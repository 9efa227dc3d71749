"""PNDM / PLMS sampler (skip_prk_steps=True), the SD v1.x default.

Counterpart of ``stable_diffusion_videos_tpu/core/schedulers/pndm.py``.  The
diffusers counter-driven state machine is hoisted to the host at table-build
time: the loop runs ``num_inference_steps + 1`` iterations over timesteps
whose second entry is duplicated (the PLMS warm-up re-evaluation), and a
``(L, 5)`` weight table combines ``[eps_new, e0, e1, e2, e3]`` per index
(1 / mean-of-2 / AB2 / AB3 / AB4 rows).  The step keeps a ring of the last
four model outputs and the stored warm-up sample.

The linear multistep combines noise predictions, so the sampler serves an
epsilon-predicting model only: ``make_tables`` refuses any other
``prediction_type`` (the JAX package's PNDM reads a v-prediction output as
epsilon and gives wrong frames without an error).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import (Scheduler, SchedulerConfig, alphas_cumprod_for,
                   check_num_steps, register)

_AB_WEIGHTS = ([1, 0, 0, 0, 0], [0.5, 0.5, 0, 0, 0], [0, 3 / 2, -1 / 2, 0, 0],
               [0, 23 / 12, -16 / 12, 5 / 12, 0],
               [0, 55 / 24, -59 / 24, 37 / 24, -9 / 24])


@register
class PNDM(Scheduler):
    name = "pndm"

    def make_tables(self, cfg: SchedulerConfig, num_inference_steps: int,
                    start_index: int = 0):
        """``start_index`` > 0 enters the schedule mid-way (img2img): the
        ``start_index`` highest timesteps are dropped and the PLMS warm-up
        replays at the truncated head, since a multistep history is valid
        only from steps that ran."""
        if cfg.prediction_type != "epsilon":
            raise ValueError(
                f"pndm combines epsilon predictions and cannot serve "
                f"prediction_type={cfg.prediction_type!r}; the samplers that "
                "read it are ddim, dpm, euler, euler_ancestral, lms, unipc "
                "and lcm")
        if not cfg.skip_prk_steps:
            raise NotImplementedError(
                "only skip_prk_steps=True (PLMS, the SD checkpoint config)")
        check_num_steps(cfg, num_inference_steps)
        acp = alphas_cumprod_for(cfg)
        final_alpha = 1.0 if cfg.set_alpha_to_one else acp[0]
        ratio = cfg.num_train_timesteps // num_inference_steps
        base = (np.arange(num_inference_steps) * ratio).round() \
            .astype(np.int64) + cfg.steps_offset
        base = base[:num_inference_steps - start_index]
        # descending with the second entry duplicated (PLMS warm-up)
        ts = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
        L = len(ts)

        t_used, t_prev = ts.copy(), ts - ratio
        if L >= 2:
            t_used[1], t_prev[1] = ts[1] + ratio, ts[1]
        a_t = acp[t_used]
        a_prev = np.where(t_prev >= 0, acp[np.maximum(t_prev, 0)], final_alpha)
        b_t, b_prev = 1.0 - a_t, 1.0 - a_prev
        weights = np.array([_AB_WEIGHTS[min(i, 4)] for i in range(L)])
        f32 = np.float32
        return {
            "timesteps": ts.astype(np.int32),
            "alphas_cumprod": acp.astype(f32),
            "sample_coeff": np.sqrt(a_prev / a_t).astype(f32),
            "denom_coeff": (a_t * np.sqrt(b_prev)
                            + np.sqrt(a_t * b_t * a_prev)).astype(f32),
            "alpha_diff": (a_prev - a_t).astype(f32),
            "weights": weights.astype(f32),
            "append": np.arange(L) != 1,
            "use_stored": np.arange(L) == 1,
            "init_noise_sigma": f32(1.0),
            "prediction_type": cfg.prediction_type,
        }

    def init_state(self, tables, latents):
        zeros = torch.zeros_like(latents, dtype=torch.float32)
        return {"ets": [zeros] * 4, "cur_sample": zeros}

    def step(self, tables, state, i, model_output, sample, noise=None):
        eps = model_output.float()
        x = sample.float()
        ets = ([eps] + state["ets"][:3]) if tables["append"][i] \
            else state["ets"]
        w = [float(c) for c in tables["weights"][i]]
        combined = w[0] * eps
        for wk, e in zip(w[1:], ets):
            if wk:
                combined = combined + wk * e
        cur = state["cur_sample"] if tables["use_stored"][i] else x
        stored = x if i == 0 else state["cur_sample"]
        prev = (float(tables["sample_coeff"][i]) * cur
                - float(tables["alpha_diff"][i]) * combined
                / float(tables["denom_coeff"][i]))
        return {"ets": ets, "cur_sample": stored}, prev.to(sample.dtype)
