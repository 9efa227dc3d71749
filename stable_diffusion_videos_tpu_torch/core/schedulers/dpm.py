"""DPM-Solver++ (2M, multistep, midpoint) sampler.

Counterpart of ``stable_diffusion_videos_tpu/core/schedulers/dpm.py``.  Every
per-step term (alpha, sigma, h, h0) and the "first order here" decision is
built on the host.  The JAX package computes both updates and selects one
with ``jnp.where``; here the step reads ``first_order[i]`` on the host and
computes only the update it needs.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import (Scheduler, SchedulerConfig, alphas_cumprod_for,
                   check_num_steps, register)


@register
class DPMSolverMultistep(Scheduler):
    name = "dpm"

    def make_tables(self, cfg: SchedulerConfig, num_inference_steps: int):
        check_num_steps(cfg, num_inference_steps + 1)
        acp = alphas_cumprod_for(cfg)
        n = cfg.num_train_timesteps
        # (steps+1)-point grid, the terminal point dropped -> descending
        if cfg.timestep_spacing == "linspace":
            ts = (np.linspace(0, n - 1, num_inference_steps + 1)
                  .round()[::-1][:-1].astype(np.int64))
        else:  # leading (SD checkpoints)
            ratio = n // (num_inference_steps + 1)
            ts = ((np.arange(0, num_inference_steps + 1) * ratio)
                  .round()[::-1][:-1].astype(np.int64)) + cfg.steps_offset

        alpha = np.sqrt(acp)
        sigma = np.sqrt(1.0 - acp)
        lam = np.log(alpha) - np.log(sigma)
        # loop index i moves from timestep ts[i] to ts[i+1] (0 at the end)
        t_cur = ts
        t_prev = np.concatenate([ts[1:], [0]])
        lam_cur = lam[t_cur]
        h = lam[t_prev] - lam_cur
        # h0[i] = lam_cur[i] - lam_cur[i-1], the second-order D1 term's step
        h0 = np.concatenate([[1.0], lam_cur[1:] - lam_cur[:-1]])

        first_order = np.zeros(num_inference_steps, dtype=bool)
        first_order[0] = True
        if cfg.lower_order_final and num_inference_steps < 15:
            first_order[-1] = True

        f32 = np.float32
        return {
            "timesteps": t_cur.astype(np.int32),
            "alphas_cumprod": acp.astype(f32),
            "alpha_cur": alpha[t_cur].astype(f32),
            "sigma_cur": sigma[t_cur].astype(f32),
            "alpha_prev": alpha[t_prev].astype(f32),
            "sigma_prev": sigma[t_prev].astype(f32),
            "h": h.astype(f32),
            "h0": h0.astype(f32),
            "first_order": first_order,
            "init_noise_sigma": f32(1.0),
            "prediction_type": cfg.prediction_type,
        }

    def init_state(self, tables, latents):
        return {"m1": torch.zeros_like(latents, dtype=torch.float32)}

    def step(self, tables, state, i, model_output, sample, noise=None):
        a_c, s_c = tables["alpha_cur"][i], tables["sigma_cur"][i]
        a_p, s_p = tables["alpha_prev"][i], tables["sigma_prev"][i]
        h, h0 = tables["h"][i], tables["h0"][i]
        x = sample.float()
        eps = model_output.float()
        # data-prediction (dpmsolver++) conversion
        if tables["prediction_type"] == "epsilon":
            m0 = (x - float(s_c) * eps) / float(a_c)
        elif tables["prediction_type"] == "v_prediction":
            m0 = float(a_c) * x - float(s_c) * eps
        else:
            m0 = eps
        # float32 arithmetic on the float32 table values, as on the device
        emh = np.expm1(-h)
        ratio, a_emh = float(s_p / s_c), float(a_p * emh)
        # first order (DPM-Solver++ 1S, DDIM in lambda space)
        prev = ratio * x - a_emh * m0
        if not tables["first_order"][i]:
            # second-order multistep, midpoint rule
            r = h0 / (h if abs(h) >= 1e-20 else np.float32(1.0))
            d1 = (m0 - state["m1"]) / float(r if abs(r) >= 1e-20 else 1.0)
            prev = prev - 0.5 * a_emh * d1
        return {"m1": m0}, prev.to(sample.dtype)
