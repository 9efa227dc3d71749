"""DDIM sampler (Song et al. 2020): deterministic at eta = 0.

Counterpart of ``stable_diffusion_videos_tpu/core/schedulers/ddim.py``.
``eta`` enters the tables (``std_dev``), so the engine keys its table cache
on it; with ``eta > 0`` the step adds ``std_dev[i]`` times its noise field.
"""

from __future__ import annotations

import numpy as np

from .base import (ONE_F32, Scheduler, SchedulerConfig,
                   alphas_cumprod_for, pred_original_sample, register,
                   spaced_timesteps)


@register
class DDIM(Scheduler):
    name = "ddim"

    def make_tables(self, cfg: SchedulerConfig, num_inference_steps: int,
                    eta: float = 0.0):
        acp = alphas_cumprod_for(cfg)
        ts = spaced_timesteps(cfg, num_inference_steps)
        a_t = acp[ts]
        prev_ts = ts - cfg.num_train_timesteps // num_inference_steps
        final_alpha = 1.0 if cfg.set_alpha_to_one else acp[0]
        a_prev = np.where(prev_ts >= 0, acp[np.maximum(prev_ts, 0)],
                          final_alpha)
        variance = (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)
        f32 = np.float32
        return {
            "timesteps": ts.astype(np.int32),
            "alphas_cumprod": acp.astype(f32),
            "alpha_prod": a_t.astype(f32),
            "alpha_prod_prev": a_prev.astype(f32),
            "std_dev": (eta * np.sqrt(variance)).astype(f32),
            "init_noise_sigma": f32(1.0),
            "prediction_type": cfg.prediction_type,
            "clip_sample": cfg.clip_sample,
        }

    def draws_noise(self, tables) -> bool:
        return bool((tables["std_dev"] > 0).any())

    def step(self, tables, state, i, model_output, sample, noise=None):
        a_t = tables["alpha_prod"][i]
        a_prev = tables["alpha_prod_prev"][i]
        sigma = tables["std_dev"][i]
        x, out = sample.float(), model_output.float()
        sq_a, sq_1ma = float(np.sqrt(a_t)), float(np.sqrt(ONE_F32 - a_t))
        x0 = pred_original_sample(out, x, a_t, tables["prediction_type"])
        if tables["prediction_type"] == "v_prediction":
            eps = sq_a * out + sq_1ma * x
        else:
            eps = (x - sq_a * x0) / sq_1ma
        if tables["clip_sample"]:
            x0 = x0.clamp(-1.0, 1.0)
            eps = (x - sq_a * x0) / sq_1ma
        dir_coeff = np.sqrt(np.maximum(ONE_F32 - a_prev - sigma * sigma,
                                       np.float32(0.0)))
        prev = float(np.sqrt(a_prev)) * x0 + float(dir_coeff) * eps
        if sigma > 0:
            prev = prev + float(sigma) * noise
        return state, prev.to(sample.dtype)
