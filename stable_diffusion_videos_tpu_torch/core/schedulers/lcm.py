"""LCM sampler (Luo et al. 2023, "Latent Consistency Models"): 2-8 steps
on consistency-distilled checkpoints.

Counterpart of ``stable_diffusion_videos_tpu/core/schedulers/lcm.py``.  The
model output maps to a denoised estimate through the boundary conditions
``c_skip``/``c_out`` (sigma_data 0.5, timestep_scaling 10), and every step
but the last re-noises it to the next timestep with a fresh noise field.
Run it with ``guidance_scale=1.0``: the distillation bakes CFG in.
"""

from __future__ import annotations

import numpy as np

from .base import (Scheduler, SchedulerConfig, alphas_cumprod_for,
                   check_num_steps, pred_original_sample, register)


def lcm_timesteps(cfg: SchedulerConfig, num_inference_steps: int,
                  original_inference_steps: int = 50) -> np.ndarray:
    """The distillation's skipping-step schedule: every
    ``original_inference_steps // num_inference_steps``-th of the
    ``original_inference_steps`` evenly strided training timesteps,
    descending."""
    check_num_steps(cfg, num_inference_steps)
    if num_inference_steps > original_inference_steps:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} exceeds the "
            f"distillation's original_inference_steps="
            f"{original_inference_steps}")
    k = cfg.num_train_timesteps // original_inference_steps
    origin = (np.arange(1, original_inference_steps + 1, dtype=np.int64)
              * k - 1)[::-1]
    skip = len(origin) // num_inference_steps
    return origin[::skip][:num_inference_steps].copy()


@register
class LCM(Scheduler):
    name = "lcm"
    stochastic = True

    #: consistency-distillation constants (published defaults)
    sigma_data = 0.5
    timestep_scaling = 10.0

    def make_tables(self, cfg: SchedulerConfig, num_inference_steps: int):
        acp = alphas_cumprod_for(cfg)
        ts = lcm_timesteps(cfg, num_inference_steps)
        st = self.timestep_scaling * ts.astype(np.float64)
        c_skip = self.sigma_data ** 2 / (st ** 2 + self.sigma_data ** 2)
        c_out = st / np.sqrt(st ** 2 + self.sigma_data ** 2)
        # the transition's target is the next loop timestep; the last step
        # returns the denoised estimate (alpha_prev 1, noise coefficient 0)
        a_prev = np.concatenate([acp[ts[1:]], [1.0]])
        noise_coeff = np.sqrt(1.0 - a_prev)
        noise_coeff[-1] = 0.0
        f32 = np.float32
        return {
            "timesteps": ts.astype(np.int32),
            "alphas_cumprod": acp.astype(f32),
            "alpha_prod": acp[ts].astype(f32),
            "alpha_prod_prev": a_prev.astype(f32),
            "noise_coeff": noise_coeff.astype(f32),
            "c_skip": c_skip.astype(f32),
            "c_out": c_out.astype(f32),
            "init_noise_sigma": f32(1.0),
            "prediction_type": cfg.prediction_type,
            "clip_sample": cfg.clip_sample,
        }

    def step(self, tables, state, i, model_output, sample, noise=None):
        x = sample.float()
        x0 = pred_original_sample(model_output.float(), x,
                                  tables["alpha_prod"][i],
                                  tables["prediction_type"])
        if tables["clip_sample"]:
            x0 = x0.clamp(-1.0, 1.0)
        denoised = (float(tables["c_out"][i]) * x0
                    + float(tables["c_skip"][i]) * x)
        prev = float(np.sqrt(tables["alpha_prod_prev"][i])) * denoised
        if tables["noise_coeff"][i]:
            prev = prev + float(tables["noise_coeff"][i]) * noise
        return state, prev.to(sample.dtype)
