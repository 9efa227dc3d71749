"""Euler and Euler-Ancestral discrete samplers (Karras et al. 2022 family).

Counterpart of ``stable_diffusion_videos_tpu/core/schedulers/euler.py``.
The sigma tables, with Karras rho-7 resampling, are built on the host; the
UNet's timesteps are then fractional, so ``timesteps`` is float32.  The
latents live at sigma scale (``init_noise_sigma`` about 14.6 at SD 1.x) in
float32; only ``scale_model_input``'s output goes into the UNet.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import (ONE_F32, Scheduler, SchedulerConfig, alphas_cumprod_for,
                   register, spaced_timesteps)


def sigma_tables(cfg: SchedulerConfig, num_inference_steps: int):
    """(timesteps, sigmas + terminal 0) in float64."""
    acp = alphas_cumprod_for(cfg)
    sigmas_train = np.sqrt((1.0 - acp) / acp)
    ts = spaced_timesteps(cfg, num_inference_steps).astype(np.float64)
    sigmas = np.interp(ts, np.arange(len(sigmas_train)), sigmas_train)
    if cfg.use_karras_sigmas:
        rho = 7.0
        s_min, s_max = sigmas[-1], sigmas[0]
        ramp = np.linspace(0, 1, num_inference_steps)
        sigmas = (s_max ** (1 / rho)
                  + ramp * (s_min ** (1 / rho) - s_max ** (1 / rho))) ** rho
        # the UNet's timesteps follow the resampled sigmas
        log_s = np.log(np.maximum(sigmas_train, 1e-20))
        ts = np.interp(np.log(sigmas), log_s, np.arange(len(sigmas_train)))
    return ts, np.concatenate([sigmas, [0.0]])


class EulerBase(Scheduler):
    def make_tables(self, cfg: SchedulerConfig, num_inference_steps: int,
                    start_index: int = 0):
        """``start_index`` > 0 truncates the sigma grid (img2img's
        mid-schedule entry; lms rebuilds its coefficients over it)."""
        ts, sigmas = sigma_tables(cfg, num_inference_steps)
        ts, sigmas = ts[start_index:], sigmas[start_index:]
        f32 = np.float32
        return {
            "timesteps": ts.astype(f32),
            "alphas_cumprod": alphas_cumprod_for(cfg).astype(f32),
            "sigmas": sigmas.astype(f32),
            "init_noise_sigma": f32(np.max(sigmas)),
            "prediction_type": cfg.prediction_type,
        }

    def scale_model_input(self, tables, state, i, sample):
        sigma = tables["sigmas"][i]
        return (sample / float(np.sqrt(sigma * sigma + ONE_F32))) \
            .to(sample.dtype)

    def derivative(self, tables, i, model_output, sample) -> torch.Tensor:
        """(sample - x0) / sigma at loop index ``i``, in float32."""
        sigma = tables["sigmas"][i]
        x, out = sample.float(), model_output.float()
        pt = tables["prediction_type"]
        if pt == "epsilon":
            x0 = x - float(sigma) * out
        elif pt == "v_prediction":
            s2p1 = sigma * sigma + ONE_F32
            x0 = (out * float(-sigma / np.sqrt(s2p1)) + x / float(s2p1))
        else:
            raise ValueError(pt)
        return (x - x0) / float(sigma)


@register
class Euler(EulerBase):
    name = "euler"

    def step(self, tables, state, i, model_output, sample, noise=None):
        sigma, sigma_next = tables["sigmas"][i], tables["sigmas"][i + 1]
        d = self.derivative(tables, i, model_output, sample)
        prev = sample.float() + d * float(sigma_next - sigma)
        return state, prev.to(sample.dtype)


@register
class EulerAncestral(EulerBase):
    name = "euler_ancestral"
    stochastic = True

    def make_tables(self, cfg: SchedulerConfig, num_inference_steps: int):
        t = super().make_tables(cfg, num_inference_steps)
        s_from, s_to = t["sigmas"][:-1], t["sigmas"][1:]
        var = np.maximum(s_to ** 2 * (s_from ** 2 - s_to ** 2)
                         / np.maximum(s_from ** 2, 1e-20), 0.0)
        sigma_up = np.sqrt(var)
        sigma_down = np.sqrt(np.maximum(s_to ** 2 - sigma_up ** 2, 0.0))
        t["sigma_up"] = sigma_up.astype(np.float32)
        t["sigma_down"] = sigma_down.astype(np.float32)
        return t

    def step(self, tables, state, i, model_output, sample, noise=None):
        sigma = tables["sigmas"][i]
        d = self.derivative(tables, i, model_output, sample)
        prev = sample.float() + d * float(tables["sigma_down"][i] - sigma)
        prev = prev + noise * float(tables["sigma_up"][i])
        return state, prev.to(sample.dtype)
