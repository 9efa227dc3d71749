"""LMS (linear multistep, Adams-Bashforth over sigma) sampler.

Counterpart of ``stable_diffusion_videos_tpu/core/schedulers/lms.py``.  The
coefficient matrix is integrated once on the host by ``scipy.integrate.quad``;
the state keeps the last ``lms_order`` derivatives, newest first, and a step
sums only the terms whose coefficient is nonzero (the first steps' warm-up
rows are shorter).
"""

from __future__ import annotations

import numpy as np
from scipy import integrate

from .base import SchedulerConfig, register
from .euler import EulerBase


def lms_coeff_matrix(sigmas: np.ndarray, order: int) -> np.ndarray:
    """coeffs[t, k] = the integral over [sigma_t, sigma_{t+1}] of the k-th
    Lagrange basis polynomial over the last ``min(t + 1, order)`` sigmas."""
    n = len(sigmas) - 1
    coeffs = np.zeros((n, order), dtype=np.float64)
    for t in range(n):
        cur_order = min(t + 1, order)
        for k in range(cur_order):
            def poly(tau, k=k, cur_order=cur_order, t=t):
                prod = 1.0
                for j in range(cur_order):
                    if j != k:
                        prod *= ((tau - sigmas[t - j])
                                 / (sigmas[t - k] - sigmas[t - j]))
                return prod
            coeffs[t, k] = integrate.quad(poly, sigmas[t], sigmas[t + 1],
                                          epsrel=1e-4)[0]
    return coeffs


@register
class LMS(EulerBase):
    name = "lms"

    def make_tables(self, cfg: SchedulerConfig, num_inference_steps: int,
                    start_index: int = 0):
        """With ``start_index`` the coefficients are integrated over the
        truncated grid, so the Adams-Bashforth warm-up (orders 1, 2, ...)
        replays at the entry, where the history is empty."""
        tables = super().make_tables(cfg, num_inference_steps, start_index)
        tables["lms_coeffs"] = lms_coeff_matrix(
            tables["sigmas"].astype(np.float64),
            cfg.lms_order).astype(np.float32)
        tables["lms_order"] = cfg.lms_order
        return tables

    def init_state(self, tables, latents):
        return {"derivatives": []}

    def step(self, tables, state, i, model_output, sample, noise=None):
        d = self.derivative(tables, i, model_output, sample)
        derivs = ([d] + state["derivatives"])[:tables["lms_order"]]
        update = None
        for c, dk in zip(tables["lms_coeffs"][i], derivs):
            if c:
                update = float(c) * dk if update is None \
                    else update + float(c) * dk
        prev = sample.float() + update
        return {"derivatives": derivs}, prev.to(sample.dtype)
