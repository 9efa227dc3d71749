"""UniPC multistep predictor-corrector sampler (order 2, B(h) = e^h - 1,
"bh2"; Zhao et al. 2023).

Counterpart of ``stable_diffusion_videos_tpu/core/schedulers/unipc.py``.  At
loop index i the model's x0 prediction ``m_t`` first corrects x_i from the
stored x_{i-1} (UniC), then steps the corrected x_i to x_{i+1} (UniP, which
at order 2 is DPM-Solver++ 2M).  The order ramp and the corrector weights
are host tables; the step reads ``use_corr[i]`` and skips the terms whose
weight is zero, where the JAX package computes every term and selects.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import (Scheduler, SchedulerConfig, alphas_cumprod_for,
                   check_num_steps, register)


def _bh2_b01(hh: float):
    """The order-2 b-vector entries for B(h) = expm1(hh): b_k = phi_{k+1}(hh)
    k! / B(h) from the paper's Taylor construction."""
    b_h = np.expm1(hh)
    h_phi_k = b_h / hh - 1.0
    b0 = h_phi_k / b_h
    h_phi_k = h_phi_k / hh - 0.5
    return b0, 2.0 * h_phi_k / b_h


@register
class UniPC(Scheduler):
    name = "unipc"

    def make_tables(self, cfg: SchedulerConfig, num_inference_steps: int,
                    start_index: int = 0):
        """``start_index`` > 0 truncates the grid and restarts the order
        ramp at the entry (predictor at order 1, corrector off until there
        is history), as img2img's mid-schedule entry needs."""
        check_num_steps(cfg, num_inference_steps + 1)
        acp = alphas_cumprod_for(cfg)
        n = cfg.num_train_timesteps
        # DPM-Solver++'s (steps+1)-point grid, the terminal point dropped
        if cfg.timestep_spacing == "linspace":
            ts = (np.linspace(0, n - 1, num_inference_steps + 1)
                  .round()[::-1][:-1].astype(np.int64))
        else:
            ratio = n // (num_inference_steps + 1)
            ts = ((np.arange(0, num_inference_steps + 1) * ratio)
                  .round()[::-1][:-1].astype(np.int64)) + cfg.steps_offset
        ts = ts[start_index:]

        alpha = np.sqrt(acp)
        sigma = np.sqrt(1.0 - acp)
        lam = np.log(alpha) - np.log(sigma)
        steps = len(ts)
        t_cur = ts
        t_next = np.concatenate([ts[1:], [0]])
        t_prev = np.concatenate([[ts[0]], ts[:-1]])
        t_prev2 = np.concatenate([[ts[0]], t_prev[:-1]])

        # predictor t_i -> t_{i+1}
        h_p = lam[t_next] - lam[t_cur]
        phi1_p = np.expm1(-h_p)
        r0_p = (lam[t_prev] - lam[t_cur]) / np.where(h_p == 0, 1.0, h_p)
        r0_p = np.where(np.abs(r0_p) < 1e-20, 1.0, r0_p)
        # order ramp: no history at the first step; order 1 at the last
        rp0 = np.full(steps, 0.5)
        rp0[0] = 0.0
        if cfg.lower_order_final and steps > 1:
            rp0[-1] = 0.0

        # corrector t_{i-1} -> t_i, from i = 1
        h_c = lam[t_cur] - lam[t_prev]
        h_c_safe = np.where(h_c == 0, 1.0, h_c)
        phi1_c = np.expm1(-h_c)
        r0_c = (lam[t_prev2] - lam[t_prev]) / h_c_safe
        r0_c = np.where(np.abs(r0_c) < 1e-20, 1.0, r0_c)
        rc0 = np.zeros(steps)   # weight of the history difference
        rc1 = np.zeros(steps)   # weight of the fresh difference
        use_corr = np.zeros(steps, dtype=bool)
        for i in range(1, steps):
            use_corr[i] = True
            if i == 1:
                rc1[i] = 0.5    # order-1 corrector: rho_c = [1/2]
                continue
            b0, b1 = _bh2_b01(-h_c[i])
            # solve [[1, 1], [r0, 1]] @ [c0, c1] = [b0, b1]
            denom = 1.0 - r0_c[i]
            if abs(denom) < 1e-12:
                rc1[i] = 0.5
                continue
            rc0[i] = (b0 - b1) / denom
            rc1[i] = b0 - rc0[i]

        f32 = np.float32
        return {
            "timesteps": t_cur.astype(np.int32),
            "alphas_cumprod": acp.astype(f32),
            "alpha_cur": alpha[t_cur].astype(f32),
            "sigma_cur": sigma[t_cur].astype(f32),
            "s_ratio_p": (sigma[t_next] / sigma[t_cur]).astype(f32),
            "alpha_next": alpha[t_next].astype(f32),
            "phi1_p": phi1_p.astype(f32),
            "r0_p": r0_p.astype(f32),
            "rp0": rp0.astype(f32),
            "s_ratio_c": (sigma[t_cur] / sigma[t_prev]).astype(f32),
            "alpha_c": alpha[t_cur].astype(f32),
            "phi1_c": phi1_c.astype(f32),
            "r0_c": r0_c.astype(f32),
            "rc0": rc0.astype(f32),
            "rc1": rc1.astype(f32),
            "use_corr": use_corr,
            "init_noise_sigma": f32(1.0),
            "prediction_type": cfg.prediction_type,
        }

    def init_state(self, tables, latents):
        z = torch.zeros_like(latents, dtype=torch.float32)
        return {"m0": z, "m1": z, "x_prev": z}

    def step(self, tables, state, i, model_output, sample, noise=None):
        x = sample.float()
        eps = model_output.float()
        a_c, s_c = tables["alpha_cur"][i], tables["sigma_cur"][i]
        if tables["prediction_type"] == "epsilon":
            m_t = (x - float(s_c) * eps) / float(a_c)
        elif tables["prediction_type"] == "v_prediction":
            m_t = float(a_c) * x - float(s_c) * eps
        else:
            m_t = eps
        m0, m1 = state["m0"], state["m1"]

        # UniC: refine x_i from x_{i-1} with the fresh evaluation folded in
        if tables["use_corr"][i]:
            phi1_c = float(tables["phi1_c"][i])   # B(h) == phi1 (bh2)
            corr = phi1_c * float(tables["rc1"][i]) * (m_t - m0)
            if tables["rc0"][i]:
                d1_c = (m1 - m0) / float(tables["r0_c"][i])
                corr = corr + phi1_c * float(tables["rc0"][i]) * d1_c
            x = (float(tables["s_ratio_c"][i]) * state["x_prev"]
                 - float(tables["alpha_c"][i]) * (phi1_c * m0 + corr))

        # UniP: step the corrected sample forward
        phi1_p = float(tables["phi1_p"][i])
        pred = phi1_p * m_t
        if tables["rp0"][i]:
            d1_p = (m0 - m_t) / float(tables["r0_p"][i])
            pred = pred + phi1_p * float(tables["rp0"][i]) * d1_p
        x_next = (float(tables["s_ratio_p"][i]) * x
                  - float(tables["alpha_next"][i]) * pred)
        return {"m0": m_t, "m1": m0, "x_prev": x}, x_next.to(sample.dtype)
