"""Latent Consistency Model distillation (Luo et al. 2023).

Counterpart of ``stable_diffusion_videos_tpu/training/lcm_distill.py``, on
one device.  Distills a trained epsilon-prediction UNet (the teacher) into
a consistency model (the student) that samples in 2-8 steps with the
``lcm`` sampler, whose conventions it shares (``core/schedulers/lcm.py``):
the boundary coefficients c_skip/c_out (sigma_data 0.5, timestep_scaling
10) and the 50-point skipping-step origin schedule.  The guidance scale
``w`` is fixed at distillation time; the student is sampled cond-only with
``guidance_scale=1.0``.

Per step (the paper's Algorithm 1, k one origin-schedule stride):

    n ~ U[0, N-2];  t = ts[n] (high), s = ts[n+1] (low)
    x_t = sqrt(a_t) x0 + sqrt(1-a_t) eps
    teacher CFG:  e = e_u + w (e_c - e_u);  DDIM x_t -> x_s with e
    loss = d( f_theta(x_t, t, c),  f_{theta^-}(x_s, s, c) )

with f(x, t, c) = c_skip(t) x + c_out(t) x0_pred(eps_model) and d the
pseudo-Huber distance sqrt(||.||^2 + c^2) - c (elementwise mean).  The
teacher's CFG call (one 2B-row call) and the target's call run under
``torch.no_grad()``, JAX's ``stop_gradient``.  theta^- is an EMA of the
student (mu = 0.95), updated after every step, and is what
``export_params`` ships by default.  The teacher is the bundle's UNet as it
is; the student and the target have fp32 masters and working copies in the
bundle's dtype (``trainer.py``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from ..core.schedulers.base import SchedulerConfig, alphas_cumprod_for
from ..core.schedulers.lcm import LCM, lcm_timesteps
from .trainer import (CUDA, MasterWeights, clip_by_global_norm_,
                      ema_update_, nchw)


def boundary_coefficients(t) -> tuple:
    """(c_skip, c_out) at (unscaled) timesteps ``t``, float32: the ``lcm``
    sampler's constants, so training and sampling cannot drift."""
    st = LCM.timestep_scaling * torch.as_tensor(t).float()
    c_skip = LCM.sigma_data ** 2 / (st ** 2 + LCM.sigma_data ** 2)
    c_out = st / torch.sqrt(st ** 2 + LCM.sigma_data ** 2)
    return c_skip, c_out


@dataclasses.dataclass(frozen=True)
class LCMDistillConfig:
    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    #: the fixed guidance scale the student bakes in
    guidance_scale: float = 3.0
    #: the origin schedule's length; inference step counts divide into it
    original_inference_steps: int = 50
    #: EMA rate of the target network theta^- (mu in the paper)
    ema_decay: float = 0.95
    #: pseudo-Huber c; 0 gives the plain MSE
    huber_c: float = 0.001


class LCMDistiller:
    """Owns the student, the EMA target and the optimizer state.
    ``models`` supplies the architecture and the teacher's weights, from
    which the student and the target start."""

    def __init__(self, models, config: Optional[LCMDistillConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 device: Optional[torch.device] = None):
        self.models = models
        self.config = cfg = config or LCMDistillConfig()
        dev = torch.device(device) if device is not None else CUDA
        self.device = dev
        scfg = scheduler_config or models.scheduler_config
        # the origin schedule, descending: ts[0] highest ... ts[N-1] lowest
        ts = lcm_timesteps(scfg, cfg.original_inference_steps,
                           cfg.original_inference_steps)
        self._ts = torch.as_tensor(ts, dtype=torch.long, device=dev)
        self._acp = torch.tensor(alphas_cumprod_for(scfg),
                                 dtype=torch.float32, device=dev)
        teacher = models.unet
        if next(teacher.parameters()).device.type != dev.type:
            teacher = copy.deepcopy(teacher).to(dev)
        self.teacher = teacher.requires_grad_(False)
        self.student = MasterWeights(models.unet, dev, models.dtype)
        self.target = MasterWeights(models.unet, dev, models.dtype)
        self.target.master.requires_grad_(False)
        self.target.work.requires_grad_(False)
        self.optimizer = torch.optim.AdamW(
            self.student.parameters(), lr=cfg.learning_rate,
            betas=(cfg.beta1, cfg.beta2), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.step_count = 0

    def _consistency(self, unet, x, t, a, ctx):
        eps = unet(x, t.float(), ctx).float()
        c_skip, c_out = (c.reshape(-1, 1, 1, 1)
                         for c in boundary_coefficients(t))
        return c_skip * x + c_out * (x - torch.sqrt(1.0 - a) * eps) \
            / torch.sqrt(a)

    def loss(self, latents, context, uncond_context, idx, noise
             ) -> torch.Tensor:
        """The distillation loss of clean latents (B, h, w, 4) float32 (the
        JAX layout), contexts (B, S, D), origin-schedule indices idx (B,)
        in [0, N-2] and noise like the latents."""
        cfg = self.config
        x0, noise = nchw(latents), nchw(noise)
        t_hi, t_lo = self._ts[idx], self._ts[idx + 1]
        a_hi = self._acp[t_hi].reshape(-1, 1, 1, 1)
        a_lo = self._acp[t_lo].reshape(-1, 1, 1, 1)
        x_t = torch.sqrt(a_hi) * x0 + torch.sqrt(1.0 - a_hi) * noise
        b = x0.shape[0]
        with torch.no_grad():
            # the teacher's probability-flow step t_hi -> t_lo under CFG,
            # one call of 2B rows
            eps2 = self.teacher(torch.cat([x_t, x_t]),
                                torch.cat([t_hi, t_hi]).float(),
                                torch.cat([uncond_context, context]))
            eps_u, eps_c = eps2[:b].float(), eps2[b:].float()
            eps_hat = eps_u + cfg.guidance_scale * (eps_c - eps_u)
            x0_t = (x_t - torch.sqrt(1.0 - a_hi) * eps_hat) / torch.sqrt(a_hi)
            x_s = torch.sqrt(a_lo) * x0_t + torch.sqrt(1.0 - a_lo) * eps_hat
            f_target = self._consistency(self.target.work, x_s, t_lo, a_lo,
                                         context)
        f_student = self._consistency(self.student.work, x_t, t_hi, a_hi,
                                      context)
        d = f_student - f_target
        if cfg.huber_c > 0.0:
            return torch.mean(torch.sqrt(d * d + cfg.huber_c ** 2)
                              - cfg.huber_c)
        return torch.mean(d * d)

    def train_step(self, latents, context, uncond_context, idx,
                   noise) -> float:
        """One distillation step on given indices and noise.  Returns the
        loss."""
        cfg, dev = self.config, self.device
        latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)
        context = torch.as_tensor(context, dtype=torch.float32, device=dev)
        uncond = torch.as_tensor(uncond_context, dtype=torch.float32,
                                 device=dev)
        if uncond.shape[0] == 1 and latents.shape[0] > 1:
            uncond = uncond.expand(latents.shape[0], -1, -1)
        loss = self.loss(latents, context, uncond,
                         torch.as_tensor(idx, device=dev).long(),
                         torch.as_tensor(noise, dtype=torch.float32,
                                         device=dev))
        loss.backward()
        self.student.grads_to_master()
        params = self.student.parameters()
        clip_by_global_norm_([p.grad for p in params], cfg.max_grad_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        ema_update_(self.target.parameters(), [p.detach() for p in params],
                    cfg.ema_decay)
        self.student.sync()
        self.target.sync()
        self.step_count += 1
        return float(loss.detach())

    def step(self, latents, context, uncond_context,
             generator: Optional[torch.Generator] = None) -> float:
        """One step; the indices and the noise come from ``generator``
        (default: one on the device seeded with the step count).  The
        uncond rows feed only the teacher's CFG; one row broadcasts."""
        latents = torch.as_tensor(latents, dtype=torch.float32,
                                  device=self.device)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(
                self.step_count)
        idx = torch.randint(0, self._ts.shape[0] - 1, (latents.shape[0],),
                            generator=generator, device=self.device)
        noise = torch.randn(tuple(latents.shape), generator=generator,
                            device=self.device)
        return self.train_step(latents, context, uncond_context, idx, noise)

    def export_params(self, ema: bool = True):
        """A new ``SDModels`` with the distilled UNet in the bundle's dtype:
        the EMA target by default (the network consistency models are
        sampled from), else the student."""
        src = self.target.parameters() if ema else None
        return dataclasses.replace(self.models,
                                   unet=self.student.export(src))
