"""UNet fine-tuning: the denoising objective's training step.

Counterpart of ``stable_diffusion_videos_tpu/training/trainer.py``, on one
device (the JAX package's mesh and batch sharding are not ported).  The
objective (Ho et al. 2020):

    t ~ U[0, T);  x_t = sqrt(a_t) x0 + sqrt(1-a_t) eps;
    loss = ||unet(x_t, t, context) - target||^2

with target eps (``objective="epsilon"``) or v (``"v_prediction"``),
optional min-SNR-gamma weighting, linear warmup, global-norm clipping,
AdamW with decoupled decay, an EMA of the weights and rematerialisation.

Precision, as flax's ``dtype=bf16`` modules over fp32 params compute: the
trainer owns fp32 master weights and optimizer state, and a working copy of
the UNet in the bundle's dtype runs the forward and the backward, so bf16
activations reach both kernels on the card.  Its gradients are cast to fp32
onto the masters (the gradient of flax's cast), the optimizer updates the
masters, and the working copy is refreshed from them.  A working copy
rather than ``torch.autocast``: the port's modules compute in their
weights' dtype (``models/unet.py``), so the copy runs the inference path's
exact graph, while autocast would run the UNet's fp32 steps (its time
embedding, its LayerNorms) on other dtypes than inference does.  An fp32
bundle's masters are the working module itself.

The JAX step draws t and the noise from ``jax.random.split(key)``; here
``step()`` draws them from a ``torch.Generator`` on the device (seeded with
the step count unless one is given, as JAX's default key is) and calls
``train_step(latents, context, t, noise)``, which takes them explicitly.

Checkpoints are the port's own ``torch.save`` of the master weights, the
optimizer state, the EMA and the step count.  The JAX package's orbax
checkpoints are not read.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..core.schedulers.base import SchedulerConfig, alphas_cumprod_for

logger = logging.getLogger("sdv_torch")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.999
    max_grad_norm: float = 1.0
    warmup_steps: int = 0
    #: rematerialise the UNet forward in the backward pass
    #: (``torch.utils.checkpoint`` over the whole call, saving nothing
    #: inside it): less activation memory for a second forward
    remat: bool = False
    #: "epsilon" (SD 1.x/SDXL) or "v_prediction" (SD 2.x); must match the
    #: family's scheduler prediction type
    objective: str = "epsilon"
    #: min-SNR-gamma loss weighting (Hang et al. 2023); 0 disables
    snr_gamma: float = 0.0
    #: exponential moving average of the weights; 0 disables
    ema_decay: float = 0.0


# ---------------------------------------------------------------------------
# pieces the trainers share
# ---------------------------------------------------------------------------

class MasterWeights:
    """fp32 master weights of a module and its working copy in ``dtype``
    on ``device``; with ``dtype`` float32 the two are one module."""

    def __init__(self, module: nn.Module, device: torch.device,
                 dtype: torch.dtype):
        self.master = copy.deepcopy(module).to(device, torch.float32)
        self.master.train().requires_grad_(True)
        if dtype == torch.float32:
            self.work = self.master
        else:
            self.work = copy.deepcopy(module).to(device, dtype)
            self.work.train().requires_grad_(True)

    def parameters(self) -> list:
        return list(self.master.parameters())

    @torch.no_grad()
    def grads_to_master(self) -> None:
        """The working copy's gradients, cast to fp32, become the masters'
        (one fused copy over every tensor)."""
        if self.work is self.master:
            return
        pairs = [(m, w) for m, w in zip(self.master.parameters(),
                                         self.work.parameters())]
        for m, w in pairs:
            if w.grad is None:
                m.grad = None
            elif m.grad is None:
                m.grad = torch.empty_like(m)
        torch._foreach_copy_([m.grad for m, w in pairs if w.grad is not None],
                             [w.grad for m, w in pairs if w.grad is not None])
        for _, w in pairs:
            w.grad = None

    @torch.no_grad()
    def sync(self) -> None:
        """The working copy from the masters, cast to its dtype (one fused
        copy)."""
        if self.work is not self.master:
            torch._foreach_copy_(list(self.work.parameters()),
                                 self.parameters())

    def export(self, tensors: Optional[list] = None) -> nn.Module:
        """A frozen copy of the working module (the bundle's dtype) holding
        ``tensors`` (default: the masters), cast."""
        out = copy.deepcopy(self.work)
        with torch.no_grad():
            for p, src in zip(out.parameters(), tensors or self.parameters()):
                p.copy_(src)
        return out.eval().requires_grad_(False)


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: below ``max_norm`` the
    gradients stay as they are, else each becomes (g / norm) · max_norm.
    (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6 instead.)
    Fused over the tensors, with no wait for the norm on the host.  Returns
    the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


def linear_warmup(learning_rate: float, warmup_steps: int, count: int
                  ) -> float:
    """optax's ``linear_schedule(0, learning_rate, warmup_steps)`` at update
    ``count`` (0 on the first update); the constant rate without warmup."""
    if not warmup_steps:
        return learning_rate
    frac = 1.0 - min(count, warmup_steps) / warmup_steps
    return -learning_rate * frac + learning_rate


@torch.no_grad()
def ema_update_(ema: list, params: list, decay: float) -> None:
    """ema <- decay · ema + (1 - decay) · params, in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)


def nchw(t: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C), the JAX package's layout -> (B, C, H, W)."""
    return t.permute(0, 3, 1, 2)


def denoising_loss(apply: Callable, acp: torch.Tensor, latents, context, t,
                   noise, objective: str = "epsilon",
                   snr_gamma: float = 0.0) -> torch.Tensor:
    """The JAX trainer's ``loss_fn``: latents and noise (B, h, w, 4) float32
    in the JAX layout, t (B,) integer timesteps; ``apply(noisy NCHW, t
    float, context)`` is the UNet call."""
    a = acp[t].reshape(-1, 1, 1, 1)
    x0, eps = nchw(latents), nchw(noise)
    noisy = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
    pred = apply(noisy, t.float(), context)
    if objective == "v_prediction":
        # v = sqrt(a) eps - sqrt(1-a) x0 (Salimans & Ho 2022)
        target = torch.sqrt(a) * eps - torch.sqrt(1.0 - a) * x0
    else:
        target = eps
    err = (pred.float() - target) ** 2
    if snr_gamma > 0.0:
        snr = a / (1.0 - a)
        if objective == "v_prediction":
            w = torch.clamp(snr, max=snr_gamma) / (snr + 1.0)
        else:
            w = torch.clamp(snr, max=snr_gamma) / snr
        # the mean over all elements is the batch mean of w_b times each
        # sample's MSE
        return torch.mean(w * err)
    return torch.mean(err)


def draw_t_and_noise(generator: torch.Generator, latents: torch.Tensor,
                     num_train_timesteps: int) -> tuple:
    """(t, noise) of one step: t (B,) uniform in [0, T), noise normal of
    the latents' shape, both from ``generator`` on its device."""
    dev = generator.device
    t = torch.randint(0, num_train_timesteps, (latents.shape[0],),
                      generator=generator, device=dev)
    noise = torch.randn(tuple(latents.shape), generator=generator,
                        device=dev, dtype=torch.float32)
    return t, noise


#: where the trainers run unless the caller names a device
CUDA = torch.device("cuda")


# ---------------------------------------------------------------------------

class UNetTrainer:
    """Owns the fp32 masters, the optimizer state and the EMA of a UNet."""

    def __init__(self, models, config: Optional[TrainConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 device: Optional[torch.device] = None):
        self.models = models
        self.config = cfg = config or TrainConfig()
        if cfg.objective not in ("epsilon", "v_prediction"):
            raise ValueError(f"unknown objective {cfg.objective!r}")
        self.device = torch.device(device) if device is not None else CUDA
        scfg = scheduler_config or models.scheduler_config
        self._acp = torch.tensor(alphas_cumprod_for(scfg),
                                 dtype=torch.float32, device=self.device)
        self._num_train_timesteps = scfg.num_train_timesteps
        self.weights = MasterWeights(models.unet, self.device, models.dtype)
        params = self.weights.parameters()
        self.optimizer = torch.optim.AdamW(
            params, lr=cfg.learning_rate, betas=(cfg.beta1, cfg.beta2),
            eps=1e-8, weight_decay=cfg.weight_decay)
        #: EMA shadow of the masters (None when ema_decay == 0)
        self.ema_params = ([p.detach().clone() for p in params]
                           if cfg.ema_decay > 0.0 else None)
        self.step_count = 0

    @property
    def unet(self) -> nn.Module:
        """The fp32 master UNet."""
        return self.weights.master

    def _apply(self, noisy, t, context):
        work = self.weights.work
        if self.config.remat:
            return torch.utils.checkpoint.checkpoint(
                work, noisy, t, context, use_reentrant=False)
        return work(noisy, t, context)

    def compute_gradients(self, latents, context, t, noise) -> float:
        """The loss on given timesteps and noise, its gradient left on the
        fp32 masters' ``.grad`` (no update): latents and noise (B, h, w, 4)
        float32 (the latents already scaled by the VAE factor), context
        (B, S, D), t (B,) integers.  Returns the loss."""
        cfg, dev = self.config, self.device
        loss = denoising_loss(
            self._apply, self._acp,
            torch.as_tensor(latents, dtype=torch.float32, device=dev),
            torch.as_tensor(context, dtype=torch.float32, device=dev),
            torch.as_tensor(t, device=dev).long(),
            torch.as_tensor(noise, dtype=torch.float32, device=dev),
            cfg.objective, cfg.snr_gamma)
        loss.backward()
        self.weights.grads_to_master()
        return float(loss.detach())

    def train_step(self, latents, context, t, noise) -> float:
        """One optimisation step on given timesteps and noise
        (``compute_gradients``' arguments).  Returns the loss."""
        cfg = self.config
        loss = self.compute_gradients(latents, context, t, noise)
        params = self.weights.parameters()
        clip_by_global_norm_([p.grad for p in params], cfg.max_grad_norm)
        self.optimizer.param_groups[0]["lr"] = linear_warmup(
            cfg.learning_rate, cfg.warmup_steps, self.step_count)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.ema_params is not None:
            ema_update_(self.ema_params, [p.detach() for p in params],
                        cfg.ema_decay)
        self.weights.sync()
        self.step_count += 1
        return loss

    def step(self, latents, context,
             generator: Optional[torch.Generator] = None) -> float:
        """One optimisation step; t and the noise come from ``generator``
        (default: a generator on the device seeded with the step count)."""
        latents = torch.as_tensor(latents, dtype=torch.float32,
                                  device=self.device)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(
                self.step_count)
        t, noise = draw_t_and_noise(generator, latents,
                                    self._num_train_timesteps)
        return self.train_step(latents, context, t, noise)

    def finetune(self, images: np.ndarray, prompts, num_steps: int = 100,
                 log_every: int = 10) -> list:
        """VAE-encode images ((N, H, W, 3) in [-1, 1]) and embed the prompts
        with the bundle, then take ``num_steps`` steps on them.  Returns the
        loss history."""
        from ..runtime.engine import Engine
        engine = Engine(self.models, self.device)
        with torch.no_grad():
            latents = engine.encode_image(np.asarray(images, np.float32))
            context = engine.embed_text(list(prompts)).float()
        losses = []
        for i in range(num_steps):
            losses.append(self.step(latents, context))
            if log_every and i % log_every == 0:
                logger.info("finetune step %d loss %.5f", i, losses[-1])
        return losses

    def export_params(self, ema: bool = True):
        """A new ``SDModels`` with the trained UNet in the bundle's dtype:
        the EMA weights when tracked and ``ema``, else the masters."""
        src = self.ema_params if (ema and self.ema_params is not None) \
            else None
        return dataclasses.replace(self.models,
                                   unet=self.weights.export(src))

    # ------------------------------------------------------------------
    def save_checkpoint(self, path) -> None:
        """Write the masters, the optimizer state, the EMA and the step
        count to one file (``torch.save``: a path or a file object)."""
        payload = {"params": self.unet.state_dict(),
                   "opt_state": self.optimizer.state_dict(),
                   "step_count": self.step_count}
        if self.ema_params is not None:
            payload["ema_params"] = self.ema_params
        torch.save(payload, path)
        logger.info("saved training checkpoint @ step %d -> %s",
                    self.step_count, path)

    def restore_checkpoint(self, path) -> "UNetTrainer":
        """Restore a ``save_checkpoint`` file into this trainer."""
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.unet.load_state_dict(ckpt["params"])
        self.optimizer.load_state_dict(ckpt["opt_state"])
        if self.ema_params is not None:
            with torch.no_grad():
                for e, s in zip(self.ema_params, ckpt["ema_params"]):
                    e.copy_(s)
        self.step_count = int(ckpt["step_count"])
        self.weights.sync()
        return self
