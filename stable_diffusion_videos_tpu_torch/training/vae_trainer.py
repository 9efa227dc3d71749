"""VAE training: reconstruction plus KL.

Counterpart of ``stable_diffusion_videos_tpu/training/vae_trainer.py``, on
one device.  Objective (Rombach et al. 2022, without the adversarial term):

    mean, logvar = encode(x);  z = mean + exp(logvar/2) * eps
    loss = ||decode(z) - x||^2 + kl_weight * KL(N(mean, var) || N(0, 1))

``train_step`` takes the posterior noise ``eps`` explicitly (``step`` draws
it from a ``torch.Generator``).  Clipping by global norm, then Adam.  The
precision is ``trainer.py``'s: fp32 masters, a working copy in the bundle's
dtype.  On the card a 512² image reaches the decoder's and the encoder's
mid-block attention at one head of D=512 over 4096 positions, and
GroupNorms of up to 4 × 512² elements a group, in both backward kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .trainer import CUDA, MasterWeights, clip_by_global_norm_, nchw


class VAETrainer:
    """Owns the fp32 masters and the optimizer state of a VAE."""

    def __init__(self, models, learning_rate: float = 1e-3,
                 kl_weight: float = 1e-6, max_grad_norm: float = 1.0,
                 device: Optional[torch.device] = None):
        self.models = models
        self.kl_weight = float(kl_weight)
        self.max_grad_norm = float(max_grad_norm)
        self.device = torch.device(device) if device is not None else CUDA
        self.weights = MasterWeights(models.vae, self.device, models.dtype)
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8
        self.optimizer = torch.optim.Adam(self.weights.parameters(),
                                          lr=learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.step_count = 0

    def loss(self, images: torch.Tensor, noise: torch.Tensor) -> tuple:
        """(loss, reconstruction MSE) of images (B, H, W, 3) in [-1, 1] and
        the posterior noise (B, H/f, W/f, 4), both float32 in the JAX
        layout."""
        vae = self.weights.work
        x = nchw(images)
        mean, logvar = vae.encode(x)
        mean, logvar = mean.float(), logvar.float()
        z = mean + torch.exp(0.5 * logvar) * nchw(noise)
        recon = vae.decode(z)
        rec = torch.mean((recon.float() - x) ** 2)
        kl = 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
        return rec + self.kl_weight * kl, rec

    def train_step(self, images, noise) -> float:
        """One optimisation step on given posterior noise.  Returns the
        reconstruction MSE (the number worth watching)."""
        dev = self.device
        loss, rec = self.loss(
            torch.as_tensor(images, dtype=torch.float32, device=dev),
            torch.as_tensor(noise, dtype=torch.float32, device=dev))
        loss.backward()
        self.weights.grads_to_master()
        params = self.weights.parameters()
        clip_by_global_norm_([p.grad for p in params], self.max_grad_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.weights.sync()
        self.step_count += 1
        return float(rec.detach())

    def step(self, images, generator: Optional[torch.Generator] = None
             ) -> float:
        """One step; the posterior noise comes from ``generator`` (default:
        one on the device seeded with the step count)."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(
                self.step_count)
        b, h, w, _ = images.shape
        f = self.models.vae_scale_factor
        noise = torch.randn(b, h // f, w // f,
                            self.models.vae_config.latent_channels,
                            generator=generator, device=self.device)
        return self.train_step(images, noise)

    @torch.no_grad()
    def recon_psnr(self, images) -> float:
        """Deterministic (mean-latent) reconstruction PSNR in dB over the
        [-1, 1] range."""
        vae = self.weights.work
        x = nchw(torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device))
        mean, _ = vae.encode(x)
        mse = float(torch.mean((vae.decode(mean).float() - x) ** 2))
        return float(10.0 * np.log10(4.0 / max(mse, 1e-12)))

    def export_params(self):
        """A new ``SDModels`` with the trained VAE in the bundle's dtype
        (the JAX package returns the fp32 parameter tree)."""
        return dataclasses.replace(self.models, vae=self.weights.export())
