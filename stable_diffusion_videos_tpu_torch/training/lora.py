"""LoRA fine-tuning: low-rank adapters over the UNet's attention and
feed-forward projections.

Counterpart of ``stable_diffusion_videos_tpu/training/lora.py``.  As there,
the step computes ``W_eff = W + (alpha/r) · delta`` for every adapted
weight and calls the unchanged UNet with the merged weights
(``torch.func.functional_call``); gradients reach the adapters alone, the
base stays frozen in the bundle's dtype, and the optimizer state is the
adapters'.  Adapted: the attentions' to_q/to_k/to_v/to_out and the
transformer feed-forward's two projections.  Rank-r init: A ~ N(0, 1/r), B
= 0, so step 0 reproduces the base model.

The ``.npz`` file is the JAX package's format exactly: each adapter under
its flax parameter path (``params/down_0_attn_0/blocks_0/attn1/to_q/
kernel``), ``::a`` (in, r) and ``::b`` (r, out) in flax's (in, out)
orientation, and ``__rank__`` and ``__alpha__``; so a file trained by either
package merges in both.  A torch Linear's weight is (out, in), so the delta
is (A @ B)ᵀ.  The map from flax paths to the port's module names is
``models.weights.from_jax_params`` itself, run on a tree whose leaves hold
their own paths.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import re
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.schedulers.base import SchedulerConfig, alphas_cumprod_for
from ..models.weights import from_jax_params, shared_copy
from .trainer import CUDA, denoising_loss, draw_t_and_noise

logger = logging.getLogger("sdv_torch")

#: flax kernel paths that get adapters (2-D kernels only)
DEFAULT_TARGET_RE = re.compile(
    r".*(to_q|to_k|to_v|to_out|ff/proj_in|ff/proj_out)/kernel$")

#: the names of flax's parameter leaves
_LEAVES = ("kernel", "bias", "scale", "embedding")


class _PathTree:
    """A stand-in for a flax parameter tree: every key is present, and each
    leaf is a (1, 1, 1, 1) object array holding its own path, so that the
    exporter's transposes pass it through unchanged."""

    def __init__(self, path: tuple = ()):
        self.path = path

    def __contains__(self, key) -> bool:
        return True

    def __getitem__(self, key):
        path = self.path + (key,)
        if key not in _LEAVES:
            return _PathTree(path)
        leaf = np.empty((1, 1, 1, 1), dtype=object)
        leaf[0, 0, 0, 0] = "/".join(path)
        return leaf


def lora_targets(unet: nn.Module,
                 target_re: re.Pattern = DEFAULT_TARGET_RE) -> dict:
    """{flax kernel path: the port's Linear module name} for every Linear
    of ``unet`` whose flax path the pattern matches, in module order."""
    names = from_jax_params({"params": _PathTree(("params",))}, unet.config)
    linear = {f"{n}.weight": n for n, m in unet.named_modules()
              if isinstance(m, nn.Linear)}
    paths = {name: leaf.item() for name, leaf in names.items()
             if name in linear}
    return {paths[w]: linear[w] for w in linear
            if w in paths and target_re.match(paths[w])}


def init_lora_params(unet: nn.Module, rank: int = 8, seed: int = 0,
                     target_re: re.Pattern = DEFAULT_TARGET_RE) -> dict:
    """{flax path: {"a": (in, r), "b": (r, out)}} float32 CPU tensors for
    every adapted Linear, A drawn N(0, 1/r) from a numpy seed, B zero."""
    rng = np.random.default_rng(seed)
    mods = dict(unet.named_modules())
    out = {}
    for path, name in lora_targets(unet, target_re).items():
        lin = mods[name]
        a = rng.standard_normal((lin.in_features, rank), dtype=np.float32)
        out[path] = {"a": torch.from_numpy(a / np.float32(np.sqrt(rank))),
                     "b": torch.zeros(rank, lin.out_features)}
    if not out:
        raise ValueError("no kernels matched the LoRA target pattern")
    return out


def merged_weights(unet: nn.Module, lora: dict, scale: float,
                   targets: Optional[dict] = None) -> dict:
    """{module.weight name: W + scale · (A @ B)ᵀ} for each adapter of
    ``lora`` (numpy arrays or tensors), summed in fp32 and cast to W's
    dtype; adapters of paths this UNet lacks are skipped with a warning."""
    targets = targets if targets is not None else lora_targets(
        unet, re.compile(".*"))
    mods = dict(unet.named_modules())
    out = {}
    for path, ab in lora.items():
        if path not in targets:
            logger.warning("lora: no UNet Linear for %r, skipped", path)
            continue
        w = mods[targets[path]].weight
        a, b = (torch.as_tensor(ab[k]).to(w.device, torch.float32)
                for k in ("a", "b"))
        out[f"{targets[path]}.weight"] = (w.float()
                                          + (a @ b).T * scale).to(w.dtype)
    return out


def merge_lora(unet: nn.Module, lora: dict, scale: float) -> nn.Module:
    """A copy of ``unet`` with the adapters merged at ``scale``; its other
    weights are the original's tensors."""
    merged = merged_weights(unet, lora, scale)
    if not merged:
        raise ValueError("no LoRA adapter matched this UNet")
    out = shared_copy(unet)
    mods = dict(out.named_modules())
    for name, w in merged.items():
        mods[name[:-len(".weight")]].weight = nn.Parameter(
            w.detach(), requires_grad=False)
    return out


class LoRATrainer:
    """Trains rank-r adapters only; the base UNet stays frozen."""

    def __init__(self, models, rank: int = 8, alpha: float | None = None,
                 learning_rate: float = 1e-4, objective: str = "epsilon",
                 scheduler_config: Optional[SchedulerConfig] = None,
                 seed: int = 0, device: Optional[torch.device] = None):
        self.models = models
        self.rank = rank
        self.alpha = float(alpha if alpha is not None else rank)
        self.scale = self.alpha / rank
        if objective not in ("epsilon", "v_prediction"):
            raise ValueError(f"unknown objective {objective!r}")
        self.objective = objective
        self.device = torch.device(device) if device is not None else CUDA
        scfg = scheduler_config or models.scheduler_config
        self._acp = torch.tensor(alphas_cumprod_for(scfg),
                                 dtype=torch.float32, device=self.device)
        self._num_train_timesteps = scfg.num_train_timesteps
        base = models.unet
        if next(base.parameters()).device.type != self.device.type:
            base = copy.deepcopy(base).to(self.device)
        self.base = base
        self._targets = lora_targets(base)
        self.lora = {path: {k: t.to(self.device).requires_grad_(True)
                            for k, t in ab.items()}
                     for path, ab in init_lora_params(base, rank,
                                                      seed).items()}
        # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, decay 1e-4
        self.optimizer = torch.optim.AdamW(
            [t for ab in self.lora.values() for t in ab.values()],
            lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4)
        self.step_count = 0

    def _apply(self, noisy, t, context):
        weights = merged_weights(self.base, self.lora, self.scale,
                                 self._targets)
        return torch.func.functional_call(self.base, weights,
                                          (noisy, t, context))

    def train_step(self, latents, context, t, noise) -> float:
        """One step on given timesteps and noise (``UNetTrainer.train_step``'s
        arguments).  Returns the loss."""
        dev = self.device
        loss = denoising_loss(
            self._apply, self._acp,
            torch.as_tensor(latents, dtype=torch.float32, device=dev),
            torch.as_tensor(context, dtype=torch.float32, device=dev),
            torch.as_tensor(t, device=dev).long(),
            torch.as_tensor(noise, dtype=torch.float32, device=dev),
            self.objective)
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step_count += 1
        return float(loss.detach())

    def step(self, latents, context,
             generator: Optional[torch.Generator] = None) -> float:
        latents = torch.as_tensor(latents, dtype=torch.float32,
                                  device=self.device)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(
                self.step_count)
        t, noise = draw_t_and_noise(generator, latents,
                                    self._num_train_timesteps)
        return self.train_step(latents, context, t, noise)

    # ------------------------------------------------------------------
    def export_params(self):
        """A new ``SDModels`` whose UNet has the adapters merged."""
        with torch.no_grad():
            unet = merge_lora(self.base, self.lora, self.scale)
        return dataclasses.replace(self.models, unet=unet)

    def save_lora(self, path) -> None:
        """The adapters alone as ``.npz``: ``{path}::a``, ``{path}::b``,
        ``__rank__`` and ``__alpha__`` (the JAX package's format)."""
        arrs = {}
        for name, ab in self.lora.items():
            arrs[f"{name}::a"] = ab["a"].detach().cpu().numpy()
            arrs[f"{name}::b"] = ab["b"].detach().cpu().numpy()
        np.savez_compressed(path, __rank__=self.rank, __alpha__=self.alpha,
                            **arrs)
        logger.info("saved %d LoRA adapters -> %s", len(self.lora), path)

    @staticmethod
    def load_lora(path) -> tuple[dict, int, float]:
        """-> (adapters as CPU tensors, rank, alpha); merge with
        ``merge_lora(unet, lora, alpha / rank)``."""
        z = np.load(str(path) if str(path).endswith(".npz")
                    else str(path) + ".npz")
        lora: dict = {}
        for k in z.files:
            if k.startswith("__"):
                continue
            name, part = k.rsplit("::", 1)
            lora.setdefault(name, {})[part] = torch.from_numpy(z[k])
        return lora, int(z["__rank__"]), float(z["__alpha__"])
