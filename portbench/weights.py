"""Weights drawn by the benchmark from ``--seed``, on the device.

Every parameter of every component is N(0, std) (the configuration's
``weight_std``), under its diffusers name, in the configuration's dtype:
one ``torch.randn`` a component on a ``torch.Generator`` of the device,
cast once and cut into the parameters' views, in the order of the
reference modules' state dicts.  The same seed gives the same tensors, so
the reference draws them again after the program's state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def component_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([int(seed), 1000 + index])
               .generate_state(1, np.uint64)[0] >> 1)


def norm_scales(module) -> set:
    """Names of the GroupNorm and LayerNorm scales of ``module``."""
    return {f"{n}.weight" for n, m in module.named_modules()
            if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm))}


def draw(shapes: dict, seed: int, std: float, dtype: torch.dtype,
         device) -> dict:
    """{component: {name: tensor}} for ``shapes`` ({component: module},
    meta-device modules whose state dicts give names and shapes).  Every
    parameter is N(0, std) but the norms' scales, 1 + N(0, std): with
    scales near 0 each norm shrinks its branch, the UNet's output stays
    near 1% of the noise and the frames hardly depend on it."""
    out = {}
    for i, (comp, mod) in enumerate(shapes.items()):
        sd = mod.state_dict()
        ones = norm_scales(mod)
        n = sum(v.numel() for v in sd.values())
        g = torch.Generator(device).manual_seed(component_seed(seed, i))
        flat = torch.randn(n, generator=g, device=device,
                           dtype=torch.float32).mul_(std)
        at, spans = 0, []
        for k, v in sd.items():
            spans.append((k, at, v.shape))
            if k in ones:
                flat[at:at + v.numel()] += 1.0
            at += v.numel()
        flat = flat.to(dtype)
        out[comp] = {k: flat[a:a + s.numel()].view(s) for k, a, s in spans}
    return out
