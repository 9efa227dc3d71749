"""LPIPS perceptual distance (Zhang et al. 2018) on AlexNet or VGG16, NCHW.

Counterpart of ``stable_diffusion_videos_tpu/utils/lpips.py``.  The two
images are scaled into the backbone's input statistics (``_SHIFT``,
``_SCALE``), run together through the backbone's convolutions (cuDNN on the
card), each tapped activation is unit-normalised over its channels (plus
1e-10), the squared difference is projected to one channel by the tap's
learned 1x1 ``lin`` head, averaged over space and summed over the taps.
Taps: AlexNet after each of its 5 convolutions (3x3/2 max pools), VGG16 at
relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3 (2x2/2 pools).

The backbone is torchvision's ``features`` Sequential, index for index, so
its checkpoints load as they are; ``convert_lpips_torch`` also takes the
lpips package's ``net.sliceK.N.*`` backbone names and its heads under
``lin{j}.model.1.weight``, ``lins.{j}.model.1.weight`` or ``lin{j}.weight``.
No weights ship with the repository: ``load_lpips_weights`` reads a
``.npz`` or a ``torch.save``'d state dict.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

# torchvision's ``features``: ("conv", out, kernel, stride, padding),
# ("relu",) or ("pool", window), with the indices of the tapped ReLUs
_ALEX = [("conv", 64, 11, 4, 2), ("relu",), ("pool", 3),
         ("conv", 192, 5, 1, 2), ("relu",), ("pool", 3),
         ("conv", 384, 3, 1, 1), ("relu",),
         ("conv", 256, 3, 1, 1), ("relu",),
         ("conv", 256, 3, 1, 1), ("relu",)]
_ALEX_TAPS = (1, 4, 7, 9, 11)
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_VGG = []
for _i, (_c, _n) in enumerate(_VGG_STAGES):
    if _i:
        _VGG.append(("pool", 2))
    _VGG += [("conv", _c, 3, 1, 1), ("relu",)] * _n
_VGG_TAPS = (3, 8, 15, 22, 29)

# lpips ScalingLayer: [-1, 1] RGB into the backbone's input statistics
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _net_spec(net: str):
    if net == "alex":
        return _ALEX, _ALEX_TAPS
    if net == "vgg":
        return _VGG, _VGG_TAPS
    raise ValueError(f"unknown LPIPS backbone {net!r} (alex|vgg)")


class LPIPS(nn.Module):
    """``lpips(a, b)``: (B, 3, H, W) pairs in [-1, 1] -> (B,) distances."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        spec, self.taps = _net_spec(net)
        self.net = net
        layers, cin, widths = [], 3, []
        for i, layer in enumerate(spec):
            if layer[0] == "conv":
                _, cout, k, s, p = layer
                layers.append(nn.Conv2d(cin, cout, k, s, p))
                cin = cout
            elif layer[0] == "relu":
                layers.append(nn.ReLU())
                if i in self.taps:
                    widths.append(cin)
            else:
                layers.append(nn.MaxPool2d(layer[1], 2))
        self.features = nn.Sequential(*layers)
        for j, c in enumerate(widths):
            self.add_module(f"lin{j}", nn.Conv2d(c, 1, 1, bias=False))
        shift = torch.tensor(_SHIFT).reshape(1, 3, 1, 1)
        scale = torch.tensor(_SCALE).reshape(1, 3, 1, 1)
        self.register_buffer("shift", shift, persistent=False)
        self.register_buffer("scale", scale, persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = (torch.cat([a, b]) - self.shift) / self.scale
        total = 0.0
        j = 0
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i not in self.taps:
                continue
            f = x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
                     + 1e-10)
            fa, fb = f.chunk(2)
            total = total + getattr(self, f"lin{j}")(
                (fa - fb) ** 2).mean(dim=(1, 2, 3))
            j += 1
            if j == len(self.taps):
                break
        return total


def convert_lpips_torch(state: dict[str, Any], net: str = "alex") -> dict:
    """A state dict of torchvision backbone names (``features.N.*``) or the
    lpips package's (``net.sliceK.N.*``), with the ``lin`` heads under any
    of the three namings -> this module's names (``features.N.*``,
    ``lin{j}.weight`` of shape (1, C, 1, 1)).  Values may be tensors or
    numpy arrays; keys the module does not have are dropped."""
    spec, taps = _net_spec(net)
    convs = [i for i, layer in enumerate(spec) if layer[0] == "conv"]
    norm = {}
    for key, v in state.items():
        if key.startswith("net.slice"):
            key = "features." + key.split(".", 2)[2]
        norm[key] = v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
    out = {}
    for i in convs:
        for leaf in ("weight", "bias"):
            out[f"features.{i}.{leaf}"] = norm[f"features.{i}.{leaf}"]
    for j in range(len(taps)):
        for cand in (f"lin{j}.model.1.weight", f"lins.{j}.model.1.weight",
                     f"lin{j}.weight"):
            if cand in norm:
                out[f"lin{j}.weight"] = norm[cand].reshape(1, -1, 1, 1)
                break
        else:
            raise KeyError(f"no lin{j} head in state dict")
    return out


def load_lpips_weights(path, net: str = "alex", device="cuda") -> LPIPS:
    """A ``.npz`` or a ``torch.save``'d state dict (``.pth``/``.pt``) of
    LPIPS weights -> the fp32 module on ``device`` (the card unless the
    caller asks for the CPU), in eval mode without gradients."""
    if str(path).endswith(".npz"):
        with np.load(path) as f:
            state = {k: f[k] for k in f.files}
    else:
        state = torch.load(str(path), map_location="cpu", weights_only=True)
    model = LPIPS(net)
    model.load_state_dict({k: v.float() for k, v in
                           convert_lpips_torch(state, net).items()})
    return model.eval().requires_grad_(False).to(torch.device(device))


def _frames(x, device) -> tuple:
    """(B, H, W, 3) or (H, W, 3) frames -> (fp32 (B, H, W, 3) on
    ``device``, whether the input's dtype is an integer one)."""
    t = x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
    integer = not t.is_floating_point()
    t = t.to(device=device, dtype=torch.float32)
    return (t[None] if t.ndim == 3 else t), integer


def lpips_distance(a, b, model: LPIPS) -> np.ndarray:
    """(B, H, W, 3) or (H, W, 3) image pairs, numpy or tensors -> (B,)
    LPIPS, computed on ``model``'s device.  Integer input is on the 0-255
    scale; float input is read as 0-255 when either side's largest value
    passes 1.5, else as [0, 1]."""
    device = next(model.parameters()).device
    (ta, int_a), (tb, int_b) = _frames(a, device), _frames(b, device)
    scale = (255.0 if int_a or int_b
             or max(float(ta.max()), float(tb.max())) > 1.5 else 1.0)
    ta, tb = ((t / scale * 2.0 - 1.0).permute(0, 3, 1, 2) for t in (ta, tb))
    with torch.no_grad():
        return model(ta, tb).cpu().numpy()
