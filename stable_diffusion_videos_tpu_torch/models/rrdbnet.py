"""RRDBNet, the Real-ESRGAN generator, PyTorch NCHW.

Counterpart of ``stable_diffusion_videos_tpu/models/rrdbnet.py`` under
basicsr's names (``conv_first``, ``body.{i}.rdb{r}.conv{c}``,
``conv_body``, ``conv_up1``, ``conv_up2``, ``conv_hr``, ``conv_last``), so
the published checkpoints load without renaming: ``num_block``
residual-in-residual dense blocks of 3 dense blocks each (leaky ReLU 0.2,
residual scale 0.2), two nearest-2x upsampling convolutions, ``conv_hr`` and
``conv_last``, the output clipped to [0, 1].  The trunk always upsamples
4x; a net of scale 2 (1) takes its input pixel-unshuffled by 2 (4), so its
``conv_first`` reads 12 (48) channels.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class RRDBNetConfig:
    in_channels: int = 3
    out_channels: int = 3
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    scale: int = 4

    @classmethod
    def x4plus(cls):
        """RealESRGAN_x4plus: 64 features, 23 blocks, growth 32, scale 4
        (16.7M parameters)."""
        return cls()

    @classmethod
    def tiny(cls):
        return cls(num_feat=16, num_block=2, num_grow_ch=8)


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.2)


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        f, g = num_feat, num_grow_ch
        self.conv1 = _conv(f, g)
        self.conv2 = _conv(f + g, g)
        self.conv3 = _conv(f + 2 * g, g)
        self.conv4 = _conv(f + 3 * g, g)
        self.conv5 = _conv(f + 4 * g, f)

    def forward(self, x):
        x1 = _lrelu(self.conv1(x))
        x2 = _lrelu(self.conv2(torch.cat([x, x1], 1)))
        x3 = _lrelu(self.conv3(torch.cat([x, x1, x2], 1)))
        x4 = _lrelu(self.conv4(torch.cat([x, x1, x2, x3], 1)))
        return self.conv5(torch.cat([x, x1, x2, x3, x4], 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    def __init__(self, config: RRDBNetConfig):
        super().__init__()
        self.config = cfg = config
        f = cfg.num_feat
        unshuffle = {4: 1, 2: 2, 1: 4}[cfg.scale]
        self.conv_first = _conv(cfg.in_channels * unshuffle ** 2, f)
        self.body = nn.Sequential(*[RRDB(f, cfg.num_grow_ch)
                                    for _ in range(cfg.num_block)])
        self.conv_body = _conv(f, f)
        self.conv_up1 = _conv(f, f)
        self.conv_up2 = _conv(f, f)
        self.conv_hr = _conv(f, f)
        self.conv_last = _conv(f, cfg.out_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_first.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [0, 1] -> fp32 (B, 3, scale·H, scale·W) in
        [0, 1], computed in the module's dtype."""
        x = x.to(self.dtype)
        if self.config.scale < 4:
            x = F.pixel_unshuffle(x, 4 // self.config.scale)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        for up in (self.conv_up1, self.conv_up2):
            feat = _lrelu(up(F.interpolate(feat, scale_factor=2.0,
                                           mode="nearest")))
        out = self.conv_last(_lrelu(self.conv_hr(feat)))
        return out.float().clamp(0.0, 1.0)
