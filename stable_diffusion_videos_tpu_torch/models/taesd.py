"""TAESD tiny decoder (Bohan 2023, github.com/madebyollin/taesd), PyTorch
NCHW.

Counterpart of the decoder half of ``stable_diffusion_videos_tpu/models/
taesd.py``, with the module names of diffusers' ``AutoencoderTiny``:
``decoder.layers`` is one ``nn.Sequential`` whose index 0 is conv_in, so a
diffusers state dict loads without renaming (the upstream checkpoints put a
parameter-free Clamp at index 0 and conv_in at 1; their indices are one
higher).  The decoder takes the sampler's scaled latents and emits images
in [0, 1] (upstream's convention; diffusers maps them to [-1, 1]).  There
is no normalisation and no attention: 3x3 convolutions, ReLU and nearest
2x upsampling only.  The encoder serves the edit paths and is not ported
yet (``SKIPPED_PREFIXES``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TAESDConfig:
    latent_channels: int = 4
    image_channels: int = 3
    #: channel width of every hidden convolution
    width: int = 64
    #: 2x upsampling stages: the pixel factor is 2 ** num_stages
    num_stages: int = 3
    #: residual blocks a stage
    blocks_per_stage: int = 3

    @property
    def scale_factor(self) -> int:
        return 2 ** self.num_stages

    @classmethod
    def sd(cls) -> "TAESDConfig":
        """The published geometry (taesd: width 64, 3 stages, 3 blocks)."""
        return cls()

    @classmethod
    def tiny(cls) -> "TAESDConfig":
        """The tiny bundle's geometry (its KL decoder's 2x factor)."""
        return cls(width=16, num_stages=1, blocks_per_stage=1)


def _conv(c_in: int, c_out: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, padding=1, bias=bias)


class TAESDBlock(nn.Module):
    """conv-ReLU-conv-ReLU-conv plus the identity, then ReLU (diffusers'
    ``AutoencoderTinyBlock`` at equal widths)."""

    def __init__(self, width: int):
        super().__init__()
        self.conv = nn.Sequential(_conv(width, width), nn.ReLU(),
                                  _conv(width, width), nn.ReLU(),
                                  _conv(width, width))

    def forward(self, x):
        return torch.relu(self.conv(x) + x)


class TAESDDecoder(nn.Module):
    """Scaled latents (B, 4, h, w) -> [0, 1] image (B, 3, h·f, w·f)."""

    def __init__(self, cfg: TAESDConfig):
        super().__init__()
        layers = [_conv(cfg.latent_channels, cfg.width), nn.ReLU()]
        for _ in range(cfg.num_stages):
            layers += [TAESDBlock(cfg.width)
                       for _ in range(cfg.blocks_per_stage)]
            layers += [nn.Upsample(scale_factor=2, mode="nearest"),
                       _conv(cfg.width, cfg.width, bias=False)]
        layers += [TAESDBlock(cfg.width),
                   _conv(cfg.width, cfg.image_channels)]
        self.layers = nn.Sequential(*layers)

    def forward(self, z):
        # TAESD's clamp: soft-limit latents to (-3, 3)
        return self.layers(torch.tanh(z / 3.0) * 3.0)


class AutoencoderTiny(nn.Module):
    """``decoder`` under diffusers' names; the encoder is not ported."""

    SKIPPED_PREFIXES = ("encoder.",)

    def __init__(self, config: TAESDConfig):
        super().__init__()
        self.config = config
        self.decoder = TAESDDecoder(config)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.layers[0].weight.dtype

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> image in [0, 1] (before the
        caller's clip), in the module's dtype."""
        return self.decoder(z.to(self.dtype))
