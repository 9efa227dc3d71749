"""TAESD tiny autoencoder (Bohan 2023, github.com/madebyollin/taesd),
PyTorch NCHW.

Counterpart of ``stable_diffusion_videos_tpu/models/taesd.py``, with the
module names of diffusers' ``AutoencoderTiny``: ``decoder.layers`` and
``encoder.layers`` are one ``nn.Sequential`` each, whose index 0 is
conv_in, so a diffusers state dict loads without renaming (the upstream
decoder checkpoints put a parameter-free Clamp at index 0 and conv_in at 1;
their decoder indices are one higher, their encoder's the same).  The
decoder takes the sampler's scaled latents and emits images in [0, 1]; the
encoder takes [0, 1] images and emits scaled latents (upstream's
convention; diffusers maps both image ranges to [-1, 1]).  There is no
normalisation and no attention: 3x3 convolutions, ReLU, stride-2
convolutions padded (1, 1) and nearest 2x upsampling only.
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


class TAESDEncoder(nn.Module):
    """[0, 1] image (B, 3, H, W) -> scaled latents (B, 4, H/f, W/f)."""

    def __init__(self, cfg: TAESDConfig):
        super().__init__()
        layers = [_conv(cfg.image_channels, cfg.width),
                  TAESDBlock(cfg.width)]
        for _ in range(cfg.num_stages):
            layers.append(nn.Conv2d(cfg.width, cfg.width, 3, stride=2,
                                    padding=1, bias=False))
            layers += [TAESDBlock(cfg.width)
                       for _ in range(cfg.blocks_per_stage)]
        layers.append(_conv(cfg.width, cfg.latent_channels))
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class AutoencoderTiny(nn.Module):
    """``decoder``, and with ``encoder=True`` the ``encoder`` too, under
    diffusers' names."""

    def __init__(self, config: TAESDConfig, encoder: bool = False):
        super().__init__()
        self.config = config
        self.decoder = TAESDDecoder(config)
        self.encoder = TAESDEncoder(config) if encoder else None

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.layers[0].weight.dtype

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> image in [0, 1] (before the
        caller's clip), in the module's dtype."""
        return self.decoder(z.to(self.dtype))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[0, 1] image (B, 3, H, W) -> scaled latents, in the module's
        dtype."""
        if self.encoder is None:
            raise ValueError("this TAESD carries no encoder weights")
        return self.encoder(x.to(self.dtype))
