"""AutoencoderKL — images to latents and back, PyTorch NCHW.

Counterpart of ``stable_diffusion_videos_tpu/models/vae.py``: the
``Encoder`` and ``quant_conv`` (``encode``: the posterior's mean and its
log-variance clipped to [-30, 20]), the ``post_quant_conv`` and the
``Decoder``, under diffusers names (``encoder.*``, ``decoder.*``).  The
encoder's downsamplers pad (0, 1), diffusers' ``padding=0`` form.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .layers import (Downsample2D, GroupNorm32, ResnetBlock2D, Upsample2D,
                     VAEAttnBlock)
from .unet import UNetBlock

SD_LATENT_SCALE = 0.18215
SDXL_LATENT_SCALE = 0.13025


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = SD_LATENT_SCALE

    @property
    def scale_factor(self) -> int:
        """Spatial up-sampling factor of the decoder (8 for SD 1.x)."""
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def sd_v1(cls):
        return cls()

    @classmethod
    def sd_xl(cls):
        """SDXL's VAE (sdxl-vae): SD 1.x's geometry, its own latent scale."""
        return cls(scaling_factor=SDXL_LATENT_SCALE)

    @classmethod
    def tiny(cls):
        return cls(block_out_channels=(32, 64), layers_per_block=1)


class Encoder(nn.Module):
    """Image (B, 3, H, W) in [-1, 1] -> moments (B, 2·latent, H/f, W/f)."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        chans = config.block_out_channels
        n = len(chans)
        ch = chans[0]
        self.conv_in = nn.Conv2d(config.in_channels, ch, 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for level, out_ch in enumerate(chans):
            resnets = []
            for _ in range(config.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, eps=1e-6))
                ch = out_ch
            down = (Downsample2D(ch, asymmetric=True) if level != n - 1
                    else None)
            self.down_blocks.append(UNetBlock(resnets, downsample=down))
        self.mid_block = UNetBlock(
            [ResnetBlock2D(ch, ch, eps=1e-6), ResnetBlock2D(ch, ch, eps=1e-6)],
            [VAEAttnBlock(ch)])
        self.conv_norm_out = GroupNorm32(ch, 32, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * config.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        chans = config.block_out_channels
        n = len(chans)
        ch = chans[-1]
        self.conv_in = nn.Conv2d(config.latent_channels, ch, 3, padding=1)
        self.mid_block = UNetBlock(
            [ResnetBlock2D(ch, ch, eps=1e-6), ResnetBlock2D(ch, ch, eps=1e-6)],
            [VAEAttnBlock(ch)])
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            out_ch = chans[n - 1 - i]
            resnets = []
            for _ in range(config.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch, out_ch, eps=1e-6))
                ch = out_ch
            up = Upsample2D(ch) if i != n - 1 else None
            self.up_blocks.append(UNetBlock(resnets, upsample=up))
        self.conv_norm_out = GroupNorm32(ch, 32, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, config.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.conv_in(z)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class AutoencoderKL(nn.Module):
    """``Encoder`` + ``quant_conv``, ``post_quant_conv`` + ``Decoder``."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> tuple:
        """Image (B, 3, H, W) in [-1, 1] -> (mean, logvar) of the latent
        posterior, each (B, 4, H/f, W/f) in the module's dtype (unscaled:
        the caller multiplies the mean by the scaling factor)."""
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, 4, h, w), already divided by the scaling factor ->
        image (B, 3, H, W) in about [-1, 1], in the module's dtype."""
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))
