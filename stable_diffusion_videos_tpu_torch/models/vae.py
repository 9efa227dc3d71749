"""AutoencoderKL decode path — latents to images, PyTorch NCHW.

Counterpart of ``stable_diffusion_videos_tpu/models/vae.py``: the
``post_quant_conv`` and the ``Decoder`` (diffusers names ``decoder.*``).  The
encoder and ``quant_conv`` wait for the img2img paths, so their weights are
left out when a state dict is loaded (``SKIPPED_PREFIXES``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .layers import GroupNorm32, ResnetBlock2D, Upsample2D, VAEAttnBlock
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
    """``post_quant_conv`` + ``Decoder``."""

    #: diffusers keys of the parts this slice does not port
    SKIPPED_PREFIXES = ("encoder.", "quant_conv.")

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, 4, h, w), already divided by the scaling factor ->
        image (B, 3, H, W) in about [-1, 1], in the module's dtype."""
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))
