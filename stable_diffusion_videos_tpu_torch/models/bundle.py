"""SDModels — the model bundle (configs, modules, tokenizer, scheduler
config) one pipeline drives.

Counterpart of ``stable_diffusion_videos_tpu/models/bundle.py``.  Modules are
built on the meta device and materialised by ``weights.load_state_dict``, so
a full-size bundle never holds a second, default-initialised copy of its
weights.  The repository holds no checkpoint, so both constructors draw
random weights from a numpy seed.  A bundle may carry the TAESD tiny decoder
beside the KL decoder (``with_taesd``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.schedulers import SchedulerConfig
from .clip_text import CLIPTextConfig, CLIPTextEncoder
from .taesd import AutoencoderTiny, TAESDConfig
from .tokenizer import BaseTokenizer, HashTokenizer
from .unet import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig
from .weights import load_state_dict, random_state_dict


@dataclasses.dataclass
class SDModels:
    unet_config: UNetConfig
    vae_config: VAEConfig
    text_config: CLIPTextConfig
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    tokenizer: BaseTokenizer
    scheduler_config: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    #: the TAESD tiny decoder (``Engine(tiny_decoder=True)``), if attached
    taesd: Optional[AutoencoderTiny] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.dtype

    @property
    def vae_scale_factor(self) -> int:
        return self.vae_config.scale_factor

    @property
    def default_size(self) -> int:
        """Default image side: UNet sample size times the VAE factor."""
        return self.unet_config.sample_size * self.vae_scale_factor

    @property
    def default_batch_size(self) -> int:
        """The walk's default dispatch batch: 8, the JAX package's default
        for the 512²-native families, kept for parity.  It is not a
        measurement on the card."""
        return 8

    def to(self, device: torch.device) -> "SDModels":
        """Move the modules to ``device`` (in place) and return the bundle."""
        for m in (self.unet, self.vae, self.text_encoder, self.taesd):
            if m is not None:
                m.to(device)
        return self

    def taesd_decoder(self):
        """The TAESD decoder module, or None when the bundle carries no
        tiny-autoencoder weights."""
        return None if self.taesd is None else self.taesd.decoder

    def with_taesd(self, config: TAESDConfig,
                   state_dict: dict) -> "SDModels":
        """Bundle copy with TAESD attached, from a diffusers
        ``AutoencoderTiny`` state dict (``decoder.layers.*``; encoder keys
        are dropped), on the UNet's device and in its dtype.  The tiny
        decoder's pixel factor must be the KL decoder's, or latents would
        decode to another size."""
        if config.scale_factor != self.vae_scale_factor:
            raise ValueError(
                f"TAESD pixel factor {config.scale_factor}x does not match "
                f"the bundle VAE's {self.vae_scale_factor}x")
        with torch.device("meta"):
            taesd = AutoencoderTiny(config)
        load_state_dict(taesd, state_dict, self.dtype)
        taesd.eval().requires_grad_(False).to(self.unet.conv_in.weight.device)
        return dataclasses.replace(self, taesd=taesd)

    @classmethod
    def build(cls, unet_config, vae_config, text_config, seed: int,
              std: float, dtype: torch.dtype,
              taesd_config: Optional[TAESDConfig] = None) -> "SDModels":
        """Modules of the given geometry with every weight drawn N(0, std)
        from numpy seeds ``seed``, ``seed + 1``, ``seed + 2`` (and the
        TAESD decoder's, if a config is given, from ``seed + 3``)."""
        with torch.device("meta"):
            mods = (UNet2DCondition(unet_config), AutoencoderKL(vae_config),
                    CLIPTextEncoder(text_config))
        for i, m in enumerate(mods):
            load_state_dict(m, random_state_dict(m, seed + i, std), dtype)
            m.eval().requires_grad_(False)
        models = cls(unet_config, vae_config, text_config, *mods,
                     HashTokenizer(vocab_size=text_config.vocab_size))
        if taesd_config is None:
            return models
        with torch.device("meta"):
            shapes = AutoencoderTiny(taesd_config)
        return models.with_taesd(taesd_config,
                                 random_state_dict(shapes, seed + 3, std))

    @classmethod
    def tiny(cls, seed: int = 0, taesd: bool = False) -> "SDModels":
        """Tiny fp32 bundle: every code path, CPU-runnable; with ``taesd``
        a one-stage TAESD decoder too."""
        return cls.build(UNetConfig.tiny(), VAEConfig.tiny(),
                         CLIPTextConfig.tiny(), seed, 0.1, torch.float32,
                         TAESDConfig.tiny() if taesd else None)

    @classmethod
    def random(cls, family: str = "sd1", seed: int = 1,
               dtype: torch.dtype = torch.bfloat16,
               taesd: bool = False) -> "SDModels":
        """The real SD 1.x geometry (CLIP-L text tower, the 860M UNet, the
        KL decoder) with weights drawn N(0, 0.02); with ``taesd`` the TAESD
        decoder at its published geometry too.  The 0.02 is load-bearing
        in bf16: unit-scale weights overflow the UNet's residual sums within
        a few blocks."""
        if family != "sd1":
            raise ValueError(f"unknown model family {family!r}; the port "
                             "has 'sd1'")
        return cls.build(UNetConfig.sd_v1(), VAEConfig.sd_v1(),
                         CLIPTextConfig.sd_v1(), seed, 0.02, dtype,
                         TAESDConfig.sd() if taesd else None)
