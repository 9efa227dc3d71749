"""SDModels — the model bundle (configs, modules, tokenizer, scheduler
config) one pipeline drives.

Counterpart of ``stable_diffusion_videos_tpu/models/bundle.py``.  Modules are
built on the meta device and materialised by ``weights.load_state_dict``, so
a full-size bundle never holds a second, default-initialised copy of its
weights.  The repository holds no checkpoint, so both constructors draw
random weights from a numpy seed.  A bundle may carry the TAESD tiny decoder
beside the KL one (``with_taesd``).  Families: SD 1.x, SD 2.x (OpenCLIP-H,
64-channel heads; the 768-v point predicts v), SDXL-base (a second text
tower, OpenCLIP-bigG, whose projected pooled output feeds the UNet's
text_time conditioning; ``is_xl``) and the SDXL refiner (bigG alone, 5
text_time ids; ``refiner``).  A bundle may carry the NSFW safety checker
(``safety_checker()``), and ``with_freeu``/``with_tome`` give a copy whose
UNet applies FreeU or ToMe around the same weight tensors.  ``tiled``: the
UNet's and the KL autoencoder's 3x3 convolutions pad circularly, so frames
tile seamlessly (``with_tiled``).  ``from_pretrained`` loads a
diffusers-layout directory or hub id (``weights.load_sd_checkpoint``) or a
single original-layout file (``ldm.load_ldm_checkpoint``); ``save`` and
``load`` write and read the JAX package's native bundle format
(``models/io.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.schedulers import SchedulerConfig
from .clip_text import CLIPTextConfig, CLIPTextEncoder
from .layers import make_circular
from .safety import SafetyChecker, SafetyConfig
from .taesd import AutoencoderTiny, TAESDConfig
from .tokenizer import BaseTokenizer, HashTokenizer
from .unet import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig
from .weights import load_state_dict, random_state_dict, shared_copy


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
    #: SDXL's second text tower (OpenCLIP-bigG): the two towers' hidden
    #: states concatenate to the UNet's context width, and its projected
    #: pooled output feeds text_time
    text_config_2: Optional[CLIPTextConfig] = None
    text_encoder_2: Optional[CLIPTextEncoder] = None
    #: tower 2's tokenizer (OpenCLIP pads with 0, not with EOS)
    tokenizer_2: Optional[BaseTokenizer] = None
    #: the NSFW safety checker (``models/safety.py``), if attached
    safety: Optional[SafetyChecker] = None
    #: circular 3x3 convolutions in the UNet and the KL autoencoder (and an
    #: engine's ControlNets): seamlessly tileable frames
    tiled: bool = False
    #: the native format's scheduler fields that SchedulerConfig lacks
    #: (``models/io.py``), kept so that a bundle saves as it was read
    bundle_scheduler_fields: dict = dataclasses.field(default_factory=dict)

    @property
    def is_xl(self) -> bool:
        """SDXL family: two text towers and text_time conditioning."""
        return self.unet_config.addition_embed_dim is not None

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
        """The walk's default dispatch batch, the JAX package's per family,
        kept for parity: 8 for the 512²- and 768²-native families, 1 at a
        default size of 1024² or more (SDXL).  It is not a measurement on
        the card."""
        return 1 if self.default_size >= 1024 else 8

    def to(self, device: torch.device) -> "SDModels":
        """Move the modules to ``device`` (in place) and return the bundle."""
        for m in (self.unet, self.vae, self.text_encoder, self.text_encoder_2,
                  self.taesd, self.safety):
            if m is not None:
                m.to(device)
        return self

    def with_tiled(self) -> "SDModels":
        """The bundle with its UNet's and KL autoencoder's 3x3
        convolutions padding circularly (``layers.make_circular``, in
        place); TAESD keeps zero padding, as in the JAX package."""
        make_circular(self.unet)
        make_circular(self.vae)
        return dataclasses.replace(self, tiled=True)

    @classmethod
    def from_pretrained(cls, path, dtype: torch.dtype = torch.bfloat16,
                        tiled: bool = False, with_safety: bool = True,
                        tokenizer_dir=None,
                        prediction_type: Optional[str] = None
                        ) -> "SDModels":
        """A diffusers-layout directory or hub id
        (``weights.load_sd_checkpoint``), or one original-layout
        ``.ckpt``/``.safetensors`` file (``ldm.load_ldm_checkpoint``, its
        geometry from the tensors' shapes; ``tokenizer_dir`` and
        ``prediction_type`` apply to such files alone, which carry neither
        a vocabulary nor a scheduler config), on the CPU in ``dtype``."""
        from pathlib import Path
        if Path(path).is_file():
            from .ldm import load_ldm_checkpoint
            return load_ldm_checkpoint(path, tokenizer_dir=tokenizer_dir,
                                       dtype=dtype, tiled=tiled,
                                       prediction_type=prediction_type)
        from .weights import load_sd_checkpoint
        return load_sd_checkpoint(path, dtype=dtype, tiled=tiled,
                                  with_safety=with_safety)

    def save(self, path) -> str:
        """Write the bundle in the native format (``models/io.py``), which
        the JAX package's ``SDModels.load`` also reads; -> the path."""
        from .io import save_bundle
        return save_bundle(self, path)

    @classmethod
    def load(cls, path, dtype: Optional[torch.dtype] = None,
             device="cpu") -> "SDModels":
        """A native-format bundle directory, written by either package, on
        ``device`` in ``dtype`` (default: the bundle's)."""
        from .io import load_bundle
        return load_bundle(path, dtype=dtype, device=device)

    def param_count(self) -> dict[str, int]:
        """Parameters a component, under the native format's names."""
        from .io import param_count
        return param_count(self)

    def with_tome(self, ratio: float, max_level: int = 0) -> "SDModels":
        """Bundle copy whose UNet merges ``ratio`` of the self-attention
        tokens (ToMe-SD, ``ops/tome.py``) at the resolution levels up to
        ``max_level`` (0: the highest alone, tomesd's default); ratio 0
        switches it off.  The copy shares every weight tensor."""
        if not 0.0 <= ratio < 1.0:
            raise ValueError("tome ratio must be in [0, 1)")
        unet = shared_copy(self.unet)
        unet.set_tome((float(ratio), int(max_level)) if ratio else None)
        return dataclasses.replace(self, unet=unet)

    def with_freeu(self, freeu) -> "SDModels":
        """Bundle copy whose UNet applies FreeU: ``True`` takes the
        published factors of the family (Si et al. 2023: SD 1.x (1.5, 1.6,
        0.9, 0.2), SD 2.x, a 1024-wide context, (1.4, 1.6, 0.9, 0.2), SDXL
        (1.3, 1.4, 0.9, 0.2)), a 4-tuple sets (b1, b2, s1, s2), a false
        value switches it off.  The copy shares every weight tensor."""
        if freeu is True:
            if self.is_xl:
                freeu = (1.3, 1.4, 0.9, 0.2)
            elif self.unet_config.cross_attention_dim == 1024:
                freeu = (1.4, 1.6, 0.9, 0.2)
            else:
                freeu = (1.5, 1.6, 0.9, 0.2)
        elif freeu:
            freeu = tuple(float(f) for f in freeu)
            if len(freeu) != 4:
                raise ValueError("freeu must be (b1, b2, s1, s2)")
        unet = shared_copy(self.unet)
        unet.freeu = freeu or None
        return dataclasses.replace(self, unet=unet)

    def safety_checker(self) -> Optional[SafetyChecker]:
        """The safety checker module, or None when the bundle has none."""
        return self.safety

    def with_safety_checker(self, checker: SafetyChecker) -> "SDModels":
        """Bundle copy with ``checker`` attached, on the UNet's device."""
        checker.to(self.unet.conv_in.weight.device)
        return dataclasses.replace(self, safety=checker)

    def taesd_decoder(self):
        """The TAESD decoder module, or None when the bundle carries no
        tiny-autoencoder weights."""
        return None if self.taesd is None else self.taesd.decoder

    def with_taesd(self, config: TAESDConfig,
                   state_dict: dict) -> "SDModels":
        """Bundle copy with TAESD attached, from a diffusers
        ``AutoencoderTiny`` state dict (``decoder.layers.*``, and the
        encoder too when the dict has ``encoder.layers.*``), on the UNet's
        device and in its dtype.  The tiny autoencoder's pixel factor must
        be the KL one's, or latents would decode to another size."""
        if config.scale_factor != self.vae_scale_factor:
            raise ValueError(
                f"TAESD pixel factor {config.scale_factor}x does not match "
                f"the bundle VAE's {self.vae_scale_factor}x")
        encoder = any(k.startswith("encoder.") for k in state_dict)
        with torch.device("meta"):
            taesd = AutoencoderTiny(config, encoder=encoder)
        load_state_dict(taesd, state_dict, self.dtype)
        taesd.eval().requires_grad_(False).to(self.unet.conv_in.weight.device)
        return dataclasses.replace(self, taesd=taesd)

    @classmethod
    def build(cls, unet_config, vae_config, text_config, seed: int,
              std: float, dtype: torch.dtype,
              taesd_config: Optional[TAESDConfig] = None,
              text_config_2: Optional[CLIPTextConfig] = None,
              scheduler_config: Optional[SchedulerConfig] = None
              ) -> "SDModels":
        """Modules of the given geometry with every weight drawn N(0, std)
        from numpy seeds ``seed``, ``seed + 1``, ``seed + 2`` (and the
        TAESD decoder's and then encoder's, if a config is given, from
        ``seed + 3``; the second text tower's, if one is given, from
        ``seed + 4``), each cast to ``dtype`` as it is drawn."""
        configs = [unet_config, vae_config, text_config]
        builders = [UNet2DCondition, AutoencoderKL, CLIPTextEncoder]
        seeds = [seed, seed + 1, seed + 2]
        if text_config_2 is not None:
            configs.append(text_config_2)
            builders.append(CLIPTextEncoder)
            seeds.append(seed + 4)
        mods = []
        for build, cfg, s in zip(builders, configs, seeds):
            with torch.device("meta"):
                m = build(cfg)
            load_state_dict(m, random_state_dict(m, s, std, dtype), dtype)
            mods.append(m.eval().requires_grad_(False))
        vocab = text_config.vocab_size
        models = cls(unet_config, vae_config, text_config, *mods[:3],
                     HashTokenizer(vocab_size=vocab),
                     scheduler_config or SchedulerConfig())
        if text_config_2 is not None:
            models = dataclasses.replace(
                models, text_config_2=text_config_2, text_encoder_2=mods[3],
                tokenizer_2=HashTokenizer(
                    vocab_size=text_config_2.vocab_size, pad_token_id=0))
        if taesd_config is None:
            return models
        with torch.device("meta"):
            shapes = AutoencoderTiny(taesd_config, encoder=True)
        return models.with_taesd(
            taesd_config, random_state_dict(shapes, seed + 3, std, dtype))

    @classmethod
    def tiny(cls, seed: int = 0, taesd: bool = False,
             with_safety: bool = False, tiled: bool = False) -> "SDModels":
        """Tiny fp32 bundle: every code path, CPU-runnable; with ``taesd``
        a one-stage TAESD decoder too, with ``with_safety`` a tiny safety
        checker (weights from ``seed + 5``), with ``tiled`` circular
        convolutions."""
        models = cls.build(UNetConfig.tiny(), VAEConfig.tiny(),
                           CLIPTextConfig.tiny(), seed, 0.1, torch.float32,
                           TAESDConfig.tiny() if taesd else None)
        if tiled:
            models = models.with_tiled()
        if not with_safety:
            return models
        return models.with_safety_checker(SafetyChecker.random(
            SafetyConfig.tiny(), seed + 5, 0.1))

    @classmethod
    def tiny_xl(cls, seed: int = 0) -> "SDModels":
        """Tiny fp32 SDXL-shaped bundle (the JAX package's
        ``SDModels.tiny_xl`` geometry): two 16-wide towers making the
        32-wide context, per-level depth (0, 2) and text_time; tower 2's
        tokenizer pads with 0."""
        return cls.build(UNetConfig.tiny_xl(), VAEConfig.tiny(),
                         CLIPTextConfig.tiny_xl_l(), seed, 0.1, torch.float32,
                         text_config_2=CLIPTextConfig.tiny_xl_g())

    @classmethod
    def tiny_refiner(cls, seed: int = 0) -> "SDModels":
        """Tiny fp32 SDXL-refiner-shaped bundle: the 16-wide projected
        tower alone (``refiner``) and ``UNetConfig.tiny_refiner``."""
        return cls.refiner(cls.build(
            UNetConfig.tiny_refiner(), VAEConfig.tiny(),
            CLIPTextConfig.tiny_xl_g(), seed, 0.1, torch.float32))

    @classmethod
    def random(cls, family: str = "sd1", seed: int = 1,
               dtype: torch.dtype = torch.bfloat16, taesd: bool = False,
               with_safety: bool = False) -> "SDModels":
        """A family's published geometry with weights drawn N(0, 0.02):
        "sd1" (CLIP-L, the 860M UNet, the KL autoencoder), "sd2" (SD 2.1
        768-v: OpenCLIP-H, the UNet at 96² latents, SD 1.x's VAE, a
        v-prediction scheduler config), "sdxl" (SDXL-base 1.0: CLIP-L and
        OpenCLIP-bigG, the 2.6B UNet at 128² latents, the SDXL VAE) or
        "sdxl_refiner" (SDXL-refiner 1.0: OpenCLIP-bigG alone, the 2.3B
        refiner UNet, the SDXL VAE); with ``taesd`` the TAESD decoder and
        encoder at their published geometry too, with ``with_safety`` the
        safety checker at CompVis's geometry (``SafetyChecker.random``,
        seed ``seed + 5``).  The 0.02 is load-bearing in bf16: unit-scale
        weights overflow the UNet's residual sums within a few blocks."""
        models = cls._random(family, seed, dtype, taesd)
        if not with_safety:
            return models
        return models.with_safety_checker(SafetyChecker.random(
            SafetyConfig.sd_v1(), seed + 5, 0.02, dtype))

    @classmethod
    def _random(cls, family: str, seed: int, dtype: torch.dtype,
                taesd: bool) -> "SDModels":
        taesd_config = TAESDConfig.sd() if taesd else None
        if family == "sd1":
            return cls.build(UNetConfig.sd_v1(), VAEConfig.sd_v1(),
                             CLIPTextConfig.sd_v1(), seed, 0.02, dtype,
                             taesd_config)
        if family == "sd2":
            return cls.build(UNetConfig.sd_v2(96), VAEConfig.sd_v1(),
                             CLIPTextConfig.sd_v2(), seed, 0.02, dtype,
                             taesd_config, scheduler_config=SchedulerConfig(
                                 prediction_type="v_prediction"))
        if family == "sdxl":
            return cls.build(UNetConfig.sd_xl(), VAEConfig.sd_xl(),
                             CLIPTextConfig.sd_xl_l(), seed, 0.02, dtype,
                             taesd_config,
                             text_config_2=CLIPTextConfig.sd_xl_g())
        if family == "sdxl_refiner":
            return cls.refiner(cls.build(
                UNetConfig.sd_xl_refiner(), VAEConfig.sd_xl(),
                CLIPTextConfig.sd_xl_g(), seed, 0.02, dtype, taesd_config))
        raise ValueError(f"unknown model family {family!r}; the port has "
                         "'sd1', 'sd2', 'sdxl' and 'sdxl_refiner'")

    @classmethod
    def refiner(cls, models: "SDModels") -> "SDModels":
        """The SDXL refiner's layout from a bundle whose primary tower is
        OpenCLIP-bigG: that tower is also ``text_encoder_2`` (the same
        module; the JAX package's loader gives a refiner
        ``text_config == text_config_2``), the source of the context (the
        UNet's 1280-wide ``cross_attention_dim``) and of the pooled
        embedding; its tokenizer pads with 0."""
        tok = HashTokenizer(vocab_size=models.text_config.vocab_size,
                            pad_token_id=0)
        return dataclasses.replace(
            models, tokenizer=tok, text_config_2=models.text_config,
            text_encoder_2=models.text_encoder, tokenizer_2=tok)
