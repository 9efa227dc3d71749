"""The CLIP image tower and the NSFW safety checker, PyTorch.

Counterpart of ``stable_diffusion_videos_tpu/models/safety.py``
(``CLIPVisionConfig``, ``CLIPVisionEncoder``, ``SafetyConfig``,
``SafetyChecker``, ``preprocess_for_safety``).  The tower: a ViT with a
bias-free patch convolution, a class token and learned positions,
``pre_layrnorm``, pre-LN blocks with unmasked attention (plain PyTorch, as
``masked_attention`` is plain XLA in the JAX package) and the MLP
activation of the config, then
``post_layernorm`` at the class token.  ``CLIPVisionModelWithProjection``
adds the bias-free ``visual_projection``.  Module names follow transformers
(``vision_model.encoder.layers.0...``), so its state dicts load without
renaming.  The IP-Adapter (``models/ip_adapter.py``) embeds its image prompt
here.

The safety checker (diffusers' ``StableDiffusionSafetyChecker``, names and
all: ``vision_model.vision_model.*``, ``visual_projection``,
``concept_embeds``, ``special_care_embeds`` and their ``_weights``): OpenAI's
ViT-L/14 tower (quick_gelu), its projection normalised, cosines against 17
concept and 3 special-care embeddings, a frame flagged when a concept's
cosine passes its threshold; a special-care hit lowers every concept
threshold by 0.01.  The head's parameters stay fp32 whatever the tower's
dtype, as the JAX package's do.

``hidden_act`` is the config's: the JAX package hard-codes quick_gelu,
which is OpenAI CLIP's activation and the default here; OpenCLIP towers,
such as IP-Adapter SD 1.5's ViT-H/14 image encoder, declare exact ``gelu``
in their ``config.json``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from .clip_text import CLIPEncoderLayer

#: CLIPImageProcessor's normalisation
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    #: "quick_gelu" (OpenAI CLIP, the safety checker's tower) or "gelu"
    #: (OpenCLIP, e.g. IP-Adapter's ViT-H/14)
    hidden_act: str = "quick_gelu"

    @classmethod
    def vit_h14(cls):
        """OpenCLIP ViT-H/14, the image encoder IP-Adapter SD 1.5 ships
        (h94/IP-Adapter ``models/image_encoder``): 32 layers of 1280, 16
        heads, 5120-wide MLP, patch 14 at 224², projection 1024, exact
        GELU."""
        return cls(hidden_size=1280, intermediate_size=5120, num_layers=32,
                   num_heads=16, projection_dim=1024, hidden_act="gelu")

    @classmethod
    def tiny(cls):
        return cls(image_size=32, patch_size=8, hidden_size=32,
                   intermediate_size=64, num_layers=2, num_heads=2,
                   projection_dim=16)

    @classmethod
    def from_json(cls, cfg: dict) -> "CLIPVisionConfig":
        """A transformers ``config.json`` (CLIPVisionConfig, or a CLIPConfig
        with ``vision_config``) -> config, ``hidden_act`` included."""
        vc = cfg.get("vision_config", cfg)
        return cls(image_size=vc.get("image_size", 224),
                   patch_size=vc.get("patch_size", 14),
                   hidden_size=vc.get("hidden_size", 1024),
                   intermediate_size=vc.get("intermediate_size", 4096),
                   num_layers=vc.get("num_hidden_layers", 24),
                   num_heads=vc.get("num_attention_heads", 16),
                   projection_dim=cfg.get("projection_dim",
                                          vc.get("projection_dim", 768)),
                   layer_norm_eps=vc.get("layer_norm_eps", 1e-5),
                   hidden_act=vc.get("hidden_act", "quick_gelu"))


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        d = config.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(3, d, config.patch_size,
                                         stride=config.patch_size, bias=False)
        n = (config.image_size // config.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, d)

    def forward(self, pixels):
        x = self.patch_embedding(pixels.to(self.class_embedding.dtype))
        x = x.flatten(2).transpose(1, 2)                      # (B, P, D)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + self.position_embedding(pos)[None]


class CLIPVisionEncoderLayers(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(config, causal=False)
                                     for _ in range(config.num_layers)])


class CLIPVisionTransformer(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.embeddings = CLIPVisionEmbeddings(config)
        self.pre_layrnorm = nn.LayerNorm(d, eps=eps)
        self.encoder = CLIPVisionEncoderLayers(config)
        self.post_layernorm = nn.LayerNorm(d, eps=eps)

    def forward(self, pixels):
        x = self.pre_layrnorm(self.embeddings(pixels))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x[:, 0])


class CLIPVisionEncoder(nn.Module):
    """ViT image tower with its projection (``CLIPVisionModelWithProjection``):
    (B, 3, S, S) CLIP-normalised pixels -> the (B, projection_dim) image
    embedding, or with ``project=False`` the pooled (B, hidden) features."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size,
                                           config.projection_dim, bias=False)

    def forward(self, pixels, project: bool = True):
        pooled = self.vision_model(pixels)
        return self.visual_projection(pooled) if project else pooled


class CLIPVisionModel(nn.Module):
    """transformers' ``CLIPVisionModel``: the tower without a projection,
    under ``vision_model.*``."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.vision_model = CLIPVisionTransformer(config)

    def forward(self, pixels):
        return self.vision_model(pixels)


@dataclasses.dataclass(frozen=True)
class SafetyConfig:
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=CLIPVisionConfig)
    num_concepts: int = 17
    num_special: int = 3

    @classmethod
    def sd_v1(cls):
        """CompVis/stable-diffusion-safety-checker: OpenAI ViT-L/14 at 224²
        (patch 14, width 1024, 24 layers, 16 heads, projection 768,
        quick_gelu), 17 concepts and 3 special-care embeddings."""
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vision=CLIPVisionConfig.tiny())


#: the head's parameters, kept in fp32
SAFETY_HEAD = ("concept_embeds", "concept_embeds_weights",
               "special_care_embeds", "special_care_embeds_weights")


class SafetyChecker(nn.Module):
    """(B, 3, S, S) CLIP-normalised frames -> (B,) bool NSFW flags."""

    def __init__(self, config: SafetyConfig):
        super().__init__()
        self.config = config
        v, p = config.vision, config.vision.projection_dim
        self.vision_model = CLIPVisionModel(v)
        self.visual_projection = nn.Linear(v.hidden_size, p, bias=False)
        self.concept_embeds = nn.Parameter(torch.ones(config.num_concepts, p))
        self.concept_embeds_weights = nn.Parameter(
            torch.ones(config.num_concepts))
        self.special_care_embeds = nn.Parameter(
            torch.ones(config.num_special, p))
        self.special_care_embeds_weights = nn.Parameter(
            torch.ones(config.num_special))

    @property
    def dtype(self) -> torch.dtype:
        return self.visual_projection.weight.dtype

    def embed(self, pixels) -> torch.Tensor:
        """The projected image embedding, unit length, fp32: (B, 768)."""
        emb = self.visual_projection(self.vision_model(pixels)).float()
        return emb / emb.norm(dim=-1, keepdim=True)

    def forward(self, pixels, adjustment: float = 0.0) -> torch.Tensor:
        """``adjustment`` moves every threshold (diffusers: 0.0 strict,
        -0.01 lenient)."""
        emb = self.embed(pixels)

        def cos(embeds):
            embeds = embeds.float()
            return emb @ (embeds / embeds.norm(dim=-1, keepdim=True)).T

        special = (cos(self.special_care_embeds)
                   - self.special_care_embeds_weights.float() + adjustment)
        concept_adj = 0.01 * (special > 0).any(dim=1, keepdim=True)
        concept = (cos(self.concept_embeds)
                   - self.concept_embeds_weights.float() + adjustment
                   + concept_adj)
        return (concept > 0).any(dim=1)

    @classmethod
    def build(cls, config: SafetyConfig, state_dict: dict,
              dtype: torch.dtype = torch.float32) -> "SafetyChecker":
        """The checker of a diffusers-named state dict: the tower in
        ``dtype``, the head in fp32."""
        from .weights import load_state_dict
        with torch.device("meta"):
            checker = cls(config)
        load_state_dict(checker, state_dict, dtype)
        for name in SAFETY_HEAD:
            setattr(checker, name, nn.Parameter(
                getattr(checker, name).detach().float(), requires_grad=False))
        return checker.eval().requires_grad_(False)

    @classmethod
    def random(cls, config: SafetyConfig, seed: int, std: float,
               dtype: torch.dtype = torch.float32) -> "SafetyChecker":
        """Every weight drawn N(0, std) from a numpy seed but the
        LayerNorms', which start as an initialiser leaves them (scale 1,
        bias 0), so that the embedding carries the image, and the
        thresholds, 0.5 as the JAX package's initialiser sets them (a
        random embedding's cosine with a random concept is about
        ±1/sqrt(768), so nothing is flagged)."""
        from .weights import random_state_dict
        with torch.device("meta"):
            shapes = cls(config)
        sd = random_state_dict(shapes, seed, std)
        for name, mod in shapes.named_modules():
            if isinstance(mod, nn.LayerNorm):
                sd[f"{name}.weight"][:] = 1.0
                sd[f"{name}.bias"][:] = 0.0
        for name in ("concept_embeds_weights", "special_care_embeds_weights"):
            sd[name][:] = 0.5
        return cls.build(config, sd, dtype)


def load_safety_checker(directory, dtype: torch.dtype = torch.float32
                        ) -> SafetyChecker:
    """A diffusers ``safety_checker`` directory (``config.json`` with its
    ``vision_config``, and the weights file) -> the checker; the concept
    counts come from the tensors."""
    from .weights import find_weights_file, read_weights
    directory = Path(directory)
    vision = CLIPVisionConfig.from_json(
        json.loads((directory / "config.json").read_text()))
    sd = read_weights(find_weights_file(directory))
    # a buffer of older transformers releases, no weight
    sd.pop("vision_model.vision_model.embeddings.position_ids", None)
    config = SafetyConfig(vision=vision,
                          num_concepts=sd["concept_embeds"].shape[0],
                          num_special=sd["special_care_embeds"].shape[0])
    return SafetyChecker.build(config, sd, dtype)


def preprocess_for_safety(images: torch.Tensor,
                          image_size: int) -> torch.Tensor:
    """(B, H, W, 3) frames in [0, 1] -> CLIP-normalised (B, 3, S, S) fp32:
    bilinear with half-pixel centres, antialiased when it shrinks (as
    ``jax.image.resize(..., "bilinear")``)."""
    x = F.interpolate(images.float().permute(0, 3, 1, 2),
                      size=(image_size, image_size), mode="bilinear",
                      antialias=True, align_corners=False)
    # scalars, not a tensor built on the host: a copy to the card would
    # wait for every kernel queued before it
    return torch.stack([(x[:, c] - m) / s for c, (m, s) in enumerate(
        zip(CLIP_IMAGE_MEAN, CLIP_IMAGE_STD))], dim=1)
