"""The CLIP image tower, PyTorch.

Counterpart of the tower in ``stable_diffusion_videos_tpu/models/safety.py``
(``CLIPVisionConfig``, ``CLIPVisionEncoder``): a ViT with a bias-free patch
convolution, a class token and learned positions, ``pre_layrnorm``, pre-LN
blocks with unmasked attention (plain PyTorch, as ``masked_attention`` is
plain XLA in the JAX package) and the MLP activation of the config, then
``post_layernorm`` at the class token.  ``CLIPVisionModelWithProjection``
adds the bias-free ``visual_projection``.  Module names follow transformers
(``vision_model.encoder.layers.0...``), so its state dicts load without
renaming.  The IP-Adapter (``models/ip_adapter.py``) embeds its image prompt
here.  The NSFW concept head of the safety checker is not ported.

``hidden_act`` is the config's: the JAX package hard-codes quick_gelu,
which is OpenAI CLIP's activation and the default here; OpenCLIP towers,
such as IP-Adapter SD 1.5's ViT-H/14 image encoder, declare exact ``gelu``
in their ``config.json``.
"""

from __future__ import annotations

import dataclasses

import torch
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
