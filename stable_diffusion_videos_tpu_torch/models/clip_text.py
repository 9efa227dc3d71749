"""CLIP text encoder — prompt embedding, PyTorch.

Counterpart of ``stable_diffusion_videos_tpu/models/clip_text.py``: token +
learned position embeddings, pre-LN blocks with causal self-attention and a
quick-GELU (OpenAI CLIP) or exact-GELU (OpenCLIP) MLP, final LayerNorm.
``forward`` returns ``(hidden, pooled)``: the sequence output the UNet
consumes (the last hidden state after the final LayerNorm, or with
``penultimate_hidden`` the second-to-last layer's output before it, as SDXL
reads both towers) and the pooled output (the final-LN features at the EOS
token, through the bias-free ``text_projection`` when the config has
``projection_dim``).  Module names follow transformers' ``CLIPTextModel``
(``text_model.encoder.layers.0...``) and ``CLIPTextModelWithProjection``
(``text_projection.weight``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import masked_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    #: "quick_gelu" (OpenAI CLIP, SD 1.x) or "gelu" (OpenCLIP-H and bigG)
    hidden_act: str = "quick_gelu"
    #: the sequence output is the penultimate layer's hidden state, before
    #: the final LayerNorm (SDXL reads hidden_states[-2] of both towers);
    #: the pooled output still comes from the full tower and the final LN
    penultimate_hidden: bool = False
    #: width of the bias-free projection of the pooled output (the OpenCLIP
    #: tower whose pooled embedding feeds SDXL's text_time conditioning)
    projection_dim: Optional[int] = None
    #: the EOS id the pooled output is read at (its first occurrence); None
    #: takes ``argmax(input_ids)``, CLIP's rule for the stock vocabulary,
    #: where EOS is the highest id
    eos_token_id: Optional[int] = None

    @classmethod
    def sd_v1(cls):
        """openai/clip-vit-large-patch14 text tower (SD v1.x)."""
        return cls()

    @classmethod
    def sd_v2(cls):
        """The OpenCLIP ViT-H text tower as SD v2.x checkpoints ship it: 23
        layers (the penultimate layer's output), exact GELU."""
        return cls(hidden_size=1024, intermediate_size=4096, num_layers=23,
                   num_heads=16, hidden_act="gelu")

    @classmethod
    def sd_xl_l(cls):
        """SDXL tower 1: CLIP ViT-L, penultimate hidden states."""
        return cls(penultimate_hidden=True)

    @classmethod
    def sd_xl_g(cls):
        """SDXL tower 2: OpenCLIP ViT-bigG, penultimate hidden states and
        the projected pooled embedding that feeds text_time."""
        return cls(hidden_size=1280, intermediate_size=5120, num_layers=32,
                   num_heads=20, hidden_act="gelu", penultimate_hidden=True,
                   projection_dim=1280)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1000, hidden_size=32, intermediate_size=64,
                   num_layers=2, num_heads=2)

    @classmethod
    def tiny_v2(cls):
        """``tiny`` with the OpenCLIP activation (SD 2.x-shaped tests)."""
        return dataclasses.replace(cls.tiny(), hidden_act="gelu")

    @classmethod
    def tiny_xl_l(cls):
        """Tower 1 of the tiny SDXL bundle (the JAX package's
        ``SDModels.tiny_xl``): 16 wide, penultimate output."""
        return cls(vocab_size=1000, hidden_size=16, intermediate_size=32,
                   num_layers=2, num_heads=2, penultimate_hidden=True)

    @classmethod
    def tiny_xl_g(cls):
        """Tower 2 of the tiny SDXL bundle: ``tiny_xl_l`` with the pooled
        output projected to 16 (``UNetConfig.tiny_xl``'s pooled width)."""
        return dataclasses.replace(cls.tiny_xl_l(), projection_dim=16)


class CLIPAttention(nn.Module):
    def __init__(self, d: int, num_heads: int, causal: bool = True):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x):
        b, s, d = x.shape
        shape = (b, s, self.num_heads, d // self.num_heads)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        return self.out_proj(masked_attention(q, k, v, causal=self.causal)
                             .reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, config):
        super().__init__()
        if config.hidden_act not in ("quick_gelu", "gelu"):
            raise ValueError(f"unknown hidden_act {config.hidden_act!r}")
        self.quick = config.hidden_act == "quick_gelu"
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h) if self.quick
                        else F.gelu(h))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN block; ``causal`` is the text tower's mask (the image tower,
    ``models/safety.py``, attends over every position)."""

    def __init__(self, config, causal: bool = True):
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = CLIPAttention(d, config.num_heads, causal)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(config)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        self.position_embedding = nn.Embedding(
            config.max_position_embeddings, config.hidden_size)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) \
            + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(config) for _ in range(config.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(config)
        self.encoder = CLIPEncoder(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size,
                                             eps=config.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(
                config.hidden_size, config.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor):
        """input_ids: (B, S) int -> (hidden (B, S, D), pooled (B, D) or
        (B, projection_dim))."""
        cfg, tm = self.config, self.text_model
        x = tm.embeddings(input_ids)
        penult = x
        for i, layer in enumerate(tm.encoder.layers):
            x = layer(x)
            if i == cfg.num_layers - 2:
                penult = x  # hidden_states[-2]: after layer L-1, before LN
        x = tm.final_layer_norm(x)
        if cfg.eos_token_id is None:
            eos = input_ids.argmax(dim=-1)
        else:
            eos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos]
        if cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return (penult if cfg.penultimate_hidden else x), pooled
