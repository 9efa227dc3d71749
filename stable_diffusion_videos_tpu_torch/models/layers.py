"""Shared neural blocks of the SD 1.x models, PyTorch NCHW.

Counterpart of ``stable_diffusion_videos_tpu/models/layers.py``.  Module and
parameter names follow diffusers, so diffusers-named state dicts load
without renaming.  Every GroupNorm goes through the GroupNorm(+SiLU) op and
every attention through the flash attention op (``ops/``).  A module computes
in the dtype of its parameters; GroupNorm statistics and softmax run in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.groupnorm import fused_groupnorm_silu
from ..ops.tome import tome_wrap


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, diffusers-compatible: (B,) -> (B, dim)
    in fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedMLP(nn.Module):
    """Linear -> SiLU -> Linear projection of the sinusoidal embedding."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics; ``silu=True`` fuses the following
    SiLU.  Always the GroupNorm(+SiLU) op (the JAX package routes through
    its kernel only behind ``SDV_FUSED_GN``)."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, silu: bool = False):
        return fused_groupnorm_silu(x, self.weight, self.bias,
                                    self.num_groups, self.eps, silu)


class ResnetBlock2D(nn.Module):
    """GN->SiLU->Conv3x3 [+temb] ->GN->SiLU->Conv3x3, residual shortcut.
    ``eps`` is 1e-5 in the UNet and 1e-6 in the VAE."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int | None = None, eps: float = 1e-5,
                 groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, groups, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm32(out_channels, groups, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x, silu=True))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return h + x


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv.  The UNet pads (1, 1) on both axes; the VAE
    encoder (``asymmetric``) pads (0, 1): the same output shape, other
    taps."""

    def __init__(self, channels: int, asymmetric: bool = False):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = nn.Conv2d(channels, channels, 3, stride=2,
                              padding=0 if asymmetric else 1)

    def forward(self, x):
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when ``context`` is None.

    IP-Adapter decoupled cross-attention (Ye et al. 2023): ``context`` may
    be a ``(text context, image tokens, scale)`` tuple.  The image tokens go
    through their own bias-free ``to_k_ip``/``to_v_ip`` projections (added
    by ``ip_adapter.IPAdapter.splice``) and a second attention call, whose
    output, times the scale, is added before ``to_out``."""

    def __init__(self, query_dim: int, context_dim: int, num_heads: int,
                 head_dim: int):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None):
        ip = None
        if isinstance(context, tuple):
            context, *ip = context
        context = x if context is None else context
        b, sq, _ = x.shape
        shape = (b, -1, self.num_heads, self.head_dim)
        q = self.to_q(x).view(shape)
        out = attention(q, self.to_k(context).view(shape),
                        self.to_v(context).view(shape))
        if ip is not None:
            tokens, scale = ip
            if not hasattr(self, "to_k_ip"):
                raise ValueError("image tokens (ip_context) given to an "
                                 "attention without IP-Adapter projections "
                                 "(to_k_ip/to_v_ip): splice an adapter "
                                 "first")
            out = out + scale * attention(q, self.to_k_ip(tokens).view(shape),
                                          self.to_v_ip(tokens).view(shape))
        return self.to_out[0](out.reshape(b, sq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    """GEGLU (exact gelu) -> Linear; ``net.1`` is diffusers' parameter-free
    dropout slot."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU FF, pre-LN residual blocks.

    ``tome_ratio`` > 0 runs the self-attention on the ToMe-merged normed
    tokens (``ops/tome.py``: merge, attn1, unmerge; ``hw`` is the token
    grid the 2x2 partition needs); the cross-attention, the IP-Adapter's
    second attention and the FF see every token."""

    def __init__(self, dim: int, context_dim: int, num_heads: int,
                 head_dim: int, tome_ratio: float = 0.0):
        super().__init__()
        self.tome_ratio = tome_ratio
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context, hw=None):
        h = self.norm1(x)
        if self.tome_ratio > 0.0:
            x = x + tome_wrap(self.attn1, h, *hw, self.tome_ratio)
        else:
            x = x + self.attn1(h)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer2DModel: GN -> 1x1 proj_in -> N blocks -> 1x1 proj_out
    + residual.  diffusers fixes this GN's eps at 1e-6."""

    def __init__(self, channels: int, context_dim: int, num_heads: int,
                 depth: int = 1):
        super().__init__()
        self.norm = GroupNorm32(channels, 32, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, num_heads,
                                   channels // num_heads)
             for _ in range(depth)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        out = self.proj_in(self.norm(x))
        out = out.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            out = blk(out, context, (h, w))
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(out) + x


class VAEAttnBlock(nn.Module):
    """Single-head full self-attention of the VAE mid block (GN eps 1e-6)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm32(channels, 32, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        out = attention(self.to_q(y), self.to_k(y), self.to_v(y))
        out = self.to_out[0](out.reshape(b, h * w, c))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x
