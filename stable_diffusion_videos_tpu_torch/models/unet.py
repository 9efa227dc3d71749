"""UNet2DCondition — the noise predictor of SD 1.x, SD 2.x, SDXL-base and
the SDXL refiner, PyTorch NCHW.

Counterpart of ``stable_diffusion_videos_tpu/models/unet.py``: conv_in,
sinusoidal+MLP time embedding (plus SDXL's "text_time" addition embedding:
the pooled text embedding and the sinusoidal embeddings of the size/crop
ids through ``add_embedding``), cross-attention down blocks with a per-level
transformer depth, a cross-attention mid block at the deepest depth, the
mirrored up path with skip concatenation, then GN+SiLU+conv_out, and
DeepCache's split into a deep trunk and a shallow pass.  ControlNet
residuals add to the skips and the mid block's output, and IP-Adapter image
tokens reach every cross-attention.  Module names follow diffusers
(``down_blocks.0.resnets.0...``); ``UNetTrunk`` (conv_in, embeddings, down
path, mid block) is the part a ControlNet shares.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from .layers import (Downsample2D, GroupNorm32, ResnetBlock2D,
                     SpatialTransformer, TimestepEmbedMLP, Upsample2D,
                     timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    #: diffusers naming quirk: the NUMBER OF HEADS (SD 1.x: 8 everywhere),
    #: an int for all levels or a per-level tuple
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    #: which resolution levels carry cross-attention transformers
    attn_levels: Tuple[bool, ...] = (True, True, True, False)
    transformer_depth: Union[int, Tuple[int, ...]] = 1
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    #: SDXL "text_time": the sinusoidal width of each size/crop id (None:
    #: no addition embedding, as SD 1.x and 2.x)
    addition_embed_dim: Optional[int] = None
    #: width of the pooled text embedding concatenated before the addition
    #: MLP (SDXL: 1280, the OpenCLIP-bigG tower's projection)
    addition_pooled_dim: Optional[int] = None
    #: number of size/crop ids: 6 for SDXL-base (orig_h, orig_w, crop_t,
    #: crop_l, target_h, target_w), 5 for the refiner (the aesthetic score
    #: in place of the target size)
    addition_num_ids: int = 6

    def heads(self, level: int) -> int:
        h = self.attention_head_dim
        return h if isinstance(h, int) else h[level]

    def depth(self, level: int) -> int:
        d = self.transformer_depth
        return d if isinstance(d, int) else d[level]

    @classmethod
    def sd_v1(cls):
        """SD v1.1-v1.5 geometry."""
        return cls()

    @classmethod
    def sd_v2(cls, sample_size: int = 64):
        """SD v2.x geometry: OpenCLIP-H context (1024) and 64-channel heads
        at every level; ``sample_size=96`` for the 768-v checkpoints (their
        v-prediction is the scheduler config's)."""
        return cls(sample_size=sample_size, cross_attention_dim=1024,
                   attention_head_dim=(5, 10, 20, 20))

    @classmethod
    def sd_xl(cls):
        """SDXL-base 1.0 geometry: 3 levels, no attention at level 0,
        transformer depths (0, 2, 10), 64-channel heads, the dual-tower
        context (768 + 1280 = 2048), and text_time: 6 ids embedded at 256
        each beside the 1280-wide pooled embedding (2816 into the MLP)."""
        return cls(sample_size=128, block_out_channels=(320, 640, 1280),
                   cross_attention_dim=2048,
                   attention_head_dim=(5, 10, 20),
                   attn_levels=(False, True, True),
                   transformer_depth=(0, 2, 10),
                   addition_embed_dim=256, addition_pooled_dim=1280)

    @classmethod
    def sd_xl_refiner(cls):
        """SDXL-refiner 1.0 geometry: 4 levels at (384, 768, 1536, 1536),
        attention at the middle two and the mid block, 64-channel heads,
        depth 4 (the published ``transformer_layers_per_block`` is the int
        4, so the mid block has 4 layers too; the JAX package's
        constructor gives it 0), the bigG-only context (1280) and 5
        text_time ids (the aesthetic score in place of the target size:
        1280 + 5·256 = 2560 into the MLP)."""
        return cls(sample_size=128, block_out_channels=(384, 768, 1536, 1536),
                   cross_attention_dim=1280,
                   attention_head_dim=(6, 12, 24, 24),
                   attn_levels=(False, True, True, False),
                   transformer_depth=4, addition_embed_dim=256,
                   addition_pooled_dim=1280, addition_num_ids=5)

    @classmethod
    def tiny(cls):
        """CPU-runnable config for tests; same code paths."""
        return cls(sample_size=8, block_out_channels=(32, 64),
                   layers_per_block=1, cross_attention_dim=32,
                   attention_head_dim=2, attn_levels=(True, False))

    @classmethod
    def tiny_xl(cls):
        """CPU-runnable SDXL-shaped config: per-level transformer depth and
        the text_time addition embedding."""
        return cls(sample_size=8, block_out_channels=(32, 64),
                   layers_per_block=1, cross_attention_dim=32,
                   attention_head_dim=2, attn_levels=(False, True),
                   transformer_depth=(0, 2),
                   addition_embed_dim=8, addition_pooled_dim=16)

    @classmethod
    def tiny_refiner(cls):
        """CPU-runnable refiner-shaped config: the deepest level without
        attention but a transformer in the mid block (the depth tuple's
        last entry), a 16-wide bigG-only context and 5 text_time ids."""
        return cls(sample_size=8, block_out_channels=(32, 64, 64),
                   layers_per_block=1, cross_attention_dim=16,
                   attention_head_dim=2, attn_levels=(False, True, False),
                   transformer_depth=(0, 1, 1), addition_embed_dim=8,
                   addition_pooled_dim=16, addition_num_ids=5)


class UNetBlock(nn.Module):
    """One resolution level: resnets, optional transformers, optional
    resampler (diffusers' ``downsamplers.0`` / ``upsamplers.0``)."""

    def __init__(self, resnets, attentions=(), downsample=None,
                 upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])

    def layer(self, j, x, temb, ctx):
        x = self.resnets[j](x, temb)
        if len(self.attentions):
            x = self.attentions[j](x, ctx)
        return x


class UNetTrunk(nn.Module):
    """conv_in, the time (and text_time) embeddings, the down path and the
    mid block, under diffusers' names: the part of the UNet a ControlNet
    (``models/controlnet.py``) copies.  ``skip_chans`` lists the channels
    of the down path's skips, in order."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        chans = cfg.block_out_channels
        n = len(chans)
        temb_dim = chans[0] * 4
        ctx_dim = cfg.cross_attention_dim
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedMLP(chans[0], temb_dim)
        if cfg.addition_embed_dim is not None:
            self.add_embedding = TimestepEmbedMLP(
                cfg.addition_pooled_dim
                + cfg.addition_num_ids * cfg.addition_embed_dim, temb_dim)

        self.skip_chans = skip_chans = [chans[0]]
        ch = chans[0]
        self.down_blocks = nn.ModuleList()
        for level, out_ch in enumerate(chans):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, temb_dim))
                ch = out_ch
                if cfg.attn_levels[level]:
                    attns.append(SpatialTransformer(
                        ch, ctx_dim, cfg.heads(level), cfg.depth(level)))
                skip_chans.append(ch)
            down = Downsample2D(ch) if level != n - 1 else None
            if down is not None:
                skip_chans.append(ch)
            self.down_blocks.append(UNetBlock(resnets, attns, downsample=down))

        self.mid_block = UNetBlock(
            [ResnetBlock2D(ch, ch, temb_dim), ResnetBlock2D(ch, ch, temb_dim)],
            [SpatialTransformer(ch, ctx_dim, cfg.heads(n - 1),
                                cfg.depth(n - 1))])

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def embed_time(self, timesteps, batch: int, text_embeds=None,
                   time_ids=None) -> torch.Tensor:
        """The time embedding, plus SDXL's text_time addition embedding of
        ``text_embeds`` (B, addition_pooled_dim) and ``time_ids`` (B,
        addition_num_ids), which a text_time config requires and any other
        refuses."""
        cfg, dtype = self.config, self.dtype
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(batch)
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(t_emb.to(dtype))
        if cfg.addition_embed_dim is not None:
            if text_embeds is None or time_ids is None:
                raise ValueError("this UNet config requires text_embeds and "
                                 "time_ids (SDXL text_time conditioning)")
            ids_emb = timestep_embedding(
                time_ids.reshape(-1), cfg.addition_embed_dim,
                cfg.flip_sin_to_cos, cfg.freq_shift).reshape(batch, -1)
            add = torch.cat([text_embeds.float(), ids_emb], dim=-1)
            temb = temb + self.add_embedding(add.to(dtype))
        elif text_embeds is not None or time_ids is not None:
            raise ValueError("text_embeds/time_ids given to a UNet without "
                             "text_time conditioning (addition_embed_dim)")
        return temb

    def run_down(self, x, temb, ctx, levels: Optional[int] = None,
                 skip_last_downsample: bool = False) -> tuple:
        """The down path over the first ``levels`` levels (all by default),
        the last one's downsample left out with ``skip_last_downsample``:
        -> (x, skips), the skips starting with ``x`` itself."""
        skips = [x]
        blocks = self.down_blocks[:levels]
        for level, blk in enumerate(blocks):
            for j in range(len(blk.resnets)):
                x = blk.layer(j, x, temb, ctx)
                skips.append(x)
            if hasattr(blk, "downsamplers") and not (
                    skip_last_downsample and level == len(blocks) - 1):
                x = blk.downsamplers[0](x)
                skips.append(x)
        return x, skips

    def run_mid(self, x, temb, ctx) -> torch.Tensor:
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, ctx)
        return self.mid_block.resnets[1](x, temb)


class UNet2DCondition(UNetTrunk):
    def __init__(self, config: UNetConfig):
        super().__init__(config)
        cfg = config
        chans = cfg.block_out_channels
        n = len(chans)
        temb_dim = chans[0] * 4
        ctx_dim = cfg.cross_attention_dim
        skip_chans = list(self.skip_chans)
        ch = chans[-1]
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            level = n - 1 - i
            out_ch = chans[level]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skip_chans.pop(), out_ch,
                                             temb_dim))
                ch = out_ch
                if cfg.attn_levels[level]:
                    attns.append(SpatialTransformer(
                        ch, ctx_dim, cfg.heads(level), cfg.depth(level)))
            up = Upsample2D(ch) if i != n - 1 else None
            self.up_blocks.append(UNetBlock(resnets, attns, upsample=up))

        self.conv_norm_out = GroupNorm32(chans[0], 32, eps=1e-5)
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, *, cache_split=None,
                deep_feature=None, ctrl_down=None, ctrl_mid=None,
                ip_context=None, ip_scale=1.0, text_embeds=None,
                time_ids=None):
        """sample: (B, C, H, W) latents; timesteps: (B,) or scalar;
        encoder_hidden_states: (B, S, cross_attention_dim).  Returns the
        fp32 noise prediction (B, C, H, W).

        SDXL text_time (a config with ``addition_embed_dim``): ``text_embeds``
        is the (B, addition_pooled_dim) pooled text embedding and
        ``time_ids`` the (B, addition_num_ids) size/crop ids; both are
        required there and refused elsewhere.

        DeepCache (Ma et al. 2023): with ``cache_split`` the call returns
        ``(eps, deep)``, where ``deep`` is the deep trunk's output entering
        level ``cache_split - 1`` (after ``up_{cache_split}``'s upsample).
        With ``deep_feature`` too, the call is the shallow pass: levels
        below the split only, ``down_{split-1}``'s downsample skipped, the
        mid block skipped, the given feature spliced in where the trunk's
        output would be, and that same feature returned.

        ControlNet: ``ctrl_down`` (one residual a skip, ``ControlNet``'s
        first output) is added to the down path's skips and ``ctrl_mid``
        to the mid block's output; neither combines with DeepCache.

        IP-Adapter: ``ip_context`` (B, T, cross_attention_dim) image tokens
        go to every cross-attention's ``to_k_ip``/``to_v_ip`` (spliced by
        ``ip_adapter.IPAdapter.splice``), their attention added at
        ``ip_scale``."""
        cfg, dtype = self.config, self.dtype
        n_levels = len(cfg.block_out_channels)
        if cache_split is not None and not 1 <= cache_split <= n_levels - 1:
            raise ValueError(f"cache_split must be in [1, {n_levels - 1}]")
        shallow = deep_feature is not None
        if shallow and cache_split is None:
            raise ValueError("deep_feature requires cache_split")
        if (ctrl_down is not None or ctrl_mid is not None) and (
                cache_split is not None):
            raise ValueError("ControlNet residuals (ctrl_down/ctrl_mid) "
                             "cannot combine with DeepCache (cache_split): "
                             "the shallow pass has no deep skips")
        temb = self.embed_time(timesteps, sample.shape[0], text_embeds,
                               time_ids)
        ctx = encoder_hidden_states.to(dtype)
        if ip_context is not None:
            ctx = (ctx, ip_context.to(dtype), ip_scale)

        x = self.conv_in(sample.to(dtype))
        x, skips = self.run_down(x, temb, ctx,
                                 cache_split if shallow else None,
                                 skip_last_downsample=shallow)
        if ctrl_down is not None:
            if len(ctrl_down) != len(skips):
                raise ValueError(f"expected {len(skips)} ControlNet down "
                                 f"residuals (ctrl_down), got "
                                 f"{len(ctrl_down)}")
            skips = [s + r.to(dtype) for s, r in zip(skips, ctrl_down)]

        if shallow:
            x = deep_feature.to(dtype)
        else:
            x = self.run_mid(x, temb, ctx)
            if ctrl_mid is not None:
                x = x + ctrl_mid.to(dtype)

        deep_out = None
        for i, blk in enumerate(self.up_blocks):
            level = n_levels - 1 - i  # up_blocks run deepest level first
            if shallow and level >= cache_split:
                continue
            for j in range(len(blk.resnets)):
                x = blk.layer(j, torch.cat([x, skips.pop()], dim=1), temb,
                              ctx)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
            if cache_split is not None and not shallow \
                    and level == cache_split:
                deep_out = x

        x = self.conv_out(self.conv_norm_out(x, silu=True))
        eps = x.float()
        if cache_split is None:
            return eps
        return eps, deep_feature.to(dtype) if shallow else deep_out
