"""ControlNet: spatially conditioned generation, PyTorch NCHW.

Counterpart of ``stable_diffusion_videos_tpu/models/controlnet.py`` (Zhang
et al. 2023): a trainable copy of the UNet's down path and mid block
(``unet.UNetTrunk``, the port's own blocks) fed ``conv_in(latents) +
controlnet_cond_embedding(control map)``, whose skips and mid output pass
through 1x1 convolutions (``controlnet_down_blocks.{i}``,
``controlnet_mid_block``) scaled by ``conditioning_scale``.  The residuals
add to the UNet's skips (``UNet2DCondition(ctrl_down=, ctrl_mid=)``).  Those
convolutions start at zero, so an untrained ControlNet is an exact no-op.

Module names are diffusers ``ControlNetModel``'s, so its state dicts load
without renaming (``load_controlnet``: a model directory or a bare weights
file); ``ControlNetBundle.from_jax_params`` carries the JAX package's flax
tree across.  An SDXL-shaped config brings the text_time embedding, which
then needs ``text_embeds``/``time_ids`` as the UNet does.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .unet import UNetConfig, UNetTrunk
from .weights import (_conv, find_weights_file, load_state_dict,
                      random_state_dict, read_weights, unet_trunk)

#: the conditioning embedding's channels of the published SD 1.x/2.x/XL
#: ControlNets (lllyasviel/sd-controlnet-*: ``conditioning_embedding_out_
#: channels``); three stride-2 convolutions take 512² maps to 64² latents
SD_COND_CHANNELS = (16, 32, 96, 256)


class ControlNetCondEmbedding(nn.Module):
    """Control map (B, 3, H, W) in [0, 1] -> (B, C, H/f, W/f) features:
    conv_in, then a 3x3 pair a step (the second of stride 2), SiLU after
    each, and conv_out; ``f = 2 ** (len(channels) - 1)``."""

    def __init__(self, channels: Tuple[int, ...], out_channels: int):
        super().__init__()
        self.conv_in = nn.Conv2d(3, channels[0], 3, padding=1)
        blocks = []
        for i in range(len(channels) - 1):
            blocks.append(nn.Conv2d(channels[i], channels[i], 3, padding=1))
            blocks.append(nn.Conv2d(channels[i], channels[i + 1], 3,
                                    padding=1, stride=2))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(channels[-1], out_channels, 3, padding=1)

    def forward(self, cond):
        x = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


class ControlNet(UNetTrunk):
    """The UNet's trunk with the control injection and the 1x1 taps.
    Returns ``(down residuals, mid residual)`` shaped like the UNet's skips
    and mid output."""

    def __init__(self, config: UNetConfig,
                 cond_channels: Tuple[int, ...] = SD_COND_CHANNELS):
        super().__init__(config)
        self.cond_channels = tuple(cond_channels)
        self.controlnet_cond_embedding = ControlNetCondEmbedding(
            self.cond_channels, config.block_out_channels[0])
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(c, c, 1) for c in self.skip_chans])
        ch = config.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(ch, ch, 1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, cond: torch.Tensor,
                conditioning_scale=1.0, text_embeds=None, time_ids=None):
        """sample: (B, C, h, w) latents; cond: (B, 3, h·f, w·f) control
        maps.  -> (tuple of down residuals, mid residual), in the module's
        dtype."""
        dtype = self.dtype
        temb = self.embed_time(timesteps, sample.shape[0], text_embeds,
                               time_ids)
        ctx = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype)) \
            + self.controlnet_cond_embedding(cond.to(dtype))
        x, skips = self.run_down(x, temb, ctx)
        x = self.run_mid(x, temb, ctx)
        down = tuple(conv(s) * conditioning_scale
                     for conv, s in zip(self.controlnet_down_blocks, skips))
        return down, self.controlnet_mid_block(x) * conditioning_scale


@dataclasses.dataclass
class ControlNetBundle:
    """A ControlNet module with its geometry, as an ``Engine`` takes it."""
    config: UNetConfig
    module: ControlNet
    cond_channels: Tuple[int, ...] = SD_COND_CHANNELS

    @property
    def pixel_factor(self) -> int:
        """Control-map side over latent side (must equal the VAE's)."""
        return 2 ** (len(self.cond_channels) - 1)

    def to(self, device: torch.device) -> "ControlNetBundle":
        """Move the module to ``device`` (in place) and return the bundle."""
        self.module.to(device)
        return self

    @classmethod
    def build(cls, config: UNetConfig, cond_channels, state_dict: dict,
              dtype: torch.dtype = torch.float32) -> "ControlNetBundle":
        """The bundle of a diffusers-named state dict."""
        with torch.device("meta"):
            mod = ControlNet(config, cond_channels)
        load_state_dict(mod, state_dict, dtype)
        return cls(config, mod.eval().requires_grad_(False),
                   tuple(cond_channels))

    @classmethod
    def random(cls, seed: int = 5, dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> "ControlNetBundle":
        """SD 1.x's published ControlNet geometry (lllyasviel/
        sd-controlnet-canny: the SD 1.x trunk and conditioning channels
        (16, 32, 96, 256)) with every weight, the taps too, drawn N(0,
        0.02) from a numpy seed (0.02 as ``SDModels.random``); with
        ``device``, drawn there from a seeded ``torch.Generator``
        (``random_state_dict``'s device route), the module on it."""
        config = UNetConfig.sd_v1()
        with torch.device("meta"):
            shapes = ControlNet(config)
        return cls.build(config, SD_COND_CHANNELS, random_state_dict(
            shapes, seed, 0.02, dtype, device), dtype)

    @classmethod
    def tiny(cls, seed: int = 0) -> "ControlNetBundle":
        """CPU-sized fp32 bundle matched to ``SDModels.tiny`` (the VAE
        factor 2, conditioning channels (8, 16)), every weight, the taps
        too, drawn N(0, 0.05)."""
        return cls._tiny(UNetConfig.tiny(), seed)

    @classmethod
    def tiny_xl(cls, seed: int = 0) -> "ControlNetBundle":
        """``tiny`` matched to ``SDModels.tiny_xl``: per-level depth and
        the text_time embedding."""
        return cls._tiny(UNetConfig.tiny_xl(), seed)

    @classmethod
    def _tiny(cls, config: UNetConfig, seed: int) -> "ControlNetBundle":
        with torch.device("meta"):
            shapes = ControlNet(config, (8, 16))
        return cls.build(config, (8, 16),
                         random_state_dict(shapes, seed, 0.05))

    def zeroed(self) -> "ControlNetBundle":
        """This bundle with its 1x1 taps zeroed in place: residuals of 0."""
        with torch.no_grad():
            for conv in (*self.module.controlnet_down_blocks,
                         self.module.controlnet_mid_block):
                conv.weight.zero_()
                conv.bias.zero_()
        return self

    @classmethod
    def from_jax_params(cls, config: UNetConfig, tree: dict,
                        cond_channels=SD_COND_CHANNELS,
                        dtype: torch.dtype = torch.float32
                        ) -> "ControlNetBundle":
        """The JAX package's ControlNet flax variables ``{"params": ...}``
        (its ``ControlNetBundle.params``) -> the port's bundle."""
        return cls.build(config, cond_channels,
                         jax_state_dict(tree, config, cond_channels), dtype)


def jax_state_dict(tree: dict, config: UNetConfig,
                   cond_channels) -> dict:
    """The JAX ControlNet tree -> diffusers ``ControlNetModel`` names."""
    p, out = tree["params"], {}
    unet_trunk(p, config, out)
    emb = p["cond_embedding"]
    _conv(emb["conv_in"], "controlnet_cond_embedding.conv_in", out)
    _conv(emb["conv_out"], "controlnet_cond_embedding.conv_out", out)
    for i in range(2 * (len(cond_channels) - 1)):
        _conv(emb[f"blocks_{i}"], f"controlnet_cond_embedding.blocks.{i}",
              out)
    i = 0
    while f"zero_conv_{i}" in p:
        _conv(p[f"zero_conv_{i}"], f"controlnet_down_blocks.{i}", out)
        i += 1
    _conv(p["zero_conv_mid"], "controlnet_mid_block", out)
    return out


# ---------------------------------------------------------------------------
# diffusers ControlNetModel files
# ---------------------------------------------------------------------------

def config_from_json(cfg: dict) -> UNetConfig:
    """A diffusers ``config.json`` (UNet or ControlNetModel) -> UNetConfig."""
    down = cfg.get("down_block_types",
                   ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"])
    head = cfg.get("attention_head_dim", 8)
    depth = cfg.get("transformer_layers_per_block", 1)
    add_dim = pooled_dim = None
    if cfg.get("addition_embed_type") == "text_time":  # SDXL
        add_dim = cfg.get("addition_time_embed_dim", 256)
        # the MLP's input: the pooled embedding and 6 id sinusoids
        pooled_dim = cfg.get("projection_class_embeddings_input_dim",
                             2816) - 6 * add_dim
    return UNetConfig(
        sample_size=cfg.get("sample_size", 64),
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels",
                                         (320, 640, 1280, 1280))),
        layers_per_block=cfg.get("layers_per_block", 2),
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        attention_head_dim=head if isinstance(head, int) else tuple(head),
        attn_levels=tuple(t == "CrossAttnDownBlock2D" for t in down),
        transformer_depth=depth if isinstance(depth, int) else tuple(depth),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        freq_shift=cfg.get("freq_shift", 0),
        addition_embed_dim=add_dim, addition_pooled_dim=pooled_dim)


def config_from_state_dict(sd: dict) -> UNetConfig:
    """The trunk's geometry from diffusers-named tensor shapes alone (a bare
    weights file), as the JAX package infers it."""
    chans, level = [], 0
    while f"down_blocks.{level}.resnets.0.conv1.weight" in sd:
        chans.append(sd[f"down_blocks.{level}.resnets.0.conv1.weight"]
                     .shape[0])
        level += 1
    n = len(chans)
    layers = 0
    while f"down_blocks.0.resnets.{layers}.conv1.weight" in sd:
        layers += 1
    attn_levels, heads, depths = [], [], []
    for lv in range(n):
        has = (f"down_blocks.{lv}.attentions.0.transformer_blocks.0.attn2."
               "to_k.weight") in sd
        attn_levels.append(has)
        d = 0
        while (f"down_blocks.{lv}.attentions.0.transformer_blocks.{d}"
               ".attn1.to_q.weight") in sd:
            d += 1
        depths.append(d)
        heads.append(chans[lv] // 64 if has and chans[lv] % 64 == 0 else 8)
    ctx = next((sd[k].shape[1] for k in sd
                if k.endswith("attn2.to_k.weight")), 768)
    # SD 1.x has 8 heads everywhere; its context is 768 wide
    head_cfg = 8 if ctx == 768 else tuple(heads)
    add = "add_embedding.linear_1.weight" in sd
    return UNetConfig(
        in_channels=sd["conv_in.weight"].shape[1],
        block_out_channels=tuple(chans), layers_per_block=layers,
        cross_attention_dim=ctx, attention_head_dim=head_cfg,
        attn_levels=tuple(attn_levels),
        transformer_depth=tuple(max(d, 1) if a else 0
                                for d, a in zip(depths, attn_levels))
        if any(d > 1 for d in depths) else 1,
        addition_embed_dim=256 if add else None,
        addition_pooled_dim=(sd["add_embedding.linear_1.weight"].shape[1]
                             - 6 * 256 if add else None))


def load_controlnet(path,
                    dtype: torch.dtype = torch.float32) -> ControlNetBundle:
    """A diffusers-layout ControlNetModel directory (``config.json`` and a
    weights file) or a bare diffusers-named weights file -> bundle, in
    ``dtype`` (the engine computes in the bundle's dtype)."""
    root = Path(path)
    if root.is_dir():
        wfile = find_weights_file(root)
        cfg_file = root / "config.json"
        cfg_json = (json.loads(cfg_file.read_text()) if cfg_file.exists()
                    else {})
    else:
        wfile, cfg_json = root, {}
    sd = read_weights(wfile)
    if "conv_in.weight" not in sd:
        raise ValueError(
            f"{wfile} is not a diffusers-layout ControlNetModel state dict "
            "(A1111 'control_model.*' single files are not supported)")
    if cfg_json:
        config = config_from_json(cfg_json)
        cond_channels = tuple(cfg_json.get(
            "conditioning_embedding_out_channels", SD_COND_CHANNELS))
    else:
        config = config_from_state_dict(sd)
        n_pairs = sum(1 for k in sd
                      if k.startswith("controlnet_cond_embedding.blocks.")
                      and k.endswith(".weight")) // 2
        cond_channels = tuple(
            [sd["controlnet_cond_embedding.conv_in.weight"].shape[0]]
            + [sd[f"controlnet_cond_embedding.blocks.{2 * i + 1}.weight"]
               .shape[0] for i in range(n_pairs)])
    return ControlNetBundle.build(config, cond_channels, sd, dtype)
