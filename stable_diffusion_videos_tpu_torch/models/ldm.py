"""Single-file checkpoints in the original (CompVis/LDM) layout.

Counterpart of ``stable_diffusion_videos_tpu/models/ldm.py``: one
``.ckpt``/``.safetensors`` file whose keys are ``model.diffusion_model.*``,
``first_stage_model.*`` and ``cond_stage_model.*`` (SD 1.x, SD 2.x) or
``conditioner.embedders.{0,1}.*`` (SDXL).  The LDM names are renamed to the
diffusers names the port's modules take (host-side renaming, no tensor is
changed but SD 2.x's fused q/k/v, which is split, and OpenCLIP's
``text_projection``, which is transposed), and the geometry is inferred
from the tensors' shapes: such files carry no config.  Nor a vocabulary:
``load_ldm_checkpoint`` takes a ``tokenizer_dir`` with ``vocab.json`` and
``merges.txt``.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from pathlib import Path
from typing import Optional

import torch

from .clip_text import CLIPTextConfig, CLIPTextEncoder
from .unet import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig
from .weights import build_module, load_state_dict_file

logger = logging.getLogger("sdv_torch")

_UNET_PFX = "model.diffusion_model."
_VAE_PFX = "first_stage_model."
_TEXT_SD1_PFX = "cond_stage_model.transformer."
_TEXT_SD2_PFX = "cond_stage_model.model."
_TEXT_XL1_PFX = "conditioner.embedders.0.transformer."
_TEXT_XL2_PFX = "conditioner.embedders.1.model."


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def split_ldm_state_dict(sd: dict) -> dict:
    """A flat single-file state dict -> its models' dicts, prefixes
    stripped: ``unet``, ``vae``, and ``text`` (SD 1.x and 2.x, the latter
    with ``text_is_openclip``) or ``text`` and ``text_2`` (SDXL)."""
    out = {"unet": _sub(sd, _UNET_PFX), "vae": _sub(sd, _VAE_PFX)}
    if not out["unet"]:
        raise ValueError(
            "no 'model.diffusion_model.*' keys: not an original-layout "
            "Stable Diffusion checkpoint")
    if any(k.startswith(_TEXT_XL2_PFX) for k in sd):
        out["text"] = _sub(sd, _TEXT_XL1_PFX)
        out["text_2"] = _sub(sd, _TEXT_XL2_PFX)
    elif any(k.startswith(_TEXT_SD2_PFX) for k in sd):
        out["text"] = _sub(sd, _TEXT_SD2_PFX)
        out["text_is_openclip"] = True
    else:  # SD 1.x: the transformers CLIP module as it is
        out["text"] = _sub(sd, _TEXT_SD1_PFX)
    return out


# ---------------------------------------------------------------------------
# UNet: LDM module-list indices -> diffusers names
# ---------------------------------------------------------------------------

_RES_INNER = {"in_layers.0": "norm1", "in_layers.2": "conv1",
              "emb_layers.1": "time_emb_proj", "out_layers.0": "norm2",
              "out_layers.3": "conv2", "skip_connection": "conv_shortcut"}


def _rename_group(sd, old_pfx, new_pfx, table, out):
    """Every ``{old_pfx}.{old}.{weight,bias}`` to ``{new_pfx}.{new}...``."""
    for old_inner, new_inner in table.items():
        for leaf in ("weight", "bias"):
            k = f"{old_pfx}.{old_inner}.{leaf}"
            if k in sd:
                out[f"{new_pfx}.{new_inner}.{leaf}"] = sd[k]


def _rename_passthrough(sd, old_pfx, new_pfx, out):
    """A whole subtree whose inner names are diffusers' already (the spatial
    transformer's)."""
    for k, v in sd.items():
        if k.startswith(old_pfx + "."):
            out[new_pfx + k[len(old_pfx):]] = v


def _block_indices(sd, section: str) -> list[int]:
    return sorted({int(m.group(1)) for k in sd
                   if (m := re.match(rf"{re.escape(section)}\.(\d+)\.", k))})


def ldm_unet_to_diffusers(sd: dict) -> dict:
    """``model.diffusion_model.*`` (prefix stripped) -> diffusers UNet
    names, the blocks found from the keys: ``input_blocks.{i}.0.op`` is a
    downsample, a module ``.1`` with ``proj_in`` a spatial transformer, an
    ``output_blocks.{i}.{m}.conv`` an upsample closing the level."""
    out = {}
    for leaf in ("weight", "bias"):
        out[f"time_embedding.linear_1.{leaf}"] = sd[f"time_embed.0.{leaf}"]
        out[f"time_embedding.linear_2.{leaf}"] = sd[f"time_embed.2.{leaf}"]
        out[f"conv_in.{leaf}"] = sd[f"input_blocks.0.0.{leaf}"]
        out[f"conv_norm_out.{leaf}"] = sd[f"out.0.{leaf}"]
        out[f"conv_out.{leaf}"] = sd[f"out.2.{leaf}"]
        if f"label_emb.0.0.{leaf}" in sd:  # SDXL text_time
            out[f"add_embedding.linear_1.{leaf}"] = sd[f"label_emb.0.0.{leaf}"]
            out[f"add_embedding.linear_2.{leaf}"] = sd[f"label_emb.0.2.{leaf}"]
    level = j = 0
    for i in _block_indices(sd, "input_blocks"):
        if i == 0:
            continue
        if f"input_blocks.{i}.0.op.weight" in sd:
            for leaf in ("weight", "bias"):
                out[f"down_blocks.{level}.downsamplers.0.conv.{leaf}"] = \
                    sd[f"input_blocks.{i}.0.op.{leaf}"]
            level, j = level + 1, 0
            continue
        _rename_group(sd, f"input_blocks.{i}.0",
                      f"down_blocks.{level}.resnets.{j}", _RES_INNER, out)
        if f"input_blocks.{i}.1.proj_in.weight" in sd:
            _rename_passthrough(sd, f"input_blocks.{i}.1",
                                f"down_blocks.{level}.attentions.{j}", out)
        j += 1
    _rename_group(sd, "middle_block.0", "mid_block.resnets.0", _RES_INNER,
                  out)
    _rename_passthrough(sd, "middle_block.1", "mid_block.attentions.0", out)
    _rename_group(sd, "middle_block.2", "mid_block.resnets.1", _RES_INNER,
                  out)
    level = j = 0
    for i in _block_indices(sd, "output_blocks"):
        _rename_group(sd, f"output_blocks.{i}.0",
                      f"up_blocks.{level}.resnets.{j}", _RES_INNER, out)
        has_attn = f"output_blocks.{i}.1.proj_in.weight" in sd
        if has_attn:
            _rename_passthrough(sd, f"output_blocks.{i}.1",
                                f"up_blocks.{level}.attentions.{j}", out)
        up_mod = 2 if has_attn else 1
        if f"output_blocks.{i}.{up_mod}.conv.weight" in sd:
            for leaf in ("weight", "bias"):
                out[f"up_blocks.{level}.upsamplers.0.conv.{leaf}"] = \
                    sd[f"output_blocks.{i}.{up_mod}.conv.{leaf}"]
            level, j = level + 1, 0
        else:
            j += 1
    return out


# ---------------------------------------------------------------------------
# VAE: LDM AutoencoderKL names -> diffusers names
# ---------------------------------------------------------------------------

_VAE_RES_INNER = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2",
                  "conv2": "conv2", "nin_shortcut": "conv_shortcut"}
#: the single-head attention, to diffusers' legacy names (1x1-convolution
#: shapes; ``weights.fit_state_dict`` takes both)
_VAE_ATTN_INNER = {"norm": "group_norm", "q": "query", "k": "key",
                   "v": "value", "proj_out": "proj_attn"}


def _vae_side(sd, side: str, out):
    for leaf in ("weight", "bias"):
        out[f"{side}.conv_in.{leaf}"] = sd[f"{side}.conv_in.{leaf}"]
        out[f"{side}.conv_norm_out.{leaf}"] = sd[f"{side}.norm_out.{leaf}"]
        out[f"{side}.conv_out.{leaf}"] = sd[f"{side}.conv_out.{leaf}"]
    _rename_group(sd, f"{side}.mid.block_1", f"{side}.mid_block.resnets.0",
                  _VAE_RES_INNER, out)
    _rename_group(sd, f"{side}.mid.attn_1", f"{side}.mid_block.attentions.0",
                  _VAE_ATTN_INNER, out)
    _rename_group(sd, f"{side}.mid.block_2", f"{side}.mid_block.resnets.1",
                  _VAE_RES_INNER, out)
    if side == "encoder":
        for lvl in _block_indices(sd, f"{side}.down"):
            pfx = f"{side}.down.{lvl}"
            for j in _block_indices(sd, f"{pfx}.block"):
                _rename_group(sd, f"{pfx}.block.{j}",
                              f"{side}.down_blocks.{lvl}.resnets.{j}",
                              _VAE_RES_INNER, out)
            if f"{pfx}.downsample.conv.weight" in sd:
                for leaf in ("weight", "bias"):
                    out[f"{side}.down_blocks.{lvl}.downsamplers.0.conv."
                        f"{leaf}"] = sd[f"{pfx}.downsample.conv.{leaf}"]
        return
    # LDM numbers the decoder's levels by resolution (up.0 the highest);
    # diffusers' up_blocks run in processing order (up_blocks.0 the deepest)
    levels = _block_indices(sd, f"{side}.up")
    for lvl in levels:
        i = len(levels) - 1 - lvl
        pfx = f"{side}.up.{lvl}"
        for j in _block_indices(sd, f"{pfx}.block"):
            _rename_group(sd, f"{pfx}.block.{j}",
                          f"{side}.up_blocks.{i}.resnets.{j}",
                          _VAE_RES_INNER, out)
        if f"{pfx}.upsample.conv.weight" in sd:
            for leaf in ("weight", "bias"):
                out[f"{side}.up_blocks.{i}.upsamplers.0.conv.{leaf}"] = \
                    sd[f"{pfx}.upsample.conv.{leaf}"]


def ldm_vae_to_diffusers(sd: dict) -> dict:
    """``first_stage_model.*`` (prefix stripped) -> diffusers names."""
    out = {}
    _vae_side(sd, "encoder", out)
    _vae_side(sd, "decoder", out)
    for leaf in ("weight", "bias"):
        out[f"quant_conv.{leaf}"] = sd[f"quant_conv.{leaf}"]
        out[f"post_quant_conv.{leaf}"] = sd[f"post_quant_conv.{leaf}"]
    return out


# ---------------------------------------------------------------------------
# the OpenCLIP text tower (SD 2.x, SDXL's tower 2) -> transformers names
# ---------------------------------------------------------------------------

def openclip_text_to_hf(sd: dict, drop_last_layer: bool = False) -> dict:
    """``cond_stage_model.model.*`` / ``conditioner.embedders.1.model.*``
    (prefix stripped) -> transformers ``text_model.*`` names, the fused
    ``attn.in_proj`` split into q, k and v, and ``text_projection`` (applied
    as x @ P) transposed to the Linear's (out, in).  ``drop_last_layer``:
    the 23-layer tower diffusers ships for SD 2.x (which reads the
    penultimate layer, so the file's last one never runs)."""
    out = {
        "text_model.embeddings.token_embedding.weight":
            sd["token_embedding.weight"],
        "text_model.embeddings.position_embedding.weight":
            sd["positional_embedding"],
        "text_model.final_layer_norm.weight": sd["ln_final.weight"],
        "text_model.final_layer_norm.bias": sd["ln_final.bias"],
    }
    if "text_projection" in sd:
        out["text_projection.weight"] = sd["text_projection"].T
    layers = _block_indices(sd, "transformer.resblocks")
    if drop_last_layer:
        layers = layers[:-1]
    table = {"ln_1": "layer_norm1", "ln_2": "layer_norm2",
             "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2",
             "attn.out_proj": "self_attn.out_proj"}
    for i in layers:
        b, nb = f"transformer.resblocks.{i}", f"text_model.encoder.layers.{i}"
        _rename_group(sd, b, nb, table, out)
        w3, b3 = sd[f"{b}.attn.in_proj_weight"], sd[f"{b}.attn.in_proj_bias"]
        d = w3.shape[0] // 3
        for part, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{nb}.self_attn.{name}.weight"] = w3[part * d:(part + 1) * d]
            out[f"{nb}.self_attn.{name}.bias"] = b3[part * d:(part + 1) * d]
    return out


# ---------------------------------------------------------------------------
# geometry from the tensors' shapes
# ---------------------------------------------------------------------------

def _count(sd: dict, pattern: str) -> int:
    """1 + the largest index the regex ``pattern`` captures in ``sd``."""
    return 1 + max(int(m.group(1)) for k in sd if (m := re.match(pattern, k)))


def infer_unet_config(dsd: dict,
                      pooled_dim: Optional[int] = None) -> UNetConfig:
    """A diffusers-named UNet state dict -> UNetConfig.  The checkpoints do
    not record heads: a 768-wide context (SD 1.x) has 8 everywhere, wider
    ones (SD 2.x 1024, SDXL 2048) 64 channels a head."""
    n_levels = _count(dsd, r"down_blocks\.(\d+)\.")
    widths = tuple(int(dsd[f"down_blocks.{L}.resnets.0.conv1.weight"]
                       .shape[0]) for L in range(n_levels))
    attn_levels = tuple(f"down_blocks.{L}.attentions.0.proj_in.weight" in dsd
                        for L in range(n_levels))
    ctx, depth = None, []
    for L in range(n_levels):
        if not attn_levels[L]:
            depth.append(0)
            continue
        pfx = f"down_blocks.{L}.attentions.0"
        ctx = int(dsd[f"{pfx}.transformer_blocks.0.attn2.to_k.weight"]
                  .shape[1])
        depth.append(_count(dsd, rf"{re.escape(pfx)}\.transformer_blocks"
                                 r"\.(\d+)\."))
    if ctx is None:
        ctx = int(dsd["mid_block.attentions.0.transformer_blocks.0.attn2."
                      "to_k.weight"].shape[1])
    heads = 8 if ctx == 768 else tuple(max(1, w // 64) for w in widths)
    present = [d for d in depth if d] or [1]
    tdepth = (present[0] if all(d == present[0] for d in present)
              else tuple(depth))
    add_dim = add_pooled = None
    num_ids = 6
    if "add_embedding.linear_1.weight" in dsd:  # SDXL
        add_dim = 256
        proj_in = int(dsd["add_embedding.linear_1.weight"].shape[1])
        add_pooled = pooled_dim if pooled_dim is not None else 1280
        num_ids = (proj_in - add_pooled) // add_dim
    return UNetConfig(
        sample_size=128 if add_dim else 64,
        in_channels=int(dsd["conv_in.weight"].shape[1]),
        out_channels=int(dsd["conv_out.weight"].shape[0]),
        block_out_channels=widths,
        layers_per_block=_count(dsd, r"down_blocks\.0\.resnets\.(\d+)\."),
        cross_attention_dim=ctx, attention_head_dim=heads,
        attn_levels=attn_levels, transformer_depth=tdepth,
        addition_embed_dim=add_dim, addition_pooled_dim=add_pooled,
        addition_num_ids=num_ids)


def infer_vae_config(dsd: dict, is_xl: bool = False) -> VAEConfig:
    """A diffusers-named VAE state dict -> VAEConfig; the scaling factor,
    which the files do not store, is SDXL's retrained VAE's 0.13025 or
    SD 1.x/2.x's 0.18215."""
    n_levels = _count(dsd, r"encoder\.down_blocks\.(\d+)\.")
    return VAEConfig(
        in_channels=int(dsd["encoder.conv_in.weight"].shape[1]),
        out_channels=int(dsd["decoder.conv_out.weight"].shape[0]),
        latent_channels=int(dsd["post_quant_conv.weight"].shape[1]),
        block_out_channels=tuple(
            int(dsd[f"encoder.down_blocks.{L}.resnets.0.conv1.weight"]
                .shape[0]) for L in range(n_levels)),
        layers_per_block=_count(dsd,
                                r"encoder\.down_blocks\.0\.resnets\.(\d+)\."),
        scaling_factor=0.13025 if is_xl else 0.18215)


def infer_text_config(tsd: dict, penultimate: bool = False,
                      with_projection: bool = False) -> CLIPTextConfig:
    """A transformers-named CLIP text state dict -> CLIPTextConfig: 64
    channels a head (every published tower), quick_gelu for the 768-wide
    OpenAI tower without a projection, gelu for OpenCLIP's."""
    emb = tsd["text_model.embeddings.token_embedding.weight"]
    hidden = int(emb.shape[1])
    return CLIPTextConfig(
        vocab_size=int(emb.shape[0]), hidden_size=hidden,
        intermediate_size=int(
            tsd["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0]),
        num_layers=_count(tsd, r"text_model\.encoder\.layers\.(\d+)\."),
        num_heads=max(1, hidden // 64),
        max_position_embeddings=int(
            tsd["text_model.embeddings.position_embedding.weight"].shape[0]),
        hidden_act=("quick_gelu" if hidden == 768 and not with_projection
                    else "gelu"),
        penultimate_hidden=penultimate,
        projection_dim=(int(tsd["text_projection.weight"].shape[0])
                        if with_projection else None))


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def load_ldm_checkpoint(path, tokenizer_dir=None,
                        dtype: torch.dtype = torch.bfloat16,
                        tiled: bool = False,
                        prediction_type: Optional[str] = None,
                        unet_overrides: Optional[dict] = None,
                        vae_overrides: Optional[dict] = None,
                        text_overrides: Optional[dict] = None,
                        text2_overrides: Optional[dict] = None):
    """One original-layout ``.ckpt``/``.safetensors`` file -> SDModels in
    ``dtype``.  ``tokenizer_dir``: ``vocab.json`` + ``merges.txt`` (the
    files carry none).  ``prediction_type``: "epsilon" (default) or
    "v_prediction" (SD 2.x 768-v; the weights do not tell).
    ``*_overrides``: config fields the shapes cannot determine (heads of an
    off-family geometry).  Entries of an EMA copy (``model_ema.*``) are
    skipped."""
    from ..core.schedulers import SchedulerConfig
    from .bundle import SDModels
    from .tokenizer import CLIPBPETokenizer

    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{path} is not a checkpoint file")
    if tokenizer_dir is None:
        raise FileNotFoundError(
            "single-file checkpoints carry no tokenizer vocabulary; pass "
            "tokenizer_dir= with a diffusers-layout tokenizer/ directory "
            "(vocab.json + merges.txt)")
    flat = {k: v for k, v in load_state_dict_file(path).items()
            if not k.startswith("model_ema.")}
    parts = split_ldm_state_dict(flat)
    unet_sd = ldm_unet_to_diffusers(parts["unet"])
    vae_sd = ldm_vae_to_diffusers(parts["vae"])
    is_xl = "text_2" in parts

    def config(cfg, overrides):
        return dataclasses.replace(cfg, **overrides) if overrides else cfg

    tcfg2 = tower2 = None
    pooled_dim = None
    if is_xl:
        t2 = openclip_text_to_hf(parts["text_2"])
        tcfg2 = config(infer_text_config(t2, penultimate=True,
                                         with_projection=True),
                       text2_overrides)
        tower2 = build_module(CLIPTextEncoder, tcfg2, t2, dtype)
        text_sd = parts["text"]
        tcfg = config(infer_text_config(text_sd, penultimate=True),
                      text_overrides)
        pooled_dim = tcfg2.projection_dim
    elif parts.get("text_is_openclip"):  # SD 2.x
        text_sd = openclip_text_to_hf(parts["text"], drop_last_layer=True)
        tcfg = config(infer_text_config(text_sd), text_overrides)
    else:  # SD 1.x
        text_sd = parts["text"]
        tcfg = config(infer_text_config(text_sd), text_overrides)
    tower = build_module(CLIPTextEncoder, tcfg, text_sd, dtype)
    ucfg = config(infer_unet_config(unet_sd, pooled_dim=pooled_dim),
                  unet_overrides)
    vcfg = config(infer_vae_config(vae_sd, is_xl=is_xl), vae_overrides)
    tok_dir = Path(tokenizer_dir)
    tokenizer = CLIPBPETokenizer(tok_dir / "vocab.json",
                                 tok_dir / "merges.txt")
    tokenizer_2 = (CLIPBPETokenizer(tok_dir / "vocab.json",
                                    tok_dir / "merges.txt", pad_token_id=0)
                   if is_xl else None)
    sched = SchedulerConfig(
        prediction_type=prediction_type or "epsilon",
        # the SD training schedule, which the files do not restate
        beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
        steps_offset=1, clip_sample=False, set_alpha_to_one=False,
        skip_prk_steps=True)
    models = SDModels(
        ucfg, vcfg, tcfg, build_module(UNet2DCondition, ucfg, unet_sd, dtype),
        build_module(AutoencoderKL, vcfg, vae_sd, dtype), tower, tokenizer,
        sched, text_config_2=tcfg2, text_encoder_2=tower2,
        tokenizer_2=tokenizer_2)
    logger.info("loaded single-file checkpoint %s (unet %s%s)", path,
                ucfg.block_out_channels, ", SDXL" if is_xl else "")
    return models.with_tiled() if tiled else models
