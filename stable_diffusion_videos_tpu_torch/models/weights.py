"""Weight bridge: diffusers-named state dicts in, port modules filled.

* ``from_jax_params(tree, config)`` turns the JAX package's flax param tree
  (nested dicts of numpy arrays, ``{"params": ...}``) into the diffusers-named
  state dict of the matching port module.  It is the mapping of the JAX
  exporters (``stable_diffusion_videos_tpu/models/weights.py`` ``export_unet``,
  ``export_vae``, ``export_text_encoder``), written with numpy alone because
  that module imports jax: conv HWIO -> OIHW, dense (in, out) -> (out, in),
  norm scale -> weight, ``to_out`` -> ``to_out.0``, ``ff.proj_in`` ->
  ``ff.net.0.proj``.  SDXL's ``add_embedding`` and the projected tower's
  ``text_projection`` map by the same rules.  The TAESD decoder's and
  encoder's trees map to diffusers ``AutoencoderTiny`` names
  (``decoder.layers.N`` and ``encoder.layers.N``, conv_in at 0), the
  safety checker's to diffusers ``StableDiffusionSafetyChecker`` names and
  RRDBNet's to basicsr's.
* ``load_state_dict(module, state_dict)`` loads diffusers-named numpy arrays,
  strict about missing and unexpected keys.  A
  transformer's ``proj_in``/``proj_out`` loads from either layout diffusers
  writes: the 1×1 convolution's ``(C, C, 1, 1)`` (SD 1.x) or the Linear's
  ``(C, C)`` (SD 2.x and SDXL, ``use_linear_projection``).
* ``random_state_dict(module, seed, std, dtype)`` draws every parameter
  N(0, std) from a numpy seed, one tensor at a time.
* ``read_safetensors(path)`` reads a ``.safetensors`` file with no package
  (an 8-byte little-endian header length, a JSON header with
  ``__metadata__``, then the raw tensors); ``read_weights(path)`` takes that
  or a ``torch.load`` pickle, the formats the add-on files ship in.
* ``shared_copy(module)`` copies a module's structure around the same
  parameter tensors, so an adapter merged into the copy leaves the original
  untouched without a second copy of its weights.
* ``load_realesrgan(path)`` reads a Real-ESRGAN ``.pth`` (the weights inside
  ``params_ema`` or ``params``) or ``.safetensors`` file and infers the
  RRDBNet's geometry from its tensors.
"""

from __future__ import annotations

import copy
import itertools
import json
import struct
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .clip_text import CLIPTextConfig
from .rrdbnet import RRDBNetConfig
from .safety import SafetyConfig
from .taesd import TAESDConfig
from .unet import UNetConfig
from .vae import VAEConfig


def _conv(p, name, out):
    out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])


def _lin(p, name, out):
    out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]))
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])


def _norm(p, name, out):
    out[f"{name}.weight"] = np.asarray(p["scale"])
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _gn32(p, name, out):
    _norm(p["norm"], name, out)  # the JAX GroupNorm32 nests a child "norm"


def _resnet(p, pfx, out):
    _gn32(p["norm1"], f"{pfx}.norm1", out)
    _conv(p["conv1"], f"{pfx}.conv1", out)
    _gn32(p["norm2"], f"{pfx}.norm2", out)
    _conv(p["conv2"], f"{pfx}.conv2", out)
    if "time_emb_proj" in p:
        _lin(p["time_emb_proj"], f"{pfx}.time_emb_proj", out)
    if "conv_shortcut" in p:
        _conv(p["conv_shortcut"], f"{pfx}.conv_shortcut", out)


def _attn(p, pfx, out):
    for proj in ("to_q", "to_k", "to_v"):
        _lin(p[proj], f"{pfx}.{proj}", out)
    _lin(p["to_out"], f"{pfx}.to_out.0", out)


def _transformer(p, pfx, depth, out):
    _gn32(p["norm"], f"{pfx}.norm", out)
    _conv(p["proj_in"], f"{pfx}.proj_in", out)
    _conv(p["proj_out"], f"{pfx}.proj_out", out)
    for i in range(depth):
        b, blk = f"{pfx}.transformer_blocks.{i}", p[f"blocks_{i}"]
        for n in ("norm1", "norm2", "norm3"):
            _norm(blk[n], f"{b}.{n}", out)
        _attn(blk["attn1"], f"{b}.attn1", out)
        _attn(blk["attn2"], f"{b}.attn2", out)
        _lin(blk["ff"]["proj_in"], f"{b}.ff.net.0.proj", out)
        _lin(blk["ff"]["proj_out"], f"{b}.ff.net.2", out)


def unet_trunk(p, config: UNetConfig, out):
    """conv_in, the time (and text_time) embeddings, the down path and the
    mid block: the part a diffusers ControlNetModel shares with the UNet."""
    _conv(p["conv_in"], "conv_in", out)
    for mlp in ("time_embedding", "add_embedding"):
        if mlp in p:  # add_embedding: SDXL text_time
            _lin(p[mlp]["linear_1"], f"{mlp}.linear_1", out)
            _lin(p[mlp]["linear_2"], f"{mlp}.linear_2", out)
    n = len(config.block_out_channels)
    for level in range(n):
        for j in range(config.layers_per_block):
            _resnet(p[f"down_{level}_res_{j}"],
                    f"down_blocks.{level}.resnets.{j}", out)
            if config.attn_levels[level]:
                _transformer(p[f"down_{level}_attn_{j}"],
                             f"down_blocks.{level}.attentions.{j}",
                             config.depth(level), out)
        if level != n - 1:
            _conv(p[f"down_{level}_downsample"]["conv"],
                  f"down_blocks.{level}.downsamplers.0.conv", out)
    _resnet(p["mid_res_0"], "mid_block.resnets.0", out)
    _transformer(p["mid_attn"], "mid_block.attentions.0",
                 config.depth(n - 1), out)
    _resnet(p["mid_res_1"], "mid_block.resnets.1", out)


def _unet(p, config: UNetConfig, out):
    unet_trunk(p, config, out)
    _gn32(p["conv_norm_out"], "conv_norm_out", out)
    _conv(p["conv_out"], "conv_out", out)
    n = len(config.block_out_channels)
    for i in range(n):
        level = n - 1 - i
        for j in range(config.layers_per_block + 1):
            _resnet(p[f"up_{level}_res_{j}"], f"up_blocks.{i}.resnets.{j}",
                    out)
            if config.attn_levels[level]:
                _transformer(p[f"up_{level}_attn_{j}"],
                             f"up_blocks.{i}.attentions.{j}",
                             config.depth(level), out)
        if i != n - 1:
            _conv(p[f"up_{level}_upsample"]["conv"],
                  f"up_blocks.{i}.upsamplers.0.conv", out)


def _vae_attn(a, pfx, out):
    _gn32(a["group_norm"], f"{pfx}.group_norm", out)
    _attn(a, pfx, out)


def _vae(p, config: VAEConfig, out):
    n = len(config.block_out_channels)
    for side in ("encoder", "decoder"):
        s = p[side]
        _conv(s["conv_in"], f"{side}.conv_in", out)
        _gn32(s["conv_norm_out"], f"{side}.conv_norm_out", out)
        _conv(s["conv_out"], f"{side}.conv_out", out)
        _resnet(s["mid_res_0"], f"{side}.mid_block.resnets.0", out)
        _resnet(s["mid_res_1"], f"{side}.mid_block.resnets.1", out)
        _vae_attn(s["mid_attn"], f"{side}.mid_block.attentions.0", out)
        if side == "encoder":
            for level in range(n):
                for j in range(config.layers_per_block):
                    _resnet(s[f"down_{level}_res_{j}"],
                            f"{side}.down_blocks.{level}.resnets.{j}", out)
                if level != n - 1:
                    _conv(s[f"down_{level}_downsample"]["conv"],
                          f"{side}.down_blocks.{level}.downsamplers.0.conv",
                          out)
        else:
            for i in range(n):
                level = n - 1 - i
                for j in range(config.layers_per_block + 1):
                    _resnet(s[f"up_{level}_res_{j}"],
                            f"{side}.up_blocks.{i}.resnets.{j}", out)
                if i != n - 1:
                    _conv(s[f"up_{level}_upsample"]["conv"],
                          f"{side}.up_blocks.{i}.upsamplers.0.conv", out)
    _conv(p["quant_conv"], "quant_conv", out)
    _conv(p["post_quant_conv"], "post_quant_conv", out)


def _text(p, config: CLIPTextConfig, out):
    out["text_model.embeddings.token_embedding.weight"] = np.asarray(
        p["token_embedding"]["embedding"])
    out["text_model.embeddings.position_embedding.weight"] = np.asarray(
        p["position_embedding"]["embedding"])
    _norm(p["final_layer_norm"], "text_model.final_layer_norm", out)
    for i in range(config.num_layers):
        b, blk = f"text_model.encoder.layers.{i}", p[f"layers_{i}"]
        _norm(blk["layer_norm1"], f"{b}.layer_norm1", out)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(blk[proj], f"{b}.self_attn.{proj}", out)
        _norm(blk["layer_norm2"], f"{b}.layer_norm2", out)
        _lin(blk["fc1"], f"{b}.mlp.fc1", out)
        _lin(blk["fc2"], f"{b}.mlp.fc2", out)
    if "text_projection" in p:
        _lin(p["text_projection"], "text_projection", out)


def _taesd_block(p, pfx, out):
    for k in range(3):
        _conv(p[f"conv_{k}"], f"{pfx}.conv.{2 * k}", out)


def _taesd(p, config: TAESDConfig, out):
    """The decoder's Sequential: conv_in, ReLU, [blocks, Upsample, conv] a
    stage, block_out, conv_out; or the encoder's (its tree has
    ``block_in``): conv_in, block_in, [stride-2 conv, blocks] a stage,
    conv_out."""
    if "block_in" in p:
        _conv(p["conv_in"], "encoder.layers.0", out)
        _taesd_block(p["block_in"], "encoder.layers.1", out)
        i = 2
        for s in range(config.num_stages):
            _conv(p[f"down_{s}_conv"], f"encoder.layers.{i}", out)
            i += 1
            for j in range(config.blocks_per_stage):
                _taesd_block(p[f"down_{s}_block_{j}"],
                             f"encoder.layers.{i}", out)
                i += 1
        _conv(p["conv_out"], f"encoder.layers.{i}", out)
        return
    _conv(p["conv_in"], "decoder.layers.0", out)
    i = 2
    for s in range(config.num_stages):
        for j in range(config.blocks_per_stage):
            _taesd_block(p[f"up_{s}_block_{j}"], f"decoder.layers.{i}", out)
            i += 1
        _conv(p[f"up_{s}_conv"], f"decoder.layers.{i + 1}", out)
        i += 2
    _taesd_block(p["block_out"], f"decoder.layers.{i}", out)
    _conv(p["conv_out"], f"decoder.layers.{i + 1}", out)


def clip_vision(p, pre: str, num_layers: int, out):
    """The JAX ``CLIPVisionEncoder`` tree -> transformers' tower names
    under ``pre`` (``vision_model.`` in ``CLIPVisionModelWithProjection``,
    ``vision_model.vision_model.`` in the safety checker)."""
    out[f"{pre}embeddings.patch_embedding.weight"] = np.transpose(
        np.asarray(p["patch_embedding"]["kernel"]), (3, 2, 0, 1))
    out[f"{pre}embeddings.position_embedding.weight"] = np.asarray(
        p["position_embedding"]["embedding"])
    out[f"{pre}embeddings.class_embedding"] = np.asarray(p["class_embedding"])
    _norm(p["pre_layrnorm"], f"{pre}pre_layrnorm", out)
    _norm(p["post_layernorm"], f"{pre}post_layernorm", out)
    for i in range(num_layers):
        b, blk = f"{pre}encoder.layers.{i}", p[f"layers_{i}"]
        _norm(blk["layer_norm1"], f"{b}.layer_norm1", out)
        _norm(blk["layer_norm2"], f"{b}.layer_norm2", out)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(blk[proj], f"{b}.self_attn.{proj}", out)
        _lin(blk["fc1"], f"{b}.mlp.fc1", out)
        _lin(blk["fc2"], f"{b}.mlp.fc2", out)


def _safety(p, config: SafetyConfig, out):
    clip_vision(p["vision_model"], "vision_model.vision_model.",
                config.vision.num_layers, out)
    _lin(p["visual_projection"], "visual_projection", out)
    for name in ("concept_embeds", "concept_embeds_weights",
                 "special_care_embeds", "special_care_embeds_weights"):
        out[name] = np.asarray(p[name])


def _rrdbnet(p, config: RRDBNetConfig, out):
    for name in ("conv_first", "conv_body", "conv_up1", "conv_up2",
                 "conv_hr", "conv_last"):
        _conv(p[name], name, out)
    for i in range(config.num_block):
        for r in (1, 2, 3):
            for c in range(1, 6):
                _conv(p[f"body_{i}"][f"rdb{r}"][f"conv{c}"],
                      f"body.{i}.rdb{r}.conv{c}", out)


_MAPPINGS = {UNetConfig: _unet, VAEConfig: _vae, CLIPTextConfig: _text,
             TAESDConfig: _taesd, SafetyConfig: _safety,
             RRDBNetConfig: _rrdbnet}


def from_jax_params(tree: dict, config) -> dict[str, np.ndarray]:
    """JAX flax variables ``{"params": ...}`` of a UNet, VAE, CLIP text
    encoder, TAESD decoder or encoder, safety checker or RRDBNet -> the
    diffusers- (basicsr-) named state dict, chosen by the config's type."""
    out: dict[str, np.ndarray] = {}
    _MAPPINGS[type(config)](tree["params"], config, out)
    return out


#: the transformers' channel projections, stored by diffusers as 1x1
#: convolutions (SD 1.x) or as Linear layers (SD 2.x and SDXL)
_LINEAR_PROJECTIONS = (".proj_in.weight", ".proj_out.weight")


def load_state_dict(module: nn.Module, state_dict: dict,
                    dtype: torch.dtype | None = None) -> nn.Module:
    """Fill ``module`` from diffusers-named arrays (numpy or torch), in
    ``dtype`` (default: the module's current dtype).  A missing or
    unexpected key, or a shape that differs, raises.  The tensors are
    assigned, so a module built on the meta device is materialised here."""
    sd = state_dict
    own = module.state_dict()
    missing, unexpected = sorted(own.keys() - sd), sorted(sd.keys() - own)
    if missing or unexpected:
        raise KeyError(f"{type(module).__name__}: missing keys {missing}, "
                       f"unexpected keys {unexpected}")
    tensors = {}
    for k, ref in own.items():
        t = sd[k] if torch.is_tensor(sd[k]) else torch.from_numpy(
            np.array(sd[k]))  # a copy: jax arrays are read-only
        if (k.endswith(_LINEAR_PROJECTIONS) and t.ndim == 2
                and tuple(ref.shape) == tuple(t.shape) + (1, 1)):
            t = t[:, :, None, None]  # a Linear over channels is a 1x1 conv
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)}, the module has "
                             f"{tuple(ref.shape)}")
        tensors[k] = t.to(dtype or ref.dtype)
    module.load_state_dict(tensors, strict=True, assign=True)
    return module


def random_state_dict(module: nn.Module, seed: int, std: float,
                      dtype: torch.dtype | None = None) -> dict:
    """Every parameter of ``module`` drawn N(0, std) in float32 from one
    numpy generator, in state-dict order (shapes only are read, so a
    meta-device module serves).  With ``dtype`` each draw is cast to a
    torch tensor of that dtype as soon as it is drawn, so no more than one
    float32 tensor is held at a time (SDXL's UNet is about 10 GB in
    float32); the values are those of the float32 draws, cast."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        w = rng.standard_normal(tuple(v.shape), dtype=np.float32) * std
        out[k] = w if dtype is None else torch.from_numpy(w).to(dtype)
    return out


def shared_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` whose parameters and buffers are the original's
    tensors: replacing or adding a submodule or parameter on the copy leaves
    the original as it was."""
    memo = {id(t): t for t in itertools.chain(module.parameters(),
                                              module.buffers())}
    return copy.deepcopy(module, memo)


# ---------------------------------------------------------------------------
# weight files
# ---------------------------------------------------------------------------

#: the safetensors dtypes the add-on files use
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16, "I64": torch.int64}


def read_safetensors(path) -> tuple[dict[str, torch.Tensor], dict]:
    """A ``.safetensors`` file -> ({name: CPU tensor}, ``__metadata__``).
    The tensors are views of one buffer holding the file."""
    data = bytearray(Path(path).read_bytes())
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf-8"))
    meta = header.pop("__metadata__", None) or {}
    base = 8 + n
    out = {}
    for name, info in header.items():
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, not one of "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        size = torch.empty((), dtype=dtype).element_size()
        count = int(np.prod(shape)) if shape else 1
        if end - start != count * size:
            raise ValueError(f"{path}: tensor {name} spans {end - start} "
                             f"bytes, its shape {shape} needs {count * size}")
        t = (torch.frombuffer(data, dtype=dtype, count=count,
                              offset=base + start) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out, meta


def read_weights(path) -> dict:
    """A weight file -> its dict: ``.safetensors`` through
    ``read_safetensors``, anything else through ``torch.load`` (tensors
    only, on the CPU)."""
    if Path(path).suffix == ".safetensors":
        return read_safetensors(path)[0]
    return torch.load(str(path), map_location="cpu", weights_only=True)


def find_weights_file(directory) -> Path:
    """The weights file of a diffusers/transformers model directory: the
    first ``.safetensors``, else ``.bin``, ``.pth`` or ``.pt``, by name."""
    for pattern in ("*.safetensors", "*.bin", "*.pth", "*.pt"):
        hits = sorted(Path(directory).glob(pattern))
        if hits:
            return hits[0]
    raise FileNotFoundError(f"no weights file found under {directory}")


def load_realesrgan(path) -> tuple[RRDBNetConfig, dict]:
    """A Real-ESRGAN checkpoint -> (RRDBNetConfig, basicsr-named state
    dict).  A ``.pth`` is read with ``torch.load(weights_only=True)`` and
    unwrapped from ``params_ema`` (else ``params``); a ``.safetensors``
    with ``read_safetensors``.  The geometry comes from the tensors: the
    block count from ``body.*``, the widths from ``conv_first``,
    ``body.0.rdb1.conv1`` and ``conv_last``, and the scale from
    ``conv_first``'s input width (3: x4, 12: x2, 48: x1)."""
    sd = read_weights(path)
    for wrapper in ("params_ema", "params"):
        if isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
            break
    first, last = sd["conv_first.weight"], sd["conv_last.weight"]
    first_in = int(first.shape[1])
    scale = {3: 4, 12: 2, 48: 1}.get(first_in, 4)
    config = RRDBNetConfig(
        in_channels=first_in // {4: 1, 2: 4, 1: 16}[scale],
        out_channels=int(last.shape[0]), num_feat=int(first.shape[0]),
        num_block=1 + max(int(k.split(".")[1]) for k in sd
                          if k.startswith("body.")),
        num_grow_ch=int(sd["body.0.rdb1.conv1.weight"].shape[0]),
        scale=scale)
    return config, sd
