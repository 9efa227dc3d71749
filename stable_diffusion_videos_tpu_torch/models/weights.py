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
  RRDBNet's to basicsr's.  ``to_jax_params(state_dict, config)`` is the
  inverse: both walk one table of (flax path, diffusers key, kind) rows.
* ``load_state_dict(module, state_dict)`` loads diffusers-named numpy arrays,
  strict about missing and unexpected keys.  A
  transformer's ``proj_in``/``proj_out`` loads from either layout diffusers
  writes: the 1×1 convolution's ``(C, C, 1, 1)`` (SD 1.x) or the Linear's
  ``(C, C)`` (SD 2.x and SDXL, ``use_linear_projection``).
* ``random_state_dict(module, seed, std, dtype, device)`` draws every
  parameter N(0, std) from a numpy seed, one tensor at a time, or with
  ``device`` from a ``torch.Generator`` on that device.
* ``read_safetensors(path)`` reads a ``.safetensors`` file with no package
  (an 8-byte little-endian header length, a JSON header with
  ``__metadata__``, then the raw tensors); ``read_weights(path)`` takes that
  or a ``torch.load`` pickle, the formats the add-on files ship in.
* ``shared_copy(module)`` copies a module's structure around the same
  parameter tensors, so an adapter merged into the copy leaves the original
  untouched without a second copy of its weights.
* ``load_sd_checkpoint(path)`` builds an ``SDModels`` from a
  diffusers-layout directory or hub id (``resolve_checkpoint``): the
  configs from each ``config.json`` (``controlnet.config_from_json`` for
  the UNet, ``vae_config_from_json``, ``text_config_from_json``,
  ``scheduler_config_from_json``), the tensors from each weights file
  (``load_state_dict_file``) as they are, fitted to the modules' names
  (``fit_state_dict``).
* ``load_realesrgan(path)`` reads a Real-ESRGAN ``.pth`` (the weights inside
  ``params_ema`` or ``params``) or ``.safetensors`` file and infers the
  RRDBNet's geometry from its tensors.
"""

from __future__ import annotations

import copy
import dataclasses
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


# ---------------------------------------------------------------------------
# the JAX package's layout <-> diffusers names: one table, walked both ways
# ---------------------------------------------------------------------------
# A row is (flax path under "params", diffusers key, kind).  Optional leaves
# (a bias, a resnet's shortcut, SDXL's add_embedding, a tower's projection)
# have rows too: a row whose source is absent is skipped, and the module's
# strict load (or ``to_jax_params``' check) reports what is missing.

def _flip(x):
    """Reverse the axes: a flax Dense kernel (in, out) <-> a Linear's
    weight (out, in)."""
    if torch.is_tensor(x):
        return x.permute(*reversed(range(x.ndim)))
    return np.transpose(np.asarray(x))


def _from_hwio(x):
    """A flax conv kernel HWIO -> OIHW."""
    if torch.is_tensor(x):
        return x.permute(3, 2, 0, 1)
    return np.transpose(np.asarray(x), (3, 2, 0, 1))


def _to_hwio(x):
    """OIHW, or a transformer projection's Linear layout (O, I), -> HWIO."""
    if x.ndim == 2:
        x = x[:, :, None, None]
    if torch.is_tensor(x):
        return x.permute(2, 3, 1, 0)
    return np.transpose(np.asarray(x), (2, 3, 1, 0))


def _same(x):
    return x if torch.is_tensor(x) else np.asarray(x)


#: kind -> (JAX layout -> diffusers, diffusers -> JAX layout)
_KINDS = {"conv": (_from_hwio, _to_hwio), "dense": (_flip, _flip),
          "same": (_same, _same)}


def _conv_rows(at: tuple, name: str) -> list:
    return [((*at, "kernel"), f"{name}.weight", "conv"),
            ((*at, "bias"), f"{name}.bias", "same")]


def _dense_rows(at: tuple, name: str) -> list:
    return [((*at, "kernel"), f"{name}.weight", "dense"),
            ((*at, "bias"), f"{name}.bias", "same")]


def _norm_rows(at: tuple, name: str) -> list:
    return [((*at, "scale"), f"{name}.weight", "same"),
            ((*at, "bias"), f"{name}.bias", "same")]


def _gn32_rows(at: tuple, name: str) -> list:
    # the JAX GroupNorm32 nests a child "norm"
    return _norm_rows((*at, "norm"), name)


def _resnet_rows(at: tuple, pfx: str) -> list:
    return (_gn32_rows((*at, "norm1"), f"{pfx}.norm1")
            + _conv_rows((*at, "conv1"), f"{pfx}.conv1")
            + _gn32_rows((*at, "norm2"), f"{pfx}.norm2")
            + _conv_rows((*at, "conv2"), f"{pfx}.conv2")
            + _dense_rows((*at, "time_emb_proj"), f"{pfx}.time_emb_proj")
            + _conv_rows((*at, "conv_shortcut"), f"{pfx}.conv_shortcut"))


def _attn_rows(at: tuple, pfx: str) -> list:
    rows = [r for proj in ("to_q", "to_k", "to_v")
            for r in _dense_rows((*at, proj), f"{pfx}.{proj}")]
    return rows + _dense_rows((*at, "to_out"), f"{pfx}.to_out.0")


def _transformer_rows(at: tuple, pfx: str, depth: int) -> list:
    rows = (_gn32_rows((*at, "norm"), f"{pfx}.norm")
            + _conv_rows((*at, "proj_in"), f"{pfx}.proj_in")
            + _conv_rows((*at, "proj_out"), f"{pfx}.proj_out"))
    for i in range(depth):
        b, blk = f"{pfx}.transformer_blocks.{i}", (*at, f"blocks_{i}")
        for n in ("norm1", "norm2", "norm3"):
            rows += _norm_rows((*blk, n), f"{b}.{n}")
        rows += (_attn_rows((*blk, "attn1"), f"{b}.attn1")
                 + _attn_rows((*blk, "attn2"), f"{b}.attn2")
                 + _dense_rows((*blk, "ff", "proj_in"), f"{b}.ff.net.0.proj")
                 + _dense_rows((*blk, "ff", "proj_out"), f"{b}.ff.net.2"))
    return rows


def _trunk_rows(config: UNetConfig) -> list:
    """conv_in, the time (and text_time) embeddings, the down path and the
    mid block: the part a diffusers ControlNetModel shares with the UNet."""
    rows = _conv_rows(("conv_in",), "conv_in")
    for mlp in ("time_embedding", "add_embedding"):  # add_: SDXL text_time
        for lin in ("linear_1", "linear_2"):
            rows += _dense_rows((mlp, lin), f"{mlp}.{lin}")
    n = len(config.block_out_channels)
    for level in range(n):
        for j in range(config.layers_per_block):
            rows += _resnet_rows((f"down_{level}_res_{j}",),
                                 f"down_blocks.{level}.resnets.{j}")
            if config.attn_levels[level]:
                rows += _transformer_rows(
                    (f"down_{level}_attn_{j}",),
                    f"down_blocks.{level}.attentions.{j}", config.depth(level))
        if level != n - 1:
            rows += _conv_rows((f"down_{level}_downsample", "conv"),
                               f"down_blocks.{level}.downsamplers.0.conv")
    return (rows + _resnet_rows(("mid_res_0",), "mid_block.resnets.0")
            + _transformer_rows(("mid_attn",), "mid_block.attentions.0",
                                config.depth(n - 1))
            + _resnet_rows(("mid_res_1",), "mid_block.resnets.1"))


def _unet_rows(config: UNetConfig) -> list:
    rows = (_trunk_rows(config)
            + _gn32_rows(("conv_norm_out",), "conv_norm_out")
            + _conv_rows(("conv_out",), "conv_out"))
    n = len(config.block_out_channels)
    for i in range(n):
        level = n - 1 - i
        for j in range(config.layers_per_block + 1):
            rows += _resnet_rows((f"up_{level}_res_{j}",),
                                 f"up_blocks.{i}.resnets.{j}")
            if config.attn_levels[level]:
                rows += _transformer_rows((f"up_{level}_attn_{j}",),
                                          f"up_blocks.{i}.attentions.{j}",
                                          config.depth(level))
        if i != n - 1:
            rows += _conv_rows((f"up_{level}_upsample", "conv"),
                               f"up_blocks.{i}.upsamplers.0.conv")
    return rows


def _vae_rows(config: VAEConfig) -> list:
    n = len(config.block_out_channels)
    rows = []
    for side in ("encoder", "decoder"):
        at = (side,)
        rows += (_conv_rows((*at, "conv_in"), f"{side}.conv_in")
                 + _gn32_rows((*at, "conv_norm_out"), f"{side}.conv_norm_out")
                 + _conv_rows((*at, "conv_out"), f"{side}.conv_out")
                 + _resnet_rows((*at, "mid_res_0"),
                                f"{side}.mid_block.resnets.0")
                 + _resnet_rows((*at, "mid_res_1"),
                                f"{side}.mid_block.resnets.1")
                 + _gn32_rows((*at, "mid_attn", "group_norm"),
                              f"{side}.mid_block.attentions.0.group_norm")
                 + _attn_rows((*at, "mid_attn"),
                              f"{side}.mid_block.attentions.0"))
        for i in range(n):
            # the encoder's levels go down in order, the decoder's up
            level, blocks, kind, resample = (
                (i, f"down_blocks.{i}", "down", "downsample")
                if side == "encoder"
                else (n - 1 - i, f"up_blocks.{i}", "up", "upsample"))
            count = config.layers_per_block + (side == "decoder")
            for j in range(count):
                rows += _resnet_rows((*at, f"{kind}_{level}_res_{j}"),
                                     f"{side}.{blocks}.resnets.{j}")
            if i != n - 1:
                rows += _conv_rows((*at, f"{kind}_{level}_{resample}", "conv"),
                                   f"{side}.{blocks}.{resample}rs.0.conv")
    return (rows + _conv_rows(("quant_conv",), "quant_conv")
            + _conv_rows(("post_quant_conv",), "post_quant_conv"))


def _text_rows(config: CLIPTextConfig) -> list:
    rows = [(("token_embedding", "embedding"),
             "text_model.embeddings.token_embedding.weight", "same"),
            (("position_embedding", "embedding"),
             "text_model.embeddings.position_embedding.weight", "same")]
    rows += _norm_rows(("final_layer_norm",), "text_model.final_layer_norm")
    for i in range(config.num_layers):
        b, blk = f"text_model.encoder.layers.{i}", (f"layers_{i}",)
        rows += _norm_rows((*blk, "layer_norm1"), f"{b}.layer_norm1")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rows += _dense_rows((*blk, proj), f"{b}.self_attn.{proj}")
        rows += (_norm_rows((*blk, "layer_norm2"), f"{b}.layer_norm2")
                 + _dense_rows((*blk, "fc1"), f"{b}.mlp.fc1")
                 + _dense_rows((*blk, "fc2"), f"{b}.mlp.fc2"))
    return rows + _dense_rows(("text_projection",), "text_projection")


def _taesd_block_rows(at: tuple, pfx: str) -> list:
    return [r for k in range(3)
            for r in _conv_rows((*at, f"conv_{k}"), f"{pfx}.conv.{2 * k}")]


def _taesd_rows(config: TAESDConfig, encoder: bool) -> list:
    """The encoder's Sequential: conv_in, block_in, [stride-2 conv, blocks]
    a stage, conv_out; the decoder's: conv_in, ReLU, [blocks, Upsample,
    conv] a stage, block_out, conv_out."""
    if encoder:
        rows = (_conv_rows(("conv_in",), "encoder.layers.0")
                + _taesd_block_rows(("block_in",), "encoder.layers.1"))
        i = 2
        for s in range(config.num_stages):
            rows += _conv_rows((f"down_{s}_conv",), f"encoder.layers.{i}")
            i += 1
            for j in range(config.blocks_per_stage):
                rows += _taesd_block_rows((f"down_{s}_block_{j}",),
                                          f"encoder.layers.{i}")
                i += 1
        return rows + _conv_rows(("conv_out",), f"encoder.layers.{i}")
    rows = _conv_rows(("conv_in",), "decoder.layers.0")
    i = 2
    for s in range(config.num_stages):
        for j in range(config.blocks_per_stage):
            rows += _taesd_block_rows((f"up_{s}_block_{j}",),
                                      f"decoder.layers.{i}")
            i += 1
        rows += _conv_rows((f"up_{s}_conv",), f"decoder.layers.{i + 1}")
        i += 2
    return (rows + _taesd_block_rows(("block_out",), f"decoder.layers.{i}")
            + _conv_rows(("conv_out",), f"decoder.layers.{i + 1}"))


def _vision_rows(at: tuple, pre: str, num_layers: int) -> list:
    rows = [((*at, "patch_embedding", "kernel"),
             f"{pre}embeddings.patch_embedding.weight", "conv"),
            ((*at, "position_embedding", "embedding"),
             f"{pre}embeddings.position_embedding.weight", "same"),
            ((*at, "class_embedding"), f"{pre}embeddings.class_embedding",
             "same")]
    rows += (_norm_rows((*at, "pre_layrnorm"), f"{pre}pre_layrnorm")
             + _norm_rows((*at, "post_layernorm"), f"{pre}post_layernorm"))
    for i in range(num_layers):
        b, blk = f"{pre}encoder.layers.{i}", (*at, f"layers_{i}")
        rows += (_norm_rows((*blk, "layer_norm1"), f"{b}.layer_norm1")
                 + _norm_rows((*blk, "layer_norm2"), f"{b}.layer_norm2"))
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rows += _dense_rows((*blk, proj), f"{b}.self_attn.{proj}")
        rows += (_dense_rows((*blk, "fc1"), f"{b}.mlp.fc1")
                 + _dense_rows((*blk, "fc2"), f"{b}.mlp.fc2"))
    return rows


def _safety_rows(config: SafetyConfig) -> list:
    rows = (_vision_rows(("vision_model",), "vision_model.vision_model.",
                         config.vision.num_layers)
            + _dense_rows(("visual_projection",), "visual_projection"))
    return rows + [((name,), name, "same") for name in (
        "concept_embeds", "concept_embeds_weights", "special_care_embeds",
        "special_care_embeds_weights")]


def _rrdbnet_rows(config: RRDBNetConfig) -> list:
    rows = [r for name in ("conv_first", "conv_body", "conv_up1", "conv_up2",
                           "conv_hr", "conv_last")
            for r in _conv_rows((name,), name)]
    for i in range(config.num_block):
        for r in (1, 2, 3):
            for c in range(1, 6):
                rows += _conv_rows((f"body_{i}", f"rdb{r}", f"conv{c}"),
                                   f"body.{i}.rdb{r}.conv{c}")
    return rows


_MAPPINGS = {UNetConfig: _unet_rows, VAEConfig: _vae_rows,
             CLIPTextConfig: _text_rows, TAESDConfig: _taesd_rows,
             SafetyConfig: _safety_rows, RRDBNetConfig: _rrdbnet_rows}
_MISSING = object()


def _lookup(tree, path: tuple):
    for k in path:
        if k not in tree:
            return _MISSING
        tree = tree[k]
    return tree


def _fill(tree, rows: list, out: dict) -> dict:
    """The diffusers-named leaves of ``rows`` present in ``tree``."""
    for path, key, kind in rows:
        leaf = _lookup(tree, path)
        if leaf is not _MISSING:
            out[key] = _KINDS[kind][0](leaf)
    return out


# one block's rows filled from its own subtree: the layer tests map single
# blocks, ControlNet and IP-Adapter trees reuse the trunk and the tower
def _conv(p, name, out):
    _fill(p, _conv_rows((), name), out)


def _lin(p, name, out):
    _fill(p, _dense_rows((), name), out)


def _norm(p, name, out):
    _fill(p, _norm_rows((), name), out)


def _gn32(p, name, out):
    _fill(p, _gn32_rows((), name), out)


def _resnet(p, pfx, out):
    _fill(p, _resnet_rows((), pfx), out)


def _attn(p, pfx, out):
    _fill(p, _attn_rows((), pfx), out)


def _vae_attn(p, pfx, out):
    _fill(p, _gn32_rows(("group_norm",), f"{pfx}.group_norm")
          + _attn_rows((), pfx), out)


def _transformer(p, pfx, depth, out):
    _fill(p, _transformer_rows((), pfx, depth), out)


def unet_trunk(p, config: UNetConfig, out):
    """The trunk's rows (``_trunk_rows``) of the UNet tree ``p`` into
    ``out``."""
    _fill(p, _trunk_rows(config), out)


def clip_vision(p, pre: str, num_layers: int, out):
    """The JAX ``CLIPVisionEncoder`` tree -> transformers' tower names
    under ``pre`` (``vision_model.`` in ``CLIPVisionModelWithProjection``,
    ``vision_model.vision_model.`` in the safety checker)."""
    _fill(p, _vision_rows((), pre, num_layers), out)


def _rows(config, encoder: bool) -> list:
    if isinstance(config, TAESDConfig):
        return _taesd_rows(config, encoder)
    return _MAPPINGS[type(config)](config)


def from_jax_params(tree: dict, config) -> dict[str, np.ndarray]:
    """JAX flax variables ``{"params": ...}`` of a UNet, VAE, CLIP text
    encoder, TAESD decoder or encoder, safety checker or RRDBNet -> the
    diffusers- (basicsr-) named state dict, chosen by the config's type.
    Tensor leaves give tensor views, array leaves numpy arrays."""
    p = tree["params"]
    return _fill(p, _rows(config, "block_in" in p), {})


def to_jax_params(state_dict: dict, config) -> dict:
    """The inverse of ``from_jax_params``: a diffusers- (basicsr-) named
    state dict -> the JAX package's flax variables ``{"params": ...}``,
    kernels HWIO and (in, out).  A TAESD dict holds the decoder's names or
    the encoder's, not both.  A key the table does not map raises."""
    encoder = any(k.startswith("encoder.") for k in state_dict)
    tree: dict = {}
    used = set()
    for path, key, kind in _rows(config, encoder):
        if key in state_dict:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _KINDS[kind][1](state_dict[key])
            used.add(key)
    left = sorted(state_dict.keys() - used)
    if left:
        raise KeyError(f"{type(config).__name__}: no JAX path for {left}")
    return {"params": tree}


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
        # contiguous: a transposed view would pick other kernels
        tensors[k] = t.to(dtype or ref.dtype).contiguous()
    module.load_state_dict(tensors, strict=True, assign=True)
    return module


def random_state_dict(module: nn.Module, seed: int, std: float,
                      dtype: torch.dtype | None = None,
                      device: torch.device | None = None) -> dict:
    """Every parameter of ``module`` drawn N(0, std) in float32 from one
    numpy generator, in state-dict order (shapes only are read, so a
    meta-device module serves).  With ``dtype`` each draw is cast to a
    torch tensor of that dtype as soon as it is drawn, so no more than one
    float32 tensor is held at a time (SDXL's UNet is about 10 GB in
    float32); the values are those of the float32 draws, cast.

    With ``device`` the draws come instead from one ``torch.Generator`` on
    that device seeded with ``seed`` (``torch.randn`` in float32, in
    state-dict order, each times ``std`` and cast to ``dtype``): tensors on
    the device, other values than numpy's, the same for a seed on one
    device type.  A card draws SDXL's 2.6B weights in well under a second,
    where numpy on one host thread takes about a minute."""
    if device is not None:
        gen = torch.Generator(device).manual_seed(seed)
        return {k: (torch.randn(tuple(v.shape), generator=gen, device=device)
                    * std).to(dtype or torch.float32)
                for k, v in module.state_dict().items()}
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


# ---------------------------------------------------------------------------
# checkpoints: a diffusers-layout directory or hub id
# ---------------------------------------------------------------------------

#: the wrappers a ``torch.load`` checkpoint may nest its weights under
_WRAPPERS = ("params_ema", "params", "state_dict")


def load_state_dict_file(path) -> dict:
    """A weights file -> its flat name -> tensor dict (CPU): ``.safetensors``
    through ``read_safetensors``, ``.bin``/``.pth``/``.pt``/``.ckpt``
    through ``torch.load(weights_only=True)``, unwrapped from
    ``params_ema``, ``params`` or ``state_dict`` (the JAX package's
    ``load_state_dict(path)``)."""
    sd = read_weights(path)
    for wrapper in _WRAPPERS:
        if isinstance(sd.get(wrapper), dict):
            return sd[wrapper]
    return sd


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text()) if path.exists() else {}


def vae_config_from_json(cfg: dict) -> VAEConfig:
    """A diffusers AutoencoderKL ``config.json`` -> VAEConfig, with its
    ``scaling_factor`` (0.18215 for SD 1.x/2.x, 0.13025 for SDXL)."""
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels",
                                         (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        scaling_factor=cfg.get("scaling_factor", 0.18215))


def text_config_from_json(cfg: dict, penultimate: bool = False,
                          with_projection: bool = False) -> CLIPTextConfig:
    """A transformers CLIP text ``config.json`` -> CLIPTextConfig, with its
    ``hidden_act`` (quick_gelu for OpenAI CLIP, gelu for OpenCLIP), the
    penultimate output (SDXL's towers) and the pooled projection (SDXL's
    tower 2)."""
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 768),
        intermediate_size=cfg.get("intermediate_size", 3072),
        num_layers=cfg.get("num_hidden_layers", 12),
        num_heads=cfg.get("num_attention_heads", 12),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        penultimate_hidden=penultimate,
        projection_dim=(cfg.get("projection_dim", 1280) if with_projection
                        else None))


def scheduler_config_from_json(cfg: dict):
    """A diffusers ``scheduler_config.json`` -> SchedulerConfig."""
    from ..core.schedulers import SchedulerConfig
    return SchedulerConfig(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        prediction_type=cfg.get("prediction_type", "epsilon"),
        steps_offset=cfg.get("steps_offset", 1),
        clip_sample=cfg.get("clip_sample", False),
        set_alpha_to_one=cfg.get("set_alpha_to_one", False),
        skip_prk_steps=cfg.get("skip_prk_steps", True),
        timestep_spacing=cfg.get("timestep_spacing", "leading"),
        rescale_betas_zero_snr=cfg.get("rescale_betas_zero_snr", False))


#: the files worth pulling from a hub snapshot (no .ckpt dumps)
_HUB_ALLOW_PATTERNS = ["*.json", "*.txt", "*.safetensors", "*.bin"]


def resolve_checkpoint(path_or_id, cache_dir=None, revision=None) -> Path:
    """A local directory, or a hub id ``org/name`` fetched with
    ``huggingface_hub.snapshot_download`` when that package is installed.
    Anything else, an id without the package, or a failed download raises
    ``FileNotFoundError`` saying which."""
    import re
    root = Path(path_or_id)
    if root.exists():
        return root
    if not re.fullmatch(r"[\w.\-]+/[\w.\-]+", str(path_or_id)):
        raise FileNotFoundError(
            f"{path_or_id!r} is neither a local diffusers-layout directory "
            "nor a hub id of the form 'org/name'")
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise FileNotFoundError(
            f"{path_or_id!r} is not a local directory and huggingface_hub "
            "is not installed to download it") from e
    try:
        return Path(snapshot_download(repo_id=str(path_or_id),
                                      revision=revision, cache_dir=cache_dir,
                                      allow_patterns=_HUB_ALLOW_PATTERNS))
    except Exception as e:
        raise FileNotFoundError(
            f"could not download {path_or_id!r} from the Hugging Face hub "
            f"(offline or repo missing): {type(e).__name__}: {e}") from e


#: older diffusers names of the VAE's mid-block attention
_LEGACY_VAE_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v",
                    "proj_attn": "to_out.0"}


def fit_state_dict(module: nn.Module, sd: dict) -> dict:
    """``sd`` renamed to ``module``'s names where checkpoints differ, and
    cut to them: a CLIP tower's names without ``text_model.``, the VAE
    attention's legacy ``query``/``key``/``value``/``proj_attn`` and their
    1x1-convolution shapes.  Entries the module has no slot for (a
    ``position_ids`` buffer, a tower's unused projection) are dropped; a
    missing one is left for ``load_state_dict`` to report."""
    own = module.state_dict()
    out = {}
    for k, v in sd.items():
        if f"text_model.{k}" in own and k not in own:
            k = f"text_model.{k}"
        head, _, leaf = k.rpartition(".")
        pfx, _, name = head.rpartition(".")
        if name in _LEGACY_VAE_ATTN and ".attentions." in pfx:
            k = f"{pfx}.{_LEGACY_VAE_ATTN[name]}.{leaf}"
        if k not in own:
            continue
        if len(v.shape) == 4 and len(own[k].shape) == 2:
            v = v[:, :, 0, 0]
        out[k] = v
    return out


def build_module(cls, config, sd: dict, dtype: torch.dtype) -> nn.Module:
    """``cls(config)`` built on the meta device and filled from ``sd``
    (``fit_state_dict``) in ``dtype``, in eval mode without gradients."""
    with torch.device("meta"):
        m = cls(config)
    load_state_dict(m, fit_state_dict(m, sd), dtype)
    return m.eval().requires_grad_(False)


def load_sd_checkpoint(path, dtype: torch.dtype = torch.bfloat16,
                       tiled: bool = False, with_safety: bool = True):
    """A diffusers-layout checkpoint directory, or a hub id, -> SDModels:
    SD 1.x and 2.x (``unet/``, ``vae/``, ``text_encoder/``,
    ``tokenizer/``), SDXL-base (also ``text_encoder_2/`` and
    ``tokenizer_2/``, padding with 0) and the SDXL refiner (the bigG tower
    alone, in ``text_encoder_2/``); the ``safety_checker/`` when present
    and ``with_safety``; the sampler's ``scheduler/scheduler_config.json``.
    The modules take diffusers names, so the tensors load as they are, in
    ``dtype``; ``tiled``: circular 3x3 convolutions (seamless frames)."""
    from .bundle import SDModels
    from .clip_text import CLIPTextEncoder
    from .controlnet import config_from_json
    from .safety import load_safety_checker
    from .tokenizer import CLIPBPETokenizer
    from .unet import UNet2DCondition
    from .vae import AutoencoderKL

    root = resolve_checkpoint(path)
    # heads (diffusers' attention_head_dim), per-level depth, text_time: the
    # pooled width is the MLP's input less 6 ids until tower 2 pins it
    ucfg = config_from_json(_read_json(root / "unet" / "config.json"))
    vcfg = vae_config_from_json(_read_json(root / "vae" / "config.json"))
    is_xl = (ucfg.addition_embed_dim is not None
             or (root / "text_encoder_2").exists())
    # the refiner ships the bigG tower alone, as text_encoder_2
    has_tower1 = (root / "text_encoder").exists()
    if not has_tower1 and not is_xl:
        raise FileNotFoundError(f"{root} has no text_encoder/ (and no "
                                "text_encoder_2/ to fall back on)")

    def weights(sub):
        return load_state_dict_file(find_weights_file(root / sub))

    tcfg = tower = None
    if has_tower1:
        tcfg = text_config_from_json(
            _read_json(root / "text_encoder" / "config.json"),
            penultimate=is_xl)
        tower = build_module(CLIPTextEncoder, tcfg, weights("text_encoder"),
                             dtype)
    tcfg2 = tower2 = None
    if is_xl:
        tcfg2 = text_config_from_json(
            _read_json(root / "text_encoder_2" / "config.json"),
            penultimate=True, with_projection=True)
        tower2 = build_module(CLIPTextEncoder, tcfg2,
                              weights("text_encoder_2"), dtype)
        # the UNet's json gives pooled + ids as one width; tower 2's
        # projection pins the split (base 2816 = 1280 + 6·256, refiner
        # 2560 = 1280 + 5·256, the fifth id the aesthetic score)
        proj_in = ucfg.addition_pooled_dim + 6 * ucfg.addition_embed_dim
        ucfg = dataclasses.replace(
            ucfg, addition_pooled_dim=tcfg2.projection_dim,
            addition_num_ids=((proj_in - tcfg2.projection_dim)
                              // ucfg.addition_embed_dim))
        if not has_tower1:
            tcfg, tower = tcfg2, tower2
    unet = build_module(UNet2DCondition, ucfg, weights("unet"), dtype)
    vae = build_module(AutoencoderKL, vcfg, weights("vae"), dtype)

    tok_dir = root / "tokenizer"
    if (not (tok_dir / "vocab.json").exists()
            and (root / "tokenizer_2" / "vocab.json").exists()):
        tok_dir = root / "tokenizer_2"  # the refiner's layout
    tokenizer = CLIPBPETokenizer(tok_dir / "vocab.json",
                                 tok_dir / "merges.txt")
    tokenizer_2 = None
    if is_xl:
        tok2_dir = root / "tokenizer_2"
        if not (tok2_dir / "vocab.json").exists():
            tok2_dir = tok_dir
        # OpenCLIP's tokenizer pads with 0, not with EOS
        tokenizer_2 = CLIPBPETokenizer(tok2_dir / "vocab.json",
                                       tok2_dir / "merges.txt",
                                       pad_token_id=0)
    models = SDModels(
        ucfg, vcfg, tcfg, unet, vae, tower, tokenizer,
        scheduler_config_from_json(
            _read_json(root / "scheduler" / "scheduler_config.json")),
        text_config_2=tcfg2, text_encoder_2=tower2, tokenizer_2=tokenizer_2)
    if tiled:
        models = models.with_tiled()
    if with_safety and (root / "safety_checker").exists():
        models = models.with_safety_checker(
            load_safety_checker(root / "safety_checker", dtype))
    return models
