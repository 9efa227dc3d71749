"""Community LoRA files: kohya-ss and diffusers/peft formats, PyTorch.

Counterpart of ``stable_diffusion_videos_tpu/models/lora_file.py``.  kohya
files name modules ``lora_unet_<module>`` / ``lora_te_`` (``lora_te1_`` and
``lora_te2_`` for SDXL's two towers) with ``.lora_down``/``.lora_up``/
``.alpha``; diffusers/peft files ``unet.<dotted>.lora_A``/``lora_B``.  kohya
SD 1.x/2.x files use the diffusers module scheme
(``down_blocks_0_attentions_0_...``), kohya SDXL files the original LDM
scheme (``input_blocks_4_1_...``), which ``ldm_unet_aliases`` translates.
The module map comes from the port's own diffusers-named modules: a kohya
name is the module's dotted name with ``_`` for ``.``.

The merge runs once, on the host's side of the weights: ``W + scale ·
(alpha / rank) · up @ down`` in fp32, cast back to the weight's dtype, on a
copy of each touched module tree (``weights.shared_copy``), so the base
bundle is untouched and the denoise path runs the same kernels as before.
Adapters: Linear, 1x1 convolution (stored either way) and LoCon 3x3
(``down (r, in, 3, 3)``, ``up (out, r, 1, 1)``).  A ``.npz`` is the LoRA
trainer's own format (``training/lora.py``, the JAX package's format),
merged into the UNet at ``scale · alpha / rank``.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
from torch import nn

from .weights import read_safetensors, shared_copy

logger = logging.getLogger("sdv_torch")

#: UNet modules outside the JAX package's LoRA map: the time and text_time
#: embeddings and the IP-Adapter's projections
_UNET_EXCLUDED = ("time_embedding.", "add_embedding.")


def unet_module_map(unet: nn.Module) -> dict[str, nn.Module]:
    """{kohya module name (no ``lora_unet_`` prefix): module} for every
    Linear and convolution of the UNet a LoRA may target: the resnets'
    convolutions and time projections, the transformers' projections,
    attentions and feed-forwards, the resamplers, conv_in and conv_out."""
    return {name.replace(".", "_"): mod
            for name, mod in unet.named_modules()
            if isinstance(mod, (nn.Linear, nn.Conv2d))
            and not name.startswith(_UNET_EXCLUDED)
            and not name.endswith(("to_k_ip", "to_v_ip"))}


def text_module_map(encoder: nn.Module) -> dict[str, nn.Module]:
    """{kohya module name (no ``lora_te*_`` prefix): module}: each encoder
    layer's q/k/v/out projections and MLP (kohya names both SDXL towers in
    the HF CLIP scheme)."""
    return {name.replace(".", "_"): mod
            for name, mod in encoder.named_modules()
            if isinstance(mod, nn.Linear)
            and name.startswith("text_model.encoder.layers.")}


#: LDM resnet inner names (kohya SDXL conv-LoRA naming)
_LDM_RES_LEAF = {"conv1": "in_layers_2", "conv2": "out_layers_3",
                 "time_emb_proj": "emb_layers_1",
                 "conv_shortcut": "skip_connection"}


def ldm_unet_aliases(config) -> dict[str, str]:
    """{LDM-scheme module name: diffusers-scheme module name} for this UNet
    geometry — kohya SDXL LoRAs use ``input_blocks_4_1_...`` style names
    (sd-scripts adapts the original SDXL UNet, not the diffusers one).
    Derived from the config as the JAX package's original-layout loader
    maps the blocks.
    """
    n = len(config.block_out_channels)
    lp = config.layers_per_block
    attn = config.attn_levels
    alias: dict[str, str] = {}

    def res(ldm_pfx, diff_pfx):
        for ours, ldm_inner in _LDM_RES_LEAF.items():
            alias[f"{ldm_pfx}_{ldm_inner}"] = f"{diff_pfx}_{ours}"

    i = 1
    for L in range(n):
        for j in range(lp):
            res(f"input_blocks_{i}_0", f"down_blocks_{L}_resnets_{j}")
            if attn[L]:
                alias[f"input_blocks_{i}_1"] = \
                    f"down_blocks_{L}_attentions_{j}"
            i += 1
        if L != n - 1:
            alias[f"input_blocks_{i}_0_op"] = \
                f"down_blocks_{L}_downsamplers_0_conv"
            i += 1
    res("middle_block_0", "mid_block_resnets_0")
    alias["middle_block_1"] = "mid_block_attentions_0"
    res("middle_block_2", "mid_block_resnets_1")
    i = 0
    for u in range(n):
        L = n - 1 - u
        for j in range(lp + 1):
            res(f"output_blocks_{i}_0", f"up_blocks_{u}_resnets_{j}")
            mod = 1
            if attn[L]:
                alias[f"output_blocks_{i}_1"] = f"up_blocks_{u}_attentions_{j}"
                mod = 2
            if j == lp and u != n - 1:
                alias[f"output_blocks_{i}_{mod}_conv"] = \
                    f"up_blocks_{u}_upsamplers_0_conv"
            i += 1
    return alias


@dataclasses.dataclass
class LoRADelta:
    down: np.ndarray  # (r, in[, kh, kw])
    up: np.ndarray    # (out, r[, 1, 1])
    alpha: float | None = None  # None -> alpha == rank (factor 1)

    @property
    def rank(self) -> int:
        return self.down.shape[0]

    def factor(self) -> float:
        return 1.0 if self.alpha is None else self.alpha / self.rank


_GROUP_PREFIXES = [  # file key prefix -> bundle group (longest match first)
    ("lora_unet_", "unet"), ("lora_te1_", "text_encoder"),
    ("lora_te2_", "text_encoder_2"), ("lora_te_", "text_encoder"),
    ("unet.", "unet"), ("text_encoder_2.", "text_encoder_2"),
    ("text_encoder.", "text_encoder"),
]
#: (suffix of the key stem once ``.weight`` is stripped, adapter part)
_PART_SUFFIXES = [
    (".lora_down", "down"), (".lora_A", "down"), (".lora.down", "down"),
    (".lora_up", "up"), (".lora_B", "up"), (".lora.up", "up"),
    # kohya underscore-joined forms (dots already collapsed in some dumps)
    ("_lora_down", "down"), ("_lora_up", "up"),
]


def parse_lora_file(path) -> dict[str, dict[str, LoRADelta]]:
    """LoRA ``.safetensors`` -> {group: {module_name: LoRADelta}} with
    kohya-style underscore module names (dotted peft names normalised)."""
    sd = {k: v.float().numpy() for k, v in read_safetensors(path)[0].items()}
    groups: dict[str, dict[str, dict]] = {}
    skipped = []
    for key, value in sd.items():
        hit = next(((pfx, g) for pfx, g in _GROUP_PREFIXES
                    if key.startswith(pfx)), None)
        if hit is None:
            skipped.append(key)
            continue
        pfx, grp = hit
        rest = key[len(pfx):]
        if rest.endswith(".alpha"):
            mod, part = rest[:-len(".alpha")], "alpha"
        elif rest.endswith(".weight"):
            stem = rest[:-len(".weight")]
            for suffix, part in _PART_SUFFIXES:
                if stem.endswith(suffix):
                    mod = stem[:-len(suffix)]
                    break
            else:
                skipped.append(key)
                continue
        else:
            skipped.append(key)
            continue
        mod = mod.replace(".", "_")
        groups.setdefault(grp, {}).setdefault(mod, {})[part] = value
    if skipped:
        logger.warning("lora %s: %d unrecognised keys (e.g. %s)", path,
                       len(skipped), skipped[:3])
    out: dict[str, dict[str, LoRADelta]] = {}
    for grp, mods in groups.items():
        out[grp] = {}
        for mod, parts in mods.items():
            if "down" not in parts or "up" not in parts:
                logger.warning("lora %s: module %s missing down/up — "
                               "skipped", path, mod)
                continue
            alpha = parts.get("alpha")
            out[grp][mod] = LoRADelta(
                down=np.asarray(parts["down"], np.float32),
                up=np.asarray(parts["up"], np.float32),
                alpha=(float(np.asarray(alpha).item())
                       if alpha is not None else None))
    if not any(out.values()):
        raise ValueError(f"{path}: no LoRA modules found (not a kohya- or "
                         "diffusers-format LoRA file?)")
    return out


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def _translate_ldm(mod: str, aliases: dict[str, str]) -> str:
    """LDM-scheme module name -> diffusers-scheme, by longest-prefix block
    alias; names already in the diffusers scheme pass through unchanged."""
    for a in sorted(aliases, key=len, reverse=True):
        if mod == a:
            return aliases[a]
        if mod.startswith(a + "_"):
            return aliases[a] + mod[len(a):]
    return mod


def delta_for_weight(shape: tuple, d: LoRADelta) -> np.ndarray:
    """The adapter's delta in the weight's PyTorch layout: (out, in) for a
    Linear, (out, in, kh, kw) for a convolution."""
    down, up = d.down, d.up
    if up.ndim == 4:
        up = up[:, :, 0, 0]  # (out, r)
    if len(shape) == 2:
        if down.ndim == 4:
            down = down[:, :, 0, 0]
        return (up @ down).astype(np.float32)
    if down.ndim == 2:
        down = down[:, :, None, None]
    if tuple(down.shape[2:]) != tuple(shape[2:]):
        raise ValueError(f"lora down kernel {d.down.shape} incompatible "
                         f"with conv weight {tuple(shape)}")
    return np.einsum("or,rihw->oihw", up, down).astype(np.float32)


def _merge(module: nn.Module, module_map: dict, deltas: dict,
           scale: float, label: str) -> int:
    """Add each delta to its module's weight in place (fp32 sum, cast back
    to the weight's dtype, as a new tensor) -> the number merged."""
    matched = 0
    for mod_name, d in deltas.items():
        target = module_map.get(mod_name)
        if target is None:
            logger.warning("lora: no %s module for %r, skipped", label,
                           mod_name)
            continue
        w = target.weight
        delta = torch.from_numpy(delta_for_weight(tuple(w.shape), d)
                                 * np.float32(scale * d.factor()))
        target.weight = nn.Parameter(
            (w.float() + delta.to(w.device)).to(w.dtype), requires_grad=False)
        matched += 1
    return matched


def apply_lora(models, path, scale: float = 1.0):
    """Merge one LoRA file into a bundle -> a new ``SDModels`` whose touched
    modules are copies (the base bundle is untouched)."""
    if str(path).endswith(".npz"):
        from ..training.lora import LoRATrainer, merge_lora
        lora, rank, alpha = LoRATrainer.load_lora(path)
        unet = merge_lora(models.unet, lora, scale * alpha / rank)
        logger.info("merged trainer lora %s (rank %d) into unet", path, rank)
        return dataclasses.replace(models, unet=unet)
    groups = parse_lora_file(path)
    changes, total = {}, 0
    for grp, deltas in groups.items():
        module = getattr(models, grp, None)
        if module is None:
            logger.warning("lora %s targets %s which this bundle lacks, "
                           "skipped (%d modules)", path, grp, len(deltas))
            continue
        module = shared_copy(module)
        if grp == "unet":
            mmap = unet_module_map(module)
            # kohya's SDXL files name blocks in the LDM scheme
            aliases = ldm_unet_aliases(models.unet_config)
            deltas = {_translate_ldm(mod, aliases): d
                      for mod, d in deltas.items()}
        else:
            mmap = text_module_map(module)
        total += _merge(module, mmap, deltas, scale, grp)
        changes[grp] = module
    if total == 0:
        raise ValueError(f"{path}: no LoRA module matched this bundle's "
                         "architecture")
    logger.info("merged lora %s: %d modules at scale %.3g", path, total,
                scale)
    return dataclasses.replace(models, **changes)


def parse_lora_arg(arg: str) -> tuple[str, float]:
    """The command line's ``path[:scale]`` -> (path, scale); a suffix that
    is not a number stays part of the path."""
    if ":" in arg:
        head, tail = arg.rsplit(":", 1)
        try:
            return head, float(tail)
        except ValueError:
            pass
    return arg, 1.0
