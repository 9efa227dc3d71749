"""Bundles in the JAX package's native format (version 1), read and written
without flax.

Counterpart of ``stable_diffusion_videos_tpu/models/io.py``.  A bundle is a
directory: ``bundle.json`` (the configs, the dtype, ``tiled``, the
component names, the tokenizer's kind and vocabulary size, the
textual-inversion triggers) and one ``<component>.msgpack`` a component,
each the component's flax variables ``{"params": ...}`` in the JAX layout
(``models/flax_msgpack.py``).  The components are ``unet``, ``vae``,
``text_encoder`` and, when the bundle has them, ``text_encoder_2``,
``safety_checker``, ``taesd_decoder`` and ``taesd_encoder``.  A BPE
tokenizer's files go in ``tokenizer/`` and ``tokenizer_2/``.  A bundle
written by either package loads in both.

The JAX package builds each config with ``Cls(**fields)``, so the config
entries hold exactly its field names.  Its ``SchedulerConfig`` has three
fields the port's lacks (``solver_order``, ``algorithm_type``,
``thresholding``; no sampler reads them): they are carried through in
``SDModels.bundle_scheduler_fields``.  The port's ``CLIPVisionConfig`` has
``hidden_act``, which the JAX package's lacks: it goes in the top-level key
``safety_hidden_act`` (quick_gelu, what the JAX tower computes, when
absent), beside ``tokenizer_2`` and ``pad_token_ids``, which record the
port's hash tokenizers; the JAX loader reads none of the three.

Loading builds each module on the meta device and fills it through
``from_jax_params`` and ``load_state_dict``, one tensor at a time from a
mapping of the file, straight onto ``device``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Optional, Union

import torch

from . import flax_msgpack
from .weights import from_jax_params, load_state_dict, to_jax_params

FORMAT_VERSION = 1
#: the JAX ``SchedulerConfig`` fields the port's lacks, at JAX's defaults
JAX_SCHEDULER_FIELDS = {"solver_order": 2, "algorithm_type": "dpmsolver++",
                        "thresholding": False}


def _cfg_to_dict(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _cfg_to_dict(v)
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out


def _state_dicts(models) -> dict:
    """{component: (state dict, config)} in the JAX package's names."""
    parts = {"unet": (models.unet, models.unet_config),
             "vae": (models.vae, models.vae_config),
             "text_encoder": (models.text_encoder, models.text_config)}
    if models.text_encoder_2 is not None:
        parts["text_encoder_2"] = (models.text_encoder_2,
                                   models.text_config_2)
    if models.safety is not None:
        parts["safety_checker"] = (models.safety, models.safety.config)
    out = {name: (m.state_dict(), cfg) for name, (m, cfg) in parts.items()}
    if models.taesd is not None:
        sd = models.taesd.state_dict()
        for side in ("decoder", "encoder"):
            sub = {k: v for k, v in sd.items() if k.startswith(f"{side}.")}
            if sub:
                out[f"taesd_{side}"] = (sub, models.taesd.config)
    return out


def param_count(models) -> dict[str, int]:
    """Elements a component, in the JAX package's component names."""
    return {name: sum(t.numel() for t in sd.values())
            for name, (sd, _) in _state_dicts(models).items()}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[1]


def save_bundle(models, path) -> str:
    """Write ``models`` to the directory ``path`` (made if missing): one
    ``.msgpack`` a component, written a tensor at a time, and
    ``bundle.json``; a BPE tokenizer's files are copied."""
    from .tokenizer import (CLIPBPETokenizer, HashTokenizer,
                            TextualInversionTokenizer)

    def unwrap(tok):
        return tok.base if isinstance(tok, TextualInversionTokenizer) \
            else tok

    def triggers(tok):
        return tok.triggers if isinstance(tok, TextualInversionTokenizer) \
            else None

    base_tok = unwrap(models.tokenizer)
    base_tok2 = unwrap(models.tokenizer_2) if models.tokenizer_2 else None
    parts = _state_dicts(models)
    safety_config = None
    if models.safety is not None:
        safety_config = _cfg_to_dict(models.safety.config)
        hidden_act = safety_config["vision"].pop("hidden_act")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = {
        "format_version": FORMAT_VERSION,
        "dtype": _dtype_name(models.dtype),
        "tiled": models.tiled,
        "unet_config": _cfg_to_dict(models.unet_config),
        "vae_config": _cfg_to_dict(models.vae_config),
        "text_config": _cfg_to_dict(models.text_config),
        "text_config_2": (_cfg_to_dict(models.text_config_2)
                          if models.text_config_2 else None),
        "scheduler_config": {**_cfg_to_dict(models.scheduler_config),
                             **JAX_SCHEDULER_FIELDS,
                             **models.bundle_scheduler_fields},
        "safety_config": safety_config,
        "taesd_config": (_cfg_to_dict(models.taesd.config)
                         if models.taesd is not None else None),
        "components": sorted(parts),
        "tokenizer": ("bpe" if isinstance(base_tok, CLIPBPETokenizer)
                      else "hash"),
        "tokenizer_vocab_size": getattr(base_tok, "vocab_size", None),
        "ti_triggers": triggers(models.tokenizer),
        "ti_triggers_2": triggers(models.tokenizer_2),
        # the port's own keys, which the JAX loader does not read
        "tokenizer_2": ("hash" if isinstance(base_tok2, HashTokenizer)
                        else None),
        "pad_token_ids": {
            "tokenizer": getattr(base_tok, "pad_token_id", None),
            "tokenizer_2": getattr(base_tok2, "pad_token_id", None)},
    }
    if safety_config is not None:
        meta["safety_hidden_act"] = hidden_act
    (path / "bundle.json").write_text(json.dumps(meta, indent=2))
    for sub, tok in (("tokenizer", base_tok), ("tokenizer_2", base_tok2)):
        if isinstance(tok, CLIPBPETokenizer):
            (path / sub).mkdir(exist_ok=True)
            shutil.copy(tok.vocab_path, path / sub / "vocab.json")
            shutil.copy(tok.merges_path, path / sub / "merges.txt")
    for name, (sd, cfg) in parts.items():
        flax_msgpack.write(path / f"{name}.msgpack", to_jax_params(sd, cfg))
    return str(path)


def load_bundle(path, dtype: Union[torch.dtype, str, None] = None,
                device: Union[torch.device, str] = "cpu"):
    """A bundle directory written by either package -> ``SDModels`` on
    ``device``, in ``dtype`` (default: the bundle's)."""
    from ..core.schedulers import SchedulerConfig
    from .bundle import SDModels
    from .clip_text import CLIPTextConfig, CLIPTextEncoder
    from .safety import CLIPVisionConfig, SafetyChecker, SafetyConfig
    from .taesd import TAESDConfig
    from .tokenizer import (CLIPBPETokenizer, HashTokenizer,
                            TextualInversionTokenizer)
    from .unet import UNet2DCondition, UNetConfig
    from .vae import AutoencoderKL, VAEConfig

    path = Path(path)
    device = torch.device(device)
    meta = json.loads((path / "bundle.json").read_text())
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported bundle format {meta['format_version']}")
    dtype = dtype or meta["dtype"]
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)

    def config(cls, fields: Optional[dict]):
        if fields is None:
            return None
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in fields.items()})

    def state_dict(name: str, cfg) -> dict:
        """The component's tensors, copied off the file's mapping onto
        ``device`` one at a time, in their stored dtype."""
        tree = flax_msgpack.read(path / f"{name}.msgpack")
        return {k: torch.empty(v.shape, dtype=v.dtype,
                               device=device).copy_(v)
                for k, v in from_jax_params(tree, cfg).items()}

    def module(cls, name: str, cfg):
        with torch.device("meta"):
            m = cls(cfg)
        load_state_dict(m, state_dict(name, cfg), dtype)
        return m.eval().requires_grad_(False)

    ucfg = config(UNetConfig, meta["unet_config"])
    vcfg = config(VAEConfig, meta["vae_config"])
    tcfg = config(CLIPTextConfig, meta["text_config"])
    tcfg2 = config(CLIPTextConfig, meta.get("text_config_2"))
    sched = dict(meta["scheduler_config"])
    extras = {k: sched.pop(k, v) for k, v in JAX_SCHEDULER_FIELDS.items()}
    scfg = SchedulerConfig(**sched)

    components = set(meta["components"])
    text_encoder = module(CLIPTextEncoder, "text_encoder", tcfg)
    text_encoder_2 = None
    if "text_encoder_2" in components:
        # the SDXL refiner's one tower is both (the JAX layout saves it
        # twice)
        text_encoder_2 = (text_encoder if tcfg2 == tcfg else
                          module(CLIPTextEncoder, "text_encoder_2", tcfg2))

    pads = meta.get("pad_token_ids") or {}
    tok_dir, tok2_dir = path / "tokenizer", path / "tokenizer_2"
    if meta["tokenizer"] == "bpe" and tok_dir.exists():
        tokenizer = CLIPBPETokenizer(tok_dir / "vocab.json",
                                     tok_dir / "merges.txt",
                                     pad_token_id=pads.get("tokenizer"))
    else:
        tokenizer = HashTokenizer(
            vocab_size=meta.get("tokenizer_vocab_size") or tcfg.vocab_size,
            pad_token_id=pads.get("tokenizer"))
    tokenizer_2 = None
    if tok2_dir.exists():
        tokenizer_2 = CLIPBPETokenizer(tok2_dir / "vocab.json",
                                       tok2_dir / "merges.txt",
                                       pad_token_id=pads.get("tokenizer_2",
                                                             0))
    elif meta.get("tokenizer_2") == "hash":
        tokenizer_2 = HashTokenizer(vocab_size=tcfg2.vocab_size,
                                    pad_token_id=pads.get("tokenizer_2"))
    base_tok = tokenizer
    if meta.get("ti_triggers"):
        tokenizer = TextualInversionTokenizer(tokenizer, meta["ti_triggers"])
    if meta.get("ti_triggers_2"):
        tokenizer_2 = TextualInversionTokenizer(tokenizer_2 or base_tok,
                                                meta["ti_triggers_2"])

    models = SDModels(
        ucfg, vcfg, tcfg, module(UNet2DCondition, "unet", ucfg),
        module(AutoencoderKL, "vae", vcfg), text_encoder, tokenizer, scfg,
        text_config_2=tcfg2, text_encoder_2=text_encoder_2,
        tokenizer_2=tokenizer_2, bundle_scheduler_fields=extras)
    if meta["tiled"]:
        models = models.with_tiled()
    if meta.get("safety_config"):
        sc = dict(meta["safety_config"])
        sc["vision"] = CLIPVisionConfig(
            **sc["vision"],
            hidden_act=meta.get("safety_hidden_act", "quick_gelu"))
        cfg = SafetyConfig(**sc)
        models = models.with_safety_checker(SafetyChecker.build(
            cfg, state_dict("safety_checker", cfg), dtype))
    if meta.get("taesd_config") and "taesd_decoder" in components:
        cfg = config(TAESDConfig, meta["taesd_config"])
        sd = {k: v for name in ("taesd_decoder", "taesd_encoder")
              if name in components for k, v in state_dict(name, cfg).items()}
        models = models.with_taesd(cfg, sd)
    return models
