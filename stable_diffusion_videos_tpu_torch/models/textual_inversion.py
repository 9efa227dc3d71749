"""Textual-inversion embedding files, PyTorch.

Counterpart of ``stable_diffusion_videos_tpu/models/textual_inversion.py``.
Formats: diffusers ``learned_embeds`` (one key, ``{"<token>": (D,) or (n,
D)}``), A1111 ``.pt`` (``string_to_param``), A1111 ``.safetensors``
(``emb_params``, the trigger word from the filename) and SDXL's dual-tower
``{"clip_l": (n, 768), "clip_g": (n, 1280)}``.

``apply_textual_inversion`` appends the learned vectors as rows of a copy of
the tower's token embedding (the tower's other weights shared), wraps the
tokenizer so the trigger word maps to the new ids
(``tokenizer.TextualInversionTokenizer``), and sets the tower config's
``vocab_size`` and ``eos_token_id``, so the pooled output is still read at
the EOS position and not at the highest id.  An SDXL bundle takes both
towers' vectors.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .tokenizer import TextualInversionTokenizer
from .weights import read_safetensors, shared_copy

logger = logging.getLogger("sdv_torch")


@dataclasses.dataclass
class TIEmbedding:
    token: str
    #: learned vectors per tower: "l" (or the only tower) and optionally
    #: "g" (SDXL second tower); each (n_vectors, D) float32
    vectors: dict[str, np.ndarray]

    @property
    def n_vectors(self) -> int:
        return next(iter(self.vectors.values())).shape[0]


def _as_2d(x) -> np.ndarray:
    a = (x.float().numpy() if torch.is_tensor(x)
         else np.asarray(x, np.float32))
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2:
        raise ValueError(f"embedding tensor must be 1-D or 2-D, got "
                         f"{a.shape}")
    return a


def _load_torch(path) -> dict:
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # old A1111 files pickle helper classes next to the tensors
        logger.warning("ti %s: weights_only load failed, retrying with "
                       "full unpickling", path)
        return torch.load(path, map_location="cpu", weights_only=False)


def parse_ti_file(path, token: str | None = None) -> TIEmbedding:
    """Read one textual-inversion file -> :class:`TIEmbedding`.  ``token``
    overrides the trigger word (defaults to the name stored in the file,
    else the filename stem)."""
    path = Path(path)
    if path.suffix == ".safetensors":
        sd = read_safetensors(path)[0]
    else:
        sd = _load_torch(path)

    if "clip_l" in sd or "clip_g" in sd:  # SDXL dual-tower
        vectors = {}
        if "clip_l" in sd:
            vectors["l"] = _as_2d(sd["clip_l"])
        if "clip_g" in sd:
            vectors["g"] = _as_2d(sd["clip_g"])
        if len(vectors) == 2 and \
                vectors["l"].shape[0] != vectors["g"].shape[0]:
            raise ValueError(f"{path}: clip_l/clip_g vector counts differ "
                             f"({vectors['l'].shape[0]} vs "
                             f"{vectors['g'].shape[0]})")
        return TIEmbedding(token or path.stem, vectors)
    if "string_to_param" in sd:  # A1111 .pt
        tensors = list(sd["string_to_param"].values())
        if len(tensors) != 1:
            raise ValueError(f"{path}: expected one concept in "
                             f"string_to_param, got {len(tensors)}")
        name = sd.get("name")
        return TIEmbedding(token or (name if isinstance(name, str) else None)
                           or path.stem, {"l": _as_2d(tensors[0])})
    if "emb_params" in sd:  # A1111 .safetensors
        return TIEmbedding(token or path.stem, {"l": _as_2d(sd["emb_params"])})
    tensor_keys = [k for k, v in sd.items()
                   if hasattr(v, "shape") and len(v.shape) in (1, 2)]
    if len(tensor_keys) == 1:  # diffusers learned_embeds
        k = tensor_keys[0]
        return TIEmbedding(token or k, {"l": _as_2d(sd[k])})
    raise ValueError(f"{path}: not a recognised textual-inversion file "
                     f"(keys: {sorted(sd)[:5]})")


def _extend_tower(encoder, config, tokenizer, vectors: np.ndarray):
    """A copy of ``encoder`` with ``vectors`` appended to its token
    embedding -> (encoder, config, new ids)."""
    old = encoder.text_model.embeddings.token_embedding.weight
    V, D = old.shape
    if vectors.shape[1] != D:
        raise ValueError(f"embedding width {vectors.shape[1]} does not "
                         f"match the text tower's hidden size {D}")
    new_ids = list(range(V, V + vectors.shape[0]))
    config = dataclasses.replace(config, vocab_size=V + vectors.shape[0],
                                 eos_token_id=int(tokenizer.eos_token_id))
    encoder = shared_copy(encoder)
    table = nn.Embedding(V + vectors.shape[0], D, device="meta")
    table.weight = nn.Parameter(torch.cat([old, torch.from_numpy(
        vectors).to(device=old.device, dtype=old.dtype)]),
        requires_grad=False)
    encoder.text_model.embeddings.token_embedding = table
    encoder.config = config
    return encoder, config, new_ids


def _wrap(tokenizer, trigger: str, ids: list[int]):
    if isinstance(tokenizer, TextualInversionTokenizer):
        return tokenizer.with_trigger(trigger, ids)
    return TextualInversionTokenizer(tokenizer, {trigger: ids})


def apply_textual_inversion(models, path, token: str | None = None):
    """Merge one textual-inversion file into a bundle -> a new ``SDModels``
    (the base untouched).  An SDXL bundle needs both towers' vectors
    (``clip_l``/``clip_g``); a one-tower file goes to the bundle's one
    tower."""
    ti = parse_ti_file(path, token=token)
    changes: dict = {}
    if models.text_config_2 is not None:  # two towers
        if set(ti.vectors) != {"l", "g"}:
            raise ValueError(
                f"{path}: this is an SDXL bundle, so the embedding file must "
                f"carry both clip_l and clip_g vectors (found "
                f"{sorted(ti.vectors)})")
        tok2 = models.tokenizer_2 or models.tokenizer
        enc, changes["text_config"], ids = _extend_tower(
            models.text_encoder, models.text_config, models.tokenizer,
            ti.vectors["l"])
        enc2, changes["text_config_2"], ids2 = _extend_tower(
            models.text_encoder_2, models.text_config_2, tok2,
            ti.vectors["g"])
        changes.update(text_encoder=enc, text_encoder_2=enc2,
                       tokenizer=_wrap(models.tokenizer, ti.token, ids),
                       tokenizer_2=_wrap(tok2, ti.token, ids2))
    else:
        if "g" in ti.vectors and "l" not in ti.vectors:
            vec = ti.vectors["g"]
        elif len(ti.vectors) == 2:
            # a two-tower file on a one-tower bundle: the matching width
            D = models.text_config.hidden_size
            vec = next((v for v in ti.vectors.values() if v.shape[1] == D),
                       None)
            if vec is None:
                raise ValueError(f"{path}: no tower matches hidden size {D}")
        else:
            vec = ti.vectors["l"]
        enc, changes["text_config"], ids = _extend_tower(
            models.text_encoder, models.text_config, models.tokenizer, vec)
        changes.update(text_encoder=enc,
                       tokenizer=_wrap(models.tokenizer, ti.token, ids))
    logger.info("textual inversion %s: trigger %r -> %d vector(s)", path,
                ti.token, ti.n_vectors)
    return dataclasses.replace(models, **changes)


def parse_ti_arg(arg: str) -> tuple[str, str | None]:
    """The command line's ``path[:token]`` -> (path, token or None).  A
    suffix holding a slash or a dot (a file suffix, a path) stays part of
    the path, so a path with a drive colon still parses."""
    if ":" in arg:
        head, tail = arg.rsplit(":", 1)
        if tail and "/" not in tail and "." not in tail.rstrip(">"):
            return head, tail
    return arg, None
