"""Prompt emphasis weighting and long-prompt chunking.

Counterpart of ``stable_diffusion_videos_tpu/core/prompt_weighting.py``: the
A1111/compel grammar (``(text)`` multiplies the fragment's token weights by
1.1, ``[text]`` by 1/1.1, ``(text:1.5)`` sets a multiplier, groups nest,
``\\(`` ``\\)`` ``\\[`` ``\\]`` ``\\\\`` escape literals, unbalanced
brackets stay text), ``BREAK`` as a forced window boundary, and prompts past
75 tokens split into several 77-token CLIP windows whose hidden states
concatenate along the sequence axis.  The parser and the windows are host
code, copied from the JAX package (importing it there loads flax);
``apply_token_weights`` is torch: ``h *= w``, then each (sample, window)
rescaled to its mean before weighting, so a weight of 1 everywhere is an
exact no-op.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np
import torch

#: multiplier for one level of ``(...)`` emphasis (the community constant)
EMPHASIS_STEP = 1.1

_TOKEN_RE = re.compile(r"""
    \\\(|\\\)|\\\[|\\\]|\\\\|\\:   # escaped specials -> literal char
    |\(|\[                         # group opens
    |:\s*([+-]?[0-9]*\.?[0-9]+)\s*\)   # explicit-weight close
    |\)|\]                         # plain closes
    |[^\\()\[\]:]+                 # plain text run
    |:                             # lone colon -> literal
""", re.X)

_BREAK_RE = re.compile(r"(?:^|\s)BREAK(?:\s|$)")

#: sentinel fragment marking a forced chunk boundary
BREAK = object()


def parse_prompt_attention(text: str) -> List[Tuple[str, float]]:
    """``"a (red:1.3) [cat]"`` -> ``[("a ",1.0),("red",1.3),(" ",1.0),
    ("cat",1/1.1)]`` — fragments with their final multiplicative weights.

    ``BREAK`` fragments come out as ``("BREAK", -1.0)`` markers.  Adjacent
    fragments with equal weight are merged.  Unbalanced brackets degrade to
    literal text (their pending multiplier is simply never applied).
    """
    res: List[List] = []          # [text, weight] pairs, mutable
    round_stack: List[int] = []   # indices into res where '(' opened
    square_stack: List[int] = []

    def mul_range(start: int, mult: float):
        for pair in res[start:]:
            if pair[1] > 0:       # skip BREAK markers
                pair[1] *= mult

    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        explicit = m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_stack.append(len(res))
        elif tok == "[":
            square_stack.append(len(res))
        elif explicit is not None and round_stack:
            mul_range(round_stack.pop(), float(explicit))
        elif tok == ")" and round_stack:
            mul_range(round_stack.pop(), EMPHASIS_STEP)
        elif tok == "]" and square_stack:
            mul_range(square_stack.pop(), 1.0 / EMPHASIS_STEP)
        else:
            if explicit is not None:      # ':1.5)' with no open '(' ->
                tok = m.group(0)          # literal text
            # split out standalone BREAKs
            parts = _BREAK_RE.split(tok)
            for i, part in enumerate(parts):
                if i:
                    res.append(["BREAK", -1.0])
                if part:
                    res.append([part, 1.0])
    # merge adjacent equal-weight fragments
    merged: List[Tuple[str, float]] = []
    for txt, w in res:
        if w > 0 and merged and merged[-1][1] == w:
            merged[-1] = (merged[-1][0] + txt, w)
        else:
            merged.append((txt, w))
    if not merged:
        merged = [("", 1.0)]
    return merged


def strip_prompt_weights(text: str) -> str:
    """The prompt with all emphasis syntax removed (for pooled embeddings,
    logging, and config persistence)."""
    return "".join(t for t, w in parse_prompt_attention(text) if w > 0)


def has_prompt_weighting(text: str) -> bool:
    """True if parsing would change anything (emphasis present or BREAK)."""
    frags = parse_prompt_attention(text)
    return any(w != 1.0 for _, w in frags) or len(frags) > 1


def _window(ids: List[int], weights: List[float], tokenizer):
    """One 77-token CLIP window: BOS + <=75 tokens + EOS + pad."""
    L = tokenizer.model_max_length
    pad_id = (tokenizer.eos_token_id if tokenizer.pad_token_id is None
              else tokenizer.pad_token_id)
    out_ids = np.full((L,), pad_id, np.int32)
    out_w = np.ones((L,), np.float32)
    out_ids[0] = tokenizer.bos_token_id
    n = len(ids)
    out_ids[1:1 + n] = ids
    out_w[1:1 + n] = weights
    out_ids[1 + n] = tokenizer.eos_token_id
    return out_ids, out_w


def encode_weighted(tokenizer, text: str, num_chunks: int | None = None):
    """Prompt -> (ids (n,77) int32, weights (n,77) float32).

    ``n`` is the number of 77-token windows the prompt needs (>=1), or
    ``num_chunks`` if given (pad with empty windows; error if the prompt
    needs more).  BOS/EOS/pad positions always carry weight 1.0.
    """
    cap = tokenizer.model_max_length - 2   # 75 content tokens per window
    chunks: List[Tuple[List[int], List[float]]] = [([], [])]
    for frag, w in parse_prompt_attention(text):
        if w < 0:  # BREAK
            chunks.append(([], []))
            continue
        for tid in tokenizer.encode(frag):
            if len(chunks[-1][0]) >= cap:
                chunks.append(([], []))
            chunks[-1][0].append(tid)
            chunks[-1][1].append(w)
    if num_chunks is not None:
        if len(chunks) > num_chunks:
            raise ValueError(
                f"prompt needs {len(chunks)} windows > num_chunks="
                f"{num_chunks}")
        while len(chunks) < num_chunks:
            chunks.append(([], []))
    ids, weights = zip(*(_window(i, w, tokenizer) for i, w in chunks))
    return np.stack(ids), np.stack(weights)


def chunks_needed(tokenizer, text: str) -> int:
    """Number of 77-token windows ``encode_weighted`` would produce."""
    return encode_weighted(tokenizer, text)[0].shape[0]


def apply_token_weights(hidden, weights) -> torch.Tensor:
    """Mean-preserving per-token scaling of encoder hidden states.

    hidden: (N, 77, D) tensor; weights: (N, 77) array or tensor.  Returns
    the float32 weighted hidden states with each sample's overall mean
    restored, on ``hidden``'s device, so a weight of 1 everywhere is an
    exact no-op."""
    h = torch.as_tensor(hidden).float()
    w = torch.as_tensor(np.asarray(weights, np.float32),
                        device=h.device)[..., None]
    mean_before = h.mean(dim=(-2, -1), keepdim=True)
    h = h * w
    mean_after = h.mean(dim=(-2, -1), keepdim=True)
    return h * (mean_before / torch.where(mean_after == 0,
                                          torch.ones_like(mean_after),
                                          mean_after))
