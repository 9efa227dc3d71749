"""CLIP tokenizer — self-contained BPE, no transformers dependency required.

Owns the role of ``transformers.CLIPTokenizer`` in the reference
(``stable_diffusion_pipeline.py:28,291-306``): prompt -> fixed 77-token id
array (BOS ... EOS pad...).  Three implementations behind one interface:

* ``CLIPBPETokenizer`` — full byte-level BPE from ``vocab.json`` +
  ``merges.txt`` (the files shipped inside every SD checkpoint).  Used
  whenever real weights are loaded.
* ``HFTokenizerAdapter`` — wraps an already-constructed ``transformers``
  tokenizer if the user has one.
* ``HashTokenizer`` — deterministic stub for weightless/tiny-model tests.

All return int32 numpy arrays of shape (B, model_max_length).

A copy of ``stable_diffusion_videos_tpu/models/tokenizer.py``: that module is
numpy-only, but importing it through its package loads flax.  Here
``HashTokenizer`` also takes ``pad_token_id``, so a bundle's second tower
can pad with 0 as SDXL's OpenCLIP tokenizer does.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import re
from pathlib import Path

import numpy as np


class BaseTokenizer:
    model_max_length: int = 77
    bos_token_id: int = 49406
    eos_token_id: int = 49407
    #: id used to fill past the EOS; CLIP's tokenizer pads with eos, SDXL's
    #: tokenizer_2 (OpenCLIP) pads with 0 — None means "pad with eos"
    pad_token_id: int | None = None

    def encode(self, text: str) -> list[int]:
        raise NotImplementedError

    def __call__(self, texts, padding: str = "max_length",
                 max_length: int | None = None, truncation: bool = True):
        """Returns dict(input_ids=np.int32 (B, L)) mirroring the reference's
        tokenizer call (``stable_diffusion_pipeline.py:291-298``)."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.model_max_length
        pad = self.eos_token_id if self.pad_token_id is None \
            else self.pad_token_id
        out = np.full((len(texts), L), pad, np.int32)
        n_trunc = 0
        for i, t in enumerate(texts):
            ids = [self.bos_token_id] + self.encode(t) + [self.eos_token_id]
            if len(ids) > L:
                ids = ids[:L - 1] + [self.eos_token_id]
                n_trunc += 1
            out[i, :len(ids)] = ids
        if n_trunc:
            import logging
            logging.getLogger(__name__).warning(
                "%d prompt(s) truncated to %d tokens", n_trunc, L)
        return {"input_ids": out}


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2/CLIP reversible byte->unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# CLIP's token split pattern; python `re` lacks \p{L}/\p{N}, so use unicode
# word characters — equivalent for the lowercased prompts SD sees in practice.
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|"""
    r"""\d|[^\s\w]+""", re.IGNORECASE | re.UNICODE)


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPBPETokenizer(BaseTokenizer):
    """Byte-level BPE with CLIP's end-of-word markers."""

    def __init__(self, vocab_path, merges_path, pad_token_id=None):
        self.vocab_path, self.merges_path = str(vocab_path), str(merges_path)
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        merges_path = Path(merges_path)
        if merges_path.suffix == ".gz":
            merges = gzip.open(merges_path, "rt", encoding="utf-8").read()
        else:
            merges = merges_path.read_text(encoding="utf-8")
        lines = merges.split("\n")
        if lines and lines[0].startswith("#"):
            lines = lines[1:]
        pairs = [tuple(l.split()) for l in lines if l.strip()]
        self.bpe_ranks = dict(zip(pairs, range(len(pairs))))
        self.byte_encoder = _bytes_to_unicode()
        self.cache: dict[str, str] = {}
        self.bos_token_id = self.encoder.get("<|startoftext|>", 49406)
        self.eos_token_id = self.encoder.get("<|endoftext|>", 49407)
        self.pad_token_id = pad_token_id

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: list[int] = []
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" ")
                       if t in self.encoder)
        return ids


class TextualInversionTokenizer(BaseTokenizer):
    """Wraps any tokenizer with trigger-word -> learned-token-id splicing.

    ``triggers`` maps a trigger string (e.g. ``"<concept>"``) to the list of
    consecutive vocabulary ids holding its learned vectors (multi-vector
    embeddings expand to several ids).  Matching is case-insensitive —
    CLIP's tokenizer lowercases prompts, so triggers must survive that."""

    def __init__(self, base: BaseTokenizer, triggers: dict[str, list[int]]):
        self.base = base
        self.triggers = {k.lower(): [int(i) for i in v]
                         for k, v in triggers.items()}
        self.model_max_length = base.model_max_length
        self.bos_token_id = base.bos_token_id
        self.eos_token_id = base.eos_token_id
        self.pad_token_id = base.pad_token_id
        self._pat = re.compile(
            "(" + "|".join(re.escape(t) for t in
                           sorted(self.triggers, key=len, reverse=True))
            + ")", re.IGNORECASE)

    def with_trigger(self, trigger: str,
                     ids: list[int]) -> "TextualInversionTokenizer":
        return TextualInversionTokenizer(
            self.base, {**self.triggers, trigger: ids})

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for part in self._pat.split(text):
            if not part:
                continue
            hit = self.triggers.get(part.lower())
            ids.extend(hit if hit is not None else self.base.encode(part))
        return ids


class HFTokenizerAdapter(BaseTokenizer):
    def __init__(self, hf_tokenizer):
        self.tok = hf_tokenizer
        self.model_max_length = hf_tokenizer.model_max_length
        self.bos_token_id = hf_tokenizer.bos_token_id
        self.eos_token_id = hf_tokenizer.eos_token_id

    def encode(self, text: str) -> list[int]:
        return self.tok.encode(text, add_special_tokens=False)


class HashTokenizer(BaseTokenizer):
    """Deterministic word-hash tokenizer for weightless tests — any prompt
    maps to a stable id sequence inside a small vocab."""

    def __init__(self, vocab_size: int = 1000, model_max_length: int = 77,
                 pad_token_id: int | None = None):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = pad_token_id

    def encode(self, text: str) -> list[int]:
        import hashlib
        ids = []
        for w in _whitespace_clean(text).lower().split(" "):
            if not w:
                continue
            h = int(hashlib.sha1(w.encode()).hexdigest(), 16)
            ids.append(h % (self.vocab_size - 2))
        return ids
