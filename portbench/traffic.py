"""The one traffic generator.  A mix is a JSON file of parameters
(``portbench/traffic/<name>.json``); everything drawn from it comes from
the run's ``--seed``, so a seed gives the same traffic every time.

* prompts: ``prompt_words`` [lo, hi] words drawn from the mix's ``words``
  (every prompt is padded to 77 tokens, so their length sets no work);
* seeds: distinct noise seeds below 2**31;
* walks (``entry`` "walk"): walk ``i`` has ``prompts_per_walk`` prompts and
  seeds, the same for a (seed, i) pair whatever came before;
* arrivals (``entry`` "serve"): an open loop at ``rate_per_s`` over the
  window.  Every seed gets the same set of gaps, the quantiles of the
  exponential distribution at that rate, in an order drawn from the seed,
  so seeds differ in order and never in the amount of work.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), *map(int, tags)]))


def prompt(mix: dict, r: np.random.Generator) -> str:
    lo, hi = mix["prompt_words"]
    words = mix["words"]
    return " ".join(words[i] for i in r.integers(0, len(words),
                                                 int(r.integers(lo, hi + 1))))


def seeds(r: np.random.Generator, n: int) -> list:
    return [int(s) for s in r.choice(2 ** 31, size=n, replace=False)]


def walk(mix: dict, seed: int, index: int) -> dict:
    """Walk ``index`` of a run: prompts and noise seeds."""
    r = rng(seed, 1, index)
    n = mix["prompts_per_walk"]
    return {"prompts": [prompt(mix, r) for _ in range(n)],
            "seeds": seeds(r, n)}


def arrivals(mix: dict, seed: int, seconds: float, tag: int = 2) -> list:
    """[(due seconds from the window's start, prompt, seed)] of the open
    loop: ``round(rate · seconds)`` requests whose gaps are the
    exponential quantiles at ``rate_per_s``, shuffled by the seed, scaled
    so that they span the window exactly (the same for every seed)."""
    rate = float(mix["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    r = rng(seed, tag)
    gaps = gaps[r.permutation(n)]
    # the next arrival after the last would fall at the window's end
    due = (np.cumsum(gaps) - gaps) * (seconds / gaps.sum())
    noise = seeds(r, n)
    return [(float(t), prompt(mix, r), s) for t, s in zip(due, noise)]
