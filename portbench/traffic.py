"""The one traffic generator: reads a mix file (``traffic/<name>.json``)
and draws the requests of a run from its seed.

Every seed gets the same sizes and the same arrivals, the sizes in another
order. Lengths and inter-arrival gaps come in blocks of ``block``
requests: each block holds the distribution's quantiles at
(j + 0.5) / block, j = 0..block-1. The lengths of a block are in an order
drawn from the seed; the gaps in an order drawn once for the mix, so
every seed sees the same arrival times. Every stretch of the schedule
thus carries the same mix of work whatever the seed. Prompt tokens are
uniform ids in [1, vocab), drawn per request from (seed, request).

A mix file holds:

- ``arrivals``: ``{"kind": "poisson", "rate_per_s": R, "preroll_s": P}``
  (an open loop; the window starts P seconds into the schedule) or
  ``{"kind": "backlog", "requests": N}`` (N requests due at once, the
  window starting when every slot is live);
- ``prompt_len``, ``output_len``: ``{"dist": "lognormal", "median": m,
  "sigma": s, "min": a, "max": b}`` or ``{"dist": "uniform", "min": a,
  "max": b}`` (clipped and rounded to whole tokens);
- ``block``: requests a block;
- ``engine``: the batcher settings the mix needs (slots, gamma, windows
  per sync, the largest prompt and output).
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List

import numpy as np

# margin of an open loop's schedule past the window's nominal end: a step
# that starts before the end may run past it
TAIL_S = 30.0
# the order of every mix's inter-arrival gaps, the same for every seed
ARRIVALS_SEED = 20260101


def quantiles(spec: dict, block: int) -> np.ndarray:
    """The block's lengths: the distribution's quantiles at
    (j + 0.5) / block, rounded and clipped to [min, max]."""
    u = (np.arange(block) + 0.5) / block
    if spec["dist"] == "uniform":
        x = spec["min"] + u * (spec["max"] + 1 - spec["min"]) - 0.5
    elif spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(v) for v in u])
        x = spec["median"] * np.exp(spec["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def exponential_gaps(rate: float, block: int) -> np.ndarray:
    """A block of inter-arrival gaps: the exponential's quantiles at
    (j + 0.5) / block, scaled so the block's mean gap is 1 / rate."""
    u = (np.arange(block) + 0.5) / block
    g = -np.log1p(-u)
    return g / g.mean() / rate


class Traffic:
    """The requests of one run: ``due`` (seconds from the schedule's start),
    ``prompt_len``, ``output_len`` and ``prompt(i)``."""

    def __init__(self, mix: dict, seed: int, vocab_size: int,
                 seconds: float):
        self.mix = mix
        self.seed = seed % 2 ** 64
        self.vocab_size = vocab_size
        arr = mix["arrivals"]
        block = int(mix["block"])
        if arr["kind"] == "poisson":
            span = arr["preroll_s"] + seconds + TAIL_S
            n = math.ceil(arr["rate_per_s"] * span)
        elif arr["kind"] == "backlog":
            n = int(arr["requests"])
        else:
            raise ValueError(f"unknown arrivals {arr['kind']!r}")
        nb = math.ceil(n / block)

        def blocks(values: np.ndarray, rng) -> np.ndarray:
            return np.concatenate([rng.permutation(values)
                                   for _ in range(nb)])[:n]

        rng = np.random.default_rng([self.seed, 0])
        self.prompt_len = blocks(quantiles(mix["prompt_len"], block), rng)
        self.output_len = blocks(quantiles(mix["output_len"], block), rng)
        if arr["kind"] == "poisson":
            gaps = blocks(exponential_gaps(arr["rate_per_s"], block),
                          np.random.default_rng(ARRIVALS_SEED))
            self.due = np.cumsum(gaps) - gaps[0]
        else:
            self.due = np.zeros(n)
        self.n = n

    def prompt(self, i: int) -> List[int]:
        """Request ``i``'s prompt token ids."""
        rng = np.random.default_rng([self.seed, 1, i])
        return rng.integers(1, self.vocab_size,
                            size=int(self.prompt_len[i])).tolist()
