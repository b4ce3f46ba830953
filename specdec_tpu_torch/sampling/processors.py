"""Logits processors (counterpart of ``specdec_tpu/sampling/processors.py``).

``__call__(logits) -> probs`` masks logits (top-k / nucleus) to
``_FILTER_VALUE`` and applies a temperature-scaled f32 softmax;
``sample(probs, generator) -> tokens`` draws over the last axis. The
speculative accept/reject test compares these processed distributions.

Draws use the Gumbel-max trick with ``torch.rand`` from an explicit
``torch.Generator``: the same distribution as ``jax.random.categorical``
over ``log(max(p, 1e-38))``, though not the same numbers, and no host read.
"""
from __future__ import annotations

from typing import Optional

import torch

_FILTER_VALUE = -1e20


def _gumbel_argmax(scores: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """argmax(scores + Gumbel noise) over the last axis: a categorical draw
    from softmax(scores)."""
    u = torch.rand(scores.shape, generator=generator, dtype=torch.float32,
                   device=scores.device)
    # torch.rand may return exactly 0, whose Gumbel value is -inf
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(scores + gumbel, dim=-1)


class LogitsProcessor:
    """probs = softmax(process(logits) / temperature)."""

    def __init__(self, temperature: float = 1.0):
        self.temperature = float(temperature)

    def _process(self, logits: torch.Tensor) -> torch.Tensor:
        return logits

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.softmax(
            self._process(logits.to(torch.float32)) / self.temperature, dim=-1)

    def sample(self, probs: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        raise NotImplementedError

    def sample_from_logits(self, logits: torch.Tensor,
                           generator: Optional[torch.Generator]
                           ) -> torch.Tensor:
        """Sample straight from logits (the AR loop's fast path)."""
        return self.sample(self(logits), generator)


class GreedyProcessor(LogitsProcessor):
    """Argmax; ties go to the first maximal index, as ``jnp.argmax``."""

    def sample(self, probs, generator=None):
        return torch.argmax(probs, dim=-1)

    def sample_from_logits(self, logits, generator=None):
        # argmax is invariant under softmax and temperature
        return torch.argmax(logits, dim=-1)


class MultinomialProcessor(LogitsProcessor):
    """Temperature-scaled multinomial sampling."""

    def sample(self, probs, generator):
        return _gumbel_argmax(torch.log(torch.clamp_min(probs, 1e-38)),
                              generator)

    def sample_from_logits(self, logits, generator):
        return _gumbel_argmax(logits.to(torch.float32) / self.temperature,
                              generator)


class TopKProcessor(MultinomialProcessor):
    """Keep the top-k logits, mask the rest."""

    def __init__(self, temperature: float = 1.0, top_k: int = 10):
        super().__init__(temperature)
        self.top_k = int(top_k)

    def _process(self, logits):
        kth = torch.topk(logits, self.top_k, dim=-1).values[..., -1:]
        return torch.where(logits < kth, _FILTER_VALUE, logits)

    sample_from_logits = LogitsProcessor.sample_from_logits  # filter first


class NucleusProcessor(MultinomialProcessor):
    """Top-p: mask the tail of the sorted cumulative distribution (cumsum of
    the UN-tempered sorted softmax > p, shifted right so the first token
    crossing the boundary is kept)."""

    def __init__(self, temperature: float = 1.0, top_p: float = 0.9):
        super().__init__(temperature)
        self.top_p = float(top_p)

    def _process(self, logits):
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove_sorted = cum > self.top_p
        remove_sorted = torch.cat(
            [torch.zeros_like(remove_sorted[..., :1]), remove_sorted[..., :-1]],
            dim=-1)
        kept = torch.where(remove_sorted, torch.inf, sorted_logits)
        threshold = torch.amin(kept, dim=-1, keepdim=True)
        return torch.where(logits < threshold, _FILTER_VALUE, logits)

    sample_from_logits = LogitsProcessor.sample_from_logits


class TopKNucleusProcessor(MultinomialProcessor):
    """Top-k filter, then the nucleus filter over the survivors."""

    def __init__(self, temperature: float = 1.0, top_k: int = 10,
                 top_p: float = 0.9):
        super().__init__(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)

    def _process(self, logits):
        kth = torch.topk(logits, self.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _FILTER_VALUE, logits)
        return NucleusProcessor(self.temperature, self.top_p)._process(logits)

    sample_from_logits = LogitsProcessor.sample_from_logits


_REGISTRY = {
    "greedy": lambda t, k, p: GreedyProcessor(t),
    "multinomial": lambda t, k, p: MultinomialProcessor(t),
    "topk": lambda t, k, p: TopKProcessor(t, k),
    "nucleus": lambda t, k, p: NucleusProcessor(t, p),
    "topknucleus": lambda t, k, p: TopKNucleusProcessor(t, k, p),
}


def build_processor(name: str, temperature: float = 1.0, top_k: int = 10,
                    top_p: float = 0.9) -> LogitsProcessor:
    """Name-based factory (greedy, multinomial, topk, nucleus,
    topknucleus; case, '-' and '_' ignored)."""
    key = name.lower().replace("_", "").replace("-", "")
    if key not in _REGISTRY:
        raise ValueError(f"unknown processor {name!r}; choose from "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](temperature, top_k, top_p)
