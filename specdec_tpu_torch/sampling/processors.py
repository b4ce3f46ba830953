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

    # --- batched entry points (serving). ``samp`` is an optional per-row
    # [B, 3] (temperature, top_k, top_p) tensor carried by BatchState; the
    # uniform processors ignore it, PerSlotProcessor consumes it. One
    # generator draws for every row.

    def batched(self, logits: torch.Tensor,
                samp: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self(logits)

    def sample_batched(self, probs: torch.Tensor,
                       generator: Optional[torch.Generator],
                       samp: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.sample(probs, generator)

    def sample_from_logits_batched(self, logits: torch.Tensor,
                                   generator: Optional[torch.Generator],
                                   samp: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
        return self.sample_from_logits(logits, generator)


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


class PerSlotProcessor(LogitsProcessor):
    """Per-request sampling params for batched serving (vLLM SamplingParams
    semantics). Each batch row carries its own (temperature, top_k, top_p)
    in a [B, 3] float32 tensor (``BatchState.samp``).

    Per row: top-k filter (``top_k <= 0`` disables), then the nucleus
    filter over the survivors with the untempered-cumsum boundary of
    ``NucleusProcessor`` (``top_p >= 1`` disables), then the temperature
    softmax. ``temperature <= 1e-5`` means greedy: the tempered softmax
    underflows to the one-hot argmax distribution, so speculative
    accept/reject stays exact for greedy rows, and the draw is the argmax.
    """

    _GREEDY_EPS = 1e-5

    def batched(self, logits, samp):
        f = logits.to(torch.float32)
        V = f.shape[-1]
        lead = (f.shape[0],) + (1,) * (f.dim() - 1)  # row scalar -> [B,1,..]
        temp = samp[:, 0].reshape(lead)
        top_k = samp[:, 1].to(torch.int64).reshape(lead)
        top_p = samp[:, 2].reshape(lead)

        # top-k: threshold at each row's k-th largest logit
        use_k = (top_k > 0) & (top_k < V)
        k = torch.clamp(top_k, 1, V)
        sorted_desc = torch.sort(f, dim=-1, descending=True).values
        kth = torch.gather(sorted_desc, -1,
                           (k - 1).expand(f.shape[:-1] + (1,)))
        f = torch.where(use_k & (f < kth), _FILTER_VALUE, f)

        # nucleus over the k-survivors (TopKNucleusProcessor's order)
        use_p = top_p < 1.0
        sorted2 = torch.sort(f, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted2, dim=-1), dim=-1)
        remove_sorted = cum > top_p
        remove_sorted = torch.cat(
            [torch.zeros_like(remove_sorted[..., :1]), remove_sorted[..., :-1]],
            dim=-1)
        kept = torch.where(remove_sorted, torch.inf, sorted2)
        threshold = torch.amin(kept, dim=-1, keepdim=True)
        f = torch.where(use_p & (f < threshold), _FILTER_VALUE, f)

        return torch.softmax(f / torch.clamp_min(temp, self._GREEDY_EPS),
                             dim=-1)

    def sample_batched(self, probs, generator, samp):
        mult = _gumbel_argmax(torch.log(torch.clamp_min(probs, 1e-38)),
                              generator)
        greedy = torch.argmax(probs, dim=-1)
        is_greedy = (samp[:, 0] <= self._GREEDY_EPS).reshape(
            (probs.shape[0],) + (1,) * (mult.dim() - 1))
        return torch.where(is_greedy, greedy, mult)

    def sample_from_logits_batched(self, logits, generator, samp):
        return self.sample_batched(self.batched(logits, samp), generator,
                                   samp)

    def __call__(self, logits):
        raise TypeError("PerSlotProcessor needs per-row params; use "
                        "batched(logits, samp) (serving path only)")

    @staticmethod
    def row(temperature: float = 1.0, top_k: int = 0,
            top_p: float = 1.0) -> torch.Tensor:
        """One request's [3] param row (CPU); temperature <= 1e-5 is
        greedy."""
        return torch.tensor([float(temperature), float(top_k), float(top_p)],
                            dtype=torch.float32)


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
