"""Gamma (draft length) selection from measured acceptance and cost ratio
(the port's copy of ``specdec_tpu/engine/gamma_tuner.py``, pure Python).

The reference leaves gamma to hand-tuning ("4-6 depending on acceptance rate",
ref: configs/performance_config.sh:28, docs/VLLM_GUIDE.md:110-111). The
expected-speedup model from the speculative-sampling paper makes this
computable: with per-draft acceptance probability ``a`` (i.i.d.
approximation), a window of gamma drafts commits on average

    E[tokens] = (1 - a^(gamma+1)) / (1 - a)

at cost ``gamma * c + 1`` target-forward-equivalents, where ``c`` is the
drafter/target cost ratio (both bandwidth-bound at bs=1, so approximately the
parameter-size ratio). ``best_gamma`` maximizes the expected tokens per unit
cost; ``expected_speedup`` reports the model's prediction for a given gamma.
"""
from __future__ import annotations

from typing import Tuple


def expected_tokens_per_window(acceptance: float, gamma: int) -> float:
    a = min(max(acceptance, 0.0), 0.9999)
    if a == 0.0:
        return 1.0
    return (1.0 - a ** (gamma + 1)) / (1.0 - a)


def expected_speedup(acceptance: float, gamma: int,
                     cost_ratio: float, window_overhead: float = 0.0) -> float:
    """Speedup over AR for one gamma-window: E[tokens] / (gamma*c + 1 + ovh)."""
    tokens = expected_tokens_per_window(acceptance, gamma)
    cost = gamma * cost_ratio + 1.0 + window_overhead
    return tokens / cost


def conditional_from_reference_rate(rate: float, gamma: int) -> float:
    """Invert the reference acceptance METRIC (accepted/speculated =
    E[n]/gamma, ref: sampling/speculative_decoding.py:189) to the per-draft
    conditional acceptance probability ``a`` the speedup model needs, using
    E[n] = (a - a^(gamma+1)) / (1 - a) and bisection. Feeding the reference
    metric directly into the model understates ``a`` badly at high gamma
    (measured: rate 0.81 at gamma 8 is a ~0.95 conditional), which made the
    round-1 advisory predict gamma 4 where the measured optimum was 10-12."""
    rate = min(max(rate, 0.0), 0.999)
    target = rate * gamma
    lo, hi = 0.0, 0.99999
    for _ in range(60):
        mid = (lo + hi) / 2
        e_n = (mid - mid ** (gamma + 1)) / (1.0 - mid)
        if e_n < target:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def best_gamma(acceptance: float, cost_ratio: float,
               window_overhead: float = 0.0,
               max_gamma: int = 16) -> Tuple[int, float]:
    """(gamma maximizing expected speedup, that speedup)."""
    best = (1, expected_speedup(acceptance, 1, cost_ratio, window_overhead))
    for g in range(2, max_gamma + 1):
        s = expected_speedup(acceptance, g, cost_ratio, window_overhead)
        if s > best[1]:
            best = (g, s)
    return best
