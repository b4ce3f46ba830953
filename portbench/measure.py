"""The yardstick's arithmetic: percentiles, unions of intervals, the card's
peaks, the weight and paged attention kernels' roofline bounds and the
FLOPs a window's work requires. Plain Python and numpy; nothing here
imports the program.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM data sheet (dense rates, 700 W): HBM3 bandwidth and the
# bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# INT4 weight-only storage: a 4-bit code and a bf16 scale per 64 rows of K
INT4_BYTES_PER_WEIGHT = 0.5 + 2 / 64


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """The p-th percentile of ``values`` by linear interpolation between
    closest ranks (numpy's default): rank p/100 * (n - 1) of the sorted
    values. None for an empty sample."""
    xs = sorted(values)
    if not xs:
        return None
    r = p / 100.0 * (len(xs) - 1)
    lo = int(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """Intervals cut to [lo, hi]; empty ones dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of ``intervals``."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def int4_bound_s(M: int, K: int, N: int) -> float:
    """Least time of one INT4 weight-only product x [M, K] @ w [K, N]: the
    weights at INT4_BYTES_PER_WEIGHT, x and y in bf16, each byte moved
    once at HBM_BYTES_PER_S, or 2*M*K*N operations at the bf16 rate,
    whichever is longer."""
    t_bytes = (K * N * INT4_BYTES_PER_WEIGHT + M * K * 2 + M * N * 2
               ) / HBM_BYTES_PER_S
    t_ops = 2.0 * M * K * N / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops)


def paged_attention_bound_s(layers: int, kv_bytes: int, q_bytes: int,
                            keys: int, rows: int) -> float:
    """Least time of one paged forward's attention over all its layers:
    each live K/V position read once (``kv_bytes`` a position and layer,
    K and V with their scales) and each live query row's q read and
    output written once (``q_bytes`` a row and layer), at HBM_BYTES_PER_S.
    The kernel's operations, a few per byte, never bound it."""
    return layers * (keys * kv_bytes + rows * q_bytes) / HBM_BYTES_PER_S


def causal_keys(first: int, last: int) -> int:
    """Keys scored in one layer by the tokens at positions first..last-1 of
    a sequence under causal attention: a token at position p scores p + 1."""
    if last <= first:
        return 0
    return (last * (last + 1) - first * (first + 1)) // 2


def window_keys(first: int, last: int, window: int) -> int:
    """``causal_keys`` in a layer whose tokens score the last ``window``
    positions at most: min(p + 1, window) at position p."""
    edge = min(max(window - 1, first), last)
    return causal_keys(first, edge) + max(0, last - edge) * window


def required_flops(family, model: dict, prompts: Sequence[int],
                   outputs: Sequence[Tuple[int, int, int]]) -> float:
    """FLOPs the window's work requires of the target alone.

    ``family`` gives the counts (``weights.family``): the layers' matrix
    weights one token multiplies (``weights_per_token``, 2 operations
    each) and the keys that tokens at given positions score, summed over
    the layers (``keys_scored``, 4 * Hq * Dh operations each: the score and
    the weighted value). ``prompts``: the unpadded length n of each prompt
    admitted in the window (all n positions processed, the last one's head
    giving the first output). ``outputs``: (n, k0, k1) for each request
    that committed its output tokens k0..k1-1 in the window; output k >= 1
    needs the token at position n + k - 1 processed, and every output
    needs one head. Drafter work, rejected drafts and padding are not
    counted."""
    per_token = 2.0 * family.weights_per_token(model)
    per_key = 4.0 * model["Hq"] * model["Dh"]
    head = 2.0 * model["D"] * model["V"]
    total = 0.0
    for n in prompts:
        total += per_token * n + per_key * family.keys_scored(model, 0, n)
    for n, k0, k1 in outputs:
        lo = max(k0, 1)
        if k1 > lo:
            total += per_token * (k1 - lo) + per_key * family.keys_scored(
                model, n + lo - 1, n + k1 - 1)
        total += head * max(0, k1 - k0)
    return total


# PyTorch's generic kernel templates: a label names the operation inside
_GENERIC = {"elementwise_kernel", "unrolled_elementwise_kernel",
            "vectorized_elementwise_kernel", "gpu_kernel_impl",
            "gpu_kernel_impl_nocast", "launch_legacy_kernel",
            "index_elementwise_kernel", "reduce_kernel", "ReduceOp",
            "func_wrapper_t", "AUnaryFunctor", "BUnaryFunctor",
            "BinaryFunctor"}


def kernel_label(name: str) -> str:
    """A device operation's name, shortened: the port's kernels by what
    they are (the attention kernel's instances by key layout and K/V
    type); PyTorch's generic templates by template and the first named
    operation inside (``elementwise_kernel/direct_copy_kernel_cuda``);
    others to their first 64 characters."""
    for k in ("int4_pair_matmul", "q4_halfplane_matmul", "int8_matmul"):
        if k in name:
            return k
    if "flash_decode_kernel" in name:
        layout = "paged" if "Paged" in name else "slotted"
        kv = "int8" if "signed char" in name else (
            "bf16" if name.count("bfloat16") > 1 else "f32")
        return f"flash_decode_kernel[{layout}, {kv} K/V]"
    words = re.findall(r"at::native::(?:\(anonymous namespace\)::)?(\w+)",
                       name)
    if words:
        inner = [w for w in words[1:] if w not in _GENERIC]
        return (words[0] + ("/" + inner[0] if inner else ""))[:64]
    return name[:64]
