"""The grouped INT4 expert kernel's least time (``int4_expert_matmul``, the
expert layers of mixture-of-experts configurations): plain arithmetic on
the card's peaks in ``measure.py``, importing nothing of the program."""
from __future__ import annotations

from portbench.measure import (
    BF16_FLOPS_PER_S, HBM_BYTES_PER_S, INT4_BYTES_PER_WEIGHT,
)


def expert_bound_s(rows: int, K: int, N: int, touched: int) -> float:
    """Least time of one launch over ``rows`` expert-sorted rows of K
    inputs and N outputs: the ``touched`` experts' INT4 weights (K x N
    each, with their scales) read once, x and y in bf16, at
    HBM_BYTES_PER_S, or 2*rows*K*N operations at the bf16 rate, whichever
    is longer."""
    t_bytes = (touched * K * N * INT4_BYTES_PER_WEIGHT + rows * K * 2
               + rows * N * 2) / HBM_BYTES_PER_S
    return max(t_bytes, 2.0 * rows * K * N / BF16_FLOPS_PER_S)
