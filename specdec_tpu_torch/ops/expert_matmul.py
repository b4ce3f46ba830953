"""Grouped INT4 expert matmul: the CUDA kernel's wrapper and its plain
PyTorch version (``csrc/int4_expert_matmul.cu``, the expert layers of
``core/moe.py``).

``int4_expert_matmul(x, w, offsets, rows)`` multiplies each assignment of
an expert-sorted list by its expert's matrix: assignment j in
[offsets[e], offsets[e + 1]) takes row ``rows[j]`` of x (row j where
``rows`` is None, an input already in that order) through expert e of the
stacked ``Int4Weight`` w ([E, K/8, N] words, [E, K/64, N] absmax, each
expert quantized alone, K1's pair4 layout). The kernel takes any
K % 64 == 0, with the absmax block-major or, where K/64 is no multiple
of 4 (the experts' down projection, K = 1408), in natural order.

On a CPU tensor the wrapper computes the plain version, each expert's rows
through ``int4_matmul_reference`` (K1's plain version); on a CUDA tensor it
launches the kernel or raises. The kernel forms the same bf16 weights and
sums each 16-k piece of a 64-k block in f32 before scaling it, as K1 does:
it differs from the plain version in the order of the f32 sums only. The
host never reads the routing: the tiles of each expert are counted and
found on the device. Launches are counted in
``int4_expert_matmul.launches``; while the tracer is on, each call records
(rows, K, N, then on the device the experts given at least one row) under
``int4_expert_matmul``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from specdec_tpu_torch.ops.quant_matmul import int4_matmul_reference
from specdec_tpu_torch.quant.core import NF4_BLOCK, Int4Weight
from specdec_tpu_torch.utils.profiling import TRACER


def per_expert(x: torch.Tensor, offsets: torch.Tensor,
               rows: Optional[torch.Tensor], N: int, dtype: torch.dtype,
               mm: Callable[[torch.Tensor, int], torch.Tensor]
               ) -> torch.Tensor:
    """The plain grouped product: [n, N] of ``dtype``, assignment j in
    [offsets[e], offsets[e + 1]) taking row ``rows[j]`` of x (row j where
    ``rows`` is None) through ``mm(rows of expert e, e)``, expert by
    expert (those with no rows skipped). Reads the offsets back."""
    n = int(offsets[-1]) if rows is None else rows.shape[0]
    out = torch.empty((n, N), dtype=dtype, device=x.device)
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        a, b = bounds[e], bounds[e + 1]
        if b > a:
            out[a:b] = mm(x[a:b] if rows is None else x[rows[a:b].long()], e)
    return out


def int4_expert_matmul_reference(x: torch.Tensor, w: Int4Weight,
                                 offsets: torch.Tensor,
                                 rows: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain version: [n, N] bf16, each expert's rows through K1's plain
    version on its own matrix (``per_expert``)."""
    return per_expert(x, offsets, rows, w.packed.shape[-1], torch.bfloat16,
                      lambda xe, e: int4_matmul_reference(xe, w.packed[e],
                                                          w.absmax[e]))


def row_tiles(n: int, experts: int) -> int:
    """Row tiles of 8 a block of the kernel (1, 2, 4 or 8), from the mean
    rows an expert gets, known from the shapes alone."""
    mean = n / experts
    return 1 if mean <= 8 else 2 if mean <= 16 else 4 if mean <= 48 else 8


def _check(x, w: Int4Weight, offsets, rows):
    name = "int4_expert_matmul"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device}, not CUDA")
    K = x.shape[1]
    p, a = w.packed, w.absmax
    if K % NF4_BLOCK or p.dim() != 3 or p.shape[1] * 8 != K \
            or a.shape[1] * NF4_BLOCK != K:
        raise ValueError(f"{name}: x has K={K}, words {tuple(p.shape)}, "
                         f"absmax {tuple(a.shape)} (K % 64 == 0, stacked "
                         "[E, K/8, N])")
    if p.dtype != torch.int32 or a.dtype != torch.bfloat16:
        raise ValueError(f"{name}: words {p.dtype} and absmax {a.dtype}")
    if offsets.dtype != torch.int32 or offsets.shape != (p.shape[0] + 1,):
        raise ValueError(f"{name}: offsets {offsets.dtype} "
                         f"{tuple(offsets.shape)} for {p.shape[0]} experts")
    if rows is not None and rows.dtype != torch.int32:
        raise ValueError(f"{name}: rows {rows.dtype}, expected int32")
    for t in (p, a, offsets) + ((rows,) if rows is not None else ()):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: every array contiguous on "
                             f"{x.device}")


def _launch(x, w: Int4Weight, offsets, rows, n: int):
    from specdec_tpu_torch.ops._build import load

    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # the kernel stages x with 16-byte copies
        xb = xb.clone()
    K, N, E = xb.shape[1], w.packed.shape[-1], w.packed.shape[0]
    nt = row_tiles(n, E)
    counts = offsets[1:] - offsets[:-1]
    tile_end = torch.cumsum((counts + 8 * nt - 1) // (8 * nt), 0,
                            dtype=torch.int32)
    y = torch.empty((n, N), dtype=torch.bfloat16, device=xb.device)
    err = load("int4_expert_matmul").int4_expert_matmul(
        xb.data_ptr(), rows.data_ptr() if rows is not None else None,
        offsets.data_ptr(), tile_end.data_ptr(), w.packed.data_ptr(),
        w.absmax.data_ptr(), y.data_ptr(), n, K, N, E,
        w.packed.stride(0), w.absmax.stride(0), nt,
        torch.cuda.current_stream(xb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4_expert_matmul launch failed: CUDA error "
                           f"{err}")
    return y


def int4_expert_matmul(x: torch.Tensor, w: Int4Weight,
                       offsets: torch.Tensor,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [R, K] (any float dtype); w a stacked [E, ...] ``Int4Weight``;
    offsets int32 [E + 1] on x's device; rows int32 [n] or None (then
    n = R). Returns [n, N] in x's dtype, in the assignments' order."""
    n = x.shape[0] if rows is None else rows.shape[0]
    K, N = x.shape[1], w.packed.shape[-1]
    if TRACER.on:
        TRACER.record("int4_expert_matmul", n, K, N,
                      (offsets[1:] > offsets[:-1]).sum())
    if x.device.type == "cpu":
        out = int4_expert_matmul_reference(x, w, offsets, rows)
    else:
        _check(x, w, offsets, rows)
        if n:
            out = _launch(x, w, offsets, rows, n)
            int4_expert_matmul.launches += 1
        else:
            out = x.new_empty((0, N))
    return out.to(x.dtype)


int4_expert_matmul.launches = 0
