"""Weight-only dequant-matmul: the CUDA kernels' wrappers and their plain
PyTorch versions (counterpart of ``specdec_tpu/ops/quant_matmul.py``).

``quant_matmul(x, w)`` (a 2D weight, the ``lm_head``) and
``quant_matmul_stacked(x, w, idx)`` (layer ``idx`` of an [L, ...] stack,
every layer projection) dispatch on the container type to one kernel
wrapper each:

- ``Int4Weight``: ``int4_matmul`` / ``int4_matmul_stacked``, CUDA kernel
  ``csrc/int4_pair_matmul.cu`` (TPU ``_pair_kernel`` and
  ``_pair_kernel_stacked``, K1);
- ``NF4Weight``, ``FP4Weight``: ``q4_halfplane_matmul`` /
  ``q4_halfplane_matmul_stacked``, ``csrc/q4_halfplane_matmul.cu`` (TPU
  ``_halfplane_kernel`` and ``_halfplane_kernel_stacked``, K6);
- ``Int8Weight``: ``int8_matmul`` / ``int8_matmul_stacked``,
  ``csrc/int8_matmul.cu`` (TPU ``_int8_kernel``, K7).

A stacked wrapper hands the kernel the whole stack and the layer index;
the kernel reads the layer in place. On a CPU tensor a wrapper computes
its plain version; on a CUDA tensor it launches the kernel or raises. The
plain versions compute the TPU kernels' arithmetic (x cast to bf16, f32
sums, a bf16 result cast to ``x.dtype``):

- INT4: each 64-row block's f32 sum times the block's bf16 scale;
- NF4/FP4: each weight decoded (bf16-rounded codebook, or the e2m1 bits),
  times its block's bf16 scale and rounded to bf16, then one f32 sum;
- INT8: the f32 sum times the channel's f32 scale.

The kernels form the same bf16 weights and differ from their plain versions
only in the order of the f32 sums (K1 also scales each 64-row block's sum
in four pieces of 16 rows, one per K-split warp, and adds them).

Each kernel wrapper counts its launches in a plain integer attribute
(``int4_matmul.launches`` and so on), so a run can show which kernels its
path went through.

The TPU tile policy (VMEM budget, tile fitting, row chunking) is not ported:
it models v5e VMEM.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from specdec_tpu_torch.quant.core import (
    NF4_BLOCK, FP4Weight, Int4Weight, Int8Weight, NF4Weight, _am_unpack,
    _fp4_decode_bits, _int4_decode, _nf4_decode_bits, _unpack_nibbles,
)

# 4-bit codec of the half-plane kernel: the plain version's decode and the
# kernel's template switch
_CODECS = {NF4Weight: ("nf4", 0), FP4Weight: ("fp4", 1)}
_DECODERS = {"nf4": _nf4_decode_bits, "fp4": _fp4_decode_bits}


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                          absmax: torch.Tensor) -> torch.Tensor:
    """Plain version of K1. x: [M, K]; packed: [K/8, N] int32; absmax:
    [K/64, N] bf16 in stored order. Returns bf16 [M, N]. Handles every
    K % 64 == 0, including natural-order absmax (G % 4 != 0)."""
    M, K = x.shape
    G = K // NF4_BLOCK
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(M, G, NF4_BLOCK)
    w = _int4_decode(_unpack_nibbles(packed)).reshape(G, NF4_BLOCK, -1)
    partial = torch.einsum("mgk,gkn->gmn", xb, w)           # [G, M, N] f32
    am = _am_unpack(absmax).to(torch.float32)                # [G, N]
    return (partial * am[:, None, :]).sum(dim=0).to(torch.bfloat16)


def q4_halfplane_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                                  absmax: torch.Tensor,
                                  codec: str) -> torch.Tensor:
    """Plain version of K6. x: [M, K]; packed: [K/8, N] int32; absmax:
    [K/64, N] bf16 in stored order; codec "nf4" or "fp4". Each weight is
    bf16(decode(code) * scale) — the product of a bf16 code value and a
    bf16 scale is exact in f32, so the kernel sees the same weights — and
    the products with bf16 x are summed in f32. Returns bf16 [M, N]."""
    vals = _DECODERS[codec](_unpack_nibbles(packed))          # [K, N] f32
    scale = _am_unpack(absmax).to(torch.float32).repeat_interleave(
        NF4_BLOCK, dim=0)
    w = (vals * scale).to(torch.bfloat16).to(torch.float32)
    return (x.to(torch.bfloat16).to(torch.float32) @ w).to(torch.bfloat16)


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K7. x: [M, K]; q: [K, N] int8; scale: [1, N] f32.
    bf16 x times the int8 values (exact in bf16) summed in f32, then the
    channel scale once; returns bf16 [M, N]."""
    acc = x.to(torch.bfloat16).to(torch.float32) @ q.to(torch.float32)
    return (acc * scale).to(torch.bfloat16)


def _fields(w: Any):
    """A container's two tensors: (q, scale) or (packed, absmax)."""
    return (w.q, w.scale) if isinstance(w, Int8Weight) else (w.packed,
                                                             w.absmax)


def _plain(w: Any, x2: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    if isinstance(w, Int8Weight):
        return int8_matmul_reference(x2, a, b)
    if isinstance(w, Int4Weight):
        return int4_matmul_reference(x2, a, b)
    return q4_halfplane_matmul_reference(x2, a, b, _CODECS[type(w)][0])


def _check_kernel_args(w: Any, x2: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, stacked: bool) -> None:
    """Raise on what the kernel does not take: a CUDA x, weights on its
    device with the stored types, contiguous layers, the K the layout needs
    (4-bit: K % 256 == 0, so the absmax is block-major) and, for INT8, N %
    4 == 0 with 4-byte aligned rows (a thread loads 4 columns at once)."""
    what = f"{type(w).__name__} kernel"
    if x2.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {x2.device}, not CUDA")
    M, K = x2.shape
    if a.dim() != (3 if stacked else 2):
        raise ValueError(f"{what}: a {a.dim()}-D weight, expected "
                         f"{3 if stacked else 2}-D")
    if isinstance(w, Int8Weight):
        N = a.shape[-1]
        if a.shape[-2] != K or tuple(b.shape[-2:]) != (1, N):
            raise ValueError(f"{what}: x has K={K}, q is "
                             f"{tuple(a.shape)}, scale {tuple(b.shape)}")
        if a.dtype != torch.int8 or b.dtype != torch.float32:
            raise ValueError(f"{what}: q {a.dtype} and scale {b.dtype}; "
                             "expected int8 and float32")
        if N % 4 or a.data_ptr() % 4 or (stacked and a.stride(0) % 4):
            raise ValueError(f"{what}: N={N} is not a multiple of 4, or q "
                             "is not 4-byte aligned")
    else:
        if K % 256 != 0:
            raise ValueError(f"{what}: K={K} is not a multiple of 256 (the "
                             "block-major absmax layout needs K/64 % 4 == 0)")
        if a.shape[-2] * 8 != K or b.shape[-2] * NF4_BLOCK != K:
            raise ValueError(f"{what}: x has K={K}, weight has "
                             f"{a.shape[-2] * 8} rows")
        if a.dtype != torch.int32 or b.dtype != torch.bfloat16:
            raise ValueError(f"{what}: words {a.dtype} and absmax "
                             f"{b.dtype}; expected int32 and bfloat16")
    for t in (a, b):
        if t.device != x2.device:
            raise ValueError(f"{what}: x on {x2.device}, weight on "
                             f"{t.device}")
        if not t[(0,) * (t.dim() - 2)].is_contiguous():
            raise ValueError(f"{what}: a weight layer is not contiguous")


def _launch(w: Any, x2: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            layer: int) -> torch.Tensor:
    """Launch the container's kernel on layer ``layer`` of a/b (leading
    layer axis, or none for a 2D weight) on the current stream."""
    from specdec_tpu_torch.ops._build import load

    xb = x2.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # the kernels stage x with 16-byte copies
        xb = xb.clone()
    M, K = xb.shape
    N = a.shape[-1]
    y = torch.empty((M, N), dtype=torch.bfloat16, device=xb.device)
    strides = [t.stride(0) if t.dim() == 3 else 0 for t in (a, b)]
    if isinstance(w, Int8Weight):
        name, extra = "int8_matmul", []
    elif isinstance(w, Int4Weight):
        name, extra = "int4_pair_matmul", []
    else:
        name, extra = "q4_halfplane_matmul", [_CODECS[type(w)][1]]
    err = getattr(load(name), name)(
        xb.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), M, K, N,
        layer, *strides, *extra,
        torch.cuda.current_stream(xb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return y


def _matmul(wrapper, kinds, x: torch.Tensor, w: Any,
            idx: Optional[int]) -> torch.Tensor:
    """The body of every kernel wrapper: x [..., K] any float dtype, the
    output's dtype follows x. ``idx`` None: a 2D weight; else layer ``idx``
    of a stacked one."""
    if not isinstance(w, kinds):
        raise TypeError(f"{wrapper.__name__}: {type(w).__name__} weight")
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    a, b = _fields(w)
    if idx is not None:
        idx = int(idx)
        if not 0 <= idx < a.shape[0]:
            raise IndexError(f"layer {idx} of a {a.shape[0]}-layer stack")
    if x2.device.type == "cpu":
        out = _plain(w, x2, *((a, b) if idx is None else (a[idx], b[idx])))
    else:
        _check_kernel_args(w, x2, a, b, stacked=idx is not None)
        out = _launch(w, x2, a, b, idx or 0)
        wrapper.launches += 1
    return out.to(x.dtype).reshape(*lead, out.shape[-1])


def int4_matmul(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """x @ w for a 2D INT4 weight (K1a)."""
    return _matmul(int4_matmul, Int4Weight, x, w, None)


def int4_matmul_stacked(x: torch.Tensor, w: Int4Weight,
                        idx: int) -> torch.Tensor:
    """x @ w[idx] for a stacked INT4 container (K1b)."""
    return _matmul(int4_matmul_stacked, Int4Weight, x, w, idx)


def q4_halfplane_matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a 2D NF4 or FP4 weight (K6a)."""
    return _matmul(q4_halfplane_matmul, (NF4Weight, FP4Weight), x, w, None)


def q4_halfplane_matmul_stacked(x: torch.Tensor, w: Any,
                                idx: int) -> torch.Tensor:
    """x @ w[idx] for a stacked NF4 or FP4 container (K6b)."""
    return _matmul(q4_halfplane_matmul_stacked, (NF4Weight, FP4Weight), x,
                   w, idx)


def int8_matmul(x: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """x @ w for a 2D INT8 weight (K7)."""
    return _matmul(int8_matmul, Int8Weight, x, w, None)


def int8_matmul_stacked(x: torch.Tensor, w: Int8Weight,
                        idx: int) -> torch.Tensor:
    """x @ w[idx] for a stacked INT8 container (K7 with a layer stride)."""
    return _matmul(int8_matmul_stacked, Int8Weight, x, w, idx)


# container type -> (2D wrapper, stacked wrapper)
_WRAPPERS = {Int4Weight: (int4_matmul, int4_matmul_stacked),
             NF4Weight: (q4_halfplane_matmul, q4_halfplane_matmul_stacked),
             FP4Weight: (q4_halfplane_matmul, q4_halfplane_matmul_stacked),
             Int8Weight: (int8_matmul, int8_matmul_stacked)}


def _wrappers(w: Any):
    try:
        return _WRAPPERS[type(w)]
    except KeyError:
        raise TypeError(f"no quantized kernel for a {type(w).__name__} "
                        "weight") from None


def quant_matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a 2D quantized weight; x: [..., K] any float dtype; the
    output dtype follows x."""
    return _wrappers(w)[0](x, w)


def quant_matmul_stacked(x: torch.Tensor, w: Any, idx: int) -> torch.Tensor:
    """x @ w[idx] for a STACKED quantized container ([L, ...] leaves). The
    kernel reads the layer in place; nothing is copied."""
    return _wrappers(w)[1](x, w, idx)


int4_matmul.launches = 0
int4_matmul_stacked.launches = 0
q4_halfplane_matmul.launches = 0
q4_halfplane_matmul_stacked.launches = 0
int8_matmul.launches = 0
int8_matmul_stacked.launches = 0
