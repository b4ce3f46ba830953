"""INT4 pair4 dequant-matmul: the CUDA kernel's wrappers and its plain
PyTorch version (counterpart of ``specdec_tpu/ops/quant_matmul.py``).

``quant_matmul`` (2D weight, the ``lm_head``) and ``quant_matmul_stacked``
(layer ``idx`` of an [L, ...] stack, every layer projection) replace the TPU
kernels ``_pair_kernel`` and ``_pair_kernel_stacked``. One CUDA kernel,
``csrc/int4_pair_matmul.cu``, serves both.

On a CPU tensor a wrapper computes the plain version,
``int4_matmul_reference``; on a CUDA tensor it launches the kernel or raises.
Both compute the TPU kernel's arithmetic: x cast to bf16, products summed in
f32 per 64-row block, the block's bf16 scale applied to the partial sum, a
bf16 result cast to ``x.dtype``.

Each wrapper counts its kernel launches in a plain integer attribute,
``quant_matmul.launches`` and ``quant_matmul_stacked.launches``, so a run
can show that its path went through the kernel.

The TPU tile policy (VMEM budget, tile fitting, row chunking) is not ported:
it models v5e VMEM.
"""
from __future__ import annotations

import torch

from specdec_tpu_torch.quant.core import (
    NF4_BLOCK, Int4Weight, _am_unpack, _int4_decode, _unpack_nibbles,
)


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                          absmax: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel. x: [M, K]; packed: [K/8, N] int32;
    absmax: [K/64, N] bf16 in stored order. Returns bf16 [M, N]. Handles
    every K % 64 == 0, including natural-order absmax (G % 4 != 0)."""
    M, K = x.shape
    G = K // NF4_BLOCK
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(M, G, NF4_BLOCK)
    w = _int4_decode(_unpack_nibbles(packed)).reshape(G, NF4_BLOCK, -1)
    partial = torch.einsum("mgk,gkn->gmn", xb, w)           # [G, M, N] f32
    am = _am_unpack(absmax).to(torch.float32)                # [G, N]
    return (partial * am[:, None, :]).sum(dim=0).to(torch.bfloat16)


def _check_kernel_args(x2: torch.Tensor, packed: torch.Tensor,
                       absmax: torch.Tensor) -> None:
    if x2.device.type != "cuda":
        raise ValueError(f"int4 kernel: tensors on {x2.device}, not CUDA")
    M, K = x2.shape
    if K % 256 != 0:
        raise ValueError(f"int4 kernel: K={K} is not a multiple of 256 (the "
                         "block-major absmax layout needs K/64 % 4 == 0)")
    if packed.shape[-2] * 8 != K or absmax.shape[-2] * NF4_BLOCK != K:
        raise ValueError(f"int4 kernel: x has K={K}, weight has "
                         f"{packed.shape[-2] * 8} rows")
    if packed.dtype != torch.int32 or absmax.dtype != torch.bfloat16:
        raise ValueError(f"int4 kernel: words {packed.dtype} and absmax "
                         f"{absmax.dtype}; expected int32 and bfloat16")
    for t in (packed, absmax):
        if t.device != x2.device:
            raise ValueError(f"int4 kernel: x on {x2.device}, weight on "
                             f"{t.device}")
        if not t[(0,) * (t.dim() - 2)].is_contiguous():
            raise ValueError("int4 kernel: a weight layer is not contiguous")


def _launch(x2: torch.Tensor, packed: torch.Tensor, absmax: torch.Tensor,
            layer: int) -> torch.Tensor:
    """Launch the kernel on layer ``layer`` of packed/absmax (leading layer
    axis, or none for a 2D weight) on the current stream."""
    from specdec_tpu_torch.ops._build import load

    xb = x2.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 4:  # the kernel reads x as bf16 pairs
        xb = xb.clone()
    M, K = xb.shape
    N = packed.shape[-1]
    y = torch.empty((M, N), dtype=torch.bfloat16, device=xb.device)
    w_stride = packed.stride(0) if packed.dim() == 3 else 0
    a_stride = absmax.stride(0) if absmax.dim() == 3 else 0
    fn = load("int4_pair_matmul").int4_pair_matmul
    err = fn(xb.data_ptr(), packed.data_ptr(), absmax.data_ptr(),
             y.data_ptr(), M, K, N, layer, w_stride, a_stride,
             torch.cuda.current_stream(xb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4_pair_matmul launch failed: CUDA error {err}")
    return y


def quant_matmul(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """x @ w for a 2D INT4 weight; x: [..., K] any float dtype; the output
    dtype follows x."""
    if not isinstance(w, Int4Weight):
        raise NotImplementedError(f"quant_matmul: {type(w).__name__} is not "
                                  "ported (only Int4Weight)")
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.device.type == "cpu":
        out = int4_matmul_reference(x2, w.packed, w.absmax)
    else:
        _check_kernel_args(x2, w.packed, w.absmax)
        out = _launch(x2, w.packed, w.absmax, 0)
        quant_matmul.launches += 1
    return out.to(x.dtype).reshape(*lead, out.shape[-1])


def quant_matmul_stacked(x: torch.Tensor, w: Int4Weight,
                         idx: int) -> torch.Tensor:
    """x @ w[idx] for a STACKED INT4 container ([L, K/8, N] words, [L, K/64,
    N] absmax). The kernel reads the layer in place; nothing is copied."""
    if not isinstance(w, Int4Weight):
        raise NotImplementedError(f"quant_matmul_stacked: {type(w).__name__} "
                                  "is not ported (only Int4Weight)")
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    idx = int(idx)
    if not 0 <= idx < w.packed.shape[0]:
        raise IndexError(f"layer {idx} of a {w.packed.shape[0]}-layer stack")
    if x2.device.type == "cpu":
        out = int4_matmul_reference(x2, w.packed[idx], w.absmax[idx])
    else:
        _check_kernel_args(x2, w.packed, w.absmax)
        out = _launch(x2, w.packed, w.absmax, idx)
        quant_matmul_stacked.launches += 1
    return out.to(x.dtype).reshape(*lead, out.shape[-1])


quant_matmul.launches = 0
quant_matmul_stacked.launches = 0
