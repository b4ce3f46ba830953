"""Flash-decode attention over the slotted KV cache: the CUDA kernel's
wrappers and its plain PyTorch version (counterpart of
``specdec_tpu/ops/decode_attention.py``).

- ``flash_decode_attention`` replaces the TPU kernel ``_kernel`` (K3): K/V
  [B, S, Hk, Dh] of q's type (float32 or bf16).
- ``flash_decode_attention_quant`` replaces ``_kernel_quant`` (K4): int8 K/V
  with f32 scales [B, S, Hk]; the k-scale multiplies the score after the
  dot, the v-scale the probability before P.V.

One CUDA kernel, ``csrc/decode_attention.cu`` on ``csrc/flash_decode.cuh``,
serves both. It reads one layer of the slotted cache in place (the model
passes ``cache.k[i]``), streams only the live 64-key tiles and folds
grouped-query heads as T*G rows per KV head, 16 rows per block. Each
sequence's tiles are split into spans over the blocks of a thread-block
cluster (chosen from S alone, so a row's result does not depend on T, B or
its neighbours), whose partial softmax states are merged through
distributed shared memory; bf16 q runs on the tensor cores. Unlike the TPU
wrapper there is no transpose, no padding and no copy, and no limit on T:
the JAX dispatch sends T*G > 1024 to the XLA path only because of the TPU's
VMEM, so the dense admission prefills (T = 64 or 256) attend through this
kernel too.

A wrapper refuses inputs that want a gradient (the kernel has no
backward; ``attention_args.refuse_grad``). On a CPU tensor it computes the
plain version,
``decode_attention_reference`` (the dense ``masked_attention`` of
``core/model.py``, the JAX package's XLA path); on a CUDA tensor it
launches the kernel or raises. Each wrapper counts its kernel launches in a
plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from specdec_tpu_torch.core.model import masked_attention
from specdec_tpu_torch.ops.attention_args import (
    DTYPE_CODE, check_kv_args, refuse_grad, shared_bytes,
)


def decode_attention_reference(q: torch.Tensor, k_all: torch.Tensor,
                               v_all: torch.Tensor, offsets: torch.Tensor,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None,
                               ) -> torch.Tensor:
    """Plain version. q: [B, T, Hq, Dh]; k_all/v_all: [B, S, Hk, Dh] (int8
    with scales [B, S, Hk], or neither); offsets: [B]; ``scale`` the
    scores' factor (1/sqrt(Dh) where None). Returns [B, T, Hq, Dh] in v's
    dtype (q's for int8 K/V)."""
    B, T, Hq, Dh = q.shape
    q_pos = offsets.to(torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32, device=q.device)[None, :]
    out = masked_attention(q, k_all, v_all, q_pos, k_all.shape[2],
                           k_scale=k_scale, v_scale=v_scale, scale=scale)
    return out.reshape(B, T, Hq, Dh)


def _check_args(name, q, k_all, v_all, k_scale, v_scale, offsets):
    check_kv_args(name, q, k_all, v_all, k_scale, v_scale,
                  shared_bytes(q.shape[-1], q.dtype, k_scale is not None))
    if offsets.device != q.device:
        raise ValueError(f"{name}: q on {q.device}, offsets on "
                         f"{offsets.device}")
    B, T, Hq, Dh = q.shape
    if k_all.dim() != 4 or k_all.shape[0] != B or offsets.shape != (B,):
        raise ValueError(f"{name}: K/V {tuple(k_all.shape)}, offsets "
                         f"{tuple(offsets.shape)} for q {tuple(q.shape)}")
    Hk = k_all.shape[2]
    if Hq % Hk != 0:
        raise ValueError(f"{name}: {Hq} query heads over {Hk} KV heads")


def _launch(q, k_all, v_all, k_scale, v_scale, offsets, scale=None):
    """Launch the kernel on the current stream."""
    from specdec_tpu_torch.ops._build import load

    B, T, Hq, Dh = q.shape
    S, Hk = k_all.shape[1], k_all.shape[2]
    off = offsets.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if scale is None:
        scale = float(np.float32(1.0) / np.sqrt(np.float32(Dh)))
    quant = k_scale is not None
    fn = load("decode_attention").decode_attention
    err = fn(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             off.data_ptr(), out.data_ptr(), DTYPE_CODE[q.dtype],
             int(quant), B, T, Hq, Hk, Dh, S, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    return out


def flash_decode_attention(q: torch.Tensor, k_all: torch.Tensor,
                           v_all: torch.Tensor, offsets: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, T, Hq, Dh]; k_all/v_all: [B, S, Hk, Dh] of q's dtype (one
    layer of the slotted cache); offsets: [B] (query t of sequence b sits
    at position offsets[b] + t); ``scale``: the scores' factor, 1/sqrt(Dh)
    where None (latent attention gives its own). Returns [B, T, Hq, Dh] in
    q's dtype."""
    refuse_grad("flash-decode kernel", q, k_all, v_all)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_all, v_all, offsets,
                                          scale=scale).to(q.dtype)
    _check_args("flash-decode kernel", q, k_all, v_all, None, None, offsets)
    out = _launch(q, k_all, v_all, None, None, offsets, scale)
    flash_decode_attention.launches += 1
    return out


def flash_decode_attention_quant(q: torch.Tensor, k_all: torch.Tensor,
                                 k_scale: torch.Tensor, v_all: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 offsets: torch.Tensor) -> torch.Tensor:
    """``flash_decode_attention`` over int8 K/V [B, S, Hk, Dh] with f32
    scales [B, S, Hk] (one layer of a ``QuantKVCache``); q float32 or
    bf16. Returns [B, T, Hq, Dh] in q's dtype."""
    refuse_grad("int8 flash-decode kernel", q, k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_all, v_all, offsets, k_scale,
                                          v_scale).to(q.dtype)
    _check_args("int8 flash-decode kernel", q, k_all, v_all, k_scale,
                v_scale, offsets)
    out = _launch(q, k_all, v_all, k_scale, v_scale, offsets)
    flash_decode_attention_quant.launches += 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention_quant.launches = 0
