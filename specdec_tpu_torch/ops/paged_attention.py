"""Paged decode attention: the CUDA kernel's wrappers and its plain PyTorch
version (counterpart of ``specdec_tpu/ops/paged_attention.py``).

``paged_decode_attention`` (a 4D pool [NP, Hk, page, Dh]) and
``paged_decode_attention_stacked`` (layer ``layer`` of [L, NP, Hk, page, Dh]
stacks, the serving path's call) replace the TPU kernels ``_kernel`` and
``_kernel_stacked``. One CUDA kernel, ``csrc/paged_attention.cu``, serves
both: the layer is a base-pointer offset.

Both compute flash-decode over K/V reached through the page table: query
position ``offsets[b] + t`` attends every key position ``<=`` it, scores in
f32 scaled by the f32 number 1/sqrt(Dh), grouped-query heads folded as T*G
rows per KV head. On a CPU tensor a wrapper computes the plain version,
``paged_attention_reference`` (``gather_pages`` and the dense masked
attention of ``core/model.py``); on a CUDA tensor it launches the kernel or
raises.

Each wrapper counts its kernel launches in a plain integer attribute,
``paged_decode_attention.launches`` and
``paged_decode_attention_stacked.launches``.
"""
from __future__ import annotations

import numpy as np
import torch

from specdec_tpu_torch.core.model import masked_attention
from specdec_tpu_torch.core.paged_cache import gather_pages

# what the kernel takes (the wrapper raises on anything else)
MAX_HEAD_DIM = 128
MAX_SHARED_BYTES = 232448   # an H100 block's dynamic shared memory
_ROWS = 16                  # query rows per block (csrc/paged_attention.cu)
_WARPS = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              offsets: torch.Tensor) -> torch.Tensor:
    """Plain version. q: [B, T, Hq, Dh]; pools: [NP, Hk, page, Dh];
    page_table: [B, MP]; offsets: [B]. Returns [B, T, Hq, Dh] in v's
    dtype."""
    B, T, Hq, Dh = q.shape
    q_pos = offsets.to(torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32, device=q.device)[None, :]
    out = masked_attention(q, gather_pages(k_pool, page_table),
                           gather_pages(v_pool, page_table), q_pos,
                           k_pool.shape[1])
    return out.reshape(B, T, Hq, Dh)


def shared_bytes(page: int, head_dim: int) -> int:
    """Dynamic shared memory of one block: the query tile, K (rows padded by
    one float against bank conflicts), V and each warp's probabilities, all
    f32."""
    return 4 * (_ROWS * head_dim + page * (head_dim + 1) + page * head_dim
                + _WARPS * page)


def _check_kernel_args(q, k_pool, v_pool, page_table, offsets):
    if q.device.type != "cuda":
        raise ValueError(f"paged attention kernel: q on {q.device}, not CUDA")
    for name, t in (("k", k_pool), ("v", v_pool), ("page_table", page_table),
                    ("offsets", offsets)):
        if t.device != q.device:
            raise ValueError(f"paged attention kernel: q on {q.device}, "
                             f"{name} on {t.device}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype or (
            v_pool.dtype != q.dtype):
        raise ValueError(f"paged attention kernel: q {q.dtype}, pools "
                         f"{k_pool.dtype}/{v_pool.dtype}; expected one of "
                         f"{sorted(map(str, _DTYPE_CODE))} for all three")
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"paged attention kernel: k pool {tuple(k_pool.shape)}"
                         f" != v pool {tuple(v_pool.shape)}")
    B, T, Hq, Dh = q.shape
    Hk, page, pool_dh = k_pool.shape[-3:]
    if pool_dh != Dh or Hq % Hk != 0:
        raise ValueError(f"paged attention kernel: q heads {Hq} x {Dh}, pool "
                         f"heads {Hk} x {pool_dh}")
    if Dh > MAX_HEAD_DIM or Dh % 8 != 0:
        raise ValueError(f"paged attention kernel: head_dim {Dh} (takes "
                         f"multiples of 8 up to {MAX_HEAD_DIM})")
    if shared_bytes(page, Dh) > MAX_SHARED_BYTES:
        raise ValueError(f"paged attention kernel: page {page} x head_dim "
                         f"{Dh} needs {shared_bytes(page, Dh)} bytes of "
                         f"shared memory (at most {MAX_SHARED_BYTES})")
    if page_table.dim() != 2 or page_table.shape[0] != B or (
            offsets.shape != (B,)):
        raise ValueError(f"paged attention kernel: table "
                         f"{tuple(page_table.shape)}, offsets "
                         f"{tuple(offsets.shape)} for batch {B}")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous()):
        raise ValueError("paged attention kernel: q and the pools must be "
                         "contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged attention kernel: the pools must be 16-byte "
                         "aligned (the kernel stages pages with 16-byte "
                         "loads)")


def _launch(q, k_pool, v_pool, page_table, offsets, layer: int):
    """Launch the kernel on layer ``layer`` of the pools (leading layer
    axis, or none for a 4D pool) on the current stream."""
    from specdec_tpu_torch.ops._build import load

    B, T, Hq, Dh = q.shape
    Hk, page = k_pool.shape[-3], k_pool.shape[-2]
    table = page_table.to(torch.int32).contiguous()
    off = offsets.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    stride = k_pool.stride(0) if k_pool.dim() == 5 else 0
    scale = float(np.float32(1.0) / np.sqrt(np.float32(Dh)))
    fn = load("paged_attention").paged_attention
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             table.data_ptr(), off.data_ptr(), out.data_ptr(),
             _DTYPE_CODE[q.dtype], B, T, Hq, Hk, Dh, page, table.shape[1],
             layer, stride, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """q: [B, T, Hq, Dh]; pools: [NP, Hk, page, Dh] (head-major);
    page_table: [B, MP] int32; offsets: [B]. Returns [B, T, Hq, Dh]."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         offsets).to(q.dtype)
    _check_kernel_args(q, k_pool, v_pool, page_table, offsets)
    out = _launch(q, k_pool, v_pool, page_table, offsets, 0)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_stacked(q: torch.Tensor, k_stack: torch.Tensor,
                                   v_stack: torch.Tensor, layer: int,
                                   page_table: torch.Tensor,
                                   offsets: torch.Tensor) -> torch.Tensor:
    """``paged_decode_attention`` reading layer ``layer`` of stacked
    [L, NP, Hk, page, Dh] pools in place; nothing is copied."""
    layer = int(layer)
    if not 0 <= layer < k_stack.shape[0]:
        raise IndexError(f"layer {layer} of a {k_stack.shape[0]}-layer stack")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_stack[layer], v_stack[layer],
                                         page_table, offsets).to(q.dtype)
    _check_kernel_args(q, k_stack, v_stack, page_table, offsets)
    out = _launch(q, k_stack, v_stack, page_table, offsets, layer)
    paged_decode_attention_stacked.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention_stacked.launches = 0
