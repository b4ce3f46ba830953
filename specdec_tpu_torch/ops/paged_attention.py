"""Paged decode attention: the CUDA kernel's wrappers and its plain PyTorch
version (counterpart of ``specdec_tpu/ops/paged_attention.py``).

Four wrappers replace the four TPU kernels of that module:

- ``paged_decode_attention`` (K2, ``_kernel``): a 4D pool [NP, Hk, page, Dh];
- ``paged_decode_attention_stacked`` (K8a, ``_kernel_stacked``): layer
  ``layer`` of [L, NP, Hk, page, Dh] stacks, the serving path's call;
- ``paged_decode_attention_quant`` (K5, ``_kernel_quant``): int8 pools with
  f32 scales [NP, Hk, page];
- ``paged_decode_attention_quant_stacked`` (K8b, ``_kernel_quant_stacked``):
  layer ``layer`` of the int8 stacks and [L, NP, Hk, page] scales, the
  serving path's call under ``kv_quant="int8"``.

One CUDA kernel, ``csrc/paged_attention.cu``, serves all four: the
flash-decode body of ``csrc/flash_decode.cuh`` (``ops/decode_attention.py``)
with key position s read at slot s % page of pool page
``page_table[b, s // page]``. The layer is a base-pointer offset (stride 0
for a 4D pool), and int8 pools are its int8 instantiation. The capacity is
the table's width, MP * page: it fixes the spans of 64-key tiles, so a row's
result depends on the table's width only, not on T, the batch or its
neighbours, and over the same keys in pages of 64 it is the slotted
kernel's bit for bit. A block reads the table entries of its rows' live
positions only; entries past a sequence's last live page may hold
anything.

All compute flash-decode over K/V reached through the page table: query
position ``offsets[b] + t`` attends every key position ``<=`` it, scores in
f32 scaled by the f32 number 1/sqrt(Dh), grouped-query heads folded as T*G
rows per KV head; for int8 pools the k-scale multiplies the score after the
dot and the v-scale the probability before P.V. A wrapper refuses inputs
that want a gradient (the kernel has no backward;
``attention_args.refuse_grad``). On a CPU tensor it computes the plain
version, ``paged_attention_reference`` (``gather_pages``,
``gather_page_scales`` and the dense ``masked_attention`` of
``core/model.py``); on a CUDA tensor it launches the kernel or raises.

Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from specdec_tpu_torch.core.model import masked_attention
from specdec_tpu_torch.core.paged_cache import gather_page_scales, gather_pages
from specdec_tpu_torch.ops.attention_args import (
    DTYPE_CODE, check_kv_args, refuse_grad, shared_bytes,
)


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              offsets: torch.Tensor,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              ) -> torch.Tensor:
    """Plain version. q: [B, T, Hq, Dh]; pools: [NP, Hk, page, Dh] (int8
    with scales [NP, Hk, page], or neither); page_table: [B, MP]; offsets:
    [B]. Returns [B, T, Hq, Dh] in v's dtype (q's for int8 pools)."""
    B, T, Hq, Dh = q.shape
    q_pos = offsets.to(torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32, device=q.device)[None, :]
    scales = {}
    if k_scale is not None:
        scales = dict(k_scale=gather_page_scales(k_scale, page_table),
                      v_scale=gather_page_scales(v_scale, page_table))
    out = masked_attention(q, gather_pages(k_pool, page_table),
                           gather_pages(v_pool, page_table), q_pos,
                           k_pool.shape[1], **scales)
    return out.reshape(B, T, Hq, Dh)


def _check_paged_args(name, q, k_pool, v_pool, k_scale, v_scale, page_table,
                      offsets):
    check_kv_args(name, q, k_pool, v_pool, k_scale, v_scale,
                  shared_bytes(q.shape[-1], q.dtype, k_scale is not None))
    for label, a in (("page_table", page_table), ("offsets", offsets)):
        if a.device != q.device:
            raise ValueError(f"{name}: q on {q.device}, {label} on "
                             f"{a.device}")
    B, T, Hq, Dh = q.shape
    Hk = k_pool.shape[-3]
    if Hq % Hk != 0:
        raise ValueError(f"{name}: {Hq} query heads over {Hk} KV heads")
    if page_table.dim() != 2 or page_table.shape[0] != B or (
            offsets.shape != (B,)):
        raise ValueError(f"{name}: table {tuple(page_table.shape)}, offsets "
                         f"{tuple(offsets.shape)} for batch {B}")


def _launch(q, k_pool, v_pool, k_scale, v_scale, page_table, offsets,
            layer: int):
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
    quant = k_scale is not None
    fn = load("paged_attention").paged_attention
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             table.data_ptr(), off.data_ptr(), out.data_ptr(),
             DTYPE_CODE[q.dtype], int(quant), B, T, Hq, Hk, Dh, page,
             table.shape[1], layer, stride, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out


def _layer_index(layer, stack: torch.Tensor) -> int:
    layer = int(layer)
    if not 0 <= layer < stack.shape[0]:
        raise IndexError(f"layer {layer} of a {stack.shape[0]}-layer stack")
    return layer


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """q: [B, T, Hq, Dh]; pools: [NP, Hk, page, Dh] (head-major);
    page_table: [B, MP] int32; offsets: [B]. Returns [B, T, Hq, Dh]."""
    refuse_grad("paged attention kernel", q, k_pool, v_pool)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         offsets).to(q.dtype)
    _check_paged_args("paged attention kernel", q, k_pool, v_pool, None,
                      None, page_table, offsets)
    out = _launch(q, k_pool, v_pool, None, None, page_table, offsets, 0)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_stacked(q: torch.Tensor, k_stack: torch.Tensor,
                                   v_stack: torch.Tensor, layer: int,
                                   page_table: torch.Tensor,
                                   offsets: torch.Tensor) -> torch.Tensor:
    """``paged_decode_attention`` reading layer ``layer`` of stacked
    [L, NP, Hk, page, Dh] pools in place; nothing is copied."""
    refuse_grad("paged attention kernel", q, k_stack, v_stack)
    layer = _layer_index(layer, k_stack)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_stack[layer], v_stack[layer],
                                         page_table, offsets).to(q.dtype)
    _check_paged_args("paged attention kernel", q, k_stack, v_stack, None,
                      None, page_table, offsets)
    out = _launch(q, k_stack, v_stack, None, None, page_table, offsets,
                  layer)
    paged_decode_attention_stacked.launches += 1
    return out


def paged_decode_attention_quant(q: torch.Tensor, k_pool: torch.Tensor,
                                 k_scale: torch.Tensor, v_pool: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 page_table: torch.Tensor,
                                 offsets: torch.Tensor) -> torch.Tensor:
    """``paged_decode_attention`` over int8 pools [NP, Hk, page, Dh] with
    f32 scales [NP, Hk, page]; q float32 or bf16. Returns [B, T, Hq, Dh] in
    q's dtype."""
    refuse_grad("int8 paged attention kernel", q, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         offsets, k_scale, v_scale
                                         ).to(q.dtype)
    _check_paged_args("int8 paged attention kernel", q, k_pool, v_pool,
                      k_scale, v_scale, page_table, offsets)
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, page_table, offsets,
                  0)
    paged_decode_attention_quant.launches += 1
    return out


def paged_decode_attention_quant_stacked(
        q: torch.Tensor, k_stack: torch.Tensor, k_scale: torch.Tensor,
        v_stack: torch.Tensor, v_scale: torch.Tensor, layer: int,
        page_table: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``paged_decode_attention_quant`` reading layer ``layer`` of int8
    stacks [L, NP, Hk, page, Dh] and their scales [L, NP, Hk, page] in
    place; nothing is copied."""
    refuse_grad("int8 paged attention kernel", q, k_scale, v_scale)
    layer = _layer_index(layer, k_stack)
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_stack[layer], v_stack[layer], page_table, offsets,
            k_scale[layer], v_scale[layer]).to(q.dtype)
    _check_paged_args("int8 paged attention kernel", q, k_stack, v_stack,
                      k_scale, v_scale, page_table, offsets)
    out = _launch(q, k_stack, v_stack, k_scale, v_scale, page_table, offsets,
                  layer)
    paged_decode_attention_quant_stacked.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention_stacked.launches = 0
paged_decode_attention_quant.launches = 0
paged_decode_attention_quant_stacked.launches = 0
