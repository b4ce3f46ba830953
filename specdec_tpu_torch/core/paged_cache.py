"""Paged KV cache: a fixed page pool plus per-sequence page tables
(counterpart of ``specdec_tpu/core/paged_cache.py``).

K/V live in a global pool of fixed-size pages; each sequence owns an ordered
page list, and growing a sequence allocates pages from a host-side free list
(``PageAllocator``). The device only ever sees the int32 page tables.
Rollback is length arithmetic: pages are never freed mid-request.

The pools keep the JAX package's head-major layout ``[L, NP, Hk, page, Dh]``,
so pools bridge between the packages bit for bit. ``QuantPagedKVCache``
(``cfg.kv_quant = "int8"``) holds int8 pools and their f32 per-(position,
head) scales ``[L, NP, Hk, page]`` in the same pages, so one page table
addresses both and the allocator and prefix cache stay format-blind.
Unlike the JAX version, which returns new arrays, the writes here
(``write_block_paged*``, which take an int8 pool's scales as an optional
argument where JAX has ``*_quant`` functions, and
``install_sequence_pages``) scatter IN PLACE into the pools, and a
``paged_view`` shares the pools' storage, so JAX's ``merge_view_storage``
has nothing to merge and is not ported.

Page 0 is the scheduler's garbage page: finished and inactive slots' table
rows point at it, so their masked writes never touch a live page. A
position whose logical page lies past the table's width is also sent to
page 0 (the JAX scatter drops such writes; an out-of-range index would be a
device fault here).
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import quantize_kv_block, storage_fields


@dataclasses.dataclass
class PagedKVCache:
    """k/v pools: [L, num_pages, Hk, page_size, Dh];
    page_table: int32 [B, max_pages] (pool page of each logical page;
    unused entries point at page 0, masked by length);
    length: int32 [B] valid tokens per sequence."""

    k: torch.Tensor
    v: torch.Tensor
    page_table: torch.Tensor
    length: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]

    def with_length(self, length: torch.Tensor) -> "PagedKVCache":
        return dataclasses.replace(self, length=length)

    def rolled_back(self, n) -> "PagedKVCache":
        return self.with_length(torch.clamp_min(self.length - n, 0))


@dataclasses.dataclass
class QuantPagedKVCache:
    """INT8 pools: k/v int8 [L, num_pages, Hk, page_size, Dh]; k_scale/
    v_scale f32 [L, num_pages, Hk, page_size] in the same pages as their
    values (dequantized value = q * scale); page_table and length as in
    PagedKVCache."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    page_table: torch.Tensor
    length: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]

    def with_length(self, length: torch.Tensor) -> "QuantPagedKVCache":
        return dataclasses.replace(self, length=length)

    def rolled_back(self, n) -> "QuantPagedKVCache":
        return self.with_length(torch.clamp_min(self.length - n, 0))


def paged_view(cache, row: torch.Tensor, length):
    """Batch-of-one view over the shared pools (and scales, for an int8
    pool): the same storage, a single-row page table and length (scheduler
    admission uses this)."""
    length = torch.as_tensor(length, dtype=torch.int32,
                             device=cache.length.device).reshape(1)
    return dataclasses.replace(cache, page_table=row[None, :], length=length)


class PageAllocator:
    """Host-side free list over the pool. The device never sees it, only the
    int32 tables it produces."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self.owned: dict = {}

    def alloc(self, owner, n: int) -> List[int]:
        if n > len(self.free):
            raise MemoryError(
                f"page pool exhausted: need {n}, free {len(self.free)}")
        pages = [self.free.pop() for _ in range(n)]
        self.owned.setdefault(owner, []).extend(pages)
        return pages

    def free_owner(self, owner):
        for p in self.owned.pop(owner, []):
            self.free.append(p)

    def disown(self, owner, page: int):
        """Transfer one page out of ``owner``'s list without freeing it (a
        prompt block's page handed to the prefix cache, which then owns its
        lifetime)."""
        self.owned[owner].remove(page)


def init_paged_cache(cfg, batch_size: int, num_pages: int, page_size: int,
                     max_pages_per_seq: int, dtype=None, device=None):
    """Zeroed pools and an all-garbage (page 0) table on ``device``
    (``None``: the card), in the format ``cfg.kv_quant`` selects."""
    device = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size,
             cfg.head_dim)
    table = torch.zeros((batch_size, max_pages_per_seq), dtype=torch.int32,
                        device=device)
    length = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    if cfg.kv_quant == "int8":
        return QuantPagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            page_table=table, length=length)
    dtype = dtype or cfg.dtype
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        page_table=table, length=length)


def _page_slot(page_table: torch.Tensor, pos: torch.Tensor, page_size: int):
    """(pool page, slot in page) of each position in ``pos`` [B, T] through
    ``page_table`` [B, MP]; positions outside the table (past its width, or
    negative, as a finished slot's drafter offset can be) go to page 0."""
    logical = torch.div(pos, page_size, rounding_mode="floor").to(torch.int64)
    MP = page_table.shape[1]
    page = torch.gather(page_table, 1, torch.clamp(logical, 0, MP - 1))
    page = torch.where((logical >= 0) & (logical < MP), page,
                       0).to(torch.int64)
    return page, (pos % page_size).to(torch.int64)


def write_block_paged(layer_k: torch.Tensor, layer_v: torch.Tensor,
                      new_k: torch.Tensor, new_v: torch.Tensor,
                      page_table: torch.Tensor, offsets: torch.Tensor,
                      page_size: int, scales=()):
    """Scatter a [B, T, Hk, Dh] block into one layer's [NP, Hk, page, Dh]
    pool at per-sequence offsets, in place, as ONE ``index_put_`` per array.
    The separated advanced indices (page, :, slot), both [B, T], put the
    batch dims first, so the target slice [B, T, Hk, Dh] is new_k.

    ``scales``, the layer's (k_scale, v_scale) [NP, Hk, page] of an int8
    pool, makes this the JAX ``write_block_paged_quant``: the blocks are
    quantized per (position, head) with the slotted cache's
    ``quantize_kv_block`` (bit-identical stored values across layouts) and
    the scales scattered beside the values.

    Live slots' (page, slot) pairs are distinct: pages are disjoint across
    sequences and positions distinct within one. Duplicates come only from
    finished slots, whose rows alias garbage page 0; which of them wins
    there is undefined and irrelevant (page 0 is never attended)."""
    if not scales:
        pools, blocks = (layer_k, layer_v), (new_k, new_v)
    else:
        kq, ks = quantize_kv_block(new_k)
        vq, vs = quantize_kv_block(new_v)
        pools, blocks = (layer_k, layer_v) + tuple(scales), (kq, vq, ks, vs)
    T = new_k.shape[1]
    pos = offsets[:, None] + torch.arange(T, dtype=torch.int32,
                                          device=offsets.device)[None, :]
    page, slot = _page_slot(page_table, pos, page_size)
    for pool, blk in zip(pools, blocks):
        pool[page, :, slot] = blk.to(pool.dtype)


def write_block_paged_stacked(stack_k: torch.Tensor, stack_v: torch.Tensor,
                              layer: int, new_k: torch.Tensor,
                              new_v: torch.Tensor, page_table: torch.Tensor,
                              offsets: torch.Tensor, page_size: int,
                              scales=()):
    """``write_block_paged`` into layer ``layer`` of the full
    [L, NP, Hk, page, Dh] stacks, in place (the layer is a view); with
    ``scales``, the (k_scale, v_scale) [L, NP, Hk, page] stacks of an int8
    pool, it is the JAX ``write_block_paged_quant_stacked``."""
    write_block_paged(stack_k[layer], stack_v[layer], new_k, new_v,
                      page_table, offsets, page_size,
                      tuple(s[layer] for s in scales))


def install_sequence_pages(cache, row: torch.Tensor, scratch):
    """Scatter a batch-of-one SLOTTED scratch cache's K/V (and scales, for
    an int8 pool) into the pool pages named by ``row``, in place: the
    dense-prefill admission's install step, one ``index_put_`` per array
    over every layer at once.

    Position p of the scratch lands at (row[p // page], p % page); positions
    past the allocated pages alias garbage page 0, as in
    ``write_block_paged``. The pool's format must match the scratch's (both
    follow ``cfg.kv_quant``)."""
    S = scratch.k.shape[2]
    pos = torch.arange(S, dtype=torch.int32, device=row.device)[None, :]
    page, slot = _page_slot(row[None, :], pos, cache.page_size)
    page, slot = page[0], slot[0]
    for name in storage_fields(cache):
        pool = getattr(cache, name)
        # the separated advanced indices (page at axis 1, slot at axis 3)
        # put the broadcast dim first: the target is [S, L, Hk(, Dh)]
        pool[:, page, :, slot] = getattr(scratch, name)[:, 0].transpose(
            0, 1).to(pool.dtype)
    return cache


def gather_pages(layer_kv: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
    """[num_pages, Hk, page, Dh] + [B, max_pages] -> contiguous
    [B, max_pages * page, Hk, Dh] (the plain attention path)."""
    B, MP = page_table.shape
    NP, Hk, ps, Dh = layer_kv.shape
    gathered = layer_kv[page_table.to(torch.int64)]   # [B, MP, Hk, page, Dh]
    return gathered.permute(0, 1, 3, 2, 4).reshape(B, MP * ps, Hk, Dh)


def gather_page_scales(layer_s: torch.Tensor,
                       page_table: torch.Tensor) -> torch.Tensor:
    """[num_pages, Hk, page] scales + [B, max_pages] -> [B, max_pages * page,
    Hk], the layout ``masked_attention`` takes its scales in."""
    B, MP = page_table.shape
    NP, Hk, ps = layer_s.shape
    gathered = layer_s[page_table.to(torch.int64)]   # [B, MP, Hk, page]
    return gathered.permute(0, 1, 3, 2).reshape(B, MP * ps, Hk)


def required_pages(length: int, page_size: int) -> int:
    return (length + page_size - 1) // page_size
