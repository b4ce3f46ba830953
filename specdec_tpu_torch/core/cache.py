"""Slotted KV cache with per-sequence length counters
(counterpart of ``specdec_tpu/core/cache.py``).

The cache is a fixed ``[L, B, S, Hk, Dh]`` buffer; "pruning n tokens" is
``length -= n``. Stale entries are masked out of attention
(``key_pos <= q_pos``) and later overwritten, so speculative rollback moves
no data.

Unlike the JAX version, which returns new arrays, ``write_block`` writes the
new block IN PLACE. ``with_length`` and ``rolled_back`` return a new
``KVCache`` that shares the ``k``/``v`` storage with the old one: after a
forward, the old cache object sees the new entries too, and only its
``length`` differs. ``install_slot`` and ``zero_slot`` likewise edit the
storage in place and return a cache with a new length tensor.
"""
from __future__ import annotations

import dataclasses

import torch

from specdec_tpu_torch import resolve_device


@dataclasses.dataclass
class KVCache:
    """k/v: [num_layers, batch, max_seq, num_kv_heads, head_dim];
    length: int32 [batch] on the cache's device."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    def with_length(self, length: torch.Tensor) -> "KVCache":
        return dataclasses.replace(self, length=length)

    def rolled_back(self, n) -> "KVCache":
        """Drop the last ``n`` (per-seq) tokens: arithmetic only."""
        return self.with_length(torch.clamp_min(self.length - n, 0))


def init_cache(cfg, batch_size: int, max_seq_len: int, dtype=None,
               device=None) -> KVCache:
    """A zeroed cache on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch_size, max_seq_len, cfg.num_kv_heads,
             cfg.head_dim)
    dtype = dtype or cfg.dtype
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch_size,), dtype=torch.int32, device=device),
    )


def write_block(layer_k: torch.Tensor, layer_v: torch.Tensor,
                new_k: torch.Tensor, new_v: torch.Tensor,
                offsets: torch.Tensor):
    """Write a [B, T, Hk, Dh] block into one layer's [B, S, Hk, Dh] cache at
    per-sequence ``offsets``, in place. As ``lax.dynamic_update_slice``
    does, an offset is clamped to ``S - T`` so the block always fits. The
    offsets stay on the device: no host read."""
    B, T = new_k.shape[:2]
    S = layer_k.shape[1]
    start = torch.clamp(offsets.to(torch.int64), 0, S - T)
    rows = torch.arange(B, device=new_k.device)[:, None].expand(B, T)
    cols = start[:, None] + torch.arange(T, device=new_k.device)[None, :]
    layer_k.index_put_((rows, cols), new_k.to(layer_k.dtype))
    layer_v.index_put_((rows, cols), new_v.to(layer_v.dtype))
    return layer_k, layer_v


def with_row_length(cache, slot: int, new_len):
    """``cache`` (slotted or paged) with row ``slot`` of its length set. The
    length tensor is copied, not edited: other caches may share it."""
    length = cache.length.clone()
    length[slot] = new_len
    return cache.with_length(length)


def install_slot(dst: KVCache, src: KVCache, slot: int, new_len) -> KVCache:
    """Copy the batch-of-one cache ``src`` into ``dst``'s batch row ``slot``
    (the scheduler's admission primitive) and set that row's length. The
    rows are copied IN PLACE into ``dst``'s storage, so ``dst`` never aliases
    ``src``; returns ``dst`` with the new length."""
    dst.k[:, slot].copy_(src.k[:, 0])
    dst.v[:, slot].copy_(src.v[:, 0])
    return with_row_length(dst, slot, new_len)


def zero_slot(cache: KVCache, slot: int, new_len) -> KVCache:
    """Zero batch row ``slot`` in place and set its length (slot-recycling
    hygiene for caches whose stale rows would otherwise be attended)."""
    cache.k[:, slot].zero_()
    cache.v[:, slot].zero_()
    return with_row_length(cache, slot, new_len)
