"""Slotted KV cache with per-sequence length counters
(counterpart of ``specdec_tpu/core/cache.py``).

The cache is a fixed ``[L, B, S, Hk, Dh]`` buffer; "pruning n tokens" is
``length -= n``. Stale entries are masked out of attention
(``key_pos <= q_pos``) and later overwritten, so speculative rollback moves
no data.

Two storage formats share one interface (length arithmetic, slot install
and zeroing): ``KVCache`` at cfg.dtype, and ``QuantKVCache`` holding int8
K/V with a per-(position, head) f32 absmax scale (``cfg.kv_quant =
"int8"``). Attention applies the k-scales after the q·k product and folds
the v-scales into the probabilities (``core/model.py::masked_attention``),
so the int8 values are used exactly as stored.

Unlike the JAX version, which returns new arrays, ``write_block`` (with
its ``scales``, JAX's ``write_block_quant``) writes the new block IN
PLACE (a block that wants a gradient is also attended through a written
copy that carries its graph, ``_write_rows``). ``with_length`` and
``rolled_back`` return a new cache that shares the storage with the old
one: after a forward, the old cache object sees the new entries too, and
only its ``length`` differs. ``install_slot``
and ``zero_slot`` likewise edit the storage in place and return a cache
with a new length tensor.
"""
from __future__ import annotations

import dataclasses

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.utils.profiling import TRACER


@dataclasses.dataclass
class KVCache:
    """k/v: [num_layers, batch, max_seq, num_kv_heads, head_dim];
    length: int32 [batch] on the cache's device. A latent (MLA) cache holds
    its one stream in k, [L, B, S, 1, kv_lora_rank + qk_rope_head_dim],
    and a v of width 0 (``ModelConfig.cache_dims``), so every primitive
    here and in ``paged_cache.py`` carries it unchanged."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    def with_length(self, length: torch.Tensor) -> "KVCache":
        return dataclasses.replace(self, length=length)

    def rolled_back(self, n) -> "KVCache":
        """Drop the last ``n`` (per-seq) tokens: arithmetic only."""
        return self.with_length(torch.clamp_min(self.length - n, 0))


@dataclasses.dataclass
class QuantKVCache:
    """INT8 K/V with per-(position, head) scales: k/v int8
    [L, B, S, Hk, Dh]; k_scale/v_scale f32 [L, B, S, Hk] (dequantized value
    = q * scale); length int32 [B]. Same length semantics as KVCache."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    length: torch.Tensor

    def with_length(self, length: torch.Tensor) -> "QuantKVCache":
        return dataclasses.replace(self, length=length)

    def rolled_back(self, n) -> "QuantKVCache":
        return self.with_length(torch.clamp_min(self.length - n, 0))


def init_cache(cfg, batch_size: int, max_seq_len: int, dtype=None,
               device=None):
    """A zeroed cache on ``device`` (``None``: the card), in the format
    ``cfg.kv_quant`` selects: every decode loop and scheduler allocates
    through here."""
    device = resolve_device(device)
    Hk, Dk, Dv = cfg.cache_dims
    shape = (cfg.num_layers, batch_size, max_seq_len, Hk, Dk)
    length = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    if cfg.kv_quant == "int8":
        if Dv != Dk:
            raise ValueError("kv_quant='int8' has no latent (MLA) cache")
        return QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            length=length)
    dtype = dtype or cfg.dtype
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape[:-1] + (Dv,), dtype=dtype, device=device),
        length=length,
    )


def quantize_kv_block(blk: torch.Tensor):
    """[B, T, Hk, Dh] float block -> (int8 values, f32 [B, T, Hk] scales):
    scale = max(absmax over Dh, 1e-8) / 127, values round(x / scale)
    (half to even) clipped to +-127. The same f32 operations as the JAX
    quantizer run eagerly, so the stored values are bit-identical to it."""
    x = blk.to(torch.float32)
    scale = torch.clamp_min(x.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _write_rows(layers, blocks, offsets: torch.Tensor):
    """Write each [B, T, ...] block into its [B, S, ...] layer array at
    per-sequence ``offsets``, in place. As ``lax.dynamic_update_slice``
    does, an offset is clamped to ``S - T`` so the block always fits. The
    offsets stay on the device: no host read.

    Returns the arrays to attend over: the layers themselves, or, for a
    block that wants a gradient (grad mode on and the block requires
    grad), a new array equal to the written layer that carries the block's
    graph, while the layer takes the block's values detached. Training
    forwards need this: the layers of one cache are views of one stack, so
    an in-place write of layer i + 1 would change what layer i's attention
    saved for its backward."""
    B, T = blocks[0].shape[:2]
    S = layers[0].shape[1]
    start = torch.clamp(offsets.to(torch.int64), 0, S - T)
    rows = torch.arange(B, device=start.device)[:, None].expand(B, T)
    cols = start[:, None] + torch.arange(T, device=start.device)[None, :]
    out = []
    for layer, blk in zip(layers, blocks):
        blk = blk.to(layer.dtype)
        if torch.is_grad_enabled() and blk.requires_grad:
            out.append(layer.index_put((rows, cols), blk))
            blk = blk.detach()
        else:
            out.append(layer)
        layer.index_put_((rows, cols), blk)
    return tuple(out)


def write_block(layer_k: torch.Tensor, layer_v: torch.Tensor,
                new_k: torch.Tensor, new_v: torch.Tensor,
                offsets: torch.Tensor, scales=()):
    """Write a [B, T, Hk, Dh] block into one layer's [B, S, Hk, Dh] cache at
    per-sequence ``offsets``, in place (offsets clamped to S - T).

    ``scales``, the layer's (k_scale, v_scale) [B, S, Hk] of an int8 cache,
    makes this the JAX ``write_block_quant``: the blocks are quantized
    (``quantize_kv_block``) and their scales written beside the values.

    Returns the arrays to attend over, (k, v) plus the scales where given:
    the layer's own arrays, or for a block that wants a gradient their
    written copies carrying its graph (``_write_rows``)."""
    if not scales:
        return _write_rows((layer_k, layer_v), (new_k, new_v), offsets)
    kq, ks = quantize_kv_block(new_k)
    vq, vs = quantize_kv_block(new_v)
    return _write_rows((layer_k, layer_v) + tuple(scales), (kq, vq, ks, vs),
                       offsets)


def storage_fields(cache):
    """Names of a cache's storage arrays (values, and scales where the
    format has them): every tensor field but the int32 bookkeeping, the
    lengths and, for a paged cache, the page table."""
    return [f.name for f in dataclasses.fields(cache)
            if getattr(cache, f.name).dtype != torch.int32]


def write_scalar(t: torch.Tensor, index, value) -> None:
    """``t[index] = value`` for a host number ``value``. On the card
    PyTorch uploads the number and waits for the copy, so the tracer counts
    the write as a host sync (``sync.scalar_write``)."""
    with TRACER.span("sync.scalar_write"):
        t[index] = value


def with_row_length(cache, slot: int, new_len):
    """``cache`` (slotted or paged) with row ``slot`` of its length set. The
    length tensor is copied, not edited: other caches may share it."""
    length = cache.length.clone()
    write_scalar(length, slot, new_len)
    return cache.with_length(length)


def copy_slot(dst, src, slot: int) -> None:
    """Copy the batch-of-one cache ``src`` into ``dst``'s batch row ``slot``
    across every storage field (the scheduler's admission primitive; values
    and scales alike keep batch at axis 1). The rows are copied IN PLACE
    into ``dst``'s storage, so ``dst`` never aliases ``src``; the lengths
    are left as they are."""
    for name in storage_fields(dst):
        getattr(dst, name)[:, slot].copy_(getattr(src, name)[:, 0])


def install_slot(dst, src, slot: int, new_len):
    """``copy_slot``, then set that row's length; returns ``dst`` with the
    new length."""
    copy_slot(dst, src, slot)
    return with_row_length(dst, slot, new_len)


def zero_slot(cache, slot: int, new_len):
    """Zero batch row ``slot`` of every storage field in place and set its
    length (slot-recycling hygiene for caches whose stale rows would
    otherwise be attended)."""
    for name in storage_fields(cache):
        getattr(cache, name)[:, slot].zero_()
    return with_row_length(cache, slot, new_len)


def gather_rows(cache, rows: torch.Tensor):
    """A cache (slotted, either format) whose batch row i is ``cache``'s
    row ``rows[i]``, in every storage field (int8 scales too) and in the
    length: beam search's reordering. The gathered storage is new."""
    fields = {name: getattr(cache, name)[:, rows]
              for name in storage_fields(cache)}
    return dataclasses.replace(cache, length=cache.length[rows], **fields)


def compact_path(cache, idx: torch.Tensor, dest: int, new_length):
    """Gather the rows at slot indices ``idx`` [n] along the sequence axis
    (axis 2) of every storage field (int8 scales too) and write them
    contiguously from slot ``dest`` (a host int); set the length: tree
    speculation's accepted-path compaction (JAX ``compact_path``).

    Source and destination may overlap inside one tensor, so the rows are
    gathered into a new tensor first (``index_select``) and then copied
    into the destination slice, in place. Where ``jnp.take`` and
    ``dynamic_update_slice`` clamp, this raises: ``index_select`` rejects
    an index outside [0, S) and a ``dest`` whose block does not fit is
    refused here, so a row is never read or written out of range
    silently (the decode loops size S so that neither happens)."""
    n = idx.shape[0]
    S = getattr(cache, storage_fields(cache)[0]).shape[2]
    if not 0 <= dest <= S - n:
        raise IndexError(f"compact_path: {n} rows from slot {dest} do not "
                         f"fit {S} slots")
    idx = idx.to(torch.int64)
    for name in storage_fields(cache):
        arr = getattr(cache, name)
        arr[:, :, dest:dest + n].copy_(arr.index_select(2, idx))
    return cache.with_length(new_length)
