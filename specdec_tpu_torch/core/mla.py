"""Multi-head latent attention (deepseek_v2, without a q low-rank) over a
latent cache.

A cached position holds, per layer, the kv_a projection's latent after
its RMSNorm (``kv_lora_rank`` wide) and the rope key that every head
shares, rotated (``qk_rope_head_dim``): one stream of 576 bf16 values in
DeepSeek-V2-Lite, in the ``k`` of the slotted and paged caches beside a v
of width 0 (``ModelConfig.cache_dims``). Layer keys: ``wq`` and ``w_kva``
(fused by the quantizer into ``wq_kva``, one K1 launch), ``kv_norm_w``,
``w_kvb`` (the latent's up projection, per head qk_nope K columns, then
v_head_dim V columns), ``wo``, and, held for the absorbed form, ``w_uk``
[H, kv_lora_rank, qk_nope] and ``w_uv`` [H, kv_lora_rank, v_head_dim]:
``w_kvb``'s values (an INT4 container's, dequantized once) in float32
(``absorbed_weights``), which the build adds wherever it makes or changes
``w_kvb`` (``hf_loader.params_from_hf``, ``quant.core.quantize_params``).

Two forms of one attention, the same function up to rounding:

- decompressed (blocks of at least ``DECOMPRESSED_MIN_ROWS`` query rows:
  the admission prefills): every cached latent goes through ``w_kvb`` (K1)
  to per-head K (qk_nope, then the shared rope key) and V, and the block
  attends as multi-head attention. Through the flash-decode kernel (K3)
  where the caller asks for it, at head width 256: q and K are padded
  from 192 and V from 128 with zeros, which add exact zeros to every
  score and fill output columns that are dropped, and the kernel takes the
  model's softmax scale; otherwise through ``masked_attention``.
- absorbed (the draft and verify steps): q_nope goes through ``w_uk`` to
  a latent-wide query a head (float32 products with the float32 weights,
  then the activation dtype beside q_pe), which scores the cached stream
  as it is stored; the probabilities weight the cached latents, and
  ``w_uv`` takes that float32 latent output to each head's V width. The
  attention between is ``ops/mla_attention.py``'s MLA decode kernel
  (``csrc/mla_decode_attention.cu``; its plain float32 version on the
  CPU): it reads the slotted cache's layer, or the paged pool's layer
  through the page table, in place, with nothing gathered or copied.

Rollback stays length arithmetic: a position past a row's length is
masked and later overwritten. While the tracer is on, each forward that
attends in the absorbed form records ``mla_attention`` in
``paged_attention``'s layout (layers, latent bytes a position and layer,
q and out bytes a query row and layer, then on the device the live
positions and query rows), and every attention call runs inside an
``mla_attend`` span (the decompressed form's page gather included).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from specdec_tpu_torch.core.cache import write_block
from specdec_tpu_torch.core.paged_cache import (
    gather_pages, write_block_paged_stacked,
)
from specdec_tpu_torch.core.rope import apply_rope_interleaved
from specdec_tpu_torch.quant.core import QUANTIZED, dequantize, qmatmul
from specdec_tpu_torch.utils.profiling import TRACER

# query rows from which a block attends in the decompressed form
DECOMPRESSED_MIN_ROWS = 16
# the flash-decode kernel's head width for the decompressed form
KERNEL_HEAD_DIM = 256


def absorbed_weights(cfg, w_kvb) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_uk [H, r, nope], w_uv [H, r, v]) in float32: ``w_kvb``'s values
    (dequantized for a quantized one), split by head. Called once a layer
    at build."""
    w = (dequantize(w_kvb) if isinstance(w_kvb, QUANTIZED)
         else w_kvb.to(torch.float32))
    H, nope = cfg.num_heads, cfg.qk_nope_head_dim
    w = w.reshape(cfg.kv_lora_rank, H, nope + cfg.v_head_dim).transpose(0, 1)
    return w[..., :nope].contiguous(), w[..., nope:].contiguous()


def _q_kva(cfg, lp, h):
    if "wq_kva" in lp:
        out = qmatmul(h, lp["wq_kva"])
        n = cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        return out[..., :n], out[..., n:]
    return qmatmul(h, lp["wq"]), qmatmul(h, lp["w_kva"])


def project(cfg, lp, h, cos, sin):
    """h [B, T, D] (the attention norm's output) -> (q_nope [B, T, H,
    nope], rotated q_pe [B, T, H, rope], the block's latent stream
    [B, T, r + rope]: normed latent, rotated shared rope key)."""
    from specdec_tpu_torch.core.model import rms_norm

    B, T, _ = h.shape
    H, nope, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q, kva = _q_kva(cfg, lp, h)
    q = q.reshape(B, T, H, nope + cfg.qk_rope_head_dim)
    q_pe = apply_rope_interleaved(q[..., nope:], cos, sin)
    c = rms_norm(kva[..., :r], lp["kv_norm_w"], cfg.norm_eps)
    k_pe = apply_rope_interleaved(kva[..., None, r:], cos, sin)[:, :, 0]
    return q[..., :nope], q_pe, torch.cat([c, k_pe], dim=-1)


def decompressed_heads(cfg, lp, q_nope, q_pe, lat_all):
    """Multi-head q [B, T, H, nope + rope], K [B, S, H, nope + rope] and
    V [B, S, H, v] of the decompressed form: every cached latent
    [B, S, r + rope] through ``w_kvb``, beside the shared rope key."""
    B, T, H, nope = q_nope.shape
    S, r, v = lat_all.shape[1], cfg.kv_lora_rank, cfg.v_head_dim
    kv = qmatmul(lat_all[..., :r], lp["w_kvb"]).reshape(B, S, H, nope + v)
    k_pe = lat_all[:, :, None, r:].expand(B, S, H, cfg.qk_rope_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    return q, k, kv[..., nope:]


def decompressed(cfg, lp, q_nope, q_pe, lat_all, q_pos, use_kernel: bool):
    """The block over every cached latent [B, S, r + rope] as multi-head
    attention; returns [B, T, H * v]."""
    from specdec_tpu_torch.core.model import masked_attention

    q, k, v = decompressed_heads(cfg, lp, q_nope, q_pe, lat_all)
    B, T, H, _ = q.shape
    if not use_kernel:
        return masked_attention(q, k, v, q_pos, H, scale=cfg.attn_scale)
    from specdec_tpu_torch.ops.decode_attention import flash_decode_attention

    def pad(t):
        return F.pad(t, (0, KERNEL_HEAD_DIM - t.shape[-1])).contiguous()

    out = flash_decode_attention(pad(q), pad(k), pad(v), q_pos[:, 0],
                                 scale=cfg.attn_scale)
    return out[..., :v.shape[-1]].reshape(B, T, -1)


def absorbed(cfg, lp, q_nope, q_pe, lat, q_pos, page_table=None):
    """The block against the cached stream as stored: ``lat`` one layer of
    the slotted cache [B, S, 1, r + rope], or of the page pool [NP, 1,
    page, r + rope] read through ``page_table``. Returns [B, T, H * v] in
    q's dtype."""
    from specdec_tpu_torch.ops.mla_attention import mla_decode_attention

    B, T, H, _ = q_nope.shape
    if "w_uk" not in lp:
        raise ValueError("latent attention's absorbed form needs the "
                         "layer's w_uk and w_uv (added at build by "
                         "params_from_hf and quantize_params)")
    q_lat = torch.einsum("bthn,hrn->bthr", q_nope.to(torch.float32),
                         lp["w_uk"])
    q = torch.cat([q_lat, q_pe.to(torch.float32)], dim=-1).to(q_nope.dtype)
    o_lat = mla_decode_attention(q, lat, q_pos[:, 0].contiguous(),
                                 cfg.attn_scale, cfg.kv_lora_rank,
                                 page_table)
    out = torch.einsum("bthr,hrv->bthv", o_lat, lp["w_uv"])
    return out.to(q_nope.dtype).reshape(B, T, -1)


def _attend(cfg, lp, q_nope, q_pe, lat, q_pos, use_kernel, table=None):
    """The form the block's rows ask for (called inside ``mla_attend``):
    ``lat`` is the layer as stored, slotted [B, S, 1, r + rope] or the page
    pool's [NP, 1, page, r + rope] read through ``table``, whose pages the
    decompressed form gathers."""
    if q_nope.shape[1] < DECOMPRESSED_MIN_ROWS:
        return absorbed(cfg, lp, q_nope, q_pe, lat, q_pos, table)
    if table is not None:
        lat = gather_pages(lat, table)
    return decompressed(cfg, lp, q_nope, q_pe, lat[:, :, 0], q_pos,
                        use_kernel)


def _record(cfg, keys: torch.Tensor, rows: torch.Tensor) -> None:
    """The ``mla_attention`` record of one absorbed-form forward."""
    size = cfg.dtype.itemsize
    r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    TRACER.record("mla_attention", cfg.num_layers, (r + rope) * size,
                  cfg.num_heads * (2 * r + rope) * size,
                  torch.stack([keys, rows]))


def slotted_attend(cfg, cache, q_pos, T: int, use_kernel: bool):
    """The layer attention over a slotted latent cache: writes the block's
    stream at ``cache.length`` in place and attends over layer ``i`` as
    stored. Every row counts as live."""
    if TRACER.on and T < DECOMPRESSED_MIN_ROWS:
        length = cache.length.to(torch.int64)
        keys = (length + T).sum()
        _record(cfg, keys, torch.full_like(keys, length.shape[0] * T))

    def attend(i, lp, q_nope, q_pe, lat):
        lat_all, _ = write_block(cache.k[i], cache.v[i], lat[:, :, None],
                                 lat.new_empty(lat.shape[:2] + (1, 0)),
                                 cache.length)
        with TRACER.span("mla_attend"):
            return _attend(cfg, lp, q_nope, q_pe, lat_all, q_pos, use_kernel)
    return attend


def paged_attend(cfg, cache, q_pos, T: int):
    """The layer attention over a paged latent pool: writes the block
    through the page table, then attends over the pool's layer through the
    table (the absorbed form) or over the gathered pages (the decompressed
    one). A row whose table starts at the garbage page counts for
    nothing."""
    table, offsets = cache.page_table, cache.length
    if TRACER.on and T < DECOMPRESSED_MIN_ROWS:
        live = (table[:, 0] != 0).to(torch.int64)
        _record(cfg, (live * (offsets.to(torch.int64) + T)).sum(),
                live.sum() * T)

    def attend(i, lp, q_nope, q_pe, lat):
        write_block_paged_stacked(cache.k, cache.v, i, lat[:, :, None],
                                  lat.new_empty(lat.shape[:2] + (1, 0)),
                                  table, offsets, cache.page_size)
        with TRACER.span("mla_attend"):
            return _attend(cfg, lp, q_nope, q_pe, cache.k[i], q_pos, False,
                           table)
    return attend


def block(cfg, lp, i: int, x, cos, sin, attend):
    """Layer ``i``: latent attention, then layer ``i``'s dense SwiGLU or
    expert layer (``core/moe.py``)."""
    from specdec_tpu_torch.core.model import _mlp_up, rms_norm
    from specdec_tpu_torch.core.moe import moe_layer

    h = rms_norm(x, lp["attn_norm_w"], cfg.norm_eps)
    q_nope, q_pe, lat = project(cfg, lp, h, cos, sin)
    x = x + qmatmul(attend(i, lp, q_nope, q_pe, lat), lp["wo"])
    m = rms_norm(x, lp["mlp_norm_w"], cfg.norm_eps)
    if cfg.is_moe_layer(i):
        return x + moe_layer(cfg, lp, m)
    return x + qmatmul(_mlp_up(cfg, lp, m), lp["w_down"])
