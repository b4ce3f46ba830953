"""Decoder-only transformer forward pass
(counterpart of ``specdec_tpu/core/model.py``).

Same families and semantics as the JAX model: llama/mistral/qwen (RMSNorm,
RoPE, SwiGLU, GQA, optional qk-norm and qkv bias), gpt-neox (LayerNorm,
parallel residual, partial rotary, biases) and gemma (embedding scale, tied
head), with an optional logit softcap. ``forward_step`` processes a [B, T]
block against the slotted cache at per-sequence offsets: prefill, one-token
decode and the (gamma+1)-token verify are the same function with another T;
it attends through the flash-decode kernel under ``attention_impl="flash"``
(``attention``). ``forward_step_paged`` is the same forward over the paged
pool (``core/paged_cache.py``), attending through the paged
decode-attention kernel. Both take the int8 cache formats of
``kv_quant="int8"`` as well. ``forward_step_features`` also returns the
pre-final-norm residual stream (the features EAGLE drafts on), and
``forward_step_tree`` / ``forward_step_tree_features`` process a block of
tree-structured tokens on the slotted cache, attending by ancestry
(``masked_attention``'s ``tree``): tree blocks never take an attention
kernel, whose mask is positional.

Params are a dict of tensors whose layer leaves are STACKED with a leading
L axis. The layer loop is a Python loop over ``range(L)``: dense leaves are
indexed (a view), and quantized containers (INT8, NF4, FP4, INT4) are
handed to ``qmatmul`` as ``StackedSlice(container, i)`` so that the kernel
reads layer ``i`` in place.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import (
    QuantKVCache, init_cache, write_block,
)
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.paged_cache import (
    QuantPagedKVCache, gather_page_scales, gather_pages,
    write_block_paged_stacked,
)
from specdec_tpu_torch.core.rope import apply_rope, rope_cos_sin
from specdec_tpu_torch.ops.attention_args import kernel_takes
from specdec_tpu_torch.quant.core import QUANTIZED, StackedSlice, qmatmul

Params = Dict[str, Any]

_NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Upcast to f32 for the statistics; the weight multiplies in x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (w * normed.to(x.dtype)).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed.to(x.dtype) * w + b).to(x.dtype)


def _norm(cfg: ModelConfig, x, w, b=None):
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, w, cfg.norm_eps)
    return layer_norm(x, w, b, cfg.norm_eps)


def _act(cfg: ModelConfig, x):
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        return F.gelu(x, approximate="none")
    if cfg.act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {cfg.act}")


def masked_attention(q, k_all, v_all, q_pos, num_kv_heads: int,
                     logit_softcap: float = 0.0,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     tree: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """q: [B, T, Hq, Dh]; k_all/v_all: [B, S, Hk, Dh]; q_pos: [B, T].
    Returns [B, T, Hq * Dh] in v's dtype, or in q's for int8 K/V.

    The mask admits key position s iff s <= q_pos[b, t]; it covers
    causality, cache validity and staleness after rollback. Scores and
    softmax are f32; grouped-query heads are a reshape of q, so K/V are
    never repeated.

    Int8 K/V come with f32 scales ``k_scale``/``v_scale`` [B, S, Hk]: the
    k-scale multiplies the scores after (q·k) * scale, the v-scale the
    normalized probabilities, which are then cast to q's dtype for the
    value product, as the JAX package's XLA path does. The int8 values are
    used as stored: no dequantized [B, S, Hk, Dh] tensor is formed.

    ``tree`` = (start [B], tree_mask [T, E] bool) makes the block a tree
    of speculated tokens (the JAX ``_attention``'s ``tree``): key slots in
    [start, start + E) hold tree nodes, admitted by ancestry through
    ``tree_mask[t, s - start]``; every other key keeps the position
    test."""
    B, T, Hq, Dh = q.shape
    S = k_all.shape[1]
    Hk = num_kv_heads
    qg = q.reshape(B, T, Hk, Hq // Hk, Dh)
    # the f32 number 1/sqrt(Dh), as a host scalar (no host-to-device copy)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(Dh)))
    scores = torch.einsum("bthgd,bshd->bhgts", qg.to(torch.float32),
                          k_all.to(torch.float32)) * scale
    if k_scale is not None:
        # one scale per (position, kv head): [B, S, Hk] -> [B, Hk, 1, 1, S]
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    k_pos = torch.arange(S, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]           # [B, T, S]
    if tree is not None:
        start, tree_mask = tree
        E = tree_mask.shape[1]
        rel = k_pos[None, :] - start.to(torch.int64)[:, None]  # [B, S]
        is_tree = (rel >= 0) & (rel < E)
        by_ancestry = tree_mask[:, rel.clamp(0, E - 1)]        # [T, B, S]
        mask = torch.where(is_tree[:, None, :],
                           by_ancestry.permute(1, 0, 2), mask)
    scores = scores.masked_fill(~mask[:, None, None], _NEG_INF)
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
        out = torch.einsum("bhgts,bshd->bthgd", probs.to(q.dtype),
                           v_all.to(q.dtype))
    else:
        out = torch.einsum("bhgts,bshd->bthgd", probs.to(v_all.dtype), v_all)
    return out.reshape(B, T, Hq * Dh)


def kernel_route(cfg: ModelConfig) -> bool:
    """Whether the config's attention can run on the attention kernels: no
    logit softcap (the kernels have none) and a head_dim and activation
    type the kernel body takes (``ops/attention_args.kernel_takes``; int8
    K/V under ``kv_quant="int8"``). Decided from the config alone, before
    any launch, as the JAX dispatch decides what its kernel cannot hold."""
    return cfg.logit_softcap == 0.0 and kernel_takes(
        cfg.head_dim, cfg.dtype, cfg.kv_quant == "int8")


def attention(cfg: ModelConfig, q, k_all, v_all, q_pos,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None,
              tree: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Cached attention over dense [B, S, Hk, Dh] K/V (the counterpart of
    the JAX ``_attention``): the flash-decode kernel (K3, or K4 for int8
    K/V; ``ops/decode_attention.py``) when ``cfg.attention_impl == "flash"``
    and ``kernel_route(cfg)``, else ``masked_attention``. The kernel tiles
    query rows over blocks, so any T takes it, dense prefills included.
    A tree block (``tree`` given) always goes to ``masked_attention``,
    under every ``attention_impl``: the kernel's mask is positional and
    would attend past a node's ancestors. Returns [B, T, Hq * Dh]."""
    B, T = q.shape[:2]
    if (tree is None and cfg.attention_impl == "flash"
            and kernel_route(cfg)):
        from specdec_tpu_torch.ops import decode_attention as da

        if k_scale is not None:
            out = da.flash_decode_attention_quant(q, k_all, k_scale, v_all,
                                                  v_scale, q_pos[:, 0])
        else:
            out = da.flash_decode_attention(q, k_all, v_all, q_pos[:, 0])
        return out.reshape(B, T, -1)
    return masked_attention(q, k_all, v_all, q_pos, cfg.num_kv_heads,
                            cfg.logit_softcap, k_scale, v_scale, tree)


def _qkv(cfg: ModelConfig, lp: Params, h):
    """q/k/v projections; a fused ``wqkv`` runs as one matmul and is split."""
    Hq, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "wqkv" in lp:
        qkv = qmatmul(h, lp["wqkv"])
        if cfg.attn_qkv_bias:
            qkv = qkv + lp["bqkv"]
        q = qkv[..., :Hq * Dh]
        k = qkv[..., Hq * Dh:(Hq + Hk) * Dh]
        v = qkv[..., (Hq + Hk) * Dh:]
        return q, k, v
    q = qmatmul(h, lp["wq"])
    k = qmatmul(h, lp["wk"])
    v = qmatmul(h, lp["wv"])
    if cfg.attn_qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return q, k, v


def _mlp_up(cfg: ModelConfig, lp: Params, m):
    """Gate/up projections (a fused ``w_gateup`` runs as one matmul)."""
    if cfg.gated_mlp:
        if "w_gateup" in lp:
            gu = qmatmul(m, lp["w_gateup"])
            if cfg.mlp_bias:
                gu = gu + lp["b_gateup"]
            Fd = gu.shape[-1] // 2
            return _act(cfg, gu[..., :Fd]) * gu[..., Fd:]
        gate = qmatmul(m, lp["w_gate"])
        up = qmatmul(m, lp["w_up"])
        if cfg.mlp_bias:
            gate, up = gate + lp["b_gate"], up + lp["b_up"]
        return _act(cfg, gate) * up
    up = qmatmul(m, lp["w_up"])
    if cfg.mlp_bias:
        up = up + lp["b_up"]
    return _act(cfg, up)


def _block(cfg: ModelConfig, lp: Params, x, cos, sin, attend):
    """One transformer block over a [B, T, D] activation block.
    ``attend(q, k, v)`` stores the block's K/V in the layer's cache (in
    place) and returns the attention output [B, T, Hq * Dh]."""
    B, T, D = x.shape
    Hq, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    h = _norm(cfg, x, lp["attn_norm_w"], lp.get("attn_norm_b"))
    q, k, v = _qkv(cfg, lp, h)
    q = q.reshape(B, T, Hq, Dh)
    k = k.reshape(B, T, Hk, Dh)
    v = v.reshape(B, T, Hk, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm_w"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm_w"], cfg.norm_eps)
    rd = cfg.rotary_dim
    q = apply_rope(q, cos, sin, rd)
    k = apply_rope(k, cos, sin, rd)

    attn = qmatmul(attend(q, k, v), lp["wo"])
    if cfg.attn_out_bias:
        attn = attn + lp["bo"]

    if cfg.parallel_residual:
        m = _norm(cfg, x, lp["mlp_norm_w"], lp.get("mlp_norm_b"))
    else:
        x = x + attn
        m = _norm(cfg, x, lp["mlp_norm_w"], lp.get("mlp_norm_b"))

    mlp = qmatmul(_mlp_up(cfg, lp, m), lp["w_down"])
    if cfg.mlp_bias:
        mlp = mlp + lp["b_down"]

    if cfg.parallel_residual:
        return x + attn + mlp
    return x + mlp


def _layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s params: views of the dense stacks, ``StackedSlice``s of
    the quantized containers."""
    return {name: StackedSlice(v, i) if isinstance(v, QUANTIZED) else v[i]
            for name, v in layers.items()}


def _head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """final norm -> logits (f32), with the logit softcap: the target's
    head, which the EAGLE drafter shares (``core/eagle.py``)."""
    x = _norm(cfg, x, params["final_norm_w"], params.get("final_norm_b"))
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", x.to(torch.float32),
                              params["embed"].to(torch.float32))
    else:
        logits = qmatmul(x, params["lm_head"]).to(torch.float32)
    if cfg.logit_softcap > 0.0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _layers(cfg: ModelConfig, layers: Params, x, q_pos, layer_attend):
    """The block stack over x [B, T, D], rope at positions q_pos."""
    cos, sin = rope_cos_sin(q_pos, cfg.rotary_dim, cfg.rope_theta,
                            scaling=cfg.rope_scaling)
    for i in range(cfg.num_layers):
        x = _block(cfg, _layer_params(layers, i), x, cos, sin,
                   functools.partial(layer_attend, i))
    return x


def _forward_common(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                    q_pos: torch.Tensor, layer_attend, head: bool = True,
                    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """embed -> layers -> final norm -> logits (f32).
    ``layer_attend(i, q, k, v)`` is layer ``i``'s cache write and attention
    (see ``_block``). Returns (logits, features): the features are the
    residual stream after the layers and before the final norm, which
    EAGLE drafts on. ``head=False`` skips the final norm and the lm_head
    (logits None)."""
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.embed_scale != 1.0:  # gemma: sqrt(hidden) on the embedding only
        # a CPU 0-dim tensor is a scalar operand: rounded to cfg.dtype first,
        # as jnp.asarray(embed_scale, dtype) is, and never copied to the card
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.dtype)
    x = _layers(cfg, params["layers"], x, q_pos, layer_attend)
    return (_head(cfg, params, x) if head else None), x


def _positions(cache, T: int) -> torch.Tensor:
    """q_pos [B, T]: cache.length[b] + t."""
    return cache.length[:, None] + torch.arange(
        T, dtype=torch.int32, device=cache.length.device)[None, :]


def slotted_attend(cfg: ModelConfig, cache, q_pos: torch.Tensor,
                   tree=None):
    """``layer_attend`` over the slotted cache (``KVCache`` or
    ``QuantKVCache``): writes layer ``i``'s block at ``cache.length`` in
    place (quantized, for the int8 cache) and attends over layer ``i`` of
    the cache through ``attention``, by ancestry where ``tree`` is given."""
    quant = isinstance(cache, QuantKVCache)

    def attend(i, q, k, v):
        scales = (cache.k_scale[i], cache.v_scale[i]) if quant else ()
        write_block(cache.k[i], cache.v[i], k, v, cache.length, scales)
        return attention(cfg, q, cache.k[i], cache.v[i], q_pos, *scales,
                         tree=tree)
    return attend


def forward_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 cache) -> Tuple[torch.Tensor, Any]:
    """Process a [B, T] token block against the slotted cache (``KVCache``
    or ``QuantKVCache``) at per-sequence offsets: writes the block's K/V
    (quantized, for the int8 cache) at ``cache.length`` in place, attends
    over everything written so far through ``attention`` (layer ``i`` of
    the cache, read in place), and returns (logits [B, T, V] f32, the cache
    advanced by T)."""
    logits, _, cache = forward_step_features(cfg, params, tokens, cache)
    return logits, cache


def forward_step_features(cfg: ModelConfig, params: Params,
                          tokens: torch.Tensor, cache,
                          ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """``forward_step`` that also returns the pre-final-norm residual
    stream, the features [B, T, D] that EAGLE drafters autoregress on
    (``core/eagle.py``). Same cache semantics as ``forward_step``."""
    T = tokens.shape[1]
    q_pos = _positions(cache, T)
    logits, feats = _forward_common(cfg, params, tokens, q_pos,
                                    slotted_attend(cfg, cache, q_pos))
    return logits, feats, cache.with_length(cache.length + T)


def _tree_positions(cache, depths: torch.Tensor, tree_start):
    if tree_start is None:
        tree_start = cache.length
    return tree_start, tree_start[:, None] + depths[None, :].to(torch.int32)


def forward_step_tree(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                      cache, depths: torch.Tensor, tree_mask: torch.Tensor,
                      tree_start: Optional[torch.Tensor] = None,
                      head: bool = True) -> Tuple[Optional[torch.Tensor], Any]:
    """Process a [B, N] block of TREE-structured tokens against the slotted
    cache. Node j's rope position is ``tree_start + depths[j]`` and it
    attends to the prefix plus its ancestors only (``tree_mask`` [N, E],
    ancestor-or-self); K/V are written at slots length .. length+N-1 and
    the cache advances by N. ``tree_start`` (default: the cache length) is
    the slot of tree node 0: level-by-level expansion passes it when the
    cache has advanced past earlier levels, whose E - N nodes the mask
    then covers too. Tree blocks attend through ``masked_attention``
    under every ``attention_impl``. ``head=False`` skips the final norm
    and the lm_head (logits None): a forward that only writes the cache.
    Returns (logits [B, N, V] f32, the cache advanced by N)."""
    logits, _, cache = _tree_forward(cfg, params, tokens, cache, depths,
                                     tree_mask, tree_start, head)
    return logits, cache


def forward_step_tree_features(cfg: ModelConfig, params: Params,
                               tokens: torch.Tensor, cache,
                               depths: torch.Tensor, tree_mask: torch.Tensor,
                               tree_start: Optional[torch.Tensor] = None,
                               ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """``forward_step_tree`` that also returns the pre-final-norm residual
    stream per tree node ([B, N, D]), which EAGLE tree drafting writes
    back along the accepted path (``sampling/eagle_tree.py``)."""
    return _tree_forward(cfg, params, tokens, cache, depths, tree_mask,
                         tree_start, True)


def _tree_forward(cfg, params, tokens, cache, depths, tree_mask, tree_start,
                  head):
    start, q_pos = _tree_positions(cache, depths, tree_start)
    logits, feats = _forward_common(
        cfg, params, tokens, q_pos,
        slotted_attend(cfg, cache, q_pos, (start, tree_mask)), head)
    return logits, feats, cache.with_length(cache.length + tokens.shape[1])


def forward_step_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                       cache, use_kernel: Optional[bool] = None,
                       ) -> Tuple[torch.Tensor, Any]:
    """``forward_step`` over a ``PagedKVCache`` or ``QuantPagedKVCache``:
    the same math, with K/V (and, for int8 pools, their scales) in a page
    pool addressed through per-sequence page tables. Each layer writes its
    block through the page table into the stacked pools in place, then
    attends through the paged decode-attention kernel on layer ``i`` of the
    stacks (``ops/paged_attention.py``: K8a, or K8b for int8 pools; on a
    CPU tensor the wrapper computes the plain version).

    ``use_kernel=None`` takes the kernel where ``kernel_route(cfg)``: not
    for a model that soft-caps its attention logits, which the kernel does
    not do, nor for a head_dim the kernel has no instance for (above 128);
    such models gather the pages (and scales) and run ``attention``, as the
    JAX dispatch does. ``True`` forces the kernel (and raises for such a
    model before any launch), ``False`` the gather path. The CUDA kernel
    tiles query rows over blocks, so any T takes it."""
    from specdec_tpu_torch.ops import paged_attention as pa

    if use_kernel is None:
        use_kernel = kernel_route(cfg)
    elif use_kernel and cfg.logit_softcap != 0.0:
        raise ValueError("the paged attention kernel has no logit softcap; "
                         "use_kernel=True needs logit_softcap == 0")
    elif use_kernel and not kernel_route(cfg):
        raise ValueError(f"the paged attention kernel does not take "
                         f"head_dim {cfg.head_dim} with {cfg.dtype} "
                         f"activations (kv_quant={cfg.kv_quant!r})")
    B, T = tokens.shape
    q_pos = _positions(cache, T)
    table, offsets = cache.page_table, cache.length
    # an int8 pool's scale stacks, written and read beside the values
    scales = ((cache.k_scale, cache.v_scale)
              if isinstance(cache, QuantPagedKVCache) else ())

    def attend(i, q, k, v):
        write_block_paged_stacked(cache.k, cache.v, i, k, v, table, offsets,
                                  cache.page_size, scales)
        if not use_kernel:
            return attention(cfg, q, gather_pages(cache.k[i], table),
                             gather_pages(cache.v[i], table), q_pos,
                             *(gather_page_scales(s[i], table)
                               for s in scales))
        if scales:
            out = pa.paged_decode_attention_quant_stacked(
                q, cache.k, scales[0], cache.v, scales[1], i, table, offsets)
        else:
            out = pa.paged_decode_attention_stacked(q, cache.k, cache.v, i,
                                                    table, offsets)
        return out.reshape(B, T, -1)

    logits, _ = _forward_common(cfg, params, tokens, q_pos, attend)
    forward_step_paged.calls += 1
    return logits, cache.with_length(cache.length + T)


# target paged forwards (a run's kernel launches are checked against it)
forward_step_paged.calls = 0


def forward_full(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Causal full-sequence forward over a scratch cache; logits [B, T, V]."""
    B, T = tokens.shape
    cache = init_cache(cfg, B, T, device=tokens.device)
    logits, _ = forward_step(cfg, params, tokens, cache)
    return logits


def init_params(cfg: ModelConfig, seed: int = 0, scale: float = 0.02,
                device=None, generator: Optional[torch.Generator] = None,
                ) -> Params:
    """Random init (normal * scale, drawn in f32 then cast to cfg.dtype),
    made on ``device`` (``None``: the card) from ``generator`` or ``seed``.
    The numbers differ from the JAX package's init; tests carry JAX params
    over with ``bridge.params_from_numpy`` instead."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)

    def w(shape, s=scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * s).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    L, D, Fd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    layers: Params = {
        "attn_norm_w": ones((L, D)),
        "mlp_norm_w": ones((L, D)),
        "wq": w((L, D, Hq * Dh)),
        "wk": w((L, D, Hk * Dh)),
        "wv": w((L, D, Hk * Dh)),
        "wo": w((L, Hq * Dh, D)),
        "w_up": w((L, D, Fd)),
        "w_down": w((L, Fd, D)),
    }
    if cfg.gated_mlp:
        layers["w_gate"] = w((L, D, Fd))
    if cfg.norm_type == "layernorm":
        layers["attn_norm_b"] = zeros((L, D))
        layers["mlp_norm_b"] = zeros((L, D))
    if cfg.attn_qkv_bias:
        layers["bq"] = zeros((L, Hq * Dh))
        layers["bk"] = zeros((L, Hk * Dh))
        layers["bv"] = zeros((L, Hk * Dh))
    if cfg.attn_out_bias:
        layers["bo"] = zeros((L, D))
    if cfg.mlp_bias:
        layers["b_up"] = zeros((L, Fd))
        layers["b_down"] = zeros((L, D))
        if cfg.gated_mlp:
            layers["b_gate"] = zeros((L, Fd))
    if cfg.qk_norm:
        layers["q_norm_w"] = ones((L, Dh))
        layers["k_norm_w"] = ones((L, Dh))

    params: Params = {
        "embed": w((cfg.vocab_size, D)),
        "layers": layers,
        "final_norm_w": ones((D,)),
    }
    if cfg.norm_type == "layernorm":
        params["final_norm_b"] = zeros((D,))
    if not cfg.tie_embeddings:
        params["lm_head"] = w((D, cfg.vocab_size))
    return params
