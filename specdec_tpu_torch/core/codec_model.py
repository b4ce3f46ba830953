"""Encoder-decoder (T5-family) model for codec speculative decoding
(counterpart of ``specdec_tpu/core/codec_model.py``).

The JAX package's model, function for function:

- T5 layer norm (= RMSNorm, no bias or mean), pre-norm residual blocks;
- relative position bias (log-bucketed, bidirectional for the encoder,
  causal for the decoder), computed from integer positions, so the decoder
  takes any per-window cache offset; NO 1/sqrt(d) attention scaling and no
  projection biases (T5's own);
- decoder self-attention over the slotted ``KVCache`` of the decoder-only
  stack (rollback is length arithmetic); cross-attention K/V computed once
  per request from the encoder output, then fixed;
- a tied head scales the decoder output by d_model^-0.5 (HF T5's rule).

Every projection and both attentions are plain ``torch.matmul``/``einsum``
and ``softmax``: the JAX model computes them as XLA einsums and reaches no
Pallas kernel, so this path has no kernel of its own.

Weights come from HF T5 state-dict names (``codec_params_from_hf``), or
straight from a local safetensors checkpoint (``load_codec_checkpoint``,
through the port's own reader: no ``transformers`` or ``safetensors``).
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import KVCache, init_cache, write_block
from specdec_tpu_torch.core.model import _layer_params, normal_init, rms_norm
from specdec_tpu_torch.core.stream_loader import ShardReader, read_config

Params = Dict[str, Any]

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    vocab_size: int
    d_model: int
    d_kv: int
    d_ff: int
    num_heads: int
    num_encoder_layers: int
    num_decoder_layers: int
    rel_buckets: int = 32
    rel_max_distance: int = 128
    norm_eps: float = 1e-6
    gated_ffn: bool = False  # t5 v1.1 / flan use gated-gelu
    tie_embeddings: bool = True
    decoder_start_token_id: int = 0
    max_position_embeddings: int = 512  # budget only; T5 has no abs positions
    dtype: torch.dtype = torch.float32

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    def replace(self, **kw) -> "CodecConfig":
        return dataclasses.replace(self, **kw)


def rel_position_bucket(rel: torch.Tensor, bidirectional: bool,
                        num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's log-spaced relative position bucketing (HF's rule), in the JAX
    package's f32 operations: the log-spaced bucket truncates a product
    that is an exact integer at some distances, so its operands are device
    tensors (CUDA turns a division by a host scalar into a multiplication
    by its reciprocal, which can round differently)."""
    out = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        out = out + (rel > 0).to(rel.dtype) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp_max(rel, 0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact

    def f32(value):
        return torch.tensor(value, dtype=torch.float32, device=rel.device)

    scaled = (torch.log(torch.clamp_min(rel, 1).to(torch.float32)
                        / f32(max_exact))
              / f32(np.float32(np.log(max_distance / max_exact)))
              * f32(num_buckets - max_exact))
    large = torch.clamp_max(max_exact + scaled.to(torch.int32).to(rel.dtype),
                            num_buckets - 1)
    return out + torch.where(is_small, rel, large)


def _rel_bias(cfg: CodecConfig, table: torch.Tensor, q_pos: torch.Tensor,
              k_pos: torch.Tensor, bidirectional: bool) -> torch.Tensor:
    """table: [num_buckets, H]; q_pos: [B, T]; k_pos: [S] -> f32 bias
    [B, H, T, S]."""
    rel = k_pos[None, None, :] - q_pos[:, :, None]            # [B, T, S]
    bucket = rel_position_bucket(rel, bidirectional, cfg.rel_buckets,
                                 cfg.rel_max_distance)
    return table[bucket].permute(0, 3, 1, 2).to(torch.float32)


def _mha(q, k, v, bias, mask):
    """q: [B, T, H, Dk]; k/v: [B, S, H, Dk]; bias [B, H, T, S] or None;
    mask [B, T, S]. f32 scores, NO 1/sqrt(d) scaling (T5), f32 softmax,
    the probabilities cast to v's dtype."""
    scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                          k.to(torch.float32))
    if bias is not None:
        scores = scores + bias
    scores = scores.masked_fill(~mask[:, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _proj(x, w):
    return torch.matmul(x, w)


def _ffn(cfg: CodecConfig, lp: Params, x):
    h = rms_norm(x, lp["ffn_norm_w"], cfg.norm_eps)
    if cfg.gated_ffn:
        # HF T5 gated-gelu uses the tanh-approximate "gelu_new"
        a = F.gelu(_proj(h, lp["wi_0"]), approximate="tanh")
        inner = a * _proj(h, lp["wi_1"])
    else:
        inner = F.relu(_proj(h, lp["wi"]))
    return x + _proj(inner, lp["wo_ffn"])


def encode(cfg: CodecConfig, params: Params, input_ids: torch.Tensor,
           input_mask: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over [B, S] ids (``input_mask`` > 0 marks
    the live ones); returns [B, S, D], final-normed."""
    B, S = input_ids.shape
    H, Dk = cfg.num_heads, cfg.d_kv
    x = params["embed"][input_ids].to(cfg.dtype)
    pos = torch.arange(S, device=input_ids.device)
    bias = _rel_bias(cfg, params["enc_rel_bias"], pos[None, :].expand(B, S),
                     pos, bidirectional=True)
    mask = (input_mask[:, None, :] > 0).expand(B, S, S)
    for i in range(cfg.num_encoder_layers):
        lp = _layer_params(params["enc_layers"], i)
        h = rms_norm(x, lp["attn_norm_w"], cfg.norm_eps)
        q = _proj(h, lp["wq"]).reshape(B, S, H, Dk)
        k = _proj(h, lp["wk"]).reshape(B, S, H, Dk)
        v = _proj(h, lp["wv"]).reshape(B, S, H, Dk)
        attn = _mha(q, k, v, bias, mask).reshape(B, S, cfg.inner_dim)
        x = x + _proj(attn, lp["wo"])
        x = _ffn(cfg, lp, x)
    return rms_norm(x, params["enc_final_norm_w"], cfg.norm_eps)


def init_cross_kv(cfg: CodecConfig, params: Params, enc_out: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-request cross-attention K/V: [L, B, S_enc, H, Dk] each."""
    B, S, _ = enc_out.shape
    shape = (B, S, cfg.num_heads, cfg.d_kv)
    layers = params["dec_layers"]
    ck = torch.stack([_proj(enc_out, layers["cross_wk"][i]).reshape(shape)
                      for i in range(cfg.num_decoder_layers)])
    cv = torch.stack([_proj(enc_out, layers["cross_wv"][i]).reshape(shape)
                      for i in range(cfg.num_decoder_layers)])
    return ck, cv


def codec_cache(cfg: CodecConfig, batch_size: int, cache_len: int,
                device=None) -> KVCache:
    """A zeroed decoder self-attention cache: ``init_cache`` through a
    shim of the decoder-only config's fields (the codec caches K/V at the
    config's dtype, never int8)."""
    shim = types.SimpleNamespace(
        num_layers=cfg.num_decoder_layers,
        cache_dims=(cfg.num_heads, cfg.d_kv, cfg.d_kv), dtype=cfg.dtype,
        kv_quant="none")
    return init_cache(shim, batch_size, cache_len, device=device)


def decode_step(cfg: CodecConfig, params: Params, tokens: torch.Tensor,
                cache: KVCache, cross_k: torch.Tensor, cross_v: torch.Tensor,
                enc_mask: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
    """A [B, T] decoder-token block against the self-attention cache at
    per-sequence offsets, cross-attending the fixed encoder K/V. Writes
    the block's K/V into the cache in place; returns (logits [B, T, V]
    f32, the cache with length + T)."""
    B, T = tokens.shape
    H, Dk = cfg.num_heads, cfg.d_kv
    offsets = cache.length
    q_pos = (offsets.to(torch.int64)[:, None]
             + torch.arange(T, device=tokens.device)[None, :])
    k_pos = torch.arange(cache.k.shape[2], device=tokens.device)

    x = params["embed"][tokens].to(cfg.dtype)
    self_bias = _rel_bias(cfg, params["dec_rel_bias"], q_pos, k_pos,
                          bidirectional=False)
    self_mask = k_pos[None, None, :] <= q_pos[:, :, None]
    cross_mask = (enc_mask[:, None, :] > 0).expand(B, T, enc_mask.shape[1])
    for i in range(cfg.num_decoder_layers):
        lp = _layer_params(params["dec_layers"], i)
        h = rms_norm(x, lp["attn_norm_w"], cfg.norm_eps)
        q = _proj(h, lp["wq"]).reshape(B, T, H, Dk)
        k = _proj(h, lp["wk"]).reshape(B, T, H, Dk)
        v = _proj(h, lp["wv"]).reshape(B, T, H, Dk)
        lk, lv = write_block(cache.k[i], cache.v[i], k, v, offsets)
        attn = _mha(q, lk, lv, self_bias, self_mask)
        x = x + _proj(attn.reshape(B, T, cfg.inner_dim), lp["wo"])

        h = rms_norm(x, lp["cross_norm_w"], cfg.norm_eps)
        q = _proj(h, lp["cross_wq"]).reshape(B, T, H, Dk)
        attn = _mha(q, cross_k[i], cross_v[i], None, cross_mask)
        x = x + _proj(attn.reshape(B, T, cfg.inner_dim), lp["cross_wo"])

        x = _ffn(cfg, lp, x)

    x = rms_norm(x, params["dec_final_norm_w"], cfg.norm_eps)
    if cfg.tie_embeddings:
        x = x * (cfg.d_model ** -0.5)     # HF T5 tied-head rescale
        logits = torch.einsum("btd,vd->btv", x.to(torch.float32),
                              params["embed"].to(torch.float32))
    else:
        logits = torch.matmul(x.to(torch.float32),
                              params["lm_head"].to(torch.float32))
    return logits, cache.with_length(cache.length + T)


# ---------------------------------------------------------------------------
# HF conversion, checkpoints and random init
# ---------------------------------------------------------------------------

def codec_config_from_hf(hf_cfg, dtype=torch.float32) -> CodecConfig:
    """A ``CodecConfig`` from an HF T5 config: the dict of a checkpoint's
    ``config.json`` or a ``transformers`` config object. Fields that
    ``save_pretrained`` leaves out at their defaults take T5's defaults."""
    if isinstance(hf_cfg, Mapping):
        def get(name, default=None):
            return hf_cfg.get(name, default)
    else:
        def get(name, default=None):
            return getattr(hf_cfg, name, default)
    num_layers = get("num_layers", 6)
    return CodecConfig(
        vocab_size=get("vocab_size", 32128),
        d_model=get("d_model", 512),
        d_kv=get("d_kv", 64),
        d_ff=get("d_ff", 2048),
        num_heads=get("num_heads", 8),
        num_encoder_layers=num_layers,
        num_decoder_layers=get("num_decoder_layers") or num_layers,
        rel_buckets=get("relative_attention_num_buckets", 32),
        rel_max_distance=get("relative_attention_max_distance", 128),
        norm_eps=get("layer_norm_epsilon", 1e-6),
        gated_ffn="gated" in get("feed_forward_proj", "relu"),
        tie_embeddings=get("tie_word_embeddings", True),
        decoder_start_token_id=get("decoder_start_token_id", 0),
        max_position_embeddings=get("n_positions", 512),
        dtype=dtype,
    )


def _codec_params(read: Callable[[str], torch.Tensor], cfg: CodecConfig,
                  device) -> Params:
    """JAX's codec param tree from HF T5 tensor names: ``read(name)``
    gives the [out, in] (or 1D) tensor of that name on any device and in
    any dtype. Each stack is allocated once at cfg.dtype on ``device`` and
    filled layer by layer (transposed to [in, out]); no parameter views
    what ``read`` returned."""

    def one(name, transpose=False):
        t = read(name).detach()
        t = t.t() if transpose else t
        return torch.empty(t.shape, dtype=cfg.dtype, device=device).copy_(t)

    def stack(pattern, L, transpose=True):
        first = read(pattern.format(0)).detach()
        shape = tuple(first.shape[::-1]) if transpose else tuple(first.shape)
        out = torch.empty((L,) + shape, dtype=cfg.dtype, device=device)
        for i in range(L):
            t = first if i == 0 else read(pattern.format(i)).detach()
            out[i].copy_(t.t() if transpose else t)
        return out

    Le, Ld = cfg.num_encoder_layers, cfg.num_decoder_layers
    e = "encoder.block.{}.layer."
    enc_layers = {
        "attn_norm_w": stack(e + "0.layer_norm.weight", Le, False),
        "wq": stack(e + "0.SelfAttention.q.weight", Le),
        "wk": stack(e + "0.SelfAttention.k.weight", Le),
        "wv": stack(e + "0.SelfAttention.v.weight", Le),
        "wo": stack(e + "0.SelfAttention.o.weight", Le),
        "ffn_norm_w": stack(e + "1.layer_norm.weight", Le, False),
    }
    d = "decoder.block.{}.layer."
    dec_layers = {
        "attn_norm_w": stack(d + "0.layer_norm.weight", Ld, False),
        "wq": stack(d + "0.SelfAttention.q.weight", Ld),
        "wk": stack(d + "0.SelfAttention.k.weight", Ld),
        "wv": stack(d + "0.SelfAttention.v.weight", Ld),
        "wo": stack(d + "0.SelfAttention.o.weight", Ld),
        "cross_norm_w": stack(d + "1.layer_norm.weight", Ld, False),
        "cross_wq": stack(d + "1.EncDecAttention.q.weight", Ld),
        "cross_wk": stack(d + "1.EncDecAttention.k.weight", Ld),
        "cross_wv": stack(d + "1.EncDecAttention.v.weight", Ld),
        "cross_wo": stack(d + "1.EncDecAttention.o.weight", Ld),
        "ffn_norm_w": stack(d + "2.layer_norm.weight", Ld, False),
    }
    if cfg.gated_ffn:
        enc_layers["wi_0"] = stack(e + "1.DenseReluDense.wi_0.weight", Le)
        enc_layers["wi_1"] = stack(e + "1.DenseReluDense.wi_1.weight", Le)
        dec_layers["wi_0"] = stack(d + "2.DenseReluDense.wi_0.weight", Ld)
        dec_layers["wi_1"] = stack(d + "2.DenseReluDense.wi_1.weight", Ld)
    else:
        enc_layers["wi"] = stack(e + "1.DenseReluDense.wi.weight", Le)
        dec_layers["wi"] = stack(d + "2.DenseReluDense.wi.weight", Ld)
    enc_layers["wo_ffn"] = stack(e + "1.DenseReluDense.wo.weight", Le)
    dec_layers["wo_ffn"] = stack(d + "2.DenseReluDense.wo.weight", Ld)

    params: Params = {
        "embed": one("shared.weight"),
        "enc_layers": enc_layers,
        "dec_layers": dec_layers,
        "enc_rel_bias": one("encoder.block.0.layer.0.SelfAttention"
                            ".relative_attention_bias.weight"),
        "dec_rel_bias": one("decoder.block.0.layer.0.SelfAttention"
                            ".relative_attention_bias.weight"),
        "enc_final_norm_w": one("encoder.final_layer_norm.weight"),
        "dec_final_norm_w": one("decoder.final_layer_norm.weight"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = one("lm_head.weight", transpose=True)
    return params


def codec_params_from_hf(state, cfg: CodecConfig, device=None) -> Params:
    """JAX's codec param tree from HF T5 weights: ``state`` maps state-dict
    names to tensors (or is a module, whose ``state_dict()`` is read).
    Weights are cast to cfg.dtype on ``device`` (``None``: the card)."""
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return _codec_params(state.__getitem__, cfg, resolve_device(device))


# the names under which a checkpoint may hold the shared embedding:
# save_pretrained writes a tied tensor once and may keep either alias
_EMBED_ALIASES = ("shared.weight", "encoder.embed_tokens.weight",
                  "decoder.embed_tokens.weight")


def load_codec_checkpoint(path: str, dtype=torch.float32, device=None
                          ) -> Tuple[CodecConfig, Params]:
    """(cfg, params) of a local HF T5/mT5 checkpoint directory: its
    ``config.json`` and ``model.safetensors`` (or a sharded index), read
    by the port's own safetensors reader (``core/stream_loader.py::
    ShardReader``; F32 and BF16 tensors alike). The weights are cast to
    ``dtype`` on ``device`` (``None``: the card), one tensor at a time."""
    device = resolve_device(device)
    cfg = codec_config_from_hf(read_config(path), dtype=dtype)
    reader = ShardReader(path)

    def read(name):
        for alias in (_EMBED_ALIASES if name == _EMBED_ALIASES[0]
                      else (name,)):
            if alias in reader:
                return reader(alias)
        raise KeyError(f"{name!r} is not in the checkpoint at {path}")

    try:
        params = _codec_params(read, cfg, device)
    finally:
        reader.close()
    return cfg, params


def init_codec_params(cfg: CodecConfig, seed: int = 0, scale: float = 0.02,
                      device=None,
                      generator: Optional[torch.Generator] = None) -> Params:
    """Random init of JAX's tree and shapes (normal * scale, drawn in f32
    then cast to cfg.dtype; norms 1), made on ``device`` (``None``: the
    card) from ``generator`` or ``seed``. The numbers differ from the JAX
    package's init; tests carry JAX params over with
    ``bridge.params_from_numpy`` instead."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)

    def w(shape):
        return normal_init(shape, scale, cfg.dtype, device, generator)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    D, I, Fd, H = cfg.d_model, cfg.inner_dim, cfg.d_ff, cfg.num_heads
    Le, Ld = cfg.num_encoder_layers, cfg.num_decoder_layers

    def ffn(L):
        out = {"ffn_norm_w": ones((L, D)), "wo_ffn": w((L, Fd, D))}
        if cfg.gated_ffn:
            out.update(wi_0=w((L, D, Fd)), wi_1=w((L, D, Fd)))
        else:
            out["wi"] = w((L, D, Fd))
        return out

    enc_layers = {
        "attn_norm_w": ones((Le, D)),
        "wq": w((Le, D, I)), "wk": w((Le, D, I)), "wv": w((Le, D, I)),
        "wo": w((Le, I, D)), **ffn(Le),
    }
    dec_layers = {
        "attn_norm_w": ones((Ld, D)),
        "wq": w((Ld, D, I)), "wk": w((Ld, D, I)), "wv": w((Ld, D, I)),
        "wo": w((Ld, I, D)),
        "cross_norm_w": ones((Ld, D)),
        "cross_wq": w((Ld, D, I)), "cross_wk": w((Ld, D, I)),
        "cross_wv": w((Ld, D, I)), "cross_wo": w((Ld, I, D)),
        **ffn(Ld),
    }
    params: Params = {
        "embed": w((cfg.vocab_size, D)),
        "enc_layers": enc_layers,
        "dec_layers": dec_layers,
        "enc_rel_bias": w((cfg.rel_buckets, H)),
        "dec_rel_bias": w((cfg.rel_buckets, H)),
        "enc_final_norm_w": ones((D,)),
        "dec_final_norm_w": ones((D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = w((D, cfg.vocab_size))
    return params
