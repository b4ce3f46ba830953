"""Weight-only quantization: INT8, NF4, FP4 and INT4 (counterpart of
``specdec_tpu/quant/core.py``).

Storage is bit-identical to the JAX package's eager quantizers, so
containers bridge through plain numpy views and can be compared bit for
bit:

- ``Int8Weight``: ``q`` int8 ``[..., K, N]``, ``scale`` f32 ``[..., 1, N]``
  (per-output-channel absmax / 127);
- ``NF4Weight``, ``FP4Weight``, ``Int4Weight``: ``packed`` int32 words
  ``[..., K/8, N]`` in the PAIR4 layout — word ``r``, bits ``[4p + 16h,
  +4)``, hold the code for ``k = p*K/4 + 2r + h``; ``absmax`` bf16
  ``[..., K/64, N]`` (block absmax, divided by 7 for INT4 and by 6 for FP4),
  stored block-major (natural block ``g = p*(G/4) + b`` at row ``b*4 + p``)
  when ``G = K/64`` is a multiple of 4, natural order otherwise.

``qmatmul`` hands every container to ``ops/quant_matmul.py``, whose CUDA
kernels (K1 for INT4, K6 for NF4/FP4, K7 for INT8) read the weights as
stored, except 4-bit weights whose K those kernels do not take, which
``check_kernel_shapes`` reports as the dequant route (and refuses a 4-bit
K that is no multiple of 64). ``init_quantized_params`` builds a random
model directly in quantized form, one layer at a time. The loaders' host
quantizers are in ``quant/host.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

# NF4 codebook from the QLoRA paper (quantiles of N(0,1), normalized to
# [-1, 1]); the JAX package's constants
NF4_CODEBOOK = np.asarray([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=np.float32)

# FP4 (e2m1) magnitudes; the sign is the code's bit 3
FP4_VALUES = np.asarray(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float32)

NF4_BLOCK = 64  # absmax block length along the reduction dimension


def _bf16_scale(absmax: torch.Tensor, div: float):
    """(stored bf16 scale, f32 normalization denominator). Codes are
    quantized against the ROUNDED scale so encode and decode see the same
    number."""
    stored = (absmax / div).to(torch.bfloat16)
    return stored, stored.to(torch.float32) * div


def _am_pack(am: torch.Tensor) -> torch.Tensor:
    """absmax natural row order (g = k // 64) -> stored block-major,
    quarter-minor order (row b*4 + p for natural g = p*(G/4) + b); a no-op
    when G % 4 != 0."""
    *lead, G, N = am.shape
    if G % 4 != 0:
        return am
    return am.reshape(*lead, 4, G // 4, N).transpose(-3, -2).reshape(
        *lead, G, N)


def _am_unpack(am: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_am_pack``."""
    *lead, G, N = am.shape
    if G % 4 != 0:
        return am
    return am.reshape(*lead, G // 4, 4, N).transpose(-3, -2).reshape(
        *lead, G, N)


def _pair_shifts(lead_dims: int, device) -> torch.Tensor:
    """[4, 1, 2, 1]-shaped shift table: nibble (p, h) sits at bit 4p + 16h."""
    sh = (torch.arange(4, device=device) * 4)[:, None, None] \
        + (torch.arange(2, device=device) * 16)[None, :, None]
    return sh.reshape(*([1] * lead_dims), 4, 1, 2, 1)


def _wrap_int32(bits: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit pattern -> the int32 with the same
    bits (bit 31 set gives a negative int32, as the JAX package stores)."""
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)


def _pack_nibbles(code: torch.Tensor) -> torch.Tensor:
    """codes [..., K, N] (0..15) -> int32 words [..., K/8, N], pair4 layout.
    The words are assembled in int64 and wrapped to int32 explicitly."""
    *lead, K, N = code.shape
    if K % 8 != 0:
        raise ValueError(f"K={K} is not a multiple of 8")
    c = code.to(torch.int64).reshape(*lead, 4, K // 8, 2, N)
    return _wrap_int32((c << _pair_shifts(len(lead), code.device)).sum(
        dim=(-4, -2)))


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """int32 words [..., K8, N] -> codes [..., K8*8, N] int32."""
    *lead, K8, N = packed.shape
    p = packed[..., None, :, None, :]
    codes = (p >> _pair_shifts(len(lead), packed.device).to(torch.int32)) & 0xF
    return codes.reshape(*lead, K8 * 8, N)


@dataclasses.dataclass
class Int8Weight:
    """w ≈ q * scale;  q: [..., K, N] int8, scale: [..., 1, N] f32."""

    q: torch.Tensor
    scale: torch.Tensor


@dataclasses.dataclass
class NF4Weight:
    """w[k, n] ≈ codebook[code(k, n)] * absmax[k // 64, n]; see the module
    docstring for the layout."""

    packed: torch.Tensor
    absmax: torch.Tensor


@dataclasses.dataclass
class FP4Weight:
    """w[k, n] ≈ fp4(code(k, n)) * absmax[k // 64, n]  (absmax is the block
    absmax pre-divided by 6, the grid's maximum)."""

    packed: torch.Tensor
    absmax: torch.Tensor


@dataclasses.dataclass
class Int4Weight:
    """w[k, n] ≈ (code(k, n) − 8) * absmax[k // 64, n]  (absmax is the
    block absmax pre-divided by 7)."""

    packed: torch.Tensor
    absmax: torch.Tensor


QUANTIZED = (Int8Weight, NF4Weight, FP4Weight, Int4Weight)


def quantize_int8(w: torch.Tensor) -> Int8Weight:
    """Symmetric per-output-channel (last dim) int8 quantization."""
    w = w.to(torch.float32)
    scale = w.abs().amax(dim=-2, keepdim=True) / 127.0
    q = torch.clamp(torch.round(w / torch.clamp_min(scale, 1e-12)), -127, 127)
    return Int8Weight(q=q.to(torch.int8), scale=scale)


def _blocks(w: torch.Tensor):
    """w [..., K, N] -> (f32 blocks [..., K/64, 64, N], block absmax)."""
    w = w.to(torch.float32)
    *lead, K, N = w.shape
    if K % NF4_BLOCK != 0:
        raise ValueError(f"K={K} not divisible by {NF4_BLOCK}")
    blocks = w.reshape(*lead, K // NF4_BLOCK, NF4_BLOCK, N)
    return blocks, blocks.abs().amax(dim=-2)


def _nearest(grid: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """Index of the nearest entry of the sorted ``grid`` through its f32
    midpoints (the left side on a tie, as ``jnp.searchsorted``)."""
    g = torch.from_numpy(grid).to(v.device)
    mids = (g[1:] + g[:-1]) / 2.0
    return torch.searchsorted(mids, v.contiguous(), right=False)


def _per_layer(fn, cls, w: torch.Tensor):
    """Quantize a stacked [L, K, N] weight one slice at a time (bounded
    transient memory), as the JAX package does."""
    slices = [fn(w[i]) for i in range(w.shape[0])]
    return cls(packed=torch.stack([s.packed for s in slices]),
               absmax=torch.stack([s.absmax for s in slices]))


def quantize_nf4(w: torch.Tensor) -> NF4Weight:
    """Blockwise NF4: codes = nearest codebook entry of w/absmax per
    64-element block along the reduction (second-to-last) dim."""
    if w.ndim >= 3:
        return _per_layer(quantize_nf4, NF4Weight, w)
    blocks, absmax = _blocks(w)
    stored, denom = _bf16_scale(absmax, 1.0)
    code = _nearest(NF4_CODEBOOK,
                    blocks / torch.clamp_min(denom[..., None, :], 1e-12))
    return NF4Weight(packed=_pack_nibbles(code.reshape(w.shape)),
                     absmax=_am_pack(stored))


def quantize_fp4(w: torch.Tensor) -> FP4Weight:
    """Blockwise FP4: nearest value of the e2m1 grid after scaling the
    64-block absmax onto the grid maximum (6.0)."""
    if w.ndim >= 3:
        return _per_layer(quantize_fp4, FP4Weight, w)
    blocks, absmax = _blocks(w)
    stored, denom = _bf16_scale(absmax, 6.0)
    scaled = blocks / torch.clamp_min(denom[..., None, :], 1e-12) * 6.0
    code = (scaled < 0).to(torch.int64) << 3 | _nearest(FP4_VALUES,
                                                        scaled.abs())
    return FP4Weight(packed=_pack_nibbles(code.reshape(w.shape)),
                     absmax=_am_pack(stored))


def quantize_int4(w: torch.Tensor) -> Int4Weight:
    """Blockwise symmetric INT4: q = clip(round(w/absmax·7), −7, 7) + 8."""
    if w.ndim >= 3:
        return _per_layer(quantize_int4, Int4Weight, w)
    blocks, absmax = _blocks(w)
    stored, denom = _bf16_scale(absmax, 7.0)
    q = torch.round(blocks / torch.clamp_min(denom[..., None, :], 1e-12) * 7.0)
    code = (torch.clamp(q, -7, 7) + 8).reshape(w.shape)
    return Int4Weight(packed=_pack_nibbles(code), absmax=_am_pack(stored))


def _int4_decode(code: torch.Tensor) -> torch.Tensor:
    """4-bit symmetric code -> float value on the ±7 grid."""
    return (code.to(torch.int32) - 8).to(torch.float32)


def _nf4_decode(code: torch.Tensor) -> torch.Tensor:
    """4-bit code -> f32 codebook value."""
    return torch.from_numpy(NF4_CODEBOOK).to(code.device)[code.long()]


def _nf4_packed_words() -> list:
    """The NF4 codebook rounded to bf16, two codes per 32-bit word: word i
    holds code 2i at bits [0, 16) and code 2i + 1 at bits [16, 32)."""
    u16 = torch.from_numpy(NF4_CODEBOOK).to(torch.bfloat16).view(
        torch.int16).to(torch.int64) & 0xFFFF
    return [int(u16[2 * i]) | (int(u16[2 * i + 1]) << 16) for i in range(8)]


_NF4_WORDS = _nf4_packed_words()


def _nf4_decode_bits(code: torch.Tensor) -> torch.Tensor:
    """NF4 code -> the bf16-rounded codebook value (as f32), assembled from
    ``_NF4_WORDS`` by the JAX package's 3-level select over code bits 1-3
    and a half-word pick on bit 0. Bit work in int64, wrapped to int32."""
    c = code.to(torch.int64)
    w = [torch.tensor(x, dtype=torch.int64, device=c.device)
         for x in _NF4_WORDS]
    b1 = (c & 2) != 0
    t = [torch.where(b1, w[2 * i + 1], w[2 * i]) for i in range(4)]
    b2 = (c & 4) != 0
    u0, u1 = torch.where(b2, t[1], t[0]), torch.where(b2, t[3], t[2])
    word = torch.where((c & 8) != 0, u1, u0)
    bits = torch.where((c & 1) != 0, word & 0xFFFF0000,
                       (word << 16) & 0xFFFFFFFF)
    return _wrap_int32(bits).view(torch.float32)


def _fp4_decode(code: torch.Tensor) -> torch.Tensor:
    """nibble (s e1e0 m) -> value: 2^(e-1) * (1 + m/2), or m/2 for e = 0."""
    c = code.to(torch.int32)
    e = (c >> 1) & 3
    half_m = 0.5 * (c & 1).to(torch.float32)
    base = torch.exp2((e - 1).to(torch.float32))
    mag = torch.where(e == 0, half_m, base * (1.0 + half_m))
    return torch.where(((c >> 3) & 1) == 1, -mag, mag)


def _fp4_decode_bits(code: torch.Tensor) -> torch.Tensor:
    """FP4 decode by assembling f32 bits: ``(e:m + 252) << 22`` for e >= 1,
    ``0x3F000000 * m`` for the e = 0 subnormals {0, 0.5}; the sign into bit
    31. Bit work in int64, wrapped to int32."""
    c = code.to(torch.int64)
    s31 = (c & 8) << 28
    norm = (((c & 7) + 252) << 22) | s31
    sub = (c & 1) * 0x3F000000 | s31
    return _wrap_int32(torch.where((c & 6) == 0, sub, norm)).view(
        torch.float32)


def _dequant4(w: Any, decode, dtype) -> torch.Tensor:
    """Decode a 4-bit container's int32 words to the full matrix."""
    vals = decode(_unpack_nibbles(w.packed))
    *lead, K, N = vals.shape
    scaled = vals.reshape(*lead, K // NF4_BLOCK, NF4_BLOCK, N) * \
        _am_unpack(w.absmax).to(torch.float32)[..., None, :]
    return scaled.reshape(*lead, K, N).to(dtype)


def dequantize(w: Any, dtype=torch.float32) -> torch.Tensor:
    """Materialize a weight (reference path and test oracle)."""
    if isinstance(w, Int8Weight):
        return (w.q.to(torch.float32) * w.scale).to(dtype)
    if isinstance(w, FP4Weight):
        return _dequant4(w, _fp4_decode, dtype)
    if isinstance(w, Int4Weight):
        return _dequant4(w, _int4_decode, dtype)
    if isinstance(w, NF4Weight):
        return _dequant4(w, _nf4_decode, dtype)
    return torch.as_tensor(w).to(dtype)


@dataclasses.dataclass
class StackedSlice:
    """Layer ``idx`` of a STACKED [L, ...] quantized container. ``qmatmul``
    hands the whole stack and the index to the kernel, which reads the
    layer in place: no layer's weights are copied."""

    container: Any
    idx: int


def qmatmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for dense or quantized w (quantized goes through
    ops/quant_matmul)."""
    if isinstance(w, StackedSlice):
        from specdec_tpu_torch.ops.quant_matmul import quant_matmul_stacked
        return quant_matmul_stacked(x, w.container, w.idx)
    if isinstance(w, QUANTIZED):
        from specdec_tpu_torch.ops.quant_matmul import quant_matmul
        return quant_matmul(x, w)
    return torch.matmul(x, w)


# the projections a layer dict may hold; the expert stacks (an [E, in,
# out] stack, or [L, E, in, out] stacked over layers) quantize each
# expert's matrix alone, as every quantizer does past two axes
_QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "w_kva", "w_kvb", "shared_gate", "shared_up", "shared_down",
                "experts_gate", "experts_up", "experts_down")


def _quantize_layer_dict(layers: dict, fn, fuse: bool, cfg=None) -> dict:
    """Quantize one layer dict (stacked or single-layer) by copy. A latent
    attention layer's (``w_kva``) fuses q with kv_a into ``wq_kva``, and
    gate with up into ``w_gateup``, ``shared_gateup`` and
    ``experts_gateup``; its absorbed weights ``w_uk``/``w_uv`` are set
    from the quantized ``w_kvb``, dequantized once (``cfg``'s heads split
    them)."""
    layers = dict(layers)
    if fuse and "w_kva" in layers:
        for parts, name in ((("wq", "w_kva"), "wq_kva"),
                            (("w_gate", "w_up"), "w_gateup"),
                            (("shared_gate", "shared_up"), "shared_gateup"),
                            (("experts_gate", "experts_up"),
                             "experts_gateup")):
            if all(p in layers for p in parts):
                layers[name] = fn(torch.cat([layers.pop(p) for p in parts],
                                            dim=-1))
    if fuse and "wq" in layers:
        layers["wqkv"] = fn(torch.cat(
            [layers.pop("wq"), layers.pop("wk"), layers.pop("wv")], dim=-1))
        if "bq" in layers:
            layers["bqkv"] = torch.cat(
                [layers.pop("bq"), layers.pop("bk"), layers.pop("bv")], dim=-1)
        if "w_gate" in layers:
            layers["w_gateup"] = fn(torch.cat(
                [layers.pop("w_gate"), layers.pop("w_up")], dim=-1))
            if "b_gate" in layers:
                layers["b_gateup"] = torch.cat(
                    [layers.pop("b_gate"), layers.pop("b_up")], dim=-1)
    for name in _QUANTIZABLE:
        if name in layers:
            layers[name] = fn(layers[name])
    if "w_kvb" in layers:
        if cfg is None:
            raise ValueError("quantize_params: a latent attention layer "
                             "(w_kvb) needs cfg, whose heads split its "
                             "absorbed weights")
        from specdec_tpu_torch.core.mla import absorbed_weights
        layers["w_uk"], layers["w_uv"] = absorbed_weights(cfg,
                                                          layers["w_kvb"])
    return layers


_QUANTIZERS = {"int8": quantize_int8, "nf4": quantize_nf4,
               "fp4": quantize_fp4, "int4": quantize_int4}


def quantize_params(params: dict, kind: str = "int8",
                    quantize_lm_head: bool = True, fuse: bool = False,
                    cfg=None) -> dict:
    """Quantize the layer projection weights (and the untied ``lm_head``)
    of a params dict; embeddings and norms stay dense. ``fuse=True``
    concatenates q/k/v into ``wqkv`` and gate/up into ``w_gateup`` first, so
    each runs as one kernel launch. ``cfg``, the model's config, is needed
    for latent attention layers only (their absorbed weights)."""
    fn = _QUANTIZERS[kind]
    out = dict(params)
    layers = params["layers"]
    out["layers"] = ([_quantize_layer_dict(lay, fn, fuse, cfg)
                      for lay in layers]
                     if isinstance(layers, (list, tuple))
                     else _quantize_layer_dict(layers, fn, fuse, cfg))
    if quantize_lm_head and "lm_head" in params:
        out["lm_head"] = fn(params["lm_head"])
    return out


FOUR_BIT = ("int4", "nf4", "fp4")


def check_kernel_shapes(cfg, kind: str) -> dict:
    """The route each projection of a ``kind`` model takes, decided by its
    K (input width) before any launch: ``{tensor name (as the fused loaders
    store it): "kernel" or "dequant"}``, by the rule the matmuls apply
    (``ops/quant_matmul.py::kernel_takes``): 4-bit weights whose K the
    kernels do not take go to ``dequant_matmul`` (the JAX package's XLA
    route), INT8 always takes its kernel. Empty for ``kind`` "none". Raises ValueError for a 4-bit K
    that is no multiple of the 64-row absmax block, which no 4-bit
    container holds (the JAX quantizers assert the same): the loaders call
    this first, so such a model is refused before anything is read or
    trained."""
    from specdec_tpu_torch.ops.quant_matmul import kernel_takes

    if kind not in FOUR_BIT + ("int8",):
        return {}
    D = cfg.hidden_size
    shapes = [("wqkv", D), ("wo", cfg.num_heads * cfg.head_dim),
              ("w_gateup" if cfg.gated_mlp else "w_up", D),
              ("w_down", cfg.intermediate_size)]
    if not cfg.tie_embeddings:
        shapes.append(("lm_head", D))
    for name, K in shapes:
        if kind in FOUR_BIT and K % NF4_BLOCK:
            raise ValueError(
                f"{kind} weights: {name} has K={K}, not a multiple of "
                f"{NF4_BLOCK} (the 4-bit absmax block); load this model "
                "with quantization 'int8' or 'none'")
    return {name: "kernel" if kernel_takes(kind, K) else "dequant"
            for name, K in shapes}


def concat_columns(parts: list):
    """Concatenate dense tensors or quantized containers along the output
    (last) axis, field by field; every container field ends in N."""
    first = parts[0]
    if isinstance(first, QUANTIZED):
        return type(first)(**{f.name: torch.cat(
            [getattr(p, f.name) for p in parts], dim=-1)
            for f in dataclasses.fields(first)})
    return torch.cat(parts, dim=-1)


# weights quantized at once by quantize_chunked (16 MiB of f32; a 4-bit
# quantizer holds a few such intermediates and twice that in int64)
CHUNK_ELEMS = 1 << 22


def quantize_chunked(fn, w: torch.Tensor, chunk_cols: Optional[int] = None):
    """``fn(w)`` computed in output-column slices of ``chunk_cols``
    (default: as many columns as keep a slice of one layer within
    CHUNK_ELEMS weights): every quantizer is independent per output column
    (INT8's absmax reduces over K per column; the 4-bit formats block along
    K per column), so the result is bit-identical to the whole-matrix call
    while each intermediate stays a slice's."""
    N = w.shape[-1]
    if chunk_cols is None:
        chunk_cols = max(1, CHUNK_ELEMS // w.shape[-2])
    if N <= chunk_cols:
        return fn(w)
    return concat_columns([fn(w[..., s:s + chunk_cols])
                           for s in range(0, N, chunk_cols)])


def _empty_stack(v, L: int):
    """Zeros of ``v``'s kind with a leading axis of L for its L=1 axis."""
    if isinstance(v, QUANTIZED):
        return type(v)(**{f.name: _empty_stack(getattr(v, f.name), L)
                          for f in dataclasses.fields(v)})
    return torch.zeros((L,) + tuple(v.shape[1:]), dtype=v.dtype,
                       device=v.device)


def _write_layer(stacked: dict, layer: dict, i: int) -> None:
    """Copy a one-layer dict (leading axis 1) into layer ``i`` of
    ``stacked`` in place."""
    for k, v in layer.items():
        if isinstance(v, QUANTIZED):
            for f in dataclasses.fields(v):
                getattr(stacked[k], f.name)[i].copy_(getattr(v, f.name)[0])
        else:
            stacked[k][i].copy_(v[0])


def stack_layers(layer_dicts, L: int) -> dict:
    """Write an iterable of L one-layer dicts into a stack allocated from
    the first, one at a time: peak memory is the stack plus one layer."""
    stacked = None
    for i, lay in enumerate(layer_dicts):
        if stacked is None:
            stacked = {k: _empty_stack(v, L) for k, v in lay.items()}
        _write_layer(stacked, lay, i)
    return stacked


def init_quantized_params(cfg, seed: int = 0, kind: str = "int8",
                          scale: float = 0.02, fuse: bool = True,
                          layer_out_scales=None, device=None,
                          generator=None) -> dict:
    """Random-init a model directly in quantized form, one layer at a time
    (counterpart of the JAX package's ``init_quantized_params``).

    ``init_params`` + ``quantize_params`` holds the whole dense stack
    first (16 GB at 8B in bf16); here each layer is drawn on ``device``
    (``None``: the card) from ``generator`` (or ``seed``), its ``wo`` and
    ``w_down`` multiplied by ``layer_out_scales[i]`` when given (the
    LayerSkip damped tail), quantized in column chunks and written into a
    preallocated stack: peak memory is the quantized stack plus one dense
    layer. Then the embedding (dense) and the untied ``lm_head``
    (quantized) are drawn, in that order. The draws are
    ``init_layer_params``'s for each layer, so drawing the same stream
    again into dense layers and calling ``quantize_params(kind,
    fuse=fuse)`` gives the same bits. Refuses a 4-bit K no container holds
    first (``check_kernel_shapes``)."""
    from functools import partial

    from specdec_tpu_torch import resolve_device
    from specdec_tpu_torch.core.model import init_layer_params, normal_init

    device = resolve_device(device)
    check_kernel_shapes(cfg, kind)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    fn = partial(quantize_chunked, _QUANTIZERS[kind])
    one = cfg.replace(num_layers=1)

    def layers():
        for i in range(cfg.num_layers):
            lay = init_layer_params(one, scale, device, generator)
            s = 1.0 if layer_out_scales is None else float(
                layer_out_scales[i])
            for name in ("wo", "w_down"):
                lay[name] = (lay[name].to(torch.float32) * s).to(cfg.dtype)
            lay = _quantize_layer_dict(lay, fn, fuse)
            yield lay
            del lay  # the next layer is drawn with none of this one left

    stacked = stack_layers(layers(), cfg.num_layers)
    D = cfg.hidden_size

    def w(shape):
        return normal_init(shape, scale, cfg.dtype, device, generator)

    params = {"embed": w((cfg.vocab_size, D)), "layers": stacked,
              "final_norm_w": torch.ones((D,), dtype=cfg.dtype,
                                         device=device)}
    if cfg.norm_type == "layernorm":
        params["final_norm_b"] = torch.zeros((D,), dtype=cfg.dtype,
                                             device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = fn(w((D, cfg.vocab_size)))
    return params
