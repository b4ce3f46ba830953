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
stored. The numpy quantizers of ``specdec_tpu/quant/host.py`` and
``init_quantized_params`` belong to the loaders and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

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


_QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_layer_dict(layers: dict, fn, fuse: bool) -> dict:
    """Quantize one layer dict (stacked or single-layer) by copy."""
    layers = dict(layers)
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
    return layers


_QUANTIZERS = {"int8": quantize_int8, "nf4": quantize_nf4,
               "fp4": quantize_fp4, "int4": quantize_int4}


def quantize_params(params: dict, kind: str = "int8",
                    quantize_lm_head: bool = True, fuse: bool = False) -> dict:
    """Quantize the layer projection weights (and the untied ``lm_head``)
    of a params dict; embeddings and norms stay dense. ``fuse=True``
    concatenates q/k/v into ``wqkv`` and gate/up into ``w_gateup`` first, so
    each runs as one kernel launch."""
    fn = _QUANTIZERS[kind]
    out = dict(params)
    out["layers"] = _quantize_layer_dict(params["layers"], fn, fuse)
    if quantize_lm_head and "lm_head" in params:
        out["lm_head"] = fn(params["lm_head"])
    return out
