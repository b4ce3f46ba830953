"""Weight-only INT4 quantization (counterpart of the INT4 part of
``specdec_tpu/quant/core.py``).

Storage is bit-identical to the JAX package's, so containers bridge through
plain numpy views and the packed words can be compared bit for bit:

- ``packed``: int32 words ``[..., K/8, N]`` in the PAIR4 layout — word ``r``,
  bits ``[4p + 16h, +4)``, hold the code for ``k = p*K/4 + 2r + h``;
- ``absmax``: bf16 ``[..., K/64, N]`` (block absmax / 7), stored
  block-major (natural block ``g = p*(G/4) + b`` at row ``b*4 + p``) when
  ``G = K/64`` is a multiple of 4, natural order otherwise.

INT8, NF4 and FP4 wait for their kernels (K6, K7) and raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

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


def _pack_nibbles(code: torch.Tensor) -> torch.Tensor:
    """codes [..., K, N] (0..15) -> int32 words [..., K/8, N], pair4 layout.

    The words are assembled in int64 and wrapped to int32 explicitly: a word
    whose (p=3, h=1) code is >= 8 has bit 31 set and must come out as the
    same negative int32 the JAX package stores."""
    *lead, K, N = code.shape
    if K % 8 != 0:
        raise ValueError(f"K={K} is not a multiple of 8")
    c = code.to(torch.int64).reshape(*lead, 4, K // 8, 2, N)
    words = (c << _pair_shifts(len(lead), code.device)).sum(dim=(-4, -2))
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """int32 words [..., K8, N] -> codes [..., K8*8, N] int32."""
    *lead, K8, N = packed.shape
    p = packed[..., None, :, None, :]
    codes = (p >> _pair_shifts(len(lead), packed.device).to(torch.int32)) & 0xF
    return codes.reshape(*lead, K8 * 8, N)


@dataclasses.dataclass
class Int4Weight:
    """w[k, n] ≈ (code(k, n) − 8) * absmax[k // 64, n]  (absmax is the
    block absmax pre-divided by 7); see the module docstring for layout."""

    packed: torch.Tensor
    absmax: torch.Tensor


def quantize_int4(w: torch.Tensor) -> Int4Weight:
    """Blockwise symmetric INT4: q = clip(round(w/absmax·7), −7, 7) + 8.
    Stacked weights are quantized one slice at a time (bounded transient
    memory), as in the JAX package."""
    if w.ndim >= 3:
        slices = [quantize_int4(w[i]) for i in range(w.shape[0])]
        return Int4Weight(packed=torch.stack([s.packed for s in slices]),
                          absmax=torch.stack([s.absmax for s in slices]))
    w = w.to(torch.float32)
    *lead, K, N = w.shape
    if K % NF4_BLOCK != 0:
        raise ValueError(f"K={K} not divisible by {NF4_BLOCK}")
    blocks = w.reshape(*lead, K // NF4_BLOCK, NF4_BLOCK, N)
    absmax = blocks.abs().amax(dim=-2)
    stored, denom = _bf16_scale(absmax, 7.0)
    q = torch.round(blocks / torch.clamp_min(denom[..., None, :], 1e-12) * 7.0)
    code = (torch.clamp(q, -7, 7) + 8).reshape(*lead, K, N)
    return Int4Weight(packed=_pack_nibbles(code), absmax=_am_pack(stored))


def _int4_decode(code: torch.Tensor) -> torch.Tensor:
    """4-bit symmetric code -> float value on the ±7 grid."""
    return (code.to(torch.int32) - 8).to(torch.float32)


def dequantize(w: Any, dtype=torch.float32) -> torch.Tensor:
    """Materialize a weight (reference path and test oracle)."""
    if isinstance(w, Int4Weight):
        vals = _int4_decode(_unpack_nibbles(w.packed))
        *lead, K, N = vals.shape
        scaled = vals.reshape(*lead, K // NF4_BLOCK, NF4_BLOCK, N) * \
            _am_unpack(w.absmax).to(torch.float32)[..., None, :]
        return scaled.reshape(*lead, K, N).to(dtype)
    return torch.as_tensor(w).to(dtype)


@dataclasses.dataclass
class StackedSlice:
    """Layer ``idx`` of a STACKED [L, ...] 4-bit container. ``qmatmul``
    hands the whole stack and the index to the kernel, which reads the
    layer in place: no layer's weights are copied."""

    container: Int4Weight
    idx: int


def qmatmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for dense or INT4 w (INT4 goes through ops/quant_matmul)."""
    if isinstance(w, StackedSlice):
        from specdec_tpu_torch.ops.quant_matmul import quant_matmul_stacked
        return quant_matmul_stacked(x, w.container, w.idx)
    if isinstance(w, Int4Weight):
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


def quantize_params(params: dict, kind: str = "int8",
                    quantize_lm_head: bool = True, fuse: bool = False) -> dict:
    """Quantize the layer projection weights (and the untied ``lm_head``)
    of a params dict; embeddings and norms stay dense. ``fuse=True``
    concatenates q/k/v into ``wqkv`` and gate/up into ``w_gateup`` first, so
    each runs as one kernel launch."""
    if kind != "int4":
        raise NotImplementedError(
            f"quantize_params(kind={kind!r}): only int4 is ported; int8, "
            "nf4 and fp4 wait for their kernels")
    out = dict(params)
    out["layers"] = _quantize_layer_dict(params["layers"], quantize_int4, fuse)
    if quantize_lm_head and "lm_head" in params:
        out["lm_head"] = quantize_int4(params["lm_head"])
    return out
