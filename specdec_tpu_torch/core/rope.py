"""Rotary position embeddings, rotate-half convention
(counterpart of ``specdec_tpu/core/rope.py``), and the interleaved-pair
rotation and YaRN frequencies of deepseek_v2's latent attention.

Computed on the fly from integer positions, so per-sequence cache offsets
cost nothing extra."""
from __future__ import annotations

import math

import torch


def scaled_inv_freq(inv_freq: torch.Tensor, scaling: tuple) -> torch.Tensor:
    """Apply a rope_scaling spec (``ModelConfig.rope_scaling``) to the base
    inverse frequencies: ``()``, ``("linear", factor)`` or
    ``("llama3", factor, low_freq_factor, high_freq_factor, original_max)``
    (HF transformers' ``_compute_llama3_parameters``). ``rope_cos_sin``
    takes YaRN's, which need theta, itself."""
    if not scaling:
        return inv_freq
    kind = scaling[0]
    if kind == "linear":
        return inv_freq / scaling[1]
    if kind == "llama3":
        _, factor, low_ff, high_ff, orig_max = scaling
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = orig_max / low_ff
        high_wl = orig_max / high_ff
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        out = torch.where(wavelen > low_wl, inv_freq / factor, inv_freq)
        is_medium = (wavelen >= high_wl) & (wavelen <= low_wl)
        return torch.where(is_medium, smoothed, out)
    raise ValueError(f"unsupported rope_scaling kind: {kind!r}")


def _yarn_inv_freq(inv_freq: torch.Tensor, scaling: tuple,
                   theta: float) -> torch.Tensor:
    """YaRN's frequencies (HF transformers' ``_compute_yarn_parameters``,
    truncated correction range) for ``("yarn", factor, original_max,
    beta_fast, beta_slow, attention_factor)``: dimensions that rotate
    fewer than beta_slow times over the original context are interpolated
    by ``factor``, those that rotate more than beta_fast times are kept,
    and a linear ramp blends the ones between."""
    _, factor, orig_max, beta_fast, beta_slow, _ = scaling
    dim = 2 * inv_freq.shape[0]

    def correction_dim(rotations):
        return (dim * math.log(orig_max / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    j = torch.arange(dim // 2, dtype=torch.float32, device=inv_freq.device)
    keep = 1 - torch.clamp((j - low) / (high - low), 0, 1)
    return inv_freq / factor * (1 - keep) + inv_freq * keep


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's magnitude correction at context factor ``factor``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_attention_factor(factor: float, mscale: float = 0.0,
                          mscale_all_dim: float = 0.0) -> float:
    """The factor YaRN multiplies cos and sin by (HF's ``attention_factor``
    when the config gives none)."""
    if mscale and mscale_all_dim:
        return yarn_mscale(factor, mscale) / yarn_mscale(factor,
                                                         mscale_all_dim)
    return yarn_mscale(factor)


def rope_cos_sin(positions: torch.Tensor, rotary_dim: int, theta: float,
                 dtype=torch.float32, scaling: tuple = ()):
    """positions: [...] integer -> (cos, sin), each [..., rotary_dim]
    (YaRN's attention factor multiplied in)."""
    half = rotary_dim // 2
    j = torch.arange(half, dtype=torch.float32, device=positions.device)
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    inv_freq = torch.pow(base, -2.0 * j / rotary_dim)
    if scaling and scaling[0] == "yarn":
        inv_freq = _yarn_inv_freq(inv_freq, scaling, theta)
    else:
        inv_freq = scaled_inv_freq(inv_freq, scaling)
    angles = positions[..., None].to(torch.float32) * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if scaling and scaling[0] == "yarn" and scaling[5] != 1.0:
        cos, sin = cos * scaling[5], sin * scaling[5]
    return cos.to(dtype), sin.to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: int) -> torch.Tensor:
    """x: [..., H, Dh]; cos/sin: [..., rotary_dim]. Rotates the first
    ``rotary_dim`` features and passes the rest through (partial rotary)."""
    if rotary_dim == x.shape[-1]:
        rot, rest = x, None
    else:
        rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    x1, x2 = rot[..., :half], rot[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    out = (rot * cos + rotated * sin).to(x.dtype)
    if rest is not None:
        out = torch.cat([out, rest], dim=-1)
    return out


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """x: [..., H, R]; cos/sin: [..., R] as ``rope_cos_sin`` gives them.
    Rotates the interleaved pairs (x[2j], x[2j + 1]) by angle j, as a
    complex product (deepseek's ``apply_rotary_emb``), in float32."""
    half = x.shape[-1] // 2
    c = cos[..., None, :half]
    s = sin[..., None, :half]
    pair = x.to(torch.float32).reshape(*x.shape[:-1], half, 2)
    a, b = pair[..., 0], pair[..., 1]
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(
        x.shape).to(x.dtype)
