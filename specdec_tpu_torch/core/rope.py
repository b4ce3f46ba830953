"""Rotary position embeddings, rotate-half convention
(counterpart of ``specdec_tpu/core/rope.py``).

Computed on the fly from integer positions, so per-sequence cache offsets
cost nothing extra."""
from __future__ import annotations

import math

import torch


def scaled_inv_freq(inv_freq: torch.Tensor, scaling: tuple) -> torch.Tensor:
    """Apply a rope_scaling spec (``ModelConfig.rope_scaling``) to the base
    inverse frequencies: ``()``, ``("linear", factor)`` or
    ``("llama3", factor, low_freq_factor, high_freq_factor, original_max)``
    (HF transformers' ``_compute_llama3_parameters``)."""
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


def rope_cos_sin(positions: torch.Tensor, rotary_dim: int, theta: float,
                 dtype=torch.float32, scaling: tuple = ()):
    """positions: [...] integer -> (cos, sin), each [..., rotary_dim]."""
    half = rotary_dim // 2
    j = torch.arange(half, dtype=torch.float32, device=positions.device)
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    inv_freq = torch.pow(base, -2.0 * j / rotary_dim)
    inv_freq = scaled_inv_freq(inv_freq, scaling)
    angles = positions[..., None].to(torch.float32) * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


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
