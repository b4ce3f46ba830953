"""Shared helpers for the decode loops
(counterpart of ``specdec_tpu/sampling/utils.py``)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def max_fn(x: torch.Tensor) -> torch.Tensor:
    """Residual distribution norm(max(x, 0)); zero mass gives zeros, and
    callers then fall back to the target distribution."""
    pos = torch.clamp_min(x, 0.0)
    total = pos.sum(dim=-1, keepdim=True)
    return pos / torch.clamp_min(total, 1e-38)


def residual_mass(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(p - q, 0.0).sum(dim=-1)


def eos_mask(tokens: torch.Tensor, eos_ids: Tuple[int, ...]) -> torch.Tensor:
    """Boolean mask of which tokens are in the (static) EOS set."""
    if not eos_ids:
        return torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    mask = tokens == eos_ids[0]
    for e in eos_ids[1:]:
        mask = mask | (tokens == e)
    return mask


def pad_to_bucket(ids: Sequence[int], pad_id: int, bucket: int = 64):
    """Right-pad a prompt to the next multiple of ``bucket`` (so the prefill
    shapes repeat across prompt lengths). Returns (int64 CPU tensor, n)."""
    n = len(ids)
    padded_len = max(bucket, ((n + bucket - 1) // bucket) * bucket)
    out = torch.full((padded_len,), pad_id, dtype=torch.int64)
    out[:n] = torch.as_tensor(list(ids), dtype=torch.int64)
    return out, n


def normalize_eos(eos_tokens_id) -> Tuple[int, ...]:
    if eos_tokens_id is None:
        return ()
    if isinstance(eos_tokens_id, int):
        return (eos_tokens_id,)
    return tuple(int(t) for t in eos_tokens_id)


def stable_top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries over the last axis, in
    descending order, equal values in ascending index order: the order of
    ``lax.top_k``. A stable sort, where ``torch.topk`` leaves the order of
    ties unspecified."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def prefill_generator(generator: torch.Generator) -> torch.Generator:
    """A generator of its own for a prefill's draws, seeded by one draw
    from ``generator`` (a host read), so the prefill's samples and the
    windows' come from separate streams: the counterpart of the JAX
    package's prefill key, ``fold_in(key, 2**31 - 1)``, which no window's
    key can equal."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    return torch.Generator(device=generator.device).manual_seed(seed)
