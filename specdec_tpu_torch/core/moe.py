"""DeepSeekMoE's expert layer (deepseek_v2): a float32 router, greedy
top-k, routed experts through the grouped INT4 kernel, shared experts
through K1, and a weighted combine. No step of it reads the device from
the host.

- ``route``: the router's logits in float32 over all experts, a softmax,
  the ``num_experts_per_tok`` largest probabilities times
  ``routed_scaling_factor``, as DeepSeek's ``MoEGate`` does with
  ``topk_method="greedy"`` and ``norm_topk_prob`` false.
- ``moe_layer``: the token-expert assignments sorted by expert on the
  device (a stable sort of the expert ids, the counts by ``scatter_add_``
  and their prefix sums: ``torch.bincount`` would read its maximum back);
  one launch of ``ops/expert_matmul.py::int4_expert_matmul`` for every
  expert's fused gate/up, reading each token through the sorted index, and
  one for their down projections; the outputs put back in (token, slot)
  order and summed with their weights in float32, cast to the activation
  type, plus the shared experts' SwiGLU.

Layer keys: ``router`` (dense [D, E]), ``experts_gateup`` (or
``experts_gate`` and ``experts_up``) and ``experts_down``, stacks
[E, in, out] with each expert quantized alone (``quant/core.py``), and
``shared_gateup`` (or ``shared_gate``, ``shared_up``) and
``shared_down``. Dense expert stacks (a loader's unquantized params) run
expert by expert in plain products, which read the counts back: they
serve the CPU tests and references.

While the tracer is on, each layer records ``moe_route``: the rows routed
(tokens times experts a token), then on the device the most rows any
expert got and the experts given at least one row.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from specdec_tpu_torch.ops.expert_matmul import (
    int4_expert_matmul, per_expert,
)
from specdec_tpu_torch.quant.core import Int4Weight, concat_columns, qmatmul
from specdec_tpu_torch.utils.profiling import TRACER


def route(cfg, x: torch.Tensor, router: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [R, D] -> (weights f32 [R, k], expert ids int64 [R, k])."""
    probs = torch.softmax(x.to(torch.float32) @ router.to(torch.float32),
                          dim=-1)
    w, idx = probs.topk(cfg.num_experts_per_tok, dim=-1)
    return w * cfg.routed_scaling_factor, idx


def _gateup(lp: Dict[str, Any], prefix: str):
    """The fused gate/up of ``prefix`` (or its two halves, concatenated)."""
    fused = lp.get(f"{prefix}_gateup")
    if fused is not None:
        return fused
    return concat_columns([lp[f"{prefix}_gate"], lp[f"{prefix}_up"]])


def _expert_mm(x: torch.Tensor, w, offsets: torch.Tensor, rows):
    """Assignment j (sorted by expert) through its expert's matrix."""
    if isinstance(w, Int4Weight):
        return int4_expert_matmul(x, w, offsets, rows)
    return per_expert(x, offsets, rows, w.shape[-1], x.dtype,
                      lambda xe, e: torch.matmul(xe, w[e].to(xe.dtype)))


def _swiglu(h: torch.Tensor) -> torch.Tensor:
    half = h.shape[-1] // 2
    return F.silu(h[..., :half]) * h[..., half:]


def moe_layer(cfg, lp: Dict[str, Any], m: torch.Tensor) -> torch.Tensor:
    """The expert layer over m [B, T, D] (the post-attention norm's
    output); returns [B, T, D] in m's dtype."""
    B, T, D = m.shape
    x = m.reshape(-1, D)
    k, E = cfg.num_experts_per_tok, cfg.n_routed_experts
    w, idx = route(cfg, x, lp["router"])
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(E, dtype=torch.int32, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    if TRACER.on:
        TRACER.record("moe_route", flat.shape[0],
                      torch.stack([counts.max().to(torch.int64),
                                   (counts > 0).sum()]))
    rows = (order // k).to(torch.int32)
    h = _expert_mm(x, _gateup(lp, "experts"), offsets, rows)
    y = _expert_mm(_swiglu(h), lp["experts_down"], offsets, None)
    back = torch.empty_like(y)
    back[order] = y
    routed = (back.view(-1, k, D).to(torch.float32) * w[..., None]).sum(
        dim=1).to(m.dtype)
    shared = qmatmul(_swiglu(qmatmul(x, _gateup(lp, "shared"))),
                     lp["shared_down"])
    return (routed + shared).reshape(B, T, D)
