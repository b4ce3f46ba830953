"""EAGLE-style feature-predictor drafter
(counterpart of ``specdec_tpu/core/eagle.py``).

EAGLE (Li et al., 2024) drafts with a one-layer feature autoregressor that
rides on the target: from the target's hidden state at a position and the
embedding of the next token it predicts the target's hidden state at the
next position, and turns predicted features into draft distributions with
the target's own final norm and ``lm_head``.

- The drafter is the model's block stack (``core/model.py::_block``) over
  the slotted cache; its config is ``target_cfg.replace(num_layers=k)``
  (k = 1 for classic EAGLE).
- Fusion is one matmul over concat(embed, feature), ``fc_w`` [2D, D].
- Logits reuse the target's ``final_norm`` and ``lm_head`` (or tied
  embedding): under an INT4 target every drafter step launches the
  lm_head's weight kernel (K1a). The drafter's own layers and its fc are
  dense, as ``init_eagle_params`` makes them, so they are plain
  ``torch.matmul``.

Features are the pre-final-norm residual stream
(``core/model.py::forward_step_features``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import (
    _head, _layers, _positions, _tree_positions, init_params, slotted_attend,
)
from specdec_tpu_torch.quant.core import qmatmul

Params = Dict[str, Any]


def init_eagle_params(cfg: ModelConfig, seed: int = 0, scale: float = 0.02,
                      device=None,
                      generator: Optional[torch.Generator] = None) -> Params:
    """Random EAGLE drafter for a target of ``cfg``'s widths; its depth is
    ``cfg.num_layers`` (``target_cfg.replace(num_layers=1)`` for classic
    EAGLE). The fc starts as [random; I] over the (embed, feature) concat,
    identity on the feature half, so the untrained drafter echoes the
    target's own feature. Made on ``device`` (``None``: the card) from
    ``generator`` or ``seed``; the numbers differ from the JAX package's
    (tests carry JAX's head over with ``bridge.params_from_numpy``)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    D = cfg.hidden_size
    fc = torch.cat([
        torch.randn((D, D), generator=generator, dtype=torch.float32,
                    device=device) * scale,
        torch.eye(D, dtype=torch.float32, device=device),
    ], dim=0).to(cfg.dtype)
    base = init_params(cfg, scale=scale, device=device, generator=generator)
    return {"fc_w": fc,               # [2D, D]: rows 0..D embed, D..2D feature
            "fc_b": torch.zeros((D,), dtype=cfg.dtype, device=device),
            "layers": base["layers"]}


def _eagle_common(cfg: ModelConfig, eagle_params: Params,
                  target_params: Params, tokens: torch.Tensor,
                  feats: torch.Tensor, cache, q_pos: torch.Tensor, tree,
                  ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """The drafter body shared by the sequential and tree forwards: fc
    fusion over (embed, feature) pairs, the block stack over the slotted
    cache (written in place), and the target's final norm and head."""
    emb = target_params["embed"][tokens].to(cfg.dtype)
    x = torch.cat([emb, feats.to(cfg.dtype)], dim=-1)
    x = qmatmul(x, eagle_params["fc_w"]) + eagle_params["fc_b"]
    f_hat = _layers(cfg, eagle_params["layers"], x, q_pos,
                    slotted_attend(cfg, cache, q_pos, tree))
    return (_head(cfg, target_params, f_hat), f_hat,
            cache.with_length(cache.length + tokens.shape[1]))


def eagle_forward(cfg: ModelConfig, eagle_params: Params,
                  target_params: Params, tokens: torch.Tensor,
                  feats: torch.Tensor, cache,
                  ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """One drafter forward over a [B, T] block of (token, feature) pairs.

    Position j of the block pairs the target feature of sequence position
    ``q_pos[j]`` with the token at ``q_pos[j] + 1``; ``f_hat[:, j]``
    predicts the target's feature at ``q_pos[j] + 1`` and ``logits[:, j]``
    its distribution for the token at ``q_pos[j] + 2``. tokens [B, T];
    feats [B, T, D]; cache: the drafter's slotted cache. Returns (logits
    [B, T, V] f32, f_hat [B, T, D], the cache advanced by T)."""
    q_pos = _positions(cache, tokens.shape[1])
    return _eagle_common(cfg, eagle_params, target_params, tokens, feats,
                         cache, q_pos, None)


def eagle_forward_tree(cfg: ModelConfig, eagle_params: Params,
                       target_params: Params, tokens: torch.Tensor,
                       feats: torch.Tensor, cache, depths: torch.Tensor,
                       tree_mask: torch.Tensor,
                       tree_start: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Tree-structured drafter forward: the N (token, parent-feature) pairs
    are tree nodes. Node j's rope position is ``tree_start + depths[j]``
    and it attends to the cache prefix and its tree ancestors only, the
    contract of ``core.model.forward_step_tree``. Returns (logits
    [B, N, V] f32, f_hat [B, N, D], the cache advanced by N)."""
    start, q_pos = _tree_positions(cache, depths, tree_start)
    return _eagle_common(cfg, eagle_params, target_params, tokens, feats,
                         cache, q_pos, (start, tree_mask))
