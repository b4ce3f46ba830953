"""EAGLE drafter training: teacher-forced feature regression and
distillation (counterpart of ``specdec_tpu/engine/eagle_train.py``).

Trains the fc and block stack of ``core/eagle.py`` against a frozen
target, with the EAGLE recipe's two terms:

- regression: smooth-L1 between the predicted feature f_hat_{j+1} and the
  target's feature f_{j+1}, in units of the target's per-position RMS
  (computed without gradient), so the term is O(1) on any target;
- classification: cross-entropy of the head's distribution (the target's
  shared final norm and ``lm_head`` over f_hat) against the target's
  distribution at the same position.

``rollout_steps > 1`` adds HASS-style multi-step alignment (Zhang et al.,
2024): pass k >= 2 feeds back the previous pass's predicted features
(detached, cast to the features' dtype). Every pass starts at cache
position 0 of a fresh cache: rope attention depends only on position
differences, so the uniform shift is exact, while an offset cache would
leave k-1 unwritten zero K/V slots below the block that every query
attends to.

On a quantized target the head's logits go through the target's quantized
``lm_head``: its weight kernel runs the forward (K1a on INT4, at M =
B·(L-k) rows), and ``ops/quant_matmul.py``'s autograd Function gives the
features their gradient. The teacher's forward (K1b and K1a at M = B·L)
runs under ``torch.no_grad()``. ``train_eagle`` is
``optax.adam(cosine_decay_schedule(lr, steps, alpha=0.1))``, no clipping
(``engine/optim.py``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.eagle import eagle_forward
from specdec_tpu_torch.core.model import forward_step_features
from specdec_tpu_torch.engine.distill import (
    on_policy_sampler, proxy_generator,
)
from specdec_tpu_torch.engine.optim import (
    Adam, cosine_decay, frozen, trainable, value_and_grad,
)


@torch.no_grad()
def teacher_feats_probs(t_cfg: ModelConfig, target_params,
                        tokens: torch.Tensor):
    """(features [B, L, D], probs [B, L, V] f32) of a full-sequence target
    forward."""
    B, L = tokens.shape
    cache = init_cache(t_cfg, B, L, device=tokens.device)
    logits, feats, _ = forward_step_features(t_cfg, target_params, tokens,
                                             cache)
    return feats, torch.softmax(logits, dim=-1)


def _smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _eagle_loss(cfg: ModelConfig, eagle_params, target_params, tokens,
                feats, probs, cls_weight: float, rollout_steps: int):
    """(reg + cls_weight * cls, (reg, cls)) over pairs (f_j, t_{j+1}) ->
    (f_{j+1}, p_{j+1}), unrolled ``rollout_steps`` times onto the head's
    own predicted features."""
    B, L = tokens.shape
    total_reg = 0.0
    total_cls = 0.0
    f_in = feats[:, :-1]
    for k in range(1, rollout_steps + 1):
        cache = init_cache(cfg, B, L - k, device=tokens.device)
        logits, f_hat, _ = eagle_forward(cfg, eagle_params, target_params,
                                         tokens[:, k:], f_in, cache)
        f_true = feats[:, k:].to(torch.float32)
        rms = torch.sqrt(torch.mean(f_true * f_true, dim=-1, keepdim=True)
                         + 1e-6).detach()
        total_reg = total_reg + torch.mean(_smooth_l1(
            (f_hat.to(torch.float32) - f_true) / rms))
        logq = torch.log_softmax(logits, dim=-1)
        total_cls = total_cls - torch.mean(
            torch.sum(probs[:, k:] * logq, dim=-1))
        f_in = f_hat[:, :-1].detach().to(feats.dtype)
    reg = total_reg / rollout_steps
    cls = total_cls / rollout_steps
    return reg + cls_weight * cls, (reg, cls)


def _eagle_loss_and_grad(cfg: ModelConfig, eagle_params, target_params,
                         tokens, feats, probs, cls_weight: float = 0.1,
                         rollout_steps: int = 1):
    """(loss, (reg, cls), grads) for ``eagle_params`` from
    ``optim.trainable``; tokens [B, L], feats/probs from
    ``teacher_feats_probs``. No gradient reaches the target's params."""
    return value_and_grad(
        lambda ep: _eagle_loss(cfg, ep, target_params, tokens, feats, probs,
                               cls_weight, rollout_steps), eagle_params)


@torch.no_grad()
def eagle_acceptance_proxy(t_cfg: ModelConfig, eagle_cfg: ModelConfig,
                           eagle_params, target_params, tokens
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean sum min(p, q), argmax agreement) under TEACHER-FORCED
    features: an upper bound of rollout acceptance (later draft steps
    condition on predicted features, which drift)."""
    B, L = tokens.shape
    feats, probs = teacher_feats_probs(t_cfg, target_params, tokens)
    cache = init_cache(eagle_cfg, B, L - 1, device=tokens.device)
    logits, _, _ = eagle_forward(eagle_cfg, eagle_params, target_params,
                                 tokens[:, 1:], feats[:, :-1], cache)
    q = torch.softmax(logits, dim=-1)
    p = probs[:, 1:]
    acc = torch.mean(torch.sum(torch.minimum(p, q), dim=-1))
    agree = torch.mean((p.argmax(-1) == q.argmax(-1)).to(torch.float32))
    return acc, agree


def train_eagle(
    t_cfg: ModelConfig, target_params,
    eagle_cfg: ModelConfig, eagle_params,
    steps: int = 300,
    batch_size: int = 8,
    seq_len: int = 128,
    learning_rate: float = 1e-3,
    cls_weight: float = 0.1,
    rollout_steps: int = 1,
    batch_sampler: Optional[Callable[[torch.Generator],
                                     torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    device=None,
    log_every: int = 0,
    log_fn=print,
):
    """Returns (the trained head's params, none requiring grad; the final
    teacher-forced acceptance proxy). ``eagle_cfg`` is
    ``t_cfg.replace(num_layers=<depth>)``; the target stays frozen and the
    caller's head is not changed. Batches come from ``batch_sampler``
    (default: ``on_policy_sampler``) fed by ``generator`` (or a new one
    seeded with ``seed`` on ``device``, ``None``: the card)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    eagle_params = trainable(eagle_params)
    # cosine decay to 0.1x: constant-rate adam oscillates near convergence
    opt = Adam(eagle_params, cosine_decay(learning_rate, max(steps, 1),
                                          alpha=0.1))
    if batch_sampler is None:
        batch_sampler = on_policy_sampler(t_cfg, target_params,
                                          batch_size=batch_size,
                                          seq_len=seq_len, device=device)

    for i in range(steps):
        tokens = batch_sampler(generator)
        feats, probs = teacher_feats_probs(t_cfg, target_params, tokens)
        loss, (reg, cls), grads = _eagle_loss_and_grad(
            eagle_cfg, eagle_params, target_params, tokens, feats, probs,
            cls_weight=cls_weight, rollout_steps=rollout_steps)
        opt.step(grads)
        del grads
        if log_every and i % log_every == 0:
            acc, agree = eagle_acceptance_proxy(
                t_cfg, eagle_cfg, eagle_params, target_params,
                batch_sampler(proxy_generator(device)))
            log_fn(f"eagle step {i}: loss={float(loss):.4f} "
                   f"reg={float(reg):.4f} cls={float(cls):.4f} "
                   f"acceptance_proxy={float(acc):.3f} "
                   f"argmax_agree={float(agree):.3f}")

    eagle_params = frozen(eagle_params)
    acc, _ = eagle_acceptance_proxy(t_cfg, eagle_cfg, eagle_params,
                                    target_params,
                                    batch_sampler(proxy_generator(device)))
    return eagle_params, float(acc)
