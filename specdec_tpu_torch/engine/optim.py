"""What the trainers share (``engine/pretrain.py``, ``engine/distill.py``,
``engine/eagle_train.py``): parameter trees as leaves that take a gradient,
``value_and_grad`` over them, and optax's Adam on ``torch.optim``.

The JAX trainers differentiate pure functions of a params pytree with
``jax.value_and_grad`` and update them with optax, returning new arrays.
Here a trainer copies the caller's tree into fresh leaves that require
grad (``trainable``; the caller's tensors are never updated), takes the
gradient with ``torch.autograd.grad`` (``value_and_grad``, the tree's
shape kept), steps them in place with ``Adam`` and returns them detached
(``frozen``), so a decode loop after training builds no graph. Only dense
leaves train: a quantized container has no gradient in either package.

``Adam`` is ``torch.optim.AdamW`` held to optax's semantics, which differ
from ``torch.optim``'s defaults in three places:

- the learning rate is ``schedule(count)`` at the count BEFORE the update
  (optax's ``scale_by_learning_rate`` over a schedule): the first update
  uses ``schedule(0)``;
- optax's ``adamw`` decays every leaf by 1e-4 by default (torch 1e-2),
  decoupled, as torch's AdamW does; ``adam`` decays nothing;
- ``clip_by_global_norm(max_norm)`` scales the gradients by max_norm / norm
  only where norm >= max_norm (``torch.nn.utils.clip_grad_norm_`` divides
  by norm + 1e-6 always), with the norm cast to each gradient's dtype.

b1 = 0.9, b2 = 0.999, eps = 1e-8 (eps outside the square root, as both
packages place it). The moments are zeros of each parameter's dtype, as
optax's ``zeros_like`` makes them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch

from specdec_tpu_torch.quant.core import QUANTIZED

Params = Dict[str, Any]


def leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a nested dict, keys in sorted order (JAX's order for
    dict pytrees). Raises on a quantized container: it cannot train."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out.extend(leaves(v))
        elif isinstance(v, QUANTIZED):
            raise TypeError(f"{key}: a {type(v).__name__} cannot be trained; "
                            "train dense parameters")
        else:
            out.append(v)
    return out


def tree_map(fn: Callable, tree: Params) -> Params:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def unflatten_like(tree: Params, flat: List[Any]) -> Params:
    """``flat`` (in ``leaves`` order) in the shape of ``tree``."""
    it = iter(flat)

    def fill(t):
        return {k: fill(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}
    return fill(tree)


def trainable(params: Params) -> Params:
    """A copy of ``params`` whose every (dense) leaf is a new tensor that
    requires grad; the caller's tensors stay as they were."""
    leaves(params)  # refuse quantized containers first
    return tree_map(lambda t: t.detach().clone().requires_grad_(True),
                    params)


def frozen(params: Params) -> Params:
    """``params`` detached: no leaf requires grad."""
    return tree_map(lambda t: t.detach(), params)


def value_and_grad(loss_fn: Callable, params: Params):
    """(loss, aux, grads): ``loss_fn(params)`` returns (a scalar loss, aux),
    ``params`` from ``trainable``; grads has the tree's shape (zeros for a
    leaf the loss does not reach, as JAX gives). loss and aux come back
    detached."""
    loss, aux = loss_fn(params)
    flat = leaves(params)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    aux = tuple(a.detach() for a in aux)
    return loss.detach(), aux, unflatten_like(params, grads)


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: g / norm * max_norm where the global
    norm (summed in float32) is at least ``max_norm``, g otherwise. The
    choice stays on the device: no host read."""
    norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
            for g in grads]


def constant(lr: float) -> Callable[[int], float]:
    return lambda count: lr


def linear_warmup(lr: float, warmup: int) -> Callable[[int], float]:
    """``optax.linear_schedule(0, lr, warmup)`` below ``warmup``, then
    ``lr``: 0 at count 0."""
    return lambda count: lr * count / warmup if count < warmup else lr


def cosine_decay(lr: float, decay_steps: int,
                 alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(lr, decay_steps, alpha)``."""
    def schedule(count):
        c = min(count, decay_steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c
                                                        / decay_steps))
                     + alpha)
    return schedule


class Adam:
    """optax's ``adam`` (``weight_decay=0``) or ``adamw``, optionally after
    ``clip_by_global_norm(clip_norm)``, on the leaves of ``params`` (from
    ``trainable``); ``schedule(count)`` gives each update's learning
    rate."""

    def __init__(self, params: Params, schedule: Callable[[int], float],
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None):
        self.params = leaves(params)
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)

    def step(self, grads: Params) -> None:
        """One update with ``grads`` (a tree of ``params``'s shape)."""
        flat = leaves(grads)
        if self.clip_norm is not None:
            flat = clip_by_global_norm(flat, self.clip_norm)
        for p, g in zip(self.params, flat):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        for p in self.params:
            p.grad = None
        self.count += 1
