"""Drafter distillation: fit a small drafter to a target's token
distribution (counterpart of ``specdec_tpu/engine/distill.py``).

The acceptance rate under multinomial sampling is ``E[sum_x min(p, q)] =
1 - TV(p, q)``, so KL distillation optimizes acceptance directly. This runs
teacher-forced KL distillation on token batches (a caller's sampler, the
target's own samples from ``on_policy_sampler``, or uniform tokens), the
teacher's probabilities computed once per batch under ``torch.no_grad()``.

``distill_drafter`` is ``optax.adam(lr)`` at a constant rate
(``engine/optim.py``). On-policy sampling runs the target's decode step,
one token at a time, eagerly: on an INT4 target that is K1b at M = B for
every projection and K1a for the ``lm_head``. JAX draws each token with
``jax.random.categorical`` at temperature 1; the port draws from the same
softmax with ``torch.multinomial`` and the caller's generator.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_full, forward_step
from specdec_tpu_torch.engine.optim import (
    Adam, constant, frozen, trainable, value_and_grad,
)

# the seed of the batch every acceptance proxy is measured on, as in JAX
PROXY_SEED = 10_007


@torch.no_grad()
def teacher_probs(t_cfg: ModelConfig, target_params,
                  tokens: torch.Tensor) -> torch.Tensor:
    return torch.softmax(forward_full(t_cfg, target_params, tokens), -1)


def _kl_loss(d_cfg: ModelConfig, drafter_params, tokens, p_t):
    logq = torch.log_softmax(forward_full(d_cfg, drafter_params, tokens), -1)
    return -torch.mean(torch.sum(p_t * logq, dim=-1))


def _kl_loss_and_grad(d_cfg: ModelConfig, drafter_params, tokens, p_t):
    """(loss, grads) for ``drafter_params`` from ``optim.trainable``."""
    loss, _, grads = value_and_grad(
        lambda dp: (_kl_loss(d_cfg, dp, tokens, p_t), ()), drafter_params)
    return loss, grads


@torch.no_grad()
def acceptance_proxy(t_cfg: ModelConfig, target_params, d_cfg: ModelConfig,
                     drafter_params, tokens
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean sum min(p, q) = expected multinomial acceptance, argmax
    agreement)."""
    p = teacher_probs(t_cfg, target_params, tokens)
    q = torch.softmax(forward_full(d_cfg, drafter_params, tokens), -1)
    acc = torch.mean(torch.sum(torch.minimum(p, q), dim=-1))
    agree = torch.mean((p.argmax(-1) == q.argmax(-1)).to(torch.float32))
    return acc, agree


@torch.no_grad()
def _sample_on_policy(t_cfg: ModelConfig, target_params,
                      generator: torch.Generator, batch_size: int,
                      seq_len: int, device=None) -> torch.Tensor:
    """[B, L] int64 token batches sampled FROM the target (temperature-1
    multinomial, one random start token per row)."""
    device = resolve_device(device)
    V = t_cfg.vocab_size
    cache = init_cache(t_cfg, batch_size, seq_len + 1, device=device)
    tok = torch.randint(1, V, (batch_size, 1), generator=generator,
                        device=device)
    toks = [tok]
    for _ in range(seq_len - 1):
        logits, cache = forward_step(t_cfg, target_params, tok, cache)
        tok = torch.multinomial(torch.softmax(logits[:, 0], dim=-1), 1,
                                generator=generator)
        toks.append(tok)
    return torch.cat(toks, dim=1)


def on_policy_sampler(t_cfg: ModelConfig, target_params,
                      batch_size: int = 8, seq_len: int = 128, device=None):
    """Batch sampler for ``distill_drafter`` and ``train_eagle`` drawing
    sequences from the TARGET itself: speculative decoding only conditions
    the drafter on tokens the target committed, so on-policy batches train
    the deployed quantity."""
    def sampler(generator: torch.Generator) -> torch.Tensor:
        return _sample_on_policy(t_cfg, target_params, generator,
                                 batch_size, seq_len, device)
    return sampler


def proxy_generator(device) -> torch.Generator:
    """The generator of the proxy's batch (JAX's ``key(10_007)``)."""
    return torch.Generator(device=device).manual_seed(PROXY_SEED)


def distill_drafter(
    t_cfg: ModelConfig, target_params,
    d_cfg: ModelConfig, drafter_params,
    steps: int = 300,
    batch_size: int = 8,
    seq_len: int = 128,
    learning_rate: float = 3e-4,
    batch_sampler: Optional[Callable[[torch.Generator],
                                     torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    device=None,
    log_every: int = 0,
    log_fn=print,
):
    """Returns (the distilled drafter params, none requiring grad; the final
    acceptance proxy). The drafter must be dense; the caller's params are
    not changed. ``generator`` (or a new one seeded with ``seed`` on
    ``device``, ``None``: the card) feeds the sampler, uniform tokens in
    [1, V) by default."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    drafter_params = trainable(drafter_params)
    opt = Adam(drafter_params, constant(learning_rate))

    if batch_sampler is None:
        V = t_cfg.vocab_size

        def batch_sampler(g):
            return torch.randint(1, V, (batch_size, seq_len), generator=g,
                                 device=device)

    for i in range(steps):
        tokens = batch_sampler(generator)
        p_t = teacher_probs(t_cfg, target_params, tokens)
        loss, grads = _kl_loss_and_grad(d_cfg, drafter_params, tokens, p_t)
        opt.step(grads)
        del grads
        if log_every and i % log_every == 0:
            acc, agree = acceptance_proxy(
                t_cfg, target_params, d_cfg, drafter_params,
                batch_sampler(proxy_generator(device)))
            log_fn(f"distill step {i}: loss={float(loss):.4f} "
                   f"acceptance_proxy={float(acc):.3f} "
                   f"argmax_agree={float(agree):.3f}")

    drafter_params = frozen(drafter_params)
    acc, _ = acceptance_proxy(t_cfg, target_params, d_cfg, drafter_params,
                              batch_sampler(proxy_generator(device)))
    return drafter_params, float(acc)
