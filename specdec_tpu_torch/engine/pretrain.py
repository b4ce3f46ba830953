"""Structured synthetic language and LM pretraining: a target that has
learned something (counterpart of ``specdec_tpu/engine/pretrain.py``).

Random-weight ``synthetic:`` targets serve throughput and acceptance
mechanics, but a feature drafter cannot learn an 18-layer random map
(their EAGLE acceptance is ~0). This module builds the arena where
drafters can be compared: a hashed-state Markov stream whose per-token
entropy is known exactly, and ``train_lm``, which trains any
``core/model.py`` config on it.

``MarkovSpec`` is a copy of the JAX class: its tables, hash coefficients,
states and entropy come from numpy's ``default_rng`` seeded by
``zlib.crc32`` and equal JAX's bit for bit. States are computed in int32
arithmetic that wraps, as JAX's int32 arrays compute them (``b * t1``
overflows int32 at a full-size vocabulary). The stream's draws come from a
``torch.Generator``, so a port batch matches a JAX batch in distribution
only.

``train_lm`` is ``optax.chain(clip_by_global_norm(1.0), adamw(lr_fn))``:
AdamW with optax's default weight decay 1e-4 and a linear warmup from 0
(``engine/optim.py``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step, init_params
from specdec_tpu_torch.engine.optim import (
    Adam, frozen, linear_warmup, trainable, value_and_grad,
)


def _wrap_int32(x):
    """An int64 value (numpy array, tensor or int) wrapped to int32's range,
    as int32 arithmetic leaves it."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _int64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return np.asarray(x).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class MarkovSpec:
    """Hashed order-1/2 Markov stream over [1, vocab) (0 stays a pad id).

    Order 1 hashes the last token into the state, so the state is a
    function of the token a drafter receives and the arena is fair to every
    drafter family; order 2 also needs bits of the token before, which a
    target's final feature need not keep (adversarial to feature
    drafters)."""

    vocab_size: int
    num_states: int = 4096
    branching: int = 8          # K successors per state
    zipf_s: float = 1.2         # successor weights ∝ (i+1)^-s
    order: int = 2
    seed: int = 0

    @property
    def entropy_nats(self) -> float:
        """Exact per-token conditional entropy of the stream."""
        w = (np.arange(1, self.branching + 1, dtype=np.float64)
             ** -self.zipf_s)
        p = w / w.sum()
        return float(-(p * np.log(p)).sum())

    def tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(successors [H, K] int32 in [1, V), logp [K] f32), on the CPU."""
        rng = np.random.default_rng(
            zlib.crc32(f"markov:{self.seed}".encode()))
        succ = rng.integers(1, self.vocab_size,
                            size=(self.num_states, self.branching),
                            dtype=np.int32)
        w = (np.arange(1, self.branching + 1, dtype=np.float64)
             ** -self.zipf_s)
        logp = np.log(w / w.sum()).astype(np.float32)
        return torch.from_numpy(succ), torch.from_numpy(logp)

    def hash_coeffs(self) -> Tuple[int, int, int]:
        rng = np.random.default_rng(
            zlib.crc32(f"markov-hash:{self.seed}".encode()))
        a, b, c = rng.integers(1, 2 ** 20, size=3)
        return int(a) * 2 + 1, int(b) * 2 + 1, int(c)

    def state(self, t2, t1):
        """State id of the trailing tokens (t2 ignored at order 1), for
        numpy arrays and tensors alike (int64 out). Order 2 is
        bucket(t1) x (t2 mod 16): learnable at scale, while predicting
        step j+2 still needs 4 bits of t_j."""
        a, b, c = self.hash_coeffs()
        h = _wrap_int32(b * _int64(t1) + c)
        if self.order == 1:
            return h % self.num_states
        R = min(16, self.num_states)
        return (h % (self.num_states // R)) * R + _int64(t2) % R


def markov_sampler(spec: MarkovSpec, batch_size: int, seq_len: int,
                   device=None) -> Callable[[torch.Generator], torch.Tensor]:
    """sampler(generator) -> [B, L] int64 token batches from the stream, on
    ``device`` (``None``: the card); ``generator`` must live there. Two
    random start tokens, then each successor's rank drawn from the Zipf
    weights."""
    device = resolve_device(device)
    succ, logp = spec.tables()
    succ = succ.to(device=device, dtype=torch.int64)
    probs = logp.exp().to(device).expand(batch_size, spec.branching)

    def sampler(generator: torch.Generator) -> torch.Tensor:
        t2 = torch.randint(1, spec.vocab_size, (batch_size,),
                           generator=generator, device=device)
        t1 = torch.randint(1, spec.vocab_size, (batch_size,),
                           generator=generator, device=device)
        rank = torch.multinomial(probs, seq_len - 2, replacement=True,
                                 generator=generator)
        toks = [t2, t1]
        for j in range(seq_len - 2):
            nxt = succ[spec.state(toks[-2], toks[-1]), rank[:, j]]
            toks.append(nxt)
        return torch.stack(toks, dim=1)

    return sampler


def lm_nll(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL (nats) of the model on [B, L] tokens, float32."""
    B, L = tokens.shape
    cache = init_cache(cfg, B, L, device=tokens.device)
    logits, _ = forward_step(cfg, params, tokens, cache)
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).to(torch.int64))


def _lm_grad(cfg: ModelConfig, params, tokens: torch.Tensor):
    """(nll, grads) for ``params`` from ``optim.trainable``."""
    nll, _, grads = value_and_grad(
        lambda p: (lm_nll(cfg, p, tokens), ()), params)
    return nll, grads


def train_lm(cfg: ModelConfig, params,
             batch_sampler: Callable[[torch.Generator], torch.Tensor],
             steps: int = 1000,
             learning_rate: float = 3e-4,
             warmup: int = 100,
             generator: Optional[torch.Generator] = None,
             seed: int = 0, device=None,
             log_every: int = 0, log_fn=print):
    """Pretrain ``params`` (dense) on the sampler's stream. Returns (the
    trained params, none requiring grad; the last step's NLL). The
    caller's params are not changed. ``generator`` (or a new one seeded
    with ``seed`` on ``device``, ``None``: the card) feeds the sampler."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    params = trainable(params)
    opt = Adam(params, linear_warmup(learning_rate, warmup),
               weight_decay=1e-4, clip_norm=1.0)
    nll = None
    for i in range(steps):
        tokens = batch_sampler(generator)
        nll, grads = _lm_grad(cfg, params, tokens)
        opt.step(grads)
        del grads
        if log_every and i % log_every == 0:
            log_fn(f"lm step {i}: nll={float(nll):.4f}")
    return frozen(params), float(nll) if nll is not None else float("nan")


def build_trained_target(cfg: ModelConfig, spec: MarkovSpec,
                         steps: int = 1000, batch_size: int = 16,
                         seq_len: int = 128, learning_rate: float = 3e-4,
                         seed: int = 0, device=None, log_every: int = 0,
                         log_fn=print):
    """(params, final_nll): a cfg-shaped target trained on the stream, on
    ``device`` (``None``: the card). The init is seeded by
    ``crc32("pretrain:<seed>")`` and the stream by ``seed + 1``, the
    integers the JAX package derives its keys from. ``spec.entropy_nats``
    is the NLL floor."""
    device = resolve_device(device)
    params = init_params(cfg, seed=zlib.crc32(f"pretrain:{seed}".encode()),
                         device=device)
    sampler = markov_sampler(spec, batch_size, seq_len, device)
    return train_lm(cfg, params, sampler, steps=steps,
                    learning_rate=learning_rate, seed=seed + 1,
                    device=device, log_every=log_every, log_fn=log_fn)
