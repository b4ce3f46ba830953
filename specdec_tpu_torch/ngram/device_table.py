"""Device-resident n-gram tables: the drafter of device NASD
(counterpart of ``specdec_tpu/ngram/device_table.py``).

The whole n-gram model lives on the device as fixed-capacity open-hash
tables, one per context order (n-1 down to 2 tokens of context), so a NASD
window drafts without reading the host (``ngram/device_assisted.py``).

Semantics are the JAX package's, bit for bit:
- capacity is fixed (a power of two); collisions overwrite (last writer
  wins), and the stored context is kept beside the prediction so a
  colliding lookup misses instead of returning another context's token;
- the prediction per context is the most recent update, not the argmax of
  counts (the host store's rule);
- lookups back off from order n-1 to 2, and an unknown context yields a
  uniformly random token with known=False.

The hash is ``h = h * MIX + c + 1`` over the context, in int32 arithmetic
that wraps. Torch's int32 overflow is not relied on: ``_bucket`` computes
in int64 and reduces modulo 2**32 at each step, which keeps the low bits
exact (the bucket is the low bits of h).

Writes are batched. ``table_update`` applies its writes as if one after
another: each write gets its sequential order, the winner of each bucket
is the write of largest order (``scatter_reduce`` with ``"amax"``), and
every write of a bucket stores the winner's context and token, so
duplicate indices all store the same value and the result does not depend
on the order in which the device applies them. Nothing reads the table
between writes, so this equals the sequential result exactly. Tables are
edited in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from specdec_tpu_torch import resolve_device

# multiplicative mixing constant (Knuth), as a signed int32
_MIX = -1640531527
_LOW32 = 0xFFFFFFFF


@dataclasses.dataclass
class DeviceNGramTable:
    """Open-hash tables for context orders (n-1, n-2, ..., 2).

    ctx[k]: [H, order_k - 1] int32, the stored context per bucket (-1 =
    empty); tok[k]: [H] int32, the predicted next token for it."""

    ctx: Tuple[torch.Tensor, ...]
    tok: Tuple[torch.Tensor, ...]

    @property
    def orders(self) -> Tuple[int, ...]:
        return tuple(c.shape[1] + 1 for c in self.ctx)

    @property
    def capacity(self) -> int:
        return self.ctx[0].shape[0]

    def clone(self) -> "DeviceNGramTable":
        return DeviceNGramTable(ctx=tuple(c.clone() for c in self.ctx),
                                tok=tuple(t.clone() for t in self.tok))


def init_device_table(n: int, capacity: int = 1 << 16,
                      device=None) -> DeviceNGramTable:
    """Empty table covering orders n..2 (context lengths n-1..1) on
    ``device`` (``None``: the card)."""
    if not (n > 1 and capacity & (capacity - 1) == 0):
        raise ValueError("n > 1 and a power-of-two capacity are required")
    device = resolve_device(device)
    ctx, tok = [], []
    for order in range(n, 1, -1):
        ctx.append(torch.full((capacity, order - 1), -1, dtype=torch.int32,
                              device=device))
        tok.append(torch.zeros((capacity,), dtype=torch.int32,
                               device=device))
    return DeviceNGramTable(ctx=tuple(ctx), tok=tuple(tok))


def _bucket(context: torch.Tensor, capacity: int) -> torch.Tensor:
    """Hash [..., k] contexts to int64 bucket indices [...]: the int32
    hash of the JAX package, computed modulo 2**32 in int64 (|h * MIX| <
    2**63 for h < 2**32)."""
    c = context.to(torch.int64)
    h = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    for i in range(c.shape[-1]):
        h = (h * _MIX + c[..., i] + 1) & _LOW32
    return h & (capacity - 1)


def _tail(context: torch.Tensor, span: int) -> torch.Tensor:
    """The last ``span`` tokens of [..., n-1] contexts."""
    return context[..., context.shape[-1] - span:]


def table_lookup(table: DeviceNGramTable, context: torch.Tensor,
                 generator: Optional[torch.Generator], vocab_size: int,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backoff lookup of [..., n-1] contexts (the last n-1 tokens, most
    recent last; -1 pads a context shorter than that). Returns (tokens
    int64 [...], known bool [...]); an unknown context yields a uniformly
    random token from ``generator`` with known=False."""
    H = table.capacity
    shape = context.shape[:-1]
    tok = torch.randint(0, vocab_size, shape, generator=generator,
                        device=context.device)
    found = torch.zeros(shape, dtype=torch.bool, device=context.device)
    # orders high to low: the first hit wins
    for order_ctx, order_tok in zip(table.ctx, table.tok):
        sub = _tail(context, order_ctx.shape[1])
        b = _bucket(sub, H)
        hit = ((order_ctx[b] == sub).all(dim=-1) & (sub >= 0).all(dim=-1))
        tok = torch.where(hit & ~found, order_tok[b].to(torch.int64), tok)
        found = found | hit
    return tok, found


def table_update(table: DeviceNGramTable, contexts: torch.Tensor,
                 next_toks: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> DeviceNGramTable:
    """Record W writes context -> next token at every order, in place, as
    if applied one after another in their order (last writer wins per
    bucket). contexts: [W, n-1] (or [n-1] for one write); next_toks: [W];
    ``valid`` [W] masks writes out. A write whose context (at an order)
    holds -1 padding is skipped at that order. Returns ``table``."""
    if contexts.dim() == 1:
        contexts, next_toks = contexts[None], next_toks.reshape(1)
    W = contexts.shape[0]
    H = table.capacity
    device = contexts.device
    order = torch.arange(W, device=device)
    ok_all = (torch.ones(W, dtype=torch.bool, device=device)
              if valid is None else valid.reshape(W))
    toks = next_toks.reshape(W).to(torch.int32)
    for order_ctx, order_tok in zip(table.ctx, table.tok):
        sub = _tail(contexts, order_ctx.shape[1]).to(torch.int32)
        b = _bucket(sub, H)
        ok = ok_all & (sub >= 0).all(dim=-1)
        winner = torch.full((H,), -1, dtype=torch.int64, device=device)
        winner.scatter_reduce_(0, b, torch.where(ok, order, -1), "amax")
        w = winner[b]                       # this write's bucket's winner
        has = w >= 0
        wi = torch.clamp_min(w, 0)
        order_tok[b] = torch.where(has, toks[wi], order_tok[b])
        order_ctx[b] = torch.where(has[:, None], sub[wi], order_ctx[b])
    return table


def seed_writes(tokens: torch.Tensor, length: torch.Tensor, n: int,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The writes of ``table_seed`` for prompts [B, P] (right-padded) of
    ``length`` [B] valid tokens: every (context, next) pair
    tokens[b, i:i+n-1] -> tokens[b, i+n-1] with i+n-1 < length[b], in
    order. Returns (contexts [B, P-n+1, n-1], next [B, P-n+1], valid
    [B, P-n+1])."""
    B, P = tokens.shape
    m = max(P - (n - 1), 0)
    i = torch.arange(m, device=tokens.device)
    ctx = tokens[:, i[:, None] + torch.arange(n - 1, device=tokens.device)]
    nxt = tokens[:, i + n - 1]
    valid = i[None, :] + (n - 1) < length.reshape(B, 1)
    return ctx, nxt, valid


def table_seed(table: DeviceNGramTable, tokens: torch.Tensor,
               length) -> DeviceNGramTable:
    """Seed from a prompt: update with every (context, next) pair, like the
    host store's ``initialize``. tokens: [P] right-padded; length: the
    valid count. In place; returns ``table``."""
    length = torch.as_tensor(length, device=tokens.device).reshape(1)
    ctx, nxt, valid = seed_writes(tokens[None], length, table.orders[0])
    return table_update(table, ctx[0], nxt[0], valid[0])
