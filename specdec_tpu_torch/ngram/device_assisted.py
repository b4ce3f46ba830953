"""Device NASD: n-gram drafting, verify, acceptance and table updates on
the device (counterpart of ``specdec_tpu/ngram/device_assisted.py``).

The reference semantics are the host path's (``ngram/assisted.py``):
exact-match acceptance of the target's own samples, so greedy output
equals greedy AR whatever the table holds; no residual adjustment; gamma
cut by ``stop_if_unknown``; committed-token and top-k filler updates;
prompt seeding. The n-gram model is the fixed-capacity recency table of
``ngram/device_table.py`` instead of the host store.

The JAX body is one ``lax.while_loop``. Here a window is eager PyTorch on
the device and the loop reads the host once per window, to stop when every
row is finished. The gamma lookups run one after another (draft k+1's
context holds draft k), each vectorized over the batch and the orders.
The table updates of a window, which the JAX package applies one by one
(``fori_loop`` over a device count per sequence), are one masked
[B, gamma+1, fillers+1] grid of writes in the JAX order (sequence, then
position, then its fillers, then the committed token), applied with the
last-writer rule of ``table_update``; the prompt seeding likewise. No
per-sequence count is read to the host.

In place: a window writes ``state.buf``, the cache and the table in place
and returns a new ``NasdState`` whose counters are new tensors. Drafts are
written into ``buf`` past each row's committed length, as the JAX window
does; only ``buf[:, :pos]`` is committed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step
from specdec_tpu_torch.engine.batch_engine import (
    _pack_state, _pad_batch, _unpack_state,
)
from specdec_tpu_torch.ngram.device_table import (
    DeviceNGramTable, init_device_table, seed_writes, table_lookup,
    table_update,
)
from specdec_tpu_torch.sampling.processors import (
    GreedyProcessor, LogitsProcessor,
)
from specdec_tpu_torch.sampling.utils import (
    eos_mask, normalize_eos, prefill_generator, stable_top_k,
)


@dataclasses.dataclass
class NasdState:
    """Device state of a device-NASD generation. The field names are
    ``engine.batch_engine.BatchState``'s (without the drafter cache: the
    drafter is the shared table, global across slots), so the batch
    engine's ``_pack_state`` / ``_unpack_state`` harvest works unchanged."""

    buf: torch.Tensor         # [B, S] int64
    pos: torch.Tensor         # [B] int32
    prompt_len: torch.Tensor  # [B] int32
    total_len: torch.Tensor   # [B] int32
    finished: torch.Tensor    # [B] bool
    t_cache: object           # target cache (the only model in NASD)
    accepted: torch.Tensor    # [B] int32
    speculated: torch.Tensor  # [B] int32


def _window_of(buf: torch.Tensor, end: torch.Tensor,
               width: int) -> torch.Tensor:
    """buf[b, end[b]-width : end[b]] per row [B, ...], the start clamped
    into the row as ``lax.dynamic_slice`` clamps it. end: [B] or [B, J]."""
    start = torch.clamp(end.to(torch.int64) - width, 0, buf.shape[1] - width)
    cols = start[..., None] + torch.arange(width, device=buf.device)
    rows = torch.arange(buf.shape[0], device=buf.device).reshape(
        (-1,) + (1,) * (cols.dim() - 1))
    return buf[rows, cols]


def _first_index(mask: torch.Tensor, default: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, or ``default`` where
    there is none."""
    return torch.where(mask.any(dim=-1), torch.argmax(mask.to(torch.int8),
                                                      dim=-1), default)


def _nasd_window_body(cfg: ModelConfig, params, state: NasdState,
                      table: DeviceNGramTable, gamma: int,
                      processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                      filler_k: int, stop_if_unknown: bool,
                      generator: torch.Generator
                      ) -> Tuple[NasdState, DeviceNGramTable]:
    """One draft / verify / accept / table-update window for the whole
    batch (shared by the one-shot generators and the serving batcher)."""
    buf, pos, finished = state.buf, state.pos, state.finished
    total_len = state.total_len
    B = buf.shape[0]
    device = buf.device
    rows = torch.arange(B, device=device)
    n_ctx = table.orders[0] - 1
    pos64 = pos.to(torch.int64)

    # --- draft: gamma lookups, each reading the previous draft -------------
    drafts, known = [], []
    for k in range(gamma):
        toks, kn = table_lookup(table, _window_of(buf, pos64 + k, n_ctx),
                                generator, cfg.vocab_size)
        buf[rows, pos64 + k] = toks
        drafts.append(toks)
        known.append(kn)
    drafts = torch.stack(drafts, dim=1)                          # [B, g]
    known = torch.stack(known, dim=1)

    corrected = torch.clamp(total_len - pos - 1, 0, gamma).to(torch.int64)
    full = torch.full((B,), gamma, dtype=torch.int64, device=device)
    eff = _first_index(~known, full) if stop_if_unknown else full
    eff = torch.minimum(eff, corrected)

    # --- verify: one target forward over gamma+1 positions -----------------
    first_tok = buf.gather(1, (pos64 - 1)[:, None])
    t_in = torch.cat([first_tok, drafts], dim=1)                 # [B, g+1]
    logits, cache = forward_step(cfg, params, t_in, state.t_cache)
    p = processor(logits)                                        # [B, g+1, V]
    samples = processor.sample(p, generator)                     # [B, g+1]

    idx = torch.arange(gamma, device=device)[None, :]
    mismatch = (samples[:, :gamma] != drafts) & (idx < eff[:, None])
    n = _first_index(mismatch, eff)

    buf[rows, pos64 + n] = samples[rows, n]
    cidx = torch.arange(gamma + 1, device=device)[None, :]
    cand = torch.where(cidx < n[:, None],
                       drafts[:, torch.clamp_max(cidx[0], gamma - 1)], 0)
    cand[rows, n] = samples[rows, n]
    advance = torch.minimum(n + 1, (total_len - pos).to(torch.int64))
    is_eos = eos_mask(cand, eos_ids) & (cidx <= n[:, None])
    any_eos = (is_eos & (cidx < advance[:, None])).any(dim=1)
    first_eos = torch.argmax(is_eos.to(torch.int8), dim=1)
    advance = torch.where(any_eos, torch.minimum(first_eos + 1, advance),
                          advance)
    advance = torch.where(finished, 0, advance)

    # --- table updates: positions pos..pos+advance-1 of each row, each
    # with its fillers FIRST and its committed token LAST (the recency
    # table keeps the last writer, and the actual continuation must win)
    fillers = stable_top_k(p, filler_k)[1]                      # [B, g+1, k]
    ctx = _window_of(buf, pos64[:, None] + cidx, n_ctx)         # [B, g+1, c]
    committed = buf[rows[:, None], pos64[:, None] + cidx]       # [B, g+1]
    toks = (torch.cat([fillers, committed[..., None]], dim=2)
            if filler_k > 1 else committed[..., None])          # [B, g+1, F]
    F = toks.shape[2]
    valid = (cidx < advance[:, None])[..., None].expand(B, gamma + 1, F)
    table_update(table, ctx[:, :, None, :].expand(B, gamma + 1, F, n_ctx)
                 .reshape(-1, n_ctx), toks.reshape(-1), valid.reshape(-1))

    new_pos = (pos + advance).to(torch.int32)
    finished = finished | any_eos | (new_pos >= total_len)
    moved = advance > 0
    accepted = state.accepted + torch.where(
        moved, torch.minimum(n, corrected), 0)
    speculated = state.speculated + torch.where(moved, eff, 0)
    state = dataclasses.replace(
        state, pos=new_pos, finished=finished,
        t_cache=cache.with_length(new_pos - 1),
        accepted=accepted.to(torch.int32),
        speculated=speculated.to(torch.int32))
    return state, table


def nasd_spec_windows(cfg: ModelConfig, params, state: NasdState,
                      table: DeviceNGramTable, gamma: int,
                      processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                      filler_k: int, stop_if_unknown: bool,
                      generator: torch.Generator, max_windows: int,
                      ) -> Tuple[NasdState, DeviceNGramTable]:
    """Up to ``max_windows`` NASD windows, stopping early once every row is
    finished: one host read (the finished check) before each window (the
    serving batcher's windows_per_sync step)."""
    for _ in range(max_windows):
        if bool(state.finished.all()):
            break
        state, table = _nasd_window_body(
            cfg, params, state, table, gamma, processor, eos_ids, filler_k,
            stop_if_unknown, generator)
    return state, table


def seed_table(table: DeviceNGramTable, prompts: torch.Tensor,
               prompt_lens: torch.Tensor, buf: torch.Tensor,
               tok0: torch.Tensor) -> DeviceNGramTable:
    """Seed the table from each prompt and its first committed token, one
    sequence after another: every (context, next) pair of prompt b, then
    the last n-1 tokens of prompt b -> tok0[b]. ``buf`` [B, S] holds the
    prompts with tok0 at each prompt's length. In place."""
    n_ctx = table.orders[0] - 1
    ctx, nxt, valid = seed_writes(prompts, prompt_lens, n_ctx + 1)
    c0 = _window_of(buf, prompt_lens, n_ctx)                     # [B, c]
    ctx = torch.cat([ctx, c0[:, None].to(ctx.dtype)], dim=1)
    nxt = torch.cat([nxt, tok0[:, None].to(nxt.dtype)], dim=1)
    valid = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)
    return table_update(table, ctx.reshape(-1, n_ctx), nxt.reshape(-1),
                        valid.reshape(-1))


def device_ngram_assisted_generate_batch(
    prompt_ids: Sequence[Sequence[int]],
    cfg: ModelConfig,
    params,
    n: int = 3,
    table: Optional[DeviceNGramTable] = None,
    capacity: int = 1 << 16,
    gamma: int = 5,
    filler_top_k: int = 3,
    logits_processor: Optional[LogitsProcessor] = None,
    gen_len: int = 100,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    stop_if_unknown: bool = False,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    device=None,
) -> Tuple[List[List[int]], List[float], DeviceNGramTable]:
    """Batched device-table NASD. Returns (per-seq outputs, per-seq rates,
    the updated table). ``table`` is copied, not edited (pass the returned
    one back in to accumulate across calls); ``generator`` (or a new one
    seeded with ``seed``) draws for every window, and the prefill draws
    from a stream of its own (``prefill_generator``). One host read per
    window and one for the harvest; ``device=None`` means the card."""
    device = resolve_device(device)
    processor = logits_processor or GreedyProcessor()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    eos_ids = normalize_eos(eos_tokens_id)
    gamma, gen_len = int(gamma), int(gen_len)
    filler_k = max(1, int(filler_top_k))
    # degenerate prompts (< n tokens) are tolerated: context slices clamp
    # at the buffer start; a minimum of 2 keeps the pos-1 reads in bounds
    if min(len(p) for p in prompt_ids) < 2:
        raise ValueError("prompts must have at least 2 tokens")
    table = (init_device_table(n, capacity, device) if table is None
             else table.clone())
    prompts, lens = _pad_batch(prompt_ids, pad_token_id, device)
    B, P = prompts.shape
    S = P + gen_len + gamma + 2
    rows = torch.arange(B, device=device)

    cache = init_cache(cfg, B, S, device=device)
    buf = torch.zeros((B, S), dtype=torch.int64, device=device)
    buf[:, :P] = prompts
    total_len = torch.clamp_max(lens + gen_len, cfg.max_position_embeddings)

    logits, cache = forward_step(cfg, params, prompts, cache)
    last = logits[rows, (lens - 1).to(torch.int64)]               # [B, V]
    tok0 = processor.sample(processor(last), prefill_generator(generator))
    buf[rows, lens.to(torch.int64)] = tok0
    seed_table(table, prompts, lens, buf, tok0)

    pos = (lens + 1).to(torch.int32)
    zeros = torch.zeros((B,), dtype=torch.int32, device=device)
    state = NasdState(
        buf=buf, pos=pos, prompt_len=lens.clone(), total_len=total_len,
        finished=eos_mask(tok0, eos_ids) | (pos >= total_len),
        t_cache=cache.with_length(lens.clone()), accepted=zeros,
        speculated=zeros.clone())
    state, table = nasd_spec_windows(
        cfg, params, state, table, gamma, processor, eos_ids, filler_k,
        bool(stop_if_unknown), generator, gen_len + 1)

    buf_h, pos_h, plen_h, acc, spec, _ = _unpack_state(
        _pack_state(state).cpu().numpy())
    outputs = [buf_h[b, plen_h[b]:pos_h[b]].tolist() for b in range(B)]
    rates = [float(acc[b]) / float(spec[b]) if spec[b] > 0 else 0.0
             for b in range(B)]
    return outputs, rates, table


def device_ngram_assisted_generate(
    inputs: Sequence[int],
    cfg: ModelConfig,
    params,
    n: int = 3,
    table: Optional[DeviceNGramTable] = None,
    capacity: int = 1 << 16,
    gamma: int = 5,
    filler_top_k: int = 3,
    logits_processor: Optional[LogitsProcessor] = None,
    max_gen_len: int = 40,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    stop_if_unknown: bool = False,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    device=None,
) -> Tuple[List[int], float, DeviceNGramTable]:
    """Single-sequence device-table NASD: the B=1 case of
    ``device_ngram_assisted_generate_batch`` (one implementation). Returns
    (generated ids, acceptance, updated table); pass the table back in to
    accumulate across prompts."""
    outs, rates, table = device_ngram_assisted_generate_batch(
        [inputs], cfg, params, n=n, table=table, capacity=capacity,
        gamma=gamma, filler_top_k=filler_top_k,
        logits_processor=logits_processor, gen_len=max_gen_len,
        eos_tokens_id=eos_tokens_id, pad_token_id=pad_token_id,
        stop_if_unknown=stop_if_unknown, generator=generator, seed=seed,
        device=device)
    return outs[0], rates[0], table
