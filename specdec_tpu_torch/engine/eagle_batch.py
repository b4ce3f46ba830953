"""Batched EAGLE speculative decoding: whole-batch feature-drafted windows
(counterpart of ``specdec_tpu/engine/eagle_batch.py``).

The single-sequence loop of ``sampling/eagle_speculative.py`` over B rows,
shaped as ``engine/batch_engine.py`` shapes model drafters: per-row cache
lengths make divergent accept counts free, and one packed host copy
harvests the result. The invariants hold per row:

- ``fbuf[b]`` holds the target's feature of each committed position,
  valid through ``pos[b] - 2`` at a window's start;
- the drafter catches up by rewriting the last gamma + 1 (feature, token)
  pairs ending at pair ``pos[b] - 2``, with the EAGLE cache's length reset
  behind them; the output at that pair is draft step 0;
- the verify's features are written at ``pos[b] - 1 ..``; those at or past
  a rejection lie past the next window's reads;
- rollback is length arithmetic on both caches.

Finished rows commit nothing (their ``buf`` rows are kept), but their
``fbuf`` and EAGLE-cache writes land at or past ``pos - 1`` without a mask,
where no later window reads (reads stop at ``new_pos - 2`` and a finished
row's ``pos`` stays). Those writes are clamped as ``_put_block``'s are, so
a row near S lands where the JAX package's ``dynamic_update_slice`` puts
it.

In place, as in ``batch_engine``: the window writes the caches, ``buf`` and
``fbuf`` of the state it is given and returns a new ``EagleBatchState``
over the same storage; the state passed in must not be used again.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.eagle import eagle_forward
from specdec_tpu_torch.core.model import forward_step_features
from specdec_tpu_torch.engine.batch_engine import (
    _gather_at, _new_generator, _outputs, _pad_batch, _put_block,
    data_split, gather_rows, stamp_first_tokens,
)
from specdec_tpu_torch.sampling.processors import (
    GreedyProcessor, LogitsProcessor, uniform,
)
from specdec_tpu_torch.sampling.speculative import accept_step, commit_step
from specdec_tpu_torch.sampling.utils import eos_mask, normalize_eos


@dataclasses.dataclass
class EagleBatchState:
    """Device state of a batched EAGLE generation. The field names are
    ``BatchState``'s where they are shared, so ``_pack_state`` and
    ``_unpack_state`` harvest it unchanged."""

    buf: torch.Tensor         # [B, S] int64 committed tokens
    pos: torch.Tensor         # [B] int32
    prompt_len: torch.Tensor  # [B] int32
    total_len: torch.Tensor   # [B] int32
    finished: torch.Tensor    # [B] bool
    fbuf: torch.Tensor        # [B, S, D] target features per position
    e_cache: object           # the EAGLE drafter's slotted cache
    t_cache: object           # the target's slotted cache
    accepted: torch.Tensor    # [B] int32
    speculated: torch.Tensor  # [B] int32
    samp: Optional[torch.Tensor] = None


def _accept_uniforms(shape, generator: Optional[torch.Generator],
                     device) -> torch.Tensor:
    """The window's acceptance draws r ~ U[0, 1): the one place the batched
    EAGLE window draws them, so that a test can supply other draws."""
    return uniform(shape, generator, device)


def _rows_at(arr: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n, ...]: arr[b, start[b]:start[b]+n], each start clamped so that
    the block fits the row (``lax.dynamic_slice``'s clamp)."""
    B, S = arr.shape[:2]
    cols = (torch.clamp(start.to(torch.int64), 0, S - n)[:, None]
            + torch.arange(n, device=arr.device)[None, :])
    return arr[torch.arange(B, device=arr.device)[:, None], cols]


def _put_rows(arr: torch.Tensor, vals: torch.Tensor,
              start: torch.Tensor) -> None:
    """arr[b, start[b]:start[b]+n] = vals[b] in place for every row, each
    start clamped so that the block fits (``dynamic_update_slice``'s
    clamp): ``_put_block`` without a mask, over rows with trailing axes."""
    B, S = arr.shape[:2]
    n = vals.shape[1]
    cols = (torch.clamp(start.to(torch.int64), 0, S - n)[:, None]
            + torch.arange(n, device=arr.device)[None, :])
    arr[torch.arange(B, device=arr.device)[:, None], cols] = vals.to(
        arr.dtype)


def eagle_batch_prefill(eagle_cfg: ModelConfig, eagle_params,
                        target_cfg: ModelConfig, target_params,
                        prompts: torch.Tensor, prompt_lens: torch.Tensor,
                        gen_len: int, gamma: int,
                        processor: LogitsProcessor, first_target: bool,
                        eos_ids: Tuple[int, ...],
                        generator: Optional[torch.Generator]
                        ) -> EagleBatchState:
    """The target's prefill over right-padded prompts [B, P] seeds the
    ``fbuf`` rows; the EAGLE cache needs none (each window's catch-up
    rewrite derives it)."""
    del eagle_params
    device = prompts.device
    B, P = prompts.shape
    S = P + gen_len + gamma + 2
    buf = torch.zeros((B, S), dtype=torch.int64, device=device)
    buf[:, :P] = prompts
    max_pos = min(eagle_cfg.max_position_embeddings,
                  target_cfg.max_position_embeddings)
    total_len = torch.clamp_max(prompt_lens + gen_len, max_pos)

    t_cache = init_cache(target_cfg, B, S, device=device)
    t_logits, t_feats, t_cache = forward_step_features(
        target_cfg, target_params, prompts, t_cache)
    fbuf = torch.zeros((B, S, target_cfg.hidden_size),
                       dtype=target_cfg.dtype, device=device)
    fbuf[:, :P] = t_feats.to(fbuf.dtype)

    rows = torch.arange(B, device=device)
    if first_target:
        last = t_logits[rows, (prompt_lens - 1).to(torch.int64)]
        tok0 = processor.sample_batched(processor.batched(last), generator)
        buf[rows, prompt_lens.to(torch.int64)] = tok0
        pos = prompt_lens + 1
        finished = eos_mask(tok0, eos_ids) | (pos >= total_len)
    else:
        # every prompt needs >= 2 tokens (the catch-up ends at pair pos-2)
        pos = prompt_lens.clone()
        finished = pos >= total_len
    zeros = torch.zeros((B,), dtype=torch.int32, device=device)
    return EagleBatchState(
        buf=buf, pos=pos, prompt_len=prompt_lens.clone(),
        total_len=total_len, finished=finished, fbuf=fbuf,
        e_cache=init_cache(eagle_cfg, B, S, device=device),
        t_cache=t_cache.with_length(pos - 1),
        accepted=zeros, speculated=zeros.clone())


def _eagle_window_body(eagle_cfg: ModelConfig, eagle_params,
                       target_cfg: ModelConfig, target_params,
                       state: EagleBatchState, gamma: int,
                       processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                       skip_sample_adjustment: bool,
                       generator: Optional[torch.Generator]
                       ) -> EagleBatchState:
    """One whole-batch EAGLE draft / verify / accept window; no host
    read."""
    B = state.buf.shape[0]
    C = gamma + 1
    samp, pos = state.samp, state.pos
    rows = torch.arange(B, device=pos.device)

    # --- catch-up rewrite + draft step 0, per row ---------------------------
    start = torch.clamp_min(pos - 1 - C, 0)
    idx = (pos - 2 - start).to(torch.int64)                 # output slot
    logits_blk, fhat_blk, e_cache = eagle_forward(
        eagle_cfg, eagle_params, target_params,
        _rows_at(state.buf, start + 1, C), _rows_at(state.fbuf, start, C),
        state.e_cache.with_length(start.to(torch.int32)))
    q = processor.batched(logits_blk[rows, idx], samp)          # [B, V]
    x = processor.sample_batched(q, generator, samp)
    f = fhat_blk[rows, idx]                                     # [B, D]
    # drop the slots past the output pair (early windows clamp start to 0)
    e_cache = e_cache.with_length(pos - 1)
    qs, xs = [q], [x]

    # --- draft steps 1..gamma-1 on predicted features ----------------------
    for _ in range(1, gamma):
        logits, f_hat, e_cache = eagle_forward(
            eagle_cfg, eagle_params, target_params, x[:, None],
            f[:, None, :], e_cache)
        q = processor.batched(logits[:, 0], samp)
        x = processor.sample_batched(q, generator, samp)
        f = f_hat[:, 0]
        qs.append(q)
        xs.append(x)
    q_all = torch.stack(qs, dim=1)                              # [B, g, V]
    drafts = torch.stack(xs, dim=1)                             # [B, g]

    # --- verify: one target forward over gamma+1 positions -----------------
    t_in = torch.cat([_gather_at(state.buf, pos - 1)[:, None], drafts], dim=1)
    t_logits, t_feats, t_cache = forward_step_features(
        target_cfg, target_params, t_in, state.t_cache)
    p_all = processor.batched(t_logits, samp)                   # [B, g+1, V]
    _put_rows(state.fbuf, t_feats, pos - 1)

    # --- accept / residual, then commit ------------------------------------
    r = _accept_uniforms((B, gamma), generator, pos.device)
    n, next_tok = accept_step(p_all, q_all, drafts, r, processor, generator,
                              skip_sample_adjustment, samp)
    remaining = (state.total_len - pos).to(n.dtype)
    cand, advance, any_eos = commit_step(drafts, n, next_tok, remaining,
                                         eos_ids)
    advance = torch.where(state.finished, 0, advance)
    _put_block(state.buf, cand, pos, state.finished)
    new_pos = (pos + advance).to(torch.int32)
    finished = state.finished | any_eos | (new_pos >= state.total_len)

    corrected = torch.clamp(state.total_len - pos - 1, 0, gamma)
    active = ~state.finished
    accepted = state.accepted + torch.where(
        active, torch.minimum(n.to(torch.int32), corrected), 0)
    speculated = state.speculated + torch.where(active, corrected, 0)
    return dataclasses.replace(
        state, pos=new_pos, finished=finished,
        e_cache=e_cache,     # the next window's catch-up resets its length
        t_cache=t_cache.with_length(new_pos - 1),
        accepted=accepted.to(torch.int32),
        speculated=speculated.to(torch.int32))


def eagle_batch_window(eagle_cfg, eagle_params, target_cfg, target_params,
                       state: EagleBatchState, gamma: int,
                       processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                       skip_sample_adjustment: bool,
                       generator: Optional[torch.Generator]
                       ) -> EagleBatchState:
    """One window (``_eagle_window_body``); no host read."""
    return _eagle_window_body(eagle_cfg, eagle_params, target_cfg,
                              target_params, state, gamma, processor,
                              eos_ids, skip_sample_adjustment, generator)


def eagle_batch_windows(eagle_cfg, eagle_params, target_cfg, target_params,
                        state: EagleBatchState, gamma: int,
                        processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                        skip_sample_adjustment: bool,
                        generator: Optional[torch.Generator],
                        max_windows: int) -> EagleBatchState:
    """Up to ``max_windows`` windows, stopping once every row is finished:
    one host read (the finished check) before each window."""
    for _ in range(max_windows):
        if bool(state.finished.all()):
            break
        state = _eagle_window_body(
            eagle_cfg, eagle_params, target_cfg, target_params, state, gamma,
            processor, eos_ids, skip_sample_adjustment, generator)
    return state


def batch_eagle_generate(
    prompt_ids: Sequence[Sequence[int]],
    eagle_cfg: ModelConfig, eagle_params,
    target_cfg: ModelConfig, target_params,
    gamma: int = 5,
    gen_len: int = 100,
    logits_processor: Optional[LogitsProcessor] = None,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    first_target: bool = True,
    skip_sample_adjustment: bool = False,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    first_token_callback: Optional[Callable[[int], None]] = None,
    device=None,
) -> Tuple[List[List[int]], List[float]]:
    """Batched EAGLE generation; the API of ``batch_speculative_generate``.
    Returns (per-sequence generated token lists, per-sequence acceptance
    rates). ``generator`` (or a new one seeded with ``seed``) draws for
    every row; ``device=None`` means the card."""
    device = resolve_device(device)
    processor = logits_processor or GreedyProcessor()
    generator = generator or _new_generator(device, seed)
    eos_ids = normalize_eos(eos_tokens_id)
    if not first_target and min(len(p) for p in prompt_ids) < 2:
        raise ValueError("first_target=False requires prompts of >= 2 tokens")
    prompts, lens = _pad_batch(prompt_ids, pad_token_id, device)
    mesh, prompts, lens, generator = data_split(
        target_params, prompts, lens, generator)
    B = prompts.shape[0]
    args = (eagle_cfg, eagle_params, target_cfg, target_params)

    state = eagle_batch_prefill(*args, prompts, lens, int(gen_len),
                                int(gamma), processor, bool(first_target),
                                eos_ids, generator)
    # the first window alone: its end is the first verified tokens (TTFT)
    state = eagle_batch_window(*args, state, int(gamma), processor, eos_ids,
                               bool(skip_sample_adjustment), generator)
    stamp_first_tokens(first_token_callback, state, len(prompt_ids))
    # every window advances each unfinished row by >= 1 token
    state = eagle_batch_windows(*args, state, int(gamma), processor, eos_ids,
                                bool(skip_sample_adjustment), generator,
                                int(gen_len) + 1)
    outs, acc, spec = _outputs(state)
    rates = [float(acc[i]) / float(spec[i]) if spec[i] > 0 else 0.0
             for i in range(B)]
    return gather_rows(mesh, outs, rates)
