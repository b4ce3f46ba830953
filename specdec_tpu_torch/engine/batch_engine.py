"""Batched speculative and autoregressive decoding
(counterpart of ``specdec_tpu/engine/batch_engine.py``).

A window advances the whole batch: gamma drafter steps (the first feeds two
tokens, the catch-up fold of ``sampling/speculative.py``), one target verify
over gamma+1 positions per sequence, the vectorized accept/residual step
(``accept_step``) and commit (``commit_step``). Per-sequence cache lengths
make divergent accept counts free: rollback is length arithmetic. Finished
rows still run through the forwards (their results are discarded) and
commit nothing.

The caches may be slotted (``KVCache``, ``QuantKVCache``) or paged
(``PagedKVCache``, ``QuantPagedKVCache``): ``forward_step`` dispatches on
the type. Either way a forward attends through the attention kernels
wherever ``kernel_route(cfg)`` holds, whatever ``attention_impl`` says:
the batch never needs a gradient, which the kernels do not give.

In place: where the JAX version donates ``state`` and returns a new one,
the window and AR steps here write the caches and each unfinished row's
committed tokens (``state.buf``) IN PLACE, and return a new ``BatchState``
whose per-row counters are new tensors. The state passed in shares its
storage with the one returned and must not be used again.

The window runs eagerly on the device; ``batch_spec_windows`` reads the
host at most once per window, to exit when every row is finished.

Under a data-parallel mesh (target params sharded by
``parallel/mesh.py::shard_params`` with dp > 1) each data rank runs its
rows of the padded batch (``batch_state_pspecs``), drawing the whole
batch's uniforms and keeping its rows (``DataRowsGenerator``), so the
outputs equal the unsharded run's for the same seed; the generate functions
gather every rank's outputs and counts with one ``all_gather_object``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step as _slotted_forward_step
from specdec_tpu_torch.core.model import forward_step_paged, kernel_route
from specdec_tpu_torch.core.paged_cache import (
    PagedKVCache, QuantPagedKVCache,
)
from specdec_tpu_torch.parallel.mesh import batch_state_pspecs
from specdec_tpu_torch.sampling.processors import (
    DataRowsGenerator, GreedyProcessor, LogitsProcessor, uniform,
)
from specdec_tpu_torch.sampling.speculative import accept_step, commit_step
from specdec_tpu_torch.sampling.utils import eos_mask, normalize_eos
from specdec_tpu_torch.utils.profiling import TRACER


def forward_step(cfg, params, tokens, cache):
    """Dispatch on the cache type: paged (``PagedKVCache``,
    ``QuantPagedKVCache``) or slotted (``KVCache``, ``QuantKVCache``), each
    on the attention kernel where ``kernel_route(cfg)`` holds (the slotted
    forward on the flash-decode kernel, the paged one on the paged
    kernel)."""
    if isinstance(cache, (PagedKVCache, QuantPagedKVCache)):
        return forward_step_paged(cfg, params, tokens, cache)
    return _slotted_forward_step(cfg, params, tokens, cache,
                                 use_kernel=kernel_route(cfg))


@dataclasses.dataclass
class BatchState:
    """Device state of a batch generation."""

    buf: torch.Tensor         # [B, S] int64 committed tokens (prompt + gen)
    pos: torch.Tensor         # [B] int32 committed length per sequence
    prompt_len: torch.Tensor  # [B] int32
    total_len: torch.Tensor   # [B] int32 per-sequence generation cap
    finished: torch.Tensor    # [B] bool
    d_cache: Optional[object]  # a slotted or paged cache, or None
    t_cache: object            # a slotted or paged cache
    accepted: torch.Tensor    # [B] int32
    speculated: torch.Tensor  # [B] int32
    # optional per-slot (temperature, top_k, top_p) [B, 3] f32, consumed by
    # PerSlotProcessor for per-request sampling; None = uniform
    samp: Optional[torch.Tensor] = None


def _pack_state(state: BatchState) -> torch.Tensor:
    """[B, S+5]: buf ++ [pos, prompt_len, accepted, speculated, finished],
    so a harvest is ONE device-to-host copy."""
    cols = torch.stack([state.pos, state.prompt_len, state.accepted,
                        state.speculated, state.finished.to(torch.int32)],
                       dim=1)
    return torch.cat([state.buf, cols.to(state.buf.dtype)], dim=1)


def _unpack_state(packed: np.ndarray):
    """(buf, pos, prompt_len, accepted, speculated, finished) from the host
    copy of ``_pack_state``'s output."""
    buf = packed[:, :-5]
    pos, plen, acc, spec, fin = (packed[:, -5 + i] for i in range(5))
    return buf, pos, plen, acc, spec, fin.astype(bool)


def _gather_at(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf[b, idx[b]] for each b (idx clamped into the row)."""
    idx = torch.clamp(idx.to(torch.int64), 0, buf.shape[1] - 1)
    return buf.gather(1, idx[:, None])[:, 0]


def _put_block(buf: torch.Tensor, vals: torch.Tensor, start: torch.Tensor,
               keep: torch.Tensor) -> None:
    """buf[b, start[b]:start[b]+n] = vals[b] in place, except rows where
    ``keep`` is set. As ``lax.dynamic_update_slice`` does, a start is
    clamped so the block fits the row."""
    n = vals.shape[1]
    cols = (torch.clamp(start.to(torch.int64), 0, buf.shape[1] - n)[:, None]
            + torch.arange(n, device=buf.device)[None, :])
    vals = torch.where(keep[:, None], buf.gather(1, cols), vals.to(buf.dtype))
    buf.scatter_(1, cols, vals)


def _new_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def batch_prefill(drafter_cfg: Optional[ModelConfig], drafter_params,
                  target_cfg: ModelConfig, target_params,
                  prompts: torch.Tensor, prompt_lens: torch.Tensor,
                  gen_len: int, gamma: int,
                  processor: LogitsProcessor, first_target: bool,
                  use_drafter: bool, eos_ids: Tuple[int, ...],
                  generator: torch.Generator, samp=None,
                  route: bool = True) -> BatchState:
    """Prefill both models on right-padded prompts [B, P] on new slotted
    caches; optionally commit the first token from the target.
    ``route=False`` keeps the config's ``attention_impl`` rule in place of
    the batch engine's kernel route, for a loop whose later forwards are
    its own (the n-gram loop's)."""
    fwd = forward_step if route else _slotted_forward_step
    device = prompts.device
    B, P = prompts.shape
    S = P + gen_len + gamma + 2
    buf = torch.zeros((B, S), dtype=torch.int64, device=device)
    buf[:, :P] = prompts

    max_pos = target_cfg.max_position_embeddings
    if use_drafter:
        max_pos = min(max_pos, drafter_cfg.max_position_embeddings)
    total_len = torch.clamp_max(prompt_lens + gen_len, max_pos)

    t_cache = init_cache(target_cfg, B, S, device=device)
    t_logits, t_cache = fwd(target_cfg, target_params, prompts, t_cache)
    d_cache = None
    if use_drafter:
        d_cache = init_cache(drafter_cfg, B, S, device=device)
        _, d_cache = fwd(drafter_cfg, drafter_params, prompts, d_cache)

    rows = torch.arange(B, device=device)
    if first_target:
        last = t_logits[rows, (prompt_lens - 1).to(torch.int64)]   # [B, V]
        tok0 = processor.sample_batched(processor.batched(last, samp),
                                        generator, samp)
        buf[rows, prompt_lens.to(torch.int64)] = tok0
        pos = prompt_lens + 1
        finished = eos_mask(tok0, eos_ids) | (pos >= total_len)
    else:
        pos = prompt_lens.clone()
        finished = pos >= total_len

    t_cache = t_cache.with_length(pos - 1)
    if use_drafter:
        # drafter invariant: covers pos-2 (the window's first draft step
        # feeds two tokens)
        d_cache = d_cache.with_length(pos - 2)
    zeros = torch.zeros((B,), dtype=torch.int32, device=device)
    return BatchState(buf=buf, pos=pos, prompt_len=prompt_lens.clone(),
                      total_len=total_len, finished=finished,
                      d_cache=d_cache, t_cache=t_cache,
                      accepted=zeros, speculated=zeros.clone(), samp=samp)


def _spec_window_body(drafter_cfg: ModelConfig, drafter_params,
                      target_cfg: ModelConfig, target_params,
                      state: BatchState, gamma: int,
                      processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                      skip_sample_adjustment: bool,
                      generator: torch.Generator) -> BatchState:
    """One gamma-draft / verify / accept window for the whole batch, in the
    tracer's spans ``draft``, ``verify`` and ``commit``; the callers open
    ``window`` around it."""
    B = state.buf.shape[0]
    samp, pos = state.samp, state.pos

    # --- draft: gamma drafter forwards; the first feeds buf[pos-2:pos] ---
    with TRACER.span("draft"):
        first_tok = _gather_at(state.buf, pos - 1)               # [B]
        prev2 = torch.stack([_gather_at(state.buf, pos - 2), first_tok],
                            dim=1)
        logits, d_cache = forward_step(drafter_cfg, drafter_params, prev2,
                                       state.d_cache)
        q = processor.batched(logits[:, 1], samp)                # [B, V]
        x = processor.sample_batched(q, generator, samp)
        qs, xs = [q], [x]
        for _ in range(1, gamma):
            logits, d_cache = forward_step(drafter_cfg, drafter_params,
                                           x[:, None], d_cache)
            q = processor.batched(logits[:, 0], samp)
            x = processor.sample_batched(q, generator, samp)
            qs.append(q)
            xs.append(x)
        q_all = torch.stack(qs, dim=1)                           # [B, g, V]
        drafts = torch.stack(xs, dim=1)                          # [B, g]

    # --- verify: one target forward over gamma+1 positions -----------------
    with TRACER.span("verify"):
        t_in = torch.cat([first_tok[:, None], drafts], dim=1)
        t_logits, t_cache = forward_step(target_cfg, target_params, t_in,
                                         state.t_cache)
        p_all = processor.batched(t_logits, samp)                # [B, g+1, V]

    # --- accept / residual, commit, bookkeeping over corrected_gamma -------
    with TRACER.span("commit"):
        r = uniform((B, gamma), generator, state.buf.device)
        n, next_tok = accept_step(p_all, q_all, drafts, r, processor,
                                  generator, skip_sample_adjustment, samp)
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
        d_cache=d_cache.with_length(new_pos - 2),
        t_cache=t_cache.with_length(new_pos - 1),
        accepted=accepted.to(torch.int32),
        speculated=speculated.to(torch.int32))


def batch_spec_window(drafter_cfg, drafter_params, target_cfg, target_params,
                      state: BatchState, gamma: int,
                      processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                      skip_sample_adjustment: bool,
                      generator: torch.Generator) -> BatchState:
    """One window (see ``_spec_window_body``); no host read."""
    with TRACER.span("window"):
        return _spec_window_body(drafter_cfg, drafter_params, target_cfg,
                                 target_params, state, gamma, processor,
                                 eos_ids, skip_sample_adjustment, generator)


def batch_spec_windows(drafter_cfg, drafter_params, target_cfg, target_params,
                       state: BatchState, gamma: int,
                       processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                       skip_sample_adjustment: bool,
                       generator: torch.Generator,
                       max_windows: int) -> BatchState:
    """Up to ``max_windows`` windows, stopping early once every row is
    finished: one host read (the finished check) before each window."""
    for _ in range(max_windows):
        with TRACER.span("sync.finished_check"):
            done = bool(state.finished.all())
        if done:
            break
        with TRACER.span("window"):
            state = _spec_window_body(
                drafter_cfg, drafter_params, target_cfg, target_params,
                state, gamma, processor, eos_ids, skip_sample_adjustment,
                generator)
    return state


def batch_ar_step(target_cfg: ModelConfig, target_params, state: BatchState,
                  processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                  generator: torch.Generator) -> BatchState:
    """One batched AR token step; no host read."""
    last = _gather_at(state.buf, state.pos - 1)
    logits, t_cache = forward_step(target_cfg, target_params, last[:, None],
                                   state.t_cache)
    tok = processor.sample_from_logits_batched(logits[:, 0], generator,
                                               state.samp)
    stop = state.finished | (state.pos >= state.total_len)
    _put_block(state.buf, tok[:, None], state.pos, state.finished)
    new_pos = (state.pos + torch.where(stop, 0, 1)).to(torch.int32)
    finished = (state.finished | eos_mask(tok, eos_ids)
                | (new_pos >= state.total_len))
    return dataclasses.replace(state, pos=new_pos, finished=finished,
                               t_cache=t_cache.with_length(new_pos - 1))


# ---------------------------------------------------------------------------
# Host-side drivers
# ---------------------------------------------------------------------------

def _pad_batch(prompt_ids: Sequence[Sequence[int]], pad_id: int, device,
               bucket: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    lens = [len(p) for p in prompt_ids]
    P = max(bucket, ((max(lens) + bucket - 1) // bucket) * bucket)
    arr = np.full((len(prompt_ids), P), pad_id, dtype=np.int64)
    for i, p in enumerate(prompt_ids):
        arr[i, :len(p)] = np.asarray(p, dtype=np.int64)
    return (torch.from_numpy(arr).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device))


def data_split(target_params, prompts: torch.Tensor, lens: torch.Tensor,
               generator: torch.Generator):
    """(mesh, prompts, lens, generator) of this data rank: under a mesh of
    dp > 1 its rows of the padded batch and a ``DataRowsGenerator`` in the
    state of ``generator``; else None and the arguments unchanged. A batch that does not split evenly over the
    data ranks (a single request) runs whole on each of them, as the JAX
    package's replicated batch does."""
    mesh = target_params.get("mesh")
    if mesh is None or mesh.dp == 1 or prompts.shape[0] % mesh.dp:
        return None, prompts, lens, generator
    rows = batch_state_pspecs(mesh, prompts.shape[0])
    g = DataRowsGenerator(prompts.device, prompts.shape[0], rows.start)
    g.set_state(generator.get_state())
    return mesh, prompts[rows], lens[rows], g


def stamp_first_tokens(callback, state, n_rows: int) -> None:
    """Call ``callback(i)`` for every row of the caller's batch once this
    rank's first window has completed (a host read waits for it). Under a
    data-parallel mesh the other data ranks run their first windows at the
    same time, so every row's first token is stamped here, on one clock:
    TTFT keeps one definition for all rows."""
    if callback is None:
        return
    state.pos.tolist()
    for i in range(n_rows):
        callback(i)


def gather_rows(mesh, *per_row):
    """Each argument (a per-row list of this data rank) concatenated over
    the data ranks, in data-index order; unchanged without a mesh."""
    if mesh is None:
        return per_row if len(per_row) > 1 else per_row[0]
    parts = mesh.gather_rows(per_row)
    out = tuple([x for p in parts for x in p[i]]
                for i in range(len(per_row)))
    return out if len(out) > 1 else out[0]


def _outputs(state: BatchState):
    buf, pos, plen, acc, spec, _ = _unpack_state(
        _pack_state(state).cpu().numpy())
    outs = [buf[i, plen[i]:pos[i]].tolist() for i in range(buf.shape[0])]
    return outs, acc, spec


def batch_speculative_generate(
    prompt_ids: Sequence[Sequence[int]],
    drafter_cfg: ModelConfig, drafter_params,
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
    """Batched speculative generation on slotted caches. Returns (per-seq
    generated token lists, per-seq acceptance rates). ``generator`` (or a
    new one seeded with ``seed``) draws for every row; ``device=None`` means
    the card."""
    device = resolve_device(device)
    processor = logits_processor or GreedyProcessor()
    generator = generator or _new_generator(device, seed)
    eos_ids = normalize_eos(eos_tokens_id)
    prompts, lens = _pad_batch(prompt_ids, pad_token_id, device)
    mesh, prompts, lens, generator = data_split(
        target_params, prompts, lens, generator)
    B = prompts.shape[0]

    state = batch_prefill(drafter_cfg, drafter_params, target_cfg,
                          target_params, prompts, lens, int(gen_len),
                          int(gamma), processor, bool(first_target), True,
                          eos_ids, generator)
    # the first window alone: its end is the first verified tokens (TTFT)
    state = batch_spec_window(drafter_cfg, drafter_params, target_cfg,
                              target_params, state, int(gamma), processor,
                              eos_ids, bool(skip_sample_adjustment),
                              generator)
    stamp_first_tokens(first_token_callback, state, len(prompt_ids))
    # every window advances each unfinished row by >= 1 token
    state = batch_spec_windows(drafter_cfg, drafter_params, target_cfg,
                               target_params, state, int(gamma), processor,
                               eos_ids, bool(skip_sample_adjustment),
                               generator, int(gen_len) + 1)
    outs, acc, spec = _outputs(state)
    rates = [float(acc[i]) / float(spec[i]) if spec[i] > 0 else 0.0
             for i in range(B)]
    return gather_rows(mesh, outs, rates)


def batch_autoregressive_generate(
    prompt_ids: Sequence[Sequence[int]],
    target_cfg: ModelConfig, target_params,
    gen_len: int = 100,
    logits_processor: Optional[LogitsProcessor] = None,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    first_token_callback: Optional[Callable[[int], None]] = None,
    steps_per_host_sync: int = 16,
    device=None,
) -> List[List[int]]:
    """Batched AR baseline: ``steps_per_host_sync`` steps between
    finished-mask checks (host reads)."""
    device = resolve_device(device)
    processor = logits_processor or GreedyProcessor()
    generator = generator or _new_generator(device, seed)
    eos_ids = normalize_eos(eos_tokens_id)
    prompts, lens = _pad_batch(prompt_ids, pad_token_id, device)
    mesh, prompts, lens, generator = data_split(
        target_params, prompts, lens, generator)

    state = batch_prefill(None, None, target_cfg, target_params, prompts,
                          lens, int(gen_len), 0, processor, True, False,
                          eos_ids, generator)
    stamp_first_tokens(first_token_callback, state, len(prompt_ids))
    step = 0
    while step < gen_len + 1 and not bool(state.finished.all()):
        for _ in range(steps_per_host_sync):
            state = batch_ar_step(target_cfg, target_params, state,
                                  processor, eos_ids, generator)
            step += 1
    return gather_rows(mesh, _outputs(state)[0])
