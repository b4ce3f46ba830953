"""Continuous batching over the paged KV cache
(counterpart of ``specdec_tpu/serve/paged_scheduler.py``).

Extends ``ContinuousBatcher`` with vLLM-style memory management: K/V pages
come from a shared pool sized in tokens, sequences allocate pages as they
grow (host free list; the device only sees int32 page tables), and a
finished request's pages return to the pool at harvest. The window step is
unchanged (``engine/batch_engine.py`` dispatches on the cache type); the
target verifies through the paged decode-attention kernel.

Admission is queued while the pool cannot cover the request's prompt plus
one dispatch horizon; each step tops up active slots so the next dispatch's
windows always have backing pages, and preempts the newest slots when the
pool runs dry.

The admission programs edit ``state`` in place (pools, tables, buffer row,
counters) and return it with new cache lengths:

- ``_admit_slot_dense``: prefill on batch-of-one SLOTTED scratch caches,
  then move the rows into pool pages with one scatter per array. Taken for
  every admission with nothing cached and no earlier chunk, which is every
  admission of the default configuration.
- ``_admit_slot_hybrid`` / ``_admit_slot_paged``: partial prefill through
  the pool after a prefix-cache hit or the chunks of a chunked prefill
  (paged target, slotted or paged drafter).
- ``_prefill_chunk``: one non-final chunk of a chunked prefill.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from specdec_tpu_torch.core.cache import (
    init_cache, install_slot, with_row_length, write_scalar,
)
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step, forward_step_paged
from specdec_tpu_torch.core.paged_cache import (
    PageAllocator, init_paged_cache, install_sequence_pages, paged_view,
    required_pages,
)
from specdec_tpu_torch.engine.batch_engine import BatchState
from specdec_tpu_torch.engine.metrics import RequestMetrics
from specdec_tpu_torch.sampling.processors import LogitsProcessor
from specdec_tpu_torch.serve.prefix_cache import PrefixBlockCache, block_keys
from specdec_tpu_torch.serve.scheduler import (
    ContinuousBatcher, Request, _first_token, _install_row,
)
from specdec_tpu_torch.utils.profiling import TRACER


def _admit_slot_paged(drafter_cfg: ModelConfig, drafter_params,
                      target_cfg: ModelConfig, target_params,
                      state: BatchState, slot: int,
                      prompt: torch.Tensor, suffix: torch.Tensor,
                      cached_len: int, prompt_len: int, max_new: int,
                      t_row: torch.Tensor, d_row: torch.Tensor,
                      processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                      generator: torch.Generator) -> BatchState:
    """Both models paged: write the slot's table rows, prefill ``suffix``
    (prompt[cached_len:], zero-padded to its bucket) through batch-of-one
    views of the shared pools at view length ``cached_len``, commit tok0.

    RoPE positions and the causal mask come out exactly as a full prefill's;
    the first cached_len positions are READ from the shared pages. Padding
    past prompt_len writes into this slot's own future pages (or garbage
    page 0): never attended before being overwritten, since a query at
    position p only admits keys <= p."""
    t_cache, d_cache = state.t_cache, state.d_cache
    t_cache.page_table[slot] = t_row
    d_cache.page_table[slot] = d_row
    t_logits, _ = forward_step_paged(
        target_cfg, target_params, suffix[None, :],
        paged_view(t_cache, t_row, cached_len))
    forward_step_paged(drafter_cfg, drafter_params, suffix[None, :],
                       paged_view(d_cache, d_row, cached_len))
    tok0, pos, total, finished = _first_token(
        target_cfg, drafter_cfg, t_logits[:, :prompt_len - cached_len],
        prompt_len, max_new, processor, eos_ids, generator, prompt.device)
    _install_row(state, slot, prompt, prompt_len, tok0, pos, total, finished)
    return dataclasses.replace(
        state, t_cache=with_row_length(t_cache, slot, pos - 1),
        # drafter invariant: covers pos-2 (two-token first draft step)
        d_cache=with_row_length(d_cache, slot, pos - 2))


def _admit_slot_hybrid(drafter_cfg: ModelConfig, drafter_params,
                       target_cfg: ModelConfig, target_params,
                       state: BatchState, slot: int,
                       prompt: torch.Tensor, suffix: torch.Tensor,
                       cached_len: int, prompt_len: int, max_new: int,
                       t_row: torch.Tensor,
                       processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                       generator: torch.Generator) -> BatchState:
    """Hybrid layout: the target prefills through its pool (partial, as in
    ``_admit_slot_paged``), the drafter prefills the FULL prompt on a
    batch-of-one slotted scratch cache copied into its slotted row.

    Why hybrid is the default: the window runs gamma sequential T=1 drafter
    steps per verify, where the paged indirection costs most; a slotted
    (shallow) drafter skips it, while the target's pool, which holds most
    of the KV, keeps the memory elasticity."""
    S = state.buf.shape[1]
    t_cache = state.t_cache
    t_cache.page_table[slot] = t_row
    t_logits, _ = forward_step_paged(
        target_cfg, target_params, suffix[None, :],
        paged_view(t_cache, t_row, cached_len))
    d1 = init_cache(drafter_cfg, 1, S, device=prompt.device)
    _, d1 = forward_step(drafter_cfg, drafter_params, prompt[None, :], d1)
    tok0, pos, total, finished = _first_token(
        target_cfg, drafter_cfg, t_logits[:, :prompt_len - cached_len],
        prompt_len, max_new, processor, eos_ids, generator, prompt.device)
    _install_row(state, slot, prompt, prompt_len, tok0, pos, total, finished)
    return dataclasses.replace(
        state, t_cache=with_row_length(t_cache, slot, pos - 1),
        d_cache=install_slot(state.d_cache, d1, slot, pos - 2))


def _admit_slot_dense(drafter_cfg: ModelConfig, drafter_params,
                      target_cfg: ModelConfig, target_params,
                      state: BatchState, slot: int,
                      prompt: torch.Tensor, prompt_len: int, max_new: int,
                      t_row: torch.Tensor, d_row: torch.Tensor,
                      processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                      generator: torch.Generator,
                      drafter_paged: bool = False) -> BatchState:
    """Dense-prefill admission: prefill the prompt on batch-of-one SLOTTED
    scratch caches with the plain ``forward_step`` (the slotted scheduler's
    admission, no paged attention over the prompt), then scatter the rows
    into the pool pages with ONE scatter per array
    (``install_sequence_pages``). Stored KV bits are those a paged prefill
    would write; only the prompt forward's access pattern differs."""
    S = state.buf.shape[1]
    device = prompt.device
    t1 = init_cache(target_cfg, 1, S, device=device)
    t_logits, t1 = forward_step(target_cfg, target_params, prompt[None, :],
                                t1)
    d1 = init_cache(drafter_cfg, 1, S, device=device)
    _, d1 = forward_step(drafter_cfg, drafter_params, prompt[None, :], d1)
    tok0, pos, total, finished = _first_token(
        target_cfg, drafter_cfg, t_logits[:, :prompt_len], prompt_len,
        max_new, processor, eos_ids, generator, device)

    t_cache = state.t_cache
    t_cache.page_table[slot] = t_row
    install_sequence_pages(t_cache, t_row, t1)
    if drafter_paged:
        d_cache = state.d_cache
        d_cache.page_table[slot] = d_row
        install_sequence_pages(d_cache, d_row, d1)
        # drafter invariant: covers pos-2 (two-token first draft step)
        d_cache = with_row_length(d_cache, slot, pos - 2)
    else:
        d_cache = install_slot(state.d_cache, d1, slot, pos - 2)
    _install_row(state, slot, prompt, prompt_len, tok0, pos, total, finished)
    return dataclasses.replace(
        state, t_cache=with_row_length(t_cache, slot, pos - 1),
        d_cache=d_cache)


def _prefill_chunk(drafter_cfg: ModelConfig, drafter_params,
                   target_cfg: ModelConfig, target_params,
                   state: BatchState, chunk: torch.Tensor, offset: int,
                   t_row: torch.Tensor, d_row: torch.Tensor,
                   drafter_paged: bool = True) -> BatchState:
    """One non-final chunk of a chunked prefill: write a [C]-token slice of
    a pending request's prompt into the pool(s) at ``offset`` (positions
    from the view length). Only the pools change; the slot's counters and
    buffer wait for the final chunk's admission. In the hybrid layout the
    drafter prefills its whole prompt in that admission."""
    forward_step_paged(target_cfg, target_params, chunk[None, :],
                       paged_view(state.t_cache, t_row, offset))
    if drafter_paged:
        forward_step_paged(drafter_cfg, drafter_params, chunk[None, :],
                           paged_view(state.d_cache, d_row, offset))
    return state


class PagedContinuousBatcher(ContinuousBatcher):
    def __init__(self, drafter_cfg: ModelConfig, drafter_params,
                 target_cfg: ModelConfig, target_params,
                 num_slots: int = 4, gamma: int = 4,
                 max_prompt_len: int = 256, max_new_tokens: int = 128,
                 page_size: int = 64, pool_tokens: Optional[int] = None,
                 prefix_caching: bool = False,
                 prefill_buckets: Optional[Tuple[int, ...]] = None,
                 prefill_chunk: Optional[int] = None,
                 drafter_paged: bool = False,
                 **kw):
        super().__init__(drafter_cfg, drafter_params, target_cfg,
                         target_params, num_slots=num_slots, gamma=gamma,
                         max_prompt_len=max_prompt_len,
                         max_new_tokens=max_new_tokens, **kw)
        self.page_size = page_size
        # hybrid layout (default): target KV paged, drafter KV slotted;
        # drafter_paged=True pools both
        self.drafter_paged = drafter_paged
        # default pool: half of what per-slot reservation would need
        pool_tokens = pool_tokens or (self.B * self.S + self.S) // 2
        # the table must cover _needed_now at max length: S tokens plus one
        # full dispatch horizon at the largest gamma a retune may reach
        horizon = self.windows_per_sync * (self.auto_gamma_max + 1) + 1
        self.max_pages_per_seq = required_pages(self.S + horizon,
                                                page_size) + 1
        self.num_pages = max(required_pages(pool_tokens, page_size),
                             2 * self.max_pages_per_seq)

        caches = dict(t_cache=init_paged_cache(
            target_cfg, self.B, self.num_pages, page_size,
            self.max_pages_per_seq, device=self.device))
        if drafter_paged:
            caches["d_cache"] = init_paged_cache(
                drafter_cfg, self.B, self.num_pages, page_size,
                self.max_pages_per_seq, device=self.device)
        # hybrid: d_cache stays the slotted [L, B, S] cache of super()
        self.state = dataclasses.replace(self.state, **caches)
        # separate pools per model (page ids are per pool)
        self._alloc_t = PageAllocator(self.num_pages)
        self._alloc_d = PageAllocator(self.num_pages if drafter_paged else 1)
        # page 0 is the garbage page: inactive and finished slots' tables
        # point at it, so their masked writes never reach a live page
        self._alloc_t.alloc("_garbage", 1)
        if drafter_paged:
            self._alloc_d.alloc("_garbage", 1)
        self._slot_pages_t: List[List[int]] = [[] for _ in range(self.B)]
        self._slot_pages_d: List[List[int]] = [[] for _ in range(self.B)]
        self._tables_dirty = False
        self.preemptions = 0

        # vLLM-style automatic prefix caching (serve/prefix_cache.py):
        # content-addressed prompt pages shared across requests
        self.prefix_caching = prefix_caching
        self.prefix_cache = PrefixBlockCache()
        # vLLM-style chunked prefill: long prompts prefill in
        # <= prefill_chunk-token slices, ONE slice per step, so other slots'
        # windows interleave with a long admission
        self.prefill_chunk = prefill_chunk
        if prefill_buckets is None:
            P = max_prompt_len
            if prefix_caching or prefill_chunk:
                cap = min(prefill_chunk or P, P)
                buckets = sorted({max(page_size, cap // 4), cap // 2, cap})
                prefill_buckets = tuple(b for b in buckets
                                        if page_size <= b <= cap) or (cap,)
            else:
                # without reuse the suffix is always the whole prompt
                prefill_buckets = (P,)
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self._slot_shared: List[List[int]] = [[] for _ in range(self.B)]
        # slot -> [req, block_keys, matched_blocks, prompt_len, offset]
        self._prefilling: dict = {}

    # ------------------------------------------------------------ page mgmt
    def _needed_now(self, length: int) -> int:
        """Pages to cover ``length`` tokens plus one full dispatch:
        windows_per_sync windows can each commit gamma+1 tokens before the
        next top-up. A shorter horizon lets later windows write past the
        provisioned pages into the shared garbage page."""
        horizon = self.windows_per_sync * (self.gamma + 1) + 1
        return required_pages(length + horizon, self.page_size)

    def _row(self, pages: List[int]) -> np.ndarray:
        row = np.zeros((self.max_pages_per_seq,), np.int32)
        row[:len(pages)] = pages
        return row

    def _table_row(self, pages: List[int]) -> torch.Tensor:
        with TRACER.span("sync.h2d"):
            return torch.from_numpy(self._row(pages)).to(self.device)

    def _alloc(self, alloc: PageAllocator, owner, n: int) -> List[int]:
        """Allocator front door: with prefix caching, an empty free list is
        pressure, not exhaustion: evict LRU refcount-0 blocks (one page in
        EACH pool) before letting MemoryError reach the preemption path."""
        deficit = n - len(alloc.free)
        if deficit > 0 and self.prefix_caching:
            t_pages, d_pages = self.prefix_cache.reclaim(deficit)
            self._alloc_t.free.extend(t_pages)
            # hybrid entries carry d_page=-1 (no drafter pool)
            self._alloc_d.free.extend(p for p in d_pages if p >= 0)
        return alloc.alloc(owner, n)

    def _release_slot_pages(self, slot: int, req: Request):
        """Return a slot's pages: owned ones to the free lists, shared
        prefix blocks by refcount (they stay cached for reuse)."""
        self._alloc_t.free_owner(("t", slot, req.request_id))
        self._alloc_d.free_owner(("d", slot, req.request_id))
        for key in self._slot_shared[slot]:
            self.prefix_cache.release(key)
        self._slot_shared[slot] = []
        self._slot_pages_t[slot] = []
        self._slot_pages_d[slot] = []

    def _preempt(self, slot: int):
        """Pool pressure: send this slot's request back to the queue FRONT
        and recycle its pages (recompute-mode preemption: the request
        restarts from its prompt on re-admission)."""
        req = self.slot_req[slot]
        self._release_slot_pages(slot, req)
        self.slot_req[slot] = None
        self._slot_first_token[slot] = None
        self.queue.insert(0, req)
        self.preemptions += 1
        write_scalar(self.state.finished, slot, True)
        self._tables_dirty = True

    def _top_up(self):
        """Give every active slot pages for the next dispatch and push the
        changed tables to the device. A slot that cannot grow is PREEMPTED,
        so the pool never deadlocks the batch, unless a single request alone
        exceeds the pool, which is a sizing error and raises.

        Positions come from the host mirror ``_host_pos``: every path that
        advances ``pos`` before this point also refreshes it (the window
        harvest, the admission stamp), so no device read is needed."""
        changed = self._tables_dirty
        self._tables_dirty = False
        pos = self._host_pos
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is None:
                continue
            need = self._needed_now(int(pos[slot]))
            pools = [(self._alloc_t, self._slot_pages_t[slot], "t")]
            if self.drafter_paged:
                pools.append((self._alloc_d, self._slot_pages_d[slot], "d"))
            try:
                for alloc, pages, tag in pools:
                    if len(pages) < need:
                        pages.extend(self._alloc(
                            alloc, (tag, slot, req.request_id),
                            need - len(pages)))
                        changed = True
            except MemoryError:
                if sum(r is not None for r in self.slot_req) == 1:
                    raise MemoryError(
                        f"page pool ({self.num_pages} pages) cannot back even "
                        f"one request of length {int(pos[slot])}+gamma; "
                        f"increase pool_tokens") from None
                self._preempt(slot)
                changed = True
        if changed:
            # PREFILLING slots keep an all-garbage device row until their
            # final admission installs the real one: they are finished while
            # pending, and a finished slot's masked window writes scatter
            # through its device row, so a real row here would let them
            # corrupt the half-prefilled pages (the chunk programs address
            # the pages through their own explicit row)
            def table(slot_pages):
                rows = np.stack([self._row([] if s in self._prefilling else p)
                                 for s, p in enumerate(slot_pages)])
                with TRACER.span("sync.h2d"):
                    return torch.from_numpy(rows).to(self.device)

            new = dict(t_cache=dataclasses.replace(
                self.state.t_cache, page_table=table(self._slot_pages_t)))
            if self.drafter_paged:
                new["d_cache"] = dataclasses.replace(
                    self.state.d_cache,
                    page_table=table(self._slot_pages_d))
            self.state = dataclasses.replace(self.state, **new)

    # ------------------------------------------------------------ overrides
    def _match_blocks(self, req: Request) -> Tuple[List[int], int]:
        """(all block keys of the truncated prompt, matched block count).
        The match is capped at prompt_len-1 tokens: the admission must
        forward at least the last prompt token to produce tok0's logits, and
        the cap keeps the drafter's first-draft rewrite of position
        prompt_len-1 out of shared pages."""
        n = min(len(req.prompt_ids), self.max_prompt_len)
        keys = block_keys(req.prompt_ids[:n], self.page_size)
        m = min(self.prefix_cache.match_len(keys),
                (n - 1) // self.page_size)
        return keys, m

    def _can_admit(self, req: Request) -> bool:
        need = self._needed_now(min(len(req.prompt_ids), self.max_prompt_len)
                                + 1)
        if not self.prefix_caching:
            return (len(self._alloc_t.free) >= need and
                    (not self.drafter_paged
                     or len(self._alloc_d.free) >= need))
        _, m = self._match_blocks(req)
        avail = len(self._alloc_t.free)
        if self.drafter_paged:
            avail = min(avail, len(self._alloc_d.free))
        return need - m <= avail + self.prefix_cache.evictable

    def _begin_admit(self, slot: int, req: Request):
        """Acquire prefix blocks and allocate pages for the whole prompt;
        mark the slot prefilling (offset starts past the cached prefix)."""
        n = min(len(req.prompt_ids), self.max_prompt_len)
        need = self._needed_now(n + 1)
        keys: List[int] = []
        m = 0
        hits = []
        if self.prefix_caching:
            keys, m = self._match_blocks(req)
            for k in keys[:m]:
                self.prefix_cache.acquire(k)
            hits = [self.prefix_cache.pages(k) for k in keys[:m]]
            self.prefix_cache.hit_tokens += m * self.page_size
            self.prefix_cache.lookup_tokens += n
        req.dequeue_time = req.dequeue_time or time.time()
        self._slot_shared[slot] = list(keys[:m])
        owner_t, owner_d = ("t", slot, req.request_id), ("d", slot, req.request_id)
        self._slot_pages_t[slot] = ([h[0] for h in hits]
                                    + self._alloc(self._alloc_t, owner_t,
                                                  need - m))
        if self.drafter_paged:
            self._slot_pages_d[slot] = ([h[1] for h in hits]
                                        + self._alloc(self._alloc_d, owner_d,
                                                      need - m))
        self._prefilling[slot] = [req, keys, m, n, m * self.page_size]

    def _tokens(self, ids: List[int], length: int) -> torch.Tensor:
        """``ids`` zero-padded to ``length``, on the device."""
        arr = np.zeros((length,), np.int64)
        arr[:len(ids)] = ids
        with TRACER.span("sync.h2d"):
            return torch.from_numpy(arr).to(self.device)

    def _advance_prefill(self, slot: int) -> bool:
        """Run ONE prefill slice of a pending slot. Non-final slices only
        write the pools (``_prefill_chunk``); the final slice is an
        admission that commits tok0 and installs the counters. Returns True
        when the slot became active."""
        req, keys, m, n, offset = self._prefilling[slot]
        P = self.max_prompt_len
        chunk = self.prefill_chunk or P
        remaining = n - offset
        t_row = self._table_row(self._slot_pages_t[slot])
        d_row = self._table_row(self._slot_pages_d[slot])
        models = (self.drafter_cfg, self.drafter_params, self.target_cfg,
                  self.target_params, self.state)
        if remaining > chunk:
            tokens = self._tokens(req.prompt_ids[offset:offset + chunk],
                                  chunk)
            if TRACER.on:
                TRACER.note(prompt=chunk)
            with TRACER.span("prefill"):
                self.state = _prefill_chunk(
                    *models, tokens, offset, t_row, d_row,
                    drafter_paged=self.drafter_paged)
            self._prefilling[slot][4] = offset + chunk
            return False

        bucket = next((b for b in self.prefill_buckets if b >= remaining), P)
        prompt = self._tokens(req.prompt_ids[:n], P)
        tail = (self.processor, self.eos_ids, self.generator)
        if offset == 0:
            # nothing cached and no earlier chunk: dense-prefill admission
            if TRACER.on:
                TRACER.note(prompt=n)
            with TRACER.span("prefill"):
                self.state = _admit_slot_dense(
                    *models, slot, prompt, n, req.max_new_tokens, t_row,
                    d_row, *tail, drafter_paged=self.drafter_paged)
        else:
            suffix = self._tokens(req.prompt_ids[offset:n], bucket)
            if TRACER.on:
                TRACER.note(prompt=remaining)
            with TRACER.span("prefill"):
                if self.drafter_paged:
                    self.state = _admit_slot_paged(
                        *models, slot, prompt, suffix, offset, n,
                        req.max_new_tokens, t_row, d_row, *tail)
                else:
                    self.state = _admit_slot_hybrid(
                        *models, slot, prompt, suffix, offset, n,
                        req.max_new_tokens, t_row, *tail)
        if self.prefix_caching:
            # hand the freshly prefilled full prompt blocks to the cache
            # (refcount 1, held by this slot until release)
            owner_t = ("t", slot, req.request_id)
            owner_d = ("d", slot, req.request_id)
            for i in range(m, n // self.page_size):
                tp = self._slot_pages_t[slot][i]
                dp = (self._slot_pages_d[slot][i]
                      if self.drafter_paged else -1)
                if self.prefix_cache.insert(keys[i], tp, dp):
                    self._alloc_t.disown(owner_t, tp)
                    if self.drafter_paged:
                        self._alloc_d.disown(owner_d, dp)
                    self._slot_shared[slot].append(keys[i])
        del self._prefilling[slot]
        self.slot_req[slot] = req
        req.metrics = RequestMetrics(
            prompt_tokens=n, start_time=req.submit_time,
            queue_seconds=(req.dequeue_time or req.submit_time)
            - req.submit_time)
        return True

    def _admit(self, slot: int, req: Request, sync: bool = True):
        with TRACER.span("admit", req.request_id):
            self._begin_admit(slot, req)
            while not self._advance_prefill(slot):
                pass
            if sync:
                self._stamp_admissions([slot])

    def _harvest(self, slot: int, buf, pos, plen, accepted, speculated):
        req = self.slot_req[slot]
        super()._harvest(slot, buf, pos, plen, accepted, speculated)
        if req is not None:
            self._release_slot_pages(slot, req)
            # stale table rows must stop pointing at recycled pages before
            # the next window runs
            self._tables_dirty = True

    def step(self):
        with TRACER.span("step"):
            worked = self._paged_step()
            if TRACER.on:
                # the target pool's pages held by slots, the garbage page
                # left out
                TRACER.note(
                    pages_held=self.num_pages - len(self._alloc_t.free) - 1,
                    pool_pages=self.num_pages - 1)
            return worked

    def _paged_step(self) -> bool:
        """The body of ``step``."""
        admitted = []
        # one prefill slice per pending slot per step: decode windows
        # interleave with long admissions instead of stalling behind them
        for slot in list(self._prefilling):
            with TRACER.span("admit", self._prefilling[slot][0].request_id):
                if self._advance_prefill(slot):
                    admitted.append(slot)
        for slot in range(self.B):
            if (self.slot_req[slot] is None and slot not in self._prefilling
                    and self.queue and self._can_admit(self.queue[0])):
                req = self.queue.pop(0)
                if self.prefill_chunk is None:
                    self._admit(slot, req, sync=False)
                    admitted.append(slot)
                else:
                    with TRACER.span("admit", req.request_id):
                        self._begin_admit(slot, req)
                        if self._advance_prefill(slot):  # short prompt
                            admitted.append(slot)
        if admitted:
            self._stamp_admissions(admitted)
        if all(r is None for r in self.slot_req):
            return bool(self._prefilling)
        with TRACER.span("top_up"):
            self._top_up()
        return super()._window_and_harvest()

    def run(self):
        while (self.queue or self._prefilling
               or any(r is not None for r in self.slot_req)):
            self.step()
        return self._gathered()
