"""Continuous batching over the paged KV cache
(counterpart of ``specdec_tpu/serve/paged_scheduler.py``).

Extends ``ContinuousBatcher`` with vLLM-style memory management: the
target's K/V pages come from a shared pool sized in tokens, sequences
allocate pages as they grow (host free list; the device only sees int32
page tables), and a finished request's pages return to the pool at
harvest. The drafter keeps slotted [B, S] rows (the hybrid layout; the JAX
package also pools the drafter, which the port does not). The window step
is unchanged (``engine/batch_engine.py`` dispatches on the cache type); the
target verifies through the paged decode-attention kernel, and the slotted
drafter drafts through the flash-decode kernel.

Admission is queued while the pool cannot cover the request's prompt plus
one dispatch horizon; each step tops up active slots so the next dispatch's
windows always have backing pages, and preempts the newest slots when the
pool runs dry.

An admission runs ``serve/scheduler.py::_admit_slot``, the model-drafter
batchers' one admission program, by one of its two paged target routes:

- dense prefill on a batch-of-one SLOTTED scratch cache, scattered into the
  slot's pages with one scatter per array, for every admission with nothing
  cached and no earlier chunk, which is every admission of the default
  configuration;
- partial prefill through the pool after a prefix-cache hit or the earlier
  chunks of a chunked prefill.

A non-final chunk of a chunked prefill only writes the target's pool; the
drafter prefills its whole prompt in the final chunk's admission.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from specdec_tpu_torch.core.cache import init_cache, write_scalar
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step_paged
from specdec_tpu_torch.core.paged_cache import (
    PageAllocator, init_paged_cache, paged_view, required_pages,
)
from specdec_tpu_torch.serve.prefix_cache import PrefixBlockCache, block_keys
from specdec_tpu_torch.serve.scheduler import (
    ContinuousBatcher, Request, _admit_slot,
)
from specdec_tpu_torch.utils.profiling import TRACER


class PagedContinuousBatcher(ContinuousBatcher):
    def __init__(self, drafter_cfg: ModelConfig, drafter_params,
                 target_cfg: ModelConfig, target_params,
                 num_slots: int = 4, gamma: int = 4,
                 max_prompt_len: int = 256, max_new_tokens: int = 128,
                 page_size: int = 64, pool_tokens: Optional[int] = None,
                 prefix_caching: bool = False,
                 prefill_buckets: Optional[Tuple[int, ...]] = None,
                 prefill_chunk: Optional[int] = None,
                 **kw):
        if target_cfg.kv_lora_rank and (prefix_caching or prefill_chunk):
            raise ValueError("a latent (MLA) cache takes neither prefix "
                             "caching nor chunked prefill")
        # read by _caches, which the base constructor calls
        self.page_size = page_size
        self._pool_tokens = pool_tokens
        super().__init__(drafter_cfg, drafter_params, target_cfg,
                         target_params, num_slots=num_slots, gamma=gamma,
                         max_prompt_len=max_prompt_len,
                         max_new_tokens=max_new_tokens, **kw)
        self._alloc_t = PageAllocator(self.num_pages)
        # page 0 is the garbage page: inactive and finished slots' tables
        # point at it, so their masked writes never reach a live page
        self._alloc_t.alloc("_garbage", 1)
        self._slot_pages_t: List[List[int]] = [[] for _ in range(self.B)]
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

    def _caches(self) -> dict:
        """The target's page pool and the drafter's slotted [B, S] cache.
        Sizes the pool: ``num_pages`` and the table's ``max_pages_per_seq``."""
        # default pool: half of what per-slot reservation would need
        pool_tokens = self._pool_tokens or (self.B * self.S + self.S) // 2
        # the table must cover _needed_now at max length: S tokens plus one
        # full dispatch horizon at the largest gamma a retune may reach
        horizon = self.windows_per_sync * (self.auto_gamma_max + 1) + 1
        self.max_pages_per_seq = required_pages(self.S + horizon,
                                                self.page_size) + 1
        self.num_pages = max(required_pages(pool_tokens, self.page_size),
                             2 * self.max_pages_per_seq)
        return dict(
            t_cache=init_paged_cache(
                self.target_cfg, self.B, self.num_pages, self.page_size,
                self.max_pages_per_seq, device=self.device),
            d_cache=init_cache(self.drafter_cfg, self.B, self.S,
                               device=self.device))

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

    def _alloc(self, owner, n: int) -> List[int]:
        """Allocator front door: with prefix caching, an empty free list is
        pressure, not exhaustion: evict LRU refcount-0 blocks before
        letting MemoryError reach the preemption path."""
        deficit = n - len(self._alloc_t.free)
        if deficit > 0 and self.prefix_caching:
            self._alloc_t.free.extend(self.prefix_cache.reclaim(deficit))
        return self._alloc_t.alloc(owner, n)

    def _release_slot_pages(self, slot: int, req: Request):
        """Return a slot's pages: owned ones to the free list, shared
        prefix blocks by refcount (they stay cached for reuse)."""
        self._alloc_t.free_owner((slot, req.request_id))
        for key in self._slot_shared[slot]:
            self.prefix_cache.release(key)
        self._slot_shared[slot] = []
        self._slot_pages_t[slot] = []

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
            pages = self._slot_pages_t[slot]
            if len(pages) >= need:
                continue
            try:
                pages.extend(self._alloc((slot, req.request_id),
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
            rows = np.stack([self._row([] if s in self._prefilling else p)
                             for s, p in enumerate(self._slot_pages_t)])
            with TRACER.span("sync.h2d"):
                table = torch.from_numpy(rows).to(self.device)
            self.state = dataclasses.replace(
                self.state, t_cache=dataclasses.replace(
                    self.state.t_cache, page_table=table))

    # ------------------------------------------------------------ overrides
    def _match_blocks(self, req: Request) -> Tuple[List[int], int]:
        """(all block keys of the truncated prompt, matched block count).
        The match is capped at prompt_len-1 tokens: the admission must
        forward at least the last prompt token to produce tok0's logits."""
        n = min(len(req.prompt_ids), self.max_prompt_len)
        keys = block_keys(req.prompt_ids[:n], self.page_size)
        m = min(self.prefix_cache.match_len(keys),
                (n - 1) // self.page_size)
        return keys, m

    def _can_admit(self, req: Request) -> bool:
        need = self._needed_now(min(len(req.prompt_ids), self.max_prompt_len)
                                + 1)
        if not self.prefix_caching:
            return len(self._alloc_t.free) >= need
        _, m = self._match_blocks(req)
        return (need - m
                <= len(self._alloc_t.free) + self.prefix_cache.evictable)

    def _begin_admit(self, slot: int, req: Request):
        """Acquire prefix blocks and allocate pages for the whole prompt;
        mark the slot prefilling (offset starts past the cached prefix)."""
        n = min(len(req.prompt_ids), self.max_prompt_len)
        need = self._needed_now(n + 1)
        keys: List[int] = []
        m = 0
        if self.prefix_caching:
            keys, m = self._match_blocks(req)
            for k in keys[:m]:
                self.prefix_cache.acquire(k)
            self.prefix_cache.hit_tokens += m * self.page_size
            self.prefix_cache.lookup_tokens += n
        req.dequeue_time = req.dequeue_time or time.time()
        self._slot_shared[slot] = list(keys[:m])
        self._slot_pages_t[slot] = (
            [self.prefix_cache.page(k) for k in keys[:m]]
            + self._alloc((slot, req.request_id), need - m))
        self._prefilling[slot] = [req, keys, m, n, m * self.page_size]

    def _advance_prefill(self, slot: int) -> bool:
        """Run ONE prefill slice of a pending slot. A non-final slice only
        writes the target's pool; the final slice is the admission program,
        which commits tok0 and installs the counters. Returns True when the
        slot became active."""
        req, keys, m, n, offset = self._prefilling[slot]
        P = self.max_prompt_len
        chunk = self.prefill_chunk or P
        remaining = n - offset
        t_row = self._table_row(self._slot_pages_t[slot])
        if remaining > chunk:
            tokens = self._tokens(req.prompt_ids[offset:offset + chunk],
                                  chunk)
            if TRACER.on:
                TRACER.note(prompt=chunk)
            with TRACER.span("prefill"):
                forward_step_paged(self.target_cfg, self.target_params,
                                   tokens[None, :],
                                   paged_view(self.state.t_cache, t_row,
                                              offset))
            self._prefilling[slot][4] = offset + chunk
            return False

        prompt = self._tokens(req.prompt_ids[:n], P)
        suffix = None
        if offset:
            bucket = next((b for b in self.prefill_buckets
                           if b >= remaining), P)
            suffix = self._tokens(req.prompt_ids[offset:n], bucket)
        if TRACER.on:
            TRACER.note(prompt=remaining)
        with TRACER.span("prefill"):
            self.state = _admit_slot(
                self.drafter_cfg, self.drafter_params, self.target_cfg,
                self.target_params, self.state, slot, prompt, n,
                req.max_new_tokens, self.processor, self.eos_ids,
                self.generator, t_row=t_row, suffix=suffix, offset=offset)
        if self.prefix_caching:
            # hand the freshly prefilled full prompt blocks to the cache
            # (refcount 1, held by this slot until release)
            for i in range(m, n // self.page_size):
                page = self._slot_pages_t[slot][i]
                if self.prefix_cache.insert(keys[i], page):
                    self._alloc_t.disown((slot, req.request_id), page)
                    self._slot_shared[slot].append(keys[i])
        del self._prefilling[slot]
        self._take(slot, req, n)
        return True

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
                with TRACER.span("admit", req.request_id):
                    self._begin_admit(slot, req)
                    # the whole prompt, unless chunks of it remain
                    if self._advance_prefill(slot):
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
