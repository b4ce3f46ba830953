"""Host-side prefix block cache for the paged scheduler (the port's copy of
``specdec_tpu/serve/prefix_cache.py``; pure host bookkeeping).

Prompt KV pages are content-addressed by a chained hash of their
page_size-token block; admissions reuse matching pages instead of
recomputing them, and unreferenced blocks linger in an LRU pool until page
pressure reclaims them. The device only ever sees the int32 page tables the
scheduler builds. The target and drafter pools always cache the same
prefixes, so one entry maps a block key to a (target page, drafter page)
PAIR (drafter page -1 in the hybrid layout, which has no drafter pool);
eviction frees one page in each pool.

Correctness invariants (why shared pages are safe to alias read-only):
- a block is registered only once its page holds K/V for every position in
  it, computed at absolute positions (RoPE is absolute, params are fixed per
  batcher), so its content is bit-identical to what any later request with
  the same token prefix would compute;
- the scheduler caps the reused prefix at prompt_len-1 tokens, so every
  post-admission write (target verify from position prompt_len, drafter
  first-draft rewrite of position prompt_len-1) lands strictly past the
  shared pages;
- refcounts pin a block while any slot's page table references it;
  refcount-0 blocks are reclaimed LRU-first only when an allocation would
  otherwise fail.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np


def block_keys(tokens: Sequence[int], page_size: int) -> List[int]:
    """Chained crc32 key per FULL page of ``tokens``: key[i] covers
    tokens[: (i+1)*page_size] (the chain makes equal blocks at different
    depths distinct). crc32, not hash() — builtin hash is per-process
    randomized, which makes cache behavior irreproducible across runs."""
    keys: List[int] = []
    h = 0
    for i in range(len(tokens) // page_size):
        blk = np.asarray(tokens[i * page_size:(i + 1) * page_size], np.int32)
        h = zlib.crc32(blk.tobytes(), h)
        keys.append(h)
    return keys


class PrefixBlockCache:
    """key → [t_page, d_page, refcount, lru_tick]."""

    def __init__(self):
        self._blocks: Dict[int, List[int]] = {}
        self._tick = 0
        # observability (read by tests / serving stats)
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._blocks)

    @property
    def evictable(self) -> int:
        return sum(1 for e in self._blocks.values() if e[2] == 0)

    def match_len(self, keys: Sequence[int]) -> int:
        """Length (in blocks) of the longest cached prefix of ``keys``."""
        m = 0
        for k in keys:
            if k not in self._blocks:
                break
            m += 1
        return m

    def pages(self, key: int) -> Tuple[int, int]:
        e = self._blocks[key]
        return e[0], e[1]

    def acquire(self, key: int) -> None:
        e = self._blocks[key]
        e[2] += 1
        self._tick += 1
        e[3] = self._tick

    def release(self, key: int) -> None:
        e = self._blocks[key]
        e[2] -= 1
        assert e[2] >= 0, "prefix block over-released"

    def insert(self, key: int, t_page: int, d_page: int) -> bool:
        """Register a freshly computed block with refcount 1 (held by the
        inserting slot). Returns False if the key is already cached (the
        caller keeps its duplicate page as plain owned memory)."""
        if key in self._blocks:
            return False
        self._tick += 1
        self._blocks[key] = [t_page, d_page, 1, self._tick]
        return True

    def reclaim(self, n: int) -> Tuple[List[int], List[int]]:
        """Evict up to ``n`` refcount-0 blocks, LRU first; returns the freed
        (target pages, drafter pages)."""
        victims = sorted(
            (e[3], k) for k, e in self._blocks.items() if e[2] == 0)[:n]
        t_pages, d_pages = [], []
        for _, k in victims:
            e = self._blocks.pop(k)
            t_pages.append(e[0])
            d_pages.append(e[1])
        self.evictions += len(victims)
        return t_pages, d_pages
