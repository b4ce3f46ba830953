"""Streaming generation: yield tokens as speculative windows complete
(counterpart of ``specdec_tpu/serve/streaming.py``).

A synchronous generator over a continuous batcher: each iteration advances
one engine step (``windows_per_sync`` windows) and yields the newly
committed tokens. TTFT for a streaming consumer is the first yield; tokens
arrive in bursts of (accepted prefix + 1), the cadence of speculative
decoding.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

from specdec_tpu_torch.serve.scheduler import ContinuousBatcher


def stream_generate(batcher: ContinuousBatcher,
                    prompt_ids: Sequence[int],
                    max_new_tokens: Optional[int] = None) -> Iterator[List[int]]:
    """Submit one request and yield lists of newly committed token ids after
    each engine step until the request finishes. Concatenating all yields
    gives exactly the request's output_ids."""
    rid = batcher.submit(prompt_ids, max_new_tokens=max_new_tokens)
    emitted = 0
    while rid not in batcher.completed:
        progressed = batcher.step()
        chunk = _new_tokens(batcher, rid, emitted)
        if chunk:
            emitted += len(chunk)
            yield chunk
        if not progressed and rid not in batcher.completed:
            # the queue starved and no slot ever opened
            break
    req = batcher.completed.get(rid)
    if req is not None and req.output_ids is not None:
        tail = req.output_ids[emitted:]
        if tail:
            yield tail


def _new_tokens(batcher: ContinuousBatcher, rid: int, emitted: int):
    if rid in batcher.completed:
        return []  # the caller yields the final tail
    for slot, r in enumerate(batcher.slot_req):
        if r is not None and r.request_id == rid:
            pos = int(batcher.state.pos[slot])
            plen = int(batcher.state.prompt_len[slot])
            n = pos - plen
            if n > emitted:
                return batcher.state.buf[slot, plen + emitted:plen + n].tolist()
            return []
    return []
