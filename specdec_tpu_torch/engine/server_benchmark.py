"""Server-style benchmark: open-loop request arrivals into continuous batching
(counterpart of ``specdec_tpu/engine/server_benchmark.py``, copied).

This is the native equivalent of the reference's vLLM benchmark path (ref:
engine/vllm_benchmark.py:20-381): there, asyncio tasks fire per-request at
AUTO_RATE into an AsyncLLMEngine; here, a Poisson-ish open-loop arrival
schedule feeds the ContinuousBatcher, and per-request TTFT/latency/throughput
are measured under load rather than per isolated batch. Unlike the reference,
token counts are exact (the reference approximates them by whitespace
splitting, ref :173-174 — a quirk SURVEY.md §7.3 fixes).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

from specdec_tpu_torch.engine.metrics import BatchMetrics, BenchmarkResults
from specdec_tpu_torch.serve.scheduler import ContinuousBatcher


def run_server_benchmark(
    batcher: ContinuousBatcher,
    prompts: Sequence[Sequence[int]],
    rate: float = 1.0,
    duration: Optional[float] = None,
    method_name: str = "speculative",
) -> BenchmarkResults:
    """Submit ``prompts`` at ``rate`` req/s (open loop), drive the batcher
    until drained (or ``duration`` reached with queue cut off), and aggregate
    reference-schema results (one BatchMetrics per completed request).

    ``batcher`` is any scheduler with the ContinuousBatcher submit/step/
    queue/completed surface — the slotted, paged, device-NASD
    (serve.nasd_scheduler.NasdContinuousBatcher) and EAGLE
    (serve.eagle_scheduler.EagleContinuousBatcher) batchers all qualify."""
    results = BenchmarkResults(method=method_name)
    start = time.time()
    results.start_time = start

    arrival_times = [start + i / rate for i in range(len(prompts))]
    next_idx = 0
    submitted: List[int] = []

    while True:
        now = time.time()
        # admit all arrivals that are due (unless the time budget is spent)
        while (next_idx < len(prompts) and arrival_times[next_idx] <= now and
               (duration is None or now - start < duration)):
            rid = batcher.submit(prompts[next_idx])
            req = batcher.queue[-1]
            req.submit_time = max(arrival_times[next_idx], now)
            submitted.append(rid)
            next_idx += 1

        active = batcher.step()
        pending_arrivals = (next_idx < len(prompts) and
                            (duration is None or time.time() - start < duration))
        if not active and not pending_arrivals:
            break
        if not active and pending_arrivals:
            time.sleep(min(0.01, max(0.0,
                                     arrival_times[next_idx] - time.time())))

    results.end_time = time.time()
    for rid in submitted:
        req = batcher.completed.get(rid)
        if req is None or req.metrics is None:
            continue
        bm = BatchMetrics(batch_size=1)
        bm.batch_start_time = req.metrics.start_time
        bm.batch_end_time = req.metrics.end_time
        bm.requests.append(req.metrics)
        results.batches.append(bm)
        results.total_requests += 1
    results.total_batches = len(results.batches)
    return results
