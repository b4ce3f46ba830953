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
from typing import List, Optional, Sequence, Tuple

from specdec_tpu_torch.engine.metrics import BatchMetrics, BenchmarkResults
from specdec_tpu_torch.serve.scheduler import ContinuousBatcher


def _group_decides(mesh, due: int, closed: bool) -> Tuple[int, bool]:
    """(arrivals to admit now, time budget spent) as the first rank of this
    rank's 'model' group reads its clock: the ranks of a tensor-parallel
    group admit the same requests at the same step, so their all-reduces
    pair the same rows. Data rows decide apart (each steps on its own)."""
    if mesh is None or mesh.tp == 1:
        return due, closed
    import torch.distributed as dist

    said = [due, closed]
    dist.broadcast_object_list(said, src=mesh.ranks[mesh.dp_index][0],
                               group=mesh.model_group)
    return int(said[0]), bool(said[1])


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
    mesh = batcher.target_params.get("mesh")

    while True:
        now = time.time()
        closed = duration is not None and now - start >= duration
        due = 0 if closed else sum(
            1 for t in arrival_times[next_idx:] if t <= now)
        due, closed = _group_decides(mesh, due, closed)
        # admit the arrivals that are due (unless the time budget is spent)
        for _ in range(due):
            rid = batcher.submit(prompts[next_idx])
            # under a data-parallel mesh another data rank may serve it
            if batcher.queue and batcher.queue[-1].request_id == rid:
                batcher.queue[-1].submit_time = max(arrival_times[next_idx],
                                                    now)
            submitted.append(rid)
            next_idx += 1

        active = batcher.step()
        pending_arrivals = next_idx < len(prompts) and not closed
        if not active and not pending_arrivals:
            break
        if not active and pending_arrivals:
            time.sleep(min(0.01, max(0.0,
                                     arrival_times[next_idx] - time.time())))

    results.end_time = time.time()
    # drained: run() only gathers the other data ranks' requests, under a
    # data-parallel mesh
    batcher.run()
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
