"""Benchmark main loop: closed-loop (N prompts) and open-loop (rate x duration)
load generation, batch and single-request modes, with rate pacing
(counterpart of ``specdec_tpu/engine/benchmark_executor.py``, copied; the
runner's ``set_request_index`` seeds a request's ``torch.Generator``).

Semantics parity with ref: engine/benchmark_executor.py:11-144 — two stop
conditions (NUM_PROMPTS count mode vs AUTO_RATE x AUTO_DURATION open loop),
per-iteration pacing sleep capped at remaining time, and deterministic
per-request seeding. The reference reseeds the global RNG to 42 before every
request (ref :79,125); we keep determinism but derive a distinct key per
request index (SURVEY.md §7.3), so requests are reproducible without every
request sampling identically.
"""
from __future__ import annotations

import time

from specdec_tpu_torch.engine.infer_engine import infer_batch


def execute_benchmark_loop(runner, spec_results, target_results) -> int:
    start_time = time.time()
    use_num_prompts = runner.num_prompts > 0
    end_time = None if use_num_prompts else start_time + runner.auto_duration
    target_requests = runner.num_prompts if use_num_prompts else None

    if runner.enable_batch:
        return _execute_batch_mode(runner, spec_results, target_results,
                                   start_time, end_time, target_requests,
                                   use_num_prompts)
    return _execute_single_mode(runner, spec_results, target_results,
                                start_time, end_time, target_requests,
                                use_num_prompts)


def _timed_out(runner, end_time) -> bool:
    """Whether a timed run is over: rank 0's clock decides for every rank
    of a mesh, so that all ranks run the same requests."""
    over = time.time() >= end_time
    if getattr(runner, "mesh", None) is None:
        return over
    import torch.distributed as dist

    flag = [over]
    dist.broadcast_object_list(flag, src=0)
    return bool(flag[0])


def _record(runner, spec_results, target_results, prompts, request_index):
    runner.set_request_index(request_index)
    spec_metrics, target_metrics = infer_batch(runner, prompts)
    if spec_results is not None and spec_metrics is not None:
        spec_results.batches.append(spec_metrics)
        spec_results.total_requests += len(prompts)
    if target_results is not None and target_metrics is not None:
        target_results.batches.append(target_metrics)
        target_results.total_requests += len(prompts)


def _execute_batch_mode(runner, spec_results, target_results, start_time,
                        end_time, target_requests, use_num_prompts) -> int:
    prompts_per_iter = max(1, runner.batch_size)
    interval = prompts_per_iter / runner.auto_rate if not use_num_prompts else 0
    batch_idx = 0
    total_requests = 0

    while True:
        if use_num_prompts:
            if total_requests >= target_requests:
                break
            if total_requests + prompts_per_iter > target_requests:
                prompts_per_iter = target_requests - total_requests
        elif _timed_out(runner, end_time):
            break

        batch_idx += 1
        iteration_start = time.time()
        prompts = [runner._get_random_prompt() for _ in range(prompts_per_iter)]
        print(f"batch {batch_idx}: {len(prompts)} prompts "
              f"(elapsed {iteration_start - start_time:.1f}s)")
        _record(runner, spec_results, target_results, prompts, batch_idx)
        total_requests += len(prompts)

        if not use_num_prompts:
            elapsed = time.time() - iteration_start
            sleep_time = interval - elapsed
            if sleep_time > 0:
                time.sleep(min(sleep_time, max(0.0, end_time - time.time())))
    return total_requests


def _execute_single_mode(runner, spec_results, target_results, start_time,
                         end_time, target_requests, use_num_prompts) -> int:
    interval = 1.0 / runner.auto_rate if not use_num_prompts else 0
    total_requests = 0

    while True:
        now = time.time()
        if use_num_prompts:
            if total_requests >= target_requests:
                break
        elif _timed_out(runner, end_time):
            break

        prompt = runner._get_random_prompt()
        print(f"request #{total_requests + 1} (elapsed {now - start_time:.1f}s)")
        _record(runner, spec_results, target_results, [prompt],
                total_requests + 1)
        total_requests += 1

        if not use_num_prompts:
            elapsed = time.time() - now
            sleep_time = interval - elapsed
            if sleep_time > 0:
                time.sleep(min(sleep_time, max(0.0, end_time - time.time())))
    return total_requests
