"""Benchmark metrics: per request, per batch and per run (counterpart of
``specdec_tpu/engine/metrics.py``, pure Python, copied).

The fields and the ``to_dict`` JSON schema are the JAX package's: TTFT,
end-to-end latency, per-batch throughput = tokens / batch latency, overall
throughput = tokens / run duration, the mean acceptance over requests with
a nonzero rate. ``print_benchmark_summary`` and ``print_comparison`` are
the console printers.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class RequestMetrics:
    prompt_tokens: int = 0
    generated_tokens: int = 0
    total_tokens: int = 0

    ttft: float = 0.0
    time_per_token: List[float] = field(default_factory=list)
    total_latency: float = 0.0

    acceptance_rate: float = 0.0
    drafts_generated: int = 0
    drafts_accepted: int = 0

    start_time: float = 0.0
    first_token_time: float = 0.0
    end_time: float = 0.0

    # seconds spent in the batcher queue before a slot was assigned: TTFT
    # is queue_seconds plus the admission prefill, and at saturating
    # offered rates the queue wait dominates
    queue_seconds: float = 0.0


@dataclass
class BatchMetrics:
    batch_size: int = 0
    requests: List[RequestMetrics] = field(default_factory=list)
    batch_start_time: float = 0.0
    batch_end_time: float = 0.0

    @property
    def batch_latency(self) -> float:
        return self.batch_end_time - self.batch_start_time

    @property
    def total_tokens(self) -> int:
        return sum(r.generated_tokens for r in self.requests)

    @property
    def avg_ttft(self) -> float:
        return (sum(r.ttft for r in self.requests) / len(self.requests)
                if self.requests else 0.0)

    @property
    def avg_latency(self) -> float:
        return (sum(r.total_latency for r in self.requests) / len(self.requests)
                if self.requests else 0.0)

    @property
    def throughput(self) -> float:
        lat = self.batch_latency
        return self.total_tokens / lat if lat > 0 else 0.0


@dataclass
class BenchmarkResults:
    method: str  # "speculative" | "target_ar" | "ngram" | ...
    total_requests: int = 0
    total_batches: int = 0
    batches: List[BatchMetrics] = field(default_factory=list)
    start_time: float = 0.0
    end_time: float = 0.0

    @property
    def total_duration(self) -> float:
        return self.end_time - self.start_time

    @property
    def total_tokens(self) -> int:
        return sum(b.total_tokens for b in self.batches)

    @property
    def total_prompt_tokens(self) -> int:
        return sum(r.prompt_tokens for b in self.batches for r in b.requests)

    @property
    def overall_throughput(self) -> float:
        d = self.total_duration
        return self.total_tokens / d if d > 0 else 0.0

    @property
    def avg_ttft(self) -> float:
        reqs = [r for b in self.batches for r in b.requests]
        return sum(r.ttft for r in reqs) / len(reqs) if reqs else 0.0

    @property
    def avg_latency(self) -> float:
        reqs = [r for b in self.batches for r in b.requests]
        return sum(r.total_latency for r in reqs) / len(reqs) if reqs else 0.0

    @property
    def avg_acceptance_rate(self) -> float:
        # reference averages only over requests that reported a rate (ref :126)
        reqs = [r for b in self.batches for r in b.requests
                if r.acceptance_rate > 0]
        return (sum(r.acceptance_rate for r in reqs) / len(reqs)
                if reqs else 0.0)

    def percentile_ttft(self, q: float) -> float:
        """p50/p99 TTFT — BASELINE.md tracks p50 TTFT per config."""
        vals = sorted(r.ttft for b in self.batches for r in b.requests)
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, max(0, int(round(q / 100.0 * (len(vals) - 1)))))
        return vals[idx]

    def to_dict(self) -> Dict:
        return {
            "method": self.method,
            "total_requests": self.total_requests,
            "total_batches": self.total_batches,
            "total_duration": self.total_duration,
            "total_tokens": self.total_tokens,
            "total_prompt_tokens": self.total_prompt_tokens,
            "overall_throughput": self.overall_throughput,
            "avg_ttft": self.avg_ttft,
            "avg_latency": self.avg_latency,
            "avg_acceptance_rate": self.avg_acceptance_rate,
            "batches": [
                {
                    "batch_size": b.batch_size,
                    "batch_latency": b.batch_latency,
                    "total_tokens": b.total_tokens,
                    "avg_ttft": b.avg_ttft,
                    "avg_latency": b.avg_latency,
                    "throughput": b.throughput,
                    "requests": [
                        {
                            "prompt_tokens": r.prompt_tokens,
                            "generated_tokens": r.generated_tokens,
                            "total_tokens": r.total_tokens,
                            "ttft": r.ttft,
                            "total_latency": r.total_latency,
                            "acceptance_rate": r.acceptance_rate,
                            "drafts_generated": r.drafts_generated,
                            "drafts_accepted": r.drafts_accepted,
                        }
                        for r in b.requests
                    ],
                }
                for b in self.batches
            ],
        }

    def save_json(self, filepath: str):
        with open(filepath, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        print(f"results saved to {filepath}")


def print_benchmark_summary(results: BenchmarkResults):
    gen = results.total_tokens
    print("\n" + "=" * 70)
    print(f"Benchmark Results: {results.method.upper()}")
    print("=" * 70)
    print("\nOverall Statistics:")
    print(f"  Total Requests:     {results.total_requests}")
    print(f"  Total Batches:      {results.total_batches}")
    print(f"  Total Duration:     {results.total_duration:.2f} s")
    print(f"  Generated Tokens:   {gen:,}")
    print(f"  Prompt Tokens:      {results.total_prompt_tokens:,}")
    print("\nPerformance Metrics:")
    print(f"  Overall Throughput: {results.overall_throughput:.2f} tokens/s")
    print(f"  Average TTFT:       {results.avg_ttft * 1000:.2f} ms")
    print(f"  p50 TTFT:           {results.percentile_ttft(50) * 1000:.2f} ms")
    print(f"  p99 TTFT:           {results.percentile_ttft(99) * 1000:.2f} ms")
    print(f"  Average Latency:    {results.avg_latency * 1000:.2f} ms")
    if results.method == "speculative":
        print("\nSpeculative Decoding Metrics:")
        print(f"  Average Acceptance Rate: {results.avg_acceptance_rate:.3f}")
    print("\n" + "=" * 70)


def print_comparison(spec_results: BenchmarkResults,
                     target_results: BenchmarkResults):
    print("\n" + "=" * 70)
    print("Performance Comparison (speculative vs target AR)")
    print("=" * 70)
    speedup = (target_results.avg_latency / spec_results.avg_latency
               if spec_results.avg_latency > 0 else 0.0)
    tp_gain = ((spec_results.overall_throughput /
                target_results.overall_throughput - 1) * 100
               if target_results.overall_throughput > 0 else 0.0)
    print(f"  Throughput Speedup:  {speedup:.2f}x")
    print(f"  Throughput Gain:     {tp_gain:+.1f}%")
    if target_results.avg_latency > 0:
        red = (1 - spec_results.avg_latency / target_results.avg_latency) * 100
        print(f"  Latency Reduction:   {red:.1f}%")
    print(f"\n{'Metric':<25} {'Speculative':<15} {'Target AR':<15}")
    print("-" * 70)
    print(f"{'Throughput (tok/s)':<25} {spec_results.overall_throughput:<15.2f} "
          f"{target_results.overall_throughput:<15.2f}")
    print(f"{'Avg TTFT (ms)':<25} {spec_results.avg_ttft * 1000:<15.2f} "
          f"{target_results.avg_ttft * 1000:<15.2f}")
    print(f"{'Avg Latency (ms)':<25} {spec_results.avg_latency * 1000:<15.2f} "
          f"{target_results.avg_latency * 1000:<15.2f}")
    print("=" * 70)
