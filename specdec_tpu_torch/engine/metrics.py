"""Per-request serving metrics (counterpart of
``specdec_tpu/engine/metrics.py::RequestMetrics``; the batch and run
aggregates belong to the harness, not ported yet)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


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
