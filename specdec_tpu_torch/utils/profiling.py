"""Tracing and profiling helpers (counterpart of
``specdec_tpu/utils/profiling.py``).

- ``phase_timer``: a host-clock bracket, as a context manager adding its
  seconds to a shared dict (the benchmark's per-phase breakdown);
- ``device_trace``: a ``torch.profiler`` trace of the CPU and, where CUDA
  is available, the card's activity, written as a Chrome/Perfetto trace
  (``trace.json``) into ``log_dir``;
- ``annotate``: a named range (``torch.profiler.record_function``) that
  marks draft, verify and accept phases in such a trace.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def phase_timer(phases: Dict[str, float], name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        phases[name] = phases.get(name, 0.0) + (time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Profile the block; the trace goes to ``log_dir/trace.json``
    (``log_dir`` defaults to ``specdec_trace`` in the temporary
    directory). Yields the profiler, or None where it does not start."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "specdec_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # the profiler may be unavailable
        print(f"warning: torch profiler unavailable: {e}")
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, "trace.json")
            prof.export_chrome_trace(path)
            print(f"device trace written to {path}")


def annotate(name: str):
    """A named trace range (recorded only while a profiler runs)."""
    return torch.profiler.record_function(name)
