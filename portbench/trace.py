"""The traced run's instruments: host spans from the benchmark's side, the
weight products' shapes, and a torch.profiler trace of the device over the
window's last ``slice_s`` seconds, reduced to busy time, device time by
operation, the weight kernel's time and the idle gaps labelled by the host
span that was open. The trace costs the host time (a traced chat window
ran 20-30% fewer steps and went past its knee): confining it to a slice
at the end keeps the host-side per-layer metrics, read before the slice,
as an untraced run would read them.

Host spans wrap the harness's submissions and, on the batcher instance
only, ``step``, ``_admit``, ``_top_up``, ``_window_and_harvest``
("harvest") and ``_window_step`` ("windows"); the innermost open span
labels a moment. The program's own ``qmatmul``, as ``core/model.py`` looks
it up, is wrapped to record (M, K, N) of every INT4 product inside the
window. None of this is installed in an untraced run.

Clocks: the window opens and closes on an empty device with a one-element
fill; the profiler's timestamps of those two fills, against the host clock
read just before each launch, give the offset between the two clocks.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import sys
import time
from typing import Dict, List, Tuple

import torch

from portbench import measure

BASE = "harness"   # the label where no span is open
SLICE_S = 10.0     # seconds traced at the window's end


class Spans:
    """Nested host spans as a list of (time_ns, innermost open label)."""

    def __init__(self):
        self.stack: List[str] = []
        self.times: List[int] = []
        self.labels: List[str] = []
        self.on = False

    def _mark(self):
        self.times.append(time.time_ns())
        self.labels.append(self.stack[-1] if self.stack else BASE)

    @contextlib.contextmanager
    def span(self, label: str):
        if not self.on:
            yield
            return
        self.stack.append(label)
        self._mark()
        try:
            yield
        finally:
            self.stack.pop()
            self._mark()

    def label_at(self, t_ns: int) -> str:
        i = bisect.bisect_right(self.times, t_ns) - 1
        return self.labels[i] if i >= 0 else BASE


@dataclasses.dataclass
class TraceResult:
    window_s: float                 # the traced window, device clock
    busy_s: float                   # union of device activity in it
    device_ops: List[Tuple[str, float]]   # seconds by kernel_label
    idle_by_span: List[Tuple[str, float]]  # idle seconds by host span
    longest_gaps: List[Tuple[str, float]]
    int4_calls: int                 # INT4 products recorded
    int4_kernels: int               # int4_pair_matmul launches traced
    int4_bound_s: float             # their summed roofline bound
    int4_device_s: float            # their summed device time
    clock_skew_us: float            # offset at the close minus the open


class Tracer:
    def __init__(self, device):
        self.device = device
        self.spans = Spans()
        self.calls: List[Tuple[int, int, int]] = []
        self._prof = None
        self._restore = []

    def _wrap(self, obj, name: str, label: str):
        fn = getattr(obj, name)
        spans = self.spans

        def wrapped(*a, **kw):
            with spans.span(label):
                return fn(*a, **kw)
        setattr(obj, name, wrapped)

    def instrument(self, batcher):
        """Span wrappers on this batcher instance, and the recording
        wrapper around the program's ``qmatmul``."""
        for name, label in (("step", "step"), ("_admit", "admit"),
                            ("_top_up", "top_up"),
                            ("_window_and_harvest", "harvest"),
                            ("_window_step", "windows")):
            self._wrap(batcher, name, label)
        from specdec_tpu_torch.core import model as M
        from specdec_tpu_torch.quant.core import Int4Weight, StackedSlice

        orig, spans, calls = M.qmatmul, self.spans, self.calls

        def qmatmul(x, w):
            c = w.container if isinstance(w, StackedSlice) else w
            if spans.on and isinstance(c, Int4Weight):
                K = x.shape[-1]
                calls.append((x.numel() // K, K, c.packed.shape[-1]))
            return orig(x, w)
        M.qmatmul = qmatmul
        self._restore.append((M, "qmatmul", orig))

    @staticmethod
    def slice_s(seconds: float) -> float:
        """The traced slice: SLICE_S, or half of a shorter window."""
        return min(SLICE_S, seconds / 2)

    def close(self):
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)
        self._restore.clear()

    def _mark(self) -> int:
        """Host time of a one-element fill launched on an idle device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.time_ns()
        torch.empty(1, device=self.device).fill_(1.0)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return t

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA
                                   if self.device.type == "cuda"
                                   else ProfilerActivity.CPU])

    def warm(self):
        """Start and stop a profiler once in set-up: the first start in a
        process initialises CUPTI, which took ~8 s inside the window."""
        with self._profile():
            self._mark()

    def start(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        self._prof = self._profile()
        self._prof.__enter__()
        self.start_s = time.time() - t0
        self.calls.clear()
        self.spans.on = True
        self._h0 = self._mark()

    def stop(self) -> TraceResult:
        h1 = self._mark()
        self.spans.on = False
        t0 = time.time()
        self._prof.__exit__(None, None, None)
        kind = (torch.autograd.DeviceType.CUDA if self.device.type == "cuda"
                else torch.autograd.DeviceType.CPU)
        events = [e for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == kind]
        self._prof = None
        self.close()
        out = reduce_trace([(e.name(), _start_ns(e),
                             _start_ns(e) + e.duration_ns())
                            for e in events],
                           self._h0, h1, self.spans, self.calls)
        print(f"[trace] profiler started in {self.start_s:.3f} s; "
              f"{len(events)} device events read in {time.time() - t0:.1f} s",
              file=sys.stderr, flush=True)
        return out


def _start_ns(e) -> int:
    f = getattr(e, "start_ns", None)
    return f() if f is not None else int(e.start_us() * 1000)


def reduce_trace(events: List[Tuple[str, int, int]], h0: int, h1: int,
                 spans: Spans, calls: List[Tuple[int, int, int]]
                 ) -> TraceResult:
    """Reduce device events (name, start_ns, end_ns) between the two clock
    marks (the first and the last event, whose host launch times are h0
    and h1) to a TraceResult."""
    events = sorted(events, key=lambda e: e[1])
    first, last = events[0], events[-1]
    off0, off1 = first[1] - h0, last[1] - h1
    lo, hi = first[2], last[1]
    body = [e for e in events[1:-1]]
    ivs = measure.clip([(s, e) for _, s, e in body], lo, hi)
    busy = measure.covered(ivs)
    ops: Dict[str, float] = {}
    for name, s, e in body:
        k = measure.kernel_label(name)
        ops[k] = ops.get(k, 0.0) + (e - s) / 1e9
    off = (off0 + off1) / 2
    idle: Dict[str, float] = {}
    labelled = []
    for s, e in measure.gaps(ivs, lo, hi):
        lab = spans.label_at(int((s + e) / 2 - off))
        idle[lab] = idle.get(lab, 0.0) + (e - s) / 1e9
        labelled.append((lab, (e - s) / 1e9))
    k1 = [(s, e) for n, s, e in body if "int4_pair_matmul" in n]
    return TraceResult(
        window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
        device_ops=sorted(ops.items(), key=lambda kv: -kv[1]),
        idle_by_span=sorted(idle.items(), key=lambda kv: -kv[1]),
        longest_gaps=sorted(labelled, key=lambda kv: -kv[1])[:10],
        int4_calls=len(calls), int4_kernels=len(k1),
        int4_bound_s=sum(measure.int4_bound_s(*c) for c in calls),
        int4_device_s=sum(e - s for s, e in k1) / 1e9,
        clock_skew_us=(off1 - off0) / 1e3)
