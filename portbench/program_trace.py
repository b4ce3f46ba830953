"""The traced run (``run.py --trace 1``): the program's own spans and
records, and a torch.profiler trace of the device over the window's last
``SLICE_S`` seconds, each kernel and idle gap tied to the program span
that launched it.

- The program's tracer (``specdec_tpu_torch.utils.profiling.TRACER``) is on
  from the set-up's warming to the window's close. Its spans and records
  land in ``run.program``; the readers count only what began inside the
  window's parts: the host-side metrics the part before the slice, which
  the profiler does not slow, the device-side ones the slice.
- The device trace keeps the CUDA runtime's events. Each kernel is tied,
  through its correlation id, to its launch, and so to the program span
  open at that moment. Each idle gap is labelled with the span open at the
  launch of the kernel that ends it.

A program without the tracer runs too: then the span-based readers
return nothing. The profiler stamps the runtime's events on the
program's clock, and the device's kernels on one that drifts from it
(``attribute``). The slice opens and closes on an idle device with a
one-element fill, whose launch brackets give the device clock's lead at
both ends.
"""
from __future__ import annotations

import bisect
import dataclasses
import sys
import time
from typing import Dict, List, Sequence, Tuple

import torch

from portbench import measure
from portbench.program_spans import END, NAME, PARENT, START, path

BASE = "harness"   # the label where no program span is open
SLICE_S = 10.0     # seconds traced at the window's end
TOP = 10           # entries of each list of the breakdown

# runtime calls that block the host until the stream drains (the marks'
# cudaDeviceSynchronize is left out)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize")

# launches a point of the device clock's lead is taken over
LEAD_BUCKET_NS = 1_000_000_000


def program_tracer():
    """The program's tracer, or None for a program without one."""
    from specdec_tpu_torch.utils import profiling

    return getattr(profiling, "TRACER", None)


@dataclasses.dataclass
class TraceResult:
    window_s: float = 0.0           # the traced slice, device clock
    busy_s: float = 0.0             # union of device activity in it
    device_ops: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)       # seconds by kernel_label
    int4_kernels: int = 0           # int4_pair_matmul launches traced
    int4_device_s: float = 0.0      # their summed device time
    slice_ns: Tuple[int, int] = (0, 0)      # the slice, program clock
    clock_offset_us: Tuple[float, ...] = ()  # device lead, open and close
    device_by_span: Dict[int, float] = dataclasses.field(
        default_factory=dict)               # seconds by launching span
    attention_by_span: Dict[int, float] = dataclasses.field(
        default_factory=dict)               # K8a seconds by launching span
    idle_by_program_span: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    device_by_program_span: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    ops_by_program_span: List[Tuple[str, str, float]] = dataclasses.field(
        default_factory=list)
    idle_after_sync: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    syncs_by_program_span: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)   # runtime calls by the sync span paired
    unpaired_sync_spans: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)   # sync.* spans with no call paired
    sync_spans: int = 0         # program sync.* spans begun in the slice
    launches: int = 0           # device operations in the slice
    launches_in_step: int = 0   # of them, launched inside a step span
    device_s: float = 0.0       # their summed time
    device_in_span_s: float = 0.0   # of it, launched inside a program span
    events_read: int = 0
    read_s: float = 0.0


def innermost(spans: Sequence[tuple]):
    """A function of a time on the program's clock giving the innermost
    span open then (-1: none)."""
    marks = sorted([(s[START], 1, i, i) for i, s in enumerate(spans)]
                   + [(s[END], 0, -i, s[PARENT]) for i, s in enumerate(spans)])
    times = [m[0] for m in marks]
    after = [m[3] for m in marks]

    def find(t: float) -> int:
        k = bisect.bisect_right(times, t) - 1
        return after[k] if k >= 0 else -1
    return find


def _top(d: dict, n: int = 40) -> list:
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]


def _line(points: Sequence[Tuple[float, float]]):
    """The function through ``points`` (t, value), sorted by t, linear
    between them and constant beyond the ends."""
    ts = [t for t, _ in points]

    def at(t: float) -> float:
        k = bisect.bisect_right(ts, t)
        if k == 0:
            return points[0][1]
        if k == len(points):
            return points[-1][1]
        (t0, v0), (t1, v1) = points[k - 1], points[k]
        return v0 + (v1 - v0) * (t - t0) / max(t1 - t0, 1)
    return at


def device_lead(device: List[tuple], runtime: Dict[int, int],
                brackets: Sequence[Tuple[int, int]]):
    """The device clock's lead over the host's, as a function of device
    time: a kernel launched onto an idle device starts a few microseconds
    after its launch, so in each LEAD_BUCKET_NS of launches the least
    (start - launch) is the lead, plus that latency. The two fill marks,
    launched onto an idle device after the host time their bracket opens
    with, give two more points."""
    least: Dict[int, Tuple[int, int]] = {}
    for _, s, _, c in device:
        r = runtime.get(c)
        if r is not None:
            k = r // LEAD_BUCKET_NS
            if k not in least or s - r < least[k][1]:
                least[k] = (s, s - r)
    marks = [(e[1], e[1] - b[0]) for e, b in zip(
        (min(device, key=lambda e: e[1]), max(device, key=lambda e: e[1])),
        brackets)]
    return _line(sorted(list(least.values()) + marks))


def attribute(device: List[tuple], runtime: Dict[int, int],
              syncs: List[Tuple[int, int]], spans: Sequence[tuple],
              brackets: Sequence[Tuple[int, int]]) -> dict:
    """Tie a device trace to the program's spans.

    ``device``: (name, start, end, correlation) of every device operation,
    the first and the last being the slice's two fill marks; ``runtime``:
    each correlation id's launch time; ``syncs``: (start, end) of the
    runtime's synchronising calls; ``spans``: the program's; ``brackets``:
    the host times read before and after each mark's launch.

    The runtime's events are stamped on the program's clock (on torch 2.11
    each synchronising call lay inside the ``sync.*`` span that made it,
    with no offset taken), so a launch time picks its span as it is. The
    device's kernel times run on a clock that drifts from it (1-4.6 ms
    ahead over a loaded 10 s slice), which ``device_lead`` follows; it
    places a kernel with no launch event (the profiler keeps none for its
    first millisecond or so) and the start of each idle gap. Returns the
    ``TraceResult`` fields other than ``events_read`` and ``read_s``."""
    device = sorted(device, key=lambda e: e[1])
    first, last = device[0], device[-1]
    lead = device_lead(device, runtime, brackets)
    h0, h1 = brackets[0][0], brackets[1][0]
    syncs = sorted(c for c in syncs if h0 < c[0] < h1)
    lo, hi = first[2], last[1]
    body = device[1:-1]
    find, memo = innermost(spans), {}

    def label(i: int) -> str:
        return path(spans, i, memo) or BASE

    def launched(e) -> int:
        r = runtime.get(e[3])
        return find(r if r is not None else e[1] - lead(e[1]))

    by_span: Dict[int, float] = {}
    attention: Dict[int, float] = {}
    by_path: Dict[str, float] = {}
    by_label: Dict[str, float] = {}
    ops: Dict[Tuple[str, str], float] = {}
    in_step = k1 = 0
    k1_s = 0.0
    for e in body:
        i, d = launched(e), (e[2] - e[1]) / 1e9
        by_span[i] = by_span.get(i, 0.0) + d
        if "flash_decode_kernel" in e[0] and "Paged" in e[0]:
            attention[i] = attention.get(i, 0.0) + d
        if "int4_pair_matmul" in e[0]:
            k1, k1_s = k1 + 1, k1_s + d
        p, k = label(i), measure.kernel_label(e[0])
        in_step += p == "step" or p.startswith("step/")
        by_path[p] = by_path.get(p, 0.0) + d
        by_label[k] = by_label.get(k, 0.0) + d
        ops[(p, k)] = ops.get((p, k), 0.0) + d
    # each synchronising call and the sync.* span it lies in
    made_by = {}
    for k, (a, b) in enumerate(syncs):
        i = find((a + b) / 2)
        made_by[k] = i if i >= 0 and spans[i][NAME].startswith("sync.") \
            else None
    idle: Dict[str, float] = {}
    after_sync: Dict[str, float] = {}
    starts = [e[1] for e in device]
    sync_starts = [a for a, _ in syncs]
    ivs = measure.clip([(e[1], e[2]) for e in body], lo, hi)
    for s, t in measure.gaps(ivs, lo, hi):
        ender = device[min(bisect.bisect_left(starts, t), len(device) - 1)]
        lab = label(launched(ender))
        idle[lab] = idle.get(lab, 0.0) + (t - s) / 1e9
        # the device fell idle while the host waited in a synchronising call
        host = s - lead(s)
        k = bisect.bisect_right(sync_starts, host) - 1
        if k >= 0 and host <= syncs[k][1]:
            i = made_by[k]
            name = spans[i][NAME] if i is not None else "unmarked"
            after_sync[name] = after_sync.get(name, 0.0) + (t - s) / 1e9
    sync_paths: Dict[str, int] = {}
    for k, (a, b) in enumerate(syncs):
        i = made_by[k]
        p = label(i) if i is not None else "unmarked:" + label(
            find((a + b) / 2))
        sync_paths[p] = sync_paths.get(p, 0) + 1
    paired = set(made_by.values())
    unpaired: Dict[str, int] = {}
    for i, s in enumerate(spans):
        if s[NAME].startswith("sync.") and h0 < s[START] < h1 \
                and i not in paired:
            unpaired[label(i)] = unpaired.get(label(i), 0) + 1
    device_s = sum(by_span.values())
    return dict(
        window_s=(hi - lo) / 1e9, busy_s=measure.covered(ivs) / 1e9,
        device_ops=_top(by_label), int4_kernels=k1, int4_device_s=k1_s,
        slice_ns=(h0, h1),
        clock_offset_us=tuple(lead(e[1]) / 1e3 for e in (first, last)),
        device_by_span=by_span, attention_by_span=attention,
        idle_by_program_span=_top(idle), device_by_program_span=_top(by_path),
        ops_by_program_span=[(p, k, v) for (p, k), v in _top(ops)],
        idle_after_sync=_top(after_sync), syncs_by_program_span=_top(
            sync_paths), unpaired_sync_spans=_top(unpaired),
        sync_spans=sum(1 for s in spans if s[NAME].startswith("sync.")
                       and h0 < s[START] < h1),
        launches=len(body), launches_in_step=in_step, device_s=device_s,
        device_in_span_s=device_s - by_span.get(-1, 0.0))


class Tracer:
    """The traced run's instruments: the program's tracer, on from
    ``warm`` in set-up to ``stop`` or ``close``, and the profiler over the
    slice from ``start`` to ``stop``, keeping the runtime's events."""

    def __init__(self, device):
        self.device = device
        self.program = program_tracer()
        self.drained = None
        self._prof = None
        self._brackets: List[Tuple[int, int]] = []

    @staticmethod
    def slice_s(seconds: float) -> float:
        """The traced slice: SLICE_S, or half of a shorter window."""
        return min(SLICE_S, seconds / 2)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA
                                   if self.device.type == "cuda"
                                   else ProfilerActivity.CPU])

    def _mark(self):
        """A one-element fill launched on an idle device; its launch
        bracket, host times before and after, is kept."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t = time.time_ns()
        torch.empty(1, device=self.device).fill_(1.0)
        self._brackets.append((t, time.time_ns()))
        if cuda:
            torch.cuda.synchronize()

    def warm(self):
        """Start and stop a profiler once in set-up (the first start in a
        process initialises CUPTI, which took ~8 s inside the window), then
        turn the program's tracer on."""
        with self._profile():
            self._mark()
        if self.program is not None:
            self.program.drain()
            self.program.enable()

    def start(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        self._prof = self._profile()
        self._prof.__enter__()
        self.start_s = time.time() - t0
        self._brackets = []
        self._mark()

    def stop(self) -> TraceResult:
        self._mark()
        self.close()
        t0 = time.time()
        self._prof.__exit__(None, None, None)
        cuda = self.device.type == "cuda"
        kind = (torch.autograd.DeviceType.CUDA if cuda
                else torch.autograd.DeviceType.CPU)
        device, runtime, syncs = [], {}, []
        events = self._prof.profiler.kineto_results.events()
        for e in events:
            if e.device_type() == kind:
                s = _start_ns(e)
                device.append((e.name(), s, s + e.duration_ns(),
                               e.correlation_id()))
            elif cuda:
                name = e.name()
                if name.startswith("cu"):
                    runtime.setdefault(e.correlation_id(), _start_ns(e))
                    if name in SYNC_CALLS:
                        syncs.append((_start_ns(e),
                                      _start_ns(e) + e.duration_ns()))
        self._prof = None
        spans = self.drained.spans if self.drained is not None else []
        out = TraceResult(
            **attribute(device, runtime, syncs, spans, self._brackets),
            events_read=len(events), read_s=time.time() - t0)
        print(f"[trace] profiler started in {self.start_s:.3f} s; "
              f"{out.events_read} events read and tied to the program's "
              f"spans in {out.read_s:.1f} s", file=sys.stderr, flush=True)
        return out

    def close(self):
        """Turn the program's tracer off and keep what it holds."""
        if self.program is not None and self.program.on:
            self.program.disable()
            self.drained = self.program.drain()


def _start_ns(e) -> int:
    f = getattr(e, "start_ns", None)
    return f() if f is not None else int(e.start_us() * 1000)


def _pairs(rows, n: int = TOP) -> list:
    return [list(r) for r in rows[:n]]


def breakdown(t: TraceResult) -> dict:
    """The result line's ``breakdown``: lists of [name, number], each at
    most TOP long. ``device_ops`` by kernel; ``idle_gaps`` by the program
    span path that launched the kernel ending each gap; device time by
    launching span path, and by path and kernel; the idle that began while
    the host waited in a synchronising call, by its ``sync.*`` span; the
    synchronising runtime calls by the span paired with them, and the
    ``sync.*`` spans with none; and how much of the slice the spans
    account for (``attributed``)."""
    return {
        "device_ops": _pairs(t.device_ops),
        "idle_gaps": _pairs(t.idle_by_program_span),
        "device_by_program_span": _pairs(t.device_by_program_span),
        "ops_by_program_span": [[f"{p} {k}", v] for p, k, v in
                                t.ops_by_program_span[:TOP]],
        "idle_after_sync": _pairs(t.idle_after_sync),
        "syncs_by_program_span": _pairs(t.syncs_by_program_span),
        "unpaired_sync_spans": _pairs(t.unpaired_sync_spans),
        "attributed": [
            ["launches_in_step", t.launches_in_step / max(t.launches, 1)],
            ["device_in_span", t.device_in_span_s / t.device_s
             if t.device_s > 0 else 0.0],
            ["runtime_syncs", sum(n for _, n in t.syncs_by_program_span)],
            ["program_sync_spans", t.sync_spans],
            ["clock_offset_open_us", t.clock_offset_us[0]],
            ["clock_offset_close_us", t.clock_offset_us[-1]],
            ["events_read", t.events_read], ["read_s", t.read_s]],
    }
