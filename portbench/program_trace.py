"""A traced run of one cell with the program's own spans.

    python3 -m portbench.program_trace --workload <cell> --seed <n> --seconds <s>

It runs the cell through ``portbench.run``'s own ``main`` with
``--trace 1``: the same program, traffic, window, profiled slice at the
window's end, check and guards (the card count, the modules that may not
be loaded), and the same result line. Two things are added:

- The program's tracer (``specdec_tpu_torch.utils.profiling.TRACER``) is on
  from the set-up's start to the window's close. Its spans and records
  land in ``run.program``; the readers count only what began inside the
  window's parts.
- The device trace keeps the CUDA runtime's events. Each kernel is tied,
  through its correlation id, to its launch, and so to the program span
  open at that moment. Each idle gap is labelled with the span open at the
  launch of the kernel that ends it.

The line it prints adds the metrics of ``READERS`` to the cell's
per-layer metrics, and to the ``breakdown`` ``idle_by_program_span`` and
``device_by_program_span`` by span path (``step/window/draft``), the device
operations by span path, the idle time of the gaps that began while the
host waited in a synchronising call (by the ``sync.*`` span around the
call), and the shares that tie the trace to the spans. A
program without the tracer runs too: then those keys are empty and the
readers return nothing. ``run.py`` does not call this module: this one
swaps its own ``ProgramTracer`` and report in for the length of a call.

The profiler stamps the runtime's events on the program's clock, and the
device's kernels on one that drifts from it (``attribute``). The lead of
the device's clock at the two fill marks is printed.
"""
from __future__ import annotations

import time

T_PROC0 = time.time()

import bisect  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Sequence, Tuple  # noqa: E402

import torch  # noqa: E402

from portbench import measure  # noqa: E402
from portbench.program_spans import (  # noqa: E402
    END, NAME, PARENT, START, path,
)
from portbench.trace import (  # noqa: E402
    BASE, Tracer, TraceResult, _start_ns, reduce_trace,
)

# metric readers that need the program's spans, and their units
READERS = {"window_dispatch_ms": "ms", "host_syncs_per_step": "count",
           "draft_device_ms": "ms", "verify_device_ms": "ms",
           "prefill_us_per_token": "us", "attention_roofline": "%",
           "kv_pool_use": "%"}

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
class ProgramTraceResult(TraceResult):
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
    ``ProgramTraceResult`` fields past ``TraceResult``'s."""
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
    ops: Dict[Tuple[str, str], float] = {}
    in_step = 0
    for e in body:
        i, d = launched(e), (e[2] - e[1]) / 1e9
        by_span[i] = by_span.get(i, 0.0) + d
        if "flash_decode_kernel" in e[0] and "Paged" in e[0]:
            attention[i] = attention.get(i, 0.0) + d
        p = label(i)
        in_step += p == "step" or p.startswith("step/")
        by_path[p] = by_path.get(p, 0.0) + d
        key = (p, measure.kernel_label(e[0]))
        ops[key] = ops.get(key, 0.0) + d
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


class ProgramTracer(Tracer):
    """``trace.Tracer`` with the program's tracer on and the runtime's
    events kept."""

    def __init__(self, device):
        super().__init__(device)
        self.program = program_tracer()
        self.drained = None
        self.result = None
        self._brackets: List[Tuple[int, int]] = []

    def warm(self):
        super().warm()
        if self.program is not None:
            self.program.drain()
            self.program.enable()

    def _mark(self) -> int:
        """``Tracer._mark``, keeping the host time after the launch too."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t = time.time_ns()
        torch.empty(1, device=self.device).fill_(1.0)
        self._brackets.append((t, time.time_ns()))
        if cuda:
            torch.cuda.synchronize()
        return t

    def start(self):
        super().start()
        self._brackets = self._brackets[-1:]

    def stop(self) -> ProgramTraceResult:
        h1 = self._mark()
        self.spans.on = False
        if self.program is not None:
            self.program.disable()
            self.drained = self.program.drain()
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
        self.close()
        base = reduce_trace([e[:3] for e in device], self._h0, h1,
                            self.spans, self.calls)
        spans = self.drained.spans if self.drained is not None else []
        out = ProgramTraceResult(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(TraceResult)},
            **attribute(device, runtime, syncs, spans, self._brackets),
            events_read=len(events), read_s=time.time() - t0)
        print(f"[trace] {out.events_read} events read and tied to the "
              f"program's spans in {out.read_s:.1f} s", file=sys.stderr,
              flush=True)
        self.result = out
        return out


def breakdown(t: ProgramTraceResult) -> dict:
    """What a traced run's breakdown gains over ``run.main``'s."""
    return {
        "idle_by_program_span": [list(kv) for kv in t.idle_by_program_span],
        "device_by_program_span": [list(kv)
                                   for kv in t.device_by_program_span],
        "ops_by_program_span": [list(kv) for kv in t.ops_by_program_span],
        "idle_after_sync": [list(kv) for kv in t.idle_after_sync],
        "syncs_by_program_span": [list(kv) for kv in t.syncs_by_program_span],
        "unpaired_sync_spans": [list(kv) for kv in t.unpaired_sync_spans],
        "attributed": {
            "launches_in_step": t.launches_in_step / max(t.launches, 1),
            "device_in_span": t.device_in_span_s / t.device_s
            if t.device_s > 0 else None,
            "runtime_syncs": sum(n for _, n in t.syncs_by_program_span),
            "program_sync_spans": t.sync_spans,
            "clock_offset_us": list(t.clock_offset_us),
            "events_read": t.events_read, "read_s": t.read_s},
    }


def main(argv=None, root=None, device=None, t_proc0=None) -> int:
    """Run the cell through ``run.main`` with ``--trace 1``, its tracer a
    ``ProgramTracer``; returns the exit code. ``run.main`` builds, runs
    and checks the cell and keeps its guards; this adds ``READERS`` to its
    report and the program's breakdown to its line. ``device`` None means
    the card; tests pass "cpu"."""
    from portbench import run as R
    from portbench import trace as T

    made: List[ProgramTracer] = []

    def tracer(device):
        made.append(ProgramTracer(device))
        return made[-1]

    def report(run, entries, cell):
        run.program = made[-1].drained if made else None
        out = base_report(run, entries, cell)
        for name, unit in READERS.items():
            v = cell.reader(name)(run)
            if v is not None:
                out[name] = {"value": float(v), "unit": unit}
        return out

    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    base_report, base_tracer = R.report, T.Tracer
    R.report, T.Tracer = report, tracer
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = R.main(argv, root=root, device=device,
                        t_proc0=T_PROC0 if t_proc0 is None else t_proc0)
    finally:
        R.report, T.Tracer = base_report, base_tracer
    lines = buf.getvalue().splitlines()
    if rc != 0 or not made or not lines:
        sys.stdout.write(buf.getvalue())
        return rc
    result = json.loads(lines[-1])
    extra = breakdown(made[-1].result)
    result["breakdown"].update(extra)
    a = extra["attributed"]
    R.log(f"[attribution] launches inside a step span "
          f"{a['launches_in_step']}, device time tied to a span "
          f"{a['device_in_span']}; synchronising runtime calls "
          f"{a['runtime_syncs']} against {a['program_sync_spans']} sync.* "
          f"spans; device clock ahead by {a['clock_offset_us']} us")
    for line in lines[:-1]:
        print(line)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
