"""The readers of the program's spans on a synthetic run, the tie of a
device trace to those spans on synthetic events, and CPU rehearsals of
the traced run (``run.py --trace 1``) with a program that has the tracer
and with one that has not."""
import importlib.util
import json
import sys
import types
from pathlib import Path

import pytest

from portbench import measure
from portbench.harness import Run
from portbench.measure import int4_bound_s, paged_attention_bound_s
from portbench.program_trace import TraceResult, attribute, innermost
from portbench.run import main

# the readers of the program's spans and records
READERS = ("window_dispatch_ms", "host_syncs_per_step", "draft_device_ms",
           "verify_device_ms", "prefill_us_per_token", "attention_roofline",
           "kv_pool_use", "weight_mm_roofline")

METRICS = Path(__file__).resolve().parent / "metrics"
MODEL = dict(L=2, D=8, F=16, V=10, Hq=2, Hk=1, Dh=4, gated=True)
S = 10 ** 9     # ns a second


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Builds a program trace: ``add`` returns the new span's index."""

    def __init__(self):
        self.spans, self.records = [], {}

    def add(self, name, start, end, parent=-1, rid=-1, **args):
        self.spans.append((name, int(start), int(end), parent, rid,
                           args or None))
        return len(self.spans) - 1

    def step(self, t, syncs=(), admit=None, pages=(30, 100)):
        """A step at t s (0.2 s long): an admission, the syncs named, one
        window of draft/verify/commit, the harvest read."""
        t0 = t * S
        st = self.add("step", t0, t0 + 0.2 * S, pages_held=pages[0],
                      pool_pages=pages[1])
        if admit is not None:
            self.add("admit", t0, t0 + 0.02 * S, st, rid=admit, prompt=10)
        for k, name in enumerate(syncs):
            self.add(name, t0 + (0.021 + k * 0.001) * S,
                     t0 + (0.0215 + k * 0.001) * S, st)
        w = self.add("window", t0 + 0.05 * S, t0 + 0.15 * S, st)
        self.add("draft", t0 + 0.05 * S, t0 + 0.09 * S, w)
        v = self.add("verify", t0 + 0.09 * S, t0 + 0.12 * S, w)
        self.add("commit", t0 + 0.12 * S, t0 + 0.15 * S, w)
        self.add("sync.harvest_read", t0 + 0.16 * S, t0 + 0.18 * S, st)
        return w, v

    def program(self):
        return types.SimpleNamespace(spans=self.spans, records=self.records)


def run_of(program, trace=None):
    r = Run("w", {}, {}, MODEL, 1, 10.0, 4, t_start=100.0, t_end=110.0,
            t_host=108.0, trace=trace)
    r.program = program
    return r


def test_host_part_readers():
    b = Spans()
    b.step(100.0, syncs=("sync.finished_check", "sync.h2d"), admit=1)
    b.step(101.0, syncs=("sync.finished_check",), pages=(50, 100))
    b.step(109.0, syncs=("sync.h2d",) * 5)   # traced slice: not counted
    b.step(99.0, syncs=("sync.h2d",) * 5)    # set-up: not counted
    run = run_of(b.program())
    # two windows of 0.1 s with no sync inside them
    assert reader("window_dispatch_ms")(run) == pytest.approx(100.0)
    # syncs: 2 + harvest read, 1 + harvest read over two steps
    assert reader("host_syncs_per_step")(run) == pytest.approx(5 / 2)
    assert reader("kv_pool_use")(run) == pytest.approx(40.0)
    # a sync inside a window counts against its dispatch
    w = b.spans.index(next(s for s in b.spans if s[0] == "window"))
    b.add("sync.finished_check", 100.06 * S, 100.08 * S, w)
    assert reader("window_dispatch_ms")(run) == pytest.approx(90.0)
    # in a backlog the launch queue's waits land in the span: no reading
    run.mix = {"arrivals": {"kind": "backlog", "requests": 8}}
    assert reader("window_dispatch_ms")(run) is None
    assert reader("host_syncs_per_step")(run) == pytest.approx(6 / 2)


def test_readers_return_nothing_without_the_program_tracer():
    run = run_of(None)
    for name in READERS:
        assert reader(name)(run) is None, name
    run = run_of(Spans().program())
    for name in READERS:
        assert reader(name)(run) is None, name


def test_traced_slice_readers():
    b = Spans()
    w0, v0 = b.step(108.2, admit=5)
    w1, v1 = b.step(108.6, admit=6)
    w2, v2 = b.step(107.0, admit=4)     # begun before the slice
    draft = [i for i, s in enumerate(b.spans) if s[0] == "draft"]
    admits = [i for i, s in enumerate(b.spans) if s[0] == "admit"]
    by_span = {draft[0]: 0.010, draft[1]: 0.030, draft[2]: 1.0,
               v0: 0.020, v1: 0.020, v2: 1.0,
               admits[0]: 0.004, admits[1]: 0.006, admits[2]: 1.0, -1: 5.0}
    # one paged forward in each verify: 1000 keys and 10 rows a layer
    rec = (2, 512, 64, 1000, 10)
    b.records["paged_attention"] = [(v0,) + rec, (v1,) + rec, (v2,) + rec]
    least = paged_attention_bound_s(*rec)
    # K1 products: two in the slice's drafts and verifies, one before it
    b.records["int4_pair_matmul"] = [(draft[0], 64, 256, 768),
                                     (v1, 256, 512, 256),
                                     (draft[2], 1, 256, 256)]
    k1_least = int4_bound_s(64, 256, 768) + int4_bound_s(256, 512, 256)
    trace = TraceResult(
        slice_ns=(108 * S, 110 * S), device_by_span=by_span,
        attention_by_span={v0: least * 4, v1: least * 4, v2: 1.0},
        int4_kernels=2, int4_device_s=k1_least * 10)
    run = run_of(b.program(), trace)
    assert reader("draft_device_ms")(run) == pytest.approx(20.0)
    assert reader("verify_device_ms")(run) == pytest.approx(20.0)
    # 10 ms of admission over 20 prompt tokens
    assert reader("prefill_us_per_token")(run) == pytest.approx(500.0)
    assert reader("attention_roofline")(run) == pytest.approx(25.0)
    assert reader("weight_mm_roofline")(run) == pytest.approx(10.0)
    assert least == pytest.approx(2 * (1000 * 512 + 10 * 64)
                                  / measure.HBM_BYTES_PER_S)


def test_attribution_ties_kernels_and_gaps_to_spans():
    """Kernels go to the span open at their launch, gaps to the span that
    launched the kernel ending them; a gap that begins while the host
    waits in a synchronising call follows that call's sync span."""
    b = Spans()
    st = b.add("step", 1000, 9000)
    chk = b.add("sync.finished_check", 1100, 2600, st)
    w = b.add("window", 2600, 8000, st)
    d = b.add("draft", 2600, 5000, w)
    v = b.add("verify", 5000, 8000, w)
    b.add("sync.h2d", 7100, 7200, v)     # a span whose call is missing
    # (name, device start, end, correlation); launches in ``runtime``
    events = [("mark", 900, 910, 1),
              ("copy", 1500, 2000, 2),                      # in the check
              ("k_draft", 3000, 4000, 3),                   # gap 2000-3000
              ("flash_decode_kernel<Paged>", 5200, 6200, 4),
              ("k_verify", 6200, 7000, 5),
              ("mark", 9500, 9510, 6)]
    runtime = {1: 890, 2: 1200, 3: 2700, 4: 5100, 5: 5150, 6: 9400}
    # the check's read waits from 1300 to 2000, when the copy ends; a call
    # inside the draft has no sync span; one after the close is left out
    calls = [(1300, 2000), (3100, 3150), (9450, 9460)]
    brackets = [(880, 895), (9390, 9405)]
    out = attribute(events, runtime, calls, b.spans, brackets)
    assert out["clock_offset_us"] == pytest.approx((0.02, 0.11))
    assert out["device_by_span"] == pytest.approx(
        {chk: 500e-9, d: 1000e-9, v: 1800e-9})
    assert out["attention_by_span"] == pytest.approx({v: 1000e-9})
    idle = dict(out["idle_by_program_span"])
    # 910-1500 ends at the check's copy; 2000-3000 at the draft kernel;
    # 4000-5200 at the verify's; 7000-9500 at the closing mark
    assert idle == pytest.approx({"step/sync.finished_check": 590e-9,
                                  "step/window/draft": 1000e-9,
                                  "step/window/verify": 1200e-9,
                                  "harness": 2500e-9})
    assert dict(out["idle_after_sync"]) == pytest.approx(
        {"sync.finished_check": 1000e-9})
    assert dict(out["syncs_by_program_span"]) == {
        "step/sync.finished_check": 1, "unmarked:step/window/draft": 1}
    assert out["unpaired_sync_spans"] == [("step/window/verify/sync.h2d", 1)]
    assert out["sync_spans"] == 2
    assert out["launches"] == 4 and out["launches_in_step"] == 4
    assert out["device_in_span_s"] == pytest.approx(out["device_s"])
    # the device's clock running from 50 ns to 1050 ns ahead of the host's:
    # launches keep their spans, a kernel with no launch event is placed by
    # its start less the lead, and the gaps keep their labels
    def late(t):
        return t + 50 + 1000 * (t - 890) / (9400 - 890)
    shifted = [(n, late(s), late(s) + e - s, c) for n, s, e, c in events]
    no_launch = {c: t for c, t in runtime.items() if c != 3}
    out2 = attribute(shifted, no_launch, calls, b.spans, brackets)
    lead = out2["clock_offset_us"]
    assert lead[1] - lead[0] == pytest.approx(1.0, abs=0.2)
    assert out2["device_by_span"] == pytest.approx(out["device_by_span"])
    assert dict(out2["idle_by_program_span"]).keys() == idle.keys()
    assert dict(out2["idle_after_sync"]).keys() == {"sync.finished_check"}


def test_innermost_prefers_the_child_at_shared_instants():
    spans = [("step", 0, 10, -1, -1, None), ("window", 0, 10, 0, -1, None),
             ("draft", 0, 4, 1, -1, None), ("verify", 4, 10, 1, -1, None)]
    find = innermost(spans)
    assert [find(t) for t in (-1, 0, 3, 4, 9, 10, 11)] == [
        -1, 2, 2, 3, 3, -1, -1]


def _line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("has_tracer", [True, False])
def test_cpu_rehearsal(tiny_root, capsys, monkeypatch, has_tracer):
    """The traced run on the CPU prints the program-span metrics and the
    breakdown by program span; with a program that has no tracer it prints
    the others and no span-based one."""
    from specdec_tpu_torch.utils import profiling

    if not has_tracer:
        monkeypatch.delattr(profiling, "TRACER")
    root = tiny_root(family="qwen3", arrivals="poisson")
    rc = main(["--workload", "tiny.poisson", "--seed", str(2 ** 31 + 7),
               "--seconds", "4", "--trace", "1"], root=root, device="cpu")
    assert rc == 0
    line = _line(capsys.readouterr().out)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["kind"] == "cpu" and list(line)[-1] == "checks"
    bd = line["breakdown"]
    assert {"device_ops", "idle_gaps"} <= set(bd)
    for key, rows in bd.items():     # lists of [name, number], 10 at most
        assert len(rows) <= 10, key
        assert all(isinstance(r[0], str) and len(r) == 2 for r in rows), key
    names = set(line["metrics"])
    assert {"step_ms", "slot_occupancy", "device_idle"} <= names
    program_metrics = {"window_dispatch_ms", "host_syncs_per_step",
                       "kv_pool_use", "draft_device_ms", "verify_device_ms",
                       "prefill_us_per_token"}
    if has_tracer:
        assert program_metrics <= names
        assert "attention_roofline" not in names   # no K8a on the CPU
        assert bd["idle_gaps"] and bd["device_by_program_span"]
        assert dict(bd["attributed"])["launches_in_step"] > 0.9
        assert profiling.TRACER.on is False
    else:
        assert not names & set(READERS)
        # no span to tie the device time to
        assert [p for p, _ in bd["device_by_program_span"]] == ["harness"]


def test_refuses_with_a_forbidden_module_loaded(tiny_root, capsys,
                                                monkeypatch):
    """run.main's guard holds in a traced run: with JAX loaded no line is
    printed."""
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    root = tiny_root(family="qwen3", arrivals="backlog")
    rc = main(["--workload", "tiny.backlog", "--seed", "3", "--seconds",
               "1", "--trace", "1"], root=root, device="cpu")
    assert rc == 3 and capsys.readouterr().out == ""


def test_a_step_past_the_slice_leaves_the_tracer_unstarted(monkeypatch):
    """One step that runs from the window's open past its close: the
    slice never starts, the window still closes, no trace is read and
    the program's tracer is off again."""
    import time

    import torch

    from portbench import harness
    from portbench.conftest import tiny_config, tiny_mix
    from portbench.program_trace import Tracer
    from specdec_tpu_torch.utils.profiling import TRACER

    cfg, mix = tiny_config("qwen3"), tiny_mix("poisson")
    seconds = 2.0
    step, long = harness.Driver.step, []

    def slow_step(self):
        if not long and time.time() >= self.t0 + mix["arrivals"][
                "preroll_s"]:
            long.append(time.time())
            time.sleep(seconds + 0.5)
        return step(self)
    monkeypatch.setattr(harness.Driver, "step", slow_step)
    program = harness.Program(cfg, torch.device("cpu"))
    run = harness.run_window(program, cfg, mix, "tiny.poisson", 5, seconds,
                             time.time(), Tracer(torch.device("cpu")))
    assert long and run.t_start <= long[0] < run.t_start + seconds
    assert run.t_end >= run.t_start + seconds
    assert run.trace is None and run.program is None
    assert run.t_host == run.t_end and TRACER.on is False
