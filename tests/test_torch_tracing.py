"""The serving path's tracer (``utils/profiling.py``) on tiny INT4 paged
runs on the CPU: the spans nest as named, the ``sync.*`` spans match the
host/device exchanges the run made, an off tracer keeps nothing, and the
records (K1 shapes, live keys, pages) equal what the batcher and the
benchmark's own ``qmatmul`` wrapper see."""
from collections import Counter

import pytest
import torch

from portbench.trace import Tracer as BenchTracer
from specdec_tpu_torch.core.config import tiny_config
from specdec_tpu_torch.core.model import init_params, layer_views
from specdec_tpu_torch.quant.core import quantize_params
from specdec_tpu_torch.serve import PagedContinuousBatcher
from specdec_tpu_torch.utils import profiling
from specdec_tpu_torch.utils.profiling import TRACER

torch.set_num_threads(2)

# widths the INT4 kernel route takes (K a multiple of 256)
CFG = tiny_config(vocab_size=256, hidden_size=256, intermediate_size=512,
                  num_heads=4, num_kv_heads=2, head_dim=64, num_layers=2)
D_CFG = CFG.replace(num_layers=1)
PROMPTS = [[3, 14, 15, 9, 2, 6], [1, 1, 2, 3, 5, 8, 13, 21, 34], [27, 4],
           list(range(40, 52))]
GAMMA = 3

# which spans open inside which
CHILDREN = {"step": {"admit", "sync.stamp", "top_up", "sync.finished_check",
                     "window", "sync.harvest_read", "harvest"},
            "admit": {"sync.h2d", "prefill"},
            "prefill": {"sync.h2d", "sync.scalar_write"},
            "top_up": {"sync.h2d"}, "window": {"draft", "verify", "commit"}}


@pytest.fixture(scope="module")
def pair():
    target = quantize_params(init_params(CFG, seed=0, scale=0.05,
                                         device="cpu"), kind="int4", fuse=True)
    return dict(target, layers=layer_views(target["layers"], 1)), target


def batcher(pair, windows_per_sync=2):
    drafter, target = pair
    return PagedContinuousBatcher(
        D_CFG, drafter, CFG, target, num_slots=2, gamma=GAMMA,
        max_prompt_len=16, max_new_tokens=10, page_size=8,
        windows_per_sync=windows_per_sync, eos_tokens_id=(), device="cpu")


def drive(b, after_step=None):
    """Submit every prompt, then step until all are served; returns the
    request ids."""
    rids = [b.submit(p, max_new_tokens=6 + i) for i, p in enumerate(PROMPTS)]
    while b.queue or b._prefilling or any(r is not None for r in b.slot_req):
        b.step()
        if after_step is not None:
            after_step(b)
    return rids


def traced(b, after_step=None, before_drain=None):
    TRACER.drain()
    TRACER.enable()
    try:
        rids = drive(b, after_step)
    finally:
        TRACER.disable()
        if before_drain is not None:
            before_drain()
    return rids, TRACER.drain()


class Exchanges:
    """Counts the calls that move data between host and device on the
    card: device-to-host reads, and uploads (a host array made a tensor, a
    tensor made from host values on a named device, a host number written
    into a tensor)."""

    READS = ("cpu", "item", "tolist", "__bool__")

    def __init__(self, monkeypatch):
        self.reads = self.uploads = 0
        for name in self.READS:
            self._count(monkeypatch, torch.Tensor, name, "reads")
        self._count(monkeypatch, torch, "from_numpy", "uploads")
        self._count(monkeypatch, torch, "tensor", "uploads",
                    lambda a, kw: "device" in kw)
        self._count(monkeypatch, torch.Tensor, "__setitem__", "uploads",
                    lambda a, kw: isinstance(a[-1], (bool, int, float)))

    def _count(self, monkeypatch, owner, name, field,
               counts=lambda a, kw: True):
        fn = getattr(owner, name)

        def counted(*a, **kw):
            if counts(a, kw):
                setattr(self, field, getattr(self, field) + 1)
            return fn(*a, **kw)
        monkeypatch.setattr(owner, name, counted)


def test_spans_nest_as_named(pair):
    b = batcher(pair)
    rids, trace = traced(b)
    spans = trace.spans
    assert {s[0] for s in spans} == set(CHILDREN) | {
        "sync.stamp", "sync.finished_check", "sync.harvest_read", "harvest",
        "sync.h2d", "sync.scalar_write", "draft", "verify", "commit"}
    for name, start, end, parent, rid, args in spans:
        assert start <= end
        if parent < 0:
            assert name == "step"
            continue
        p = spans[parent]
        assert name in CHILDREN[p[0]], (name, p[0])
        assert p[1] <= start and end <= p[2]
        assert rid == p[4] or p[4] == -1 and name == "admit"
    admits = [s for s in spans if s[0] == "admit"]
    assert sorted(s[4] for s in admits) == sorted(rids)
    for s in admits:
        assert s[5] == {"prompt": len(PROMPTS[rids.index(s[4])])}
    # each window opens one draft, one verify and one commit, in order
    for w in (i for i, s in enumerate(spans) if s[0] == "window"):
        assert [s[0] for s in spans if s[3] == w] == [
            "draft", "verify", "commit"]


def test_sync_spans_match_the_exchanges(pair, monkeypatch):
    b = batcher(pair)
    ex = Exchanges(monkeypatch)
    # the drain's own read of the records comes after the count
    _, trace = traced(b, before_drain=monkeypatch.undo)
    c = Counter(s[0] for s in trace.spans)
    assert ex.reads == (c["sync.finished_check"] + c["sync.harvest_read"]
                        + c["sync.stamp"])
    assert ex.uploads == c["sync.h2d"] + c["sync.scalar_write"]
    # an admission uploads the target's table row, the prompt and the
    # first token's limit, and writes five counters and two cache lengths
    in_admit = [s[0] for s in trace.spans if s[0].startswith("sync.")
                and trace.spans[s[3]][0] in ("admit", "prefill")]
    assert in_admit.count("sync.h2d") == 3 * len(PROMPTS)
    assert in_admit.count("sync.scalar_write") == 7 * len(PROMPTS)
    assert c["sync.harvest_read"] == c["step"]


def test_off_tracer_keeps_nothing(pair):
    assert not TRACER.on
    assert TRACER.span("step") is TRACER.span("admit", 3)
    TRACER.drain()
    drive(batcher(pair))
    trace = TRACER.drain()
    assert trace.spans == [] and trace.records == {}


def test_k1_record_equals_the_benchmark_wrapper(pair):
    b = batcher(pair)
    bench = BenchTracer(torch.device("cpu"))
    bench.instrument(b)
    bench.spans.on = True
    try:
        _, trace = traced(b)
    finally:
        bench.close()
    got = [r[1:] for r in trace.records["int4_pair_matmul"]]
    assert got and got == bench.calls
    # every K1 launch is made inside a prefill, draft or verify span
    kinds = {trace.spans[r[0]][0] for r in trace.records["int4_pair_matmul"]}
    assert kinds == {"prefill", "draft", "verify"}


def test_live_keys_and_pages_equal_the_host_state(pair):
    """One window a sync, so the host mirror of the positions is the
    device's at every window: each verify attends, on every live row, its
    committed positions less one plus the gamma+1 block."""
    b = batcher(pair, windows_per_sync=1)
    expected, held = [], []
    window = b._window_step

    def window_step():
        live = [s for s, r in enumerate(b.slot_req) if r is not None]
        expected.append(sum(int(b._host_pos[s]) - 1 + GAMMA + 1
                            for s in live))
        window()
    b._window_step = window_step
    _, trace = traced(b, lambda b: held.append(
        sum(len(p) for p in b._slot_pages_t)))
    recs = trace.records["paged_attention"]
    assert [trace.spans[r[0]][0] for r in recs] == ["verify"] * len(recs)
    L, kv, q = CFG.num_layers, 2 * 2 * 64 * 4, 2 * 4 * 64 * 4
    assert all(r[1:4] == (L, kv, q) for r in recs)
    assert [r[4] for r in recs] == expected
    assert sum(r[4] for r in recs) == sum(expected)
    steps = [s[5] for s in trace.spans if s[0] == "step"]
    assert [s["pages_held"] for s in steps] == held
    assert {s["pool_pages"] for s in steps} == {b.num_pages - 1}


def test_drain_reads_device_tensors_once_a_kind():
    t = profiling.Tracer()
    t.enable()
    with t.span("step"):
        t.note(pages_held=2)
        with t.span("sync.stamp"):
            pass
        t.note(pages_held=1)
        t.record("k", 1, torch.tensor([3, 4]))
        t.record("k", 2, torch.tensor([5, 6]))
        t.record("plain", 7)
    out = t.drain()
    assert out.spans[0][5] == {"pages_held": 3} and out.spans[1][5] is None
    assert out.records == {"k": [(0, 1, 3, 4), (0, 2, 5, 6)],
                           "plain": [(0, 7)]}
    assert t.drain().spans == []
