"""The metrics' arithmetic on synthetic runs, the trace reduction on
synthetic events, and a CPU rehearsal of a whole run: a tiny
configuration, mix, cell and metric, each added as a new file, driven
through the harness's cell loop with ``device="cpu"``."""
import importlib.util
import json
from pathlib import Path

import pytest

from portbench import measure
from portbench.harness import Req, Run
from portbench.program_trace import TraceResult, attribute
from portbench.run import main
from portbench.weights import family

METRICS = Path(__file__).resolve().parent / "metrics"
MODEL = dict(L=2, D=8, F=16, V=10, Hq=2, Hk=1, Dh=4)
QWEN3 = family({"model_type": "qwen3"})


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_of(reqs, **kw):
    r = Run("w", {}, {}, MODEL, 1, 10.0, 4, t_start=100.0, t_end=110.0,
            t_host=110.0, **kw)
    r.reqs = {q.rid: q for q in reqs}
    return r


def test_percentile_linear():
    assert measure.percentile([], 90) is None
    assert measure.percentile([5.0], 90) == 5.0
    assert measure.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 90) == \
        pytest.approx(9.1)


def test_ttft_from_due_with_censored_waits():
    reqs = [Req(0, due=99.0, prompt_len=4, asked=4, first=99.5),  # before
            Req(1, due=101.0, prompt_len=4, asked=4, first=101.2),
            Req(2, due=102.0, prompt_len=4, asked=4, first=102.4),
            Req(3, due=108.0, prompt_len=4, asked=4),           # censored
            Req(4, due=109.0, prompt_len=4, asked=4, first=111.0)]
    # waits 200, 400, 2000 (to the close), 1000 (to the close)
    got = reader("ttft_p90_ms")(run_of(reqs))
    assert got == pytest.approx(measure.percentile([200, 400, 2000, 1000],
                                                   90))
    qw = [Req(0, due=101.0, prompt_len=4, asked=4, admit=101.1),
          Req(1, due=105.0, prompt_len=4, asked=4)]
    assert reader("queue_wait_p90_ms")(run_of(qw)) == pytest.approx(
        measure.percentile([100, 5000], 90))


def test_out_tok_s_counts_edges():
    reqs = [Req(0, 90.0, 4, 20, end=103.0, generated=20, at_start=15,
                at_end=20),                     # finished in the window
            Req(1, 95.0, 4, 20, at_start=3, at_end=11),   # live at both ends
            Req(2, 104.0, 4, 20, at_start=0, at_end=6),   # admitted in it
            Req(3, 80.0, 4, 9, end=90.0, generated=9, at_start=9,
                at_end=9)]                      # finished before it
    assert reader("out_tok_s")(run_of(reqs)) == pytest.approx(
        (5 + 8 + 6) / 10.0)
    tp = reader("tpot_p90_ms")(run_of([Req(0, 90.0, 4, 11, first=101.0,
                                          end=102.0, generated=11)]))
    assert tp == pytest.approx(100.0)


def test_acceptance_and_occupancy():
    reqs = [Req(0, 90.0, 4, 8, end=101.0, accepted=3, drafted=4),
            Req(1, 90.0, 4, 8, end=102.0, accepted=0, drafted=8),
            Req(2, 90.0, 4, 8, end=95.0, accepted=9, drafted=9)]
    assert reader("acceptance")(run_of(reqs)) == pytest.approx(25.0)
    r = run_of([], steps=4, live_sum=10)
    assert reader("slot_occupancy")(r) == pytest.approx(62.5)
    assert reader("step_ms")(r) == pytest.approx(2500.0)


def test_union_and_idle_share():
    ivs = [(0, 2), (1, 3), (5, 6), (6, 7), (9, 12)]
    assert measure.union(ivs) == [(0, 3), (5, 7), (9, 12)]
    assert measure.gaps(ivs, 1, 10) == [(3, 5), (7, 9)]
    # two marks (launched at host 0 and 10000 ns, seen on the device
    # 500 ns later), two kernels, one of them the weight kernel; no span
    ev = [("mark", 500, 510, 1),
          ("int4_pair_matmul_kernel<1>", 1510, 2510, 2),
          ("other", 2000, 4510, 3), ("mark", 10500, 10510, 4)]
    out = attribute(ev, {1: 0, 2: 1000, 3: 1100, 4: 10000}, [], [],
                    [(0, 1), (10000, 10001)])
    t = TraceResult(**out)
    assert t.window_s == pytest.approx(9990e-9)
    assert t.busy_s == pytest.approx(3000e-9)
    assert dict(t.device_ops) == pytest.approx(
        {"int4_pair_matmul": 1000e-9, "other": 2510e-9})
    assert dict(t.idle_by_program_span) == pytest.approx(
        {"harness": 6990e-9})
    assert (t.int4_kernels, t.int4_device_s) == (1, pytest.approx(1e-6))
    run = run_of([], trace=t)
    assert reader("device_idle")(run) == pytest.approx(100 * 6990 / 9990)


def test_int4_bound_and_flops():
    # bytes-bound at M = 1: K*N/2 + K*N/32 + 2K + 2N bytes
    K, N = 4096, 12288
    assert measure.int4_bound_s(1, K, N) == pytest.approx(
        (K * N * (0.5 + 1 / 32) + 2 * K + 2 * N) / 3.35e12)
    # operations-bound at M = 4096
    assert measure.int4_bound_s(4096, K, N) == pytest.approx(
        2 * 4096 * K * N / 989e12)
    per_layer = 8 * 16 + 8 * 8 + 2 * 8 * 16 + 16 * 8     # qkv wo gate/up down
    assert QWEN3.weights_per_token(MODEL) == 2 * per_layer
    # a 3-token prompt: 3 tokens through the layers, keys 1 + 2 + 3
    attn = 4.0 * 2 * 2 * 4
    assert measure.required_flops(QWEN3, MODEL, [3], []) == pytest.approx(
        2 * 2 * per_layer * 3 + attn * 6)
    # outputs 0..2 of that request: outputs 1, 2 process positions 3, 4
    # (4 and 5 keys); three heads
    assert measure.required_flops(QWEN3, MODEL, [], [(3, 0, 3)]) == \
        pytest.approx(2 * 2 * per_layer * 2 + attn * 9 + 3 * 2 * 8 * 10)


@pytest.mark.parametrize("first,last", [(0, 0), (0, 1), (0, 9), (3, 4),
                                        (5, 40), (30, 31), (40, 30)])
@pytest.mark.parametrize("window", [1, 4, 32, 1000])
def test_window_keys(first, last, window):
    assert measure.window_keys(first, last, window) == sum(
        min(p + 1, window) for p in range(first, last))
    assert measure.causal_keys(first, last) == sum(
        p + 1 for p in range(first, last))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("family,arrivals,trace", [
    ("qwen3", "poisson", 0), ("gpt_neox", "backlog", 1)])
def test_cpu_rehearsal(tiny_root, capsys, family, arrivals, trace):
    """A cell, a mix and a metric added as files run through the cell
    loop; the line holds the contract's keys and the new metric."""
    metric = ("def read(run):\n"
              "    return 100.0 * run.steps / max(run.steps, 1)\n")
    root = tiny_root(family=family, arrivals=arrivals, metric=metric)
    rc = main(["--workload", f"tiny.{arrivals}", "--seed", str(2 ** 31 + 5),
               "--seconds", "2", "--trace", str(trace)], root=root,
              device="cpu")
    assert rc == 0
    line = _last_json(capsys.readouterr().out)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    names = set(line["metrics"])
    if trace:
        assert {"tiny_metric", "step_ms", "slot_occupancy", "acceptance",
                "mfu", "device_idle", "host_syncs_per_step", "kv_pool_use",
                "draft_device_ms", "verify_device_ms"} <= names
        # no K1 or K8a launch on the CPU: nothing to read, no reading
        assert not {"weight_mm_roofline", "attention_roofline"} & names
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
    else:
        assert {"out_tok_s", "setup_s", "ttft_p90_ms"} <= names
        assert "tiny_metric" not in names


def test_refuses_without_card(tiny_root, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR",
                "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, "unset")
    root = tiny_root()
    rc = main(["--workload", "tiny.poisson", "--seed", "1", "--seconds", "1",
               "--trace", "0"], root=root)
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("key,value", [("drafter", "eagle"),
                                       ("weights", "int8")])
def test_program_refuses_what_it_does_not_build(key, value):
    """A configuration that asks for another drafter or weight format is
    refused, not built as an INT4 LayerSkip pair."""
    import torch

    from portbench.conftest import tiny_config
    from portbench.harness import Program

    cfg = tiny_config("qwen3")
    cfg[key]["kind" if key == "drafter" else "format"] = value
    with pytest.raises(ValueError, match=value):
        Program(cfg, torch.device("cpu"))
