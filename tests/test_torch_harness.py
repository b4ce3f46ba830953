"""The port's benchmark harness against the JAX package's:
``engine/{benchmark_runner,benchmark_executor,dataset,monitor,
server_benchmark,vllm_compat}.py``, ``utils/{printing,profiling}.py`` and
``cli/benchmark.py``.

The runner cases load one tiny f32 llama checkpoint (built here, with a
word-level tokenizer) in both packages with the same environment and
ShareGPT file, the port on the CPU: the result files' nested key sets, the
prompts chosen and the request counts are equal; greedy target_ar and
ngram give JAX's tokens; speculative runs self-draft (target = drafter),
so greedy acceptance is 1.0 and the tokens are AR's, as the port's other
speculative parity tests hold them. The telemetry cases are JAX's
``tests/test_harness.py`` cases, plus the NVML sampler on a fake
library."""
import ctypes
import json
import random
import time
import warnings

import pytest
import torch

from specdec_tpu.engine import benchmark_executor as jexec
from specdec_tpu.engine import dataset as jds
from specdec_tpu.engine import infer_engine as jie
from specdec_tpu.utils import printing as jprint

from specdec_tpu_torch.engine import benchmark_executor as texec
from specdec_tpu_torch.engine import dataset as tds
from specdec_tpu_torch.engine import infer_engine as tie
from specdec_tpu_torch.engine import monitor as tmon
from specdec_tpu_torch.engine.model_loader import load_models
from specdec_tpu_torch.engine.server_benchmark import run_server_benchmark
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate
from specdec_tpu_torch.utils import printing as tprint
from specdec_tpu_torch.utils import profiling as tprof

from test_torch_loader import build_hf, write_tokenizer

torch.set_num_threads(2)

PROMPTS = ["tell me about speculative decoding", "what is a systolic array",
           "the cat sat on a mat and then it ran", "hello world",
           "drafts verify tokens fast", "model slow the cat"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("harness_ckpt")
    build_hf("llama", seed=3).save_pretrained(d)
    write_tokenizer(d)
    return str(d)


@pytest.fixture
def bench_env(tmp_path, monkeypatch, ckpt):
    sg = tmp_path / "sharegpt"
    sg.mkdir()
    with open(sg / "sharegpt_gpt4.jsonl", "w") as f:
        for i, p in enumerate(PROMPTS):
            conv = [{"from": "human", "value": p}]
            if i % 2:
                conv.append({"from": "gpt", "value": "an answer"})
            f.write(json.dumps({"conversations": conv}) + "\n")
        f.write("not json\n")
    for k, v in dict(TARGET_MODEL=ckpt, DRAFTER_MODEL=ckpt, GAMMA_VALUE="3",
                     GENERATION_LENGTH="8", NUM_PROMPTS="3",
                     ENABLE_BATCH="false", ENABLE_GPU_MONITOR="true",
                     GPU_MONITOR_INTERVAL="0.05", SHAREGPT_DIR=str(sg),
                     MODEL_DTYPE="float32").items():
        monkeypatch.setenv(k, v)
    return tmp_path


def keyset(x):
    """The nested key structure of a JSON value."""
    if isinstance(x, dict):
        return {k: keyset(v) for k, v in x.items()}
    if isinstance(x, list):
        return [keyset(x[0])] if x else []
    return None


# the engines infer_batch dispatches to (AR first: it returns the outputs
# alone, the others (outputs, rates[, table]))
ENGINES = ("batch_autoregressive_generate", "batch_speculative_generate",
           "batch_ngram_assisted_generate",
           "device_ngram_assisted_generate_batch", "batch_eagle_generate")


def run_runner(package, tmp_path, monkeypatch, name):
    """One runner run with its prompts and engine outputs recorded.
    Returns (runner, prompts, outputs, {file: json})."""
    if package == "jax":
        from specdec_tpu.engine import eagle_batch
        from specdec_tpu.engine.benchmark_runner import BenchmarkRunner
        from specdec_tpu.ngram import assisted, device_assisted
        executor, kw = jexec, {}
        # the JAX engine imports these where it calls them
        engines = {"batch_autoregressive_generate": jie,
                   "batch_speculative_generate": jie,
                   "batch_ngram_assisted_generate": assisted,
                   "device_ngram_assisted_generate_batch": device_assisted,
                   "batch_eagle_generate": eagle_batch}
    else:
        from specdec_tpu_torch.engine.benchmark_runner import BenchmarkRunner
        executor, kw = texec, {"device": "cpu"}
        engines = dict.fromkeys(ENGINES, tie)
    base = tmp_path / f"{package}_{name}.json"
    monkeypatch.setenv("OUTPUT_FILE", str(base))
    prompts, outputs = [], []
    infer = executor.infer_batch

    def recording_infer(ctx, batch):
        prompts.append(list(batch))
        return infer(ctx, batch)
    monkeypatch.setattr(executor, "infer_batch", recording_infer)
    for fn, module in engines.items():
        def wrapped(*a, _f=getattr(module, fn), _ar=fn == ENGINES[0], **k):
            out = _f(*a, **k)
            outputs.append([[int(t) for t in o]
                            for o in (out if _ar else out[0])])
            return out
        monkeypatch.setattr(module, fn, wrapped)
    # the first request's prompt is drawn before any request seeds Python's
    # random (both runners), so both start from the same state
    random.seed(1234)
    runner = BenchmarkRunner(**kw)
    files = {p.name.replace(f"{package}_", ""): json.loads(p.read_text())
             for p in tmp_path.glob(f"{package}_{name}*.json")}
    return runner, prompts, outputs, files


METHODS = {
    "speculative": {},
    "target_ar_batch": dict(INFERENCE_METHOD="target_ar", ENABLE_BATCH="true",
                            BATCH_SIZE="2"),
    "ngram": dict(INFERENCE_METHOD="ngram"),
    "ngram_device": dict(INFERENCE_METHOD="ngram", NGRAM_DEVICE="true",
                         ENABLE_BATCH="true", BATCH_SIZE="2",
                         NGRAM_DEVICE_CAPACITY="256"),
    "eagle": dict(DRAFTER_MODEL="eagle:1"),
}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_benchmark_runner_matches_jax(bench_env, monkeypatch, method):
    for k, v in METHODS[method].items():
        monkeypatch.setenv(k, v)
    ours, o_prompts, o_outs, o_files = run_runner(
        "torch", bench_env, monkeypatch, method)
    theirs, j_prompts, j_outs, j_files = run_runner(
        "jax", bench_env, monkeypatch, method)
    # the same result files with the same nested keys
    assert sorted(o_files) == sorted(j_files) and len(o_files) == 3
    assert {k: keyset(v) for k, v in o_files.items()} == {
        k: keyset(v) for k, v in j_files.items()}
    assert o_files[f"{method}_gpu.json"]["power_source"] == "estimated_tdp"
    # the same prompts, in the same batches
    assert o_prompts == j_prompts and len(sum(o_prompts, [])) == 3
    res, ref = (r.spec_results or r.target_results for r in (ours, theirs))
    assert res.method == ref.method
    assert res.total_requests == ref.total_requests == 3
    assert res.total_batches == ref.total_batches
    assert [r.prompt_tokens for b in res.batches for r in b.requests] == [
        r.prompt_tokens for b in ref.batches for r in b.requests]
    if method == "eagle":
        assert ours.eagle_drafter and theirs.eagle_drafter
        assert all(len(o) == 8 for batch in o_outs for o in batch)
        return
    # greedy: JAX's tokens (self-draft speculative and NASD are greedy AR)
    assert o_outs == j_outs and res.total_tokens == ref.total_tokens
    if method == "speculative":
        assert res.avg_acceptance_rate == ref.avg_acceptance_rate == 1.0
        ids = tie.tokenize_batch(ours.tokenizer, o_prompts[0], 512)[0]
        assert o_outs[0][0] == autoregressive_generate(
            ids, ours.target_cfg, ours.target_params, max_gen_len=8,
            eos_tokens_id=ours.end_tokens, device="cpu")


def test_benchmark_runner_open_loop(bench_env, monkeypatch):
    """NUM_PROMPTS=0: requests arrive at AUTO_RATE for AUTO_DURATION, one
    at a time; the runner stops at the deadline."""
    from specdec_tpu_torch.engine.benchmark_runner import BenchmarkRunner

    for k, v in dict(NUM_PROMPTS="0", AUTO_RATE="20", AUTO_DURATION="1.0",
                     INFERENCE_METHOD="target_ar", TARGET_MODEL="synthetic:tiny",
                     DRAFTER_MODEL="layerskip:2",
                     OUTPUT_FILE=str(bench_env / "open.json")).items():
        monkeypatch.setenv(k, v)
    t0 = time.time()
    runner = BenchmarkRunner(device="cpu")
    res = runner.target_results
    assert res.total_requests >= 1 and res.total_batches == res.total_requests
    assert time.time() - t0 < 30
    assert (bench_env / "open_target.json").exists()


def test_request_generator_per_request(bench_env, monkeypatch):
    """Each request index seeds its own generator; the same index gives the
    same draws, and the prompt choice follows Python's random seeded with
    BENCH_SEED + index, as the JAX runner's."""
    from specdec_tpu_torch.engine.benchmark_runner import BenchmarkRunner

    monkeypatch.setenv("NUM_PROMPTS", "0")
    monkeypatch.setenv("AUTO_RATE", "0")  # invalid: loads, runs nothing
    monkeypatch.setenv("TARGET_MODEL", "synthetic:tiny")
    monkeypatch.setenv("DRAFTER_MODEL", "layerskip:2")
    monkeypatch.setenv("INFERENCE_METHOD", "target_ar")
    r = BenchmarkRunner(device="cpu")
    draws = []
    for idx in (1, 2, 1):
        r.set_request_index(idx)
        draws.append(torch.rand(4, generator=r.request_generator()))
        draws[-1] = (draws[-1], r._get_random_prompt())
    assert torch.equal(draws[0][0], draws[2][0])
    assert not torch.equal(draws[0][0], draws[1][0])
    random.seed(42 + 1)
    parts = [p for p in r.sharegpt_parts if p]
    assert draws[0][1] == random.choice(random.choice(parts))


def test_dataset_matches_jax(tmp_path):
    """load_sharegpt_prompts / _multi (missing files give empty lists) and
    random_prompt with a seeded Random choose what JAX's do."""
    path = tmp_path / "sg.jsonl"
    rows = [{"conversations": [{"from": "human", "value": "x" * n}]}
            for n in (5, 10, 50, 600)] + [{"other": 1}]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\nbad\n")
    paths = [str(path), str(tmp_path / "missing.jsonl")]
    ours = tds.load_sharegpt_multi(paths, max_lines=4)
    assert ours == jds.load_sharegpt_multi(paths, max_lines=4)
    assert [len(p) for p in ours] == [2, 0]
    assert tds.load_sharegpt_prompts(str(path), max_len=600) == \
        jds.load_sharegpt_prompts(str(path), max_len=600)
    picks = [tds.random_prompt(ours, random.Random(s)) for s in range(6)]
    assert picks == [jds.random_prompt(ours, random.Random(s))
                     for s in range(6)]
    assert tds.random_prompt([[], []]) == jds.FALLBACK_PROMPT


# ---------------------------------------------------------------------------
# telemetry (tests/test_harness.py's cases, and NVML)
# ---------------------------------------------------------------------------

def test_trapezoidal_energy_hand_case():
    r = tmon.MonitorResults()
    r.snapshots = [tmon.PowerSnapshot(0.0, 100.0),
                   tmon.PowerSnapshot(1.0, 200.0),
                   tmon.PowerSnapshot(3.0, 100.0)]
    # (100+200)/2*1 + (200+100)/2*2 = 150 + 300 = 450 J
    assert abs(r.energy_joules - 450.0) < 1e-9
    r.total_tokens = 900
    assert abs(r.tokens_per_joule - 2.0) < 1e-9
    assert abs(r.energy_wh - 450.0 / 3600) < 1e-12


def test_monitor_thread_collects_and_stop_returns_results():
    calls = []

    class FakeSampler:
        source = "fake"
        num_chips = 1

        def sample(self):
            calls.append(1)
            return tmon.PowerSnapshot(len(calls) * 0.1, 50.0)

    mon = tmon.TelemetryMonitor(
        sampler=FakeSampler(), interval_s=0.02,
        perf_callback=lambda: {"total_tokens": 123, "accepted_tokens": 45})
    mon.start()
    time.sleep(0.15)
    results = mon.stop()
    assert results is not None
    assert len(results.snapshots) >= 2
    assert results.total_tokens == 123
    assert results.accepted_tokens == 45
    assert results.power_source == "fake"


def test_monitor_results_memory_fields_and_schema():
    """The memory fields serialize, and to_dict has JAX's keys."""
    from specdec_tpu.engine.monitor import MonitorResults

    r = tmon.MonitorResults()
    r.snapshots = [tmon.PowerSnapshot(0.0, 100.0, memory_pct=40.0),
                   tmon.PowerSnapshot(1.0, 100.0, memory_pct=60.0)]
    assert abs(r.avg_memory_pct - 50.0) < 1e-9
    assert abs(r.peak_memory_pct - 60.0) < 1e-9
    d = r.to_dict()
    assert d["avg_memory_pct"] == r.avg_memory_pct
    assert d["peak_memory_pct"] == r.peak_memory_pct
    assert list(d) == list(MonitorResults().to_dict())


class FakeNvml:
    """The NVML entry points the sampler calls, writing through the
    pointers it passes (powers in mW)."""

    def __init__(self, power_mw=(250_000, 150_000), rc=0):
        self.power_mw, self.rc, self.inits = power_mw, rc, 0

    def nvmlInit_v2(self):
        self.inits += 1
        return self.rc

    def nvmlDeviceGetCount_v2(self, n):
        n._obj.value = len(self.power_mw)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, h):
        h._obj.value = 0x100 + i.value
        return 0

    def _card(self, h):
        return (h.value - 0x100) if isinstance(h, ctypes.c_void_p) else 0

    def nvmlDeviceGetPowerUsage(self, h, v):
        v._obj.value = self.power_mw[self._card(h)]
        return 0

    def nvmlDeviceGetEnforcedPowerLimit(self, h, v):
        v._obj.value = 700_000
        return 0

    def nvmlDeviceGetUtilizationRates(self, h, u):
        u._obj.gpu, u._obj.memory = 30 + 40 * self._card(h), 5
        return 0

    def nvmlDeviceGetMemoryInfo(self, h, m):
        m._obj.total, m._obj.used = 80 << 30, (20 + 20 * self._card(h)) << 30
        m._obj.free = m._obj.total - m._obj.used
        return 0

    def nvmlDeviceGetTemperature(self, h, sensor, v):
        assert sensor.value == 0
        v._obj.value = 41 + self._card(h)
        return 0


def test_nvml_sampler_reads_every_field():
    """Power summed over the cards (mW to W), utilization averaged, memory
    and temperature the largest; the limit summed; source "nvml"."""
    s = tmon.NvmlSampler(indices=[0, 1], lib=FakeNvml())
    snap = s.sample()
    assert s.source == "nvml" and s.num_chips == 2
    assert s.power_limit_w == 1400.0
    assert snap.power_w == 400.0
    assert snap.utilization_pct == 50.0
    assert snap.memory_pct == 50.0 and snap.temperature_c == 42.0
    mon = tmon.TelemetryMonitor(sampler=s, interval_s=0.01)
    mon.start()
    time.sleep(0.05)
    d = mon.stop().to_dict()
    assert d["power_source"] == "nvml" and d["num_chips"] == 2
    assert d["avg_power_w"] == d["peak_power_w"] == 400.0


def test_nvml_absent_gives_labeled_estimate():
    """Without NVML (as here) default_sampler is the TDP estimate, labeled
    so; a failing NVML call raises OSError at construction."""
    with pytest.raises(OSError):
        tmon.NvmlSampler(lib=FakeNvml(rc=9))
    s = tmon.default_sampler()
    assert s.source == "estimated_tdp"
    assert s.sample().power_w == tmon._DEFAULT_TDP * s.num_chips
    h100 = tmon.DeviceKindTdpSampler(num_cards=1,
                                     device_kind="NVIDIA H100 80GB HBM3")
    assert h100.watts == 700.0


# ---------------------------------------------------------------------------
# the vLLM-tier facade and the server benchmark
# ---------------------------------------------------------------------------

def test_vllm_compat_config_from_env(monkeypatch):
    from specdec_tpu.engine import vllm_compat as jv
    from specdec_tpu_torch.engine import vllm_compat as tv

    for k, v in dict(TARGET_MODEL="synthetic:tiny", DRAFTER_MODEL="layerskip:2",
                     VLLM_TENSOR_PARALLEL_SIZE="4", VLLM_MAX_MODEL_LEN="2048",
                     VLLM_DTYPE="half", VLLM_ENABLE_SPECULATIVE="true",
                     VLLM_NUM_SPECULATIVE_TOKENS="7",
                     VLLM_MAX_NUM_BATCHED_TOKENS="64",
                     VLLM_QUANTIZATION="int4").items():
        monkeypatch.setenv(k, v)
    cfg = tv.create_vllm_config_from_env()
    assert isinstance(cfg, tv.VLLMConfig)
    assert cfg.tensor_parallel_size == 4
    assert cfg.max_model_len == 2048
    assert cfg.dtype == "bfloat16"
    assert cfg.speculative_config["num_speculative_tokens"] == 7
    assert vars(cfg) == vars(jv.create_vllm_config_from_env())
    assert tv.is_vllm_available()


@pytest.fixture
def tiny_manager():
    from specdec_tpu_torch.engine.vllm_compat import (
        VLLMConfig, VLLMEngineManager,
    )

    def make(**kw):
        spec = kw.pop("spec", "synthetic:tiny")
        # admission prefills min(max_model_len, 2048) rows: kept short
        cfg = VLLMConfig(model="synthetic:tiny", dtype="float32",
                         max_model_len=32,
                         speculative_config={"model": spec,
                                             "num_speculative_tokens": 3},
                         **kw)
        return VLLMEngineManager(cfg, device="cpu")
    return make


def test_vllm_compat_manager_generates(tiny_manager):
    from specdec_tpu_torch.serve import PagedContinuousBatcher

    mgr = tiny_manager()
    assert mgr.initialize(num_slots=2)
    assert isinstance(mgr.batcher, PagedContinuousBatcher)
    out = mgr.generate("hello", max_tokens=6)
    assert isinstance(out, str)
    outs = mgr.generate_batch(["a", "bb"], max_tokens=5)
    assert len(outs) == 2


@pytest.mark.parametrize("engine", ["slotted", "prefix", "kv_int8"])
def test_vllm_compat_engines(tiny_manager, monkeypatch, engine):
    """SPECDEC_SERVE_ENGINE=slotted, prefix caching (the paged engine with
    its block cache) and KV_QUANT=int8 (int8 pools)."""
    from specdec_tpu_torch.serve import (
        ContinuousBatcher, PagedContinuousBatcher,
    )

    kw = {}
    if engine == "slotted":
        monkeypatch.setenv("SPECDEC_SERVE_ENGINE", "slotted")
    elif engine == "prefix":
        kw = dict(enable_prefix_caching=True)
    else:
        monkeypatch.setenv("KV_QUANT", "int8")
    mgr = tiny_manager(spec="layerskip:2", **kw)
    assert mgr.initialize(num_slots=2, max_new_tokens=4)
    b = mgr.batcher
    if engine == "slotted":
        assert type(b) is ContinuousBatcher
    else:
        assert isinstance(b, PagedContinuousBatcher)
        assert b.prefix_caching == (engine == "prefix")
        assert b.target_cfg.kv_quant == ("int8" if engine == "kv_int8"
                                         else "none")
    assert b.drafter_cfg.num_layers == 2
    assert len(mgr.generate_batch(["ab", "cd", "ef"], max_tokens=4)) == 3


def test_vllm_compat_pp_folds_or_warns(tiny_manager):
    """pipeline_parallel_size > 1 is not dropped silently: with one device
    the stages cannot fold into TP, so the manager warns and serves."""
    mgr = tiny_manager(pipeline_parallel_size=2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert mgr.initialize(num_slots=2)
    assert any("pipeline_parallel_size" in str(x.message) for x in w)


def test_vllm_compat_initialize_honors_max_tokens(tiny_manager, monkeypatch):
    mgr = tiny_manager()
    assert mgr.initialize(num_slots=2, max_new_tokens=37)
    assert mgr.batcher.default_max_new == 37
    monkeypatch.setenv("MAX_TOKENS", "19")
    mgr2 = tiny_manager()
    assert mgr2.initialize(num_slots=2)
    assert mgr2.batcher.default_max_new == 19


def test_vllm_compat_eagle_drafter(tiny_manager):
    from specdec_tpu_torch.serve import EagleContinuousBatcher

    mgr = tiny_manager(spec="eagle:1")
    mgr.initialize(num_slots=1, max_new_tokens=8)
    assert isinstance(mgr.batcher, EagleContinuousBatcher)
    out = mgr.generate("hello", max_tokens=8)
    assert isinstance(out, str) and len(out) > 0


@pytest.mark.parametrize("kind", ["slotted", "paged", "nasd", "eagle"])
def test_server_benchmark_over_each_batcher(kind):
    """Open-loop arrivals into every batcher: every request completes with
    its greedy AR tokens (self-draft, NASD and EAGLE at greedy; the
    untrained EAGLE head at temperature 1e-4 so its softmaxes saturate),
    one BatchMetrics each."""
    from specdec_tpu_torch.sampling.processors import GreedyProcessor
    from specdec_tpu_torch.serve import (
        ContinuousBatcher, EagleContinuousBatcher, NasdContinuousBatcher,
        PagedContinuousBatcher,
    )

    b = load_models("synthetic:tiny", "eagle:1" if kind == "eagle" else None,
                    dtype=torch.float32, device="cpu")
    cfg, params = b["target"]["cfg"], b["target"]["params"]
    kw = dict(num_slots=2, gamma=3, max_prompt_len=16, max_new_tokens=6,
              eos_tokens_id=(), device="cpu")
    if kind == "slotted":
        batcher = ContinuousBatcher(cfg, params, cfg, params, **kw)
    elif kind == "paged":
        batcher = PagedContinuousBatcher(cfg, params, cfg, params, **kw)
    elif kind == "nasd":
        batcher = NasdContinuousBatcher(cfg, params, n=3, **kw)
    else:
        batcher = EagleContinuousBatcher(
            b["drafter"]["cfg"], b["drafter"]["params"], cfg, params,
            logits_processor=GreedyProcessor(temperature=1e-4), **kw)
    prompts = [[5, 9, 33, 2, 41], [7, 7, 8], [100, 3, 12, 9], [4]]
    res = run_server_benchmark(batcher, prompts, rate=200.0,
                               method_name=kind)
    assert res.total_requests == res.total_batches == 4
    assert res.method == kind and res.total_tokens == 24
    for rid, p in enumerate(prompts):
        assert batcher.completed[rid].output_ids == autoregressive_generate(
            p, cfg, params, max_gen_len=6, eos_tokens_id=(), device="cpu")


def test_server_benchmark_duration_cuts_arrivals():
    b = load_models("synthetic:tiny", None, dtype=torch.float32,
                    device="cpu")
    cfg, params = b["target"]["cfg"], b["target"]["params"]
    from specdec_tpu_torch.serve import ContinuousBatcher
    batcher = ContinuousBatcher(cfg, params, cfg, params, num_slots=2,
                                gamma=2, max_prompt_len=8, max_new_tokens=2,
                                device="cpu")
    res = run_server_benchmark(batcher, [[1, 2]] * 50, rate=1.0,
                               duration=0.5)
    assert 1 <= res.total_requests < 50


# ---------------------------------------------------------------------------
# printing, profiling and the CLI
# ---------------------------------------------------------------------------

def test_printing_matches_jax(capsys):
    from specdec_tpu_torch.engine.model_loader import SyntheticTokenizer

    tok = SyntheticTokenizer(300)
    drafts = tok.encode("abcd")[1:]
    printed = []
    for mod in (tprint, jprint):
        mod.initial_step(70, tok)
        mod.end_token_found(3)
        mod.speculative_step(tok, drafts, 2, 72)
        mod.speculative_step(None, drafts, 4, None)
        mod.beam_search_step([-1.5, -2.25], [drafts, drafts[:2]], 3, tok)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "beam step 3" in printed[0]


def test_profiling_helpers(tmp_path):
    phases = {}
    with tprof.phase_timer(phases, "draft"):
        time.sleep(0.01)
    with tprof.phase_timer(phases, "draft"):
        pass
    assert phases["draft"] >= 0.01
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        with tprof.annotate("verify"):
            torch.ones(8) @ torch.ones(8)
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "verify" for e in trace["traceEvents"])


def test_cli_raises_without_cuda(bench_env):
    """The entry point runs on the card only: without CUDA it raises and
    never falls back to the CPU."""
    from specdec_tpu_torch.cli import benchmark

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main(["--target-model", "synthetic:tiny"])
    assert not list(bench_env.glob("*.json"))
