"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration
(``configs/<name>.json``), its traffic mix (``traffic/<name>.json``) and
its metrics (``metrics/<name>.py``, each a ``read(run)``) are found by the
names in ``BENCHMARK.json``, and the configuration's model family
(``families/<model_type>.py``) by its ``model_type``. ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics, read from the program's own spans and records and a device
trace of the window's last seconds (``program_trace.py``). Fails,
printing no result, without a CUDA card (or with fewer than the cell asks
for), without the program, or when JAX or the JAX package is loaded once
the window has closed.
"""
import time

T_PROC0 = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "specdec_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix and
    metric entries, read from the files the names point to."""

    def __init__(self, root: Path, workload: str):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        wl = {w["name"]: w for w in spec["workloads"]}
        if workload not in wl:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.root, self.name, self.entry = root, workload, wl[workload]
        conf = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config = json.loads((root / conf["file"]).read_text())
        # the family file (``weights.family``) is found under this root too
        self.config["family_dir"] = str(root / "portbench" / "families")
        self.mix = json.loads((root / "portbench" / "traffic" /
                               f"{self.entry['traffic']}.json").read_text())
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in spec["end_to_end"] if self._mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._mine(m)]

    def _mine(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def reader(self, name: str):
        path = self.root / "portbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def report(run, metrics_entries, cell) -> dict:
    out = {}
    for m in metrics_entries:
        v = cell.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def summary(run) -> None:
    """Request counts and the generator's lateness, on standard error."""
    qs = list(run.reqs.values())
    late = [(q.submit if q.submit is not None else run.t_end) - q.due
            for q in qs if run.in_window(q.due)]
    log(f"[window] {run.window_s:.3f} s, {run.steps} steps; requests: "
        f"recorded {len(qs)}, due in window {len(late)}, admitted in window "
        f"{sum(run.in_window(q.admit) for q in qs)}, finished in window "
        f"{sum(run.in_window(q.end) for q in qs)}, live at close "
        f"{sum(q.first is not None and q.end is None for q in qs)}, waiting "
        f"at close {sum(q.admit is None for q in qs)} (unsent "
        f"{sum(q.submit is None for q in qs)}); preemptions "
        f"{run.preemptions}")
    done = [q for q in qs if run.in_window(q.end)]
    drafted = sum(q.drafted for q in done)
    log(f"[requests] finished in window: {len(done)}, output tokens "
        f"{sum(q.generated for q in done)}, acceptance "
        f"{sum(q.accepted for q in done) / max(drafted, 1):.4f}; due in "
        f"window asked for {sum(q.asked for q in qs if run.in_window(q.due))}"
        " output tokens")
    m = run.model
    log(f"[memory] window peak {run.memory_peak_bytes} B allocated; target "
        f"K/V live at close {run.kv_tokens} positions, "
        f"{run.kv_tokens * 4 * m['L'] * m['Hk'] * m['Dh']} B in bf16")
    if late:
        log(f"[generator] late by mean {sum(late) / len(late) * 1e3:.3f} ms, "
            f"max {max(late) * 1e3:.3f} ms over {len(late)} requests")


def main(argv=None, root=None, device=None, t_proc0=T_PROC0) -> int:
    """Run the cell; returns the exit code. ``device`` None means the
    card; tests pass "cpu" to rehearse on the plain paths."""
    args = parse(argv)
    root = Path(root or os.getcwd())
    if device is None:
        build = root / "build" / "portbench"
        os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
        os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
        os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    import torch

    if device is None and not torch.cuda.is_available():
        log("portbench: no CUDA device; the benchmark runs on the card only")
        return 2
    cell = Cell(root, args.workload)
    if device is None:
        if torch.cuda.device_count() < cell.chips:
            log(f"portbench: {cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} present")
            return 2
        device = torch.device("cuda", 0)
        torch.set_num_threads(2)
        log(f"[card] {card_info()}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
    device = torch.device(device)

    from portbench import check
    from portbench.harness import Program, run_window
    from portbench.program_trace import Tracer, breakdown

    t_build = time.time()
    program = Program(cell.config, device)
    log(f"[setup] program built in {time.time() - t_build:.1f} s, "
        f"{t_build - t_proc0:.1f} s after the process started")
    tracer = Tracer(device) if args.trace else None
    run = run_window(program, cell.config, cell.mix, cell.name, args.seed,
                     args.seconds, t_proc0, tracer)
    summary(run)
    metrics = report(run, cell.per_layer if args.trace else cell.end_to_end,
                     cell)
    del program
    check.free_memory()
    t0 = time.time()
    reading = check.readings(run, run.traffic, device)
    checks = check.decide(run, reading, cell.config["check"]["max_logit_gap"])
    log(f"[check] {reading.get('sampled_requests')} requests, "
        f"{reading.get('sampled_tokens')} served tokens compared in "
        f"{time.time() - t0:.1f} s")

    bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if bad:
        log(f"portbench: forbidden modules loaded: {bad}")
        return 3
    stalled = len(check.stalled_ids(run))
    attempted = sum(1 for q in run.reqs.values()
                    if check.live_at_start(run, q) or run.in_window(q.due)
                    or run.in_window(q.admit))
    result = {
        "correct": check.passed(checks), "attempted": attempted,
        "failed": stalled, "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": int(run.memory_peak_bytes)},
    }
    if run.trace is not None:
        t = run.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = breakdown(t)
        log(f"[trace] the window's last {run.t_end - run.t_host:.3f} s; "
            f"busy {t.busy_s:.6f} of {t.window_s:.6f} s; int4_pair_matmul "
            f"launches {t.int4_kernels}; launches inside a step span "
            f"{t.launches_in_step} of {t.launches}, device time tied to a "
            f"span {t.device_in_span_s:.6f} of {t.device_s:.6f} s; "
            f"synchronising runtime calls "
            f"{sum(n for _, n in t.syncs_by_program_span)} against "
            f"{t.sync_spans} sync.* spans; device clock ahead by "
            f"{list(t.clock_offset_us)} us")
    result["checks"] = checks
    for name, c in checks.items():
        rule = (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
        log(f"{name} {c['value']} {rule}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
