#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``specdec_tpu_torch``) on one NVIDIA
GPU, an H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 switched off
   for float32 matmuls and convolutions;
2. build: nvcc builds the port's kernel from ``specdec_tpu_torch/ops/csrc``
   into ``build/kernels/`` (git-ignored);
3. kernel vs plain: the INT4 pair4 dequant-matmul kernel against its plain
   PyTorch version at every shape the main path gives it, on the main
   path's own weights; its time beside the plain version's, a bf16
   ``torch.matmul`` on pre-dequantized weights (a yardstick the port never
   calls) and the bound; and a check that a row's result does not depend on
   how many rows share the call;
4. greedy oracle: greedy self-draft speculative decoding equals greedy AR
   on the card (full widths, 2 layers, float32 activations, kernel on every
   projection);
5. main path: ``specdec_tpu_torch.bench``'s 22-layer INT4 LayerSkip pair,
   AR and speculative decoding (gamma 12, 256 tokens), with the kernel's
   launch counts checked against what the configuration implies.

Any failed phase exits 1 (without a CUDA device, or outside a checkout,
too, before any result is printed). Standard output ends with the card's
name and power limit, a JSON line of the main path's numbers, a JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# main-path shapes of the INT4 kernel: (name, K, N) of each layer projection
# of the 22-layer target (the drafter reads layers 0..3 of the same stacks),
# the 2D lm_head, and the row counts M the decode loops give it
STACKED = [("wqkv", 2048, 2560), ("wo", 2048, 2048),
           ("w_gateup", 2048, 11264), ("w_down", 5632, 2048)]
LM_HEAD = ("lm_head", 2048, 32000)
ROWS = (1, 2, 13, 64)   # AR/draft step, drafter catch-up, verify, prefill
# kernel vs plain: relative Frobenius error and elementwise tolerance (the
# JAX package's kernel-vs-oracle tolerance, tests/test_quant.py); both
# sides round x and y to bf16 and differ only in f32 summation order
REL_FRO_TOL = 1e-2
RTOL, ATOL = 2e-2, 2e-1
TIMED_RUNS = 25
SLEEP_CYCLES = 50_000_000   # keeps the card busy while the runs enqueue


def say(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_ms(fn, flush):
    """Median device time of ``fn`` in ms over TIMED_RUNS runs, each timed
    by its own CUDA events with L2 flushed before it (the main path reads
    every weight once per forward, from device memory). The flush READS a
    buffer five times the L2's size, so it leaves clean lines and no
    write-back lands inside the timed run. The runs are queued behind a
    sleep kernel, so host launch overhead is not counted."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(TIMED_RUNS)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in ev:
        flush.amax()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(M, K, N):
    """Least time for one call: words K/8*N*4 + absmax K/64*N*2 + x M*K*2
    + y M*N*2 bytes at HBM_BYTES_PER_S, or 2*M*K*N operations at the bf16
    rate, whichever is longer. Returns (ms, "bytes" | "operations")."""
    t_bytes = (K // 8 * N * 4 + K // 64 * N * 2 + M * K * 2 + M * N * 2
               ) / HBM_BYTES_PER_S
    t_ops = 2 * M * K * N / BF16_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[1 device] {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for "
        "float32 matmuls (torch.backends.cuda.matmul.allow_tf32=False) and "
        "convolutions (torch.backends.cudnn.allow_tf32=False)")
    return card


def phase_build():
    from specdec_tpu_torch.ops import _build
    t0 = time.perf_counter()
    log = _build.build()
    say(f"[2 build] nvcc built {sorted(log)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rec in log.items():
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")


def phase_kernel(target, device):
    """Kernel vs plain at every main-path shape. Returns the per-shape
    records and the largest absolute error."""
    from specdec_tpu_torch.ops import quant_matmul as qm
    from specdec_tpu_torch.quant.core import Int4Weight, dequantize

    gen = torch.Generator(device=device).manual_seed(1234)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=device)
    records, max_err = [], 0.0
    cases = [(name, K, N, layer) for name, K, N in STACKED
             for layer in (0, 21)] + [LM_HEAD + (None,)]
    for name, K, N, layer in cases:
        if layer is None:
            w = target["lm_head"]
            packed, absmax = w.packed, w.absmax

            def kern(x, w=w):
                return qm.quant_matmul(x, w)
        else:
            w = target["layers"][name]
            packed, absmax = w.packed[layer], w.absmax[layer]

            def kern(x, w=w, layer=layer):
                return qm.quant_matmul_stacked(x, w, layer)
        if tuple(packed.shape) != (K // 8, N):
            fail(f"{name}: words {tuple(packed.shape)}, expected "
                 f"{(K // 8, N)}")
        x_all = torch.randn((max(ROWS), K), generator=gen, device=device
                            ).to(torch.bfloat16)
        ys = {M: kern(x_all[:M]) for M in ROWS}
        torch.cuda.synchronize()
        for M in ROWS:
            # a row's result must not depend on how many rows share the call
            if not torch.equal(ys[M], ys[max(ROWS)][:M]):
                fail(f"{name} layer {layer}: rows of the M={M} call differ "
                     f"from the same rows of the M={max(ROWS)} call")
        w_bf16 = dequantize(Int4Weight(packed=packed, absmax=absmax),
                            torch.bfloat16)
        for M in ROWS:
            x = x_all[:M]
            plain = qm.int4_matmul_reference(x, packed, absmax).float()
            got = ys[M].float()
            err = (got - plain).abs().max().item()
            rel = ((got - plain).norm() / plain.norm()).item()
            if not (rel <= REL_FRO_TOL and torch.allclose(
                    got, plain, rtol=RTOL, atol=ATOL)):
                fail(f"{name} layer {layer} M={M}: kernel vs plain max abs "
                     f"err {err:.3g}, relative Frobenius {rel:.3g}")
            max_err = max(max_err, err)
            rec = {"name": name, "layer": layer, "M": M, "K": K, "N": N,
                   "max_abs_err": err, "rel_fro_err": rel}
            if layer in (0, None):
                b, by = bound_ms(M, K, N)
                rec.update(
                    ms=gpu_ms(lambda: kern(x), flush),
                    plain_ms=gpu_ms(
                        lambda: qm.int4_matmul_reference(x, packed, absmax),
                        flush),
                    library_ms=gpu_ms(lambda: torch.matmul(x, w_bf16), flush),
                    bound_ms=b, bound_by=by)
                say(f"[3 kernel] {name:8s} M={M:2d} K={K} N={N}: kernel "
                    f"{rec['ms'] * 1e3:8.1f} us, plain "
                    f"{rec['plain_ms'] * 1e3:8.1f} us, torch.matmul bf16 "
                    f"{rec['library_ms'] * 1e3:7.1f} us, bound "
                    f"{b * 1e3:6.1f} us ({by}); max abs err {err:.3g}, "
                    f"rel {rel:.2g}")
            records.append(rec)
    say(f"[3 kernel] all {len(records)} comparisons within relative "
        f"Frobenius {REL_FRO_TOL} and rtol {RTOL}, atol {ATOL}; "
        f"row-independent at M in {ROWS}")
    return records, max_err


def phase_oracle(device):
    """Greedy self-draft speculative == greedy AR, on the kernel."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.model import forward_full, init_params
    from specdec_tpu_torch.quant.core import quantize_params
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )
    from specdec_tpu_torch.sampling.speculative import speculative_generate

    cfg = bench.target_config(num_layers=2, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(1)
    params = quantize_params(
        init_params(cfg, scale=0.02, device=device, generator=gen),
        kind="int4", fuse=True)
    prompt = bench.bench_prompt(seed=1)
    ar = autoregressive_generate(prompt, cfg, params, max_gen_len=64,
                                 eos_tokens_id=(), device=device)
    spec, rate = speculative_generate(prompt, cfg, params, cfg, params,
                                      gamma=bench.GAMMA, max_gen_len=64,
                                      eos_tokens_id=(), device=device)
    if len(ar) != 64 or len(spec) != 64:
        fail(f"oracle: {len(ar)} AR and {len(spec)} spec tokens, not 64")
    if spec == ar:
        if rate != 1.0:
            fail(f"oracle: tokens equal but acceptance {rate}")
        say(f"[4 oracle] greedy self-draft spec == greedy AR over 64 tokens "
            f"(2 layers, float32 activations), acceptance {rate}")
        return
    i = next(j for j, (a, b) in enumerate(zip(ar, spec)) if a != b)
    toks = torch.tensor([prompt + ar[:i]], device=device)
    top2 = forward_full(cfg, params, toks)[0, -1].topk(2).values.tolist()
    gap = top2[0] - top2[1]
    ulp = 2.0 ** (math.floor(math.log2(abs(top2[0]))) - 7)
    if i < 16 or gap > ulp:
        fail(f"oracle: spec diverges from AR at token {i} where the "
             f"target's top-2 logit gap {gap:.3g} exceeds one bf16 ulp "
             f"({ulp:.3g}), or before token 16")
    say(f"[4 oracle] spec == AR for the first {i} tokens; token {i} is a "
        f"tie within one bf16 ulp (top-2 gap {gap:.3g} <= {ulp:.3g}); "
        f"acceptance {rate:.4f}")


def phase_main(pair, device):
    """The main path with launch counts. Returns its summary."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.ops import quant_matmul as qm
    from specdec_tpu_torch.sampling.processors import MultinomialProcessor

    t_cfg, d_cfg, target, drafter = pair
    proc = MultinomialProcessor(temperature=1.0)
    prompt = bench.bench_prompt()
    per_fwd = {"stacked": 4 * t_cfg.num_layers, "2d": 1}
    per_draft = {"stacked": 4 * d_cfg.num_layers, "2d": 1}

    def counts():
        return {"stacked": qm.quant_matmul_stacked.launches,
                "2d": qm.quant_matmul.launches}

    qm.quant_matmul_stacked.launches = 0
    qm.quant_matmul.launches = 0
    gen, gamma = bench.GEN, bench.GAMMA
    ar = bench.measure_ar(t_cfg, target, prompt, gen, proc, device)
    ar_counts = counts()
    spec = bench.measure_spec(d_cfg, drafter, t_cfg, target, prompt, gen,
                              gamma, proc, device)
    total = counts()

    for run in ar["runs"] + spec["runs"]:
        if run["tokens"] != gen or not all(0 <= t < bench.V
                                           for t in run["ids"]):
            fail(f"main path: {run['tokens']} tokens (expected {gen}) or a "
                 "token outside the vocabulary")
    for run in spec["runs"]:
        if not 0.0 < run["acceptance"] <= 1.0:
            fail(f"main path: acceptance {run['acceptance']}")
    ar_tokens = sum(r["tokens"] for r in ar["runs"])
    windows = sum(r["windows"] for r in spec["runs"])
    n_spec = len(spec["runs"])
    for kind in ("stacked", "2d"):
        # AR: the prefill yields token 1, one forward for each later token
        want_ar = per_fwd[kind] * ar_tokens
        # spec: target and drafter prefill, then per window gamma drafter
        # forwards and one target verify
        want_spec = (n_spec * (per_fwd[kind] + per_draft[kind])
                     + windows * (gamma * per_draft[kind] + per_fwd[kind]))
        if ar_counts[kind] != want_ar:
            fail(f"main path: {ar_counts[kind]} {kind} launches in AR, "
                 f"expected {want_ar}")
        if total[kind] - ar_counts[kind] != want_spec:
            fail(f"main path: {total[kind] - ar_counts[kind]} {kind} "
                 f"launches in spec, expected {want_spec}")
    per_token = per_fwd["stacked"] + per_fwd["2d"]
    per_window = gamma * (per_draft["stacked"] + 1) + per_token
    best_ar = min(ar["runs"][1:], key=lambda r: r["seconds"])
    best_spec = min(spec["runs"][1:], key=lambda r: r["seconds"])
    summary = {
        "ar_tok_s": ar["tok_s"], "spec_tok_s": spec["tok_s"],
        "speedup": spec["tok_s"] / ar["tok_s"],
        "acceptance": spec["acceptance"],
        "ar_ms_per_token": best_ar["seconds"] / best_ar["tokens"] * 1e3,
        "spec_ms_per_window": best_spec["seconds"] / best_spec["windows"]
        * 1e3,
        "spec_windows": [r["windows"] for r in spec["runs"]],
        "ar_seconds": [r["seconds"] for r in ar["runs"]],
        "spec_seconds": [r["seconds"] for r in spec["runs"]],
        "launches": {"per_ar_token": per_token,
                     "per_spec_window": per_window,
                     "stacked": total["stacked"], "2d": total["2d"]},
        "gamma": gamma, "gen": gen, "reps": bench.REPS,
        "device": torch.cuda.get_device_name(0)}
    say(f"[5 main] AR {summary['ar_tok_s']:.1f} tok/s, spec "
        f"{summary['spec_tok_s']:.1f} tok/s ({summary['speedup']:.3f}x), "
        f"acceptance {summary['acceptance']:.3f}; launches as implied: "
        f"{per_token} per AR token, {per_window} per window")
    return summary, total


def phase_profile(pair, summary, device):
    """Device time per AR step and per speculative window, from
    torch.profiler's CUDA activity, against the wall times of phase 5: the
    share of wall time the card is busy, and the kernels that take it.
    Differential: a short and a long call of each, so the prefill cancels
    (same seed, so the short call is a prefix of the long one)."""
    from torch.profiler import ProfilerActivity, profile

    from specdec_tpu_torch import bench
    from specdec_tpu_torch.sampling.processors import MultinomialProcessor

    t_cfg, d_cfg, target, drafter = pair
    proc = MultinomialProcessor(temperature=1.0)
    prompt = bench.bench_prompt()

    def ar(gen):
        rec = bench.run_ar(t_cfg, target, prompt, gen, proc, 7, device)
        return rec, rec["tokens"]

    def spec(gen):
        rec = bench.run_spec(d_cfg, drafter, t_cfg, target, prompt, gen,
                             bench.GAMMA, proc, 7, device)
        return rec, rec["windows"]

    def device_us(run, gen):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, steps = run(gen)
            torch.cuda.synchronize()
        return steps, {e.key: e.self_device_time_total
                       for e in prof.key_averages()}

    out = {}
    for label, run, gens, wall in (
            ("ar", ar, (9, 41), summary["ar_ms_per_token"]),
            ("spec", spec, (64, 192), summary["spec_ms_per_window"])):
        run(gens[0])
        (s0, t0), (s1, t1) = (device_us(run, g) for g in gens)
        diff = sorted(((k, (t1[k] - t0.get(k, 0.0)) / 1e3 / (s1 - s0))
                       for k in t1), key=lambda kv: -kv[1])
        per_step = sum(t for _, t in diff)
        if per_step <= 0:
            say(f"[5 profile] {label}: device time not measured (the "
                "profiler recorded no CUDA activity)")
            out[label] = None
            continue
        out[label] = {"device_ms_per_step": per_step,
                      "wall_ms_per_step": wall,
                      "busy_share": per_step / wall, "top": diff[:6]}
        say(f"[5 profile] {label}: device {per_step:.3f} ms per "
            f"{'token' if label == 'ar' else 'window'} of {wall:.3f} ms "
            f"wall (busy {per_step / wall:.1%}); top: " + "; ".join(
                f"{k[:48]} {t:.3f} ms" for k, t in diff[:4]))
    return out


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "specdec_tpu_torch")):
        fail(f"no specdec_tpu_torch package beside {__file__}: run from the "
             "root of a checkout")
    sys.path.insert(0, root)
    from specdec_tpu_torch import bench

    t0 = time.perf_counter()
    card = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    t1 = time.perf_counter()
    pair = bench.build_pair(device)
    torch.cuda.synchronize()
    say(f"[5 main] built the INT4 LayerSkip pair in "
        f"{time.perf_counter() - t1:.1f} s")
    records, max_err = phase_kernel(pair[2], device)
    phase_oracle(device)
    summary, launches = phase_main(pair, device)
    summary["profile"] = phase_profile(pair, summary, device)

    def total(key, rows):
        return sum(r[key] for r in rows)

    # one entry per replaced TPU kernel; the top-level times are the work
    # of one decode step (M=1): a layer's four projections, or the lm_head
    entries = []
    for is_2d, name, line in ((False, "int4_pair_matmul (stacked layer)", 219),
                              (True, "int4_pair_matmul (2D lm_head)", 196)):
        mine = [r for r in records if (r["layer"] is None) == is_2d]
        timed = [r for r in mine if "ms" in r]
        step = [r for r in timed if r["M"] == 1]
        entries.append({
            "name": name, "route": "cuda",
            "source": "specdec_tpu_torch/ops/csrc/int4_pair_matmul.cu",
            "replaces": f"specdec_tpu/ops/quant_matmul.py:{line}",
            "launches": launches["2d" if is_2d else "stacked"],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms", step), "plain_ms": total("plain_ms", step),
            "bound_ms": total("bound_ms", step), "bound_by": "bytes",
            "library_ms": total("library_ms", step),
            "work": "M=1: " + ", ".join(f"{r['name']} {r['K']}x{r['N']}"
                                        for r in step),
            "shapes": timed})
    say(f"[6 done] all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"largest kernel-vs-plain abs error {max_err:.3g}")
    say(card)
    say(json.dumps(summary))
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
