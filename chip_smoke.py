#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``specdec_tpu_torch``) on one NVIDIA
GPU, an H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 switched off
   for float32 matmuls and convolutions;
2. build: nvcc builds the port's kernels from ``specdec_tpu_torch/ops/csrc``
   into ``build/kernels/`` (git-ignored), all sources at once;
3. kernel vs plain, INT4: the pair4 dequant-matmul kernel against its plain
   PyTorch version at every shape the main paths give it (M = 1, 2, 13, 64
   for single-sequence decoding; 8, 72, 256 for the serving engine's draft
   step, verify and admission prefill), on the main path's own weights;
   its time beside the plain version's, a bf16 ``torch.matmul`` on
   pre-dequantized weights (a yardstick the port never calls) and the
   bound; and a check that a row's result does not depend on how many rows
   share the call;
3b. kernel vs plain, paged attention: the paged decode-attention kernel,
   through both wrappers (a 4D pool, and a layer of stacked pools, which
   must agree bit for bit), against its plain version in float32 and bf16
   at the decode, verify, long-context and serving shapes; its time beside
   the plain version's, ``scaled_dot_product_attention`` over K/V gathered
   beforehand (a yardstick the port never calls) and the bound;
4. greedy oracle: greedy self-draft speculative decoding equals greedy AR
   on the card (full widths, 2 layers, float32 activations, kernel on every
   projection);
4b. serving oracle: the default serving engine (``PagedContinuousBatcher``,
   self-draft, greedy, more requests than slots) gives every request
   greedy AR's tokens with acceptance 1.0 (full widths, 2 layers, float32),
   also with prefix caching and chunked prefill on prompts that share a
   prefix;
5. main path, single sequence: ``specdec_tpu_torch.bench``'s 22-layer INT4
   LayerSkip pair, AR and speculative decoding (gamma 12, 256 tokens), with
   the kernel's launch counts checked against what the configuration
   implies, and a profile of the card's busy share;
6. main path, serving: ``bench.measure_serving`` on the same pair, the
   paged engine and the slotted one (16 requests x 128 tokens, 8 slots,
   gamma 8), with every page back in the pool, launch counts checked (the
   attention kernel once per target layer per paged forward) and a profile
   of the card's busy share.

Any failed phase exits 1 (without a CUDA device, or outside a checkout,
too, before any result is printed). Standard output ends with the card's
name and power limit, a JSON line of the main paths' numbers, a JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# main-path shapes of the INT4 kernel: (name, K, N) of each layer projection
# of the 22-layer target (the drafter reads layers 0..3 of the same stacks),
# the 2D lm_head, and the row counts M the decode loops give it
STACKED = [("wqkv", 2048, 2560), ("wo", 2048, 2048),
           ("w_gateup", 2048, 11264), ("w_down", 5632, 2048)]
LM_HEAD = ("lm_head", 2048, 32000)
# single sequence: AR/draft step, drafter catch-up, verify (gamma 12),
# prefill; serving (8 slots, gamma 8): draft step, verify, admission prefill
ROWS = (1, 2, 8, 13, 64, 72, 256)
# kernel vs plain: relative Frobenius error and elementwise tolerance (the
# JAX package's kernel-vs-oracle tolerance, tests/test_quant.py); both
# sides round x and y to bf16 and differ only in f32 summation order
REL_FRO_TOL = 1e-2
RTOL, ATOL = 2e-2, 2e-1
TIMED_RUNS = 25
SLEEP_CYCLES = 50_000_000   # keeps the card busy while the runs enqueue

# paged attention shapes (Hq=32, Hk=4, Dh=64, page 64, the pair's heads):
# (label, B, T, MP, offsets). decode/verify are tools/bench_paged.py's
# validation shapes; long reaches the config's 2048 positions; serve is the
# serving engine's verify (8 slots, gamma 8) at its table width of 9 pages
PAGED_HEADS = (32, 4, 64, 64)
SERVE_TABLE_PAGES = 9
PAGED_SHAPES = [
    ("decode", 8, 1, 8, [40, 100, 511, 7, 250, 64, 63, 300]),
    ("verify", 4, 9, 8, [40, 100, 350, 7]),
    ("long", 8, 9, 32, [2000, 1500, 1023, 64, 7, 1800, 2030, 511]),
    ("serve", 8, 9, SERVE_TABLE_PAGES,
     [60, 150, 230, 320, 90, 200, 280, 330]),
]
# kernel vs plain: float32 sides differ in summation order only (online
# vs dense softmax); bf16 adds the rounding of the probabilities before
# P.V and of the output, one bf16 ulp (2**-7 at |out| in [1, 2))
PAGED_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}


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


def paged_bound_ms(B, T, Hq, Hk, Dh, page, MP, offsets):
    """Least time for one bf16 paged attention call: the live K and V pages
    of each sequence ((offset+T-1)//page + 1 of them, per KV head), q, out,
    the table and the offsets at HBM_BYTES_PER_S, or the products of the
    keys each query attends (offset+t+1 of them; q.k and p.v, a multiply
    and an add each) at the bf16 rate, whichever is longer. Returns (ms,
    "bytes" | "operations")."""
    esize = 2
    live = sum(min((o + T - 1) // page, MP - 1) + 1 for o in offsets)
    nbytes = (2 * live * Hk * page * Dh * esize + 2 * B * T * Hq * Dh * esize
              + B * MP * 4 + B * 4)
    keys = sum(min(o + t + 1, MP * page) for o in offsets for t in range(T))
    ops = 4 * Hq * Dh * keys
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_paged_kernel(device):
    """The paged attention kernel vs its plain version at PAGED_SHAPES, in
    float32 and bf16, through both wrappers. Returns the per-shape records
    (timed in bf16, the main path's type) and the largest absolute
    error."""
    from specdec_tpu_torch.core.paged_cache import gather_pages
    from specdec_tpu_torch.ops import paged_attention as pa

    Hq, Hk, Dh, page = PAGED_HEADS
    gen = torch.Generator(device=device).manual_seed(4321)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=device)
    records, max_err = [], 0.0
    for label, B, T, MP, offsets in PAGED_SHAPES:
        NP = B * MP + 1
        table = (1 + torch.randperm(NP - 1, generator=gen, device=device)
                 )[:B * MP].reshape(B, MP).to(torch.int32)
        off = torch.tensor(offsets, dtype=torch.int32, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            ks, vs = (torch.randn((2, NP, Hk, page, Dh), generator=gen,
                                  device=device).to(dtype) for _ in range(2))
            q = torch.randn((B, T, Hq, Dh), generator=gen,
                            device=device).to(dtype)
            k2 = pa.paged_decode_attention(q, ks[1], vs[1], table, off)
            k8 = pa.paged_decode_attention_stacked(q, ks, vs, 1, table, off)
            torch.cuda.synchronize()
            if not torch.equal(k2, k8):
                fail(f"paged {label} {dtype}: the stacked wrapper (layer 1) "
                     "differs from the 4D wrapper on that layer")
            plain = pa.paged_attention_reference(q, ks[1], vs[1], table, off)
            err = (k2.float() - plain.float()).abs().max().item()
            if not torch.allclose(k2.float(), plain.float(),
                                  **PAGED_TOL[dtype]):
                fail(f"paged {label} {dtype}: kernel vs plain max abs err "
                     f"{err:.3g} beyond {PAGED_TOL[dtype]}")
            max_err = max(max_err, err)
            rec = {"name": label, "dtype": str(dtype).split(".")[-1],
                   "B": B, "T": T, "MP": MP, "offsets": offsets,
                   "max_abs_err": err}
            if dtype == torch.bfloat16:
                # yardstick: SDPA over K/V gathered (and GQA-expanded)
                # beforehand, the same mask; only the SDPA call is timed
                S = MP * page
                kg = gather_pages(ks[1], table).permute(0, 2, 1, 3)
                vg = gather_pages(vs[1], table).permute(0, 2, 1, 3)
                kg = kg.repeat_interleave(Hq // Hk, dim=1).contiguous()
                vg = vg.repeat_interleave(Hq // Hk, dim=1).contiguous()
                qt = q.permute(0, 2, 1, 3).contiguous()
                q_pos = off[:, None] + torch.arange(T, device=device)
                mask = (torch.arange(S, device=device)[None, None, :]
                        <= q_pos[:, :, None])[:, None]
                b, by = paged_bound_ms(B, T, Hq, Hk, Dh, page, MP, offsets)
                rec.update(
                    ms=gpu_ms(lambda: pa.paged_decode_attention_stacked(
                        q, ks, vs, 1, table, off), flush),
                    plain_ms=gpu_ms(lambda: pa.paged_attention_reference(
                        q, ks[1], vs[1], table, off), flush),
                    library_ms=gpu_ms(lambda: F.scaled_dot_product_attention(
                        qt, kg, vg, attn_mask=mask), flush),
                    bound_ms=b, bound_by=by)
                say(f"[3b paged] {label:6s} B={B} T={T} MP={MP}: kernel "
                    f"{rec['ms'] * 1e3:7.1f} us, plain "
                    f"{rec['plain_ms'] * 1e3:7.1f} us, SDPA "
                    f"{rec['library_ms'] * 1e3:7.1f} us, bound "
                    f"{b * 1e3:5.1f} us ({by}); max abs err {err:.3g}")
            records.append(rec)
    say(f"[3b paged] all {len(records)} comparisons within "
        f"{ {str(k).split('.')[-1]: v for k, v in PAGED_TOL.items()} }; "
        "stacked == 4D bit for bit")
    return records, max_err


def phase_serve_oracle(device):
    """The default serving engine, self-draft greedy on a float32 model,
    equals greedy AR per request with acceptance 1.0; then again with
    prefix caching and chunked prefill (chunks of 64, so partial
    admissions attend through the kernel at T=64). Dense float32 weights
    keep every product in float32: the engine and AR then differ only in
    summation order (the kernel against dense attention, batched against
    single-row matmuls), ~1e-6 of a logit, far below the gap between the
    top two logits; INT4's bf16 outputs would round logits to bf16, where
    ties between the top two are common (phase 4 allows them)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.model import init_params
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )
    from specdec_tpu_torch.serve import DefaultBatcher

    cfg = bench.target_config(num_layers=2, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(2)
    params = init_params(cfg, scale=0.02, device=device, generator=gen)
    rng = np.random.default_rng(3)

    def tokens(n):
        return [int(t) for t in rng.integers(1, bench.V, size=n)]

    shared = tokens(128)
    cases = (
        ("default", [tokens(n) for n in (40, 130, 75, 200, 33, 160)], {}),
        ("prefix+chunked", [shared + tokens(n) for n in (20, 45, 70, 9, 60)],
         dict(prefix_caching=True, prefill_chunk=64)),
    )
    new = 32
    for label, prompts, kw in cases:
        b = DefaultBatcher(cfg, params, cfg, params, num_slots=4, gamma=4,
                           max_prompt_len=256, max_new_tokens=new,
                           page_size=64, eos_tokens_id=(), device=device,
                           **kw)
        ids = [b.submit(p) for p in prompts]
        done = b.run()
        for i, (rid, p) in enumerate(zip(ids, prompts)):
            ar = autoregressive_generate(p, cfg, params, max_gen_len=new,
                                         eos_tokens_id=(), device=device)
            got = done[rid]
            if got.output_ids != ar or len(ar) != new:
                fail(f"serve oracle ({label}): request {i} gave "
                     f"{got.output_ids} where greedy AR gives {ar}")
            if got.metrics.acceptance_rate != 1.0:
                fail(f"serve oracle ({label}): request {i} acceptance "
                     f"{got.metrics.acceptance_rate}, not 1.0")
        if len(b._alloc_t.free) + len(b.prefix_cache) != b.num_pages - 1:
            fail(f"serve oracle ({label}): pages not returned")
        if kw and b.prefix_cache.hit_tokens == 0:
            fail(f"serve oracle ({label}): no prefix-cache hit")
        say(f"[4b serve oracle] {label}: {len(prompts)} requests on 4 slots "
            f"== greedy AR ({new} tokens each), acceptance 1.0; prefix hit "
            f"tokens {b.prefix_cache.hit_tokens}")


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


def serving_busy(batcher, device):
    """Device busy share of one more serving pass on ``batcher``:
    torch.profiler's CUDA kernel time over the pass's wall time (under the
    profiler, whose own overhead lengthens the wall time a little)."""
    from torch.profiler import ProfilerActivity, profile

    from specdec_tpu_torch import bench

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec = bench.serve_pass(batcher, bench.serving_prompts())
    totals = sorted(((e.key[:80], e.self_device_time_total / 1e3)
                     for e in prof.key_averages()), key=lambda kv: -kv[1])
    device_ms = sum(t for _, t in totals)
    if device_ms <= 0:
        return None
    wall_ms = rec["seconds"] * 1e3
    return {"device_ms": device_ms, "wall_ms": wall_ms,
            "busy_share": device_ms / wall_ms, "top": totals[:6]}


def phase_serve(pair, device):
    """The serving main path: both engines, launch counts of this run.
    Returns (summary, launches)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core import model as tmodel
    from specdec_tpu_torch.ops import paged_attention as pa
    from specdec_tpu_torch.ops import quant_matmul as qm

    t_cfg = pair[0]
    kernels = (qm.quant_matmul_stacked, qm.quant_matmul,
               pa.paged_decode_attention, pa.paged_decode_attention_stacked)
    for k in kernels:
        k.launches = 0
    tmodel.forward_step_paged.calls = 0
    runs = [bench.measure_serving(paged, pair, device)
            for paged in (True, False)]
    launches = {"stacked": qm.quant_matmul_stacked.launches,
                "2d": qm.quant_matmul.launches,
                "paged_4d": pa.paged_decode_attention.launches,
                "paged_stacked": pa.paged_decode_attention_stacked.launches}
    paged_forwards = tmodel.forward_step_paged.calls

    for r in runs:
        for name in ("warm", "timed"):
            outs = r[name]["outputs"]
            if len(outs) != bench.SERVE_REQUESTS or any(
                    len(o) != bench.SERVE_GEN or not all(
                        0 <= t < bench.V for t in o) for o in outs):
                fail(f"serve ({r['engine']}, {name}): not every request "
                     f"completed {bench.SERVE_GEN} in-vocabulary tokens")
            if not 0.0 < r[name]["acceptance"] <= 1.0:
                fail(f"serve ({r['engine']}, {name}): acceptance "
                     f"{r[name]['acceptance']}")
    b = runs[0]["batcher"]
    if len(b._alloc_t.free) != b.num_pages - 1:
        fail(f"serve: {len(b._alloc_t.free)} of {b.num_pages - 1} pages "
             "back in the pool")
    if b.max_pages_per_seq != SERVE_TABLE_PAGES:
        fail(f"serve: table width {b.max_pages_per_seq}, phase 3b timed "
             f"{SERVE_TABLE_PAGES}")
    want = t_cfg.num_layers * paged_forwards
    if paged_forwards == 0 or launches["paged_stacked"] != want or (
            launches["paged_4d"] != 0):
        fail(f"serve: {launches['paged_stacked']} stacked and "
             f"{launches['paged_4d']} 4D paged attention launches over "
             f"{paged_forwards} paged forwards; expected {want} and 0")
    if launches["stacked"] == 0 or launches["2d"] == 0:
        fail(f"serve: INT4 launches {launches}")

    paged, slotted = (r["timed"] for r in runs)
    # where the engines' greedy outputs first differ: the two attention
    # paths round differently in bf16, and a one-ulp difference flips a
    # near-tie of the bf16 logits, after which the continuations part
    agree = [next((i for i, (x, y) in enumerate(zip(a, c)) if x != y),
                  len(a))
             for a, c in zip(paged["outputs"], slotted["outputs"])]
    same = sum(n == bench.SERVE_GEN for n in agree)
    summary = {
        eng: {k: r["timed"][k] for k in ("tok_s", "ttft_p50_ms",
                                         "ttft_p99_ms", "acceptance",
                                         "seconds", "tokens")}
        for eng, r in (("paged", runs[0]), ("slotted", runs[1]))}
    summary["paged"]["preemptions"] = runs[0]["preemptions"]
    summary["paged_over_slotted"] = paged["tok_s"] / slotted["tok_s"]
    summary["same_outputs"] = same
    summary["agreeing_prefix_tokens"] = agree
    summary["paged_forwards"] = paged_forwards
    summary["launches"] = launches
    for r in runs:
        say(f"[6 serve] {r['engine']}: {r['timed']['tokens']} tokens in "
            f"{r['timed']['seconds']:.2f} s = {r['timed']['tok_s']:.1f} "
            f"tok/s, TTFT p50 {r['timed']['ttft_p50_ms']:.0f} ms, p99 "
            f"{r['timed']['ttft_p99_ms']:.0f} ms, acceptance "
            f"{r['timed']['acceptance']:.3f} (warm-up pass "
            f"{r['warm']['tok_s']:.1f} tok/s)")
    say(f"[6 serve] paged/slotted {summary['paged_over_slotted']:.3f}; "
        f"{same}/{len(slotted['outputs'])} requests with equal outputs, "
        f"agreeing prefixes of {min(agree)}-{max(agree)} tokens (median "
        f"{int(np.median(agree))}); "
        f"{paged_forwards} paged forwards, {launches['paged_stacked']} "
        f"attention launches (= {t_cfg.num_layers} per forward); all pages "
        "returned; preemptions " + str(runs[0]["preemptions"]))
    summary["profile"] = {}
    for r in runs:
        busy = serving_busy(r["batcher"], device)
        summary["profile"][r["engine"]] = busy
        if busy is None:
            say(f"[6 profile] {r['engine']}: device time not measured (the "
                "profiler recorded no CUDA activity)")
            continue
        say(f"[6 profile] {r['engine']}: device {busy['device_ms']:.0f} ms "
            f"of {busy['wall_ms']:.0f} ms wall (busy "
            f"{busy['busy_share']:.1%}); top: " + "; ".join(
                f"{k[:40]} {t:.0f} ms" for k, t in busy["top"][:4]))
    return summary, launches


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
    paged_records, paged_err = phase_paged_kernel(device)
    phase_oracle(device)
    phase_serve_oracle(device)
    summary, launches = phase_main(pair, device)
    summary["profile"] = phase_profile(pair, summary, device)
    summary["serving"], serve_launches = phase_serve(pair, device)

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
        key = "2d" if is_2d else "stacked"
        entries.append({
            "name": name, "route": "cuda",
            "source": "specdec_tpu_torch/ops/csrc/int4_pair_matmul.cu",
            "replaces": f"specdec_tpu/ops/quant_matmul.py:{line}",
            "launches": launches[key] + serve_launches[key],
            "launches_by_path": {"spec_decode": launches[key],
                                 "serving": serve_launches[key]},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms", step), "plain_ms": total("plain_ms", step),
            "bound_ms": total("bound_ms", step), "bound_by": "bytes",
            "library_ms": total("library_ms", step),
            "work": "M=1: " + ", ".join(f"{r['name']} {r['K']}x{r['N']}"
                                        for r in step),
            "shapes": timed})
    # the paged attention kernel: one CUDA kernel for K2 (4D pool) and K8a
    # (a layer of the stacks, the wrapper the serving path calls); the
    # top-level times are one verify call of the serving engine
    serve_shape = next(r for r in paged_records
                       if r["name"] == "serve" and "ms" in r)
    entries.append({
        "name": "paged_decode_attention (K8a stacked layer; K2 4D pool)",
        "route": "cuda",
        "source": "specdec_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "specdec_tpu/ops/paged_attention.py:258",
        "also_replaces": "specdec_tpu/ops/paged_attention.py:26",
        "launches": (serve_launches["paged_stacked"]
                     + serve_launches["paged_4d"]),
        "max_abs_err": paged_err,
        **{k: serve_shape[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        "work": "serving verify: B=8, T=9, Hq=32, Hk=4, Dh=64, page 64, "
                "MP=9, bf16",
        "shapes": [r for r in paged_records if "ms" in r]})
    say(f"[7 done] all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"largest kernel-vs-plain abs error {max_err:.3g} (INT4), "
        f"{paged_err:.3g} (paged attention)")
    say(card)
    say(json.dumps(summary))
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
