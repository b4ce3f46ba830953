#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``specdec_tpu_torch``) on one NVIDIA
GPU, an H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 switched off
   for float32 matmuls and convolutions;
2. build: nvcc builds the port's kernels from ``specdec_tpu_torch/ops/csrc``
   into ``build/kernels/`` (git-ignored), all sources at once;
3. kernel vs plain, INT4: the pair4 dequant-matmul kernel (K1) against its
   plain PyTorch version at every shape the main paths give it (M = 1, 2,
   13, 64 for single-sequence decoding; 8, 72, 256 for the serving engine's
   draft step, verify and admission prefill; 4 for a beam step, 6, 24, 48
   for NASD's verify at B = 1, 4, 8 and 512 for its B = 8 prefill; 3, 15,
   16 for the trees' drafter levels and verifies, 5 and 9 for EAGLE's
   catch-up and gamma-8 verify; M = 33 and up share one kernel instance),
   on the main path's own weights; its time beside the plain version's, a
   bf16 ``torch.matmul`` on pre-dequantized weights (a yardstick the port
   never calls) and the bound; the share of output elements bit-equal to
   the plain version's (at least MIN_BIT_EQUAL); a check that a row's
   result does not depend on how many rows share the call; and the two
   ragged shapes of K6 below, on random weights quantized on the card,
   through the 2D wrapper and through the stacked one (layer 1 of a stack
   of 2, whose fields start off any 16-byte line);
3b. kernel vs plain, paged attention: the paged decode-attention kernel,
   through both wrappers (a 4D pool, and a layer of stacked pools, which
   must agree bit for bit), against its plain version in float32 and bf16
   at the decode, verify, long-context and serving shapes, and once at
   qwen3-family heads (Hq=32, Hk=8, Dh=128), over bf16/f32 pools and over
   int8 pools with their scales; its time beside the plain version's,
   ``scaled_dot_product_attention`` over K/V gathered (and, for int8,
   dequantized) beforehand (a yardstick the port never calls) and the
   bound;
3c. kernel vs plain, flash-decode attention: the slotted-cache kernel over
   K/V of q's type and over int8 K/V, in float32 and bf16, at the shapes
   the main paths give it (single sequence B=1, S=334, T = 1, 2, 13, 64;
   the serving drafter B=8, T = 1, 2 over the batcher's S; the admission
   prefill T=256), at qwen3-family heads (decode and verify, Dh=128) and
   at S=2048 (8 spans of 4 tiles), and EAGLE's int8 + flash catch-ups
   and verify (T = 5, 6 over S = 327, 337), offsets up to S; a row's
   result must
   not depend on T (at S=334 and 2048), nor a sequence's on the rest of its
   batch (each alone at B=1, bit for bit); over the same keys laid out in
   pages of 64, K3/K4 equal the paged kernel K8a/K8b bit for bit (one
   kernel body, the same tiles and spans); times beside the plain
   version's, SDPA over the live K/V and the bound;
3d. kernel vs plain, INT8/NF4/FP4: as phase 3, for the INT8 kernel (K7)
   and the NF4/FP4 half-plane kernel (K6, both codecs), on the 22-layer
   pair's own weights in each format, with the share of output elements
   that are bit-equal to the plain version's (at least MIN_BIT_EQUAL);
   each also at two ragged shapes on random weights quantized on the card:
   K6 (as K1) at K = 768, so K % 512 = 256, and N = 1000, not a multiple of
   its column tiles, or N = 1001, odd; K7 at K = 1000, N = 1000 (K % 256 !=
   0, N % 32 = 8) and K = 1001, N = 1004 (odd K: x's rows are unaligned and
   take the scalar staging), each through both wrappers as in phase 3.
   Phase 2 rebuilds every kernel (K1, K6, K7,
   the flash-decode and the paged attention kernels) and fails if ptxas
   reports a register spill in any of their instances. With ``--against
   NAME=SRC`` (NAME a kernel's library in ``_build.SIGNATURES``; SRC
   another source of it, such as an earlier commit's from ``git show``,
   whose quoted includes are looked up beside it first, then in
   ``csrc``), phases 3 and 3d, 3b (``paged_attention``) or 3c
   (``decode_attention``) also time that source, built the same way and
   launched through the same wrappers, in turns with the checkout's (this,
   other, other, this);
4. greedy oracle: greedy self-draft speculative decoding equals greedy AR
   on the card (full widths, 2 layers, float32 activations, a kernel on
   every projection): INT4 weights with the plain attention and with int8
   KV under the flash-decode kernel, and INT8, NF4 and FP4 weights (the
   kernels' bf16 outputs round the logits, so the two may part where the
   top two logits are tied within two bf16 ulps);
   int8-KV prefill logits stay within 8% (relative max error) of bf16-KV
   logits;
4b. serving oracle: the default serving engine (``PagedContinuousBatcher``,
   self-draft, greedy, more requests than slots) gives every request
   greedy AR's tokens with acceptance 1.0 (full widths, 2 layers, float32),
   also with prefix caching and chunked prefill on prompts that share a
   prefix; dense weights with bf16 KV and with int8 KV under the
   flash-decode kernel, and INT8 weights (K7 on every projection);
5. main path, single sequence: ``specdec_tpu_torch.bench``'s 22-layer INT4
   LayerSkip pair, AR and speculative decoding (gamma 12, 256 tokens), with
   the kernels' launch counts checked against what the configuration
   implies, and a profile of the card's busy share; again with
   ``--kv-quant int8 --attn flash`` (every attention on the int8
   flash-decode kernel) and ``--attn flash`` (the flash-decode kernel over
   bf16 KV); then the same pair under ``--quant int8``, ``nf4`` and
   ``fp4``, every projection and the ``lm_head`` on K7 or K6 and none on
   K1; one timed call each;
6. main path, serving: ``bench.measure_serving`` on the same pair, the
   paged engine and the slotted one (16 requests x 128 tokens, 8 slots,
   gamma 8), with every page back in the pool, launch counts checked (the
   paged attention kernel once per target layer per paged forward, the
   int8 flash-decode kernel on every slotted forward) and a profile of the
   card's busy share under the paged engine; with bf16 KV and with
   ``--kv-quant int8 --attn flash``; and the paged engine under ``--quant
   int8`` and ``--quant nf4`` (K7 or K6 on every projection, at the
   serving row counts M = 8, 72, 256);
4c. dispatch: a model with head_dim 256 (gemma's; the attention kernels
   take at most 128) runs the slotted forward under the flash setting and
   the paged forward with ``use_kernel=None``, over bf16 and int8 KV, with
   no attention kernel launched, logits equal to the plain path's, and
   ``use_kernel=True`` raising before any launch;
7. NASD on the INT4 target of phase 5, greedy (tools/bench_nasd.py's
   protocol, cut to 64 tokens: n = 3, gamma 5, prompts from
   default_rng(3)):
   the host store in Python at B = 1, 4 and 8 (fresh each call), the C++
   store at B=1 (carried from call to call, so that its drafts are
   accepted in part and the cache rolls back), and the device table at
   B = 1, 4 and 8 (ragged prompts of 40-60 tokens, the table carried);
   each one warm and one timed call, every call equal to greedy AR per
   prompt (a first parting only at a top-two bf16 tie; every token of a
   parted output then the target's argmax over its own prefix, within
   that tie, in a replay of the engine's computation), K1 launched per
   target forward as implied; tok/s beside the card's name and power
   limit; again under int8 KV + flash (K4 in every verify) for the
   carried C++ store at B=1 and the table at B=4;
7b. NASD serving: ``NasdContinuousBatcher`` with 8 slots, gamma 5, the 16
   prompts of phase 6, 128 tokens each, at 1 and 4 windows per host sync:
   every request equal to greedy AR, a parted one replayed as in phase 7,
   both settings the same tokens; tok/s, TTFT, acceptance, windows and K1
   launches;
7c. beam search on the same target: one beam of one expansion equals
   greedy AR (a parted output replayed as in phase 7), four beams give
   the same tokens twice; ms per step and K1 launches (M = beams).
4d. tree oracles (full widths, 2 layers, float32 activations, K1 on every
   projection): greedy tree speculation with a 1-layer prefix drafter and
   greedy EAGLE trees with an untrained 1-layer head, at (2, 2, 1, 1),
   (3, 2, 1) and (4, 2), each equal to greedy AR up to a top-two bf16
   tie; (3, 2, 1) again under int8 KV + flash and under bf16 + flash,
   where the launches show K4 (K3) on every sequential forward and on no
   tree forward;
8. trees at full depth, tools/bench_tree.py's protocol on the pair of
   phase 5 (a 60-token prompt from default_rng(0), 256 tokens, greedy):
   (2, 2, 2), (3, 2, 1) and (4, 2) at tail damp 0.08 and 0.35, (2, 2, 2)
   under INT8 weights (K7) and under int8 KV + flash, a warm and a timed
   call each; a sampled (2, 2, 2) call twice from one seed gives the same
   tokens; tok/s, chain-depth acceptance, windows, launches as implied;
   every greedy output equal to greedy AR up to a first tie, a parted one
   replayed in the engine's shape;
8b. EAGLE on the same target (tools/bench_eagle.py's protocol, 256
   tokens), an untrained depth-1 head made on the card from a seed: chain
   gamma 3, 5, 8 sampled, chain gamma 5 greedy (GreedyProcessor at
   temperature 1e-4, where acceptance is exact-match), the greedy trees
   (3, 2, 1), (2, 2, 2), (4, 2), each greedy output equal to greedy AR up
   to a tie (replayed); chain gamma 5 and tree (2, 2, 2) under int8 KV +
   flash; K1a on every head forward, K4 on every sequential forward;
8c. EAGLE batched and served: ``batch_eagle_generate`` at B=8 on the
   serving phase's prompts, 128 tokens, greedy, gamma 5, and
   ``EagleContinuousBatcher`` (8 slots) on all 16 at 1 and 4 windows per
   sync: the same tokens, each request equal to the batch engine's (and
   that to greedy AR) up to a tie; tok/s, TTFT, acceptance, windows, K1
   launches (M = 48 a verify, 256 an admission).

Any failed phase exits 1 (without a CUDA device, or outside a checkout,
too, before any result is printed). Standard output ends with the card's
name and power limit, a JSON line of the main paths' numbers, a JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
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

# main-path shapes of the weight kernels: (name, K, N) of each layer projection
# of the 22-layer target (the drafter reads layers 0..3 of the same stacks),
# the 2D lm_head
STACKED = [("wqkv", 2048, 2560), ("wo", 2048, 2048),
           ("w_gateup", 2048, 11264), ("w_down", 5632, 2048)]
LM_HEAD = ("lm_head", 2048, 32000)
# ragged shapes, by weight format, through the 2D wrapper and through the
# stacked one (layer 1 of a stack of 2, its fields off any 16-byte line).
# K1 and K6: K %
# 512 = 256 and N not a multiple of their column tiles; an odd N also takes
# the scalar loads and stores. K7: K % 256 != 0 (a partial last chunk), N %
# 32 = 8 (a partial column group); an odd K leaves x's rows unaligned, which
# takes the scalar staging of x
RAGGED = {"int4": [("ragged", 768, 1000), ("ragged_odd", 768, 1001)],
          "int8": [("ragged", 1000, 1000), ("ragged_odd", 1001, 1004)]}
RAGGED["nf4"] = RAGGED["fp4"] = RAGGED["int4"]
RAGGED_NAMES = {name for shapes in RAGGED.values() for name, _, _ in shapes}
# the library of each format's weight kernel (``--against`` names one)
WEIGHT_LIBS = {"int4": "int4_pair_matmul", "int8": "int8_matmul",
               "nf4": "q4_halfplane_matmul", "fp4": "q4_halfplane_matmul"}
# the row counts M the main paths give the weight kernels. Single sequence:
# AR/draft step, drafter catch-up, verify (gamma 12), prefill (64); serving
# (8 slots, gamma 8): draft step, verify, admission prefill (256); beam
# search: a step of 4 beams (their prefill 256); NASD (gamma 5): the verify
# at B = 1, 4, 8 (6, 24, 48; NASD serving's 8 slots 48) and the prefill at
# B = 8 (512; B = 1 and 4: 64 and 256); trees: the drafter's levels (1-8
# nodes: 3 and 6 for (3, 2, 1)), the verify of (4, 2), (2, 2, 2) and (3, 2,
# 1) (13, 15, 16 nodes); EAGLE: the chain verify at gamma 3, 5, 8 (4, 6,
# 9), the head's catch-up (gamma + 1, a tree's depth + 2: 4, 5) on the
# lm_head, its serving verify (48). K1's instances split M at 8, 16 and
# 32: each instance of every main path is held to the plain version
ROWS = (1, 2, 3, 4, 5, 6, 8, 9, 13, 15, 16, 24, 48, 64, 72, 256, 512)
# kernel vs plain: relative Frobenius error and elementwise tolerance (the
# JAX package's kernel-vs-oracle tolerance, tests/test_quant.py); both
# sides round x and y to bf16 (and NF4/FP4 each weight, identically) and
# differ only in f32 summation order
REL_FRO_TOL = 1e-2
RTOL, ATOL = 2e-2, 2e-1
# K1, K6 and K7 form the same bf16 weights as their plain versions, so an
# output differs only where the f32 sums' order moves its bf16 rounding
# (K1 also scales each 64-k block in four 16-k pieces): at least this share
# must be bit-equal (K1 99.95-100%, K6 99.85-100%, K7 99.95-100% on an
# H100). Weights rounded otherwise than the plain version's (truncated, or
# kept in f32), or a scale folded into the weights, shift every output by
# a fraction of a bf16 ulp and would change a large share of them.
MIN_BIT_EQUAL = 0.99
TIMED_RUNS = 25
# timed calls of each single-sequence main path, after one warm-up
# (bench.REPS takes three): one, so that the whole run stays near 8 minutes
MAIN_REPS = 1
SLEEP_CYCLES = 50_000_000   # keeps the card busy while the runs enqueue

# attention heads (Hq, Hk, Dh): the pair's, and a qwen3-family model's
# (Qwen3-8B: 32 query heads over 8 KV heads of 128), run once on each
# attention kernel
PAIR_HEADS = (32, 4, 64)
QWEN3_HEADS = (32, 8, 128)
# paged attention shapes: (label, B, T, page, MP, offsets, heads). Page 64
# is the serving engine's: decode/verify are tools/bench_paged.py's
# validation shapes; long reaches the config's 2048 positions; serve is the
# serving engine's verify (8 slots, gamma 8) at its table width of 9 pages,
# chunk a chunk of phase 4b's chunked prefill (prefill_chunk=64) at that
# width. Pages of 16 (four to a 64-key tile) and 128 (half a page a tile)
# with offsets at page starts and ends. Every table's entries past its
# sequence's last live page hold POISON, an out-of-range page index that
# faults if the kernel reads it.
PAGE = 64
SERVE_TABLE_PAGES = 9
POISON = 2 ** 30
PAGED_SHAPES = [
    ("decode", 8, 1, PAGE, 8, [40, 100, 511, 7, 250, 64, 63, 300],
     PAIR_HEADS),
    ("verify", 4, 9, PAGE, 8, [40, 100, 350, 7], PAIR_HEADS),
    ("long", 8, 9, PAGE, 32, [2000, 1500, 1023, 64, 7, 1800, 2030, 511],
     PAIR_HEADS),
    ("serve", 8, 9, PAGE, SERVE_TABLE_PAGES,
     [60, 150, 230, 320, 90, 200, 280, 330], PAIR_HEADS),
    ("chunk", 1, 64, PAGE, SERVE_TABLE_PAGES, [128], PAIR_HEADS),
    ("page16", 4, 9, 16, 32, [15, 16, 200, 490], PAIR_HEADS),
    ("page128", 4, 9, 128, 4, [127, 128, 300, 500], PAIR_HEADS),
    ("qwen3-verify", 4, 9, PAGE, 8, [40, 100, 350, 7], QWEN3_HEADS),
]
# row independence of the paged kernel: the rows of a T=64 call against the
# same rows of calls at these T, at every paged shape
PAGED_ROW_CHECK_T = (1, 2, 9)
# kernel vs plain, float32: the sides differ in summation order only
# (online vs dense softmax)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# kernel vs plain, bf16: scores and softmax statistics are f32 on both
# sides; each rounds every probability (times its v-scale) to bf16 before
# P.V, the plain version after normalizing and the kernel before, against
# its running max, with a relative error of at most BF16_U each; so their
# f32 sums differ by at most 2 * BF16_U * sum_s p_s |v_s| (the attention
# of |V|), and each rounds its output to bf16 once: one ulp. Elementwise,
# |kernel - plain| <= ulp + 2 * BF16_U * (P.|V|) (check_attention)
BF16_U = 2.0 ** -8

# flash-decode shapes: (label, B, S, T, offsets, heads). Single sequence:
# the speculative loop's cache capacity S = 64 + 256 + 12 + 2, T = 1 (AR and
# draft step), 2 (drafter catch-up), 13 (gamma-12 verify) and 64 (prefill);
# serving: the slotted drafter's draft step and catch-up over the batcher's
# S = 256 + 128 + 8 + 2, 8 slots, and the dense admission prefill of
# max_prompt_len = 256 rows; decode and verify at qwen3-family heads; a
# verify and a prefill at the config's 2048 positions, where the kernel's 8
# spans hold 4 tiles each; and EAGLE's sequential forwards under int8 KV +
# flash (phase 8b): the chain's catch-up and verify (T = 6, gamma 5) over
# its S = 64 + 256 + 5 + 2, the (2, 2, 2) tree's catch-up (T = 5) over
# S = 64 + 256 + 15 + 2. Offsets reach S - T.
SINGLE_S, SERVE_S, LONG_S = 334, 394, 2048
EAGLE_S, EAGLE_TREE_S = 327, 337
FLASH_SHAPES = [
    ("decode", 1, SINGLE_S, 1, [333], PAIR_HEADS),
    ("catch-up", 1, SINGLE_S, 2, [150], PAIR_HEADS),
    ("verify", 1, SINGLE_S, 13, [321], PAIR_HEADS),
    ("prefill", 1, SINGLE_S, 64, [0], PAIR_HEADS),
    ("serve-draft", 8, SERVE_S, 1, [0, 5, 63, 64, 200, 300, 391, 393],
     PAIR_HEADS),
    ("serve-catch-up", 8, SERVE_S, 2, [1, 7, 62, 130, 257, 333, 390, 392],
     PAIR_HEADS),
    ("admission", 1, SERVE_S, 256, [0], PAIR_HEADS),
    ("qwen3-decode", 1, SINGLE_S, 1, [333], QWEN3_HEADS),
    ("qwen3-verify", 1, SINGLE_S, 13, [321], QWEN3_HEADS),
    ("long-verify", 1, LONG_S, 13, [2030], PAIR_HEADS),
    ("long-prefill", 1, LONG_S, 64, [1900], PAIR_HEADS),
    ("eagle-catch-up", 1, EAGLE_S, 6, [180], PAIR_HEADS),
    ("eagle-verify", 1, EAGLE_S, 6, [321], PAIR_HEADS),
    ("eagle-tree-catch-up", 1, EAGLE_TREE_S, 5, [300], PAIR_HEADS),
]
# row independence: the rows of a T=64 call at one offset against the same
# rows of calls at smaller T, over a cache of each capacity (S, offset)
ROW_CHECK_T = (1, 2, 13)
ROW_CHECK_S = ((SINGLE_S, 200), (LONG_S, 1900))


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


def bytes_per_weight(fmt, K):
    """Bytes per stored weight: the 4-bit code and a bf16 scale per 64 (K1,
    K6), or the int8 byte and an f32 scale per column of K (K7)."""
    return 1 + 4 / K if fmt == "int8" else 0.5 + 1 / 32


def bound_ms(M, K, N, bpw):
    """Least time for one call: the weights K*N*bpw + x M*K*2 + y M*N*2
    bytes at HBM_BYTES_PER_S, or 2*M*K*N operations at the bf16 rate,
    whichever is longer. Returns (ms, "bytes" | "operations")."""
    t_bytes = (K * N * bpw + M * K * 2 + M * N * 2) / HBM_BYTES_PER_S
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


# kernels rebuilt on every run and failed on any ptxas register spill: the
# INT4 kernel (K1), the NF4/FP4 kernel (K6), the INT8 kernel (K7) and the
# attention kernels, flash-decode (K3/K4) and paged (K2/K8a, K5/K8b): every
# kernel of the port
SPILL_CHECKED = ("int4_pair_matmul", "q4_halfplane_matmul", "int8_matmul",
                 "decode_attention", "paged_attention")
# the kernels ``--against`` takes: the weight kernels and the attention
# kernels
AGAINST_LIBS = (sorted(set(WEIGHT_LIBS.values()))
                + ["decode_attention", "paged_attention"])


def phase_build():
    """Build every kernel; fail if ptxas reports a register spill, or no
    spill report, in any instance of a kernel of SPILL_CHECKED, each rebuilt
    first so that its report is there to check."""
    from specdec_tpu_torch.ops import _build
    t0 = time.perf_counter()
    for name in SPILL_CHECKED:
        _build._target(name).unlink(missing_ok=True)
    log = _build.build()
    say(f"[2 build] nvcc built {sorted(log)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rec in log.items():
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")
    for name in SPILL_CHECKED:
        spills = [int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", log[name]["ptxas"])]
        if not spills or any(spills):
            fail(f"{name}: ptxas reports register spills (or no spill "
                 "report)")
        say(f"  {name}: {len(spills) // 2} instances, no spill")


def build_against(spec):
    """``--against NAME=SRC``: SRC, another source of kernel NAME (such as
    an earlier commit's; its headers are looked up in ``csrc``), built with
    the same flags. Returns (NAME, its library, loaded with NAME's C
    signature)."""
    import ctypes

    from specdec_tpu_torch.ops import _build

    name, _, src = spec.partition("=")
    if name not in AGAINST_LIBS or not os.path.isfile(src):
        fail(f"--against {spec}: expected NAME=SRC, NAME one of "
             f"{AGAINST_LIBS} and SRC a file")
    out = _build.BUILD_DIR / f"lib{name}_against.so"
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-o", str(out), src],
                           capture_output=True, text=True, timeout=600)
    if built.returncode:
        fail(f"--against: nvcc failed on {src}:\n{built.stdout}"
             f"{built.stderr}")
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, name)
    fn.argtypes = _build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    say(f"[2 build] --against: built {src} as {name}")
    return name, lib


@contextlib.contextmanager
def launching(name, lib):
    """Inside, the wrappers of kernel ``name`` launch ``lib``'s kernel (the
    wrappers look their library up in ``_build`` at every call)."""
    from specdec_tpu_torch.ops import _build

    _build.load(name)
    mine = _build._libs[name]
    _build._libs[name] = lib
    try:
        yield
    finally:
        _build._libs[name] = mine


def weight_format(w):
    """A quantized container's format: (label, the plain version of its
    kernel on one layer's two tensors)."""
    from specdec_tpu_torch.ops import quant_matmul as qm
    from specdec_tpu_torch.quant.core import Int4Weight, Int8Weight, NF4Weight

    if isinstance(w, Int8Weight):
        return "int8", qm.int8_matmul_reference
    if isinstance(w, Int4Weight):
        return "int4", qm.int4_matmul_reference
    codec = "nf4" if isinstance(w, NF4Weight) else "fp4"
    return codec, lambda x, a, b: qm.q4_halfplane_matmul_reference(x, a, b,
                                                                   codec)


def layer_of(w, layer):
    """Layer ``layer`` of a stacked container (None: the 2D container)."""
    if layer is None:
        return w
    return type(w)(**{f.name: getattr(w, f.name)[layer]
                      for f in dataclasses.fields(w)})


def kernel_vs_plain(got, plain):
    """(max abs error, relative Frobenius error, within the tolerance)."""
    err = (got - plain).abs().max().item()
    rel = ((got - plain).norm() / plain.norm()).item()
    return err, rel, rel <= REL_FRO_TOL and torch.allclose(
        got, plain, rtol=RTOL, atol=ATOL)


def phase_kernel(target, device, phase="3 kernel", against=None):
    """Kernel vs plain at every main-path shape, for the weight format of
    ``target`` (the 22-layer pair's target). ``against``: build_against's
    (NAME, library); where NAME is this format's kernel, that library is
    held to the same tolerance and timed in turns with the checkout's.
    Returns the per-shape records and the largest absolute error."""
    from specdec_tpu_torch.ops import quant_matmul as qm
    from specdec_tpu_torch.quant import core as qc
    from specdec_tpu_torch.quant.core import dequantize

    fmt, plain_fn = weight_format(target["lm_head"])
    other = (against[1] if against and against[0] == WEIGHT_LIBS[fmt]
             else None)
    gen = torch.Generator(device=device).manual_seed(1234)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=device)
    records, max_err = [], 0.0
    cases = [(name, K, N, layer) for name, K, N in STACKED
             for layer in (0, 21)] + [LM_HEAD + (None,)]
    # the ragged shapes through the 2D wrapper and through the stacked one
    # (layer 1 of a stack of 2, whose fields start off any 16-byte line)
    cases += [shape + (layer,) for shape in RAGGED.get(fmt, ())
              for layer in (None, 1)]
    for name, K, N, layer in cases:
        if name in RAGGED_NAMES:
            # random weights quantized on the card
            w = getattr(qc, f"quantize_{fmt}")(
                torch.randn((K, N) if layer is None else (2, K, N),
                            generator=gen, device=device) * 0.02)

            def kern(x, w=w, layer=layer):
                return (qm.quant_matmul(x, w) if layer is None
                        else qm.quant_matmul_stacked(x, w, layer))
        elif layer is None:
            w = target["lm_head"]

            def kern(x, w=w):
                return qm.quant_matmul(x, w)
        else:
            w = target["layers"][name]

            def kern(x, w=w, layer=layer):
                return qm.quant_matmul_stacked(x, w, layer)
        lw = layer_of(w, layer)
        a, b = (lw.q, lw.scale) if fmt == "int8" else (lw.packed, lw.absmax)
        want = (K, N) if fmt == "int8" else (K // 8, N)
        if tuple(a.shape) != want:
            fail(f"{fmt} {name}: weight {tuple(a.shape)}, expected {want}")
        x_all = torch.randn((max(ROWS), K), generator=gen, device=device
                            ).to(torch.bfloat16)
        ys = {M: kern(x_all[:M]) for M in ROWS}
        torch.cuda.synchronize()
        for M in ROWS:
            # a row's result must not depend on how many rows share the call
            if not torch.equal(ys[M], ys[max(ROWS)][:M]):
                fail(f"{fmt} {name} layer {layer}: rows of the M={M} call "
                     f"differ from the same rows of the M={max(ROWS)} call")
        w_bf16 = dequantize(lw, torch.bfloat16)
        for M in ROWS:
            x = x_all[:M]
            plain = plain_fn(x, a, b).float()
            got = ys[M].float()
            err, rel, ok = kernel_vs_plain(got, plain)
            if not ok:
                fail(f"{fmt} {name} layer {layer} M={M}: kernel vs plain max "
                     f"abs err {err:.3g}, relative Frobenius {rel:.3g}")
            max_err = max(max_err, err)
            rec = {"name": name, "format": fmt, "layer": layer, "M": M,
                   "K": K, "N": N, "max_abs_err": err, "rel_fro_err": rel,
                   "bit_equal": (got == plain).float().mean().item()}
            if rec["bit_equal"] < MIN_BIT_EQUAL:
                fail(f"{fmt} {name} layer {layer} M={M}: only "
                     f"{rec['bit_equal']:.3%} of the kernel's outputs "
                     f"bit-equal to the plain version's (at least "
                     f"{MIN_BIT_EQUAL:.0%})")
            if layer in (0, None):
                b_ms, by = bound_ms(M, K, N, bytes_per_weight(fmt, K))
                rec.update(
                    ms=gpu_ms(lambda: kern(x), flush),
                    plain_ms=gpu_ms(lambda: plain_fn(x, a, b), flush),
                    library_ms=gpu_ms(lambda: torch.matmul(x, w_bf16), flush),
                    bound_ms=b_ms, bound_by=by)
                if other is not None:
                    with launching(WEIGHT_LIBS[fmt], other):
                        o_err, _, ok = kernel_vs_plain(kern(x).float(), plain)
                        t = [gpu_ms(lambda: kern(x), flush) for _ in (0, 1)]
                    if not ok:
                        fail(f"--against {fmt} {name} M={M}: the other "
                             f"source's kernel vs plain max abs err "
                             f"{o_err:.3g}")
                    rec["against_ms"] = min(t)
                    rec["ms"] = min(rec["ms"], gpu_ms(lambda: kern(x), flush))
                say(f"[{phase}] {fmt} {name:8s} M={M:3d} K={K} N={N}: kernel "
                    f"{rec['ms'] * 1e3:8.1f} us, plain "
                    f"{rec['plain_ms'] * 1e3:8.1f} us, torch.matmul bf16 "
                    f"{rec['library_ms'] * 1e3:7.1f} us, bound "
                    f"{b_ms * 1e3:6.1f} us ({by}); max abs err {err:.3g}, "
                    f"rel {rel:.2g}, bit-equal {rec['bit_equal']:.3%}")
            records.append(rec)
    say(f"[{phase}] {fmt}: all {len(records)} comparisons within relative "
        f"Frobenius {REL_FRO_TOL} and rtol {RTOL}, atol {ATOL} "
        f"({min(r['bit_equal'] for r in records):.3%}-"
        f"{max(r['bit_equal'] for r in records):.3%} of elements bit-equal); "
        f"row-independent at M in {ROWS}")
    for M in ROWS if other is not None else ():
        # a layer's four projections (layer 0) and the lm_head, us per call
        # of this checkout's kernel against the other source's
        rows = [r for r in records if r["M"] == M and "against_ms" in r]
        layer = [sum(r[k] for r in rows if r["layer"] == 0) * 1e3
                 for k in ("ms", "against_ms")]
        head = [next(r[k] for r in rows if r["name"] == LM_HEAD[0]) * 1e3
                for k in ("ms", "against_ms")]
        say(f"[{phase} against] {fmt} M={M:3d}: a layer {layer[0]:8.1f} us "
            f"against {layer[1]:8.1f} ({layer[1] / layer[0]:.2f}x); lm_head "
            f"{head[0]:8.1f} against {head[1]:8.1f} "
            f"({head[1] / head[0]:.2f}x)")
    return records, max_err


# the configurations the oracles and main paths run besides the default
# (bf16 KV, plain attention on the slotted cache): ModelConfig fields
KVINT8_FLASH = dict(kv_quant="int8", attention_impl="flash")
FLASH = dict(attention_impl="flash")


def greedy_tie(what, cfg, params, prompt, ar, got, device):
    """Where ``got`` parts from greedy AR's tokens ``ar``: the position, if
    the target's top two logits there are tied within two bf16 ulps, else
    a failure. The weight kernels round every output to bf16, the
    lm_head's too, so each logit is the bf16 rounding of an f32 sum that AR
    (one row, cached attention) and the engine (blocks of rows, another
    attention) reach in another order: each of the top two can land one ulp
    apart, and their gap can move by two. Such ties are common (exact ones
    too, among 32000 bf16 logits), so they may fall at any token."""
    from specdec_tpu_torch.core.model import forward_full

    i = next(j for j, (a, b) in enumerate(zip(ar, got)) if a != b)
    toks = torch.tensor([prompt + ar[:i]], device=device)
    top2 = forward_full(cfg, params, toks)[0, -1].topk(2).values.tolist()
    gap = top2[0] - top2[1]
    ulp = 2.0 ** (math.floor(math.log2(abs(top2[0]))) - 7)
    if gap > 2 * ulp:
        fail(f"{what}: diverges from greedy AR at token {i} where the "
             f"target's top-2 logit gap {gap:.3g} exceeds two bf16 ulps "
             f"({2 * ulp:.3g})")
    return i, gap, ulp


def phase_oracle(device, label="bf16 KV", kind="int4", **cfg_kw):
    """Greedy self-draft speculative == greedy AR, on the kernels, with
    weights in format ``kind`` and the configuration ``cfg_kw``
    (ModelConfig fields)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.model import init_params
    from specdec_tpu_torch.quant.core import quantize_params
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )
    from specdec_tpu_torch.sampling.speculative import speculative_generate

    cfg = bench.target_config(num_layers=2, dtype=torch.float32, **cfg_kw)
    gen = torch.Generator(device=device).manual_seed(1)
    params = quantize_params(
        init_params(cfg, scale=0.02, device=device, generator=gen),
        kind=kind, fuse=True)
    prompt = bench.bench_prompt(seed=1)
    ar = autoregressive_generate(prompt, cfg, params, max_gen_len=64,
                                 eos_tokens_id=(), device=device)
    spec, rate = speculative_generate(prompt, cfg, params, cfg, params,
                                      gamma=bench.GAMMA, max_gen_len=64,
                                      eos_tokens_id=(), device=device)
    what = f"oracle ({kind} weights, {label})"
    if len(ar) != 64 or len(spec) != 64:
        fail(f"{what}: {len(ar)} AR and {len(spec)} spec tokens, not 64")
    if spec == ar:
        if rate != 1.0:
            fail(f"{what}: tokens equal but acceptance {rate}")
        say(f"[4 oracle] {kind} weights, {label}: greedy self-draft spec == "
            f"greedy AR over 64 tokens (2 layers, float32 activations), "
            f"acceptance {rate}")
        return
    i, gap, ulp = greedy_tie(what, cfg, params, prompt, ar, spec, device)
    say(f"[4 oracle] {kind} weights, {label}: spec == AR for the first {i} "
        f"tokens; token {i} is a tie within two bf16 ulps (top-2 gap "
        f"{gap:.3g}, ulp {ulp:.3g}); acceptance {rate:.4f}")


def phase_kv_error(pair, device):
    """Bounded error of the int8 KV cache at full width: the prefill logits
    of the bench prompt with int8 KV against bf16 KV, on the pair's target
    under the flash-decode kernel, within a relative max error of 0.08
    (tests/test_kv_quant.py's bound)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.cache import init_cache
    from specdec_tpu_torch.core.model import forward_step

    t_cfg, _, target, _ = pair
    toks = torch.tensor([bench.bench_prompt()], device=device)
    logits = {}
    for kv in ("none", "int8"):
        cfg = t_cfg.replace(kv_quant=kv, attention_impl="flash")
        logits[kv], _ = forward_step(cfg, target, toks,
                                     init_cache(cfg, 1, toks.shape[1],
                                                device=device))
    err = ((logits["int8"] - logits["none"]).abs().max()
           / logits["none"].abs().max()).item()
    if not err < 0.08:
        fail(f"int8 KV: prefill logits off bf16 KV's by {err:.3g} "
             "(relative max error), not < 0.08")
    say(f"[4 oracle] int8 KV prefill logits vs bf16 KV (22 layers, flash "
        f"kernels): relative max error {err:.4f} < 0.08")
    return err


def attention_bound_ms(live_positions, B, T, Hq, Hk, Dh, keys, int8=False,
                       index_bytes=0):
    """Least time for one bf16 attention call: the live K and V
    (``live_positions`` summed over the batch, x Hk x Dh, one byte each
    for int8 with a 4-byte scale per position and head, two for bf16), q
    and out (bf16) and ``index_bytes`` of tables and offsets at
    HBM_BYTES_PER_S, or the products of the ``keys`` every query row
    attends (q.k and p.v, a multiply and an add each, for each of the Hq
    heads) at the bf16 rate, whichever is longer. Returns (ms, "bytes" |
    "operations")."""
    kv = live_positions * Hk * (Dh + 4 if int8 else 2 * Dh)
    nbytes = 2 * kv + 2 * B * T * Hq * Dh * 2 + index_bytes
    ops = 4 * Hq * Dh * keys
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def paged_bound_ms(B, T, Hq, Hk, Dh, page, MP, offsets, int8=False):
    """``attention_bound_ms`` of a paged call: each sequence's live
    positions min(offset + T, MP * page), the table entries of its live
    pages and the offsets; the keys each query attends are offset+t+1."""
    live = [min(o + T, MP * page) for o in offsets]
    pages = sum(-(-n // page) for n in live)
    keys = sum(min(o + t + 1, MP * page) for o in offsets for t in range(T))
    return attention_bound_ms(sum(live), B, T, Hq, Hk, Dh, keys, int8,
                              pages * 4 + B * 4)


def sdpa_args(q, k, v, offsets, k_scale=None, v_scale=None):
    """Arguments of the SDPA yardstick over dense [B, S, Hk, Dh] K/V:
    dequantized to q's type beforehand for int8, GQA-expanded, with the
    kernel's mask; built outside the timed call."""
    B, T, Hq, Dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    if k_scale is not None:
        k = (k.float() * k_scale[..., None]).to(q.dtype)
        v = (v.float() * v_scale[..., None]).to(q.dtype)
    kg = k.permute(0, 2, 1, 3).repeat_interleave(Hq // Hk, dim=1)
    vg = v.permute(0, 2, 1, 3).repeat_interleave(Hq // Hk, dim=1)
    q_pos = offsets[:, None] + torch.arange(T, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= q_pos[:, :, None])[:, None]
    return (q.permute(0, 2, 1, 3).contiguous(), kg.contiguous(),
            vg.contiguous(), mask)


def bf16_ulp(x):
    """One bf16 ulp at |x| (2**-7 in [1, 2)); below the smallest normal,
    its ulp."""
    a = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_attention(what, got, plain, pv_abs=None, against="plain"):
    """Kernel against plain (or against another kernel, ``against``):
    float32 within F32_TOL; bf16 elementwise within one ulp plus 2 * BF16_U
    * ``pv_abs`` (the plain version's attention of |V|, in float32; see
    BF16_U). Returns the max abs error and, for bf16, the worst error in
    ulps, the share of elements within one ulp and the worst error over its
    allowance."""
    got, plain = got.float(), plain.float()
    diff = (got - plain).abs()
    err = diff.max().item()
    if pv_abs is None:
        if not torch.allclose(got, plain, **F32_TOL):
            fail(f"{what}: kernel vs {against} max abs err {err:.3g} beyond "
                 f"{F32_TOL}")
        return {"max_abs_err": err}
    ulp = bf16_ulp(torch.maximum(got.abs(), plain.abs()))
    ratio = (diff / (ulp + 2 * BF16_U * pv_abs.float())).max().item()
    if not ratio <= 1.0:
        fail(f"{what}: kernel vs {against} beyond one bf16 ulp + 2 * 2**-8 "
             f"* P.|V| (worst error {ratio:.3g} of its allowance)")
    ulps = diff / ulp
    return {"max_abs_err": err, "max_ulps": ulps.max().item(),
            "within_1ulp": (ulps <= 1.0).float().mean().item(),
            "bound_ratio": ratio}


def tol_summary(recs):
    """The tolerances of a phase's comparisons and how close bf16 came."""
    bf = [r for r in recs if r["dtype"] == "bfloat16"]
    return (f"float32 within {F32_TOL}; bf16 within one ulp + 2 * 2**-8 * "
            f"P.|V| (worst {max(r['bound_ratio'] for r in bf):.2f} of it; "
            f"{min(r['within_1ulp'] for r in bf):.1%}-"
            f"{max(r['within_1ulp'] for r in bf):.1%} of elements within "
            "one ulp)")


def poisoned(table, offsets, T, page):
    """``table`` with every entry past its sequence's last live page (that
    of position offsets[b] + T - 1) set to POISON."""
    last = (torch.as_tensor(offsets, device=table.device) + T - 1) // page
    lp = torch.arange(table.shape[1], device=table.device)
    return torch.where(lp[None] > last[:, None], POISON, table).to(
        torch.int32)


def phase_paged_kernel(device, against=None):
    """The paged attention kernel vs its plain version at PAGED_SHAPES, in
    float32 and bf16, through both wrappers (which must agree bit for bit),
    over pools of q's type and over int8 pools with scales (quantized from
    the same kind of random pools), the tables poisoned past each
    sequence's last live page (the plain version reads the clean table);
    checks that a query row's result does not depend on T, nor a
    sequence's on the others of its batch. ``against``: build_against's
    (NAME, library); where NAME is ``paged_attention``, that library is
    held to the same tolerance and timed in turns with the checkout's.
    Returns the per-shape records of each pool format (timed in bf16, the
    main path's type) and each format's largest absolute error."""
    from specdec_tpu_torch.core.cache import quantize_kv_block
    from specdec_tpu_torch.core.paged_cache import (
        gather_page_scales, gather_pages,
    )
    from specdec_tpu_torch.ops import paged_attention as pa

    other = (against[1] if against and against[0] == "paged_attention"
             else None)
    gen = torch.Generator(device=device).manual_seed(4321)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=device)
    records, max_err = {"bf16": [], "int8": []}, {"bf16": 0.0, "int8": 0.0}
    for label, B, T, page, MP, offsets, (Hq, Hk, Dh) in PAGED_SHAPES:
        NP = B * MP + 1
        clean = (1 + torch.randperm(NP - 1, generator=gen, device=device)
                 )[:B * MP].reshape(B, MP).to(torch.int32)
        table = poisoned(clean, offsets, T, page)
        off = torch.tensor(offsets, dtype=torch.int32, device=device)
        pools = [torch.randn((2, NP, Hk, page, Dh), generator=gen,
                             device=device) for _ in range(2)]
        (kq, kss), (vq, vss) = (quantize_kv_block(p) for p in pools)
        for fmt in ("bf16", "int8"):
            for dtype in (torch.float32, torch.bfloat16):
                q = torch.randn((B, T, Hq, Dh), generator=gen,
                                device=device).to(dtype)
                if fmt == "int8":
                    stack = (kq, kss, vq, vss)
                    layer = [a[1] for a in stack]

                    def k4(q, table, off):
                        return pa.paged_decode_attention_quant(
                            q, *layer, table, off)

                    def kern(q=q, table=table, off=off):
                        return pa.paged_decode_attention_quant_stacked(
                            q, *stack, 1, table, off)

                    def ref():
                        return pa.paged_attention_reference(
                            q, layer[0], layer[2], clean, off, layer[1],
                            layer[3])
                    pv_abs = pa.paged_attention_reference(
                        q.float(), layer[0], layer[2].abs(), clean, off,
                        layer[1], layer[3])
                else:
                    ks, vs = (p.to(dtype) for p in pools)

                    def k4(q, table, off):
                        return pa.paged_decode_attention(q, ks[1], vs[1],
                                                         table, off)

                    def kern(q=q, table=table, off=off):
                        return pa.paged_decode_attention_stacked(
                            q, ks, vs, 1, table, off)

                    def ref():
                        return pa.paged_attention_reference(
                            q, ks[1], vs[1], clean, off)
                    pv_abs = pa.paged_attention_reference(
                        q.float(), ks[1].float(), vs[1].float().abs(),
                        clean, off)
                got, plain = kern(), ref()
                torch.cuda.synchronize()
                what = f"paged {label} {fmt} pool, q {dtype}"
                if not torch.equal(k4(q, table, off), got):
                    fail(f"{what}: the stacked wrapper (layer 1) differs "
                         "from the 4D wrapper on that layer")
                rec = {"name": label, "pool": fmt,
                       "dtype": str(dtype).split(".")[-1], "B": B, "T": T,
                       "page": page, "MP": MP, "offsets": offsets,
                       "heads": [Hq, Hk, Dh],
                       **check_attention(what, got, plain,
                                         pv_abs if dtype == torch.bfloat16
                                         else None)}
                # a sequence's rows do not depend on the rest of its batch
                for b in range(B if B > 1 else 0):
                    one = kern(q[b:b + 1], table[b:b + 1], off[b:b + 1])
                    if not torch.equal(one, got[b:b + 1]):
                        fail(f"{what}: sequence {b} alone differs from the "
                             f"same sequence in the B={B} call")
                # nor a row's on T: the rows of a T=64 call against the
                # same rows of calls at smaller T
                q64 = torch.randn((B, 64, Hq, Dh), generator=gen,
                                  device=device).to(dtype)
                t64 = poisoned(clean, offsets, 64, page)
                full = kern(q64, t64)
                for t in PAGED_ROW_CHECK_T:
                    if not torch.equal(kern(q64[:, :t].contiguous(), t64),
                                       full[:, :t]):
                        fail(f"{what}: rows of the T={t} call differ from "
                             "the same rows of the T=64 call")
                err = rec["max_abs_err"]
                max_err[fmt] = max(max_err[fmt], err)
                if dtype == torch.bfloat16:
                    # yardstick: SDPA over K/V gathered (dequantized for
                    # int8) and GQA-expanded beforehand, the same mask;
                    # only the SDPA call is timed
                    if fmt == "int8":
                        lib = sdpa_args(
                            q, gather_pages(kq[1], clean),
                            gather_pages(vq[1], clean), off,
                            gather_page_scales(kss[1], clean),
                            gather_page_scales(vss[1], clean))
                    else:
                        lib = sdpa_args(q, gather_pages(ks[1], clean),
                                        gather_pages(vs[1], clean), off)
                    b, by = paged_bound_ms(B, T, Hq, Hk, Dh, page, MP,
                                           offsets, int8=fmt == "int8")
                    rec.update(
                        ms=gpu_ms(kern, flush), plain_ms=gpu_ms(ref, flush),
                        library_ms=gpu_ms(
                            lambda: F.scaled_dot_product_attention(
                                lib[0], lib[1], lib[2], attn_mask=lib[3]),
                            flush),
                        bound_ms=b, bound_by=by)
                    # the other source in turns with the checkout's (this,
                    # other, other, this)
                    against_txt = ""
                    if other is not None:
                        with launching("paged_attention", other):
                            check_attention(f"other source {what}", kern(),
                                            plain, pv_abs)
                            rec["against_ms"] = min(gpu_ms(kern, flush)
                                                    for _ in (0, 1))
                        rec["ms"] = min(rec["ms"], gpu_ms(kern, flush))
                        against_txt = (f" (other source "
                                       f"{rec['against_ms'] * 1e3:.1f})")
                    say(f"[3b paged] {label:12s} {fmt} B={B} T={T:2d} "
                        f"page={page:3d} MP={MP:2d} Hq={Hq} Hk={Hk} Dh={Dh}: "
                        f"kernel {rec['ms'] * 1e3:7.1f} us{against_txt}, "
                        f"plain {rec['plain_ms'] * 1e3:7.1f} us, SDPA "
                        f"{rec['library_ms'] * 1e3:7.1f} us, bound "
                        f"{b * 1e3:5.2f} us ({by}); max abs err {err:.3g} "
                        f"({rec['max_ulps']:.0f} ulps at worst, "
                        f"{rec['within_1ulp']:.1%} within one; "
                        f"{rec['bound_ratio']:.2f} of the allowance)")
                records[fmt].append(rec)
    n = sum(map(len, records.values()))
    say(f"[3b paged] all {n} comparisons within tolerance: "
        f"{tol_summary(records['bf16'] + records['int8'])}; tables poisoned "
        f"past each sequence's last live page (entry {POISON}); stacked == "
        "4D bit for bit, for bf16/f32 and int8 pools; rows independent of "
        f"T (T in {PAGED_ROW_CHECK_T} against 64) and of the batch (each "
        "sequence alone at B=1), bit for bit")
    return records, max_err


def flash_bound_ms(B, S, T, Hq, Hk, Dh, offsets, int8):
    """``attention_bound_ms`` of a flash-decode call: each sequence's live
    positions min(offset + T, S) and the offsets; the keys each query
    attends are offset+t+1."""
    live = sum(min(o + T, S) for o in offsets)
    keys = sum(min(o + t + 1, S) for o in offsets for t in range(T))
    return attention_bound_ms(live, B, T, Hq, Hk, Dh, keys, int8, B * 4)


def phase_flash_kernel(device, against=None):
    """The flash-decode kernel vs its plain version at FLASH_SHAPES: over
    K/V of q's type (K3) and over int8 K/V quantized from the same random
    K/V (K4), q in float32 and bf16; checks that a query row's result does
    not depend on T, nor a sequence's on the others of its batch; and K3/K4
    against the paged kernels K8a/K8b over the same keys laid out in pages
    of 64, bit for bit.
    ``against``: build_against's (NAME, library); where NAME is
    ``decode_attention``, that library is held to the same tolerance and
    timed in turns with the checkout's. Returns the per-shape records of each kernel (timed in
    bf16) and each kernel's largest absolute error."""
    from specdec_tpu_torch.core.cache import quantize_kv_block
    from specdec_tpu_torch.ops import decode_attention as da
    from specdec_tpu_torch.ops import paged_attention as pa

    other = (against[1] if against and against[0] == "decode_attention"
             else None)
    gen = torch.Generator(device=device).manual_seed(5678)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=device)
    records, max_err = {"K3": [], "K4": []}, {"K3": 0.0, "K4": 0.0}

    def run(kernel, q, k, v, off, quant):
        if kernel == "kernel":
            return (da.flash_decode_attention_quant(q, k[0], k[1], v[0], v[1],
                                                    off) if quant else
                    da.flash_decode_attention(q, k, v, off))
        return (da.decode_attention_reference(q, k[0], v[0], off, k[1], v[1])
                if quant else da.decode_attention_reference(q, k, v, off))

    def pv_abs(q, k, v, off, quant):
        """The plain version's attention of |V| in float32 (the scale of
        the bf16 allowance, see BF16_U)."""
        if quant:
            return da.decode_attention_reference(q.float(), k[0], v[0].abs(),
                                                  off, k[1], v[1])
        return da.decode_attention_reference(q.float(), k.float(),
                                             v.float().abs(), off)

    def seq(x, b):
        """Sequence b of a batched argument (K/V with scales: a pair)."""
        if isinstance(x, tuple):
            return tuple(seq(a, b) for a in x)
        return x[b:b + 1].contiguous()

    for label, B, S, T, offsets, (Hq, Hk, Dh) in FLASH_SHAPES:
        off = torch.tensor(offsets, dtype=torch.int32, device=device)
        kf, vf = (torch.randn((B, S, Hk, Dh), generator=gen, device=device)
                  for _ in range(2))
        kq, vq = quantize_kv_block(kf), quantize_kv_block(vf)
        for name, quant in (("K3", False), ("K4", True)):
            for dtype in (torch.float32, torch.bfloat16):
                q = torch.randn((B, T, Hq, Dh), generator=gen,
                                device=device).to(dtype)
                k, v = (kq, vq) if quant else (kf.to(dtype), vf.to(dtype))
                got = run("kernel", q, k, v, off, quant)
                plain = run("plain", q, k, v, off, quant)
                torch.cuda.synchronize()
                what = f"flash {label} {name} q {dtype}"
                pv = (pv_abs(q, k, v, off, quant)
                      if dtype == torch.bfloat16 else None)
                rec = {"name": label, "kernel": name,
                       "dtype": str(dtype).split(".")[-1], "B": B, "S": S,
                       "T": T, "offsets": offsets, "heads": [Hq, Hk, Dh],
                       **check_attention(what, got, plain, pv)}
                # a sequence's rows do not depend on the rest of its batch
                for b in range(B if B > 1 else 0):
                    one = run("kernel", seq(q, b), seq(k, b), seq(v, b),
                              seq(off, b), quant)
                    if not torch.equal(one, got[b:b + 1]):
                        fail(f"{what}: sequence {b} alone differs from the "
                             f"same sequence in the B={B} call")
                err = rec["max_abs_err"]
                max_err[name] = max(max_err[name], err)
                if dtype == torch.bfloat16:
                    # yardstick: SDPA over the live K/V (positions below
                    # max(offsets) + T), dequantized beforehand for int8
                    n = min(max(offsets) + T, S)
                    lib = sdpa_args(q, *((k[0][:, :n], v[0][:, :n], off,
                                          k[1][:, :n], v[1][:, :n])
                                         if quant else
                                         (k[:, :n], v[:, :n], off)))
                    b, by = flash_bound_ms(B, S, T, Hq, Hk, Dh, offsets,
                                           quant)

                    def kern():
                        return run("kernel", q, k, v, off, quant)

                    rec.update(
                        ms=gpu_ms(kern, flush),
                        plain_ms=gpu_ms(
                            lambda: run("plain", q, k, v, off, quant), flush),
                        library_ms=gpu_ms(
                            lambda: F.scaled_dot_product_attention(
                                lib[0], lib[1], lib[2], attn_mask=lib[3]),
                            flush),
                        bound_ms=b, bound_by=by)
                    # the other source in turns with the checkout's (this,
                    # other, other, this)
                    against_txt = ""
                    if other is not None:
                        with launching("decode_attention", other):
                            check_attention(f"other source {what}", kern(),
                                            plain, pv)
                            rec["against_ms"] = min(gpu_ms(kern, flush)
                                                  for _ in (0, 1))
                        rec["ms"] = min(rec["ms"], gpu_ms(kern, flush))
                        against_txt = (f" (other source "
                                       f"{rec['against_ms'] * 1e3:.1f})")
                    say(f"[3c flash] {label:14s} {name} B={B} S={S} T={T:3d} "
                        f"Dh={Dh}: kernel {rec['ms'] * 1e3:7.1f} us"
                        f"{against_txt}, plain {rec['plain_ms'] * 1e3:7.1f} "
                        f"us, SDPA {rec['library_ms'] * 1e3:7.1f} us, bound "
                        f"{b * 1e3:5.2f} us ({by}); max abs err {err:.3g} "
                        f"({rec['max_ulps']:.0f} ulps at worst, "
                        f"{rec['within_1ulp']:.1%} within one; "
                        f"{rec['bound_ratio']:.2f} of the allowance)")
                records[name].append(rec)

    # a row's result does not depend on T: the rows of a T=64 call against
    # the same rows (same positions) of calls at smaller T (the kernel runs
    # the T=64 call in one block per row tile, the others in clusters)
    Hq, Hk, Dh = PAIR_HEADS

    def as_pages(a, S):
        """[1, S, Hk(, Dh)] -> a one-layer pool [1, MP + 1, Hk, page(, Dh)]
        whose page p + 1 holds positions p * page ..; page 0 and the tail
        past S are zero."""
        MP = -(-S // PAGE)
        pad = torch.zeros((MP * PAGE,) + a.shape[2:], dtype=a.dtype,
                          device=device)
        pad[:S] = a[0]
        pool = pad.reshape(MP, PAGE, *a.shape[2:]).transpose(1, 2)
        return torch.cat([torch.zeros_like(pool[:1]), pool])[None].contiguous()

    for S, o in ROW_CHECK_S:
        off = torch.tensor([o], dtype=torch.int32, device=device)
        kf, vf = (torch.randn((1, S, Hk, Dh), generator=gen, device=device)
                  for _ in range(2))
        kq, vq = quantize_kv_block(kf), quantize_kv_block(vf)
        MP = -(-S // PAGE)
        table = torch.arange(1, MP + 1, dtype=torch.int32, device=device)[None]
        for name, quant in (("K3", False), ("K4", True)):
            for dtype in (torch.float32, torch.bfloat16):
                k, v = (kq, vq) if quant else (kf.to(dtype), vf.to(dtype))
                q = torch.randn((1, 64, Hq, Dh), generator=gen,
                                device=device).to(dtype)
                pools = tuple(as_pages(a, S) for a in (
                    (k[0], k[1], v[0], v[1]) if quant else (k, v)))

                def paged(q):
                    if quant:
                        return pa.paged_decode_attention_quant_stacked(
                            q, *pools, 0, table, off)
                    return pa.paged_decode_attention_stacked(
                        q, *pools, 0, table, off)

                full = run("kernel", q, k, v, off, quant)
                for T in ROW_CHECK_T + (64,):
                    qt = q[:, :T].contiguous()
                    part = run("kernel", qt, k, v, off, quant)
                    if not torch.equal(part, full[:, :T]):
                        fail(f"flash {name} {dtype} S={S}: rows of the T={T} "
                             "call differ from the same rows of the T=64 "
                             "call")
                    # over the same keys laid out in pages of 64 (MP =
                    # ceil(S / 64): the same tiles, so the same spans), K3
                    # equals K8a and K4 equals K8b bit for bit
                    if not torch.equal(paged(qt), part):
                        fail(f"flash {name} {dtype} S={S} T={T}: the paged "
                             "kernel over the same keys in pages of "
                             f"{PAGE} differs from the flash-decode kernel")
    n = sum(map(len, records.values()))
    say(f"[3c flash] all {n} comparisons within tolerance: "
        f"{tol_summary(records['K3'] + records['K4'])}; rows independent of "
        f"T (T in {ROW_CHECK_T} against 64; S, offset in {ROW_CHECK_S}) and "
        "of the batch "
        "(each sequence alone at B=1 against the B=8 calls); K3 == K8a and "
        f"K4 == K8b bit for bit over the same keys in pages of {PAGE} (T in "
        f"{ROW_CHECK_T + (64,)}; S in {[S for S, _ in ROW_CHECK_S]})")
    return records, max_err


def phase_serve_oracle(device, label="bf16 KV", kind=None, **cfg_kw):
    """The default serving engine, self-draft greedy on a float32 model in
    the configuration ``cfg_kw``, equals greedy AR per request with
    acceptance 1.0; then again with prefix caching and chunked prefill
    (chunks of 64, so partial admissions attend through the paged kernel
    at T=64). Under int8 KV both sides read the same quantized state
    (quantized from K/V that agree to f32 summation order). Dense float32
    weights (``kind`` None) keep every product in float32: the engine and
    AR then differ only in summation order (the kernel against dense
    attention, batched against single-row matmuls), ~1e-6 of a logit, far
    below the gap between the top two logits. Quantized weights (``kind``)
    put every projection on its kernel, whose bf16 outputs round the logits
    to bf16: a request may then part from AR at a tie of the top two
    within two bf16 ulps, as phase 4 allows (``greedy_tie``)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.model import init_params
    from specdec_tpu_torch.quant.core import quantize_params
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )
    from specdec_tpu_torch.serve import DefaultBatcher

    cfg = bench.target_config(num_layers=2, dtype=torch.float32, **cfg_kw)
    gen = torch.Generator(device=device).manual_seed(2)
    params = init_params(cfg, scale=0.02, device=device, generator=gen)
    if kind is not None:
        params = quantize_params(params, kind=kind, fuse=True)
        label = f"{kind} weights, {label}"
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
    for case, prompts, kw in cases:
        b = DefaultBatcher(cfg, params, cfg, params, num_slots=4, gamma=4,
                           max_prompt_len=256, max_new_tokens=new,
                           page_size=64, eos_tokens_id=(), device=device,
                           **kw)
        ids = [b.submit(p) for p in prompts]
        done = b.run()
        ties = []
        for i, (rid, p) in enumerate(zip(ids, prompts)):
            ar = autoregressive_generate(p, cfg, params, max_gen_len=new,
                                         eos_tokens_id=(), device=device)
            got = done[rid]
            what = f"serve oracle ({label}, {case}), request {i}"
            if len(ar) != new or len(got.output_ids) != new:
                fail(f"{what}: {len(got.output_ids)} tokens, AR {len(ar)}; "
                     f"expected {new}")
            if got.output_ids != ar:
                if kind is None:
                    fail(f"{what}: gave {got.output_ids} where greedy AR "
                         f"gives {ar}")
                ties.append(greedy_tie(what, cfg, params, p, ar,
                                       got.output_ids, device)[0])
            elif got.metrics.acceptance_rate != 1.0:
                fail(f"{what}: acceptance {got.metrics.acceptance_rate}, "
                     "not 1.0")
        if len(b._alloc_t.free) + len(b.prefix_cache) != b.num_pages - 1:
            fail(f"serve oracle ({label}, {case}): pages not returned")
        if kw and b.prefix_cache.hit_tokens == 0:
            fail(f"serve oracle ({label}, {case}): no prefix-cache hit")
        say(f"[4b serve oracle] {label}, {case}: {len(prompts)} requests on "
            f"4 slots == greedy AR ({new} tokens each), acceptance 1.0"
            + (f", except {len(ties)} parting at a bf16 tie (tokens {ties})"
               if ties else "")
            + f"; prefix hit tokens {b.prefix_cache.hit_tokens}")


def kernel_wrappers():
    """Every kernel wrapper of the port, by the short name of the TPU
    kernel it replaces. The weight kernels have a 2D wrapper (a: the
    lm_head) and a stacked one (b: layer i of a stack); for K7, whose TPU
    kernel is one, they are K7a and K7b here."""
    from specdec_tpu_torch.ops import decode_attention as da
    from specdec_tpu_torch.ops import paged_attention as pa
    from specdec_tpu_torch.ops import quant_matmul as qm

    return {"K1b": qm.int4_matmul_stacked, "K1a": qm.int4_matmul,
            "K6b": qm.q4_halfplane_matmul_stacked,
            "K6a": qm.q4_halfplane_matmul,
            "K7b": qm.int8_matmul_stacked, "K7a": qm.int8_matmul,
            "K2": pa.paged_decode_attention,
            "K8a": pa.paged_decode_attention_stacked,
            "K5": pa.paged_decode_attention_quant,
            "K8b": pa.paged_decode_attention_quant_stacked,
            "K3": da.flash_decode_attention,
            "K4": da.flash_decode_attention_quant}


def reset_launches():
    for w in kernel_wrappers().values():
        w.launches = 0


def launches():
    return {k: w.launches for k, w in kernel_wrappers().items()}


# the weight formats besides INT4, with kernels K7 (int8) and K6 (nf4, fp4)
QUANTS = ("int8", "nf4", "fp4")
WEIGHT_KERNELS = {"int4": ("K1b", "K1a"), "nf4": ("K6b", "K6a"),
                  "fp4": ("K6b", "K6a"), "int8": ("K7b", "K7a")}


def weight_kernels(params):
    """(stacked, 2D) kernel of a model's weight format: the one every layer
    projection launches and the one its lm_head launches."""
    return WEIGHT_KERNELS[weight_format(params["lm_head"])[0]]


def slotted_attention_kernel(cfg):
    """The kernel a slotted forward of ``cfg`` attends through (None: the
    plain attention)."""
    if cfg.attention_impl != "flash":
        return None
    return "K4" if cfg.kv_quant == "int8" else "K3"


def phase_main(pair, device, label="bf16 KV"):
    """The main path with launch counts: every projection on the stacked
    kernel of the weight format (K1b for INT4, K6b for NF4/FP4, K7b for
    INT8) and the lm_head on its 2D kernel, and, under
    ``attention_impl="flash"``, every attention on K3 (bf16 KV) or K4 (int8
    KV); no other kernel launches. Returns its summary and the launch
    counts of this run."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.sampling.processors import MultinomialProcessor

    t_cfg, d_cfg, target, drafter = pair
    reps = MAIN_REPS
    proc = MultinomialProcessor(temperature=1.0)
    prompt = bench.bench_prompt()
    stacked, two_d = weight_kernels(target)
    per_fwd = {stacked: 4 * t_cfg.num_layers, two_d: 1}
    per_draft = {stacked: 4 * d_cfg.num_layers, two_d: 1}
    attn = slotted_attention_kernel(t_cfg)
    if attn is not None:
        per_fwd[attn] = t_cfg.num_layers
        per_draft[attn] = d_cfg.num_layers

    reset_launches()
    gen, gamma = bench.GEN, bench.GAMMA
    ar = bench.measure_ar(t_cfg, target, prompt, gen, proc, device,
                          reps=reps)
    ar_counts = launches()
    spec = bench.measure_spec(d_cfg, drafter, t_cfg, target, prompt, gen,
                              gamma, proc, device, reps=reps)
    total = launches()

    for runs in (ar["runs"], spec["runs"]):
        # the warm-up call runs bench.WARM_GEN tokens, the timed ones gen
        for run, n in zip(runs, [bench.WARM_GEN] + [gen] * reps):
            if run["tokens"] != n or not all(0 <= t < bench.V
                                             for t in run["ids"]):
                fail(f"main path ({label}): {run['tokens']} tokens "
                     f"(expected {n}) or a token outside the vocabulary")
    for run in spec["runs"]:
        if not 0.0 < run["acceptance"] <= 1.0:
            fail(f"main path ({label}): acceptance {run['acceptance']}")
    ar_tokens = sum(r["tokens"] for r in ar["runs"])
    windows = sum(r["windows"] for r in spec["runs"])
    n_spec = len(spec["runs"])
    for kind in total:
        # AR: the prefill yields token 1, one forward for each later token
        want_ar = per_fwd.get(kind, 0) * ar_tokens
        # spec: target and drafter prefill, then per window gamma drafter
        # forwards and one target verify
        want_spec = (n_spec * (per_fwd.get(kind, 0) + per_draft.get(kind, 0))
                     + windows * (gamma * per_draft.get(kind, 0)
                                  + per_fwd.get(kind, 0)))
        if ar_counts[kind] != want_ar:
            fail(f"main path ({label}): {ar_counts[kind]} {kind} launches in "
                 f"AR, expected {want_ar}")
        if total[kind] - ar_counts[kind] != want_spec:
            fail(f"main path ({label}): {total[kind] - ar_counts[kind]} "
                 f"{kind} launches in spec, expected {want_spec}")
    per_token = dict(per_fwd)
    per_window = {k: gamma * per_draft[k] + per_fwd[k] for k in per_fwd}
    best_ar = min(ar["runs"][1:], key=lambda r: r["seconds"])
    best_spec = min(spec["runs"][1:], key=lambda r: r["seconds"])
    summary = {
        "config": label, "quant": weight_format(target["lm_head"])[0],
        "kv_quant": t_cfg.kv_quant, "attention_impl": t_cfg.attention_impl,
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
                     "total": {k: n for k, n in total.items() if n}},
        "gamma": gamma, "gen": gen, "reps": reps,
        "device": torch.cuda.get_device_name(0)}
    say(f"[5 main] {label}: AR {summary['ar_tok_s']:.1f} tok/s, spec "
        f"{summary['spec_tok_s']:.1f} tok/s ({summary['speedup']:.3f}x), "
        f"acceptance {summary['acceptance']:.3f}; launches as implied: "
        f"{per_token} per AR token, {per_window} per window")
    return summary, total


def phase_profile(pair, summary, device, config="bf16 KV"):
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
        return steps, device_times(prof)

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
            say(f"[5 profile] {config}, {label}: device time not measured "
                "(the profiler recorded no CUDA activity)")
            out[label] = None
            continue
        out[label] = {"device_ms_per_step": per_step,
                      "wall_ms_per_step": wall,
                      "busy_share": per_step / wall, "top": diff[:6],
                      "port": port_kernels(diff)}
        say(f"[5 profile] {config}, {label}: device {per_step:.3f} ms per "
            f"{'token' if label == 'ar' else 'window'} of {wall:.3f} ms "
            f"wall (busy {per_step / wall:.1%}); top: " + "; ".join(
                f"{k} {t:.3f} ms" for k, t in diff[:4]) + "; port kernels: "
            + "; ".join(f"{k} {t:.3f} ms" for k, t in port_kernels(diff)))
    return out


# kernel_label's names of the port's kernels
PORT_KERNEL_LABELS = ("int4_pair_matmul", "q4_halfplane_matmul",
                      "int8_matmul", "flash_decode_kernel")


def kernel_label(key):
    """A profiler key, shortened: the port's kernels by what they are (the
    attention kernel's instantiations by key layout, paged K2/K8a and
    K5/K8b or slotted K3/K4, and K/V type), others to their first 48
    characters."""
    for name in ("int4_pair_matmul", "q4_halfplane_matmul", "int8_matmul"):
        if name in key:
            return name
    if "flash_decode_kernel" in key:
        layout = "paged" if "Paged" in key else "slotted"
        kv = "int8" if "signed char" in key else (
            "bf16" if key.count("bfloat16") > 1 else "f32")
        return f"flash_decode_kernel[{layout}, {kv} K/V]"
    return key[:48]


def port_kernels(times):
    """The port's own kernels among (label, time) pairs, in their order."""
    return [(k, t) for k, t in times
            if k.split("[")[0] in PORT_KERNEL_LABELS]


def device_times(prof):
    """Device µs by ``kernel_label`` (instantiations of one kernel summed)
    from a torch.profiler run: the durations of its CUDA events (kernels,
    copies, sets), read straight from the kineto results. A device event
    has no children, so this is the self device time ``key_averages()``
    reports, without building the profiler's event tree, which takes most
    of a profiled serving pass's time."""
    times = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            key = kernel_label(e.name())
            times[key] = times.get(key, 0.0) + e.duration_ns() / 1e3
    return times


def serving_busy(batcher, device):
    """Device busy share of one more serving pass on ``batcher``:
    torch.profiler's CUDA kernel time over the pass's wall time (under the
    profiler, whose own overhead lengthens the wall time a little)."""
    from torch.profiler import ProfilerActivity, profile

    from specdec_tpu_torch import bench

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec = bench.serve_pass(batcher, bench.serving_prompts())
    totals = sorted(((k, t / 1e3) for k, t in device_times(prof).items()),
                    key=lambda kv: -kv[1])
    device_ms = sum(t for _, t in totals)
    if device_ms <= 0:
        return None
    wall_ms = rec["seconds"] * 1e3
    return {"device_ms": device_ms, "wall_ms": wall_ms,
            "busy_share": device_ms / wall_ms, "top": totals[:6],
            "port": port_kernels(totals)}


def phase_serve(pair, device, label="bf16 KV", engines=("paged", "slotted")):
    """The serving main path: the paged engine and (unless ``engines``
    leaves it out) the slotted one, each with the launch counts of its own
    passes. The paged engine's target attends through K8a (bf16 KV) or K8b
    (int8 KV), 22 launches per paged forward; under
    ``attention_impl="flash"`` every slotted forward (the hybrid drafter's
    steps, the dense admissions, all of the slotted engine's forwards)
    attends through K3 or K4. Every forward runs its projections on the
    weight format's stacked kernel and its lm_head on the 2D one. Returns
    (summary, launches summed over the engines)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core import model as tmodel

    t_cfg, d_cfg = pair[0], pair[1]
    L, Ld, gamma = t_cfg.num_layers, d_cfg.num_layers, bench.SERVE_GAMMA
    paged_kernel = "K8b" if t_cfg.kv_quant == "int8" else "K8a"
    attn = slotted_attention_kernel(t_cfg)
    w_stacked, w_2d = weight_kernels(pair[2])
    runs, by_engine = [], {}
    for engine in engines:
        reset_launches()
        tmodel.forward_step_paged.calls = 0
        t0 = time.perf_counter()
        runs.append(bench.measure_serving(engine == "paged", pair, device))
        by_engine[engine] = dict(
            launches(), paged_forwards=tmodel.forward_step_paged.calls)
        say(f"[time] {label}, {engine}: two passes in "
            f"{time.perf_counter() - t0:.1f} s")
    total = {k: sum(c[k] for c in by_engine.values())
             for k in kernel_wrappers()}
    paged_forwards = by_engine["paged"]["paged_forwards"]

    for r in runs:
        for name in ("warm", "timed"):
            outs = r[name]["outputs"]
            if len(outs) != bench.SERVE_REQUESTS or any(
                    len(o) != bench.SERVE_GEN or not all(
                        0 <= t < bench.V for t in o) for o in outs):
                fail(f"serve ({label}, {r['engine']}, {name}): not every "
                     f"request completed {bench.SERVE_GEN} in-vocabulary "
                     "tokens")
            if not 0.0 < r[name]["acceptance"] <= 1.0:
                fail(f"serve ({label}, {r['engine']}, {name}): acceptance "
                     f"{r[name]['acceptance']}")
    b = runs[0]["batcher"]
    if len(b._alloc_t.free) != b.num_pages - 1:
        fail(f"serve ({label}): {len(b._alloc_t.free)} of {b.num_pages - 1} "
             "pages back in the pool")
    if b.max_pages_per_seq != SERVE_TABLE_PAGES:
        fail(f"serve ({label}): table width {b.max_pages_per_seq}, phase 3b "
             f"timed {SERVE_TABLE_PAGES}")
    # what the code implies: the paged engine verifies through the paged
    # kernel (every paged forward is the target's: the drafter is slotted),
    # drafts gamma slotted 4-layer steps per window and admits densely (a
    # 22-layer and a 4-layer slotted prefill per admission, preempted
    # requests again); the slotted engine runs gamma drafter steps and a
    # 22-layer verify per window
    admissions = 2 * bench.SERVE_REQUESTS + runs[0]["preemptions"]
    per_admission = L + Ld
    want_paged = {k: 0 for k in kernel_wrappers()}
    want_paged[paged_kernel] = L * paged_forwards
    if attn is not None:
        want_paged[attn] = (Ld * gamma * paged_forwards
                            + per_admission * admissions)
    # the same forwards, each with 4 projections per layer and one lm_head
    want_paged[w_stacked] = 4 * (L * paged_forwards
                                 + Ld * gamma * paged_forwards
                                 + per_admission * admissions)
    want_paged[w_2d] = (1 + gamma) * paged_forwards + 2 * admissions
    got_paged = {k: by_engine["paged"][k] for k in want_paged}
    if paged_forwards == 0 or got_paged != want_paged:
        fail(f"serve ({label}, paged): launches {got_paged} over "
             f"{paged_forwards} paged forwards and {admissions} admissions; "
             f"expected {want_paged}")
    slotted = by_engine.get("slotted")
    slotted_windows = None
    if slotted is not None:
        if any(slotted[k] for k in ("K2", "K8a", "K5", "K8b")):
            fail(f"serve ({label}, slotted): paged attention launches "
                 f"{slotted}")
        if slotted[w_stacked] == 0 or slotted[w_2d] == 0 or any(
                slotted[k] for k in sum(WEIGHT_KERNELS.values(), ())
                if k not in (w_stacked, w_2d)):
            fail(f"serve ({label}, slotted): weight kernel launches "
                 f"{slotted}")
        if attn is not None:
            n = slotted[attn] - per_admission * 2 * bench.SERVE_REQUESTS
            per_window = Ld * gamma + L
            if n <= 0 or n % per_window:
                fail(f"serve ({label}, slotted): {slotted[attn]} {attn} "
                     f"launches are not {per_admission} per admission plus "
                     f"{per_window} per window")
            slotted_windows = n // per_window

    summary = {r["engine"]: {k: r["timed"][k] for k in (
        "tok_s", "ttft_p50_ms", "ttft_p99_ms", "acceptance", "seconds",
        "tokens")} for r in runs}
    summary["config"] = label
    summary["paged"]["preemptions"] = runs[0]["preemptions"]
    summary["paged_forwards"] = paged_forwards
    summary["slotted_windows"] = slotted_windows
    summary["launches"] = {eng: {k: n for k, n in c.items() if n}
                           for eng, c in by_engine.items()}
    for r in runs:
        say(f"[6 serve] {label}, {r['engine']}: {r['timed']['tokens']} "
            f"tokens in {r['timed']['seconds']:.2f} s = "
            f"{r['timed']['tok_s']:.1f} tok/s, TTFT p50 "
            f"{r['timed']['ttft_p50_ms']:.0f} ms, p99 "
            f"{r['timed']['ttft_p99_ms']:.0f} ms, acceptance "
            f"{r['timed']['acceptance']:.3f} (warm-up pass "
            f"{r['warm']['tok_s']:.1f} tok/s)")
    compared = ""
    if slotted is not None:
        paged, slotted_pass = (r["timed"] for r in runs)
        # where the engines' greedy outputs first differ: the two attention
        # paths round differently in bf16, and a one-ulp difference flips a
        # near-tie of the bf16 logits, after which the continuations part
        agree = [next((i for i, (x, y) in enumerate(zip(a, c)) if x != y),
                      len(a))
                 for a, c in zip(paged["outputs"], slotted_pass["outputs"])]
        same = sum(n == bench.SERVE_GEN for n in agree)
        summary["paged_over_slotted"] = paged["tok_s"] / slotted_pass["tok_s"]
        summary["same_outputs"] = same
        summary["agreeing_prefix_tokens"] = agree
        compared = (
            f"paged/slotted {summary['paged_over_slotted']:.3f}; "
            f"{same}/{len(slotted_pass['outputs'])} requests with equal "
            f"outputs, agreeing prefixes of {min(agree)}-{max(agree)} tokens "
            f"(median {int(np.median(agree))}); slotted engine {attn} x "
            f"{slotted[attn] if attn else 0} ({slotted_windows} windows); ")
    say(f"[6 serve] {label}: {compared}{paged_forwards} paged forwards, "
        f"launches as implied: paged engine "
        f"{ {k: n for k, n in got_paged.items() if n} }; all pages returned; "
        f"preemptions {runs[0]['preemptions']}")
    # a profiled pass of the paged engine (the default) only, to keep the
    # run's time near 8 minutes
    summary["profile"] = {}
    for r in runs[:1]:
        t0 = time.perf_counter()
        busy = serving_busy(r["batcher"], device)
        say(f"[time] {label}, {r['engine']}: profiled pass in "
            f"{time.perf_counter() - t0:.1f} s")
        summary["profile"][r["engine"]] = busy
        if busy is None:
            say(f"[6 profile] {label}, {r['engine']}: device time not "
                "measured (the profiler recorded no CUDA activity)")
            continue
        say(f"[6 profile] {label}, {r['engine']}: device "
            f"{busy['device_ms']:.0f} ms of {busy['wall_ms']:.0f} ms wall "
            f"(busy {busy['busy_share']:.1%}); top: " + "; ".join(
                f"{k} {t:.0f} ms" for k, t in busy["top"][:4])
            + "; port kernels: " + "; ".join(
                f"{k} {t:.1f} ms" for k, t in busy["port"]))
    return summary, total


# ---------------------------------------------------------------------------
# Dispatch at head_dim 256, NASD, NASD serving and beam search
# ---------------------------------------------------------------------------

# a gemma-2B-shaped attention (8 query heads over 1 KV head of 256) at the
# pair's width, 2 layers: a head_dim the attention kernels do not take
DH256_HEADS = (8, 1, 256)
# NASD and beam search, tools/bench_nasd.py's protocol: greedy, n = 3,
# gamma 5; prompts from default_rng(3), the first of 60 tokens, the rest
# ragged, 40-60. The benchmark decodes 128 tokens; 64 here, one timed
# call after the warm one, and 32 tokens of beam search, so that the run
# holds the tree and EAGLE phases within its time
NASD_N, NASD_GAMMA, NASD_GEN = 3, 5, 64
NASD_BATCHES = (1, 4, 8)
NASD_TIMED = 1
# under int8 KV + flash (K4 in every verify): these variants only
NASD_INT8_VARIANTS = ("host native B=1 carried", "device table B=4")
# NASD serving: the serving phase's 16 prompts and 128 tokens, 8 slots
NASD_SLOTS = 8
BEAM_GEN, BEAM_WIDE = 32, 4
ATTENTION_KERNELS = ("K2", "K8a", "K5", "K8b", "K3", "K4")


def phase_dispatch(device):
    """Part of the port's dispatch that the kernels' limits decide: a model
    with head_dim 256 (gemma's; the attention kernels take at most 128)
    runs a prefill and a decode step through the slotted forward under
    ``attention_impl="flash"`` and through the paged forward with
    ``use_kernel=None``, over bf16 and int8 KV: no attention kernel
    launches, the logits are finite and equal the plain path's (``"xla"``,
    ``use_kernel=False``) bit for bit, and ``use_kernel=True`` raises
    before any launch."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core import model as tmodel
    from specdec_tpu_torch.core.cache import init_cache
    from specdec_tpu_torch.core.paged_cache import init_paged_cache

    Hq, Hk, Dh = DH256_HEADS
    base = bench.target_config(num_layers=2).replace(
        num_heads=Hq, num_kv_heads=Hk, head_dim=Dh)
    gen = torch.Generator(device=device).manual_seed(4)
    params = tmodel.init_params(base, scale=0.02, device=device,
                                generator=gen)
    prompt = torch.tensor([bench.bench_prompt(seed=4)], device=device)
    P, B, MP = prompt.shape[1], 1, 2
    step = torch.tensor([[17]], device=device)

    def run(forward, make_cache):
        cache = make_cache()
        logits, cache = forward(prompt, cache)
        out = [logits]
        logits, cache = forward(step, cache)
        return out + [logits]

    for kv in ("none", "int8"):
        cfg = base.replace(kv_quant=kv, attention_impl="flash")
        if tmodel.kernel_route(cfg):
            fail(f"dispatch: head_dim {Dh} routed to the attention kernels")

        def slotted(c):
            return lambda: init_cache(c, B, 128, device=device)

        def paged():
            cache = init_paged_cache(cfg, B, MP + 1, PAGE, MP, device=device)
            cache.page_table[0] = torch.arange(1, MP + 1, device=device)
            return cache

        results = {}
        for what, forward, make in (
                ("slotted flash", lambda t, c: tmodel.forward_step(
                    cfg, params, t, c), slotted(cfg)),
                ("slotted plain", lambda t, c: tmodel.forward_step(
                    cfg.replace(attention_impl="xla"), params, t, c),
                 slotted(cfg.replace(attention_impl="xla"))),
                ("paged", lambda t, c: tmodel.forward_step_paged(
                    cfg, params, t, c), paged),
                ("paged gather", lambda t, c: tmodel.forward_step_paged(
                    cfg, params, t, c, use_kernel=False), paged)):
            reset_launches()
            results[what] = run(forward, make)
            torch.cuda.synchronize()
            n = {k: v for k, v in launches().items()
                 if k in ATTENTION_KERNELS and v}
            if n:
                fail(f"dispatch ({kv} KV, {what}): attention kernels "
                     f"launched at head_dim {Dh}: {n}")
            if not all(bool(torch.isfinite(l).all())
                       for l in results[what]):
                fail(f"dispatch ({kv} KV, {what}): logits not finite")
        for a, b in (("slotted flash", "slotted plain"),
                     ("paged", "paged gather")):
            if not all(torch.equal(x, y)
                       for x, y in zip(results[a], results[b])):
                fail(f"dispatch ({kv} KV): {a} differs from {b}")
        reset_launches()
        try:
            tmodel.forward_step_paged(cfg, params, prompt, paged(),
                                      use_kernel=True)
        except ValueError:
            pass
        else:
            fail(f"dispatch ({kv} KV): use_kernel=True did not raise at "
                 f"head_dim {Dh}")
        if any(launches().values()):
            fail(f"dispatch ({kv} KV): use_kernel=True launched "
                 f"{launches()} before raising")
        say(f"[4c dispatch] head_dim {Dh} (Hq={Hq}, Hk={Hk}), {kv} KV, 2 "
            f"layers at D={cfg.hidden_size}: slotted flash forward == plain, "
            f"paged forward == gather path, prefill T={P} and a decode step, no "
            "attention kernel launched; use_kernel=True raised before any "
            "launch")


def nasd_prompts():
    rng = np.random.default_rng(3)
    lens = [60] + [int(n) for n in rng.integers(40, 61, size=7)]
    return [[int(t) for t in rng.integers(1, 32000, size=n)] for n in lens]


def teacher_forced(what, cfg, params, prompts, outs, device, shape,
                   root=False, step_cfg=None, max_ulps=2):
    """Every token of every output is the target's argmax over its own
    prefix, or within greedy_tie's two bf16 ulps below it, in a replay of
    the engine's computation: ``shape`` = (P, S, T, admit): the prompts
    padded to P and prefilled on a cache of S positions (each alone, as a
    serving admission, if ``admit``; else as one batch), then one forward
    of T rows a token, the committed token in row 0 and padding after it,
    row 0 read (a causal row reads nothing after it; each weight kernel's
    row is the same bits at every row count). A forward over the whole
    sequence at once is not such a replay: its attention reduces in
    another order, which moves a logit by more than the tie rule allows.
    ``root``: the engine re-forwards the prompt's last token in its first
    window (the tree loops), so the first token comes from such a forward
    too, not from the prefill. ``step_cfg``: the config of those forwards
    where it differs from the prefill's (a tree verify attends in the
    plain attention under every setting). ``max_ulps``: the largest gap
    allowed (TREE_REPLAY_ULPS for the tree engines). Returns (tokens
    checked, tokens not the argmax, largest gap in ulps)."""
    from specdec_tpu_torch.core.cache import init_cache, install_slot
    from specdec_tpu_torch.core.model import forward_step

    step_cfg = step_cfg or cfg
    P, S, T, admit = shape
    N, L = len(prompts), max(map(len, outs))
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=device)
    if max(map(len, prompts)) + L - 1 + T > S:
        fail(f"{what}: a replay of {L} tokens does not fit {S} positions")
    padded = torch.zeros((N, P), dtype=torch.int64, device=device)
    out_t = torch.zeros((N, L), dtype=torch.int64, device=device)
    live = torch.zeros((N, L), dtype=torch.bool, device=device)
    for i, (p, o) in enumerate(zip(prompts, outs)):
        padded[i, :len(p)] = torch.tensor(p)
        out_t[i, :len(o)] = torch.tensor(o)
        live[i, :len(o)] = True
    cache = init_cache(cfg, N, S, device=device)
    if admit:
        first = []
        for i in range(N):
            one = init_cache(cfg, 1, S, device=device)
            lg, one = forward_step(cfg, params, padded[i:i + 1], one)
            first.append(lg[0, len(prompts[i]) - 1])
            cache = install_slot(cache, one, i, len(prompts[i]))
        rows = torch.stack(first)
    else:
        lg, cache = forward_step(cfg, params, padded, cache)
        rows = lg[torch.arange(N, device=device), (lens - 1).long()]
    last = padded[torch.arange(N, device=device), (lens - 1).long()]
    gaps = []
    for j in range(L):
        if j or root:
            t_in = torch.zeros((N, T), dtype=torch.int64, device=device)
            t_in[:, 0] = out_t[:, j - 1] if j else last
            lg, cache = forward_step(step_cfg, params, t_in,
                                     cache.with_length(lens + j - 1))
            rows = lg[:, 0]
        rows = rows.float()
        top = rows.max(dim=-1).values
        gap = top - rows.gather(1, out_t[:, j:j + 1])[:, 0]
        ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30)))
                         - 7)
        gaps.append(torch.where(live[:, j], gap / ulp, 0.0))
    ratio = torch.stack(gaps, dim=1)                               # [N, L]
    if (ratio > max_ulps).any():
        # the first token past the tie rule, by position
        j, i = (ratio > max_ulps).t().nonzero()[0].tolist()
        fail(f"{what}: token {j} ({outs[i][j]}) of a sequence of prompt "
             f"length {len(prompts[i])} is {ratio[i, j].item():.2f} bf16 "
             f"ulps below the target's argmax over its prefix (at most "
             f"{max_ulps})")
    return (int(live.sum()), int((ratio > 0).sum()), ratio.max().item())


def check_greedy(what, cfg, params, prompts, refs, outs, device, parted):
    """Every output equals its greedy AR reference, or parts from it first
    at a top-two tie within two bf16 ulps (``greedy_tie``). A parted
    output is added to ``parted`` ({(prompt index, output): prompt}), for
    ``teacher_forced`` to check every token after the tie. Returns the
    tokens where a tie parted them."""
    ties = []
    for i, (p, ref, out) in enumerate(zip(prompts, refs, outs)):
        if len(out) != len(ref):
            fail(f"{what}, sequence {i}: {len(out)} tokens, AR {len(ref)}")
        if out != ref:
            ties.append(greedy_tie(f"{what}, sequence {i}", cfg, params, p,
                                   ref, out, device)[0])
            parted[(i, tuple(out))] = p
    return ties


def check_parted(what, cfg, params, parted, device, shape, **replay):
    """``teacher_forced`` over every distinct parted output, in one
    replay (``replay``: its ``root`` and ``step_cfg``); (0, 0, 0.0) if none
    parted. Returns its counts."""
    if not parted:
        return 0, 0, 0.0
    return teacher_forced(what, cfg, params, list(parted.values()),
                          [list(o) for _, o in parted], device, shape,
                          **replay)


def forced_note(forced):
    n, off, worst = forced
    return (f"the {n} tokens of the outputs parted from AR replayed in the "
            f"engine's shape: {off} not the argmax, the largest gap "
            f"{worst:.2f} bf16 ulps")


def forward_launches(what, counts, cfg, params, extra=()):
    """The launch counts of a run of target forwards: each forward launches
    the stacked weight kernel 4 * L times and the lm_head's once, and under
    the flash kernel the slotted attention kernel L times; nothing else
    launches (``extra``: kernels also allowed). Returns the forwards."""
    stacked, two_d = weight_kernels(params)
    L = cfg.num_layers
    forwards = counts[two_d]
    want = {k: 0 for k in counts}
    want[stacked], want[two_d] = 4 * L * forwards, forwards
    attn = slotted_attention_kernel(cfg)
    if attn is not None:
        want[attn] = L * forwards
    got = {k: n for k, n in counts.items() if k not in extra}
    if forwards == 0 or got != {k: want[k] for k in got}:
        fail(f"{what}: launches {counts}, expected {want} for {forwards} "
             "forwards")
    return forwards


def timed_call(fn):
    """(result, seconds) of one call, the card synchronized around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_nasd(pair, device, card, label="bf16 KV", variants=None):
    """NASD on the INT4 target at full width, greedy, tools/bench_nasd.py's
    protocol. Each variant (the host store in Python at B = 1, 4, 8, fresh
    each call as the benchmark has it; the C++ store at B=1, carried from
    call to call, so that drafts are accepted in part and the verify rolls
    the cache back; the device table at B = 1, 4, 8, carried, as the
    benchmark does) runs one warm call and NASD_TIMED timed ones; every
    call's tokens equal the greedy AR tokens of each prompt (a first
    parting only at a top-two bf16 tie, every distinct parted output then
    held token by token by ``teacher_forced``), and
    every call launches K1 (and, under int8 KV + flash, K4) per target
    forward as the forward implies. The references: prompt 0's from
    ``autoregressive_generate``, the batch's from the batched AR engine.
    Returns (summary, launches summed over the variants)."""
    from specdec_tpu_torch.engine.batch_engine import (
        batch_autoregressive_generate,
    )
    from specdec_tpu_torch.ngram import (
        NGramStorage, batch_ngram_assisted_generate,
        device_ngram_assisted_generate_batch,
        ngram_assisted_speculative_generate,
    )
    from specdec_tpu_torch.ngram.native import NativeNGramStorage
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )

    cfg, target = pair[0], pair[2]
    V = cfg.vocab_size
    prompts = nasd_prompts()
    kw = dict(gamma=NASD_GAMMA, eos_tokens_id=(), device=device)

    def host(store_cls, B, carry=False):
        def call(carried):
            store = (carried if carry and carried is not None
                     else store_cls(NASD_N, V))
            if B == 1:
                out, rate = ngram_assisted_speculative_generate(
                    prompts[0], store, cfg, target, max_gen_len=NASD_GEN,
                    **kw)
                return [out], [rate], store
            outs, rates = batch_ngram_assisted_generate(
                prompts[:B], store, cfg, target, gen_len=NASD_GEN, **kw)
            return outs, rates, store
        return call

    def table(B):
        def call(carried):
            return device_ngram_assisted_generate_batch(
                prompts[:B], cfg, target, n=NASD_N, table=carried,
                gen_len=NASD_GEN, **kw)
        return call

    all_variants = {f"host python B={B}": (host(NGramStorage, B), B)
                    for B in NASD_BATCHES}
    all_variants["host native B=1 carried"] = (
        host(NativeNGramStorage, 1, carry=True), 1)
    for B in NASD_BATCHES:
        all_variants[f"device table B={B}"] = (table(B), B)
    variants = variants or list(all_variants)

    t0 = time.perf_counter()
    n_refs = max(all_variants[v][1] for v in variants)
    refs = {1: [autoregressive_generate(prompts[0], cfg, target,
                                        max_gen_len=NASD_GEN,
                                        eos_tokens_id=(), device=device)]}
    if n_refs > 1:
        refs[n_refs] = batch_autoregressive_generate(
            prompts[:n_refs], cfg, target, gen_len=NASD_GEN,
            eos_tokens_id=(), device=device)
    say(f"[time] NASD ({label}): greedy AR references (prompt 0 alone"
        + (f", {n_refs} prompts batched" if n_refs > 1 else "")
        + f") in {time.perf_counter() - t0:.1f} s")
    summary, total, parted = {}, {k: 0 for k in kernel_wrappers()}, {}
    for name in variants:
        call, B = all_variants[name]
        carried, runs = None, []
        for i in range(1 + NASD_TIMED):
            reset_launches()
            (outs, rates, carried), seconds = timed_call(
                lambda: call(carried))
            counts = launches()
            what = f"NASD ({label}, {name}, call {i})"
            forwards = forward_launches(what, counts, cfg, target)
            ref = refs[1] if B == 1 else refs[n_refs][:B]
            ties = check_greedy(what, cfg, target, prompts[:B], ref, outs,
                                device, parted)
            for k in total:
                total[k] += counts[k]
            runs.append({"seconds": seconds,
                         "tokens": sum(len(o) for o in outs),
                         "acceptance": float(np.mean(rates)),
                         "windows": forwards - 1, "ties": ties,
                         "launches": {k: n for k, n in counts.items()
                                      if n}})
        best = max(runs[1:], key=lambda r: r["tokens"] / r["seconds"])
        rec = {"batch": B, "tok_s": best["tokens"] / best["seconds"],
               "acceptance": best["acceptance"], "windows": best["windows"],
               "runs": runs}
        summary[name] = rec
        say(f"[7 nasd] {label}, {name}: {rec['tok_s']:.1f} tok/s (best of "
            f"{NASD_TIMED} timed call(s) after a warm one; {card}), "
            f"acceptance {rec['acceptance']:.3f} ({runs[0]['acceptance']:.3f} "
            f"in the warm call), {rec['windows']} windows; launches per "
            f"call {best['launches']}; every call == greedy "
            "AR" + (f" but for bf16 ties at tokens "
                    f"{[r['ties'] for r in runs]}"
                    if any(r["ties"] for r in runs) else ""))
    # every variant prefills its batch at P = 64 on a cache of P + 128 +
    # gamma + 2 positions and verifies gamma + 1 rows a window
    P = 64 * max(1, -(-max(map(len, prompts)) // 64))
    shape = (P, P + NASD_GEN + NASD_GAMMA + 2, NASD_GAMMA + 1, False)
    forced = check_parted(f"NASD ({label})", cfg, target, parted, device,
                          shape)
    summary["parted_replay"] = forced
    say(f"[7 nasd] {label}: {len(parted)} distinct outputs parted from AR; "
        + forced_note(forced))
    return summary, total


def phase_nasd_serving(pair, device, card):
    """``NasdContinuousBatcher`` on the INT4 target: 8 slots, gamma 5, the
    serving phase's 16 prompts, 128 tokens each, greedy, at 1 and 4 windows
    per host sync; every request equals its greedy AR tokens (the batched
    AR engine over the same prompts; a first parting only at a top-two bf16
    tie), and both settings give the same tokens. Launches: K1 per target
    forward (an admission prefill or a window's verify). Returns (summary,
    launches summed over the passes)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.engine.batch_engine import (
        batch_autoregressive_generate,
    )
    from specdec_tpu_torch.serve import NasdContinuousBatcher

    cfg, target = pair[0], pair[2]
    prompts = bench.serving_prompts()
    t0 = time.perf_counter()
    refs = batch_autoregressive_generate(
        prompts, cfg, target, gen_len=bench.SERVE_GEN, eos_tokens_id=(),
        device=device)
    say(f"[time] NASD serving: greedy AR references (batched) in "
        f"{time.perf_counter() - t0:.1f} s")
    summary, total, outputs = {}, {k: 0 for k in kernel_wrappers()}, {}
    parted = {}
    for wps in (1, 4):
        b = NasdContinuousBatcher(
            cfg, target, num_slots=NASD_SLOTS, gamma=NASD_GAMMA, n=NASD_N,
            max_prompt_len=bench.SERVE_MAX_PROMPT,
            max_new_tokens=bench.SERVE_GEN, eos_tokens_id=(),
            windows_per_sync=wps, device=device)
        reset_launches()
        rec = bench.serve_pass(b, prompts)
        counts = launches()
        what = f"NASD serving (windows_per_sync {wps})"
        forwards = forward_launches(what, counts, cfg, target)
        windows = forwards - len(prompts)
        ties = check_greedy(what, cfg, target, prompts, refs,
                            rec["outputs"], device, parted)
        outputs[wps] = rec["outputs"]
        for k in total:
            total[k] += counts[k]
        stacked, two_d = weight_kernels(target)
        summary[f"windows_per_sync_{wps}"] = {
            **{k: rec[k] for k in ("tok_s", "ttft_p50_ms", "ttft_p99_ms",
                                   "acceptance", "seconds", "tokens")},
            "windows": windows, "ties": ties,
            "launches": {k: n for k, n in counts.items() if n}}
        say(f"[7b nasd serve] windows_per_sync {wps}: {rec['tokens']} tokens "
            f"in {rec['seconds']:.2f} s = {rec['tok_s']:.1f} tok/s ({card}), "
            f"TTFT p50 {rec['ttft_p50_ms']:.0f} ms, p99 "
            f"{rec['ttft_p99_ms']:.0f} ms, acceptance "
            f"{rec['acceptance']:.3f}, {windows} windows; K1 launches "
            f"{stacked} {counts[stacked]}, {two_d} {counts[two_d]} "
            f"({counts[stacked] / forwards:.0f} and 1 per target forward); "
            f"16 requests == greedy AR"
            + (f" but for bf16 ties at tokens {ties}" if ties else ""))
    if outputs[1] != outputs[4]:
        fail("NASD serving: windows_per_sync 1 and 4 gave different tokens")
    # an admission prefills one prompt padded to the longest on the
    # batcher's cache; a window verifies gamma + 1 rows a slot
    P = bench.SERVE_MAX_PROMPT
    forced = check_parted("NASD serving", cfg, target, parted, device,
                          (P, P + bench.SERVE_GEN + NASD_GAMMA + 2,
                           NASD_GAMMA + 1, True))
    summary["parted_replay"] = forced
    say(f"[7b nasd serve] {len(parted)} distinct outputs parted from AR; "
        + forced_note(forced))
    return summary, total


def phase_beam(pair, device, card):
    """``beam_search_generate`` on the INT4 target, prompt 0 of the NASD
    phase, BEAM_GEN tokens: one beam of one expansion equals greedy AR (up
    to its first pad token, which ends a beam; a first parting only at a
    top-two bf16 tie), BEAM_WIDE beams give the same tokens in two calls;
    per step one target forward over the beams (K1 at M = beams). Returns
    (summary, launches summed over the calls)."""
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate, beam_search_generate,
    )

    cfg, target = pair[0], pair[2]
    prompt = nasd_prompts()[0]
    ar = autoregressive_generate(prompt, cfg, target, max_gen_len=BEAM_GEN,
                                 eos_tokens_id=(), device=device)
    if 0 in ar:
        ar = ar[:ar.index(0) + 1]
    summary, total, outs = {}, {k: 0 for k in kernel_wrappers()}, []
    for beams, top_k, calls in ((1, 1, 1), (BEAM_WIDE, 3, 2)):
        for _ in range(calls):
            reset_launches()
            out, seconds = timed_call(lambda: beam_search_generate(
                prompt, cfg, target, max_gen_len=BEAM_GEN, num_beams=beams,
                top_k=top_k, eos_tokens_id=(), device=device))
            counts = launches()
            what = f"beam ({beams} beams)"
            steps = forward_launches(what, counts, cfg, target) - 1
            for k in total:
                total[k] += counts[k]
            outs.append(out)
        rec = {"beams": beams, "top_k": top_k, "tokens": len(out),
               "steps": steps, "ms_per_step": seconds / max(steps, 1) * 1e3,
               "seconds": seconds,
               "launches": {k: n for k, n in counts.items() if n}}
        if beams == 1:
            parted = {}
            rec["ties"] = check_greedy(what, cfg, target, [prompt], [ar],
                                       [out], device, parted)
            # one beam: a prefill at P = 64 on P + BEAM_GEN positions, then
            # one row a step
            rec["parted_replay"] = check_parted(
                what, cfg, target, parted, device,
                (64, 64 + BEAM_GEN, 1, False))
        elif outs[-1] != outs[-2]:
            fail(f"beam ({beams} beams): two calls gave different tokens")
        if not 1 <= len(out) <= BEAM_GEN:
            fail(f"beam ({beams} beams): {len(out)} tokens")
        summary[f"beams_{beams}"] = rec
        stacked, two_d = weight_kernels(target)
        say(f"[7c beam] {beams} beams, top_k {top_k}: {len(out)} tokens, "
            f"{steps} steps, {rec['ms_per_step']:.1f} ms per step ({card}); "
            f"K1 launches {stacked} {counts[stacked]}, {two_d} "
            f"{counts[two_d]} (M = {beams})"
            + (f"; == greedy AR; {forced_note(rec['parted_replay'])}"
               if beams == 1 else "; two calls gave the same tokens"))
    return summary, total


# ---------------------------------------------------------------------------
# Trees and EAGLE: oracles at 2 layers (4d), trees at full depth (8), EAGLE
# single sequence (8b), EAGLE batched and serving (8c)
# ---------------------------------------------------------------------------

# phase 4d: 2 layers at full widths, f32 activations, K1 on every
# projection, 64 tokens; a 1-layer prefix drafter and a 1-layer EAGLE head
ORACLE_TREES = ((2, 2, 1, 1), (3, 2, 1), (4, 2))
ORACLE_GEN = 64
# phase 8, tools/bench_tree.py's protocol: a 60-token prompt from
# default_rng(0) (bench.bench_prompt()), 256 tokens, greedy, at its two
# tail damps (the drafter strong and weak)
TREES = ((2, 2, 2), (3, 2, 1), (4, 2))
TREE_DAMPS = (0.08, 0.35)
TREE_GEN = 256
# the replay's tie rule for the tree engines. A tree verify sums each
# node's attention over its ancestors at their tree slots, with the
# other nodes' slots masked in between; the replay sums over contiguous
# positions. Where such a sum sits near a bf16 rounding boundary the two
# round apart, and 22 layers carry it on: on an H100 a parted token lay
# 3.00 ulps below the replay's argmax, where the sequential engines'
# replays (phases 7-7c) stay within 1
TREE_REPLAY_ULPS = 4
# phase 8b, tools/bench_eagle.py's protocol at 256 tokens (it decodes
# 512): an untrained depth-1 head made on the card from EAGLE_SEED
EAGLE_GAMMAS = (3, 5, 8)
EAGLE_GAMMA = 5
EAGLE_SEED = 7
# greedy chain EAGLE runs GreedyProcessor at this temperature: its
# softmaxes saturate, so a draft is accepted iff it is the target's argmax
# and a rejection commits the argmax, whatever the acceptance draws (at
# temperature 1 the draws decide, and the tokens are not greedy AR's)
GREEDY_T = 1e-4
# phase 8c: the serving phase's prompts and tokens, 8 slots, gamma 5
EAGLE_SLOTS = 8


def expect_launches(what, counts, params, cfg, forwards):
    """Fail unless ``counts`` are exactly what ``forwards`` launch: a list
    of (calls, quantized layers, lm_heads, attention layers) per kind of
    forward. Each quantized layer launches the weight format's stacked
    kernel 4 times, each lm_head its 2D kernel once, and each attention
    layer of a sequential forward the slotted attention kernel under
    ``attention_impl="flash"`` (tree forwards attend in the plain
    attention: 0). Nothing else launches."""
    stacked, two_d = weight_kernels(params)
    attn = slotted_attention_kernel(cfg)
    want = {k: 0 for k in counts}
    for calls, layers, heads, attn_layers in forwards:
        want[stacked] += 4 * layers * calls
        want[two_d] += heads * calls
        if attn is not None:
            want[attn] += attn_layers * calls
    if counts != want:
        fail(f"{what}: launches {counts}, expected {want}")
    return {k: n for k, n in counts.items() if n}


def tree_forwards(kind, t_cfg, d_cfg, topo, windows, gamma=None):
    """The forwards of one call of a tree or EAGLE loop, for
    ``expect_launches``. ``kind``: "tree" (the prefix drafter: both
    prefills, d drafter levels with logits and the last without, a tree
    verify a window), "eagle tree" (the target's prefill; a catch-up and
    d-1 tree levels of the dense head, a tree verify) or "eagle" (chain:
    a catch-up and gamma-1 steps of the head, a sequential verify)."""
    L, Ld = t_cfg.num_layers, d_cfg.num_layers
    if kind == "tree":
        d = topo.depth
        return [(1, L, 1, L), (1, Ld, 1, Ld), (windows * d, Ld, 1, 0),
                (windows, Ld, 0, 0), (windows, L, 1, 0)]
    if kind == "eagle tree":
        return [(1, L, 1, L), (windows, 0, 1, Ld),
                (windows * (topo.depth - 1), 0, 1, 0), (windows, L, 1, 0)]
    return [(1, L, 1, L), (windows * gamma, 0, 1, Ld), (windows, L, 1, L)]


def run_tree(kind, cfgs, params, prompt, topo, gen, device, processor=None,
             seed=0, gamma=None):
    """One call of a tree or EAGLE loop through its inner function (which
    also returns the windows). ``cfgs`` = (target config, drafter or head
    config); ``params`` = (target, drafter or head). Returns ((tokens,
    acceptance, windows), seconds)."""
    from specdec_tpu_torch.sampling.eagle_speculative import _eagle_generate
    from specdec_tpu_torch.sampling.eagle_tree import _eagle_tree_generate
    from specdec_tpu_torch.sampling.tree_speculative import (
        _tree_spec_generate,
    )

    (t_cfg, d_cfg), (target, drafter) = cfgs, params
    gen_t = torch.Generator(device=device).manual_seed(seed)

    def call():
        if kind == "eagle":
            out, acc, spec, log = _eagle_generate(
                prompt, d_cfg, drafter, t_cfg, target, gamma, gen, processor,
                (), True, False, gen_t, 0, device)
            return out, acc / spec if spec else 0.0, len(log)
        fn = _tree_spec_generate if kind == "tree" else _eagle_tree_generate
        out, acc, spec, windows = fn(prompt, d_cfg, drafter, t_cfg, target,
                                     topo, gen, (), processor, gen_t, 0,
                                     device)
        return out, acc / spec if spec else 0.0, windows
    return timed_call(call)


def phase_tree_oracle(device):
    """Greedy trees == greedy AR on the kernels (full widths, 2 layers,
    float32 activations, INT4 weights: K1 on every projection): the prefix
    drafter (the target's first layer) through ``tree_speculative`` and an
    untrained 1-layer EAGLE head through ``eagle_tree``, at each of
    ORACLE_TREES, a first parting allowed only at a top-two bf16 tie
    (``greedy_tie``); then (3, 2, 1) under int8 KV + flash and under bf16 +
    flash, where the launches show the flash-decode kernel (K4, K3) on
    every sequential forward and on no tree forward. Returns the launches
    summed by setting."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.eagle import init_eagle_params
    from specdec_tpu_torch.core.model import init_params
    from specdec_tpu_torch.quant.core import quantize_params
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )
    from specdec_tpu_torch.sampling.tree_speculative import _topology

    base = bench.target_config(num_layers=2, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(1)
    params = quantize_params(
        init_params(base, scale=0.02, device=device, generator=gen),
        kind="int4", fuse=True)
    drafter = dict(params, layers=bench.layer_views(params["layers"], 1))
    head = init_eagle_params(base.replace(num_layers=1), seed=EAGLE_SEED,
                             device=device)
    prompt = bench.bench_prompt(seed=1)
    totals = {}
    for label, kw, trees in (("bf16 KV", {}, ORACLE_TREES),
                             ("int8 KV, flash", KVINT8_FLASH, ((3, 2, 1),)),
                             ("bf16 KV, flash", FLASH, ((3, 2, 1),))):
        cfg = base.replace(**kw)
        d_cfg = cfg.replace(num_layers=1)
        ar = autoregressive_generate(prompt, cfg, params,
                                     max_gen_len=ORACLE_GEN,
                                     eos_tokens_id=(), device=device)
        total = totals.setdefault(label, {k: 0 for k in kernel_wrappers()})
        for br in trees:
            topo = _topology(br)
            for kind, second in (("tree", drafter), ("eagle tree", head)):
                what = f"tree oracle ({label}, {kind} {br})"
                reset_launches()
                (out, rate, windows), _ = run_tree(
                    kind, (cfg, d_cfg), (params, second), prompt, topo,
                    ORACLE_GEN, device)
                counts = launches()
                for k in total:
                    total[k] += counts[k]
                got = expect_launches(what, counts, params, cfg,
                                      tree_forwards(kind, cfg, d_cfg, topo,
                                                    windows))
                if len(out) != ORACLE_GEN:
                    fail(f"{what}: {len(out)} tokens, not {ORACLE_GEN}")
                tie = ""
                if out != ar:
                    i, gap, ulp = greedy_tie(what, cfg, params, prompt, ar,
                                             out, device)
                    tie = (f"; == AR for {i} tokens, then a tie within two "
                           f"bf16 ulps (gap {gap:.3g}, ulp {ulp:.3g})")
                say(f"[4d tree oracle] {label}, {kind} {br}: greedy == AR "
                    f"over {ORACLE_GEN} tokens{tie}; acceptance {rate:.3f}, "
                    f"{windows} windows; launches {got}")
    return totals


def phase_trees(pairs, device, card, refs):
    """Tree speculation on the 22-layer INT4 pair, tools/bench_tree.py's
    protocol: each of TREES at tail damp 0.08 and 0.35, (2, 2, 2) again
    under INT8 weights (K7) and under int8 KV + flash (K4 in the two
    prefills only), then a sampled (2, 2, 2) call twice from one seed (the
    same tokens). Each greedy configuration runs a warm and a timed call,
    each equal to greedy AR (``refs``: the AR tokens by setting, filled
    here) up to a first top-two bf16 tie; the distinct parted outputs are
    replayed in the engine's shape (a root re-forward, then N rows a token
    in the plain attention). Launches are checked per call. Returns
    (summary, launches by setting)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.sampling.processors import MultinomialProcessor
    from specdec_tpu_torch.sampling.tree_speculative import _topology

    prompt = bench.bench_prompt()
    damp35 = bench.build_pair(device, tail_damp=0.35)
    settings = {"damp 0.08": pairs["int4"], "damp 0.35": damp35,
                "int8 weights": pairs["int8"],
                "int8 KV, flash": with_config(pairs["int4"], **KVINT8_FLASH)}
    runs = [(f"damp {damp}", br, None) for damp in TREE_DAMPS for br in TREES]
    runs += [("int8 weights", (2, 2, 2), None),
             ("int8 KV, flash", (2, 2, 2), None),
             ("damp 0.08", (2, 2, 2), MultinomialProcessor(temperature=1.0))]
    summary, totals, parted = {}, {}, {}
    for setting, br, proc in runs:
        t_cfg, d_cfg, target, drafter = settings[setting]
        topo = _topology(br)
        if proc is None and setting not in refs:
            refs[setting] = greedy_ar(t_cfg, target, prompt, TREE_GEN,
                                      device)
        total = totals.setdefault(setting, {k: 0 for k in kernel_wrappers()})
        label = f"{setting}, {br}" + (", sampled" if proc else "")
        calls = []
        # a short warm call, then the timed one; the sampled configuration
        # runs two full calls from one seed, the first its warm-up
        for i, gen in enumerate((TREE_GEN if proc else bench.WARM_GEN,
                                  TREE_GEN)):
            reset_launches()
            (out, rate, windows), seconds = run_tree(
                "tree", (t_cfg, d_cfg), (target, drafter), prompt, topo,
                gen, device, proc, seed=100)
            counts = launches()
            for k in total:
                total[k] += counts[k]
            what = f"trees ({label}, call {i})"
            got = expect_launches(what, counts, target, t_cfg,
                                  tree_forwards("tree", t_cfg, d_cfg, topo,
                                                windows))
            if len(out) != gen or not all(0 <= t < bench.V for t in out):
                fail(f"{what}: {len(out)} tokens or one outside the "
                     "vocabulary")
            ties = ([] if proc else check_greedy(
                what, t_cfg, target, [prompt], [refs[setting][:gen]], [out],
                device, parted.setdefault(setting, {})))
            calls.append({"tokens": len(out), "seconds": seconds,
                          "acceptance": rate, "windows": windows,
                          "ties": ties, "launches": got, "ids": out})
        if proc and calls[0]["ids"] != calls[1]["ids"]:
            fail(f"trees ({label}): two calls from one seed gave different "
                 "tokens")
        timed = calls[1]
        stacked, two_d = weight_kernels(target)
        rec = {"tok_s": timed["tokens"] / timed["seconds"],
               "acceptance": timed["acceptance"],
               "windows": timed["windows"], "ties": timed["ties"],
               "warm_seconds": calls[0]["seconds"],
               "seconds": timed["seconds"], "launches": timed["launches"],
               "per_window": {
                   stacked: 4 * ((topo.depth + 1) * d_cfg.num_layers
                                 + t_cfg.num_layers),
                   two_d: topo.depth + 1}}
        summary[label] = rec
        say(f"[8 trees] {label}: {rec['tok_s']:.1f} tok/s ({card}), "
            f"chain-depth acceptance {rec['acceptance']:.3f}, "
            f"{rec['windows']} windows; launches {rec['launches']} "
            f"({rec['per_window']} a window, as implied)"
            + ("; two calls from one seed gave the same tokens" if proc
               else "; == greedy AR" + (f" but for bf16 ties at tokens "
                                        f"{timed['ties']}" if timed["ties"]
                                        else "")))
    for setting, outs in parted.items():
        forced = tree_replay(f"trees ({setting})", settings[setting][0],
                             settings[setting][2], outs, device)
        summary[f"{setting} parted_replay"] = forced
        if outs:
            say(f"[8 trees] {setting}: {len(outs)} distinct outputs parted "
                f"from AR; " + forced_note(forced))
    return summary, totals


def tree_replay(what, cfg, params, outs, device):
    """``check_parted`` for tree engines' outputs: the root re-forwarded,
    then a tree's 16 rows a token (the largest of TREES) in the plain
    attention, each token within TREE_REPLAY_ULPS of the argmax."""
    N = max(_nodes(br) for br in TREES)
    return check_parted(what, cfg, params, outs, device,
                        (64, 64 + TREE_GEN + N + 2, N, False), root=True,
                        step_cfg=cfg.replace(attention_impl="xla"),
                        max_ulps=TREE_REPLAY_ULPS)


def _nodes(branching):
    return int(sum(np.cumprod((1,) + tuple(branching))))


def greedy_ar(cfg, params, prompt, gen, device):
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )

    t0 = time.perf_counter()
    out = autoregressive_generate(prompt, cfg, params, max_gen_len=gen,
                                  eos_tokens_id=(), device=device)
    say(f"[time] greedy AR reference ({cfg.kv_quant} KV, "
        f"{cfg.attention_impl}, {weight_format(params['lm_head'])[0]}) in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_eagle(pair, device, card, refs):
    """EAGLE on the 22-layer INT4 target (tools/bench_eagle.py's protocol,
    256 tokens): an untrained depth-1 head made on the card from
    EAGLE_SEED, one warm-up call, then one timed call each of chain gamma
    3, 5, 8 (MultinomialProcessor(1.0)), chain gamma 5 greedy (at
    GREEDY_T) and the greedy trees of TREES; chain gamma 5 greedy and tree
    (2, 2, 2) again under int8 KV + flash. Greedy outputs equal greedy AR
    (``refs``) up to a first top-two bf16 tie, the parted ones replayed in
    the engine's shape. Launches: K1b per target forward, K1a per target
    and head forward, K4 per sequential forward of either under int8 KV +
    flash. Returns (summary, launches by setting, the head)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.eagle import init_eagle_params
    from specdec_tpu_torch.sampling.processors import (
        GreedyProcessor, MultinomialProcessor,
    )
    from specdec_tpu_torch.sampling.tree_speculative import _topology

    t_cfg, _, target, _ = pair
    e_cfg = t_cfg.replace(num_layers=1)
    head = init_eagle_params(e_cfg, seed=EAGLE_SEED, device=device)
    prompt = bench.bench_prompt()
    sampled = MultinomialProcessor(temperature=1.0)
    greedy = GreedyProcessor(temperature=GREEDY_T)
    runs = [("damp 0.08", "eagle", g, None, sampled) for g in EAGLE_GAMMAS]
    runs += [("damp 0.08", "eagle", EAGLE_GAMMA, None, greedy)]
    runs += [("damp 0.08", "eagle tree", None, br, None) for br in TREES]
    runs += [("int8 KV, flash", "eagle", EAGLE_GAMMA, None, greedy),
             ("int8 KV, flash", "eagle tree", None, (2, 2, 2), None)]
    cfgs = {"damp 0.08": t_cfg, "int8 KV, flash": t_cfg.replace(
        **KVINT8_FLASH)}
    # one short warm-up call
    run_tree("eagle", (t_cfg, e_cfg), (target, head), prompt, None,
             bench.WARM_GEN, device, sampled, gamma=EAGLE_GAMMAS[0])
    summary, totals, parted = {}, {}, {}
    for setting, kind, gamma, br, proc in runs:
        cfg = cfgs[setting]
        ecfg = cfg.replace(num_layers=1)
        topo = _topology(br) if br else None
        if proc is not sampled and setting not in refs:
            refs[setting] = greedy_ar(cfg, target, prompt, TREE_GEN, device)
        label = (f"{setting}, chain gamma {gamma}"
                 + (", greedy" if proc is greedy else ", sampled")
                 if kind == "eagle" else f"{setting}, tree {br}")
        reset_launches()
        (out, rate, windows), seconds = run_tree(
            kind, (cfg, ecfg), (target, head), prompt, topo, TREE_GEN,
            device, proc if kind == "eagle" else None, seed=100, gamma=gamma)
        counts = launches()
        total = totals.setdefault(setting, {k: 0 for k in kernel_wrappers()})
        for k in total:
            total[k] += counts[k]
        what = f"eagle ({label})"
        got = expect_launches(what, counts, target, cfg, tree_forwards(
            kind, cfg, ecfg, topo, windows, gamma))
        if len(out) != TREE_GEN or not all(0 <= t < bench.V for t in out):
            fail(f"{what}: {len(out)} tokens or one outside the vocabulary")
        ties = []
        if proc is not sampled:
            ties = check_greedy(what, cfg, target, [prompt], [refs[setting]],
                                [out], device,
                                parted.setdefault((setting, kind), {}))
        rec = {"tok_s": len(out) / seconds, "acceptance": rate,
               "windows": windows, "seconds": seconds, "ties": ties,
               "launches": got}
        summary[label] = rec
        say(f"[8b eagle] {label}: {rec['tok_s']:.1f} tok/s ({card}), "
            f"acceptance {rate:.3f}, {windows} windows; launches {got} (as "
            "implied)" + ("" if proc is sampled else "; == greedy AR" + (
                f" but for bf16 ties at tokens {ties}" if ties else "")))
    for (setting, kind), outs in parted.items():
        cfg, what = cfgs[setting], f"eagle ({setting}, {kind})"
        if kind == "eagle":
            # the first token from the prefill, then a verify of gamma+1
            # sequential rows a window
            forced = check_parted(
                what, cfg, target, outs, device,
                (64, 64 + TREE_GEN + EAGLE_GAMMA + 2, EAGLE_GAMMA + 1,
                 False))
        else:
            forced = tree_replay(what, cfg, target, outs, device)
        summary[f"{setting}, {kind} parted_replay"] = forced
        if outs:
            say(f"[8b eagle] {setting}, {kind}: {len(outs)} distinct "
                "outputs parted from AR; " + forced_note(forced))
    return summary, totals, head


def phase_eagle_serving(pair, head, device, card):
    """Batched and served EAGLE on the 22-layer INT4 target, greedy (at
    GREEDY_T), gamma 5, the serving phase's 16 prompts and 128 tokens:
    ``batch_eagle_generate`` on prompts 0-7 (the B=8 measurement) and 8-15,
    then ``EagleContinuousBatcher`` with 8 slots at 1 and 4 windows per
    host sync. Every output equals the batched AR engine's tokens up to a
    first top-two bf16 tie; each request's equals the batch engine's for
    its prompt up to a tie; both sync settings give the same tokens.
    Launches: K1b per target forward (a batch prefill or an admission at M
    = 256, a verify at M = 48), K1a per target and head forward. Returns
    (summary, launches by path)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.engine.batch_engine import (
        batch_autoregressive_generate,
    )
    from specdec_tpu_torch.engine.eagle_batch import batch_eagle_generate
    from specdec_tpu_torch.sampling.processors import GreedyProcessor
    from specdec_tpu_torch.serve import EagleContinuousBatcher

    t_cfg, _, target, _ = pair
    e_cfg = t_cfg.replace(num_layers=1)
    L, gamma, gen = t_cfg.num_layers, EAGLE_GAMMA, bench.SERVE_GEN
    proc = GreedyProcessor(temperature=GREEDY_T)
    prompts = bench.serving_prompts()
    t0 = time.perf_counter()
    refs = batch_autoregressive_generate(prompts, t_cfg, target, gen_len=gen,
                                         eos_tokens_id=(), device=device)
    say(f"[time] EAGLE serving: greedy AR references (batched) in "
        f"{time.perf_counter() - t0:.1f} s")

    def windows_of(what, counts, admissions):
        """Windows from the K1b launches (4 L per target forward), the
        launches then checked against them."""
        n = counts["K1b"] // (4 * L) - admissions
        expect_launches(what, counts, target, t_cfg,
                        [(admissions, L, 1, L), (n * gamma, 0, 1, 0),
                         (n, L, 1, 0)])
        return n

    summary, totals, parted, engine = {}, {}, {}, []
    for i in (0, 8):
        batch = prompts[i:i + 8]
        reset_launches()
        (outs, rates), seconds = timed_call(lambda: batch_eagle_generate(
            batch, e_cfg, head, t_cfg, target, gamma=gamma, gen_len=gen,
            logits_processor=proc, eos_tokens_id=(), device=device))
        counts = launches()
        totals.setdefault("eagle_batch", {k: 0 for k in kernel_wrappers()})
        for k in counts:
            totals["eagle_batch"][k] += counts[k]
        what = f"EAGLE batch (prompts {i}-{i + 7})"
        windows = windows_of(what, counts, 1)
        ties = check_greedy(what, t_cfg, target, batch, refs[i:i + 8], outs,
                            device, parted.setdefault(("batch", i), {}))
        engine += outs
        tokens = sum(len(o) for o in outs)
        summary[f"batch, prompts {i}-{i + 7}"] = {
            "tok_s": tokens / seconds, "seconds": seconds,
            "acceptance": float(np.mean(rates)), "windows": windows,
            "ties": ties, "launches": {k: n for k, n in counts.items() if n}}
        say(f"[8c eagle batch] B=8 (prompts {i}-{i + 7}): {tokens} tokens in "
            f"{seconds:.2f} s = {tokens / seconds:.1f} tok/s ({card}), "
            f"acceptance {np.mean(rates):.3f}, {windows} windows; K1b "
            f"{counts['K1b']}, K1a {counts['K1a']} (as implied); == greedy "
            "AR" + (f" but for bf16 ties at tokens {ties}" if ties else ""))
    outputs = {}
    for wps in (1, 4):
        b = EagleContinuousBatcher(
            e_cfg, head, t_cfg, target, num_slots=EAGLE_SLOTS, gamma=gamma,
            max_prompt_len=bench.SERVE_MAX_PROMPT, max_new_tokens=gen,
            logits_processor=proc, eos_tokens_id=(), windows_per_sync=wps,
            device=device)
        reset_launches()
        rec = bench.serve_pass(b, prompts)
        counts = launches()
        totals.setdefault("eagle_serving", {k: 0 for k in kernel_wrappers()})
        for k in counts:
            totals["eagle_serving"][k] += counts[k]
        what = f"EAGLE serving (windows_per_sync {wps})"
        windows = windows_of(what, counts, len(prompts))
        ties = check_greedy(what, t_cfg, target, prompts, engine,
                            rec["outputs"], device,
                            parted.setdefault(("serve", 0), {}))
        outputs[wps] = rec["outputs"]
        summary[f"serving, windows_per_sync {wps}"] = {
            **{k: rec[k] for k in ("tok_s", "ttft_p50_ms", "ttft_p99_ms",
                                   "acceptance", "seconds", "tokens")},
            "windows": windows, "ties": ties,
            "launches": {k: n for k, n in counts.items() if n}}
        say(f"[8c eagle serve] windows_per_sync {wps}: {rec['tokens']} tokens "
            f"in {rec['seconds']:.2f} s = {rec['tok_s']:.1f} tok/s ({card}), "
            f"TTFT p50 {rec['ttft_p50_ms']:.0f} ms, p99 "
            f"{rec['ttft_p99_ms']:.0f} ms, acceptance "
            f"{rec['acceptance']:.3f}, {windows} windows; K1b "
            f"{counts['K1b']}, K1a {counts['K1a']} (as implied); 16 requests "
            "== the batch engine's outputs"
            + (f" but for bf16 ties at tokens {ties}" if ties else ""))
    if outputs[1] != outputs[4]:
        fail("EAGLE serving: windows_per_sync 1 and 4 gave different tokens")
    for (where, i), outs in parted.items():
        if where == "batch":
            # one batch prefill at the padded length, gamma+1 rows a window
            P = 64 * max(1, -(-max(map(len, prompts[i:i + 8])) // 64))
            shape = (P, P + gen + gamma + 2, gamma + 1, False)
        else:
            P = bench.SERVE_MAX_PROMPT
            shape = (P, P + gen + gamma + 2, gamma + 1, True)
        forced = check_parted(f"EAGLE {where}", t_cfg, target, outs, device,
                              shape)
        if outs:
            say(f"[8c eagle] {where} {i}: {len(outs)} distinct outputs "
                "parted; " + forced_note(forced))
    return summary, totals


def with_config(pair, **cfg_kw):
    """The pair with both configs changed (the weights do not depend on the
    KV format or the attention kernel): what ``bench.build_pair(device,
    kv_quant, attention_impl)`` builds, without building it again."""
    t_cfg, d_cfg, target, drafter = pair
    return t_cfg.replace(**cfg_kw), d_cfg.replace(**cfg_kw), target, drafter


def kernel_entry(name, source, replaces, records, err, top, work,
                 launches_by_path, **extra):
    """One entry of the ``kernels`` line: launches summed over the main
    paths, the times of the ``top`` record, every timed shape."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, **extra,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path, "max_abs_err": err,
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "work": work, "shapes": [r for r in records if "ms" in r]}


def step_times(records):
    """Times of one decode step's calls of a weight kernel: the timed M=1
    records summed (a layer's four projections, or the lm_head), with the
    work they stand for."""
    step = [r for r in records if r["M"] == 1 and "ms" in r]
    out = {k: sum(r[k] for r in step)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in step)
                       else "operations")
    out["work"] = "M=1: " + ", ".join(f"{r['name']} {r['K']}x{r['N']}"
                                      for r in step)
    return out


def weight_entry(name, source, line, records, top, by_path, **extra):
    """One entry of the ``kernels`` line for a weight kernel: the top-level
    times are ``step_times(top)``; ``records`` are all its comparisons."""
    return {"name": name, "route": "cuda",
            "source": f"specdec_tpu_torch/ops/csrc/{source}",
            "replaces": f"specdec_tpu/ops/quant_matmul.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in records),
            **step_times(top), **extra,
            "shapes": [r for r in records if "ms" in r]}


def stacked_records(records, stacked=True):
    """The records of the stacked layers (or of the lm_head), without the
    ragged shapes."""
    return [r for r in records if (r["layer"] is not None) == stacked
            and r["name"] not in RAGGED_NAMES]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="NAME=SRC",
                    help="also time kernel NAME (int4_pair_matmul, "
                    "int8_matmul, q4_halfplane_matmul, decode_attention or "
                    "paged_attention) built from SRC, another source of it, "
                    "in turns with the checkout's (phases 3 and 3d, 3c or "
                    "3b)")
    args = ap.parse_args()
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

    def stamp(phase):
        say(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s")

    # the 22-layer pair in each weight format: INT4 (the default) and the
    # formats of kernels K7 (int8) and K6 (nf4, fp4)
    pairs = {}
    for quant in ("int4",) + QUANTS:
        t1 = time.perf_counter()
        pairs[quant] = bench.build_pair(device, quant=quant)
        torch.cuda.synchronize()
        say(f"[5 main] built the {quant} LayerSkip pair in "
            f"{time.perf_counter() - t1:.1f} s")
    pair = pairs["int4"]

    against = build_against(args.against) if args.against else None
    records, max_err = phase_kernel(pair[2], device, against=against)
    paged_records, paged_err = phase_paged_kernel(device, against)
    flash_records, flash_err = phase_flash_kernel(device, against)
    fmt_records = {q: phase_kernel(pairs[q][2], device, "3d kernel", against)
                   for q in QUANTS}
    stamp("3-3d kernels")
    phase_oracle(device)
    phase_oracle(device, "int8 KV, flash", **KVINT8_FLASH)
    for quant in QUANTS:
        phase_oracle(device, kind=quant)
    kv_err = phase_kv_error(pair, device)
    phase_serve_oracle(device)
    phase_serve_oracle(device, "int8 KV, flash", **KVINT8_FLASH)
    phase_serve_oracle(device, kind="int8")
    stamp("4-4b oracles")
    phase_dispatch(device)
    stamp("4c dispatch")
    int8_pair = with_config(pair, **KVINT8_FLASH)
    summary, launches_main = phase_main(pair, device)
    stamp("5 single sequence, bf16 KV")
    summary["profile"] = phase_profile(pair, summary, device)
    int8_main, launches_int8 = phase_main(int8_pair, device, "int8 KV, flash")
    stamp("5 single sequence, int8 KV")
    int8_main["profile"] = phase_profile(int8_pair, int8_main, device,
                                         "int8 KV, flash")
    stamp("5 profiles")
    flash_main, launches_flash = phase_main(with_config(pair, **FLASH),
                                            device, "bf16 KV, flash")
    fmt_main, fmt_launches = {}, {}
    for quant in QUANTS:
        fmt_main[quant], fmt_launches[quant] = phase_main(
            pairs[quant], device, f"{quant} weights")
    stamp("5 single sequence")
    summary["serving"], serve_launches = phase_serve(pair, device)
    int8_serving, serve_launches_int8 = phase_serve(int8_pair, device,
                                                    "int8 KV, flash")
    fmt_main["int8"]["serving"], serve_launches_w8 = phase_serve(
        pairs["int8"], device, "int8 weights", engines=("paged",))
    fmt_main["nf4"]["serving"], serve_launches_nf4 = phase_serve(
        pairs["nf4"], device, "nf4 weights", engines=("paged",))
    stamp("6 serving")
    nasd, launches_nasd = phase_nasd(pair, device, card)
    nasd_int8, launches_nasd_int8 = phase_nasd(
        int8_pair, device, card, "int8 KV, flash", NASD_INT8_VARIANTS)
    stamp("7 NASD")
    nasd_serving, launches_nasd_serve = phase_nasd_serving(pair, device,
                                                           card)
    stamp("7b NASD serving")
    summary["beam"], launches_beam = phase_beam(pair, device, card)
    stamp("7c beam")
    tree_oracle = phase_tree_oracle(device)
    stamp("4d tree oracles")
    refs = {}
    summary["trees"], launches_trees = phase_trees(pairs, device, card, refs)
    stamp("8 trees")
    summary["eagle"], launches_eagle, head = phase_eagle(pair, device, card,
                                                         refs)
    stamp("8b EAGLE")
    summary["eagle_serving"], launches_eagle_serve = phase_eagle_serving(
        pair, head, device, card)
    stamp("8c EAGLE batched and serving")
    summary["trees"]["card"] = summary["eagle"]["card"] = card
    summary["nasd"] = {"bf16 KV": nasd, "int8 KV, flash": nasd_int8,
                       "serving": nasd_serving, "card": card}
    summary["kvint8_flash"] = dict(int8_main, serving=int8_serving,
                                   prefill_logit_rel_err=kv_err)
    summary["flash"] = flash_main
    summary["weights"] = fmt_main

    # one entry per replaced TPU kernel; the top-level times are the work
    # of one decode step (M=1): a layer's four projections, or the lm_head
    entries = []
    for key, name, line in (("K1b", "int4_pair_matmul (stacked layer)", 219),
                            ("K1a", "int4_pair_matmul (2D lm_head)", 196)):
        mine = stacked_records(records, key == "K1b")
        # the ragged shapes through the wrapper of the entry
        ragged = [r for r in records if r["name"] in RAGGED_NAMES
                  and (r["layer"] is None) == (key == "K1a")]
        entries.append(weight_entry(
            name, "int4_pair_matmul.cu", line, mine + ragged, mine,
            {"spec_decode": launches_main[key],
             "spec_decode_kvint8_flash": launches_int8[key],
             "spec_decode_flash": launches_flash[key],
             "serving": serve_launches[key],
             "serving_kvint8_flash": serve_launches_int8[key],
             "nasd": launches_nasd[key],
             "nasd_kvint8_flash": launches_nasd_int8[key],
             "nasd_serving": launches_nasd_serve[key],
             "beam": launches_beam[key],
             "tree_oracle": sum(c[key] for c in tree_oracle.values()),
             "trees": launches_trees["damp 0.08"][key]
             + launches_trees["damp 0.35"][key],
             "trees_kvint8_flash": launches_trees["int8 KV, flash"][key],
             "eagle": launches_eagle["damp 0.08"][key],
             "eagle_kvint8_flash": launches_eagle["int8 KV, flash"][key],
             "eagle_batch": launches_eagle_serve["eagle_batch"][key],
             "eagle_serving": launches_eagle_serve["eagle_serving"][key]}))
    # K6: one kernel for both codecs; the top-level times are NF4's (the
    # JAX package's default codec), FP4's beside them
    for key, name, line in (("K6b", "q4_halfplane_matmul (stacked layer)",
                             263),
                            ("K6a", "q4_halfplane_matmul (2D lm_head)", 241)):
        nf4, fp4 = (stacked_records(fmt_records[q][0], key == "K6b")
                    for q in ("nf4", "fp4"))
        # the ragged shapes through the wrapper of the entry
        ragged = [r for q in ("nf4", "fp4") for r in fmt_records[q][0]
                  if r["name"] in RAGGED_NAMES
                  and (r["layer"] is None) == (key == "K6a")]
        entries.append(weight_entry(
            name, "q4_halfplane_matmul.cu", line, nf4 + fp4 + ragged, nf4,
            {**{f"spec_decode_{q}": fmt_launches[q][key]
                for q in ("nf4", "fp4")},
             "serving_nf4": serve_launches_nf4[key]},
            codecs="nf4 (top-level times), fp4", fp4=step_times(fp4)))
    # K7: the stacked layer's and the lm_head's calls are one TPU kernel;
    # the top-level times are a layer's four projections, the lm_head's
    # beside them
    w8 = fmt_records["int8"][0]
    entries.append(weight_entry(
        "int8_matmul (stacked layer; 2D lm_head)", "int8_matmul.cu", 91, w8,
        stacked_records(w8),
        {"spec_decode_int8": fmt_launches["int8"]["K7b"]
         + fmt_launches["int8"]["K7a"],
         "serving_int8": serve_launches_w8["K7b"] + serve_launches_w8["K7a"],
         "trees_int8": launches_trees["int8 weights"]["K7b"]
         + launches_trees["int8 weights"]["K7a"]},
        lm_head=step_times(stacked_records(w8, False))))

    def top(rows, name):
        return next(r for r in rows if r["name"] == name and "ms" in r)

    # the paged attention kernel: one CUDA kernel for K2 (4D pool) and K8a
    # (a layer of the stacks, the wrapper the serving path calls), and its
    # int8 instantiation for K5 and K8b; the top-level times are one verify
    # call of the serving engine
    paged_src = "specdec_tpu_torch/ops/csrc/paged_attention.cu"
    entries.append(kernel_entry(
        "paged_decode_attention (K8a stacked layer; K2 4D pool)", paged_src,
        "specdec_tpu/ops/paged_attention.py:258", paged_records["bf16"],
        paged_err["bf16"], top(paged_records["bf16"], "serve"),
        "serving verify: B=8, T=9, Hq=32, Hk=4, Dh=64, page 64, MP=9, bf16",
        {"serving": serve_launches["K8a"] + serve_launches["K2"],
         "serving_int8": serve_launches_w8["K8a"] + serve_launches_w8["K2"],
         "serving_nf4": serve_launches_nf4["K8a"] + serve_launches_nf4["K2"]},
        also_replaces="specdec_tpu/ops/paged_attention.py:26"))
    entries.append(kernel_entry(
        "paged_decode_attention_quant (K8b stacked layer; K5 4D pool)",
        paged_src, "specdec_tpu/ops/paged_attention.py:377",
        paged_records["int8"], paged_err["int8"],
        top(paged_records["int8"], "serve"),
        "serving verify: B=8, T=9, Hq=32, Hk=4, Dh=64, page 64, MP=9, int8 "
        "pools, bf16 q",
        {"serving_kvint8_flash": serve_launches_int8["K8b"]
         + serve_launches_int8["K5"]},
        also_replaces="specdec_tpu/ops/paged_attention.py:136"))
    # the flash-decode kernel: K3 (K/V of q's type) and K4 (int8 K/V); the
    # top-level times are one single-sequence decode step's call
    flash_src = "specdec_tpu_torch/ops/csrc/decode_attention.cu"
    work = "single-sequence decode: B=1, S=334, T=1, Hq=32, Hk=4, Dh=64, "
    entries.append(kernel_entry(
        "flash_decode_attention (K3)", flash_src,
        "specdec_tpu/ops/decode_attention.py:38", flash_records["K3"],
        flash_err["K3"], top(flash_records["K3"], "decode"), work + "bf16",
        {"spec_decode_flash": launches_flash["K3"],
         "tree_oracle_flash": tree_oracle["bf16 KV, flash"]["K3"]}))
    entries.append(kernel_entry(
        "flash_decode_attention_quant (K4)", flash_src,
        "specdec_tpu/ops/decode_attention.py:159", flash_records["K4"],
        flash_err["K4"], top(flash_records["K4"], "decode"),
        work + "int8 K/V, bf16 q",
        {"spec_decode_kvint8_flash": launches_int8["K4"],
         "serving_kvint8_flash": serve_launches_int8["K4"],
         "nasd_kvint8_flash": launches_nasd_int8["K4"],
         "tree_oracle_kvint8_flash": tree_oracle["int8 KV, flash"]["K4"],
         "trees_kvint8_flash": launches_trees["int8 KV, flash"]["K4"],
         "eagle_kvint8_flash": launches_eagle["int8 KV, flash"]["K4"]}))
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"largest kernel-vs-plain abs error {max_err:.3g} (INT4), "
        + ", ".join(f"{fmt_records[q][1]:.3g} ({q})" for q in QUANTS) + ", "
        f"{paged_err['bf16']:.3g} / {paged_err['int8']:.3g} (paged "
        f"attention, bf16/f32 / int8 pools), {flash_err['K3']:.3g} / "
        f"{flash_err['K4']:.3g} (flash-decode K3 / K4)")
    say(card)
    say(json.dumps(summary))
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
