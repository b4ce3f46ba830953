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
   catch-up and gamma-8 verify; M = 33-159 share one instance, and from
   the library's threshold, 160, the tiled instance takes 256 and 512),
   on the main path's own weights; its time beside the plain version's, a
   bf16 ``torch.matmul`` on pre-dequantized weights (a yardstick the port
   never calls) and the bound; the share of output elements bit-equal to
   the plain version's (at least MIN_BIT_EQUAL); a check that a row's
   result does not depend on how many rows share the call (bit for bit
   within each of K1's two designs, within the kernel-vs-plain tolerance
   across the threshold, where the order of the sums changes); and the two
   ragged shapes of K6 below, on random weights quantized on the card,
   through the 2D wrapper and through the stacked one (layer 1 of a stack
   of 2, whose fields start off any 16-byte line); then K1 at the
   benchmark's served widths (SERVED: Qwen3-8B's, Pythia-6.9B's and
   DeepSeek-V2-Lite's layers and heads) at M = 160, 320, 512, 1536, 2048
   and 8192 on random weights, held to the plain version and timed against
   ``portbench.measure.int4_bound_s`` and a bf16 ``torch.matmul``, each
   call's rows bit-equal to the same rows of the 8192-row call; K1's
   wrappers must count as tiled exactly the calls at or above the
   threshold;
3b. kernel vs plain, paged attention: the paged decode-attention kernel,
   through both wrappers (a 4D pool, and a layer of stacked pools, which
   must agree bit for bit), against its plain version in float32 and bf16
   at the decode, verify, long-context and serving shapes, once at
   qwen3-family heads (Hq=32, Hk=8, Dh=128) and once at gemma-2b's (the
   serving verify, Hq=8, Hk=1, Dh=256, pages of 16, where float32 q over
   float32 pools must be refused before any launch), over bf16/f32 pools
   and over
   int8 pools with their scales; its time beside the plain version's,
   ``scaled_dot_product_attention`` over K/V gathered (and, for int8,
   dequantized) beforehand (a yardstick the port never calls) and the
   bound;
3c. kernel vs plain, flash-decode attention: the slotted-cache kernel over
   K/V of q's type and over int8 K/V, in float32 and bf16, at the shapes
   the main paths give it (single sequence B=1, S=334, T = 1, 2, 13, 64;
   the serving drafter B=8, T = 1, 2 over the batcher's S; the admission
   prefill T=256), at qwen3-family heads (decode and verify, Dh=128), at
   gemma-2b's (decode and verify, Dh=256; float32 over float32 refused
   before any launch) and at S=2048 (8 spans of 4 tiles), and EAGLE's int8
   + flash catch-ups
   and verify (T = 5, 6 over S = 145, 135), offsets up to S; a row's
   result must
   not depend on T (at S=334 and 2048, and at Dh=256), nor a sequence's on
   the rest of its
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
   the flash-decode and the paged attention kernels, the expert kernel)
   and fails if ptxas
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
   flash-decode kernel, K3 or K4 over int8 KV, on every slotted forward
   whatever ``attention_impl`` says) and a profile of the
   card's busy share under the paged engine; with bf16 KV and with
   ``--kv-quant int8 --attn flash``; and the paged engine under ``--quant
   int8`` and ``--quant nf4`` (K7 or K6 on every projection, at the
   serving row counts M = 8, 72, 256);
4c. head_dim 256 at full width: google/gemma-2b's widths (GEMMA_2B
   through ``config_from_hf``: 18 layers, Hq=8, Hk=1, Dh=256, F=16384,
   V=256000, tied), random INT4 weights, its first 4 layers as the
   drafter, under the flash setting with bf16 and int8 KV: greedy AR and
   speculative decoding (gamma 12) of one sequence with K3 (K4) in every
   layer of every forward, and the paged engine serving 4 requests with
   K8a (K8b) in every target forward, every output equal to the plain
   attention's greedy AR up to a top-two tie, ms a token with the kernels
   and with the plain attention; then float32 over float32 KV (2 layers)
   takes the plain route by config and ``use_kernel=True`` raises before
   any launch;
4e. latent attention and experts at DeepSeek-V2-Lite's widths
   (DEEPSEEK_V2_LITE through ``config_from_hf``, 3 layers: layer 0 dense,
   then 64 experts top-6 and 2 shared; random INT4 weights): the grouped
   INT4 expert kernel against its plain version on the layer's own
   stacks, gate/up (K 2048, N 2816) and down (K 1408, N 2048), at ~6, ~30
   and ~770 rows an expert and with 32 experts given no row (phase 3's
   tolerance and bit-equal share), timed against its bound; the
   decompressed form's K3 call, zero-padded to head width 256 with the
   model's softmax scale, against the plain attention of the unpadded
   heads at 4096- and 8192-row admissions (phase 3c's bf16 tolerance; the
   padding's output columns zero), timed against the unpadded work's
   bound; K3, the MLA decode kernel's and the expert kernel's launches
   over a prefill and two steps, counted from zero;
4f. the MLA decode kernel (the absorbed form of latent attention) against
   its plain version at longreason's shapes (64 slots, T = 1, 2 and 5,
   live lengths 4,096-9,728, pages of 64 with a dead row and the slotted
   cache; then T = 15 and short ragged sequences), phase 3c's bf16
   allowance, timed against its bytes bound and the plain version;
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
   prompts of phase 6, 64 tokens each, at 1 and 4 windows per host sync:
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
   phase 5 (a 60-token prompt from default_rng(0), 64 tokens, greedy):
   (2, 2, 2), (3, 2, 1) and (4, 2) at tail damp 0.08 and 0.35, (2, 2, 2)
   under INT8 weights (K7) and under int8 KV + flash, a warm and a timed
   call each; a sampled (2, 2, 2) call twice from one seed gives the same
   tokens; tok/s, chain-depth acceptance, windows, launches as implied;
   every greedy output equal to greedy AR up to a first tie, a parted one
   replayed in the engine's shape;
8b. EAGLE on the same target (tools/bench_eagle.py's protocol, 64
   tokens), an untrained depth-1 head made on the card from a seed: chain
   gamma 3, 5, 8 sampled, chain gamma 5 greedy (GreedyProcessor at
   temperature 1e-4, where acceptance is exact-match), the greedy trees
   (3, 2, 1), (2, 2, 2), (4, 2), each greedy output equal to greedy AR up
   to a tie (replayed); chain gamma 5 and tree (2, 2, 2) under int8 KV +
   flash; K1a on every head forward, K4 on every sequential forward;
8c. EAGLE batched and served: ``batch_eagle_generate`` at B=8 on the
   serving phase's prompts, 64 tokens, greedy, gamma 5, and
   ``EagleContinuousBatcher`` (8 slots) on all 16 at 1 and 4 windows per
   sync: the same tokens, each request equal to the batch engine's (and
   that to greedy AR) up to a tie; tok/s, TTFT, acceptance, windows, K1
   launches (M = 48 a verify, 256 an admission).

9. the benchmark entry point at full width: a ShareGPT-format JSONL of 64
   prompts of 10-500 characters written from default_rng(0); the README's
   command (``TARGET_MODEL=synthetic:llama-1b-ls4 DRAFTER_MODEL=layerskip:4
   QUANTIZATION=int8 ... python -m specdec_tpu_torch.cli.benchmark``, 4
   prompts of 100 tokens, gamma 5: K7) and its INT4 counterpart in batch
   mode (8 prompts in batches of 4: K1), each in a subprocess that runs
   the module as ``-m`` does and then prints its launch counts; then the
   INT4 configuration through ``BenchmarkRunner`` in-process (4 prompts of
   64 tokens): target_ar, ngram on the device table, an untrained
   ``eagle:1`` head and an open-loop run (2 requests/s for 10 s). Each run:
   the result files with the JAX runner's keys at every level, the
   requests asked for, launches that make whole forwards, NVML telemetry
   (average power, or a sample, inside (0, the card's limit)); greedy
   target_ar and ngram outputs equal single-sequence greedy AR up to a
   top-two tie (``greedy_tie``); tok/s, TTFT and latency p50/p99,
   acceptance, average and peak W and tokens per joule printed;
9b. a local checkpoint: the dense bf16 target of phase 5 written as a
   TinyLlama-shaped HF llama checkpoint (two safetensors shards and an
   index, 2.2 GB, under ``build/``, removed after), loaded by
   ``load_hf_streamed(quantization="int4")`` on the card: bit-identical to
   ``quantize_params(dense, "int4", fuse=True)`` on the card and on the
   CPU, peak device memory of the load under the loaded model plus two
   dense layers and the dense lm_head, greedy AR of 32 tokens equal to
   the pair's;
9c. ``synthetic:llama-8b`` (built by ``init_quantized_params``, INT4) with
   ``layerskip:4``, 4 prompts in one batch of 32 tokens, through the
   runner: its build time and peak memory; K1 at the preset's shapes
   (M = 1, 4, 20, 256) against its plain version, with times; then the
   route of 4-bit weights whose K the kernels do not take: a
   Qwen2-0.5B-width model (hidden 896, 2 layers) in INT4 and NF4, the
   kernel wrappers refusing K=896 before any launch, wqkv, wo and
   w_gateup on ``dequant_matmul`` and w_down on K1b / K6b (the counts
   hold the split), greedy AR equal to the dequantized dense model's up
   to a top-two bf16 tie;
9d. the serving facade: ``VLLMEngineManager`` from the VLLM_* variables on
   the INT4 LayerSkip pair (max_model_len 512, 8 slots, gamma 5), the
   paged engine with bf16 KV (K8a) and with ``KV_QUANT=int8`` (K8b),
   ``run_server_benchmark`` over it with the serving phase's 16 prompts
   arriving at 4 per second, 128 tokens each, greedy at temperature 1e-4:
   every request equal to the batched AR engine's output up to a tie;
   req/s, tok/s, TTFT and latency p50/p99.

10a. gradients through the weight kernels: K1 (INT4), K6 (NF4) and K7
   (INT8) on the pair's weights (layer 0's projections and the lm_head)
   at M = 1024 and 1016 (a teacher forward of 8 x 128 tokens, the EAGLE
   head's first rollout pass): the forward through the wrappers' autograd
   Function against the plain version (phase 3's tolerances), x's gradient
   against autograd of the plain version (relative Frobenius 1e-2, never
   None or zero); at M = 1024 the forward's, the backward's (dy @
   dequantize(w)^T) and torch.matmul's times; every attention wrapper
   raises under grad and launches nothing;
10c. convergence at tests/test_pretrain.py's width on the card: a 4-layer
   D=128 target 450 steps on the order-1 stream (NLL under the floor +
   0.35, a fresh batch + 0.4), a depth-1 EAGLE head 250 steps (proxy at
   least 0.5, lifted by more than 0.3), and the trained head accepting more
   than the untrained one in ``eagle_generate``;
10b. full-width pretraining through ``load_models``: ``trained:llama-1b@100``
   in bf16 (seconds a step, tokens/s, 6 N tokens/s against the bf16 peak,
   peak memory, the NLL at the first and last step, which must fall by
   0.4 nats), quantized to INT4; greedy AR of the INT4 target equal to the
   dense one's up to a top-two bf16 tie;
10d. in the same load, ``eagle:1@2`` trained on the INT4 target (batch 8 x
   128, rollout 3; each step's time split into sampler, teacher, loss and
   backward, optimizer; K1 launches a step exactly as its forwards imply)
   and saved through EAGLE_SAVE, ``eagle:<dir>`` reloading it bit for bit;
   three ``distill_drafter`` steps of a dense 4-layer drafter against the
   INT4 target; the perplexity of the dense and INT4 targets on 16 stream
   sequences (INT4 within 5%); the CLI with ``TARGET_MODEL=trained:llama-
   1b@100 DRAFTER_MODEL=eagle:<dir>``, its result files checked as phase 9
   checks them and its K1 launches whole forwards.

11. the encoder-decoder at full width: Flan-T5-large's shape (target) and
   Flan-T5-small's (drafter), from google/flan-t5-large and -small's
   config.json, random weights from a seed at HF T5's initialization
   scales (``t5_init_scales``: peaked logits), each written as an HF T5
   checkpoint under ``build/`` (removed after; the large one BF16 in two
   shards with an index, the small one F32 in one file, by the writer
   phase 9b uses) and loaded by ``load_codec_checkpoint`` on the card in
   bf16 and in f32, bit-equal to the weights as written (load time and
   peak memory printed); ``rel_position_bucket`` on the card equal to the
   CPU's over rel in [-1024, 1024]; bf16 decode_step logits within a
   relative Frobenius CODEC_BF16_FRO of f32 at full width, and the card's
   f32 within CODEC_CPU_FRO of the CPU's at 2 + 2 layers; on a 60-token
   prompt from default_rng(0), 64 tokens: greedy AR, self-draft greedy
   spec (gamma 5, GreedyProcessor at GREEDY_T) equal to AR up to a
   top-two bf16 tie with acceptance 1.0 unless a tie parted them, the
   small drafter likewise equal to AR, a seeded multinomial run twice the
   same; the encoder's ms, AR ms a token and the card's busy share of it
   (profiled), ms a window, tok/s and acceptance; no port kernel launched
   (the codec has none);
12. the REPL: ``python -m specdec_tpu_torch.cli.repl`` with its defaults
   (synthetic:llama-1b over synthetic:llama-70m, dense bf16) in a
   subprocess, phase 9's ShareGPT JSONL as SHAREGPT_DIR, over /gamma 4,
   /length 32, /ngram, /drafter, a prompt, /set_ngramstorage onelevel 2,
   /random, auto 2 and /quit: exit 0, every tag and throughput ratio for
   each of the 4 prompts; then ``InferenceCLI._infer`` in process at
   ``/processor greedy`` GREEDY_T: speculative and NASD tokens equal target
   AR's up to a top-two bf16 tie.
13a. tensor and data parallelism at world size 1: an NCCL world of one
   rank (``parallel.init_distributed``), a tp=1 x dp=1 mesh; the INT4
   pair of phase 5 through ``shard_params`` (the drafter replicated) in
   ``batch_speculative_generate`` over PAR_PROMPTS prompts, and
   ``load_models(mesh=...)`` of the INT4 llama-1b LayerSkip preset in the
   paged engine over PAR_REQUESTS requests, greedy and sampled: tokens
   and acceptance bit-equal to the unsharded runs, every all-reduce
   issued; the single-sequence window's wall with and without the mesh,
   PAR_WALL_TURNS turns of calls, every call reported, and one
   all-reduce alone at the verify forward's shapes;
13b. worlds of 2 and 4 ranks on the one card (``torch.multiprocessing``
   spawned, gloo over CUDA tensors: NCCL takes one rank a card), at
   TinyLlama's widths cut to PAR_LAYERS layers, INT4: tp=2, tp=4 and
   tp=2 x dp=2, with bf16 KV and int8 KV under the flash kernel (K4);
   greedy batched AR equal to the unsharded run's up to a top-two bf16
   tie, logits within PAR_LOGIT_FRO (relative Frobenius) of the
   unsharded forward while each planted fault of PAR_FAULTS (a dropped
   all-reduce, a rank on the wrong KV heads) reads above it, and per
   forward 2 all-reduces a layer plus 2, the
   lm_head on K1a and every projection on K1b but, at tp=4, the w_down
   shard (K = 1408) on ``dequant_matmul``.
14a. pipeline parallelism at one stage: an NCCL world of one rank,
   ``pipeline_forward_full`` on the INT4 target of phase 5 (22 layers,
   quantized lm_head) at B=8, T = 13 and 64, 1, 2 and 4 microbatches:
   bit-equal to ``forward_full`` at one microbatch, the largest
   difference and argmaxes up to top-two ties at more; launches;
14b. gloo worlds on the one card (spawned, CUDA tensors, each hop staged
   through the host): 2 stages over the 22 layers and 4 over the first
   20, B=8, T=13, 1, 2 and 4 microbatches, under the plain attention and
   the flash kernel (K3): logits within PP_LOGIT_FRO of the unsharded
   forward's, argmaxes up to top-two ties, two faults planted at run time
   (PP_FAULTS) reading above the limit, every rank's launches (4 K1b a
   layer and microbatch, K1a a microbatch on the last stage, K3 a layer
   and microbatch under flash); walls labelled one card's.

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
# lm_head, its serving verify (48). K1's instances split M at 8, 16, 32
# and the tiled instance's threshold (160): each instance of every main
# path is held to the plain version
ROWS = (1, 2, 3, 4, 5, 6, 8, 9, 13, 15, 16, 24, 48, 64, 72, 256, 512)
# K1 at the benchmark's served widths (portbench/configs: Qwen3-8B,
# Pythia-6.9B and DeepSeek-V2-Lite as quantize_params(fuse=True) lays them
# out; DeepSeek's wq with w_kva fused is wq_kva, the unfused pair kept as
# the loaders without fusion give it), at the row counts its cells give
# them: verifies (160: 32 slots x 5; 320: 64 x 5), admissions (512, 1536,
# 2048, 8192 rows) and the latent attention's kv_b over the cached rows
SERVED = [("qwen3-8b wqkv", 4096, 6144), ("qwen3-8b/pythia-6.9b wo", 4096, 4096),
          ("qwen3-8b w_gateup", 4096, 24576), ("qwen3-8b w_down", 12288, 4096),
          ("qwen3-8b lm_head", 4096, 151936),
          ("pythia-6.9b wqkv", 4096, 12288), ("pythia-6.9b w_up", 4096, 16384),
          ("pythia-6.9b w_down", 16384, 4096),
          ("pythia-6.9b lm_head", 4096, 50432),
          ("deepseek-v2-lite wq_kva", 2048, 3648),
          ("deepseek-v2-lite wq", 2048, 3072),
          ("deepseek-v2-lite w_kva", 2048, 576),
          ("deepseek-v2-lite w_kvb", 512, 4096),
          ("deepseek-v2-lite wo", 2048, 2048),
          ("deepseek-v2-lite shared gate/up", 2048, 5632),
          ("deepseek-v2-lite shared down", 2816, 2048),
          ("deepseek-v2-lite layer-0 gate/up", 2048, 21888),
          ("deepseek-v2-lite lm_head", 2048, 102400)]
SERVED_ROWS = (160, 320, 512, 1536, 2048, 8192)
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

# attention heads (Hq, Hk, Dh): the pair's, a qwen3-family model's
# (Qwen3-8B: 32 query heads over 8 KV heads of 128) and google/gemma-2b's (8
# query heads over 1 KV head of 256, the kernel body's 256 instance), run
# on each attention kernel. At head_dim 256 float32 q over float32 K/V does
# not fit a block's shared memory: that combination must be refused before
# any launch, and is recorded as refused
PAIR_HEADS = (32, 4, 64)
QWEN3_HEADS = (32, 8, 128)
GEMMA_HEADS = (8, 1, 256)
# paged attention shapes: (label, B, T, page, MP, offsets, heads). Page 64
# is the serving engine's: decode/verify are tools/bench_paged.py's
# validation shapes; long reaches the config's 2048 positions; serve is the
# serving engine's verify (8 slots, gamma 8) at its table width of 9 pages,
# chunk a chunk of phase 4b's chunked prefill (prefill_chunk=64) at that
# width; vllm-serve the serving facade's verify (phase 9d: 8 slots, gamma
# 5) at its width of VLLM_TABLE_PAGES = 12 pages; gemma-serve the serving
# verify at gemma-2b's heads in pages of 16 over the same 576 positions.
# Pages of 16 (four to a 64-key tile) and 128 (half a page a tile)
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
    ("vllm-serve", 8, 6, PAGE, 12, [30, 199, 260, 400, 511, 600, 640, 700],
     PAIR_HEADS),
    ("gemma-serve", 8, 9, 16, 36, [60, 150, 230, 320, 90, 200, 280, 330],
     GEMMA_HEADS),
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
# its S = 64 + TREE_GEN + 5 + 2, the (2, 2, 2) tree's catch-up (T = 5) over
# S = 64 + TREE_GEN + 15 + 2; the single-sequence decode and verify at
# gemma-2b's heads (phase 4c's shapes). Offsets reach S - T.
SINGLE_S, SERVE_S, LONG_S = 334, 394, 2048
EAGLE_S, EAGLE_TREE_S = 135, 145
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
    ("eagle-catch-up", 1, EAGLE_S, 6, [116], PAIR_HEADS),
    ("eagle-verify", 1, EAGLE_S, 6, [129], PAIR_HEADS),
    ("eagle-tree-catch-up", 1, EAGLE_TREE_S, 5, [140], PAIR_HEADS),
    ("gemma-decode", 1, SINGLE_S, 1, [333], GEMMA_HEADS),
    ("gemma-verify", 1, SINGLE_S, 13, [321], GEMMA_HEADS),
]
# row independence: the rows of a T=64 call at one offset against the same
# rows of calls at smaller T, over a cache of each capacity and heads (S,
# offset, heads)
ROW_CHECK_T = (1, 2, 13)
ROW_CHECK_S = ((SINGLE_S, 200, PAIR_HEADS), (LONG_S, 1900, PAIR_HEADS),
               (SINGLE_S, 200, GEMMA_HEADS))


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
# INT4 kernel (K1), the NF4/FP4 kernel (K6), the INT8 kernel (K7), the
# attention kernels, flash-decode (K3/K4) and paged (K2/K8a, K5/K8b), the
# grouped INT4 expert kernel and the MLA decode kernel: every kernel of the
# port
SPILL_CHECKED = ("int4_pair_matmul", "q4_halfplane_matmul", "int8_matmul",
                 "decode_attention", "paged_attention", "int4_expert_matmul",
                 "mla_decode_attention")
# the kernels ``--against`` takes: the weight kernels and the attention
# kernels
AGAINST_LIBS = (sorted(set(WEIGHT_LIBS.values()))
                + ["decode_attention", "paged_attention",
                   "mla_decode_attention"])


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
        # per instance: its mangled name, registers and spill bytes
        entry = spill = None
        for line in rec["ptxas"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = re.search(r"Used \d+ registers", line).group(0)
                say(f"  {name}: {entry}: {regs}; {spill}")
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
    # K1's calls of M at or above its library's threshold take the tiled
    # instance, whose sums run in another order: a row is bit-equal across
    # M within each of K1's two designs, and within tolerance across them
    tiled = (lambda M: M >= qm.int4_tiled_min_rows()) if fmt == "int4" \
        else (lambda M: False)
    counts, calls = k1_counts(), {"all": 0, "tiled": 0}
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
        if fmt == "int4":
            kern = counted(kern, calls)
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
            # a row's result must not depend on how many rows share the
            # call: bit for bit within a design, within the kernel-vs-plain
            # tolerance across K1's two
            ref = max(m for m in ROWS if tiled(m) == tiled(M))
            if not torch.equal(ys[M], ys[ref][:M]):
                fail(f"{fmt} {name} layer {layer}: rows of the M={M} call "
                     f"differ from the same rows of the M={ref} call")
            err, rel, ok = kernel_vs_plain(ys[M].float(),
                                           ys[max(ROWS)][:M].float())
            if not ok:
                fail(f"{fmt} {name} layer {layer}: rows of the M={M} call "
                     f"differ from the M={max(ROWS)} call's beyond the "
                     f"tolerance (max abs {err:.3g}, relative {rel:.3g})")
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
    if fmt == "int4":
        check_k1_counts(phase, counts, calls)
    family = "each of K1's two designs" if fmt == "int4" else "the kernel"
    say(f"[{phase}] {fmt}: all {len(records)} comparisons within relative "
        f"Frobenius {REL_FRO_TOL} and rtol {RTOL}, atol {ATOL} "
        f"({min(r['bit_equal'] for r in records):.3%}-"
        f"{max(r['bit_equal'] for r in records):.3%} of elements bit-equal); "
        f"row-independent at M in {ROWS} (bit for bit within {family})")
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


def k1_counts():
    """K1's wrappers' launch counts: (launches, tiled launches) summed."""
    from specdec_tpu_torch.ops import quant_matmul as qm

    wrappers = (qm.int4_matmul, qm.int4_matmul_stacked)
    return (sum(w.launches for w in wrappers),
            sum(w.tiled_launches for w in wrappers))


def counted(kern, calls):
    """``kern`` (a K1 call on x), tallying its calls and those of M at or
    above the threshold of the library it launches (an ``--against``
    source without a tiled instance reports none) in ``calls``."""
    from specdec_tpu_torch.ops import quant_matmul as qm

    def run(x):
        calls["all"] += 1
        calls["tiled"] += x.shape[0] >= qm.int4_tiled_min_rows()
        return kern(x)
    return run


def check_k1_counts(phase, before, calls):
    """K1's wrappers counted every call since ``before`` and, as tiled
    launches, exactly the calls at or above the threshold."""
    launched, tiled = (a - b for a, b in zip(k1_counts(), before))
    if (launched, tiled) != (calls["all"], calls["tiled"]):
        fail(f"[{phase}] K1 counted {launched} launches, {tiled} tiled; "
             f"expected {calls['all']} and {calls['tiled']}")
    say(f"[{phase}] K1 launches {launched}, of them {tiled} on the tiled "
        "instance: the calls at or above its threshold")


def plain_int4(x, a, b):
    """K1's plain version in column slices, so that its [64-row blocks, M,
    columns] f32 partial sums stay near 1.5 GB at any served width."""
    from specdec_tpu_torch.ops import quant_matmul as qm

    M, N, G = x.shape[0], a.shape[1], a.shape[0] // 8
    step = max(128, int(1.5e9 / (G * M * 4)) // 128 * 128)
    return torch.cat([qm.int4_matmul_reference(x, a[:, i:i + step],
                                               b[:, i:i + step])
                      for i in range(0, N, step)], dim=1)


def compare_sliced(got, plain, step=8192):
    """kernel_vs_plain and the bit-equal share over column slices (the
    served heads' outputs are GBs in f32): (max abs error, relative
    Frobenius error, within the tolerance, bit-equal share)."""
    err, d2, p2, ok, equal = 0.0, 0.0, 0.0, True, 0
    for i in range(0, got.shape[1], step):
        g, p = got[:, i:i + step].float(), plain[:, i:i + step].float()
        err = max(err, (g - p).abs().max().item())
        d2 += (g - p).square().sum().item()
        p2 += p.square().sum().item()
        ok &= torch.allclose(g, p, rtol=RTOL, atol=ATOL)
        equal += (g == p).sum().item()
    rel = math.sqrt(d2 / p2)
    return err, rel, ok and rel <= REL_FRO_TOL, equal / got.numel()


def phase_served(device, against=None):
    """3, served widths: K1 at the benchmark's configurations' widths and
    row counts (SERVED, SERVED_ROWS) on random weights quantized on the
    card, through the 2D wrapper: held to the plain version (tolerance and
    bit-equal share), row-independent within the tiled instance (each
    call's rows bit-equal to the same rows of the largest call), timed
    against ``portbench.measure.int4_bound_s`` and a bf16 ``torch.matmul``
    on the dequantized weights (a yardstick the port never calls), and,
    with ``--against int4_pair_matmul=SRC``, SRC's kernel in turns; the
    wrappers count exactly the calls at or above the threshold as tiled."""
    from portbench.measure import int4_bound_s
    from specdec_tpu_torch.ops import quant_matmul as qm
    from specdec_tpu_torch.quant.core import dequantize, quantize_int4

    other = (against[1] if against and against[0] == WEIGHT_LIBS["int4"]
             else None)
    threshold = qm.int4_tiled_min_rows()
    if any(M < threshold for M in SERVED_ROWS):
        fail(f"[3 served] threshold {threshold} above a served row count "
             f"of {SERVED_ROWS}")
    gen = torch.Generator(device=device).manual_seed(2727)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=device)
    counts, calls = k1_counts(), {"all": 0, "tiled": 0}
    records = []
    for name, K, N in SERVED:
        w = quantize_int4(torch.randn((K, N), generator=gen, device=device)
                          * 0.02)
        kern = counted(lambda x, w=w: qm.int4_matmul(x, w), calls)
        x_all = torch.randn((max(SERVED_ROWS), K), generator=gen,
                            device=device).to(torch.bfloat16)
        ys = {M: kern(x_all[:M]) for M in SERVED_ROWS}
        torch.cuda.synchronize()
        w_bf16 = dequantize(w, torch.bfloat16)
        for M in SERVED_ROWS:
            if not torch.equal(ys[M], ys[max(SERVED_ROWS)][:M]):
                fail(f"[3 served] {name}: rows of the M={M} call differ "
                     f"from the same rows of the M={max(SERVED_ROWS)} call")
            x = x_all[:M]
            err, rel, ok, equal = compare_sliced(
                ys[M], plain_int4(x, w.packed, w.absmax))
            if not ok or equal < MIN_BIT_EQUAL:
                fail(f"[3 served] {name} M={M}: kernel vs plain max abs err "
                     f"{err:.3g}, relative Frobenius {rel:.3g}, "
                     f"{equal:.3%} bit-equal")
            bound = int4_bound_s(M, K, N) * 1e3
            rec = {"name": name, "K": K, "N": N, "M": M,
                   "max_abs_err": err, "rel_fro_err": rel,
                   "bit_equal": equal, "bound_ms": bound,
                   "ms": gpu_ms(lambda: kern(x), flush),
                   "library_ms": gpu_ms(lambda: torch.matmul(x, w_bf16),
                                        flush)}
            if other is not None:
                with launching(WEIGHT_LIBS["int4"], other):
                    t = [gpu_ms(lambda: kern(x), flush) for _ in (0, 1)]
                rec["against_ms"] = min(t)
                rec["ms"] = min(rec["ms"], gpu_ms(lambda: kern(x), flush))
            rec["of_bound"] = bound / rec["ms"]
            records.append(rec)
            say(f"[3 served] {name:32s} M={M:5d} K={K:5d} N={N:6d}: kernel "
                f"{rec['ms'] * 1e3:9.1f} us ({rec['of_bound']:6.1%} of the "
                f"bound {bound * 1e3:8.1f} us), torch.matmul bf16 "
                f"{rec['library_ms'] * 1e3:8.1f} us"
                + (f", against {rec['against_ms'] * 1e3:9.1f} us"
                   if other is not None else "")
                + f"; max abs err {err:.3g}, rel {rel:.2g}, bit-equal "
                f"{equal:.3%}")
        del ys, w_bf16, x_all, w
    check_k1_counts("3 served", counts, calls)
    say(f"[3 served] all {len(records)} comparisons within relative "
        f"Frobenius {REL_FRO_TOL} and rtol {RTOL}, atol {ATOL} "
        f"({min(r['bit_equal'] for r in records):.3%}-"
        f"{max(r['bit_equal'] for r in records):.3%} bit-equal), "
        f"row-independent on the tiled instance (from M = {threshold})")
    return records


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


def refusal(what, calls):
    """Each of ``calls`` (an attention wrapper on a combination of head_dim
    and types that the kernel does not take) raises ValueError before any
    launch: the wrappers' counts do not move. Returns the first message."""
    counts = launches()
    msgs = []
    for call in calls:
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
        else:
            fail(f"{what}: the kernel's wrapper did not refuse")
    torch.cuda.synchronize()
    if launches() != counts:
        fail(f"{what}: launched before refusing")
    return msgs[0]


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
    A combination the kernel does not take (float32 over float32 pools at
    head_dim 256) must be refused by both wrappers before any launch.
    Returns the per-shape records of each pool format (timed in bf16, the
    main path's type) and each format's largest absolute error."""
    from specdec_tpu_torch.core.cache import quantize_kv_block
    from specdec_tpu_torch.core.paged_cache import (
        gather_page_scales, gather_pages,
    )
    from specdec_tpu_torch.ops import paged_attention as pa
    from specdec_tpu_torch.ops.attention_args import kernel_takes

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
                what = f"paged {label} {fmt} pool, q {dtype}"
                if not kernel_takes(Dh, dtype, fmt == "int8"):
                    records[fmt].append({
                        "name": label, "pool": fmt,
                        "dtype": str(dtype).split(".")[-1], "B": B, "T": T,
                        "page": page, "MP": MP, "heads": [Hq, Hk, Dh],
                        "refused": refusal(what, (
                            kern, lambda: k4(q, table, off)))})
                    say(f"[3b paged] {label:12s} {fmt} q {dtype} Dh={Dh}: "
                        "refused before any launch (shared memory)")
                    continue
                got, plain = kern(), ref()
                torch.cuda.synchronize()
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
    n = sum("refused" not in r for rs in records.values() for r in rs)
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
    of 64, bit for bit. A combination the kernel does not take (float32 q
    over float32 K/V at head_dim 256) must be refused before any launch.
    ``against``: build_against's (NAME, library); where NAME is
    ``decode_attention``, that library is held to the same tolerance and
    timed in turns with the checkout's. Returns the per-shape records of
    each kernel (timed in bf16) and each kernel's largest absolute error."""
    from specdec_tpu_torch.core.cache import quantize_kv_block
    from specdec_tpu_torch.ops import decode_attention as da
    from specdec_tpu_torch.ops import paged_attention as pa
    from specdec_tpu_torch.ops.attention_args import kernel_takes

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
                what = f"flash {label} {name} q {dtype}"
                if not kernel_takes(Dh, dtype, quant):
                    records[name].append({
                        "name": label, "kernel": name,
                        "dtype": str(dtype).split(".")[-1], "B": B, "S": S,
                        "T": T, "heads": [Hq, Hk, Dh],
                        "refused": refusal(what, (lambda: run(
                            "kernel", q, k, v, off, quant),))})
                    say(f"[3c flash] {label:14s} {name} q {dtype} Dh={Dh}: "
                        "refused before any launch (shared memory)")
                    continue
                got = run("kernel", q, k, v, off, quant)
                plain = run("plain", q, k, v, off, quant)
                torch.cuda.synchronize()
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

    for S, o, (Hq, Hk, Dh) in ROW_CHECK_S:
        off = torch.tensor([o], dtype=torch.int32, device=device)
        kf, vf = (torch.randn((1, S, Hk, Dh), generator=gen, device=device)
                  for _ in range(2))
        kq, vq = quantize_kv_block(kf), quantize_kv_block(vf)
        MP = -(-S // PAGE)
        table = torch.arange(1, MP + 1, dtype=torch.int32, device=device)[None]
        for name, quant in (("K3", False), ("K4", True)):
            for dtype in (torch.float32, torch.bfloat16):
                if not kernel_takes(Dh, dtype, quant):
                    continue
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
                        fail(f"flash {name} {dtype} S={S} Dh={Dh}: rows of "
                             f"the T={T} call differ from the same rows of "
                             "the T=64 call")
                    # over the same keys laid out in pages of 64 (MP =
                    # ceil(S / 64): the same tiles, so the same spans), K3
                    # equals K8a and K4 equals K8b bit for bit
                    if not torch.equal(paged(qt), part):
                        fail(f"flash {name} {dtype} S={S} T={T} Dh={Dh}: the "
                             "paged kernel over the same keys in pages of "
                             f"{PAGE} differs from the flash-decode kernel")
    n = sum("refused" not in r for rs in records.values() for r in rs)
    say(f"[3c flash] all {n} comparisons within tolerance: "
        f"{tol_summary(records['K3'] + records['K4'])}; rows independent of "
        f"T (T in {ROW_CHECK_T} against 64; S, offset, heads in "
        f"{ROW_CHECK_S}) and of the batch "
        "(each sequence alone at B=1 against the B=8 calls); K3 == K8a and "
        f"K4 == K8b bit for bit over the same keys in pages of {PAGE} (T in "
        f"{ROW_CHECK_T + (64,)}; S in {[S for S, _, _ in ROW_CHECK_S]}); "
        "float32 over float32 refused before any launch at head_dim "
        f"{GEMMA_HEADS[2]}")
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
    """The kernel a slotted forward of ``cfg`` outside the batch engine
    attends through (None: the plain attention)."""
    if cfg.attention_impl != "flash":
        return None
    return "K4" if cfg.kv_quant == "int8" else "K3"


def batch_attention_kernel(cfg):
    """The kernel a slotted forward of the batch engine or of a serving
    batcher's admission attends through, whatever ``attention_impl`` says
    (None: the plain attention): K3, or K4 over int8 KV, wherever
    ``kernel_route(cfg)`` holds."""
    from specdec_tpu_torch.core.model import kernel_route

    if not kernel_route(cfg):
        return None
    return "K4" if cfg.kv_quant == "int8" else "K3"


@contextlib.contextmanager
def plain_batch_route():
    """The batch engine's and the admissions' slotted forwards on the
    config's ``attention_impl`` rule, not the kernel route: the greedy AR
    references of engines that attend as the config says (NASD, EAGLE),
    so that the reference and the engine reduce in the same attention."""
    from specdec_tpu_torch.engine import batch_engine

    saved = batch_engine.kernel_route
    batch_engine.kernel_route = lambda cfg: False
    try:
        yield
    finally:
        batch_engine.kernel_route = saved


def phase_main(pair, device, label="bf16 KV", gen=None):
    """The main path with launch counts: every projection on the stacked
    kernel of the weight format (K1b for INT4, K6b for NF4/FP4, K7b for
    INT8) and the lm_head on its 2D kernel, and, under
    ``attention_impl="flash"``, every attention on K3 (bf16 KV) or K4 (int8
    KV); no other kernel launches. ``gen``: tokens a timed call (default
    ``bench.GEN``). Returns its summary and the launch counts of this
    run."""
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
    gen, gamma = gen or bench.GEN, bench.GAMMA
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


def phase_serve(pair, device, label="bf16 KV", engines=("paged", "slotted"),
                profile=True):
    """The serving main path: the paged engine and (unless ``engines``
    leaves it out) the slotted one, each with the launch counts of its own
    passes. The paged engine's target attends through K8a (bf16 KV) or K8b
    (int8 KV), 22 launches per paged forward; every slotted forward (the
    hybrid drafter's steps, the dense admissions, all of the slotted
    engine's forwards) attends through K3 or K4, whatever
    ``attention_impl`` says. Every forward runs its projections on the
    weight format's stacked kernel and its lm_head on the 2D one. Returns
    (summary, launches summed over the engines). ``profile=False`` skips
    the profiled pass."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core import model as tmodel

    t_cfg, d_cfg = pair[0], pair[1]
    L, Ld, gamma = t_cfg.num_layers, d_cfg.num_layers, bench.SERVE_GAMMA
    paged_kernel = "K8b" if t_cfg.kv_quant == "int8" else "K8a"
    attn = batch_attention_kernel(t_cfg)
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
    for r in runs[:1 if profile else 0]:
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

# phase 4c: google/gemma-2b's config.json on the Hugging Face hub, the
# fields the port reads, at its published widths (typed here; nothing is
# downloaded): 18 layers of hidden 2048, 8 query heads over 1 KV head of
# 256, intermediate 16384, vocabulary 256000, tied embeddings, embedding
# scale sqrt(2048). Random weights at 0.02 from GEMMA_SEED, INT4, fused; the
# drafter is its first GEMMA_DRAFT_LAYERS layers (LayerSkip, as bench.py
# pairs). Single sequence: GEMMA_GEN greedy tokens, AR and speculative at
# GEMMA_GAMMA; serving: GEMMA_REQUESTS requests on the paged engine at
# gamma GEMMA_SERVE_GAMMA in pages of GEMMA_PAGE (phase 3b's gemma-serve
# shape); then the f32 refusal at GEMMA_F32_LAYERS layers
GEMMA_2B = {"model_type": "gemma", "hidden_size": 2048,
            "num_hidden_layers": 18, "num_attention_heads": 8,
            "num_key_value_heads": 1, "head_dim": 256,
            "intermediate_size": 16384, "vocab_size": 256000,
            "max_position_embeddings": 8192, "rope_theta": 10000.0,
            "rms_norm_eps": 1e-6, "hidden_activation": "gelu_pytorch_tanh",
            "tie_word_embeddings": True}
GEMMA_SEED, GEMMA_DRAFT_LAYERS = 4, 4
GEMMA_GEN, GEMMA_GAMMA = 32, 12
GEMMA_REQUESTS, GEMMA_SERVE_GAMMA, GEMMA_PAGE = 4, 8, 16
GEMMA_F32_LAYERS = 2
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
# NASD serving: the serving phase's 16 prompts, 8 slots
NASD_SLOTS = 8
# phases 7b and 8c (NASD and EAGLE serving): SERVE_SHORT_GEN tokens a
# request (the serving phase decodes 128), so that the run holds phase 10
# within its time
SERVE_SHORT_GEN = 64
BEAM_GEN, BEAM_WIDE = 32, 4
ATTENTION_KERNELS = ("K2", "K8a", "K5", "K8b", "K3", "K4")


def gemma_model(device, dtype=torch.bfloat16, num_layers=None,
                quant="int4"):
    """Phase 4c's model: GEMMA_2B through the port's ``config_from_hf``,
    random weights from GEMMA_SEED (``quant``: INT4, fused; None: dense).
    Returns (cfg, params)."""
    from specdec_tpu_torch.core.hf_loader import config_from_hf
    from specdec_tpu_torch.core.model import init_params
    from specdec_tpu_torch.quant.core import quantize_params

    cfg = config_from_hf(GEMMA_2B, dtype=dtype)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    gen = torch.Generator(device=device).manual_seed(GEMMA_SEED)
    params = init_params(cfg, scale=0.02, device=device, generator=gen)
    if quant is not None:
        params = quantize_params(params, kind=quant, fuse=True)
    return cfg, params


def gemma_counts(what, counts, attn, want_attn):
    """The launches of phase 4c's runs: ``want_attn`` of the attention
    kernel ``attn`` (each layer of each forward attends once), four K1b a
    layer, no K1a (the head is the tied embedding) and nothing else."""
    want = {k: 0 for k in counts}
    want[attn] = want_attn
    want["K1b"] = 4 * want_attn
    if want_attn == 0 or counts != want:
        fail(f"4c {what}: launches {counts}, expected {want}")


def phase_gemma(device, card):
    """Phase 4c, head_dim 256 at full width: gemma-2b's widths, INT4, a
    4-layer LayerSkip drafter, under ``attention_impl="flash"`` with bf16
    KV and with int8 KV. Greedy AR and speculative decoding (GreedyProcessor
    at GREEDY_T: a draft is accepted iff it is the target's argmax) of one
    sequence attend through K3 (K4) in every layer of every forward, and
    the paged engine serves GEMMA_REQUESTS requests through K8a (K8b) in
    every target forward and K3 (K4) in every slotted one; every output
    equals the plain attention's greedy AR (``"xla"``) or parts from it at
    a top-two tie. Then float32 activations over float32 KV (2 layers, the
    one combination the kernels refuse at head_dim 256): the plain route
    by config, logits equal to the plain path's, and ``use_kernel=True``
    raises before any launch. Returns (summary, launches summed)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core import model as tmodel
    from specdec_tpu_torch.core.cache import init_cache
    from specdec_tpu_torch.core.paged_cache import init_paged_cache
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )
    from specdec_tpu_torch.sampling.processors import GreedyProcessor
    from specdec_tpu_torch.serve import PagedContinuousBatcher

    t0 = time.perf_counter()
    base, target = gemma_model(device)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    drafter = dict(target, layers=tmodel.layer_views(target["layers"],
                                                     GEMMA_DRAFT_LAYERS))
    L, Ld, gamma = base.num_layers, GEMMA_DRAFT_LAYERS, GEMMA_GAMMA
    prompt = bench.bench_prompt(seed=GEMMA_SEED)
    prompts = [bench.bench_prompt(seed=GEMMA_SEED + 1 + i)
               for i in range(GEMMA_REQUESTS)]
    greedy, cold = GreedyProcessor(), GreedyProcessor(temperature=GREEDY_T)
    out, total = {"card": card, "build_s": built}, {}
    for label, kv in (("bf16 KV", "none"), ("int8 KV", "int8")):
        plain = base.replace(kv_quant=kv, attention_impl="xla")
        cfg = plain.replace(attention_impl="flash")
        d_cfg = cfg.replace(num_layers=Ld)
        if not tmodel.kernel_route(cfg):
            fail(f"4c {label}: head_dim 256 in bf16 not routed to the "
                 "attention kernels")
        attn, paged = ("K4", "K8b") if kv == "int8" else ("K3", "K8a")

        def ar(c, n):
            return timed_call(lambda: bench.run_ar(c, target, prompt, n,
                                                   greedy, 0, device))
        for c in (plain, cfg):  # warm-up
            ar(c, 4)
        ref, plain_s = ar(plain, GEMMA_GEN)
        reset_launches()
        got, kernel_s = ar(cfg, GEMMA_GEN)
        gemma_counts(f"{label} AR", launches(), attn, L * GEMMA_GEN)
        by_path = launches()
        reset_launches()
        spec = bench.run_spec(d_cfg, drafter, cfg, target, prompt, GEMMA_GEN,
                              gamma, cold, 0, device)
        w = spec["windows"]
        gemma_counts(f"{label} speculative", launches(), attn,
                     L * (1 + w) + Ld * (1 + gamma * w))
        for k, n in launches().items():
            by_path[k] += n
        parted = {what: check_greedy(f"4c {label} {what}", plain, target,
                                     [prompt], [ref["ids"]], [out["ids"]],
                                     device, {})
                  for what, out in (("AR", got), ("speculative", spec))}

        # single-sequence AR keeps the plain attention under "xla" (the
        # batch engine would attend through K3)
        refs = [autoregressive_generate(p, plain, target,
                                        max_gen_len=GEMMA_GEN,
                                        eos_tokens_id=(), device=device)
                for p in prompts]
        b = PagedContinuousBatcher(
            d_cfg, drafter, cfg, target, num_slots=GEMMA_REQUESTS,
            gamma=GEMMA_SERVE_GAMMA, max_prompt_len=64,
            max_new_tokens=GEMMA_GEN, page_size=GEMMA_PAGE,
            logits_processor=cold, eos_tokens_id=(), device=device)
        reset_launches()
        calls = tmodel.forward_step_paged.calls
        ids = [b.submit(p) for p in prompts]
        done, serve_s = timed_call(b.run)
        served = launches()
        forwards = tmodel.forward_step_paged.calls - calls
        want = {k: 0 for k in served}
        want[paged], want["K1b"] = L * forwards, 4 * (served[attn]
                                                      + L * forwards)
        want[attn] = served[attn]
        if forwards == 0 or served[attn] == 0 or served != want:
            fail(f"4c {label} serving: launches {served} over {forwards} "
                 f"paged target forwards; expected {want}")
        for k, n in served.items():
            by_path[k] += n
        parted["serving"] = check_greedy(
            f"4c {label} serving", plain, target, prompts, refs,
            [done[j].output_ids for j in ids], device, {})
        rec = {"ar_ms_per_token": kernel_s / GEMMA_GEN * 1e3,
               "ar_ms_per_token_plain": plain_s / GEMMA_GEN * 1e3,
               "spec_windows": w, "spec_acceptance": spec["acceptance"],
               "serving_s": serve_s, "paged_forwards": forwards,
               "parted": parted,
               "launches": {k: n for k, n in by_path.items() if n}}
        out[label] = rec
        for k, n in by_path.items():
            total[k] = total.get(k, 0) + n
        say(f"[4c gemma] {label}, gemma-2b widths ({L} layers, Hq=8, Hk=1, "
            f"Dh=256, V=256000), INT4: AR {rec['ar_ms_per_token']:.2f} ms a "
            f"token on the kernels, {rec['ar_ms_per_token_plain']:.2f} on "
            f"the plain attention ({card}); {L} {attn} a target forward, "
            f"{Ld} a drafter forward; spec gamma {gamma}: {w} windows, "
            f"acceptance {spec['acceptance']:.3f}; serving {GEMMA_REQUESTS} "
            f"requests x {GEMMA_GEN} tokens in {serve_s:.2f} s, {forwards} "
            f"paged forwards through {paged}; tokens == the plain "
            f"attention's greedy AR but for partings at a top-two tie at "
            f"tokens {parted}; launches {rec['launches']}")
    del target, drafter
    torch.cuda.empty_cache()

    # float32 over float32 KV: the plain route, and a forced kernel refused
    cfg32, params = gemma_model(device, torch.float32, GEMMA_F32_LAYERS,
                                quant=None)
    cfg = cfg32.replace(attention_impl="flash")
    if tmodel.kernel_route(cfg):
        fail("4c f32: float32 over float32 KV routed to the kernels at "
             "head_dim 256")
    toks = torch.tensor([prompt], device=device)
    MP = -(-len(prompt) // GEMMA_PAGE)

    def paged_cache(c):
        cache = init_paged_cache(c, 1, MP + 1, GEMMA_PAGE, MP, device=device)
        cache.page_table[0] = torch.arange(1, MP + 1, device=device)
        return cache

    reset_launches()
    got = {"slotted flash": tmodel.forward_step(
               cfg, params, toks, init_cache(cfg, 1, len(prompt),
                                             device=device))[0],
           "slotted plain": tmodel.forward_step(
               cfg32, params, toks, init_cache(cfg32, 1, len(prompt),
                                               device=device))[0],
           "paged": tmodel.forward_step_paged(cfg, params, toks,
                                              paged_cache(cfg))[0],
           "paged gather": tmodel.forward_step_paged(
               cfg32, params, toks, paged_cache(cfg32), use_kernel=False)[0]}
    torch.cuda.synchronize()
    if any(launches().values()):
        fail(f"4c f32: kernels launched {launches()}")
    if not (torch.equal(got["slotted flash"], got["slotted plain"])
            and torch.equal(got["paged"], got["paged gather"])
            and all(bool(torch.isfinite(v).all()) for v in got.values())):
        fail("4c f32: the flash and paged forwards differ from the plain "
             "paths, or are not finite")
    try:
        tmodel.forward_step_paged(cfg, params, toks, paged_cache(cfg),
                                  use_kernel=True)
    except ValueError:
        pass
    else:
        fail("4c f32: use_kernel=True did not raise at head_dim 256")
    if any(launches().values()):
        fail(f"4c f32: use_kernel=True launched {launches()} before raising")
    del params
    torch.cuda.empty_cache()
    say(f"[4c gemma] float32 over float32 KV, {GEMMA_F32_LAYERS} layers at "
        "gemma-2b widths: the plain route by config (slotted flash == plain, "
        "paged == gather path, bit for bit, no kernel launched); "
        "use_kernel=True raised before any launch")
    out["seconds"] = time.perf_counter() - t0
    return out, total


# 4e: DeepSeek-V2-Lite's published config (deepseek-ai/DeepSeek-V2-Lite,
# config.json: latent attention, 64 experts top-6 plus 2 shared, YaRN)
# through ``config_from_hf``, cut to DEEPSEEK_LAYERS layers (layer 0 dense,
# then expert layers), random weights from DEEPSEEK_SEED, INT4 and fused
# by ``quantize_params``. The expert kernel's routings (label, tokens,
# experts used), each token to 6 distinct experts: the longreason cell's
# draft step (64 slots, ~6 rows an expert), its verify (64 x 5 rows, ~30)
# and an 8192-token admission (~770), and a draft step over half the
# experts (32 given no row). The decompressed form's K3 calls (label, T):
# admissions of T rows at offset 0 over the cell's scratch cache of
# DEEPSEEK_ADMIT_S = P + O + gamma + 2 positions
DEEPSEEK_V2_LITE = {
    "model_type": "deepseek_v2", "hidden_size": 2048,
    "intermediate_size": 10944, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "vocab_size": 102400,
    "max_position_embeddings": 163840, "rope_theta": 10000,
    "rms_norm_eps": 1e-6, "moe_intermediate_size": 1408,
    "n_routed_experts": 64, "n_shared_experts": 2,
    "num_experts_per_tok": 6, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "n_group": 1, "topk_group": 1,
    "topk_method": "greedy", "scoring_func": "softmax",
    "norm_topk_prob": False, "routed_scaling_factor": 1,
    "attention_bias": False, "tie_word_embeddings": False,
    "rope_scaling": {"type": "yarn", "factor": 40,
                     "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707}}
DEEPSEEK_LAYERS, DEEPSEEK_SEED = 3, 7
EXPERT_ROUTINGS = (("draft", 64, 64), ("verify", 320, 64),
                   ("admission", 8192, 64), ("half-empty", 64, 32))
DEEPSEEK_ADMIT_S = 8192 + 1536 + 4 + 2
MLA_PREFILLS = (("admission-4k", 4096), ("admission-8k", 8192))
# phase 4e's launch-count run: a prefill of DEEPSEEK_PREFILL rows (the
# decompressed form), then DEEPSEEK_STEPS steps of gamma + 1 rows (the
# absorbed form)
DEEPSEEK_PREFILL, DEEPSEEK_STEPS = 512, 2


def deepseek_model(device):
    """Phase 4e's model: DEEPSEEK_V2_LITE through ``config_from_hf`` at
    DEEPSEEK_LAYERS layers, bf16, random weights N(0, 0.02^2) (norms 1)
    from DEEPSEEK_SEED in the loader's layout (``params_from_hf``), INT4
    through ``quantize_params`` (fused; each expert alone; W_UK/W_UV set
    there). Returns (cfg, params)."""
    from specdec_tpu_torch.core.hf_loader import config_from_hf
    from specdec_tpu_torch.quant.core import quantize_params

    cfg = config_from_hf(DEEPSEEK_V2_LITE, dtype=torch.bfloat16).replace(
        num_layers=DEEPSEEK_LAYERS)
    gen = torch.Generator(device=device).manual_seed(DEEPSEEK_SEED)
    D, H, r = cfg.hidden_size, cfg.num_heads, cfg.kv_lora_rank
    nope, rope, v = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    E, Fe = cfg.n_routed_experts, cfg.moe_intermediate_size
    Fs = Fe * cfg.n_shared_experts

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=device)
                * 0.02).to(torch.bfloat16)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=device)

    layers = []
    for i in range(cfg.num_layers):
        lay = {"attn_norm_w": ones(D), "mlp_norm_w": ones(D),
               "kv_norm_w": ones(r), "wq": w(D, H * (nope + rope)),
               "w_kva": w(D, r + rope), "w_kvb": w(r, H * (nope + v)),
               "wo": w(H * v, D)}
        if cfg.is_moe_layer(i):
            lay.update(router=w(D, E), shared_gate=w(D, Fs),
                       shared_up=w(D, Fs), shared_down=w(Fs, D),
                       experts_gate=w(E, D, Fe), experts_up=w(E, D, Fe),
                       experts_down=w(E, Fe, D))
        else:
            F_ = cfg.intermediate_size
            lay.update(w_gate=w(D, F_), w_up=w(D, F_), w_down=w(F_, D))
        layers.append(quantize_params({"layers": lay}, kind="int4",
                                      fuse=True, cfg=cfg)["layers"])
        del lay
    params = quantize_params(
        {"embed": w(cfg.vocab_size, D), "layers": [],
         "final_norm_w": ones(D), "lm_head": w(D, cfg.vocab_size)},
        kind="int4", fuse=True, cfg=cfg)
    params["layers"] = layers
    return cfg, params


def expert_routing(T, used, E, k, gen, device):
    """(offsets int32 [E + 1], rows int32 [T * k]) of T tokens, each to k
    distinct experts drawn among the first ``used`` of E: the assignments
    sorted by expert, as ``core/moe.py`` sorts them."""
    idx = torch.rand((T, used), generator=gen, device=device).topk(k).indices
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(E, dtype=torch.int32, device=device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    return offsets, (order // k).to(torch.int32)


def phase_deepseek(device, card):
    """Phase 4e, latent attention and experts at DeepSeek-V2-Lite's widths
    (``deepseek_model``):

    - the grouped INT4 expert kernel (``int4_expert_matmul``) against its
      plain version (each expert's rows through K1's plain version) on
      the same CUDA inputs, on layer 1's own expert stacks: gate/up (K
      2048, N 2816) and down (K 1408, N 2048) at EXPERT_ROUTINGS. It
      forms K1's bf16 weights and differs only in the f32 sums' order, so
      phase 3's tolerance and share of bit-equal outputs hold; timed
      against ``portbench/expert_bound.py``'s bound;
    - the decompressed form's padded K3 call (head width 256, the model's
      softmax scale) at MLA_PREFILLS, on q, K and V from layer 0's own
      projections: ``mla.decompressed`` on the kernel against the plain
      attention of the unpadded heads (phase 3c's bf16 tolerance), its
      padding columns exactly zero; timed against the unpadded work's
      bound (``attention_bound_ms`` at Dh (192 + 128) / 2 = 160 counts
      its q, K, V and out bytes and q.k + p.v operations exactly);
    - launches, counted from zero over a prefill of DEEPSEEK_PREFILL rows
      and DEEPSEEK_STEPS steps of gamma + 1 rows: K3 once a layer of the
      prefill, the MLA decode kernel once a layer of every step (the
      absorbed form), the expert kernel twice an expert layer of every
      forward, no other attention kernel.

    Returns (expert records, MLA records, launches)."""
    from portbench.expert_bound import expert_bound_s
    from specdec_tpu_torch.core import mla
    from specdec_tpu_torch.core.cache import init_cache
    from specdec_tpu_torch.core.model import (
        forward_step, masked_attention, rms_norm,
    )
    from specdec_tpu_torch.core.rope import rope_cos_sin
    from specdec_tpu_torch.ops import expert_matmul as em
    from specdec_tpu_torch.ops import mla_attention as ma
    from specdec_tpu_torch.ops.decode_attention import flash_decode_attention

    t0 = time.perf_counter()
    cfg, params = deepseek_model(device)
    torch.cuda.synchronize()
    say(f"[4e deepseek] built {DEEPSEEK_LAYERS} layers at DeepSeek-V2-Lite "
        f"widths (INT4) in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(DEEPSEEK_SEED + 1)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=device)
    lay = params["layers"][1]
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    D, Fe = cfg.hidden_size, cfg.moe_intermediate_size
    expert_records = []
    for label, T, used in EXPERT_ROUTINGS:
        offsets, rows = expert_routing(T, used, E, k, gen, device)
        touched = int((offsets[1:] > offsets[:-1]).sum())
        x = torch.randn((T, D), generator=gen, device=device).to(
            torch.bfloat16)
        u = torch.randn((T * k, Fe), generator=gen, device=device).to(
            torch.bfloat16)
        for name, w, xin, r in (("gate_up", lay["experts_gateup"], x, rows),
                                ("down", lay["experts_down"], u, None)):
            K, N = xin.shape[1], w.packed.shape[-1]
            got = em.int4_expert_matmul(xin, w, offsets, r).float()
            plain = em.int4_expert_matmul_reference(xin, w, offsets,
                                                    r).float()
            err, rel, ok = kernel_vs_plain(got, plain)
            equal = (got == plain).float().mean().item()
            what = f"4e expert {label} {name} ({T} tokens, {touched} experts)"
            if not ok:
                fail(f"{what}: kernel vs plain max abs err {err:.3g}, "
                     f"relative Frobenius {rel:.3g}")
            if equal < MIN_BIT_EQUAL:
                fail(f"{what}: only {equal:.3%} of the kernel's outputs "
                     f"bit-equal to the plain version's (at least "
                     f"{MIN_BIT_EQUAL:.0%})")
            bound = expert_bound_s(T * k, K, N, touched) * 1e3
            t_ops = 2.0 * (T * k) * K * N / BF16_OPS_PER_S * 1e3
            rec = {"name": f"{label} {name}", "tokens": T, "rows": T * k,
                   "K": K, "N": N, "experts_touched": touched,
                   "max_abs_err": err, "rel_fro_err": rel, "bit_equal": equal,
                   "ms": gpu_ms(lambda: em.int4_expert_matmul(
                       xin, w, offsets, r), flush),
                   "plain_ms": gpu_ms(lambda: em.int4_expert_matmul_reference(
                       xin, w, offsets, r), flush),
                   "bound_ms": bound,
                   "bound_by": "operations" if t_ops >= bound else "bytes"}
            expert_records.append(rec)
            say(f"[4e deepseek] expert {label:10s} {name:7s} rows={T * k:5d} "
                f"K={K} N={N} experts={touched}: kernel "
                f"{rec['ms'] * 1e3:8.1f} us, plain {rec['plain_ms'] * 1e3:9.1f}"
                f" us (a host loop over the experts), bound "
                f"{bound * 1e3:7.1f} us ({rec['bound_by']}, "
                f"{100 * bound / rec['ms']:.1f}%); max abs err {err:.3g}, "
                f"rel {rel:.2g}, bit-equal {equal:.3%}")

    # the decompressed form over layer 0's projections of random hidden
    # states, as an admission's prefill computes them
    lay0 = params["layers"][0]
    H, v = cfg.num_heads, cfg.v_head_dim
    mla_records = []
    for label, T in MLA_PREFILLS:
        q_pos = torch.arange(T, dtype=torch.int32, device=device)[None]
        cos, sin = rope_cos_sin(q_pos, cfg.rotary_dim, cfg.rope_theta,
                                scaling=cfg.rope_scaling)
        h = rms_norm(torch.randn((1, T, D), generator=gen, device=device).to(
            torch.bfloat16), lay0["attn_norm_w"], cfg.norm_eps)
        q_nope, q_pe, lat = mla.project(cfg, lay0, h, cos, sin)
        q, kh, vh = mla.decompressed_heads(cfg, lay0, q_nope, q_pe, lat)
        got = mla.decompressed(cfg, lay0, q_nope, q_pe, lat, q_pos,
                               True).reshape(1, T, H, v)
        plain = masked_attention(q, kh, vh, q_pos, H,
                                 scale=cfg.attn_scale).reshape(1, T, H, v)
        pv = masked_attention(q.float(), kh.float(), vh.float().abs(), q_pos,
                              H, scale=cfg.attn_scale).reshape(1, T, H, v)
        what = f"4e mla {label}"
        rec = {"name": label, "B": 1, "S": DEEPSEEK_ADMIT_S, "T": T,
               "heads": [H, H, mla.KERNEL_HEAD_DIM], "scale": cfg.attn_scale,
               **check_attention(what, got, plain, pv)}
        del plain, pv

        def pad(t):
            return F.pad(t, (0, mla.KERNEL_HEAD_DIM - t.shape[-1])
                         ).contiguous()

        # the padded call as the prefill makes it, over the scratch cache's
        # S positions (those past T are never read: offset 0)
        kp, vp = (torch.zeros((1, DEEPSEEK_ADMIT_S, H, mla.KERNEL_HEAD_DIM),
                              dtype=torch.bfloat16, device=device)
                  for _ in range(2))
        kp[:, :T], vp[:, :T] = pad(kh), pad(vh)
        qp, off = pad(q), torch.zeros(1, dtype=torch.int32, device=device)
        padded = flash_decode_attention(qp, kp, vp, off, scale=cfg.attn_scale)
        if torch.count_nonzero(padded[..., v:]).item():
            fail(f"{what}: the padded call's columns past v are not zero")
        b, by = attention_bound_ms(T, 1, T, H, H, (192 + 128) // 2,
                                   T * (T + 1) // 2)
        rec.update(ms=gpu_ms(lambda: flash_decode_attention(
            qp, kp, vp, off, scale=cfg.attn_scale), flush),
            plain_ms=gpu_ms(lambda: masked_attention(
                q, kh, vh, q_pos, H, scale=cfg.attn_scale), flush),
            bound_ms=b, bound_by=by)
        mla_records.append(rec)
        say(f"[4e deepseek] K3 padded {label} T={T} S={DEEPSEEK_ADMIT_S} "
            f"Dh=256 scale={cfg.attn_scale:.6g}: kernel "
            f"{rec['ms'] * 1e3:9.1f} us, plain {rec['plain_ms'] * 1e3:9.1f} "
            f"us, bound {b * 1e3:7.1f} us ({by}, {100 * b / rec['ms']:.1f}%); "
            f"max abs err {rec['max_abs_err']:.3g} ({rec['max_ulps']:.0f} "
            f"ulps at worst, {rec['within_1ulp']:.1%} within one; "
            f"{rec['bound_ratio']:.2f} of the allowance); padding columns "
            "zero")
        del q, kh, vh, qp, kp, vp, padded
        torch.cuda.empty_cache()

    # launches from zero over a prefill and the steps after it
    L = cfg.num_layers
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(L))
    gamma = 4
    cache = init_cache(cfg, 1, DEEPSEEK_PREFILL + DEEPSEEK_STEPS * (gamma + 1),
                       device=device)
    toks = torch.randint(0, cfg.vocab_size, (1, DEEPSEEK_PREFILL),
                         generator=gen, device=device)
    reset_launches()
    em.int4_expert_matmul.launches = 0
    ma.mla_decode_attention.launches = 0
    logits, cache = forward_step(cfg, params, toks, cache, use_kernel=True)
    for _ in range(DEEPSEEK_STEPS):
        logits, cache = forward_step(cfg, params, toks[:, :gamma + 1], cache,
                                     use_kernel=True)
    torch.cuda.synchronize()
    counts = dict(launches(), expert=em.int4_expert_matmul.launches,
                  mla=ma.mla_decode_attention.launches)
    forwards = 1 + DEEPSEEK_STEPS
    attn = {k: n for k, n in counts.items() if k in ATTENTION_KERNELS and n}
    if (counts["K3"] != L or counts["expert"] != 2 * moe_layers * forwards
            or counts["mla"] != L * DEEPSEEK_STEPS or attn != {"K3": L}
            or not bool(torch.isfinite(logits).all())):
        fail(f"4e deepseek: launches {counts} over a prefill and "
             f"{DEEPSEEK_STEPS} steps; expected K3 {L} (the prefill's "
             f"layers), the expert kernel {2 * moe_layers * forwards} (two "
             f"an expert layer and forward), the MLA decode kernel "
             f"{L * DEEPSEEK_STEPS} (a layer of every step), no other "
             "attention kernel, and finite logits")
    say(f"[4e deepseek] launches over a {DEEPSEEK_PREFILL}-row prefill and "
        f"{DEEPSEEK_STEPS} steps of {gamma + 1} rows: K3 {counts['K3']}, the "
        f"expert kernel {counts['expert']}, the MLA decode kernel "
        f"{counts['mla']}, K1a {counts['K1a']} ({card})")
    del params
    torch.cuda.empty_cache()
    return expert_records, mla_records, counts


def expert_entry(records, counts):
    """The ``kernels`` line's entry of the grouped expert kernel: the
    top-level times are one verify forward's expert layer (its gate/up and
    down launches at ~30 rows an expert)."""
    top = [r for r in records if r["name"] in ("verify gate_up",
                                               "verify down")]
    return {"name": "int4_expert_matmul (grouped experts)", "route": "cuda",
            "source": "specdec_tpu_torch/ops/csrc/int4_expert_matmul.cu",
            "replaces": None, "launches": counts["expert"],
            "launches_by_path": {"deepseek_v2_width": counts["expert"]},
            "max_abs_err": max(r["max_abs_err"] for r in records),
            **{k: sum(r[k] for r in top)
               for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in top) else "operations",
            "work": "an expert layer of a verify: 320 tokens x 6 experts, "
                    "gate/up K 2048 N 2816 and down K 1408 N 2048",
            "shapes": records}


# phase 4f's shapes of the MLA decode kernel (label, layout, B, T, capacity,
# live offsets low..high): longreason's 64 slots at T = 1, 2 (draft steps)
# and 5 (the verify at gamma 4) over its live lengths, paged (pages of 64,
# 153 a slot) and slotted (the drafter's cache of DEEPSEEK_ADMIT_S
# positions); then a T = 15 verify (three row groups) and short ragged
# sequences, fewer live tiles than the card has SMs
MLA_PAGE = 64
MLA_SHAPES = (
    ("draft-paged", "paged", 64, 1, 153 * MLA_PAGE, 4096, 9728),
    ("draft2-paged", "paged", 64, 2, 153 * MLA_PAGE, 4096, 9728),
    ("verify-paged", "paged", 64, 5, 153 * MLA_PAGE, 4096, 9728),
    ("draft-slotted", "slotted", 64, 1, DEEPSEEK_ADMIT_S, 4096, 9728),
    ("draft2-slotted", "slotted", 64, 2, DEEPSEEK_ADMIT_S, 4096, 9728),
    ("verify-slotted", "slotted", 64, 5, DEEPSEEK_ADMIT_S, 4096, 9728),
    ("verify15-paged", "paged", 4, 15, 40 * MLA_PAGE, 100, 2400),
    ("short-slotted", "slotted", 3, 2, 256, 0, 200),
)


def mla_inputs(layout, B, T, cap, lo, hi, gen, device):
    """The kernel's inputs at one of MLA_SHAPES: q [B, T, 16, 576] bf16
    (N(0, 0.25): scores of a few units at the model's scale), offsets drawn
    in [lo, min(hi, cap) - T], the latent N(0, 1) bf16; paged: a pool of
    B * MP + 1 pages in a random order behind the tables, sequence 1 dead
    (its table all page 0); slotted: the cache [B, cap, 1, 576]. Returns
    (q, lat, offsets, table or None, live: the rows that are not dead)."""
    H, D = 16, 576
    q = (torch.randn((B, T, H, D), generator=gen, device=device) * 0.5
         ).to(torch.bfloat16)
    offsets = torch.randint(lo, min(hi, cap) - T + 1, (B,), generator=gen,
                            device=device, dtype=torch.int32)
    live = torch.ones(B, dtype=torch.bool, device=device)
    if layout == "slotted":
        lat = torch.randn((B, cap, 1, D), generator=gen,
                          device=device).to(torch.bfloat16)
        return q, lat, offsets, None, live
    MP = cap // MLA_PAGE
    pages = torch.randperm(B * MP, generator=gen, device=device) + 1
    table = pages.reshape(B, MP).to(torch.int32)
    if B > 1:
        table[1] = 0
        live[1] = False
    lat = torch.randn((B * MP + 1, 1, MLA_PAGE, D), generator=gen,
                      device=device).to(torch.bfloat16)
    return q, lat, offsets, table, live


def phase_mla_kernel(device, card, against=None):
    """Phase 4f, the MLA decode kernel (``ops/mla_attention.py``, the
    absorbed form of latent attention) against its plain version on the
    same CUDA inputs at MLA_SHAPES (``mla_inputs``): live rows within phase
    3c's bf16 allowance (one bf16 ulp + 2 * 2**-8 * P.|V|, the plain
    attention of |V|: the kernel rounds the probabilities to bf16 for P.V
    once, the plain version keeps them in float32; q and the latent are the
    same bf16 values on both sides), a dead row's output finite (zeros);
    its launches, one a call (each call a split kernel and its combine);
    timed (CUDA events after an L2 flush, as phase 3) against its bytes
    bound, ``portbench/measure.py::paged_attention_bound_s`` on one layer's
    ``mla_attention`` record (1,152 bytes a live position, 34,816 a query
    row), and against the plain version. ``against``: build_against's
    (NAME, library); where NAME is ``mla_decode_attention``, that library
    is timed in turns with this one (``against_ms``) and its outputs must
    be within the same allowance. Returns the records."""
    from portbench.measure import paged_attention_bound_s
    from specdec_tpu_torch.ops import mla_attention as ma

    gen = torch.Generator(device=device).manual_seed(DEEPSEEK_SEED + 2)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=device)
    scale = 0.1147  # ~ DeepSeek-V2-Lite's attn_scale (1/sqrt(192) * 1.59)
    records = []
    for label, layout, B, T, cap, lo, hi in MLA_SHAPES:
        q, lat, off, table, live = mla_inputs(layout, B, T, cap, lo, hi, gen,
                                              device)
        before = ma.mla_decode_attention.launches
        got = ma.mla_decode_attention(q, lat, off, scale, 512, table)
        torch.cuda.synchronize()
        if ma.mla_decode_attention.launches != before + 1:
            fail(f"4f mla {label}: the wrapper did not count its launch")
        plain = ma.mla_attention_reference(q, lat, off, scale, 512, table)
        vabs = lat.abs()
        pv = ma.mla_attention_reference(q, vabs, off, scale, 512, table)
        what = f"4f mla {label}"
        if not bool(torch.isfinite(got).all()):
            fail(f"{what}: non-finite outputs")
        if not bool((got[~live] == 0).all()):
            fail(f"{what}: a dead row's output is not zeros")
        plain_live, pv_live = plain[live], pv[live]
        rec = {"name": label, "layout": layout, "B": B, "T": T, "H": 16,
               "capacity": cap, "offsets": [int(off.min()), int(off.max())],
               "dead_rows": int((~live).sum()),
               **check_attention(what, got[live], plain_live, pv_live)}
        del plain, pv, vabs
        keys = int(((off.long() + T) * live).sum())
        rows = int(live.sum()) * T
        bound = paged_attention_bound_s(1, 576 * 2, 16 * (2 * 512 + 64) * 2,
                                        keys, rows) * 1e3
        rec.update(live_positions=keys, query_rows=rows,
                   ms=gpu_ms(lambda: ma.mla_decode_attention(
                       q, lat, off, scale, 512, table), flush),
                   plain_ms=gpu_ms(lambda: ma.mla_attention_reference(
                       q, lat, off, scale, 512, table), flush),
                   bound_ms=bound, bound_by="bytes")
        rec["roofline"] = bound / rec["ms"]
        if against and against[0] == "mla_decode_attention":
            with launching(*against):
                other = ma.mla_decode_attention(q, lat, off, scale, 512,
                                                table)
                check_attention(f"{what} (--against)", other[live],
                                plain_live, pv_live)
                rec["against_ms"] = gpu_ms(lambda: ma.mla_decode_attention(
                    q, lat, off, scale, 512, table), flush)
            rec["ms_after"] = gpu_ms(lambda: ma.mla_decode_attention(
                q, lat, off, scale, 512, table), flush)
            say(f"[4f mla] {label}: --against {rec['against_ms'] * 1e3:.1f} "
                f"us, this kernel {rec['ms'] * 1e3:.1f} / "
                f"{rec['ms_after'] * 1e3:.1f} us (before / after it)")
        records.append(rec)
        say(f"[4f mla] {label:15s} B={B} T={T:2d} cap={cap} offsets "
            f"{rec['offsets'][0]}-{rec['offsets'][1]}: kernel "
            f"{rec['ms'] * 1e3:8.1f} us, plain {rec['plain_ms'] * 1e3:9.1f} "
            f"us, bound {bound * 1e3:7.1f} us ({100 * rec['roofline']:.1f}%);"
            f" max abs err {rec['max_abs_err']:.3g} ({rec['bound_ratio']:.2f}"
            f" of the allowance) ({card})")
        del q, lat, off, table, got, plain_live, pv_live
        torch.cuda.empty_cache()
    return records


def mla_entry(records, launches):
    """The ``kernels`` line's entry of the MLA decode kernel: the top-level
    times are one verify layer over the paged pool at longreason's
    shapes."""
    top = next(r for r in records if r["name"] == "verify-paged")
    return {"name": "mla_decode_attention (absorbed latent attention)",
            "route": "cuda",
            "source": "specdec_tpu_torch/ops/csrc/mla_decode_attention.cu",
            "replaces": None, "launches": launches,
            "launches_by_path": {"deepseek_v2_width": launches},
            "max_abs_err": max(r["max_abs_err"] for r in records),
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes",
            "work": "one verify layer: 64 slots x 5 positions x 16 heads "
                    "over 4,096-9,728 live latent positions, pages of 64",
            "shapes": records}


def nasd_prompts():
    rng = np.random.default_rng(3)
    lens = [60] + [int(n) for n in rng.integers(40, 61, size=7)]
    return [[int(t) for t in rng.integers(1, 32000, size=n)] for n in lens]


def teacher_forced(what, cfg, params, prompts, outs, device, shape,
                   root=False, step_cfg=None, max_ulps=2, ties_at=None):
    """Every token of every output is the target's argmax over its own
    prefix, or within greedy_tie's two bf16 ulps below it, in a replay of
    the engine's computation: ``shape`` = (P, S, T, admit): the prompts
    padded to P and prefilled on a cache of S positions (each alone, as a
    serving admission, if ``admit``, on a scratch cache of ``admit``
    positions where it is a number, as the serving engine's dense
    admission has it; else as one batch), then one forward
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
    allowed (TREE_REPLAY_ULPS for the tree engines). ``ties_at``: {output
    index: token} where the output parts from its greedy AR reference; the
    replay's top two logits there must lie within ``max_ulps`` (the
    parting is a tie of the engine's own computation). Returns (tokens
    checked, tokens not the argmax, largest gap in ulps)."""
    from specdec_tpu_torch.core.cache import init_cache, storage_fields
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
        first, S1 = [], S if admit is True else admit
        for i in range(N):
            one = init_cache(cfg, 1, S1, device=device)
            lg, one = forward_step(cfg, params, padded[i:i + 1], one)
            first.append(lg[0, len(prompts[i]) - 1])
            for name in storage_fields(cache):
                getattr(cache, name)[:, i, :S1].copy_(getattr(one, name)[:, 0])
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
        for i in [i for i, t in (ties_at or {}).items() if t == j]:
            top2 = rows[i].topk(2).values
            tie = ((top2[0] - top2[1]) / ulp[i]).item()
            if tie > max_ulps:
                fail(f"{what}, sequence {i}: parts from greedy AR at token "
                     f"{j} where the replay's top-2 logit gap is {tie:.2f} "
                     f"bf16 ulps (at most {max_ulps})")
    ratio = torch.stack(gaps, dim=1)                               # [N, L]
    if (ratio > max_ulps).any():
        # the first token past the tie rule, by position
        j, i = (ratio > max_ulps).t().nonzero()[0].tolist()
        fail(f"{what}: token {j} ({outs[i][j]}) of a sequence of prompt "
             f"length {len(prompts[i])} is {ratio[i, j].item():.2f} bf16 "
             f"ulps below the target's argmax over its prefix (at most "
             f"{max_ulps})")
    return (int(live.sum()), int((ratio > 0).sum()), ratio.max().item())


def admitted_greedy_ar(cfg, params, prompts, gen, P, S, device):
    """Greedy AR of each prompt as the serving engine admits it: padded to
    P and prefilled alone on a scratch cache of S positions
    (``serve/scheduler.py::_scratch_prefill``, on the batch engine's
    attention route), then one token a step on that cache, the prompts
    batched. An engine's verify then reads the same prompt K/V and decodes
    through another attention (the paged kernel over the page table), as
    an independent reference's decode should."""
    from specdec_tpu_torch.core.cache import init_cache, storage_fields
    from specdec_tpu_torch.core.model import forward_step, kernel_route
    from specdec_tpu_torch.serve.scheduler import _scratch_prefill

    cache = init_cache(cfg, len(prompts), S, device=device)
    first = []
    for i, p in enumerate(prompts):
        padded = torch.zeros((P,), dtype=torch.int64, device=device)
        padded[:len(p)] = torch.tensor(p, device=device)
        lg, one = _scratch_prefill(cfg, params, padded, S)
        first.append(lg[0, len(p) - 1].argmax())
        for name in storage_fields(cache):
            getattr(cache, name)[:, i].copy_(getattr(one, name)[:, 0])
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=device)
    toks = [torch.stack(first)]
    for j in range(1, gen):
        lg, cache = forward_step(cfg, params, toks[-1][:, None],
                                 cache.with_length(lens + j - 1),
                                 use_kernel=kernel_route(cfg))
        toks.append(lg[:, 0].argmax(dim=-1))
    return torch.stack(toks, dim=1).tolist()


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


def forward_launches(what, counts, cfg, params, extra=(), batch=False):
    """The launch counts of a run of target forwards: each forward launches
    the stacked weight kernel 4 * L times and the lm_head's once, and under
    the flash kernel the slotted attention kernel L times; so does each
    forward of the batch engine (``batch``: ``batch_attention_kernel``),
    whatever ``attention_impl`` says; nothing else launches (``extra``:
    kernels also allowed). Returns the forwards."""
    stacked, two_d = weight_kernels(params)
    L = cfg.num_layers
    forwards = counts[two_d]
    want = {k: 0 for k in counts}
    want[stacked], want[two_d] = 4 * L * forwards, forwards
    attn = slotted_attention_kernel(cfg)
    if attn is not None:
        want[attn] = L * forwards
    elif batch and batch_attention_kernel(cfg) is not None:
        want[batch_attention_kernel(cfg)] = L * forwards
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
        # NASD's loops attend as the config says, and so does the reference
        with plain_batch_route():
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
    serving phase's 16 prompts, SERVE_SHORT_GEN tokens each, greedy, at 1
    and 4 windows per host sync; every request equals its greedy AR tokens (the batched
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
    with plain_batch_route():
        refs = batch_autoregressive_generate(
            prompts, cfg, target, gen_len=SERVE_SHORT_GEN, eos_tokens_id=(),
            device=device)
    say(f"[time] NASD serving: greedy AR references (batched) in "
        f"{time.perf_counter() - t0:.1f} s")
    summary, total, outputs = {}, {k: 0 for k in kernel_wrappers()}, {}
    parted = {}
    for wps in (1, 4):
        b = NasdContinuousBatcher(
            cfg, target, num_slots=NASD_SLOTS, gamma=NASD_GAMMA, n=NASD_N,
            max_prompt_len=bench.SERVE_MAX_PROMPT,
            max_new_tokens=SERVE_SHORT_GEN, eos_tokens_id=(),
            windows_per_sync=wps, device=device)
        reset_launches()
        rec = bench.serve_pass(b, prompts, SERVE_SHORT_GEN)
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
                          (P, P + SERVE_SHORT_GEN + NASD_GAMMA + 2,
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
# default_rng(0) (bench.bench_prompt()), greedy, at its two tail damps (the
# drafter strong and weak); 64 tokens (the benchmark decodes 256), so
# that the run holds phases 9-10 within its time
TREES = ((2, 2, 2), (3, 2, 1), (4, 2))
TREE_DAMPS = (0.08, 0.35)
TREE_GEN = 64
# the replay's tie rule for the tree engines. A tree verify sums each
# node's attention over its ancestors at their tree slots, with the
# other nodes' slots masked in between; the replay sums over contiguous
# positions. Where such a sum sits near a bf16 rounding boundary the two
# round apart, and 22 layers carry it on: on an H100 a parted token lay
# 3.00 ulps below the replay's argmax, where the sequential engines'
# replays (phases 7-7c) stay within 1
TREE_REPLAY_ULPS = 4
# phase 8b, tools/bench_eagle.py's protocol at TREE_GEN tokens (it decodes
# 512): an untrained depth-1 head made on the card from EAGLE_SEED
EAGLE_GAMMAS = (3, 5, 8)
EAGLE_GAMMA = 5
EAGLE_SEED = 7
# greedy chain EAGLE runs GreedyProcessor at this temperature: its
# softmaxes saturate, so a draft is accepted iff it is the target's argmax
# and a rejection commits the argmax, whatever the acceptance draws (at
# temperature 1 the draws decide, and the tokens are not greedy AR's)
GREEDY_T = 1e-4
# phase 8c: the serving phase's prompts, SERVE_SHORT_GEN tokens, 8 slots,
# gamma 5
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
    TREE_GEN tokens): an untrained depth-1 head made on the card from
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
    GREEDY_T), gamma 5, the serving phase's 16 prompts and SERVE_SHORT_GEN
    tokens:
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
    L, gamma, gen = t_cfg.num_layers, EAGLE_GAMMA, SERVE_SHORT_GEN
    proc = GreedyProcessor(temperature=GREEDY_T)
    prompts = bench.serving_prompts()
    t0 = time.perf_counter()
    with plain_batch_route():
        refs = batch_autoregressive_generate(prompts, t_cfg, target,
                                             gen_len=gen, eos_tokens_id=(),
                                             device=device)
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
        rec = bench.serve_pass(b, prompts, gen)
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


# ---------------------------------------------------------------------------
# Phases 9-9d: the benchmark entry point, the loaders and the serving facade
# ---------------------------------------------------------------------------

# phase 9: the README's command (the synthetic TinyLlama-1.1B preset with
# its LayerSkip tail, the drafter its first 4 layers, INT8 weights: K7)
# and its INT4 counterpart in batch mode (K1), each through the CLI in a
# subprocess; then the INT4 configuration in-process, launches counted
README_ENV = dict(TARGET_MODEL="synthetic:llama-1b-ls4",
                  DRAFTER_MODEL="layerskip:4", QUANTIZATION="int8",
                  DRAFTER_QUANTIZATION="int8", NUM_PROMPTS="4",
                  GENERATION_LENGTH="100", GAMMA_VALUE="5")
CLI_RUNS = {"cli_int8": README_ENV,
            "cli_int4": dict(README_ENV, QUANTIZATION="int4",
                             DRAFTER_QUANTIZATION="int4", ENABLE_BATCH="true",
                             BATCH_SIZE="4", NUM_PROMPTS="8")}
# the in-process runs: 4 prompts of HARNESS_GEN tokens, single mode
HARNESS_GEN = 64
HARNESS_RUNS = {
    "target_ar": dict(INFERENCE_METHOD="target_ar"),
    "ngram_device": dict(INFERENCE_METHOD="ngram", NGRAM_DEVICE="true"),
    "eagle": dict(DRAFTER_MODEL="eagle:1"),
    "open_loop": dict(NUM_PROMPTS="0", AUTO_RATE="2", AUTO_DURATION="10"),
}
SHAREGPT_PROMPTS = 64
# the JAX runner's result files (tests/test_torch_harness.py holds the
# port's to them on the CPU): the method's results, each batch, each
# request, and the telemetry
RESULT_KEYS = ["method", "total_requests", "total_batches", "total_duration",
               "total_tokens", "total_prompt_tokens", "overall_throughput",
               "avg_ttft", "avg_latency", "avg_acceptance_rate", "batches"]
BATCH_KEYS = ["batch_size", "batch_latency", "total_tokens", "avg_ttft",
              "avg_latency", "throughput", "requests"]
REQUEST_KEYS = ["prompt_tokens", "generated_tokens", "total_tokens", "ttft",
                "total_latency", "acceptance_rate", "drafts_generated",
                "drafts_accepted"]
MONITOR_KEYS = ["power_source", "num_chips", "duration_s", "samples",
                "avg_power_w", "peak_power_w", "avg_utilization_pct",
                "avg_memory_pct", "peak_memory_pct", "peak_temperature_c",
                "energy_joules", "energy_wh", "energy_kwh", "total_tokens",
                "accepted_tokens", "tokens_per_joule",
                "accepted_tokens_per_joule", "tokens_per_kwh"]
# phase 9c: the 8B preset (32 layers, D=4096, F=14336, V=128256, Hk=8,
# Dh=128) with layerskip:4, INT4, 4 prompts in one batch of 32 tokens
LLAMA8B_ENV = dict(TARGET_MODEL="synthetic:llama-8b",
                   DRAFTER_MODEL="layerskip:4", QUANTIZATION="int4",
                   NUM_PROMPTS="4", ENABLE_BATCH="true", BATCH_SIZE="4",
                   GENERATION_LENGTH="32", INFERENCE_METHOD="speculative")
# K1 at the 8B preset's shapes, at a row count of each of its instances
# (M <= 8, 16, 32, more): a decode step, the B=4 drafter step, the B=4
# verify at gamma 4, a prefill slice
LLAMA8B_STACKED = [("wqkv", 4096, 6144), ("wo", 4096, 4096),
                   ("w_gateup", 4096, 28672), ("w_down", 14336, 4096)]
LLAMA8B_HEAD = ("lm_head", 4096, 128256)
LLAMA8B_ROWS = (1, 4, 20, 256)
# phase 9d: the serving facade on the INT4 pair: VLLM_MAX_MODEL_LEN 512
# (admission prefills min(max_model_len, 2048) rows), 8 slots, gamma 5,
# the serving phase's 16 prompts of 128 tokens arriving at 4 per second
VLLM_ENV = dict(TARGET_MODEL="synthetic:llama-1b-ls4",
                DRAFTER_MODEL="layerskip:4", VLLM_ENABLE_SPECULATIVE="true",
                VLLM_NUM_SPECULATIVE_TOKENS="5", VLLM_QUANTIZATION="int4",
                VLLM_MAX_MODEL_LEN="512", VLLM_MAX_NUM_SEQS="8",
                MAX_TOKENS="128")
VLLM_RATE = 4.0
# its page table: S = 512 + 128 + 5 + 2 positions plus a window, in pages
# of 64, plus one (serve/paged_scheduler.py); phase 3b times this width
VLLM_TABLE_PAGES = 12


@contextlib.contextmanager
def environ(**kv):
    """os.environ with ``kv`` set inside, restored after."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def power_limit_w(card):
    """The power limit of nvidia-smi's "name, limit W" line."""
    return float(card.rsplit(",", 1)[1].split()[0])


def write_sharegpt(path, n=SHAREGPT_PROMPTS, seed=0):
    """A ShareGPT-format JSONL of ``n`` human turns of 10-500 characters
    (words of random letters), each followed by a model turn."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    with open(path, "w") as f:
        for _ in range(n):
            size = int(rng.integers(10, 501))
            words = []
            while sum(map(len, words)) + len(words) < size:
                words.append("".join(rng.choice(letters,
                                                int(rng.integers(1, 9)))))
            text = " ".join(words)[:size].strip().ljust(size, "x")
            f.write(json.dumps({"conversations": [
                {"from": "human", "value": text},
                {"from": "gpt", "value": "ok"}]}) + "\n")


def check_result_files(what, base, method, asked, limit):
    """The runner's three files under ``base``: the JAX runner's keys at
    every level, the method file equal to the combined file's entry, the
    requests asked for (``asked``: a count, or a (low, high) range), NVML
    telemetry with average power inside (0, limit). Returns a summary."""
    stem = base[:-len(".json")]
    suffix = {"target_ar": "target"}.get(method, method)
    try:
        with open(base) as f:
            combined = json.load(f)
        with open(f"{stem}_{suffix}.json") as f:
            alone = json.load(f)
        with open(f"{stem}_gpu.json") as f:
            gpu = json.load(f)
    except (OSError, ValueError) as e:
        fail(f"{what}: result files missing or unreadable: {e}")
    res = combined.get(method, {})
    if sorted(combined) != sorted([method, "gpu_monitoring"]) or \
            list(res) != RESULT_KEYS or alone != res or \
            list(gpu) != MONITOR_KEYS or combined["gpu_monitoring"] != gpu:
        fail(f"{what}: result files' keys {sorted(combined)}, {list(res)}, "
             f"{list(gpu)} are not the JAX runner's")
    reqs = [r for b in res["batches"] for r in b["requests"]]
    if any(list(b) != BATCH_KEYS for b in res["batches"]) or any(
            list(r) != REQUEST_KEYS for r in reqs):
        fail(f"{what}: a batch's or a request's keys are not the JAX "
             "runner's")
    n = res["total_requests"]
    low, high = asked if isinstance(asked, tuple) else (asked, asked)
    if not low <= n <= high or len(reqs) != n:
        fail(f"{what}: {n} requests ({len(reqs)} recorded), asked {asked}")
    if gpu["power_source"] != "nvml" or gpu["samples"] < 1 or not (
            0 < gpu["avg_power_w"] < limit):
        fail(f"{what}: telemetry {gpu['power_source']!r}, {gpu['samples']} "
             f"samples, average {gpu['avg_power_w']} W: not NVML within "
             f"(0, {limit}) W")
    ttft = [r["ttft"] * 1e3 for r in reqs]
    lat = [r["total_latency"] * 1e3 for r in reqs]
    return {"requests": n, "tokens": res["total_tokens"],
            "tok_s": res["overall_throughput"],
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99)),
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p99_ms": float(np.percentile(lat, 99)),
            "acceptance": res["avg_acceptance_rate"],
            "avg_w": gpu["avg_power_w"], "peak_w": gpu["peak_power_w"],
            "tokens_per_joule": gpu["tokens_per_joule"],
            "samples": gpu["samples"], "seconds": res["total_duration"]}


def say_run(phase, name, rec, card, extra=""):
    say(f"[{phase}] {name}: {rec['requests']} requests, {rec['tokens']} "
        f"tokens in {rec['seconds']:.2f} s = {rec['tok_s']:.1f} tok/s "
        f"({card}); TTFT p50 {rec['ttft_p50_ms']:.0f} / p99 "
        f"{rec['ttft_p99_ms']:.0f} ms, latency p50 {rec['latency_p50_ms']:.0f}"
        f" / p99 {rec['latency_p99_ms']:.0f} ms, acceptance "
        f"{rec['acceptance']:.3f}; NVML {rec['samples']} samples, "
        f"{rec['avg_w']:.1f} W average, {rec['peak_w']:.1f} W peak, "
        f"{rec['tokens_per_joule']:.3f} tokens/J" + extra)


def spec_forwards(what, counts, kernels, L, Ld, attn):
    """Target and drafter forwards of a LayerSkip run of the batch engine
    from its launches: the stacked weight kernel 4 (L T + Ld D) times, the
    2D one T + D times, the slotted attention kernel ``attn`` (the batch
    engine's, ``batch_attention_kernel``; None: none) L T + Ld D times,
    nothing else (``kernels``: the format's (stacked, 2D) pair). Returns
    (T, D)."""
    stacked, two_d = kernels
    a, b = counts[stacked], counts[two_d]
    num = a // 4 - Ld * b
    T, D = num // (L - Ld), b - num // (L - Ld)
    others = {k: n for k, n in counts.items() if n and k not in (stacked,
                                                                two_d, attn)}
    if a % 4 or num % (L - Ld) or T <= 0 or D <= 0 or others or (
            attn is not None and counts[attn] != L * T + Ld * D):
        fail(f"{what}: launches {counts} are no whole number of {L}-layer "
             f"target and {Ld}-layer drafter forwards")
    return T, D


def run_cli(name, env, root, workdir, limit, card):
    """``python -m specdec_tpu_torch.cli.benchmark`` in a subprocess: the
    module run as ``-m`` runs it (runpy, ``__main__``, argv untouched),
    then the launch counts of the port's kernel wrappers printed. Returns
    (result summary, launch counts)."""
    code = ("import json, runpy, chip_smoke\n"
            "try:\n"
            "    runpy.run_module('specdec_tpu_torch.cli.benchmark', "
            "run_name='__main__', alter_sys=True)\n"
            "finally:\n"
            "    print('LAUNCHES ' + json.dumps(chip_smoke.launches()))\n")
    base = os.path.join(workdir, f"{name}.json")
    full = dict(os.environ, **env, OUTPUT_FILE=base,
                SHAREGPT_DIR=workdir, GPU_MONITOR_INTERVAL="0.5",
                PYTHONPATH=os.pathsep.join(
                    [root] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=full,
                          capture_output=True, text=True, timeout=400)
    seconds = time.perf_counter() - t0
    with open(os.path.join(workdir, f"{name}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    counts = [json.loads(line[len("LAUNCHES "):])
              for line in proc.stdout.splitlines()
              if line.startswith("LAUNCHES ")]
    if proc.returncode or not counts:
        fail(f"9 {name}: the CLI exited {proc.returncode}:\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rec = check_result_files(f"9 {name}", base, "speculative",
                             int(env["NUM_PROMPTS"]), limit)
    rec["process_seconds"] = seconds
    return rec, counts[0]


def recording(module, names, calls):
    """Wrap ``module``'s functions ``names`` to append (args, result) to
    ``calls``; returns the originals, to restore."""
    saved = {n: getattr(module, n) for n in names}
    for n, fn in saved.items():
        def wrapped(*a, _fn=fn, _n=n, **k):
            out = _fn(*a, **k)
            calls.append((_n, a, out))
            return out
        setattr(module, n, wrapped)
    return saved


def greedy_ar_outputs(what, runner, calls, device):
    """Every recorded greedy output of the run equals single-sequence
    greedy AR of its prompt on the runner's target, or parts from it
    first at a top-two bf16 tie (``greedy_tie``), both attending alike:
    the batch engine's outputs against AR on its attention kernel (under
    ``"flash"``), the device table's against AR as the config says.
    Returns the ties."""
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )

    params = runner.target_params
    ties = []
    for name, args, out in calls:
        cfg = runner.target_cfg
        if (name == "batch_autoregressive_generate"
                and batch_attention_kernel(cfg) is not None):
            cfg = cfg.replace(attention_impl="flash")
        outs = out if name == "batch_autoregressive_generate" else out[0]
        for p, o in zip(args[0], outs):
            ref = autoregressive_generate(
                p, cfg, params, max_gen_len=runner.gen_len,
                eos_tokens_id=runner.end_tokens, device=device)
            o = [int(t) for t in o]
            if o == ref:
                continue
            if not any(a != b for a, b in zip(o, ref)):
                fail(f"{what}: an output of {len(o)} tokens and greedy AR's "
                     f"{len(ref)} agree where both have tokens")
            ties.append(greedy_tie(what, cfg, params, p, ref, o, device)[0])
    return ties


def eagle_forwards(what, counts, L):
    """(target forwards, head forwards) of an EAGLE run on an INT4 target
    of L layers from its launches: 4 L K1b and one K1a a target forward,
    one K1a a head forward, nothing else."""
    T, rest = divmod(counts["K1b"], 4 * L)
    heads = counts["K1a"] - T
    if rest or T <= 0 or heads <= 0 or any(
            n for k, n in counts.items() if k not in ("K1b", "K1a")):
        fail(f"{what}: launches {counts} are not {4 * L} K1b and one K1a "
             "per target forward plus one K1a per head forward")
    return T, heads


def harness_run(name, env, device, workdir, limit, calls=None):
    """One in-process BenchmarkRunner run (its console output to
    ``workdir/<name>.log``), launches counted from 0. Returns (runner,
    launches, seconds)."""
    from specdec_tpu_torch.engine.benchmark_runner import BenchmarkRunner

    base = os.path.join(workdir, f"{name}.json")
    reset_launches()
    t0 = time.perf_counter()
    with environ(**env, OUTPUT_FILE=base, SHAREGPT_DIR=workdir,
                 GPU_MONITOR_INTERVAL="0.5"), \
            open(os.path.join(workdir, f"{name}.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        runner = BenchmarkRunner(device=device)
    seconds = time.perf_counter() - t0
    counts = launches()
    mon = runner.monitor_results
    if mon is None or mon.power_source != "nvml" or not any(
            0 < s.power_w < limit for s in mon.snapshots):
        fail(f"9 {name}: no NVML sample within (0, {limit}) W")
    return runner, counts, seconds


def phase_cli(device, card, root, workdir):
    """Phase 9: the CLI (README's INT8 command, the INT4 batch run) in
    subprocesses, then the INT4 configuration in-process as target_ar,
    ngram on the device table, an EAGLE drafter and an open-loop run.
    Returns (summary, launches by run)."""
    from specdec_tpu_torch.engine import infer_engine as tie

    limit = power_limit_w(card)
    write_sharegpt(os.path.join(workdir, "sharegpt_gpt4.jsonl"))
    summary, by_run = {}, {}
    L, Ld = 22, 4  # the preset's layers and the drafter's
    # the preset's bf16 heads of 64 take the flash-decode kernel, which
    # every forward of the batch engine attends through
    attn = "K3"
    for name, env in CLI_RUNS.items():
        rec, counts = run_cli(name, env, root, workdir, limit, card)
        quant = env["QUANTIZATION"]
        stacked, two_d = WEIGHT_KERNELS[quant]
        if not counts[stacked]:
            fail(f"9 {name}: no {stacked} launch under {quant} weights")
        rec["target_forwards"], rec["drafter_forwards"] = spec_forwards(
            f"9 {name}", counts, (stacked, two_d), L, Ld, attn)
        rec["launches"] = {k: n for k, n in counts.items() if n}
        summary[name], by_run[name] = rec, counts
        mode = "batch" if env.get("ENABLE_BATCH") == "true" else "single"
        say_run("9 cli", f"{name} ({quant}, {mode})", rec, card, f"; {stacked} {counts[stacked]}, {two_d} "
                f"{counts[two_d]} = {rec['target_forwards']} target + "
                f"{rec['drafter_forwards']} drafter forwards; process "
                f"{rec['process_seconds']:.1f} s")
    base = dict(CLI_RUNS["cli_int4"], ENABLE_BATCH="false", NUM_PROMPTS="4",
                GENERATION_LENGTH=str(HARNESS_GEN))
    for name, env in HARNESS_RUNS.items():
        env = dict(base, **env)
        calls = []
        saved = recording(tie, ("batch_autoregressive_generate",
                                "device_ngram_assisted_generate_batch"),
                          calls)
        try:
            runner, counts, seconds = harness_run(name, env, device,
                                                  workdir, limit)
        finally:
            for n, fn in saved.items():
                setattr(tie, n, fn)
        method = ("target_ar" if name == "target_ar" else
                  "ngram" if name == "ngram_device" else "speculative")
        asked = ((1, int(float(env["AUTO_RATE"]) * float(env["AUTO_DURATION"]))
                  + 1) if env["NUM_PROMPTS"] == "0" else int(env["NUM_PROMPTS"]))
        rec = check_result_files(f"9 {name}", os.path.join(
            workdir, f"{name}.json"), method, asked, limit)
        params = runner.target_params
        L = runner.target_cfg.num_layers
        what = f"9 {name}"
        extra = ""
        if name in ("target_ar", "ngram_device"):
            # target_ar decodes in the batch engine, every forward on its
            # attention; the device table's loop runs its own forwards
            fw = forward_launches(what, counts, runner.target_cfg, params,
                                  batch=name == "target_ar")
            rec["ties"] = greedy_ar_outputs(what, runner, calls, device)
            extra = (f"; {fw} target forwards (K1b 88, K1a 1 each); every "
                     "output == greedy AR" + (
                         f" but for bf16 ties at tokens {rec['ties']}"
                         if rec["ties"] else ""))
        elif name == "eagle":
            T, heads = eagle_forwards(what, counts, L)
            rec["target_forwards"], rec["head_forwards"] = T, heads
            extra = f"; {T} target forwards, {heads} head forwards"
        else:
            T, D = spec_forwards(what, counts, weight_kernels(params), L,
                                 runner.drafter_cfg.num_layers,
                                 batch_attention_kernel(runner.target_cfg))
            if rec["seconds"] < float(env["AUTO_DURATION"]):
                fail(f"{what}: stopped after {rec['seconds']:.1f} s, before "
                     f"AUTO_DURATION {env['AUTO_DURATION']} s")
            rec["target_forwards"], rec["drafter_forwards"] = T, D
            extra = f"; {T} target + {D} drafter forwards"
        rec["launches"] = {k: n for k, n in counts.items() if n}
        rec["wall_s"] = seconds
        summary[name], by_run[name] = rec, counts
        say_run("9 harness", name, rec, card, extra)
        del runner
    torch.cuda.empty_cache()
    return summary, by_run


# ---------------------------------------------------------------------------
# phase 9b: a local checkpoint, streamed
# ---------------------------------------------------------------------------

SAFETENSORS_DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16}


def write_safetensors(path, tensors, dtype, n_shards=1):
    """``tensors`` (name -> tensor, on any device, in order) written in
    ``dtype`` ("F32" or "BF16") as HF safetensors under ``path``: one
    ``model.safetensors``, or ``n_shards`` files holding contiguous runs of
    the names of about equal bytes, with an index. The format written by
    hand: an 8-byte little-endian header length, the JSON header padded to
    8 bytes, the raw bytes. Returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    torch_dtype = SAFETENSORS_DTYPES[dtype]
    size = torch.empty((), dtype=torch_dtype).element_size()
    total = sum(t.numel() for t in tensors.values())
    shards, before = [[] for _ in range(n_shards)], 0
    for name, t in tensors.items():
        shards[min(n_shards - 1, before * n_shards // total)].append(name)
        before += t.numel()
    weight_map, written = {}, 0
    for s, names in enumerate(shards):
        fname = ("model.safetensors" if n_shards == 1 else
                 f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors")
        header, offset = {"__metadata__": {"format": "pt"}}, 0
        for name in names:
            n = tensors[name].numel() * size
            header[name] = {"dtype": dtype, "shape": list(tensors[name].shape),
                            "data_offsets": [offset, offset + n]}
            offset += n
            weight_map[name] = fname
        head = json.dumps(header).encode()
        head += b" " * (-len(head) % 8)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(len(head).to_bytes(8, "little"))
            f.write(head)
            for name in names:
                f.write(tensors[name].to(torch_dtype).contiguous().cpu().view(
                    torch.uint8).numpy().tobytes())
        written += 8 + len(head) + offset
    if n_shards > 1:
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return written


def write_llama_checkpoint(path, cfg, params, n_shards=2):
    """The dense bf16 params of ``cfg`` as an HF llama checkpoint: its
    config.json and ``n_shards`` BF16 safetensors files with an index
    (``write_safetensors``: the embedding first, the layers in order, the
    norm and head last, so the layers split evenly)."""
    L = cfg.num_layers
    lay = params["layers"]
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    tensors = {"model.embed_tokens.weight": params["embed"]}
    for i in range(L):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = lay["attn_norm_w"][i]
        tensors[p + "post_attention_layernorm.weight"] = lay["mlp_norm_w"][i]
        tensors.update({p + hf + ".weight": lay[k][i].t()
                        for k, hf in names.items()})
    tensors["model.norm.weight"] = params["final_norm_w"]
    tensors["lm_head.weight"] = params["lm_head"].t()
    write_safetensors(path, tensors, "BF16", n_shards)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "llama",
                   "architectures": ["LlamaForCausalLM"],
                   "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": L,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
                   "tie_word_embeddings": False, "torch_dtype": "bfloat16"},
                  f)


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return tree.numel() * tree.element_size()


def same_bits(what, got, ref):
    """Quantized params equal bit for bit (``ref`` on any device)."""
    if isinstance(got, dict):
        if sorted(got) != sorted(ref):
            fail(f"{what}: keys {sorted(got)} against {sorted(ref)}")
        for k in got:
            same_bits(f"{what}.{k}", got[k], ref[k])
    elif dataclasses.is_dataclass(got):
        if type(got) is not type(ref):
            fail(f"{what}: {type(got).__name__} against "
                 f"{type(ref).__name__}")
        for f in dataclasses.fields(got):
            same_bits(f"{what}.{f.name}", getattr(got, f.name),
                      getattr(ref, f.name))
    elif got.dtype != ref.dtype or got.shape != ref.shape or \
            not torch.equal(got, ref.to(got.device)):
        fail(f"{what}: not bit-identical")


def phase_stream(device, card, root, target):
    """Phase 9b: bench.build_pair's dense bf16 target written as a
    TinyLlama-shaped HF checkpoint (two shards and an index), loaded with
    load_hf_streamed(quantization="int4") on the card: bit-identical to
    quantize_params(dense, "int4", fuse=True) on the card and on the CPU,
    peak device memory of the load under the loaded model plus two dense
    layers and the dense lm_head, greedy AR of 32 tokens equal to that of
    the pair's INT4 ``target``. Returns (summary, K1 launches of the greedy
    run)."""
    import shutil

    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.stream_loader import load_hf_streamed
    from specdec_tpu_torch.quant.core import quantize_params

    t_cfg, _, dense, _ = bench.build_pair(device, quant="none")
    path = os.path.join(root, "build", "smoke_checkpoint")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    write_llama_checkpoint(path, t_cfg, dense)
    disk = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    t_write = time.perf_counter() - t0
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cfg, loaded = load_hf_streamed(path, quantization="int4",
                                       device=device)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if cfg != t_cfg:
        fail(f"9b stream: config {cfg} against the pair's {t_cfg}")
    dense_layer = sum(v[0].numel() * v[0].element_size()
                      for v in dense["layers"].values())
    head = tree_bytes(dense["lm_head"])
    bound = tree_bytes(loaded) + 2 * dense_layer + head
    if peak > bound:
        fail(f"9b stream: peak {peak / 2**20:.0f} MiB over the loaded model "
             f"plus two dense layers and the dense lm_head "
             f"({bound / 2**20:.0f} MiB)")
    same_bits("9b stream vs quantize_params on the card", loaded,
              quantize_params(dense, kind="int4", fuse=True))
    t0 = time.perf_counter()
    cpu_dense = {k: ({n: t.cpu() for n, t in v.items()}
                     if isinstance(v, dict) else v.cpu())
                 for k, v in dense.items()}
    same_bits("9b stream vs quantize_params on the CPU", loaded,
              quantize_params(cpu_dense, kind="int4", fuse=True))
    t_cpu = time.perf_counter() - t0
    del cpu_dense
    prompt = bench.bench_prompt()
    reset_launches()
    got = greedy_ar(cfg, loaded, prompt, 32, device)
    counts = launches()
    want = greedy_ar(t_cfg, target, prompt, 32, device)
    if got != want:
        fail("9b stream: greedy AR of the loaded model differs from the "
             "pair's")
    forward_launches("9b stream greedy", counts, cfg, loaded)
    summary = {"checkpoint_bytes": disk, "write_s": t_write,
               "load_s": t_load, "cpu_quantize_s": t_cpu,
               "peak_bytes": peak, "bound_bytes": bound,
               "loaded_bytes": tree_bytes(loaded)}
    say(f"[9b stream] wrote a TinyLlama-shaped bf16 checkpoint "
        f"({disk / 1e9:.2f} GB, 2 shards + index) in {t_write:.1f} s; "
        f"load_hf_streamed(int4) on the card in {t_load:.1f} s, peak "
        f"{peak / 2**20:.0f} MiB (loaded model {tree_bytes(loaded) / 2**20:.0f}"
        f" MiB; bound {bound / 2**20:.0f} MiB); bit-identical to "
        f"quantize_params(int4, fuse=True) on the card and on the CPU "
        f"({t_cpu:.1f} s); greedy AR of 32 tokens == the pair's; {card}")
    del dense, loaded
    torch.cuda.empty_cache()
    return summary, counts


# ---------------------------------------------------------------------------
# phase 9c: the 8B preset
# ---------------------------------------------------------------------------

def phase_8b(device, card, workdir):
    """Phase 9c: synthetic:llama-8b built by init_quantized_params (INT4)
    with layerskip:4, 4 prompts in one batch of 32 tokens, through the
    runner in-process; build time and peak memory; K1 at the preset's
    shapes against its plain version. Returns (summary, launches,
    kernel records)."""
    from specdec_tpu_torch.engine import model_loader
    from specdec_tpu_torch.ops import quant_matmul as qm
    from specdec_tpu_torch.quant.core import dequantize

    limit = power_limit_w(card)
    built = {}
    load = model_loader.load_models

    def timed_load(*a, **k):
        # the build's peak above what the process held before it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = load(*a, **k)
        torch.cuda.synchronize()
        built.update(seconds=time.perf_counter() - t0,
                     peak=torch.cuda.max_memory_allocated() - before,
                     params=tree_bytes(out["target"]["params"]))
        return out
    model_loader.load_models = timed_load
    try:
        runner, counts, seconds = harness_run("llama_8b", LLAMA8B_ENV, device,
                                              workdir, limit)
    finally:
        model_loader.load_models = load
    cfg = runner.target_cfg
    if (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
            cfg.vocab_size, cfg.num_kv_heads, cfg.head_dim) != (
            32, 4096, 14336, 128256, 8, 128):
        fail(f"9c 8B: config {cfg}")
    rec = check_result_files("9c 8B", os.path.join(workdir, "llama_8b.json"),
                             "speculative", 4, limit)
    T, D = spec_forwards("9c 8B", counts, weight_kernels(runner.target_params),
                         32, 4, batch_attention_kernel(runner.target_cfg))
    rec.update(build_s=built["seconds"], build_peak_bytes=built["peak"],
               params_bytes=built["params"], target_forwards=T,
               drafter_forwards=D, wall_s=seconds,
               launches={k: n for k, n in counts.items() if n})
    say_run("9c 8B", "synthetic:llama-8b + layerskip:4, int4, batch 4",
            rec, card, f"; built by init_quantized_params in "
            f"{built['seconds']:.1f} s, peak {built['peak'] / 2**30:.2f} GiB "
            f"above the memory held before it, for "
            f"{built['params'] / 2**30:.2f} GiB of params; {T} target + "
            f"{D} drafter forwards")
    # K1 at the 8B shapes, layer 0 and the lm_head, against its plain
    # version, with its time
    params = runner.target_params
    gen = torch.Generator(device=device).manual_seed(88)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=device)
    records = []
    for name, K, N in LLAMA8B_STACKED + [LLAMA8B_HEAD]:
        head = name == LLAMA8B_HEAD[0]
        w = params["lm_head"] if head else params["layers"][name]
        lw = layer_of(w, None if head else 0)
        w_bf16 = dequantize(lw, torch.bfloat16)
        x_all = torch.randn((max(LLAMA8B_ROWS), K), generator=gen,
                            device=device).to(torch.bfloat16)
        for M in LLAMA8B_ROWS:
            x = x_all[:M]

            def kern(x=x, w=w, head=head):
                return (qm.quant_matmul(x, w) if head
                        else qm.quant_matmul_stacked(x, w, 0))
            got = kern().float()
            plain = qm.int4_matmul_reference(x, lw.packed, lw.absmax).float()
            err, rel, ok = kernel_vs_plain(got, plain)
            bit_equal = (got == plain).float().mean().item()
            if not ok or bit_equal < MIN_BIT_EQUAL:
                fail(f"9c K1 {name} M={M}: kernel vs plain max abs err "
                     f"{err:.3g}, relative {rel:.3g}, bit-equal {bit_equal:.3%}")
            b_ms, by = bound_ms(M, K, N, bytes_per_weight("int4", K))
            records.append({
                "name": f"8b_{name}", "format": "int4",
                "layer": None if head else 0, "M": M, "K": K, "N": N,
                "max_abs_err": err, "rel_fro_err": rel,
                "bit_equal": bit_equal, "ms": gpu_ms(kern, flush),
                "plain_ms": gpu_ms(lambda: qm.int4_matmul_reference(
                    x, lw.packed, lw.absmax), flush),
                "library_ms": gpu_ms(lambda: torch.matmul(x, w_bf16), flush),
                "bound_ms": b_ms, "bound_by": by})
        del w_bf16
        say(f"[9c K1] {name:8s} K={K} N={N}: " + "; ".join(
            f"M={r['M']} {r['ms'] * 1e3:.1f} us (bound "
            f"{r['bound_ms'] * 1e3:.1f}, plain {r['plain_ms'] * 1e3:.0f}, "
            f"torch.matmul bf16 {r['library_ms'] * 1e3:.1f}, "
            f"{r['bit_equal']:.2%} bit-equal)"
            for r in records if r["name"] == f"8b_{name}"))
    del runner, params
    torch.cuda.empty_cache()
    return rec, counts, records


# ---------------------------------------------------------------------------
# phase 9d: the serving facade
# ---------------------------------------------------------------------------

def phase_vllm(device, card):
    """Phase 9d: VLLMEngineManager from the VLLM_* environment on the INT4
    LayerSkip pair, the default paged engine with bf16 KV (K8a) and with
    KV_QUANT=int8 (K8b); run_server_benchmark over its batcher with the
    serving phase's 16 prompts arriving at VLLM_RATE per second, 128 tokens
    each, greedy at GREEDY_T (the softmaxes saturate, so acceptance is
    exact-match and a request's tokens are the target's). Its pool is the
    default half of full reservation, so requests may be preempted and
    prefilled again, another computation of the same tokens. Every token
    of every request is held to the target's argmax over its own prefix,
    within greedy_tie's two bf16 ulps, in a replay of the engine's shape
    (``teacher_forced``), and each request equals greedy AR under the same
    KV format from the same admission prefill (``admitted_greedy_ar``), or
    parts from it first where the replay's top two logits are tied within
    two bf16 ulps. Returns (summary, launches by KV format)."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core import model as tmodel
    from specdec_tpu_torch.engine.server_benchmark import run_server_benchmark
    from specdec_tpu_torch.engine.vllm_compat import (
        VLLMEngineManager, create_vllm_config_from_env,
    )
    from specdec_tpu_torch.sampling.processors import GreedyProcessor
    from specdec_tpu_torch.serve import PagedContinuousBatcher

    prompts = bench.serving_prompts()
    gen = int(VLLM_ENV["MAX_TOKENS"])
    summary, by_kv = {}, {}
    for kv in ("none", "int8"):
        with environ(**VLLM_ENV, KV_QUANT=kv):
            mgr = VLLMEngineManager(create_vllm_config_from_env(),
                                    device=device)
            mgr.initialize()
        b = mgr.batcher
        if type(b) is not PagedContinuousBatcher or \
                b.max_pages_per_seq != VLLM_TABLE_PAGES or \
                b.target_cfg.kv_quant != kv or b.drafter_cfg.num_layers != 4:
            fail(f"9d vllm ({kv} KV): {type(b).__name__}, table width "
                 f"{b.max_pages_per_seq}, kv {b.target_cfg.kv_quant}")
        b.processor = GreedyProcessor(temperature=GREEDY_T)
        t_cfg, target = b.target_cfg, b.target_params
        reset_launches()
        tmodel.forward_step_paged.calls = 0
        torch.cuda.synchronize()
        res = run_server_benchmark(b, prompts, rate=VLLM_RATE,
                                   method_name="speculative")
        torch.cuda.synchronize()
        counts = launches()
        paged_forwards = tmodel.forward_step_paged.calls
        what = f"9d vllm ({kv} KV)"
        if res.total_requests != len(prompts):
            fail(f"{what}: {res.total_requests} of {len(prompts)} requests")
        outs = [b.completed[i].output_ids for i in range(len(prompts))]
        if any(len(o) != gen for o in outs):
            fail(f"{what}: output lengths {[len(o) for o in outs]}, not {gen}")
        if any(t in mgr._end_tokens for o in outs for t in o[:-1]):
            fail(f"{what}: an output runs on past an end token "
                 f"{mgr._end_tokens}")
        # no request ended early, so the reference is greedy AR without
        # end tokens: an end token only cuts a stream short, and where AR
        # would end one (at a tie) the request parts from it there
        P, gamma = b.max_prompt_len, b.gamma
        refs = admitted_greedy_ar(t_cfg, target, prompts, gen, P, b.S,
                                  device)
        ar_equal = sum(o == r for o, r in zip(outs, refs))
        if any(len(o) != len(r) for o, r in zip(outs, refs)):
            fail(f"{what}: output lengths {[len(o) for o in outs]}, AR's "
                 f"{[len(r) for r in refs]}")
        # the reference prefills each prompt as the engine's admission
        # does (the kernel's spans follow the cache's size, and the
        # probabilities round to bf16 at each span's scale), then decodes
        # on its own; where a request parts from it, a tie of the engine's
        # own computation (the replay below)
        parts = {i: next(j for j, (x, y) in enumerate(zip(o, r)) if x != y)
                 for i, (o, r) in enumerate(zip(outs, refs)) if o != r}
        ties = [parts[i] for i in sorted(parts)]
        # every token the target's argmax over its own prefix (within two
        # bf16 ulps) in a replay of the engine's computation: each
        # prompt admitted alone, padded to max_prompt_len, on the
        # admission's scratch cache of b.S positions through the
        # flash-decode kernel, then gamma + 1 rows a token through the
        # flash-decode kernel over a slotted cache of the page table's
        # capacity, whose tiles and spans are those of the paged kernel the
        # engine verifies through (K3 == K8a, K4 == K8b over the same keys:
        # phase 3c)
        flash = t_cfg.replace(attention_impl="flash")
        forced = teacher_forced(
            what, flash, target, prompts, outs, device,
            (P, b.max_pages_per_seq * b.page_size, gamma + 1, b.S),
            step_cfg=flash, ties_at=parts)
        paged = "K8b" if kv == "int8" else "K8a"
        # the hybrid drafter's gamma forwards a window and each dense
        # admission's two prefills attend through the flash-decode kernel
        attn = batch_attention_kernel(t_cfg)
        admissions = len(prompts) + b.preemptions
        slotted = (b.drafter_cfg.num_layers * (gamma * paged_forwards
                                               + admissions)
                   + t_cfg.num_layers * admissions)
        if counts[paged] != t_cfg.num_layers * paged_forwards or \
                not paged_forwards or not counts["K1b"] or \
                attn is None or counts[attn] != slotted or any(
                    n for k, n in counts.items()
                    if k not in (paged, attn, "K1b", "K1a")):
            fail(f"{what}: launches {counts} over {paged_forwards} paged "
                 f"forwards and {admissions} admissions")
        reqs = [r for bm in res.batches for r in bm.requests]
        ttft = [r.ttft * 1e3 for r in reqs]
        lat = [r.total_latency * 1e3 for r in reqs]
        rec = {"requests": res.total_requests, "tokens": res.total_tokens,
               "seconds": res.total_duration,
               "tok_s": res.overall_throughput,
               "req_s": res.total_requests / res.total_duration,
               "ttft_p50_ms": float(np.percentile(ttft, 50)),
               "ttft_p99_ms": float(np.percentile(ttft, 99)),
               "latency_p50_ms": float(np.percentile(lat, 50)),
               "latency_p99_ms": float(np.percentile(lat, 99)),
               "acceptance": res.avg_acceptance_rate,
               "preemptions": b.preemptions, "replay": forced,
               "equal_to_greedy_ar": ar_equal, "ties": ties,
               "paged_forwards": paged_forwards,
               "launches": {k: n for k, n in counts.items() if n}}
        summary[f"{kv} KV"], by_kv[kv] = rec, counts
        say(f"[9d vllm] {kv} KV: {rec['requests']} requests at "
            f"{VLLM_RATE:g}/s, {rec['tokens']} tokens in "
            f"{rec['seconds']:.2f} s = {rec['tok_s']:.1f} tok/s, "
            f"{rec['req_s']:.2f} req/s ({card}); TTFT p50 "
            f"{rec['ttft_p50_ms']:.0f} / p99 {rec['ttft_p99_ms']:.0f} ms, "
            f"latency p50 {rec['latency_p50_ms']:.0f} / p99 "
            f"{rec['latency_p99_ms']:.0f} ms, acceptance "
            f"{rec['acceptance']:.3f}; {paged} {counts[paged]} over "
            f"{paged_forwards} paged forwards, K1b {counts['K1b']}, K1a "
            f"{counts['K1a']}; {b.preemptions} preemptions; {ar_equal} of "
            f"{len(prompts)} requests == greedy AR, the rest parting "
            f"first at a bf16 tie (tokens {ties}); every token of every "
            f"request the target's argmax over its prefix in a replay: "
            f"{forced[1]} of {forced[0]} not, the largest gap "
            f"{forced[2]:.2f} bf16 ulps (at most 2)")
        del mgr, b, target
        torch.cuda.empty_cache()
    return summary, by_kv


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

# 10a: the weight kernels forward and backward at the training row counts:
# a teacher forward or a perplexity batch (M = B L = 8 x 128) and the EAGLE
# head's logits in its first rollout pass (M = 8 x 127)
GRAD_ROWS = (1024, 1016)
GRAD_FORMATS = ("int4", "nf4", "int8")
# 10b and 10d: the llama-1b preset pretrained at load (batch 32 of 128
# tokens, the JAX loader's settings), INT4, with an EAGLE head trained
# EAGLE_STEPS on-policy steps on it (batch 8 of 128, rollout 3): each step
# samples its batch with 127 eager decode steps of the target
TRAIN_STEPS = 100
TRAINED_SPEC = f"trained:llama-1b@{TRAIN_STEPS}"
TRAIN_BATCH, TRAIN_SEQ = 32, 128
EAGLE_STEPS, EAGLE_BATCH, EAGLE_SEQ, EAGLE_ROLLOUT = 2, 8, 128, 3
DISTILL_STEPS = 3
# greedy AR of the trained targets; the perplexity's stream sequences
TRAINED_GEN = 32
PPL_SEQS, PPL_LEN = 16, 128
# the CLI on the trained target with the saved head
TRAINED_CLI_ENV = dict(TARGET_MODEL=TRAINED_SPEC, QUANTIZATION="int4",
                       NUM_PROMPTS="4", GENERATION_LENGTH="64",
                       GAMMA_VALUE="5", INFERENCE_METHOD="speculative")
# 10c: tests/test_pretrain.py's configuration
CONV_STEPS, CONV_LR, CONV_EAGLE_STEPS, CONV_EAGLE_LR = 450, 3e-3, 250, 2e-3


def phase_grad(pairs, device):
    """10a: K1 (INT4), K6 (NF4) and K7 (INT8) on the 22-layer pair's own
    weights (layer 0's four projections and the lm_head) at M = 1024 and
    1016: the forward through the autograd Function against the plain
    version (phase 3's tolerances and bit-equal share) and x's gradient
    through it against autograd of the plain version on the card (relative
    Frobenius REL_FRO_TOL; None or all zeros fails); at M = 1024 the
    forward's, the backward's (dy @ dequantize(w)^T, the Function's) and
    torch.matmul's time over the bf16-dequantized weight, with the bound
    of that work. Then every attention wrapper must raise under grad and
    launch nothing. These launches are comparisons: no path counts them.
    Returns the records by format."""
    from specdec_tpu_torch.ops import quant_matmul as qm
    from specdec_tpu_torch.quant.core import dequantize

    gen = torch.Generator(device=device).manual_seed(4321)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=device)
    out = {}
    for fmt in GRAD_FORMATS:
        target = pairs[fmt][2]
        _, plain_fn = weight_format(target["lm_head"])
        recs = []
        for name, K, N, layer in [s + (0,) for s in STACKED] + [
                LM_HEAD + (None,)]:
            w = target["lm_head"] if layer is None else \
                target["layers"][name]
            lw = layer_of(w, layer)
            a, b = (lw.q, lw.scale) if fmt == "int8" else (lw.packed,
                                                           lw.absmax)

            def kern(x, w=w, layer=layer):
                return (qm.quant_matmul(x, w) if layer is None
                        else qm.quant_matmul_stacked(x, w, layer))
            x_all = torch.randn((max(GRAD_ROWS), K), generator=gen,
                                device=device).to(torch.bfloat16)
            dy_all = torch.randn((max(GRAD_ROWS), N), generator=gen,
                                 device=device).to(torch.bfloat16)
            for M in GRAD_ROWS:
                x, dy = x_all[:M].clone().requires_grad_(True), dy_all[:M]
                y = kern(x)
                if y.grad_fn is None:
                    fail(f"10a {fmt} {name} M={M}: the wrapper's output "
                         "carries no graph")
                dx, = torch.autograd.grad(y, x, dy)
                xp = x.detach().clone().requires_grad_(True)
                yp = plain_fn(xp, a, b)
                dxp, = torch.autograd.grad(yp, xp, dy)
                got, plain = y.detach().float(), yp.detach().float()
                err, rel, ok = kernel_vs_plain(got, plain)
                bit = (got == plain).float().mean().item()
                if not ok or bit < MIN_BIT_EQUAL:
                    fail(f"10a {fmt} {name} M={M}: kernel vs plain max abs "
                         f"err {err:.3g}, relative Frobenius {rel:.3g}, "
                         f"{bit:.3%} bit-equal")
                if dx is None or not torch.isfinite(dx).all() or \
                        not dx.abs().max().item() > 0:
                    fail(f"10a {fmt} {name} M={M}: the gradient is None, "
                         "not finite or all zeros")
                g_rel = ((dx.float() - dxp.float()).norm()
                         / dxp.float().norm()).item()
                if not g_rel <= REL_FRO_TOL:
                    fail(f"10a {fmt} {name} M={M}: the gradient through the "
                         f"kernel's Function is {g_rel:.3g} (relative "
                         "Frobenius) from autograd of the plain version")
                rec = {"name": name, "format": fmt, "M": M, "K": K, "N": N,
                       "max_abs_err": err, "rel_fro_err": rel,
                       "bit_equal": bit, "grad_rel_fro_err": g_rel}
                if M == max(GRAD_ROWS):
                    xd = x.detach()
                    w_bf16 = dequantize(lw, torch.bfloat16)
                    b_ms, by = bound_ms(M, K, N, bytes_per_weight(fmt, K))
                    rec.update(
                        ms=gpu_ms(lambda: kern(xd), flush),
                        backward_ms=gpu_ms(
                            lambda: dy @ dequantize(lw, dy.dtype).T, flush),
                        plain_ms=gpu_ms(lambda: plain_fn(xd, a, b), flush),
                        library_ms=gpu_ms(lambda: torch.matmul(xd, w_bf16),
                                          flush),
                        bound_ms=b_ms, bound_by=by)
                    say(f"[10a grad] {fmt} {name:8s} M={M} K={K} N={N}: "
                        f"forward {rec['ms'] * 1e3:8.1f} us, backward "
                        f"(dequantize + matmul) {rec['backward_ms'] * 1e3:8.1f}"
                        f" us, torch.matmul bf16 {rec['library_ms'] * 1e3:7.1f}"
                        f" us, bound {b_ms * 1e3:6.1f} us ({by}) each; "
                        f"forward bit-equal {bit:.3%}, gradient rel {g_rel:.2g}")
                recs.append(rec)
        out[fmt] = recs
        say(f"[10a grad] {fmt}: {len(recs)} forwards within phase 3's "
            f"tolerances, gradients within relative Frobenius {REL_FRO_TOL} "
            f"of the plain version's (largest "
            f"{max(r['grad_rel_fro_err'] for r in recs):.2g}), none zero")
    # the attention kernels have no backward: every wrapper refuses
    from specdec_tpu_torch.ops import decode_attention as da
    from specdec_tpu_torch.ops import paged_attention as pa

    Hq, Hk, Dh = PAIR_HEADS
    q = torch.randn((1, 2, Hq, Dh), generator=gen, device=device).to(
        torch.bfloat16).requires_grad_(True)
    kv = torch.zeros((1, 64, Hk, Dh), dtype=torch.bfloat16, device=device)
    kv8 = torch.zeros((1, 64, Hk, Dh), dtype=torch.int8, device=device)
    sc = torch.ones((1, 64, Hk), device=device, requires_grad=True)
    pool = torch.zeros((1, 1, Hk, PAGE, Dh), dtype=torch.bfloat16,
                       device=device)
    pool8 = pool.to(torch.int8)
    psc = torch.ones((1, 1, Hk, PAGE), device=device)
    table = torch.zeros((1, 1), dtype=torch.int32, device=device)
    off = torch.tensor([5], dtype=torch.int32, device=device)
    calls = {
        "K3": lambda: da.flash_decode_attention(q, kv, kv, off),
        "K4": lambda: da.flash_decode_attention_quant(q, kv8, sc, kv8, sc,
                                                      off),
        "K2": lambda: pa.paged_decode_attention(q, pool[0], pool[0], table,
                                                off),
        "K8a": lambda: pa.paged_decode_attention_stacked(q, pool, pool, 0,
                                                         table, off),
        "K5": lambda: pa.paged_decode_attention_quant(
            q, pool8[0], psc[0], pool8[0], psc[0], table, off),
        "K8b": lambda: pa.paged_decode_attention_quant_stacked(
            q, pool8, psc, pool8, psc, 0, table, off)}
    before = launches()
    for key, call in calls.items():
        try:
            call()
        except ValueError as e:
            if "no backward" not in str(e):
                fail(f"10a {key}: raised {e!r}, not the refusal under grad")
        else:
            fail(f"10a {key}: the attention wrapper ran with an input that "
                 "requires grad")
    if launches() != before:
        fail(f"10a: an attention wrapper launched under grad: {before} -> "
             f"{launches()}")
    say(f"[10a grad] attention wrappers {sorted(calls)}: each raises "
        "ValueError under grad before any launch")
    torch.cuda.synchronize()
    return out


class Spans:
    """Device-synchronized wall time of wrapped callables, in call order:
    (label, seconds, keep(result)). ``restore`` puts the originals back."""

    def __init__(self):
        self.calls, self._saved = [], []

    def wrap(self, owner, name, label, keep=lambda out: None):
        fn = getattr(owner, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.calls.append((label, time.perf_counter() - t0, keep(out)))
            return out
        setattr(owner, name, timed)
        self._saved.append((owner, name, fn))

    def restore(self):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []

    def of(self, label):
        return [c for c in self.calls if c[0] == label]


def phase_train(device, card, root):
    """10b and 10d on the card, through ``load_models``: ``trained:llama-1b``
    pretrained TRAIN_STEPS steps in bf16 (seconds a step, tokens/s, 6 N
    tokens/s against the bf16 peak, peak memory, the NLL at the first and
    last step, which must fall by 0.4 nats), quantized to INT4, with
    ``eagle:1@EAGLE_STEPS`` trained on it (the step's time split four ways:
    sampler, teacher, loss and backward, optimizer; K1 launches per step)
    and saved through EAGLE_SAVE; greedy AR of the INT4 target equal to the
    dense one's up to a top-two tie (``greedy_tie``); ``eagle:<dir>``
    reloading the head bit for bit; DISTILL_STEPS distillation steps of a
    dense 4-layer drafter of the preset's shapes against the INT4 target;
    the perplexity of the dense and INT4 targets on stream sequences (INT4
    within 5% of dense); the CLI on the trained target with the saved
    head, its result files checked as phase 9 checks them. Returns
    (summary, launches by path)."""
    import shutil

    from specdec_tpu_torch.core.model import layer_views
    from specdec_tpu_torch.engine import distill, eagle_train, evaluate
    from specdec_tpu_torch.engine import model_loader, optim, pretrain
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )

    workdir = os.path.join(root, "build", "smoke_train")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    head_dir = os.path.join(workdir, "eagle_head")
    summary, by_path = {"card": card}, {}
    try:
        spans = Spans()
        spans.wrap(pretrain, "build_trained_target", "pretrain",
                   keep=lambda out: out[0])
        spans.wrap(pretrain, "train_lm", "train_lm")
        spans.wrap(pretrain, "_lm_grad", "lm loss and backward",
                   keep=lambda out: float(out[0]))
        spans.wrap(distill, "_sample_on_policy", "sampler")
        spans.wrap(eagle_train, "teacher_feats_probs", "teacher")
        spans.wrap(eagle_train, "_eagle_loss_and_grad", "loss and backward")
        spans.wrap(optim.Adam, "step", "optimizer")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        reset_launches()
        t0 = time.perf_counter()
        try:
            with environ(EAGLE_SAVE=head_dir, EAGLE_TRAIN_BATCH=EAGLE_BATCH,
                         EAGLE_TRAIN_SEQ=EAGLE_SEQ,
                         EAGLE_ROLLOUT=EAGLE_ROLLOUT):
                bundle = model_loader.load_models(
                    TRAINED_SPEC, f"eagle:1@{EAGLE_STEPS}",
                    quantization="int4", device=device)
        finally:
            spans.restore()
        load_s = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated(device) - held
        t, head = bundle["target"], bundle["drafter"]
        cfg, qparams = t["cfg"], t["params"]
        dense = spans.of("pretrain")[0][2]
        pre_s = spans.of("train_lm")[0][1]
        nlls = [c[2] for c in spans.of("lm loss and backward")]
        if len(nlls) != TRAIN_STEPS:
            fail(f"10b: {len(nlls)} pretraining steps, asked {TRAIN_STEPS}")
        if not nlls[0] - nlls[-1] >= 0.4:
            fail(f"10b: the NLL fell from {nlls[0]:.3f} to {nlls[-1]:.3f} "
                 f"nats in {TRAIN_STEPS} steps, less than 0.4")
        if abs(t["pretrain_nll"] - nlls[-1]) > 1e-6:
            fail(f"10b: pretrain_nll {t['pretrain_nll']} is not the last "
                 f"step's {nlls[-1]}")
        n_params = sum(p.numel() for p in optim.leaves(dense))
        tok_s = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / pre_s
        opt = spans.of("optimizer")
        lb_s = sum(c[1] for c in spans.of("lm loss and backward"))
        opt_s = sum(c[1] for c in opt[:TRAIN_STEPS])
        pre = {"steps": TRAIN_STEPS, "seconds": pre_s,
               "s_per_step": pre_s / TRAIN_STEPS, "tokens_per_s": tok_s,
               "params": n_params,
               "mfu_bf16": 6 * n_params * tok_s / BF16_OPS_PER_S,
               "loss_and_backward_s": lb_s, "optimizer_s": opt_s,
               "sampler_and_host_s": pre_s - lb_s - opt_s,
               "nll_first": nlls[0], "nll_last": nlls[-1],
               "entropy_floor": t["stream_spec"].entropy_nats,
               "peak_memory_gib": peak / 2 ** 30}
        summary["pretrain"] = pre
        say(f"[10b train] {TRAINED_SPEC} in bf16 ({n_params / 1e9:.3f} B "
            f"params, batch {TRAIN_BATCH} x {TRAIN_SEQ}): {TRAIN_STEPS} steps "
            f"in {pre_s:.1f} s = {pre['s_per_step'] * 1e3:.1f} ms a step "
            f"(loss and backward {lb_s / TRAIN_STEPS * 1e3:.1f} ms, optimizer "
            f"{opt_s / TRAIN_STEPS * 1e3:.1f} ms, sampler and host "
            f"{pre['sampler_and_host_s'] / TRAIN_STEPS * 1e3:.1f} ms), "
            f"{tok_s:.0f} training tokens/s, 6 N tokens/s = "
            f"{pre['mfu_bf16']:.1%} of {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s "
            f"({card}); NLL {nlls[0]:.3f} -> {nlls[-1]:.3f} nats (floor "
            f"{pre['entropy_floor']:.3f}); peak memory {pre['peak_memory_gib']:.2f}"
            f" GiB above what the process held")

        # the EAGLE head's training: EAGLE_STEPS steps and the final proxy
        samp, teach = spans.of("sampler"), spans.of("teacher")
        loss, eopt = spans.of("loss and backward"), opt[TRAIN_STEPS:]
        if not (len(samp) == len(teach) == EAGLE_STEPS + 1
                and len(loss) == len(eopt) == EAGLE_STEPS):
            fail(f"10d: {len(samp)} sampler, {len(teach)} teacher, "
                 f"{len(loss)} loss and {len(eopt)} optimizer calls for "
                 f"{EAGLE_STEPS} steps")
        L = cfg.num_layers
        # target forwards: the sampler's EAGLE_SEQ - 1 decode steps and the
        # teacher, each step and the final proxy; head forwards: the
        # rollout passes of each step and the proxy's one
        fw = EAGLE_SEQ * (EAGLE_STEPS + 1)
        expect_launches("10d eagle:1 training", counts, qparams, cfg,
                        [(fw, L, 1, 0),
                         (EAGLE_ROLLOUT * EAGLE_STEPS + 1, 0, 1, 0)])
        steps = [{"sampler_s": s[1], "teacher_s": te[1], "loss_backward_s":
                  lo[1], "optimizer_s": o[1]}
                 for s, te, lo, o in zip(samp, teach, loss, eopt)]
        eagle = {"steps": EAGLE_STEPS, "load_s": load_s, "step_times": steps,
                 "launches": counts, "K1_per_step": {
                     "K1b": 4 * L * EAGLE_SEQ,
                     "K1a": EAGLE_SEQ + EAGLE_ROLLOUT}}
        summary["eagle_train"] = eagle
        by_path["eagle_train"] = counts
        for i, s in enumerate(steps):
            say(f"[10d eagle] step {i}: sampler {s['sampler_s']:.2f} s, "
                f"teacher {s['teacher_s'] * 1e3:.1f} ms, loss and backward "
                f"{s['loss_backward_s'] * 1e3:.1f} ms, optimizer "
                f"{s['optimizer_s'] * 1e3:.1f} ms")
        say(f"[10d eagle] eagle:1@{EAGLE_STEPS} on the INT4 trained target "
            f"(batch {EAGLE_BATCH} x {EAGLE_SEQ}, rollout {EAGLE_ROLLOUT}): "
            f"K1b {counts['K1b']}, K1a {counts['K1a']} = {fw} target "
            f"forwards (the sampler's {EAGLE_SEQ - 1} decode steps and the "
            f"teacher, a step and the proxy) + {EAGLE_ROLLOUT} head forwards "
            f"a step + 1; per step K1b {4 * L * EAGLE_SEQ}, K1a "
            f"{EAGLE_SEQ + EAGLE_ROLLOUT}; the whole load {load_s:.1f} s")
        if any(p.requires_grad for p in optim.leaves(head["params"])) or \
                any(p.requires_grad for p in optim.leaves(dense)):
            fail("10b: trained params require grad")

        # greedy AR: the INT4 target against the dense one, a stream prompt
        stream = t["stream_spec"]
        prompt = pretrain.markov_sampler(stream, 1, 16, device)(
            torch.Generator(device=device).manual_seed(0))[0].tolist()
        ar_dense = autoregressive_generate(prompt, cfg, dense,
                                           max_gen_len=TRAINED_GEN,
                                           eos_tokens_id=(), device=device)
        ar_q = autoregressive_generate(prompt, cfg, qparams,
                                       max_gen_len=TRAINED_GEN,
                                       eos_tokens_id=(), device=device)
        if ar_q == ar_dense:
            say(f"[10b train] greedy AR of the INT4 trained target == the "
                f"dense one's over {TRAINED_GEN} tokens")
        else:
            i, gap, ulp = greedy_tie("10b INT4 against dense", cfg, dense,
                                     prompt, ar_dense, ar_q, device)
            say(f"[10b train] greedy AR of the INT4 trained target == the "
                f"dense one's for the first {i} tokens; token {i} is a tie "
                f"within two bf16 ulps (top-2 gap {gap:.3g}, ulp {ulp:.3g})")

        # eagle:<dir> reloads the saved head bit for bit
        again = model_loader._eagle(head_dir, TRAINED_SPEC, t, device)
        same_bits("10d eagle:<dir>", again["params"], head["params"])
        if again["cfg"] != head["cfg"]:
            fail("10d eagle:<dir>: the reloaded head's config differs")
        say(f"[10d eagle] eagle:{head_dir} reloads the saved head bit for "
            "bit")

        # distillation of a dense 4-layer drafter against the INT4 target
        d_cfg = cfg.replace(num_layers=4)
        drafter = dict(dense, layers=layer_views(dense["layers"], 4))
        reset_launches()
        t0 = time.perf_counter()
        _, acc = distill.distill_drafter(cfg, qparams, d_cfg, drafter,
                                         steps=DISTILL_STEPS, batch_size=8,
                                         seq_len=128, seed=0, device=device)
        torch.cuda.synchronize()
        dist_s = time.perf_counter() - t0
        counts = launches()
        expect_launches("10d distill", counts, qparams, cfg,
                        [(DISTILL_STEPS + 1, L, 1, 0)])
        by_path["distill"] = counts
        summary["distill"] = {"steps": DISTILL_STEPS, "seconds": dist_s,
                              "acceptance_proxy": acc}
        say(f"[10d distill] {DISTILL_STEPS} steps of a dense 4-layer drafter "
            f"against the INT4 target (batch 8 x 128) and the proxy in "
            f"{dist_s:.2f} s; acceptance proxy {acc:.3f}; K1 one teacher "
            "forward a step and one for the proxy")

        # perplexity, dense and INT4, on stream sequences
        seqs = pretrain.markov_sampler(stream, PPL_SEQS, PPL_LEN, device)(
            torch.Generator(device=device).manual_seed(1)).tolist()
        ppl_dense = evaluate.perplexity(cfg, dense, seqs, device=device)
        reset_launches()
        t0 = time.perf_counter()
        ppl_q = evaluate.perplexity(cfg, qparams, seqs, device=device)
        ppl_s = time.perf_counter() - t0
        counts = launches()
        expect_launches("10d perplexity", counts, qparams, cfg,
                        [(-(-PPL_SEQS // 8), L, 1, 0)])
        by_path["perplexity"] = counts
        rel = abs(ppl_q - ppl_dense) / ppl_dense
        if not rel < 0.05:
            fail(f"10d perplexity: INT4 {ppl_q:.3f} against dense "
                 f"{ppl_dense:.3f}, {rel:.2%} apart (at most 5%)")
        summary["perplexity"] = {"dense": ppl_dense, "int4": ppl_q,
                                 "int4_seconds": ppl_s}
        say(f"[10d ppl] {PPL_SEQS} stream sequences of {PPL_LEN}: dense "
            f"{ppl_dense:.3f}, INT4 {ppl_q:.3f} ({rel:.2%} apart; exp of the "
            f"floor {math.exp(stream.entropy_nats):.3f}); INT4 in "
            f"{ppl_s * 1e3:.0f} ms, K1 at M = {8 * PPL_LEN}")
        del bundle, t, head, qparams, dense, drafter, again
        torch.cuda.empty_cache()

        # the CLI: the trained target (trained again in the subprocess, the
        # same seeds) with the head from its directory
        write_sharegpt(os.path.join(workdir, "sharegpt_gpt4.jsonl"))
        rec, counts = run_cli("cli_trained_eagle",
                              dict(TRAINED_CLI_ENV,
                                   DRAFTER_MODEL=f"eagle:{head_dir}"),
                              root, workdir, power_limit_w(card), card)
        T, heads = eagle_forwards("10d CLI", counts, L)
        rec.update(target_forwards=T, head_forwards=heads,
                   launches={k: n for k, n in counts.items() if n})
        summary["cli_trained_eagle"] = rec
        by_path["cli_trained_eagle"] = counts
        say_run("10d cli", f"{TRAINED_SPEC} + eagle:<dir> (int4)", rec, card,
                f"; {T} target forwards, {heads} head forwards; process "
                f"{rec['process_seconds']:.1f} s (pretraining included)")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return summary, by_path


def phase_convergence(device, card):
    """10c: tests/test_pretrain.py's configuration on the card (V = 128, 64
    states, order 1, a 4-layer D=128 f32 target, 450 steps at lr 3e-3):
    the NLL under floor + 0.35, a fresh batch under floor + 0.4; a depth-1
    head trained 250 steps at lr 2e-3 reaching a proxy of 0.5, more than
    0.3 above the untrained head's; then the trained head accepting more
    than the untrained one in ``eagle_generate`` (the same prompts and
    seeds). Returns its summary."""
    from specdec_tpu_torch.core.config import ModelConfig
    from specdec_tpu_torch.core.eagle import init_eagle_params
    from specdec_tpu_torch.engine.eagle_train import (
        eagle_acceptance_proxy, train_eagle,
    )
    from specdec_tpu_torch.engine.pretrain import (
        MarkovSpec, build_trained_target, lm_nll, markov_sampler,
    )
    from specdec_tpu_torch.sampling.eagle_speculative import eagle_generate

    spec = MarkovSpec(vocab_size=128, num_states=64, branching=4,
                      zipf_s=1.2, order=1, seed=3)
    cfg = ModelConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32,
                      max_position_embeddings=256, dtype=torch.float32)
    floor = spec.entropy_nats
    t0 = time.perf_counter()
    target, nll = build_trained_target(cfg, spec, steps=CONV_STEPS,
                                       batch_size=32, seq_len=64,
                                       learning_rate=CONV_LR, seed=0,
                                       device=device)
    train_s = time.perf_counter() - t0
    gen = torch.Generator(device=device)
    eval_nll = float(lm_nll(cfg, target, markov_sampler(
        spec, 16, 64, device)(gen.manual_seed(99))))
    if not (nll < floor + 0.35 and eval_nll < floor + 0.4):
        fail(f"10c: NLL {nll:.3f} (fresh batch {eval_nll:.3f}) against the "
             f"floor {floor:.3f} + 0.35 (+ 0.4)")
    e_cfg = cfg.replace(num_layers=1)
    head = init_eagle_params(e_cfg, seed=7, device=device)
    sampler = markov_sampler(spec, 16, 64, device)
    acc0, _ = eagle_acceptance_proxy(cfg, e_cfg, head, target,
                                     sampler(gen.manual_seed(10_007)))
    t0 = time.perf_counter()
    trained, acc = train_eagle(cfg, target, e_cfg, head,
                               steps=CONV_EAGLE_STEPS, batch_sampler=sampler,
                               learning_rate=CONV_EAGLE_LR, seed=8,
                               device=device)
    eagle_s = time.perf_counter() - t0
    if not (acc >= 0.5 and acc - float(acc0) > 0.3):
        fail(f"10c: EAGLE proxy {acc:.3f} from {float(acc0):.3f} (at least "
             "0.5, a lift above 0.3)")
    prompts = markov_sampler(spec, 4, 12, device)(
        gen.manual_seed(5)).tolist()
    rates = {name: float(np.mean([eagle_generate(
        p, e_cfg, h, cfg, target, gamma=4, max_gen_len=24, eos_tokens_id=(),
        seed=i, device=device)[1] for i, p in enumerate(prompts)]))
        for name, h in (("untrained", head), ("trained", trained))}
    if not rates["trained"] > rates["untrained"]:
        fail(f"10c: eagle_generate acceptance {rates}: the trained head does "
             "not accept more")
    say(f"[10c converge] {CONV_STEPS} steps in {train_s:.1f} s: NLL "
        f"{nll:.3f}, fresh batch {eval_nll:.3f} (floor {floor:.3f}); EAGLE "
        f"{CONV_EAGLE_STEPS} steps in {eagle_s:.1f} s: proxy {float(acc0):.3f}"
        f" -> {acc:.3f}; eagle_generate acceptance untrained "
        f"{rates['untrained']:.3f}, trained {rates['trained']:.3f} ({card})")
    return {"nll": nll, "eval_nll": eval_nll, "floor": floor,
            "train_s": train_s, "proxy_untrained": float(acc0),
            "proxy_trained": acc, "eagle_s": eagle_s,
            "eagle_generate_acceptance": rates}


def phase_harness(device, card, root, target):
    """Phases 9-9d in a git-ignored working directory, removed after."""
    import shutil

    workdir = os.path.join(root, "build", "smoke_bench")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    try:
        cli, cli_launches = phase_cli(device, card, root, workdir)
        say(f"[time] 9 CLI and harness in {time.perf_counter() - t0:.1f} s")
        stream, stream_launches = phase_stream(device, card, root, target)
        say(f"[time] 9b streamed checkpoint done at "
            f"{time.perf_counter() - t0:.1f} s")
        big, big_launches, big_records = phase_8b(device, card, workdir)
        say(f"[time] 9c 8B preset done at {time.perf_counter() - t0:.1f} s")
        route_launches = phase_route(device, card)
        say(f"[time] 9c route done at {time.perf_counter() - t0:.1f} s")
        vllm, vllm_launches = phase_vllm(device, card)
        say(f"[time] 9d serving facade done at "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    summary = {"cli_and_runner": cli, "streamed_checkpoint": stream,
               "llama_8b": big, "vllm": vllm, "card": card}
    by_path = {**{f"harness_{k}": v for k, v in cli_launches.items()},
               "stream_greedy": stream_launches, "llama_8b": big_launches,
               "vllm_serving": vllm_launches["none"],
               "vllm_serving_kvint8": vllm_launches["int8"],
               **{f"loader_route_{k}": v for k, v in route_launches.items()}}
    return summary, by_path, big_records


# ---------------------------------------------------------------------------
# phase 11: the encoder-decoder at full width
# ---------------------------------------------------------------------------

# google/flan-t5-large and google/flan-t5-small, their config.json on the
# Hugging Face hub: the fields that differ, then the shared ones
FLAN_T5 = {
    "large": dict(d_model=1024, d_kv=64, num_heads=16, d_ff=2816,
                  num_layers=24, num_decoder_layers=24),
    "small": dict(d_model=512, d_kv=64, num_heads=6, d_ff=1024,
                  num_layers=8, num_decoder_layers=8),
}
FLAN_T5_SHARED = dict(
    model_type="t5", architectures=["T5ForConditionalGeneration"],
    vocab_size=32128, feed_forward_proj="gated-gelu", is_gated_act=True,
    dense_act_fn="gelu_new", tie_word_embeddings=False,
    relative_attention_num_buckets=32, relative_attention_max_distance=128,
    layer_norm_epsilon=1e-6, n_positions=512, decoder_start_token_id=0,
    eos_token_id=1, pad_token_id=0)
# how each is written: the large one in BF16 as two shards with an index,
# the small one in F32 as one file
CODEC_FILES = {"large": ("BF16", 2), "small": ("F32", 1)}
CODEC_SEED = 11
CODEC_PROMPT = 60
CODEC_GEN = 64
CODEC_GAMMA = 5
# the card's bf16 decode_step logits against its f32 on the same weights,
# relative Frobenius error: bf16 rounds every activation (2^-9 relative)
# through 48 layers, a few percent at most; a wiring fault gives order 1
CODEC_BF16_FRO = 0.1
# the card's f32 against the CPU's f32 at 2 + 2 layers (TF32 off): the
# sums' order only
CODEC_CPU_FRO = 1e-4


def t5_init_scales(cfg):
    """The standard deviation of each weight at HF T5's initialization
    (``T5PreTrainedModel._init_weights``, factor 1): the embedding and the
    untied lm_head 1; q 1/sqrt(d_model d_kv), which stands in for the
    attention's missing 1/sqrt(d_kv); k, v, wi_0, wi_1 and the relative
    bias 1/sqrt(d_model); o 1/sqrt(heads d_kv); the FFN's wo 1/sqrt(d_ff).
    The logits (the final-normed state times the head) then have a
    standard deviation near sqrt(d_model): peaked. Random weights at a
    uniform small scale instead make a 48-layer stack chaotic: bf16 and f32
    logits part by order 1 (0.70 relative Frobenius on the card at N(0,
    0.02^2), 0.33 at 8 + 8 layers on the CPU), hiding any real fault."""
    D, dkv, H = cfg.d_model, cfg.d_kv, cfg.num_heads
    attn = {"wq": (D * dkv) ** -0.5, "wk": D ** -0.5, "wv": D ** -0.5,
            "wo": (H * dkv) ** -0.5}
    layer = dict(attn, **{f"cross_{k}": v for k, v in attn.items()},
                 wi_0=D ** -0.5, wi_1=D ** -0.5, wo_ffn=cfg.d_ff ** -0.5)
    return {"embed": 1.0, "lm_head": 1.0, "enc_rel_bias": D ** -0.5,
            "dec_rel_bias": D ** -0.5, "enc_layers": layer,
            "dec_layers": layer}


def t5_tensors(cfg, params):
    """The codec params of a gated-FFN model with an untied head as HF T5
    state-dict names (the inverse of ``codec_params_from_hf``): [in, out]
    stacks back to [out, in] per layer, the relative bias in block 0
    only."""
    out = {"shared.weight": params["embed"]}
    for side, L, blocks in (
            ("encoder", cfg.num_encoder_layers,
             (("0.SelfAttention", ("q", "k", "v", "o"), ""),
              ("1.DenseReluDense", ("wi_0", "wi_1", "wo"), "ffn"))),
            ("decoder", cfg.num_decoder_layers,
             (("0.SelfAttention", ("q", "k", "v", "o"), ""),
              ("1.EncDecAttention", ("q", "k", "v", "o"), "cross"),
              ("2.DenseReluDense", ("wi_0", "wi_1", "wo"), "ffn")))):
        lay = params[f"{side[:3]}_layers"]
        norms = (("attn_norm_w", "0"), ("ffn_norm_w", str(len(blocks) - 1)))
        if side == "decoder":
            norms += (("cross_norm_w", "1"),)
        for i in range(L):
            p = f"{side}.block.{i}.layer."
            for key, j in norms:
                out[f"{p}{j}.layer_norm.weight"] = lay[key][i]
            for module, names, kind in blocks:
                for n in names:
                    key = {"": f"w{n}", "cross": f"cross_w{n}",
                           "ffn": "wo_ffn" if n == "wo" else n}[kind]
                    out[f"{p}{module}.{n}.weight"] = lay[key][i].t()
        out[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias"
            ".weight"] = params[f"{side[:3]}_rel_bias"]
        out[f"{side}.final_layer_norm.weight"] = \
            params[f"{side[:3]}_final_norm_w"]
    out["lm_head.weight"] = params["lm_head"].t()
    return out


def map_tree(fn, tree):
    """``fn`` on every tensor of a nested dict of params."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def codec_inputs(prompt, device):
    """The padded [1, P] prompt and its mask, as the codec loops build
    them."""
    from specdec_tpu_torch.sampling.utils import pad_to_bucket

    ids, n = pad_to_bucket(prompt, 0)
    mask = (torch.arange(ids.shape[0]) < n).to(torch.int32)[None, :]
    return ids[None, :].to(device), mask.to(device)


def codec_logits(cfg, params, prompt, dec, device):
    """decode_step's logits over the decoder block ``dec`` from an empty
    cache, the encoder over ``prompt``."""
    from specdec_tpu_torch.core import codec_model as cm

    ids, mask = codec_inputs(prompt, device)
    ck, cv = cm.init_cross_kv(cfg, params, cm.encode(cfg, params, ids, mask))
    cache = cm.codec_cache(cfg, 1, len(dec) + 8, device)
    logits, _ = cm.decode_step(cfg, params,
                               torch.tensor([dec], device=device), cache, ck,
                               cv, mask)
    return logits[0]


def codec_greedy_tie(what, cfg, params, prompt, ar, got, device):
    """``greedy_tie`` for the codec: where ``got`` parts from greedy AR's
    decoder ids ``ar``, the target's top two logits over ar's prefix
    (decode_step teacher-forced as one block) must be tied within two bf16
    ulps. Returns the position."""
    i = next(j for j, (a, b) in enumerate(zip(ar, got)) if a != b)
    top2 = codec_logits(cfg, params, prompt, ar[:i], device)[-1].topk(
        2).values.tolist()
    gap = top2[0] - top2[1]
    ulp = 2.0 ** (math.floor(math.log2(abs(top2[0]))) - 7)
    if gap > 2 * ulp:
        fail(f"{what}: diverges from greedy AR at decoder position {i} where "
             f"the target's top-2 logit gap {gap:.3g} exceeds two bf16 ulps "
             f"({2 * ulp:.3g})")
    return i


def codec_models(device, workdir):
    """Phase 11's checkpoints: each Flan-T5 shape made on the card from a
    seed, written as an HF T5 checkpoint (CODEC_FILES), read back by
    ``load_codec_checkpoint`` in bf16 and in f32, each bit-equal to the
    weights as written. Returns ({name: (bf16 cfg, params, f32 cfg,
    params)}, {name: load record})."""
    from specdec_tpu_torch.core import codec_model as cm

    models, loads = {}, {}
    for i, name in enumerate(("large", "small")):
        hf = dict(FLAN_T5_SHARED, **FLAN_T5[name])
        cfg = cm.codec_config_from_hf(hf)
        made = cm.init_codec_params(cfg, seed=CODEC_SEED + i, scale=1.0,
                                    device=device)
        for key, std in t5_init_scales(cfg).items():
            if isinstance(std, dict):
                for weight, w in made[key].items():
                    w.mul_(std.get(weight, 1.0))   # norms stay 1
            else:
                made[key].mul_(std)
        dtype, shards = CODEC_FILES[name]
        path = os.path.join(workdir, f"flan-t5-{name}")
        t0 = time.perf_counter()
        disk = write_safetensors(path, t5_tensors(cfg, made), dtype, shards)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dict(hf, torch_dtype={"BF16": "bfloat16",
                                            "F32": "float32"}[dtype]), f)
        t_write = time.perf_counter() - t0
        written = map_tree(lambda t: t.to(SAFETENSORS_DTYPES[dtype]), made)
        del made
        got = {}
        for want in (torch.bfloat16, torch.float32):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            lcfg, params = cm.load_codec_checkpoint(path, want, device)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - before
            if lcfg != cfg.replace(dtype=want):
                fail(f"11 codec: {name} config {lcfg} against {cfg}")
            same_bits(f"11 codec {name} {want} load", params,
                      map_tree(lambda t: t.to(want), written))
            loaded = tree_bytes(params)
            largest = max(t.numel() for t in t5_tensors(lcfg, params).values())
            bound = loaded + 2 * largest * 4
            if peak > bound:
                fail(f"11 codec: loading {name} at {want} peaked at "
                     f"{peak / 2**20:.0f} MiB, over the loaded params plus "
                     f"two f32 copies of the largest tensor "
                     f"({bound / 2**20:.0f} MiB)")
            got[want] = (lcfg, params)
            loads[f"{name}_{str(want).split('.')[-1]}"] = {
                "file_dtype": dtype, "shards": shards, "disk_bytes": disk,
                "write_s": t_write, "load_s": seconds, "peak_bytes": peak,
                "loaded_bytes": loaded, "bound_bytes": bound}
            say(f"[11 codec] Flan-T5-{name}: {disk / 1e9:.2f} GB of {dtype} "
                f"({shards} file{'s' if shards > 1 else ''}) written in "
                f"{t_write:.1f} s; load_codec_checkpoint at "
                f"{str(want).split('.')[-1]} in {seconds:.2f} s, peak "
                f"{peak / 2**20:.0f} MiB (params {loaded / 2**20:.0f} MiB, "
                f"bound {bound / 2**20:.0f} MiB), bit-equal to the weights "
                "as written")
        del written
        models[name] = got[torch.bfloat16] + got[torch.float32]
    return models, loads


def codec_spec_timed(prompt, d, t, processor, device, seed=0):
    """One speculative call, timed, with its window count (the loop's own
    debug line). Returns (tokens, rate, seconds, windows)."""
    import io

    from specdec_tpu_torch.sampling.codec_decoding import (
        speculative_generate_encoder_decoder,
    )

    log = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        out, rate = speculative_generate_encoder_decoder(
            prompt, d[0], d[1], t[0], t[1], gamma=CODEC_GAMMA,
            logits_processor=processor, max_gen_len=CODEC_GEN,
            eos_tokens_id=(), seed=seed, debug=True, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    windows = int(re.search(r"windows=(\d+)", log.getvalue()).group(1))
    return out, rate, seconds, windows


def phase_codec(device, card, root):
    """Phase 11: Flan-T5-large (target) and Flan-T5-small (drafter) at full
    width through checkpoints, precision checks and the codec oracles.
    Returns its summary."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from specdec_tpu_torch.core import codec_model as cm
    from specdec_tpu_torch.sampling.codec_decoding import (
        autoregressive_generate_encoder_decoder,
    )
    from specdec_tpu_torch.sampling.processors import (
        GreedyProcessor, MultinomialProcessor,
    )

    workdir = os.path.join(root, "build", "smoke_codec")
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        models, loads = codec_models(device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    t_cfg, t16, t_cfg32, t32 = models["large"]
    d_cfg, d16 = models["small"][:2]
    target, drafter = (t_cfg, t16), (d_cfg, d16)
    del models
    reset_launches()

    # --- precision: buckets, bf16 against f32, the card against the CPU --
    rel = torch.arange(-1024, 1025)
    for bidirectional in (True, False):
        for nb, md in ((32, 128), (8, 32)):
            on_card = cm.rel_position_bucket(rel.to(device), bidirectional,
                                              nb, md).cpu()
            if not torch.equal(on_card,
                               cm.rel_position_bucket(rel, bidirectional,
                                                      nb, md)):
                fail(f"11 codec: rel_position_bucket({nb}, {md}, "
                     f"bidirectional={bidirectional}) on the card differs "
                     "from the CPU's over rel in [-1024, 1024]")
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(2, t_cfg.vocab_size,
                                           CODEC_PROMPT)]
    dec = [0] + [int(t) for t in rng.integers(2, t_cfg.vocab_size, 15)]
    bf16_err = kernel_vs_plain(
        codec_logits(t_cfg, t16, prompt, dec, device),
        codec_logits(t_cfg32, t32, prompt, dec, device))[1]
    if not bf16_err <= CODEC_BF16_FRO:
        fail(f"11 codec: bf16 decode_step logits at relative Frobenius "
             f"{bf16_err:.3g} from f32 (limit {CODEC_BF16_FRO})")
    short = t_cfg32.replace(num_encoder_layers=2, num_decoder_layers=2)
    cut = dict(t32, **{k: map_tree(lambda w: w[:2], t32[k])
                       for k in ("enc_layers", "dec_layers")})
    cpu_err = kernel_vs_plain(
        codec_logits(short, cut, prompt, dec, device).cpu(),
        codec_logits(short, map_tree(torch.Tensor.cpu, cut), prompt, dec,
                     "cpu"))[1]
    del t32, cut
    torch.cuda.empty_cache()
    if not cpu_err <= CODEC_CPU_FRO:
        fail(f"11 codec: f32 logits at 2 + 2 layers, the card against the "
             f"CPU, at relative Frobenius {cpu_err:.3g} (limit "
             f"{CODEC_CPU_FRO})")
    say(f"[11 codec] rel_position_bucket on the card == the CPU's over rel "
        f"in [-1024, 1024] (both directions, (32, 128) and (8, 32)); "
        f"decode_step logits bf16 vs f32 at full width: relative Frobenius "
        f"{bf16_err:.3g} (limit {CODEC_BF16_FRO}); f32 at 2 + 2 layers, card "
        f"vs CPU: {cpu_err:.3g} (limit {CODEC_CPU_FRO})")

    # --- the encoder alone, then the oracles ------------------------------
    ids, mask = codec_inputs(prompt, device)

    def encoder():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cm.init_cross_kv(t_cfg, t16, cm.encode(t_cfg, t16, ids, mask))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    encoder_ms = statistics.median(encoder() for _ in range(6))

    def ar(gen):
        return autoregressive_generate_encoder_decoder(
            prompt, t_cfg, t16, max_gen_len=gen, eos_tokens_id=(),
            device=device)

    ar(4)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ar(CODEC_GEN)
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t0
    if len(ref) != CODEC_GEN + 1 or ref[0] != t_cfg.decoder_start_token_id \
            or not all(0 <= t < t_cfg.vocab_size for t in ref):
        fail(f"11 codec: greedy AR gave {len(ref)} ids starting {ref[:4]}")

    # the card's busy share of an AR token: device time of a 41-token call
    # less a 9-token one (the encoder and the cache set-up cancel)
    busy = {}
    for gen in (9, 41):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ar(gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy[gen] = (sum(device_times(prof).values()) / 1e3, wall * 1e3)
    device_ms = (busy[41][0] - busy[9][0]) / 32
    wall_ms = (busy[41][1] - busy[9][1]) / 32

    greedy = GreedyProcessor(temperature=GREEDY_T)
    runs = {}
    for label, d in (("self_draft", target), ("flan_t5_small", drafter)):
        codec_spec_timed(prompt, d, target, greedy, device)   # warm
        out, rate, seconds, windows = codec_spec_timed(prompt, d, target,
                                                       greedy, device)
        parted = None
        if out != ref:
            parted = codec_greedy_tie(f"11 codec {label}", t_cfg, t16,
                                      prompt, ref, out, device)
        if label == "self_draft" and parted is None and rate != 1.0:
            fail(f"11 codec: self-draft acceptance {rate} without a tie")
        runs[label] = {"acceptance": rate, "seconds": seconds,
                       "windows": windows,
                       "ms_per_window": seconds * 1e3 / windows,
                       "tok_per_s": (len(out) - 1) / seconds,
                       "parted_at_tie": parted}
    sampled = [codec_spec_timed(prompt, drafter, target,
                                MultinomialProcessor(temperature=1.0),
                                device, seed=7) for _ in range(2)]
    out = sampled[0][0]
    if sampled[1][0] != out or not 2 <= len(out) <= CODEC_GEN + 1 or \
            not all(0 <= t < t_cfg.vocab_size for t in out):
        fail(f"11 codec: seeded multinomial runs gave {len(out)} and "
             f"{len(sampled[1][0])} ids (equal: {sampled[1][0] == out})")
    runs["sampled"] = {"acceptance": sampled[0][1], "seconds": sampled[0][2],
                       "windows": sampled[0][3],
                       "tok_per_s": (len(out) - 1) / sampled[0][2]}
    counts = launches()
    if any(counts.values()):
        fail(f"11 codec: port kernels launched on the codec path: {counts}")

    summary = {
        **{role: f"Flan-T5-{name} shape ({c.num_encoder_layers} + "
           f"{c.num_decoder_layers} layers, d_model {c.d_model})"
           for role, name, c in (("target", "large", t_cfg),
                                 ("drafter", "small", d_cfg))},
        "dtype": "bfloat16", "prompt_tokens": CODEC_PROMPT,
        "gen_tokens": CODEC_GEN, "gamma": CODEC_GAMMA, "loads": loads,
        "bf16_vs_f32_rel_fro": bf16_err, "card_vs_cpu_rel_fro": cpu_err,
        "encoder_ms": encoder_ms, "ar_ms_per_token": ar_s * 1e3 / CODEC_GEN,
        "ar_device_ms_per_token": device_ms, "ar_wall_ms_per_token": wall_ms,
        "ar_busy_share": device_ms / wall_ms, "spec": runs,
        "launches": counts, "card": card}
    say(f"[11 codec] encoder ({t_cfg.num_encoder_layers} layers, "
        f"{ids.shape[1]} positions) {encoder_ms:.3f} ms; "
        f"greedy AR {summary['ar_ms_per_token']:.2f} ms a token (device "
        f"{device_ms:.3f} of {wall_ms:.2f} ms, busy "
        f"{device_ms / wall_ms:.1%}); " + "; ".join(
            f"{k} gamma {CODEC_GAMMA}: {r['ms_per_window']:.2f} ms a window, "
            f"{r['tok_per_s']:.1f} tok/s, acceptance {r['acceptance']:.3f}"
            + (f" (parted from AR at a tie, position {r['parted_at_tie']})"
               if r["parted_at_tie"] is not None else ", == greedy AR")
            for k, r in runs.items() if k != "sampled")
        + f"; sampled: {runs['sampled']['tok_per_s']:.1f} tok/s, acceptance "
        f"{runs['sampled']['acceptance']:.3f}, the same ids twice; port "
        f"kernel launches {sum(counts.values())}; {card}")
    del target, drafter, t16, d16
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 12: the REPL
# ---------------------------------------------------------------------------

REPL_PROMPT = "Tell me how speculative decoding keeps the target's output"
REPL_INPUT = ["/gamma 4", "/length 32", "/ngram", "/drafter", REPL_PROMPT,
              "/set_ngramstorage onelevel 2", "/random", "auto 2", "/quit"]
REPL_TAGS = ("[speculative]", "[ngram-assist]", "[target AR]",
             "[drafter AR]")


def phase_repl(device, card, root):
    """Phase 12: ``python -m specdec_tpu_torch.cli.repl`` with its default
    models in a subprocess over REPL_INPUT (phase 9's ShareGPT JSONL as
    sharegpt_gpt4.jsonl), then ``InferenceCLI._infer`` in process, greedy
    at GREEDY_T: speculative and NASD tokens equal target AR's up to a
    top-two bf16 tie. Returns its summary."""
    import shutil

    from specdec_tpu_torch.cli.repl import InferenceCLI
    from specdec_tpu_torch.engine.infer_engine import tokenize_batch

    workdir = os.path.join(root, "build", "smoke_repl")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    env = {k: v for k, v in os.environ.items()
           if k not in ("TARGET_MODEL", "DRAFTER_MODEL", "GENERATION_LENGTH",
                        "GAMMA_VALUE")}
    env.update(SHAREGPT_DIR=workdir, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    try:
        write_sharegpt(os.path.join(workdir, "sharegpt_gpt4.jsonl"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "specdec_tpu_torch.cli.repl"],
            input="\n".join(REPL_INPUT) + "\n", cwd=root, env=env,
            capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    lines = proc.stdout.replace("> ", "\n").splitlines()
    prompts = 4   # the typed one, /random and auto's two
    tags = {tag: sum(line.startswith(tag) for line in lines)
            for tag in REPL_TAGS}
    ratios = {name: sum(f"throughput {name}/target:" in line
                        for line in lines)
              for name in ("speculative", "ngram", "drafter")}
    if proc.returncode or "Goodbye!" not in lines or \
            set(tags.values()) != {prompts} or \
            set(ratios.values()) != {prompts}:
        fail(f"12 REPL: exit {proc.returncode}, tags {tags}, throughput "
             f"lines {ratios}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    say(f"[12 REPL] python -m specdec_tpu_torch.cli.repl (synthetic:llama-1b"
        f" over synthetic:llama-70m, dense bf16) ran {len(REPL_INPUT)} "
        f"inputs in {seconds:.1f} s, exit 0; every tag and throughput ratio "
        f"for each of {prompts} prompts; " + "; ".join(
            line.strip() for line in lines if "throughput" in line)[:400])

    cli = InferenceCLI(device=device)
    for command in ("/gamma 4", "/length 32", "/ngram",
                    f"/processor greedy {GREEDY_T}"):
        cli._perform_command(command)
    results = cli._infer(REPL_PROMPT)
    ids = tokenize_batch(cli.tokenizer, [REPL_PROMPT], 2048,
                         chat=cli.chat)[0]
    ref = results["target"][0]
    parted = {}
    for name in ("speculative", "ngram"):
        got = results[name][0]
        parted[name] = None
        if got != ref:
            parted[name] = greedy_tie(f"12 REPL {name}", cli.target_cfg,
                                      cli.target_params, ids, ref, got,
                                      device)[0]
    say(f"[12 REPL] InferenceCLI._infer at /processor greedy {GREEDY_T}: "
        "speculative and ngram-assist tokens == target AR's" + "".join(
            f" ({k} parted at a top-two tie, token {v})"
            for k, v in parted.items() if v is not None) + f"; {card}")
    summary = {"subprocess_s": seconds, "prompts": prompts,
               "in_process": {k: {"tokens": len(v[0]), "seconds": v[1]}
                              for k, v in results.items()},
               "parted_at_tie": parted, "card": card}
    del cli
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 13: tensor and data parallelism
# ---------------------------------------------------------------------------

# 13a: the pair of phase 5 at world size 1 (NCCL): 4 prompts batched and 8
# serving requests, PAR_GEN tokens each
PAR_PROMPTS, PAR_REQUESTS, PAR_GEN = 4, 8, 64
# turns of (plain, mesh, mesh, plain) single-sequence calls of 13a's walls
PAR_WALL_TURNS = 3
# 13b: TinyLlama's widths (the pair's target) cut to PAR_LAYERS layers, INT4,
# over gloo with CUDA tensors, every rank on the one card; greedy batched AR
# over PAR_PROMPTS prompts of PAR_PROMPT_LEN tokens, PAR_B_GEN tokens each
PAR_LAYERS, PAR_PROMPT_LEN, PAR_B_GEN = 4, 48, 32
# (world size, [(tp, dp), ...]) of each spawn
PAR_WORLDS = ((2, ((2, 1),)), (4, ((4, 1), (2, 2))))
PAR_KV = {"bf16 KV": {}, "int8 KV, flash": KVINT8_FLASH}
# the sharded bf16 logits against the unsharded ones, relative Frobenius:
# each rank rounds its row-parallel partial sums to bf16 where the unsharded
# product rounds the whole sum (2^-9 relative a rounding, over 4 layers).
# The faults of PAR_FAULTS, planted in every layout, must read above it
PAR_LOGIT_FRO = 0.05
PAR_FAULTS = ("w_down all-reduce dropped in layer 0",
              "KV heads of rank 0 on the last model rank")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def par_prompts(n, length, seed):
    from specdec_tpu_torch import bench

    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, bench.V, size=length)]
            for _ in range(n)]


def par_counts():
    """The launch counts of the paths phase 13 runs, with the dequant
    route's calls and the all-reduces over 'model' groups."""
    from specdec_tpu_torch.ops import quant_matmul as qm
    from specdec_tpu_torch.parallel.mesh import model_all_reduce

    return dict(launches(), route=qm.dequant_matmul.calls,
                all_reduce=model_all_reduce.calls)


def par_reset():
    from specdec_tpu_torch.ops import quant_matmul as qm
    from specdec_tpu_torch.parallel.mesh import model_all_reduce

    reset_launches()
    qm.dequant_matmul.calls = 0
    model_all_reduce.calls = 0


def par_serve(models, prompts, proc, device):
    """``prompts`` through the paged engine on ``models`` (d_cfg, drafter,
    t_cfg, target), one slot each: (outputs, acceptances) in submission
    order."""
    from specdec_tpu_torch.serve import PagedContinuousBatcher

    b = PagedContinuousBatcher(*models, num_slots=len(prompts), gamma=8,
                               max_prompt_len=256, max_new_tokens=PAR_GEN,
                               logits_processor=proc, eos_tokens_id=(),
                               device=device)
    ids = [b.submit(p) for p in prompts]
    done = b.run()
    return ([done[i].output_ids for i in ids],
            [done[i].metrics.acceptance_rate for i in ids])


def all_reduce_us(mesh, shape, dtype, device, reps=200):
    """One ``mesh.all_reduce`` of a ``shape`` tensor of ``dtype`` (the f32
    casts included): {"wall": host µs a call over ``reps`` calls ended by
    a synchronize, "device": µs a call between CUDA events}."""
    x = torch.randn(shape, device=device).to(dtype)
    for _ in range(10):
        mesh.all_reduce(x)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        mesh.all_reduce(x)
    end.record()
    torch.cuda.synchronize()
    return {"wall": (time.perf_counter() - t0) / reps * 1e6,
            "device": start.elapsed_time(end) / reps * 1e3}


def bundle_models(bundle):
    return (bundle["drafter"]["cfg"], bundle["drafter"]["params"],
            bundle["target"]["cfg"], bundle["target"]["params"])


def phase_parallel_nccl(pair, device, card):
    """Phase 13a: a world of one rank over NCCL, a tp=1 x dp=1 mesh. The
    phase-5 pair through ``shard_params`` (replicated drafter) runs
    batch_speculative_generate over PAR_PROMPTS prompts, and
    ``load_models(mesh=...)`` of the INT4 llama-1b LayerSkip preset serves
    PAR_REQUESTS requests on the paged engine: greedy and sampled, tokens
    and acceptance bit-equal to the unsharded runs, with every all-reduce
    issued (one rank). Then the single-sequence window's wall with and
    without the mesh, in turns (the gap of the medians is what the
    collectives cost at world size 1), and one all-reduce timed alone.
    Returns (summary, launch counts of the sharded runs)."""
    import torch.distributed as dist

    from specdec_tpu_torch import bench
    from specdec_tpu_torch.engine.batch_engine import (
        batch_speculative_generate,
    )
    from specdec_tpu_torch.engine.model_loader import load_models
    from specdec_tpu_torch.parallel import (
        build_mesh, init_distributed, local_config, shard_params,
    )
    from specdec_tpu_torch.sampling.processors import (
        GreedyProcessor, MultinomialProcessor,
    )

    if not init_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                            device=device):
        fail("13a: init_distributed did not join a world of one rank")
    if dist.get_backend() != "nccl":
        fail(f"13a: backend {dist.get_backend()}, not nccl")
    try:
        mesh = build_mesh(tp=1, dp=1)
        t_cfg, d_cfg, target, drafter = pair
        plain = (d_cfg, drafter, t_cfg, target)
        sharded = (d_cfg, shard_params(drafter, d_cfg, mesh, replicated=True),
                   local_config(t_cfg, mesh), shard_params(target, t_cfg,
                                                           mesh))
        procs = {"greedy": GreedyProcessor(),
                 "sampled": MultinomialProcessor(1.0)}
        prompts = par_prompts(PAR_PROMPTS, bench.PROMPT_LEN, seed=13)
        out, counts = {}, {}

        def both(name, run, plain_models, mesh_models):
            """run(models) unsharded, then sharded (counted): equal."""
            plain = run(plain_models)
            par_reset()
            got = run(mesh_models)
            counts[name] = par_counts()
            if got != plain:
                fail(f"13a {name}: the tp=1 x dp=1 mesh's tokens or "
                     "acceptance differ from the unsharded run's")
            if counts[name]["all_reduce"] == 0:
                fail(f"13a {name}: no all-reduce was issued")
            return got[1]

        for kind, proc in procs.items():
            out[f"batch_{kind}_acceptance"] = both(
                f"batch {kind}", lambda m, p=proc: batch_speculative_generate(
                    prompts, *m, gamma=bench.GAMMA, gen_len=PAR_GEN,
                    logits_processor=p, eos_tokens_id=(), seed=5,
                    device=device), plain, sharded)
        plain_b = load_models("synthetic:llama-1b-ls4", "layerskip:4",
                              quantization="int4", device=device)
        mesh_b = load_models("synthetic:llama-1b-ls4", "layerskip:4",
                             quantization="int4", device=device, mesh=mesh)
        if mesh_b["target"]["params"].get("mesh") is not mesh:
            fail("13a: load_models(mesh=...) returned params without the "
                 "mesh")
        requests = bench.serving_prompts()[:PAR_REQUESTS]
        for kind, proc in procs.items():
            out[f"serving_{kind}_acceptance"] = both(
                f"serving {kind}", lambda m, p=proc: par_serve(
                    m, requests, p, device), bundle_models(plain_b),
                bundle_models(mesh_b))
        del plain_b, mesh_b

        # the wall of a window, single sequence, in turns: (plain, mesh,
        # mesh, plain) x PAR_WALL_TURNS; every call is reported
        prompt, proc = bench.bench_prompt(), procs["sampled"]
        walls = {"plain": [], "mesh": []}
        for which in ("plain", "mesh", "mesh", "plain") * PAR_WALL_TURNS:
            models = plain if which == "plain" else sharded
            r = bench.measure_spec(*models, prompt, bench.GEN // 4,
                                   bench.GAMMA, proc, device, reps=1)["runs"][1]
            walls[which].append(r["seconds"] / r["windows"] * 1e3)
        out["window_ms_runs"] = walls
        out["window_ms_median"] = {k: float(np.median(v))
                                   for k, v in walls.items()}
        out["collectives_ms_per_window"] = (out["window_ms_median"]["mesh"]
                                            - out["window_ms_median"]["plain"])
        # one all-reduce alone, at the verify forward's shapes, in turns:
        # the residual's [1, gamma + 1, D] bf16 partial sums and the head's
        # [1, gamma + 1, V] f32 logits
        T = bench.GAMMA + 1
        shapes = {"activation": ((1, T, t_cfg.hidden_size), torch.bfloat16),
                  "logits": ((1, T, t_cfg.vocab_size), torch.float32)}
        out["all_reduce_us"] = {k: [] for k in shapes}
        for k in ("activation", "logits", "logits", "activation"):
            out["all_reduce_us"][k].append(all_reduce_us(mesh, *shapes[k],
                                                         device))
    finally:
        dist.destroy_process_group()
    total = {}
    for c in counts.values():
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
    for k in ("K1b", "K1a", "K8a"):
        if total[k] == 0:
            fail(f"13a: no {k} launch on the sharded paths")
    out["counts"] = counts
    out["card"] = card
    say(f"[13a parallel] NCCL world of 1, tp=1 x dp=1: batched spec over "
        f"{PAR_PROMPTS} prompts and the paged engine over {PAR_REQUESTS} "
        f"requests from load_models(mesh=...), greedy and sampled, tokens "
        f"and acceptance == unsharded; {total['all_reduce']} all-reduces; "
        f"window ms with the mesh {walls['mesh']}, without {walls['plain']} "
        f"(medians {out['window_ms_median']['mesh']:.2f} and "
        f"{out['window_ms_median']['plain']:.2f}); one all-reduce "
        f"{out['all_reduce_us']} ({card}); launches "
        f"{ {k: n for k, n in total.items() if n} }")
    return out, total


def par_model(cfg, device):
    """The INT4 model of phase 13b, the same bits on every rank."""
    from specdec_tpu_torch.core.model import init_params
    from specdec_tpu_torch.quant.core import quantize_params

    gen = torch.Generator(device=device).manual_seed(13)
    return quantize_params(init_params(cfg, scale=0.02, device=device,
                                       generator=gen), kind="int4", fuse=True)


def planted_faults(params, base, mesh, local, tokens, rows):
    """The sharded forward's logits (data rows gathered) under each fault
    of PAR_FAULTS, planted at run time on every rank alike (the code is
    not changed): the first skips the third all-reduce of a forward on
    ``local`` (the embedding's, layer 0's wo, layer 0's w_down), so each
    rank keeps its own partial sum; the second builds the last model
    rank's shard on rank 0's KV heads."""
    from specdec_tpu_torch.core.model import forward_full
    from specdec_tpu_torch.parallel import local_config, shard_params
    from specdec_tpu_torch.parallel import mesh as mesh_mod

    lc = local_config(base, mesh)
    out = {}
    reduce, calls = mesh_mod.Mesh.all_reduce, [0]

    def dropping(self, x):
        calls[0] += 1
        return x if calls[0] == 3 else reduce(self, x)

    mesh_mod.Mesh.all_reduce = dropping
    try:
        out[PAR_FAULTS[0]] = torch.cat(mesh.gather_rows(
            forward_full(lc, local, tokens[rows]).cpu()))
    finally:
        mesh_mod.Mesh.all_reduce = reduce
    kv_heads = mesh_mod._kv_heads

    def wrong(cfg, tp, r):
        return kv_heads(cfg, tp, 0 if r == tp - 1 else r)

    mesh_mod._kv_heads = wrong
    try:
        local = shard_params(params, base, mesh)
    finally:
        mesh_mod._kv_heads = kv_heads
    out[PAR_FAULTS[1]] = torch.cat(mesh.gather_rows(
        forward_full(lc, local, tokens[rows]).cpu()))
    return out


def parallel_rank(rank, world, address, root, device, layouts, refs, out):
    """One rank of phase 13b (spawned): joins a gloo world (named: NCCL
    takes one rank a card) whose tensors are CUDA tensors on the one card,
    builds the model, and for each (tp, dp) of ``layouts`` and each KV
    format shards it, runs batched greedy AR and a forward over the
    prompts, and reads the forward under each planted fault
    (``planted_faults``, bf16 KV); rank 0 holds them against ``refs``
    (the unsharded run's tokens) and its own unsharded forward, and writes
    ``out``. ``device``: the card every rank runs on."""
    sys.path.insert(0, root)
    import torch.distributed as dist

    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.model import forward_full
    from specdec_tpu_torch.engine.batch_engine import (
        batch_autoregressive_generate,
    )
    from specdec_tpu_torch.parallel import (
        batch_state_pspecs, build_mesh, init_distributed, local_config,
        shard_params,
    )

    device = torch.device(device)
    torch.cuda.set_device(device)
    init_distributed(address, world, rank, backend="gloo", device=device)
    base = bench.target_config(num_layers=PAR_LAYERS)
    params = par_model(base, device)
    prompts = refs["prompts"]
    tokens = torch.tensor(prompts, device=device)
    full = forward_full(base, params, tokens).cpu() if rank == 0 else None

    def rel_fro(logits, cfg_full):
        return float((logits - cfg_full).norm() / cfg_full.norm())

    results = []
    for tp, dp in layouts:
        mesh = build_mesh(tp=tp, dp=dp, device=device)
        local = shard_params(params, base, mesh)
        rows = batch_state_pspecs(mesh, len(prompts))
        for label, kw in PAR_KV.items():
            cfg = base.replace(**kw)
            lc = local_config(cfg, mesh)
            logits = torch.cat(mesh.gather_rows(
                forward_full(lc, local, tokens[rows]).cpu()))
            par_reset()
            got = batch_autoregressive_generate(
                prompts, lc, local, gen_len=PAR_B_GEN, eos_tokens_id=(),
                device=device)
            rec = {"tp": tp, "dp": dp, "kv": label, "counts": par_counts(),
                   "local_cfg": [lc.num_heads, lc.num_kv_heads,
                                 lc.intermediate_size]}
            if rank == 0:
                cfg_full = (full if not kw
                            else forward_full(cfg, params, tokens).cpu())
                rec["logit_rel_fro"] = rel_fro(logits, cfg_full)
                rec["parted"] = [
                    list(greedy_tie(f"13b tp={tp} x dp={dp}, {label}", cfg,
                                    params, p, ref, o, device))
                    for p, ref, o in zip(prompts, refs[label], got)
                    if o != ref]
                rec["equal"] = sum(o == r for o, r in zip(got, refs[label]))
            results.append(rec)
        faults = planted_faults(params, base, mesh, local, tokens, rows)
        if rank == 0:
            results[-len(PAR_KV)]["faults"] = {
                k: rel_fro(v, full) for k, v in faults.items()}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


def phase_parallel_gloo(device, card, root):
    """Phase 13b: worlds of 2 and 4 ranks on the one card (NCCL takes one
    rank per GPU, so the transport here is gloo, named explicitly, over
    CUDA tensors), at TinyLlama's widths cut to PAR_LAYERS layers, INT4:
    tp=2, tp=4 and tp=2 x dp=2, with bf16 KV and with int8 KV under the
    flash kernel (K4). Greedy batched AR equals the unsharded run's up to
    ``greedy_tie``; the logits' relative error against the unsharded
    forward stays within PAR_LOGIT_FRO, and each planted fault reads
    above it; at tp=4 the row-parallel w_down
    (K = 5632 / 4 = 1408) takes the dequant route and every other
    projection K1b, at tp=2 (K = 2816) all take K1b. Returns (summary,
    launches of rank 0 summed)."""
    import tempfile

    import torch.multiprocessing as mp

    from specdec_tpu_torch import bench
    from specdec_tpu_torch.engine.batch_engine import (
        batch_autoregressive_generate,
    )

    prompts = par_prompts(PAR_PROMPTS, PAR_PROMPT_LEN, seed=14)
    refs = {"prompts": prompts}
    base = bench.target_config(num_layers=PAR_LAYERS)
    params = par_model(base, device)
    for label, kw in PAR_KV.items():
        refs[label] = batch_autoregressive_generate(
            prompts, base.replace(**kw), params, gen_len=PAR_B_GEN,
            eos_tokens_id=(), device=device)
    del params
    torch.cuda.synchronize()
    records, total = [], {}
    for world, layouts in PAR_WORLDS:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
            out = os.path.join(d, "rank0.json")
            mp.spawn(parallel_rank, args=(world, f"127.0.0.1:{free_port()}",
                                          root, str(device), layouts, refs,
                                          out), nprocs=world)
            with open(out) as f:
                got = json.load(f)
        say(f"[time] 13b world of {world} in {time.perf_counter() - t0:.1f} s")
        records += got
    L = PAR_LAYERS
    for rec in records:
        what = f"13b tp={rec['tp']} x dp={rec['dp']}, {rec['kv']}"
        c = rec["counts"]
        if rec["logit_rel_fro"] > PAR_LOGIT_FRO:
            fail(f"{what}: logits {rec['logit_rel_fro']:.3g} relative "
                 f"Frobenius from the unsharded forward's (limit "
                 f"{PAR_LOGIT_FRO})")
        for fault, err in rec.get("faults", {}).items():
            # the limit must tell a wiring fault from the rounding
            if err <= PAR_LOGIT_FRO:
                fail(f"{what}: planted fault '{fault}' reads {err:.3g}, "
                     f"within the limit {PAR_LOGIT_FRO}")
        forwards = c["K1a"]  # the lm_head: once a forward
        routed = L if rec["tp"] == 4 else 0  # w_down at K = 1408
        if (forwards == 0 or c["route"] != forwards * routed
                or c["K1b"] != forwards * (4 * L - routed)):
            fail(f"{what}: launches {c}: expected per forward {L} w_down "
                 f"on the {'route' if routed else 'K1b'} and the rest of "
                 f"the {4 * L} projections on K1b")
        if rec["kv"] != "bf16 KV" and c["K4"] != forwards * L:
            fail(f"{what}: {c['K4']} K4 launches for {forwards} forwards")
        if c["all_reduce"] != forwards * (2 * L + 2):
            fail(f"{what}: {c['all_reduce']} all-reduces for {forwards} "
                 "forwards")
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
        say(f"[13b parallel] {what} (gloo, CUDA tensors, one card): local "
            f"heads/KV heads/F {rec['local_cfg']}; logits {rec['logit_rel_fro']:.3g} "
            f"relative Frobenius from unsharded (planted faults: "
            f"{ {k: round(v, 4) for k, v in rec.get('faults', {}).items()} }); "
            f"greedy AR {rec['equal']}/"
            f"{PAR_PROMPTS} equal, parted at a bf16 tie "
            f"{[p[0] for p in rec['parted']]}; per forward {c['K1b'] // forwards} "
            f"K1b, {c['route'] // forwards} routed, {c['all_reduce'] // forwards} "
            f"all-reduces ({card})")
    return {"records": records, "card": card}, total


# ---------------------------------------------------------------------------
# phase 14: pipeline parallelism
# ---------------------------------------------------------------------------

# 14a: the pair's INT4 target (22 layers, quantized lm_head) at one stage in
# an NCCL world of one rank: PP_B sequences at each T of PP_TS, each count
# of microbatches of PP_MS. 14b: gloo worlds on the one card (spawned, CUDA
# tensors), (stages, layers) of PP_WORLDS: 2 stages over the 22 layers, 4
# over the first 20 (22 % 4 != 0), at T = PP_TS[0], under each attention
# of PP_IMPLS
PP_B, PP_TS, PP_MS = 8, (13, 64), (1, 2, 4)
PP_WORLDS = ((2, 22), (4, 20))
PP_IMPLS = ("xla", "flash")
# the pipeline's logits against the unsharded forward's, relative
# Frobenius: a stage runs the unsharded forward's kernels on the same rows
# and the hop is exact, so only a microbatch's smaller batch may move a
# bf16 rounding (the plain attention's batched products). The faults of
# PP_FAULTS, planted at PP_FAULT_M microbatches, must read above it
PP_LOGIT_FRO = 1e-2
PP_FAULTS = ("the hop delivers a stage's input one microbatch late",
             "the last stage writes microbatch j's logits into slot j + 1")
PP_FAULT_M = 4


def pp_tokens(T, seed):
    """PP_B sequences of T tokens, the same on every rank."""
    from specdec_tpu_torch import bench

    rng = np.random.default_rng(seed)
    return rng.integers(1, bench.V, size=(PP_B, T)).tolist()


def logit_gap(what, logits, ref):
    """``logits`` against the unsharded ``ref`` [B, T, V]: the relative
    Frobenius error, the largest absolute difference, whether they are
    equal bit for bit, and the positions whose argmax differs, each of
    which must be a top-two tie of ``ref`` within two bf16 ulps."""
    parted = (logits.argmax(-1) != ref.argmax(-1)).nonzero().tolist()
    for b, t in parted:
        top2 = ref[b, t].topk(2).values.tolist()
        ulp = 2.0 ** (math.floor(math.log2(abs(top2[0]))) - 7)
        if top2[0] - top2[1] > 2 * ulp:
            fail(f"{what}: the argmax of sequence {b}, position {t} differs "
                 f"from the unsharded forward's, whose top-2 gap "
                 f"{top2[0] - top2[1]:.3g} exceeds two bf16 ulps")
    return {"rel_fro": float((logits - ref).norm() / ref.norm()),
            "max_abs": float((logits - ref).abs().max()),
            "bit_equal": bool(torch.equal(logits, ref)),
            "parted_at_ties": len(parted)}


def pp_counts(what, counts, m, per_stage, last, flash):
    """One rank's launches of a pipeline call of ``m`` microbatches over
    ``per_stage`` layers: four K1b a layer and microbatch, the K1a of the
    lm_head once a microbatch on the last stage only, one K3 a layer and
    microbatch under the flash kernel; nothing else."""
    want = {k: 0 for k in counts}
    want["K1b"] = 4 * m * per_stage
    want["K1a"] = m if last else 0
    want["K3"] = m * per_stage if flash else 0
    if counts != want:
        fail(f"{what}: launches {counts}, expected {want}")


def phase_pipeline_nccl(pair, device, card):
    """Phase 14a: ``pipeline_forward_full`` at one stage in an NCCL world of
    one rank, on the pair's INT4 target (22 layers, quantized lm_head), at
    B = PP_B and each T of PP_TS, at each microbatch count of PP_MS: at one
    microbatch the logits equal ``forward_full``'s bit for bit; at more,
    the largest difference is reported and the argmaxes agree up to
    top-two ties. Launches as ``pp_counts``. Returns (summary, launches
    summed)."""
    import torch.distributed as dist

    from specdec_tpu_torch.core.model import forward_full
    from specdec_tpu_torch.parallel import (
        build_pipeline_mesh, init_distributed, pipeline_forward_full,
        shard_params_pipeline,
    )

    t_cfg, target = pair[0], pair[2]
    L = t_cfg.num_layers
    if not init_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                            device=device):
        fail("14a: init_distributed did not join a world of one rank")
    if dist.get_backend() != "nccl":
        fail(f"14a: backend {dist.get_backend()}, not nccl")
    records, total = [], {}
    try:
        mesh = build_pipeline_mesh(stages=1)
        local = shard_params_pipeline(target, t_cfg, mesh)
        for T in PP_TS:
            tokens = torch.tensor(pp_tokens(T, seed=T), device=device)
            ref = forward_full(t_cfg, target, tokens)
            for m in PP_MS:
                what = f"14a T={T} M={m}"
                reset_launches()
                logits, wall = timed_call(lambda: pipeline_forward_full(
                    t_cfg, local, tokens, mesh, num_microbatches=m))
                counts = launches()
                pp_counts(what, counts, m, L, True, False)
                rec = {"T": T, "M": m, "wall_ms": wall * 1e3,
                       **logit_gap(what, logits, ref)}
                if m == 1 and not rec["bit_equal"]:
                    fail(f"{what}: logits differ from forward_full's at one "
                         f"stage and one microbatch (max abs "
                         f"{rec['max_abs']:.3g})")
                records.append(rec)
                for k, n in counts.items():
                    total[k] = total.get(k, 0) + n
        del local
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    say(f"[14a pipeline] NCCL world of 1, one stage, INT4 target ({L} "
        f"layers, quantized lm_head), B={PP_B}: "
        + "; ".join(f"T={r['T']} M={r['M']} {r['wall_ms']:.1f} ms, max abs "
                    f"{r['max_abs']:.3g}"
                    + (" (bit-equal)" if r["bit_equal"] else "")
                    + f", {r['parted_at_ties']} argmaxes parted at ties"
                    for r in records)
        + f"; walls on one card ({card}); launches "
        f"{ {k: n for k, n in total.items() if n} }")
    return {"records": records, "card": card}, total


def planted_pipeline_faults(cfg, local, tokens, mesh):
    """The pipeline's logits at PP_FAULT_M microbatches under each fault of
    PP_FAULTS, planted at run time on every rank alike (the code is not
    changed): a stage's receive hands on the activation it received one
    microbatch earlier; the last stage stores microbatch j's logits in
    slot j + 1 mod M."""
    from specdec_tpu_torch.parallel import pipeline as pp

    recv, store = pp._recv_activation, pp._store_logits
    held = []

    def late(mesh, like):
        held.append(recv(mesh, like))
        return held[-2] if len(held) > 1 else held[-1]

    def shifted(out, j, logits):
        store(out, (j + 1) % out.shape[0], logits)

    got = {}
    for fault, name, planted in ((PP_FAULTS[0], "_recv_activation", late),
                                 (PP_FAULTS[1], "_store_logits", shifted)):
        original = getattr(pp, name)
        setattr(pp, name, planted)
        try:
            got[fault] = pp.pipeline_forward_full(
                cfg, local, tokens, mesh, num_microbatches=PP_FAULT_M)
        finally:
            setattr(pp, name, original)
    return got


def pipeline_rank(rank, world, address, root, device, layers, tokens, out):
    """One rank of phase 14b (spawned): joins a gloo world whose tensors are
    CUDA tensors on the one card, builds the pair's INT4 target (the same
    bits on every rank) cut to ``layers`` layers, keeps its stage of a
    pipeline of ``world`` stages, and runs ``pipeline_forward_full`` at
    each microbatch count of PP_MS under each attention of PP_IMPLS, with
    its launches, then the planted faults. Rank 0 holds the logits against
    the unsharded ``forward_full`` (computed before it drops the other
    stages' layers) and writes every rank's records to ``out``."""
    sys.path.insert(0, root)
    import torch.distributed as dist

    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.model import forward_full, layer_views
    from specdec_tpu_torch.parallel import (
        build_pipeline_mesh, init_distributed, pipeline_forward_full,
        shard_params_pipeline,
    )

    device = torch.device(device)
    torch.cuda.set_device(device)
    init_distributed(address, world, rank, backend="gloo", device=device)
    t_cfg, _, target, _ = bench.build_pair(device)
    cfg = t_cfg.replace(num_layers=layers)
    params = dict(target, layers=layer_views(target["layers"], layers))
    tokens = torch.tensor(tokens, device=device)
    refs = ({impl: forward_full(cfg.replace(attention_impl=impl), params,
                                tokens) for impl in PP_IMPLS}
            if rank == 0 else None)
    mesh = build_pipeline_mesh()  # no device: the rank's card
    local = shard_params_pipeline(params, cfg, mesh)
    del target, params
    torch.cuda.empty_cache()
    # warm-up (the rank's first products and host staging), not timed
    for impl in PP_IMPLS:
        pipeline_forward_full(cfg.replace(attention_impl=impl), local,
                              tokens, mesh, num_microbatches=1)
    records = []
    for impl in PP_IMPLS:
        c = cfg.replace(attention_impl=impl)
        for m in PP_MS:
            reset_launches()
            logits, wall = timed_call(lambda: pipeline_forward_full(
                c, local, tokens, mesh, num_microbatches=m))
            rec = {"rank": rank, "stage": mesh.stage, "impl": impl, "M": m,
                   "wall_ms": wall * 1e3, "counts": launches()}
            if rank == 0:
                rec.update(logit_gap(f"14b {world} stages, {impl}, M={m}",
                                     logits, refs[impl]))
            records.append(rec)
    faults = planted_pipeline_faults(cfg.replace(attention_impl="xla"),
                                     local, tokens, mesh)
    if rank == 0:
        records.append({"faults": {
            k: float((v - refs["xla"]).norm() / refs["xla"].norm())
            for k, v in faults.items()}})
    gathered = [None] * world
    dist.all_gather_object(gathered, records)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(gathered, f)
    dist.destroy_process_group()


def phase_pipeline_gloo(device, card, root):
    """Phase 14b: gloo worlds on the one card (NCCL takes one rank per GPU;
    every rank's tensors are CUDA tensors, each hop staged through the
    host), PP_WORLDS: 2 stages over the pair's 22 INT4 layers and 4 over
    its first 20, B = PP_B, T = PP_TS[0], microbatches PP_MS, under the
    plain attention and the flash kernel. The logits stay within
    PP_LOGIT_FRO of the unsharded forward's with argmaxes equal up to
    top-two ties; each planted fault reads above the limit; every rank
    launches as ``pp_counts``. Walls are one card's: the ranks share it,
    so they say nothing of PP across cards. Returns (summary, launches of
    every rank summed)."""
    import tempfile

    import torch.multiprocessing as mp

    T = PP_TS[0]
    tokens = pp_tokens(T, seed=T)
    records, total = [], {}
    for stages, layers in PP_WORLDS:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
            out = os.path.join(d, "ranks.json")
            mp.spawn(pipeline_rank,
                     args=(stages, f"127.0.0.1:{free_port()}", root,
                           str(device), layers, tokens, out), nprocs=stages)
            with open(out) as f:
                ranks = json.load(f)
        seconds = time.perf_counter() - t0
        say(f"[time] 14b {stages} stages in {seconds:.1f} s")
        what = f"14b {stages} stages over {layers} layers"
        for recs in ranks:
            for rec in recs:
                if "counts" not in rec:
                    continue
                pp_counts(f"{what}, rank {rec['rank']}, {rec['impl']}, "
                          f"M={rec['M']}", rec["counts"], rec["M"],
                          layers // stages, rec["stage"] == stages - 1,
                          rec["impl"] == "flash")
                for k, n in rec["counts"].items():
                    total[k] = total.get(k, 0) + n
        calls = [r for r in ranks[0] if "counts" in r]
        faults = next(r["faults"] for r in ranks[0] if "faults" in r)
        for r in calls:
            if r["rel_fro"] > PP_LOGIT_FRO:
                fail(f"{what}, {r['impl']}, M={r['M']}: logits "
                     f"{r['rel_fro']:.3g} relative Frobenius from the "
                     f"unsharded forward's (limit {PP_LOGIT_FRO})")
        for fault, err in faults.items():
            if err <= PP_LOGIT_FRO:
                fail(f"{what}: planted fault '{fault}' reads {err:.3g}, "
                     f"within the limit {PP_LOGIT_FRO}")
        records.append({"stages": stages, "layers": layers, "T": T,
                        "seconds": seconds, "calls": calls,
                        "faults": faults})
        say(f"[14b pipeline] {what} (gloo, CUDA tensors, one card), B={PP_B}"
            f" T={T}: "
            + "; ".join(f"{r['impl']} M={r['M']} {r['wall_ms']:.1f} ms, "
                        f"{r['rel_fro']:.3g} rel. Frobenius"
                        + (" (bit-equal)" if r["bit_equal"] else
                           f", max abs {r['max_abs']:.3g}")
                        + f", {r['parted_at_ties']} argmaxes parted at ties"
                        for r in calls)
            + f" (limit {PP_LOGIT_FRO}); planted faults "
            f"{ {k: round(v, 4) for k, v in faults.items()} }; per rank and "
            f"microbatch {4 * (layers // stages)} K1b, "
            f"{layers // stages} K3 under flash, one K1a on the last stage; "
            f"walls are rank 0's on one card shared by {stages} ranks "
            f"({card}): they say nothing of PP across cards")
    return {"records": records, "card": card}, total


# Qwen/Qwen2-0.5B's config.json on the Hugging Face hub, cut to ROUTE_LAYERS
# layers: hidden 896 (K % 256 = 128), so its 4-bit wqkv, wo and w_gateup
# take the dequant route and w_down (K = 4864 = 19 x 256) its kernel; the
# head is the tied embedding
QWEN2_05B = dict(vocab_size=151936, hidden_size=896, intermediate_size=4864,
                 num_heads=14, num_kv_heads=2, head_dim=64,
                 max_position_embeddings=32768, rope_theta=1000000.0,
                 norm_eps=1e-6, attn_qkv_bias=True, tie_embeddings=True)
ROUTE_LAYERS, ROUTE_GEN = 2, 32


def phase_route(device, card):
    """Phase 9c (route): 4-bit weights whose K the kernels do not take, on
    the card. A Qwen2-0.5B-width model (2 layers, random weights) in INT4
    and NF4: the kernel wrappers refuse its K=896 before any launch, the
    model runs with its wqkv, wo and w_gateup on the dequant route and its
    w_down on K1b / K6b (the counts hold that split exactly), and its greedy
    AR tokens equal those of the dense model of the dequantized weights up
    to ``greedy_tie`` (the route computes that model's products; the
    kernel's w_down rounds its own way). Returns launches by format."""
    from specdec_tpu_torch import bench
    from specdec_tpu_torch.core.config import ModelConfig
    from specdec_tpu_torch.core.model import init_params
    from specdec_tpu_torch.ops import quant_matmul as qm
    from specdec_tpu_torch.quant.core import (
        QUANTIZED, check_kernel_shapes, dequantize, quantize_params,
    )
    from specdec_tpu_torch.sampling.base_decoding import (
        autoregressive_generate,
    )

    cfg = ModelConfig(num_layers=ROUTE_LAYERS, dtype=torch.bfloat16,
                      **QWEN2_05B)
    gen = torch.Generator(device=device).manual_seed(9)
    dense = init_params(cfg, scale=0.02, device=device, generator=gen)
    prompt = bench.bench_prompt(seed=9)
    by_kind = {}
    for kind, (stacked, wrapper) in (("int4", ("K1b", qm.int4_matmul_stacked)),
                                     ("nf4", ("K6b",
                                              qm.q4_halfplane_matmul_stacked))):
        params = quantize_params(dense, kind=kind, fuse=True)
        routes = check_kernel_shapes(cfg, kind)
        if routes != {"wqkv": "dequant", "wo": "dequant",
                      "w_gateup": "dequant", "w_down": "kernel"}:
            fail(f"9c route ({kind}): routes {routes}")
        x = torch.zeros((1, cfg.hidden_size), dtype=torch.bfloat16,
                        device=device)
        try:
            wrapper(x, params["layers"]["wqkv"], 0)
            fail(f"9c route ({kind}): the kernel wrapper took K=896")
        except ValueError as e:
            if "K=896" not in str(e):
                raise
        deq = dict(params, layers={
            k: dequantize(v, torch.bfloat16) if isinstance(v, QUANTIZED)
            else v for k, v in params["layers"].items()})
        ref = autoregressive_generate(prompt, cfg, deq, max_gen_len=ROUTE_GEN,
                                      eos_tokens_id=(), device=device)
        par_reset()
        got = autoregressive_generate(prompt, cfg, params,
                                      max_gen_len=ROUTE_GEN, eos_tokens_id=(),
                                      device=device)
        c = par_counts()
        L = ROUTE_LAYERS
        forwards = c[stacked] // L
        if (forwards == 0 or c[stacked] != forwards * L
                or c["route"] != forwards * 3 * L):
            fail(f"9c route ({kind}): {c[stacked]} {stacked} launches and "
                 f"{c['route']} routed products; expected {L} and {3 * L} "
                 "a forward")
        parted = None
        if got != ref:
            parted = greedy_tie(f"9c route ({kind})", cfg, deq, prompt, ref,
                                got, device)[0]
        by_kind[kind] = {k: n for k, n in c.items() if n}
        say(f"[9c route] {kind} at Qwen2-0.5B widths ({L} layers): the "
            f"kernel wrapper refused K=896; per forward {3 * L} products on "
            f"the dequant route and {L} on {stacked}; greedy AR over "
            f"{ROUTE_GEN} tokens == the dequantized dense model's"
            + ("" if parted is None else f" up to a bf16 tie at token "
               f"{parted}") + f" ({card})")
    return by_kind


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
    served_records = phase_served(device, against)
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
    summary_gemma, launches_gemma = phase_gemma(device, card)
    stamp("4c head_dim 256 at gemma-2b widths")
    expert_records, mla_records, launches_deepseek = phase_deepseek(device,
                                                                    card)
    stamp("4e latent attention and experts at DeepSeek-V2-Lite widths")
    mla_kernel_records = phase_mla_kernel(device, card, against)
    stamp("4f the MLA decode kernel at longreason's shapes")
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
        # half the tokens a call (phase 13's time): the launch counts and
        # kernels are the same, one timed call each
        fmt_main[quant], fmt_launches[quant] = phase_main(
            pairs[quant], device, f"{quant} weights", gen=bench.GEN // 2)
    stamp("5 single sequence")
    summary["serving"], serve_launches = phase_serve(pair, device)
    int8_serving, serve_launches_int8 = phase_serve(int8_pair, device,
                                                    "int8 KV, flash")
    # the weight formats' serving passes go unprofiled (phase 13's time)
    fmt_main["int8"]["serving"], serve_launches_w8 = phase_serve(
        pairs["int8"], device, "int8 weights", engines=("paged",),
        profile=False)
    fmt_main["nf4"]["serving"], serve_launches_nf4 = phase_serve(
        pairs["nf4"], device, "nf4 weights", engines=("paged",),
        profile=False)
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
    summary["harness"], launches_harness, k1_8b = phase_harness(
        device, card, root, pair[2])
    stamp("9-9d benchmark entry point, loaders, serving facade")
    grad_records = phase_grad(pairs, device)
    stamp("10a gradients")
    convergence = phase_convergence(device, card)
    stamp("10c convergence")
    summary["training"], launches_train = phase_train(device, card, root)
    summary["training"]["convergence"] = convergence
    stamp("10b and 10d training")
    summary["codec"] = phase_codec(device, card, root)
    stamp("11 encoder-decoder")
    summary["repl"] = phase_repl(device, card, root)
    stamp("12 REPL")
    summary["parallel_nccl"], launches_13a = phase_parallel_nccl(pair, device,
                                                                 card)
    stamp("13a parallel, NCCL world of 1")
    summary["parallel_gloo"], launches_13b = phase_parallel_gloo(device, card,
                                                                 root)
    stamp("13b parallel, gloo worlds of 2 and 4 on one card")
    summary["pipeline_nccl"], launches_14a = phase_pipeline_nccl(pair, device,
                                                                 card)
    stamp("14a pipeline, NCCL world of 1")
    summary["pipeline_gloo"], launches_14b = phase_pipeline_gloo(device, card,
                                                                 root)
    stamp("14b pipeline, gloo worlds of 2 and 4 stages on one card")
    summary["gemma"] = summary_gemma
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
             "eagle_serving": launches_eagle_serve["eagle_serving"][key],
             **{path: c.get(key, 0) for path, c in launches_harness.items()
                if path not in ("harness_cli_int8", "loader_route_nf4")},
             "parallel_nccl": launches_13a[key],
             "parallel_gloo": launches_13b[key],
             **{path: c[key] for path, c in launches_train.items()},
             "gemma_2b_width": launches_gemma.get(key, 0),
             "pipeline_nccl": launches_14a[key],
             "pipeline_gloo": launches_14b[key]},
            k1_8b=[r for r in k1_8b if (r["layer"] is None) == (key == "K1a")],
            **({"served": served_records} if key == "K1a" else {}),
            training=[r for r in grad_records["int4"]
                      if (r["name"] == LM_HEAD[0]) == (key == "K1a")]))
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
             "serving_nf4": serve_launches_nf4[key],
             "loader_route_nf4": launches_harness["loader_route_nf4"].get(
                 key, 0)},
            codecs="nf4 (top-level times), fp4", fp4=step_times(fp4),
            training=[r for r in grad_records["nf4"]
                      if (r["name"] == LM_HEAD[0]) == (key == "K6a")]))
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
         + launches_trees["int8 weights"]["K7a"],
         "cli_int8": launches_harness["harness_cli_int8"]["K7b"]
         + launches_harness["harness_cli_int8"]["K7a"]},
        lm_head=step_times(stacked_records(w8, False)),
        training=grad_records["int8"]))

    def top(rows, name):
        return next(r for r in rows if r["name"] == name and "ms" in r)

    def head_dim_256(rows, name):
        """The timed record of a gemma-2b shape, and the refused one."""
        return {"timed": [r for r in rows if r["name"] == name and "ms" in r],
                "refused": [{k: r[k] for k in ("dtype", "refused")}
                            for r in rows if r["name"] == name
                            and "refused" in r]}

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
         "serving_nf4": serve_launches_nf4["K8a"] + serve_launches_nf4["K2"],
         "vllm_serving": launches_harness["vllm_serving"]["K8a"],
         "parallel_nccl_serving": launches_13a["K8a"],
         "gemma_2b_width_serving": launches_gemma["K8a"]},
        also_replaces="specdec_tpu/ops/paged_attention.py:26",
        head_dim_256=head_dim_256(paged_records["bf16"], "gemma-serve")))
    entries.append(kernel_entry(
        "paged_decode_attention_quant (K8b stacked layer; K5 4D pool)",
        paged_src, "specdec_tpu/ops/paged_attention.py:377",
        paged_records["int8"], paged_err["int8"],
        top(paged_records["int8"], "serve"),
        "serving verify: B=8, T=9, Hq=32, Hk=4, Dh=64, page 64, MP=9, int8 "
        "pools, bf16 q",
        {"serving_kvint8_flash": serve_launches_int8["K8b"]
         + serve_launches_int8["K5"],
         "vllm_serving_kvint8": launches_harness["vllm_serving_kvint8"]["K8b"],
         "gemma_2b_width_serving_kvint8": launches_gemma["K8b"]},
        also_replaces="specdec_tpu/ops/paged_attention.py:136",
        head_dim_256=head_dim_256(paged_records["int8"], "gemma-serve")))
    # the flash-decode kernel: K3 (K/V of q's type) and K4 (int8 K/V); the
    # top-level times are one single-sequence decode step's call
    flash_src = "specdec_tpu_torch/ops/csrc/decode_attention.cu"
    work = "single-sequence decode: B=1, S=334, T=1, Hq=32, Hk=4, Dh=64, "
    entries.append(kernel_entry(
        "flash_decode_attention (K3)", flash_src,
        "specdec_tpu/ops/decode_attention.py:38", flash_records["K3"],
        flash_err["K3"], top(flash_records["K3"], "decode"), work + "bf16",
        {"spec_decode_flash": launches_flash["K3"],
         "tree_oracle_flash": tree_oracle["bf16 KV, flash"]["K3"],
         "gemma_2b_width": launches_gemma["K3"],
         "deepseek_v2_width": launches_deepseek["K3"],
         "pipeline_gloo_flash": launches_14b["K3"]},
        head_dim_256={n: head_dim_256(flash_records["K3"], n)
                      for n in ("gemma-decode", "gemma-verify")},
        latent_attention_padded=mla_records))
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
         "eagle_kvint8_flash": launches_eagle["int8 KV, flash"]["K4"],
         "parallel_gloo_kvint8_flash": launches_13b["K4"],
         "gemma_2b_width_kvint8": launches_gemma["K4"]},
        head_dim_256={n: head_dim_256(flash_records["K4"], n)
                      for n in ("gemma-decode", "gemma-verify")}))
    entries.append(expert_entry(expert_records, launches_deepseek))
    entries.append(mla_entry(mla_kernel_records, launches_deepseek["mla"]))
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
