"""Headline benchmark of the port: speculative against autoregressive
decoding of a weight-quantized LayerSkip pair on the card (counterpart of
the root ``bench.py``, which measures the JAX package).

The pair is synthetic but shaped like a real one: a TinyLlama-1.1B-shaped
bf16 target (22 layers, D=2048, F=5632, 32 query heads, 4 KV heads of 64,
V=32000) whose layers 4..21 have ``wo`` and ``w_down`` damped by 0.08 (a
residual refinement on top of the first 4 layers), and a drafter made of
the target's first 4 layers. Both are weight-only quantized
(``quantize_params(kind=quant, fuse=True)``, quantized ``lm_head``);
``--quant`` picks the format: int4 (the default; kernel K1), int8 (K7), nf4
or fp4 (K6), or none (dense bf16, ``torch.matmul``), the counterpart of the
root bench's ``BENCH_QUANT``. The drafter's layers are views of the
target's stacked containers and it shares the embedding, final norm and
``lm_head``, so no weight exists twice. Weights are random, drawn on the
device from a ``torch.Generator`` seeded 0.

Run: ``python -m specdec_tpu_torch.bench``. It decodes 256 tokens after a
60-token prompt with MultinomialProcessor(1.0), speculating gamma=12, and
prints one JSON line to stdout,
``{"metric": "spec_decode_int4_tokens_per_sec", "value": spec tok/s,
"unit": "tokens/s", "vs_baseline": spec/AR speedup}``; everything else goes
to stderr. Each measurement is one warm-up call (WARM_GEN tokens) and
REPS timed calls, timed with CUDA events; tokens/s is the best of the
timed calls. The
metric names the weight format as the root bench does
(``spec_decode_{quant}_tokens_per_sec``, ``spec_decode_tokens_per_sec``
for none).

``python -m specdec_tpu_torch.bench --serve`` measures serving instead (the
counterpart of ``tools/bench_paged.py::bench_serving``): 16 requests with
prompt lengths drawn from ``default_rng(1).integers(30, 200)``, 128 new
tokens each, no EOS, greedy, through the default engine
(``PagedContinuousBatcher``: page 64, a pool of (slots+1)*S tokens, so no
request is preempted) and the slotted ``ContinuousBatcher``, both with 8
slots, gamma 8 and 8 windows per host sync. Each engine runs one warm-up
pass and one timed pass; it prints one JSON line with aggregate tok/s, TTFT
p50/p99, mean acceptance and preemptions per engine, under the metric
``serve_{quant}_tokens_per_sec`` (``serve_tokens_per_sec`` for none).

``--kv-quant int8`` gives both models int8 KV caches (``QuantKVCache``,
``QuantPagedKVCache``), ``--attn flash`` sends their slotted-cache
attention through the flash-decode kernel; both go into ``target_config``
and so into the drafter's config too. With either flag the JSON line's
metric names the configuration (``spec_decode_int4_kvint8_flash_tokens_
per_sec``, ``serve_int4_kvint8_flash_tokens_per_sec``) and the line gains
``"kv_quant"`` and ``"attention_impl"`` keys; without them it is unchanged.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import init_params, layer_views
from specdec_tpu_torch.quant.core import quantize_params
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate
from specdec_tpu_torch.sampling.processors import (
    LogitsProcessor, MultinomialProcessor,
)
from specdec_tpu_torch.sampling.speculative import _spec_generate
from specdec_tpu_torch.serve import ContinuousBatcher, PagedContinuousBatcher

DRAFT_LAYERS = 4
V = 32000
TAIL_DAMP = 0.08
PROMPT_LEN = 60
GAMMA = 12
GEN = 256
REPS = 3
# the warm-up call's tokens: eager PyTorch compiles nothing, so the warm-up
# only needs to touch every shape of a call (the prefill, a step, a window)
WARM_GEN = 32
QUANT_KINDS = ("int4", "int8", "nf4", "fp4", "none")
# serving measurement
SERVE_REQUESTS = 16
SERVE_SLOTS = 8
SERVE_GAMMA = 8
SERVE_GEN = 128
SERVE_MAX_PROMPT = 256
SERVE_PAGE = 64
WINDOWS_PER_SYNC = 8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def target_config(num_layers: int = 22, dtype: torch.dtype = torch.bfloat16,
                  kv_quant: str = "none",
                  attention_impl: str = "xla") -> ModelConfig:
    return ModelConfig(
        vocab_size=V, hidden_size=2048, intermediate_size=5632,
        num_layers=num_layers, num_heads=32, num_kv_heads=4, head_dim=64,
        max_position_embeddings=2048, rope_theta=10000.0, dtype=dtype,
        kv_quant=kv_quant, attention_impl=attention_impl)


def build_pair(device=None, kv_quant: str = "none",
               attention_impl: str = "xla", quant: str = "int4",
               tail_damp: float = TAIL_DAMP):
    """The LayerSkip pair, weights in format ``quant`` (QUANT_KINDS), the
    ``wo`` and ``w_down`` of layers 4..21 damped by ``tail_damp`` (the
    drafter's quality: 0.08 by default, 0.35 for a weak drafter, the two
    operating points of ``tools/bench_tree.py``). Returns (t_cfg, d_cfg,
    target, drafter); the drafter's config is the target's with 4 layers,
    so it inherits the KV format and the attention."""
    device = resolve_device(device)
    t_cfg = target_config(kv_quant=kv_quant, attention_impl=attention_impl)
    d_cfg = t_cfg.replace(num_layers=DRAFT_LAYERS)
    gen = torch.Generator(device=device).manual_seed(0)
    base = init_params(t_cfg, scale=0.02, device=device, generator=gen)
    layer_scale = torch.ones(t_cfg.num_layers, device=device)
    layer_scale[DRAFT_LAYERS:] = tail_damp
    layers = dict(base["layers"])
    for name in ("wo", "w_down"):
        layers[name] = (layers[name].to(torch.float32)
                        * layer_scale[:, None, None]).to(t_cfg.dtype)
    target = dict(base, layers=layers)
    if quant != "none":
        target = quantize_params(target, kind=quant, fuse=True)
    drafter = dict(target, layers=layer_views(target["layers"],
                                              d_cfg.num_layers))
    return t_cfg, d_cfg, target, drafter


def bench_prompt(seed: int = 0) -> List[int]:
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, V, size=PROMPT_LEN)]


def _timed(fn: Callable[[], dict]) -> dict:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rec = fn()
    end.record()
    end.synchronize()
    rec["seconds"] = start.elapsed_time(end) / 1e3
    return rec


def _summary(runs: List[dict]) -> dict:
    timed = runs[1:]
    best = min(timed, key=lambda r: r["seconds"])
    return {"runs": runs, "tok_s": best["tokens"] / best["seconds"]}


def run_ar(t_cfg: ModelConfig, target, prompt: List[int], gen: int,
           proc: LogitsProcessor, seed: int, device) -> dict:
    """One AR call. Returns {tokens, ids}."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids = autoregressive_generate(prompt, t_cfg, target, max_gen_len=gen,
                                  logits_processor=proc, eos_tokens_id=(),
                                  generator=g, device=device)
    return {"tokens": len(ids), "ids": ids}


def run_spec(d_cfg: ModelConfig, drafter, t_cfg: ModelConfig, target,
             prompt: List[int], gen: int, gamma: int, proc: LogitsProcessor,
             seed: int, device) -> dict:
    """One speculative call. Returns {tokens, ids, windows, acceptance}."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids, accepted, speculated, accept_log = _spec_generate(
        prompt, d_cfg, drafter, t_cfg, target, gamma, gen, proc, (), True,
        False, g, 0, device)
    return {"tokens": len(ids), "ids": ids, "windows": len(accept_log),
            "acceptance": accepted / speculated if speculated else 0.0}


def measure_ar(t_cfg: ModelConfig, target, prompt: List[int], gen: int,
               proc: LogitsProcessor, device=None, reps: int = REPS) -> dict:
    """One warm-up (WARM_GEN tokens) and ``reps`` timed AR calls. Returns
    {"runs": [{tokens, ids, seconds}], "tok_s"}; runs[0] is the
    warm-up."""
    device = resolve_device(device)
    runs = [_timed(lambda s=1 + i, n=n: run_ar(t_cfg, target, prompt, n,
                                               proc, s, device))
            for i, n in enumerate([WARM_GEN] + [gen] * reps)]
    return _summary(runs)


def measure_spec(d_cfg: ModelConfig, drafter, t_cfg: ModelConfig, target,
                 prompt: List[int], gen: int, gamma: int,
                 proc: LogitsProcessor, device=None,
                 reps: int = REPS) -> dict:
    """One warm-up (WARM_GEN tokens) and ``reps`` timed speculative calls.
    Returns {"runs": [{tokens, ids, windows, acceptance, seconds}],
    "tok_s", "acceptance"}; runs[0] is the warm-up."""
    device = resolve_device(device)
    runs = [_timed(lambda s=100 + i, n=n: run_spec(
        d_cfg, drafter, t_cfg, target, prompt, n, gamma, proc, s, device))
            for i, n in enumerate([WARM_GEN] + [gen] * reps)]
    out = _summary(runs)
    out["acceptance"] = float(np.mean([r["acceptance"] for r in runs[1:]]))
    return out


def serving_prompts() -> List[List[int]]:
    rng = np.random.default_rng(1)
    return [[int(t) for t in rng.integers(1, V, size=int(n))]
            for n in rng.integers(30, 200, size=SERVE_REQUESTS)]


def make_batcher(paged: bool, pair, device):
    """The serving engine on the pair: paged (the default engine) or
    slotted."""
    t_cfg, d_cfg, target, drafter = pair
    kw = dict(num_slots=SERVE_SLOTS, gamma=SERVE_GAMMA,
              max_prompt_len=SERVE_MAX_PROMPT, max_new_tokens=SERVE_GEN,
              windows_per_sync=WINDOWS_PER_SYNC, eos_tokens_id=(),
              device=device)
    if not paged:
        return ContinuousBatcher(d_cfg, drafter, t_cfg, target, **kw)
    # a pool that backs every slot at full length: measures the paged path,
    # not preemption
    S = SERVE_MAX_PROMPT + SERVE_GEN + SERVE_GAMMA + 2
    return PagedContinuousBatcher(d_cfg, drafter, t_cfg, target,
                                  page_size=SERVE_PAGE,
                                  pool_tokens=(SERVE_SLOTS + 1) * S, **kw)


def serve_pass(batcher, prompts: List[List[int]],
               max_new_tokens: int = SERVE_GEN) -> dict:
    """Submit every prompt at once, ``max_new_tokens`` each, and drain the
    batcher; host clock around the run, which ends in a host read. Returns
    {seconds, tokens, tok_s, ttft_p50_ms, ttft_p99_ms (numpy percentiles
    over requests), acceptance (mean over requests), outputs (per request,
    in submission order)}."""
    ids = [batcher.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = batcher.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    reqs = [done[i] for i in ids]
    batcher.completed.clear()
    toks = sum(len(r.output_ids) for r in reqs)
    ttft = np.percentile([r.metrics.ttft * 1e3 for r in reqs], [50, 99])
    return {"seconds": dt, "tokens": toks, "tok_s": toks / dt,
            "ttft_p50_ms": float(ttft[0]), "ttft_p99_ms": float(ttft[1]),
            "acceptance": float(np.mean([r.metrics.acceptance_rate
                                         for r in reqs])),
            "outputs": [r.output_ids for r in reqs]}


def measure_serving(paged: bool, pair, device=None) -> dict:
    """One warm-up pass and one timed pass of one engine. Returns
    {"engine", "warm", "timed", "preemptions", "batcher"}."""
    device = resolve_device(device)
    b = make_batcher(paged, pair, device)
    prompts = serving_prompts()
    warm = serve_pass(b, prompts)
    timed = serve_pass(b, prompts)
    return {"engine": "paged" if paged else "slotted", "warm": warm,
            "timed": timed, "preemptions": getattr(b, "preemptions", 0),
            "batcher": b}


def _metric(stem: str, quant: str, kv_quant: str,
            attention_impl: str) -> dict:
    """The JSON line's leading keys: the metric named for the configuration
    (e.g. ``spec_decode_int4_kvint8_flash_tokens_per_sec``; the weight
    format is left out for dense weights, as the root bench does) and, off
    the default KV format and attention, the two keys naming them; the
    default's line stays as it was."""
    stem = stem if quant == "none" else f"{stem}_{quant}"
    if kv_quant == "none" and attention_impl == "xla":
        return {"metric": f"{stem}_tokens_per_sec"}
    tags = ("_kv" + kv_quant if kv_quant != "none" else "") + (
        "_" + attention_impl if attention_impl != "xla" else "")
    return {"metric": f"{stem}{tags}_tokens_per_sec", "kv_quant": kv_quant,
            "attention_impl": attention_impl}


def main_serve(kv_quant: str = "none", attention_impl: str = "xla",
               quant: str = "int4") -> Dict[str, float]:
    device = resolve_device(None)
    log(f"device: {torch.cuda.get_device_name(device)}")
    pair = build_pair(device, kv_quant, attention_impl, quant)
    rows = {}
    for paged in (True, False):
        r = measure_serving(paged, pair, device)
        t = r["timed"]
        log(f"{r['engine']}: {t['tokens']} tokens in {t['seconds']:.2f} s = "
            f"{t['tok_s']:.1f} tok/s, TTFT p50 {t['ttft_p50_ms']:.0f} ms, "
            f"p99 {t['ttft_p99_ms']:.0f} ms, acceptance "
            f"{t['acceptance']:.3f}, preemptions {r['preemptions']}")
        rows[r["engine"]] = {k: t[k] for k in (
            "tok_s", "ttft_p50_ms", "ttft_p99_ms", "acceptance")}
        rows[r["engine"]]["preemptions"] = r["preemptions"]
    result = {**_metric("serve", quant, kv_quant, attention_impl),
              "value": round(rows["paged"]["tok_s"], 2), "unit": "tokens/s",
              "vs_slotted": round(rows["paged"]["tok_s"]
                                  / rows["slotted"]["tok_s"], 3),
              "engines": rows}
    print(json.dumps(result))
    return result


def main(kv_quant: str = "none", attention_impl: str = "xla",
         quant: str = "int4") -> Dict[str, float]:
    device = resolve_device(None)
    log(f"device: {torch.cuda.get_device_name(device)}")
    t_cfg, d_cfg, target, drafter = build_pair(device, kv_quant,
                                               attention_impl, quant)
    proc = MultinomialProcessor(temperature=1.0)
    prompt = bench_prompt()
    ar = measure_ar(t_cfg, target, prompt, GEN, proc, device)
    spec = measure_spec(d_cfg, drafter, t_cfg, target, prompt, GEN, GAMMA,
                        proc, device)
    speedup = spec["tok_s"] / ar["tok_s"]
    log(f"AR {ar['tok_s']:.1f} tok/s; spec(gamma={GAMMA}) "
        f"{spec['tok_s']:.1f} tok/s, acceptance {spec['acceptance']:.3f}; "
        f"speedup {speedup:.3f}x")
    result = {**_metric("spec_decode", quant, kv_quant, attention_impl),
              "value": round(spec["tok_s"], 2), "unit": "tokens/s",
              "vs_baseline": round(speedup, 3)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        prog="python -m specdec_tpu_torch.bench",
        description="Speculative against AR decoding of the weight-quantized "
                    "LayerSkip pair on the card, or serving with --serve.")
    parser.add_argument("--serve", action="store_true",
                        help="measure both serving engines instead")
    parser.add_argument("--kv-quant", choices=("none", "int8"),
                        default="none", help="KV cache format of both models")
    parser.add_argument("--attn", choices=("xla", "flash"), default="xla",
                        help="slotted-cache attention: plain or the "
                             "flash-decode kernel")
    parser.add_argument("--quant", choices=QUANT_KINDS, default="int4",
                        help="weight format of both models")
    args = parser.parse_args()
    (main_serve if args.serve else main)(args.kv_quant, args.attn,
                                         args.quant)
