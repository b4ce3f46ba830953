"""The port's NASD paths (host store, native store, device table, serving),
its batch inference engine and its benchmark metrics against the JAX
package's, on the same params (a tiny float32 model, bridged with
``params_from_numpy``) and prompts drawn with numpy.

Greedy NASD emits only the target's own samples, so every variant must
give greedy AR's tokens, and the JAX package's. The host stores and their
unknown-context tokens are deterministic in both packages, so host-store
NASD's acceptance must equal JAX's exactly; so must the device table after
a single-sequence generation (its writes are committed tokens and the
target's top-k, in position order). Sampled NASD cannot match JAX's RNG:
its emitted tokens are held to the target's distribution by a TV bound
over many rows, as tests/test_speculative.py holds the JAX sampler."""
import dataclasses
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.engine import infer_engine as jie
from specdec_tpu.engine import metrics as jmet
from specdec_tpu.ngram import assisted as jas
from specdec_tpu.ngram import device_assisted as jda
from specdec_tpu.ngram import native as jnative
from specdec_tpu.ngram import storage as jst
from specdec_tpu.sampling import processors as jp
from specdec_tpu.sampling.base_decoding import (
    autoregressive_generate as jax_autoregressive_generate,
)
from specdec_tpu.serve import NasdContinuousBatcher as JaxNasdBatcher

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_full
from specdec_tpu_torch.engine import infer_engine as tie
from specdec_tpu_torch.engine import metrics as tmet
from specdec_tpu_torch.ngram import (
    DeviceNGramTable, NGramStorage, batch_ngram_assisted_generate,
    device_ngram_assisted_generate, device_ngram_assisted_generate_batch,
    ngram_assisted_speculative_generate,
)
from specdec_tpu_torch.ngram.native import NativeNGramStorage
from specdec_tpu_torch.sampling import processors as tp
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate
from specdec_tpu_torch.serve import NasdContinuousBatcher

torch.set_num_threads(2)

VOCAB = 64
JCFG = tiny_config(vocab_size=VOCAB, num_layers=2, hidden_size=64,
                   intermediate_size=128, num_heads=4, num_kv_heads=2,
                   head_dim=16)
CFG = ModelConfig(**{**{f.name: getattr(JCFG, f.name)
                        for f in dataclasses.fields(JCFG)},
                     "dtype": torch.float32})
GEN = 20
_rng = np.random.default_rng(11)
# ragged: three lengths, one below the n-gram order's context of 2 + 1
PROMPTS = [[int(t) for t in _rng.integers(1, VOCAB, size=n)]
           for n in (9, 3, 14)]
STORES = {"python": (NGramStorage, jst.NGramStorage),
          "native": (NativeNGramStorage, jnative.NativeNGramStorage)}
NASD = dict(gamma=4, filler_top_k=3, eos_tokens_id=())


@pytest.fixture(scope="module")
def models():
    """(JAX params, port params) of the same numpy arrays."""
    np_params = jax.tree.map(
        np.asarray, jm.init_params(JCFG, jax.random.key(0), scale=0.3))
    return (jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, "cpu"))


@pytest.fixture(scope="module")
def greedy_ar(models):
    """Greedy AR per prompt: JAX's, which the port's must equal."""
    jparams, params = models
    ref = [jax_autoregressive_generate(p, JCFG, jparams, max_gen_len=GEN,
                                       eos_tokens_id=()) for p in PROMPTS]
    got = [autoregressive_generate(p, CFG, params, max_gen_len=GEN,
                                   eos_tokens_id=(), device="cpu")
           for p in PROMPTS]
    assert got == ref
    return ref


@pytest.mark.parametrize("store", list(STORES))
def test_host_nasd_equals_ar_and_jax(models, greedy_ar, store):
    """B=1, twice on one store (the second call drafts from what the first
    learned): tokens == greedy AR == JAX's, acceptance == JAX's exactly."""
    jparams, params = models
    port_store, jax_store = (cls(n=3, vocab_size=VOCAB)
                             for cls in STORES[store])
    rates = []
    for call in range(2):
        out, rate = ngram_assisted_speculative_generate(
            PROMPTS[0], port_store, CFG, params, max_gen_len=GEN,
            device="cpu", **NASD)
        ref, ref_rate = jas.ngram_assisted_speculative_generate(
            PROMPTS[0], jax_store, JCFG, jparams, max_gen_len=GEN,
            key=jax.random.key(call), **NASD)
        assert out == ref == greedy_ar[0]
        assert rate == ref_rate
        rates.append(rate)
    assert rates[1] > 0.5


def test_batch_host_nasd_equals_ar_and_jax(models, greedy_ar):
    """Ragged B=3 on one shared store, twice: tokens == greedy AR == JAX's,
    per-sequence acceptance == JAX's exactly; an EOS stops only its row."""
    jparams, params = models
    store, jstore = NGramStorage(3, VOCAB), jst.NGramStorage(3, VOCAB)
    for call in range(2):
        outs, rates = batch_ngram_assisted_generate(
            PROMPTS, store, CFG, params, gen_len=GEN, device="cpu", **NASD)
        ref, ref_rates = jas.batch_ngram_assisted_generate(
            PROMPTS, jstore, JCFG, jparams, gen_len=GEN,
            key=jax.random.key(call), **NASD)
        assert outs == ref == greedy_ar
        assert rates == ref_rates
    assert min(rates) > 0.5
    eos = greedy_ar[0][5]
    outs, _ = batch_ngram_assisted_generate(
        PROMPTS, NGramStorage(3, VOCAB), CFG, params, gen_len=GEN,
        device="cpu", **dict(NASD, eos_tokens_id=eos))
    for out, ar in zip(outs, greedy_ar):
        assert out == (ar[:ar.index(eos) + 1] if eos in ar else ar)


def tables_equal(table: DeviceNGramTable, ref) -> bool:
    return all(np.array_equal(a.numpy(), np.asarray(b))
               for a, b in zip(table.ctx + table.tok, ref.ctx + ref.tok))


@pytest.mark.parametrize("batch", [1, 3], ids=["B1", "B3-ragged"])
def test_device_nasd_equals_ar_and_jax(models, greedy_ar, batch):
    """Tokens == greedy AR == JAX's. At B=1 the table after the call equals
    JAX's bit for bit (the window's grid of writes in JAX's order); a
    second call on the learned table accepts."""
    jparams, params = models
    prompts, ar = PROMPTS[:batch], greedy_ar[:batch]
    kw = dict(n=3, capacity=1 << 12, gen_len=GEN, **NASD)
    outs, rates, table = device_ngram_assisted_generate_batch(
        prompts, CFG, params, device="cpu", **kw)
    ref, _, jtable = jda.device_ngram_assisted_generate_batch(
        prompts, JCFG, jparams, key=jax.random.key(1), **kw)
    assert outs == ref == ar
    assert all(0.0 <= r <= 1.0 for r in rates)
    if batch == 1:
        assert tables_equal(table, jtable)
    kept = table.clone()
    outs, rates, _ = device_ngram_assisted_generate_batch(
        prompts, CFG, params, table=table, device="cpu", seed=1, **kw)
    assert outs == ar and min(rates) > 0.5
    # the table passed in is copied, not edited
    assert all(torch.equal(a, b) for a, b in zip(table.ctx + table.tok,
                                                 kept.ctx + kept.tok))


def test_device_nasd_single_and_eos(models, greedy_ar):
    """The single-sequence entry point and stop_if_unknown, and an EOS
    inside a window stopping only its row."""
    _, params = models
    out, rate, _ = device_ngram_assisted_generate(
        PROMPTS[2], CFG, params, n=3, max_gen_len=GEN, stop_if_unknown=True,
        device="cpu", **NASD)
    assert out == greedy_ar[2] and 0.0 <= rate <= 1.0
    eos = greedy_ar[0][5]
    outs, _, _ = device_ngram_assisted_generate_batch(
        PROMPTS, CFG, params, n=3, gen_len=GEN, device="cpu",
        **dict(NASD, eos_tokens_id=eos))
    for out, ar in zip(outs, greedy_ar):
        assert out == (ar[:ar.index(eos) + 1] if eos in ar else ar)


@pytest.mark.parametrize("path", ["host", "device"])
def test_sampled_nasd_distribution(models, path):
    """MultinomialProcessor(0.7): over N rows of one prompt, the prefill's
    token follows the target's distribution, and the first token the
    window emits follows the target's marginal sum_t0 p(t0) p(. | t0);
    TV < 0.06 each (tests/test_speculative.py's bound)."""
    _, params = models
    N, prompt = 6000, PROMPTS[0]
    proc = tp.MultinomialProcessor(temperature=0.7)
    kw = dict(gamma=3, filler_top_k=3, logits_processor=proc, gen_len=2,
              eos_tokens_id=(), device="cpu", seed=3)
    if path == "host":
        outs, _ = batch_ngram_assisted_generate(
            [prompt] * N, NGramStorage(3, VOCAB), CFG, params, **kw)
    else:
        outs, _, _ = device_ngram_assisted_generate_batch(
            [prompt] * N, CFG, params, n=3, **kw)
    toks = np.asarray(outs)
    p0 = proc(forward_full(CFG, params, torch.tensor([prompt]))[0, -1])
    # every continuation t0 in one batch: p(. | prompt, t0) for each
    grid = torch.tensor([prompt + [t] for t in range(VOCAB)])
    p1 = proc(forward_full(CFG, params, grid)[:, -1])
    marginal = (p0[:, None] * p1).sum(dim=0)
    for col, ref in ((0, p0), (1, marginal)):
        counts = np.bincount(toks[:, col], minlength=VOCAB) / N
        tv = 0.5 * np.abs(counts - ref.numpy()).sum()
        assert tv < 0.06, f"token {col}: TV {tv:.4f}"


@pytest.mark.parametrize("wps", [1, 2])
def test_nasd_serving_equals_ar_and_jax(models, greedy_ar, wps):
    """NasdContinuousBatcher, 2 slots for 3 requests, greedy: every request
    == greedy AR == the JAX batcher's output, at 1 and 2 windows per
    sync; a table injected into the batcher is copied."""
    jparams, params = models
    kw = dict(num_slots=2, gamma=3, n=3, capacity=256, max_prompt_len=32,
              max_new_tokens=GEN, eos_tokens_id=(), windows_per_sync=wps)
    _, _, table = device_ngram_assisted_generate_batch(
        PROMPTS, CFG, params, n=3, capacity=256, gen_len=4, device="cpu",
        **dict(NASD, gamma=3))
    kept = table.clone()
    b = NasdContinuousBatcher(CFG, params, table=table, device="cpu", **kw)
    ids = [b.submit(p) for p in PROMPTS]
    done = b.run()
    jb = JaxNasdBatcher(JCFG, jparams, **kw)
    jids = [jb.submit(p) for p in PROMPTS]
    jdone = jb.run()
    for rid, jrid, ar in zip(ids, jids, greedy_ar):
        assert done[rid].output_ids == jdone[jrid].output_ids == ar
        m = done[rid].metrics
        assert m.generated_tokens == GEN and 0.0 <= m.acceptance_rate <= 1.0
    assert b.table is not table
    assert all(torch.equal(a, c) for a, c in zip(table.ctx + table.tok,
                                                 kept.ctx + kept.tok))


class FakeTokenizer:
    """Characters to token ids (a - z -> 1 - 26, others 27); a chat
    template wraps the prompt in markers 28 and 29."""

    chat_template = "fake"

    def apply_chat_template(self, messages, add_generation_prompt,
                            tokenize):
        return "<" + messages[0]["content"] + ">"

    def encode(self, text):
        table = {"<": 28, ">": 29}
        return [table.get(c, ord(c) - 96 if c.isalpha() else 27)
                for c in text.lower()]


def contexts(models, method, ngram=None):
    """The JAX runner context and the port's, for one method."""
    jparams, params = models
    common = dict(tokenizer=FakeTokenizer(), max_batch_length=16, chat=True,
                  reset_in_between=False, spec=method != "target_ar",
                  target_gen=method == "target_ar", gamma=3, filler_top_k=3,
                  gen_len=12, end_tokens=(), pad_token_id=0)
    jctx = types.SimpleNamespace(
        **common, ngram=ngram[1] if ngram else None, target_cfg=JCFG,
        target_params=jparams, drafter_cfg=JCFG, drafter_params=jparams,
        processor=jp.GreedyProcessor(),
        request_key=lambda: jax.random.key(0))
    ctx = types.SimpleNamespace(
        **common, ngram=ngram[0] if ngram else None, target_cfg=CFG,
        target_params=params, drafter_cfg=CFG, drafter_params=params,
        processor=tp.GreedyProcessor(), device="cpu",
        request_generator=lambda: torch.Generator().manual_seed(0))
    return jctx, ctx


PROMPT_TEXTS = ["the cat sat on the mat", "abc abc abc", "hello"]


@pytest.mark.parametrize("method", ["host", "self-draft", "target_ar"])
def test_infer_batch_matches_jax(models, method):
    """tokenize_batch and infer_batch: per-request tokens and acceptance
    equal JAX's (a self-drafted greedy batch accepts every draft)."""
    ngram = ((NGramStorage(3, VOCAB), jst.NGramStorage(3, VOCAB))
             if method == "host" else None)
    jctx, ctx = contexts(models, "target_ar" if method == "target_ar"
                         else "speculative", ngram)
    ids = tie.tokenize_batch(ctx.tokenizer, PROMPT_TEXTS, 16)
    assert ids == jie.tokenize_batch(jctx.tokenizer, PROMPT_TEXTS, 16)
    assert ids[2] == [28, 8, 5, 12, 12, 15, 29]
    got = [m for m in tie.infer_batch(ctx, PROMPT_TEXTS) if m is not None]
    ref = [m for m in jie.infer_batch(jctx, PROMPT_TEXTS) if m is not None]
    assert len(got) == len(ref) == 1
    for r, j in zip(got[0].requests, ref[0].requests):
        assert (r.prompt_tokens, r.generated_tokens, r.acceptance_rate) == (
            j.prompt_tokens, j.generated_tokens, j.acceptance_rate)
    if method == "self-draft":
        assert all(r.acceptance_rate == 1.0 for r in got[0].requests)


def test_infer_batch_device_table_and_reset(models, monkeypatch):
    """The device-table method carries its table across batches, and
    reset_in_between gives a new empty table; without a table, an EAGLE
    drafter goes to the batched EAGLE engine (tests/test_torch_eagle_serve.py
    runs it)."""
    _, ctx = contexts(models, "speculative")
    ctx.ngram = device_ngram_assisted_generate_batch(
        [[1, 2, 3]], CFG, models[1], n=3, capacity=256, gen_len=2,
        device="cpu")[2]
    first = ctx.ngram
    spec, target = tie.infer_batch(ctx, PROMPT_TEXTS)
    assert target is None and ctx.ngram is not first
    assert [r.generated_tokens for r in spec.requests] == [12] * 3
    ctx.reset_in_between = True
    tie.infer_batch(ctx, PROMPT_TEXTS[:1])
    assert ctx.ngram.capacity == 256 and ctx.ngram.orders == (3, 2)
    ctx.ngram, ctx.eagle_drafter = None, True
    calls = []

    def eagle_engine(prompt_ids, *args, **kw):
        calls.append(len(prompt_ids))
        return [[1]] * len(prompt_ids), [0.0] * len(prompt_ids)
    monkeypatch.setattr(tie, "batch_eagle_generate", eagle_engine)
    spec, _ = tie.infer_batch(ctx, PROMPT_TEXTS)
    assert calls == [3]
    assert [r.generated_tokens for r in spec.requests] == [1] * 3


def build_results(met):
    """The same BenchmarkResults in either package."""
    res = met.BenchmarkResults(method="speculative", total_requests=3,
                               total_batches=2, start_time=10.0,
                               end_time=14.5)
    for b, (start, end) in enumerate(((10.0, 12.0), (12.0, 14.5))):
        bm = met.BatchMetrics(batch_size=2, batch_start_time=start,
                              batch_end_time=end)
        for i in range(2 - b):
            bm.requests.append(met.RequestMetrics(
                prompt_tokens=5 + i, generated_tokens=12 + b,
                total_tokens=17 + i + b, ttft=0.1 * (i + 1),
                total_latency=1.5 + i, acceptance_rate=0.5 * i + 0.25 * b,
                drafts_generated=8, drafts_accepted=4 * i))
        res.batches.append(bm)
    return res


def test_metrics_match_jax(capsys):
    """to_dict's schema and numbers, the percentiles and both console
    printers equal JAX's."""
    got, ref = build_results(tmet), build_results(jmet)
    assert got.to_dict() == ref.to_dict()
    assert [got.percentile_ttft(q) for q in (50, 99)] == [
        ref.percentile_ttft(q) for q in (50, 99)]
    target = build_results(tmet)
    target.method, target.end_time = "target_ar", 16.0
    jtarget = build_results(jmet)
    jtarget.method, jtarget.end_time = "target_ar", 16.0
    printed = []
    for met, res, tgt in ((tmet, got, target), (jmet, ref, jtarget)):
        met.print_benchmark_summary(res)
        met.print_comparison(res, tgt)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "Throughput Speedup" in printed[0]
