"""The port's batched engine and serving batchers against the JAX
package's, on the same params (the tiny model of
tests/test_paged_scheduler.py, bridged with ``params_from_numpy``).

Greedy outputs are compared token for token. Sampled outputs cannot match
JAX's RNG, so the batched window is held to the target distribution by a TV
test over many rows, as tests/test_torch_decoding.py does for one
sequence."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.engine import batch_engine as jbe
from specdec_tpu.engine import gamma_tuner as jgt
from specdec_tpu.sampling import processors as jp
from specdec_tpu.sampling.base_decoding import (
    autoregressive_generate as jax_autoregressive_generate,
)
from specdec_tpu.serve.paged_scheduler import (
    PagedContinuousBatcher as JaxPagedBatcher,
)
from specdec_tpu.serve.scheduler import ContinuousBatcher as JaxBatcher

import specdec_tpu_torch.serve as serve
from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_full
from specdec_tpu_torch.engine import batch_engine as tbe
from specdec_tpu_torch.engine import gamma_tuner as tgt
from specdec_tpu_torch.sampling import processors as tp
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate
from specdec_tpu_torch.serve.streaming import stream_generate

torch.set_num_threads(2)

VOCAB = 32
JCFG = tiny_config(vocab_size=VOCAB, num_layers=2, hidden_size=32,
                   intermediate_size=64, num_heads=4, num_kv_heads=2,
                   head_dim=8)
CFG = ModelConfig(**{**{f.name: getattr(JCFG, f.name)
                        for f in dataclasses.fields(JCFG)},
                     "dtype": torch.float32})
PROMPTS = [[3, 14, 15, 9, 2, 6], [1, 1, 2, 3, 5, 8, 13, 21], [27, 4],
           [9, 9, 9, 1, 2]]
GEN = 12
# the batchers' shared settings (test_paged_scheduler.py's)
BATCHER = dict(num_slots=2, gamma=3, max_prompt_len=32, max_new_tokens=GEN,
               eos_tokens_id=())
# exact greedy acceptance: a tempered softmax at this temperature is the
# one-hot argmax, so accept/reject and the residual follow the argmax and a
# distinct drafter still yields the target's greedy tokens
COLD = 1e-6


@pytest.fixture(scope="module")
def models():
    """(JAX target, JAX drafter, port target, port drafter): the drafter is
    the target plus noise, a correlated but distinct proposal."""
    target = jax.tree.map(np.asarray,
                          jm.init_params(JCFG, jax.random.key(0), scale=0.4))
    noise = jax.tree.map(np.asarray,
                         jm.init_params(JCFG, jax.random.key(1), scale=0.1))
    drafter = jax.tree.map(lambda a, b: a + b, target, noise)
    return (jax.tree.map(jnp.asarray, target),
            jax.tree.map(jnp.asarray, drafter),
            params_from_numpy(target, "cpu"), params_from_numpy(drafter, "cpu"))


@pytest.fixture(scope="module")
def greedy_ar(models):
    """JAX greedy AR per prompt (the batchers' oracle), and the port's."""
    jtarget, _, target, _ = models
    ref = [jax_autoregressive_generate(p, JCFG, jtarget, max_gen_len=GEN,
                                       eos_tokens_id=(),
                                       key=jax.random.key(7))
           for p in PROMPTS]
    got = [autoregressive_generate(p, CFG, target, max_gen_len=GEN,
                                   eos_tokens_id=(), device="cpu")
           for p in PROMPTS]
    assert got == ref
    return ref


@pytest.mark.parametrize("drafter", ["self", "distinct"])
def test_batch_speculative_matches_jax(models, greedy_ar, drafter):
    jtarget, jdrafter, target, pdrafter = models
    if drafter == "self":
        jd, d, jproc, proc = jtarget, target, None, None
    else:
        jd, d = jdrafter, pdrafter
        jproc, proc = jp.GreedyProcessor(COLD), tp.GreedyProcessor(COLD)
    ref, ref_rates = jbe.batch_speculative_generate(
        PROMPTS, JCFG, jd, JCFG, jtarget, gamma=3, gen_len=GEN,
        logits_processor=jproc, eos_tokens_id=(), key=jax.random.key(6))
    got, rates = tbe.batch_speculative_generate(
        PROMPTS, CFG, d, CFG, target, gamma=3, gen_len=GEN,
        logits_processor=proc, eos_tokens_id=(), device="cpu")
    assert got == ref == greedy_ar
    np.testing.assert_allclose(rates, ref_rates, rtol=1e-6)
    if drafter == "self":
        assert rates == [1.0] * len(PROMPTS)
    else:
        assert min(rates) < 1.0


def test_batch_eos_and_ar_match_jax(models, greedy_ar):
    """Per-sequence EOS: the 4th greedy token of prompt 0 as EOS stops each
    sequence at its own first EOS, in batched AR and spec alike."""
    jtarget, _, target, _ = models
    eos = greedy_ar[0][3]
    ref_ar = jbe.batch_autoregressive_generate(
        PROMPTS, JCFG, jtarget, gen_len=GEN, eos_tokens_id=eos,
        key=jax.random.key(3))
    got_ar = tbe.batch_autoregressive_generate(
        PROMPTS, CFG, target, gen_len=GEN, eos_tokens_id=eos, device="cpu")
    got_spec, _ = tbe.batch_speculative_generate(
        PROMPTS, CFG, target, CFG, target, gamma=4, gen_len=GEN,
        eos_tokens_id=eos, device="cpu")
    assert got_ar == ref_ar == got_spec
    for out, full in zip(got_ar, greedy_ar):
        cut = full.index(eos) + 1 if eos in full else len(full)
        assert out == full[:cut]


def test_per_slot_processor_matches_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((5, 3, 50)) * 3).astype(np.float32)
    samp = np.asarray([[0.7, 5, 0.8], [1.0, 0, 1.0], [1e-6, 0, 1.0],
                       [1.3, 0, 0.6], [0.9, 12, 1.0]], np.float32)
    ref = np.asarray(jp.PerSlotProcessor().batched(jnp.asarray(logits),
                                                   jnp.asarray(samp)))
    proc = tp.PerSlotProcessor()
    got = proc.batched(torch.from_numpy(logits), torch.from_numpy(samp))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)
    draws = proc.sample_batched(got, torch.Generator().manual_seed(0),
                                torch.from_numpy(samp))
    assert draws.shape == (5, 3)
    assert (draws[2] == got[2].argmax(-1)).all()     # the greedy row
    with pytest.raises(TypeError):
        proc(torch.from_numpy(logits))
    np.testing.assert_array_equal(
        tp.PerSlotProcessor.row(0.5, 3, 0.9).numpy(),
        np.asarray(jp.PerSlotProcessor.row(0.5, 3, 0.9)))


def test_batched_window_output_distribution(models):
    """Sampled batched speculation keeps the target's distribution: 20,000
    rows with one prompt, per-row sampling params (PerSlotProcessor at
    temperature 1), a distinct drafter, no first target token. The first
    committed token of the first window must be distributed as the target's
    softmax at the prompt's last position: TV < 0.04 (sampling noise here
    is ~0.015). Half the rows' draws come from the residual, so a wrong
    residual or acceptance rule moves it."""
    _, _, target, drafter = models
    B, gamma = 20000, 3
    prompt = torch.tensor([3, 14, 15, 9])
    prompts = prompt[None, :].expand(B, -1).contiguous()
    lens = torch.full((B,), 4, dtype=torch.int32)
    samp = tp.PerSlotProcessor.row(1.0)[None, :].expand(B, -1).contiguous()
    gen = torch.Generator().manual_seed(11)
    proc = tp.PerSlotProcessor()
    state = tbe.batch_prefill(CFG, drafter, CFG, target, prompts, lens, 4,
                              gamma, proc, False, True, (), gen, samp)
    state = tbe.batch_spec_window(CFG, drafter, CFG, target, state, gamma,
                                  proc, (), False, gen)
    first = state.buf[:, 4].numpy()
    accepted = state.accepted.numpy()
    assert (state.pos.numpy() >= 5).all()
    assert 0.2 < (accepted == 0).mean() < 0.9     # the residual is exercised
    p = torch.softmax(forward_full(CFG, target, prompt[None])[0, -1],
                      -1).numpy()
    tv = 0.5 * np.abs(np.bincount(first, minlength=VOCAB) / B - p).sum()
    assert tv < 0.04, f"TV {tv:.4f}: output dist != target dist"


@pytest.fixture(scope="module")
def jax_batcher_outputs(models):
    """Outputs of the JAX package's slotted batcher and paged batcher in
    both layouts, self-draft greedy."""
    jtarget = models[0]
    out = {}
    for name, make in (
            ("slotted", lambda: JaxBatcher(JCFG, jtarget, JCFG, jtarget,
                                           **BATCHER)),
            ("hybrid", lambda: JaxPagedBatcher(JCFG, jtarget, JCFG, jtarget,
                                               page_size=8, **BATCHER)),
            ("both-paged", lambda: JaxPagedBatcher(
                JCFG, jtarget, JCFG, jtarget, page_size=8,
                drafter_paged=True, **BATCHER))):
        b = make()
        ids = [b.submit(p) for p in PROMPTS]
        done = b.run()
        out[name] = [(done[i].output_ids, done[i].metrics.acceptance_rate)
                     for i in ids]
    return out


def run_batcher(batcher, prompts=PROMPTS):
    ids = [batcher.submit(p) for p in prompts]
    done = batcher.run()
    assert sorted(done) == sorted(ids)
    return [done[i].output_ids for i in ids], [
        done[i].metrics.acceptance_rate for i in ids]


@pytest.mark.parametrize("layout", ["slotted", "hybrid", "both-paged"])
def test_batchers_match_jax_and_ar(models, greedy_ar, jax_batcher_outputs,
                                   layout):
    target = models[2]
    if layout == "slotted":
        b = serve.ContinuousBatcher(CFG, target, CFG, target, device="cpu",
                                    **BATCHER)
    else:
        b = serve.PagedContinuousBatcher(
            CFG, target, CFG, target, page_size=8, device="cpu",
            drafter_paged=layout == "both-paged", **BATCHER)
    outs, rates = run_batcher(b)
    assert [(o, r) for o, r in zip(outs, rates)] == jax_batcher_outputs[layout]
    assert outs == greedy_ar
    assert rates == [1.0] * len(PROMPTS)
    if layout != "slotted":   # every page back in the free list
        assert len(b._alloc_t.free) == b.num_pages - 1


def test_default_batcher_needs_cuda_unless_told_cpu(models):
    assert serve.DefaultBatcher is serve.PagedContinuousBatcher
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.DefaultBatcher(CFG, models[2], CFG, models[2], **BATCHER)


@pytest.mark.parametrize("kw", [dict(windows_per_sync=4),
                                dict(prefill_chunk=8),
                                dict(drafter_paged=True, prefill_chunk=8),
                                dict(auto_gamma=True, auto_gamma_min_drafts=8,
                                     windows_per_sync=2)],
                         ids=["windows4", "chunked", "chunked-both-paged",
                              "auto-gamma"])
def test_paged_batcher_options_keep_outputs(models, kw):
    """Multi-window dispatch (page provisioning over the whole horizon),
    chunked prefill (partial admissions through the paged kernel's plain
    version) and gamma retuning give the default's greedy outputs, on
    prompts long enough to cross pages and chunks."""
    target = models[2]
    prompts = [list(np.random.default_rng(i).integers(1, VOCAB, size=n))
               for i, n in enumerate((20, 9, 27, 3))]
    args = (CFG, target, CFG, target)
    ref, _ = run_batcher(serve.PagedContinuousBatcher(
        *args, page_size=8, device="cpu", **BATCHER), prompts)
    got, rates = run_batcher(serve.PagedContinuousBatcher(
        *args, page_size=8, device="cpu", **dict(BATCHER, **kw)), prompts)
    assert got == ref
    assert rates == [1.0] * len(prompts)


def test_preemption_and_page_recycling(models):
    """A pool too small for four slots at full length (the sizing of
    tests/test_paged_scheduler.py) preempts (requeue and restart from the
    prompt) instead of failing; outputs stay greedy AR's and every page
    comes home."""
    target = models[2]
    prompts = [[3, 14, 15, 9, 2, 6], [1, 1, 2, 3, 5, 8], [27, 4, 11, 30],
               [9, 9, 9, 1, 2]]
    b = serve.PagedContinuousBatcher(
        CFG, target, CFG, target, device="cpu", page_size=8, pool_tokens=56,
        **dict(BATCHER, num_slots=4, max_prompt_len=16))
    outs, _ = run_batcher(b, prompts)
    assert b.preemptions > 0
    assert outs == [autoregressive_generate(p, CFG, target, max_gen_len=GEN,
                                            eos_tokens_id=(), device="cpu")
                    for p in prompts]
    assert len(b._alloc_t.free) == b.num_pages - 1


@pytest.mark.parametrize("drafter_paged", [False, True],
                         ids=["hybrid", "both-paged"])
def test_prefix_caching_hits_keep_outputs(models, drafter_paged):
    """Prompts sharing a 16-token prefix (two pages) reuse its pages once
    the first prompt's prefill has registered them (the second prompt
    admits while the first is still prefilling in chunks, so it misses);
    outputs equal the uncached batcher's and pages come home (cached blocks
    included)."""
    target = models[2]
    rng = np.random.default_rng(9)
    shared = list(rng.integers(1, VOCAB, size=16))
    prompts = [shared + list(rng.integers(1, VOCAB, size=n))
               for n in (5, 11, 2, 8)]
    args = (CFG, target, CFG, target)
    kw = dict(BATCHER, page_size=8, device="cpu", drafter_paged=drafter_paged)
    ref, _ = run_batcher(serve.PagedContinuousBatcher(*args, **kw), prompts)
    b = serve.PagedContinuousBatcher(*args, prefix_caching=True,
                                     prefill_chunk=16, **kw)
    got, _ = run_batcher(b, prompts)
    assert got == ref
    assert b.prefix_cache.hit_tokens == 2 * 16
    cached = len(b.prefix_cache)
    assert len(b._alloc_t.free) + cached == b.num_pages - 1


def test_stream_generate_concatenates_to_output(models, greedy_ar):
    target = models[2]
    b = serve.PagedContinuousBatcher(CFG, target, CFG, target, page_size=8,
                                     device="cpu", **BATCHER)
    chunks = list(stream_generate(b, PROMPTS[1]))
    assert len(chunks) > 1
    assert sum(chunks, []) == greedy_ar[1]


def test_gamma_tuner_matches_jax():
    for a in (0.0, 0.3, 0.7, 0.95):
        for g in (1, 4, 12):
            assert tgt.expected_tokens_per_window(a, g) == \
                jgt.expected_tokens_per_window(a, g)
            assert tgt.expected_speedup(a, g, 0.25, 0.1) == \
                jgt.expected_speedup(a, g, 0.25, 0.1)
            assert tgt.conditional_from_reference_rate(a, g) == \
                jgt.conditional_from_reference_rate(a, g)
        assert tgt.best_gamma(a, 0.25, 0.089) == jgt.best_gamma(a, 0.25, 0.089)
