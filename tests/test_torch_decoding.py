"""The port's decode loops against the JAX package's, on the same params.

Greedy tokens are compared exactly. Sampled tokens cannot match JAX's RNG,
so the speculative accept/residual step is held to the target distribution
by a TV-distance test over many draws in one batched call, as
tests/test_speculative.py holds the JAX sampler."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.sampling import processors as jp
from specdec_tpu.sampling import utils as ju
from specdec_tpu.sampling.base_decoding import (
    autoregressive_generate as jax_autoregressive_generate,
)

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.quant.core import quantize_params
from specdec_tpu_torch.sampling import processors as tp
from specdec_tpu_torch.sampling import utils as tu
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate
from specdec_tpu_torch.sampling.speculative import (
    accept_step, commit_step, speculative_generate,
)

torch.set_num_threads(2)

VOCAB = 32
JCFG = tiny_config(vocab_size=VOCAB, num_layers=2, hidden_size=32,
                   intermediate_size=64, num_heads=4, num_kv_heads=2,
                   head_dim=8)
PROMPT = [3, 14, 15, 9, 2, 6]


def port_config(cfg) -> ModelConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ModelConfig(**dict(kw, dtype=torch.float32))


CFG = port_config(JCFG)


def gen_kw(seed=0):
    return dict(eos_tokens_id=(), device="cpu",
                generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def models():
    """(JAX target params, port target, port drafter): the drafter is the
    target plus noise, a correlated but distinct proposal."""
    target = jax.tree.map(np.asarray,
                          jm.init_params(JCFG, jax.random.key(0), scale=0.4))
    noise = jax.tree.map(np.asarray,
                         jm.init_params(JCFG, jax.random.key(1), scale=0.1))
    drafter = jax.tree.map(lambda a, b: a + b, target, noise)
    return (jax.tree.map(jnp.asarray, target),
            params_from_numpy(target, "cpu"),
            params_from_numpy(drafter, "cpu"))


def test_greedy_ar_matches_jax(models):
    jtarget, target, _ = models
    ref = jax_autoregressive_generate(PROMPT, JCFG, jtarget, max_gen_len=30,
                                      eos_tokens_id=(), key=jax.random.key(5))
    got = autoregressive_generate(PROMPT, CFG, target, max_gen_len=30,
                                  **gen_kw())
    assert got == ref


def test_greedy_self_draft_equals_ar(models):
    """drafter == target under greedy: every draft is accepted and the
    tokens are greedy AR's, across window sizes."""
    _, target, _ = models
    ar = autoregressive_generate(PROMPT, CFG, target, max_gen_len=30,
                                 **gen_kw())
    for gamma in (1, 4, 7):
        spec, rate = speculative_generate(PROMPT, CFG, target, CFG, target,
                                          gamma=gamma, max_gen_len=30,
                                          **gen_kw(6))
        assert spec == ar
        assert rate == 1.0


def test_greedy_self_draft_equals_ar_int4():
    """The same oracle on an INT4 model (quantize_params(int4, fuse=True),
    hidden 256 so absmax is block-major), through the plain kernel path."""
    jcfg = tiny_config(vocab_size=64, num_layers=2, hidden_size=256,
                       intermediate_size=512, num_heads=4, num_kv_heads=2,
                       head_dim=64)
    cfg = port_config(jcfg)
    dense = jax.tree.map(np.asarray,
                         jm.init_params(jcfg, jax.random.key(3), scale=0.3))
    target = quantize_params(params_from_numpy(dense, "cpu"), kind="int4",
                             fuse=True)
    prompt = [5, 9, 33, 2, 41, 7]
    ar = autoregressive_generate(prompt, cfg, target, max_gen_len=24,
                                 **gen_kw())
    spec, rate = speculative_generate(prompt, cfg, target, cfg, target,
                                      gamma=5, max_gen_len=24, **gen_kw())
    assert spec == ar
    assert rate == 1.0


def test_distinct_drafter_deterministic_and_in_vocab(models):
    _, target, drafter = models
    outs = [speculative_generate(PROMPT, CFG, drafter, CFG, target, gamma=4,
                                 max_gen_len=30, **gen_kw(6))
            for _ in range(2)]
    assert outs[0] == outs[1]
    out, rate = outs[0]
    assert len(out) == 30
    assert all(0 <= t < VOCAB for t in out)
    assert 0.0 <= rate <= 1.0


def test_sampled_generation_lengths(models):
    _, target, drafter = models
    proc = tp.MultinomialProcessor(temperature=1.0)
    ar = autoregressive_generate(PROMPT, CFG, target, max_gen_len=17,
                                 logits_processor=proc, **gen_kw(1))
    spec, rate = speculative_generate(PROMPT, CFG, drafter, CFG, target,
                                      gamma=3, max_gen_len=17,
                                      logits_processor=proc, **gen_kw(2))
    assert len(ar) == len(spec) == 17
    assert all(0 <= t < VOCAB for t in ar + spec)
    assert 0.0 < rate <= 1.0


def test_eos_truncation(models):
    """The 6th greedy token as EOS: AR and self-draft spec stop there with
    identical prefixes (EOS inside accepted drafts truncates)."""
    _, target, _ = models
    full = autoregressive_generate(PROMPT, CFG, target, max_gen_len=20,
                                   **gen_kw())
    eos = full[5]
    first_eos = full.index(eos)
    kw = dict(gen_kw(), eos_tokens_id=eos)
    ar = autoregressive_generate(PROMPT, CFG, target, max_gen_len=20, **kw)
    spec, _ = speculative_generate(PROMPT, CFG, target, CFG, target, gamma=3,
                                   max_gen_len=20, **kw)
    assert ar == full[:first_eos + 1]
    assert spec == ar


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_length_cap(models, gamma):
    _, target, drafter = models
    spec, _ = speculative_generate(PROMPT, CFG, drafter, CFG, target,
                                   gamma=gamma, max_gen_len=13, **gen_kw(11))
    assert len(spec) == 13


def test_max_position_cap(models):
    """total_len = min(max_position_embeddings, prompt + max_gen_len)."""
    _, target, _ = models
    cfg = CFG.replace(max_position_embeddings=len(PROMPT) + 9)
    ar = autoregressive_generate(PROMPT, cfg, target, max_gen_len=30,
                                 **gen_kw())
    spec, _ = speculative_generate(PROMPT, cfg, target, cfg, target, gamma=4,
                                   max_gen_len=30, **gen_kw())
    assert len(ar) == len(spec) == 9
    assert spec == ar


def test_first_target_false(models):
    _, target, _ = models
    ar = autoregressive_generate(PROMPT, CFG, target, max_gen_len=12,
                                 **gen_kw())
    spec, _ = speculative_generate(PROMPT, CFG, target, CFG, target, gamma=4,
                                   max_gen_len=12, first_target=False,
                                   **gen_kw())
    assert spec == ar


def test_single_token_prompt(models):
    _, target, _ = models
    ar = autoregressive_generate([7], CFG, target, max_gen_len=10, **gen_kw())
    spec, rate = speculative_generate([7], CFG, target, CFG, target, gamma=3,
                                      max_gen_len=10, **gen_kw())
    assert spec == ar
    assert rate == 1.0


def test_first_target_false_requires_two_token_prompt(models):
    _, target, _ = models
    with pytest.raises(ValueError, match="first_target=False"):
        speculative_generate([7], CFG, target, CFG, target, gamma=2,
                             max_gen_len=4, first_target=False, **gen_kw())
    out, _ = speculative_generate([7, 9], CFG, target, CFG, target, gamma=2,
                                  max_gen_len=4, first_target=False,
                                  **gen_kw())
    assert len(out) == 4


def _dists(rng, rows, V):
    logits = rng.standard_normal((rows, V)) * 1.5
    p = np.exp(logits)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("skip", [False, True])
def test_accept_step_output_distribution(skip):
    """The first committed token of a window must be distributed as the
    target's processed distribution p[0] (the Leviathan/Chen guarantee):
    drafts from q, acceptance on p/q, residual max(p-q, 0) on rejection.
    30,000 windows in one batched call; TV < 0.03 (sampling noise here is
    ~0.01). With skip_sample_adjustment the rejection draws from p instead,
    which is biased toward tokens q under-proposes: TV must then be
    clearly larger, so the test can tell the two apart."""
    rng = np.random.default_rng(0)
    B, gamma, V = 30000, 3, 8
    p = _dists(rng, gamma + 1, V)
    q = _dists(rng, gamma, V)
    drafts = np.stack([rng.choice(V, size=B, p=q[i] / q[i].sum())
                       for i in range(gamma)], axis=1)
    r = rng.random((B, gamma)).astype(np.float32)
    p_all = torch.from_numpy(np.broadcast_to(p, (B, gamma + 1, V)).copy())
    q_all = torch.from_numpy(np.broadcast_to(q, (B, gamma, V)).copy())
    n, next_tok = accept_step(p_all, q_all, torch.from_numpy(drafts),
                              torch.from_numpy(r),
                              tp.MultinomialProcessor(),
                              torch.Generator().manual_seed(1),
                              skip_sample_adjustment=skip)
    n, next_tok = n.numpy(), next_tok.numpy()
    assert n.shape == next_tok.shape == (B,)
    assert ((0 <= n) & (n <= gamma)).all()
    # acceptance of draft 0 happens with probability sum_x min(p, q)
    assert abs((n >= 1).mean() - np.minimum(p[0], q[0]).sum()) < 0.02
    first = np.where(n >= 1, drafts[:, 0], next_tok)
    tv = 0.5 * np.abs(np.bincount(first, minlength=V) / B - p[0]).sum()
    if skip:
        assert tv > 0.05, f"TV {tv:.4f}: skip should bias the output"
    else:
        assert tv < 0.03, f"TV {tv:.4f}: output dist != target dist"


def test_accept_step_bonus_token():
    """All drafts accepted (p == q) -> n == gamma and the next token is
    drawn from the target's extra position p[gamma]."""
    rng = np.random.default_rng(2)
    B, gamma, V = 20000, 2, 6
    p = _dists(rng, gamma + 1, V)
    drafts = np.stack([rng.choice(V, size=B, p=p[i] / p[i].sum())
                       for i in range(gamma)], axis=1)
    r = rng.random((B, gamma)).astype(np.float32)
    p_all = torch.from_numpy(np.broadcast_to(p, (B, gamma + 1, V)).copy())
    n, next_tok = accept_step(p_all, p_all[:, :gamma].clone(),
                              torch.from_numpy(drafts), torch.from_numpy(r),
                              tp.MultinomialProcessor(),
                              torch.Generator().manual_seed(3))
    assert (n.numpy() == gamma).all()
    counts = np.bincount(next_tok.numpy(), minlength=V) / B
    assert 0.5 * np.abs(counts - p[gamma]).sum() < 0.03


def test_commit_step_matches_reference_rule():
    """Batched commit against the rule written out per row: candidates
    drafts[:n] + next_tok, at most ``remaining`` of them, cut after the
    first EOS among the n+1 committed tokens."""
    rng = np.random.default_rng(5)
    B, gamma, eos = 400, 4, (3, 7)
    drafts = rng.integers(0, 10, size=(B, gamma))
    n = rng.integers(0, gamma + 1, size=B)
    next_tok = rng.integers(0, 10, size=B)
    remaining = rng.integers(1, gamma + 3, size=B)
    cand, advance, any_eos = commit_step(
        torch.from_numpy(drafts), torch.from_numpy(n),
        torch.from_numpy(next_tok), torch.from_numpy(remaining), eos)
    for b in range(B):
        committed = list(drafts[b, :n[b]]) + [next_tok[b]]
        assert cand[b].tolist() == committed + [0] * (gamma - n[b])
        kept = committed[:remaining[b]]
        cut = next((i for i, t in enumerate(kept) if t in eos), None)
        assert bool(any_eos[b]) == (cut is not None)
        assert int(advance[b]) == (len(kept) if cut is None else cut + 1)


@pytest.mark.parametrize("name", ["greedy", "multinomial", "topk", "nucleus",
                                  "topknucleus"])
def test_processors_match_jax(name):
    logits = (np.random.default_rng(4).standard_normal((3, 50)) * 3
              ).astype(np.float32)
    kw = dict(temperature=0.7, top_k=5, top_p=0.8)
    ref = np.asarray(jp.build_processor(name, **kw)(jnp.asarray(logits)))
    proc = tp.build_processor(name, **kw)
    got = proc(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    if name == "greedy":
        tied = torch.tensor([1.0, 3.0, 3.0, 2.0])
        assert int(proc.sample(tied)) == int(jnp.argmax(jnp.asarray(
            tied.numpy()))) == 1
        assert int(proc.sample_from_logits(tied)) == 1


def test_sampling_utils_match_jax():
    rng = np.random.default_rng(6)
    p, q = _dists(rng, 4, 9), _dists(rng, 4, 9)
    for fn in ("max_fn", "residual_mass"):
        args = (p - q,) if fn == "max_fn" else (p, q)
        np.testing.assert_allclose(
            getattr(tu, fn)(*map(torch.from_numpy, args)).numpy(),
            np.asarray(getattr(ju, fn)(*map(jnp.asarray, args))),
            rtol=1e-6, atol=1e-7)
    # no residual mass: zeros (XLA on the CPU flushes the 1e-38 guard to 0
    # and gives NaN there); either way the caller falls back to p
    assert (tu.max_fn(torch.zeros(9)) == 0).all()
    toks = rng.integers(0, 6, size=(3, 5)).astype(np.int32)
    for eos in ((), (2,), (1, 4)):
        np.testing.assert_array_equal(
            tu.eos_mask(torch.from_numpy(toks), eos).numpy(),
            np.asarray(ju.eos_mask(jnp.asarray(toks), eos)))
    for ids in ([5], list(range(64)), list(range(70))):
        got, n = tu.pad_to_bucket(ids, pad_id=0)
        ref, ref_n = ju.pad_to_bucket(ids, pad_id=0)
        assert n == ref_n and got.tolist() == np.asarray(ref).tolist()
    for eos in (None, 3, [1, 2]):
        assert tu.normalize_eos(eos) == ju.normalize_eos(eos)
