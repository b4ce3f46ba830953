"""The port's training path against the JAX package's: the Markov stream
(``engine/pretrain.py``), the losses and gradients of pretraining,
distillation and EAGLE head training, their acceptance proxies, and the
optimizer updates of all three trainers; the gradient through the weight
kernels' wrappers and the attention wrappers' refusal under grad.

Params are made by the JAX package and carried over with
``bridge.params_from_numpy``; tokens are made with numpy. Losses and
gradients agree at float32 tolerance (rtol 1e-4): both sides run in f32
and differ in summation order. Parameters after optimizer updates agree at
rtol 1e-5, atol 1e-6: that pins optax's semantics (the schedule read before
each update, adamw's 1e-4 decay, the clip). The stream's draws come from
torch, so the port's batches match JAX's in distribution only; the tables
and states are JAX's bit for bit."""
import dataclasses
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import eagle as je
from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.engine import distill as jd
from specdec_tpu.engine import eagle_train as jet
from specdec_tpu.engine import pretrain as jp
from specdec_tpu.quant import core as jq

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.engine import distill as td
from specdec_tpu_torch.engine import eagle_train as tet
from specdec_tpu_torch.engine import optim
from specdec_tpu_torch.engine import pretrain as tp
from specdec_tpu_torch.ops import decode_attention as tda
from specdec_tpu_torch.ops import paged_attention as tpa
from specdec_tpu_torch.quant import core as tq

torch.set_num_threads(2)

VOCAB = 32
JCFG = tiny_config(vocab_size=VOCAB, num_layers=2, hidden_size=32,
                   intermediate_size=64, num_heads=4, num_kv_heads=2,
                   head_dim=8)
UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)


def port_config(cfg) -> ModelConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ModelConfig(**dict(kw, dtype=torch.float32))


CFG = port_config(JCFG)


def both(params):
    """(JAX params, the port's) from JAX numpy params."""
    params = jax.tree.map(np.asarray, params)
    return jax.tree.map(jnp.asarray, params), params_from_numpy(params, "cpu")


def f32_close(got, ref, err_msg=""):
    """Both sides in f32, summed in another order: rtol 1e-4, and an
    absolute error of 1e-5 of the array's largest magnitude (a feature of
    magnitude 25 carries ~2e-5 of summation error into its small
    neighbours)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max(),
                               err_msg=err_msg)


def assert_tree_close(got, ref, close=f32_close, **tol):
    """A port tree (tensors) against a JAX tree, leaf by leaf, same keys:
    ``close`` or, with ``tol``, assert_allclose at that tolerance."""
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            assert_tree_close(got[k], ref[k], close, **tol)
        elif tol:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(ref[k]), err_msg=k, **tol)
        else:
            close(got[k].detach().numpy(), ref[k], err_msg=k)


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target, JAX 1-layer drafter, port drafter, JAX
    head, port head): the drafter a separate random model."""
    jt, tt = both(jm.init_params(JCFG, jax.random.key(0), scale=0.3))
    jdr, tdr = both(jm.init_params(JCFG.replace(num_layers=1),
                                   jax.random.key(3), scale=0.3))
    jh, th = both(je.init_eagle_params(JCFG.replace(num_layers=1),
                                       jax.random.key(1)))
    return jt, tt, jdr, tdr, jh, th


def tokens(B, L, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, (B, L)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the Markov stream
# ---------------------------------------------------------------------------

SPECS = {
    "test": dict(vocab_size=128, num_states=64, branching=4, zipf_s=1.2,
                 order=1, seed=3),
    # the loader's llama-1b stream: b * t1 overflows int32 at V = 32000
    "llama-1b": dict(vocab_size=32000, num_states=8192, branching=8,
                     zipf_s=1.2, order=1,
                     seed=zlib.crc32(b"llama-1b") % 2 ** 31),
    "order2": dict(vocab_size=32000, num_states=4096, branching=8,
                   zipf_s=1.1, order=2, seed=5),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_markov_spec_matches_jax(name):
    """Tables, hash coefficients and entropy bit for bit; states of random
    int32 token pairs (every value, overflowing products included) equal
    JAX's from numpy and from tensors."""
    ours, theirs = tp.MarkovSpec(**SPECS[name]), jp.MarkovSpec(**SPECS[name])
    succ, logp = ours.tables()
    jsucc, jlogp = theirs.tables()
    assert succ.dtype == torch.int32 and logp.dtype == torch.float32
    np.testing.assert_array_equal(succ.numpy(), np.asarray(jsucc))
    assert logp.numpy().tobytes() == np.asarray(jlogp).tobytes()
    assert ours.hash_coeffs() == theirs.hash_coeffs()
    assert ours.entropy_nats == theirs.entropy_nats
    t = np.random.default_rng(1).integers(0, ours.vocab_size, (2, 4096),
                                          dtype=np.int32)
    t[1, :3] = [0, 1, ours.vocab_size - 1]
    ref = np.asarray(theirs.state(jnp.asarray(t[0]), jnp.asarray(t[1])))
    assert ref.min() >= 0 and ref.max() < ours.num_states
    np.testing.assert_array_equal(
        ours.state(torch.from_numpy(t[0]), torch.from_numpy(t[1])).numpy(),
        ref)
    np.testing.assert_array_equal(ours.state(t[0], t[1]), ref)


def test_markov_sampler_stream():
    """The port's sampler: [B, L] tokens in [1, V) whose every transition is
    legal, successor ranks within TV 0.05 of the Zipf weights, and the
    oracle NLL of the stream equal to its entropy (rtol 0.08, as
    tests/test_pretrain.py asks of JAX's)."""
    spec = tp.MarkovSpec(**SPECS["test"])
    toks = tp.markov_sampler(spec, 64, 64, "cpu")(
        torch.Generator().manual_seed(1)).numpy()
    assert toks.shape == (64, 64) and toks.min() >= 1
    assert toks.max() < spec.vocab_size
    succ, logp = (t.numpy() for t in spec.tables())
    p = np.exp(logp.astype(np.float64))
    h = spec.state(toks[:, :-2], toks[:, 1:-1])
    cand = succ[h]                                    # [B, L-2, K]
    match = cand == toks[:, 2:, None]
    assert match.any(-1).all()
    # the first slot holding the token: its rank, up to repeated successors
    first = match.argmax(-1)
    seen = np.bincount(first.ravel(), minlength=spec.branching) / first.size
    # rank r draws slot owner[r], the first slot of the same token
    owner = (cand[..., :, None] == cand[..., None, :]).argmax(-2)
    expect = np.array([((owner == i) * p).sum(-1).mean()
                       for i in range(spec.branching)])
    assert 0.5 * np.abs(seen - expect).sum() < 0.05, (seen, expect)
    oracle = -np.log((p * match).sum(-1)).mean()
    np.testing.assert_allclose(oracle, spec.entropy_nats, rtol=0.08)


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

def test_lm_nll_and_grad_match_jax(models):
    jt, tt = models[:2]
    toks = tokens(3, 12, 5)
    jnll, jgrads = jp._lm_grad(JCFG, jt, jnp.asarray(toks))
    nll, grads = tp._lm_grad(CFG, optim.trainable(tt),
                             torch.from_numpy(toks))
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-5)
    assert_tree_close(grads, jgrads)
    assert float(tp.lm_nll(CFG, tt, torch.from_numpy(toks))) == float(nll)


def test_kl_loss_and_grad_match_jax(models):
    jt, tt, jdr, tdr = models[:4]
    toks = tokens(3, 12, 6)
    jp_t = jd.teacher_probs(JCFG, jt, jnp.asarray(toks))
    p_t = td.teacher_probs(CFG, tt, torch.from_numpy(toks))
    f32_close(p_t.numpy(), jp_t)
    d_jcfg = JCFG.replace(num_layers=1)
    jloss, jgrads = jd._kl_loss_and_grad(d_jcfg, jdr, jnp.asarray(toks),
                                         jp_t)
    loss, grads = td._kl_loss_and_grad(port_config(d_jcfg),
                                       optim.trainable(tdr),
                                       torch.from_numpy(toks), p_t)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_tree_close(grads, jgrads)


@pytest.mark.parametrize("rollout", [1, 3])
def test_eagle_loss_and_grad_match_jax(models, rollout):
    """The teacher's features and probabilities, then loss, (reg, cls) and
    the head's gradients, teacher-forced and with HASS rollout passes."""
    jt, tt, _, _, jh, th = models
    toks = tokens(3, 14, 7)
    jf, jprobs = jet.teacher_feats_probs(JCFG, jt, jnp.asarray(toks))
    f, probs = tet.teacher_feats_probs(CFG, tt, torch.from_numpy(toks))
    f32_close(f.numpy(), jf)
    f32_close(probs.numpy(), jprobs)
    e_jcfg = JCFG.replace(num_layers=1)
    jloss, (jreg, jcls), jgrads = jet._eagle_loss_and_grad(
        e_jcfg, jh, jt, jnp.asarray(toks), jf, jprobs, rollout_steps=rollout)
    loss, (reg, cls), grads = tet._eagle_loss_and_grad(
        port_config(e_jcfg), optim.trainable(th), tt,
        torch.from_numpy(toks), f, probs, rollout_steps=rollout)
    for a, b in ((loss, jloss), (reg, jreg), (cls, jcls)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    assert_tree_close(grads, jgrads)


def bf16_close(got, ref):
    """A gradient through an INT4 lm_head: the port's forward rounds x and
    the product to bf16 as the kernel does (the JAX CPU route dequantizes
    in f32), so the two differ at bf16 resolution, not in form."""
    assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2 ** -5 * np.abs(ref).max())


def test_eagle_grad_on_int4_target_matches_jax():
    """An INT4 target (K = 64): the teacher's features through the weight
    wrappers agree with JAX's at bf16 tolerance. Given the same teacher
    outputs, the head's loss and gradients (its logits through the
    target's INT4 ``lm_head``, the gradient through the autograd Function
    of ``ops/quant_matmul.py``, dy @ dequantize(w)ᵀ) agree with JAX's XLA
    route on the CPU (autodiff of its dequantize-then-matmul) at bf16
    tolerance: the port's forward rounds x and the product to bf16 as the
    kernel does, JAX's stays in f32."""
    jcfg = tiny_config(vocab_size=64, num_layers=2, hidden_size=64,
                       intermediate_size=128, num_heads=4, num_kv_heads=2,
                       head_dim=16)
    target = jq.quantize_params(jm.init_params(jcfg, jax.random.key(2),
                                               scale=0.3), kind="int4")
    jt, tt = both(target)
    jh, th = both(je.init_eagle_params(jcfg.replace(num_layers=1),
                                       jax.random.key(4)))
    cfg = port_config(jcfg)
    toks = np.random.default_rng(8).integers(1, 64, (2, 12)).astype(np.int32)
    jf, jprobs = jet.teacher_feats_probs(jcfg, jt, jnp.asarray(toks))
    f, _ = tet.teacher_feats_probs(cfg, tt, torch.from_numpy(toks))
    bf16_close(f.numpy(), np.asarray(jf))
    f, probs = (torch.from_numpy(np.array(a)) for a in (jf, jprobs))
    for rollout in (1, 3):
        jloss, _, jgrads = jet._eagle_loss_and_grad(
            jcfg.replace(num_layers=1), jh, jt, jnp.asarray(toks), jf,
            jprobs, rollout_steps=rollout)
        loss, _, grads = tet._eagle_loss_and_grad(
            cfg.replace(num_layers=1), optim.trainable(th), tt,
            torch.from_numpy(toks), f, probs, rollout_steps=rollout)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
        assert_tree_close(grads, jgrads, close=lambda a, b, err_msg:
                          bf16_close(a, np.asarray(b)))


def test_acceptance_proxies_match_jax(models):
    jt, tt, jdr, tdr, jh, th = models
    toks = tokens(3, 14, 9)
    d_jcfg = JCFG.replace(num_layers=1)
    got = td.acceptance_proxy(CFG, tt, port_config(d_jcfg), tdr,
                              torch.from_numpy(toks))
    ref = jd.acceptance_proxy(JCFG, jt, d_jcfg, jdr, jnp.asarray(toks))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    assert float(got[1]) == float(ref[1])
    got = tet.eagle_acceptance_proxy(CFG, port_config(d_jcfg), th, tt,
                                     torch.from_numpy(toks))
    ref = jet.eagle_acceptance_proxy(JCFG, d_jcfg, jh, jt, jnp.asarray(toks))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    assert float(got[1]) == float(ref[1])


# ---------------------------------------------------------------------------
# optimizer updates: the port's trainers against optax
# ---------------------------------------------------------------------------

def cycling(batches, to):
    """A sampler that ignores its key or generator and returns the batches
    in turn (both trainers call it in the same order)."""
    state = {"i": 0}

    def sampler(_):
        b = batches[state["i"] % len(batches)]
        state["i"] += 1
        return to(b)
    return sampler


# each trainer's gradient function, in both packages
GRAD_FNS = {"train_lm": "_lm_grad", "distill": "_kl_loss_and_grad",
            "eagle": "_eagle_loss_and_grad"}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("trainer", ["train_lm", "distill", "eagle"])
def test_updates_match_optax(models, trainer, steps, monkeypatch):
    """Parameters after 1 and 3 updates equal optax's: train_lm (clip 1.0,
    adamw with the warmup read before each update, so the first update has
    rate 0; warmup 2 so the third runs at the full rate), distill_drafter
    (adam at a constant rate) and train_eagle (adam, cosine decay, rollout
    2), each trainer against the JAX package's on the same batches. The
    port trains first and records its gradients; the JAX trainer's
    gradient function then checks its own first one against the port's
    (f32 tolerance; later ones start from params a rounding apart) and
    hands optax the port's, so that the comparison of the
    updates holds the optimizers alone to rtol 1e-5 (Adam's step g / (|g|
    + 1e-8) turns the f32 summation error of a gradient near 1e-8 into a
    large share of the step). The caller's params stay as they were and
    the result requires no grad."""
    jt, tt, jdr, tdr, jh, th = models
    batches = [tokens(2, 10, 20 + i) for i in range(4)]
    module = {"train_lm": (tp, jp), "distill": (td, jd),
              "eagle": (tet, jet)}[trainer]
    name = GRAD_FNS[trainer]
    recorded = []

    def port_grad(*a, _fn=getattr(module[0], name), **k):
        out = _fn(*a, **k)
        recorded.append(optim.tree_map(lambda t: t.numpy().copy(), out[-1]))
        return out

    def jax_grad(*a, _fn=getattr(module[1], name), **k):
        out = _fn(*a, **k)
        mine = recorded[jax_grad.calls]
        if jax_grad.calls == 0:
            assert_tree_close(optim.tree_map(torch.from_numpy, mine),
                              out[-1])
        jax_grad.calls += 1
        return out[:-1] + (jax.tree.map(jnp.asarray, mine),)
    jax_grad.calls = 0
    monkeypatch.setattr(module[0], name, port_grad)
    monkeypatch.setattr(module[1], name, jax_grad)

    jbatch = cycling(batches, jnp.asarray)
    tbatch = cycling(batches, torch.from_numpy)
    before = {k: v.clone() for k, v in tt["layers"].items()}
    d_jcfg = JCFG.replace(num_layers=1)
    if trainer == "train_lm":
        got, _ = tp.train_lm(CFG, tt, tbatch, steps=steps,
                             learning_rate=1e-2, warmup=2, device="cpu")
        ref, _ = jp.train_lm(JCFG, jt, jbatch, steps=steps,
                             learning_rate=1e-2, warmup=2)
    elif trainer == "distill":
        got, _ = td.distill_drafter(CFG, tt, port_config(d_jcfg), tdr,
                                    steps=steps, learning_rate=1e-2,
                                    batch_sampler=tbatch, device="cpu")
        ref, _ = jd.distill_drafter(JCFG, jt, d_jcfg, jdr, steps=steps,
                                    learning_rate=1e-2, batch_sampler=jbatch)
    else:
        got, _ = tet.train_eagle(CFG, tt, port_config(d_jcfg), th,
                                 steps=steps, learning_rate=1e-2,
                                 rollout_steps=2, batch_sampler=tbatch,
                                 device="cpu")
        ref, _ = jet.train_eagle(JCFG, jt, d_jcfg, jh, steps=steps,
                                 learning_rate=1e-2, rollout_steps=2,
                                 batch_sampler=jbatch)
    assert len(recorded) == jax_grad.calls == steps
    assert_tree_close(got, ref, **UPDATE_TOL)
    assert not any(t.requires_grad for t in optim.leaves(got))
    assert all(torch.equal(before[k], v) for k, v in tt["layers"].items())


def test_schedules_match_optax():
    import optax

    warm = optax.linear_schedule(0.0, 1e-3, 100)
    cos = optax.cosine_decay_schedule(1e-3, 50, alpha=0.1)
    for i in (0, 1, 50, 99, 100, 101, 400):
        # optax evaluates in f32: (0 - lr) * (1 - i / 100) + lr cancels to
        # a relative error of a few 1e-6
        ref = float(jnp.where(i < 100, warm(i), 1e-3))
        assert optim.linear_warmup(1e-3, 100)(i) == pytest.approx(ref,
                                                                  rel=1e-5)
        assert optim.cosine_decay(1e-3, 50, 0.1)(i) == pytest.approx(
            float(cos(i)), rel=1e-5)


def test_clip_by_global_norm_matches_optax():
    import optax

    rng = np.random.default_rng(0)
    for scale in (0.01, 10.0):
        g = [rng.standard_normal((4, 5)).astype(np.float32) * scale,
             rng.standard_normal(7).astype(np.float32) * scale]
        ref, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(a) for a in g], optax.EmptyState())
        got = optim.clip_by_global_norm([torch.from_numpy(a) for a in g], 1.0)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ---------------------------------------------------------------------------
# the on-policy sampler
# ---------------------------------------------------------------------------

def test_on_policy_sampler_draws_from_the_target(models):
    """[B, L] tokens in [0, V); a token's draws follow the target's softmax
    over its prefix (TV 0.05 over 4000 rows, the second token of each)."""
    tt = models[1]
    toks = td.on_policy_sampler(CFG, tt, batch_size=4000, seq_len=2,
                                device="cpu")(
        torch.Generator().manual_seed(3))
    assert toks.shape == (4000, 2) and toks.min() >= 0
    assert toks.max() < VOCAB
    p = torch.softmax(tm.forward_full(CFG, tt, toks[:, :1])[:, 0], -1)
    expect = p.mean(0).numpy()
    seen = np.bincount(toks[:, 1].numpy(), minlength=VOCAB) / len(toks)
    assert 0.5 * np.abs(seen - expect).sum() < 0.05
    again = td.on_policy_sampler(CFG, tt, batch_size=4000, seq_len=2,
                                 device="cpu")(
        torch.Generator().manual_seed(3))
    assert torch.equal(toks, again)


# ---------------------------------------------------------------------------
# the gradient through the weight wrappers; attention refuses it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "int4", "nf4", "fp4"])
def test_weight_wrapper_gradient(kind):
    """Under autograd a weight wrapper gives x the plain product dy @
    dequantize(w)ᵀ (2D and a layer of a stack), in x's dtype, and its
    forward is the no-grad call's bit for bit."""
    g = torch.Generator().manual_seed(0)
    w = getattr(tq, f"quantize_{kind}")(
        torch.randn((2, 256, 96), generator=g) * 0.05)
    w2 = type(w)(*(getattr(w, f.name)[1] for f in dataclasses.fields(w)))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((3, 5, 256), generator=g).to(dtype)
        dy = torch.randn((3, 5, 96), generator=g).to(dtype)
        for call in (lambda x: tq.qmatmul(x, w2),
                     lambda x: tq.qmatmul(x, tq.StackedSlice(w, 1))):
            with torch.no_grad():
                plain = call(x)
            xg = x.clone().requires_grad_(True)
            y = call(xg)
            assert y.dtype == dtype and torch.equal(y.detach(), plain)
            (y * dy).sum().backward()
            ref = dy @ tq.dequantize(w2, dtype).T
            assert xg.grad.dtype == dtype
            torch.testing.assert_close(xg.grad, ref, rtol=0, atol=0)


def test_attention_wrappers_refuse_grad():
    """Every attention kernel wrapper raises ValueError when an input
    requires grad under grad mode (the kernels have no backward), on the
    CPU as on the card; under no_grad the same call runs."""
    g = torch.Generator().manual_seed(0)
    B, T, Hq, Hk, Dh, S, page = 2, 3, 4, 2, 16, 32, 8
    q = torch.randn((B, T, Hq, Dh), generator=g, requires_grad=True)
    kv = torch.randn((B, S, Hk, Dh), generator=g)
    kv8 = torch.randint(-127, 128, (B, S, Hk, Dh), dtype=torch.int8,
                        generator=g)
    sc = torch.rand((B, S, Hk), generator=g)
    pool = torch.randn((1, 8, Hk, page, Dh), generator=g)
    pool8 = torch.randint(-127, 128, (1, 8, Hk, page, Dh), dtype=torch.int8,
                          generator=g)
    psc = torch.rand((1, 8, Hk, page), generator=g)
    table = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    off = torch.tensor([5, 20], dtype=torch.int32)
    calls = [
        lambda: tda.flash_decode_attention(q, kv, kv, off),
        lambda: tda.flash_decode_attention_quant(q, kv8, sc, kv8, sc, off),
        lambda: tpa.paged_decode_attention(q, pool[0], pool[0], table, off),
        lambda: tpa.paged_decode_attention_stacked(q, pool, pool, 0, table,
                                                   off),
        lambda: tpa.paged_decode_attention_quant(q, pool8[0], psc[0],
                                                 pool8[0], psc[0], table,
                                                 off),
        lambda: tpa.paged_decode_attention_quant_stacked(
            q, pool8, psc, pool8, psc, 0, table, off),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no backward"):
            call()
        with torch.no_grad():
            assert call().shape == (B, T, Hq, Dh)


def test_training_forward_matches_inference():
    """A forward under autograd (parameters requiring grad) gives the
    inference forward's logits and cache bit for bit: the cache still
    takes each block in place, and attention reads the written copy."""
    from specdec_tpu_torch.core.cache import init_cache

    params = tm.init_params(CFG, seed=1, scale=0.3, device="cpu")
    toks = torch.from_numpy(tokens(2, 9, 11))
    c1 = init_cache(CFG, 2, 12, device="cpu")
    c2 = init_cache(CFG, 2, 12, device="cpu")
    with torch.no_grad():
        ref, _ = tm.forward_step(CFG, params, toks, c1)
    got, _ = tm.forward_step(CFG, optim.trainable(params), toks, c2)
    assert got.requires_grad
    assert torch.equal(got.detach(), ref)
    assert torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v)
