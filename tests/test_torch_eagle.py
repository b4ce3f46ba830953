"""The port's EAGLE drafter and its single-sequence loops against the JAX
package's, on the same params (the untrained head of ``init_eagle_params``,
carried over with ``bridge.params_from_numpy``).

The forwards' logits, predicted features and caches agree at f32
tolerance. Greedy chain EAGLE is not greedy AR: its acceptance compares
softmax ratios against uniform draws (reference semantics), so its tokens
depend on the draws; the port's loop takes JAX's draws here (its
``_accept_uniforms`` patched) and must then give JAX's tokens and
acceptance exactly. At a temperature low enough that the softmaxes
saturate, the draws stop mattering and greedy chain EAGLE is greedy AR.
Greedy EAGLE trees are greedy AR's tokens for any head. Sampled outputs are
held to the target distribution by JAX's TV bound (0.06,
tests/test_eagle.py)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import cache as jc
from specdec_tpu.core import eagle as je
from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.sampling import eagle_speculative as jes
from specdec_tpu.sampling import eagle_tree as jet
from specdec_tpu.sampling import tree_speculative as jts

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core import cache as tc
from specdec_tpu_torch.core import eagle as te
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.sampling import eagle_speculative as tes
from specdec_tpu_torch.sampling import eagle_tree as tet
from specdec_tpu_torch.sampling import processors as tp
from specdec_tpu_torch.sampling import tree_speculative as tts
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate

torch.set_num_threads(2)

VOCAB = 32
JCFG = tiny_config(vocab_size=VOCAB, num_layers=2, hidden_size=32,
                   intermediate_size=64, num_heads=4, num_kv_heads=2,
                   head_dim=8)
JECFG = JCFG.replace(num_layers=1)
PROMPT = [3, 14, 15, 9, 2, 6]
GEN = 30
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def port_config(cfg) -> ModelConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ModelConfig(**dict(kw, dtype=torch.float32))


CFG, ECFG = port_config(JCFG), port_config(JECFG)


@pytest.fixture(scope="module")
def models():
    """(JAX target, JAX head, port target, port head)."""
    target = jax.tree.map(np.asarray,
                          jm.init_params(JCFG, jax.random.key(0), scale=0.4))
    head = jax.tree.map(np.asarray,
                        je.init_eagle_params(JECFG, jax.random.key(1)))
    return (jax.tree.map(jnp.asarray, target), jax.tree.map(jnp.asarray, head),
            params_from_numpy(target, "cpu"), params_from_numpy(head, "cpu"))


def jax_draws(key, gamma):
    """JAX's acceptance draws of window w of ``_eagle_generate``."""
    def draw(shape, generator, device):
        k = jax.random.split(jax.random.fold_in(key, draw.window), 3)[1]
        draw.window += 1
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (gamma,)))).reshape(shape)
    draw.window = 0
    return draw


def test_init_eagle_params():
    """The port's head: fc = [random; I] over (embed, feature), zero bias,
    dense layers of the head's depth, from a seed."""
    head = te.init_eagle_params(ECFG, seed=3, device="cpu")
    D = ECFG.hidden_size
    assert head["fc_w"].shape == (2 * D, D)
    torch.testing.assert_close(head["fc_w"][D:], torch.eye(D))
    assert head["fc_b"].abs().max() == 0
    assert head["layers"]["wq"].shape[0] == 1
    again = te.init_eagle_params(ECFG, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        head["layers"].values(), again["layers"].values()))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_eagle_forwards_match_jax(models, kv_quant):
    """The target's prefill with features, a catch-up block of pairs, a
    draft step, and a tree level from a later slot (E > N): logits, f_hat
    and the head's cache equal JAX's at f32 tolerance."""
    jt, jh, tt, th = models
    jcfg, jecfg = (JCFG.replace(kv_quant=kv_quant),
                   JECFG.replace(kv_quant=kv_quant))
    cfg, ecfg = port_config(jcfg), port_config(jecfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, VOCAB, size=(2, 8)).astype(np.int32)
    jl, jf, _ = jm.forward_step_features(jcfg, jt, jnp.asarray(toks),
                                         jc.init_cache(jcfg, 2, 32))
    tl, tf, _ = tm.forward_step_features(cfg, tt, torch.from_numpy(toks),
                                         tc.init_cache(cfg, 2, 32,
                                                       device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **F32_TOL)

    feats = np.array(jf)
    jcache = jc.init_cache(jecfg, 2, 32)
    cache = tc.init_cache(ecfg, 2, 32, device="cpu")

    def check(ref, got):
        for r, g in zip(ref[:2], got[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32_TOL)
        np.testing.assert_array_equal(got[2].length.numpy(),
                                      np.asarray(ref[2].length))
        return ref[2], got[2]

    # catch-up block: pairs (feature j, token j+1)
    jcache, cache = check(
        je.eagle_forward(jecfg, jh, jt, jnp.asarray(toks[:, 1:6]),
                         jnp.asarray(feats[:, :5]), jcache),
        te.eagle_forward(ecfg, th, tt, torch.from_numpy(toks[:, 1:6]),
                         torch.from_numpy(feats[:, :5]), cache))
    # a draft step on a predicted feature
    jcache, cache = check(
        je.eagle_forward(jecfg, jh, jt, jnp.asarray(toks[:, 6:7]),
                         jnp.asarray(feats[:, 5:6]), jcache),
        te.eagle_forward(ecfg, th, tt, torch.from_numpy(toks[:, 6:7]),
                         torch.from_numpy(feats[:, 5:6]), cache))
    # a tree: level 1 at the current length, then level 2 from that start
    topo, jtopo = tts.TreeTopology((2, 2)), jts.TreeTopology((2, 2))
    depths, anc = topo.on("cpu")
    start = np.asarray([6, 6], np.int32)
    nodes = rng.integers(0, VOCAB, size=(2, topo.num_nodes)).astype(np.int32)
    nf = rng.standard_normal((2, topo.num_nodes, 32)).astype(np.float32)
    for l in (1, 2):
        ls = topo.level_nodes(l)
        E = topo.level_start[l + 1]
        jcache, cache = check(
            je.eagle_forward_tree(
                jecfg, jh, jt, jnp.asarray(nodes[:, ls]),
                jnp.asarray(nf[:, ls]), jcache, jtopo.depths[ls] - 1,
                jtopo.ancestor[ls, 1:E], tree_start=jnp.asarray(start)),
            te.eagle_forward_tree(
                ecfg, th, tt, torch.from_numpy(nodes[:, ls]),
                torch.from_numpy(nf[:, ls]), cache, depths[ls] - 1,
                anc[ls, 1:E], tree_start=torch.from_numpy(start)))
    if kv_quant == "int8":
        np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
        np.testing.assert_allclose(cache.v_scale.numpy(),
                                   np.asarray(jcache.v_scale), rtol=1e-5)
    else:
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                                   **F32_TOL)


@pytest.mark.parametrize("first_target", [True, False])
@pytest.mark.parametrize("gamma", [3, 5])
def test_greedy_eagle_matches_jax(models, monkeypatch, gamma, first_target):
    jt, jh, tt, th = models
    key = jax.random.key(10 + gamma)
    ref, ref_rate = jes.eagle_generate(
        PROMPT, JECFG, jh, JCFG, jt, gamma=gamma, max_gen_len=GEN,
        eos_tokens_id=(), first_target=first_target, key=key)
    monkeypatch.setattr(tes, "_accept_uniforms", jax_draws(key, gamma))
    got, rate = tes.eagle_generate(
        PROMPT, ECFG, th, CFG, tt, gamma=gamma, max_gen_len=GEN,
        eos_tokens_id=(), first_target=first_target, device="cpu")
    assert got == ref and rate == ref_rate
    assert len(got) == GEN and 0.0 < rate < 1.0


def test_greedy_eagle_eos_truncation(models, monkeypatch):
    jt, jh, tt, th = models
    key = jax.random.key(20)
    full, _ = jes.eagle_generate(PROMPT, JECFG, jh, JCFG, jt, gamma=3,
                                 max_gen_len=GEN, eos_tokens_id=(), key=key)
    eos = full[9]
    ref, _ = jes.eagle_generate(PROMPT, JECFG, jh, JCFG, jt, gamma=3,
                                max_gen_len=GEN, eos_tokens_id=eos, key=key)
    monkeypatch.setattr(tes, "_accept_uniforms", jax_draws(key, 3))
    got, _ = tes.eagle_generate(PROMPT, ECFG, th, CFG, tt, gamma=3,
                                max_gen_len=GEN, eos_tokens_id=eos,
                                device="cpu")
    assert got == ref == full[:full.index(eos) + 1]


def test_low_temperature_greedy_eagle_equals_ar(models):
    """GreedyProcessor at temperature 1e-4: the softmaxes saturate, a draft
    is accepted iff it is the target's argmax and a rejection commits the
    argmax, whatever the draws: greedy AR's tokens, with accepts in
    part."""
    _, _, tt, th = models
    ar = autoregressive_generate(PROMPT, CFG, tt, max_gen_len=GEN,
                                 eos_tokens_id=(), device="cpu")
    got, rate = tes.eagle_generate(
        PROMPT, ECFG, th, CFG, tt, gamma=4, max_gen_len=GEN,
        logits_processor=tp.GreedyProcessor(temperature=1e-4),
        eos_tokens_id=(), device="cpu")
    assert got == ar and 0.0 < rate < 1.0


def test_sampled_eagle_first_token_distribution(models):
    """The first emitted token through the accept / residual path is
    distributed as the target's processed distribution (JAX's bound)."""
    _, _, tt, th = models
    proc = tp.MultinomialProcessor(temperature=1.0)
    gen = torch.Generator().manual_seed(42)
    n_runs = 1500
    tokens = [tes.eagle_generate(PROMPT, ECFG, th, CFG, tt, gamma=3,
                                 max_gen_len=1, logits_processor=proc,
                                 eos_tokens_id=(), first_target=False,
                                 generator=gen, device="cpu")[0][0]
              for _ in range(n_runs)]
    counts = np.bincount(tokens, minlength=VOCAB) / n_runs
    logits = tm.forward_full(CFG, tt, torch.tensor([PROMPT]))
    p = proc(logits[0, -1]).numpy()
    tv = 0.5 * np.abs(counts - p).sum()
    assert tv < 0.06, f"TV distance {tv:.4f}"


@pytest.mark.parametrize("branching", [(3, 2, 1), (2, 2, 2)])
def test_greedy_eagle_tree_matches_jax_and_ar(models, branching):
    jt, jh, tt, th = models
    ref, ref_rate = jet.eagle_tree_generate(
        PROMPT, JECFG, jh, JCFG, jt, branching=branching, max_gen_len=GEN,
        eos_tokens_id=())
    got, rate = tet.eagle_tree_generate(
        PROMPT, ECFG, th, CFG, tt, branching=branching, max_gen_len=GEN,
        eos_tokens_id=(), device="cpu")
    assert got == ref == autoregressive_generate(
        PROMPT, CFG, tt, max_gen_len=GEN, eos_tokens_id=(), device="cpu")
    assert rate == ref_rate and 0.0 < rate < 1.0


def test_sampled_eagle_tree_deterministic(models):
    """A sampled EAGLE tree draws from its generator only: one seed, one
    output."""
    _, _, tt, th = models
    proc = tp.MultinomialProcessor(temperature=1.0)
    outs = [tet.eagle_tree_generate(
        PROMPT, ECFG, th, CFG, tt, branching=(2, 2), max_gen_len=24,
        logits_processor=proc, eos_tokens_id=(),
        generator=torch.Generator().manual_seed(s), device="cpu")
        for s in (5, 5)]
    assert outs[0] == outs[1]
    out, rate = outs[0]
    assert len(out) == 24 and 0.0 <= rate <= 1.0
    assert all(0 <= t < VOCAB for t in out)
