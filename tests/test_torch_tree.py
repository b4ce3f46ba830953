"""The port's tree speculation against the JAX package's, on the same params.

The topology bookkeeping and the accepted-path compaction are compared bit
for bit; the tree forwards' logits, features and caches at f32 tolerance
(INT4 weights: ``bf16_close``, the JAX side on its Pallas kernels in
interpret mode);
greedy tree decoding exactly, tokens and acceptance, against JAX and
against greedy AR (the greedy tree is greedy AR's tokens for any drafter).
Sampled trees cannot match JAX's RNG: the SpecInfer walk is held to the
target distribution by a TV-distance test over many walks in one batched
call, with JAX's bound (0.06, tests/test_tree_speculative.py)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

import specdec_tpu.ops.quant_matmul as jax_qm
from specdec_tpu.core import cache as jc
from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.quant import core as jq
from specdec_tpu.sampling import tree_speculative as jts

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core import cache as tc
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.ops import decode_attention as tda
from specdec_tpu_torch.quant import core as tq
from specdec_tpu_torch.sampling import processors as tp
from specdec_tpu_torch.sampling import tree_speculative as tts
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate

torch.set_num_threads(2)

VOCAB = 64
JCFG = tiny_config(vocab_size=VOCAB, num_layers=2, hidden_size=32,
                   intermediate_size=64, num_heads=4, num_kv_heads=2,
                   head_dim=8)
PROMPT = [3, 14, 15, 9, 2, 6]
GEN = 30
# both sides f32, differing in summation order only (tests/test_torch_model.py)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BRANCHINGS = [(2, 2, 1, 1), (3, 2, 1), (1, 1, 1, 1), (4, 2), (2, 2, 2)]


def port_config(cfg) -> ModelConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ModelConfig(**dict(kw, dtype=torch.float32))


CFG = port_config(JCFG)


def bf16_close(got, ref):
    """tests/test_torch_model.py's tolerance for INT4 models, whose
    matmuls round to bf16."""
    assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2 ** -5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def models():
    """numpy params: the target, an unrelated drafter (another init) and a
    noisy one (the target plus noise: partial accepts, so compaction moves
    rows)."""
    target = jax.tree.map(np.asarray,
                          jm.init_params(JCFG, jax.random.key(0), scale=0.4))
    other = jax.tree.map(np.asarray,
                         jm.init_params(JCFG, jax.random.key(1), scale=0.4))
    noise = jax.tree.map(np.asarray,
                         jm.init_params(JCFG, jax.random.key(2), scale=0.05))
    return {"target": target, "unrelated": other,
            "noisy": jax.tree.map(lambda a, b: a + b, target, noise)}


def both(tree):
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("branching", BRANCHINGS)
def test_topology_matches_jax(branching):
    ref = jts.TreeTopology(branching)
    got = tts.TreeTopology(branching)
    np.testing.assert_array_equal(got.parent, ref.parent)
    np.testing.assert_array_equal(got.depths, np.asarray(ref.depths))
    np.testing.assert_array_equal(got.ancestor, np.asarray(ref.ancestor))
    assert got.level_start == ref.level_start
    assert got.level_sizes == ref.level_sizes
    assert got.num_nodes == ref.num_nodes and got.depth == ref.depth
    depths, anc = got.on("cpu")
    np.testing.assert_array_equal(depths.numpy(), got.depths)
    np.testing.assert_array_equal(anc.numpy(), got.ancestor)
    assert tts._topology(branching) is tts._topology(list(branching))


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_compact_path_bit_equal(fmt):
    """Rows gathered at overlapping slots and written from ``dest``: every
    field, int8 scales included, equals JAX's bit for bit."""
    rng = np.random.default_rng(4)
    L, B, S, Hk, Dh = 2, 2, 24, 2, 8
    shape = (L, B, S, Hk, Dh)
    if fmt == "bf16":
        vals = {n: jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                for n in ("k", "v")}
        jcache = jc.KVCache(length=jnp.zeros((B,), jnp.int32), **vals)
        cache = tc.KVCache(length=torch.zeros((B,), dtype=torch.int32),
                           **{n: params_from_numpy(np.asarray(a), "cpu")
                              for n, a in vals.items()})
    else:
        vals = {n: rng.integers(-127, 128, size=shape).astype(np.int8)
                for n in ("k", "v")}
        vals.update({n: rng.random(shape[:-1]).astype(np.float32)
                     for n in ("k_scale", "v_scale")})
        jcache = jc.QuantKVCache(length=jnp.zeros((B,), jnp.int32),
                                 **{n: jnp.asarray(a) for n, a in vals.items()})
        cache = tc.QuantKVCache(length=torch.zeros((B,), dtype=torch.int32),
                                **{n: torch.from_numpy(a.copy())
                                   for n, a in vals.items()})
    # the accepted chain of a (3, 2, 1) tree rooted at slot 9: nodes 2, 5, 9
    idx = np.asarray([11, 14, 18], np.int32)
    new_len = np.asarray([13, 13], np.int32)
    ref = jc.compact_path(jcache, jnp.asarray(idx), jnp.int32(10),
                          jnp.asarray(new_len))
    got = tc.compact_path(cache, torch.from_numpy(idx), 10,
                          torch.from_numpy(new_len))
    for name in tc.storage_fields(got) + ["length"]:
        a = getattr(got, name)
        if a.dtype == torch.bfloat16:
            a = a.float()
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(getattr(ref, name)).astype(a.numpy().dtype),
            err_msg=name)
    with pytest.raises(IndexError):
        tc.compact_path(cache, torch.from_numpy(idx), S - 2,
                        torch.from_numpy(new_len))
    with pytest.raises(IndexError):
        tc.compact_path(cache, torch.tensor([S]), 10,
                        torch.from_numpy(new_len))


# the JAX forwards, jitted (each shape compiles once; the INT4 test's
# interpret-mode kernels are slow to run eagerly)
JIT = {"features": jax.jit(jm.forward_step_features, static_argnums=0),
       "tree": jax.jit(jm.forward_step_tree, static_argnums=0),
       "tree_features": jax.jit(jm.forward_step_tree_features,
                                static_argnums=0)}


def _tree_forwards(jcfg, cfg, jparams, params, close, branching=(2, 2),
                   lengths=(9, 6)):
    """A prefill, then a tree expanded level by level from a later slot
    (``tree_start`` < length, E > N past level 0), then the whole tree at
    once with features: logits, features and the caches compared. One
    sequence per entry of ``lengths`` (the prefill is the longest)."""
    topo = tts.TreeTopology(branching)
    jtopo = jts.TreeTopology(branching)
    depths, anc = topo.on("cpu")
    rng = np.random.default_rng(8)
    B, S = len(lengths), 40
    jcache = jc.init_cache(jcfg, B, S)
    cache = tc.init_cache(cfg, B, S, device="cpu")
    toks = rng.integers(0, VOCAB, size=(B, max(lengths))).astype(np.int32)
    jl, jf, jcache = JIT["features"](jcfg, jparams, jnp.asarray(toks),
                                     jcache)
    tl, tf, cache = tm.forward_step_features(cfg, params,
                                             torch.from_numpy(toks), cache)
    close(tl.numpy(), np.asarray(jl))
    close(tf.numpy(), np.asarray(jf))
    lengths = np.asarray(lengths, np.int32)
    jcache = jcache.with_length(jnp.asarray(lengths))
    cache = cache.with_length(torch.from_numpy(lengths))
    start = torch.from_numpy(lengths)
    nodes = rng.integers(0, VOCAB, size=(B, topo.num_nodes)).astype(np.int32)
    for l in range(topo.depth + 1):
        ls = topo.level_nodes(l)
        E = topo.level_start[l + 1]
        jl, jcache = JIT["tree"](
            jcfg, jparams, jnp.asarray(nodes[:, ls]), jcache,
            jtopo.depths[ls], jtopo.ancestor[ls, :E],
            tree_start=jnp.asarray(lengths))
        tl, cache = tm.forward_step_tree(
            cfg, params, torch.from_numpy(nodes[:, ls]), cache, depths[ls],
            anc[ls, :E], tree_start=start)
        close(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))
    # the whole tree at once from the prefix, with features
    jcache = jcache.with_length(jnp.asarray(lengths))
    cache = cache.with_length(torch.from_numpy(lengths))
    jl, jf, jcache = JIT["tree_features"](
        jcfg, jparams, jnp.asarray(nodes), jcache, jtopo.depths,
        jtopo.ancestor)
    tl, tf, cache = tm.forward_step_tree_features(
        cfg, params, torch.from_numpy(nodes), cache, depths, anc)
    close(tl.numpy(), np.asarray(jl))
    close(tf.numpy(), np.asarray(jf))
    return jcache, cache


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_forward_step_tree_matches_jax(models, kv_quant):
    """f32 models over bf16-typed (f32 here) and int8 KV: the stored K/V
    equal JAX's (int8: values equal, scales to the projections' f32
    summation order)."""
    jcfg = JCFG.replace(kv_quant=kv_quant)
    jparams, params = both(models["target"])
    jcache, cache = _tree_forwards(
        jcfg, port_config(jcfg), jparams, params,
        lambda a, b: np.testing.assert_allclose(a, b, **F32_TOL))
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))
    if kv_quant == "int8":
        np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
        np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))
        np.testing.assert_allclose(cache.k_scale.numpy(),
                                   np.asarray(jcache.k_scale), rtol=1e-5)
    else:
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                                   **F32_TOL)
        np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v),
                                   **F32_TOL)


def test_forward_step_tree_int4_matches_jax(monkeypatch):
    """INT4 weights (quantize_params(int4, fuse=True)) at
    tests/test_torch_model.py's INT4 widths (hidden 512: every projection,
    the lm_head too, takes JAX's kernel): the port's plain K1 against JAX's
    Pallas kernels in interpret mode, which compute the function K1's plain
    version computes, at ``bf16_close``. One sequence and a (2,) tree keep
    the row counts (3, 1, 2) few: each costs the JAX side an interpret-mode
    compile."""
    jcfg = tiny_config(vocab_size=256, num_layers=2, hidden_size=512,
                       intermediate_size=1024, num_heads=8, num_kv_heads=2,
                       head_dim=64)
    dense = jax.tree.map(np.asarray,
                         jm.init_params(jcfg, jax.random.key(3), scale=0.3))
    jparams = jax.jit(lambda p: jq.quantize_params(p, kind="int4",
                                                   fuse=True))(
        jax.tree.map(jnp.asarray, dense))
    params = tq.quantize_params(params_from_numpy(dense, "cpu"), kind="int4",
                                fuse=True)
    assert isinstance(params["layers"]["wqkv"], tq.Int4Weight)
    assert isinstance(params["lm_head"], tq.Int4Weight)
    monkeypatch.setattr(jax_qm, "_use_pallas", lambda w: True)
    with pltpu.force_tpu_interpret_mode():
        _tree_forwards(jcfg, port_config(jcfg), jparams, params, bf16_close,
                       branching=(2,), lengths=(3,))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tree_block_reaches_no_attention_kernel(monkeypatch, kv_quant):
    """Under ``attention_impl="flash"`` a tree block attends by ancestry in
    the plain attention: the flash-decode wrappers (patched to raise) are
    never reached, while a sequential forward does reach them."""
    # head_dim 16: one the kernels take over int8 K/V too
    cfg = port_config(JCFG.replace(kv_quant=kv_quant, attention_impl="flash",
                                   head_dim=16))
    assert tm.kernel_route(cfg)
    params = tm.init_params(cfg, seed=5, scale=0.3, device="cpu")

    def boom(*a, **k):
        raise AssertionError("attention kernel wrapper reached")
    for name in ("flash_decode_attention", "flash_decode_attention_quant"):
        monkeypatch.setattr(tda, name, boom)
    topo = tts.TreeTopology((3, 2, 1))
    depths, anc = topo.on("cpu")
    cache = tc.init_cache(cfg, 1, 32, device="cpu")
    cache = cache.with_length(torch.tensor([5], dtype=torch.int32))
    toks = torch.arange(topo.num_nodes)[None, :]
    logits, cache = tm.forward_step_tree(cfg, params, toks, cache, depths,
                                         anc)
    logits, feats, cache = tm.forward_step_tree_features(
        cfg, params, toks, cache, depths, anc,
        tree_start=torch.tensor([5], dtype=torch.int32))
    assert logits.shape == (1, topo.num_nodes, VOCAB)
    with pytest.raises(AssertionError, match="kernel wrapper reached"):
        tm.forward_step(cfg, params, toks[:, :2], cache)


def _ar(params, eos=()):
    return autoregressive_generate(PROMPT, CFG, params, max_gen_len=GEN,
                                   eos_tokens_id=eos, device="cpu")


@pytest.mark.parametrize("drafter", ["unrelated", "noisy"])
@pytest.mark.parametrize("branching", [(2, 2, 1, 1), (3, 2, 1),
                                       (1, 1, 1, 1)])
def test_greedy_tree_matches_jax_and_ar(models, branching, drafter):
    jt, tt = both(models["target"])
    jd, td = both(models[drafter])
    ref, ref_rate = jts.tree_speculative_generate(
        PROMPT, JCFG, jd, JCFG, jt, branching=branching, max_gen_len=GEN,
        eos_tokens_id=())
    got, rate = tts.tree_speculative_generate(
        PROMPT, CFG, td, CFG, tt, branching=branching, max_gen_len=GEN,
        eos_tokens_id=(), device="cpu")
    assert got == ref == _ar(tt)
    assert rate == ref_rate
    if drafter == "noisy":
        assert 0.0 < rate < 1.0


def test_greedy_tree_int8_kv_flash_matches_jax(models):
    """int8 KV under the flash setting: sequential forwards take K4's plain
    version, tree blocks the ancestor-masked attention."""
    jcfg = JCFG.replace(kv_quant="int8", attention_impl="flash")
    cfg = port_config(jcfg)
    jt, tt = both(models["target"])
    jd, td = both(models["noisy"])
    ref, ref_rate = jts.tree_speculative_generate(
        PROMPT, jcfg, jd, jcfg, jt, branching=(2, 2, 2), max_gen_len=GEN,
        eos_tokens_id=())
    got, rate = tts.tree_speculative_generate(
        PROMPT, cfg, td, cfg, tt, branching=(2, 2, 2), max_gen_len=GEN,
        eos_tokens_id=(), device="cpu")
    assert got == ref and rate == ref_rate
    assert got == autoregressive_generate(PROMPT, cfg, tt, max_gen_len=GEN,
                                          eos_tokens_id=(), device="cpu")


def test_greedy_tree_eos_truncation(models):
    jt, tt = both(models["target"])
    jd, td = both(models["noisy"])
    full = _ar(tt)
    eos = full[7]
    ref, _ = jts.tree_speculative_generate(
        PROMPT, JCFG, jd, JCFG, jt, branching=(2, 2, 1, 1), max_gen_len=GEN,
        eos_tokens_id=eos)
    got, _ = tts.tree_speculative_generate(
        PROMPT, CFG, td, CFG, tt, branching=(2, 2, 1, 1), max_gen_len=GEN,
        eos_tokens_id=eos, device="cpu")
    assert got == ref == full[:full.index(eos) + 1] == _ar(tt, eos)


def test_sampled_tree_self_draft_accepts_everything(models):
    """Drafter == target under sampling: every child drawn from q = p is
    accepted (min(1, p/q) = 1), so acceptance is 1.0; the same generator
    seed gives the same tokens."""
    _, tt = both(models["target"])
    proc = tp.MultinomialProcessor(temperature=1.0)
    outs = [tts.tree_speculative_generate(
        PROMPT, CFG, tt, CFG, tt, branching=(2, 2), max_gen_len=24,
        logits_processor=proc, eos_tokens_id=(),
        generator=torch.Generator().manual_seed(3), device="cpu")
        for _ in range(2)]
    assert outs[0] == outs[1]
    out, rate = outs[0]
    assert rate == 1.0 and len(out) == 24
    assert all(0 <= t < VOCAB for t in out)


def test_sampled_tree_first_token_distribution(models):
    """SpecInfer's theorem through ``_sampled_tree_accept``: over many
    walks of one (2, 2) tree window, each drawing its own children from
    the drafter's q, the first emitted token (the first accepted child, or
    the residual draw) is distributed as the target's p. q and p are the
    models' processed distributions at the root; the deeper nodes' do not
    move the first token."""
    _, tt = both(models["target"])
    _, td = both(models["unrelated"])
    proc = tp.MultinomialProcessor(temperature=1.0)
    topo = tts.TreeTopology((2, 2))
    toks = torch.tensor([PROMPT])
    p = proc(tm.forward_full(CFG, tt, toks)[0, -1])
    q = proc(tm.forward_full(CFG, td, toks)[0, -1])
    R, N = 20000, topo.num_nodes
    gen = torch.Generator().manual_seed(42)
    q_nodes = q.expand(R, N, VOCAB)
    p_nodes = p.expand(R, N, VOCAB)
    tree_toks = torch.zeros((R, N), dtype=torch.int64)
    tree_toks[:, 1:] = proc.sample(q.expand(R, N - 1, VOCAB), gen)
    chain, n_acc, nxt = tts._sampled_tree_accept(topo, tree_toks, q_nodes,
                                                 p_nodes, proc, gen)
    first = torch.where(n_acc > 0, tree_toks.gather(1, chain[:, :1])[:, 0],
                        nxt)
    counts = np.bincount(first.numpy(), minlength=VOCAB) / R
    tv = 0.5 * np.abs(counts - p.numpy()).sum()
    assert tv < 0.06, f"TV distance {tv:.4f}"
    # the walk accepts in part: both branches of the first token occur
    assert 0 < int((n_acc > 0).sum()) < R


def test_build_pair_tail_damp(monkeypatch):
    """``bench.build_pair``'s ``tail_damp`` (tools/bench_tree.py's two
    operating points): the default gives the weights of the fixed 0.08
    damp it replaced, bit for bit; 0.35 changes only the damped stacks of
    layers 4 and up. At a small config in place of the full widths."""
    from specdec_tpu_torch import bench

    def small_config(num_layers=6, dtype=torch.bfloat16, kv_quant="none",
                     attention_impl="xla"):
        return ModelConfig(vocab_size=64, hidden_size=64,
                           intermediate_size=128, num_layers=num_layers,
                           num_heads=4, num_kv_heads=2, head_dim=16,
                           dtype=dtype, kv_quant=kv_quant,
                           attention_impl=attention_impl)
    monkeypatch.setattr(bench, "target_config", small_config)
    t_cfg, d_cfg, target, drafter = bench.build_pair("cpu", quant="none")
    # the weights as the pair was built before tail_damp existed
    base = tm.init_params(t_cfg, scale=0.02, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    scale = torch.ones(t_cfg.num_layers)
    scale[bench.DRAFT_LAYERS:] = 0.08
    for name, want in base["layers"].items():
        if name in ("wo", "w_down"):
            want = (want.float() * scale[:, None, None]).to(t_cfg.dtype)
        assert torch.equal(target["layers"][name], want), name
    assert torch.equal(target["lm_head"], base["lm_head"])
    assert d_cfg.num_layers == bench.DRAFT_LAYERS
    assert torch.equal(drafter["layers"]["wo"],
                       target["layers"]["wo"][:bench.DRAFT_LAYERS])
    weak = bench.build_pair("cpu", quant="none", tail_damp=0.35)[2]
    for name, w in weak["layers"].items():
        head = slice(0, bench.DRAFT_LAYERS)
        assert torch.equal(w[head], target["layers"][name][head]), name
        assert torch.equal(w, target["layers"][name]) == (
            name not in ("wo", "w_down")), name
