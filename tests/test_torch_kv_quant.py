"""The port's INT8 KV cache (``kv_quant="int8"``) and flash-decode dispatch
(``attention_impl="flash"``) against the JAX package's, on the same numpy
inputs and params.

Storage is compared bit for bit: the quantizer against JAX's eager one
(ties included), the slotted and paged writes, and the slot and page
installs that must move the scales with their values. Forwards are compared
in float32 models at f32 tolerance (JAX runs its XLA path on the CPU, the
port its kernels' plain versions, which are the same dense attention).
Decoding and serving over int8 KV are held to the exact greedy oracles of
tests/test_kv_quant.py and tests/test_paged_quant.py: both sides of each
oracle read the same quantized state."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from specdec_tpu.core import cache as jc
from specdec_tpu.core import model as jm
from specdec_tpu.core import paged_cache as jpc
from specdec_tpu.core.config import tiny_config
from specdec_tpu.sampling.base_decoding import (
    autoregressive_generate as jax_autoregressive_generate,
)

import specdec_tpu_torch.serve as serve
from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core import cache as tc
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core import paged_cache as tpc
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate
from specdec_tpu_torch.sampling.speculative import speculative_generate

torch.set_num_threads(2)

PAGE = 8
# both sides f32, differing in summation order only (tests/test_torch_model.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def port_config(cfg, **kw) -> ModelConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ModelConfig(**dict(fields, dtype=torch.float32, **kw))


def t(a):
    return torch.from_numpy(np.array(a))


def assert_fields_equal(got, ref, names):
    for name in names:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


QUANT_FIELDS = ("k", "v", "k_scale", "v_scale", "length")


def tie_block(rng, shape):
    """Random values, plus rows whose absmax is 127 (scale exactly 1) and
    whose other entries sit on exact .5 ties of both parities, and an
    all-zero row (scale 1e-8 / 127)."""
    x = rng.standard_normal(shape).astype(np.float32)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                    np.float32)
    row = np.resize(ties, shape[-1])
    row[0] = 127.0
    x[0, 0, 0] = row
    x[0, -1, -1] = -row
    x[-1, 0, 0] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_block_bit_identical_to_eager_jax(dtype):
    """Values round half to even on exact ties and scales are the same f32
    numbers: held against the eager JAX quantizer (under jit XLA may turn
    the / 127 into * (1/127))."""
    x = tie_block(np.random.default_rng(0), (3, 5, 2, 16))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = t(x).to(getattr(torch, dtype))
    jq, js = jc.quantize_kv_block(jx)
    tq, ts = tc.quantize_kv_block(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if dtype == "float32":
        np.testing.assert_array_equal(tq[0, 0, 0, :8].numpy(),
                                      [127, 2, 2, -0, -2, -2, 126, -126])


def test_quant_cache_construction_rollback_and_views():
    cfg = port_config(tiny_config(), kv_quant="int8")
    c = tc.init_cache(cfg, 2, 32, device="cpu")
    assert isinstance(c, tc.QuantKVCache)
    assert c.k.dtype == c.v.dtype == torch.int8
    assert c.k_scale.dtype == c.v_scale.dtype == torch.float32
    assert c.k_scale.shape == c.k.shape[:-1] == (2, 2, 32, 2)
    c2 = c.with_length(torch.tensor([5, 7], dtype=torch.int32)).rolled_back(6)
    assert c2.length.tolist() == [0, 1]
    assert c2.k is c.k and c2.v_scale is c.v_scale
    assert isinstance(tc.init_cache(port_config(tiny_config()), 2, 32,
                                    device="cpu"), tc.KVCache)

    p = tpc.init_paged_cache(cfg, 2, 9, PAGE, 4, device="cpu")
    assert isinstance(p, tpc.QuantPagedKVCache)
    assert p.k.shape == (2, 9, 2, PAGE, 16) and p.k.dtype == torch.int8
    assert p.k_scale.shape == (2, 9, 2, PAGE) and p.page_size == PAGE
    assert p.rolled_back(1).length.tolist() == [0, 0]
    view = tpc.paged_view(p, torch.tensor([3, 1, 0, 0], dtype=torch.int32),
                          5)
    assert isinstance(view, tpc.QuantPagedKVCache)
    assert view.k_scale is p.k_scale and view.v_scale is p.v_scale
    assert view.page_table.tolist() == [[3, 1, 0, 0]]
    assert view.length.tolist() == [5]


@pytest.mark.parametrize("offsets", [[0, 9], [3, 12]],
                         ids=["inside", "clamped"])
def test_write_block_quant_bit_equal(offsets):
    """Quantized slotted writes (``write_block`` with the layer's scales,
    JAX's ``write_block_quant``) at per-sequence offsets, the second clamped
    to S - T as ``dynamic_update_slice`` clamps it: values and scales equal
    JAX's bit for bit."""
    rng = np.random.default_rng(1)
    B, S, Hk, Dh, T = 2, 12, 2, 16, 4
    layers = [rng.integers(-127, 128, size=(B, S, Hk, Dh)).astype(np.int8),
              rng.uniform(0.01, 0.1, size=(B, S, Hk)).astype(np.float32)]
    nk, nv = (tie_block(rng, (B, T, Hk, Dh)) for _ in range(2))
    off = np.asarray(offsets, np.int32)
    ref = jc.write_block_quant(
        jnp.asarray(layers[0]), jnp.asarray(layers[1]),
        jnp.asarray(layers[0]), jnp.asarray(layers[1]), jnp.asarray(nk),
        jnp.asarray(nv), jnp.asarray(off))
    got = [t(layers[0]), t(layers[1]), t(layers[0]), t(layers[1])]
    tc.write_block(got[0], got[2], t(nk), t(nv), t(off),
                   scales=(got[1], got[3]))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_write_block_paged_quant_stacked_bit_equal():
    """Quantized scatter into each layer of int8 stacks
    (``write_block_paged_stacked`` with the scale stacks, JAX's
    ``write_block_paged_quant_stacked``) across a page boundary, one row
    finished (its table is garbage page 0): pools and scales equal JAX's
    bit for bit."""
    rng = np.random.default_rng(2)
    L, NP, Hk, Dh, B, T, MP = 2, 10, 2, 16, 3, 3, 3
    pk = (rng.integers(-127, 128, size=(L, NP, Hk, PAGE, Dh)).astype(np.int8),
          rng.uniform(0.01, 0.1, size=(L, NP, Hk, PAGE)).astype(np.float32))
    pv = (pk[0][::-1].copy(), pk[1][::-1].copy())
    tables = rng.permutation(np.arange(1, NP))[:B * MP].reshape(B, MP)
    tables = tables.astype(np.int32)
    tables[2] = 0
    off = np.asarray([6, 13, 2], np.int32)
    jk = tuple(map(jnp.asarray, pk))
    jv = tuple(map(jnp.asarray, pv))
    tk, tv = tuple(map(t, pk)), tuple(map(t, pv))
    for layer in range(L):
        nk, nv = (tie_block(rng, (B, T, Hk, Dh)) for _ in range(2))
        jk, jv = jpc.write_block_paged_quant_stacked(
            jk, jv, jnp.int32(layer), jnp.asarray(nk), jnp.asarray(nv),
            jnp.asarray(tables), jnp.asarray(off), PAGE)
        tpc.write_block_paged_stacked(tk[0], tv[0], layer, t(nk), t(nv),
                                      t(tables), t(off), PAGE,
                                      scales=(tk[1], tv[1]))
        for g, r in zip(tk + tv, jk + jv):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_install_and_zero_slot_move_scales():
    """The slotted admission primitives over QuantKVCache copy and zero the
    scales with the values (JAX's ``_array_fields``), bit for bit."""
    rng = np.random.default_rng(3)
    L, B, S, Hk, Dh = 2, 3, 10, 2, 16
    shape = (L, B, S, Hk, Dh)

    def arrays(b):
        return dict(
            k=rng.integers(-127, 128, size=shape[:1] + (b,) + shape[2:]
                           ).astype(np.int8),
            v=rng.integers(-127, 128, size=shape[:1] + (b,) + shape[2:]
                           ).astype(np.int8),
            k_scale=rng.uniform(size=(L, b, S, Hk)).astype(np.float32),
            v_scale=rng.uniform(size=(L, b, S, Hk)).astype(np.float32),
            length=np.arange(3, 3 + b, dtype=np.int32))

    dst, src = arrays(B), arrays(1)
    jdst = jc.QuantKVCache(**{k: jnp.asarray(v) for k, v in dst.items()})
    jsrc = jc.QuantKVCache(**{k: jnp.asarray(v) for k, v in src.items()})
    pdst = tc.QuantKVCache(**{k: t(v) for k, v in dst.items()})
    psrc = tc.QuantKVCache(**{k: t(v) for k, v in src.items()})
    ref = jc.zero_slot(jc.install_slot(jdst, jsrc, jnp.int32(1),
                                       jnp.int32(9)), jnp.int32(2),
                       jnp.int32(0))
    got = tc.zero_slot(tc.install_slot(pdst, psrc, 1, 9), 2, 0)
    assert_fields_equal(got, ref, QUANT_FIELDS)
    psrc.k_scale.zero_()
    assert got.k_scale[:, 1].abs().sum() > 0      # copied, not aliased


def test_install_sequence_pages_moves_scales():
    """The dense admission's install over an int8 pool scatters the scratch
    cache's scales with its values, bit for bit."""
    rng = np.random.default_rng(4)
    L, NP, Hk, Dh, S, MP = 2, 9, 2, 16, 30, 5
    cfg = port_config(tiny_config(num_kv_heads=Hk, head_dim=Dh),
                      kv_quant="int8")
    pool = tpc.init_paged_cache(cfg, 1, NP, PAGE, MP, device="cpu")
    for name in ("k", "v"):
        getattr(pool, name).copy_(t(rng.integers(
            -127, 128, size=(L, NP, Hk, PAGE, Dh)).astype(np.int8)))
        getattr(pool, f"{name}_scale").copy_(t(rng.uniform(
            size=(L, NP, Hk, PAGE)).astype(np.float32)))
    jpool = jpc.QuantPagedKVCache(
        **{n: jnp.asarray(getattr(pool, n).numpy())
           for n in ("k", "v", "k_scale", "v_scale", "page_table",
                     "length")})
    scratch = dict(
        k=rng.integers(-127, 128, size=(L, 1, S, Hk, Dh)).astype(np.int8),
        v=rng.integers(-127, 128, size=(L, 1, S, Hk, Dh)).astype(np.int8),
        k_scale=rng.uniform(size=(L, 1, S, Hk)).astype(np.float32),
        v_scale=rng.uniform(size=(L, 1, S, Hk)).astype(np.float32),
        length=np.zeros(1, np.int32))
    row = np.asarray([7, 2, 5, 0, 0], np.int32)   # 3 pages allocated
    ref = jpc.install_sequence_pages(
        jpool, jnp.asarray(row),
        jc.QuantKVCache(**{k: jnp.asarray(v) for k, v in scratch.items()}))
    tpc.install_sequence_pages(
        pool, t(row), tc.QuantKVCache(**{k: t(v) for k, v in scratch.items()}))
    assert_fields_equal(pool, ref, ("k", "v", "k_scale", "v_scale"))
    np.testing.assert_array_equal(
        tpc.gather_page_scales(pool.k_scale[1], t(row[None])).numpy(),
        np.asarray(jpc.gather_page_scales(ref.k_scale[1],
                                          jnp.asarray(row[None]))))


JCFG = tiny_config(vocab_size=64, num_layers=2, hidden_size=64,
                   intermediate_size=128, num_heads=8, num_kv_heads=4,
                   head_dim=16)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray,
                        jm.init_params(JCFG, jax.random.key(0), scale=0.3))


@pytest.mark.parametrize("kv_quant,attn", [("int8", "xla"),
                                           ("int8", "flash"),
                                           ("none", "flash")])
def test_forward_step_matches_jax(np_params, kv_quant, attn):
    """Prefill, a one-token decode and a gamma+1 verify on two sequences at
    different offsets, then a forward after rollback: the port's slotted
    forward (the flash kernels' plain versions under ``flash``) against
    JAX's jitted forward, logits at f32 tolerance. The stored int8 values
    are equal and the scales agree to the projections' f32 summation order
    (the K/V they quantize differ there by ~1e-6, relative)."""
    jcfg = JCFG.replace(kv_quant=kv_quant, attention_impl=attn)
    cfg = port_config(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    step = jax.jit(jm.forward_step, static_argnums=0)
    rng = np.random.default_rng(5)
    B, S = 2, 32
    jcache = jc.init_cache(jcfg, B, S)
    pcache = tc.init_cache(cfg, B, S, device="cpu")

    def both(T, lengths=None):
        nonlocal jcache, pcache
        if lengths is not None:
            jcache = jcache.with_length(jnp.asarray(lengths, jnp.int32))
            pcache = pcache.with_length(t(np.asarray(lengths, np.int32)))
        toks = rng.integers(0, 64, size=(B, T)).astype(np.int32)
        jl, jcache = step(jcfg, jparams, jnp.asarray(toks), jcache)
        pl_, pcache = tm.forward_step(cfg, params, t(toks), pcache)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGIT_TOL)

    both(9)
    both(1, lengths=[9, 6])
    both(5)
    both(2, lengths=(pcache.length - 3).tolist())
    assert type(pcache).__name__ == type(jcache).__name__
    np.testing.assert_array_equal(pcache.length.numpy(),
                                  np.asarray(jcache.length))
    if kv_quant == "int8":
        np.testing.assert_array_equal(pcache.k.numpy(), np.asarray(jcache.k))
        np.testing.assert_array_equal(pcache.v.numpy(), np.asarray(jcache.v))
        np.testing.assert_allclose(pcache.k_scale.numpy(),
                                   np.asarray(jcache.k_scale), rtol=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "gather"])
def test_forward_step_paged_int8_matches_jax_and_slotted(np_params,
                                                         use_kernel):
    """The paged forward over an int8 pool, through K8b's plain version or
    the gather path with ``gather_page_scales``, against JAX's paged
    forward (its int8 kernel in interpret mode, or its gather path) and the
    port's slotted int8 forward. The stored int8 pools equal JAX's; their
    scales agree to the projections' f32 summation order."""
    jcfg = JCFG.replace(kv_quant="int8")
    cfg = port_config(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    rng = np.random.default_rng(6)
    B, MP = 2, 5
    NP = B * MP + 2
    tables = rng.permutation(np.arange(1, NP))[:B * MP].reshape(B, MP)
    tables = tables.astype(np.int32)
    jcache = dataclasses.replace(jpc.init_paged_cache(jcfg, B, NP, PAGE, MP),
                                 page_table=jnp.asarray(tables))
    pcache = dataclasses.replace(
        tpc.init_paged_cache(cfg, B, NP, PAGE, MP, device="cpu"),
        page_table=t(tables))
    scache = tc.init_cache(cfg, B, MP * PAGE, device="cpu")

    def step(T, lengths=None):
        nonlocal jcache, pcache, scache
        if lengths is not None:
            jcache = jcache.with_length(jnp.asarray(lengths, jnp.int32))
            pcache = pcache.with_length(t(np.asarray(lengths, np.int32)))
            scache = scache.with_length(t(np.asarray(lengths, np.int32)))
        toks = t(rng.integers(0, 64, size=(B, T)).astype(np.int32))
        with pltpu.force_tpu_interpret_mode():
            jl, jcache = jm.forward_step_paged(jcfg, jparams,
                                               jnp.asarray(toks.numpy()),
                                               jcache, use_kernel=use_kernel)
        pl_, pcache = tm.forward_step_paged(cfg, params, toks, pcache,
                                            use_kernel=use_kernel)
        sl, scache = tm.forward_step(cfg, params, toks, scache)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(pl_.numpy(), sl.numpy(), **LOGIT_TOL)

    step(11)
    step(1, lengths=[11, 7])
    step(5)
    assert isinstance(pcache, tpc.QuantPagedKVCache)
    assert_fields_equal(pcache, jcache, ("k", "v", "length"))
    np.testing.assert_allclose(pcache.v_scale.numpy(),
                               np.asarray(jcache.v_scale), rtol=1e-5)


VOCAB = 32
SCFG = tiny_config(vocab_size=VOCAB, num_layers=2, hidden_size=32,
                   intermediate_size=64, num_heads=4, num_kv_heads=2,
                   head_dim=16, kv_quant="int8", attention_impl="flash")
PROMPTS = [[3, 14, 15, 9, 2, 6], [1, 1, 2, 3, 5, 8, 13, 21], [27, 4],
           [9, 9, 9, 1, 2]]
GEN = 12


@pytest.fixture(scope="module")
def serve_models():
    """(port config, port params, JAX greedy AR per prompt over int8 KV)."""
    target = jax.tree.map(np.asarray,
                          jm.init_params(SCFG, jax.random.key(0), scale=0.4))
    ref = [jax_autoregressive_generate(p, SCFG, jax.tree.map(jnp.asarray,
                                                             target),
                                       max_gen_len=GEN, eos_tokens_id=())
           for p in PROMPTS]
    return port_config(SCFG), params_from_numpy(target, "cpu"), ref


def test_int8_flash_ar_matches_jax_and_self_draft_oracle(serve_models):
    """Greedy AR over int8 KV equals JAX's token for token, and greedy
    self-draft speculation equals it with acceptance 1.0 (AR attends at
    T=1, the verify at T=gamma+1, over the same quantized state)."""
    cfg, params, ref = serve_models
    for p, want in zip(PROMPTS, ref):
        ar = autoregressive_generate(p, cfg, params, max_gen_len=GEN,
                                     eos_tokens_id=(), device="cpu")
        assert ar == want
        spec, rate = speculative_generate(p, cfg, params, cfg, params,
                                          gamma=4, max_gen_len=GEN,
                                          eos_tokens_id=(), device="cpu")
        assert spec == ar and rate == 1.0


BATCHER = dict(num_slots=2, gamma=3, max_prompt_len=32, max_new_tokens=GEN,
               eos_tokens_id=(), device="cpu")


@pytest.mark.parametrize("kw", [
    None, dict(), dict(prefix_caching=True, prefill_chunk=8),
    dict(drafter_paged=True, prefix_caching=True, prefill_chunk=8)],
    ids=["slotted", "default", "prefix+chunked", "both-paged-prefix+chunked"])
def test_batchers_over_int8_match_greedy_ar(serve_models, kw):
    """The slotted batcher and the default engine over int8 KV (int8 pools
    for the paged target, and for the drafter when both are paged) give
    every request greedy AR's tokens with acceptance 1.0, with prefix
    caching and chunked prefill too; prompts sharing a 16-token prefix
    cross pages and chunks, and every page comes home."""
    cfg, params, _ = serve_models
    rng = np.random.default_rng(9)
    shared = [int(x) for x in rng.integers(1, VOCAB, size=16)]
    prompts = [shared + [int(x) for x in rng.integers(1, VOCAB, size=n)]
               for n in (5, 11, 2, 8)] + PROMPTS[:2]
    if kw is None:
        b = serve.ContinuousBatcher(cfg, params, cfg, params, **BATCHER)
    else:
        b = serve.PagedContinuousBatcher(cfg, params, cfg, params,
                                         page_size=PAGE, **BATCHER, **kw)
        assert isinstance(b.state.t_cache, tpc.QuantPagedKVCache)
    ids = [b.submit(p) for p in prompts]
    done = b.run()
    for rid, p in zip(ids, prompts):
        want = autoregressive_generate(p, cfg, params, max_gen_len=GEN,
                                       eos_tokens_id=(), device="cpu")
        assert done[rid].output_ids == want, f"request {rid}"
        assert done[rid].metrics.acceptance_rate == 1.0
    if kw:
        assert b.prefix_cache.hit_tokens > 0
    if kw is not None:
        assert len(b._alloc_t.free) + len(b.prefix_cache) == b.num_pages - 1
