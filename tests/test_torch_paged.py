"""The port's paged KV cache, paged attention and paged forward against the
JAX package's, on the same numpy inputs.

Pool writes and installs must store bit-identical pools (both packages keep
the head-major [L, NP, Hk, page, Dh] layout). The paged attention kernel's
plain version (what its wrapper computes on a CPU tensor) is held against
JAX's Pallas kernel run in interpret mode, as tests/test_paged_cache.py
runs it, and the paged forward against JAX's paged forward and the port's
own slotted forward, in f32."""
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
from specdec_tpu.ops import paged_attention as jpa

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core import cache as tc
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core import paged_cache as tpc
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

PAGE = 8
# f32 on both sides, differing only in summation order (the tolerance of
# tests/test_paged_cache.py for the kernel against its gather oracle, and
# of tests/test_torch_model.py for logits)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def port_config(cfg) -> ModelConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ModelConfig(**dict(kw, dtype=torch.float32))


def t(a):
    return torch.from_numpy(np.array(a))


def scrambled_tables(rng, B, MP, NP, finished=()):
    """[B, MP] int32 tables over pages 1..NP-1, shuffled; rows in
    ``finished`` point at garbage page 0."""
    pages = rng.permutation(np.arange(1, NP))[:B * MP]
    tables = pages.reshape(B, MP).astype(np.int32)
    for b in finished:
        tables[b] = 0
    return tables


@pytest.mark.parametrize("offsets", [[6, 13, 2], [0, 21, 9]],
                         ids=["page-boundary", "table-end"])
def test_write_block_paged_stacked_bit_equal(offsets):
    """Writes at every layer of the stacks, across a page boundary (offset
    6, T=3 reaches slots 6, 7 of one page and 0 of the next), with the last
    slot finished (its row is garbage page 0): the stored pools equal
    JAX's bit for bit."""
    rng = np.random.default_rng(1)
    L, NP, Hk, Dh, B, T, MP = 3, 10, 2, 16, 3, 3, 3
    k = rng.standard_normal((L, NP, Hk, PAGE, Dh)).astype(np.float32)
    v = rng.standard_normal((L, NP, Hk, PAGE, Dh)).astype(np.float32)
    tables = scrambled_tables(rng, B, MP, NP, finished=(2,))
    off = np.asarray(offsets, np.int32)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    pk, pv = t(k), t(v)
    for layer in range(L):
        nk = rng.standard_normal((B, T, Hk, Dh)).astype(np.float32)
        nv = rng.standard_normal((B, T, Hk, Dh)).astype(np.float32)
        jk, jv = jpc.write_block_paged_stacked(
            jk, jv, jnp.int32(layer), jnp.asarray(nk), jnp.asarray(nv),
            jnp.asarray(tables), jnp.asarray(off), PAGE)
        tpc.write_block_paged_stacked(pk, pv, layer, t(nk), t(nv),
                                      t(tables), t(off), PAGE)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_write_past_table_goes_to_garbage_page():
    """A position whose logical page lies past the table (or before it, a
    finished slot's drafter offset of -1) lands on page 0 instead of
    faulting; live pages are untouched."""
    Hk, Dh = 2, 4
    pool = torch.zeros((5, Hk, PAGE, Dh))
    table = torch.tensor([[3, 1]], dtype=torch.int32)
    blk = torch.ones((1, 3, Hk, Dh))
    for off in (15, -1):
        pool.zero_()
        tpc.write_block_paged(pool, pool.clone(), blk, blk, table,
                              torch.tensor([off], dtype=torch.int32), PAGE)
        assert pool[1:].sum() == (1 if off == 15 else 2) * Hk * Dh
        assert pool[0].sum() == (2 if off == 15 else 1) * Hk * Dh


def test_install_sequence_pages_bit_equal():
    """The dense admission's install: a batch-of-one slotted scratch cache
    scattered through a table row into every layer's pool, positions past
    the allocated pages on garbage page 0."""
    rng = np.random.default_rng(2)
    L, NP, Hk, Dh, S, MP = 2, 9, 2, 16, 30, 5
    cfg = tiny_config(num_layers=L, num_kv_heads=Hk, head_dim=Dh,
                      num_heads=2 * Hk)
    pools = [rng.standard_normal((L, NP, Hk, PAGE, Dh)).astype(np.float32)
             for _ in range(2)]
    rows = [rng.standard_normal((L, 1, S, Hk, Dh)).astype(np.float32)
            for _ in range(2)]
    row = np.asarray([7, 2, 5, 0, 0], np.int32)   # 3 pages allocated
    jcache = jpc.PagedKVCache(
        k=jnp.asarray(pools[0]), v=jnp.asarray(pools[1]),
        page_table=jnp.zeros((1, MP), jnp.int32),
        length=jnp.zeros((1,), jnp.int32))
    jscratch = jc.KVCache(k=jnp.asarray(rows[0]), v=jnp.asarray(rows[1]),
                          length=jnp.zeros((1,), jnp.int32))
    ref = jpc.install_sequence_pages(jcache, jnp.asarray(row), jscratch)
    pcache = tpc.init_paged_cache(port_config(cfg), 1, NP, PAGE, MP,
                                  device="cpu")
    pcache.k.copy_(t(pools[0]))
    pcache.v.copy_(t(pools[1]))
    scratch = tc.KVCache(k=t(rows[0]), v=t(rows[1]),
                         length=torch.zeros(1, dtype=torch.int32))
    tpc.install_sequence_pages(pcache, t(row), scratch)
    np.testing.assert_array_equal(pcache.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(pcache.v.numpy(), np.asarray(ref.v))


def test_install_and_zero_slot_bit_equal():
    """The slotted admission primitives: copy a batch-of-one cache into a
    batch row and zero a row, setting that row's length; the port's edit in
    place must leave the source cache unaliased."""
    rng = np.random.default_rng(6)
    L, B, S, Hk, Dh = 2, 3, 10, 2, 4
    dst = [rng.standard_normal((L, B, S, Hk, Dh)).astype(np.float32)
           for _ in range(2)]
    src = [rng.standard_normal((L, 1, S, Hk, Dh)).astype(np.float32)
           for _ in range(2)]
    lens = np.asarray([3, 5, 7], np.int32)
    jdst = jc.KVCache(k=jnp.asarray(dst[0]), v=jnp.asarray(dst[1]),
                      length=jnp.asarray(lens))
    jsrc = jc.KVCache(k=jnp.asarray(src[0]), v=jnp.asarray(src[1]),
                      length=jnp.zeros((1,), jnp.int32))
    pdst = tc.KVCache(k=t(dst[0]), v=t(dst[1]), length=t(lens))
    psrc = tc.KVCache(k=t(src[0]), v=t(src[1]),
                      length=torch.zeros(1, dtype=torch.int32))
    ref = jc.zero_slot(jc.install_slot(jdst, jsrc, jnp.int32(1),
                                       jnp.int32(9)), jnp.int32(2),
                       jnp.int32(0))
    got = tc.zero_slot(tc.install_slot(pdst, psrc, 1, 9), 2, 0)
    for name in ("k", "v", "length"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert pdst.length.tolist() == lens.tolist()   # old length untouched
    psrc.k.zero_()
    assert got.k[:, 1].abs().sum() > 0             # rows were copied


def test_gather_pages_and_allocator_match_jax():
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((7, 2, PAGE, 4)).astype(np.float32)
    tables = np.asarray([[3, 1, 6], [0, 5, 2]], np.int32)
    np.testing.assert_array_equal(
        tpc.gather_pages(t(pool), t(tables)).numpy(),
        np.asarray(jpc.gather_pages(jnp.asarray(pool), jnp.asarray(tables))))

    ops = [("alloc", "a", 3), ("alloc", "b", 2), ("disown", "a", None),
           ("free", "b", None), ("alloc", "c", 4), ("free", "a", None)]
    allocs = (jpc.PageAllocator(10), tpc.PageAllocator(10))
    for op, owner, n in ops:
        got = []
        for a in allocs:
            if op == "alloc":
                got.append(a.alloc(owner, n))
            elif op == "disown":
                a.disown(owner, a.owned[owner][1])
            else:
                a.free_owner(owner)
        assert got == [] or got[0] == got[1]
        assert allocs[0].free == allocs[1].free
        assert allocs[0].owned == allocs[1].owned
    for a in allocs:
        with pytest.raises(MemoryError):
            a.alloc("z", 100)
    for n in (0, 1, 8, 9, 17):
        assert tpc.required_pages(n, PAGE) == jpc.required_pages(n, PAGE)


@pytest.mark.parametrize("T,offsets", [(1, [5, 20]), (9, [3, 30])],
                         ids=["T1", "T9"])
def test_paged_attention_plain_matches_jax_kernel(T, offsets):
    """The kernel's plain version against JAX's Pallas kernel (interpret
    mode) with mostly dead pages (live keys in the first 1-4 of 6 logical
    pages), and K8a (a layer of the stacks) against K2 on that layer."""
    rng = np.random.default_rng(4)
    B, Hq, Hk, Dh, L, NP, MP = 2, 8, 4, 16, 3, 13, 6
    ks = rng.standard_normal((L, NP, Hk, PAGE, Dh)).astype(np.float32)
    vs = rng.standard_normal((L, NP, Hk, PAGE, Dh)).astype(np.float32)
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    tables = scrambled_tables(rng, B, MP, NP)
    off = np.asarray(offsets, np.int32)
    layer = 1
    with pltpu.force_tpu_interpret_mode():
        ref = jpa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(ks[layer]), jnp.asarray(vs[layer]),
            jnp.asarray(tables), jnp.asarray(off), Hk)
    got = tpa.paged_decode_attention(t(q), t(ks[layer]), t(vs[layer]),
                                     t(tables), t(off))
    assert got.shape == (B, T, Hq, Dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)
    stacked = tpa.paged_decode_attention_stacked(t(q), t(ks), t(vs), layer,
                                                 t(tables), t(off))
    assert torch.equal(stacked, got)
    with pytest.raises(IndexError):
        tpa.paged_decode_attention_stacked(t(q), t(ks), t(vs), L,
                                           t(tables), t(off))


def test_paged_attention_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers compute the plain version and launch no
    kernel, so their launch counts stay put."""
    before = (tpa.paged_decode_attention.launches,
              tpa.paged_decode_attention_stacked.launches)
    q = torch.randn(1, 1, 4, 8)
    pool = torch.randn(2, 3, 2, PAGE, 8)
    table = torch.zeros((1, 2), dtype=torch.int32)
    off = torch.tensor([3], dtype=torch.int32)
    tpa.paged_decode_attention(q, pool[0], pool[0], table, off)
    tpa.paged_decode_attention_stacked(q, pool, pool, 1, table, off)
    assert (tpa.paged_decode_attention.launches,
            tpa.paged_decode_attention_stacked.launches) == before


FAMILIES = {
    "llama": dict(),
    "gemma-softcap": dict(act="gelu_tanh", embed_scale=8.0,
                          tie_embeddings=True, logit_softcap=5.0),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_step_paged_matches_jax_and_slotted(family):
    """Prefill, one-token decode, a gamma+1 verify across page boundaries
    and a forward after rollback, on two sequences at different offsets:
    logits equal JAX's paged forward (its kernel in interpret mode for the
    llama model; softcap models take the gather path in both packages) and
    the port's slotted forward, and the stored pools equal JAX's."""
    jcfg = tiny_config(vocab_size=64, num_layers=2, hidden_size=64,
                       intermediate_size=128, num_heads=8, num_kv_heads=4,
                       head_dim=8, **FAMILIES[family])
    cfg = port_config(jcfg)
    np_params = jax.tree.map(
        np.asarray, jm.init_params(jcfg, jax.random.key(0), scale=0.3))
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    use_kernel = jcfg.logit_softcap == 0.0
    rng = np.random.default_rng(5)
    B, MP = 2, 6
    NP = B * MP + 3
    tables = scrambled_tables(rng, B, MP, NP)

    jcache = dataclasses.replace(
        jpc.init_paged_cache(jcfg, B, NP, PAGE, MP, dtype=jnp.float32),
        page_table=jnp.asarray(tables))
    pcache = dataclasses.replace(
        tpc.init_paged_cache(cfg, B, NP, PAGE, MP, device="cpu"),
        page_table=t(tables))
    scache = tc.init_cache(cfg, B, MP * PAGE, device="cpu")

    def step(toks, lengths=None):
        nonlocal jcache, pcache, scache
        if lengths is not None:
            jcache = jcache.with_length(jnp.asarray(lengths, jnp.int32))
            pcache = pcache.with_length(t(np.asarray(lengths, np.int32)))
            scache = scache.with_length(t(np.asarray(lengths, np.int32)))
        with pltpu.force_tpu_interpret_mode():
            jl, jcache = jm.forward_step_paged(
                jcfg, jparams, jnp.asarray(toks), jcache,
                use_kernel=use_kernel)
        pl_, pcache = tm.forward_step_paged(cfg, params, t(toks), pcache)
        sl, scache = tm.forward_step(cfg, params, t(toks), scache)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(pl_.numpy(), sl.numpy(), **LOGIT_TOL)
        np.testing.assert_array_equal(pcache.length.numpy(),
                                      np.asarray(jcache.length))

    step(rng.integers(0, 64, size=(B, 12)).astype(np.int32))
    step(rng.integers(0, 64, size=(B, 1)).astype(np.int32), lengths=[12, 7])
    step(rng.integers(0, 64, size=(B, 5)).astype(np.int32))
    step(rng.integers(0, 64, size=(B, 2)).astype(np.int32),
         lengths=(pcache.length - 2).tolist())
    np.testing.assert_allclose(pcache.k.numpy(), np.asarray(jcache.k),
                               **LOGIT_TOL)
    np.testing.assert_allclose(pcache.v.numpy(), np.asarray(jcache.v),
                               **LOGIT_TOL)


def test_forward_step_paged_use_kernel_argument():
    """``use_kernel=True`` forces the kernel (a softcap model raises, since
    the kernel has no softcap); ``False`` gathers; both agree on a plain
    model."""
    cfg = port_config(tiny_config(vocab_size=32, num_layers=1))
    params = tm.init_params(cfg, seed=0, scale=0.3, device="cpu")
    toks = torch.tensor([[3, 5, 7]])

    def run(use_kernel, c=cfg):
        cache = tpc.init_paged_cache(c, 1, 4, PAGE, 3, device="cpu")
        cache.page_table[0] = torch.tensor([2, 1, 3])
        return tm.forward_step_paged(c, params, toks, cache,
                                     use_kernel=use_kernel)[0]

    torch.testing.assert_close(run(True), run(False), **LOGIT_TOL)
    with pytest.raises(ValueError, match="softcap"):
        run(True, cfg.replace(logit_softcap=5.0))
