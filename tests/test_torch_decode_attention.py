"""The plain versions of the port's flash-decode and int8 paged attention
kernels (what their wrappers compute on a CPU tensor) against the JAX
package's Pallas kernels in interpret mode, as tests/test_decode_attention.py
and tests/test_paged_quant.py run them.

K3 (``flash_decode_attention``) and K4 (``flash_decode_attention_quant``)
cover decode, gamma+1 verify, MHA, S not a multiple of the tile, mostly
dead tiles and a zero-offset prefill; K5 (``paged_decode_attention_quant``)
and K8b (its stacked form) cover decode and verify blocks over scrambled
int8 pools with mostly dead pages. Both sides are float32 and differ in
summation order only (online against dense softmax), and for int8 K/V in
where the v-scale meets the softmax's normalization: the tolerances of the
JAX kernels' own tests (2e-5; 3e-5 for the int8 paged kernel).

A NumPy model of the CUDA kernel's algorithm (``split_merge_model``: the
cache's 64-key tiles in spans over a cluster's blocks, each block's rows in
16-row tiles, four warps of 16 keys a tile, a partial (m, l, acc) per warp
and block, merged in rank order), over the slotted cache and through a page
table, is held against the same Pallas kernels and JAX's four paged ones,
so the CPU pins what the card runs; the wrappers' plain versions stay
``decode_attention_reference`` and ``paged_attention_reference``."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from specdec_tpu.core.cache import quantize_kv_block
from specdec_tpu.ops import decode_attention as jda
from specdec_tpu.ops import paged_attention as jpa

from specdec_tpu_torch.ops import attention_args as aa
from specdec_tpu_torch.ops import decode_attention as tda
from specdec_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
PAGED_QUANT_TOL = dict(rtol=3e-5, atol=3e-5)
PAGE = 8


def t(a):
    return torch.from_numpy(np.array(a))


# (B, T, Hq, Hk, Dh, S, offsets), the cases of tests/test_decode_attention.py
FLASH_CASES = {
    "decode": (2, 1, 8, 4, 16, 128, [37, 90]),
    "verify-gqa": (3, 5, 8, 2, 32, 192, [10, 64, 175]),
    "mha-unaligned-s": (1, 3, 4, 4, 16, 100, [50]),
    "prefill-zero-offset": (2, 8, 4, 2, 16, 64, [0, 0]),
    "dead-tiles": (2, 1, 8, 4, 16, 512, [40, 100]),
}


# the kernel's split at work: S = 1100 gives 6 spans of 3 tiles, all but
# the first two past every row's position; S = 1300 (7 spans of 3 tiles)
# with every row's keys inside span 0, its own span the only live one
SPLIT_CASES = {
    "dead-spans": (2, 2, 8, 4, 16, 1100, [200, 130]),
    "own-span-only": (2, 4, 4, 2, 32, 1300, [0, 60]),
}


def flash_inputs(case, cases):
    """The case's q, K/V (float32, and int8 with scales quantized by the JAX
    quantizer) and offsets, made from a seed with numpy."""
    B, T, Hq, Hk, Dh, S, offsets = cases[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)
    (kq, ks), (vq, vs) = (map(np.asarray, quantize_kv_block(jnp.asarray(a)))
                          for a in (k, v))
    return q, (k, v), (kq, ks, vq, vs), np.asarray(offsets, np.int32), Hk


def jax_flash(q, kv, quantized, off, Hk, quant):
    """The JAX package's Pallas kernel (interpret mode), float32."""
    with pltpu.force_tpu_interpret_mode():
        if quant:
            return np.asarray(jda.flash_decode_attention_quant(
                jnp.asarray(q), *map(jnp.asarray, quantized),
                jnp.asarray(off), num_kv_heads=Hk, tile_s=64))
        return np.asarray(jda.flash_decode_attention(
            jnp.asarray(q), *map(jnp.asarray, kv), jnp.asarray(off),
            num_kv_heads=Hk, tile_s=64))


@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_decode_plain_matches_jax_kernel(case, quant):
    q, kv, quantized, off, Hk = flash_inputs(case, FLASH_CASES)
    ref = jax_flash(q, kv, quantized, off, Hk, quant)
    if quant:
        kq, ks, vq, vs = quantized
        got = tda.flash_decode_attention_quant(t(q), t(kq), t(ks), t(vq),
                                               t(vs), t(off))
    else:
        got = tda.flash_decode_attention(t(q), *map(t, kv), t(off))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **FLASH_TOL)


def split(S):
    """The kernel's spans over a cache of capacity S (``flash::span_of``,
    ``flash::clusters_of`` in ``csrc/flash_decode.cuh``): (span, C), C
    spans of ``span`` consecutive 64-key tiles, span the fewest that let
    C <= MAX_CLUSTER cover S."""
    tiles = -(-S // aa.TILE)
    span = -(-tiles // aa.MAX_CLUSTER)
    return span, -(-tiles // span)


def split_merge_model(q, k, v, off, k_scale=None, v_scale=None, table=None):
    """The CUDA kernel's algorithm (``csrc/flash_decode.cuh``) in float32
    NumPy, over the slotted cache (k/v [B, S, Hk, Dh], scales [B, S, Hk])
    or, with ``table`` [B, MP], over page pools (k/v [NP, Hk, page, Dh],
    scales [NP, Hk, page]) of capacity S = MP * page. Per (b, h) and 16-row
    tile of the T*G rows, the 64-key tiles of S are cut into C spans
    (``split``); for each span up to the tile of the rows' largest position
    last_pos, warp w owns keys 16w .. 16w + 15 of each tile and keeps its
    own online softmax (masked probabilities exactly 0; keys, values and
    scales past last_pos read as zeros, and the table entries of their
    pages are not read: the model raises on an entry past the row tile's
    last live page); the warps' partials are merged in warp order into the
    span's partial, and the span partials are combined in span order by
    the online rule from the empty state (-1e30, 0, 0)."""
    B, T, Hq, Dh = q.shape
    Hk = k.shape[-3] if table is not None else k.shape[2]
    S = table.shape[1] * k.shape[2] if table is not None else k.shape[1]
    G, TG = Hq // Hk, T * Hq // Hk
    span, C = split(S)
    keys_per_warp = aa.TILE // aa.WARPS
    scale = np.float32(1.0) / np.sqrt(np.float32(Dh))
    neg = np.float32(-1e30)
    out = np.zeros_like(q)

    def rows(a, b, h, pos, last_pos):
        """a's rows (K, V or a scale) of positions ``pos`` of sequence b,
        head h, zero past last_pos."""
        got = np.zeros((len(pos),) + a.shape[3:], np.float32)
        live = pos <= last_pos
        if table is None:
            got[live] = a[b, pos[live], h]
            return got
        page = a.shape[2]
        lp = pos[live] // page
        if lp.size and lp.max() > last_pos // page:
            raise IndexError(f"table entry {lp.max()} read past the row "
                             f"tile's last live page {last_pos // page}")
        got[live] = a[table[b, lp], h, pos[live] % page]
        return got

    for b in range(B):
        for h in range(Hk):
            rows_q = q[b, :, h * G:(h + 1) * G].reshape(TG, Dh)
            for r0 in range(0, TG, aa.ROWS):
                qr = rows_q[r0:r0 + aa.ROWS]
                q_pos = off[b] + np.arange(r0, r0 + len(qr)) // G
                last_pos = min(int(q_pos.max()), S - 1)
                last = last_pos // aa.TILE
                m_run = np.full(len(qr), neg, np.float32)
                l_run = np.zeros(len(qr), np.float32)
                acc_run = np.zeros((len(qr), Dh), np.float32)
                for c in range(last // span + 1):
                    parts = []
                    for w in range(aa.WARPS):
                        m = np.full(len(qr), neg, np.float32)
                        l = np.zeros(len(qr), np.float32)
                        acc = np.zeros((len(qr), Dh), np.float32)
                        for tile in range(c * span,
                                          min(c * span + span, last + 1)):
                            pos = (tile * aa.TILE + w * keys_per_warp
                                   + np.arange(keys_per_warp))
                            kt = rows(k, b, h, pos, last_pos)
                            vt = rows(v, b, h, pos, last_pos)
                            s = (qr @ kt.T) * scale
                            if k_scale is not None:
                                s = s * rows(k_scale, b, h, pos,
                                             last_pos)[None]
                            live = (pos[None] <= q_pos[:, None]) & (pos < S)
                            s = np.where(live, s, neg)
                            m_new = np.maximum(m, s.max(1))
                            alpha = np.exp(m - m_new)
                            p = np.where(live, np.exp(s - m_new[:, None]), 0)
                            l = l * alpha + p.sum(1)
                            if v_scale is not None:
                                p = p * rows(v_scale, b, h, pos,
                                             last_pos)[None]
                            acc = acc * alpha[:, None] + p @ vt
                            m = m_new
                        parts.append((m, l, acc))
                    # the span's partial: the warps' in warp order
                    m_c = np.max([pm for pm, _, _ in parts], axis=0)
                    l_c = np.zeros_like(m_c)
                    acc_c = np.zeros((len(qr), Dh), np.float32)
                    for pm, pl, pa in parts:
                        wt = np.exp(pm - m_c)
                        l_c = l_c + wt * pl
                        acc_c = acc_c + wt[:, None] * pa
                    # combined into the running state, in span order
                    m_new = np.maximum(m_run, m_c)
                    ca, cb = np.exp(m_run - m_new), np.exp(m_c - m_new)
                    l_run = l_run * ca + l_c * cb
                    acc_run = acc_run * ca[:, None] + acc_c * cb[:, None]
                    m_run = m_new
                o = acc_run / np.maximum(l_run, np.float32(1e-38))[:, None]
                for i, r in enumerate(range(r0, r0 + len(qr))):
                    out[b, r // G, h * G + r % G] = o[i]
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("case", list(FLASH_CASES) + list(SPLIT_CASES))
def test_kernel_split_and_merge_matches_jax_kernel(case, quant):
    """The kernel's split over a cluster and its merge, modelled in NumPy,
    give the Pallas kernel's result within its test's tolerance; whole
    spans past every row's position add nothing and cause no NaN."""
    cases = {**FLASH_CASES, **SPLIT_CASES}
    q, kv, quantized, off, Hk = flash_inputs(case, cases)
    ref = jax_flash(q, kv, quantized, off, Hk, quant)
    if quant:
        kq, ks, vq, vs = quantized
        got = split_merge_model(q, kq, vq, off, ks, vs)
    else:
        got = split_merge_model(q, *kv, off)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **FLASH_TOL)


@pytest.mark.parametrize("S", [1, 64, 65, 334, 394, 960, 961, 1100, 2048,
                               8192])
def test_split_covers_the_cache_in_one_cluster(S):
    """Spans of whole tiles, at most MAX_CLUSTER blocks, each owning at
    least one tile, together every tile of S; the fewest tiles per span
    that allow it."""
    span, C = split(S)
    tiles = -(-S // aa.TILE)
    assert 1 <= C <= aa.MAX_CLUSTER
    assert (C - 1) * span < tiles <= C * span
    assert span == 1 or -(-tiles // (span - 1)) > aa.MAX_CLUSTER


@pytest.mark.parametrize("wrapper", [tda, tpa], ids=["flash", "paged"])
@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_shared_memory_fits_every_head_dim(dtype, quant, wrapper):
    """Every head_dim a wrapper takes (the slotted one, and the paged one on
    the same kernel body) fits one block of the kernel in the card's
    shared memory, by the formula that wrapper checks with, and every
    head_dim up to MAX_HEAD_DIM that fits is taken: all of them but f32 q
    over f32 K/V past 152 (at 256, 372,480 bytes)."""
    step = 16 if quant else 8
    dims = range(step, aa.MAX_HEAD_DIM + 1, step)
    sizes = [wrapper.shared_bytes(dh, dtype, quant) for dh in dims]
    assert all(n > 0 for n in sizes) and sizes == sorted(sizes)
    for dh, n in zip(dims, sizes):
        fits = n <= aa.MAX_SHARED_BYTES
        assert aa.kernel_takes(dh, dtype, quant) == fits
        assert fits == (quant or dtype == torch.bfloat16 or dh <= 152)


# the paged layout of the kernel model: pages of 8 and 16 (several to a
# 64-key tile), 64 (the serving engine's, a tile a page) and 128 (half a
# page a tile); a table width of PAGED_S positions (9 tiles: spans of 2,
# C = 5); offsets at a page's end and at a page's start, in different spans
PAGED_S = 576
POISON = 2 ** 30
PAGED_KERNELS = ["K2", "K5", "K8a", "K8b"]


def paged_inputs(page, T):
    """q, float32 pools [L, NP, Hk, page, Dh] and their int8 quantization
    (by the JAX quantizer), a scrambled table [B, MP] whose entries past
    each sequence's last live page hold POISON, and offsets: made from a
    seed with numpy."""
    rng = np.random.default_rng(page * 100 + T)
    B, Hq, Hk, Dh, L, MP = 2, 4, 2, 16, 2, PAGED_S // page
    NP = B * MP + 1
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((L, NP, Hk, page, Dh)).astype(np.float32)
            for _ in range(2))
    (kq, ks), (vq, vs) = (map(np.asarray, quantize_kv_block(jnp.asarray(a)))
                          for a in (k, v))
    off = np.asarray([-(-200 // page) * page - 1, 448 // page * page],
                     np.int32)
    table = (rng.permutation(NP - 1)[:B * MP].reshape(B, MP) + 1
             ).astype(np.int32)
    last_page = (off + T - 1) // page
    table[np.arange(MP)[None] > last_page[:, None]] = POISON
    return q, (k, v), (kq, ks, vq, vs), table, off, Hk


def jax_paged(kernel, q, kv, quantized, table, off, Hk, layer=1):
    """JAX's paged kernel (interpret mode), float32: K2 and K5 on layer
    ``layer`` of the pools, K8a and K8b reading it from the stacks."""
    args = [jnp.asarray(a) for a in (table, off)]
    lid = jnp.int32(layer)
    with pltpu.force_tpu_interpret_mode():
        if kernel == "K2":
            out = jpa.paged_decode_attention(
                jnp.asarray(q), *(jnp.asarray(a[layer]) for a in kv), *args,
                Hk)
        elif kernel == "K8a":
            out = jpa.paged_decode_attention_stacked(
                jnp.asarray(q), *map(jnp.asarray, kv), lid, *args, Hk)
        elif kernel == "K5":
            out = jpa.paged_decode_attention_quant(
                jnp.asarray(q), *(jnp.asarray(a[layer]) for a in quantized),
                *args, Hk)
        else:
            out = jpa.paged_decode_attention_quant_stacked(
                jnp.asarray(q), *map(jnp.asarray, quantized), lid, *args, Hk)
    return np.asarray(out)


@pytest.mark.parametrize("kernel", PAGED_KERNELS)
@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("page", [8, 16, 64, 128])
def test_kernel_model_paged_matches_jax_kernels(page, T, kernel):
    """The kernel model over the paged layout against JAX's four paged
    kernels (interpret mode), tiles of 64 keys whatever the page, spans
    fixed by the table's width, offsets at page ends and starts; table
    entries past a row tile's last live page are never read (the model
    raises if it touches one, and past each sequence's last live page they
    hold an out-of-range page)."""
    q, kv, quantized, table, off, Hk = paged_inputs(page, T)
    ref = jax_paged(kernel, q, kv, quantized, table, off, Hk)
    layer = 1
    if kernel in ("K5", "K8b"):
        kq, ks, vq, vs = (a[layer] for a in quantized)
        got = split_merge_model(q, kq, vq, off, ks, vs, table=table)
        tol = PAGED_QUANT_TOL
    else:
        got = split_merge_model(q, kv[0][layer], kv[1][layer], off,
                                table=table)
        tol = FLASH_TOL
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **tol)


def test_kernel_model_raises_on_reading_a_poisoned_entry():
    """A POISON entry that the model reads makes it raise: so the paged
    cases above, whose entries past each sequence's last live page hold
    POISON, show that it reads none of them."""
    q, kv, _, table, off, _ = paged_inputs(16, 9)
    table = table.copy()
    table[0, off[0] // 16] = POISON
    with pytest.raises(IndexError):
        split_merge_model(q, kv[0][1], kv[1][1], off, table=table)


@pytest.mark.parametrize("quant", [False, True], ids=["K3-K8a", "K4-K8b"])
@pytest.mark.parametrize("T", [1, 9])
def test_kernel_model_paged_equals_slotted_bit_for_bit(T, quant):
    """Over the same keys laid out in pages of 64 with MP = ceil(S / 64),
    the paged model's result is the slotted model's bit for bit: the same
    tiles, so the same spans and the same sums (phase 3c of chip_smoke.py
    holds the kernels K3 == K8a and K4 == K8b so)."""
    page, S = 64, PAGED_S - 16
    MP = -(-S // page)
    rng = np.random.default_rng(17 + T)
    B, Hq, Hk, Dh = 2, 4, 2, 16
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)
            for _ in range(2))
    off = np.asarray([130, S - T], np.int32)
    table = (rng.permutation(B * MP).reshape(B, MP) + 1).astype(np.int32)

    def pool(a):   # [B, S, Hk, ...] -> [B * MP + 1, Hk, page, ...]
        pad = np.zeros((B, MP * page) + a.shape[2:], a.dtype)
        pad[:, :S] = a
        pages = np.swapaxes(pad.reshape(B, MP, page, *a.shape[2:]), 2, 3)
        out = np.zeros((B * MP + 1,) + pages.shape[2:], a.dtype)
        out[table] = pages
        return out

    if quant:
        (kq, ks), (vq, vs) = (map(np.asarray,
                                  quantize_kv_block(jnp.asarray(a)))
                              for a in (k, v))
        slotted = split_merge_model(q, kq, vq, off, ks, vs)
        paged = split_merge_model(q, pool(kq), pool(vq), off, pool(ks),
                                  pool(vs), table=table)
    else:
        slotted = split_merge_model(q, k, v, off)
        paged = split_merge_model(q, pool(k), pool(v), off, table=table)
    np.testing.assert_array_equal(paged, slotted)


@pytest.mark.parametrize("T,offsets", [(1, [13, 27]), (3, [5, 20]),
                                       (3, [0, 2 * PAGE])],
                         ids=["T1", "T3", "T3-page-start"])
def test_quant_paged_plain_matches_jax_kernels(T, offsets):
    """K5 on a 4D int8 pool and K8b on layer 1 of int8 stacks against
    JAX's ``paged_decode_attention_quant`` and its stacked form (interpret
    mode); the stacked wrapper equals the 4D one on that layer bit for
    bit."""
    rng = np.random.default_rng(7 + T)
    B, Hq, Hk, Dh, L, NP, MP = 2, 4, 2, 16, 3, 11, 4
    kq, vq = (rng.integers(-127, 128, size=(L, NP, Hk, PAGE, Dh)
                           ).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.03, size=(L, NP, Hk, PAGE)
                          ).astype(np.float32) for _ in range(2))
    table = (rng.permutation(NP - 1)[:B * MP].reshape(B, MP) + 1
             ).astype(np.int32)
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    layer = 1
    args = [jnp.asarray(a) for a in (table, off)]
    with pltpu.force_tpu_interpret_mode():
        ref = jpa.paged_decode_attention_quant(
            jnp.asarray(q), jnp.asarray(kq[layer]), jnp.asarray(ks[layer]),
            jnp.asarray(vq[layer]), jnp.asarray(vs[layer]), *args, Hk)
        ref_stacked = jpa.paged_decode_attention_quant_stacked(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks),
            jnp.asarray(vq), jnp.asarray(vs), jnp.int32(layer), *args, Hk)
    got = tpa.paged_decode_attention_quant(
        t(q), t(kq[layer]), t(ks[layer]), t(vq[layer]), t(vs[layer]),
        t(table), t(off))
    stacked = tpa.paged_decode_attention_quant_stacked(
        t(q), t(kq), t(ks), t(vq), t(vs), layer, t(table), t(off))
    assert got.shape == (B, T, Hq, Dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **PAGED_QUANT_TOL)
    np.testing.assert_allclose(stacked.numpy(), np.asarray(ref_stacked),
                               **PAGED_QUANT_TOL)
    assert torch.equal(stacked, got)
    with pytest.raises(IndexError):
        tpa.paged_decode_attention_quant_stacked(
            t(q), t(kq), t(ks), t(vq), t(vs), L, t(table), t(off))


def test_plain_flash_and_paged_agree_over_the_same_keys():
    """The slotted and paged plain versions attend the same int8 keys the
    same way: a sequence's pages laid out contiguously give K4's result."""
    rng = np.random.default_rng(11)
    B, T, Hq, Hk, Dh, MP = 2, 3, 4, 2, 16, 3
    kq, vq = (rng.integers(-127, 128, size=(B * MP + 1, Hk, PAGE, Dh)
                           ).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.1, size=(B * MP + 1, Hk, PAGE)
                          ).astype(np.float32) for _ in range(2))
    table = np.arange(1, B * MP + 1, dtype=np.int32).reshape(B, MP)
    q = t(rng.standard_normal((B, T, Hq, Dh)).astype(np.float32))
    off = t(np.asarray([4, 17], np.int32))
    paged = tpa.paged_decode_attention_quant(q, t(kq), t(ks), t(vq), t(vs),
                                             t(table), off)

    def slotted(a):   # [NP, Hk, page, ...] -> [B, MP * page, Hk, ...]
        a = t(a)[t(table).long()]
        return a.transpose(2, 3).reshape(B, MP * PAGE, *a.shape[2:3],
                                         *a.shape[4:])

    flash = tda.flash_decode_attention_quant(q, slotted(kq), slotted(ks),
                                             slotted(vq), slotted(vs), off)
    torch.testing.assert_close(flash, paged, rtol=1e-6, atol=1e-6)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers compute the plain version and launch no
    kernel, so their launch counts stay put."""
    wrappers = (tda.flash_decode_attention, tda.flash_decode_attention_quant,
                tpa.paged_decode_attention_quant,
                tpa.paged_decode_attention_quant_stacked)
    before = [w.launches for w in wrappers]
    q = torch.randn(1, 2, 4, 16)
    kv = torch.randn(1, 20, 2, 16)
    kq = torch.randint(-127, 128, (1, 20, 2, 16), dtype=torch.int8)
    sc = torch.rand(1, 20, 2)
    off = torch.tensor([5], dtype=torch.int32)
    tda.flash_decode_attention(q, kv, kv, off)
    tda.flash_decode_attention_quant(q, kq, sc, kq, sc, off)
    pool = torch.randint(-127, 128, (2, 3, 2, PAGE, 16), dtype=torch.int8)
    psc = torch.rand(2, 3, 2, PAGE)
    table = torch.tensor([[2, 1]], dtype=torch.int32)
    tpa.paged_decode_attention_quant(q, pool[0], psc[0], pool[0], psc[0],
                                     table, off)
    tpa.paged_decode_attention_quant_stacked(q, pool, psc, pool, psc, 1,
                                             table, off)
    assert [w.launches for w in wrappers] == before
