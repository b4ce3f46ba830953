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
JAX kernels' own tests (2e-5; 3e-5 for the int8 paged kernel)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from specdec_tpu.core.cache import quantize_kv_block
from specdec_tpu.ops import decode_attention as jda
from specdec_tpu.ops import paged_attention as jpa

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


@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_decode_plain_matches_jax_kernel(case, quant):
    B, T, Hq, Hk, Dh, S, offsets = FLASH_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    if quant:
        (kq, ks), (vq, vs) = (map(np.asarray, quantize_kv_block(
            jnp.asarray(a))) for a in (k, v))
        with pltpu.force_tpu_interpret_mode():
            ref = jda.flash_decode_attention_quant(
                jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks),
                jnp.asarray(vq), jnp.asarray(vs), jnp.asarray(off),
                num_kv_heads=Hk, tile_s=64)
        got = tda.flash_decode_attention_quant(t(q), t(kq), t(ks), t(vq),
                                               t(vs), t(off))
    else:
        with pltpu.force_tpu_interpret_mode():
            ref = jda.flash_decode_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(off), num_kv_heads=Hk, tile_s=64)
        got = tda.flash_decode_attention(t(q), t(k), t(v), t(off))
    assert got.shape == (B, T, Hq, Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLASH_TOL)


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
