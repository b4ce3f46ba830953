"""The port's INT4 quantization and its dequant-matmul wrappers, held
against the JAX package on the same numpy inputs.

The storage is bit-identical to JAX's. The plain matmul (what a wrapper
computes on a CPU tensor) computes the TPU kernel's function, so it is held
against the Pallas kernel itself, run in interpret mode as
tests/test_quant.py runs it, and against JAX's off-TPU dequantize path."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from specdec_tpu.ops.quant_matmul import _nf4_matmul_2d, _q4_matmul_stacked
from specdec_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from specdec_tpu.quant import core as jq

from specdec_tpu_torch.bridge import params_from_numpy, tensor_from_numpy
from specdec_tpu_torch.ops import quant_matmul as tq_ops
from specdec_tpu_torch.quant import core as tq

torch.set_num_threads(2)

# jitted JAX quantizer for tests that only need quantized inputs: one
# compile per shape instead of one per op. Bit-identity is checked against
# the eager quantizer, as the JAX package calls it: under jit, XLA turns the
# /7 of the scale into *(1/7), which can round one scale differently.
_jax_quantize_int4 = jax.jit(jq.quantize_int4)


def _weights(shape, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _to_np(a):
    """torch tensor (bf16 included) -> numpy, bit for bit."""
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view(np.uint16)
    return a.numpy()


def _jax_np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# (K, N): G = K/64 = 8 and 12 are block-major absmax, 3 and 5 natural order;
# stacked shapes quantize per layer as in the JAX package
@pytest.mark.parametrize("shape", [(512, 96), (768, 40), (192, 24),
                                   (320, 16), (3, 256, 48)])
def test_quantize_int4_bit_identical(shape):
    w = _weights(shape, seed=sum(shape))
    # spread the magnitudes so every code 1..15 (and bit 31 of the words)
    # occurs: codes >= 8 in the (p=3, h=1) nibble make negative int32 words
    w *= np.exp(np.random.default_rng(1).uniform(-3, 3, size=shape)
                ).astype(np.float32)
    ref = jq.quantize_int4(jnp.asarray(w))
    got = tq.quantize_int4(torch.from_numpy(w))
    assert got.packed.dtype == torch.int32
    assert got.absmax.dtype == torch.bfloat16
    np.testing.assert_array_equal(_to_np(got.packed), np.asarray(ref.packed))
    np.testing.assert_array_equal(_to_np(got.absmax), _jax_np(ref.absmax))
    assert (_to_np(got.packed) < 0).any()
    np.testing.assert_array_equal(
        tq.dequantize(got).numpy(), np.asarray(jax.jit(jq.dequantize)(ref)))


def test_pack_unpack_nibbles_round_trip():
    codes = np.random.default_rng(2).integers(0, 16, size=(2, 64, 24))
    words = tq._pack_nibbles(torch.from_numpy(codes))
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(jq._pack_nibbles(jnp.asarray(codes))))
    np.testing.assert_array_equal(tq._unpack_nibbles(words).numpy(), codes)


@pytest.mark.parametrize("M", [1, 5])
def test_plain_stacked_matches_pallas_interpret(M):
    """Port's plain quant_matmul_stacked == JAX's _q4_matmul_stacked in
    interpret mode, for every layer. Both round x to bf16, sum the products
    of each 64-row block in f32, scale the block sum and round the result to
    bf16; only the f32 summation order differs, so the two agree to one bf16
    rounding step (rtol 2**-7)."""
    L, K, N = 3, 512, 256
    w = _weights((L, K, N), seed=3)
    x = np.random.default_rng(4).standard_normal((M, K)).astype(np.float32)
    ref_w = _jax_quantize_int4(jnp.asarray(w))
    tw = params_from_numpy(jax.tree.map(np.asarray, ref_w), device="cpu")
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    for i in range(L):
        with pltpu.force_tpu_interpret_mode():
            ref = _q4_matmul_stacked(xb, ref_w.packed, ref_w.absmax,
                                     jnp.int32(i), 256, 512, codec="int4")
        got = tq_ops.quant_matmul_stacked(
            tensor_from_numpy(np.asarray(xb), "cpu"), tw, i)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("K,N", [(512, 96), (192, 40)])
def test_plain_matmul_matches_jax_offtpu(K, N):
    """Against JAX's off-TPU quant_matmul (dequantize to f32, then x @ w):
    the plain version rounds x and the output to bf16 as the kernel does,
    so the tolerance is test_quant.py's kernel-vs-oracle one (rtol 2e-2,
    atol 2e-1) and a relative Frobenius error of at most 1e-2. K=192 has
    natural-order absmax (G % 4 != 0)."""
    w = _weights((K, N), seed=K + N)
    x = np.random.default_rng(5).standard_normal((3, 4, K)).astype(np.float32)
    ref_w = _jax_quantize_int4(jnp.asarray(w))
    ref = np.asarray(jax.jit(jax_quant_matmul)(jnp.asarray(x), ref_w))
    tw = params_from_numpy(jax.tree.map(np.asarray, ref_w), device="cpu")
    got = tq.qmatmul(torch.from_numpy(x), tw)
    assert got.shape == (3, 4, N) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-1)
    assert np.linalg.norm(got - ref) <= 1e-2 * np.linalg.norm(ref)


@pytest.mark.parametrize("N", [1000, 1001])
@pytest.mark.parametrize("K", [512, 768])
def test_plain_matmul_ragged_shape(K, N):
    """The plain K1 at the ragged shapes the card checks: K = 768 (K % 512
    = 256) and N = 1000 (not a multiple of the kernel's column tiles) or
    the odd N = 1001 (its scalar loads and stores). The Pallas
    ``_nf4_matmul_2d(codec="int4")`` takes only K % 512 == 0, so at K = 512
    it is the reference (in interpret mode; it pads N to its tile), and at
    K = 768 the reference is ``_pair_tile``'s arithmetic in JAX: each
    64-row block's f32 dot of bf16 x with the weights code - 8, times the
    block's bf16 scale, summed over blocks and rounded to bf16. Only the f32
    summation order differs, so they agree to one bf16 rounding step."""
    w = _weights((K, N), seed=K + N)
    w *= np.exp(np.random.default_rng(9).uniform(-3, 3, size=(K, N))
                ).astype(np.float32)
    x = np.random.default_rng(10).standard_normal((5, K)).astype(np.float32)
    ref_w = _jax_quantize_int4(jnp.asarray(w))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if K % 512 == 0:
        with pltpu.force_tpu_interpret_mode():
            ref = _nf4_matmul_2d(xb, ref_w.packed, ref_w.absmax, tile_n=128,
                                 tile_k=512, codec="int4")
    else:
        G = K // 64
        wq = (jq._unpack_nibbles(ref_w.packed) - 8).astype(jnp.float32)
        am = jq._am_unpack(ref_w.absmax).astype(jnp.float32)     # [G, N]
        part = jnp.einsum("mgk,gkn->gmn",
                          xb.astype(jnp.float32).reshape(5, G, 64),
                          wq.reshape(G, 64, N),
                          precision=jax.lax.Precision.HIGHEST)
        ref = (part * am[:, None, :]).sum(axis=0).astype(jnp.bfloat16)
    tw = params_from_numpy(jax.tree.map(np.asarray, ref_w), device="cpu")
    got = tq_ops.int4_matmul(tensor_from_numpy(np.asarray(xb), "cpu"), tw)
    assert got.shape == (5, N) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_stacked_slice_reads_layer_in_place():
    w = _weights((2, 256, 32), seed=6)
    tw = tq.quantize_int4(torch.from_numpy(w))
    x = torch.from_numpy(
        np.random.default_rng(7).standard_normal((2, 256)).astype(np.float32))
    for i in range(2):
        layer = tq.Int4Weight(packed=tw.packed[i], absmax=tw.absmax[i])
        np.testing.assert_array_equal(
            tq.qmatmul(x, tq.StackedSlice(tw, i)).numpy(),
            tq.qmatmul(x, layer).numpy())


def test_cuda_less_default_device_raises():
    """device=None means the card; with no card the entry points raise
    instead of carrying on on the CPU."""
    from specdec_tpu_torch import resolve_device
    from specdec_tpu_torch.core.config import tiny_config
    from specdec_tpu_torch.core.model import init_params
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tensor_from_numpy(np.zeros(3, np.float32))


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A wrapper computes the plain version only for CPU tensors; any other
    device goes to the kernel's checks (here: not CUDA -> raise)."""
    w = tq.quantize_int4(torch.from_numpy(_weights((256, 32), seed=8)))
    meta_w = tq.Int4Weight(packed=w.packed.to("meta"),
                           absmax=w.absmax.to("meta"))
    x = torch.empty((1, 256), device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        tq_ops.quant_matmul(x, meta_w)
    stacked = tq.Int4Weight(packed=meta_w.packed[None],
                            absmax=meta_w.absmax[None])
    with pytest.raises(ValueError, match="not CUDA"):
        tq_ops.quant_matmul_stacked(x, stacked, 0)
    assert tq_ops.int4_matmul.launches == 0
    assert tq_ops.int4_matmul_stacked.launches == 0
