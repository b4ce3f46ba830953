"""The port's INT8, NF4 and FP4 weight formats and their dequant-matmul
wrappers (kernels K6 and K7), held against the JAX package on the same
numpy inputs.

Storage is bit-identical to the eager JAX quantizers. The plain matmuls
(what a wrapper computes on a CPU tensor) compute the TPU kernels'
function, so they are held against the Pallas kernels themselves, run in
interpret mode as tests/test_quant.py runs them, and against JAX's off-TPU
dequantize path; models in each format are held to JAX's forward and to
the greedy oracles."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.ops.quant_matmul import (
    _int8_matmul_2d, _nf4_matmul_2d, _q4_matmul_stacked,
)
from specdec_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from specdec_tpu.quant import core as jq

from specdec_tpu_torch import serve
from specdec_tpu_torch.bridge import params_from_numpy, tensor_from_numpy
from specdec_tpu_torch.core import cache as tc
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.ops import quant_matmul as tq_ops
from specdec_tpu_torch.quant import core as tq
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate
from specdec_tpu_torch.sampling.speculative import speculative_generate

torch.set_num_threads(2)

KINDS = ("int8", "nf4", "fp4")
CONTAINER = {"int8": tq.Int8Weight, "nf4": tq.NF4Weight, "fp4": tq.FP4Weight}
# the Pallas half-plane kernel's tolerance against the plain version: both
# use the same bf16 weights and round x and y to bf16; only the f32
# summation order differs, so they agree to one bf16 rounding step
KERNEL_TOL = dict(rtol=2 ** -7, atol=1e-6)


def _weights(shape, seed, scale=0.1, spread=False):
    """Normal weights; with ``spread``, magnitudes spread over e^±3 (so
    every code and bit 31 of the words occur) and an all-zero column (the
    1e-12 floor of the scale)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape) * scale
    if spread:
        w *= np.exp(rng.uniform(-3, 3, size=shape))
        w[..., 0] = 0.0
    return w.astype(np.float32)


def _bits(a):
    """torch tensor or numpy array (bf16 included) -> numpy, bit for bit."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a
                ).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _fields(w):
    return {f.name: getattr(w, f.name) for f in dataclasses.fields(w)}


# (K, N): G = K/64 = 8 block-major absmax, 3 natural order; a stack of 3
@pytest.mark.parametrize("shape", [(512, 96), (192, 24), (3, 256, 48)])
@pytest.mark.parametrize("kind", KINDS)
def test_quantizer_bit_identical(kind, shape):
    w = _weights(shape, seed=sum(shape), spread=True)
    ref = getattr(jq, f"quantize_{kind}")(jnp.asarray(w))
    got = getattr(tq, f"quantize_{kind}")(torch.from_numpy(w))
    assert type(got) is CONTAINER[kind]
    ref_f = _fields(ref)
    for name, t in _fields(got).items():
        assert t.dtype == {"q": torch.int8, "scale": torch.float32,
                           "packed": torch.int32,
                           "absmax": torch.bfloat16}[name]
        np.testing.assert_array_equal(_bits(t), _bits(ref_f[name]))
    if kind != "int8":
        assert (_bits(got.packed) < 0).any()
    np.testing.assert_array_equal(
        tq.dequantize(got).numpy(), np.asarray(jax.jit(jq.dequantize)(ref)))


@pytest.mark.parametrize("fn", ["_nf4_decode_bits", "_fp4_decode_bits",
                                "_nf4_decode", "_fp4_decode"])
def test_decoders_match_jax_on_all_codes(fn):
    codes = np.arange(16, dtype=np.int32)
    got = getattr(tq, fn)(torch.from_numpy(codes))
    assert got.dtype == torch.float32
    ref = np.asarray(getattr(jq, fn)(jnp.asarray(codes)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))


@pytest.mark.parametrize("codec", ["nf4", "fp4"])
def test_kernel_nf4_table_is_the_bf16_codebook(codec):
    """The CUDA kernel's decode tables (bf16 bit patterns written into the
    source): NF4's equals the halves of ``_NF4_WORDS``; FP4's equals
    ``_fp4_decode_bits`` of codes 0..15 rounded to bf16 (exact: every e2m1
    value is a bf16)."""
    src = (Path(tq_ops.__file__).parent / "csrc" /
           "q4_halfplane_matmul.cu").read_text()
    name = {"nf4": "kNF4Bits", "fp4": "kFP4Bits"}[codec]
    table = re.search(name + r"\[16\] = \{([^}]*)\}", src).group(1)
    got = [int(v, 16) for v in re.findall(r"0x[0-9A-Fa-f]+", table)]
    if codec == "nf4":
        want = [h for w in tq._NF4_WORDS for h in (w & 0xFFFF, w >> 16)]
    else:
        vals = tq._fp4_decode_bits(torch.arange(16, dtype=torch.int32))
        assert torch.equal(vals.to(torch.bfloat16).float(), vals)
        want = (vals.to(torch.bfloat16).view(torch.int16).to(torch.int32)
                & 0xFFFF).tolist()
    assert got == want


@pytest.mark.parametrize("codec", ["nf4", "fp4"])
def test_plain_halfplane_matches_pallas_interpret(codec):
    """The plain K6 (2D wrapper on CPU tensors) against the Pallas
    ``_halfplane_kernel`` in interpret mode."""
    K, N = 512, 128
    w = _weights((K, N), seed=21, scale=0.05)
    x = np.random.default_rng(22).standard_normal((3, K)).astype(np.float32)
    ref_w = getattr(jq, f"quantize_{codec}")(jnp.asarray(w))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = _nf4_matmul_2d(xb, ref_w.packed, ref_w.absmax, tile_n=128,
                             tile_k=512, codec=codec)
    tw = params_from_numpy(jax.tree.map(np.asarray, ref_w), device="cpu")
    got = tq_ops.q4_halfplane_matmul(tensor_from_numpy(np.asarray(xb), "cpu"),
                                     tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **KERNEL_TOL)


@pytest.mark.parametrize("K", [512, 768])
@pytest.mark.parametrize("codec", ["nf4", "fp4"])
def test_plain_halfplane_ragged_shape(codec, K):
    """The plain K6 at N = 1000 (not a multiple of the kernel's column
    tiles) and K = 768 (K % 512 = 256), a ragged shape the card checks.
    The Pallas ``_nf4_matmul_2d`` takes only K % 512 == 0, so at K = 512 it
    is the reference (in interpret mode; it pads N to its tile), and at
    K = 768 the reference is its tile's arithmetic in JAX: each weight the
    decode (``_nf4_decode_bits`` / ``_fp4_decode_bits``, as
    ``_halfplane_kernel`` takes it) times its scale, rounded to bf16, and
    an f32 dot with bf16 x."""
    _check_plain_halfplane_ragged(codec, K, 1000)


@pytest.mark.parametrize("K", [512, 768])
@pytest.mark.parametrize("codec", ["nf4", "fp4"])
def test_plain_halfplane_ragged_odd_n(codec, K):
    """As ``test_plain_halfplane_ragged_shape`` at N = 1001, the odd N on
    which the card's kernel takes its scalar loads and stores."""
    _check_plain_halfplane_ragged(codec, K, 1001)


def _check_plain_halfplane_ragged(codec, K, N):
    w = _weights((K, N), seed=K, scale=0.05, spread=True)
    x = np.random.default_rng(28).standard_normal((5, K)).astype(np.float32)
    ref_w = getattr(jq, f"quantize_{codec}")(jnp.asarray(w))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if K % 512 == 0:
        with pltpu.force_tpu_interpret_mode():
            ref = _nf4_matmul_2d(xb, ref_w.packed, ref_w.absmax, tile_n=128,
                                 tile_k=512, codec=codec)
    else:
        decode = {"nf4": jq._nf4_decode_bits, "fp4": jq._fp4_decode_bits}
        wq = jq._dequant4(ref_w, decode[codec], jnp.bfloat16).astype(
            jnp.float32)
        ref = jnp.dot(xb.astype(jnp.float32), wq,
                      precision=jax.lax.Precision.HIGHEST).astype(jnp.bfloat16)
    tw = params_from_numpy(jax.tree.map(np.asarray, ref_w), device="cpu")
    got = tq_ops.q4_halfplane_matmul(tensor_from_numpy(np.asarray(xb), "cpu"),
                                     tw)
    assert got.shape == (5, N) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **KERNEL_TOL)


@pytest.mark.parametrize("codec", ["nf4", "fp4"])
def test_plain_halfplane_stacked_matches_pallas_interpret(codec):
    """The plain K6 on each layer of a stack (``quant_matmul_stacked``)
    against the Pallas ``_halfplane_kernel_stacked`` in interpret mode."""
    L, K, N = 2, 512, 128
    w = _weights((L, K, N), seed=23, scale=0.05)
    x = np.random.default_rng(24).standard_normal((2, K)).astype(np.float32)
    ref_w = getattr(jq, f"quantize_{codec}")(jnp.asarray(w))
    tw = params_from_numpy(jax.tree.map(np.asarray, ref_w), device="cpu")
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    for i in range(L):
        with pltpu.force_tpu_interpret_mode():
            ref = _q4_matmul_stacked(xb, ref_w.packed, ref_w.absmax,
                                     jnp.int32(i), 128, 512, codec=codec)
        got = tq_ops.quant_matmul_stacked(
            tensor_from_numpy(np.asarray(xb), "cpu"), tw, i)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **KERNEL_TOL)


@pytest.mark.parametrize("K,N", [(160, 100), (1000, 1000), (1001, 1004)])
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_plain_int8_matches_pallas_interpret(stacked, K, N):
    """The plain K7 against the Pallas ``_int8_kernel`` in interpret mode
    (K and N not multiples of the tiles: the JAX side pads), also at the
    ragged shapes chip_smoke.py runs the CUDA kernel at (K % 256 != 0, N %
    32 = 8; an odd K). The stacked wrapper reads layer 1 of a stack; JAX
    runs its kernel on that slice."""
    w = _weights((2, K, N), seed=25)
    x = np.random.default_rng(26).standard_normal((3, K)).astype(np.float32)
    ref_w = jq.quantize_int8(jnp.asarray(w))
    tw = params_from_numpy(jax.tree.map(np.asarray, ref_w), device="cpu")
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = _int8_matmul_2d(xb, ref_w.q[1], ref_w.scale[1], tile_n=128,
                              tile_k=128)
    xt = tensor_from_numpy(np.asarray(xb), "cpu")
    got = (tq_ops.int8_matmul_stacked(xt, tw, 1) if stacked else
           tq_ops.int8_matmul(xt, tq.Int8Weight(q=tw.q[1], scale=tw.scale[1])))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **KERNEL_TOL)


@pytest.mark.parametrize("K,N", [(512, 96), (192, 40)])
@pytest.mark.parametrize("kind", KINDS)
def test_qmatmul_matches_jax_offtpu(kind, K, N):
    """``qmatmul`` against JAX's off-TPU ``quant_matmul`` (the f32 codebook
    and scale applied before an f32 dot): the port rounds x, the weights
    (NF4/FP4) and the output to bf16 as the kernels do, so the tolerance is
    the bf16 level of tests/test_quant.py (rtol 2e-2, atol 2e-1) and a
    relative Frobenius error of at most 1e-2. K=192 has natural-order
    absmax (G % 4 != 0)."""
    w = _weights((K, N), seed=K + N)
    x = np.random.default_rng(27).standard_normal((3, 4, K)).astype(np.float32)
    ref_w = getattr(jq, f"quantize_{kind}")(jnp.asarray(w))
    ref = np.asarray(jax.jit(jax_quant_matmul)(jnp.asarray(x), ref_w))
    tw = params_from_numpy(jax.tree.map(np.asarray, ref_w), device="cpu")
    got = tq.qmatmul(torch.from_numpy(x), tw)
    assert got.shape == (3, 4, N) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-1)
    assert np.linalg.norm(got - ref) <= 1e-2 * np.linalg.norm(ref)


JCFG = tiny_config(vocab_size=64, num_layers=2, hidden_size=256,
                   intermediate_size=512, num_heads=4, num_kv_heads=2,
                   head_dim=64)
CFG = ModelConfig(**{**{f.name: getattr(JCFG, f.name)
                        for f in dataclasses.fields(JCFG)},
                     "dtype": torch.float32})


def _dense(scale):
    """The tiny model's dense params (numpy), made by the JAX package."""
    return jax.tree.map(np.asarray,
                        jm.init_params(JCFG, jax.random.key(3), scale=scale))


@pytest.fixture(scope="module")
def dense():
    return _dense(0.3)


@pytest.mark.parametrize("kind", KINDS)
def test_bridge_carries_quantized_params(kind, dense):
    """JAX ``quantize_params(kind, fuse=True)`` through ``params_from_numpy``
    gives the port's containers, bit for bit, and equals the port's own
    quantization of the same dense params."""
    ref = jax.tree.map(np.asarray, jq.quantize_params(
        jax.tree.map(jnp.asarray, dense), kind=kind, fuse=True))
    got = params_from_numpy(ref, "cpu")
    mine = tq.quantize_params(params_from_numpy(dense, "cpu"), kind=kind,
                              fuse=True)
    names = ("wqkv", "wo", "w_gateup", "w_down")
    for name, w in [(n, got["layers"][n]) for n in names] + [
            ("lm_head", got["lm_head"])]:
        assert type(w) is CONTAINER[kind]
        r = ref["layers"][name] if name in names else ref["lm_head"]
        m = mine["layers"][name] if name in names else mine["lm_head"]
        for f, t in _fields(w).items():
            np.testing.assert_array_equal(_bits(t), _bits(getattr(r, f)))
            np.testing.assert_array_equal(_bits(t), _bits(getattr(m, f)))


def bf16_close(got, ref):
    """Logits of models whose matmuls round to bf16 (the port's kernels)
    against JAX's off-TPU path (f32 dequantized weights, f32 dots): the
    rounding steps of each projection carry through the layers, so the
    tolerance is tests/test_torch_model.py's bf16 one. A layout or scale
    error gives O(1) errors."""
    assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2 ** -5 * np.abs(ref).max())


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(kind):
    """Prefill 6 tokens, then decode 1, on two sequences: the port's
    forward (every projection and the lm_head through the plain kernels,
    read in place from the stacks) against JAX's jitted forward on the same
    quantized params. Weights at scale 1/sqrt(D), so each layer keeps the
    activations' scale and the rounding steps do not grow through it."""
    jparams = jq.quantize_params(
        jax.tree.map(jnp.asarray, _dense(JCFG.hidden_size ** -0.5)),
        kind=kind, fuse=True)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    step = jax.jit(jm.forward_step, static_argnums=0)
    from specdec_tpu.core import cache as jc
    jcache = jc.init_cache(JCFG, 2, 16)
    tcache = tc.init_cache(CFG, 2, 16, device="cpu")
    rng = np.random.default_rng(5)
    for T in (6, 1):
        toks = rng.integers(0, 64, size=(2, T)).astype(np.int32)
        jl, jcache = step(JCFG, jparams, jnp.asarray(toks), jcache)
        tl, tcache = tm.forward_step(CFG, tparams, torch.from_numpy(toks),
                                     tcache)
        bf16_close(tl.numpy(), np.asarray(jl))


@pytest.fixture(scope="module")
def quantized(dense):
    """kind -> the port's tiny model quantized in that format."""
    return {kind: tq.quantize_params(params_from_numpy(dense, "cpu"),
                                     kind=kind, fuse=True)
            for kind in ("int8", "nf4")}


PROMPTS = [[5, 9, 33, 2, 41, 7], [1, 2, 3], [60, 61, 7, 7, 7, 12, 40, 3, 9]]


@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_greedy_self_draft_equals_ar(kind, quantized):
    """Greedy self-draft speculation equals greedy AR with acceptance 1.0:
    the verify's rows go through the same plain kernels as AR's one row."""
    target = quantized[kind]
    kw = dict(eos_tokens_id=(), device="cpu")
    ar = autoregressive_generate(PROMPTS[0], CFG, target, max_gen_len=24,
                                 **kw)
    spec, rate = speculative_generate(PROMPTS[0], CFG, target, CFG, target,
                                      gamma=5, max_gen_len=24, **kw)
    assert spec == ar
    assert rate == 1.0


@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_default_batcher_equals_ar(kind, quantized):
    """The default serving engine (paged target, slotted drafter,
    self-draft, greedy) gives every request greedy AR's tokens with
    acceptance 1.0, and returns every page."""
    target = quantized[kind]
    b = serve.DefaultBatcher(CFG, target, CFG, target, num_slots=2, gamma=3,
                             max_prompt_len=16, max_new_tokens=10,
                             page_size=8, eos_tokens_id=(), device="cpu")
    ids = [b.submit(p) for p in PROMPTS]
    done = b.run()
    for rid, p in zip(ids, PROMPTS):
        ar = autoregressive_generate(p, CFG, target, max_gen_len=10,
                                     eos_tokens_id=(), device="cpu")
        assert done[rid].output_ids == ar
        assert done[rid].metrics.acceptance_rate == 1.0
    assert len(b._alloc_t.free) == b.num_pages - 1


@pytest.mark.parametrize("kind,wrapper", [
    ("nf4", "q4_halfplane_matmul"), ("fp4", "q4_halfplane_matmul_stacked"),
    ("int8", "int8_matmul"), ("int8", "int8_matmul_stacked")])
def test_wrappers_raise_off_cuda_without_launching(kind, wrapper):
    """A wrapper computes the plain version only for CPU tensors; a meta
    tensor goes to the kernel's checks, which raise (not CUDA), and the
    launch counter stays at 0."""
    stacked = wrapper.endswith("stacked")
    w = getattr(tq, f"quantize_{kind}")(torch.from_numpy(
        _weights((2, 256, 32) if stacked else (256, 32), seed=8)))
    meta_w = type(w)(**{f: t.to("meta") for f, t in _fields(w).items()})
    x = torch.empty((1, 256), device="meta")
    fn = getattr(tq_ops, wrapper)
    with pytest.raises(ValueError, match="not CUDA"):
        fn(x, meta_w, 1) if stacked else fn(x, meta_w)
    assert fn.launches == 0


def test_dispatch_by_container_type():
    """``quant_matmul`` and ``quant_matmul_stacked`` send each container to
    its kernel's wrapper (on CPU tensors: its plain version); a kernel
    wrapper refuses another format's container."""
    x = torch.from_numpy(
        np.random.default_rng(9).standard_normal((2, 256)).astype(np.float32))
    w = _weights((2, 256, 32), seed=10)
    for kind, fn in (("int8", tq_ops.int8_matmul_stacked),
                     ("nf4", tq_ops.q4_halfplane_matmul_stacked),
                     ("fp4", tq_ops.q4_halfplane_matmul_stacked),
                     ("int4", tq_ops.int4_matmul_stacked)):
        qw = getattr(tq, f"quantize_{kind}")(torch.from_numpy(w))
        np.testing.assert_array_equal(
            tq.qmatmul(x, tq.StackedSlice(qw, 1)).numpy(),
            fn(x, qw, 1).numpy())
    with pytest.raises(TypeError, match="Int8Weight"):
        tq_ops.q4_halfplane_matmul(x, tq.quantize_int8(torch.from_numpy(w[0])))
    with pytest.raises(TypeError, match="no quantized kernel"):
        tq_ops.quant_matmul(x, torch.from_numpy(w[0]))
