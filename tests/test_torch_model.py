"""The port's forward_step against the JAX package's, on the same params.

Params are made by the JAX package, carried over with
``bridge.params_from_numpy``, and fed to both with the same tokens. Each
case runs a prefill, a one-token decode, a gamma+1 verify block and a
forward after ``rolled_back``, on two sequences at different offsets, and
compares the f32 logits and the cache lengths after every step."""
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

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core import cache as tc
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.quant import core as tq

torch.set_num_threads(2)

FAMILIES = {
    "llama": dict(),
    "qwen3": dict(qk_norm=True, attn_qkv_bias=True),
    "neox": dict(norm_type="layernorm", act="gelu", gated_mlp=False,
                 parallel_residual=True, rotary_pct=0.25, attn_qkv_bias=True,
                 attn_out_bias=True, mlp_bias=True,
                 rope_scaling=("linear", 2.0)),
    "gemma": dict(act="gelu_tanh", embed_scale=8.0, tie_embeddings=True,
                  logit_softcap=5.0, num_kv_heads=1,
                  rope_scaling=("llama3", 8.0, 1.0, 4.0, 64)),
}


def port_config(cfg) -> ModelConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ModelConfig(**dict(kw, dtype=torch.float32))


def make_params(cfg, seed):
    """JAX init_params plus numpy noise on the biases and norm weights (the
    JAX init leaves them at 0 and 1, which would hide a missing term)."""
    params = jax.tree.map(np.asarray,
                          jm.init_params(cfg, jax.random.key(seed), scale=0.3))
    rng = np.random.default_rng(seed)

    def perturb(d):
        for k, v in d.items():
            if isinstance(v, dict):
                perturb(v)
            elif k.startswith("b") or "norm" in k:
                d[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(params)
    return params


def f32_close(got, ref):
    """Both sides run in f32 and differ only in summation order."""
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def bf16_close(got, ref):
    """For models whose matmuls round to bf16 (the INT4 kernel's output):
    a different f32 summation order can move a value across a bf16 rounding
    boundary, and later layers carry that step on. Measured on this test:
    relative Frobenius error <= 0.8%, elementwise <= 2**-6.5 * max|ref|.
    A layout or scale error gives O(1) errors."""
    assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2 ** -5 * np.abs(ref).max())


def run_both(cfg, jparams, tparams, close=f32_close, Ts=(8, 1, 5, 2)):
    """Prefill Ts[0] (lengths then set to Ts[0] and Ts[0]-2), decode Ts[1],
    verify Ts[2], roll back 3, forward Ts[3]; compares logits with
    ``close`` and the lengths exactly."""
    tcfg = port_config(cfg)
    step = jax.jit(jm.forward_step, static_argnums=0)
    rng = np.random.default_rng(11)
    B, S = 2, 32
    jcache = jc.init_cache(cfg, B, S)
    tcache = tc.init_cache(tcfg, B, S, device="cpu")

    def both(tokens, jcache, tcache):
        jl, jcache = step(cfg, jparams, jnp.asarray(tokens), jcache)
        tl, tcache = tm.forward_step(tcfg, tparams, torch.from_numpy(tokens),
                                     tcache)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        close(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tcache.length.numpy(),
                                      np.asarray(jcache.length))
        return jcache, tcache

    def toks(T):
        return rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)

    jcache, tcache = both(toks(Ts[0]), jcache, tcache)
    lengths = np.asarray([Ts[0], Ts[0] - 2], np.int32)
    jcache = jcache.with_length(jnp.asarray(lengths))
    tcache = tcache.with_length(torch.from_numpy(lengths))
    for T in Ts[1:3]:
        jcache, tcache = both(toks(T), jcache, tcache)
    jcache, tcache = jcache.rolled_back(3), tcache.rolled_back(3)
    both(toks(Ts[3]), jcache, tcache)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_step_matches_jax(family):
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_heads=4, num_kv_heads=2, head_dim=8)
    cfg = tiny_config(**dict(kw, **FAMILIES[family]))
    params = make_params(cfg, seed=len(family))
    run_both(cfg, jax.tree.map(jnp.asarray, params),
             params_from_numpy(params, device="cpu"))


def test_forward_full_matches_jax():
    cfg = tiny_config(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_heads=4, num_kv_heads=2, head_dim=8)
    params = make_params(cfg, seed=3)
    tokens = np.random.default_rng(3).integers(0, 64, (2, 7)).astype(np.int32)
    ref = jm.forward_full(cfg, jax.tree.map(jnp.asarray, params),
                          jnp.asarray(tokens))
    got = tm.forward_full(port_config(cfg), params_from_numpy(params, "cpu"),
                          torch.from_numpy(tokens))
    f32_close(got.numpy(), np.asarray(ref))


def test_int4_forward_matches_pallas_path(monkeypatch):
    """An INT4 model (quantize_params(int4, fuse=True)) at hidden 512, so
    every projection's absmax is block-major. Each side quantizes the same
    dense params itself (test_torch_quant.py holds the containers bit for
    bit). The JAX side is forced onto its Pallas kernels (interpret mode),
    which compute the function the port's plain version computes: bf16 x,
    f32 block sums, a bf16 result. Logits agree to bf16's tolerance
    (``bf16_close``). The blocks are 5, 1, 5, 5 tokens long: each new
    length costs the JAX side an interpret-mode compile."""
    cfg = tiny_config(vocab_size=256, hidden_size=512, intermediate_size=1024,
                      num_heads=8, num_kv_heads=2, head_dim=64)
    dense = make_params(cfg, seed=7)
    ref_q = jax.jit(lambda p: jq.quantize_params(p, kind="int4", fuse=True))(
        jax.tree.map(jnp.asarray, dense))
    got_q = tq.quantize_params(params_from_numpy(dense, "cpu"), kind="int4",
                               fuse=True)
    assert set(got_q["layers"]) == set(ref_q["layers"])
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        got_w, ref_w = got_q["layers"][name], ref_q["layers"][name]
        assert isinstance(got_w, tq.Int4Weight)
        assert tuple(got_w.packed.shape) == ref_w.packed.shape
        assert tuple(got_w.absmax.shape) == ref_w.absmax.shape
    monkeypatch.setattr(jax_qm, "_use_pallas", lambda w: True)
    with pltpu.force_tpu_interpret_mode():
        run_both(cfg, ref_q, got_q, close=bf16_close, Ts=(5, 1, 5, 5))
