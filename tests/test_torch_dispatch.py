"""Which attention a forward takes, decided from the config: a head_dim
the attention kernels do not take (above 128, as gemma's 256) goes to the
plain attention under ``attention_impl="flash"`` and to the gather path of
the paged forward, as the JAX dispatch sends what its kernel cannot hold
to its XLA path. At head_dim 256 both forwards reach no kernel wrapper
(each is patched to raise); forcing the paged kernel raises before any
launch; head_dims 64 and 128 still take the kernel.

Each step's logits are JAX's at f32 tolerance, from the same cache state:
the port's forward runs on a copy of JAX's cache as it stood before the
step. Over int8 KV the two packages quantize K/V that differ in f32
summation order, and at head_dim 256 a value can land on the other side
of a rounding boundary (one int8 step), which a later step would read; so
the port's own chained cache is held to JAX's stored values within that
one step, and its logits, bit for bit, to the port's plain path over the
same quantized state."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import cache as jc
from specdec_tpu.core import model as jm
from specdec_tpu.core import paged_cache as jpc
from specdec_tpu.core.config import tiny_config

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core import cache as tc
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core import paged_cache as tpc
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.ops import attention_args
from specdec_tpu_torch.ops import decode_attention as tda
from specdec_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

PAGE = 8
# both sides f32, differing in summation order only (tests/test_torch_paged.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = tiny_config(vocab_size=64, num_layers=2, hidden_size=64,
                   intermediate_size=128, num_heads=2, num_kv_heads=1,
                   head_dim=256)
WRAPPERS = ((tda, "flash_decode_attention"),
            (tda, "flash_decode_attention_quant"),
            (tpa, "paged_decode_attention"),
            (tpa, "paged_decode_attention_stacked"),
            (tpa, "paged_decode_attention_quant"),
            (tpa, "paged_decode_attention_quant_stacked"))


def port_config(cfg, **kw) -> ModelConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ModelConfig(**dict(fields, dtype=torch.float32, **kw))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def no_kernels(monkeypatch):
    """Every attention kernel wrapper raises if it is called."""
    def refuse(*args, **kwargs):
        raise AssertionError("an attention kernel wrapper was reached")
    for module, name in WRAPPERS:
        monkeypatch.setattr(module, name, refuse)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray,
                        jm.init_params(JCFG, jax.random.key(0), scale=0.3))


@pytest.mark.parametrize("head_dim,takes", [(64, True), (128, True),
                                            (256, False), (136, False)])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_kernel_route_by_config(head_dim, takes, kv_quant):
    """The predicate and the config route: 64 and 128 take the kernels in
    f32 and bf16, 256 and 136 (past the cap) do not; a softcap or f16
    activations never do."""
    quant = kv_quant == "int8"
    for dtype in (torch.float32, torch.bfloat16):
        assert attention_args.kernel_takes(head_dim, dtype, quant) == takes
        cfg = port_config(JCFG, head_dim=head_dim, kv_quant=kv_quant,
                          attention_impl="flash").replace(dtype=dtype)
        assert tm.kernel_route(cfg) == takes
        assert not tm.kernel_route(cfg.replace(logit_softcap=5.0))
    assert not attention_args.kernel_takes(head_dim, torch.float16, quant)
    assert not attention_args.kernel_takes(72 if quant else 68,
                                           torch.float32, quant)


def bridged(pcache, jcache):
    """The port's cache holding JAX's cache state."""
    return dataclasses.replace(pcache, **{
        f.name: t(getattr(jcache, f.name))
        for f in dataclasses.fields(pcache)})


def check_step(kv_quant, got, plain, synced, ref, cache, jcache):
    """One step: the logits ``synced`` (the port's forward on JAX's cache
    before the step) against JAX's ``ref``; the logits ``got`` of the
    port's chained cache against JAX's (K/V in the model's dtype) or, bit
    for bit, against the port's plain path ``plain`` (int8 KV), whose
    stored int8 values must equal JAX's but for single-step flips."""
    np.testing.assert_allclose(synced.numpy(), np.asarray(ref), **LOGIT_TOL)
    if kv_quant == "none":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   **LOGIT_TOL)
        return
    assert torch.equal(got, plain)
    for name in ("k", "v"):
        diff = np.abs(getattr(cache, name).numpy().astype(np.int32)
                      - np.asarray(getattr(jcache, name)).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_head_dim_256_flash_forward_matches_jax(np_params, no_kernels,
                                                kv_quant):
    """The slotted forward under ``"flash"`` at Dh=256: prefill, decode and
    a verify after rollback on two sequences."""
    jcfg = JCFG.replace(kv_quant=kv_quant, attention_impl="flash")
    cfg = port_config(jcfg)
    plain_cfg = cfg.replace(attention_impl="xla")
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    step = jax.jit(jm.forward_step, static_argnums=0)
    rng = np.random.default_rng(5)
    B, S = 2, 24
    jcache = jc.init_cache(jcfg, B, S)
    pcache = tc.init_cache(cfg, B, S, device="cpu")
    plain = tc.init_cache(cfg, B, S, device="cpu")
    for T, lengths in ((7, None), (1, [7, 4]), (5, [6, 8])):
        if lengths is not None:
            jcache = jcache.with_length(jnp.asarray(lengths, jnp.int32))
            pcache = pcache.with_length(t(np.asarray(lengths, np.int32)))
            plain = plain.with_length(t(np.asarray(lengths, np.int32)))
        toks = rng.integers(0, 64, size=(B, T)).astype(np.int32)
        sl, _ = tm.forward_step(cfg, params, t(toks),
                                bridged(pcache, jcache))
        jl, jcache = step(jcfg, jparams, jnp.asarray(toks), jcache)
        pl_, pcache = tm.forward_step(cfg, params, t(toks), pcache)
        ref, plain = tm.forward_step(plain_cfg, params, t(toks), plain)
        check_step(kv_quant, pl_, ref, sl, jl, pcache, jcache)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_head_dim_256_paged_forward_matches_jax(np_params, no_kernels,
                                                kv_quant):
    """``forward_step_paged(use_kernel=None)`` at Dh=256 takes the gather
    path, across page boundaries and after rollback (JAX's paged forward
    takes its gather path on the CPU); ``use_kernel=True`` raises before
    any launch."""
    jcfg = JCFG.replace(kv_quant=kv_quant)
    cfg = port_config(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    rng = np.random.default_rng(6)
    B, MP = 2, 4
    NP = B * MP + 2
    tables = rng.permutation(np.arange(1, NP))[:B * MP].reshape(B, MP)
    tables = tables.astype(np.int32)
    jcache = dataclasses.replace(jpc.init_paged_cache(jcfg, B, NP, PAGE, MP),
                                 page_table=jnp.asarray(tables))
    pcache, plain = (dataclasses.replace(
        tpc.init_paged_cache(cfg, B, NP, PAGE, MP, device="cpu"),
        page_table=t(tables)) for _ in range(2))
    for T, lengths in ((11, None), (1, [11, 6]), (5, [9, 12])):
        if lengths is not None:
            jcache = jcache.with_length(jnp.asarray(lengths, jnp.int32))
            pcache = pcache.with_length(t(np.asarray(lengths, np.int32)))
            plain = plain.with_length(t(np.asarray(lengths, np.int32)))
        toks = rng.integers(0, 64, size=(B, T)).astype(np.int32)
        sl, _ = tm.forward_step_paged(cfg, params, t(toks),
                                      bridged(pcache, jcache))
        jl, jcache = jm.forward_step_paged(jcfg, jparams, jnp.asarray(toks),
                                           jcache)
        pl_, pcache = tm.forward_step_paged(cfg, params, t(toks), pcache)
        ref, plain = tm.forward_step_paged(cfg, params, t(toks), plain,
                                           use_kernel=False)
        check_step(kv_quant, pl_, ref, sl, jl, pcache, jcache)
    with pytest.raises(ValueError, match="head_dim 256"):
        tm.forward_step_paged(cfg, params, t(toks), pcache, use_kernel=True)
