"""Which attention a forward takes, decided from the config: the attention
kernels take head_dims up to 256 (gemma's), where a block's shared memory
holds bf16 q over bf16 or int8 K/V and f32 q over int8 K/V but not f32 q
over f32 K/V. What they do not take goes to the plain attention under
``attention_impl="flash"`` and to the gather path of the paged forward, as
the JAX dispatch sends what its kernel cannot hold to its XLA path. At
head_dim 256 the f32 forwards over f32 K/V reach no kernel wrapper and
forcing the paged kernel raises before any launch; over int8 K/V, and in
bf16, they reach the wrappers (whose CPU branch is the plain version).

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
def wrapper_calls(monkeypatch):
    """Every attention kernel wrapper counts its calls (in the returned
    dict, by name) and runs as before."""
    calls = {name: 0 for _, name in WRAPPERS}
    for module, name in WRAPPERS:
        def counted(*args, _name=name, _fn=getattr(module, name), **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray,
                        jm.init_params(JCFG, jax.random.key(0), scale=0.3))


@pytest.mark.parametrize("head_dim", [64, 128, 136, 256, 264])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_kernel_route_by_config(head_dim, kv_quant):
    """The predicate and the config route: 64 and 128 take the kernels in
    f32 and bf16, and so does 136 over K/V of q's type (int8 K/V take
    multiples of 16); 256 in bf16, and in f32 over int8 K/V only (f32 over
    f32 needs more shared memory than a block has); 264, past the cap, not
    at all; a softcap or f16 activations never do."""
    quant = kv_quant == "int8"
    for dtype in (torch.float32, torch.bfloat16):
        takes = {64: True, 128: True, 136: not quant,
                 256: quant or dtype == torch.bfloat16, 264: False}[head_dim]
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


def test_shared_bytes_at_head_dim_256():
    """A block's dynamic shared memory at head_dim 256 (the kernel's
    ``flash::layout``): bf16 q over bf16 and int8 K/V, f32 q over int8 K/V
    fit the H100's 232,448 bytes; f32 q over f32 K/V does not. bf16 q
    stages Q in 16 x (256 + 16) bf16 (8,704 bytes) over head_dim 128."""
    sb = attention_args.shared_bytes
    assert attention_args.MAX_HEAD_DIM == 256
    assert sb(256, torch.bfloat16, False) == 228_864
    assert sb(256, torch.bfloat16, True) == 164_352
    assert sb(256, torch.float32, True) == 176_896
    assert sb(256, torch.float32, False) == 372_480
    assert sb(128, torch.bfloat16, False) == 113_664  # no Q staged
    assert sb(256, torch.float32, False) > attention_args.MAX_SHARED_BYTES
    assert max(sb(256, torch.bfloat16, q) for q in (False, True)) <= (
        attention_args.MAX_SHARED_BYTES)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_head_dim_256_flash_forward_matches_jax(np_params, wrapper_calls,
                                                kv_quant):
    """The slotted forward under ``"flash"`` at Dh=256: prefill, decode and
    a verify after rollback on two sequences. f32 over f32 K/V reaches no
    kernel wrapper; over int8 K/V every layer of every step reaches K4's."""
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
    quant = kv_quant == "int8"
    # two forwards a step (the synced and the chained one), 3 steps
    assert wrapper_calls == {
        name: 6 * JCFG.num_layers if quant and name.endswith("_quant")
        and name.startswith("flash") else 0 for name in wrapper_calls}


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_head_dim_256_paged_forward_matches_jax(np_params, wrapper_calls,
                                                kv_quant):
    """``forward_step_paged(use_kernel=None)`` at Dh=256, across page
    boundaries and after rollback (JAX's paged forward takes its gather
    path on the CPU): f32 over f32 pools takes the gather path and
    ``use_kernel=True`` raises before any launch; over int8 pools every
    layer reaches K8b's wrapper, and ``use_kernel=True`` runs it too."""
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
    quant = kv_quant == "int8"
    # two kernel-route forwards a step (the synced and the chained one)
    assert wrapper_calls == {
        name: 6 * JCFG.num_layers
        if quant and name == "paged_decode_attention_quant_stacked" else 0
        for name in wrapper_calls}
    if not quant:
        with pytest.raises(ValueError, match="head_dim 256"):
            tm.forward_step_paged(cfg, params, t(toks), pcache,
                                  use_kernel=True)
        assert not any(wrapper_calls.values())
        return
    forced, _ = tm.forward_step_paged(cfg, params, t(toks),
                                      pcache.with_length(pcache.length - 5),
                                      use_kernel=True)
    assert torch.equal(forced, pl_)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_head_dim_256_bf16_reaches_the_kernels(np_params, wrapper_calls,
                                               kv_quant):
    """bf16 activations at Dh=256 take the kernels in both forwards: the
    slotted one under ``"flash"`` reaches K3's (K4's) wrapper and the
    paged one K8a's (K8b's) once a layer; on the CPU the wrappers compute
    the plain version, so the logits equal the plain paths' bit for
    bit."""
    cfg = port_config(JCFG, kv_quant=kv_quant,
                      attention_impl="flash").replace(dtype=torch.bfloat16)
    assert tm.kernel_route(cfg)
    params = params_from_numpy(np_params, "cpu")
    params = {k: ({n: w.to(torch.bfloat16) for n, w in v.items()}
                  if k == "layers" else v.to(torch.bfloat16))
              for k, v in params.items()}
    toks = t(np.random.default_rng(7).integers(0, 64, size=(2, 6)))
    B, MP = 2, 2
    flash, _ = tm.forward_step(cfg, params, toks,
                               tc.init_cache(cfg, B, 16, device="cpu"))
    plain, _ = tm.forward_step(cfg.replace(attention_impl="xla"), params,
                               toks, tc.init_cache(cfg, B, 16, device="cpu"))
    assert torch.equal(flash, plain)
    tables = t(np.arange(1, B * MP + 1, dtype=np.int32).reshape(B, MP))

    def paged(c, **kw):
        cache = dataclasses.replace(
            tpc.init_paged_cache(c, B, B * MP + 1, PAGE, MP, device="cpu"),
            page_table=tables)
        return tm.forward_step_paged(c, params, toks, cache, **kw)[0]
    assert torch.equal(paged(cfg), paged(cfg.replace(attention_impl="xla"),
                                         use_kernel=False))
    quant = kv_quant == "int8"
    slotted = ("flash_decode_attention_quant" if quant
               else "flash_decode_attention")
    pool = ("paged_decode_attention_quant_stacked" if quant
            else "paged_decode_attention_stacked")
    assert wrapper_calls == {
        name: JCFG.num_layers if name in (slotted, pool) else 0
        for name in wrapper_calls}
