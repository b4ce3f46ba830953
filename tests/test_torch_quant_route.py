"""4-bit weights whose K the kernels do not take (K % 256 != 0), and the
serving batchers' bound on a request's new tokens.

The K1/K6 kernels read the absmax block-major, which needs K/64 % 4 == 0.
Other K (Qwen2-0.5B's hidden 896, a row-parallel shard of 1408 rows) go,
by their shape and before any launch, to ``dequant_matmul``: ``x @
dequantize(w)``, the JAX package's XLA route. It is held here to JAX's
``quant_matmul`` (which takes that route on the CPU), to the K1 plain
version, and, for a whole model at D=896, to JAX's ``forward_full``."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.ops import quant_matmul as jqm
from specdec_tpu.quant import core as jq

from specdec_tpu_torch.bridge import params_from_numpy, tensor_from_numpy
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.eagle import init_eagle_params
from specdec_tpu_torch.core.model import forward_full, init_params
from specdec_tpu_torch.ops import quant_matmul as tqm
from specdec_tpu_torch.quant import core as tq
from specdec_tpu_torch.serve import (
    ContinuousBatcher, EagleContinuousBatcher, NasdContinuousBatcher,
    PagedContinuousBatcher,
)

torch.set_num_threads(2)

KINDS = ("int4", "nf4", "fp4")


def _weight(K, N, seed, L=None):
    shape = (K, N) if L is None else (L, K, N)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.05


@pytest.mark.parametrize("K", [896, 1344])
@pytest.mark.parametrize("kind", KINDS)
def test_route_matches_jax(kind, K):
    """K = 896 (Qwen2-0.5B's hidden) and 1344 (21 blocks of 64): the
    containers are JAX's bit for bit, quant_matmul takes the dequant route
    (counted, not a kernel wrapper) and gives JAX's XLA product for bf16 x
    within two bf16 ulps; INT4's also agrees with K1's plain version, which
    reads the natural-order absmax of K/64 % 4 != 0."""
    w = _weight(K, 96, seed=K)
    jw = getattr(jq, f"quantize_{kind}")(jnp.asarray(w))
    tw = getattr(tq, f"quantize_{kind}")(torch.from_numpy(w))
    for f in dataclasses.fields(tw):
        np.testing.assert_array_equal(
            getattr(tw, f.name).view(torch.int16 if f.name == "absmax"
                                     else torch.int32).numpy(),
            np.asarray(getattr(jw, f.name)).view(
                np.int16 if f.name == "absmax" else np.int32))
    x = np.random.default_rng(1).standard_normal((5, K)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jqm.quant_matmul(jx, jw).astype(jnp.float32))
    tx = tensor_from_numpy(np.asarray(jx), "cpu")
    wrapper = tqm._wrappers(tw)[0]
    launches, calls = wrapper.launches, tqm.dequant_matmul.calls
    got = tqm.quant_matmul(tx, tw)
    assert tqm.dequant_matmul.calls == calls + 1
    assert wrapper.launches == launches
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7)
    if kind == "int4":
        plain = tqm.int4_matmul_reference(tx, tw.packed, tw.absmax)
        torch.testing.assert_close(got.float(), plain.float(), rtol=2 ** -6,
                                   atol=2 ** -6)


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_route_and_gradient(kind):
    """quant_matmul_stacked routes layer ``idx`` of a stack the same way
    (its value that of the layer's own container), and a gradient reaches
    x through the route: dy @ dequantize(w)ᵀ."""
    w = torch.from_numpy(_weight(896, 64, seed=3, L=2))
    tw = getattr(tq, f"quantize_{kind}")(w)
    one = type(tw)(*(getattr(tw, f.name)[1] for f in dataclasses.fields(tw)))
    x = torch.randn((3, 896), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    got = tqm.quant_matmul_stacked(x, tw, 1)
    torch.testing.assert_close(got, tqm.quant_matmul(x, one), rtol=0, atol=0)
    dy = torch.randn_like(got)
    got.backward(dy)
    torch.testing.assert_close(x.grad, dy @ tq.dequantize(one).T)


@pytest.mark.parametrize("kind", KINDS)
def test_model_at_d896_matches_jax(kind):
    """A Qwen2-0.5B-width layer (D=896, 14 q heads over 2 KV heads of 64,
    qkv bias, tied embeddings) with F=1344, fused 4-bit containers: every
    projection takes the route, and the f32 logits match JAX's
    forward_full within 1e-4."""
    jcfg = tiny_config(vocab_size=128, num_layers=1, hidden_size=896,
                       intermediate_size=1344, num_heads=14, num_kv_heads=2,
                       head_dim=64, attn_qkv_bias=True, tie_embeddings=True)
    cfg = ModelConfig(**{**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(jcfg)},
                         "dtype": torch.float32})
    jp = jq.quantize_params(jm.init_params(jcfg, jax.random.key(0),
                                           scale=0.05), kind=kind, fuse=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert set(tq.check_kernel_shapes(cfg, kind).values()) == {"dequant"}
    tokens = np.random.default_rng(0).integers(0, 128, (2, 7))
    ref = np.asarray(jm.forward_full(jcfg, jp, jnp.asarray(tokens,
                                                           jnp.int32)))
    calls = tqm.dequant_matmul.calls
    got = forward_full(cfg, params, torch.from_numpy(tokens))
    assert tqm.dequant_matmul.calls - calls == 4
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


CFG = ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8)


def _batcher(name):
    params = init_params(CFG, seed=0, device="cpu")
    kw = dict(num_slots=2, gamma=2, max_prompt_len=8, max_new_tokens=10,
              device="cpu")
    if name == "slotted":
        return ContinuousBatcher(CFG, params, CFG, params, **kw)
    if name == "paged":
        return PagedContinuousBatcher(CFG, params, CFG, params, page_size=4,
                                      **kw)
    if name == "nasd":
        return NasdContinuousBatcher(CFG, params, capacity=64, **kw)
    head = init_eagle_params(CFG.replace(num_layers=1), seed=1, device="cpu")
    return EagleContinuousBatcher(CFG.replace(num_layers=1), head, CFG,
                                  params, **kw)


@pytest.mark.parametrize("name", ["slotted", "paged", "nasd", "eagle"])
def test_submit_is_bounded_by_the_sized_capacity(name):
    """A batcher's cache is sized for the constructor's max_new_tokens:
    submit raises ValueError past it and below 1 (an explicit 0 is no
    longer the default), None means the constructor's value, and a
    refused request takes no id and no queue place."""
    b = _batcher(name)
    for bad in (11, 0, -1):
        with pytest.raises(ValueError, match=r"sized for 1\.\.10 new tokens"):
            b.submit([1, 2, 3], max_new_tokens=bad)
    assert not b.queue
    assert b.submit([1, 2, 3]) == 0 and b.queue[-1].max_new_tokens == 10
    assert b.submit([4, 5], max_new_tokens=1) == 1
    assert b.submit([6], max_new_tokens=10) == 2
    done = b.run()
    assert [len(done[i].output_ids) for i in range(3)] == [10, 1, 10]
