"""The port's tensor and data parallelism (specdec_tpu_torch/parallel/)
against the unsharded port and the JAX package, at tests/test_parallel.py's
shapes (V=64, 2 layers, D=64, F=128, 8 q heads over 4 KV heads, Dh 8).

One world of 8 gloo ranks (spawned once for the module, each rank on one
CPU thread) runs every case of tests/test_parallel.py: meshes of dp=2 x
tp=4 and 8-way TP (so 8 q heads over 4 KV heads puts one q head on a rank
and replicates the KV heads), a replicated drafter, int8 KV and fused INT8
containers. The shards themselves are built in this process against a mesh
of no process group (``shard_params`` reads only the rank's position)."""
import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.multiprocessing as mp

from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.engine.batch_engine import (
    batch_speculative_generate as jax_batch_spec,
)
from specdec_tpu.sampling.processors import GreedyProcessor as JaxGreedy

import torch_mesh_worker as worker
from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_full
from specdec_tpu_torch.engine.batch_engine import batch_speculative_generate
from specdec_tpu_torch.parallel import mesh as tmesh
from specdec_tpu_torch.quant import core as tq
from specdec_tpu_torch.sampling.processors import (
    GreedyProcessor, MultinomialProcessor,
)
from specdec_tpu_torch.serve.paged_scheduler import PagedContinuousBatcher
from specdec_tpu_torch.serve.scheduler import ContinuousBatcher

torch.set_num_threads(2)

JCFG = tiny_config(vocab_size=64, num_layers=2, hidden_size=64,
                   intermediate_size=128, num_heads=8, num_kv_heads=4,
                   head_dim=8)
CFG = ModelConfig(**{**{f.name: getattr(JCFG, f.name)
                        for f in dataclasses.fields(JCFG)},
                     "dtype": torch.float32})
PROMPTS = worker.PROMPTS
WORLD = 8


@pytest.fixture(scope="module")
def models():
    """tests/test_parallel.py's models: JAX params, and the port's."""
    target = jm.init_params(JCFG, jax.random.key(0), scale=0.3)
    noise = jm.init_params(JCFG, jax.random.key(1), scale=0.05)
    drafter = jax.tree.map(lambda a, b: a + b, target, noise)
    return (target, drafter,
            params_from_numpy(jax.tree.map(np.asarray, target), "cpu"),
            params_from_numpy(jax.tree.map(np.asarray, drafter), "cpu"))


@pytest.fixture(scope="module")
def tokens():
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, size=(4, 12)).astype(np.int64))


@pytest.fixture(scope="module")
def world(models, tokens, tmp_path_factory):
    """Rank 0's results of ``worker.parallel_cases`` (every rank's, for the
    checks that each rank holds the same)."""
    _, _, target, drafter = models
    out = tmp_path_factory.mktemp("world8")
    mp.spawn(worker.parallel_cases,
             args=(WORLD, str(out / "store"), str(out), CFG, target, drafter,
                   tokens), nprocs=WORLD)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def spec(target, drafter, prompts=PROMPTS, gen=12, seed=5, **kw):
    return batch_speculative_generate(prompts, CFG, drafter, CFG, target,
                                      gamma=3, gen_len=gen, eos_tokens_id=(),
                                      seed=seed, device="cpu", **kw)


def jax_spec(target, drafter, prompts=PROMPTS, gen=12, key=5, cfg=JCFG):
    """JAX's greedy tokens and acceptance at ``worker.COLD``, where neither
    depends on the acceptance draws."""
    return jax_batch_spec(prompts, cfg, drafter, cfg, target, gamma=3,
                          gen_len=gen, eos_tokens_id=(),
                          logits_processor=JaxGreedy(worker.COLD),
                          key=jax.random.key(key))


def fake_mesh(tp, r, dp=1, d=0):
    """A mesh position without process groups: enough for shard_params."""
    return tmesh.Mesh(tp=tp, dp=dp, rank=d * tp + r, tp_index=r,
                      dp_index=d, ranks=(), model_group=None,
                      data_group=None, device=torch.device("cpu"))


def test_mesh_builder_shapes(world):
    for r, got in enumerate(world):
        shape42, shape8, (d, t), ranks = got["shapes"]
        assert shape42 == {tmesh.DATA_AXIS: 2, tmesh.MODEL_AXIS: 4}
        assert shape8 == {tmesh.DATA_AXIS: 1, tmesh.MODEL_AXIS: 8}
        # row-major as JAX's reshape(dp, tp)
        assert (d, t) == divmod(r, 4)
        assert ranks == ((0, 1, 2, 3), (4, 5, 6, 7))
    # one local config: Hq/8 = 1 q head reading one (replicated) KV head
    assert world[0]["local_cfg"] == (1, 1, 16, 64)


def test_mesh_device_defaults_to_the_card(world):
    """``build_mesh`` with no device puts the rank on its card under gloo
    too, never on the CPU: without a card it raises (as ``resolve_device``
    does), before any group is made, on every rank alike."""
    for got in world:
        assert got["default_device"] != "cpu"
        if not torch.cuda.is_available():
            assert "no CUDA device" in got["default_device"]


def test_load_models_under_a_mesh_takes_its_device():
    """``load_models(device=None, mesh=m)`` loads on the mesh's device: a
    card's mesh without a card raises before anything is read."""
    from specdec_tpu_torch.engine.model_loader import load_models

    card = dataclasses.replace(fake_mesh(1, 0), device=torch.device("cuda"))
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_models("synthetic:llama-70m", None, mesh=card)


def test_sharded_params_are_distributed(models):
    """Column-parallel wq holds a quarter of the heads on each of 4 ranks;
    row-parallel wo and w_down a quarter of their rows; the embedding and
    lm_head a quarter of the vocabulary; a replicated copy holds all, with
    no mesh attached."""
    _, _, target, _ = models
    L, D, Hq, Hk, Dh = 2, 64, 8, 4, 8
    for r in range(4):
        s = tmesh.shard_params(target, CFG, fake_mesh(4, r))
        lay = s["layers"]
        assert tuple(lay["wq"].shape) == (L, D, Hq * Dh // 4)
        assert tuple(lay["wk"].shape) == (L, D, Hk * Dh // 4)
        assert tuple(lay["wo"].shape) == (L, Hq * Dh // 4, D)
        assert tuple(lay["w_down"].shape) == (L, 128 // 4, D)
        assert tuple(s["embed"].shape) == (16, D)
        assert tuple(s["lm_head"].shape) == (D, 16)
        q = slice(r * 16, (r + 1) * 16)
        assert torch.equal(lay["wq"], target["layers"]["wq"][..., q])
        assert torch.equal(lay["wo"], target["layers"]["wo"][:, q])
        assert s["mesh"].tp_index == r
        assert lay["wq"].untyped_storage().data_ptr() != \
            target["layers"]["wq"].untyped_storage().data_ptr()
    repl = tmesh.shard_params(target, CFG, fake_mesh(4, 1), replicated=True)
    assert "mesh" not in repl
    assert torch.equal(repl["layers"]["wq"], target["layers"]["wq"])
    assert repl["layers"]["wq"].data_ptr() != \
        target["layers"]["wq"].data_ptr()


@pytest.mark.parametrize("kind", ["int8", "int4", "nf4"])
def test_fused_shards_are_per_rank_columns(models, kind):
    """A rank's fused wqkv / w_gateup is built from its own q, k and v
    (gate and up) column ranges, for every container: it equals the
    quantized concatenation of the rank's dense q, k, v (gate, up) shards
    bit for bit (each quantizer is independent per column). At 8 ranks
    over 4 KV heads, ranks 2j and 2j+1 share KV head j."""
    _, _, target, _ = models
    fn = tq._QUANTIZERS[kind]
    fused = tq.quantize_params(target, kind=kind, fuse=True)["layers"]
    parts = {"wqkv": ("wq", "wk", "wv"), "w_gateup": ("w_gate", "w_up")}
    for tp in (4, 8):
        for r in range(tp):
            dense = tmesh.shard_params(target, CFG, fake_mesh(tp, r))
            for name, names in parts.items():
                got = tmesh._shard_layer(name, fused[name], CFG, tp, r)
                want = fn(torch.cat([dense["layers"][n] for n in names], -1))
                for f in dataclasses.fields(got):
                    assert torch.equal(getattr(got, f.name),
                                       getattr(want, f.name)), \
                        (tp, r, name, f.name)
    k = [tmesh.shard_params(target, CFG, fake_mesh(8, r))["layers"]["wk"]
         for r in range(8)]
    assert all(torch.equal(k[2 * j], k[2 * j + 1]) for j in range(4))
    assert torch.equal(k[2], target["layers"]["wk"][..., 8:16])


@pytest.mark.parametrize("kind", ["int4", "nf4", "fp4"])
def test_four_bit_row_shard_dequantizes_bit_for_bit(kind):
    """A 4-bit row shard at K/tp = 256 (w_down with F=1024 at tp=4) is
    repacked from its codes and natural-order absmax: it dequantizes to
    exactly the unsharded weight's rows, its absmax block-major like any
    K % 256 == 0 weight."""
    cfg = CFG.replace(intermediate_size=1024)
    gen = torch.Generator().manual_seed(7)
    w = torch.randn((2, 1024, 64), generator=gen)
    full = tq._QUANTIZERS[kind](w)
    ref = tq.dequantize(full)
    for r in range(4):
        shard = tmesh._shard_layer("w_down", full, cfg, 4, r)
        assert tuple(shard.packed.shape) == (2, 256 // 8, 64)
        assert tuple(shard.absmax.shape) == (2, 256 // 64, 64)
        assert torch.equal(tq.dequantize(shard),
                           ref[:, r * 256:(r + 1) * 256])
        # the shard is the container the quantizer makes of those rows
        alone = tq._QUANTIZERS[kind](w[:, r * 256:(r + 1) * 256])
        assert torch.equal(shard.packed, alone.packed)
        assert torch.equal(shard.absmax, alone.absmax)


def test_shards_that_do_not_split_raise():
    """V % tp, (K/tp) % 64 for a 4-bit row shard, and heads that do not
    split raise ValueError naming what, before anything launches; an INT8
    row shard slices q by rows and keeps the scale whole."""
    with pytest.raises(ValueError, match="vocab_size 65 does not split"):
        tmesh.local_config(CFG.replace(vocab_size=65), fake_mesh(2, 0))
    cfg = CFG.replace(intermediate_size=96 * 4)
    w = tq.quantize_int4(torch.randn((1, 96 * 4, 64)))
    with pytest.raises(ValueError, match=r"w_down.*tp=4"):
        tmesh._shard_layer("w_down", w, cfg, 4, 1)
    with pytest.raises(ValueError, match="KV heads do not split"):
        tmesh.local_config(CFG.replace(num_kv_heads=3, num_heads=6),
                           fake_mesh(4, 0))
    q8 = tq.quantize_int8(torch.randn((2, 128, 64)))
    s = tmesh._shard_layer("w_down", q8, CFG, 4, 2)
    assert torch.equal(s.q, q8.q[:, 64:96]) and torch.equal(s.scale,
                                                            q8.scale)


def _as_tuples(specs):
    return {k: _as_tuples(v) if isinstance(v, dict) else tuple(v)
            for k, v in specs.items()}


@pytest.mark.parametrize("flags", [
    {},
    {"gated_mlp": False, "norm_type": "layernorm", "mlp_bias": True,
     "attn_out_bias": True, "tie_embeddings": True},
    {"attn_qkv_bias": True, "qk_norm": True, "mlp_bias": True},
])
@pytest.mark.parametrize("replicated", [False, True])
def test_param_pspecs_match_jax(flags, replicated):
    """The dense params' specs equal JAX's PartitionSpecs, name for name,
    for each config feature that adds params."""
    from specdec_tpu.parallel.mesh import param_pspecs as jax_pspecs

    want = _as_tuples(jax_pspecs(dataclasses.replace(JCFG, **flags),
                                 replicated))
    assert tmesh.param_pspecs(CFG.replace(**flags), replicated) == want


def test_shard_cache_and_pspecs():
    """shard_cache keeps a data rank's rows and its KV heads (int8 scales
    beside their values); cache_pspec and pspecs_for_params name the
    roles as JAX's specs do."""
    qcfg = CFG.replace(kv_quant="int8")
    cache = init_cache(qcfg, 4, 16, device="cpu")
    cache.k.copy_(torch.arange(cache.k.numel()).reshape(cache.k.shape) % 100)
    cache.k_scale.copy_(torch.rand(cache.k_scale.shape))
    cache.length.copy_(torch.arange(4))
    m = fake_mesh(4, 3, dp=2, d=1)
    s = tmesh.shard_cache(cache, qcfg, m)
    assert tuple(s.k.shape) == (2, 2, 16, 1, 8)
    assert torch.equal(s.k, cache.k[:, 2:4, :, 3:4])
    assert torch.equal(s.k_scale, cache.k_scale[:, 2:4, :, 3:4])
    assert torch.equal(s.length, cache.length[2:4])
    specs = tmesh.cache_pspec(qcfg)
    assert specs["k"] == (None, "data", None, "model", None)
    assert specs["k_scale"] == (None, "data", None, "model")
    fused = tq.quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, jm.init_params(
            JCFG, jax.random.key(0))), "cpu"), kind="int8", fuse=True)
    ps = tmesh.pspecs_for_params(fused, CFG)
    assert ps["layers"]["wqkv"] == (None, None, "model")
    assert ps["layers"]["wo"] == (None, "model", None)
    assert ps["embed"] == ("model", None) and ps["lm_head"] == (None,
                                                                 "model")
    assert tmesh.param_pspecs(CFG, replicated=True)["layers"]["wq"] == (
        None, None, None)
    assert tmesh.batch_state_pspecs(m, 4) == slice(2, 4)


def test_sharded_forward_matches_unsharded(models, tokens, world):
    """dp=2 x tp=4 forward_full, data rows gathered: f32 logits within 1e-4
    of JAX's unsharded forward_full; 2 all-reduces a layer plus the
    embedding's and the head's."""
    target = models[0]
    base = np.asarray(jm.forward_full(JCFG, target, jnp.asarray(
        tokens.numpy().astype(np.int32))))
    for got in world:
        np.testing.assert_allclose(got["forward"].numpy(), base, rtol=1e-4,
                                   atol=1e-4)
        assert got["forward_reduces"] == 2 * CFG.num_layers + 2


def test_sharded_spec_decode_matches_unsharded(models, world):
    """dp=2 x tp=4: greedy tokens and acceptance equal the unsharded
    port's for the seed (at temperature 1, where the acceptance test draws)
    and JAX's (at ``worker.COLD``, where it does not), on every rank."""
    jt, jd, target, drafter = models
    ref, ref_rates = jax_spec(jt, jd)
    base = spec(target, drafter)
    for got in world:
        assert got["spec"] == base
        assert got["spec_cold"][0] == ref
        np.testing.assert_allclose(got["spec_cold"][1], ref_rates)


def test_pure_tp_8way(models, world):
    """8-way TP (one q head a rank, KV heads replicated): greedy tokens
    equal the unsharded port's and, at ``worker.COLD``, JAX's."""
    jt, jd, target, drafter = models
    ref, _ = jax_spec(jt, jd, PROMPTS[:2], gen=8, key=6)
    base = spec(target, drafter, PROMPTS[:2], gen=8, seed=6)
    for got in world:
        assert got["tp8"] == base
        assert got["tp8_cold"][0] == ref


def test_sampled_spec_decode_equals_unsharded(models, world):
    """Sampled decoding draws from the seeded generator: 8-way TP (dp=1)
    and dp=2 x tp=4 (each data rank draws the whole batch's uniforms and
    keeps its rows) give the unsharded port's tokens for the seed."""
    _, _, target, drafter = models
    base = spec(target, drafter, seed=3,
                logits_processor=MultinomialProcessor(1.0))
    for got in world:
        assert got["sampled_tp8"] == base
        assert got["sampled_42"] == base


@pytest.mark.parametrize("engine", ["slotted", "paged"])
def test_sharded_continuous_batching_matches_unsharded(models, world,
                                                       engine):
    """The batcher on a dp=2 x tp=4 target (replicated drafter): each data
    rank serves every other request on one slot, and run() gathers them;
    every request equals the unsharded batcher's."""
    _, _, target, drafter = models
    cls, kw = ((ContinuousBatcher, {}) if engine == "slotted"
               else (PagedContinuousBatcher, {"page_size": 4}))
    base = worker._serve(cls, CFG, drafter, CFG, target, **kw)
    key = "serve" if engine == "slotted" else "serve_paged"
    for got in world:
        assert got[key] == base


def test_server_benchmark_under_a_mesh_matches_unsharded(models, world):
    """The open-loop server benchmark on a dp=2 x tp=4 target: the first
    rank of each 'model' group decides which arrivals are due at each
    step, so the group's ranks admit alike and their all-reduces pair the
    same rows; every request equals the unsharded run's, and every rank
    reports all of them."""
    _, _, target, drafter = models
    base, n = worker.server(CFG, drafter, CFG, target)
    assert n == len(PROMPTS)
    for got in world:
        assert got["server"] == (base, n)


def test_first_token_stamps_every_row_under_dp(world):
    """Under dp=2 every rank stamps the first token of every row of the
    batch, its own and the other data rank's, once its own first window
    is done: TTFT has one definition for all rows."""
    for got in world:
        assert got["first_tokens"] == {"spec": [0, 1, 2, 3],
                                       "ar": [0, 1, 2, 3]}


def test_sharded_spec_decode_int8_kv(models, world):
    """int8 KV, sharded by KV heads with its scales: dp=2 x tp=4 equals
    the unsharded int8-KV run (batched and paged serving) and JAX's."""
    jt, jd, target, drafter = models
    qcfg = CFG.replace(kv_quant="int8")
    ref, _ = jax_spec(jt, jd, cfg=JCFG.replace(kv_quant="int8"))
    base = batch_speculative_generate(
        PROMPTS, qcfg, drafter, qcfg, target, gamma=3, gen_len=12,
        eos_tokens_id=(), seed=5, device="cpu",
        logits_processor=GreedyProcessor(worker.COLD))
    paged = worker._serve(PagedContinuousBatcher, qcfg, drafter, qcfg,
                          target, page_size=4)
    for got in world:
        assert got["int8_kv"] == base
        assert got["int8_kv"][0] == ref
        assert got["int8_kv_paged"] == paged


def bf16_tie(cfg, params, prompt, ref, got, ulps=2):
    """Whether greedy tokens ``got`` equal ``ref`` or part from it where
    the unsharded target's top two logits after ``prompt + ref[:i]`` are
    within ``ulps`` bf16 ulps of each other, ``got[i]`` being one of them:
    an INT8 kernel's output is bf16, and a row-parallel shard rounds its
    partial sums where the unsharded product rounds the whole sum."""
    i = next((j for j, (a, b) in enumerate(zip(ref, got)) if a != b), None)
    if i is None:
        return len(got) == len(ref)
    logits = forward_full(cfg, params, torch.tensor([prompt + ref[:i]]))
    top = torch.topk(logits[0, -1], 2)
    ulp = 2.0 ** (np.floor(np.log2(abs(float(top.values[0])))) - 7)
    return (float(top.values[0] - top.values[1]) <= ulps * ulp
            and got[i] in top.indices.tolist())


def test_sharded_quantized_spec_decode_matches_unsharded(models, world):
    """Fused INT8 containers at dp=2 x tp=4: the containers are per-rank
    column (wqkv, w_gateup) and row (wo, w_down) shards, and the greedy
    tokens (at ``worker.COLD``) equal the unsharded quantized run's, or
    part from them at a top-two bf16 tie of the unsharded target
    (``bf16_tie``); the acceptance of a row that does not part is equal."""
    _, _, target, drafter = models
    qt = tq.quantize_params(target, kind="int8", fuse=True)
    qd = tq.quantize_params(drafter, kind="int8", fuse=True)
    base, base_rates = spec(qt, qd, seed=9,
                            logits_processor=GreedyProcessor(worker.COLD))
    local = world[0]["int8_fused_local"]
    assert local["wqkv"] == (2, 64, (8 + 4 + 4) * 8 // 4)
    assert local["w_gateup"] == (2, 64, 2 * 128 // 4)
    assert local["wo"] == (2, 16, 64) and local["w_down"] == (2, 32, 64)
    for got in world:
        outs, rates = got["int8_fused"]
        for p, ref, out, r0, r1 in zip(PROMPTS, base, outs, base_rates,
                                       rates):
            assert bf16_tie(CFG, qt, p, ref, out), (p, ref, out)
            if out == ref:
                assert r0 == r1


def test_sharded_forward_refuses_gradient():
    """The all-reduce carries no gradient, so a forward on sharded params
    that would backpropagate raises before any collective runs."""
    x = torch.ones((2, 3), requires_grad=True)
    with pytest.raises(ValueError, match="takes no gradient"):
        fake_mesh(2, 0).all_reduce(x * 2)
