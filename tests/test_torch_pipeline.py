"""The port's pipeline parallelism (specdec_tpu_torch/parallel/pipeline.py)
against the JAX package's GPipe forward and its unsharded ``forward_full``,
at tests/test_pipeline.py's shapes (V=64, 4 layers, D=64, F=128, 8 q heads
over 4 KV heads, Dh 8, scale 0.3, f32).

One world of 4 gloo ranks (spawned once for the module, one CPU thread
each, through ``tests/torch_pipeline_worker.py``) runs every case: 4 stages
at 1, 2 and 4 microbatches; 2 stages on the first two ranks (the other two
are off the mesh); INT4 layers with a dense ``lm_head`` at D=512, F=1024;
and INT4 with a quantized ``lm_head`` and a logit softcap of 5. The JAX
pipeline raises on a quantized ``lm_head`` and leaves the softcap out
(ROADMAP.md, "Known faults of the reference"), so that case is held to
``forward_full``, JAX's and the port's.

The INT4 cases differ from JAX's by bf16 roundings: the port's plain
version of the INT4 kernel rounds x and its result to bf16, as the Pallas
kernel does (tests/test_torch_model.py::test_int4_forward_matches_pallas_
path), where JAX's CPU path multiplies the dequantized weight in f32; the
Pallas kernel in interpret mode inside the JAX pipeline would take about a
minute here. So they are held to JAX within ``int4_close`` and to the
port's own unsharded forward within 2e-4 (bit for bit at one
microbatch)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.multiprocessing as mp

from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.parallel import pipeline as jpp
from specdec_tpu.quant import core as jq

import torch_pipeline_worker as worker
from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_full
from specdec_tpu_torch.parallel import STAGE_AXIS

torch.set_num_threads(2)

WORLD = 4
MS = (1, 2, 4)
# both sides f32 (tests/test_pipeline.py's tolerance)
TOL = dict(rtol=2e-4, atol=2e-4)


def int4_close(got, ref):
    """The port's INT4 logits against JAX's: the plain version rounds each
    projection's input and output to bf16 (2**-9 relative), four
    projections a layer over 4 layers; measured here 0.5% relative
    Frobenius and 1.2% of max|ref| elementwise. A layer or microbatch out
    of place gives O(1) errors."""
    assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2 ** -5 * np.abs(ref).max())
JCFG = tiny_config(vocab_size=64, num_layers=4, hidden_size=64,
                   intermediate_size=128, num_heads=8, num_kv_heads=4,
                   head_dim=8)
# INT4 widths: every projection's K a multiple of 512
QCFG = JCFG.replace(hidden_size=512, intermediate_size=1024, head_dim=64)


def port_config(cfg) -> ModelConfig:
    return ModelConfig(**{**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)},
                          "dtype": torch.float32})


def tokens_of(B, T, seed):
    return np.random.default_rng(seed).integers(0, 64, (B, T)).astype(
        np.int32)


def jax_pipeline(jcfg, params, tokens, stages, ms):
    """JAX's pipeline logits at each microbatch count, on the first
    ``stages`` virtual devices."""
    mesh = jpp.build_pipeline_mesh(jax.devices()[:stages], stages=stages)
    sharded = jpp.shard_params_pipeline(params, jcfg, mesh)
    return {m: np.asarray(jpp.pipeline_forward_full(
        jcfg, sharded, jnp.asarray(tokens), mesh, num_microbatches=m))
        for m in ms}


@pytest.fixture(scope="module")
def cases():
    """Each case's JAX params, tokens and the references: JAX's pipeline
    (where it runs) and JAX's ``forward_full``."""
    out = {}
    dense = jm.init_params(JCFG, jax.random.key(0), scale=0.3)
    gqa_cfg = JCFG.replace(num_layers=2)
    gqa = jm.init_params(gqa_cfg, jax.random.key(1), scale=0.3)
    base = jm.init_params(QCFG, jax.random.key(2), scale=0.05)
    capped = jax.jit(lambda p: jq.quantize_params(p, kind="int4",
                                                  fuse=True))(base)
    int4 = dict(capped, lm_head=base["lm_head"])
    capped_cfg = QCFG.replace(logit_softcap=5.0)
    full = jax.jit(jm.forward_full, static_argnums=0)
    for name, jcfg, params, (B, T, seed), stages, ms, pipe in (
            ("dense", JCFG, dense, (8, 12, 0), None, MS, True),
            ("gqa", gqa_cfg, gqa, (4, 9, 1), 2, (2,), True),
            ("int4", QCFG, int4, (8, 12, 2), None, MS, True),
            ("int4_head_softcap", capped_cfg, capped, (8, 12, 3), None, MS,
             False)):
        toks = tokens_of(B, T, seed)
        out[name] = {
            "jcfg": jcfg, "params": params, "tokens": toks,
            "stages": stages, "ms": ms,
            "full": np.asarray(full(jcfg, params, jnp.asarray(toks))),
            "pipeline": (jax_pipeline(jcfg, params, toks, stages or WORLD,
                                      ms) if pipe else None)}
    return out


@pytest.fixture(scope="module")
def ported(cases):
    """Each case in the port's terms: config, params, tokens, mesh."""
    return [{"name": name, "cfg": port_config(c["jcfg"]),
             "params": params_from_numpy(jax.tree.map(np.asarray,
                                                      c["params"]), "cpu"),
             "tokens": torch.from_numpy(c["tokens"].astype(np.int64)),
             "ms": c["ms"], "stages": c["stages"],
             "devices": None if c["stages"] is None else list(
                 range(c["stages"]))}
            for name, c in cases.items()]


@pytest.fixture(scope="module")
def world(ported, tmp_path_factory):
    """Every rank's results of ``worker.pipeline_cases``."""
    out = tmp_path_factory.mktemp("pipeline4")
    mp.spawn(worker.pipeline_cases,
             args=(WORLD, str(out / "store"), str(out), ported),
             nprocs=WORLD)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def port_full(ported, name):
    """The port's unsharded ``forward_full`` of a case."""
    c = next(c for c in ported if c["name"] == name)
    return forward_full(c["cfg"], c["params"], c["tokens"])


@pytest.mark.parametrize("m", MS)
def test_pipeline_forward_matches_single_device(cases, world, m):
    """4 stages, m microbatches: every stage's logits equal JAX's pipeline
    and JAX's unsharded forward within 2e-4, and each other's bit for
    bit (the last stage broadcasts them)."""
    c = cases["dense"]
    got = [w["dense"]["logits"][m] for w in world]
    for g in got[1:]:
        assert torch.equal(g, got[0])
    np.testing.assert_allclose(got[0].numpy(), c["pipeline"][m], **TOL)
    np.testing.assert_allclose(got[0].numpy(), c["full"], **TOL)


def test_pipeline_stage_local_layers(world):
    """Each rank holds L/S = 1 layer of every stacked tensor (stage r the
    r-th), on a ('stage',) mesh of 4; an INT4 container is cut on its
    leading axis."""
    cfg = JCFG
    D, Hq, Dh = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    for r, w in enumerate(world):
        rec = w["dense"]
        assert rec["shape"] == WORLD and rec["stage"] == r
        assert rec["shapes"]["wq"] == (1, D, Hq * Dh)
        assert {s[0] for s in rec["shapes"].values()} == {1}
        assert {s[0] for s in w["int4"]["packed"].values()} == {1}


def test_pipeline_two_stages_gqa(cases, world):
    """2 stages on ranks 0 and 1, 2 microbatches, 8 q heads over 4 KV
    heads; ranks 2 and 3 are off the mesh and refuse it."""
    c = cases["gqa"]
    for w in world[:2]:
        got = w["gqa"]["logits"][2].numpy()
        np.testing.assert_allclose(got, c["pipeline"][2], **TOL)
        np.testing.assert_allclose(got, c["full"], **TOL)
        assert w["gqa"]["shapes"]["wk"][0] == 1
    for w in world[2:]:
        assert "not on the pipeline mesh" in w["gqa"]["off_mesh"]


@pytest.mark.parametrize("m", MS)
def test_pipeline_int4_layers(cases, ported, world, m):
    """Fused INT4 layers (the plain version of the INT4 kernel) with a
    dense lm_head, 4 stages: the port's unsharded forward within 2e-4 (bit
    for bit at one microbatch), JAX's pipeline within ``int4_close``."""
    got = world[0]["int4"]["logits"][m]
    full = port_full(ported, "int4")
    if m == 1:
        assert torch.equal(got, full)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)
    int4_close(got.numpy(), cases["int4"]["pipeline"][m])


@pytest.mark.parametrize("m", MS)
def test_pipeline_quantized_head_and_softcap(cases, ported, world, m):
    """INT4 layers and lm_head, logit softcap 5: where JAX's pipeline
    raises (the quantized lm_head) and leaves the softcap out, the port's
    equals forward_full: the port's own within 2e-4 (bit for bit at one
    microbatch), JAX's within ``int4_close``."""
    got = world[-1]["int4_head_softcap"]["logits"][m]
    full = port_full(ported, "int4_head_softcap")
    assert float(got.abs().max()) <= 5.0
    if m == 1:
        assert torch.equal(got, full)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)
    int4_close(got.numpy(), cases["int4_head_softcap"]["full"])


def test_pipeline_refusals(world):
    """ValueError on every rank, before any collective, for L % S != 0,
    B % M != 0 and params that hold all L layers; a mesh with no device is
    the rank's card, and raises without one."""
    for w in world:
        assert "not divisible by 4 stages" in w["layers_refused"]
        assert "not divisible by 3 microbatches" in w["batch_refused"]
        assert "hold 4 layers" in w["unsharded_refused"]
        assert w["default_device"] != "cpu"
        if not torch.cuda.is_available():
            assert "no CUDA device" in w["default_device"]


def test_stage_axis_name():
    assert STAGE_AXIS == jpp.STAGE_AXIS
