"""Rank bodies for the port's gloo tests (tests/test_torch_parallel.py and
tests/test_torch_distributed.py). Spawned processes import this module, not
the test files, so that they start without JAX: each rank joins a gloo world
through a ``file://`` store, runs the cases it is given on its shard of the
model and writes what it got to ``<out>/rank<r>.pt``."""
import os

import torch
import torch.distributed as dist

# exact greedy acceptance: a tempered softmax at this temperature is the
# one-hot argmax, so the tokens do not depend on the acceptance draws and
# can be held to JAX's (whose draws differ)
COLD = 1e-6

PROMPTS = [
    [3, 14, 15, 9, 2, 6],
    [1, 1, 2, 3, 5, 8, 13, 21],
    [27, 4, 9],
    [40, 41, 42, 43],
]


def _join(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)


def _spec(prompts, d_cfg, drafter, t_cfg, target, gen, seed=5,
          processor=None, **kw):
    from specdec_tpu_torch.engine.batch_engine import (
        batch_speculative_generate,
    )
    return batch_speculative_generate(
        prompts, d_cfg, drafter, t_cfg, target, gamma=3, gen_len=gen,
        eos_tokens_id=(), seed=seed, logits_processor=processor,
        device="cpu", **kw)


def _batcher(batcher_cls, d_cfg, drafter, t_cfg, target, **kw):
    """A 2-slot batcher at ``COLD``: under dp=2 each data rank serves half
    of the requests on one slot, with draws of its own, so only acceptance
    that ignores the draws can equal the unsharded run."""
    from specdec_tpu_torch.sampling.processors import GreedyProcessor

    return batcher_cls(d_cfg, drafter, t_cfg, target, num_slots=2, gamma=3,
                       max_prompt_len=16, max_new_tokens=10,
                       windows_per_sync=2, eos_tokens_id=(), device="cpu",
                       logits_processor=GreedyProcessor(COLD), **kw)


def _serve(batcher_cls, d_cfg, drafter, t_cfg, target, **kw):
    """Every prompt through ``_batcher``: the output ids by request."""
    b = _batcher(batcher_cls, d_cfg, drafter, t_cfg, target, **kw)
    ids = [b.submit(p) for p in PROMPTS]
    done = b.run()
    return [done[i].output_ids for i in ids]


def server(d_cfg, drafter, t_cfg, target):
    """Every prompt through ``run_server_benchmark`` (open loop, arrivals
    1 ms apart, so that they land between steps) on a slotted
    ``_batcher``: (output ids by request, requests reported)."""
    from specdec_tpu_torch.engine.server_benchmark import (
        run_server_benchmark,
    )
    from specdec_tpu_torch.serve.scheduler import ContinuousBatcher

    b = _batcher(ContinuousBatcher, d_cfg, drafter, t_cfg, target)
    res = run_server_benchmark(b, PROMPTS, rate=1000.0)
    return ([b.completed[i].output_ids for i in range(len(PROMPTS))],
            res.total_requests)


def parallel_cases(rank, world, store, out, cfg, target, drafter, tokens):
    """The cases of tests/test_parallel.py on a world of 8 ranks: meshes
    of 4 x 2 and 8 x 1 over a dense target (and its fused INT8
    containers), a replicated drafter."""
    from specdec_tpu_torch.core.model import forward_full
    from specdec_tpu_torch.engine.batch_engine import (
        batch_autoregressive_generate,
    )
    from specdec_tpu_torch.parallel.mesh import (
        batch_state_pspecs, build_mesh, local_config, model_all_reduce,
        shard_params,
    )
    from specdec_tpu_torch.quant.core import quantize_params
    from specdec_tpu_torch.sampling.processors import (
        GreedyProcessor, MultinomialProcessor,
    )
    from specdec_tpu_torch.serve.paged_scheduler import (
        PagedContinuousBatcher,
    )
    from specdec_tpu_torch.serve.scheduler import ContinuousBatcher

    _join(rank, world, store)
    got = {}
    try:  # no device: the card, never the CPU
        got["default_device"] = build_mesh().device.type
    except RuntimeError as e:
        got["default_device"] = str(e)
    mesh42 = build_mesh(tp=4, dp=2, device="cpu")
    mesh8 = build_mesh(device="cpu")
    got["shapes"] = (mesh42.shape, mesh8.shape,
                     (mesh42.dp_index, mesh42.tp_index), mesh42.ranks)
    lc42, lc8 = local_config(cfg, mesh42), local_config(cfg, mesh8)
    t42 = shard_params(target, cfg, mesh42)
    t8 = shard_params(target, cfg, mesh8)
    d_rep = shard_params(drafter, cfg, mesh42, replicated=True)
    got["local"] = {k: tuple(v.shape) for k, v in t42["layers"].items()}
    got["local_cfg"] = (lc8.num_heads, lc8.num_kv_heads,
                        lc8.intermediate_size, lc8.vocab_size)

    rows = batch_state_pspecs(mesh42, tokens.shape[0])
    before = model_all_reduce.calls
    logits = forward_full(lc42, t42, tokens[rows])
    got["forward_reduces"] = model_all_reduce.calls - before
    got["forward"] = torch.cat(mesh42.gather_rows(logits))

    cold = GreedyProcessor(COLD)
    got["spec"] = _spec(PROMPTS, cfg, d_rep, lc42, t42, 12)
    got["spec_cold"] = _spec(PROMPTS, cfg, d_rep, lc42, t42, 12,
                             processor=cold)
    got["tp8"] = _spec(PROMPTS[:2], cfg, d_rep, lc8, t8, 8, seed=6)
    got["tp8_cold"] = _spec(PROMPTS[:2], cfg, d_rep, lc8, t8, 8, seed=6,
                            processor=cold)
    sampler = MultinomialProcessor(1.0)
    got["sampled_tp8"] = _spec(PROMPTS, cfg, d_rep, lc8, t8, 12, seed=3,
                               processor=sampler)
    got["sampled_42"] = _spec(PROMPTS, cfg, d_rep, lc42, t42, 12, seed=3,
                              processor=sampler)
    got["serve"] = _serve(ContinuousBatcher, cfg, d_rep, lc42, t42)
    got["serve_paged"] = _serve(PagedContinuousBatcher, cfg, d_rep, lc42, t42,
                                page_size=4)
    got["server"] = server(cfg, d_rep, lc42, t42)
    stamped = {"spec": [], "ar": []}
    _spec(PROMPTS, cfg, d_rep, lc42, t42, 4,
          first_token_callback=stamped["spec"].append)
    batch_autoregressive_generate(PROMPTS, lc42, t42, gen_len=4,
                                  eos_tokens_id=(), device="cpu",
                                  first_token_callback=stamped["ar"].append)
    got["first_tokens"] = stamped
    qcfg = cfg.replace(kv_quant="int8")
    got["int8_kv"] = _spec(PROMPTS, qcfg, d_rep, lc42.replace(
        kv_quant="int8"), t42, 12, processor=cold)
    got["int8_kv_paged"] = _serve(PagedContinuousBatcher, qcfg, d_rep,
                                  lc42.replace(kv_quant="int8"), t42,
                                  page_size=4)

    qt = quantize_params(target, kind="int8", fuse=True)
    qd = quantize_params(drafter, kind="int8", fuse=True)
    qt42 = shard_params(qt, cfg, mesh42)
    got["int8_fused_local"] = {
        k: tuple(getattr(v, "q", v).shape) for k, v in qt42["layers"].items()}
    got["int8_fused"] = _spec(PROMPTS, cfg, shard_params(
        qd, cfg, mesh42, replicated=True), lc42, qt42, 12, seed=9,
        processor=cold)
    torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def multihost_case(rank, world, port, host_of, out, env_style):
    """One rank of a world joined from the environment, as each host
    process of a multi-host launch is: ``init_distributed`` reads the JAX
    runner's variables (``env_style`` "jax") or torchrun's ("torchrun");
    ``host_of[rank]`` is the node this rank pretends to run on. Builds the
    multi-host mesh and runs a TP-sharded matmul whose all-reduce spans
    the processes."""
    torch.set_num_threads(1)
    hosts = sorted(set(host_of))
    if env_style == "jax":
        os.environ.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                          NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
    else:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          WORLD_SIZE=str(world), RANK=str(rank))
    os.environ["GROUP_RANK"] = str(host_of[rank])
    os.environ["LOCAL_WORLD_SIZE"] = str(world // len(hosts))
    from specdec_tpu_torch.parallel.distributed import (
        build_multihost_mesh, init_distributed,
    )
    from specdec_tpu_torch.parallel.mesh import model_all_reduce

    joined = init_distributed(device="cpu")
    mesh = build_multihost_mesh(device="cpu")
    K = 8
    W = torch.arange(K * K, dtype=torch.float32).reshape(K, K) / K
    x = torch.ones((4, K), dtype=torch.float32)
    # rows of x over 'data', W row-parallel over 'model': the partial
    # products all-reduce across processes, the data rows gather
    rows = x.shape[0] // mesh.dp
    k = K // mesh.tp
    xs = x[mesh.dp_index * rows:(mesh.dp_index + 1) * rows,
           mesh.tp_index * k:(mesh.tp_index + 1) * k]
    part = model_all_reduce(mesh, xs @ W[mesh.tp_index * k:
                                         (mesh.tp_index + 1) * k])
    y = torch.cat(mesh.gather_rows(part))
    torch.save({"joined": joined, "world": dist.get_world_size(),
                "shape": mesh.shape, "ranks": mesh.ranks,
                "host": host_of[rank], "sum": float(y.sum()),
                "y": y},
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
