"""Rank bodies for the port's pipeline tests (tests/test_torch_pipeline.py).
Spawned processes import this module, not the test file, so that they start
without JAX: each rank joins a gloo world through a ``file://`` store, runs
the pipeline cases it is given on its stage and writes what it got to
``<out>/rank<r>.pt``."""
import torch
import torch.distributed as dist


def pipeline_cases(rank, world, store, out, cases):
    """``cases``: dicts of a name, the whole model's ``cfg`` and
    ``params``, ``tokens``, the microbatch counts ``ms`` and the mesh's
    ``devices`` and ``stages`` (None: every rank). For each, this rank
    builds the mesh (or records why it is not on it), shards the params,
    records its stage-local layer shapes, and runs the pipeline at each
    microbatch count. Then the refusals: a mesh with no device, L % S != 0
    and B % M != 0."""
    from specdec_tpu_torch.parallel import (
        STAGE_AXIS, build_pipeline_mesh, pipeline_forward_full,
        shard_params_pipeline,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    got = {}
    try:  # no device: the card, never the CPU
        got["default_device"] = build_pipeline_mesh().device.type
    except RuntimeError as e:
        got["default_device"] = str(e)
    for case in cases:
        cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
        try:
            mesh = build_pipeline_mesh(case["devices"], case["stages"],
                                       device="cpu")
        except ValueError as e:
            got[case["name"]] = {"off_mesh": str(e)}
            continue
        local = shard_params_pipeline(params, cfg, mesh)
        rec = {"shape": mesh.shape[STAGE_AXIS], "stage": mesh.stage,
               "shapes": {k: tuple(v.shape) for k, v in
                          local["layers"].items() if torch.is_tensor(v)},
               "packed": {k: tuple(v.packed.shape) for k, v in
                          local["layers"].items() if hasattr(v, "packed")},
               "logits": {m: pipeline_forward_full(cfg, local, tokens, mesh,
                                                   num_microbatches=m)
                          for m in case["ms"]}}
        got[case["name"]] = rec
    # the refusals, raised before any collective on every rank alike
    cfg, params, tokens = (cases[0][k] for k in ("cfg", "params", "tokens"))
    mesh = build_pipeline_mesh(device="cpu")
    try:
        shard_params_pipeline(params, cfg.replace(num_layers=6), mesh)
    except ValueError as e:
        got["layers_refused"] = str(e)
    local = shard_params_pipeline(params, cfg, mesh)
    try:
        pipeline_forward_full(cfg, local, tokens, mesh, num_microbatches=3)
    except ValueError as e:
        got["batch_refused"] = str(e)
    try:
        pipeline_forward_full(cfg, params, tokens, mesh, num_microbatches=1)
    except ValueError as e:
        got["unsharded_refused"] = str(e)
    torch.save(got, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()
