"""Tensor, data and pipeline parallelism over torch.distributed
(counterpart of ``specdec_tpu/parallel/``): ``mesh`` builds the ('data',
'model') mesh and shard-local params, ``distributed`` joins the world and
lays out the multi-host mesh, ``pipeline`` splits the layer stack over
stages and runs the GPipe full-sequence forward."""
from specdec_tpu_torch.parallel.distributed import (  # noqa: F401
    build_multihost_mesh, init_distributed,
)
from specdec_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Mesh, batch_state_pspecs, build_mesh,
    cache_pspec, local_config, param_pspecs, pspecs_for_params,
    shard_cache, shard_params,
)
from specdec_tpu_torch.parallel.pipeline import (  # noqa: F401
    STAGE_AXIS, PipelineMesh, build_pipeline_mesh, pipeline_forward_full,
    shard_params_pipeline,
)
