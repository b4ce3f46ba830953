"""Tensor and data parallelism over torch.distributed (counterpart of
``specdec_tpu/parallel/``): ``mesh`` builds the ('data', 'model') mesh and
shard-local params, ``distributed`` joins the world and lays out the
multi-host mesh."""
from specdec_tpu_torch.parallel.distributed import (  # noqa: F401
    build_multihost_mesh, init_distributed,
)
from specdec_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Mesh, batch_state_pspecs, build_mesh,
    cache_pspec, local_config, param_pspecs, pspecs_for_params,
    shard_cache, shard_params,
)
