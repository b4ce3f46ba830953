"""The port's multi-process tier (specdec_tpu_torch/parallel/distributed.py),
the counterpart of tests/test_distributed.py: the world is joined from the
environment, as every process of a multi-host launch joins it, and the
mesh lays 'model' within a host and 'data' across hosts.

One machine has one host, so each rank names the node it stands for
(``GROUP_RANK``, as torchrun sets it); the hosts are interleaved over the
ranks, so a mesh that ordered ranks by number instead of host-major would
put a 'model' row across hosts. Four gloo processes (two hosts of two
ranks) run a TP-sharded matmul whose all-reduce spans the processes."""
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_mesh_worker as worker
from specdec_tpu_torch.parallel.distributed import init_distributed
from specdec_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

WORLD = 4
HOST_OF = [0, 1, 0, 1]  # rank -> the node it stands for


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_single_process_is_a_no_op(monkeypatch):
    """Without a coordinator or a world in the environment there is no
    world to join: False, and torch.distributed stays uninitialized."""
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                 "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env_style", ["jax", "torchrun"])
def test_multihost_distributed_mesh(tmp_path, env_style):
    """Each process joins from the JAX runner's variables
    (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) or torchrun's
    (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK); build_multihost_mesh
    gives 'model' = the ranks of a host (LOCAL_WORLD_SIZE) and 'data' =
    the hosts, every 'model' row on one host; the sharded product equals
    the unsharded one on every rank."""
    mp.spawn(worker.multihost_case,
             args=(WORLD, _free_port(), HOST_OF, str(tmp_path), env_style),
             nprocs=WORLD)
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    K = 8
    W = np.arange(K * K, dtype=np.float32).reshape(K, K) / K
    want = np.ones((4, K), np.float32) @ W
    for g in got:
        assert g["joined"] is True and g["world"] == WORLD
        assert g["shape"] == {DATA_AXIS: 2, MODEL_AXIS: 2}
        # host-major: each 'model' row holds one host's ranks
        assert g["ranks"] == ((0, 2), (1, 3))
        for row in g["ranks"]:
            assert len({HOST_OF[r] for r in row}) == 1
        np.testing.assert_allclose(g["y"].numpy(), want, rtol=1e-6)
    assert len({g["sum"] for g in got}) == 1
