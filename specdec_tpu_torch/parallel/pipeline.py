"""Pipeline parallelism: the GPipe stage-sharded full-sequence forward
(counterpart of ``specdec_tpu/parallel/pipeline.py``).

The layer stack's leading L axis is split over S stages, one rank each, and
the batch into M microbatches. Stage 0 embeds, each stage runs its L/S
layers, activations hop to the next stage by point-to-point sends, and the
last stage projects each finished microbatch through the head (softcap
included) and broadcasts the logits to every stage.

The JAX package runs the schedule in one ``shard_map``-ed program: at
global step t stage s computes microbatch t - s, and the bubble steps
(t - s outside [0, M)) compute too and are masked. The port is eager and
multi-controller (one process per card, as ``parallel/mesh.py``), so a
stage runs only its live steps: it receives microbatch j from stage s - 1,
runs its layers, and sends the result on while it receives j + 1; the
classic schedule falls out of the blocking receives. Every rank issues its
calls in one order (receive, compute, send; a send's handle is waited on
before the next send), so no two ranks wait on each other.

A stage runs the same per-layer code as the unsharded ``forward_full``
(``core/model.py``'s ``_layers`` over a scratch slotted cache of capacity T,
and ``_head``), so under ``attention_impl="flash"`` each layer attends
through the flash-decode kernel, and the weight kernels run each stage's
projections. At one stage and one microbatch the logits are the unsharded
forward's bit for bit.

The hop moves a [B/M, T, D] activation. NCCL sends the device tensor;
gloo's send and receive take CPU tensors only, so under gloo a CUDA
activation is staged through a host copy (the hop's bytes, nothing else,
leave the card) and the logits are broadcast as they are (gloo broadcasts
CUDA tensors).

Scope, as in the JAX package: the full-sequence (uncached) forward, the
verify shape and prefill. Token-by-token decode would serialize on the hop
every token; ``engine/vllm_compat.py`` folds ``pipeline_parallel_size``
into TP.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
# a module reference: core/model.py imports parallel/mesh.py, which loads
# this package
import specdec_tpu_torch.core.model as core_model
from specdec_tpu_torch.quant.core import QUANTIZED

STAGE_AXIS = "stage"


@dataclasses.dataclass(frozen=True)
class PipelineMesh:
    """This rank's place on a ('stage',) mesh: ``stages`` ranks in stage
    order (``ranks``), this rank at ``stage``, joined by ``group``;
    ``device`` is where this rank's tensors live."""

    stages: int
    stage: int
    ranks: Tuple[int, ...]
    group: Any
    device: torch.device

    @property
    def shape(self) -> dict:
        return {STAGE_AXIS: self.stages}


def build_pipeline_mesh(devices: Optional[Sequence[int]] = None,
                        stages: Optional[int] = None,
                        device=None) -> PipelineMesh:
    """A ('stage',) mesh over the first ``stages`` of the world ranks
    ``devices`` (default: every rank, in order; ``stages`` defaults to
    their number and must divide it, as in the JAX package). Every rank of
    the world calls this (group creation is collective); a rank past the
    first ``stages`` raises ValueError after it. ``device`` is where this
    rank's tensors live: ``None`` means its card (the current CUDA
    device), whatever the backend, and raises without one; the CPU is
    asked for by name."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("build_pipeline_mesh needs an initialized "
                           "torch.distributed world: call parallel."
                           "distributed.init_distributed (or torch."
                           "distributed.init_process_group) first")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    stages = stages or len(ranks)
    if len(ranks) % stages:
        raise ValueError(f"{len(ranks)} ranks do not split into {stages} "
                         "stages")
    ranks = tuple(ranks[:stages])
    group = dist.new_group(list(ranks))
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError(f"rank {me} is not on the pipeline mesh {ranks}")
    return PipelineMesh(stages=stages, stage=ranks.index(me), ranks=ranks,
                        group=group, device=device)


def _placed(w, device: torch.device, layers=None):
    """A dense tensor or quantized container on ``device``; with ``layers``
    (lo, hi), its layers [lo, hi) on the leading axis (every field of a
    container alike), copied."""
    if isinstance(w, QUANTIZED):
        return type(w)(**{f.name: _placed(getattr(w, f.name), device, layers)
                          for f in dataclasses.fields(w)})
    if layers is None:
        return w.to(device)
    return w[layers[0]:layers[1]].to(device, copy=True)


def shard_params_pipeline(params: dict, cfg: ModelConfig,
                          mesh: PipelineMesh) -> dict:
    """This rank's stage-local params: the stacked layers cut to the
    stage's L/S layers on their leading axis (each field of a quantized
    container alike) and copied, so that a stage holds only its layers;
    the embedding, the final norm and the ``lm_head`` (quantized too)
    replicated. Everything is placed on ``mesh.device``. No mesh goes
    under ``"mesh"``: ``core/model.py`` reads that key as a tensor-parallel
    mesh. Raises ValueError where L % S != 0 and for params already
    sharded over a tensor-parallel mesh."""
    S = mesh.stages
    if cfg.num_layers % S:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by "
                         f"{S} stages")
    if "mesh" in params:
        raise ValueError("pipeline stages take unsharded params, not "
                         "params sharded over a ('data', 'model') mesh")
    n = cfg.num_layers // S
    lo = mesh.stage * n
    out = {key: _placed(val, mesh.device) for key, val in params.items()
           if key != "layers"}
    out["layers"] = {name: _placed(w, mesh.device, (lo, lo + n))
                     for name, w in params["layers"].items()}
    return out


def _stacked_depth(layers: dict) -> int:
    w = next(iter(layers.values()))
    if isinstance(w, QUANTIZED):
        w = getattr(w, dataclasses.fields(w)[0].name)
    return w.shape[0]


def _staged(mesh: PipelineMesh) -> bool:
    """Whether the hop stages CUDA activations through the host (gloo's
    point-to-point calls take CPU tensors only)."""
    return (mesh.device.type == "cuda"
            and dist.get_backend(mesh.group) == "gloo")


def _recv_activation(mesh: PipelineMesh, like: torch.Tensor):
    """The previous stage's next activation, shaped and typed as ``like``,
    on ``mesh.device``."""
    src = mesh.ranks[mesh.stage - 1]
    if _staged(mesh):
        buf = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(buf, src=src, group=mesh.group)
        return buf.to(mesh.device)
    buf = torch.empty_like(like)
    dist.recv(buf, src=src, group=mesh.group)
    return buf


def _send_activation(mesh: PipelineMesh, x: torch.Tensor):
    """Send ``x`` to the next stage; returns (handle, the tensor sent),
    which must live until the handle is waited on."""
    if _staged(mesh):
        x = x.cpu()
    return dist.isend(x, dst=mesh.ranks[mesh.stage + 1],
                      group=mesh.group), x


def _store_logits(out: torch.Tensor, j: int, logits: torch.Tensor) -> None:
    """The last stage's logits of microbatch ``j`` into their slot of
    ``out`` [M, B/M, T, V]."""
    out[j] = logits


def pipeline_forward_full(cfg: ModelConfig, params: dict,
                          tokens: torch.Tensor, mesh: PipelineMesh,
                          num_microbatches: int = 4) -> torch.Tensor:
    """Causal full-sequence forward under PP. ``params`` are this rank's
    stage-local params (``shard_params_pipeline``), ``cfg`` the whole
    model's config; tokens [B, T] with B divisible by
    ``num_microbatches``. Returns the logits [B, T, V] (f32) on every
    stage, those of ``forward_full`` (bit for bit at one stage and one
    microbatch). Every rank of the mesh calls it with the same tokens.
    Raises ValueError where B % M != 0 or the params hold another number
    of layers than L/S."""
    B, T = tokens.shape
    S, s, M = mesh.stages, mesh.stage, num_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    n = cfg.num_layers // S
    if cfg.num_layers % S or _stacked_depth(params["layers"]) != n:
        raise ValueError(
            f"stage params hold {_stacked_depth(params['layers'])} layers; "
            f"{cfg.num_layers} layers over {S} stages take "
            f"{cfg.num_layers / S:g} a stage (shard_params_pipeline)")
    mb, device = B // M, mesh.device
    local = cfg.replace(num_layers=n)
    tokens = tokens.to(device)
    q_pos = torch.arange(T, dtype=torch.int32, device=device)[None, :].expand(
        mb, T)
    # scratch K/V covering the block, reused by every microbatch: each
    # writes positions 0 .. T-1 before it reads them
    attend = core_model.slotted_attend(
        local, init_cache(local, mb, T, device=device), q_pos)
    like = torch.empty((mb, T, cfg.hidden_size), dtype=cfg.dtype,
                       device=device)
    logits = torch.empty((M, mb, T, cfg.vocab_size), dtype=torch.float32,
                         device=device)
    pending = None
    for j in range(M):
        if s == 0:
            x = core_model._embed_input(cfg, params,
                                        tokens[j * mb:(j + 1) * mb])
        else:
            x = _recv_activation(mesh, like)
        y = core_model._layers(local, params["layers"], x, q_pos, attend)
        if s < S - 1:
            if pending is not None:
                pending[0].wait()
            pending = _send_activation(mesh, y)
        else:
            _store_logits(logits, j, core_model._head(cfg, params, y))
    if pending is not None:
        pending[0].wait()
    if S > 1:
        dist.broadcast(logits, src=mesh.ranks[S - 1], group=mesh.group)
    return logits.reshape(B, T, cfg.vocab_size)
