"""A ('data', 'model') mesh over torch.distributed, and shard-local params
(counterpart of ``specdec_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process holds every device,
``shard_params`` only places arrays, and GSPMD partitions an unchanged
forward. The port is eager and calls hand-written kernels, so it runs one
process per card (multi-controller, as ``torchrun`` launches them). Every
rank runs the same decode loop on its own shard with explicit collectives:

- a mesh is a world of ``tp * dp`` ranks, laid out row-major as JAX's
  ``reshape(dp, tp)``: one 'model' group per data row, one 'data' group
  per model column;
- attention's q/k/v and the MLP's gate/up are column-parallel (heads and
  intermediate columns split over 'model'); ``wo`` and ``w_down`` are
  row-parallel, and ``core/model.py`` all-reduces their partial sums over
  the 'model' group in f32 before the replicated ``bo`` / ``b_down``;
- the embedding and the ``lm_head`` are vocab-parallel: each rank looks up
  and scores its vocabulary range, and an all-reduce into a zero-filled
  full-vocab buffer gives every rank the same logits, so every rank draws
  the same token from the same seeded generator;
- a data rank runs its rows of the batch (``batch_state_pspecs``); the
  caches, built from ``local_config``, hold the rank's KV heads.

``shard_params`` returns shard-local tensors and puts the mesh under the
params' ``"mesh"`` key, as a JAX array carries its ``NamedSharding``; the
forwards read it there, so the engines keep JAX's signatures. Replicated
params (a drafter) carry no mesh: their forwards issue no collective.

The specs below mirror JAX's PartitionSpecs as tuples of axis names: they
are the roles that ``shard_params`` reads (column, row, vocab, replicated).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.quant.core import (
    QUANTIZED, Int8Weight, _am_pack, _am_unpack, _pack_nibbles,
    _unpack_nibbles, concat_columns, NF4_BLOCK,
)

if TYPE_CHECKING:  # core/model.py imports this module
    from specdec_tpu_torch.core.config import ModelConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


def P(*axes) -> Tuple[Optional[str], ...]:
    """A partition spec: one mesh axis name (or None) per tensor axis."""
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a ('data', 'model') mesh of ``dp`` x ``tp``
    ranks. ``ranks[d][t]`` is the world rank at data index d and model
    index t; ``model_group`` joins this rank's data row, ``data_group``
    its model column; ``device`` is where this rank's tensors live."""

    tp: int
    dp: int
    rank: int
    tp_index: int
    dp_index: int
    ranks: Tuple[Tuple[int, ...], ...]
    model_group: Any
    data_group: Any
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the 'model' group, in f32, returned in
        x's dtype: a bf16 sum would round once more than the unsharded
        product does. An f32 ``x`` is reduced in place (the forwards hand
        over tensors they own). Counted in ``model_all_reduce.calls``.
        Raises under autograd: the collective carries no gradient, and
        training is not sharded."""
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("a sharded forward takes no gradient: the "
                             "all-reduce over the 'model' group has none")
        acc = x.to(torch.float32).contiguous()
        dist.all_reduce(acc, group=self.model_group)
        model_all_reduce.calls += 1
        return acc.to(x.dtype)

    def gather_rows(self, obj) -> list:
        """Every data rank's ``obj``, in data-index order, on every rank
        (``all_gather_object`` over the 'data' group: a host round trip,
        once a call)."""
        out = [None] * self.dp
        dist.all_gather_object(out, obj, group=self.data_group)
        return out


def model_all_reduce(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """``mesh.all_reduce(x)``, or x unchanged without a mesh."""
    return x if mesh is None else mesh.all_reduce(x)


# all-reduces issued over 'model' groups (a run's collectives are read here)
model_all_reduce.calls = 0


def build_mesh(devices: Optional[Sequence[int]] = None,
               tp: Optional[int] = None, dp: Optional[int] = None,
               device=None) -> Mesh:
    """Build a ('data', 'model') mesh over world ranks ``devices`` (default:
    every rank of the initialized world, in order), laid out as
    ``reshape(dp, tp)``. Defaults: every rank on 'model' (pure TP) unless
    ``dp`` is given; ``tp * dp`` must equal the number of ranks. Every rank
    of the world calls this (group creation is collective). ``device``
    is where this rank's tensors live: ``None`` means its card (the
    current CUDA device), whatever the backend, and raises without one;
    the CPU is asked for by name."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized torch.distributed "
                           "world: call parallel.distributed.init_distributed "
                           "(or torch.distributed.init_process_group) first")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    n = len(ranks)
    if tp is None and dp is None:
        tp, dp = n, 1
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if tp * dp != n:
        raise ValueError(f"tp({tp}) * dp({dp}) != devices({n})")
    grid = tuple(tuple(ranks[d * tp:(d + 1) * tp]) for d in range(dp))
    me = dist.get_rank()
    model_group = data_group = None
    # new_group is collective over the world: every rank creates every group
    for row in grid:
        g = dist.new_group(list(row))
        if me in row:
            model_group = g
    for t in range(tp):
        col = [grid[d][t] for d in range(dp)]
        g = dist.new_group(col)
        if me in col:
            data_group = g
    if model_group is None:
        raise ValueError(f"rank {me} is not on the mesh {grid}")
    pos = ranks.index(me)
    return Mesh(tp=tp, dp=dp, rank=me, tp_index=pos % tp,
                dp_index=pos // tp, ranks=grid, model_group=model_group,
                data_group=data_group, device=device)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def param_pspecs(cfg: ModelConfig, replicated: bool = False) -> dict:
    """Specs matching the dense, unfused params of ``core/model.py`` (the
    names ``cfg`` selects, through ``pspecs_for_params``' roles)."""
    names = ["attn_norm_w", "mlp_norm_w", "wq", "wk", "wv", "wo", "w_up",
             "w_down"]
    top = ["embed", "final_norm_w"]
    if cfg.gated_mlp:
        names.append("w_gate")
    if cfg.norm_type == "layernorm":
        names += ["attn_norm_b", "mlp_norm_b"]
        top.append("final_norm_b")
    if cfg.attn_qkv_bias:
        names += ["bq", "bk", "bv"]
    if cfg.attn_out_bias:
        names.append("bo")
    if cfg.mlp_bias:
        names += ["b_up", "b_down"] + (["b_gate"] if cfg.gated_mlp else [])
    if cfg.qk_norm:
        names += ["q_norm_w", "k_norm_w"]
    if not cfg.tie_embeddings:
        top.append("lm_head")
    return pspecs_for_params(dict(dict.fromkeys(top),
                                  layers=dict.fromkeys(names)),
                             cfg, replicated)


def cache_pspec(cfg: ModelConfig, replicated_model: bool = False) -> dict:
    """Specs of the cache fields ``cfg`` selects: values [L, B, S, Hk, Dh]
    on 'data' over B and 'model' over the KV heads, the int8 format's
    scales [L, B, S, Hk] beside them, ``length`` [B] on 'data'. (The
    paged pools [L, NP, Hk, page, Dh] shard their head axis the same
    way; their pages belong to one data rank's batcher.)"""
    m = None if replicated_model else MODEL_AXIS
    kv = P(None, DATA_AXIS, None, m, None)
    specs = {"k": kv, "v": kv, "length": P(DATA_AXIS)}
    if cfg.kv_quant == "int8":
        specs.update(k_scale=P(None, DATA_AXIS, None, m),
                     v_scale=P(None, DATA_AXIS, None, m))
    return specs


def batch_state_pspecs(mesh: Mesh, batch: int) -> slice:
    """The rows of a [batch, ...] ``BatchState`` this data rank holds: every
    field is ``P(DATA_AXIS)`` on its leading axis, so one slice serves all.
    Raises ValueError when ``batch`` does not split evenly."""
    if batch % mesh.dp:
        raise ValueError(f"a batch of {batch} does not split over "
                         f"dp={mesh.dp} data ranks")
    n = batch // mesh.dp
    return slice(mesh.dp_index * n, (mesh.dp_index + 1) * n)


# layer-dict weight roles: column-parallel ([.., K, N] sharded on N) for the
# qkv/up projections including their fused forms, row-parallel (sharded on
# K) for the output projections whose partial sums all-reduce
_COL_W = ("wq", "wk", "wv", "wqkv", "w_gate", "w_up", "w_gateup")
_ROW_W = ("wo", "w_down")
_COL_B = ("bq", "bk", "bv", "bqkv", "b_gate", "b_up", "b_gateup")


def pspecs_for_params(params: dict, cfg: ModelConfig,
                      replicated: bool = False) -> dict:
    """Specs derived from the actual params structure (dense or quantized,
    fused or not; an EAGLE head's too): one spec per dense tensor or
    container, in the dense weight's axes; unknown keys replicate. These
    are the roles ``shard_params`` reads."""
    m = MODEL_AXIS if not replicated else None
    out = {}
    for key, val in params.items():
        if key == "layers":
            out[key] = {name: (P(None, None, m) if name in _COL_W
                               else P(None, m, None) if name in _ROW_W
                               else P(None, m) if name in _COL_B else P())
                        for name in val}
        elif key == "embed":
            out[key] = P(m, None)
        elif key == "lm_head":
            out[key] = P(None, m)
        elif key != "mesh":
            out[key] = P()
    return out


# ---------------------------------------------------------------------------
# Shard construction
# ---------------------------------------------------------------------------

def _kv_heads(cfg: ModelConfig, tp: int, r: int) -> Tuple[int, int]:
    """The KV heads [lo, hi) that rank r's q heads read. Where there are
    fewer KV heads than ranks, each rank holds the one its heads read (the
    heads are replicated across ranks)."""
    Hk = cfg.num_kv_heads
    if Hk >= tp:
        n = Hk // tp
        return r * n, (r + 1) * n
    head = r * (cfg.num_heads // tp) // cfg.q_per_kv
    return head, head + 1


def local_config(cfg: ModelConfig, mesh: Mesh) -> ModelConfig:
    """The config a rank's eager forward runs with: Hq/tp q heads, the KV
    heads those read (Hk/tp, or 1 where Hk < tp) and F/tp intermediate
    columns; ``vocab_size`` stays global (sampling sees gathered logits).
    Raises ValueError, before any launch, for what does not split."""
    tp = mesh.tp
    Hq, Hk = cfg.num_heads, cfg.num_kv_heads
    if Hq % tp or (Hk % tp and tp % Hk):
        raise ValueError(f"{Hq} q heads and {Hk} KV heads do not split over "
                         f"tp={tp}")
    if cfg.intermediate_size % tp:
        raise ValueError(f"intermediate_size {cfg.intermediate_size} does not "
                         f"split over tp={tp}")
    if cfg.vocab_size % tp:
        raise ValueError(f"vocab_size {cfg.vocab_size} does not split over "
                         f"tp={tp} (the embedding and lm_head are "
                         "vocab-parallel)")
    lo, hi = _kv_heads(cfg, tp, 0)
    return cfg.replace(num_heads=Hq // tp, num_kv_heads=hi - lo,
                       intermediate_size=cfg.intermediate_size // tp)


def _copy(t):
    """A tensor or container copied whole (nothing shares the source)."""
    if isinstance(t, QUANTIZED):
        return type(t)(**{f.name: getattr(t, f.name).clone()
                          for f in dataclasses.fields(t)})
    return t.clone()


def _columns(w, ranges):
    """Columns ``ranges`` ([(lo, hi), ...]) of a dense tensor or container
    (every container field ends in N), concatenated in order into new
    storage."""
    def part(lo, hi):
        if isinstance(w, QUANTIZED):
            return type(w)(**{f.name: getattr(w, f.name)[..., lo:hi]
                              for f in dataclasses.fields(w)})
        return w[..., lo:hi]
    return concat_columns([part(lo, hi) for lo, hi in ranges])


def _rows(name: str, w, lo: int, hi: int, tp: int):
    """Rows [lo, hi) of the reduction axis of a dense [.., K, N] weight or
    container. A 4-bit container is repacked from its codes and its
    natural-order absmax, one layer at a time (pair4 interleaves k across
    quarter-planes, so a slice of the packed words is no k range); whole
    64-row blocks keep every scale, so the shard dequantizes to the
    unsharded rows bit for bit."""
    if isinstance(w, Int8Weight):
        return Int8Weight(q=w.q[..., lo:hi, :].clone(), scale=w.scale.clone())
    if not isinstance(w, QUANTIZED):
        return w[..., lo:hi, :].clone()
    if lo % NF4_BLOCK or hi % NF4_BLOCK:
        raise ValueError(
            f"{name}: a {type(w).__name__} row shard of {hi - lo} rows at "
            f"tp={tp} splits its 64-row absmax blocks; 4-bit row-parallel "
            "weights need (K/tp) % 64 == 0")
    g0, g1 = lo // NF4_BLOCK, hi // NF4_BLOCK

    def one(packed, absmax):
        return (_pack_nibbles(_unpack_nibbles(packed)[lo:hi]),
                _am_pack(_am_unpack(absmax)[g0:g1]))

    if w.packed.dim() == 2:
        packed, absmax = one(w.packed, w.absmax)
    else:
        parts = [one(w.packed[i], w.absmax[i])
                 for i in range(w.packed.shape[0])]
        packed = torch.stack([p for p, _ in parts])
        absmax = torch.stack([a for _, a in parts])
    return type(w)(packed=packed, absmax=absmax)


def _shard_layer(name: str, w, cfg: ModelConfig, tp: int, r: int):
    """Rank r's shard of a column- or row-parallel layer-dict entry
    (``_COL_W``, ``_COL_B``, ``_ROW_W``)."""
    Hq, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Fd = cfg.intermediate_size
    q = (r * Hq // tp * Dh, (r + 1) * Hq // tp * Dh)
    k0, k1 = _kv_heads(cfg, tp, r)
    kv = (k0 * Dh, k1 * Dh)
    f = (r * Fd // tp, (r + 1) * Fd // tp)
    if name in ("wq", "bq"):
        return _columns(w, [q])
    if name in ("wk", "wv", "bk", "bv"):
        return _columns(w, [kv])
    if name in ("wqkv", "bqkv"):
        # the fused weight's columns are [q | k | v]: take each part's range
        base = (Hq + Hk) * Dh
        return _columns(w, [q, (Hq * Dh + kv[0], Hq * Dh + kv[1]),
                            (base + kv[0], base + kv[1])])
    if name in ("w_gate", "w_up", "b_gate", "b_up"):
        return _columns(w, [f])
    if name in ("w_gateup", "b_gateup"):
        return _columns(w, [f, (Fd + f[0], Fd + f[1])])
    if name == "wo":
        return _rows(name, w, *q, tp)
    return _rows(name, w, *f, tp)  # w_down


def shard_params(params: dict, cfg: ModelConfig, mesh: Mesh,
                 replicated: bool = False) -> dict:
    """This rank's shard-local params (dense, fused or quantized), with the
    mesh under ``"mesh"``: each tensor or container is split as its spec
    (``pspecs_for_params``) says, a fused one from this rank's own column
    ranges. ``replicated=True`` (a drafter, an EAGLE head) copies every
    tensor whole and attaches no mesh. ``cfg`` is the global config; run
    the forwards with ``local_config(cfg, mesh)``. Raises ValueError
    before any launch for heads, intermediate columns or a vocabulary that
    do not split, and for a 4-bit row shard that splits its absmax
    blocks."""
    specs = pspecs_for_params(params, cfg, replicated)
    if not replicated:
        local_config(cfg, mesh)  # refuses what does not split
    tp, r = mesh.tp, mesh.tp_index
    v = (r * cfg.vocab_size // tp, (r + 1) * cfg.vocab_size // tp)

    def shard(key, val, spec):
        if MODEL_AXIS not in spec:
            return _copy(val)
        if key == "embed":
            return val[v[0]:v[1]].clone()
        if key == "lm_head":
            return _columns(val, [v])
        return _shard_layer(key, val, cfg, tp, r)

    out = {key: ({name: shard(name, w, specs[key][name])
                  for name, w in val.items()} if key == "layers"
                 else shard(key, val, specs[key]))
           for key, val in params.items() if key != "mesh"}
    if not replicated:
        out["mesh"] = mesh
    return out


def shard_cache(cache, cfg: ModelConfig, mesh: Mesh,
                replicated_model: bool = False):
    """This rank's part of a global slotted cache (``KVCache`` or
    ``QuantKVCache``), as ``cache_pspec`` splits it: its data rows and,
    unless ``replicated_model``, the KV heads of its q heads."""
    rows = batch_state_pspecs(mesh, cache.length.shape[0])
    heads = slice(*_kv_heads(cfg, mesh.tp, mesh.tp_index))
    specs = cache_pspec(cfg, replicated_model)
    return type(cache)(**{
        name: getattr(cache, name)[tuple(
            rows if a == DATA_AXIS else heads if a == MODEL_AXIS
            else slice(None) for a in spec)].clone()
        for name, spec in specs.items()})
