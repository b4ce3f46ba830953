"""MLA decode attention: the CUDA kernel's wrapper and its plain PyTorch
version (``csrc/mla_decode_attention.cu``, the absorbed form of
``core/mla.py``).

``mla_decode_attention(q, lat, offsets, scale, rank, page_table)`` attends
the absorbed query q [B, T, H, D] (D = rank + the shared rope width: the
latent-wide query a head, then its rope part) over one layer's latent
stream as the cache stores it, and returns the latent output o_lat
[B, T, H, rank] in float32 (``core/mla.py`` takes it through W_UV):

- slotted: ``lat`` is one layer of the slotted cache, [B, S, 1, D], and
  ``page_table`` None;
- paged: ``lat`` is one layer of the page pool, [NP, 1, page, D], read
  through ``page_table`` [B, MP] (capacity MP * page); a sequence whose
  table starts at page 0, the scheduler's garbage page, is a dead slot.

Query row (t, h) of sequence b attends the positions s <= offsets[b] + t:
scores q . c_s times ``scale`` (the model's softmax scale), softmax and the
weighted sum of the positions' first ``rank`` values, in float32.

On a CPU tensor the wrapper computes the plain version,
``mla_attention_reference``: the float32 arithmetic of the absorbed form
before the kernel, over the stream read through the page table position by
position (no ``gather_pages``). On a CUDA tensor it launches the kernel or
raises: q and the stream bf16 (the served model's activations), D = 576
and rank = 512 (DeepSeek-V2's latent and rope widths), every array
contiguous on q's device. The kernel reads each live latent byte once a
layer and sequence (T * H rows in a block, up to 80; more are cut into row
groups), only up to each sequence's offset + T, and gives a dead slot zeros
where the plain version attends over the garbage page: both finite, both
dropped by the caller. It refuses inputs that want a gradient on either
device (``attention_args.refuse_grad``). Each call is two launches, the
split kernel and the combine of its partials, counted once in
``mla_decode_attention.launches``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from specdec_tpu_torch.ops.attention_args import refuse_grad

# the widths the kernel takes: DeepSeek-V2's latent and its rope key
KERNEL_RANK, KERNEL_DIM = 512, 576
# query rows of a block: m-tiles of 16, at most 5
ROW_TILE, MAX_ROW_TILES = 16, 5

_NEG_INF = -1e30
_sm_count: Dict[int, int] = {}


def _stream_rows(lat: torch.Tensor, page_table: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The stream [B, S, D] of one layer: the slotted layer itself, or the
    pool's rows read position by position through the page table."""
    if page_table is None:
        return lat[:, :, 0]
    NP, _, page, D = lat.shape
    B, MP = page_table.shape
    pos = torch.arange(MP * page, device=lat.device)
    rows = page_table.to(torch.int64)[:, pos // page] * page + pos % page
    return lat.reshape(NP * page, D)[rows]


def mla_attention_reference(q: torch.Tensor, lat: torch.Tensor,
                            offsets: torch.Tensor, scale: float, rank: int,
                            page_table: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain version, in float32: [B, T, H, rank]."""
    B, T, H, _ = q.shape
    stream = _stream_rows(lat, page_table).to(torch.float32)
    S = stream.shape[1]
    q_pos = offsets.to(torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32, device=q.device)[None, :]
    scores = torch.einsum("bthd,bsd->bhts", q.to(torch.float32),
                          stream) * scale
    k_pos = torch.arange(S, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]             # [B, T, S]
    probs = torch.softmax(scores.masked_fill(~mask[:, None], _NEG_INF),
                          dim=-1)
    return torch.einsum("bhts,bsr->bthr", probs, stream[..., :rank])


def row_groups(T: int, H: int) -> Tuple[int, int]:
    """(groups, m-tiles a group): a sequence's T * H query rows in the
    fewest groups of at most MAX_ROW_TILES m-tiles of 16, the rows spread
    evenly over them. The kernel has instances of 1, 2, 3 and 5 m-tiles
    (one of 4 spills registers): 4 take the 5-tile one, its last 16 rows
    empty."""
    tiles = -(-T * H // ROW_TILE)
    groups = -(-tiles // MAX_ROW_TILES)
    mt = -(-tiles // groups)
    return groups, 5 if mt == 4 else mt


def check_args(q, lat, offsets, rank, page_table):
    """Raise ValueError for what the kernel does not take: q [B, T, H, 576]
    and the latent bf16, rank 512, the latent one layer of either layout,
    offsets int32 [B], the page table int32 [B, MP], each contiguous on q's
    device, q and the latent 16-byte aligned (the kernel stages rows with
    16-byte copies)."""
    name = "mla_decode_attention"
    if q.dim() != 4 or q.shape[-1] != KERNEL_DIM or rank != KERNEL_RANK:
        raise ValueError(f"{name}: q {tuple(q.shape)}, rank {rank}; the "
                         f"kernel takes [B, T, H, {KERNEL_DIM}] over a "
                         f"{KERNEL_RANK}-wide latent")
    if q.dtype != torch.bfloat16 or lat.dtype != torch.bfloat16:
        raise ValueError(f"{name}: q {q.dtype}, latent {lat.dtype}; the "
                         "kernel takes bf16 for both")
    B = q.shape[0]
    heads = lat.shape[1 if page_table is not None else 2] if (
        lat.dim() == 4) else 0
    if heads != 1 or lat.shape[-1] != KERNEL_DIM:
        raise ValueError(f"{name}: latent {tuple(lat.shape)}, expected one "
                         f"layer [B, S, 1, {KERNEL_DIM}] or [NP, 1, page, "
                         f"{KERNEL_DIM}]")
    if page_table is None and lat.shape[0] != B:
        raise ValueError(f"{name}: slotted latent of {lat.shape[0]} "
                         f"sequences for batch {B}")
    if offsets.dtype != torch.int32 or offsets.shape != (B,):
        raise ValueError(f"{name}: offsets {offsets.dtype} "
                         f"{tuple(offsets.shape)}, expected int32 ({B},)")
    arrays = [q, lat, offsets]
    if page_table is not None:
        if page_table.dtype != torch.int32 or page_table.dim() != 2 or (
                page_table.shape[0] != B):
            raise ValueError(f"{name}: page table {page_table.dtype} "
                             f"{tuple(page_table.shape)}, expected int32 "
                             f"[{B}, MP]")
        arrays.append(page_table)
    for a in arrays:
        if a.device != q.device or not a.is_contiguous():
            raise ValueError(f"{name}: q, the latent, offsets and the page "
                             f"table must be contiguous on {q.device}")
    if q.data_ptr() % 16 or lat.data_ptr() % 16:
        raise ValueError(f"{name}: q and the latent must be 16-byte aligned")


def _launch(q, lat, offsets, scale, page_table):
    """Load the library (built first where needed: raises without nvcc),
    then launch on the current stream."""
    from specdec_tpu_torch.ops._build import load

    fn = load("mla_decode_attention").mla_decode_attention
    B, T, H, _ = q.shape
    groups, mt = row_groups(T, H)
    dev = q.device.index if q.device.index is not None else (
        torch.cuda.current_device())
    grid = _sm_count.get(dev)
    if grid is None:
        grid = _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    rows = ROW_TILE * mt
    out = torch.empty((B, T, H, KERNEL_RANK), dtype=torch.float32,
                      device=q.device)
    ws_acc = torch.empty((grid, 2, rows, KERNEL_RANK), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((grid, 2, rows, 2), dtype=torch.float32,
                        device=q.device)
    if page_table is None:
        S, slot_stride, MP, page, table = lat.shape[1], lat.stride(0), 0, 0, 0
    else:
        MP, page = page_table.shape[1], lat.shape[2]
        S, slot_stride, table = MP * page, 0, page_table.data_ptr()
    err = fn(
        q.data_ptr(), lat.data_ptr(), offsets.data_ptr(), table or None,
        out.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(), B, T, H, S,
        slot_stride, MP, page, groups, mt, grid, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_decode_attention launch failed: CUDA error "
                           f"{err}")
    return out


def mla_decode_attention(q: torch.Tensor, lat: torch.Tensor,
                         offsets: torch.Tensor, scale: float, rank: int,
                         page_table: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q [B, T, H, D] in the activation dtype; ``lat`` one layer of the
    slotted cache [B, S, 1, D] (``page_table`` None) or of the page pool
    [NP, 1, page, D] (``page_table`` [B, MP] int32); offsets [B] int32.
    Returns o_lat [B, T, H, rank] float32."""
    refuse_grad("mla decode attention kernel", q, lat)
    if q.device.type == "cpu":
        return mla_attention_reference(q, lat, offsets, scale, rank,
                                       page_table)
    if q.device.type != "cuda":
        raise ValueError(f"mla_decode_attention: q on {q.device}, not CUDA")
    check_args(q, lat, offsets, rank, page_table)
    out = _launch(q, lat, offsets, scale, page_table)
    mla_decode_attention.launches += 1
    return out


mla_decode_attention.launches = 0
