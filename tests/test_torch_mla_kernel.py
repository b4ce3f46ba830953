"""The MLA decode kernel's wrapper (``ops/mla_attention.py``) on the CPU:
its plain version against the absorbed form's float32 arithmetic as it was
written before the kernel (the form in plain PyTorch over the stream as
stored, the paged pool gathered first), in both layouts; the arguments it
refuses before any launch; and how it cuts a sequence's rows into groups.

The CUDA kernel itself runs on the card only (``chip_smoke.py`` phase 4f
holds it to this plain version at DeepSeek-V2-Lite's widths); what the CPU
can check is the arithmetic the kernel is held to and the wrapper's
checks.
"""
from __future__ import annotations

import types

import pytest
import torch

from specdec_tpu_torch.core import mla
from specdec_tpu_torch.core.paged_cache import gather_pages
from specdec_tpu_torch.ops import _build
from specdec_tpu_torch.ops import mla_attention as ma

# tiny widths: 4 heads, latent 32, rope 16, qk_nope 16, v 24
H, R, ROPE, NOPE, V = 4, 32, 16, 16, 24
PAGE, MP = 8, 6
SCALE = 0.37


def _old_absorbed(lp, q_nope, q_pe, lat_all, q_pos):
    """The absorbed form before the kernel (lat_all [B, S, R + ROPE])."""
    B, T, _, _ = q_nope.shape
    S = lat_all.shape[1]
    q_lat = torch.einsum("bthn,hrn->bthr", q_nope.to(torch.float32),
                         lp["w_uk"])
    q = torch.cat([q_lat, q_pe.to(torch.float32)], dim=-1)
    lat = lat_all.to(torch.float32)
    scores = torch.einsum("bthd,bsd->bhts", q, lat) * SCALE
    k_pos = torch.arange(S)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]
    probs = torch.softmax(scores.masked_fill(~mask[:, None], -1e30), dim=-1)
    o_lat = torch.einsum("bhts,bsr->bthr", probs, lat[..., :R])
    out = torch.einsum("bthr,hrv->bthv", o_lat, lp["w_uv"])
    return out.to(q_nope.dtype).reshape(B, T, -1)


def _inputs(T, layout, seed):
    """Ragged offsets over a capacity of MP * PAGE positions; paged: the
    pages in a shuffled order behind the tables, sequence 1 dead (its table
    all garbage page 0, its offset stale)."""
    g = torch.Generator().manual_seed(seed)
    B, cap = 3, MP * PAGE
    lp = {"w_uk": torch.randn(H, R, NOPE, generator=g),
          "w_uv": torch.randn(H, R, V, generator=g)}
    q_nope = torch.randn(B, T, H, NOPE, generator=g)
    q_pe = torch.randn(B, T, H, ROPE, generator=g)
    offsets = torch.tensor([0, 13, cap - T], dtype=torch.int32)
    q_pos = offsets[:, None] + torch.arange(T, dtype=torch.int32)[None]
    if layout == "slotted":
        lat = torch.randn(B, cap, 1, R + ROPE, generator=g)
        return lp, q_nope, q_pe, lat, None, q_pos, lat[:, :, 0]
    pool = torch.randn(B * MP + 1, 1, PAGE, R + ROPE, generator=g)
    table = (torch.randperm(B * MP, generator=g) + 1).reshape(B, MP).to(
        torch.int32)
    table[1] = 0
    return (lp, q_nope, q_pe, pool, table, q_pos,
            gather_pages(pool, table)[:, :, 0])


@pytest.mark.parametrize("layout", ["slotted", "paged"])
@pytest.mark.parametrize("T", [1, 2, 5, 15])
def test_plain_version_is_the_absorbed_arithmetic(T, layout):
    """``mla.absorbed`` through the wrapper's plain version gives the
    float32 absorbed form's numbers bit for bit: the same einsums over the
    same values, the paged stream read through the table position by
    position instead of gathered page by page (the dead row included: it
    attends over the garbage page on both sides)."""
    lp, q_nope, q_pe, lat, table, q_pos, lat_all = _inputs(T, layout, T)
    cfg = types.SimpleNamespace(attn_scale=SCALE, kv_lora_rank=R)
    got = mla.absorbed(cfg, lp, q_nope, q_pe, lat, q_pos, table)
    assert torch.equal(got, _old_absorbed(lp, q_nope, q_pe, lat_all, q_pos))


def _valid(layout="slotted"):
    """bf16 arguments at the kernel's widths (D 576, rank 512)."""
    q = torch.zeros(2, 1, 16, ma.KERNEL_DIM, dtype=torch.bfloat16)
    off = torch.tensor([3, 5], dtype=torch.int32)
    if layout == "slotted":
        return q, torch.zeros(2, 8, 1, ma.KERNEL_DIM,
                              dtype=torch.bfloat16), off, None
    return (q, torch.zeros(5, 1, 4, ma.KERNEL_DIM, dtype=torch.bfloat16),
            off, torch.ones(2, 2, dtype=torch.int32))


def _bad(case):
    """(q, lat, offsets, rank, table) with one thing the kernel refuses."""
    paged = case.startswith("table")
    q, lat, off, table = _valid("paged" if paged else "slotted")
    rank = ma.KERNEL_RANK
    if case == "q_float32":
        q = q.float()
    elif case == "latent_float32":
        lat = lat.float()
    elif case == "width":
        q, lat = q[..., :512].contiguous(), lat[..., :512].contiguous()
    elif case == "rank":
        rank = 256
    elif case == "q_strided":
        q = torch.zeros(2, 1, 16, 2 * ma.KERNEL_DIM,
                        dtype=torch.bfloat16)[..., ::2]
    elif case == "latent_strided":
        lat = torch.zeros(2, 8, 1, 2 * ma.KERNEL_DIM,
                          dtype=torch.bfloat16)[..., ::2]
    elif case == "latent_heads":
        lat = torch.zeros(2, 8, 2, ma.KERNEL_DIM, dtype=torch.bfloat16)
    elif case == "latent_batch":
        lat = torch.zeros(3, 8, 1, ma.KERNEL_DIM, dtype=torch.bfloat16)
    elif case == "offsets_int64":
        off = off.long()
    elif case == "offsets_shape":
        off = off[:1]
    elif case == "table_int64":
        table = table.long()
    elif case == "table_batch":
        table = table[:1]
    return q, lat, off, rank, table


@pytest.mark.parametrize("case", [
    "q_float32", "latent_float32", "width", "rank", "q_strided",
    "latent_strided", "latent_heads", "latent_batch", "offsets_int64",
    "offsets_shape", "table_int64", "table_batch"])
def test_kernel_arguments_refused(case):
    """What the kernel does not take raises ValueError in the checks the
    CUDA branch runs before any launch; the valid arguments pass."""
    for layout in ("slotted", "paged"):
        q, lat, off, table = _valid(layout)
        ma.check_args(q, lat, off, ma.KERNEL_RANK, table)
    with pytest.raises(ValueError, match="mla_decode_attention"):
        ma.check_args(*_bad(case))


def test_no_launch_off_cuda_or_without_the_library(tmp_path, monkeypatch):
    """A tensor on neither the CPU nor a CUDA device is refused; the launch
    loads the library before it touches the card, so without the built
    library and without nvcc it raises, and nothing is counted."""
    before = ma.mla_decode_attention.launches
    q, lat, off, _ = _valid()
    with pytest.raises(ValueError, match="not CUDA"):
        ma.mla_decode_attention(q.to("meta"), lat.to("meta"), off.to("meta"),
                                SCALE, ma.KERNEL_RANK)

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        ma._launch(q, lat, off, SCALE, None)
    assert ma.mla_decode_attention.launches == before


def test_wrapper_refuses_grad():
    """The kernel has no backward: inputs that want a gradient are refused
    on either device, as the attention kernels' wrappers do."""
    q, lat, off, _ = _valid()
    with pytest.raises(ValueError, match="no backward"):
        ma.mla_decode_attention(q.float().requires_grad_(), lat.float(), off,
                                SCALE, ma.KERNEL_RANK)


@pytest.mark.parametrize("T,H,want", [
    (1, 16, (1, 1)), (2, 16, (1, 2)), (4, 16, (1, 5)), (5, 16, (1, 5)),
    (6, 16, (2, 3)), (15, 16, (3, 5)), (3, 4, (1, 1)), (7, 128, (12, 5))])
def test_row_groups(T, H, want):
    """A sequence's T * H rows in the fewest groups of at most 5 m-tiles of
    16, spread evenly: 80 rows (T = 5 at 16 heads) are one block; 4 m-tiles
    take the 5-tile instance."""
    groups, mt = ma.row_groups(T, H)
    assert (groups, mt) == want
    assert groups * mt * ma.ROW_TILE >= T * H
    assert mt in (1, 2, 3, 5)
