"""What the attention kernels take: the argument checks that the wrappers of
``ops/paged_attention.py`` and ``ops/decode_attention.py`` share, and the
constants and shared memory of the kernel body both launch,
``csrc/flash_decode.cuh``.

A wrapper raises on anything the kernel does not take; there is no
fallback to the plain version for a CUDA tensor. The kernels have no
backward (nor have the JAX package's Pallas attention kernels), so a
wrapper refuses, on either device, inputs that want a gradient
(``refuse_grad``): the kernel's output would carry none, silently. The
trainers attend through the plain attention. The model's dispatch asks
``kernel_takes`` first, from the config, and sends a head_dim the kernel
does not take to the plain attention before any launch. The kernel has
instances for head_dims up to 64, 128 and 256 (gemma's); at 256 a block's
shared memory holds bf16 q over bf16 or int8 K/V and f32 q over int8 K/V,
not f32 q over f32 K/V (which stops at 152).
"""
from __future__ import annotations

import torch

MAX_HEAD_DIM = 256
MAX_SHARED_BYTES = 232448   # an H100 block's dynamic shared memory
# q's type as the CUDA entry points take it
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's constants (csrc/flash_decode.cuh): keys per tile, warps per
# block (each owns 16 keys of a tile), query rows per block, spans at most
# (blocks of a cluster), tiles in the staging ring, row slots of a split
# block's inbox
TILE, WARPS, ROWS, MAX_CLUSTER, STAGES = 64, 4, 16, 8, 2
MAX_INBOX = ROWS + MAX_CLUSTER
# the largest head_dim whose bf16 Q fragments live in registers; above it
# the block stages Q in shared memory (kRegQMaxDh)
REG_Q_MAX_DH = 128


def shared_bytes(head_dim: int, q_dtype: torch.dtype, quant: bool) -> int:
    """Dynamic shared memory of one block of the kernel (``flash::layout``):
    the staging ring of K/V tiles in their stored type (rows padded by 16
    bytes; int8 with its scales), which a split block's inbox reuses; the
    warps' partials; for f32 q, Q and the warps' probabilities (for bf16
    q over REG_Q_MAX_DH, Q as bf16 rows of head_dim + 16); the merge's
    per-row numbers; a local block's running state; the 64-bit rows of the
    ring's positions (read by the paged layout)."""
    kv_bytes = 1 if quant else torch.tensor([], dtype=q_dtype).element_size()
    ring = 2 * STAGES * TILE * (head_dim * kv_bytes + 16)
    if quant:
        ring += 2 * STAGES * TILE * 4
    inbox = MAX_INBOX * (head_dim + 2) * 4
    partial = WARPS * ROWS * (head_dim + 2) * 4
    if q_dtype == torch.float32:
        qs = (ROWS * (head_dim + 4) + WARPS * ROWS * (TILE // WARPS + 1)
              + WARPS * ROWS) * 4
    else:
        qs = ROWS * (head_dim + 16) * 2 if head_dim > REG_Q_MAX_DH else 0
    merge = ROWS * (WARPS + 2 + 2 * MAX_CLUSTER) * 4
    return (max(ring, inbox) + partial + qs + merge
            + ROWS * (head_dim + 2) * 4 + STAGES * TILE * 8)


def kernel_takes(head_dim: int, q_dtype: torch.dtype, quant: bool) -> bool:
    """Whether the kernel body has an instance for this head_dim and q's
    type: q float32 or bf16, head_dim a multiple of 8 (16 over int8 K/V)
    up to MAX_HEAD_DIM, and a block's shared memory within the card's."""
    vec = 16 if quant else 8
    return (q_dtype in DTYPE_CODE and head_dim <= MAX_HEAD_DIM
            and head_dim % vec == 0
            and shared_bytes(head_dim, q_dtype, quant) <= MAX_SHARED_BYTES)


def refuse_grad(name: str, *arrays) -> None:
    """Raise, before any launch, where grad mode is on and an input
    requires grad."""
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in arrays):
        raise ValueError(f"{name}: the kernel has no backward, and an input "
                         "requires grad; attend through the plain attention "
                         "(attention_impl='xla') to train, or run under "
                         "torch.no_grad()")


def check_kv_args(name: str, q, k, v, k_scale, v_scale, smem: int):
    """The checks every attention kernel's wrapper shares: q float32 or
    bf16 on a CUDA device; K/V of q's type, or int8 with f32 scales shaped
    like the values without Dh; one head_dim the kernel takes; ``smem``, the
    dynamic shared memory of one of the kernel's blocks, within the card's;
    every array contiguous, q and K/V 16-byte aligned (the kernel stages
    K/V with 16-byte copies and loads q's fragments from device memory)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q on {q.device}, not CUDA")
    quant = k_scale is not None
    arrays = dict(k=k, v=v)
    if quant:
        arrays.update(k_scale=k_scale, v_scale=v_scale)
    for label, a in arrays.items():
        if a.device != q.device:
            raise ValueError(f"{name}: q on {q.device}, {label} on "
                             f"{a.device}")
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: q {q.dtype}; expected one of "
                         f"{sorted(map(str, DTYPE_CODE))}")
    kv_dtype = torch.int8 if quant else q.dtype
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise ValueError(f"{name}: K/V {k.dtype}/{v.dtype}, expected "
                         f"{kv_dtype} with q {q.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} != v {tuple(v.shape)}")
    if quant:
        for label in ("k_scale", "v_scale"):
            s = arrays[label]
            if s.dtype != torch.float32 or s.shape != k.shape[:-1]:
                raise ValueError(f"{name}: {label} {s.dtype} "
                                 f"{tuple(s.shape)}, expected float32 "
                                 f"{tuple(k.shape[:-1])}")
    Dh = q.shape[-1]
    if k.shape[-1] != Dh:
        raise ValueError(f"{name}: q head_dim {Dh}, K/V head_dim "
                         f"{k.shape[-1]}")
    vec = 16 if quant else 8
    if Dh > MAX_HEAD_DIM or Dh % vec != 0:
        raise ValueError(f"{name}: head_dim {Dh} (takes multiples of {vec} "
                         f"up to {MAX_HEAD_DIM})")
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: head_dim {Dh} needs {smem} bytes of "
                         f"shared memory (at most {MAX_SHARED_BYTES})")
    if not (q.is_contiguous()
            and all(a.is_contiguous() for a in arrays.values())):
        raise ValueError(f"{name}: q, K/V and scales must be contiguous")
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: q must be 16-byte aligned")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: K/V must be 16-byte aligned")
