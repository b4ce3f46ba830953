"""specdec_tpu_torch — the PyTorch/CUDA port of ``specdec_tpu``.

The package mirrors the JAX package's module layout and function names
(``core/model.py::forward_step`` here is the counterpart of
``specdec_tpu/core/model.py::forward_step``), so each function has an
obvious reference. Inside, it is plain PyTorch: eager functions on tensors,
small dataclasses, an explicit ``device`` and explicit ``torch.Generator``s.

Every TPU (Pallas) kernel on a ported path has a hand-written CUDA kernel
here (``ops/csrc``). A kernel wrapper computes its plain PyTorch version
only for tensors that lie on the CPU; on a CUDA tensor it launches the
kernel or raises.

The package never imports ``jax`` or ``specdec_tpu``; only its tests import
both, to hold the port against the reference.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``). Raises when a CUDA device is
    asked for and none is present: the port never carries on silently on
    the CPU; callers that want the CPU (the tests) say ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "specdec_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    return dev
