"""Carry the JAX package's params over to the port, through numpy.

The JAX side converts its params with ``np.asarray`` (for example
``jax.tree.map(np.asarray, params)``): a nested dict whose leaves are numpy
arrays, with 4-bit containers whose ``packed`` (int32 pair4 words) and
``absmax`` (bf16) fields are numpy arrays. ``params_from_numpy`` turns that
into the port's params on ``device``. Storage layouts are identical in the
two packages, so nothing is repacked: int32 words pass through unchanged.

bf16 leaves arrive as numpy arrays whose dtype is named ``"bfloat16"``,
which ``torch.from_numpy`` refuses. The port does not import the package
that defines that dtype, so such an array is viewed as int16 and
reinterpreted as ``torch.bfloat16``, bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.quant.core import Int4Weight


def tensor_from_numpy(a: Any, device=None) -> torch.Tensor:
    """One numpy array (bf16 included) -> a tensor on ``device``."""
    a = np.array(a, order="C", copy=True)  # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dict of numpy leaves and INT4 containers -> the port's params
    on ``device`` (``None``: the card). The JAX package's ``Int4Weight``
    becomes the port's; its other 4-bit containers (NF4, FP4) raise."""
    device = resolve_device(device)
    if hasattr(tree, "packed") and hasattr(tree, "absmax"):
        kind = type(tree).__name__
        if kind != "Int4Weight":
            raise NotImplementedError(f"params_from_numpy: {kind} is not "
                                      "ported (only Int4Weight)")
        return Int4Weight(packed=tensor_from_numpy(tree.packed, device),
                          absmax=tensor_from_numpy(tree.absmax, device))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
