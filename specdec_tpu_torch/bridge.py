"""Carry the JAX package's params over to the port, through numpy.

The JAX side converts its params with ``np.asarray`` (for example
``jax.tree.map(np.asarray, params)``): a nested dict whose leaves are numpy
arrays, with quantized containers whose fields are numpy arrays
(``Int8Weight``: int8 ``q`` and f32 ``scale``; ``NF4Weight``, ``FP4Weight``
and ``Int4Weight``: int32 pair4 ``packed`` words and bf16 ``absmax``).
``params_from_numpy`` turns that into the port's params on ``device``.
Storage layouts are identical in the two packages, so nothing is repacked:
int32 words and bf16 scales pass through unchanged.

bf16 leaves arrive as numpy arrays whose dtype is named ``"bfloat16"``,
which ``torch.from_numpy`` refuses. The port does not import the package
that defines that dtype, so such an array is viewed as int16 and
reinterpreted as ``torch.bfloat16``, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.quant.core import QUANTIZED

# the port's container of each JAX container, by type name
_CONTAINERS = {cls.__name__: cls for cls in QUANTIZED}


def tensor_from_numpy(a: Any, device=None) -> torch.Tensor:
    """One numpy array (bf16 included) -> a tensor on ``device``."""
    a = np.array(a, order="C", copy=True)  # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dict of numpy leaves and quantized containers -> the port's
    params on ``device`` (``None``: the card). Each JAX container
    (``Int8Weight``, ``NF4Weight``, ``FP4Weight``, ``Int4Weight``) becomes
    the port's container of the same name, field by field."""
    device = resolve_device(device)
    cls = _CONTAINERS.get(type(tree).__name__)
    if cls is not None:
        return cls(**{f.name: tensor_from_numpy(getattr(tree, f.name), device)
                      for f in dataclasses.fields(cls)})
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
