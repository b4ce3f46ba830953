"""Parameter checkpoints: persist trained drafters (EAGLE heads, distilled
drafters) and trained targets (counterpart of
``specdec_tpu/engine/checkpoint.py``).

A checkpoint is a directory, as in the JAX package, refused when it exists
unless ``overwrite=True``. The format is the port's own, not orbax's: one
``params.pt`` written by ``torch.save``, holding a flat dict of the tree's
tensors by ``/``-joined path and the class name of each quantized
container's path (``Int8Weight``, ``NF4Weight``, ``FP4Weight``,
``Int4Weight``, field by field). It is read back with
``weights_only=True``, so loading runs no pickled code, and restores every
tensor's dtype and bits. Parameters cross between the two packages through
``bridge.py`` and numpy, not through checkpoints.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.quant.core import QUANTIZED

FILE = "params.pt"
FORMAT = "specdec_tpu_torch-params-1"
_CONTAINERS = {cls.__name__: cls for cls in QUANTIZED}


def _flatten(tree: Any, prefix: str, tensors: Dict[str, torch.Tensor],
             containers: Dict[str, str]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in k or "." in k:
                raise ValueError(f"parameter name {k!r} holds '/' or '.'")
            _flatten(v, f"{prefix}/{k}" if prefix else k, tensors,
                     containers)
    elif isinstance(tree, QUANTIZED):
        containers[prefix] = type(tree).__name__
        for f in dataclasses.fields(tree):
            tensors[f"{prefix}.{f.name}"] = getattr(tree, f.name)
    else:
        tensors[prefix] = tree


def save_params(path: str, params: Any, overwrite: bool = False) -> str:
    """Save a params tree (nested dicts of tensors and quantized containers)
    to directory ``path``; returns its absolute path."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(f"{path} exists; pass overwrite=True to "
                                  "replace it")
        shutil.rmtree(path)
    tensors, containers = {}, {}
    _flatten(params, "", tensors, containers)
    os.makedirs(path)
    torch.save({"format": FORMAT, "containers": containers,
                "tensors": {k: t.detach().cpu() for k, t in tensors.items()}},
               os.path.join(path, FILE))
    return path


def load_params(path: str, device=None) -> Any:
    """Restore a params tree saved by ``save_params`` onto ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    data = torch.load(os.path.join(path, FILE), map_location="cpu",
                      weights_only=True)
    if data.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    tree: Dict[str, Any] = {}
    fields: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, t in data["tensors"].items():
        t = t.to(device)
        name, dot, field = key.partition(".")
        if dot:
            fields.setdefault(name, {})[field] = t
            continue
        _insert(tree, name, t)
    for name, cls in data["containers"].items():
        _insert(tree, name, _CONTAINERS[cls](**fields[name]))
    return tree


def _insert(tree: Dict[str, Any], path: str, value: Any) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value
