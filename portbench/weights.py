"""The benchmark's weights: dense bf16 draws from the configuration's
weight seed (``weights.seed`` in its file), one layer at a time, on the
device. The program receives them to quantize; the plain reference draws
the same ones again after the window and quantizes them itself. Each
tensor group has a generator of its own, seeded from (seed, group), so any
layer can be drawn alone.

The weights are the configuration's, as a deployment's checkpoint is: the
same for every run, whatever the run's seed, which draws the traffic. With
weights drawn from the run's seed, LayerSkip acceptance moved from 31% to
86% between seeds on the Pythia cell, and the tokens per second with it.

A model family is a file: ``families/<model_type>.py`` gives the
yardstick's side of one architecture (``family``), and this module draws
whatever tensors it lists.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

# draws of the tensor groups: (seed, GROUP, layer)
_LAYER, _EMBED, _HEAD, _FINAL = 0, 1, 2, 3

# where a configuration's family files are, unless it names a directory
# under ``family_dir`` (``run.Cell`` names its root's)
FAMILIES = Path(__file__).resolve().parent / "families"
_loaded: Dict[Path, object] = {}


def family(cfg: dict):
    """The family module of the configuration's ``model_type``, loaded by
    path from ``<family_dir>/<model_type>.py``. It gives:

    - ``arch(cfg)``: the sizes and flags both sides use, with at least
      ``L``, ``D``, ``V``, ``Hq``, ``Hk``, ``Dh`` and ``norm`` ("rms" or
      "layer": the final norm's kind);
    - ``tensors(a, i)``: layer ``i``'s tensors in draw order, name ->
      (shape, kind), the kind one of "proj", "norm_w", "norm_b", "bias";
    - ``RESIDUAL``: the names the LayerSkip tail damping scales;
    - ``block(a, i, x, pos, lw, ops)``: layer ``i`` of the float32
      reference (``reference.Ops`` rounds for the control);
    - ``weights_per_token(a)`` and ``keys_scored(a, first, last)``: the
      counts of ``measure.required_flops``;
    - optionally ``build_layers(cfg, dense, fmt)``: how the program stacks
      the drawn layers (``harness.Program``), the one place a family file
      may import the program, inside the function."""
    mt = cfg["model_type"]
    path = Path(cfg.get("family_dir", FAMILIES)) / f"{mt}.py"
    if path not in _loaded:
        if not path.is_file():
            raise ValueError(f"no family file {path} for model_type {mt!r}")
        spec = importlib.util.spec_from_file_location(
            f"portbench_family_{mt}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def arch(cfg: dict) -> dict:
    """Sizes and flags of a configuration file's published keys."""
    return family(cfg).arch(cfg)


def _generator(seed: int, group: int, index: int, device) -> torch.Generator:
    """A generator for one tensor group, from any whole-number seed."""
    state = np.random.SeedSequence(
        [seed % 2 ** 64, group, index]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31 | int(state[1]) >> 1) & (2 ** 63 - 1))
    return g


def _draw(shapes: Dict[str, tuple], g: torch.Generator, device,
          dtype) -> Dict[str, torch.Tensor]:
    """One normal draw for all ``shapes``, split into bf16 views."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=g, dtype=torch.float32,
                       device=device).to(dtype)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def layer(cfg: dict, seed: int, i: int, device,
          dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s dense weights as its family lists them, each with a
    leading layer axis of 1, in one draw: projections
    N(0, init_scale^2), norm weights 1 + N(0, norm_jitter^2), norm biases
    N(0, norm_jitter^2), other biases N(0, init_scale^2). At and past the
    drafter's exit layer the family's residual outputs are multiplied by
    the tail damping."""
    fam = family(cfg)
    listed = fam.tensors(fam.arch(cfg), i)
    w_cfg, dr = cfg["weights"], cfg["drafter"]
    scale, jitter = w_cfg["init_scale"], w_cfg["norm_jitter"]
    g = _generator(seed, _LAYER, i, device)
    out = _draw({name: (1, *shape) for name, (shape, _) in listed.items()},
                g, device, torch.float32)
    for name, (_, kind) in listed.items():
        if kind == "proj" or kind == "bias":
            out[name] = out[name] * scale
        elif kind == "norm_w":
            out[name] = 1.0 + out[name] * jitter
        elif kind == "norm_b":
            out[name] = out[name] * jitter
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
    if i >= dr["exit_layer"]:
        for name in fam.RESIDUAL:
            if name in out:
                out[name] = out[name] * dr["tail_damp"]
    return {k: v.to(dtype) for k, v in out.items()}


def embedding(cfg: dict, seed: int, device,
              dtype=torch.bfloat16) -> torch.Tensor:
    """The [V, D] embedding, N(0, init_scale^2)."""
    a = arch(cfg)
    g = _generator(seed, _EMBED, 0, device)
    return _draw({"e": (a["V"], a["D"])}, g, device, torch.float32)["e"].mul_(
        cfg["weights"]["init_scale"]).to(dtype)


def head(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    """The untied [D, V] output head, N(0, init_scale^2)."""
    a = arch(cfg)
    g = _generator(seed, _HEAD, 0, device)
    return _draw({"h": (a["D"], a["V"])}, g, device, torch.float32)["h"].mul_(
        cfg["weights"]["init_scale"]).to(dtype)


def final_norm(cfg: dict, seed: int, device, dtype=torch.bfloat16
               ) -> Dict[str, Optional[torch.Tensor]]:
    """The final norm's weight (1 + N(0, norm_jitter^2)) and, for a
    LayerNorm, its bias (N(0, norm_jitter^2))."""
    a = arch(cfg)
    jitter = cfg["weights"]["norm_jitter"]
    g = _generator(seed, _FINAL, 0, device)
    d = _draw({"w": (a["D"],), "b": (a["D"],)}, g, device, torch.float32)
    return {"w": (1.0 + d["w"] * jitter).to(dtype),
            "b": (d["b"] * jitter).to(dtype) if a["norm"] == "layer"
            else None}
