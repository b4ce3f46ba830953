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

``arch`` reads a configuration file's published keys into the sizes both
sides use (llama-lineage qwen3 and gpt-neox families).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# draws of the tensor groups: (seed, GROUP, layer)
_LAYER, _EMBED, _HEAD, _FINAL = 0, 1, 2, 3


def arch(cfg: dict) -> dict:
    """Sizes and flags of a configuration file's published keys."""
    mt = cfg["model_type"]
    D, Hq = cfg["hidden_size"], cfg["num_attention_heads"]
    if mt == "qwen3":
        Dh = cfg.get("head_dim", D // Hq)
        return dict(family=mt, L=cfg["num_hidden_layers"], D=D,
                    F=cfg["intermediate_size"], V=cfg["vocab_size"], Hq=Hq,
                    Hk=cfg["num_key_value_heads"], Dh=Dh, rotary_dim=Dh,
                    theta=float(cfg["rope_theta"]),
                    eps=float(cfg["rms_norm_eps"]), norm="rms", qk_norm=True,
                    parallel_residual=False, bias=False, gated=True,
                    act="silu", positions=cfg["max_position_embeddings"])
    if mt == "gpt_neox":
        Dh = D // Hq
        rd = int(Dh * cfg["rotary_pct"])
        return dict(family=mt, L=cfg["num_hidden_layers"], D=D,
                    F=cfg["intermediate_size"], V=cfg["vocab_size"], Hq=Hq,
                    Hk=Hq, Dh=Dh, rotary_dim=rd - rd % 2,
                    theta=float(cfg["rotary_emb_base"]),
                    eps=float(cfg["layer_norm_eps"]), norm="layer",
                    qk_norm=False,
                    parallel_residual=bool(cfg["use_parallel_residual"]),
                    bias=True, gated=False, act=cfg["hidden_act"],
                    positions=cfg["max_position_embeddings"])
    raise ValueError(f"no architecture for model_type {mt!r}")


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
    """Layer ``i``'s dense weights, each with a leading layer axis of 1:
    projections N(0, init_scale^2), norm weights 1 + N(0, norm_jitter^2)
    (norm biases and projection biases N(0, norm_jitter^2) and
    N(0, init_scale^2)). At and past the drafter's exit layer the residual
    outputs (``wo``, ``w_down`` and their biases) are multiplied by the
    tail damping."""
    a = arch(cfg)
    w_cfg, dr = cfg["weights"], cfg["drafter"]
    scale, jitter = w_cfg["init_scale"], w_cfg["norm_jitter"]
    D, F, Dh, Hq, Hk = a["D"], a["F"], a["Dh"], a["Hq"], a["Hk"]
    shapes = {"wq": (1, D, Hq * Dh), "wk": (1, D, Hk * Dh),
              "wv": (1, D, Hk * Dh), "wo": (1, Hq * Dh, D),
              "w_up": (1, D, F), "w_down": (1, F, D)}
    if a["gated"]:
        shapes["w_gate"] = (1, D, F)
    norms = {"attn_norm_w": (1, D), "mlp_norm_w": (1, D)}
    if a["qk_norm"]:
        norms.update(q_norm_w=(1, Dh), k_norm_w=(1, Dh))
    biases = {}
    if a["norm"] == "layer":
        biases.update(attn_norm_b=(1, D), mlp_norm_b=(1, D))
    if a["bias"]:
        biases.update(bq=(1, Hq * Dh), bk=(1, Hk * Dh), bv=(1, Hk * Dh),
                      bo=(1, D), b_up=(1, F), b_down=(1, D))
    g = _generator(seed, _LAYER, i, device)
    out = _draw({**shapes, **norms, **biases}, g, device, torch.float32)
    for name in shapes:
        out[name] = out[name] * scale
    for name in norms:
        out[name] = 1.0 + out[name] * jitter
    for name in biases:
        s = jitter if name.endswith("norm_b") else scale
        out[name] = out[name] * s
    if i >= dr["exit_layer"]:
        for name in ("wo", "w_down", "bo", "b_down"):
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
