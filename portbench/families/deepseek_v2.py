"""The ``deepseek_v2`` family (DeepseekV2ForCausalLM without a q low-rank,
DeepSeek-V2-Lite), the yardstick's side: RMSNorm; multi-head latent
attention, whose keys and values come from one normed latent a position
and a rope key every head shares, rope on interleaved pairs with YaRN's
frequencies and the softmax scale times YaRN's mscale(factor,
mscale_all_dim) squared, as DeepSeek's code applies it; layers before
``first_k_dense_replace`` a dense SwiGLU, the others DeepSeekMoE: a
softmax router over the routed experts, the ``num_experts_per_tok`` best
weighted by their probabilities (times ``routed_scaling_factor``), and
``n_shared_experts`` shared experts fused as one SwiGLU of their summed
width.

The router is drawn as the harness's dense kind ("bias": N(0,
init_scale^2), kept as drawn): the harness's "proj" kind would be
quantized by the reference, and DeepSeek serves its router dense; so do
both sides here.

``arch``'s ``Dh`` is 160, so that ``measure.required_flops``'
4 * Hq * Dh operations a scored key are the decompressed form's
2 * (192 + 128) a head: the q.k product over the 192 wide q and key, and
the weighted sum of the 128 wide value. ``Hk`` is Hq, the heads of that
form; the cache holds neither, only the latent stream.
"""
import math

import torch

from portbench.measure import causal_keys
from portbench.reference import rms

# the residual outputs that the LayerSkip tail damping scales
RESIDUAL = ("wo", "w_down", "shared_down", "experts_down")


def arch(cfg: dict) -> dict:
    rs = cfg.get("rope_scaling") or {}
    nope, rope_d = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    factor = float(rs.get("factor", 1.0))

    def mscale(m):
        return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0
    scale = (nope + rope_d) ** -0.5
    if rs.get("mscale_all_dim"):
        scale *= mscale(rs["mscale_all_dim"]) ** 2
    Hq = cfg["num_attention_heads"]
    return dict(family=cfg["model_type"], L=cfg["num_hidden_layers"],
                D=cfg["hidden_size"], F=cfg["intermediate_size"],
                Fe=cfg["moe_intermediate_size"], V=cfg["vocab_size"], Hq=Hq,
                Hk=Hq, Dh=(nope + rope_d + cfg["v_head_dim"]) // 2,
                nope=nope, rope=rope_d, r=cfg["kv_lora_rank"],
                v=cfg["v_head_dim"], E=cfg["n_routed_experts"],
                top_k=cfg["num_experts_per_tok"],
                shared=cfg["n_shared_experts"],
                dense=cfg["first_k_dense_replace"],
                route_scale=float(cfg.get("routed_scaling_factor", 1.0)),
                theta=float(cfg["rope_theta"]),
                eps=float(cfg["rms_norm_eps"]), norm="rms", yarn=dict(rs),
                scale=scale, positions=cfg["max_position_embeddings"])


def tensors(a: dict, i: int) -> dict:
    """Layer ``i``'s tensors in draw order: name -> (shape, kind)."""
    D, H, r = a["D"], a["Hq"], a["r"]
    out = {"wq": ((D, H * (a["nope"] + a["rope"])), "proj"),
           "w_kva": ((D, r + a["rope"]), "proj"),
           "w_kvb": ((r, H * (a["nope"] + a["v"])), "proj"),
           "wo": ((H * a["v"], D), "proj"),
           "attn_norm_w": ((D,), "norm_w"), "mlp_norm_w": ((D,), "norm_w"),
           "kv_norm_w": ((r,), "norm_w")}
    if i < a["dense"]:
        out.update(w_gate=((D, a["F"]), "proj"), w_up=((D, a["F"]), "proj"),
                   w_down=((a["F"], D), "proj"))
        return out
    E, Fe, Fs = a["E"], a["Fe"], a["Fe"] * a["shared"]
    out.update(router=((D, E), "bias"),
               shared_gate=((D, Fs), "proj"), shared_up=((D, Fs), "proj"),
               shared_down=((Fs, D), "proj"),
               experts_gate=((E, D, Fe), "proj"),
               experts_up=((E, D, Fe), "proj"),
               experts_down=((E, Fe, D), "proj"))
    return out


def _inv_freq(a: dict, device) -> torch.Tensor:
    """YaRN's inverse frequencies of the rope dims (truncated ramp)."""
    dim, base, rs = a["rope"], a["theta"], a["yarn"]
    inv = base ** (-torch.arange(0, dim, 2, dtype=torch.float64,
                                 device=device) / dim)
    if not rs:
        return inv
    f, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(
            base))
    lo = max(math.floor(corr(rs.get("beta_fast", 32))), 0)
    hi = min(math.ceil(corr(rs.get("beta_slow", 1))), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device) - lo)
            / max(hi - lo, 1e-3)).clamp(0, 1)
    return inv / f * ramp + inv * (1 - ramp)


def rope_pairs(a: dict, x, pos):
    """Interleaved-pair rotation of x [T, H, rope] at positions pos [T]
    (the cos/sin factor is 1 where mscale equals mscale_all_dim)."""
    ang = pos.to(torch.float64)[:, None] * _inv_freq(a, x.device)[None, :]
    c = torch.cos(ang).float()[:, None, :]
    s = torch.sin(ang).float()[:, None, :]
    p = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([p[..., 0] * c - p[..., 1] * s,
                        p[..., 0] * s + p[..., 1] * c], -1).reshape(x.shape)


def block(a: dict, i: int, x, pos, lw: dict, ops):
    T, H, nope, R, r, v = (x.shape[0], a["Hq"], a["nope"], a["rope"],
                           a["r"], a["v"])
    eps = a["eps"]
    h = rms(x, lw["attn_norm_w"], eps)
    q = ops.mm(h, lw["wq"]).view(T, H, nope + R)
    kva = ops.mm(h, lw["w_kva"])
    c = ops.r(rms(kva[:, :r], lw["kv_norm_w"], eps))
    k_pe = ops.r(rope_pairs(a, kva[:, None, r:], pos))
    kv = ops.mm(c, lw["w_kvb"]).view(T, H, nope + v)
    q = ops.r(torch.cat([q[..., :nope], rope_pairs(a, q[..., nope:], pos)],
                        -1))
    k = torch.cat([kv[..., :nope], k_pe.expand(T, H, R)], -1)
    # attend divides the scores by sqrt(q's width); the model's scale
    # carries mscale^2 besides
    o = ops.attend(q * (a["scale"] * (nope + R) ** 0.5), k, kv[..., nope:])
    x = x + ops.mm(o.reshape(T, H * v), lw["wo"])
    m = rms(x, lw["mlp_norm_w"], eps)
    silu = torch.nn.functional.silu
    if i < a["dense"]:
        u = silu(ops.mm(m, lw["w_gate"])) * ops.mm(m, lw["w_up"])
        return ops.r(x + ops.mm(u, lw["w_down"]))
    probs = torch.softmax(m @ lw["router"], dim=-1)
    w, idx = probs.topk(a["top_k"], dim=-1)
    w = w * a["route_scale"]
    y = torch.zeros_like(x)
    for e in range(a["E"]):
        hit = (idx == e)
        rows = hit.any(-1).nonzero()[:, 0]
        if len(rows):
            me = m[rows]
            u = silu(ops.mm(me, lw["experts_gate"][e])) * ops.mm(
                me, lw["experts_up"][e])
            y[rows] += (w[rows] * hit[rows]).sum(-1, keepdim=True) * ops.mm(
                u, lw["experts_down"][e])
    u = silu(ops.mm(m, lw["shared_gate"])) * ops.mm(m, lw["shared_up"])
    return ops.r(x + ops.r(y) + ops.mm(u, lw["shared_down"]))


def weights_per_token(a: dict) -> int:
    """The layers' matrix weights one token multiplies: attention (q, kv_a,
    kv_b, o), then layer 0's SwiGLU, or the router, the shared experts and
    ``top_k`` routed experts."""
    D, H, r = a["D"], a["Hq"], a["r"]
    attn = (D * H * (a["nope"] + a["rope"]) + D * (r + a["rope"])
            + r * H * (a["nope"] + a["v"]) + H * a["v"] * D)
    moe = D * a["E"] + 3 * D * a["Fe"] * (a["shared"] + a["top_k"])
    dense = 3 * D * a["F"]
    return a["L"] * attn + a["dense"] * dense + (a["L"] - a["dense"]) * moe


def keys_scored(a: dict, first: int, last: int) -> int:
    """Keys scored by the tokens at positions first..last-1, summed over
    the layers."""
    return a["L"] * causal_keys(first, last)


def build_layers(cfg, dense, fmt):
    """The program's layers: a list of per-layer dicts (layer 0 dense, the
    rest expert stacks), each quantized by the program's
    ``quantize_params(kind=fmt, fuse=True, cfg=...)`` (each expert's
    matrix alone; the router stays dense; latent attention's absorbed
    weights, ``w_kvb``'s INT4 values in float32, set once there)."""
    import torch as _torch

    from specdec_tpu_torch.core.hf_loader import config_from_hf
    from specdec_tpu_torch.quant.core import quantize_params

    pcfg = config_from_hf(cfg, dtype=_torch.bfloat16)
    out = []
    for d in dense:
        out.append(quantize_params(
            {"layers": {k: v[0] for k, v in d.items()}}, kind=fmt,
            fuse=True, cfg=pcfg)["layers"])
        del d
    return out
