"""The ``qwen3`` family (Qwen3ForCausalLM), the yardstick's side: RMSNorm,
per-head q/k RMSNorm, rotate-half RoPE over the whole head,
grouped-query attention over every earlier position, SwiGLU, no biases.
Every layer alike."""
import torch

from portbench.measure import causal_keys
from portbench.reference import rms, rope

# the residual outputs that the LayerSkip tail damping scales
RESIDUAL = ("wo", "w_down")


def arch(cfg: dict) -> dict:
    D, Hq = cfg["hidden_size"], cfg["num_attention_heads"]
    Dh = cfg.get("head_dim", D // Hq)
    return dict(family=cfg["model_type"], L=cfg["num_hidden_layers"], D=D,
                F=cfg["intermediate_size"], V=cfg["vocab_size"], Hq=Hq,
                Hk=cfg["num_key_value_heads"], Dh=Dh, rotary_dim=Dh,
                theta=float(cfg["rope_theta"]),
                eps=float(cfg["rms_norm_eps"]), norm="rms",
                positions=cfg["max_position_embeddings"])


def tensors(a: dict, i: int) -> dict:
    """Layer ``i``'s tensors in draw order: name -> (shape, kind)."""
    D, F, Dh, Hq, Hk = a["D"], a["F"], a["Dh"], a["Hq"], a["Hk"]
    return {"wq": ((D, Hq * Dh), "proj"), "wk": ((D, Hk * Dh), "proj"),
            "wv": ((D, Hk * Dh), "proj"), "wo": ((Hq * Dh, D), "proj"),
            "w_up": ((D, F), "proj"), "w_down": ((F, D), "proj"),
            "w_gate": ((D, F), "proj"),
            "attn_norm_w": ((D,), "norm_w"), "mlp_norm_w": ((D,), "norm_w"),
            "q_norm_w": ((Dh,), "norm_w"), "k_norm_w": ((Dh,), "norm_w")}


def block(a: dict, i: int, x, pos, lw: dict, ops):
    T, Hq, Hk, Dh, eps = x.shape[0], a["Hq"], a["Hk"], a["Dh"], a["eps"]
    h = rms(x, lw["attn_norm_w"], eps)
    q = ops.mm(h, lw["wq"]).view(T, Hq, Dh)
    k = ops.mm(h, lw["wk"]).view(T, Hk, Dh)
    v = ops.mm(h, lw["wv"]).view(T, Hk, Dh)
    q = rms(q, lw["q_norm_w"], eps)
    k = rms(k, lw["k_norm_w"], eps)
    q = ops.r(rope(q, pos, a["rotary_dim"], a["theta"]))
    k = ops.r(rope(k, pos, a["rotary_dim"], a["theta"]))
    x = x + ops.mm(ops.attend(q, k, v).reshape(T, Hq * Dh), lw["wo"])
    m = rms(x, lw["mlp_norm_w"], eps)
    u = torch.nn.functional.silu(ops.mm(m, lw["w_gate"])) * ops.mm(
        m, lw["w_up"])
    return ops.r(x + ops.mm(u, lw["w_down"]))


def weights_per_token(a: dict) -> int:
    """The layers' matrix weights one token multiplies."""
    D, F, Dh, Hq, Hk = a["D"], a["F"], a["Dh"], a["Hq"], a["Hk"]
    return a["L"] * (D * (Hq + 2 * Hk) * Dh + Hq * Dh * D + D * F * 2
                     + F * D)


def keys_scored(a: dict, first: int, last: int) -> int:
    """Keys scored by the tokens at positions first..last-1, summed over
    the layers."""
    return a["L"] * causal_keys(first, last)
