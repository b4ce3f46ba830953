"""The ``gpt_neox`` family (GPTNeoXForCausalLM, Pythia), the yardstick's
side: LayerNorm with biases, biases on every product, rotate-half RoPE on
the first ``rotary_pct`` of each head, multi-head attention over every
earlier position, exact GELU, the parallel residual where the
configuration asks for it. Every layer alike."""
import torch

from portbench.measure import causal_keys
from portbench.reference import ln, rope

RESIDUAL = ("wo", "w_down", "bo", "b_down")


def arch(cfg: dict) -> dict:
    D, Hq = cfg["hidden_size"], cfg["num_attention_heads"]
    Dh = D // Hq
    rd = int(Dh * cfg["rotary_pct"])
    return dict(family=cfg["model_type"], L=cfg["num_hidden_layers"], D=D,
                F=cfg["intermediate_size"], V=cfg["vocab_size"], Hq=Hq,
                Hk=Hq, Dh=Dh, rotary_dim=rd - rd % 2,
                theta=float(cfg["rotary_emb_base"]),
                eps=float(cfg["layer_norm_eps"]), norm="layer",
                parallel_residual=bool(cfg["use_parallel_residual"]),
                act=cfg["hidden_act"],
                positions=cfg["max_position_embeddings"])


def tensors(a: dict, i: int) -> dict:
    """Layer ``i``'s tensors in draw order: name -> (shape, kind)."""
    D, F, Dh, H = a["D"], a["F"], a["Dh"], a["Hq"]
    return {"wq": ((D, H * Dh), "proj"), "wk": ((D, H * Dh), "proj"),
            "wv": ((D, H * Dh), "proj"), "wo": ((H * Dh, D), "proj"),
            "w_up": ((D, F), "proj"), "w_down": ((F, D), "proj"),
            "attn_norm_w": ((D,), "norm_w"), "mlp_norm_w": ((D,), "norm_w"),
            "attn_norm_b": ((D,), "norm_b"), "mlp_norm_b": ((D,), "norm_b"),
            "bq": ((H * Dh,), "bias"), "bk": ((H * Dh,), "bias"),
            "bv": ((H * Dh,), "bias"), "bo": ((D,), "bias"),
            "b_up": ((F,), "bias"), "b_down": ((D,), "bias")}


def block(a: dict, i: int, x, pos, lw: dict, ops):
    T, H, Dh, eps = x.shape[0], a["Hq"], a["Dh"], a["eps"]
    h = ln(x, lw["attn_norm_w"], lw["attn_norm_b"], eps)
    q = ops.mm(h, lw["wq"], lw["bq"]).view(T, H, Dh)
    k = ops.mm(h, lw["wk"], lw["bk"]).view(T, H, Dh)
    v = ops.mm(h, lw["wv"], lw["bv"]).view(T, H, Dh)
    q = ops.r(rope(q, pos, a["rotary_dim"], a["theta"]))
    k = ops.r(rope(k, pos, a["rotary_dim"], a["theta"]))
    attn = ops.mm(ops.attend(q, k, v).reshape(T, H * Dh), lw["wo"],
                  lw["bo"])
    if not a["parallel_residual"]:
        x = x + attn
    m = ln(x, lw["mlp_norm_w"], lw["mlp_norm_b"], eps)
    u = torch.nn.functional.gelu(ops.mm(m, lw["w_up"], lw["b_up"]),
                                   approximate="none")
    mlp = ops.mm(u, lw["w_down"], lw["b_down"])
    return ops.r(x + attn + mlp if a["parallel_residual"] else x + mlp)


def weights_per_token(a: dict) -> int:
    """The layers' matrix weights one token multiplies."""
    D, F, Dh, H = a["D"], a["F"], a["Dh"], a["Hq"]
    return a["L"] * (D * 3 * H * Dh + H * Dh * D + D * F + F * D)


def keys_scored(a: dict, first: int, last: int) -> int:
    """Keys scored by the tokens at positions first..last-1, summed over
    the layers."""
    return a["L"] * causal_keys(first, last)
