"""A plain float32 reference of the deepseek_v2 architecture (DeepSeek-V2
and -Lite without a q low-rank), for the tests of the port's latent
attention and expert layer. It imports neither JAX nor anything of the
port: whole sequences, one layer at a time, no cache, every attention in
the decompressed form, every expert one matrix product, TF32 off.

``params`` is the port's layout (``core/hf_loader.py``): ``embed`` [V, D],
``final_norm_w``, ``lm_head`` [D, V] and ``layers``, a list of dicts of
[in, out] matrices: ``wq``, ``w_kva``, ``kv_norm_w``, ``w_kvb``, ``wo``,
the norms, then ``w_gate``/``w_up``/``w_down`` (dense layers) or
``router`` [D, E], ``experts_*`` [E, in, out] and ``shared_*``. ``hf`` is
the published config's keys (a dict).
"""
from __future__ import annotations

import math

import torch


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn(hf: dict):
    """(inverse frequencies of the rope dims, cos/sin factor, softmax
    scale) of YaRN as the DeepSeek-V2 paper and code define it."""
    dim = hf["qk_rope_head_dim"]
    base = float(hf.get("rope_theta", 10000.0))
    inv = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    scale = (hf["qk_nope_head_dim"] + dim) ** -0.5
    rs = hf.get("rope_scaling")
    if not rs:
        return inv.float(), 1.0, scale
    f, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    lo = max(math.floor(corr(rs.get("beta_fast", 32))), 0)
    hi = min(math.ceil(corr(rs.get("beta_slow", 1))), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - lo)
            / max(hi - lo, 1e-3)).clamp(0, 1)
    inv = inv / f * ramp + inv * (1 - ramp)
    m, mad = rs.get("mscale", 1.0), rs.get("mscale_all_dim", 0.0)
    cs = _mscale(f, m) / _mscale(f, mad) if mad else _mscale(f, m)
    if mad:
        scale = scale * _mscale(f, mad) ** 2
    return inv.float(), float(cs), scale


def rope(x, pos, inv, cs):
    """Interleaved-pair rotation of x [T, H, R] at positions pos [T]."""
    ang = pos.double()[:, None] * inv.double()[None, :]
    rot = torch.polar(torch.full_like(ang, cs), ang).to(torch.complex64)
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
    return torch.view_as_real(xc * rot[:, None, :]).reshape(x.shape)


def attention(hf: dict, lw: dict, h, pos):
    T = h.shape[0]
    H, nope = hf["num_attention_heads"], hf["qk_nope_head_dim"]
    R, r, v = hf["qk_rope_head_dim"], hf["kv_lora_rank"], hf["v_head_dim"]
    inv, cs, scale = yarn(hf)
    q = (h @ lw["wq"]).view(T, H, nope + R)
    kva = h @ lw["w_kva"]
    c = _rms(kva[:, :r], lw["kv_norm_w"], hf["rms_norm_eps"])
    k_pe = rope(kva[:, None, r:], pos, inv, cs)
    q_pe = rope(q[..., nope:], pos, inv, cs)
    kv = (c @ lw["w_kvb"]).view(T, H, nope + v)
    qf = torch.cat([q[..., :nope], q_pe], -1)
    kf = torch.cat([kv[..., :nope], k_pe.expand(T, H, R)], -1)
    s = torch.einsum("thd,shd->hts", qf, kf) * scale
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -math.inf)
    o = torch.einsum("hts,shd->thd", torch.softmax(s, -1), kv[..., nope:])
    return o.reshape(T, H * v) @ lw["wo"]


def route(hf: dict, m, router):
    """(weights [T, k], expert ids [T, k]) of DeepSeek's greedy gate."""
    p = torch.softmax(m @ router, -1)
    w, idx = p.topk(hf["num_experts_per_tok"], -1)
    return w * hf.get("routed_scaling_factor", 1.0), idx


def _swiglu(m, g, u, d):
    return (torch.nn.functional.silu(m @ g) * (m @ u)) @ d


def mlp(hf: dict, i: int, lw: dict, m):
    if i < hf.get("first_k_dense_replace", 0):
        return _swiglu(m, lw["w_gate"], lw["w_up"], lw["w_down"])
    w, idx = route(hf, m, lw["router"])
    y = torch.zeros_like(m)
    for t in range(m.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            y[t] += w[t, j] * _swiglu(m[t:t + 1], lw["experts_gate"][e],
                                      lw["experts_up"][e],
                                      lw["experts_down"][e])[0]
    return y + _swiglu(m, lw["shared_gate"], lw["shared_up"],
                       lw["shared_down"])


@torch.no_grad()
def forward(hf: dict, params: dict, tokens) -> torch.Tensor:
    """Logits [T, V] of one sequence, in float32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f = {k: v.float() for k, v in params.items() if k != "layers"}
        tok = torch.as_tensor(tokens, dtype=torch.int64)
        x = f["embed"][tok]
        pos = torch.arange(len(tok))
        eps = hf["rms_norm_eps"]
        for i, lay in enumerate(params["layers"]):
            lw = {k: v.float() for k, v in lay.items()}
            x = x + attention(hf, lw, _rms(x, lw["attn_norm_w"], eps), pos)
            x = x + mlp(hf, i, lw, _rms(x, lw["mlp_norm_w"], eps))
        return _rms(x, f["final_norm_w"], eps) @ f["lm_head"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
