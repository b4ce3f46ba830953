"""The plain reference: a float32 forward pass of the benchmark's
configurations in PyTorch (TF32 off), for the check that decides
``correct``. It imports nothing of the program: it draws the weights
again from the configuration's seed (``weights.py``), quantizes them to INT4 with
its own copy of the blockwise quantizer and dequantizes them to float32,
then runs the published architecture (qwen3: RMSNorm, per-head q/k
RMSNorm, rotate-half RoPE, grouped-query attention, SwiGLU; gpt-neox:
LayerNorm, partial rotary, biases, exact GELU, parallel residual) over
whole sequences, one layer at a time, with no cache and no batching.

The control is the same pass a precision below the configuration's
bf16 activations: ``"fp8"`` rounds to float8 e4m3, with one scale a row,
every tensor the program holds in bf16 (the residual stream, each weight
product's input and output, q, K, V, the attention probabilities and
output, the logits); ``"w4a8"`` rounds only the weight products' inputs,
the step an INT4-weight, float8-activation kernel would take.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from portbench import weights as W

BLOCK = 64          # absmax block of the INT4 format along K
FP8_MAX = 448.0     # largest finite float8 e4m3 value
COLS = 16384        # columns dequantized at once


def int4_roundtrip(w: torch.Tensor) -> torch.Tensor:
    """w [K, N] -> the float32 weights an INT4 container of it holds:
    per column, per 64-row block, the scale bf16(absmax / 7) and the code
    clip(round(w / (scale * 7) * 7), -7, 7); the value code * scale."""
    K, N = w.shape
    out = torch.empty((K, N), dtype=torch.float32, device=w.device)
    for c in range(0, N, COLS):
        blocks = w[:, c:c + COLS].to(torch.float32).reshape(
            K // BLOCK, BLOCK, -1)
        absmax = blocks.abs().amax(dim=1)
        stored = (absmax / 7.0).to(torch.bfloat16).to(torch.float32)
        q = torch.round(blocks / torch.clamp_min(stored * 7.0, 1e-12)[:, None]
                        * 7.0).clamp_(-7, 7)
        out[:, c:c + COLS] = (q * stored[:, None]).reshape(K, -1)
    return out


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (absmax / 448)."""
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _ln(x, w, b, eps):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * w + b


def _rope(x, pos, rd, theta):
    """Rotate-half RoPE on the first ``rd`` features of x [T, H, Dh]."""
    half = rd // 2
    inv = theta ** (-2.0 * torch.arange(half, dtype=torch.float32,
                                        device=x.device) / rd)
    ang = pos[:, None].to(torch.float32) * inv
    cos = torch.cat([ang, ang], -1).cos()[:, None, :]
    sin = torch.cat([ang, ang], -1).sin()[:, None, :]
    r = x[..., :rd]
    rot = torch.cat([-r[..., half:], r[..., :half]], -1)
    return torch.cat([r * cos + rot * sin, x[..., rd:]], -1)


class Reference:
    """The reference over a fixed set of sequences. ``run(seqs, starts)``
    returns, per sequence, the float32 logits at positions starts-1 ..
    len-2 (the logits that choose tokens starts .. len-1), one pass per
    entry of ``act_quants`` (None: float32 activations; "fp8", "w4a8":
    the lower precisions)."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, device
        self.seed = cfg["weights"]["seed"]
        self.a = W.arch(cfg)

    def _norm(self, x, w, b):
        a = self.a
        return (_rms(x, w, a["eps"]) if a["norm"] == "rms"
                else _ln(x, w, b, a["eps"]))

    def _block(self, x, p, lw, quant):
        a = self.a
        T = x.shape[0]
        Hq, Hk, Dh = a["Hq"], a["Hk"], a["Dh"]
        r = fp8_rows if quant == "fp8" else (lambda t: t)

        def mm(h, name):
            h = fp8_rows(h) if quant in ("fp8", "w4a8") else h
            y = h @ lw[name]
            return r(y + lw["b" + name[1:]] if ("b" + name[1:]) in lw else y)

        h = self._norm(x, lw["attn_norm_w"], lw.get("attn_norm_b"))
        q = mm(h, "wq").view(T, Hq, Dh)
        k = mm(h, "wk").view(T, Hk, Dh)
        v = mm(h, "wv").view(T, Hk, Dh)
        if a["qk_norm"]:
            q = _rms(q, lw["q_norm_w"], a["eps"])
            k = _rms(k, lw["k_norm_w"], a["eps"])
        q = r(_rope(q, p, a["rotary_dim"], a["theta"]))
        k = r(_rope(k, p, a["rotary_dim"], a["theta"]))
        rep = Hq // Hk
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        s = torch.einsum("thd,shd->hts", q, k) / (Dh ** 0.5)
        causal = torch.ones(T, T, dtype=torch.bool,
                            device=x.device).tril_()
        s = s.masked_fill(~causal, float("-inf"))
        o = r(torch.einsum("hts,shd->thd", r(torch.softmax(s, -1)), v))
        attn = mm(o.reshape(T, Hq * Dh), "wo")
        if a["parallel_residual"]:
            m = self._norm(x, lw["mlp_norm_w"], lw.get("mlp_norm_b"))
        else:
            x = x + attn
            m = self._norm(x, lw["mlp_norm_w"], lw.get("mlp_norm_b"))
        if a["gated"]:
            u = torch.nn.functional.silu(mm(m, "w_gate")) * mm(m, "w_up")
        else:
            u = torch.nn.functional.gelu(mm(m, "w_up"), approximate="none")
        mlp = mm(u, "w_down")
        return r(x + attn + mlp if a["parallel_residual"] else x + mlp)

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer i in float32: projections through the INT4 round trip,
        norms and biases as drawn (bf16) in float32."""
        dense = W.layer(self.cfg, self.seed, i, self.device)
        out = {}
        for k, v in dense.items():
            v = v[0]
            out[k] = int4_roundtrip(v) if v.dim() == 2 else v.float()
        return out

    @torch.no_grad()
    def run(self, seqs: Sequence[Sequence[int]], starts: Sequence[int],
            act_quants: Sequence[Optional[str]] = (None,)
            ) -> Dict[Optional[str], List[torch.Tensor]]:
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._run(seqs, starts, act_quants)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def _run(self, seqs, starts, act_quants):
        dev = self.device
        emb = W.embedding(self.cfg, self.seed, dev)
        toks = [torch.tensor(list(s), dtype=torch.int64, device=dev)
                for s in seqs]
        pos = [torch.arange(len(s), device=dev) for s in seqs]
        xs = {q: [fp8_rows(emb[t].float()) if q == "fp8" else emb[t].float()
                  for t in toks] for q in act_quants}
        del emb
        for i in range(self.a["L"]):
            lw = self._layer(i)
            for q in act_quants:
                xs[q] = [self._block(x, p, lw, q)
                         for x, p in zip(xs[q], pos)]
            del lw
        fn = W.final_norm(self.cfg, self.seed, dev)
        fw = fn["w"].float()
        fb = fn["b"].float() if fn["b"] is not None else None
        head = int4_roundtrip(W.head(self.cfg, self.seed, dev))
        out = {}
        for q in act_quants:
            rows = []
            for x, st in zip(xs[q], starts):
                h = self._norm(x[st - 1:-1], fw, fb)
                h = fp8_rows(h) if q in ("fp8", "w4a8") else h
                rows.append(fp8_rows(h @ head) if q == "fp8" else h @ head)
            out[q] = rows
        return out
