"""The plain reference: a float32 forward pass of the benchmark's
configurations in PyTorch (TF32 off), for the check that decides
``correct``. It imports nothing of the program: it draws the weights
again from the configuration's seed (``weights.py``), quantizes them to INT4 with
its own copy of the blockwise quantizer and dequantizes them to float32,
then runs the published architecture over whole sequences, one layer at
a time, with no cache and no batching. Each layer is its family's
``block`` (``families/<model_type>.py``), built from the helpers here:
the norms, RoPE, and ``Ops``, which holds the control's rounding.

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


def rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def ln(x, w, b, eps):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * w + b


def norm(a, x, w, b):
    """The architecture's norm kind (``a["norm"]``): RMSNorm or LayerNorm."""
    return rms(x, w, a["eps"]) if a["norm"] == "rms" else ln(x, w, b,
                                                             a["eps"])


def rope(x, pos, rd, theta):
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


def _same(t):
    return t


class Ops:
    """What a family's block computes with, at one precision (``quant``:
    None, "fp8" or "w4a8"). ``r`` rounds a tensor the program holds in
    bf16 (to float8 rows under "fp8"); ``mm`` is a weight product, its
    input rounded to float8 rows under "fp8" and "w4a8" and its output,
    bias added, by ``r``; ``attend`` is attention with its probabilities
    and output rounded by ``r``."""

    def __init__(self, quant: Optional[str]):
        self.quant = quant
        self.r = fp8_rows if quant == "fp8" else _same

    def mm(self, h, w, b=None):
        h = fp8_rows(h) if self.quant in ("fp8", "w4a8") else h
        y = h @ w
        return self.r(y + b if b is not None else y)

    def attend(self, q, k, v, window: Optional[int] = None):
        """q [T, Hq, Dh], k and v [T, Hk, Dh] -> [T, Hq, Dh]: each query
        over the keys at its position and before (the last ``window`` of
        them, given one), grouped-query heads sharing their K/V head."""
        T, Hq, Dh = q.shape
        rep = Hq // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        s = torch.einsum("thd,shd->hts", q, k) / (Dh ** 0.5)
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril_()
        if window is not None:
            mask &= ~torch.ones_like(mask).tril_(-window)
        s = s.masked_fill(~mask, float("-inf"))
        return self.r(torch.einsum("hts,shd->thd",
                                   self.r(torch.softmax(s, -1)), v))


class Reference:
    """The reference over a fixed set of sequences. ``run(seqs, starts)``
    returns, per sequence, the float32 logits at positions starts-1 ..
    len-2 (the logits that choose tokens starts .. len-1), one pass per
    entry of ``act_quants`` (None: float32 activations; "fp8", "w4a8":
    the lower precisions)."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, device
        self.seed = cfg["weights"]["seed"]
        self.family = W.family(cfg)
        self.a = self.family.arch(cfg)

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer i in float32: projections through the INT4 round trip
        (each matrix of a stack alone), norms and biases as drawn (bf16) in
        float32."""
        dense = W.layer(self.cfg, self.seed, i, self.device)
        kinds = self.family.tensors(self.a, i)
        out = {}
        for k, v in dense.items():
            v = v[0]
            if kinds[k][1] != "proj":
                out[k] = v.float()
            elif v.dim() == 2:
                out[k] = int4_roundtrip(v)
            else:
                out[k] = torch.stack([int4_roundtrip(m) for m in
                                      v.reshape(-1, *v.shape[-2:])]
                                     ).reshape(v.shape)
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
        ops = {q: Ops(q) for q in act_quants}
        for i in range(self.a["L"]):
            lw = self._layer(i)
            for q in act_quants:
                xs[q] = [self.family.block(self.a, i, x, p, lw, ops[q])
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
                h = norm(self.a, x[st - 1:-1], fw, fb)
                h = fp8_rows(h) if q in ("fp8", "w4a8") else h
                rows.append(fp8_rows(h @ head) if q == "fp8" else h @ head)
            out[q] = rows
        return out
