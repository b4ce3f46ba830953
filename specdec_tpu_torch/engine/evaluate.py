"""Perplexity and log-probability evaluation (counterpart of
``specdec_tpu/engine/evaluate.py``).

Token-level NLL with HF's teacher-forcing convention (the logits at
position t score token t+1), over batches of sequences padded with masks.
The tests gate quantization quality with it (INT8/INT4/NF4/FP4 against
dense). Every forward is ``core/model.py::forward_full`` under
``torch.no_grad()``: on a quantized target each projection launches its
weight kernel (K1, K6 or K7) at M = B·T rows.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_full


@torch.no_grad()
def _nll_sums(cfg: ModelConfig, params, tokens: torch.Tensor,
              mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens/mask: [B, T]. Returns (the sum of NLL over scored positions,
    the number of scored positions), float32. Position t is scored iff
    both t and t+1 are valid."""
    logits = forward_full(cfg, params, tokens)            # [B, T, V] f32
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].to(torch.int64)
    tok_logp = torch.gather(logp, -1, targets[..., None])[..., 0]
    score_mask = (mask[:, :-1] * mask[:, 1:]).to(torch.float32)
    return -(tok_logp * score_mask).sum(), score_mask.sum()


def _padded(chunk: Sequence[Sequence[int]], pad_id: int, device):
    T = max(len(s) for s in chunk)
    toks = np.full((len(chunk), T), pad_id, np.int32)
    mask = np.zeros((len(chunk), T), np.int32)
    for j, s in enumerate(chunk):
        toks[j, :len(s)] = s
        mask[j, :len(s)] = 1
    return (torch.from_numpy(toks).to(device),
            torch.from_numpy(mask).to(device))


def perplexity(cfg: ModelConfig, params, sequences: Sequence[Sequence[int]],
               pad_id: int = 0, batch_size: int = 8, device=None) -> float:
    """Corpus perplexity = exp(total NLL / total scored tokens), on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    total_nll = 0.0
    total_tok = 0.0
    seqs = [list(s) for s in sequences]
    for i in range(0, len(seqs), batch_size):
        nll, n = _nll_sums(cfg, params,
                           *_padded(seqs[i:i + batch_size], pad_id, device))
        total_nll += float(nll)
        total_tok += float(n)
    return float(np.exp(total_nll / max(total_tok, 1.0)))


def sequence_logprobs(cfg: ModelConfig, params,
                      sequences: Sequence[Sequence[int]],
                      pad_id: int = 0, device=None) -> List[float]:
    """Per-sequence total log-probability (teacher-forced), one forward a
    sequence."""
    device = resolve_device(device)
    out = []
    for s in sequences:
        nll, _ = _nll_sums(cfg, params, *_padded([s], pad_id, device))
        out.append(-float(nll))
    return out
