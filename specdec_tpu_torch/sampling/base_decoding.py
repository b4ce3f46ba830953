"""Baseline generation (counterpart of
``specdec_tpu/sampling/base_decoding.py``): autoregressive decoding and the
length-penalized beam search.

The JAX versions are one jitted ``lax.while_loop`` each; here the loops are
eager Python over device tensors. AR's tokens stay on the device: the loop
reads the host only once per token when an EOS set is given (to stop), and
otherwise only once, at the end. Beam search reads one flag per step (has
every beam finished) and the best beam once, at the end.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import gather_rows, init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step
from specdec_tpu_torch.sampling.processors import GreedyProcessor, LogitsProcessor
from specdec_tpu_torch.sampling.utils import (
    eos_mask, normalize_eos, pad_to_bucket, stable_top_k,
)


def autoregressive_generate(
    inputs: Sequence[int],
    cfg: ModelConfig,
    params,
    max_gen_len: int = 40,
    logits_processor: Optional[LogitsProcessor] = None,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    use_cache: bool = True,  # API parity; the slotted cache is always used
    debug: bool = False,
    device=None,
) -> List[int]:
    """Generate from the target alone. ``generator`` (or a new one seeded
    with ``seed``) drives sampling; ``device=None`` means the card.

    One forward per generated token: the prompt's prefill yields token 1,
    and the forward after the last token is skipped (its logits would be
    unused)."""
    del use_cache, debug
    device = resolve_device(device)
    processor = logits_processor or GreedyProcessor()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    eos_ids = normalize_eos(eos_tokens_id)
    prompt, n = pad_to_bucket(inputs, pad_token_id)
    prompt = prompt.to(device)
    P = prompt.shape[0]
    S = P + max_gen_len
    buf = torch.zeros((S,), dtype=torch.int64, device=device)
    buf[:P] = prompt

    cache = init_cache(cfg, 1, S, device=device)
    logits, cache = forward_step(cfg, params, prompt[None, :], cache)
    cache = cache.with_length(torch.full((1,), n, dtype=torch.int32,
                                         device=device))
    last_logits = logits[0, n - 1]
    total_len = min(cfg.max_position_embeddings, n + max_gen_len)

    pos = n
    while pos < total_len:
        tok = processor.sample_from_logits(last_logits, generator)
        buf[pos] = tok
        pos += 1
        if eos_ids and bool(eos_mask(tok, eos_ids)):
            break
        if pos >= total_len:
            break
        logits, cache = forward_step(cfg, params, tok.reshape(1, 1), cache)
        last_logits = logits[0, 0]
    return buf[n:pos].tolist()


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

_NEG = -1e30


def _beam_search(cfg: ModelConfig, params, prompt: torch.Tensor,
                 prompt_len: int, gen_len: int, num_beams: int, top_k: int,
                 alpha: float, min_length: float, eos_ids: Tuple[int, ...],
                 pad_id: int) -> Tuple[List[int], int]:
    """Length-penalized beam search; returns (the best beam's buffer row,
    the index of its last token).

    The JAX package's semantics: score = cumulative log-prob /
    ((min_length + length) / (min_length + 1)) ** alpha, with the prefill
    seeding the cumulative log-prob at 1.0; an expansion token equal to EOS
    *or pad* finishes a beam; finished beams carry themselves as frozen
    candidates and bypass the dedup; duplicate expansion candidates
    (identical full sequences) are dropped keeping the earliest; the loop
    ends when every beam is finished (or at the length cap); the best beam
    is returned.

    Beams are a batch over one KV cache, and reordering gathers cache rows
    (``core/cache.py::gather_rows``, int8 scales too). Each step scores
    K * (top_k + 1) candidate slots: per beam, itself, then its top_k
    expansions by log-prob.

    Ties: every ranking is a stable sort in descending order, as
    ``lax.top_k`` ranks: a beam's expansions (and the prefill's K seed
    tokens) by log-prob with equal log-probs in token order, and the
    candidates by score with equal scores in slot order (beam by beam; a
    beam's own slot first, then its expansions by rank)."""
    device = prompt.device
    K, k = num_beams, top_k
    P = prompt.shape[0]
    S = P + gen_len
    total_len = min(cfg.max_position_embeddings, prompt_len + gen_len)
    f32 = dict(dtype=torch.float32, device=device)
    ml = torch.tensor(min_length, **f32)
    al = torch.tensor(alpha, **f32)

    def lp(length):
        return ((ml + length) / (ml + 1.0)) ** al

    # --- prefill: the prompt in every beam, seeded with the top-K tokens ---
    cache = init_cache(cfg, K, S, device=device)
    prompts = prompt[None, :].expand(K, P)
    logits, cache = forward_step(cfg, params, prompts, cache)
    cache = cache.with_length(torch.full((K,), prompt_len, dtype=torch.int32,
                                         device=device))
    buf = torch.full((K, S), pad_id, dtype=torch.int64, device=device)
    buf[:, :P] = prompts
    logp0 = torch.log_softmax(logits[0, prompt_len - 1], dim=-1)
    top_probs0, top_tokens0 = stable_top_k(logp0, K)
    buf[:, prompt_len] = top_tokens0
    cum = 1.0 + top_probs0
    score = cum / lp(torch.tensor(1.0, **f32))
    last_index = torch.full((K,), -1, dtype=torch.int64, device=device)

    C = K * (k + 1)
    slot = torch.arange(C, device=device)
    slot_parent = slot // (k + 1)
    slot_is_self = slot % (k + 1) == 0
    exp_idx = torch.clamp_min(slot % (k + 1) - 1, 0)
    earlier = slot[None, :] < slot[:, None]
    rows = torch.arange(K, device=device)

    cur = prompt_len + 1
    while cur < total_len and bool((last_index < 0).any()):   # host read
        finished = last_index >= 0
        logits, cache = forward_step(cfg, params, buf[:, cur - 1:cur],
                                     cache)
        logp = torch.log_softmax(logits[:, 0], dim=-1)           # [K, V]
        top_probs, top_tokens = stable_top_k(logp, k)            # [K, k]
        penalty = lp(torch.tensor(float(cur - prompt_len), **f32))

        exp_score = ((cum[slot_parent] + top_probs[slot_parent, exp_idx])
                     / torch.where(penalty != 0, penalty, 1.0))
        parent_fin = finished[slot_parent]
        cand_score = torch.where(
            slot_is_self, torch.where(parent_fin, score[slot_parent], _NEG),
            torch.where(parent_fin, _NEG, exp_score))
        # the token at position cur of each candidate's sequence
        cand_tok = torch.where(slot_is_self, buf[slot_parent, cur],
                               top_tokens[slot_parent, exp_idx])

        # dedup: drop expansions equal to an earlier live candidate
        row_eq = (buf[:, None, :] == buf[None, :, :]).all(dim=-1)  # [K, K]
        same = (row_eq[slot_parent[:, None], slot_parent[None, :]]
                & (cand_tok[:, None] == cand_tok[None, :]))
        alive = cand_score > _NEG / 2
        dup = (same & earlier & alive[None, :]).any(dim=1) & ~slot_is_self
        cand_score = torch.where(dup, _NEG, cand_score)

        # --- the top K candidates ------------------------------------------
        score, sel = stable_top_k(cand_score, K)
        sel_parent, sel_self = slot_parent[sel], slot_is_self[sel]
        sel_tok = cand_tok[sel]
        buf = buf[sel_parent]
        buf[rows, cur] = torch.where(sel_self, buf[rows, cur], sel_tok)
        cum = torch.where(sel_self, cum[sel_parent],
                          cum[sel_parent] + top_probs[sel_parent,
                                                      exp_idx[sel]])
        is_stop = eos_mask(sel_tok, eos_ids) | (sel_tok == pad_id)
        last_index = torch.where(sel_self, last_index[sel_parent],
                                 torch.where(is_stop, cur, -1))
        # every length is cur here: the forward advanced past token cur-1
        cache = gather_rows(cache, sel_parent)
        cur += 1

    last = torch.where(last_index[0] < 0, total_len - 1, last_index[0])
    out = torch.cat([buf[0], last[None]]).tolist()   # one host read
    return out[:-1], out[-1]


def beam_search_generate(
    inputs: Sequence[int],
    cfg: ModelConfig,
    params,
    max_gen_len: int = 40,
    num_beams: int = 4,
    top_k: int = 3,
    min_length: float = 5.0,
    alpha: float = 1.2,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    debug: bool = False,
    device=None,
) -> List[int]:
    """Beam search baseline with the reference's API (``_beam_search``
    gives the semantics and the tie rule). Deterministic: no sampling.
    ``device=None`` means the card."""
    del debug
    device = resolve_device(device)
    eos_ids = normalize_eos(eos_tokens_id)
    prompt, n = pad_to_bucket(inputs, pad_token_id)
    if n >= cfg.max_position_embeddings:
        raise ValueError("Prompt length exceeds maximum sequence length.")
    buf, last = _beam_search(cfg, params, prompt.to(device), n,
                             int(max_gen_len), int(num_beams), int(top_k),
                             float(alpha), float(min_length), eos_ids,
                             int(pad_token_id))
    return buf[n:last + 1]
