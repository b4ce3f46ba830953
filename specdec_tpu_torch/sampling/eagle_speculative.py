"""Single-sequence EAGLE speculative decoding
(counterpart of ``specdec_tpu/sampling/eagle_speculative.py``).

The draft-gamma-then-verify window of ``sampling/speculative.py``, with the
accept / residual step (``accept_step``) and the commit (``commit_step``)
unchanged, but drafted by the EAGLE feature predictor (``core/eagle.py``):

- a feature buffer ``fbuf`` [S, D] holds the target's residual-stream
  feature of every committed position, written by the prefill and by each
  verify; at a window's start it is valid through ``pos - 2`` (the feature
  at ``pos - 1`` was computed under a rejected draft, or never, for a bonus
  token);
- the drafter catches up by a fixed-shape rewrite: each window re-forwards
  the last gamma + 1 (feature, token) pairs ending at pair ``pos - 2``,
  with the drafter cache's length reset behind them (a length change, not
  a copy); the block's output at that pair is draft step 0;
- draft steps 1 .. gamma-1 run on the drafter's own predicted features;
- rollback is length arithmetic on both caches.

The window runs eagerly on the device with one host read per window (the
accept count, the advance and the EOS flag). The cache capacity is
S = P + gen_len + gamma + 2.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.eagle import eagle_forward
from specdec_tpu_torch.core.model import forward_step_features
from specdec_tpu_torch.sampling.processors import (
    GreedyProcessor, LogitsProcessor,
)
from specdec_tpu_torch.sampling.speculative import accept_step, commit_step
from specdec_tpu_torch.sampling.utils import (
    eos_mask, normalize_eos, pad_to_bucket,
)


def _accept_uniforms(shape, generator: Optional[torch.Generator],
                     device) -> torch.Tensor:
    """The window's acceptance draws r ~ U[0, 1): the one place the EAGLE
    loops draw them, so that a test can supply other draws."""
    return torch.rand(shape, generator=generator, device=device)


def catch_up(eagle_cfg: ModelConfig, eagle_params, target_params,
             buf: torch.Tensor, fbuf: torch.Tensor, e_cache, pos: int,
             C: int):
    """The drafter's catch-up rewrite for one sequence: re-forward the C
    pairs (fbuf[j], buf[j+1]) ending at j = pos - 2, from the drafter
    cache's slot ``start`` (the length is reset there; stale deeper slots
    are masked and later overwritten). Returns (logits [V] and f_hat [D]
    at pair pos - 2, the drafter cache at length pos - 1)."""
    start = max(pos - 1 - C, 0)
    idx = pos - 2 - start
    lengths = torch.full((1,), start, dtype=torch.int32, device=buf.device)
    logits, f_hat, e_cache = eagle_forward(
        eagle_cfg, eagle_params, target_params,
        buf[start + 1:start + 1 + C][None, :],
        fbuf[start:start + C][None], e_cache.with_length(lengths))
    # drop the slots past the output pair (early windows clamp start to 0)
    return logits[0, idx], f_hat[0, idx], e_cache.with_length(
        torch.full((1,), pos - 1, dtype=torch.int32, device=buf.device))


def _eagle_generate(
    inputs: Sequence[int],
    eagle_cfg: ModelConfig, eagle_params,
    target_cfg: ModelConfig, target_params,
    gamma: int, gen_len: int,
    processor: LogitsProcessor,
    eos_ids: Tuple[int, ...],
    first_target: bool,
    skip_sample_adjustment: bool,
    generator: Optional[torch.Generator],
    pad_token_id: int,
    device: torch.device,
) -> Tuple[List[int], int, int, List[int]]:
    """Returns (generated tokens, accepted, speculated, per-window accept
    counts)."""
    prompt, n = pad_to_bucket(inputs, pad_token_id)
    if not first_target and n < 2:
        # the catch-up block's last pair index is pos-2: with first_target
        # the prefill token makes pos >= n+1, without it a 1-token prompt
        # would index pair -1
        raise ValueError(f"first_target=False requires a prompt of >= 2 "
                         f"tokens (got {n})")
    prompt = prompt.to(device)
    P = prompt.shape[0]
    S = P + gen_len + gamma + 2
    C = gamma + 1                  # catch-up pairs (max commits per window)

    def lengths(v: int) -> torch.Tensor:
        return torch.full((1,), v, dtype=torch.int32, device=device)

    e_cache = init_cache(eagle_cfg, 1, S, device=device)
    t_cache = init_cache(target_cfg, 1, S, device=device)
    buf = torch.zeros((S,), dtype=torch.int64, device=device)
    buf[:P] = prompt
    fbuf = torch.zeros((S, target_cfg.hidden_size), dtype=target_cfg.dtype,
                       device=device)
    total_len = min(eagle_cfg.max_position_embeddings,
                    target_cfg.max_position_embeddings, n + gen_len)

    # --- target prefill; its features seed fbuf[0:P] ----------------------
    t_logits, t_feats, t_cache = forward_step_features(
        target_cfg, target_params, prompt[None, :], t_cache)
    fbuf[:P] = t_feats[0].to(fbuf.dtype)
    if first_target:
        tok0 = processor.sample(processor(t_logits[0, n - 1]), generator)
        buf[n] = tok0
        pos = n + 1
        finished = pos >= total_len or (
            bool(eos_ids) and bool(eos_mask(tok0, eos_ids)))
        t_cache = t_cache.with_length(lengths(n))
    else:
        pos = n
        finished = pos >= total_len
        t_cache = t_cache.with_length(lengths(n - 1))

    accepted = speculated = 0
    accept_log: List[int] = []
    while not finished and pos < total_len and len(accept_log) < gen_len + 1:
        # --- catch-up rewrite + draft step 0 ------------------------------
        logits, f, e_cache = catch_up(eagle_cfg, eagle_params, target_params,
                                      buf, fbuf, e_cache, pos, C)
        q = processor(logits)
        x = processor.sample(q, generator)
        qs, xs = [q], [x]
        # --- draft steps 1..gamma-1 on predicted features -----------------
        for _ in range(1, gamma):
            logits, f_hat, e_cache = eagle_forward(
                eagle_cfg, eagle_params, target_params, x.reshape(1, 1),
                f.reshape(1, 1, -1), e_cache)
            q = processor(logits[0, 0])
            x = processor.sample(q, generator)
            f = f_hat[0, 0]
            qs.append(q)
            xs.append(x)
        q_all = torch.stack(qs)                                # [gamma, V]
        drafts = torch.stack(xs)                               # [gamma]

        # --- verify: one target forward over gamma+1 positions -----------
        t_in = torch.cat([buf[pos - 1:pos], drafts])
        t_logits, t_feats, t_cache = forward_step_features(
            target_cfg, target_params, t_in[None, :], t_cache)
        p_all = processor(t_logits[0])                         # [gamma+1, V]
        # features of positions pos-1 .. pos+gamma-1; those at or past the
        # first rejection lie past the next window's reads (which stop at
        # new_pos - 2) and are overwritten later
        fbuf[pos - 1:pos + gamma] = t_feats[0].to(fbuf.dtype)

        r = _accept_uniforms((1, gamma), generator, device)
        n_acc, next_tok = accept_step(p_all[None], q_all[None], drafts[None],
                                      r, processor, generator,
                                      skip_sample_adjustment)
        cand, advance, any_eos = commit_step(drafts[None], n_acc, next_tok,
                                             total_len - pos, eos_ids)
        buf[pos:pos + gamma + 1] = cand[0]
        n_h, advance_h, eos_h = torch.stack(
            [n_acc[0], advance[0], any_eos[0].to(n_acc.dtype)]).tolist()

        corrected_gamma = min(max(total_len - pos - 1, 0), gamma)
        accepted += min(n_h, corrected_gamma)
        speculated += corrected_gamma
        pos += advance_h
        finished = bool(eos_h) or pos >= total_len
        # the target covers pos-1; the drafter's cache needs no restore, the
        # next catch-up resets its length
        t_cache = t_cache.with_length(lengths(pos - 1))
        accept_log.append(n_h)
    return buf[n:pos].tolist(), accepted, speculated, accept_log


def eagle_generate(
    inputs: Sequence[int],
    eagle_cfg: ModelConfig, eagle_params,
    target_cfg: ModelConfig, target_params,
    tokenizer=None,
    gamma: int = 5,
    logits_processor: Optional[LogitsProcessor] = None,
    max_gen_len: int = 40,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    skip_sample_adjustment: bool = False,
    first_target: bool = True,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    debug: bool = False,
    device=None,
) -> Tuple[List[int], float]:
    """EAGLE-drafted speculative generation; the API of
    ``speculative_generate``. Returns (generated ids, acceptance rate).

    ``eagle_cfg`` shares the target's widths (``target_cfg.replace(
    num_layers=<depth>)``); ``eagle_params`` come from
    ``core/eagle.py::init_eagle_params``. ``generator`` (or a new one
    seeded with ``seed``) drives drafting, acceptance and resampling;
    ``device=None`` means the card."""
    del tokenizer
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    tokens, accepted, speculated, accept_log = _eagle_generate(
        inputs, eagle_cfg, eagle_params, target_cfg, target_params,
        int(gamma), int(max_gen_len), logits_processor or GreedyProcessor(),
        normalize_eos(eos_tokens_id), bool(first_target),
        bool(skip_sample_adjustment), generator, pad_token_id, device)
    rate = accepted / speculated if speculated > 0 else 0.0
    if debug:
        print(f"[eagle] windows={len(accept_log)} "
              f"accepts/window={accept_log} acceptance={rate:.3f}")
    return tokens, rate
