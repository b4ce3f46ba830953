"""Single-sequence speculative decoding, draft gamma then verify
(counterpart of ``specdec_tpu/sampling/speculative.py``).

Reference semantics kept exactly where they define the output distribution:

- acceptance on the *processed* distributions: draw r ~ U[0, 1) per draft
  and reject at the first i with r_i > p_i(x_i) / q_i(x_i);
- on rejection, resample from norm(max(p - q, 0)), falling back to p when
  the residual has no mass (or straight from p with
  ``skip_sample_adjustment``);
- the bonus token from the target's extra position when all gamma drafts
  are accepted;
- EOS inside the committed tokens truncates and stops;
- ``first_target``: the target emits generation token 1 before the loop;
- acceptance bookkeeping over corrected_gamma = min(gamma, total_len-pos-1).

Cache invariants, as in the JAX version: at a window's start the target's
cache covers pos-1 tokens and the drafter's pos-2; the drafter's first step
feeds the two tokens buf[pos-2:pos] (catching up the last committed token
and drafting x0 in one forward); rollback is ``with_length``; the cache
capacity is S = P + gen_len + gamma + 2.

The window runs eagerly on the device. Drafted tokens feed the next
drafter step as device tensors; the one host read per window brings back
the accept count, the advance and the EOS flag.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step
from specdec_tpu_torch.sampling.processors import GreedyProcessor, LogitsProcessor
from specdec_tpu_torch.sampling.utils import eos_mask, max_fn, normalize_eos, pad_to_bucket


def accept_step(p_all: torch.Tensor, q_all: torch.Tensor,
                drafts: torch.Tensor, r: torch.Tensor,
                processor: LogitsProcessor,
                generator: Optional[torch.Generator],
                skip_sample_adjustment: bool = False,
                samp: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The accept / residual step over a leading batch axis.

    p_all: [B, gamma+1, V] target distributions; q_all: [B, gamma, V]
    drafter distributions; drafts: [B, gamma] drafted tokens; r: [B, gamma]
    uniform draws; samp: per-row sampling params for
    ``processor.sample_batched`` (serving). Returns (n [B] accepted drafts,
    next_tok [B]): the bonus token from p_all[:, gamma] when n == gamma,
    else a draw from the residual at position n."""
    B, g1, _ = p_all.shape
    gamma = g1 - 1
    p_x = p_all[:, :gamma].gather(-1, drafts[..., None])[..., 0]
    q_x = q_all.gather(-1, drafts[..., None])[..., 0]
    reject = r > p_x / torch.clamp_min(q_x, 1e-38)
    first = torch.argmax(reject.to(torch.int32), dim=-1)   # first True
    n = torch.where(reject.any(dim=-1), first, gamma)

    rows = torch.arange(B, device=p_all.device)
    p_n = p_all[rows, torch.clamp_max(n, gamma)]
    q_n = q_all[rows, torch.clamp_max(n, gamma - 1)]
    if skip_sample_adjustment:
        resample_dist = p_n
    else:
        residual = max_fn(p_n - q_n)
        has_mass = torch.clamp_min(p_n - q_n, 0.0).sum(-1) > 1e-12
        resample_dist = torch.where(has_mass[:, None], residual, p_n)
    next_dist = torch.where((n == gamma)[:, None], p_all[:, gamma],
                            resample_dist)
    return n, processor.sample_batched(next_dist, generator, samp)


def commit_step(drafts: torch.Tensor, n: torch.Tensor,
                next_tok: torch.Tensor, remaining,
                eos_ids: Tuple[int, ...],
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The commit step over a leading batch axis: candidates drafts[:n] +
    next_tok, capped at ``remaining`` tokens and truncated after the first
    EOS among them.

    drafts: [B, gamma]; n, next_tok: [B]; remaining: int or [B]. Returns
    (cand [B, gamma+1] with zeros past n, advance [B] = tokens to commit,
    any_eos [B])."""
    B, gamma = drafts.shape
    idx = torch.arange(gamma + 1, device=drafts.device)
    n = n[:, None]
    cand = torch.where(idx < n, torch.cat([drafts, drafts[:, :1]], dim=1), 0)
    cand = torch.where(idx == n, next_tok[:, None], cand)
    advance = torch.clamp_max(n[:, 0] + 1, remaining)
    is_eos = eos_mask(cand, eos_ids) & (idx <= n)
    any_eos = (is_eos & (idx < advance[:, None])).any(dim=-1)
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=-1)
    advance = torch.where(any_eos, torch.minimum(first_eos + 1, advance),
                          advance)
    return cand, advance, any_eos


def _spec_generate(
    inputs: Sequence[int],
    drafter_cfg: ModelConfig, drafter_params,
    target_cfg: ModelConfig, target_params,
    gamma: int, max_gen_len: int,
    processor: LogitsProcessor,
    eos_ids: Tuple[int, ...],
    first_target: bool,
    skip_sample_adjustment: bool,
    generator: torch.Generator,
    pad_token_id: int,
    device: torch.device,
) -> Tuple[List[int], int, int, List[int]]:
    """Returns (generated tokens, accepted, speculated, per-window accept
    counts)."""
    prompt, n_prompt = pad_to_bucket(inputs, pad_token_id)
    if not first_target and n_prompt < 2:
        # the drafter's catch-up step reads buf[pos-2] at window start
        raise ValueError(f"first_target=False requires a prompt of >= 2 "
                         f"tokens (got {n_prompt})")
    prompt = prompt.to(device)
    P = prompt.shape[0]
    S = P + max_gen_len + gamma + 2  # a window may overrun the cap
    max_windows = max_gen_len + 1

    d_cache = init_cache(drafter_cfg, 1, S, device=device)
    t_cache = init_cache(target_cfg, 1, S, device=device)
    buf = torch.zeros((S,), dtype=torch.int64, device=device)
    buf[:P] = prompt

    def lengths(v: int) -> torch.Tensor:
        return torch.full((1,), v, dtype=torch.int32, device=device)

    max_pos = min(drafter_cfg.max_position_embeddings,
                  target_cfg.max_position_embeddings)
    total_len = min(max_pos, n_prompt + max_gen_len)

    # --- prefills ---------------------------------------------------------
    t_logits, t_cache = forward_step(target_cfg, target_params,
                                     prompt[None, :], t_cache)
    _, d_cache = forward_step(drafter_cfg, drafter_params, prompt[None, :],
                              d_cache)
    if first_target:
        tok0 = processor.sample(processor(t_logits[0, n_prompt - 1]),
                                generator)
        buf[n_prompt] = tok0
        pos = n_prompt + 1
        finished = pos >= total_len or (
            bool(eos_ids) and bool(eos_mask(tok0, eos_ids)))
        d_cache = d_cache.with_length(lengths(n_prompt - 1))
        t_cache = t_cache.with_length(lengths(n_prompt))
    else:
        pos = n_prompt
        finished = pos >= total_len
        d_cache = d_cache.with_length(lengths(n_prompt - 2))
        t_cache = t_cache.with_length(lengths(n_prompt - 1))

    accepted = speculated = 0
    accept_log: List[int] = []
    while not finished and pos < total_len and len(accept_log) < max_windows:
        # --- draft: gamma cached drafter forwards; the first feeds two
        # tokens (catch-up of the last committed token + draft x0) ---------
        logits, d_cache = forward_step(drafter_cfg, drafter_params,
                                       buf[pos - 2:pos][None, :], d_cache)
        q = processor(logits[0, 1])
        x = processor.sample(q, generator)
        qs, xs = [q], [x]
        for _ in range(1, gamma):
            logits, d_cache = forward_step(drafter_cfg, drafter_params,
                                           x.reshape(1, 1), d_cache)
            q = processor(logits[0, 0])
            x = processor.sample(q, generator)
            qs.append(q)
            xs.append(x)
        q_all = torch.stack(qs)                                # [gamma, V]
        drafts = torch.stack(xs)                               # [gamma]

        # --- verify: one target forward over gamma+1 positions -----------
        t_in = torch.cat([buf[pos - 1:pos], drafts])
        t_logits, t_cache = forward_step(target_cfg, target_params,
                                         t_in[None, :], t_cache)
        p_all = processor(t_logits[0])                         # [gamma+1, V]

        r = torch.rand((1, gamma), generator=generator, device=device)
        n, next_tok = accept_step(p_all[None], q_all[None], drafts[None], r,
                                  processor, generator,
                                  skip_sample_adjustment)

        # --- commit: drafts[:n] + next_tok, EOS-truncated -----------------
        cand, advance, any_eos = commit_step(drafts[None], n, next_tok,
                                             total_len - pos, eos_ids)
        buf[pos:pos + gamma + 1] = cand[0]
        n_h, advance_h, eos_h = torch.stack(
            [n[0], advance[0], any_eos[0].to(n.dtype)]).tolist()  # host read

        corrected_gamma = min(max(total_len - pos - 1, 0), gamma)
        accepted += min(n_h, corrected_gamma)
        speculated += corrected_gamma
        pos += advance_h
        finished = bool(eos_h) or pos >= total_len
        # restore the invariants: target covers pos-1, drafter pos-2
        d_cache = d_cache.with_length(lengths(pos - 2))
        t_cache = t_cache.with_length(lengths(pos - 1))
        accept_log.append(n_h)

    return buf[n_prompt:pos].tolist(), accepted, speculated, accept_log


def speculative_generate(
    inputs: Sequence[int],
    drafter_cfg: ModelConfig, drafter_params,
    target_cfg: ModelConfig, target_params,
    tokenizer=None,
    gamma: int = 5,
    logits_processor: Optional[LogitsProcessor] = None,
    max_gen_len: int = 40,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    use_cache: bool = True,     # API parity; the slotted cache is always used
    skip_sample_adjustment: bool = False,
    first_target: bool = True,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    debug: bool = False,
    device=None,
) -> Tuple[List[int], float]:
    """Returns (generated token ids, acceptance rate). ``generator`` (or a
    new one seeded with ``seed``) drives drafting, acceptance and
    resampling; ``device=None`` means the card."""
    del use_cache, tokenizer
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    tokens, accepted, speculated, accept_log = _spec_generate(
        inputs, drafter_cfg, drafter_params, target_cfg, target_params,
        int(gamma), int(max_gen_len), logits_processor or GreedyProcessor(),
        normalize_eos(eos_tokens_id), bool(first_target),
        bool(skip_sample_adjustment), generator, pad_token_id, device)
    rate = accepted / speculated if speculated > 0 else 0.0
    if debug:
        print(f"[specdec] windows={len(accept_log)} "
              f"accepts/window={accept_log} acceptance={rate:.3f}")
    return tokens, rate
