"""Encoder-decoder generation: the AR baseline and speculative decoding
(counterpart of ``specdec_tpu/sampling/codec_decoding.py``).

The JAX package's semantics, kept exactly:

- decoding starts from ``decoder_start_token_id`` at decoder position 0,
  and the returned sequence INCLUDES that start token;
- the generation budget is ``total_len = min(max_position_embeddings -
  prompt_len - 1, max_gen_len + 1)`` decoder positions;
- the encoder prompt is padded by ``pad_to_bucket`` under the mask
  ``arange < prompt_len`` and fixed; every decoder forward cross-attends
  it;
- acceptance, residual, bonus and EOS semantics are the decoder-only
  loop's: the window's accept and commit steps ARE
  ``sampling/speculative.py::accept_step`` and ``commit_step``; the loop
  stops after ``max_gen_len + 1`` windows; acceptance is counted over
  corrected_gamma = clip(total_len - pos - 1, 0, gamma).

Cache invariants (the codec's own, not the decoder-only loop's): at a
window's start both caches cover pos - 1 decoder positions. The drafter
is fed buf[pos-1] and then each draft, one token a step for gamma steps,
and one more step with the last draft, whose logits go unused (it writes
that draft's K/V, needed when every draft is accepted). With
``first_target`` the target emits token 1 from the start token before the
loop, and the drafter takes the start token too (a step whose logits go
unused), so that both caches cover position 0. The JAX package sets the
drafter's length to 1 without that step: its drafter attends a zero key
and value in place of the start token's, and a self-draft there parts
from greedy AR (``ROADMAP.md`` §3, a known fault of the reference). The
port follows the invariant instead.

The windows run eagerly on the device; the one host read per window
brings back the accept count, the advance and the EOS flag.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.codec_model import (
    CodecConfig, codec_cache, decode_step, encode, init_cross_kv,
)
from specdec_tpu_torch.sampling.processors import GreedyProcessor, LogitsProcessor
from specdec_tpu_torch.sampling.speculative import accept_step, commit_step
from specdec_tpu_torch.sampling.utils import eos_mask, normalize_eos, pad_to_bucket


def _accept_uniforms(shape, generator: Optional[torch.Generator],
                     device) -> torch.Tensor:
    """The window's acceptance draws r ~ U[0, 1): the one place the loop
    draws them, so that a test can supply other draws."""
    return torch.rand(shape, generator=generator, device=device)


def _encoded(cfg: CodecConfig, params, prompt: torch.Tensor,
             mask: torch.Tensor):
    """The cross-attention K/V of one model over the [1, P] prompt."""
    return init_cross_kv(cfg, params, encode(cfg, params, prompt, mask))


def _prompt(inputs: Sequence[int], pad_token_id: int, device):
    """(the padded [1, P] prompt, its [1, P] int32 mask, its length)."""
    prompt, n = pad_to_bucket(inputs, pad_token_id)
    mask = (torch.arange(prompt.shape[0]) < n).to(torch.int32)[None, :]
    return prompt[None, :].to(device), mask.to(device), n


def autoregressive_generate_encoder_decoder(
    inputs: Sequence[int],
    cfg: CodecConfig,
    params,
    max_gen_len: int = 40,
    logits_processor: Optional[LogitsProcessor] = None,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    use_cache: bool = True,  # API parity; the slotted cache is always used
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    debug: bool = False,
    device=None,
) -> List[int]:
    """AR over decoder ids with a fixed encoder prompt. ``generator`` (or a
    new one seeded with ``seed``) drives sampling; ``device=None`` means
    the card. Reads the host once per token when an EOS set is given (to
    stop), else once at the end."""
    del use_cache, debug
    device = resolve_device(device)
    processor = logits_processor or GreedyProcessor()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    eos_ids = normalize_eos(eos_tokens_id)
    prompt, mask, n = _prompt(inputs, pad_token_id, device)
    gen_budget = max_gen_len + 1
    cache_len = gen_budget + 8
    ck, cv = _encoded(cfg, params, prompt, mask)
    cache = codec_cache(cfg, 1, cache_len, device)

    buf = torch.zeros((cache_len,), dtype=torch.int64, device=device)
    buf[0] = cfg.decoder_start_token_id
    total_len = min(cfg.max_position_embeddings - n - 1, gen_budget)
    pos = 1
    while pos < total_len:
        logits, cache = decode_step(cfg, params, buf[pos - 1:pos][None, :],
                                    cache, ck, cv, mask)
        tok = processor.sample(processor(logits[0, 0]), generator)
        buf[pos] = tok
        pos += 1
        if eos_ids and bool(eos_mask(tok, eos_ids)):
            break
    return buf[:pos].tolist()


def _codec_spec(
    drafter_cfg: CodecConfig, drafter_params,
    target_cfg: CodecConfig, target_params,
    inputs: Sequence[int], gamma: int, max_gen_len: int,
    processor: LogitsProcessor, eos_ids: Tuple[int, ...],
    first_target: bool, skip_sample_adjustment: bool,
    generator: torch.Generator, pad_token_id: int, device: torch.device,
) -> Tuple[List[int], int, int, List[int]]:
    """Returns (the decoder ids, accepted, speculated, per-window accept
    counts)."""
    prompt, mask, n_prompt = _prompt(inputs, pad_token_id, device)
    gen_budget = max_gen_len + 1
    cache_len = gen_budget + gamma + 4
    t_ck, t_cv = _encoded(target_cfg, target_params, prompt, mask)
    d_ck, d_cv = _encoded(drafter_cfg, drafter_params, prompt, mask)
    t_cache = codec_cache(target_cfg, 1, cache_len, device)
    d_cache = codec_cache(drafter_cfg, 1, cache_len, device)

    def t_step(tokens, cache):
        return decode_step(target_cfg, target_params, tokens[None, :], cache,
                           t_ck, t_cv, mask)

    def d_step(tokens, cache):
        return decode_step(drafter_cfg, drafter_params, tokens[None, :],
                           cache, d_ck, d_cv, mask)

    def lengths(v: int) -> torch.Tensor:
        return torch.full((1,), v, dtype=torch.int32, device=device)

    buf = torch.zeros((cache_len,), dtype=torch.int64, device=device)
    buf[0] = target_cfg.decoder_start_token_id
    total_len = min(target_cfg.max_position_embeddings - n_prompt - 1,
                    gen_budget)

    if first_target:
        logits, t_cache = t_step(buf[:1], t_cache)
        _, d_cache = d_step(buf[:1], d_cache)
        tok0 = processor.sample(processor(logits[0, 0]), generator)
        buf[1] = tok0
        pos = 2
        finished = pos >= total_len or (
            bool(eos_ids) and bool(eos_mask(tok0, eos_ids)))
        t_cache = t_cache.with_length(lengths(1))
    else:
        pos = 1
        finished = pos >= total_len
        t_cache = t_cache.with_length(lengths(0))
    d_cache = d_cache.with_length(lengths(pos - 1))

    accepted = speculated = 0
    accept_log: List[int] = []
    while not finished and pos < total_len and len(accept_log) < gen_budget:
        # --- draft: gamma one-token drafter steps from buf[pos-1], then one
        # step that writes the last draft's K/V ------------------------------
        prev = buf[pos - 1:pos]
        qs, xs = [], []
        for _ in range(gamma):
            logits, d_cache = d_step(prev, d_cache)
            q = processor(logits[0, 0])
            prev = processor.sample(q, generator).reshape(1)
            qs.append(q)
            xs.append(prev)
        _, d_cache = d_step(prev, d_cache)
        q_all = torch.stack(qs)                                # [gamma, V]
        drafts = torch.cat(xs)                                 # [gamma]

        # --- verify: one target step over gamma+1 positions ---------------
        t_logits, t_cache = t_step(torch.cat([buf[pos - 1:pos], drafts]),
                                   t_cache)
        p_all = processor(t_logits[0])                         # [gamma+1, V]
        r = _accept_uniforms((1, gamma), generator, device)
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
        # restore the invariant: both caches cover pos - 1
        d_cache = d_cache.with_length(lengths(pos - 1))
        t_cache = t_cache.with_length(lengths(pos - 1))
        accept_log.append(n_h)

    return buf[:pos].tolist(), accepted, speculated, accept_log


def speculative_generate_encoder_decoder(
    inputs: Sequence[int],
    drafter_cfg: CodecConfig, drafter_params,
    target_cfg: CodecConfig, target_params,
    gamma: int = 5,
    logits_processor: Optional[LogitsProcessor] = None,
    max_gen_len: int = 40,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    use_cache: bool = True,  # API parity; the slotted cache is always used
    skip_sample_adjustment: bool = False,
    first_target: bool = True,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    debug: bool = False,
    device=None,
) -> Tuple[List[int], float]:
    """Speculative decoding for encoder-decoder models. Returns (the
    decoder ids, start token included, and the acceptance rate).
    ``generator`` (or a new one seeded with ``seed``) drives drafting,
    acceptance and resampling; ``device=None`` means the card."""
    del use_cache
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    tokens, accepted, speculated, accept_log = _codec_spec(
        drafter_cfg, drafter_params, target_cfg, target_params, inputs,
        int(gamma), int(max_gen_len), logits_processor or GreedyProcessor(),
        normalize_eos(eos_tokens_id), bool(first_target),
        bool(skip_sample_adjustment), generator, pad_token_id, device)
    rate = accepted / speculated if speculated > 0 else 0.0
    if debug:
        print(f"[codec specdec] windows={len(accept_log)} "
              f"accepts/window={accept_log} acceptance={rate:.3f}")
    return tokens, rate
