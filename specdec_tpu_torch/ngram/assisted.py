"""N-gram-assisted speculative decoding (NASD) with a host store
(counterpart of ``specdec_tpu/ngram/assisted.py``).

Reference semantics, as in the JAX package:
- drafts come from the n-gram store, not a model; ``stop_if_unknown`` cuts
  the window at the first unknown context;
- acceptance is sample equality: draw from the target's processed
  distribution at each draft position and accept while the sample equals
  the draft; no probability-ratio test and no residual adjustment;
- on rejection the emitted token is that drawn sample; on full acceptance
  it is a draw at the extra target position;
- the store learns each committed context -> token pair and the target's
  top-``filler_top_k`` tokens at each committed position;
- the acceptance rate counts over the (possibly cut) effective gamma.

A window drafts on the host, runs one eager verify on the device (a target
forward over gamma+1 positions, sampling, matching and the rollback by
length) and reads the host once, one packed array of (n, samples,
fillers).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step
from specdec_tpu_torch.engine.batch_engine import (
    _pack_state, _pad_batch, _unpack_state, batch_prefill,
)
from specdec_tpu_torch.ngram.storage import INgramStorage
from specdec_tpu_torch.sampling.processors import (
    GreedyProcessor, LogitsProcessor,
)
from specdec_tpu_torch.sampling.utils import (
    normalize_eos, prefill_generator, stable_top_k,
)


def _nasd_batch_verify(cfg: ModelConfig, params, cache,
                       last_toks: torch.Tensor, drafts: torch.Tensor,
                       eff: torch.Tensor, active: torch.Tensor,
                       processor: LogitsProcessor, gamma: int, filler_k: int,
                       generator: torch.Generator):
    """One verify window for a batch: one target forward over
    [B, gamma+1], exact-match acceptance, per-row rollback by length
    (rows not ``active`` advance nothing). drafts [B, gamma] (entries at
    or past ``eff`` ignored). Returns (packed [B, 1 + (g+1) + (g+1)*k]
    int64 = (n, samples, fillers), the cache). The emitted token is
    samples[n]: the rejection sample and the bonus draw are one draw."""
    B = last_toks.shape[0]
    t_in = torch.cat([last_toks[:, None], drafts], dim=1)        # [B, g+1]
    logits, cache = forward_step(cfg, params, t_in, cache)
    p = processor(logits)                                        # [B, g+1, V]
    samples = processor.sample(p, generator)                     # [B, g+1]

    idx = torch.arange(gamma, device=t_in.device)[None, :]
    mismatch = (samples[:, :gamma] != drafts) & (idx < eff[:, None])
    n = torch.where(mismatch.any(dim=1),
                    torch.argmax(mismatch.to(torch.int8), dim=1), eff)
    fillers = stable_top_k(p, filler_k)[1]                      # [B, g+1, k]
    advance = torch.where(active, n + 1, 0)
    new_len = cache.length - (gamma + 1) + advance
    packed = torch.cat([n[:, None], samples, fillers.reshape(B, -1)], dim=1)
    return packed, cache.with_length(new_len.to(torch.int32))


def _draft(store: INgramStorage, tokens: List[int], gamma: int,
           stop_if_unknown: bool) -> Tuple[List[int], int]:
    """Up to ``gamma`` store lookups over the running context; returns
    (drafts, effective gamma)."""
    drafts, ctx = [], list(tokens)
    for k in range(gamma):
        tok, known = store.next_token(ctx)
        if not known and stop_if_unknown:
            return drafts, k
        drafts.append(tok)
        ctx.append(tok)
    return drafts, gamma


def _learn(store: INgramStorage, tokens: List[int], committed: List[int],
           fillers: np.ndarray, filler_top_k: int):
    """The store learns each committed token, and the fillers of its
    position, in the context before it."""
    ctx = list(tokens)
    for i, tok in enumerate(committed):
        store.update(ctx, [tok])
        if filler_top_k > 1:
            store.update(ctx, [int(t) for t in fillers[i]])
        ctx.append(tok)


def batch_ngram_assisted_generate(
    prompt_ids: Sequence[Sequence[int]],
    ngramstorage: INgramStorage,
    target_cfg: ModelConfig,
    target_params,
    gamma: int = 5,
    filler_top_k: int = 3,
    logits_processor: Optional[LogitsProcessor] = None,
    gen_len: int = 100,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    stop_if_unknown: bool = False,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    first_token_callback: Optional[Callable[[int], None]] = None,
    debug: bool = False,
    device=None,
) -> Tuple[List[List[int]], List[float]]:
    """Batched NASD: the host drafts each sequence from the SHARED store,
    one verify per window for the whole batch. Per sequence, the semantics
    of ``ngram_assisted_speculative_generate``; the store's updates land
    window by window across the batch instead of sequence by sequence.
    Under greedy sampling each sequence equals its greedy AR output
    whatever the store holds. ``generator`` (or a new one seeded with
    ``seed``) draws for every window; the prefill draws from a stream of
    its own. ``debug`` prints each sequence's window. Returns (per-seq
    generated tokens, per-seq acceptance rates)."""
    device = resolve_device(device)
    processor = logits_processor or GreedyProcessor()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    eos_set = set(normalize_eos(eos_tokens_id))
    gamma = int(gamma)
    filler_k = max(1, int(filler_top_k))
    B = len(prompt_ids)

    prompts_host = [[int(t) for t in p] for p in prompt_ids]
    prompts, lens = _pad_batch(prompts_host, pad_token_id, device)
    state = batch_prefill(None, None, target_cfg, target_params, prompts,
                          lens, int(gen_len), gamma, processor, True, False,
                          tuple(sorted(eos_set)),
                          prefill_generator(generator))
    cache = state.t_cache
    # one host read for the prefill's harvest
    buf0, pos0, plen0, _, _, finished0 = _unpack_state(
        _pack_state(state).cpu().numpy())
    total_len = np.minimum(target_cfg.max_position_embeddings,
                           plen0 + int(gen_len))

    tokens: List[List[int]] = []
    for b in range(B):
        ngramstorage.initialize(prompts_host[b])
        tokens.append(buf0[b, :pos0[b]].tolist())
        ngramstorage.update(prompts_host[b], [tokens[b][-1]])
        if first_token_callback is not None:
            first_token_callback(b)
    finished = [bool(f) for f in finished0]
    accepted = np.zeros(B, np.int64)
    speculated = np.zeros(B, np.int64)

    window = 0
    while not all(finished):
        drafts_arr = np.zeros((B, gamma), np.int64)
        eff_arr = np.zeros((B,), np.int64)
        last_arr = np.zeros((B,), np.int64)
        drafts_host: List[List[int]] = [[] for _ in range(B)]
        for b in range(B):
            if finished[b]:
                continue
            last_arr[b] = tokens[b][-1]
            corrected = min(gamma, int(total_len[b]) - len(tokens[b]) - 1)
            drafts_host[b], eff_arr[b] = _draft(ngramstorage, tokens[b],
                                                corrected, stop_if_unknown)
            speculated[b] += eff_arr[b]
            drafts_arr[b, :len(drafts_host[b])] = drafts_host[b][:gamma]

        active = torch.tensor([not f for f in finished], device=device)
        packed, cache = _nasd_batch_verify(
            target_cfg, target_params, cache,
            torch.from_numpy(last_arr).to(device),
            torch.from_numpy(drafts_arr).to(device),
            torch.from_numpy(eff_arr).to(device), active, processor, gamma,
            filler_k, generator)
        packed = packed.cpu().numpy()   # one host read per window
        n = packed[:, 0]
        samples = packed[:, 1:gamma + 2]
        fillers = packed[:, gamma + 2:].reshape(B, gamma + 1, filler_k)

        for b in range(B):
            if finished[b]:
                continue
            nb = int(n[b])
            accepted[b] += nb
            committed = drafts_host[b][:nb] + [int(samples[b, nb])]
            _learn(ngramstorage, tokens[b], committed, fillers[b],
                   filler_top_k)
            if debug:
                print(f"[nasd] seq={b} window={window} eff_gamma="
                      f"{eff_arr[b]} accepted={nb} emitted={committed}")
            for tok in committed:
                tokens[b].append(tok)
                if tok in eos_set:
                    finished[b] = True
                    break
            if len(tokens[b]) >= int(total_len[b]):
                finished[b] = True
        # the verify advanced the cache by n+1; a commit cut at EOS
        # finishes the row, whose stale cache rows are never read again
        window += 1
        if window > gen_len + 2:
            break

    outputs = [tokens[b][len(prompts_host[b]):] for b in range(B)]
    rates = [float(accepted[b]) / float(speculated[b]) if speculated[b] > 0
             else 0.0 for b in range(B)]
    return outputs, rates


def ngram_assisted_speculative_generate(
    inputs: Sequence[int],
    ngramstorage: INgramStorage,
    target_cfg: ModelConfig,
    target_params,
    gamma: int = 5,
    filler_top_k: int = 3,
    logits_processor: Optional[LogitsProcessor] = None,
    max_gen_len: int = 40,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    use_cache: bool = True,   # API parity; the slotted cache is always used
    first_target: bool = True,
    stop_if_unknown: bool = False,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    debug: bool = False,
    device=None,
) -> Tuple[List[int], float]:
    """Single-sequence NASD with the reference's API: the B=1 case of
    ``batch_ngram_assisted_generate`` (one implementation). Returns
    (generated ids, acceptance rate). ``device=None`` means the card."""
    del use_cache
    if not first_target:
        raise NotImplementedError(
            "NASD requires the target prefill step (first_target=True), as "
            "in all reference call sites")
    outs, rates = batch_ngram_assisted_generate(
        [inputs], ngramstorage, target_cfg, target_params, gamma=gamma,
        filler_top_k=filler_top_k, logits_processor=logits_processor,
        gen_len=max_gen_len, eos_tokens_id=eos_tokens_id,
        pad_token_id=pad_token_id, stop_if_unknown=stop_if_unknown,
        generator=generator, seed=seed, debug=debug, device=device)
    return outs[0], rates[0]
