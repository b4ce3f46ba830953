"""Continuous batching with the EAGLE feature-predictor drafter
(counterpart of ``specdec_tpu/serve/eagle_scheduler.py``).

The host scheduler of ``serve/scheduler.py`` over fixed device slots, with
``engine/eagle_batch.py``'s windows as the step. Admission prefills the
target as a batch of one WITH features (``forward_step_features``) and
installs the feature-buffer row beside the token row and the target's KV
row, since drafting reads the committed positions' features.

The EAGLE cache's slot row is ZEROED at admission, not prefilled: each
window's catch-up rewrites the drafter state of the last gamma + 1 pairs
from the feature buffer, but rows below the catch-up's start are attended
by position and never rewritten, so on slot reuse they would carry the
previous request's drafter K/V.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from specdec_tpu_torch.core.cache import init_cache, install_slot, zero_slot
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step_features
from specdec_tpu_torch.engine.eagle_batch import (
    EagleBatchState, eagle_batch_window, eagle_batch_windows,
)
from specdec_tpu_torch.sampling.processors import LogitsProcessor
from specdec_tpu_torch.serve.scheduler import (
    ContinuousBatcher, _commit_first_token,
)


def _admit_eagle_slot(eagle_cfg: ModelConfig, target_cfg: ModelConfig,
                      target_params, state: EagleBatchState, slot: int,
                      prompt: torch.Tensor, prompt_len: int, max_new: int,
                      processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                      generator: Optional[torch.Generator]
                      ) -> EagleBatchState:
    """Prefill ``prompt`` (padded [P]) as a batch of one with features and
    install it in ``slot``: token row, feature row, counters, the target's
    KV row (copied), and a zeroed EAGLE-cache row. Edits ``state`` in place
    and returns it with the new cache lengths."""
    S = state.buf.shape[1]
    t1 = init_cache(target_cfg, 1, S, device=prompt.device)
    t_logits, t_feats, t1 = forward_step_features(
        target_cfg, target_params, prompt[None, :], t1)
    _, pos = _commit_first_token(
        target_cfg, eagle_cfg, state, slot, prompt, prompt_len,
        t_logits[:, :prompt_len], max_new, processor, eos_ids, generator)
    state.fbuf[slot].zero_()
    state.fbuf[slot, :prompt.shape[0]] = t_feats[0].to(state.fbuf.dtype)
    return dataclasses.replace(
        state,
        t_cache=install_slot(state.t_cache, t1, slot, pos - 1),
        # rows below a window's catch-up start are attended but never
        # rewritten: zeroed, the slot's drafter state is what a new
        # engine's (eagle_batch_prefill's init_cache) would be
        e_cache=zero_slot(state.e_cache, slot, 0))


class EagleContinuousBatcher(ContinuousBatcher):
    """Admit/evict requests into fixed device slots and drive EAGLE
    windows, ``windows_per_sync`` of them between host syncs. The host
    machinery is ``ContinuousBatcher``'s, and the EAGLE head is its drafter
    (``drafter_cfg``, ``drafter_params``). ``device=None`` means the card;
    ``seed`` seeds the one generator that draws for every admission and
    window."""

    State = EagleBatchState

    def __init__(self, eagle_cfg: ModelConfig, eagle_params,
                 target_cfg: ModelConfig, target_params,
                 num_slots: int = 4, gamma: int = 4,
                 max_prompt_len: int = 256, max_new_tokens: int = 128,
                 logits_processor: Optional[LogitsProcessor] = None,
                 eos_tokens_id=(), pad_token_id: int = 0,
                 skip_sample_adjustment: bool = False,
                 windows_per_sync: int = 1,
                 seed: int = 0, device=None):
        super().__init__(
            eagle_cfg, eagle_params, target_cfg, target_params,
            num_slots=num_slots, gamma=gamma, max_prompt_len=max_prompt_len,
            max_new_tokens=max_new_tokens, logits_processor=logits_processor,
            eos_tokens_id=eos_tokens_id,
            skip_sample_adjustment=bool(skip_sample_adjustment),
            windows_per_sync=windows_per_sync, seed=seed, device=device)
        self.pad_id = pad_token_id

    def _caches(self) -> dict:
        """The target's feature rows beside its slotted cache, and the
        EAGLE head's slotted cache."""
        B, S, dev = self.B, self.S, self.device
        return dict(
            fbuf=torch.zeros((B, S, self.target_cfg.hidden_size),
                             dtype=self.target_cfg.dtype, device=dev),
            e_cache=init_cache(self.drafter_cfg, B, S, device=dev),
            t_cache=init_cache(self.target_cfg, B, S, device=dev))

    def _prefill_slot(self, slot: int, prompt: torch.Tensor, n: int,
                      max_new: int):
        self.state = _admit_eagle_slot(
            self.drafter_cfg, self.target_cfg, self.target_params,
            self.state, slot, prompt, n, max_new, self.processor,
            self.eos_ids, self.generator)

    def _window_step(self):
        args = (self.drafter_cfg, self.drafter_params, self.target_cfg,
                self.target_params, self.state, self.gamma, self.processor,
                self.eos_ids, self.skip_sample_adjustment, self.generator)
        if self.windows_per_sync > 1:
            self.state = eagle_batch_windows(*args, self.windows_per_sync)
        else:
            self.state = eagle_batch_window(*args)
