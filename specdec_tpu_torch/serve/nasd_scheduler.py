"""Continuous batching with the device-resident n-gram drafter: NASD
serving (counterpart of ``specdec_tpu/serve/nasd_scheduler.py``).

The model-drafter scheduler (``serve/scheduler.py``) admits requests into
fixed device slots and drives whole-batch speculative windows. This is the
same host scheduler with the drafter swapped for the SHARED
``DeviceNGramTable`` (``ngram/device_table.py``): admission also seeds the
table from the new prompt and its first token, and the window step is
``nasd_spec_windows``: drafting, verify, exact-match acceptance and table
updates on the device, one host read per window.

The table is global across slots: every admitted prompt seeds it and every
committed token updates it, so concurrent requests share learned n-grams,
as the one-shot path accumulates one table over a dataset. Exact-match
acceptance makes greedy NASD serving output equal greedy AR output for
every request, whatever the table holds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from specdec_tpu_torch.core.cache import init_cache, install_slot
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step
from specdec_tpu_torch.ngram.device_assisted import (
    NasdState, nasd_spec_windows, seed_table,
)
from specdec_tpu_torch.ngram.device_table import (
    DeviceNGramTable, init_device_table,
)
from specdec_tpu_torch.sampling.processors import LogitsProcessor
from specdec_tpu_torch.serve.scheduler import (
    ContinuousBatcher, _commit_first_token,
)


def _admit_nasd_slot(cfg: ModelConfig, params, state: NasdState,
                     table: DeviceNGramTable, slot: int,
                     prompt: torch.Tensor, prompt_len: int, max_new: int,
                     processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                     generator: torch.Generator,
                     ) -> Tuple[NasdState, DeviceNGramTable]:
    """Prefill ``prompt`` (padded [P]) as a batch-of-one, install it in
    ``slot`` (buffer row, counters and KV rows, copied in place) and seed
    the shared table from the prompt and the first committed token, as the
    one-shot batch path seeds before its loop."""
    S = state.buf.shape[1]
    cache1 = init_cache(cfg, 1, S, device=prompt.device)
    logits, cache1 = forward_step(cfg, params, prompt[None, :], cache1)
    tok0, pos = _commit_first_token(
        cfg, cfg, state, slot, prompt, prompt_len, logits[:, :prompt_len],
        max_new, processor, eos_ids, generator)
    seed_table(table, prompt[None], state.prompt_len[slot:slot + 1],
               state.buf[slot:slot + 1], tok0[None])
    return dataclasses.replace(
        state, t_cache=install_slot(state.t_cache, cache1, slot,
                                    pos - 1)), table


class NasdContinuousBatcher(ContinuousBatcher):
    """Admit/evict requests into fixed device slots; drive device-NASD
    windows against one SHARED n-gram table.

    The host machinery (queue, slot bookkeeping, TTFT stamped at
    admission, harvest) is ``ContinuousBatcher``'s; only the caches, the
    admission and the window step differ. An injected ``table`` is
    copied, not aliased: the batcher edits its table in place, and the
    caller may hand the same learned table to several consumers.
    ``device=None`` means the card; ``seed`` seeds the one generator that
    draws for every admission and window."""

    State = NasdState

    def __init__(self, target_cfg: ModelConfig, target_params,
                 num_slots: int = 4, gamma: int = 4,
                 n: int = 3, capacity: int = 1 << 16,
                 filler_top_k: int = 3, stop_if_unknown: bool = False,
                 table: Optional[DeviceNGramTable] = None,
                 max_prompt_len: int = 256, max_new_tokens: int = 128,
                 logits_processor: Optional[LogitsProcessor] = None,
                 eos_tokens_id=(), pad_token_id: int = 0,
                 windows_per_sync: int = 1,
                 seed: int = 0, device=None):
        super().__init__(
            None, None, target_cfg, target_params, num_slots=num_slots,
            gamma=gamma, max_prompt_len=max_prompt_len,
            max_new_tokens=max_new_tokens, logits_processor=logits_processor,
            eos_tokens_id=eos_tokens_id, windows_per_sync=windows_per_sync,
            seed=seed, device=device)
        self.filler_top_k = max(1, int(filler_top_k))
        self.stop_if_unknown = bool(stop_if_unknown)
        self.pad_id = pad_token_id
        self.table = (table.clone() if table is not None
                      else init_device_table(n, capacity, self.device))

    def _caches(self) -> dict:
        """The target's slotted cache: the drafter is the table."""
        return dict(t_cache=init_cache(self.target_cfg, self.B, self.S,
                                       device=self.device))

    def _prefill_slot(self, slot: int, prompt: torch.Tensor, n: int,
                      max_new: int):
        self.state, self.table = _admit_nasd_slot(
            self.target_cfg, self.target_params, self.state, self.table,
            slot, prompt, n, max_new, self.processor, self.eos_ids,
            self.generator)

    def _window_step(self):
        self.state, self.table = nasd_spec_windows(
            self.target_cfg, self.target_params, self.state, self.table,
            self.gamma, self.processor, self.eos_ids, self.filler_top_k,
            self.stop_if_unknown, self.generator, self.windows_per_sync)
