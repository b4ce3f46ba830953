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
import time
from typing import Optional, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache, install_slot
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step
from specdec_tpu_torch.engine.metrics import RequestMetrics
from specdec_tpu_torch.ngram.device_assisted import (
    NasdState, nasd_spec_windows, seed_table,
)
from specdec_tpu_torch.ngram.device_table import (
    DeviceNGramTable, init_device_table,
)
from specdec_tpu_torch.sampling.processors import (
    GreedyProcessor, LogitsProcessor,
)
from specdec_tpu_torch.sampling.utils import eos_mask, normalize_eos
from specdec_tpu_torch.serve.scheduler import (
    ContinuousBatcher, Request, _install_row, data_slots,
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
    device = prompt.device
    S = state.buf.shape[1]
    cache1 = init_cache(cfg, 1, S, device=device)
    logits, cache1 = forward_step(cfg, params, prompt[None, :], cache1)
    tok0 = processor.sample(processor(logits[0, prompt_len - 1]), generator)
    total = min(cfg.max_position_embeddings, prompt_len + max_new)
    pos = prompt_len + 1
    finished = eos_mask(tok0, eos_ids) | torch.tensor(pos >= total,
                                                      device=device)
    _install_row(state, slot, prompt, prompt_len, tok0, pos, total, finished)
    seed_table(table, prompt[None], state.prompt_len[slot:slot + 1],
               state.buf[slot:slot + 1], tok0[None])
    return dataclasses.replace(
        state, t_cache=install_slot(state.t_cache, cache1, slot,
                                    pos - 1)), table


class NasdContinuousBatcher(ContinuousBatcher):
    """Admit/evict requests into fixed device slots; drive device-NASD
    windows against one SHARED n-gram table.

    The host machinery (queue, slot bookkeeping, TTFT stamped at
    admission, harvest) is ``ContinuousBatcher``'s; only the device state,
    the admission and the window step differ. An injected ``table`` is
    copied, not aliased: the batcher edits its table in place, and the
    caller may hand the same learned table to several consumers.
    ``device=None`` means the card; ``seed`` seeds the one generator that
    draws for every admission and window."""

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
        self.device = resolve_device(device)
        self.target_cfg, self.target_params = target_cfg, target_params
        self.data_mesh, self.B = data_slots(target_params, num_slots)
        self.gamma = gamma
        self.auto_gamma = False
        self.filler_top_k = max(1, int(filler_top_k))
        self.stop_if_unknown = bool(stop_if_unknown)
        self.max_prompt_len = max_prompt_len
        self.default_max_new = max_new_tokens
        self.processor = logits_processor or GreedyProcessor()
        self.eos_ids = normalize_eos(eos_tokens_id)
        self.pad_id = pad_token_id
        self.windows_per_sync = max(1, int(windows_per_sync))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        S = max_prompt_len + max_new_tokens + gamma + 2
        self.S = S
        dev, B = self.device, self.B
        self.table = (table.clone() if table is not None
                      else init_device_table(n, capacity, dev))
        # empty state: every slot finished until admitted; pos=1 keeps the
        # window's pos-1 reads in bounds for slots never admitted
        self.state = NasdState(
            buf=torch.zeros((B, S), dtype=torch.int64, device=dev),
            pos=torch.ones((B,), dtype=torch.int32, device=dev),
            prompt_len=torch.ones((B,), dtype=torch.int32, device=dev),
            total_len=torch.ones((B,), dtype=torch.int32, device=dev),
            finished=torch.ones((B,), dtype=torch.bool, device=dev),
            t_cache=init_cache(target_cfg, B, S, device=dev),
            accepted=torch.zeros((B,), dtype=torch.int32, device=dev),
            speculated=torch.zeros((B,), dtype=torch.int32, device=dev),
        )
        self._init_host_state()

    def _admit(self, slot: int, req: Request, sync: bool = True):
        prompt, n = self._padded_prompt(req)
        self.state, self.table = _admit_nasd_slot(
            self.target_cfg, self.target_params, self.state, self.table,
            slot, prompt, n, req.max_new_tokens, self.processor,
            self.eos_ids, self.generator)
        self.slot_req[slot] = req
        req.metrics = RequestMetrics(prompt_tokens=n,
                                     start_time=req.submit_time,
                                     queue_seconds=time.time() - req.submit_time)
        if sync:
            self._stamp_admissions([slot])

    def _window_step(self):
        self.state, self.table = nasd_spec_windows(
            self.target_cfg, self.target_params, self.state, self.table,
            self.gamma, self.processor, self.eos_ids, self.filler_top_k,
            self.stop_if_unknown, self.generator, self.windows_per_sync)
