"""Continuous batching scheduler for speculative decoding
(counterpart of ``specdec_tpu/serve/scheduler.py``).

A host scheduler admits requests into a FIXED number of device slots and
evicts them when they finish, while a whole-batch speculative window
(``engine/batch_engine.py``) advances every active slot. Finished slots
stay in the batch (their compute is wasted, shapes stay static) until
admission refills them without touching other slots.

- Admission prefills the new prompt as a batch-of-one on scratch caches and
  copies its KV rows, buffer row and counters into the slot, in place.
- Every forward, admissions and windows alike, goes through the batch
  engine's ``forward_step``, on the flash-decode kernel wherever
  ``kernel_route(cfg)`` holds, whatever ``attention_impl`` says (serving
  takes no gradient; the NASD and EAGLE batchers' own admissions and
  windows keep ``attention_impl``'s rule).
- The drive loop runs ``windows_per_sync`` windows per harvest, the host
  sync that reads positions back.
- Per-request metrics: TTFT, end-to-end latency, tokens, acceptance
  (``engine/metrics.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import (
    init_cache, install_slot, write_scalar,
)
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.engine.batch_engine import (
    BatchState, _pack_state, _unpack_state, batch_spec_window,
    batch_spec_windows, forward_step,
)
from specdec_tpu_torch.engine.gamma_tuner import (
    best_gamma, conditional_from_reference_rate, expected_speedup,
)
from specdec_tpu_torch.engine.metrics import RequestMetrics
from specdec_tpu_torch.sampling.processors import (
    GreedyProcessor, LogitsProcessor,
)
from specdec_tpu_torch.sampling.utils import eos_mask, normalize_eos
from specdec_tpu_torch.utils.profiling import TRACER


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_ids: List[int]
    max_new_tokens: int
    submit_time: float = 0.0
    # stamped when a batcher takes the request off its queue (preemption
    # requeues keep the FIRST dequeue time)
    dequeue_time: float = 0.0
    # filled at completion
    output_ids: Optional[List[int]] = None
    metrics: Optional[RequestMetrics] = None


def _first_token(target_cfg, drafter_cfg, t_logits, prompt_len: int,
                 max_new: int, processor, eos_ids, generator, device):
    """The admission's commit: tok0 from the prompt's last logits, and the
    slot's (pos, total, finished). prompt_len is a host int; t_logits
    [1, T, V] covers the prompt's last position at index prompt_len-1 of
    the forwarded block (callers slice for partial prefills)."""
    p0 = processor(t_logits[0, -1])
    tok0 = processor.sample(p0, generator)
    max_pos = min(target_cfg.max_position_embeddings,
                  drafter_cfg.max_position_embeddings)
    total = min(max_pos, prompt_len + max_new)
    pos = prompt_len + 1
    with TRACER.span("sync.h2d"):
        done = torch.tensor(pos >= total, device=device)
    finished = eos_mask(tok0, eos_ids) | done
    return tok0, pos, total, finished


def _scratch_prefill(cfg: ModelConfig, params, prompt: torch.Tensor,
                     S: int):
    """Prefill ``prompt`` [P] as a batch of one on a new slotted cache of
    ``S`` positions through the batch engine's ``forward_step`` (on the
    flash-decode kernel where ``kernel_route(cfg)``). Returns (logits
    [1, P, V], the cache advanced by P)."""
    cache = init_cache(cfg, 1, S, device=prompt.device)
    return forward_step(cfg, params, prompt[None, :], cache)


def _install_row(state: BatchState, slot: int, prompt: torch.Tensor,
                 prompt_len: int, tok0, pos: int, total: int, finished):
    """Set slot ``slot``'s buffer row and counters in place."""
    state.buf[slot].zero_()
    state.buf[slot, :prompt.shape[0]] = prompt
    state.buf[slot, prompt_len] = tok0
    write_scalar(state.pos, slot, pos)
    write_scalar(state.prompt_len, slot, prompt_len)
    write_scalar(state.total_len, slot, total)
    state.finished[slot] = finished
    write_scalar(state.accepted, slot, 0)
    write_scalar(state.speculated, slot, 0)


def _admit_slot(drafter_cfg: ModelConfig, drafter_params,
                target_cfg: ModelConfig, target_params,
                state: BatchState, slot: int, prompt: torch.Tensor,
                prompt_len: int, max_new: int,
                processor: LogitsProcessor, eos_ids: Tuple[int, ...],
                generator: torch.Generator) -> BatchState:
    """Prefill ``prompt`` (padded [P]) as a batch-of-one and install it in
    ``slot``: buffer row, position and limit, both models' KV rows (copied,
    so the slot never aliases the scratch caches). Edits ``state`` in place
    and returns it with the new cache lengths."""
    device = prompt.device
    S = state.buf.shape[1]
    t_logits, t1 = _scratch_prefill(target_cfg, target_params, prompt, S)
    _, d1 = _scratch_prefill(drafter_cfg, drafter_params, prompt, S)
    tok0, pos, total, finished = _first_token(
        target_cfg, drafter_cfg, t_logits[:, :prompt_len], prompt_len,
        max_new, processor, eos_ids, generator, device)
    _install_row(state, slot, prompt, prompt_len, tok0, pos, total, finished)
    return dataclasses.replace(
        state,
        t_cache=install_slot(state.t_cache, t1, slot, pos - 1),
        # drafter invariant: covers pos-2 (two-token first draft step)
        d_cache=install_slot(state.d_cache, d1, slot, pos - 2))


def data_slots(target_params, num_slots: int):
    """(mesh, slots of this data rank): under a data-parallel mesh (target
    params sharded with dp > 1) the ``num_slots`` split over the data
    ranks, else (None, num_slots). Raises ValueError when they do not
    split evenly."""
    mesh = target_params.get("mesh")
    if mesh is None or mesh.dp == 1:
        return None, num_slots
    if num_slots % mesh.dp:
        raise ValueError(f"{num_slots} slots do not split over dp={mesh.dp} "
                         "data ranks")
    return mesh, num_slots // mesh.dp


class ContinuousBatcher:
    """Admit/evict requests into fixed device slots; drive spec windows.

    ``device=None`` means the card; ``seed`` seeds the one generator that
    draws for every admission and window.

    Under a data-parallel mesh every data rank holds ``num_slots / dp``
    slots and serves the requests whose id is its data index modulo dp
    (every rank submits every request); ``run`` gathers the completed
    requests of all data ranks onto each. Greedy requests equal the
    unsharded batcher's; sampled ones draw from each rank's own generator,
    so they match the unsharded batcher in distribution, not token for
    token."""

    def __init__(self, drafter_cfg: ModelConfig, drafter_params,
                 target_cfg: ModelConfig, target_params,
                 num_slots: int = 4, gamma: int = 4,
                 max_prompt_len: int = 256, max_new_tokens: int = 128,
                 logits_processor: Optional[LogitsProcessor] = None,
                 eos_tokens_id=(),
                 skip_sample_adjustment: bool = False,
                 windows_per_sync: int = 1,
                 auto_gamma: bool = False,
                 auto_gamma_max: int = 16,
                 auto_gamma_min_drafts: int = 256,
                 gamma_cost_ratio: Optional[float] = None,
                 gamma_window_overhead: float = 0.089,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.drafter_cfg, self.drafter_params = drafter_cfg, drafter_params
        self.target_cfg, self.target_params = target_cfg, target_params
        self.data_mesh, self.B = data_slots(target_params, num_slots)
        self.gamma = gamma
        # runtime gamma adaptation (engine/gamma_tuner.py): after
        # auto_gamma_min_drafts measured drafts, switch to the model's best
        # gamma; at most twice, and only for a >= 5% predicted gain
        self.auto_gamma = auto_gamma
        self.auto_gamma_max = auto_gamma_max if auto_gamma else gamma
        self.auto_gamma_min_drafts = auto_gamma_min_drafts
        # the drafter/target cost ratio: the layer ratio scaled by the
        # per-call inflation the JAX package calibrated (1.37); a prior only
        self.gamma_cost_ratio = (
            gamma_cost_ratio
            if gamma_cost_ratio is not None
            else 1.37 * drafter_cfg.num_layers / max(1, target_cfg.num_layers))
        self.gamma_window_overhead = gamma_window_overhead
        self._auto_drafts = [0, 0]  # accepted, speculated since last retune
        self._gamma_switches = 0
        self.max_prompt_len = max_prompt_len
        self.default_max_new = max_new_tokens
        self.processor = logits_processor or GreedyProcessor()
        self.eos_ids = normalize_eos(eos_tokens_id)
        self.skip_sample_adjustment = skip_sample_adjustment
        # >1 trades admission latency for fewer host syncs
        self.windows_per_sync = max(1, int(windows_per_sync))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        # slack covers the largest window a retune may reach
        S = max_prompt_len + max_new_tokens + self.auto_gamma_max + 2
        self.S = S
        dev, B = self.device, self.B
        # empty state: every slot finished until admitted
        self.state = BatchState(
            buf=torch.zeros((B, S), dtype=torch.int64, device=dev),
            pos=torch.ones((B,), dtype=torch.int32, device=dev),
            prompt_len=torch.ones((B,), dtype=torch.int32, device=dev),
            total_len=torch.ones((B,), dtype=torch.int32, device=dev),
            finished=torch.ones((B,), dtype=torch.bool, device=dev),
            d_cache=init_cache(drafter_cfg, B, S, device=dev),
            t_cache=init_cache(target_cfg, B, S, device=dev),
            accepted=torch.zeros((B,), dtype=torch.int32, device=dev),
            speculated=torch.zeros((B,), dtype=torch.int32, device=dev),
        )
        self._init_host_state()

    def _init_host_state(self):
        """Queue and slot bookkeeping, shared by every batcher (the NASD
        batcher builds its own device state and reuses this)."""
        B = self.B
        self.queue: List[Request] = []
        self.slot_req: List[Optional[Request]] = [None] * B
        self._slot_first_token: List[Optional[float]] = [None] * B
        self.completed: Dict[int, Request] = {}
        self._next_id = 0
        # host mirror of state.pos, refreshed by every host sync that reads
        # it anyway (admission stamp, window harvest); the paged page top-up
        # reads this instead of the device
        self._host_pos = np.zeros((B,), np.int64)

    # ------------------------------------------------------------------ API
    def submit(self, prompt_ids: Sequence[int],
               max_new_tokens: Optional[int] = None) -> int:
        """Queue a request; returns its id. ``max_new_tokens`` None means
        the constructor's ``max_new_tokens``, which sized the cache: a
        request may ask for 1 up to that many, and ValueError is raised
        otherwise (the JAX batcher clamps the overflow onto the cache's
        last slots)."""
        if max_new_tokens is None:
            max_new_tokens = self.default_max_new
        elif not 1 <= max_new_tokens <= self.default_max_new:
            raise ValueError(
                f"max_new_tokens={max_new_tokens}: this batcher's cache was "
                f"sized for 1..{self.default_max_new} new tokens a request")
        rid = self._next_id
        self._next_id += 1
        mesh = self.data_mesh
        if mesh is not None and rid % mesh.dp != mesh.dp_index:
            return rid  # another data rank serves it
        req = Request(request_id=rid,
                      prompt_ids=[int(t) for t in prompt_ids][:self.max_prompt_len],
                      max_new_tokens=int(max_new_tokens),
                      submit_time=time.time())
        self.queue.append(req)
        return rid

    def _padded_prompt(self, req: Request) -> Tuple[torch.Tensor, int]:
        P = self.max_prompt_len
        prompt = np.zeros((P,), np.int64)
        n = min(len(req.prompt_ids), P)
        prompt[:n] = req.prompt_ids[:n]
        with TRACER.span("sync.h2d"):
            return torch.from_numpy(prompt).to(self.device), n

    def _admit(self, slot: int, req: Request, sync: bool = True):
        with TRACER.span("admit", req.request_id):
            prompt, n = self._padded_prompt(req)
            if TRACER.on:
                TRACER.note(prompt=n)
            with TRACER.span("prefill"):
                self.state = _admit_slot(
                    self.drafter_cfg, self.drafter_params, self.target_cfg,
                    self.target_params, self.state, slot, prompt, n,
                    req.max_new_tokens, self.processor, self.eos_ids,
                    self.generator)
            self.slot_req[slot] = req
            req.metrics = RequestMetrics(
                prompt_tokens=n, start_time=req.submit_time,
                queue_seconds=time.time() - req.submit_time)
            if sync:
                self._stamp_admissions([slot])

    def _stamp_admissions(self, slots: List[int]):
        """The admission prefill commits the first generated token, so TTFT
        stamps at admission, after one host read (a burst of admissions
        shares it)."""
        with TRACER.span("sync.stamp"):
            self._host_pos[:] = self.state.pos.cpu().numpy()
        now = time.time()
        for slot in slots:
            self._slot_first_token[slot] = now

    def _harvest(self, slot: int, buf, pos, plen, accepted, speculated):
        req = self.slot_req[slot]
        if req is None:
            return
        out = buf[slot, plen[slot]:pos[slot]].tolist()
        req.output_ids = out
        m = req.metrics
        m.generated_tokens = len(out)
        m.total_tokens = m.prompt_tokens + len(out)
        m.end_time = time.time()
        m.total_latency = m.end_time - m.start_time
        ft = self._slot_first_token[slot]
        m.first_token_time = ft or m.end_time
        m.ttft = (ft or m.end_time) - m.start_time
        m.drafts_accepted = int(accepted[slot])
        m.drafts_generated = int(speculated[slot])
        m.acceptance_rate = (m.drafts_accepted / m.drafts_generated
                             if m.drafts_generated > 0 else 0.0)
        if self.auto_gamma:
            self._auto_drafts[0] += m.drafts_accepted
            self._auto_drafts[1] += m.drafts_generated
        self.completed[req.request_id] = req
        self.slot_req[slot] = None

    def _maybe_retune_gamma(self):
        """Switch to the tuner's best gamma once enough drafts are measured
        (hysteresis: a >= 5% predicted gain, at most two switches)."""
        acc, spec = self._auto_drafts
        if spec < self.auto_gamma_min_drafts or self._gamma_switches >= 2:
            return
        a = conditional_from_reference_rate(acc / spec, self.gamma)
        g, s = best_gamma(a, self.gamma_cost_ratio,
                          self.gamma_window_overhead,
                          max_gamma=self.auto_gamma_max)
        cur = expected_speedup(a, self.gamma, self.gamma_cost_ratio,
                               self.gamma_window_overhead)
        self._auto_drafts = [0, 0]
        if g != self.gamma and s > 1.05 * cur:
            self.gamma = g
            self._gamma_switches += 1

    def step(self):
        """Fill free slots from the queue, then run the windows of one
        sync."""
        with TRACER.span("step"):
            admitted = []
            for slot in range(self.B):
                if self.slot_req[slot] is None and self.queue:
                    self._admit(slot, self.queue.pop(0), sync=False)
                    admitted.append(slot)
            if admitted:
                self._stamp_admissions(admitted)
            if all(r is None for r in self.slot_req):
                return False
            return self._window_and_harvest()

    def _window_step(self):
        """Advance the device state by windows_per_sync windows."""
        args = (self.drafter_cfg, self.drafter_params, self.target_cfg,
                self.target_params, self.state, self.gamma, self.processor,
                self.eos_ids, self.skip_sample_adjustment, self.generator)
        if self.windows_per_sync > 1:
            self.state = batch_spec_windows(*args, self.windows_per_sync)
        else:
            self.state = batch_spec_window(*args)

    def _window_and_harvest(self):
        self._window_step()
        now = time.time()
        packed = _pack_state(self.state)
        with TRACER.span("sync.harvest_read"):
            packed = packed.cpu().numpy()
        with TRACER.span("harvest"):
            buf, pos, plen, accepted, speculated, finished = _unpack_state(
                packed)
            self._host_pos[:] = pos
            for slot in range(self.B):
                if self.slot_req[slot] is not None:
                    if self._slot_first_token[slot] is None:
                        self._slot_first_token[slot] = now
                    if finished[slot]:
                        self._harvest(slot, buf, pos, plen, accepted,
                                      speculated)
            if self.auto_gamma:
                self._maybe_retune_gamma()
        return True

    def run(self) -> Dict[int, Request]:
        """Drain the queue and the active slots; returns completed requests
        by id."""
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
        return self._gathered()

    def _gathered(self) -> Dict[int, Request]:
        """``completed``, with every data rank's requests under a
        data-parallel mesh (one ``all_gather_object`` a call)."""
        if self.data_mesh is not None:
            for part in self.data_mesh.gather_rows(self.completed):
                self.completed.update(part)
        return self.completed
