"""One cell, once: build the program under test from the seed, drive its
serving engine with the mix's traffic through set-up and the measured
window, and keep what every metric and the check read.

The program is ``specdec_tpu_torch``: the configuration's published keys go
through its ``config_from_hf``; the benchmark's dense draws (``weights.py``)
through its ``quantize_params(kind="int4", fuse=True)``; the drafter is the
target's first ``exit_layer`` layers (``layer_views``), sharing the
embedding, the final norm and the head; a family file may stack its
layers its own way (``build_layers``). The window drives
``PagedContinuousBatcher`` through ``submit()`` and ``step()`` alone, in the
default hybrid layout. Due requests are submitted between steps, and the
window ends at the first step boundary past ``seconds``, without
draining.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import torch

from portbench import weights as W
from portbench.traffic import Traffic

# Greedy decoding through the program's ``GreedyProcessor``: at temperature
# 1 it accepts a draft with probability p(x)/q(x) and need not serve the
# argmax; at this temperature both distributions are one-hot, so every
# served token is the target's argmax, which the check relies on.
GREEDY_TEMPERATURE = 1e-4


@dataclasses.dataclass
class Req:
    """One request's life, on the host clock (``time.time()``, the clock
    the batcher stamps with)."""

    rid: int
    due: float
    prompt_len: int
    asked: int
    submit: Optional[float] = None
    admit: Optional[float] = None
    first: Optional[float] = None
    end: Optional[float] = None
    generated: int = 0
    accepted: int = 0
    drafted: int = 0
    at_start: int = 0    # output tokens committed when the window opened
    at_host: int = 0     # at t_host
    at_end: int = 0      # and when it closed


@dataclasses.dataclass
class Run:
    """Everything a run's metrics and its check read."""

    workload: str
    config: dict
    mix: dict
    model: dict          # weights.arch of the configuration
    seed: int
    seconds: float
    num_slots: int
    setup_s: float = 0.0
    t_start: float = 0.0
    t_end: float = 0.0
    # a traced run's device trace covers [t_host, t_end]; its host-side
    # per-layer metrics read [t_start, t_host], which the trace's overhead
    # does not slow (t_host = t_end in an untraced run)
    t_host: float = 0.0
    steps: int = 0       # step() calls that worked, in [t_start, t_host]
    live_sum: int = 0    # live slots summed over those steps
    preemptions: int = 0
    queued: tuple = (0, 0)   # requests waiting at the open and the close
    reqs: Dict[int, Req] = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None   # program_trace.TraceResult, traced
    program: Optional[object] = None  # the program's drained spans, traced
    memory_peak_bytes: int = 0   # the window's peak, allocated by torch
    kv_tokens: int = 0   # the target's live K/V positions at the close
    outputs: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    traffic: Optional[Traffic] = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def host_s(self) -> float:
        return self.t_host - self.t_start

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t_start <= t <= self.t_end

    def in_host(self, t: Optional[float]) -> bool:
        return t is not None and self.t_start <= t <= self.t_host


class Program:
    """The program under test, built from a configuration."""

    def __init__(self, cfg: dict, device):
        from specdec_tpu_torch.core.hf_loader import config_from_hf
        from specdec_tpu_torch.core.model import layer_views
        from specdec_tpu_torch.quant.core import (
            quantize_chunked, quantize_int4, quantize_params, stack_layers,
        )

        if device.type == "cuda":
            # every kernel built (once a checkout) before any traffic
            from specdec_tpu_torch.ops._build import build
            build()
        eng = cfg["engine"]
        fam = W.family(cfg)
        L = fam.arch(cfg)["L"]
        seed = cfg["weights"]["seed"]
        fmt = cfg["weights"]["format"]
        if fmt != "int4":
            raise ValueError(f"weight format {fmt!r}: the harness builds "
                             "int4 only")
        kind = cfg["drafter"]["kind"]
        if kind != "layerskip":
            raise ValueError(f"drafter kind {kind!r}: the harness builds "
                             "layerskip pairs only")
        self.t_cfg = config_from_hf(cfg, dtype=getattr(
            torch, cfg["serve_dtype"])).replace(
            attention_impl=eng["attention_impl"], kv_quant=eng["kv_quant"])
        self.d_cfg = self.t_cfg.replace(
            num_layers=cfg["drafter"]["exit_layer"])

        def dense():
            for i in range(L):
                yield W.layer(cfg, seed, i, device)

        def quantized():
            for d in dense():
                yield quantize_params({"layers": d}, kind=fmt,
                                      fuse=True)["layers"]
                del d

        build = getattr(fam, "build_layers", None)
        layers = (build(cfg, dense(), fmt) if build is not None
                  else stack_layers(quantized(), L))
        fn = W.final_norm(cfg, seed, device)
        self.target = {
            "embed": W.embedding(cfg, seed, device),
            "layers": layers,
            "final_norm_w": fn["w"],
            "lm_head": quantize_chunked(quantize_int4,
                                        W.head(cfg, seed, device)),
        }
        if fn["b"] is not None:
            self.target["final_norm_b"] = fn["b"]
        self.drafter = dict(self.target, layers=layer_views(
            self.target["layers"], self.d_cfg.num_layers))
        self.device = device

    def batcher(self, cfg: dict, mix: dict, seed: int):
        """A fresh serving engine for the mix: greedy at
        ``GREEDY_TEMPERATURE`` (served tokens are the target's argmax), no
        EOS, a page pool that backs every slot at full length."""
        from specdec_tpu_torch.core.paged_cache import required_pages
        from specdec_tpu_torch.sampling.processors import GreedyProcessor
        from specdec_tpu_torch.serve import PagedContinuousBatcher

        eng = {**cfg["engine"], **mix["engine"]}
        B, g, wps = eng["num_slots"], eng["gamma"], eng["windows_per_sync"]
        P, O, page = eng["max_prompt_len"], eng["max_new_tokens"], eng[
            "page_size"]
        S = P + O + g + 2
        horizon = wps * (g + 1) + 1
        pool = (B * required_pages(S + horizon, page) + 1) * page
        return PagedContinuousBatcher(
            self.d_cfg, self.drafter, self.t_cfg, self.target,
            num_slots=B, gamma=g, max_prompt_len=P, max_new_tokens=O,
            windows_per_sync=wps, page_size=page, pool_tokens=pool,
            logits_processor=GreedyProcessor(temperature=GREEDY_TEMPERATURE),
            eos_tokens_id=(), seed=seed % 2 ** 63, device=self.device)


def _committed(b) -> Dict[int, int]:
    """Output tokens committed so far by request id: finished requests'
    outputs and live slots' committed lengths (the host mirror of the
    positions, current at every step boundary)."""
    out = {rid: r.metrics.generated_tokens for rid, r in b.completed.items()}
    for slot, r in enumerate(b.slot_req):
        if r is not None:
            n = min(len(r.prompt_ids), b.max_prompt_len)
            out[r.request_id] = int(b._host_pos[slot]) - n
    return out


class Driver:
    """Submits the traffic's due requests between the batcher's steps. A
    backlog's requests are all due at the schedule's start; they are handed
    over as the queue runs short of one request a slot, which the batcher,
    taking its queue in order, cannot tell from handing them all at once."""

    def __init__(self, batcher, traffic: Traffic, t0: float):
        self.b, self.tr, self.t0 = batcher, traffic, t0
        self.next = 0
        self.reqs: Dict[int, Req] = {}
        self.backlog = traffic.mix["arrivals"]["kind"] == "backlog"

    def _due(self, now: float) -> bool:
        if self.next >= self.tr.n:
            return False
        if self.backlog:
            return len(self.b.queue) < self.b.B
        return self.t0 + self.tr.due[self.next] <= now

    def submit_due(self, now: float):
        tr, b = self.tr, self.b
        while self._due(now):
            i = self.next
            rid = b.submit(tr.prompt(i), max_new_tokens=int(tr.output_len[i]))
            self.reqs[rid] = Req(rid, self.t0 + float(tr.due[i]),
                                 int(tr.prompt_len[i]),
                                 int(tr.output_len[i]), submit=time.time())
            self.next += 1

    def step(self) -> bool:
        """Submit what is due, then one ``step()``; False when the batcher
        had nothing to do (it then waits for the next arrival)."""
        self.submit_due(time.time())
        if self.b.step():
            return True
        if self.next < self.tr.n:
            time.sleep(max(0.0, min(self.t0 + self.tr.due[self.next]
                                    - time.time(), 0.05)))
        return False

    def live(self) -> int:
        return sum(r is not None for r in self.b.slot_req)


def run_window(program: Program, cfg: dict, mix: dict, workload: str,
               seed: int, seconds: float, t_proc0: float,
               tracer=None) -> Run:
    """Set-up's traffic (the open loop's pre-roll, or the backlog's fill),
    then the measured window. ``tracer`` (a ``program_trace.Tracer``) is
    warmed in set-up and started at the first step boundary of the
    window's last ``slice_s``; it is stopped at the close only if it
    started (a step may run from before that boundary past the close),
    and closed in any case."""
    b = program.batcher(cfg, mix, seed)
    a = W.arch(cfg)
    traffic = Traffic(mix, seed, a["V"], seconds)
    if tracer is not None:
        tracer.warm()
    t0 = time.time()
    d = Driver(b, traffic, t0)
    arr = mix["arrivals"]
    if arr["kind"] == "poisson":
        while time.time() < t0 + arr["preroll_s"]:
            d.step()
    else:
        d.submit_due(t0)
        while d.live() < b.B:
            d.step()
    gc.collect()
    gc.freeze()
    run = Run(workload, cfg, mix, a, seed, seconds, b.B, traffic=traffic)
    if torch.cuda.is_available():
        # the peak of the window alone: set-up's transients (the slotted
        # target cache that the paged pool replaces) are no deployment's
        torch.cuda.reset_peak_memory_stats()
    run.t_start = time.time()
    run.setup_s = run.t_start - t_proc0
    start = _committed(b)
    host = None
    q0 = len(b.queue)
    trace_at = run.t_start + seconds - (
        tracer.slice_s(seconds) if tracer is not None else 0.0)
    while True:
        now = time.time()
        if now >= run.t_start + seconds:
            break
        if tracer is not None and host is None and now >= trace_at:
            run.t_host, host = now, _committed(b)
            tracer.start()
        if d.step() and host is None:
            run.steps += 1
            run.live_sum += d.live()
    run.t_end = time.time()
    if tracer is not None:
        if host is not None:
            run.trace = tracer.stop()
            run.program = tracer.drained
        tracer.close()
    gc.unfreeze()
    end = _committed(b)
    if host is None:
        run.t_host, host = run.t_end, end
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if torch.cuda.is_available() else 0)
    run.kv_tokens = sum(int(b._host_pos[s]) for s, r in enumerate(b.slot_req)
                        if r is not None)
    run.preemptions = b.preemptions
    run.queued = (q0, len(b.queue))
    _collect(run, b, d.reqs, start, host, end)
    # due in the window but not yet handed over when it closed (a step ran
    # past their due time): they count, unsent, with negative ids
    for i in range(d.next, traffic.n):
        if t0 + traffic.due[i] > run.t_end:
            break
        run.reqs[-1 - i] = Req(-1 - i, t0 + float(traffic.due[i]),
                               int(traffic.prompt_len[i]),
                               int(traffic.output_len[i]))
    return run


def _collect(run: Run, b, reqs: Dict[int, Req], start, host, end):
    """Fill each request's record from the batcher's state at the close."""
    live = {r.request_id: s for s, r in enumerate(b.slot_req)
            if r is not None}
    for rid, q in reqs.items():
        q.at_start, q.at_host, q.at_end = (start.get(rid, 0),
                                           host.get(rid, 0), end.get(rid, 0))
        if rid in b.completed:
            r = b.completed[rid]
            m = r.metrics
            q.admit = r.dequeue_time or r.submit_time + m.queue_seconds
            q.first, q.end = m.first_token_time, m.end_time
            q.generated = m.generated_tokens
            q.accepted, q.drafted = m.drafts_accepted, m.drafts_generated
            run.outputs[rid] = list(r.output_ids)
        elif rid in live:
            r = b.slot_req[live[rid]]
            q.admit = r.dequeue_time or None
            q.first = b._slot_first_token[live[rid]]
            q.generated = q.at_end
    run.reqs = reqs
