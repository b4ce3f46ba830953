"""The serving path's tracer: spans and per-call records, kept in memory
and drained by whoever enabled it.

- A span is ``(name, start_ns, end_ns, parent, request_id, args)``:
  ``parent`` is the index of the span that was innermost when it opened
  (-1 for none), ``request_id`` the request it serves (-1 where none
  applies; a span opened inside a request's span inherits its id), and
  ``args`` a dict of numbers noted on it, or None.
- ``records`` holds per-call records by kind: the index of the innermost
  open span, then the site's values. A record may end in a device tensor;
  ``drain`` reads every such tensor of a kind in one copy, so a site costs
  the device no host read.

Off by default. Off, a span site costs one attribute test: ``span``
returns a shared inert context and allocates nothing; ``note`` and
``record`` sites test ``on`` themselves.
``TRACER`` is the one tracer of the process, as the profiler it lines up
with is: ``enable()``, ``disable()``, then ``drain()`` for what was kept.

Clock: ``time.time_ns()``, the Unix wall clock in nanoseconds. It is the
clock on which ``torch.profiler`` (torch 2.11 with CUDA 12.8, on an NVIDIA
H100) stamps its host-side events: each ``cudaLaunchKernel`` runtime event
lies between ``time.time_ns()`` read just before and just after the
launch, and in a 10 s slice of chat serving each of the 460
``cudaStreamSynchronize`` calls lay inside the ``sync.*`` span that made
it, with no offset taken. The device's own kernel times drift from it (1
to 4.6 ms ahead over that slice), so a kernel is tied to the span that
launched it through its launch event. The ``Request`` and
``RequestMetrics`` stamps keep ``time.time()``, the same clock in
seconds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

now_ns = time.time_ns


class _Off:
    """The context a span site gets while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """The context of an open span: its exit closes it."""

    __slots__ = ("tracer", "index")

    def __init__(self, tracer: "Tracer", index: int):
        self.tracer, self.index = tracer, index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t = self.tracer
        t._ends[self.index] = now_ns()
        t._stack.pop()
        return False


@dataclasses.dataclass
class Trace:
    """What a tracer kept between ``enable`` and ``drain``."""

    spans: List[tuple]                 # (name, start, end, parent, rid, args)
    records: Dict[str, List[tuple]]    # kind -> (span, *values)


class Tracer:
    def __init__(self):
        self.on = False
        self._clear()

    def _clear(self):
        self._names: List[str] = []
        self._starts: List[int] = []
        self._ends: List[int] = []
        self._parents: List[int] = []
        self._rids: List[int] = []
        self._args: Dict[int, dict] = {}
        self._stack: List[int] = []
        self._records: Dict[str, List[tuple]] = {}

    def enable(self):
        self.on = True

    def disable(self):
        self.on = False

    def span(self, name: str, request_id: int = -1):
        """A context that records one span while the tracer is on."""
        if not self.on:
            return _OFF
        i = len(self._names)
        parent = self._stack[-1] if self._stack else -1
        if request_id < 0 and parent >= 0:
            request_id = self._rids[parent]
        self._names.append(name)
        self._starts.append(now_ns())
        self._ends.append(0)
        self._parents.append(parent)
        self._rids.append(request_id)
        self._stack.append(i)
        return _Span(self, i)

    def note(self, **values):
        """Add numbers to the innermost open span's args. Callers test
        ``on`` first."""
        if self._stack:
            args = self._args.setdefault(self._stack[-1], {})
            for k, v in values.items():
                args[k] = args.get(k, 0) + v

    def record(self, kind: str, *values):
        """One per-call record under ``kind``, tagged with the innermost
        open span. Callers test ``on`` first, so that an off tracer costs
        them no arithmetic."""
        span = self._stack[-1] if self._stack else -1
        self._records.setdefault(kind, []).append((span, *values))

    def drain(self) -> Trace:
        """Everything kept so far, and a fresh start; call it outside every
        span. Device tensors that end a kind's records are
        read here, one copy a kind."""
        spans = [(n, s, e, p, r, self._args.get(i))
                 for i, (n, s, e, p, r) in enumerate(zip(
                     self._names, self._starts, self._ends, self._parents,
                     self._rids))]
        records = {k: _read_tensors(v) for k, v in self._records.items()}
        self._clear()
        return Trace(spans, records)


def _read_tensors(rows: List[tuple]) -> List[tuple]:
    if not rows or not isinstance(rows[0][-1], torch.Tensor):
        return rows
    values = torch.stack([r[-1] for r in rows]).cpu().tolist()
    return [r[:-1] + (tuple(v) if isinstance(v, list) else (v,))
            for r, v in zip(rows, values)]


TRACER = Tracer()

