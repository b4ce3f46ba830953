"""Arithmetic over the program's own spans and records, as the program's
tracer (``specdec_tpu_torch/utils/profiling.py``) drains them: plain
Python, importing nothing of the program.

A span is ``(name, start_ns, end_ns, parent, request_id, args)`` on the
Unix clock in nanoseconds, the clock of ``time.time_ns()`` and of the
profiler's host-side events; ``parent`` indexes the span list (-1: none).
A record is ``(span, *values)``, ``span`` the innermost span open at the
call. A traced run keeps them in ``run.program``; a run of a program
without the tracer has none, and every reader then returns None.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

NAME, START, END, PARENT, RID, ARGS = range(6)


def program(run):
    """The run's drained program trace, or None."""
    return getattr(run, "program", None)


def host_part_ns(run) -> Tuple[int, int]:
    """The untraced part of the window, [t_start, t_host], in ns."""
    return int(run.t_start * 1e9), int(run.t_host * 1e9)


def traced_slice_ns(run) -> Optional[Tuple[int, int]]:
    """The profiled slice on the program's clock, or None."""
    return getattr(run.trace, "slice_ns", None) if run.trace else None


def begun_in(spans: Sequence[tuple], name: str, lo: int, hi: int
             ) -> List[int]:
    """Indices of the spans named ``name`` that began in [lo, hi]."""
    return [i for i, s in enumerate(spans)
            if s[NAME] == name and lo <= s[START] <= hi]


def ancestor(spans: Sequence[tuple], i: int, name: str) -> int:
    """The nearest span named ``name`` among ``i`` and its ancestors, or
    -1."""
    while i >= 0 and spans[i][NAME] != name:
        i = spans[i][PARENT]
    return i


def path(spans: Sequence[tuple], i: int, memo: Dict[int, str]) -> str:
    """``step/window/draft``: the names from the root span down to ``i``
    (memoised in ``memo``)."""
    if i < 0:
        return ""
    if i not in memo:
        up = path(spans, spans[i][PARENT], memo)
        memo[i] = f"{up}/{spans[i][NAME]}" if up else spans[i][NAME]
    return memo[i]


def device_in(spans: Sequence[tuple], by_span: Dict[int, float],
              name: str, chosen: Iterable[int]) -> float:
    """Seconds of ``by_span`` (device time by the innermost span open at
    each launch) launched inside one of the ``chosen`` spans named
    ``name``."""
    chosen = set(chosen)
    return sum(s for i, s in by_span.items()
               if ancestor(spans, i, name) in chosen)


def slice_records(run, kind: str) -> Optional[List[tuple]]:
    """The program's ``kind`` records made in spans begun in the traced
    slice (the slice opens and closes between steps, so no span crosses
    it), or None without a program trace."""
    p, part = program(run), traced_slice_ns(run)
    if p is None or part is None:
        return None
    lo, hi = part
    return [r for r in p.records.get(kind, [])
            if r[0] >= 0 and lo <= p.spans[r[0]][START] <= hi]


def window_part_ms(run, name: str) -> Optional[float]:
    """Milliseconds of device time launched inside the ``name`` spans
    (``draft``, ``verify``) of the windows begun in the traced slice, per
    such window."""
    p, part = program(run), traced_slice_ns(run)
    if p is None or part is None:
        return None
    spans = p.spans
    windows = set(begun_in(spans, "window", *part))
    if not windows:
        return None
    chosen = [i for i, s in enumerate(spans) if s[NAME] == name
              and ancestor(spans, s[PARENT], "window") in windows]
    return device_in(spans, run.trace.device_by_span, name,
                     chosen) / len(windows) * 1e3
