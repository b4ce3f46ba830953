"""Blocking host/device exchanges a step: the program's ``sync.*`` spans
over its ``step`` spans, both begun in the untraced part of the
window."""
from portbench.program_spans import (
    NAME, START, begun_in, host_part_ns, program,
)


def read(run):
    p = program(run)
    if p is None:
        return None
    lo, hi = host_part_ns(run)
    steps = begun_in(p.spans, "step", lo, hi)
    if not steps:
        return None
    syncs = sum(1 for s in p.spans
                if s[NAME].startswith("sync.") and lo <= s[START] <= hi)
    return syncs / len(steps)
