"""Rows an expert multiplies in a verify forward: over the program's
``moe_route`` records made inside ``verify`` spans begun in the untraced
part of the window, the mean of the rows routed (tokens times experts a
token) over the experts given at least one row."""
from portbench.program_spans import START, ancestor, host_part_ns, program


def read(run):
    p = program(run)
    if p is None:
        return None
    lo, hi = host_part_ns(run)
    shares = [rows / touched
              for span, rows, _, touched in p.records.get("moe_route", [])
              if span >= 0 and touched and lo <= p.spans[span][START] <= hi
              and ancestor(p.spans, span, "verify") >= 0]
    return sum(shares) / len(shares) if shares else None
