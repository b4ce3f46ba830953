"""Mean, over the ``step`` spans begun in the untraced part of the
window, of the target pool's pages held by slots over the pool's pages
(the garbage page left out of both), as each step's end records them."""
from portbench.program_spans import ARGS, begun_in, host_part_ns, program


def read(run):
    p = program(run)
    if p is None:
        return None
    shares = []
    for i in begun_in(p.spans, "step", *host_part_ns(run)):
        a = p.spans[i][ARGS] or {}
        if a.get("pool_pages"):
            shares.append(a["pages_held"] / a["pool_pages"])
    return 100.0 * sum(shares) / len(shares) if shares else None
