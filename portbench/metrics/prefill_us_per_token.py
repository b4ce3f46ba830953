"""Device time of the kernels launched inside the ``admit`` spans begun in
the traced slice, over the unpadded prompt tokens of those admissions
(each admission's ``prompt``): what a prompt token costs the card to
admit, padding and the drafter's prefill included."""
from portbench.program_spans import (
    ARGS, begun_in, device_in, program, traced_slice_ns,
)


def read(run):
    p, part = program(run), traced_slice_ns(run)
    if p is None or part is None:
        return None
    admits = begun_in(p.spans, "admit", *part)
    tokens = sum((p.spans[i][ARGS] or {}).get("prompt", 0) for i in admits)
    if not tokens:
        return None
    return device_in(p.spans, run.trace.device_by_span, "admit",
                     admits) / tokens * 1e6
