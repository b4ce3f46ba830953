"""The paged attention kernel's (K8a's) share of its roofline over the
traced slice: the summed least time of the paged forwards whose spans
began in the slice (``program_spans.paged_attention_bound_s`` on the live
K/V positions and query rows each forward counted on the device) over the
summed device time of the K8a launches inside those spans."""
from portbench.program_spans import (
    START, paged_attention_bound_s, program, traced_slice_ns,
)


def read(run):
    p, part = program(run), traced_slice_ns(run)
    if p is None or part is None:
        return None
    lo, hi = part
    device = run.trace.attention_by_span
    least, spans = 0.0, set()
    for span, layers, kv, q, keys, rows in p.records.get(
            "paged_attention", []):
        if span in device and lo <= p.spans[span][START] <= hi:
            least += paged_attention_bound_s(layers, kv, q, keys, rows)
            spans.add(span)
    busy = sum(device[i] for i in spans)
    return least / busy * 100.0 if busy > 0 else None
