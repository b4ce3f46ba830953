"""The paged attention kernel's (K8a's) share of its roofline over the
traced slice: the summed least time of the paged forwards whose spans
began in the slice (``measure.paged_attention_bound_s`` on the live K/V
positions and query rows each forward counted on the device) over the
summed device time of the K8a launches inside those spans."""
from portbench.measure import paged_attention_bound_s
from portbench.program_spans import slice_records


def read(run):
    recs = slice_records(run, "paged_attention")
    if not recs:
        return None
    device = run.trace.attention_by_span
    least, spans = 0.0, set()
    for span, layers, kv, q, keys, rows in recs:
        if span in device:
            least += paged_attention_bound_s(layers, kv, q, keys, rows)
            spans.add(span)
    busy = sum(device[i] for i in spans)
    return least / busy * 100.0 if busy > 0 else None
