"""Latent attention's share of its roofline over the traced slice: the
summed least time of the absorbed-form forwards whose spans began in the
slice (their ``mla_attention`` records, ``measure.paged_attention_bound_s``
on the live latent positions and query rows each counted on the device)
over the device time launched inside the ``mla_attend`` spans of those
forwards."""
from portbench.measure import paged_attention_bound_s
from portbench.program_spans import NAME, PARENT, device_in, slice_records


def _under(spans, i, chosen) -> bool:
    while i >= 0:
        if i in chosen:
            return True
        i = spans[i][PARENT]
    return False


def read(run):
    recs = slice_records(run, "mla_attention")
    if not recs:
        return None
    spans = run.program.spans
    owners = {r[0] for r in recs}
    attends = [i for i, s in enumerate(spans)
               if s[NAME] == "mla_attend" and _under(spans, s[PARENT],
                                                     owners)]
    busy = device_in(spans, run.trace.device_by_span, "mla_attend", attends)
    if busy <= 0:
        return None
    least = sum(paged_attention_bound_s(layers, kv, q, keys, rows)
                for _, layers, kv, q, keys, rows in recs)
    return least / busy * 100.0
