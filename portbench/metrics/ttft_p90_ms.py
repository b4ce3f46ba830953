"""90th percentile over every request due in the window of its first
token's stamp less its due time; a request with no first token by the
window's close counts with its wait so far."""
from portbench.measure import percentile


def read(run):
    waits = [((q.first if q.first is not None and q.first <= run.t_end
               else run.t_end) - q.due) * 1e3
             for q in run.reqs.values() if run.in_window(q.due)]
    return percentile(waits, 90)
