"""90th percentile, over the requests that finished in the window, of
(end - first token) / (tokens - 1): the time per output token after the
first."""
from portbench.measure import percentile


def read(run):
    return percentile([(q.end - q.first) / (q.generated - 1) * 1e3
                       for q in run.reqs.values()
                       if run.in_window(q.end) and q.generated > 1], 90)
