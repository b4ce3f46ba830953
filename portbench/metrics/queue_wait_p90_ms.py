"""90th percentile, over every request due in the untraced part of the
window, of the wait from its due time to its admission (the batcher
taking it off the queue); a request not admitted by the window's close
counts with its wait so far."""
from portbench.measure import percentile


def read(run):
    return percentile([((q.admit if q.admit is not None
                         and q.admit <= run.t_end else run.t_end)
                        - q.due) * 1e3
                       for q in run.reqs.values() if run.in_host(q.due)],
                      90)
