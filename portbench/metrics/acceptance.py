"""Accepted drafts over drafted tokens, summed over the requests that
finished in the untraced part of the window (the batcher's device
counters)."""


def read(run):
    done = [q for q in run.reqs.values() if run.in_host(q.end)]
    drafted = sum(q.drafted for q in done)
    return sum(q.accepted for q in done) / drafted * 100.0 if drafted else None
