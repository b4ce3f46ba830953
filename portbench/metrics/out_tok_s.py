"""Output tokens committed inside the window over the window's seconds:
each request's committed outputs at the close less those at the open
(finished requests and live slots alike)."""


def read(run):
    return sum(q.at_end - q.at_start for q in run.reqs.values()) / run.window_s
