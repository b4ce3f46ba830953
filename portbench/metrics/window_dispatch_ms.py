"""Mean host time of issuing one speculative window, over the windows
begun in the untraced part of the window: the program's ``window`` span
less the ``sync.*`` spans inside it (none on today's paths).

It is the host's own time only where the host, not the device, sets the
pace: in an open-loop cell. In a backlog the device is the bottleneck, the
launch queue fills and the host waits inside the launch calls, so the span
follows device throughput; there it reads nothing."""
from portbench.program_spans import (
    END, NAME, PARENT, START, ancestor, begun_in, host_part_ns, program,
)


def read(run):
    p = program(run)
    if p is None or run.mix.get("arrivals", {}).get("kind") == "backlog":
        return None
    spans = p.spans
    windows = begun_in(spans, "window", *host_part_ns(run))
    if not windows:
        return None
    waits = dict.fromkeys(windows, 0)
    for s in spans:
        if s[NAME].startswith("sync."):
            w = ancestor(spans, s[PARENT], "window")
            if w in waits:
                waits[w] += s[END] - s[START]
    return sum(spans[w][END] - spans[w][START] - waits[w]
               for w in windows) / len(windows) / 1e6
