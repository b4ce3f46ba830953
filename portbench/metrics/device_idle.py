"""The share of the traced window in which no operation ran on the
device: 1 - the union of the device's activity intervals over the
window."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0
