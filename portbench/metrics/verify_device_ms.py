"""Device time of the kernels launched inside ``verify`` spans, per
``window`` begun in the traced slice: the target forward over gamma+1
positions and its distributions, on the card."""
from portbench.program_spans import window_part_ms


def read(run):
    return window_part_ms(run, "verify")
