"""Device time of the kernels launched inside ``draft`` spans, per
``window`` begun in the traced slice: the gamma drafter forwards and
their sampling, on the card."""
from portbench.program_spans import window_part_ms


def read(run):
    return window_part_ms(run, "draft")
