"""The INT4 weight kernel's share of its roofline over the traced slice:
the summed least time of the INT4 products the program recorded in the
slice (its ``int4_pair_matmul`` record, (M, K, N) of each launch;
``measure.int4_bound_s``) over the summed device time of the
``int4_pair_matmul`` launches there."""
from portbench.measure import int4_bound_s
from portbench.program_spans import slice_records


def read(run):
    calls = slice_records(run, "int4_pair_matmul")
    if not calls or run.trace.int4_device_s <= 0:
        return None
    return (sum(int4_bound_s(*c[1:]) for c in calls)
            / run.trace.int4_device_s * 100.0)
