"""The grouped INT4 expert kernel's share of its roofline over the traced
slice: the summed least time of the launches the program recorded in the
slice (its ``int4_expert_matmul`` record: rows, K, N and the experts given
a row; ``expert_bound.expert_bound_s``) over the summed device time of the
kernel's instances there (``device_ops``)."""
from portbench.expert_bound import expert_bound_s
from portbench.program_spans import slice_records


def read(run):
    recs = slice_records(run, "int4_expert_matmul")
    if not recs:
        return None
    busy = sum(s for label, s in run.trace.device_ops
               if "int4_expert_matmul" in label)
    if busy <= 0:
        return None
    return sum(expert_bound_s(*r[1:5]) for r in recs) / busy * 100.0
