"""The INT4 weight kernel's share of its roofline over the traced window:
the summed least time of every INT4 product the model asked for
(``measure.int4_bound_s`` on its M, K, N) over the summed device time of
the ``int4_pair_matmul`` launches."""


def read(run):
    t = run.trace
    if t is None or t.int4_device_s <= 0 or not t.int4_calls:
        return None
    return t.int4_bound_s / t.int4_device_s * 100.0
