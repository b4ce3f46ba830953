"""Seconds over the batcher's ``step()`` calls that worked (admissions
and the windows of one host sync), in the untraced part of the window."""


def read(run):
    return run.host_s / run.steps * 1e3 if run.steps else None
