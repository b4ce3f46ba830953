"""Mean live slots after each step in the untraced part of the window,
as a share of the batcher's slots."""


def read(run):
    if not run.steps:
        return None
    return run.live_sum / run.steps / run.num_slots * 100.0
