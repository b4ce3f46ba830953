"""The FLOPs the work of the untraced part of the window requires of the
target, over its seconds at the card's dense bf16 peak: the unpadded
prompts admitted and the output tokens committed, through the target's
layer products, its head and its attention at their positions, as the
configuration's family counts them (``measure.required_flops``); the
drafter, rejected drafts and padding are not counted."""
from portbench.measure import BF16_FLOPS_PER_S, required_flops
from portbench.weights import family


def read(run):
    prompts = [q.prompt_len for q in run.reqs.values()
               if run.in_host(q.admit)]
    outputs = [(q.prompt_len, q.at_start, q.at_host)
               for q in run.reqs.values() if q.at_host > q.at_start]
    flops = required_flops(family(run.config), run.model, prompts, outputs)
    return flops / (run.host_s * BF16_FLOPS_PER_S) * 100.0
