"""Continuous-batching serving engines (counterpart of
``specdec_tpu/serve/__init__.py``; the NASD and EAGLE batchers are not
ported yet).

``PagedContinuousBatcher`` is the DEFAULT engine: hybrid layout (paged
target pool, slotted drafter), chunked prefill, prefix caching, preemption
under pool pressure. ``ContinuousBatcher`` (slotted, KV reserved per slot)
is the other choice when every sequence may run to max length anyway.
"""
from specdec_tpu_torch.serve.paged_scheduler import PagedContinuousBatcher
from specdec_tpu_torch.serve.scheduler import ContinuousBatcher, Request

DefaultBatcher = PagedContinuousBatcher
