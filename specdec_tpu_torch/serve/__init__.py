"""Continuous-batching serving engines (counterpart of
``specdec_tpu/serve/__init__.py``).

``PagedContinuousBatcher`` is the DEFAULT engine: hybrid layout (paged
target pool, slotted drafter), chunked prefill, prefix caching, preemption
under pool pressure. ``ContinuousBatcher`` (slotted, KV reserved per slot)
is the other choice when every sequence may run to max length anyway.
``NasdContinuousBatcher`` serves with the device-resident n-gram table as
its drafter (no drafter model); ``EagleContinuousBatcher`` with an EAGLE
head (slotted).
"""
from specdec_tpu_torch.serve.eagle_scheduler import EagleContinuousBatcher
from specdec_tpu_torch.serve.nasd_scheduler import NasdContinuousBatcher
from specdec_tpu_torch.serve.paged_scheduler import PagedContinuousBatcher
from specdec_tpu_torch.serve.scheduler import ContinuousBatcher, Request

DefaultBatcher = PagedContinuousBatcher
