"""A witness of the program's ``int4_pair_matmul`` record, outside the
program: ``Tracer.instrument`` wraps ``qmatmul`` as ``core/model.py``
looks it up and, while ``spans.on``, records (M, K, N) of every INT4
product in ``calls``; ``close`` restores it. The benchmark's runs never
install it: they read the program's own record (``program_trace.py``).
``tests/test_torch_tracing.py`` holds that record to this one.
"""
from __future__ import annotations

import types
from typing import List, Tuple


class Tracer:
    def __init__(self, device):
        self.device = device
        self.spans = types.SimpleNamespace(on=False)
        self.calls: List[Tuple[int, int, int]] = []
        self._restore = []

    def instrument(self, batcher=None):
        """The recording wrapper around the program's ``qmatmul`` (the
        batcher is not touched)."""
        from specdec_tpu_torch.core import model as M
        from specdec_tpu_torch.quant.core import Int4Weight, StackedSlice

        orig, spans, calls = M.qmatmul, self.spans, self.calls

        def qmatmul(x, w):
            c = w.container if isinstance(w, StackedSlice) else w
            if spans.on and isinstance(c, Int4Weight):
                K = x.shape[-1]
                calls.append((x.numel() // K, K, c.packed.shape[-1]))
            return orig(x, w)
        M.qmatmul = qmatmul
        self._restore.append((M, "qmatmul", orig))

    def close(self):
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)
        self._restore.clear()
