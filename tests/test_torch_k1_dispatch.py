"""K1's instances as the benchmark's trace and the wrappers' counters see
them. Every ``__global__`` kernel of ``int4_pair_matmul.cu`` carries
``int4_pair_matmul`` in its name, so the trace labels each launch as K1
and ``weight_mm_roofline`` divides K1's bounds by all of K1's device time;
and the wrappers count the calls that take the tiled instance by the
threshold the library exports, with a stub library standing in for the
built one (no CUDA here)."""
import re
import types
from pathlib import Path

import pytest
import torch

from portbench import measure
from portbench.program_trace import attribute
from specdec_tpu_torch.ops import _build
from specdec_tpu_torch.ops import quant_matmul as qm
from specdec_tpu_torch.quant.core import Int4Weight

SRC = Path(qm.__file__).resolve().parent / "csrc" / "int4_pair_matmul.cu"


def global_kernels():
    """The names of the ``__global__`` functions the K1 source defines."""
    text = SRC.read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                      r"(\w+)\s*\(", text)


def profiled(name):
    """A kernel's name as the profiler reports it: demangled, in the
    anonymous namespace, with its template arguments and parameters."""
    return (f"void (anonymous namespace)::{name}<8, 2, 2>(__nv_bfloat16 "
            "const*, int const*, __nv_bfloat16 const*, __nv_bfloat16*, int, "
            "int, int, bool)")


def test_the_source_defines_the_tiled_kernel_beside_the_old_one():
    names = global_kernels()
    assert "int4_pair_matmul_kernel" in names
    assert "int4_pair_matmul_tiled_kernel" in names
    assert len(names) == len(set(names))


def test_every_k1_kernel_is_labelled_k1():
    """measure.kernel_label, which names the kernels in ``device_ops``,
    labels every kernel of the source as K1."""
    for name in global_kernels():
        assert measure.kernel_label(profiled(name)) == "int4_pair_matmul"


def test_the_trace_counts_every_k1_kernel_as_k1():
    """program_trace.attribute counts each kernel of the source, and only
    them, into K1's launches and device time, the denominator of
    weight_mm_roofline."""
    names = global_kernels()
    spans = [("step", 1000, 9000, -1, -1, None)]
    events = [("mark", 900, 910, 1)]
    runtime = {1: 890}
    t = 1100
    for k, name in enumerate(names + ["int4_expert_matmul_kernel"]):
        events.append((profiled(name), t, t + 300, k + 2))
        runtime[k + 2] = t - 50
        t += 400
    events.append(("mark", 9500, 9510, 99))
    runtime[99] = 9400
    out = attribute(events, runtime, [], spans, [(880, 895), (9390, 9405)])
    assert out["int4_kernels"] == len(names)
    assert out["int4_device_s"] == pytest.approx(300e-9 * len(names))


class StubLibrary:
    """Stands in for the built K1 library: its entry point records the
    rows it is given and returns 0 (success); ``min_rows`` None leaves the
    threshold's export out, as an earlier source of the kernel has none."""

    def __init__(self, min_rows):
        self.rows = []
        if min_rows is not None:
            self.int4_pair_matmul_tiled_min_rows = lambda: min_rows

    def int4_pair_matmul(self, x, words, absmax, y, M, K, N, layer, ws, ams,
                         stream):
        self.rows.append(M)
        return 0


@pytest.fixture
def stub_launch(monkeypatch):
    """The kernel path of the wrappers without a card: tensors on the meta
    device, the argument check and the stream stubbed, the library one
    StubLibrary. The wrappers' counters are put back afterwards, so other
    tests in the process see them as they were."""
    for wrapper in (qm.int4_matmul, qm.int4_matmul_stacked):
        for name in ("launches", "tiled_launches"):
            monkeypatch.setattr(wrapper, name, getattr(wrapper, name))

    def install(min_rows):
        lib = StubLibrary(min_rows)
        monkeypatch.setattr(_build, "_libs", {"int4_pair_matmul": lib})
        monkeypatch.setattr(qm, "_check_kernel_args", lambda *a, **k: None)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: types.SimpleNamespace(
                                cuda_stream=0))
        return lib
    return install


K, N = 256, 64


def meta_weight(layers=None):
    lead = () if layers is None else (layers,)
    return Int4Weight(
        packed=torch.empty(lead + (K // 8, N), dtype=torch.int32,
                           device="meta"),
        absmax=torch.empty(lead + (K // 64, N), dtype=torch.bfloat16,
                           device="meta"))


@pytest.mark.parametrize("min_rows", [96, 128, 160])
@pytest.mark.parametrize("stacked", [False, True])
def test_tiled_count_follows_the_exported_threshold(stub_launch, min_rows,
                                                    stacked):
    """Each wrapper counts every launch in ``launches`` and, beside it, the
    launches of M at or above the library's threshold in
    ``tiled_launches``; the threshold is read from the library."""
    lib = stub_launch(min_rows)
    wrapper = qm.int4_matmul_stacked if stacked else qm.int4_matmul
    w = meta_weight(2 if stacked else None)
    rows = [1, 64, min_rows - 1, min_rows, min_rows + 1, 2048]
    launches, tiled = wrapper.launches, wrapper.tiled_launches
    for M in rows:
        x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
        out = (wrapper(x, w, 1) if stacked else wrapper(x, w))
        assert out.shape == (M, N)
    assert lib.rows == rows
    assert qm.int4_tiled_min_rows() == min_rows
    assert wrapper.launches - launches == len(rows)
    assert wrapper.tiled_launches - tiled == 3


def test_a_library_without_the_export_has_no_tiled_launches(stub_launch):
    """A K1 library built from a source with no tiled instance (one that
    ``chip_smoke.py --against`` times) reports none."""
    stub_launch(None)
    tiled = qm.int4_matmul.tiled_launches
    x = torch.empty((4096, K), dtype=torch.bfloat16, device="meta")
    qm.int4_matmul(x, meta_weight())
    assert qm.int4_tiled_min_rows() > 2 ** 40
    assert qm.int4_matmul.tiled_launches == tiled


def test_cpu_calls_count_nothing():
    """The plain version on the CPU counts neither launches nor tiled
    launches."""
    from specdec_tpu_torch.quant.core import quantize_int4

    w = quantize_int4(torch.randn(K, N) * 0.02)
    before = (qm.int4_matmul.launches, qm.int4_matmul.tiled_launches)
    qm.int4_matmul(torch.randn(300, K), w)
    assert (qm.int4_matmul.launches, qm.int4_matmul.tiled_launches) == before
