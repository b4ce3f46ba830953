"""Accelerator telemetry with energy integration (counterpart of
``specdec_tpu/engine/monitor.py``).

A daemon thread samples power, utilization, memory and temperature at a
set interval; ``MonitorResults`` integrates energy by the trapezoidal rule
(E = sum((P_i + P_{i+1}) / 2 * dt)) and derives average and peak power,
tokens per joule, accepted tokens per joule and tokens per kWh. A perf
callback lets the benchmark runner feed its token counts into the same
results.

Samplers (``source`` names each in the results, so an estimate is never
read as a measurement):

- ``NvmlSampler`` (``"nvml"``): NVIDIA's management library through
  ``ctypes`` on ``libnvidia-ml.so.1`` (no ``pynvml``): board power,
  GPU utilization, memory in use, temperature, summed or averaged over the
  process's cards; the enforced power limit is kept beside them;
- ``DeviceKindTdpSampler`` (``"estimated_tdp"``): cards x the nominal TDP
  of the device kind, where NVML is absent (as on a host without a card);
- ``CallableSampler`` (``"callable"``), ``NullSampler`` (``"none"``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

# nominal board TDP (watts per card) for the estimator fallback only
_GPU_TDP_WATTS = {
    "h100": 700.0,
    "h200": 700.0,
    "a100": 400.0,
    "l4": 72.0,
}
_DEFAULT_TDP = 150.0

NVML_LIBRARY = "libnvidia-ml.so.1"
_NVML_TEMPERATURE_GPU = 0


@dataclasses.dataclass
class PowerSnapshot:
    timestamp: float
    power_w: float
    utilization_pct: float = 0.0
    memory_pct: float = 0.0
    temperature_c: float = 0.0


class NullSampler:
    source = "none"

    def sample(self) -> Optional[PowerSnapshot]:
        return PowerSnapshot(time.time(), 0.0)


class CallableSampler:
    """Wrap any callable returning instantaneous watts."""

    source = "callable"

    def __init__(self, fn: Callable[[], float]):
        self._fn = fn

    def sample(self) -> Optional[PowerSnapshot]:
        try:
            return PowerSnapshot(time.time(), float(self._fn()))
        except Exception:
            return None


def _cuda_cards():
    """(count, name of card 0) of the CUDA cards this process sees; (0, "")
    without CUDA."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.device_count(), torch.cuda.get_device_name(0)
    return 0, ""


class DeviceKindTdpSampler:
    """Estimate draw as cards x the nominal TDP of the device kind."""

    source = "estimated_tdp"

    def __init__(self, num_cards: Optional[int] = None,
                 device_kind: Optional[str] = None):
        count, name = _cuda_cards()
        self.num_chips = max(1, num_cards if num_cards is not None
                             else count)
        kind = (device_kind if device_kind is not None else name).lower()
        tdp = _DEFAULT_TDP
        for key, watts in _GPU_TDP_WATTS.items():
            if key in kind:
                tdp = watts
                break
        self.watts = tdp * self.num_chips
        self.device_kind = kind or "unknown"

    def sample(self) -> Optional[PowerSnapshot]:
        return PowerSnapshot(time.time(), self.watts)


class _NvmlUtilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class _NvmlMemory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


def _visible_indices(count: int) -> List[int]:
    """NVML indices of the cards CUDA numbers 0..count-1: the integers of
    ``CUDA_VISIBLE_DEVICES`` where it lists them, else 0..count-1."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    parts = [p.strip() for p in visible.split(",") if p.strip()]
    if parts and all(p.isdigit() for p in parts):
        return [int(p) for p in parts][:count]
    return list(range(count))


_P = ctypes.c_void_p  # a pointer argument
_H = ctypes.c_void_p  # nvmlDevice_t
# (argtypes) of every NVML entry point the sampler calls; each returns
# nvmlReturn_t (0 = success)
_NVML_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlDeviceGetCount_v2": [_P],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint, _P],
    "nvmlDeviceGetPowerUsage": [_H, _P],
    "nvmlDeviceGetEnforcedPowerLimit": [_H, _P],
    "nvmlDeviceGetUtilizationRates": [_H, _P],
    "nvmlDeviceGetMemoryInfo": [_H, _P],
    "nvmlDeviceGetTemperature": [_H, ctypes.c_int, _P],
}


def _load_nvml():
    lib = ctypes.CDLL(NVML_LIBRARY)
    for name, argtypes in _NVML_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


class NvmlSampler:
    """Board power (``nvmlDeviceGetPowerUsage``, mW), GPU utilization
    (``nvmlDeviceGetUtilizationRates``), memory in use
    (``nvmlDeviceGetMemoryInfo``) and temperature
    (``nvmlDeviceGetTemperature``) of the process's cards, through
    ``ctypes``. Power is summed over the cards, the rest averaged (memory
    and temperature: the largest). ``power_limit_w`` is the sum of the
    enforced limits (``nvmlDeviceGetEnforcedPowerLimit``). Raises
    ``OSError`` where the library or a card is missing; ``lib`` replaces
    the library (tests)."""

    source = "nvml"

    def __init__(self, indices: Optional[List[int]] = None, lib=None):
        self._lib = lib if lib is not None else _load_nvml()
        self._check(self._lib.nvmlInit_v2(), "nvmlInit_v2")
        if indices is None:
            n = ctypes.c_uint(0)
            self._check(self._lib.nvmlDeviceGetCount_v2(ctypes.byref(n)),
                        "nvmlDeviceGetCount_v2")
            count = _cuda_cards()[0] or n.value
            indices = _visible_indices(min(count, n.value))
        if not indices:
            raise OSError("NVML: no card")
        self._handles = []
        for i in indices:
            h = ctypes.c_void_p()
            self._check(self._lib.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(i), ctypes.byref(h)),
                "nvmlDeviceGetHandleByIndex_v2")
            self._handles.append(h)
        self.num_chips = len(self._handles)
        self.power_limit_w = sum(self._uint(
            "nvmlDeviceGetEnforcedPowerLimit", h) for h in self._handles
        ) / 1000.0
        self.sample()  # every query answers, or the constructor raises

    @staticmethod
    def _check(rc: int, what: str):
        if rc != 0:
            raise OSError(f"NVML: {what} returned {rc}")

    def _uint(self, fn: str, handle, *args) -> int:
        v = ctypes.c_uint(0)
        self._check(getattr(self._lib, fn)(handle, *args, ctypes.byref(v)),
                    fn)
        return v.value

    def sample(self) -> Optional[PowerSnapshot]:
        power = util = 0.0
        mem = temp = 0.0
        for h in self._handles:
            power += self._uint("nvmlDeviceGetPowerUsage", h) / 1000.0
            u = _NvmlUtilization()
            self._check(self._lib.nvmlDeviceGetUtilizationRates(
                h, ctypes.byref(u)), "nvmlDeviceGetUtilizationRates")
            util += u.gpu
            m = _NvmlMemory()
            self._check(self._lib.nvmlDeviceGetMemoryInfo(
                h, ctypes.byref(m)), "nvmlDeviceGetMemoryInfo")
            if m.total:
                mem = max(mem, 100.0 * m.used / m.total)
            temp = max(temp, float(self._uint(
                "nvmlDeviceGetTemperature", h,
                ctypes.c_int(_NVML_TEMPERATURE_GPU))))
        return PowerSnapshot(time.time(), power,
                             utilization_pct=util / len(self._handles),
                             memory_pct=mem, temperature_c=temp)


def default_sampler():
    """NVML where the library and a card answer, else the labeled TDP
    estimate."""
    try:
        return NvmlSampler()
    except (OSError, AttributeError):  # no library, symbol or card
        return DeviceKindTdpSampler()


@dataclasses.dataclass
class MonitorResults:
    """Aggregated telemetry; ``to_dict`` has the JAX package's keys, and
    ``power_source`` names the sampler."""

    snapshots: List[PowerSnapshot] = dataclasses.field(default_factory=list)
    power_source: str = "none"
    num_chips: int = 1

    total_tokens: int = 0
    accepted_tokens: int = 0

    start_time: float = 0.0
    end_time: float = 0.0

    @property
    def duration(self) -> float:
        return max(0.0, self.end_time - self.start_time)

    @property
    def energy_joules(self) -> float:
        """Trapezoidal integration of power over time."""
        snaps = self.snapshots
        if len(snaps) < 2:
            return 0.0
        total = 0.0
        for a, b in zip(snaps, snaps[1:]):
            dt = b.timestamp - a.timestamp
            if dt > 0:
                total += 0.5 * (a.power_w + b.power_w) * dt
        return total

    @property
    def energy_wh(self) -> float:
        return self.energy_joules / 3600.0

    @property
    def energy_kwh(self) -> float:
        return self.energy_wh / 1000.0

    @property
    def avg_power_w(self) -> float:
        if not self.snapshots:
            return 0.0
        return sum(s.power_w for s in self.snapshots) / len(self.snapshots)

    @property
    def peak_power_w(self) -> float:
        return max((s.power_w for s in self.snapshots), default=0.0)

    @property
    def avg_utilization_pct(self) -> float:
        if not self.snapshots:
            return 0.0
        return (sum(s.utilization_pct for s in self.snapshots)
                / len(self.snapshots))

    @property
    def avg_memory_pct(self) -> float:
        if not self.snapshots:
            return 0.0
        return sum(s.memory_pct for s in self.snapshots) / len(self.snapshots)

    @property
    def peak_memory_pct(self) -> float:
        return max((s.memory_pct for s in self.snapshots), default=0.0)

    @property
    def peak_temperature_c(self) -> float:
        return max((s.temperature_c for s in self.snapshots), default=0.0)

    @property
    def tokens_per_joule(self) -> float:
        e = self.energy_joules
        return self.total_tokens / e if e > 0 else 0.0

    @property
    def accepted_tokens_per_joule(self) -> float:
        e = self.energy_joules
        return self.accepted_tokens / e if e > 0 else 0.0

    @property
    def tokens_per_kwh(self) -> float:
        e = self.energy_kwh
        return self.total_tokens / e if e > 0 else 0.0

    def to_dict(self) -> Dict:
        return {
            "power_source": self.power_source,
            "num_chips": self.num_chips,
            "duration_s": self.duration,
            "samples": len(self.snapshots),
            "avg_power_w": self.avg_power_w,
            "peak_power_w": self.peak_power_w,
            "avg_utilization_pct": self.avg_utilization_pct,
            "avg_memory_pct": self.avg_memory_pct,
            "peak_memory_pct": self.peak_memory_pct,
            "peak_temperature_c": self.peak_temperature_c,
            "energy_joules": self.energy_joules,
            "energy_wh": self.energy_wh,
            "energy_kwh": self.energy_kwh,
            "total_tokens": self.total_tokens,
            "accepted_tokens": self.accepted_tokens,
            "tokens_per_joule": self.tokens_per_joule,
            "accepted_tokens_per_joule": self.accepted_tokens_per_joule,
            "tokens_per_kwh": self.tokens_per_kwh,
        }

    def save_json(self, filepath: str):
        with open(filepath, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


class TelemetryMonitor:
    """Daemon-thread sampler; ``stop()`` takes a last sample and a last
    token reading and returns the results."""

    def __init__(self, sampler=None, interval_s: float = 1.0,
                 perf_callback: Optional[Callable[[], Dict]] = None):
        self.sampler = sampler or default_sampler()
        self.interval_s = interval_s
        self.perf_callback = perf_callback
        self.results = MonitorResults(
            power_source=getattr(self.sampler, "source", "unknown"),
            num_chips=getattr(self.sampler, "num_chips", 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _read_perf(self):
        if self.perf_callback is None:
            return
        try:
            perf = self.perf_callback() or {}
            self.results.total_tokens = int(
                perf.get("total_tokens", self.results.total_tokens))
            self.results.accepted_tokens = int(
                perf.get("accepted_tokens", self.results.accepted_tokens))
        except Exception:
            pass

    def _loop(self):
        while not self._stop.is_set():
            snap = self.sampler.sample()
            if snap is not None:
                self.results.snapshots.append(snap)
            self._read_perf()
            self._stop.wait(self.interval_s)

    def start(self):
        self.results.start_time = time.time()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> MonitorResults:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # a final bracketing sample, so that short runs still integrate,
        # and a final token reading: the JAX monitor reads tokens only in
        # its loop, so a run shorter than an interval after its last tokens
        # reports 0 tokens per joule
        snap = self.sampler.sample()
        if snap is not None:
            self.results.snapshots.append(snap)
        self._read_perf()
        self.results.end_time = time.time()
        return self.results


def print_power_summary(results: MonitorResults):
    print("\n" + "=" * 70)
    print(f"Accelerator Telemetry (source: {results.power_source}, "
          f"{results.num_chips} card(s))")
    print("=" * 70)
    print(f"  Duration:            {results.duration:.2f} s "
          f"({len(results.snapshots)} samples)")
    print(f"  Avg Power:           {results.avg_power_w:.1f} W")
    print(f"  Peak Power:          {results.peak_power_w:.1f} W")
    if results.avg_memory_pct > 0:
        print(f"  Avg Memory In Use:   {results.avg_memory_pct:.1f}% "
              f"(peak {results.peak_memory_pct:.1f}%)")
    if results.avg_utilization_pct > 0:
        print(f"  Avg Utilization:     {results.avg_utilization_pct:.1f}%")
    print(f"  Energy:              {results.energy_joules:.1f} J "
          f"({results.energy_wh:.4f} Wh)")
    print(f"  Tokens/J:            {results.tokens_per_joule:.3f}")
    print(f"  Accepted Tokens/J:   {results.accepted_tokens_per_joule:.3f}")
    print(f"  Tokens/kWh:          {results.tokens_per_kwh:,.0f}")
    if results.power_source == "estimated_tdp":
        print("  NOTE: power is a nominal-TDP estimate, not a measurement.")
    print("=" * 70)
