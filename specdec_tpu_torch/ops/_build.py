"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface (``csrc/*.cuh`` are headers
they share). At first use, ``nvcc`` compiles it for ``sm_90a`` into a
shared library under ``build/kernels/`` at the root of the checkout
(git-ignored), named by a hash of the source, the headers and the flags so
an edited source is rebuilt, and it is loaded with ``ctypes``.
Sources are compiled in parallel, one ``nvcc`` process each. A failed build
raises with nvcc's output. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_c_float = ctypes.c_float
# C signature of each kernel library's entry point
SIGNATURES = {
    "int4_pair_matmul": [_c_void_p, _c_void_p, _c_void_p, _c_void_p,
                         _c_int, _c_int, _c_int, _c_ll, _c_ll, _c_ll,
                         _c_void_p],
    "q4_halfplane_matmul": [_c_void_p] * 4 + [_c_int] * 3 + [_c_ll] * 3
                           + [_c_int, _c_void_p],
    "int8_matmul": [_c_void_p] * 4 + [_c_int] * 3 + [_c_ll] * 3
                   + [_c_void_p],
    "paged_attention": [_c_void_p] * 8 + [_c_int] * 9
                       + [_c_ll, _c_ll, _c_float, _c_void_p],
    "decode_attention": [_c_void_p] * 7 + [_c_int] * 8
                        + [_c_float, _c_void_p],
}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in "
                           f"{cuda_home}/bin): the CUDA kernels cannot be "
                           "built")
    return path


def _target(name: str) -> Path:
    # the source and every shared header it may include
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu"]
                   + sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(names: List[str] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, all
    at once. Returns, per kernel, {"seconds": wall time of its build (0.0
    when it was already built), "ptxas": nvcc's output}."""
    names = list(SIGNATURES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, log = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            log[name] = {"seconds": 0.0, "ptxas": "(already built)"}
            continue
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name} "
                               f"(exit {proc.returncode}):\n{text}")
        os.replace(tmp, out)
        log[name] = {"seconds": time.perf_counter() - t0, "ptxas": text}
    return log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build([name])
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib
