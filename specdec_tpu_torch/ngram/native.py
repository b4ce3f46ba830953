"""ctypes bridge to the native C++ n-gram store (``ngram/_native/
ngram_store.cpp``; counterpart of ``specdec_tpu/ngram/native.py``).

``NativeNGramStorage`` implements the ``INgramStorage`` interface with the
semantics of the Python ``NGramStorage`` (the tests cross-check them on
random streams) at C++ hash-map speed: the store is the host-side hot path
of NASD drafting (one lookup per draft token, one update per committed
token and filler).

At first use, g++ compiles the port's own copy of the source into a shared
library under ``build/ngram/`` at the root of the checkout (git-ignored,
beside ``build/kernels/``), named by a hash of the source and the flags so
an edited source is rebuilt. Without g++, or when the build fails,
``NativeUnavailable`` is raised: nothing swaps in the Python store.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

from specdec_tpu_torch.ngram.storage import INgramStorage

SRC = Path(__file__).resolve().parent / "_native" / "ngram_store.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ngram"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libngram_store_{digest[:12]}.so"


def build() -> Path:
    """The shared library's path, compiled first if it is not built yet."""
    with _BUILD_LOCK:
        out = _target()
        if out.exists():
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise NativeUnavailable("g++ not found on PATH: the native "
                                    "n-gram store cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        try:
            subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            detail = getattr(e, "stderr", b"")
            raise NativeUnavailable(
                f"building ngram_store failed: {e}\n"
                f"{detail.decode() if detail else ''}") from e
        os.replace(tmp, out)
        return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.ngram_create.restype = ctypes.c_void_p
        lib.ngram_create.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_uint64]
        lib.ngram_destroy.argtypes = [ctypes.c_void_p]
        lib.ngram_reset.argtypes = [ctypes.c_void_p]
        lib.ngram_next_token.restype = ctypes.c_int32
        lib.ngram_next_token.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.ngram_has_gram.restype = ctypes.c_int32
        lib.ngram_has_gram.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.ngram_update.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.ngram_initialize.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.ngram_size.restype = ctypes.c_int64
        lib.ngram_size.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _arr(ids: Sequence[int]):
    buf = (ctypes.c_int32 * len(ids))(*[int(t) for t in ids])
    return buf, len(ids)


class NativeNGramStorage(INgramStorage):
    """Backoff n-gram store backed by the C++ extension."""

    def __init__(self, n: int, vocab_size: int, seed: int = 0):
        super().__init__(n, vocab_size)
        self._h = _lib().ngram_create(n, vocab_size, seed)

    def __del__(self):
        if getattr(self, "_h", None) and _LIB is not None:
            _LIB.ngram_destroy(self._h)
            self._h = None

    def next_token(self, context: Sequence[int]) -> Tuple[int, bool]:
        buf, n = _arr(context)
        known = ctypes.c_int32(0)
        tok = _lib().ngram_next_token(self._h, buf, n, ctypes.byref(known))
        return int(tok), bool(known.value)

    def has_gram(self, ngram: Sequence[int]) -> bool:
        buf, n = _arr(ngram)
        return bool(_lib().ngram_has_gram(self._h, buf, n))

    def update(self, context: Sequence[int], next_tokens: Sequence[int]):
        cbuf, cn = _arr(context)
        tbuf, tn = _arr(next_tokens)
        _lib().ngram_update(self._h, cbuf, cn, tbuf, tn)

    def initialize(self, token_ids: Sequence[int]):
        buf, n = _arr(token_ids)
        _lib().ngram_initialize(self._h, buf, n)

    def reset(self):
        _lib().ngram_reset(self._h)

    def size(self) -> int:
        return int(_lib().ngram_size(self._h))


def native_available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False
