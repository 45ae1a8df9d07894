"""ctypes loader for the native host kernel library (native/host_kernels.cpp).

Builds the shared library into native/build/ on first use if a toolchain is
available (under a file lock, then an atomic rename, so concurrent test
workers never see a half-written library); callers fall back to the
pure-Python implementations when it is not.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB = _NATIVE_DIR / "build" / "libsrsran_host.so"


def _build() -> None:
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    with open(_LIB.parent / ".host_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _LIB.exists():
            return
        tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
        subprocess.run(["make", "-C", str(_NATIVE_DIR), f"TARGET={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL | None:
    if not _LIB.exists():
        try:
            _build()
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None
    lib.pack_bits_u32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.unpack_bits_u32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.crc_bits.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int]
    lib.crc_bits.restype = ctypes.c_uint32
    lib.spsc_create.argtypes = [ctypes.c_int64]
    lib.spsc_create.restype = ctypes.c_void_p
    lib.spsc_destroy.argtypes = [ctypes.c_void_p]
    lib.spsc_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.spsc_write.restype = ctypes.c_int64
    lib.spsc_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.spsc_read.restype = ctypes.c_int64
    return lib


def available() -> bool:
    return load() is not None


def pack_bits(bits: np.ndarray) -> np.ndarray:
    lib = load()
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if lib is None:
        from .utils.bits import pack_bits as py_pack

        return py_pack(bits)
    words = np.empty((len(bits) + 31) // 32, dtype=np.uint32)
    lib.pack_bits_u32(bits.ctypes.data, words.ctypes.data, len(bits))
    return words


def unpack_bits(words: np.ndarray, nof_bits: int) -> np.ndarray:
    lib = load()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if lib is None:
        from .utils.bits import unpack_bits as py_unpack

        return py_unpack(words, nof_bits)
    bits = np.empty(nof_bits, dtype=np.uint8)
    lib.unpack_bits_u32(words.ctypes.data, bits.ctypes.data, nof_bits)
    return bits


def crc_bits(bits: np.ndarray, name: str) -> int:
    from .ops.crc import POLYS

    order, poly = POLYS[name]
    lib = load()
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if lib is None:
        from .ops.crc import crc_host

        rem = crc_host(bits, name)
        return int("".join(map(str, rem.tolist())), 2) if len(rem) else 0
    return int(lib.crc_bits(bits.ctypes.data, len(bits), poly & ((1 << order) - 1), order))


class SpscRing:
    """Native single-producer single-consumer IQ ring buffer."""

    def __init__(self, capacity_samples: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._ring = lib.spsc_create(capacity_samples)

    def write(self, iq_pair: np.ndarray) -> int:
        iq = np.ascontiguousarray(iq_pair, dtype=np.float32)
        return self._lib.spsc_write(self._ring, iq.ctypes.data, iq.shape[0])

    def read(self, nof_samples: int) -> np.ndarray:
        out = np.empty((nof_samples, 2), dtype=np.float32)
        self._lib.spsc_read(self._ring, out.ctypes.data, nof_samples)
        return out

    def __del__(self):
        if getattr(self, "_ring", None):
            self._lib.spsc_destroy(self._ring)
            self._ring = None
