"""ctypes bindings for the native sampio runtime (native/sampio.cpp).

Port of srsran_tpu/io/sampio.py over the same C ABI.  The JAX loader
rebuilds ``native/libsampio.so`` in place; this one reads ``native/`` and
writes nothing there: at first use ``g++`` compiles the source into a
directory of its own, ``build/sampio/`` at the repository root, named by a
hash of the source, the flags and the compiler's version, and the library
is loaded from there (a fresh checkout builds it once, in about a second).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "sampio.cpp"
BUILD_DIR = _REPO / "build" / "sampio"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


@functools.lru_cache(maxsize=1)
def _compiler_version() -> str:
    return subprocess.run(["g++", "--version"], capture_output=True,
                          text=True, check=True).stdout


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_compiler_version().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsampio_{h.hexdigest()[:16]}.so"


def compile_command(out: Path) -> list:
    """The g++ command that builds the library into ``out``."""
    return ["g++", *CXX_FLAGS, "-o", str(out), str(SOURCE)]


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(compile_command(tmp), check=True)
        os.replace(tmp, out)          # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(out))
    u64, u32, f64 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_double
    vp, fp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
    sigs = {
        "sampio_ring_create": (vp, [u64, u32]),
        "sampio_ring_destroy": (None, [vp]),
        "sampio_ring_capacity": (u64, [vp]),
        "sampio_ring_readable": (u64, [vp]),
        "sampio_ring_writable": (u64, [vp]),
        "sampio_ring_write": (u64, [vp, fp, u64]),
        "sampio_ring_read": (u64, [vp, fp, u64, ctypes.POINTER(u64)]),
        "sampio_file_open_write": (vp, [ctypes.c_char_p, u32, f64]),
        "sampio_file_open_read": (vp, [ctypes.c_char_p, ctypes.POINTER(u32),
                                       ctypes.POINTER(f64)]),
        "sampio_file_write": (u64, [vp, fp, u64]),
        "sampio_file_read": (u64, [vp, fp, u64]),
        "sampio_file_close": (None, [vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _as_float_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class SampleRing:
    """Timestamped SPSC multi-channel cf32 ring (native, wait-free)."""

    def __init__(self, capacity: int, nof_channels: int):
        self._lib = _load()
        self._h = self._lib.sampio_ring_create(capacity, nof_channels)
        if not self._h:
            raise MemoryError("sampio ring allocation failed")
        self.nof_channels = nof_channels
        self.capacity = self._lib.sampio_ring_capacity(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sampio_ring_destroy(self._h)
            self._h = None

    @property
    def readable(self) -> int:
        return self._lib.sampio_ring_readable(self._h)

    @property
    def writable(self) -> int:
        return self._lib.sampio_ring_writable(self._h)

    def write(self, samples: np.ndarray) -> bool:
        """samples: complex64 [channels, count].  All-or-nothing."""
        samples = np.ascontiguousarray(samples, dtype=np.complex64)
        if samples.ndim != 2 or samples.shape[0] != self.nof_channels:
            raise ValueError(f"samples must be [{self.nof_channels}, count], "
                             f"got {samples.shape}")
        count = samples.shape[1]
        n = self._lib.sampio_ring_write(
            self._h, _as_float_ptr(samples.view(np.float32)), count)
        return n == count

    def read(self, count: int):
        """Returns (samples [channels, count] complex64, timestamp) or None."""
        out = np.empty((self.nof_channels, count), dtype=np.complex64)
        ts = ctypes.c_uint64(0)
        n = self._lib.sampio_ring_read(
            self._h, _as_float_ptr(out.view(np.float32)), count,
            ctypes.byref(ts))
        if n != count:
            return None
        return out, int(ts.value)


class SampleFileWriter:
    def __init__(self, path: str, nof_channels: int, sample_rate: float):
        self._lib = _load()
        self._h = self._lib.sampio_file_open_write(
            str(path).encode(), nof_channels, sample_rate)
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.nof_channels = nof_channels

    def write(self, samples: np.ndarray):
        """samples: complex64 [channels, count] -> interleaved frames."""
        samples = np.ascontiguousarray(
            np.asarray(samples, dtype=np.complex64).T)  # [count, channels]
        self._lib.sampio_file_write(
            self._h, _as_float_ptr(samples.view(np.float32)),
            samples.shape[0])

    def close(self):
        if self._h:
            self._lib.sampio_file_close(self._h)
            self._h = None


class SampleFileReader:
    def __init__(self, path: str):
        self._lib = _load()
        ch = ctypes.c_uint32(0)
        sr = ctypes.c_double(0)
        self._h = self._lib.sampio_file_open_read(
            str(path).encode(), ctypes.byref(ch), ctypes.byref(sr))
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.nof_channels = ch.value
        self.sample_rate = sr.value

    def read(self, count: int):
        """Up to ``count`` samples per channel: complex64 [channels, n]."""
        out = np.empty((count, self.nof_channels), dtype=np.complex64)
        n = self._lib.sampio_file_read(
            self._h, _as_float_ptr(out.view(np.float32)), count)
        return out[:n].T.copy()

    def close(self):
        if self._h:
            self._lib.sampio_file_close(self._h)
            self._h = None
