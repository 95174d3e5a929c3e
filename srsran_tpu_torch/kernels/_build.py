"""Build ``srsran_tpu_torch/csrc/*.cu`` into one shared library at first use.

The kernels have a plain C interface, so ``nvcc`` compiles them without
PyTorch's headers (seconds, not minutes) into ``build/kernels/`` at the
repository root, named by a hash of the sources and flags; the library is
loaded with ``ctypes``.  Pointers and the stream go over as
``ctypes.c_void_p``; every C entry point returns ``cudaGetLastError()``
after its launches, and :func:`check` raises on anything but 0.

``--fmad=false`` keeps ``a + b * c`` as a rounded multiply then a rounded
add, the way PyTorch's separate tensor ops compute it: the LDPC decoder's
hard decisions are held bit-exact against its twin.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (see the matching .cu file).
SIGNATURES = {
    "srsran_ldpc_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                          _P, _I, _P, _P, _I, _P],
    "srsran_ldpc_check": [_P, _I, _P, _P],
    "srsran_rate_dematch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _F, _P],
    "srsran_pusch_demap": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _I, _P, _P, _P, _P],
    "srsran_ofdm_window": [_P, _P, _P, _I, _I, _I, _I, _P],
    "srsran_ofdm_bins_to_grid": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "srsran_dlsch_encode": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P, _I, _P, _P],
    "srsran_pdsch_map": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P,
                         _I, _I, _P, _I, _P, _I, _I, _P],
    "srsran_ofdm_grid_to_bins": [_P, _P, _I, _I, _I, _I, _P],
    "srsran_ofdm_cp_insert": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "srsran_chest_estimate": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                              _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "srsran_chest_ta": [_P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P, _P],
    "srsran_prach_corr": [_P, _P, _I, _I, _I, _I, _P, _P],
    "srsran_prach_detect": [_P, _I, _I, _I, _F, _P, _P, _I, _I, _I, _I, _F,
                            _F, _P, _I, _P, _P, _P, _P, _P],
    "srsran_pucch_f1": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _I, _I, _I, _I, _P, _P, _P, _F, _P, _P, _P, _P, _P],
    "srsran_srs_noise": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _F, _P, _P,
                         _I, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("srsran_tpu_torch: nvcc not found (PATH, $CUDA_HOME "
                       "or /usr/local/cuda); the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsrsran_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    out = library_path()
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    load.build_seconds = time.perf_counter() - t0
    return lib


def build_log() -> str:
    """nvcc's output for the current library (registers, spills), if built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
