"""Build ``srsran_tpu_torch/csrc/*.cu`` into one shared library at first use.

The kernels have a plain C interface, so ``nvcc`` compiles them without
PyTorch's headers (seconds, not minutes): one ``nvcc -c`` per source, all
started together, then one link, into ``build/kernels/`` at the repository
root, named by a hash of the sources and flags; the library is loaded with
``ctypes``.  A fresh checkout (as ``chip_smoke.py`` runs from) pays the cold
build on every run, so the sources compile side by side.  Pointers and the stream go over as
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
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (see the matching .cu file).
SIGNATURES = {
    "srsran_ldpc_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                          _P, _I, _P, _P, _I, _I, _P],
    "srsran_ldpc_check": [_P, _I, _I, _P, _P],
    "srsran_rate_dematch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _F, _P],
    "srsran_pusch_demap": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _I, _P, _P, _P, _I, _P],
    "srsran_pusch_demap_lxn": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P, _P, _I, _I, _P, _P, _P, _P],
    "srsran_ulsch_demux": [_P, _P, _P, _P, _I, _P, _P],
    "srsran_ofdm_window": [_P, _P, _P, _I, _I, _I, _I, _P],
    "srsran_ofdm_bins_to_grid": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "srsran_dlsch_encode": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P, _I, _P, _I, _P],
    "srsran_pdsch_map": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P,
                         _I, _I, _P, _I, _P, _I, _I, _I, _P],
    "srsran_ofdm_grid_to_bins": [_P, _P, _I, _I, _I, _I, _P],
    "srsran_ofdm_cp_insert": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "srsran_chest_estimate": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                              _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _P],
    "srsran_chest_ta": [_P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P, _I, _P],
    "srsran_prach_corr": [_P, _P, _I, _I, _I, _I, _P, _P],
    "srsran_prach_detect": [_P, _I, _I, _I, _F, _P, _P, _I, _I, _I, _I, _F,
                            _F, _P, _I, _P, _P, _P, _P, _P],
    "srsran_pucch_f1": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _I, _I, _I, _I, _P, _P, _P, _F, _P, _P, _P, _P, _P],
    "srsran_srs_noise": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _F, _P, _P,
                         _I, _P, _P],
    "srsran_pucch_f0": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _F,
                        _P, _P, _P, _P, _P],
    "srsran_pucch_f2_demap": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _F,
                              _P, _P, _P],
    "srsran_short_block_detect": [_P, _I, _I, _I, _I, _P, _P, _P, _P],
    "srsran_polar_decode": [_P, _I, _I, _I, _P, _P, _I, _P, _I, _I, _I, _P,
                            _P, _P],
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
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outputs = [proc.communicate()[0] for _, proc in procs]  # wait for all
        logs = [_finish(cmd, proc, o) for (cmd, proc), o in zip(procs, outputs)]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *[str(o) for o in objs]]
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(_finish(link, proc, proc.stdout))
        for obj in objs:
            obj.unlink()
        os.replace(tmp, out)
        out.with_suffix(".log").write_text("".join(logs))
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    load.build_seconds = time.perf_counter() - t0
    return lib


def _finish(cmd: list, proc, output: str) -> str:
    """One finished nvcc's output; raises with it when nvcc failed."""
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{output}")
    return output


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
