"""PRACH occasion OFDM demodulator (TS38.211 §5.3.2), kernel K21.

Port of srsran_tpu/phy/lower/prach_demod.py (the reference's
ofdm_prach_demodulator_impl, lib/phy/lower/modulation/): from the PRACH
occasion window of a baseband stream, the L_ra frequency bins at the RA
subcarrier spacing, for each repetition of the preamble:

    out[p, r, k] = N_u^-1/2 sum_n e^{-2 pi i (b0 + k) n / N_u}
                   x[p, s0 + r N_u + n]

with N_u = fs / ra_scs and b0 the first bin (the frequency offset over the
RA SCS, mod N_u).  Only the L_ra needed bins are computed, never a full
N_u-point transform (N_u reaches 98,304 for the long formats).

:func:`demodulate` is the K21 wrapper: on CUDA tensors csrc/prach_demod.cu
(one CTA per port, repetition and 8 bins, each output a direct sum over
the window, the twiddle index ((b0 + k) n) mod N_u kept in integers and
read from a float64-built table); on CPU tensors the plain twin
:func:`demodulate_ref`, the JAX function's [L_ra, N_u] bin matrix times
the windows.  The function is bound by its bytes on the card (an N_u-point
FFT per row needs fewer operations than moving the window takes); K21's
direct sum does 8 real flops per complex MAC, L_ra N_u per output row.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import kernels
from ...device import const, is_cuda
from ...kernels import _build
from ...ran.prach_params import LONG_FORMATS, SHORT_FORMATS

KERNEL = kernels.register(kernels.Kernel(
    name="prach_demod", route="cuda",
    source="srsran_tpu_torch/csrc/prach_demod.cu",
    replaces="srsran_tpu/phy/lower/prach_demod.py:29"))


@functools.lru_cache(maxsize=None)
def _bin_dft_matrix(n_u: int, first_bin: int, l_ra: int) -> np.ndarray:
    """Partial DFT: rows for bins first_bin..first_bin+L_ra of an N_u DFT."""
    k = (first_bin + np.arange(l_ra))[:, None]
    n = np.arange(n_u)[None, :]
    return (np.exp(-2j * np.pi * k * n / n_u) / np.sqrt(n_u)).astype(np.complex64)


def _twiddles(n_u: int) -> np.ndarray:
    """complex64 [N_u]: e^{-2 pi i m / N_u} / sqrt(N_u), built in float64
    as the JAX bin matrix is, indexed by the reduced phase index m."""
    m = np.arange(n_u)
    return (np.exp(-2j * np.pi * m / n_u) / np.sqrt(n_u)).astype(np.complex64)


def geometry(fmt: str, sample_rate_hz: int, freq_offset_hz: float,
             ra_scs_hz: int = 0) -> tuple:
    """(L_ra, N_u, repetitions, first bin) of an occasion."""
    if fmt in LONG_FORMATS:
        l_ra, ra_scs, reps = LONG_FORMATS[fmt]
    else:
        l_ra, ra_scs, reps = 139, (ra_scs_hz or 15_000), SHORT_FORMATS[fmt]
    n_u = sample_rate_hz // ra_scs
    first_bin = int(round(freq_offset_hz / ra_scs)) % n_u
    return l_ra, n_u, reps, first_bin


def _check(samples: torch.Tensor, start_sample: int, n_u: int, reps: int,
           nof_fd_occasions: int):
    if nof_fd_occasions != 1:
        raise NotImplementedError(
            f"nof_fd_occasions={nof_fd_occasions}: more than one "
            "frequency-domain PRACH occasion per window is not ported yet "
            "(ROADMAP §3)")
    if samples.ndim != 2 or samples.dtype != torch.complex64:
        raise ValueError(f"samples {tuple(samples.shape)} {samples.dtype}: "
                         "complex64 [ports, T] expected")
    if start_sample < 0 or start_sample + reps * n_u > samples.shape[-1]:
        raise ValueError(f"window [{start_sample}, "
                         f"{start_sample + reps * n_u}) outside "
                         f"{samples.shape[-1]} samples")


def demodulate_ref(samples: torch.Tensor, fmt: str, sample_rate_hz: int,
                   start_sample: int, freq_offset_hz: float,
                   nof_fd_occasions: int = 1,
                   ra_scs_hz: int = 0) -> torch.Tensor:
    """Plain twin of :func:`demodulate`."""
    l_ra, n_u, reps, first_bin = geometry(fmt, sample_rate_hz,
                                          freq_offset_hz, ra_scs_hz)
    _check(samples, start_sample, n_u, reps, nof_fd_occasions)
    m = const(_bin_dft_matrix, n_u, first_bin, l_ra, device=samples.device)
    win = samples[:, start_sample:start_sample + reps * n_u].reshape(
        samples.shape[0], reps, n_u)
    return torch.einsum("kn,prn->prk", m, win)


def demodulate(samples: torch.Tensor, fmt: str, sample_rate_hz: int,
               start_sample: int, freq_offset_hz: float,
               nof_fd_occasions: int = 1, ra_scs_hz: int = 0) -> torch.Tensor:
    """Extract and DFT the PRACH occasion.

    samples: complex64 [ports, T] baseband at sample_rate_hz; ra_scs_hz:
    the short formats' RA subcarrier spacing (15000 << mu; 0 = 15 kHz).
    start_sample: the first sample of the preamble sequence (after its
    CP).  Returns complex64 [ports, repetitions, L_ra].
    """
    if not is_cuda(samples):
        return demodulate_ref(samples, fmt, sample_rate_hz, start_sample,
                              freq_offset_hz, nof_fd_occasions, ra_scs_hz)
    l_ra, n_u, reps, first_bin = geometry(fmt, sample_rate_hz,
                                          freq_offset_hz, ra_scs_hz)
    _check(samples, start_sample, n_u, reps, nof_fd_occasions)
    dev = samples.device
    lib = _build.load()
    tw = const(_twiddles, n_u, device=dev)
    samples = samples.contiguous()
    ports = samples.shape[0]
    out = torch.empty((ports, reps, l_ra), dtype=torch.complex64, device=dev)
    _build.check(lib.srsran_prach_demod(
        _build.ptr(samples), ports, samples.shape[-1], start_sample, n_u,
        reps, l_ra, first_bin, _build.ptr(tw), _build.ptr(out),
        _build.stream_of(samples)), "prach_demod")
    KERNEL.count()
    return out
