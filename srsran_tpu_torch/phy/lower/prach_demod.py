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
(a register-tiled product of the bins by the windows on the CUDA cores,
split over the samples when the tiles are too few to fill the card, the
twiddle index ((b0 + k) n) mod N_u kept in integers and read from a
float64-built table), launched through a plan cached per call signature
(``kernels/_build.py::Launch``); on CPU tensors the plain twin
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
from ...device import const
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


def _check(shape: tuple, dtype: torch.dtype, start_sample: int, n_u: int,
           reps: int, nof_fd_occasions: int):
    if nof_fd_occasions != 1:
        raise NotImplementedError(
            f"nof_fd_occasions={nof_fd_occasions}: more than one "
            "frequency-domain PRACH occasion per window is not ported yet "
            "(ROADMAP §3)")
    if len(shape) != 2 or dtype != torch.complex64:
        raise ValueError(f"samples {tuple(shape)} {dtype}: complex64 "
                         "[ports, T] expected")
    if start_sample < 0 or start_sample + reps * n_u > shape[-1]:
        raise ValueError(f"window [{start_sample}, "
                         f"{start_sample + reps * n_u}) outside "
                         f"{shape[-1]} samples")


def demodulate_ref(samples: torch.Tensor, fmt: str, sample_rate_hz: int,
                   start_sample: int, freq_offset_hz: float,
                   nof_fd_occasions: int = 1,
                   ra_scs_hz: int = 0) -> torch.Tensor:
    """Plain twin of :func:`demodulate`."""
    l_ra, n_u, reps, first_bin = geometry(fmt, sample_rate_hz,
                                          freq_offset_hz, ra_scs_hz)
    _check(samples.shape, samples.dtype, start_sample, n_u, reps,
           nof_fd_occasions)
    m = const(_bin_dft_matrix, n_u, first_bin, l_ra, device=samples.device)
    win = samples[:, start_sample:start_sample + reps * n_u].reshape(
        samples.shape[0], reps, n_u)
    return torch.einsum("kn,prn->prk", m, win)


KBINS, KWARPS = 8, 8           # csrc/prach_demod.cu kBins, kWarps


@functools.lru_cache(maxsize=None)
def _twiddle_table(n_u: int, index: int) -> torch.Tensor:
    """:func:`_twiddles` on CUDA device ``index``, uploaded once per N_u
    and kept for the life of the process (a few N_u occur; a captured
    CUDA graph may read the table at any replay)."""
    return torch.from_numpy(_twiddles(n_u)).to(torch.device("cuda", index))


def _demod_params(fmt: str, sample_rate_hz: int, start_sample: int,
                  freq_offset_hz: float, nof_fd_occasions: int,
                  ra_scs_hz: int, shape: tuple, dtype: torch.dtype,
                  sms: int) -> _build.PrachDemodParams:
    """K21's parameters for one call signature on a card of ``sms`` SMs;
    raises on what the kernel does not take.  Tiles are 8 bins by RT rows
    (RT 4, or 2 or 1 for fewer rows); when they are fewer than the SMs the
    samples split over CTAs, in whole rounds of the CTA's 8 warps over
    32-sample blocks."""
    l_ra, n_u, reps, first_bin = geometry(fmt, sample_rate_hz,
                                          freq_offset_hz, ra_scs_hz)
    _check(shape, dtype, start_sample, n_u, reps, nof_fd_occasions)
    ports = shape[0]
    rows = ports * reps
    rt = 4 if rows >= 4 else 2 if rows >= 2 else 1
    tiles = -(-l_ra // KBINS) * -(-rows // rt)
    nblocks = -(-n_u // 32)
    splits = max(1, min(-(-sms // tiles), nblocks // KWARPS))
    split_blocks = -(-nblocks // splits)
    split_blocks = -(-split_blocks // KWARPS) * KWARPS
    splits = -(-nblocks // split_blocks)
    return _build.PrachDemodParams(ports, shape[1], start_sample, n_u, reps,
                                   l_ra, first_bin, rt, splits, split_blocks,
                                   float(np.sqrt(np.float64(n_u))))


@functools.lru_cache(maxsize=1024)
def _demod_plan(fmt: str, sample_rate_hz: int, start_sample: int,
                freq_offset_hz: float, nof_fd_occasions: int, ra_scs_hz: int,
                shape: tuple, dtype: torch.dtype, index: int) -> tuple:
    """K21's launch for one call signature on CUDA device ``index``:
    (launch, output shape, split-K scratch shape or None)."""
    p = _demod_params(fmt, sample_rate_hz, start_sample, freq_offset_hz,
                      nof_fd_occasions, ra_scs_hz, shape, dtype,
                      torch.cuda.get_device_properties(index)
                      .multi_processor_count)
    launch = _build.Launch("srsran_prach_demod", index, p,
                           (_twiddle_table(p.n_u, index),))
    out = (p.ports, p.reps, p.l_ra)
    return launch, out, (p.splits,) + out if p.splits > 1 else None


def demodulate(samples: torch.Tensor, fmt: str, sample_rate_hz: int,
               start_sample: int, freq_offset_hz: float,
               nof_fd_occasions: int = 1, ra_scs_hz: int = 0) -> torch.Tensor:
    """Extract and DFT the PRACH occasion.

    samples: complex64 [ports, T] baseband at sample_rate_hz; ra_scs_hz:
    the short formats' RA subcarrier spacing (15000 << mu; 0 = 15 kHz).
    start_sample: the first sample of the preamble sequence (after its
    CP).  Returns complex64 [ports, repetitions, L_ra].  On the card one
    K21 launch (two with split-K) through the cached plan of the call's
    signature.
    """
    if not samples.is_cuda:
        return demodulate_ref(samples, fmt, sample_rate_hz, start_sample,
                              freq_offset_hz, nof_fd_occasions, ra_scs_hz)
    launch, shape, scratch_shape = _demod_plan(
        fmt, sample_rate_hz, start_sample, freq_offset_hz, nof_fd_occasions,
        ra_scs_hz, samples.shape, samples.dtype, samples.get_device())
    x = samples if samples.is_contiguous() else samples.contiguous()
    out = x.new_empty(shape)
    if scratch_shape is None:
        launch(x.data_ptr(), out.data_ptr(), 0)
    else:
        scratch = x.new_empty(scratch_shape)
        launch(x.data_ptr(), out.data_ptr(), scratch.data_ptr())
    KERNEL.count()
    return out
