"""OFDM modulation / demodulation (TS38.211 §5.3).

Port of srsran_tpu/ops/ofdm.py with its exact semantics: half-spectrum
swap between grid and DFT bins, per-symbol phase compensation
e^{-j 2 pi f_c t_l} (conjugated on RX), the optional RX FFT-window offset
into the CP with its per-bin phase ramp, and unitary (norm="ortho") FFTs.

:func:`demodulate_slot` is the K4 wrapper and :func:`modulate_slot` the K7
wrapper: on CUDA tensors each is one launch of a hand kernel
(csrc/ofdm_demod.cu, csrc/ofdm_mod.cu) that computes the whole function,
FFT included, with no cuFFT and no buffer in device memory: one CTA a
(row, symbol) transforms in registers and shared memory (csrc/ofdm.cuh),
K4 reading its window straight from the samples and storing only the used
bins, K7 loading only the grid's values and writing each symbol with its
CP.  Both go through ``kernels/_build.py::Launch``: one plan per call
signature (:func:`_ofdm_plan`; its struct, testable on the CPU, from
:func:`_ofdm_params`, its twiddle table from :func:`_fft_table`).  N is a
power of two from 128 to 4096 (the radix-16 form, :func:`_fft_stages`) or
any other 2^a 3^b 5^c up to 4096 (K18's Stockham stages,
``transform_precode.fft_plan``); any other size raises.  On CPU tensors
each runs its plain twin (:func:`demodulate_slot_ref`,
:func:`modulate_slot_ref`, with ``torch.fft``).  A leading slot axis
([B, P, ...], the slot-batch mode) is B x P rows of the same launch.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ran.cyclic_prefix import CyclicPrefix, cp_lengths, symbols_per_slot
from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build
from .transform_precode import fft_plan, fft_radices, twiddles

KERNEL = kernels.register(kernels.Kernel(
    name="ofdm_demodulate", route="cuda",
    source="srsran_tpu_torch/csrc/ofdm_demod.cu",
    replaces="srsran_tpu/ops/ofdm.py:135"))
KERNEL_TX = kernels.register(kernels.Kernel(
    name="ofdm_modulate", route="cuda",
    source="srsran_tpu_torch/csrc/ofdm_mod.cu",
    replaces="srsran_tpu/ops/ofdm.py:72"))
KERNEL_BATCH = kernels.batched(KERNEL)
KERNEL_TX_BATCH = kernels.batched(KERNEL_TX)


@functools.lru_cache(maxsize=None)
def _symbol_layout(cp: CyclicPrefix, numerology: int, dft_size: int,
                   slot_in_subframe: int):
    """(cp_lens [S], data_start_sample [S], total samples) for one slot."""
    lens = cp_lengths(cp, numerology, dft_size, slot_in_subframe)
    starts = np.zeros(len(lens), dtype=np.int64)
    pos = 0
    for i, c in enumerate(lens):
        starts[i] = pos + c
        pos += c + dft_size
    return tuple(int(x) for x in lens), tuple(int(x) for x in starts), int(pos)


@functools.lru_cache(maxsize=None)
def phase_compensation(cp: CyclicPrefix, numerology: int, dft_size: int,
                       slot_in_subframe: int, center_freq_hz: float) -> np.ndarray:
    """Per-symbol compensation factors e^{-j 2 pi f_c t_l} (complex64 [S])."""
    _, starts, _ = _symbol_layout(cp, numerology, dft_size, slot_in_subframe)
    fs = dft_size * (15_000 << numerology)
    t = np.asarray(starts, dtype=np.float64) / fs
    phase = -2.0 * np.pi * np.mod(center_freq_hz * t, 1.0)
    return np.exp(1j * phase).astype(np.complex64)


def _grid_to_bins(grid: torch.Tensor, dft_size: int) -> torch.Tensor:
    """[..., K] grid -> [..., N] DFT input with half-spectra swapped."""
    k = grid.shape[-1]
    half = k // 2
    zeros = grid.new_zeros(grid.shape[:-1] + (dft_size - k,))
    return torch.cat([grid[..., half:], zeros, grid[..., :half]], dim=-1)


def _bins_to_grid(bins: torch.Tensor, nof_sc: int) -> torch.Tensor:
    half = nof_sc // 2
    return torch.cat([bins[..., -half:], bins[..., :nof_sc - half]], dim=-1)


@functools.lru_cache(maxsize=None)
def _cp_insert_plan(cp: CyclicPrefix, numerology: int, dft_size: int,
                    slot_in_subframe: int) -> np.ndarray:
    """int32 [T]: output sample t <- flat (symbol*N + n) source index."""
    lens, _, total = _symbol_layout(cp, numerology, dft_size, slot_in_subframe)
    idx = np.empty(total, dtype=np.int32)
    pos = 0
    for l, c in enumerate(lens):
        base = l * dft_size
        idx[pos:pos + c] = base + dft_size - c + np.arange(c)
        idx[pos + c:pos + c + dft_size] = base + np.arange(dft_size)
        pos += c + dft_size
    return idx


@functools.lru_cache(maxsize=None)
def _window_plan_rx(cp: CyclicPrefix, numerology: int, dft_size: int,
                    slot_in_subframe: int, window_offset: int) -> np.ndarray:
    """int32 [S, N]: FFT window sample indices per symbol."""
    _, starts, _ = _symbol_layout(cp, numerology, dft_size, slot_in_subframe)
    return np.stack([np.arange(dft_size, dtype=np.int32) + s - window_offset
                     for s in starts], axis=0)


def _check_tx(shape: tuple, cp) -> int:
    """The symbols a slot; raises if a grid of ``shape`` [..., S, K] has
    another count."""
    nsym = symbols_per_slot(cp)
    if len(shape) < 2 or shape[-2] != nsym:
        raise ValueError(f"grid {tuple(shape)} has no {nsym} symbols")
    return nsym


def modulate_slot_ref(grid: torch.Tensor, dft_size: int, numerology: int,
                      cp: CyclicPrefix = CyclicPrefix.NORMAL,
                      slot_in_subframe: int = 0, center_freq_hz: float = 0.0,
                      scale: float = 1.0) -> torch.Tensor:
    """Plain twin of :func:`modulate_slot` (any leading dims)."""
    nsym = _check_tx(grid.shape, cp)
    bins = _grid_to_bins(grid.to(torch.complex64), dft_size)
    x = torch.fft.ifft(bins, dim=-1, norm="ortho")
    comp = const(phase_compensation, cp, numerology, dft_size,
                 slot_in_subframe, float(center_freq_hz), device=grid.device)
    x = x * (scale * comp)[..., :, None]
    plan = const(_cp_insert_plan, cp, numerology, dft_size, slot_in_subframe,
                 device=grid.device, dtype=torch.long)
    out = x.reshape(x.shape[:-2] + (nsym * dft_size,))[..., plan]
    return out.to(torch.complex64)


def modulate_slot(grid: torch.Tensor, dft_size: int, numerology: int,
                  cp: CyclicPrefix = CyclicPrefix.NORMAL,
                  slot_in_subframe: int = 0, center_freq_hz: float = 0.0,
                  scale: float = 1.0) -> torch.Tensor:
    """OFDM-modulate one slot.  grid complex64 [P, S, K] -> samples [P, T];
    with a slot axis, [B, P, S, K] -> [B, P, T] (the twin also takes other
    leading dims).  On CUDA one launch of K7."""
    if not is_cuda(grid):
        return modulate_slot_ref(grid, dft_size, numerology, cp,
                                 slot_in_subframe, center_freq_hz, scale)
    if grid.dtype != torch.complex64:
        raise ValueError(f"grid must be complex64 [(B,) P, S, K], got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    launch, shape, counter = _ofdm_plan(
        "mod", tuple(grid.shape), grid.shape[-1], int(dft_size),
        int(numerology), cp, int(slot_in_subframe), float(center_freq_hz),
        float(scale), 0, grid.get_device())
    x = grid if grid.is_contiguous() else grid.contiguous()
    out = x.new_empty(shape)
    launch(x.data_ptr(), out.data_ptr())
    counter.count()
    return out


@functools.lru_cache(maxsize=None)
def _rx_tables(cp, numerology, dft_size, slot_in_subframe, center_freq_hz,
               scale, window_offset):
    """The twin's host tables: (conj(comp) * scale [S] complex64, the
    per-bin ramp [N] complex64 or None)."""
    comp = np.conj(phase_compensation(cp, numerology, dft_size,
                                      slot_in_subframe, center_freq_hz))
    rot = None
    if window_offset:
        kbin = np.arange(dft_size)
        kbin = np.where(kbin < dft_size // 2, kbin, kbin - dft_size)
        rot = np.exp(1j * 2 * np.pi * window_offset * kbin / dft_size
                     ).astype(np.complex64)
    return (np.complex64(scale) * comp).astype(np.complex64), rot


def _rx_table(i: int, *key) -> np.ndarray:
    """One of the :func:`_rx_tables` (0: compensation, 1: ramp)."""
    return _rx_tables(*key)[i]


def max_window_offset(dft_size: int) -> int:
    """The largest RX FFT-window offset into the CP: half the normal CP."""
    return (144 * dft_size // 2048) // 2


def _check_rx(shape: tuple, cp, numerology, dft_size, slot_in_subframe,
              window_offset) -> tuple:
    """The slot's :func:`_symbol_layout`; raises if samples of ``shape``
    [..., T] hold another slot length or the offset is out of range."""
    layout = _symbol_layout(cp, numerology, dft_size, slot_in_subframe)
    total = layout[2]
    if not shape or shape[-1] != total:
        raise ValueError(f"samples {tuple(shape)}: a slot of {total} "
                         f"samples a row")
    max_off = max_window_offset(dft_size)
    if not 0 <= window_offset <= max_off:
        raise ValueError(f"window_offset {window_offset} outside [0, {max_off}]")
    return layout


def demodulate_slot_ref(samples: torch.Tensor, nof_sc: int, dft_size: int,
                        numerology: int, cp: CyclicPrefix = CyclicPrefix.NORMAL,
                        slot_in_subframe: int = 0, center_freq_hz: float = 0.0,
                        scale: float = 1.0, window_offset: int = 0) -> torch.Tensor:
    """Plain twin of :func:`demodulate_slot`."""
    _check_rx(samples.shape, cp, numerology, dft_size, slot_in_subframe,
              window_offset)
    dev = samples.device
    plan = const(_window_plan_rx, cp, numerology, dft_size, slot_in_subframe,
                 window_offset, device=dev, dtype=torch.long)
    x = samples[..., plan]                                  # [..., S, N]
    bins = torch.fft.fft(x, dim=-1, norm="ortho")
    key = (cp, numerology, dft_size, slot_in_subframe, float(center_freq_hz),
           float(scale), int(window_offset))
    if window_offset:
        bins = bins * const(_rx_table, 1, *key, device=dev)
    bins = bins * const(_rx_table, 0, *key, device=dev)[..., :, None]
    return _bins_to_grid(bins, nof_sc).to(torch.complex64)


def demodulate_slot(samples: torch.Tensor, nof_sc: int, dft_size: int,
                    numerology: int, cp: CyclicPrefix = CyclicPrefix.NORMAL,
                    slot_in_subframe: int = 0, center_freq_hz: float = 0.0,
                    scale: float = 1.0, window_offset: int = 0) -> torch.Tensor:
    """OFDM-demodulate one slot.  samples complex64 [P, T] -> grid [P, S, K];
    with a slot axis, [B, P, T] -> [B, P, S, K].  On CUDA one launch of
    K4."""
    if not is_cuda(samples):
        return demodulate_slot_ref(samples, nof_sc, dft_size, numerology, cp,
                                   slot_in_subframe, center_freq_hz, scale,
                                   window_offset)
    if samples.dtype != torch.complex64:
        raise ValueError(f"samples must be complex64 [(B,) P, T], got "
                         f"{samples.dtype} {tuple(samples.shape)}")
    launch, shape, counter = _ofdm_plan(
        "demod", tuple(samples.shape), int(nof_sc), int(dft_size),
        int(numerology), cp, int(slot_in_subframe), float(center_freq_hz),
        float(scale), int(window_offset), samples.get_device())
    x = samples if samples.is_contiguous() else samples.contiguous()
    grid = x.new_empty(shape)
    launch(x.data_ptr(), grid.data_ptr())
    counter.count()
    return grid


# ------------------------------------------------- the kernels' host plan

OFDM_MIN_POW2 = 128        # the radix-16 form: N = 2^7 ...
OFDM_MAX_POINTS = 4096     # ... to 2^12 (csrc/ofdm.cuh kOfdmMaxPoints)
# the Stockham form's dynamic shared memory: two buffers and the table
OFDM_MIXED_SMEM = 3 * OFDM_MAX_POINTS * 8


def _fft_form(n: int) -> int:
    """The kernels' form of an N-point transform: log2 N for the radix-16
    form (a power of two from 128 to 4096), 0 for the Stockham form (any
    other 2^a 3^b 5^c up to 4096); raises a ValueError naming the limit
    for any other size."""
    if 1 <= n <= OFDM_MAX_POINTS:
        if n >= OFDM_MIN_POW2 and n & (n - 1) == 0:
            return n.bit_length() - 1
        try:
            fft_radices(n)
            return 0
        except ValueError:
            pass
    raise ValueError(f"K4 and K7 take a DFT of at most {OFDM_MAX_POINTS} "
                     f"points of the form 2^a 3^b 5^c (a power of two from "
                     f"{OFDM_MIN_POW2} in the radix-16 form); got {n}")


@functools.lru_cache(maxsize=None)
def _fft_stages(n: int) -> tuple:
    """The radix-16 form's stages of N = 2^n: radix 16, with a last stage
    of radix 2, 4 or 8 where 4 does not divide n (csrc/ofdm.cuh Form)."""
    log = n.bit_length() - 1
    full, rest = divmod(log, 4)
    return (16,) * full + ((1 << rest,) if rest else ())


def _fft_offsets(n: int) -> tuple:
    """Where stages 1, 2, ... find their first twiddle in
    :func:`_fft_table`, after the N entries of ``twiddles(n)`` (stage 0
    has none)."""
    offs, off, span = [], n, 1
    for s, r in enumerate(_fft_stages(n)):
        if s:
            offs.append(off)
            off += (r - 1) * span
        span *= r
    return tuple(offs)


@functools.lru_cache(maxsize=None)
def _fft_table(n: int, window_offset: int = 0) -> np.ndarray:
    """The kernels' twiddle table, complex64: ``twiddles(n)``, exp(2j pi m
    / N) built in float64 and rounded once (the Stockham form's table);
    then in the radix-16 form stage s's [R - 1, L] entries (r - 1, k) =
    exp(2j pi r k N / (L R) / N), taken from it (the forward transform
    uses their conjugates); then, for K4 with a window offset, the ramp of
    bin b, its entry (offset b mod N) (:func:`_ramp_offset`)."""
    full = twiddles(n)
    parts, span = [full], 1
    if _fft_form(n):
        for s, r in enumerate(_fft_stages(n)):
            if s:
                step = n // (span * r)
                idx = (np.arange(1, r)[:, None] * np.arange(span)[None]
                       * step) % n
                parts.append(full[idx].reshape(-1))
            span *= r
    if window_offset:
        parts.append(full[(window_offset * np.arange(n)) % n])
    return np.concatenate(parts)


def _ramp_offset(n: int) -> int:
    """Where the ramp starts in :func:`_fft_table` (after the twiddles)."""
    return len(_fft_table(n))


def _ofdm_params(kind: str, shape: tuple, nof_sc: int, n: int,
                 numerology: int, cp: CyclicPrefix, slot_in_subframe: int,
                 center_freq_hz: float, scale: float,
                 window_offset: int) -> _build.OfdmParams:
    """K4's (``kind`` "demod": samples of ``shape`` [(B,) P, T]) or K7's
    ("mod": a grid [(B,) P, S, K]) parameters for one call signature;
    raises on what the kernels do not take."""
    form = _fft_form(n)
    lens, starts, total = _symbol_layout(cp, numerology, n, slot_in_subframe)
    nsym = len(lens)
    if kind == "demod":
        _check_rx(shape, cp, numerology, n, slot_in_subframe, window_offset)
        if len(shape) not in (2, 3) or 0 in shape:
            raise ValueError(f"samples {tuple(shape)}: a slot of {total} "
                             f"samples a row, [(B,) P, T]")
        lead = shape[:-1]
    else:
        _check_tx(shape, cp)
        if len(shape) not in (3, 4) or 0 in shape:
            raise ValueError(f"grid {tuple(shape)}: [(B,) P, {nsym}, K]")
        lead = shape[:-2]
    if not 1 <= nof_sc <= n:
        raise ValueError(f"{nof_sc} subcarriers do not fit a {n}-point DFT")
    comp = (np.complex64(scale) * phase_compensation(
        cp, numerology, n, slot_in_subframe, center_freq_hz))
    if kind == "demod":
        comp = np.conj(comp)
    comp = (comp.astype(np.complex128) / np.sqrt(np.float64(n))).astype(
        np.complex64)
    off = window_offset if kind == "demod" else 0
    p = _build.OfdmParams(
        rows=math.prod(lead), S=nsym, N=n, K=nof_sc, half=nof_sc // 2,
        T=total, off=off, form=form, ramp=_ramp_offset(n) if off else 0)
    if form:
        offs = _fft_offsets(n)
        p.tw_off[:len(offs)] = offs
    else:
        p.fft = fft_plan(n)
        p.fft.scale = 1.0
        p.smem = 3 * n * 8
    for s in range(nsym):
        if kind == "demod":
            p.start[s] = starts[s] - window_offset
        else:
            p.start[s], p.cp[s] = starts[s] - lens[s], lens[s]
    p.comp[:2 * nsym] = comp.view(np.float32).tolist()
    return p


@functools.lru_cache(maxsize=None)
def _ofdm_prepare(index: int) -> None:
    """Let the Stockham forms take OFDM_MIXED_SMEM of dynamic shared
    memory on CUDA device ``index`` (once, before any capture)."""
    lib = _build.load_locked()
    with torch.cuda.device(index):
        _build.check(lib.srsran_ofdm_demod_prepare(OFDM_MIXED_SMEM),
                     "ofdm_demod_prepare")
        _build.check(lib.srsran_ofdm_mod_prepare(OFDM_MIXED_SMEM),
                     "ofdm_mod_prepare")


@functools.lru_cache(maxsize=64)
def _ofdm_plan(kind: str, shape: tuple, nof_sc: int, n: int, numerology: int,
               cp: CyclicPrefix, slot_in_subframe: int, center_freq_hz: float,
               scale: float, window_offset: int, index: int) -> tuple:
    """K4's or K7's plan on CUDA device ``index``: (its launch, with the
    twiddle table; the output's shape; the launch count it adds to)."""
    params = _ofdm_params(kind, shape, nof_sc, n, numerology, cp,
                          slot_in_subframe, center_freq_hz, scale,
                          window_offset)
    _ofdm_prepare(index)
    table = const(_fft_table, n, params.off,
                  device=torch.device("cuda", index))
    if kind == "demod":
        name, lead = "srsran_ofdm_demodulate", shape[:-1]
        out = lead + (params.S, nof_sc)
        counter = KERNEL_BATCH if len(lead) > 1 else KERNEL
    else:
        name, lead = "srsran_ofdm_modulate", shape[:-2]
        out = lead + (params.T,)
        counter = KERNEL_TX_BATCH if len(lead) > 1 else KERNEL_TX
    return _build.Launch(name, index, params, (table,)), out, counter
