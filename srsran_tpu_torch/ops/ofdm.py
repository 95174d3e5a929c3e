"""OFDM modulation / demodulation (TS38.211 §5.3).

Port of srsran_tpu/ops/ofdm.py with its exact semantics: half-spectrum
swap between grid and DFT bins, per-symbol phase compensation
e^{-j 2 pi f_c t_l} (conjugated on RX), the optional RX FFT-window offset
into the CP with its per-bin phase ramp, and unitary (norm="ortho") FFTs.

:func:`demodulate_slot` is the K4 wrapper: on CUDA tensors the window
gather before the FFT and the ramp/compensation/swap pass after it are the
hand kernels of csrc/ofdm_demod.cu, with cuFFT (torch.fft) between them; on
CPU tensors it runs :func:`demodulate_slot_ref`, the plain twin.  It
replaces the passes around the FFT of srsran_tpu/ops/ofdm.py::
demodulate_slot.  :func:`modulate_slot` is the K7 wrapper in the same way:
csrc/ofdm_mod.cu's grid-to-bins pass, cuFFT's IFFT, then its compensation
and CP-insertion pass; twin :func:`modulate_slot_ref`.  On the card all
these passes are memory-bound gathers (about 2 MB each at the flagship),
and the kernel designs are in the .cu files.  A leading slot axis ([B, P,
...], the slot-batch mode) goes through the same passes as B x P rows, with
one cuFFT plan per batch shape.
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


def _check_tx(grid, cp) -> int:
    nsym = symbols_per_slot(cp)
    if grid.shape[-2] != nsym:
        raise ValueError(f"grid {tuple(grid.shape)} has no {nsym} symbols")
    return nsym


def modulate_slot_ref(grid: torch.Tensor, dft_size: int, numerology: int,
                      cp: CyclicPrefix = CyclicPrefix.NORMAL,
                      slot_in_subframe: int = 0, center_freq_hz: float = 0.0,
                      scale: float = 1.0) -> torch.Tensor:
    """Plain twin of :func:`modulate_slot` (any leading dims)."""
    nsym = _check_tx(grid, cp)
    bins = _grid_to_bins(grid.to(torch.complex64), dft_size)
    x = torch.fft.ifft(bins, dim=-1, norm="ortho")
    comp = const(phase_compensation, cp, numerology, dft_size,
                 slot_in_subframe, float(center_freq_hz), device=grid.device)
    x = x * (scale * comp)[..., :, None]
    plan = const(_cp_insert_plan, cp, numerology, dft_size, slot_in_subframe,
                 device=grid.device, dtype=torch.long)
    out = x.reshape(x.shape[:-2] + (nsym * dft_size,))[..., plan]
    return out.to(torch.complex64)


def _tx_table(i: int, cp, numerology, dft_size, slot_in_subframe,
              center_freq_hz, scale) -> np.ndarray:
    """Host tables of the TX passes: 0, the CP plan (int32 [T]); 1, the
    per-symbol compensation times the scale (complex64 [S])."""
    if i == 0:
        return _cp_insert_plan(cp, numerology, dft_size, slot_in_subframe)
    comp = phase_compensation(cp, numerology, dft_size, slot_in_subframe,
                              center_freq_hz)
    return (np.complex64(scale) * comp).astype(np.complex64)


def modulate_slot(grid: torch.Tensor, dft_size: int, numerology: int,
                  cp: CyclicPrefix = CyclicPrefix.NORMAL,
                  slot_in_subframe: int = 0, center_freq_hz: float = 0.0,
                  scale: float = 1.0) -> torch.Tensor:
    """OFDM-modulate one slot.  grid complex64 [P, S, K] -> samples [P, T];
    with a slot axis, [B, P, S, K] -> [B, P, T] (the twin also takes other
    leading dims)."""
    if not is_cuda(grid):
        return modulate_slot_ref(grid, dft_size, numerology, cp,
                                 slot_in_subframe, center_freq_hz, scale)
    nsym = _check_tx(grid, cp)
    if grid.dtype != torch.complex64 or grid.ndim not in (3, 4):
        raise ValueError(f"grid must be complex64 [(B,) P, S, K], got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    lead = tuple(grid.shape[:-2])
    p, k = math.prod(lead), grid.shape[-1]
    if k > dft_size:
        raise ValueError(f"{k} subcarriers do not fit a {dft_size}-point DFT")
    dev = grid.device
    lib = _build.load()
    key = (cp, numerology, dft_size, slot_in_subframe, float(center_freq_hz),
           float(scale))
    plan = const(_tx_table, 0, *key, device=dev)
    comp = const(_tx_table, 1, *key, device=dev)
    total = plan.shape[0]
    stream = _build.stream_of(grid)
    bins = torch.empty((p, nsym, dft_size), dtype=torch.complex64, device=dev)
    _build.check(lib.srsran_ofdm_grid_to_bins(
        _build.ptr(torch.view_as_real(grid.contiguous())), _build.ptr(bins),
        p, nsym, k, dft_size, stream), "ofdm_grid_to_bins")
    x = torch.fft.ifft(bins, dim=-1, norm="ortho")
    out = torch.empty((p, total), dtype=torch.complex64, device=dev)
    _build.check(lib.srsran_ofdm_cp_insert(
        _build.ptr(x), _build.ptr(out), _build.ptr(plan), _build.ptr(comp),
        p, nsym, dft_size, total, stream), "ofdm_cp_insert")
    (KERNEL_TX_BATCH if len(lead) > 1 else KERNEL_TX).count()
    return out.reshape(lead + (total,))


@functools.lru_cache(maxsize=None)
def _rx_tables(cp, numerology, dft_size, slot_in_subframe, center_freq_hz,
               scale, window_offset):
    """Host tables of the RX passes: (window starts [S] int32, conj(comp) *
    scale [S] complex64, per-bin ramp [N] complex64 or None)."""
    _, starts, _ = _symbol_layout(cp, numerology, dft_size, slot_in_subframe)
    comp = np.conj(phase_compensation(cp, numerology, dft_size,
                                      slot_in_subframe, center_freq_hz))
    rot = None
    if window_offset:
        kbin = np.arange(dft_size)
        kbin = np.where(kbin < dft_size // 2, kbin, kbin - dft_size)
        rot = np.exp(1j * 2 * np.pi * window_offset * kbin / dft_size
                     ).astype(np.complex64)
    return (np.asarray(starts, np.int32) - window_offset,
            (np.complex64(scale) * comp).astype(np.complex64), rot)


def _rx_table(i: int, *key) -> np.ndarray:
    """One of the :func:`_rx_tables` (0: starts, 1: compensation, 2: ramp)."""
    return _rx_tables(*key)[i]


def _check_rx(samples, cp, numerology, dft_size, slot_in_subframe,
              window_offset):
    _, _, total = _symbol_layout(cp, numerology, dft_size, slot_in_subframe)
    if samples.shape[-1] != total:
        raise ValueError(f"samples {tuple(samples.shape)}: slot has {total}")
    max_off = (144 * dft_size // 2048) // 2
    if not 0 <= window_offset <= max_off:
        raise ValueError(f"window_offset {window_offset} outside [0, {max_off}]")


def demodulate_slot_ref(samples: torch.Tensor, nof_sc: int, dft_size: int,
                        numerology: int, cp: CyclicPrefix = CyclicPrefix.NORMAL,
                        slot_in_subframe: int = 0, center_freq_hz: float = 0.0,
                        scale: float = 1.0, window_offset: int = 0) -> torch.Tensor:
    """Plain twin of :func:`demodulate_slot`."""
    _check_rx(samples, cp, numerology, dft_size, slot_in_subframe, window_offset)
    dev = samples.device
    plan = const(_window_plan_rx, cp, numerology, dft_size, slot_in_subframe,
                 window_offset, device=dev, dtype=torch.long)
    x = samples[..., plan]                                  # [..., S, N]
    bins = torch.fft.fft(x, dim=-1, norm="ortho")
    key = (cp, numerology, dft_size, slot_in_subframe, float(center_freq_hz),
           float(scale), int(window_offset))
    if window_offset:
        bins = bins * const(_rx_table, 2, *key, device=dev)
    bins = bins * const(_rx_table, 1, *key, device=dev)[..., :, None]
    return _bins_to_grid(bins, nof_sc).to(torch.complex64)


def demodulate_slot(samples: torch.Tensor, nof_sc: int, dft_size: int,
                    numerology: int, cp: CyclicPrefix = CyclicPrefix.NORMAL,
                    slot_in_subframe: int = 0, center_freq_hz: float = 0.0,
                    scale: float = 1.0, window_offset: int = 0) -> torch.Tensor:
    """OFDM-demodulate one slot.  samples complex64 [P, T] -> grid [P, S, K];
    with a slot axis, [B, P, T] -> [B, P, S, K]."""
    if not is_cuda(samples):
        return demodulate_slot_ref(samples, nof_sc, dft_size, numerology, cp,
                                   slot_in_subframe, center_freq_hz, scale,
                                   window_offset)
    _check_rx(samples, cp, numerology, dft_size, slot_in_subframe, window_offset)
    if samples.dtype != torch.complex64 or samples.ndim not in (2, 3):
        raise ValueError(f"samples must be complex64 [(B,) P, T], got "
                         f"{samples.dtype} {tuple(samples.shape)}")
    dev = samples.device
    lib = _build.load()
    key = (cp, numerology, dft_size, slot_in_subframe, float(center_freq_hz),
           float(scale), int(window_offset))
    starts = const(_rx_table, 0, *key, device=dev)
    comp = const(_rx_table, 1, *key, device=dev)
    rot = const(_rx_table, 2, *key, device=dev) if window_offset else None
    lead = tuple(samples.shape[:-1])
    p, t = math.prod(lead), samples.shape[-1]
    s = starts.shape[0]
    src = torch.view_as_real(samples.contiguous())
    win = torch.empty((p, s, dft_size), dtype=torch.complex64, device=dev)
    stream = _build.stream_of(samples)
    _build.check(lib.srsran_ofdm_window(
        _build.ptr(src), _build.ptr(win), _build.ptr(starts), p, t, s,
        dft_size, stream), "ofdm_window")
    bins = torch.fft.fft(win, dim=-1, norm="ortho")
    grid = torch.empty((p, s, nof_sc), dtype=torch.complex64, device=dev)
    _build.check(lib.srsran_ofdm_bins_to_grid(
        _build.ptr(bins), _build.ptr(grid), _build.ptr(comp),
        _build.ptr(rot) if rot is not None else None, p, s, dft_size, nof_sc,
        stream), "ofdm_bins_to_grid")
    (KERNEL_BATCH if len(lead) > 1 else KERNEL).count()
    return grid.reshape(lead + (s, nof_sc))
