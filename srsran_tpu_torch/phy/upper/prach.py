"""PRACH generation and detection (TS38.211 §6.3.3).

Port of srsran_tpu/phy/upper/prach.py: derive N_cs, the shifts per root and
the roots for the preambles (host side, restricted sets included); multiply
the frequency-domain capture by the conjugate roots, pack the bins into a
power-of-two IDFT, combine the delay power over ports and symbols, and per
preamble compare the power in its cyclic-shift window with the local noise
reference.

:func:`detect` is the K9 wrapper: on CUDA tensors the hand kernels of
csrc/prach_detect.cu around cuFFT's IDFT, all preambles in one launch; on
CPU tensors its twin :func:`detect_ref` (the JAX package's per-preamble
loop, vectorised over the preambles through one host gather plan).  A
capture with a slot axis ([B, P, S, L], the slot-batch mode) runs the
kernels once for its B slots.  The
direct non-power-of-two DFT (``dft_nonpow2``) is off this path and not
ported (ROADMAP §1, the do-not-port list).
"""

from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import torch

from ... import kernels
from ...device import const, f32, is_cuda, stack_slots
from ...kernels import _build
from ...ran.prach_params import (LONG_FORMATS, LONG_SEQ, PRACH_CP_KAPPA,
                                 SHORT_SEQ, n_cs, restricted_cyclic_shifts,
                                 root_sequence_number, zc_sequence)

KERNEL = kernels.register(kernels.Kernel(
    name="prach_detect", route="cuda",
    source="srsran_tpu_torch/csrc/prach_detect.cu",
    replaces="srsran_tpu/phy/upper/prach.py:177"))
KERNEL_BATCH = kernels.batched(KERNEL)

_THRESHOLDS = (Path(__file__).resolve().parents[2] / "data"
               / "prach_thresholds.json")


@dataclasses.dataclass(frozen=True)
class PrachConfig:
    """Static PRACH occasion description (same fields and defaults as the
    JAX package's PrachConfig)."""

    format: str                  # '0'..'3', 'A1'.. 'C2'
    root_sequence_index: int     # logical index
    zero_correlation_zone: int
    nof_preambles: int = 64
    start_preamble: int = 0
    ra_scs_hz: int = 0           # short formats: 15000 << mu; long: from table
    restricted: str = "unrestricted"   # or 'type_a' | 'type_b'

    @property
    def is_long(self) -> bool:
        return self.format in LONG_FORMATS

    @property
    def l_ra(self) -> int:
        return LONG_SEQ if self.is_long else SHORT_SEQ

    @property
    def scs_hz(self) -> int:
        if self.is_long:
            return LONG_FORMATS[self.format][1]
        return self.ra_scs_hz or 15_000


@functools.lru_cache(maxsize=None)
def _root_set(cfg: PrachConfig):
    """(roots [R], preamble_map, ncs): preamble_map[p] = (root_idx, C_v).

    Unrestricted roots carry floor(L/N_cs) evenly spaced shifts; restricted
    roots carry the d_u-dependent C_v enumeration (TS38.211 §6.3.3.1), so
    the walk continues across logical root indices until start_preamble +
    nof_preambles are assigned.
    """
    ncs = n_cs(cfg.zero_correlation_zone, cfg.scs_hz, cfg.restricted)
    roots: list = []
    pmap: list = []
    logical = cfg.root_sequence_index
    need = cfg.start_preamble + cfg.nof_preambles
    while len(pmap) < need:
        u = root_sequence_number(logical, cfg.is_long)
        shifts = restricted_cyclic_shifts(u, ncs, cfg.l_ra, cfg.restricted)
        if shifts:
            roots.append(u)
            ridx = len(roots) - 1
            pmap.extend((ridx, cs) for cs in shifts)
        logical += 1
        if logical - cfg.root_sequence_index >= 2 * cfg.l_ra:
            raise ValueError(
                "no restricted preambles available for this configuration")
    return tuple(roots), tuple(pmap[:need]), ncs


@functools.lru_cache(maxsize=None)
def _root_fd(cfg: PrachConfig) -> np.ndarray:
    """Frequency-domain root sequences [R, L] (unit-power bins)."""
    roots, _, _ = _root_set(cfg)
    tds = np.stack([zc_sequence(u, cfg.l_ra) for u in roots])
    fd = np.fft.fft(tds, axis=-1) / np.sqrt(cfg.l_ra)
    return fd.astype(np.complex64)


def generate_np(cfg: PrachConfig, preamble: int) -> np.ndarray:
    """Frequency-domain preamble [L] (UE side / tests), numpy."""
    roots, pmap, _ = _root_set(cfg)
    root_idx, cs = pmap[cfg.start_preamble + preamble]
    td = zc_sequence(roots[root_idx], cfg.l_ra, cs)
    fd = np.fft.fft(td) / np.sqrt(cfg.l_ra)
    return fd.astype(np.complex64)


def generate(cfg: PrachConfig, preamble: int, *,
             device: torch.device | str) -> torch.Tensor:
    """Frequency-domain preamble complex64 [L] on ``device`` (UE side /
    tests): computed on the host and uploaded, as the JAX package does."""
    return torch.from_numpy(generate_np(cfg, preamble)).to(device)


def cp_seq_samples(cfg: PrachConfig) -> float:
    """PRACH cyclic-prefix length in sequence-sample units (L_ra-rate).

    Long formats: N_CP * kappa*Tc seconds * (L_ra * ra_scs) samples/s.
    Short formats: the table's 2^-mu scaling cancels the 2^mu in the RA
    SCS, leaving N_CP * L_ra / 2048 for any numerology.
    """
    ncp = PRACH_CP_KAPPA[cfg.format]
    if cfg.is_long:
        return ncp / 30_720_000 * cfg.l_ra * cfg.scs_hz
    return ncp * cfg.l_ra / 2048.0


@dataclasses.dataclass
class PrachDetection:
    metrics: torch.Tensor         # f32 [nof_preambles] detection metric
    time_advance_s: torch.Tensor  # f32 [nof_preambles]
    detected: torch.Tensor        # bool [nof_preambles]
    rssi: torch.Tensor            # f32 scalar


@functools.lru_cache(maxsize=None)
def _threshold_table() -> dict:
    if _THRESHOLDS.exists():
        return json.loads(_THRESHOLDS.read_text())
    return {}


def calibrated_threshold(cfg: PrachConfig, nof_ports: int,
                         default: float = 2.0) -> float:
    """Measured noise-floor threshold keyed (format, zcz, ports), from the
    port's copy of the JAX package's data/prach_thresholds.json."""
    tab = _threshold_table()
    key = f"{cfg.format}:{cfg.zero_correlation_zone}:{nof_ports}"
    if key in tab:
        return tab[key]
    # fall back to the nearest port count for this (format, zcz)
    for p in (4, 2, 1):
        k = f"{cfg.format}:{cfg.zero_correlation_zone}:{p}"
        if k in tab:
            return tab[k]
    return default


@functools.lru_cache(maxsize=None)
def _window(cfg: PrachConfig, idft_size: int) -> tuple:
    """(win, margin, search): the delay search window, bounded by the PRACH
    cyclic prefix (prach_detector_generic_impl.cpp:135-160), its noise
    reference margin and the searched bins."""
    _, _, ncs = _root_set(cfg)
    cp_bins = max(1, int(cp_seq_samples(cfg) * idft_size / cfg.l_ra))
    ncs_bins = max(1, (ncs * idft_size) // cfg.l_ra) if ncs else idft_size
    win = min(ncs_bins if ncs else idft_size, cp_bins, idft_size)
    margin = (min(max(4, win // 4), idft_size - win)
              if win < idft_size else 0)
    return win, margin, max(1, int(win * 0.8))


@functools.lru_cache(maxsize=None)
def _geometry(cfg: PrachConfig, idft_size: int) -> np.ndarray:
    """int32 [nof_preambles, 2]: (root index, window start bin) of every
    preamble; the peak of cyclic shift C_v sits at delay bin
    N - C_v * N / L (mod N)."""
    _, pmap, _ = _root_set(cfg)
    rows = []
    for p in range(cfg.nof_preambles):
        root_idx, cs = pmap[cfg.start_preamble + p]
        rows.append((root_idx,
                     (idft_size - (cs * idft_size) // cfg.l_ra) % idft_size))
    return np.asarray(rows, np.int32)


def _region_index(cfg: PrachConfig, idft_size: int) -> np.ndarray:
    """int64 [nof_preambles, win + 2 margin]: each preamble's region of the
    circular delay power, from window start - margin."""
    win, margin, _ = _window(cfg, idft_size)
    start = _geometry(cfg, idft_size)[:, 1].astype(np.int64)
    j = np.arange(win + 2 * margin)
    return (start[:, None] - margin + j[None]) % idft_size


def _root_index(cfg: PrachConfig, idft_size: int) -> np.ndarray:
    return _geometry(cfg, idft_size)[:, 0].astype(np.int64)


def _pack(prod: torch.Tensor, l_ra: int, idft_size: int) -> torch.Tensor:
    """Pack the L bins into the IDFT input, split halves like the reference
    (low half first, high half at the top)."""
    half = (l_ra + 1) // 2
    zeros = prod.new_zeros(prod.shape[:-1] + (idft_size - l_ra,))
    return torch.cat([prod[..., :half], zeros, prod[..., half:]], dim=-1)


def detect_ref(rx_fd: torch.Tensor, cfg: PrachConfig,
               threshold: float | None = None,
               idft_size: int = 1024) -> PrachDetection:
    """Plain twin of :func:`detect` (a slot axis runs slot by slot)."""
    if threshold is None:
        threshold = calibrated_threshold(cfg, rx_fd.shape[-3])
    if rx_fd.ndim == 4:
        return stack_slots([detect_ref(x, cfg, threshold, idft_size)
                            for x in rx_fd])
    dev = rx_fd.device
    rssi = torch.mean(rx_fd.abs() ** 2)
    root_fd = const(_root_fd, cfg, device=dev)                # [R, L]
    prod = rx_fd[:, :, None, :] * root_fd.conj()[None, None]  # [P, S, R, L]
    buf = _pack(prod, cfg.l_ra, idft_size)
    delay = torch.fft.ifft(buf, dim=-1) * np.sqrt(idft_size)
    power = torch.sum(delay.abs() ** 2, dim=(0, 1))           # [R, N]
    win, margin, search = _window(cfg, idft_size)
    key = (cfg, idft_size)
    region = power[const(_root_index, *key, device=dev)[:, None],
                   const(_region_index, *key, device=dev)]    # [pre, W+2M]
    ref = torch.sum(region, dim=-1)
    seg = region[:, margin:margin + win]
    den = torch.clamp_min(ref[:, None] - seg, 1e-12)
    metric_bins = (seg / den)[:, :search]
    peak = torch.argmax(metric_bins, dim=1)
    metrics = metric_bins.gather(1, peak[:, None])[:, 0] * win
    span = const(f32, (float(idft_size * cfg.scs_hz),), device=dev)[0]
    return PrachDetection(
        metrics=metrics.to(torch.float32),
        time_advance_s=peak.to(torch.float32) / span,
        detected=metrics > threshold, rssi=rssi.to(torch.float32))


def detect(rx_fd: torch.Tensor, cfg: PrachConfig,
           threshold: float | None = None,
           idft_size: int = 1024) -> PrachDetection:
    """Detect preambles.

    rx_fd: complex64 [ports, symbols, L] frequency-domain preamble captures
    (or [B, ports, symbols, L]: B slots' captures, every field of the
    result with a leading slot axis, the kernels launched once).
    threshold: metric threshold; None uses the calibrated table keyed by
    (format, zcz, rx ports).
    """
    if threshold is None:
        threshold = calibrated_threshold(cfg, rx_fd.shape[-3])
    if not is_cuda(rx_fd):
        return detect_ref(rx_fd, cfg, threshold, idft_size)
    if (rx_fd.dtype != torch.complex64 or rx_fd.ndim not in (3, 4)
            or rx_fd.shape[-1] != cfg.l_ra):
        raise ValueError(f"rx_fd must be complex64 [(B,) P, S, {cfg.l_ra}], "
                         f"got {rx_fd.dtype} {tuple(rx_fd.shape)}")
    if idft_size < cfg.l_ra:
        raise ValueError(f"a {idft_size}-point IDFT cannot hold {cfg.l_ra} "
                         "bins")
    dev = rx_fd.device
    lead = tuple(rx_fd.shape[:-3])
    slots = lead[0] if lead else 1
    n_p, n_s, l_ra = rx_fd.shape[-3:]
    roots = const(_root_fd, cfg, device=dev)
    geom = const(_geometry, cfg, idft_size, device=dev)
    n_r = roots.shape[0]
    win, margin, search = _window(cfg, idft_size)
    rx = rx_fd.contiguous()
    buf = torch.empty(lead + (n_p, n_s, n_r, idft_size),
                      dtype=torch.complex64, device=dev)
    lib = _build.load()
    stream = _build.stream_of(rx)
    _build.check(lib.srsran_prach_corr(
        _build.ptr(rx), _build.ptr(roots), slots * n_p * n_s, n_r, l_ra,
        idft_size, _build.ptr(buf), stream), "prach_corr")
    delay = torch.fft.ifft(buf, dim=-1)
    npre = cfg.nof_preambles
    power = torch.empty(lead + (n_r, idft_size), dtype=torch.float32,
                        device=dev)
    metrics = torch.empty(lead + (npre,), dtype=torch.float32, device=dev)
    ta = torch.empty(lead + (npre,), dtype=torch.float32, device=dev)
    detected = torch.empty(lead + (npre,), dtype=torch.bool, device=dev)
    rssi = torch.empty(lead, dtype=torch.float32, device=dev)
    _build.check(lib.srsran_prach_detect(
        _build.ptr(delay), n_p * n_s, n_r, idft_size,
        float(np.sqrt(idft_size)), _build.ptr(power), _build.ptr(geom), npre,
        win, margin, search, float(threshold),
        float(idft_size * cfg.scs_hz), _build.ptr(rx), n_p * n_s * l_ra,
        _build.ptr(metrics), _build.ptr(ta), _build.ptr(detected),
        _build.ptr(rssi), slots, stream), "prach_detect")
    (KERNEL_BATCH if lead else KERNEL).count()
    return PrachDetection(metrics=metrics, time_advance_s=ta,
                          detected=detected, rssi=rssi)
