"""PRACH generation and detection (TS38.211 §6.3.3).

Port of srsran_tpu/phy/upper/prach.py: derive N_cs, the shifts per root and
the roots for the preambles (host side, restricted sets included); multiply
the frequency-domain capture by the conjugate roots, pack the bins into a
power-of-two IDFT, combine the delay power over ports and symbols, and per
preamble compare the power in its cyclic-shift window with the local noise
reference.

:func:`detect` is the K9 wrapper: on CUDA tensors one launch of the hand
kernel of csrc/prach_detect.cu (a thread-block cluster per slot and root
that correlates, transforms by its own N = V x 32 split in shared memory
and registers -- no cuFFT, no IDFT buffer in device memory -- sums the
power and detects every preamble) through ``kernels/_build.py::Launch``:
one plan per call signature (:func:`_detect_plan`; its parameters,
testable on the CPU, from :func:`_detect_params`, its tables from
:func:`_detect_tables`), so a call allocates one output and makes one
ctypes call.  On CPU tensors its twin :func:`detect_ref` (the JAX
package's per-preamble loop, vectorised over the preambles through one
host gather plan).  A capture with a slot axis ([B, P, S, L], the
slot-batch mode) runs the kernel once for its B slots.  The kernel takes
an IDFT of 256 to 4096 points, a power of two (every caller passes 1024).
The direct non-power-of-two DFT (``dft_nonpow2``) is off this path and not
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
from ...device import const, f32, stack_slots
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


@functools.lru_cache(maxsize=256)
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




# ----------------------------------------------------- K9: the launch plan

PRACH_WARPS = 8            # csrc/prach_detect.cu kPrachThreads / 32
PRACH_MAX_CTAS = 8         # kPrachMaxCtas
PRACH_PAD = 33             # kPad
PRACH_ROOT_PREAMBLES = 64  # kPrachMaxRootPreambles
PRACH_MAX_ROWS = 128       # kPrachMaxRows: ports x symbols
IDFT_SIZES = (256, 512, 1024, 2048, 4096)


def _idft_rows(l_ra: int, idft_size: int) -> np.ndarray:
    """int32: the rows n1 of the kernel's split (input n = 32 n1 + t) that
    hold a packed bin, in order -- the low half [0, (L + 1) / 2) and the
    high half [N - L / 2, N); 6 of 32 at L 139, N 1024."""
    half = (l_ra + 1) // 2
    high = idft_size - (l_ra - half)
    return np.asarray([n1 for n1 in range(idft_size // 32)
                       if 32 * n1 < half or 32 * n1 + 31 >= high], np.int32)


@functools.lru_cache(maxsize=None)
def _idft_tables(idft_size: int) -> tuple:
    """The kernel's transform tables for N = V x 32, built in float64 and
    rounded once: tw complex64 [V, 32] = e^{2 pi i t k1 / N} (the twiddle
    of output k1 at lane t), wv complex64 [V] = e^{2 pi i m / V} (the
    column DFT), w32 complex64 [16] = e^{2 pi i m / 32} (the 32-point
    stage), rev int32 [32]: register m of a lane holds output k2 =
    rev[m] (five bits reversed)."""
    v = idft_size // 32
    k1, t = np.arange(v)[:, None], np.arange(32)[None]
    tw = np.exp(2j * np.pi * ((k1 * t) % idft_size) / idft_size)
    wv = np.exp(2j * np.pi * np.arange(v) / v)
    w32 = np.exp(2j * np.pi * np.arange(16) / 32)
    rev = np.asarray([int(f"{m:05b}"[::-1], 2) for m in range(32)], np.int32)
    return (tw.astype(np.complex64), wv.astype(np.complex64),
            w32.astype(np.complex64), rev)


def _detect_roots(cfg: PrachConfig, idft_size: int) -> np.ndarray:
    """int32 [roots, 3]: each root that carries one of the configured
    preambles (the kernel's grid), its first preamble and their count
    (the preambles of a root are consecutive)."""
    geom = _geometry(cfg, idft_size)
    rows = []
    for p, root in enumerate(geom[:, 0].tolist()):
        if rows and rows[-1][0] == root:
            rows[-1][2] += 1
        else:
            if any(r[0] == root for r in rows):
                raise ValueError(f"root {root}'s preambles are not "
                                 "consecutive")
            rows.append([root, p, 1])
    return np.asarray(rows, np.int32)


def _detect_cluster(rows: int, idft_size: int, clusters: int,
                    sms: int) -> int:
    """CTAs a (slot, root): a power of two (clusters of 1, 2, 4 or 8 pack
    into the GPCs' SMs), enough for a warp a row, at most 8 (4 at N =
    4096, for the leader's [C, N] powers), halved while the launch's
    ``clusters`` clusters would not fit ``sms`` SMs in one wave (one CTA an
    SM)."""
    need = -(-rows // PRACH_WARPS)
    c = 1
    while c < need:
        c *= 2
    c = min(c, PRACH_MAX_CTAS if idft_size <= 2048 else 4)
    while c > 1 and clusters * c > sms:
        c //= 2
    return c


def _detect_smem(idft_size: int, l_ra: int, nz: int, ctas: int) -> int:
    """K9's dynamic shared memory a CTA, bytes (csrc Smem): tw [N], wv [V],
    w32 [16], the root [L] and the warps' buffers [8, 32, 33] (complex);
    the cluster's powers [C, N] and the rows' energies [128] (float); the
    root's window starts [64], the rows [nz] and rev5 [32] (int)."""
    return (8 * (idft_size + idft_size // 32 + 16 + l_ra
                 + PRACH_WARPS * 32 * PRACH_PAD)
            + 4 * (ctas * idft_size + PRACH_MAX_ROWS)
            + 4 * (PRACH_ROOT_PREAMBLES + nz + 32))


# the most K9 takes: N = 4096 (4 CTAs) or 2048 (8), L_RA 839
PRACH_SMEM = max(_detect_smem(4096, 839, 32, 4),
                 _detect_smem(2048, 839, 32, 8))


def _live_rows(l_ra: int, idft_size: int) -> int:
    """The mask of :func:`_idft_rows` (bit n1) where the kernel transforms
    a column in registers (N <= 1024), else 0; the kernel has a form
    pruned at compile time to L_RA 139's rows at N = 1024 (0xE0000007),
    and takes every other mask by its unpruned form."""
    if idft_size > 1024:
        return 0
    return sum(1 << int(n1) for n1 in _idft_rows(l_ra, idft_size))


def _detect_params(cfg: PrachConfig, shape: tuple, idft_size: int,
                   threshold: float,
                   sms: int = 132) -> _build.PrachDetectParams:
    """K9's parameters for one call signature (the capture's shape) on a
    card of ``sms`` SMs; raises on what the kernel does not take."""
    if idft_size not in IDFT_SIZES or idft_size < cfg.l_ra:
        raise ValueError(f"K9 takes an IDFT of {IDFT_SIZES[0]} to "
                         f"{IDFT_SIZES[-1]} points, a power of two that "
                         f"holds L_RA = {cfg.l_ra}; got {idft_size}")
    if len(shape) not in (3, 4) or shape[-1] != cfg.l_ra or 0 in shape:
        raise ValueError(f"rx_fd must be complex64 [(B,) P, S, {cfg.l_ra}], "
                         f"got {tuple(shape)}")
    n_p, n_s, l_ra = shape[-3:]
    if not 1 <= cfg.nof_preambles <= PRACH_ROOT_PREAMBLES:
        raise ValueError(f"K9 takes 1 to {PRACH_ROOT_PREAMBLES} preambles")
    rows = n_p * n_s
    if rows > PRACH_MAX_ROWS:
        raise ValueError(f"K9 takes up to {PRACH_MAX_ROWS} ports x symbols, "
                         f"got {rows}")
    win, margin, search = _window(cfg, idft_size)
    nz = len(_idft_rows(l_ra, idft_size))
    slots = shape[0] if len(shape) == 4 else 1
    roots = len(_detect_roots(cfg, idft_size))
    ctas = _detect_cluster(rows, idft_size, slots * roots, sms)
    p = _build.PrachDetectParams(
        B=slots, rows=rows, L=l_ra, half=(l_ra + 1) // 2, N=idft_size,
        V=idft_size // 32, roots=roots, npre=cfg.nof_preambles, nz=nz,
        live=np.int32(np.uint32(_live_rows(l_ra, idft_size))).item(),
        C=ctas, win=win, margin=margin, search=search, nrx=rows * l_ra,
        smem=_detect_smem(idft_size, l_ra, nz, ctas),
        threshold=float(np.float32(threshold)),
        span=float(np.float32(idft_size * cfg.scs_hz)),
        inv_n=1.0 / idft_size)
    n_r = len(_root_set(cfg)[0])
    p.off_tw = n_r * l_ra
    p.off_wv = p.off_tw + idft_size
    p.off_w32 = p.off_wv + idft_size // 32
    p.off_geom = nz + 32
    p.off_range = p.off_geom + 2 * cfg.nof_preambles
    return p


def _detect_tables(cfg: PrachConfig, idft_size: int) -> tuple:
    """K9's tables (numpy; the order of :func:`_detect_params`' offsets):
    complex64 [roots [R, L], tw, wv, w32] and int32 [rows, rev5, geometry
    [npre, 2], launched roots [roots, 3]]."""
    tw, wv, w32, rev = _idft_tables(idft_size)
    cplx = np.concatenate([_root_fd(cfg).reshape(-1), tw.reshape(-1), wv,
                           w32])
    ints = np.concatenate([_idft_rows(cfg.l_ra, idft_size), rev,
                           _geometry(cfg, idft_size).reshape(-1),
                           _detect_roots(cfg, idft_size).reshape(-1)])
    return cplx, ints.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _detect_prepare(index: int) -> None:
    """Let K9 take PRACH_SMEM of dynamic shared memory on CUDA device
    ``index`` (once, before any capture)."""
    with torch.cuda.device(index):
        _build.check(_build.load_locked().srsran_prach_prepare(PRACH_SMEM),
                     "prach_prepare")


@functools.lru_cache(maxsize=64)
def _detect_plan(cfg: PrachConfig, shape: tuple, idft_size: int,
                 threshold: float, index: int) -> tuple:
    """K9's plan on CUDA device ``index``: (its launch, with the tables;
    the floats of the call's output (metrics, TA, RSSI); the
    ``as_strided`` forms of its views; the decisions' shape; the launch
    count it adds to)."""
    params = _detect_params(
        cfg, shape, idft_size, threshold,
        torch.cuda.get_device_properties(index).multi_processor_count)
    _detect_prepare(index)
    dev = torch.device("cuda", index)
    tables = tuple(torch.from_numpy(t).to(dev)
                   for t in _detect_tables(cfg, idft_size))
    lead = tuple(shape[:-3])
    m = params.B * params.npre
    per = lead + (params.npre,)
    strides = (params.npre, 1) if lead else (1,)
    views = ((per, strides, 0), (per, strides, m),
             (lead, (1,) if lead else (), 2 * m))
    return (_build.Launch("srsran_prach_detect", index, params, tables),
            2 * m + params.B, views, per, KERNEL_BATCH if lead else KERNEL)


def detect(rx_fd: torch.Tensor, cfg: PrachConfig,
           threshold: float | None = None,
           idft_size: int = 1024) -> PrachDetection:
    """Detect preambles.

    rx_fd: complex64 [ports, symbols, L] frequency-domain preamble captures
    (or [B, ports, symbols, L]: B slots' captures, every field of the
    result with a leading slot axis, the kernel launched once).
    threshold: metric threshold; None uses the calibrated table keyed by
    (format, zcz, rx ports).  On CUDA one launch of K9 through the plan of
    the call's signature; ``idft_size`` a power of two from 256 to 4096.
    """
    if threshold is None:
        threshold = calibrated_threshold(cfg, rx_fd.shape[-3])
    if not rx_fd.is_cuda:
        return detect_ref(rx_fd, cfg, threshold, idft_size)
    if rx_fd.dtype != torch.complex64:
        raise ValueError(f"rx_fd must be complex64, got {rx_fd.dtype}")
    launch, n_out, views, shape, counter = _detect_plan(
        cfg, tuple(rx_fd.shape), int(idft_size), float(threshold),
        rx_fd.get_device())
    rx = rx_fd if rx_fd.is_contiguous() else rx_fd.contiguous()
    out = rx.new_empty(n_out, dtype=torch.float32)
    detected = rx.new_empty(shape, dtype=torch.bool)
    launch(rx.data_ptr(), out.data_ptr(), detected.data_ptr())
    counter.count()
    mv, tv, rv = views
    return PrachDetection(metrics=out.as_strided(*mv),
                          time_advance_s=out.as_strided(*tv),
                          detected=detected, rssi=out.as_strided(*rv))
