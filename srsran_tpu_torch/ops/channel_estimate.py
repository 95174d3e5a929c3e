"""DM-RS port channel estimation (LS + despread + CFO + smoothing +
interpolation + noise + TA).

Port of srsran_tpu/ops/channel_estimate.py::estimate and _time_alignment.
:func:`estimate` is the plain PyTorch version on gathered pilots; it applies
the smoothing-and-interpolation operator as the host matrix of
:func:`_smooth_interp_matrix`, cast to complex64 once and cached per device.

:func:`estimate_from_grid` is the K8 wrapper: on CUDA tensors it reads the
pilots straight from the resource grid in the hand kernels of
csrc/channel_estimate.cu, which apply the same operator in band form
(:func:`_band`: first column + [nsc, W] weights, W = 8 at the flagship)
and compute RSRP, EPRE, noise, CFO and TA on the device; on CPU tensors it
runs :func:`estimate_from_grid_ref`, the twin (gather, then
:func:`estimate`).  A leading slot axis on the grid (and on the pilots,
which are slot context) runs every pass once for all slots; the band and
the tables are shared, and each result gains the slot axis in front.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import kernels
from ..device import const, f32, i64, is_cuda
from ..kernels import _build

KERNEL = kernels.register(kernels.Kernel(
    name="channel_estimate", route="cuda",
    source="srsran_tpu_torch/csrc/channel_estimate.cu",
    replaces="srsran_tpu/ops/channel_estimate.py:180"))
KERNEL_BATCH = kernels.batched(KERNEL)


@dataclasses.dataclass
class ChannelEstimate:
    """Per-(rx_port, layer) results over one allocation."""

    # complex64 [P, L, S, nsc]: S == nof_symbols for the 'interpolate'
    # time strategy, S == 1 for 'average' (time-constant).
    coeffs: torch.Tensor
    noise_var: torch.Tensor        # f32 [P]
    rsrp: torch.Tensor             # f32 [P]
    epre: torch.Tensor             # f32 [P]
    snr: torch.Tensor              # f32 [P]
    time_alignment_s: torch.Tensor  # f32 scalar
    cfo_hz: torch.Tensor           # f32 scalar (0 if not estimated)


@functools.lru_cache(maxsize=None)
def _rc_filter(rolloff: float = 0.2, stride: int = 2,
               nof_rb: int = 3) -> np.ndarray:
    """Raised-cosine smoothing FIR, downsampled by the pilot stride."""
    span_rb = min(nof_rb, 3)
    nof_full = span_rb * 10 + 1
    half = nof_full // 2 // stride
    k = np.arange(-half, half + 1) * stride / 10.0
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.sinc(k) * np.cos(np.pi * rolloff * k) / (1 - (2 * rolloff * k) ** 2)
    h[~np.isfinite(h)] = np.pi / 4 * np.sinc(1 / (2 * rolloff)) if rolloff else 0.0
    h = np.nan_to_num(h)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _smooth_interp_matrix(pilot_scs_key: tuple, nof_sc: int, strategy: str,
                          stride: int) -> np.ndarray:
    """Host [nof_sc, K_p] operator = (linear interpolation to the full
    lattice) ∘ (frequency smoothing with linear edge extrapolation)."""
    x = np.asarray(pilot_scs_key, dtype=np.float32)
    k_p = len(x)
    xi = np.arange(nof_sc, dtype=np.float32)
    right = np.searchsorted(x, xi, side="left").clip(1, k_p - 1)
    left = right - 1
    denom = x[right] - x[left]
    w_r = np.where(denom > 0, (xi - x[left]) / np.maximum(denom, 1e-9), 0.0)
    w_r = np.clip(w_r, 0.0, 1.0).astype(np.float32)
    i_mat = np.zeros((nof_sc, k_p), np.float32)
    i_mat[np.arange(nof_sc), left] += 1.0 - w_r
    i_mat[np.arange(nof_sc), right] += w_r
    if strategy == "none":
        return i_mat
    if strategy == "mean":
        return np.full((nof_sc, k_p), 1.0 / k_p, np.float32)
    taps = _rc_filter(stride=stride)
    pad = len(taps) // 2
    f_mat = np.zeros((k_p, k_p), np.float32)
    rows = np.arange(k_p)
    for t, h in enumerate(taps):
        src = rows - pad + t
        low = src < 0
        high = src > k_p - 1
        mid = ~(low | high)
        np.add.at(f_mat, (rows[mid], src[mid]), h)
        if low.any() and k_p >= 2:
            s = src[low].astype(np.float32)
            np.add.at(f_mat, (rows[low], np.zeros(low.sum(), int)),
                      h * (1.0 - s))
            np.add.at(f_mat, (rows[low], np.ones(low.sum(), int)), h * s)
        elif low.any():
            np.add.at(f_mat, (rows[low], np.zeros(low.sum(), int)), h)
        if high.any() and k_p >= 2:
            d = (src[high] - (k_p - 1)).astype(np.float32)
            np.add.at(f_mat, (rows[high],
                              np.full(high.sum(), k_p - 1)), h * (1.0 + d))
            np.add.at(f_mat, (rows[high],
                              np.full(high.sum(), k_p - 2)), -h * d)
        elif high.any():
            np.add.at(f_mat, (rows[high], np.full(high.sum(), k_p - 1)), h)
    return (i_mat @ f_mat).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _smooth_interp_matrix_t(pilot_scs_key: tuple, nof_sc: int, strategy: str,
                            stride: int) -> np.ndarray:
    """complex64 [K_p, nof_sc]: the transposed operator, ready for x @ M."""
    m = _smooth_interp_matrix(pilot_scs_key, nof_sc, strategy, stride)
    return np.ascontiguousarray(m.T).astype(np.complex64)


def _td_weights(dmrs_idx, nof_symbols: int):
    """Per-OFDM-symbol (slice index, weight) for time-domain linear
    interpolation between DM-RS symbols, with edge extrapolation."""
    d = np.asarray(dmrs_idx, dtype=np.int64)
    i0 = np.zeros(nof_symbols, np.int32)
    w = np.zeros(nof_symbols, np.float32)
    if len(d) < 2:
        return i0, w
    for s in range(nof_symbols):
        prev = d[d < s]
        nxt = d[d >= s]
        if len(prev) == 0:
            before, after = d[0], d[1]
        elif len(nxt) == 0:
            before, after = d[-2], d[-1]
        else:
            before, after = prev[-1], nxt[0]
        i0[s] = int(np.searchsorted(d, before))
        w[s] = (s - before) / float(after - before)
    return i0, w


def _td_i0(dmrs_idx: tuple, nof_symbols: int) -> np.ndarray:
    return _td_weights(dmrs_idx, nof_symbols)[0].astype(np.int64)


def _td_w(dmrs_idx: tuple, nof_symbols: int) -> np.ndarray:
    return _td_weights(dmrs_idx, nof_symbols)[1]


def estimate(rx_pilots: torch.Tensor, expected: torch.Tensor,
             pilot_scs: np.ndarray, nof_sc: int, nof_symbols: int,
             scs_hz: float, stride: int = 2, smoothing: str = "filter",
             beta_scaling: float = 1.0, estimate_cfo: bool = True,
             dmrs_symbol_times_s: np.ndarray | None = None,
             td_strategy: str = "average",
             dmrs_symbol_idx: np.ndarray | None = None,
             cdm_pairs: bool = False) -> ChannelEstimate:
    """Estimate the channel for one allocation hop.

    rx_pilots: complex64 [P, S_dmrs, K_p] received REs at pilot positions.
    expected:  complex64 [L, S_dmrs, K_p] transmitted pilots (per layer).
    pilot_scs: int [K_p] subcarrier indices within the allocation.
    cdm_pairs: despread the fd-OCC cover over adjacent pilot pairs (needed
    when several layers share the comb).
    Returns coefficients on the full [P, L, S, nof_sc] lattice.
    """
    dev = rx_pilots.device
    epre = torch.mean(rx_pilots.abs() ** 2, dim=(1, 2))              # [P]
    ls = rx_pilots[:, None] * expected.conj()[None] / (beta_scaling ** 2)

    scs_np = np.asarray(pilot_scs)
    if cdm_pairs:
        ls = 0.5 * (ls[..., 0::2] + ls[..., 1::2])
        pilot_scs_sm = (scs_np[0::2] + scs_np[1::2]) // 2
        stride_sm = stride * 2
    else:
        pilot_scs_sm = scs_np
        stride_sm = stride

    use_cfo = (estimate_cfo and ls.shape[2] >= 2
               and dmrs_symbol_times_s is not None)
    cfo = torch.zeros((), dtype=torch.float32, device=dev)
    if use_cfo:
        dt = float(dmrs_symbol_times_s[1] - dmrs_symbol_times_s[0])
        xcorr = torch.sum(ls[:, :, 1:] * ls[:, :, :-1].conj())
        cfo = (torch.angle(xcorr) / (2 * np.pi * dt)).to(torch.float32)
        t = const(f32, tuple(float(v) for v in dmrs_symbol_times_s),
                  device=dev)
        rot = torch.exp(-2j * np.pi * cfo * t).to(ls.dtype)
        ls = ls * rot[None, None, :, None]

    ls_avg = torch.mean(ls, dim=2)                                   # [P, L, K_sm]
    key = (tuple(int(s) for s in pilot_scs_sm), nof_sc, smoothing, stride_sm)
    m_si_t = const(_smooth_interp_matrix_t, *key, device=dev)        # [K_sm, nsc]
    coeffs_f = torch.matmul(ls_avg, m_si_t)                          # [P, L, nsc]
    pilot_idx = const(i64, tuple(int(s) for s in scs_np), device=dev)
    filtered = coeffs_f[..., pilot_idx]                              # [P, L, K_p]

    rsrp = torch.mean(filtered.abs() ** 2, dim=(1, 2)) * (beta_scaling ** 2)

    recon = filtered[:, :, None, :] * expected[None] * beta_scaling
    if use_cfo:
        rot = torch.exp(2j * np.pi * cfo * t).to(recon.dtype)
        recon = recon * rot[None, None, :, None]
    recon_sum = torch.sum(recon, dim=1)                              # [P, S, K_p]
    resid = rx_pilots - recon_sum
    noise_var = torch.mean(resid.abs() ** 2, dim=(1, 2))             # [P]
    noise_var = torch.maximum(noise_var, rsrp * 10 ** (-60 / 10))
    snr = rsrp / torch.clamp_min(noise_var, 1e-12)

    ta = _time_alignment(ls_avg, pilot_scs_sm, nof_sc, scs_hz, stride_sm)

    if (td_strategy == "interpolate" and dmrs_symbol_idx is not None
            and ls.shape[2] >= 2):
        f_sym = torch.matmul(ls, m_si_t)                             # [P, L, S, nsc]
        dkey = (tuple(int(v) for v in dmrs_symbol_idx), nof_symbols)
        i0 = const(_td_i0, *dkey, device=dev)
        w = const(_td_w, *dkey, device=dev)[None, None, :, None]
        coeffs = (f_sym[:, :, i0, :] * (1.0 - w)
                  + f_sym[:, :, i0 + 1, :] * w).to(torch.complex64)
    else:
        coeffs = coeffs_f[:, :, None, :].to(torch.complex64)         # S == 1
    return ChannelEstimate(coeffs=coeffs, noise_var=noise_var, rsrp=rsrp,
                           epre=epre, snr=snr, time_alignment_s=ta, cfo_hz=cfo)


def _time_alignment(ls_avg: torch.Tensor, pilot_scs: np.ndarray, nof_sc: int,
                    scs_hz: float, stride: int) -> torch.Tensor:
    """IDFT power-peak TA estimate (first maximum, as the JAX package)."""
    nfft = 1
    while nfft < nof_sc * 2:
        nfft *= 2
    pilot_scs = np.asarray(pilot_scs)
    k_p = len(pilot_scs)
    regular = k_p > 1 and bool(np.all(np.diff(pilot_scs) == stride))
    if not regular:
        raise NotImplementedError(
            "TA over an irregular pilot comb arrives with RA type 0 "
            "(ROADMAP §1 item 13)")
    z = torch.zeros_like(ls_avg)
    inter = torch.stack([ls_avg] + [z] * (stride - 1), dim=-1)
    inter = inter.reshape(ls_avg.shape[:-1] + (k_p * stride,))
    buf = torch.nn.functional.pad(inter, (0, nfft - k_p * stride))
    h_t = torch.fft.ifft(buf, dim=-1)
    power = torch.sum(h_t.abs() ** 2, dim=tuple(range(h_t.ndim - 1)))  # [nfft]
    max_delay = nfft // (2 * stride)
    idx = torch.argmax(torch.cat([power[:max_delay], power[-max_delay:]]))
    delay = torch.where(idx < max_delay, idx, idx - 2 * max_delay)
    # a device tensor divisor: PyTorch turns division by a Python scalar
    # into a multiply by its reciprocal, which may round differently
    span = const(f32, (float(nfft * scs_hz),), device=ls_avg.device)[0]
    return delay.to(torch.float32) / span


# ------------------------------------------------------------------ K8

@functools.lru_cache(maxsize=None)
def _band(pilot_scs_key: tuple, nof_sc: int, strategy: str,
          stride: int) -> tuple:
    """The operator of :func:`_smooth_interp_matrix` in band form:
    (first int32 [nof_sc], weights float32 [nof_sc, W]), row n holding the
    matrix entries of columns first[n] .. first[n] + W - 1 (W the widest
    span of nonzeros over the rows; the band never leaves the matrix)."""
    m = _smooth_interp_matrix(pilot_scs_key, nof_sc, strategy, stride)
    k = m.shape[1]
    nz = m != 0
    has = nz.any(axis=1)
    lo = np.where(has, nz.argmax(axis=1), 0)
    hi = np.where(has, k - 1 - nz[:, ::-1].argmax(axis=1), 0)
    width = max(int((hi - lo).max()) + 1, 1)
    first = np.minimum(lo, k - width).astype(np.int32)
    weights = np.take_along_axis(m, first[:, None] + np.arange(width), axis=1)
    return first, np.ascontiguousarray(weights, dtype=np.float32)


def _band_table(i: int, first: int, stride: int, count: int, nof_sc: int,
                strategy: str) -> np.ndarray:
    """One half of :func:`_band` for the regular comb first + stride * k,
    k < count (0: first columns, 1: weights)."""
    comb = tuple(range(first, first + stride * count, stride))
    return _band(comb, nof_sc, strategy, stride)[i]


def _i32(values: tuple) -> np.ndarray:
    return np.asarray(values, dtype=np.int32)


def _comb_i32(first: int, stride: int, count: int) -> np.ndarray:
    return np.arange(first, first + stride * count, stride, dtype=np.int32)


def _td_i0_i32(dmrs_idx: tuple, nof_symbols: int) -> np.ndarray:
    return _td_weights(dmrs_idx, nof_symbols)[0]


def estimate_from_grid_ref(grid: torch.Tensor, symbols: tuple, first_sc: int,
                           expected: torch.Tensor, pilot_scs: np.ndarray,
                           nof_sc: int, nof_symbols: int, scs_hz: float,
                           **kw) -> ChannelEstimate:
    """Plain twin of :func:`estimate_from_grid`: gather the pilots, then
    :func:`estimate` (a slot axis runs slot by slot)."""
    if grid.ndim == 4:
        ests = [estimate_from_grid_ref(
            grid[b], symbols, first_sc, expected[b] if expected.ndim == 4
            else expected, pilot_scs, nof_sc, nof_symbols, scs_hz, **kw)
            for b in range(grid.shape[0])]
        return ChannelEstimate(**{
            f.name: torch.stack([getattr(e, f.name) for e in ests])
            for f in dataclasses.fields(ChannelEstimate)})
    dev = grid.device
    syms = const(i64, tuple(int(s) for s in symbols), device=dev)
    cols = const(i64, tuple(int(first_sc) + int(s) for s in pilot_scs),
                 device=dev)
    rx_pilots = grid[:, syms, :][:, :, cols]
    return estimate(rx_pilots, expected, pilot_scs, nof_sc, nof_symbols,
                    scs_hz, **kw)


def estimate_from_grid(grid: torch.Tensor, symbols: tuple, first_sc: int,
                       expected: torch.Tensor, pilot_scs: np.ndarray,
                       nof_sc: int, nof_symbols: int, scs_hz: float,
                       stride: int = 2, smoothing: str = "filter",
                       beta_scaling: float = 1.0, estimate_cfo: bool = True,
                       dmrs_symbol_times_s: np.ndarray | None = None,
                       td_strategy: str = "average",
                       dmrs_symbol_idx: np.ndarray | None = None,
                       cdm_pairs: bool = False) -> ChannelEstimate:
    """:func:`estimate` on the pilots of ``grid`` (complex64 [P, nsym,
    nsc_grid]): pilot k of DM-RS symbol i sits at grid[:, symbols[i],
    first_sc + pilot_scs[k]].  The other arguments are :func:`estimate`'s.
    With a slot axis -- grid [B, P, nsym, nsc_grid], expected [B, L, S_dmrs,
    K_p] or shared [L, S_dmrs, K_p] -- every field of the result gains it."""
    kw = dict(stride=stride, smoothing=smoothing, beta_scaling=beta_scaling,
              estimate_cfo=estimate_cfo,
              dmrs_symbol_times_s=dmrs_symbol_times_s,
              td_strategy=td_strategy, dmrs_symbol_idx=dmrs_symbol_idx,
              cdm_pairs=cdm_pairs)
    if not is_cuda(grid, expected):
        return estimate_from_grid_ref(grid, symbols, first_sc, expected,
                                      pilot_scs, nof_sc, nof_symbols, scs_hz,
                                      **kw)
    if grid.dtype != torch.complex64 or grid.ndim not in (3, 4):
        raise ValueError(f"grid must be complex64 [(B,) P, S, K], got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    lead = tuple(grid.shape[:-3])
    slots = lead[0] if lead else 1
    scs_np = np.asarray(pilot_scs)
    n_l, n_s, n_k = expected.shape[-3:]
    shared = expected.ndim == 3
    if (expected.dtype != torch.complex64
            or (n_s, n_k) != (len(symbols), len(scs_np))
            or expected.shape[:-3] not in ((), lead)):
        raise ValueError(f"expected must be complex64 [L, {len(symbols)}, "
                         f"{len(scs_np)}], got {expected.dtype} "
                         f"{tuple(expected.shape)}")
    if cdm_pairs:
        if n_k % 2:
            raise ValueError("fd-OCC despread needs an even pilot count")
        scs_sm = (scs_np[0::2] + scs_np[1::2]) // 2
        stride_sm = stride * 2
    else:
        scs_sm, stride_sm = scs_np, stride
    k_sm = len(scs_sm)
    step = int(scs_np[1] - scs_np[0]) if n_k > 1 else 0
    if not (k_sm > 1 and bool(np.all(np.diff(scs_sm) == stride_sm))
            and bool(np.all(np.diff(scs_np) == step))):
        raise NotImplementedError(
            "TA over an irregular pilot comb arrives with RA type 0 "
            "(ROADMAP §1 item 13)")
    use_cfo = (estimate_cfo and n_s >= 2
               and dmrs_symbol_times_s is not None)
    interp = (td_strategy == "interpolate" and dmrs_symbol_idx is not None
              and n_s >= 2)
    nsym_out = nof_symbols if interp else 1
    nfft = 1
    while nfft < nof_sc * 2:
        nfft *= 2
    dev = grid.device
    n_p = grid.shape[-3]
    # Host tables keyed by the comb (first, step, count), not by its pilots.
    key = (int(scs_sm[0]), stride_sm, k_sm, nof_sc, smoothing)
    first = const(_band_table, 0, *key, device=dev)
    weights = const(_band_table, 1, *key, device=dev)
    syms = const(_i32, tuple(int(s) for s in symbols), device=dev)
    p0 = int(scs_np[0])
    cols = const(_comb_i32, int(first_sc) + p0, step, n_k, device=dev)
    pilot_idx = const(_comb_i32, p0, step, n_k, device=dev)
    times = td_i0 = td_w = None
    two_pi_dt = 1.0
    if use_cfo:
        t = tuple(float(v) for v in dmrs_symbol_times_s)
        times = const(f32, t, device=dev)
        two_pi_dt = 2 * np.pi * (t[1] - t[0])
    if interp:
        dkey = (tuple(int(v) for v in dmrs_symbol_idx), nof_symbols)
        td_i0 = const(_td_i0_i32, *dkey, device=dev)
        td_w = const(_td_w, *dkey, device=dev)
    c64 = dict(dtype=torch.complex64, device=dev)
    ls = torch.empty(lead + (n_p, n_l, n_s, k_sm), **c64)
    ls_avg = torch.empty(lead + (n_p, n_l, k_sm), **c64)
    partials = torch.empty(lead + (max(1, -(-(n_p * n_l * n_s * k_sm)
                                             // 256)),), **c64)
    filtered = torch.empty(lead + (n_p, n_l, n_k), **c64)
    coeffs = torch.empty(lead + (n_p, n_l, nsym_out, nof_sc), **c64)
    tabuf = torch.empty(lead + (n_p, n_l, nfft), **c64)
    stats = torch.empty(lead + (4 * n_p + 2,), dtype=torch.float32, device=dev)
    # [(B,) P, NB, 3] partial sums of the stats pass (NB as csrc's
    # stats_blocks)
    stats_part = torch.empty(
        lead + (n_p, min(max(-(-n_s * n_k // 256), 1), 32), 3),
        dtype=torch.float32, device=dev)
    grid = grid.contiguous()
    expected = expected.contiguous()
    lib = _build.load()
    stream = _build.stream_of(grid)

    def opt(x):
        return _build.ptr(x) if x is not None else None

    _build.check(lib.srsran_chest_estimate(
        _build.ptr(grid), grid.shape[-2], grid.shape[-1], _build.ptr(syms),
        _build.ptr(cols), _build.ptr(expected), opt(times), _build.ptr(first),
        _build.ptr(weights), _build.ptr(pilot_idx), opt(td_i0), opt(td_w),
        n_p, n_l, n_s, n_k, int(cdm_pairs), nof_sc, weights.shape[1],
        int(use_cfo), nsym_out, int(interp), float(beta_scaling), two_pi_dt,
        nfft, stride_sm, _build.ptr(ls), _build.ptr(ls_avg),
        _build.ptr(partials), _build.ptr(filtered), _build.ptr(coeffs),
        _build.ptr(stats_part), _build.ptr(stats), _build.ptr(tabuf), slots,
        int(shared), stream), "chest_estimate")
    h_t = torch.fft.ifft(tabuf, dim=-1)
    _build.check(lib.srsran_chest_ta(
        _build.ptr(h_t), n_p, n_l, n_s, n_k, nfft, nfft // (2 * stride_sm),
        float(nfft * scs_hz), float(beta_scaling), _build.ptr(stats_part),
        _build.ptr(stats), slots, stream), "chest_ta")
    (KERNEL_BATCH if lead else KERNEL).count()
    return ChannelEstimate(
        coeffs=coeffs, noise_var=stats[..., :n_p],
        rsrp=stats[..., n_p:2 * n_p], epre=stats[..., 2 * n_p:3 * n_p],
        snr=stats[..., 3 * n_p:4 * n_p], time_alignment_s=stats[..., 4 * n_p + 1],
        cfo_hz=stats[..., 4 * n_p])
