"""DM-RS port channel estimation (LS + despread + CFO + smoothing +
interpolation + noise + TA).

Port of srsran_tpu/ops/channel_estimate.py::estimate and _time_alignment.
:func:`estimate` is the plain PyTorch version on gathered pilots; it applies
the smoothing-and-interpolation operator as the host matrix of
:func:`_smooth_interp_matrix`, cast to complex64 once and cached per device.

:func:`estimate_from_grid` is the K8 wrapper: on CUDA tensors one launch
of csrc/channel_estimate.cu (a thread-block cluster of up to 8 CTAs per
slot, G = 8 / P a port, each owning a chunk of the port's pilots and
subcarriers, :func:`_chest_cluster`; the pilots read straight from the
resource grid; the smoothing and interpolation as the band of
:func:`_band`, first column + [nsc, W] weights, W = 8 at the flagship;
RSRP, EPRE, noise, CFO and the TA on the device, the TA as one M = nfft /
s point IDFT a row in shared memory, :func:`_ta_shift`,
:func:`_dif_twiddles`, :func:`_dif_bins`), over a regular comb (tables
keyed by first, step,
count) or any pilot list, such as a type 0 PDSCH's DM-RS (tables keyed by
the pilots' bytes), through a plan per call signature on the lean launch
path (``kernels/_build.py::Launch``: :func:`_chest_plan`,
:func:`_chest_params`, :func:`_chest_tables`); on CPU tensors it runs
:func:`estimate_from_grid_ref`, the twin (gather, then :func:`estimate`).
A leading slot axis on the grid (and on the pilots, which are slot
context) runs every slot in the same launch; the band and the tables are
shared, and each result gains the slot axis in front.
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
    if regular:
        # zero-interleave; |ifft| does not see the comb's global shift
        # (a time-domain phase ramp), so pilot_scs[0] is dropped, as the
        # JAX regular branch does
        z = torch.zeros_like(ls_avg)
        inter = torch.stack([ls_avg] + [z] * (stride - 1), dim=-1)
        inter = inter.reshape(ls_avg.shape[:-1] + (k_p * stride,))
        buf = torch.nn.functional.pad(inter, (0, nfft - k_p * stride))
    else:
        # an irregular comb: each pilot at its own subcarrier (the JAX
        # scatter branch, which keeps the shift)
        buf = ls_avg.new_zeros(ls_avg.shape[:-1] + (nfft,))
        buf[..., const(i64, tuple(int(s) for s in pilot_scs),
                       device=ls_avg.device)] = ls_avg
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


@functools.lru_cache(maxsize=64)
def _comb_tables(pilots: bytes, cdm_pairs: bool, first_sc: int, nof_sc: int,
                 strategy: str, stride: int) -> tuple:
    """K8's tables for any pilot list, keyed by its int64 bytes: (int32
    [nof_sc + 2 K_p + K_sm]: the band's first columns, the grid columns,
    the pilots, each despread pilot's place in the TA's nfft-point IDFT --
    its subcarrier, as the JAX scatter branch places it; float32 [nof_sc,
    W] the band's weights).  An irregular comb's band stays narrow in
    pilot-index space."""
    scs = np.frombuffer(pilots, dtype=np.int64)
    scs_sm = (scs[0::2] + scs[1::2]) // 2 if cdm_pairs else scs
    first, weights = _band(tuple(int(s) for s in scs_sm), nof_sc, strategy,
                           stride)
    ints = np.concatenate([first, first_sc + scs, scs, scs_sm])
    return ints.astype(np.int32), weights


def _i32(values: tuple) -> np.ndarray:
    return np.asarray(values, dtype=np.int32)


def _ta_shift(positions: np.ndarray) -> int:
    """log2 of the largest power of two s dividing every position's offset
    from the first (0 for a single pilot): the TA's nfft-point IDFT of
    pilots at these positions is, in magnitude, the (nfft / s)-point IDFT
    of them packed at (position - first) / s, repeated s times."""
    d = np.asarray(positions, np.int64) - int(positions[0])
    g = int(np.gcd.reduce(d)) if len(d) > 1 else 0
    return (g & -g).bit_length() - 1 if g else 0


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


CHEST_MAX_PORTS = 8       # csrc/channel_estimate.cu kChestMaxPorts
CHEST_MAX_LAYERS = 4      # kChestMaxLayers
CHEST_MAX_SYMBOLS = 14    # kChestMaxSymbols
CHEST_SMEM = 230400       # dynamic shared memory a CTA may take (of 232,448)
CHEST_PLANS_MAX = 256


def _nfft(nof_sc: int) -> int:
    nfft = 1
    while nfft < nof_sc * 2:
        nfft *= 2
    return nfft


def _chest_params(pilots: tuple, shapes: tuple, symbols: tuple,
                  nof_sc: int, nof_symbols: int, scs_hz: float, stride: int,
                  beta: float, times: tuple | None, interp_idx: tuple | None,
                  cdm: bool, band_w: int, ta_shift: int) -> _build.ChestParams:
    """K8's launch for one call signature: ``pilots`` ("regular", first,
    step, count) or ("list", int64 bytes); ``shapes`` the grid's and the
    pilots' shapes; ``times`` the DM-RS symbol times when the CFO is
    estimated; ``interp_idx`` the DM-RS symbols when the coefficients are
    interpolated per symbol; ``band_w`` the band's width; ``ta_shift``
    :func:`_ta_shift` of the TA's positions.  Raises on what the kernel does
    not take; the shared memory as :func:`_chest_smem` lays it out."""
    grid_s, exp_s = shapes
    n_k = pilots[3] if pilots[0] == "regular" else len(pilots[1]) // 8
    if len(grid_s) not in (3, 4) or len(exp_s) not in (3, len(grid_s)):
        raise ValueError(f"grid must be [(B,) P, S, K] and expected [(B,) "
                         f"L, S_dmrs, K_p], got {tuple(grid_s)} and "
                         f"{tuple(exp_s)}")
    lead = tuple(grid_s[:-3])
    n_l, n_s = exp_s[-3], exp_s[-2]
    if (exp_s[-2:] != (len(symbols), n_k)
            or (len(exp_s) == 4 and tuple(exp_s[:1]) != lead)):
        raise ValueError(f"expected must be [(B,) L, {len(symbols)}, {n_k}], "
                         f"got {tuple(exp_s)}")
    n_p = grid_s[-3]
    nsym_out = nof_symbols if interp_idx is not None else 1
    if (not 1 <= n_p <= CHEST_MAX_PORTS or not 1 <= n_l <= CHEST_MAX_LAYERS
            or not 1 <= n_s <= CHEST_MAX_SYMBOLS
            or nsym_out > CHEST_MAX_SYMBOLS):
        raise ValueError(f"K8 takes up to {CHEST_MAX_PORTS} ports, "
                         f"{CHEST_MAX_LAYERS} layers and "
                         f"{CHEST_MAX_SYMBOLS} symbols, got {n_p}, {n_l}, "
                         f"{n_s} and {nsym_out} out")
    k_sm = n_k // 2 if cdm else n_k
    stride_sm = 2 * stride if cdm else stride
    nfft = _nfft(nof_sc)
    m = nfft >> min(ta_shift, nfft.bit_length() - 2)
    w2 = 2 * (nfft // (2 * stride_sm))
    g, chunk = _chest_cluster(n_p, k_sm)
    smem = _chest_smem(n_p, g, n_l, n_s, k_sm, chunk, m, w2,
                       interp_idx is not None)
    p = _build.ChestParams(
        P=n_p, L=n_l, S=n_s, K=n_k, Ksm=k_sm, cdm=int(cdm), nsc=nof_sc,
        W=band_w, nsym_grid=grid_s[-2], nsc_grid=grid_s[-1],
        nsym_out=nsym_out, interp=int(interp_idx is not None),
        use_cfo=int(times is not None), nslots=lead[0] if lead else 1,
        shared_pilots=int(len(exp_s) == 3), M=m, maxd=nfft // (2 * stride_sm),
        G=g, chunk=chunk, nfft=nfft, lg_s=(nfft // m).bit_length() - 1,
        smem=smem, beta=beta, beta2=beta * beta,
        two_pi_dt=2 * np.pi * (times[1] - times[0]) if times else 1.0,
        span=float(nfft * scs_hz))
    p.syms[:n_s] = symbols
    if times is not None:
        p.times[:n_s] = times
    if interp_idx is not None:
        i0, w = _td_weights(interp_idx, nof_symbols)
        p.td_i0[:nof_symbols] = i0.tolist()
        p.td_w[:nof_symbols] = w.tolist()
    return p


def _chest_tables(pilots: tuple, first_sc: int, nof_sc: int, stride: int,
                  smoothing: str, cdm: bool) -> tuple:
    """K8's tables for ``pilots`` (:func:`_pilots_key`): (int32 [nof_sc + 2
    K_p + K_sm] the band's first columns, the grid columns, the pilots and
    each despread pilot's subcarrier, its place in the TA's nfft-point
    IDFT; float32 [nof_sc, W] the band's weights; K_sm).  A comb of the
    nominal stride takes the band keyed by (first, step, count)
    (:func:`_band_table`); any other pilot list the one keyed by its bytes
    (:func:`_comb_tables`)."""
    n_k = pilots[3] if pilots[0] == "regular" else len(pilots[1]) // 8
    if cdm and n_k % 2:
        raise ValueError("fd-OCC despread needs an even pilot count")
    k_sm = n_k // 2 if cdm else n_k
    stride_sm = 2 * stride if cdm else stride
    if pilots[0] == "regular" and pilots[2] == stride:
        _, p0, step, n_k = pilots
        scs = np.arange(p0, p0 + step * n_k, step, dtype=np.int64)
        scs_sm = (scs[0::2] + scs[1::2]) // 2 if cdm else scs
        band = (int(scs_sm[0]), stride_sm, len(scs_sm), nof_sc, smoothing)
        ints = np.concatenate([_band_table(0, *band), first_sc + scs, scs,
                               scs_sm]).astype(np.int32)
        weights = _band_table(1, *band)
    else:
        if pilots[0] == "regular":
            _, p0, step, n_k = pilots
            pilots = ("list", np.arange(p0, p0 + step * n_k, step,
                                        dtype=np.int64).tobytes())
        ints, weights = _comb_tables(pilots[1], cdm, first_sc, nof_sc,
                                     smoothing, stride_sm)
    return ints, weights, k_sm


def _chest_cluster(n_p: int, k_sm: int) -> tuple:
    """K8's cluster for ``n_p`` rx ports: (G, chunk), the CTAs a port (the
    cluster P G <= 8 CTAs) and the despread pilots a CTA, at most."""
    g = max(1, min(_build.CHEST_MAX_CTAS // n_p, k_sm))
    return g, -(-k_sm // g)


def _chest_smem(n_p: int, g: int, n_l: int, n_s: int, k_sm: int, chunk: int,
                m: int, w2: int, interp: bool) -> int:
    """K8's dynamic shared memory a CTA (bytes; csrc/channel_estimate.cu's
    Layout): the TA's twiddles and one TA row [M], the port's averages
    [L, K_sm] (after its rotated LS values [L, S, K_sm] for per-symbol
    interpolation), the chunk's LS values [L, S, chunk] and received
    pilots [S, 2 chunk] (complex), the CTA's TA power [M] and every CTA's
    over the CTA's slice of the window [P G, ceil(w2 / (P G))] (floats);
    raises past CHEST_SMEM."""
    per_port = n_l * ((n_s if interp else 0) + 1) * k_sm
    n_cta = n_p * g
    smem = (8 * (2 * m + per_port + n_l * n_s * chunk + 2 * n_s * chunk)
            + 4 * (m + n_cta * -(-w2 // n_cta)))
    if smem > CHEST_SMEM:
        raise ValueError(f"K8's shared memory ({smem} bytes) cannot hold an "
                         f"{m}-point TA row beside {per_port} averages")
    return smem


@functools.lru_cache(maxsize=None)
def _dif_twiddles(m: int) -> np.ndarray:
    """complex64 [M]: the tables of K8's in-place radix-4 decimation in
    frequency (the M-point IDFT), stage by stage for block size N = M, M /
    4, ... down to 4: exp(2j pi r t / N) for r = 1, 2, 3, t < N / 4, built
    in float64 and rounded once (padded with ones)."""
    parts, n = [], m
    while n >= 4:
        t = np.arange(n // 4)
        parts += [np.exp(2j * np.pi * r * t / n) for r in (1, 2, 3)]
        n //= 4
    tw = np.concatenate(parts) if parts else np.zeros(0, complex)
    return np.concatenate([tw, np.ones(m - len(tw))]).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _dif_bins(m: int) -> np.ndarray:
    """int32 [M]: the bin of the M-point IDFT that position p of K8's
    transformed row holds (radix-4 stages, then radix 2 where log2 M is
    odd: block r of a stage holds the outputs 4 k + r of its block)."""
    if m <= 2:
        return np.arange(m, dtype=np.int32)
    sub = _dif_bins(m // 4).astype(np.int64)
    return np.concatenate([4 * sub + r for r in range(4)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _chest_prepare(index: int) -> None:
    """Let K8 take CHEST_SMEM of dynamic shared memory on CUDA device
    ``index`` (once, before any capture)."""
    with torch.cuda.device(index):
        _build.check(_build.load_locked().srsran_chest_prepare(CHEST_SMEM),
                     "chest_prepare")


@functools.lru_cache(maxsize=CHEST_PLANS_MAX)
def _chest_plan(pilots: tuple, first_sc: int, shapes: tuple, symbols: tuple,
                nof_sc: int, nof_symbols: int, scs_hz: float, stride: int,
                smoothing: str, beta: float, times: tuple | None,
                interp_idx: tuple | None, cdm: bool, index: int) -> tuple:
    """K8's plan on CUDA device ``index``: (its launch, with
    :func:`_chest_tables` and the TA's twiddles; the coefficients' shape
    and strides; the complex values of the call's one allocation, the
    coefficients then the launch's scratch; the stats' shape and split; the
    launch count it adds to)."""
    ints, weights, k_sm = _chest_tables(pilots, first_sc, nof_sc, stride,
                                        smoothing, cdm)
    params = _chest_params(pilots, shapes, symbols, nof_sc, nof_symbols,
                           scs_hz, stride, beta, times, interp_idx, cdm,
                           weights.shape[1], _ta_shift(ints[-k_sm:]))
    # the band's rows at the pilots, for the statistics
    pilot_idx = ints[nof_sc + params.K:nof_sc + 2 * params.K]
    ints = np.concatenate([ints, ints[pilot_idx], _dif_bins(params.M)])
    weights = np.concatenate([weights, weights[pilot_idx]])
    _chest_prepare(index)
    dev = torch.device("cuda", index)
    tables = (torch.from_numpy(ints).to(dev),
              torch.from_numpy(np.ascontiguousarray(weights)).to(dev),
              torch.from_numpy(_dif_twiddles(params.M)).to(dev))
    lead = tuple(shapes[0][:-3])
    n_p = params.P
    coeffs = lead + (n_p, params.L, params.nsym_out, nof_sc)
    strides = tuple(int(np.prod(coeffs[i + 1:])) for i in range(len(coeffs)))
    scratch = params.nslots * n_p * params.L * (
        (params.S if params.interp else 0) + 1) * params.Ksm
    return (_build.Launch("srsran_chest_estimate", index, params, tables),
            coeffs, strides, int(np.prod(coeffs)) + scratch,
            lead + (4 * n_p + 2,), (n_p, n_p, n_p, n_p, 2),
            KERNEL_BATCH if lead else KERNEL)


def _pilots_key(pilot_scs) -> tuple:
    """("regular", first, step, count) for a comb of equal steps, else
    ("list", the pilots as int64 bytes)."""
    scs = np.asarray(pilot_scs, dtype=np.int64)
    n = len(scs)
    if n > 1:
        steps = scs[1:] - scs[:-1]
        step = int(steps[0])
        if step > 0 and (steps == step).all():
            return ("regular", int(scs[0]), step, n)
    return ("list", np.ascontiguousarray(scs).tobytes())


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
    K_p] or shared [L, S_dmrs, K_p] -- every field of the result gains it.

    On CUDA one launch of K8 through a plan per call signature, found by
    the content of the arguments (:func:`_chest_plan`)."""
    if not (grid.is_cuda and expected.is_cuda) and not is_cuda(grid,
                                                               expected):
        return estimate_from_grid_ref(
            grid, symbols, first_sc, expected, pilot_scs, nof_sc,
            nof_symbols, scs_hz, stride=stride, smoothing=smoothing,
            beta_scaling=beta_scaling, estimate_cfo=estimate_cfo,
            dmrs_symbol_times_s=dmrs_symbol_times_s, td_strategy=td_strategy,
            dmrs_symbol_idx=dmrs_symbol_idx, cdm_pairs=cdm_pairs)
    if grid.dtype != torch.complex64 or expected.dtype != torch.complex64:
        raise ValueError(f"grid and expected must be complex64, got "
                         f"{grid.dtype} and {expected.dtype}")
    index = grid.get_device()
    if index != expected.get_device():
        raise ValueError("grid and expected lie on different devices")
    n_s = expected.shape[-2]
    use_cfo = estimate_cfo and n_s >= 2 and dmrs_symbol_times_s is not None
    interp = (td_strategy == "interpolate" and dmrs_symbol_idx is not None
              and n_s >= 2)
    launch, coeffs_shape, coeffs_strides, n_total, stats_shape, split, \
        counter = _chest_plan(
            _pilots_key(pilot_scs), int(first_sc),
            (tuple(grid.shape), tuple(expected.shape)),
            tuple(int(s) for s in symbols), int(nof_sc), int(nof_symbols),
            float(scs_hz), int(stride), smoothing, float(beta_scaling),
            tuple(float(t) for t in dmrs_symbol_times_s) if use_cfo
            else None,
            tuple(int(i) for i in dmrs_symbol_idx) if interp else None,
            bool(cdm_pairs), index)
    if not grid.is_contiguous():
        grid = grid.contiguous()
    if not expected.is_contiguous():
        expected = expected.contiguous()
    buf = grid.new_empty(n_total)    # the coefficients, then the scratch
    coeffs = buf.as_strided(coeffs_shape, coeffs_strides)
    stats = grid.new_empty(stats_shape, dtype=torch.float32)
    ptr = buf.data_ptr()
    launch(grid.data_ptr(), expected.data_ptr(), ptr, stats.data_ptr(),
           ptr + 8 * coeffs.numel())
    counter.count()
    noise, rsrp, epre, snr, _ = stats.split_with_sizes(split, -1)
    n_cfo = split[0] * 4
    return ChannelEstimate(coeffs=coeffs, noise_var=noise, rsrp=rsrp,
                           epre=epre, snr=snr,
                           time_alignment_s=stats.select(-1, n_cfo + 1),
                           cfo_hz=stats.select(-1, n_cfo))
