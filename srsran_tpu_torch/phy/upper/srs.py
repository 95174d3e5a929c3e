"""SRS channel estimator (TS38.211 §6.4.1.4).

Port of srsran_tpu/phy/upper/srs.py: correlate the received comb REs with
the cyclic-shifted low-PAPR base sequence of every SRS port, average over
symbols, IDFT-peak TA, then the SRS-specific noise of one TA-compensated
wideband coefficient per (rx port, SRS port).  :func:`estimate` runs the
generic estimator K8 (``channel_estimate.estimate_from_grid``, CFO off,
pilot stride = comb) and then :func:`srs_noise`, the K11 wrapper: on CUDA
tensors the hand kernel of csrc/srs_estimate.cu, which takes K8's TA and
RSRP on the device, through a plan per call signature on
``kernels/_build.py::Launch`` (:func:`_noise_plan`, its struct
:func:`_noise_params`); on CPU tensors its twin :func:`srs_noise_ref`.  A
grid with a slot axis runs both once for all its slots.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ... import kernels
from ...device import const, i64, is_cuda, stack_slots
from ...kernels import _build
from ...ops import channel_estimate as chest
from ...ops.low_papr import base_sequence

KERNEL = kernels.register(kernels.Kernel(
    name="srs_estimate", route="cuda",
    source="srsran_tpu_torch/csrc/srs_estimate.cu",
    replaces="srsran_tpu/phy/upper/srs.py:98"))
KERNEL_BATCH = kernels.batched(KERNEL)


@dataclasses.dataclass(frozen=True)
class SrsConfig:
    """Static SRS occasion description (same fields and defaults as the JAX
    package's SrsConfig)."""

    rb_start: int
    rb_count: int              # resolved m_SRS (from C_SRS/B_SRS tables)
    start_symbol: int
    nof_symbols: int           # 1, 2 or 4
    comb: int                  # K_TC: 2 or 4
    comb_offset: int
    cyclic_shift: int          # n_SRS_cs
    nof_ports: int             # N_ap: 1, 2 or 4
    sequence_id: int           # n_SRS_ID
    numerology: int = 0
    rnti: int = 0              # fapi ul_srs_pdu rnti (indication routing)

    @property
    def seq_len(self) -> int:
        return self.rb_count * 12 // self.comb

    @property
    def n_cs_max(self) -> int:
        return 8 if self.comb == 2 else 12


@functools.lru_cache(maxsize=None)
def port_sequence(cfg: SrsConfig, port: int) -> np.ndarray:
    """r^(alpha_p) for SRS port p (TS38.211 §6.4.1.4.2)."""
    u = cfg.sequence_id % 30
    m = cfg.seq_len
    base = base_sequence(u, 0, m)
    n_cs = (cfg.cyclic_shift + cfg.n_cs_max * port // cfg.nof_ports) % cfg.n_cs_max
    alpha = 2 * np.pi * n_cs / cfg.n_cs_max
    n = np.arange(m)
    return (np.exp(1j * alpha * n) * base).astype(np.complex64)


def sc_indices(cfg: SrsConfig) -> np.ndarray:
    return (cfg.rb_start * 12 + cfg.comb_offset
            + cfg.comb * np.arange(cfg.seq_len)).astype(np.int32)


def _symbols(cfg: SrsConfig) -> tuple:
    return tuple(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))


@functools.lru_cache(maxsize=None)
def _expected(cfg: SrsConfig) -> np.ndarray:
    """complex64 [L, S, K]: every port's sequence on every SRS symbol."""
    return np.stack([np.repeat(port_sequence(cfg, p)[None], cfg.nof_symbols,
                               axis=0) for p in range(cfg.nof_ports)])


def _expected_tensor(cfg: SrsConfig, device) -> torch.Tensor:
    return const(_expected, cfg, device=device)


def map_to_grid(grid: torch.Tensor, cfg: SrsConfig) -> torch.Tensor:
    """UE-side: a copy of ``grid`` with the SRS of every port added (port p
    transmits on grid port p; tests and the UE emulation)."""
    dev = grid.device
    out = grid.clone()
    sc = const(i64, tuple(int(s) for s in sc_indices(cfg)), device=dev)
    for p in range(cfg.nof_ports):
        seq = torch.as_tensor(port_sequence(cfg, p)).to(dev)
        for s in _symbols(cfg):
            out[p, s, sc] += seq
    return out


def _ramp_scale(cfg: SrsConfig) -> float:
    """2 pi scs comb: the per-comb-sample phase of a delay of one second."""
    return 2.0 * np.pi * float(15_000 << cfg.numerology) * cfg.comb


def _arange_f32(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.float32)


def srs_noise_ref(grid: torch.Tensor, cfg: SrsConfig, ta: torch.Tensor,
                  rsrp: torch.Tensor) -> tuple:
    """Plain twin of :func:`srs_noise` (a slot axis runs slot by slot)."""
    if grid.ndim == 4:
        return stack_slots([srs_noise_ref(grid[b], cfg, ta[b], rsrp[b])
                            for b in range(grid.shape[0])])
    dev = grid.device
    syms = const(i64, _symbols(cfg), device=dev)
    sc = const(i64, tuple(int(s) for s in sc_indices(cfg)), device=dev)
    rx = grid[:, syms, :][:, :, sc]                              # [P, S, K]
    expected = _expected_tensor(cfg, dev)                        # [L, S, K]
    seq0 = expected[:, 0, :]                                     # [L, K]
    ls_mean = torch.mean(rx[:, None] * expected.conj()[None], dim=2)
    k = const(_arange_f32, cfg.seq_len, device=dev)
    # per-comb-sample phase of a pure delay: 2*pi * ta * scs * comb
    phase = (_ramp_scale(cfg) * ta.to(torch.float32)) * k
    ramp = torch.exp(1j * phase).to(torch.complex64)
    wideband = torch.mean(ls_mean * ramp[None, None, :], dim=-1)  # [P, L]
    recon = torch.einsum("pl,lk->pk", wideband,
                         seq0 * ramp.conj()[None, :])            # [P, K]
    acc = torch.sum(rx, dim=1)                                   # [P, K]
    resid = acc - cfg.nof_symbols * recon
    # each accumulated sample carries S*sigma^2 of noise; L wideband
    # coefficients were fit on the K samples -> K-L residual DOF
    dof = max(cfg.seq_len - cfg.nof_ports, 1)
    noise_var = torch.sum(resid.abs() ** 2, dim=-1) / (
        float(cfg.nof_symbols) * dof)                            # [P]
    noise_var = torch.maximum(noise_var, rsrp * 10 ** (-60 / 10))
    snr = rsrp / torch.clamp_min(noise_var, 1e-12)
    return noise_var, snr


def _noise_params(shapes: tuple, strides: tuple,
                  cfg: SrsConfig) -> _build.SrsNoiseParams:
    """K11's parameters for one call signature: the shapes of the grid, the
    TA and the RSRP, their strides and the occasion; raises on what the
    kernel does not take.  A port's warps W: 1 up to K = 256
    subcarriers, else the power of two with at most 256 a warp (8 at
    K = 1632); J the power of two >= the subcarriers a lane."""
    grid_s, ta_s, rsrp_s = shapes
    if len(grid_s) not in (3, 4):
        raise ValueError(f"grid must be complex64 [(B,) P, S, K], got "
                         f"{tuple(grid_s)}")
    lead = tuple(grid_s[:-3])
    n_p, nsym, nsc = grid_s[-3:]
    slots = lead[0] if lead else 1
    if tuple(rsrp_s) != lead + (n_p,) or math.prod(ta_s) != slots:
        raise ValueError(f"rsrp {tuple(rsrp_s)} / ta {tuple(ta_s)} do not "
                         f"fit {n_p} rx ports of {slots} slots")
    if not 0 < n_p <= _build.SRS_MAX_RX_PORTS:
        raise ValueError(f"{n_p} rx ports: K11 takes 1 to "
                         f"{_build.SRS_MAX_RX_PORTS}")
    n_l, n_s, k = cfg.nof_ports, cfg.nof_symbols, cfg.seq_len
    if not 0 < n_l <= _build.SRS_MAX_LAYERS:
        raise ValueError(f"{n_l} SRS ports: K11 takes at most "
                         f"{_build.SRS_MAX_LAYERS}")
    if not 0 < n_s <= _build.SRS_MAX_SYMBOLS:
        raise ValueError(f"{n_s} SRS symbols: K11 takes 1 to "
                         f"{_build.SRS_MAX_SYMBOLS}")
    warps = 1
    while k > 256 * warps:
        warps *= 2
    if warps > _build.SRS_MAX_WARPS:
        raise ValueError(f"K = {k} comb subcarriers: K11 takes at most "
                         f"{256 * _build.SRS_MAX_WARPS}")
    sc0 = cfg.rb_start * 12 + cfg.comb_offset
    if (cfg.start_symbol + n_s > nsym or k < 1
            or sc0 + cfg.comb * (k - 1) >= nsc):
        raise ValueError(f"the SRS occasion (subcarriers {sc0} + "
                         f"{cfg.comb} k, k < {k}, symbols "
                         f"{cfg.start_symbol}-{cfg.start_symbol + n_s - 1}) "
                         f"lies outside the grid {tuple(grid_s)}")
    if slots * n_p * nsym * nsc >= 1 << 31:
        raise ValueError("K11 takes at most 2^31 elements a grid (32-bit "
                         "offsets)")
    j = 1
    while 32 * warps * j < k:
        j *= 2
    ta_st, rsrp_st = strides[1], strides[2]
    return _build.SrsNoiseParams(
        slots=slots, P=n_p, nsym=nsym, nsc=nsc, sc0=sc0, comb=cfg.comb,
        s0=cfg.start_symbol, S=n_s, K=k, L=n_l,
        lw=warps.bit_length() - 1,
        ppc=min(n_p, _build.SRS_MAX_WARPS) if warps == 1 else 1, J=j,
        ta_stride=ta_st[0] if ta_st else 0,
        rsrp_stride=rsrp_st[0] if lead else 0, c=_ramp_scale(cfg),
        inv_sk=1.0 / (n_s * k), sdof=float(n_s) * max(k - n_l, 1))


@functools.lru_cache(maxsize=256)
def _noise_plan(shapes: tuple, strides: tuple, cfg: SrsConfig,
                index: int) -> tuple:
    """K11's launch for one call signature on CUDA device ``index`` and
    its output's shape, [(B,) 2, P]: the noise variances, then the SNRs.
    The plan holds the sequence table [L, K], each SRS port's sequence once
    (``_expected`` repeats it on every symbol)."""
    p = _noise_params(shapes, strides, cfg)
    seq = torch.from_numpy(np.ascontiguousarray(_expected(cfg)[:, 0])).to(
        f"cuda:{index}")
    lead = tuple(shapes[0][:-3])
    return (_build.Launch("srsran_srs_noise", index, p, (seq,)),
            lead + (2, p.P))


def srs_noise(grid: torch.Tensor, cfg: SrsConfig, ta: torch.Tensor,
              rsrp: torch.Tensor) -> tuple:
    """SRS noise variance and SNR per rx port, (f32 [P], f32 [P]), from the
    received grid, the TA (f32 scalar) and RSRP (f32 [P]) of the generic
    estimate (srs.py:98-118 of the JAX package).  B slots at once: grid
    [B, P, nsym, nsc], ta [B] and rsrp [B, P] give ([B, P], [B, P]), in
    one launch.  On the card: K11 through the cached plan of the call's
    signature (the TA and RSRP read where they lie, K8's strided views
    included); one output allocation."""
    if not (grid.is_cuda and ta.is_cuda and rsrp.is_cuda):
        is_cuda(grid, ta, rsrp)                              # raises on a mix
        return srs_noise_ref(grid, cfg, ta, rsrp)
    if grid.dtype != torch.complex64:
        raise ValueError(f"grid must be complex64 [(B,) P, S, K], got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    g = grid if grid.is_contiguous() else grid.contiguous()
    t = ta if ta.dtype == torch.float32 else ta.float()
    r = rsrp if rsrp.dtype == torch.float32 else rsrp.float()
    if r.ndim and r.stride(-1) != 1:
        r = r.contiguous()
    launch, shape = _noise_plan((g.shape, t.shape, r.shape),
                                (None, t.stride(), r.stride()), cfg,
                                g.get_device())
    out = g.new_empty(shape, dtype=torch.float32)
    launch(g.data_ptr(), t.data_ptr(), r.data_ptr(), out.data_ptr())
    (KERNEL_BATCH if len(shape) > 2 else KERNEL).count()
    return out.unbind(-2)


def estimate_args(grid: torch.Tensor, cfg: SrsConfig) -> tuple:
    """(args, kwargs) of the generic estimate (``chest.estimate_from_grid``)
    on the SRS comb: CFO off, pilot stride = comb."""
    sc = sc_indices(cfg)
    args = (grid, _symbols(cfg), cfg.rb_start * 12 + cfg.comb_offset,
            _expected_tensor(cfg, grid.device),
            sc - cfg.rb_start * 12 - cfg.comb_offset, cfg.seq_len * cfg.comb,
            cfg.nof_symbols, float(15_000 << cfg.numerology))
    return args, dict(stride=cfg.comb, smoothing="filter", estimate_cfo=False)


def estimate(grid: torch.Tensor, cfg: SrsConfig) -> chest.ChannelEstimate:
    """Estimate the [rx_port, srs_port] channel from a received grid (with
    a slot axis, [B, P, nsym, nsc]: K8 and K11 once for the B slots, every
    field of the estimate with a leading slot axis)."""
    args, kwargs = estimate_args(grid, cfg)
    est = chest.estimate_from_grid(*args, **kwargs)
    noise_var, snr = srs_noise(grid, cfg, est.time_alignment_s, est.rsrp)
    return dataclasses.replace(est, noise_var=noise_var, snr=snr)
