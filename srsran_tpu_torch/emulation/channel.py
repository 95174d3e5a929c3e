"""Frequency-domain TDL fading channel emulator (kernel K20).

Port of srsran_tpu/emulation/channel.py (the reference's channel_emulator,
tests/integrationtests/phy/upper/channel_processors/
pxsch_bler_test_channel_emulator.h:41-67): TDLA/TDLB/TDLC delay profiles
(TR 38.901-inspired, no Doppler), per-slot uncorrelated tap coefficients
(Rayleigh or uniform-phase), AWGN at a target SINR and an optional CFO.

:func:`apply` is deterministic given its draws: H[r,t,k] = sum_d g[r,t,d]
steer[d,k]; rx[r,s,k] = sum_t H[r,t,k] tx[t,s,k], times a CFO rotation per
symbol; n0 = mean |rx|^2 over all R*S*K REs (empty ones included) over
10^(SINR/10); rx + sqrt(n0/2) noise.  On CUDA tensors it runs kernel K20
(csrc/tdl_channel.cu) through a plan per call signature on
``kernels/_build.py::Launch`` (:func:`_tdl_plan`: the steering table, the
rotation and the launch's :class:`_build.TdlParams`, split by
:func:`_tdl_split`): a CTA per (rx port, 32 lanes of 2 subcarriers, group
of symbols), every load staged at entry, rx and the CTAs' partial power
sums stored; then a second launch adds the noise at the level of their
sum, taken in one fixed order, so a replay gives the same bits.  On CPU tensors the plain twin
:func:`apply_ref` runs.  On the card K20 is bound by its bytes (tx, noise
and steering in; rx and H out): 5.1 MB at the flagship 4x4, 273 RB.

:func:`run` draws the gains [R, T, D] and the noise [R, S, K] from an
explicit ``torch.Generator`` on the grid's device, in the JAX function's
order and scaling (Rayleigh (N + jN)/sqrt(2) times the tap amplitudes,
uniform phase e^{j phi} times them; noise N + jN), then calls
:func:`apply`.  The draws differ from ``jax.random``'s by construction, and
a CPU generator's from a CUDA one's: the tests compare :func:`apply` with
the JAX channel on the same draws.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build

KERNEL = kernels.register(kernels.Kernel(
    name="tdl_channel", route="cuda",
    source="srsran_tpu_torch/csrc/tdl_channel.cu",
    replaces="srsran_tpu/emulation/channel.py:67"))

# (delay ns, average power dB) — TR 38.901 TDL profiles as used by the
# reference emulator.
PROFILES = {
    "single-tap": ((0, 0.0),),
    "TDLA": ((0, -15.5), (10, 0.0), (15, -5.1), (20, -5.1), (25, -9.6),
             (50, -8.2), (65, -13.1), (75, -11.5), (105, -11.0),
             (135, -16.2), (150, -16.6), (290, -26.2)),
    "TDLB": ((0, 0.0), (10, -2.2), (20, -0.6), (30, -0.6), (35, -0.3),
             (45, -1.2), (55, -5.9), (120, -2.2), (170, -0.8), (245, -6.3),
             (330, -7.5), (480, -7.1)),
    "TDLC": ((0, -6.9), (65, 0.0), (70, -7.7), (190, -2.5), (195, -2.4),
             (200, -9.9), (240, -8.0), (325, -6.6), (520, -7.1),
             (1045, -13.0), (1510, -14.2), (2595, -16.0)),
}


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    profile: str = "TDLA"
    fading: str = "rayleigh"        # 'rayleigh' | 'uniform-phase'
    sinr_db: float = 20.0
    cfo_hz: float = 0.0
    nof_tx_ports: int = 1
    nof_rx_ports: int = 1
    nof_subc: int = 12 * 52
    nof_symbols: int = 14
    scs_hz: int = 30_000


@functools.lru_cache(maxsize=None)
def _steering(profile: str, nof_subc: int, scs_hz: int) -> np.ndarray:
    """Per-tap frequency response phases [taps, nof_subc]."""
    taps = PROFILES[profile]
    delays = np.array([t[0] for t in taps]) * 1e-9
    f = (np.arange(nof_subc) - nof_subc / 2) * scs_hz
    return np.exp(-2j * np.pi * np.outer(delays, f)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _amplitudes(profile: str) -> np.ndarray:
    taps = PROFILES[profile]
    p = 10 ** (np.array([t[1] for t in taps]) / 10)
    return np.sqrt(p / p.sum()).astype(np.float32)


def _rotation(cfo_hz: float, nof_symbols: int, scs_hz: int) -> np.ndarray:
    """complex64 [S]: the CFO's phase per symbol, at the approximate symbol
    times arange(S) / scs (no cyclic prefix), in float32 as JAX computes
    it (srsran_tpu/emulation/channel.py:88-90)."""
    t_sym = np.arange(nof_symbols, dtype=np.float32) / np.float32(scs_hz)
    phase = np.float32(2 * np.pi) * np.float32(cfo_hz) * t_sym
    return np.exp(1j * phase.astype(np.float32)).astype(np.complex64)


def _check(tx_grid: torch.Tensor, cfg: ChannelConfig, gains, noise) -> None:
    _check_shapes(tuple(tx_grid.shape), tuple(gains.shape),
                  tuple(noise.shape), cfg)


def _check_shapes(tx_s: tuple, g_s: tuple, n_s: tuple,
                  cfg: ChannelConfig) -> None:
    d = len(PROFILES[cfg.profile])
    r, t = cfg.nof_rx_ports, cfg.nof_tx_ports
    s, k = cfg.nof_symbols, cfg.nof_subc
    if tx_s != (t, s, k) or g_s != (r, t, d) or n_s != (r, s, k):
        raise ValueError(f"tx {tx_s}, gains {g_s}, noise {n_s} vs ({t}, "
                         f"{s}, {k}), ({r}, {t}, {d}), ({r}, {s}, {k})")


def apply_ref(tx_grid: torch.Tensor, cfg: ChannelConfig, gains: torch.Tensor,
              noise: torch.Tensor) -> tuple:
    """Plain twin of :func:`apply` (the JAX function's einsums)."""
    _check(tx_grid, cfg, gains, noise)
    dev = tx_grid.device
    steer = const(_steering, cfg.profile, cfg.nof_subc, cfg.scs_hz,
                  device=dev)
    h = torch.einsum("rtd,dk->rtk", gains.to(torch.complex64), steer)
    rx = torch.einsum("rtk,tsk->rsk", h, tx_grid.to(torch.complex64))
    if cfg.cfo_hz:
        rot = const(_rotation, float(cfg.cfo_hz), cfg.nof_symbols,
                    cfg.scs_hz, device=dev)
        rx = rx * rot[None, :, None]
    sig_pow = torch.mean(torch.abs(rx) ** 2)
    n0 = sig_pow / (10 ** (cfg.sinr_db / 10))
    rx = rx + torch.sqrt(n0 / 2) * noise.to(torch.complex64)
    return rx, h


def _tdl_smem(t: int, d: int, warps: int, vec: int) -> int:
    """Bytes of a K20 launch-1 CTA's dynamic shared memory
    (csrc/tdl_channel.cu smem_bytes): steering [D][32 V], gains [T D]
    padded to even, H [T][32 V] and tx [warps][T][32 V] complex values."""
    row = 32 * vec
    return 8 * (d * row + ((t * d + 1) & ~1) + t * row + warps * t * row)


def _tdl_split(r: int, t: int, s: int, k: int, d: int, vec: int,
               sms: int) -> tuple:
    """(splits, warps): K20's symbol groups (gridDim.y) and warps a CTA,
    one symbol a warp.  The fewest groups that give the grid two CTAs an
    SM (every symbol its own CTA when even that gives fewer), within
    TDL_MAX_WARPS warps and TDL_MAX_SMEM bytes a CTA."""
    runs = -(-(-(-k // vec)) // 32)         # ceil(ceil(K / V) / 32)
    for asked in range(1, s + 1):
        warps = -(-s // asked)
        splits = -(-s // warps)             # no group left empty
        if (warps > _build.TDL_MAX_WARPS
                or _tdl_smem(t, d, warps, vec) > _build.TDL_MAX_SMEM):
            continue
        if runs * r * splits >= 2 * sms or warps == 1:
            return splits, warps
    raise AssertionError("one symbol a CTA always fits")


def _tdl_params(r: int, t: int, s: int, k: int, d: int, vec: int,
                splits: int, warps: int, use_rot: bool,
                sinr_db: float) -> _build.TdlParams:
    """K20's launch parameters (csrc/tdl_channel.cu TdlParams)."""
    lanes = -(-k // vec)
    runs = -(-lanes // 32)
    return _build.TdlParams(
        R=r, T=t, S=s, K=k, D=d, V=vec, lanes=lanes, runs=runs,
        splits=splits, warps=warps, use_rot=int(use_rot),
        nblocks=runs * splits * r, smem=_tdl_smem(t, d, warps, vec),
        scale=1.0 / (r * s * k * 10 ** (sinr_db / 10) * 2))


@functools.lru_cache(maxsize=64)
def _tdl_plan(shapes: tuple, dtypes: tuple, devices: tuple,
              cfg: ChannelConfig, vec: int):
    """K20's launch for one call signature: the inputs' shapes, dtypes and
    CUDA devices, the configuration and V (2: 16-byte accesses).  The plan
    holds the steering table and the rotation; a call brings its own
    scratch for the partial sums, so calls on two streams share nothing
    that they write."""
    _check_shapes(*shapes, cfg)
    if any(dt != torch.complex64 for dt in dtypes):
        raise ValueError("the channel's inputs must be complex64")
    if len(set(devices)) != 1:
        raise ValueError(f"the channel's inputs on CUDA devices {devices}")
    r, t, d = shapes[1]
    s, k = cfg.nof_symbols, cfg.nof_subc
    if t > _build.TDL_MAX_TX or d > _build.TDL_MAX_TAPS:
        raise ValueError(f"{t} TX ports / {d} taps (K20 takes "
                         f"{_build.TDL_MAX_TX} / {_build.TDL_MAX_TAPS})")
    if max(r * s, t * s, r * t, d) * k >= 1 << 31:
        raise ValueError("K20 takes at most 2^31 elements an input or "
                         "output (32-bit offsets)")
    index = devices[0]
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    split = _tdl_split(r, t, s, k, d, vec, sms)
    params = _tdl_params(r, t, s, k, d, vec, *split, bool(cfg.cfo_hz),
                         cfg.sinr_db)
    dev = torch.device("cuda", index)
    steer = torch.from_numpy(_steering(cfg.profile, k, cfg.scs_hz)).to(dev)
    rot = torch.from_numpy(_rotation(float(cfg.cfo_hz), s, cfg.scs_hz)).to(
        dev)
    return _build.Launch("srsran_tdl_channel", index, params, (steer, rot))


def apply(tx_grid: torch.Tensor, cfg: ChannelConfig, gains: torch.Tensor,
          noise: torch.Tensor) -> tuple:
    """The channel on given draws.  tx_grid complex64 [T, S, K], gains
    complex64 [R, T, D] (the tap coefficients, amplitudes included), noise
    complex64 [R, S, K] (unit-variance parts) -> (rx [R, S, K], H [R, T,
    K]).  K20 on CUDA tensors (allocating rx, H and the partial sums), the
    plain twin on CPU tensors."""
    if not is_cuda(tx_grid, gains, noise):
        return apply_ref(tx_grid, cfg, gains, noise)
    tx, g, z = (x if x.is_contiguous() else x.contiguous()
                for x in (tx_grid, gains, noise))
    # V = 2 where K is even and tx and noise are 16-byte aligned
    vec = 1 if (tx.data_ptr() | z.data_ptr()) & 15 or cfg.nof_subc & 1 else 2
    launch = _tdl_plan(
        (tuple(tx.shape), tuple(g.shape), tuple(z.shape)),
        (tx.dtype, g.dtype, z.dtype),
        (tx.get_device(), g.get_device(), z.get_device()), cfg, vec)
    r, t = g.shape[0], g.shape[1]
    h = tx.new_empty((r, t, cfg.nof_subc))
    rx = tx.new_empty((r, cfg.nof_symbols, cfg.nof_subc))
    partial = tx.new_empty(launch.params.nblocks, dtype=torch.float64)
    launch(tx.data_ptr(), g.data_ptr(), z.data_ptr(), rx.data_ptr(),
           h.data_ptr(), partial.data_ptr())
    KERNEL.count()
    return rx, h


def draw(cfg: ChannelConfig, generator: torch.Generator) -> tuple:
    """(gains [R, T, D], noise [R, S, K]) complex64 from ``generator``, on
    its device, in the JAX function's order and scaling."""
    dev = generator.device
    shape = (cfg.nof_rx_ports, cfg.nof_tx_ports, len(PROFILES[cfg.profile]))
    amp = const(_amplitudes, cfg.profile, device=dev)
    if cfg.fading == "rayleigh":
        re = torch.randn(shape, generator=generator, device=dev)
        im = torch.randn(shape, generator=generator, device=dev)
        g = torch.complex(re, im) / math.sqrt(2)
    else:
        phase = torch.rand(shape, generator=generator, device=dev) * (
            2 * math.pi)
        g = torch.polar(torch.ones_like(phase), phase)
    g = g * amp
    nshape = (cfg.nof_rx_ports, cfg.nof_symbols, cfg.nof_subc)
    nr = torch.randn(nshape, generator=generator, device=dev)
    ni = torch.randn(nshape, generator=generator, device=dev)
    return g, torch.complex(nr, ni)


def run(tx_grid: torch.Tensor, cfg: ChannelConfig,
        generator: torch.Generator) -> tuple:
    """Apply the channel with fresh draws.  tx_grid [T, S, K] -> (rx_grid
    [R, S, K], H [R, T, K]); ``generator`` lies on the grid's device."""
    if generator.device.type != tx_grid.device.type:
        raise ValueError(f"generator on {generator.device}, grid on "
                         f"{tx_grid.device}")
    gains, noise = draw(cfg, generator)
    return apply(tx_grid.to(torch.complex64), cfg, gains, noise)
