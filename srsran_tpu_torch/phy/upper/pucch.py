"""PUCCH formats 0, 1 and 2: receive and transmit (TS38.211 §6.3.2).

Port of the F0, F1 and F2 parts of srsran_tpu/phy/upper/pucch.py:

- F0 (:func:`detect_format0`): sequence detection against the candidate
  cyclic shifts of the HARQ/SR dictionary (TS38.213 §9.2.3-9.2.5), with
  the host references of :func:`f0_refs_for`.  :func:`f0_detect` is the
  K12 wrapper (csrc/pucch_f0.cu on CUDA tensors, :func:`f0_detect_ref` on
  CPU tensors).
- F1: time-OCC despreading of DM-RS and data symbols, a per-hop channel
  estimate, coherent combining and the BPSK/QPSK decision, for all users
  multiplexed on one occasion at once (the batch API of the reference's
  pucch_processor.h:196-217).  :func:`detect_format1_batch` takes the host
  weights of :func:`f1_batch_weights` (cyclic-shift phases with conj(base)
  folded in, OCC weights): from the slot context, as the JAX conductor
  builds them, or built here and cached per device.  :func:`f1_detect` is
  the K10 wrapper (csrc/pucch_f1.cu, twin :func:`f1_detect_ref`).
- F2 (:func:`process_format2`): the comb-3 DM-RS channel estimate through
  K8, then per data RE the port combining, QPSK demap and descrambling of
  the K13 wrapper :func:`f2_demap` (csrc/pucch_f2.cu, twin
  :func:`f2_demap_ref`), then the UCI decode: short block (K14) or polar
  (K15).

:func:`detect_format1` (one user, host sequences), :func:`transmit_format0`,
:func:`transmit_format1` and :func:`transmit_format2` (UE side) are plain,
for tests and the UE emulation.  Formats 3 and 4 are not ported (ROADMAP
§1 item 13).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ... import kernels
from ...device import const, f32, is_cuda
from ...kernels import _build
from ...ops import channel_estimate as chest
from ...ops import polar as polar_ops
from ...ops import short_block
from ...ops.crc import crc
from ...ops.gold import gold_sequence, gold_sequence_np
from ...ops.low_papr import base_sequence
from ...ops.modulation import (demodulate, modulate, pam_levels_scaled,
                               qpsk_np)
from ...ops.scrambling import descramble_llrs, scramble_bits
from ...ran import polar_params

KERNEL = kernels.register(kernels.Kernel(
    name="pucch_f1_detect", route="cuda",
    source="srsran_tpu_torch/csrc/pucch_f1.cu",
    replaces="srsran_tpu/phy/upper/pucch.py:325"))
KERNEL_F0 = kernels.register(kernels.Kernel(
    name="pucch_f0_detect", route="cuda",
    source="srsran_tpu_torch/csrc/pucch_f0.cu",
    replaces="srsran_tpu/phy/upper/pucch.py:120"))
KERNEL_F2 = kernels.register(kernels.Kernel(
    name="pucch_f2_demap", route="cuda",
    source="srsran_tpu_torch/csrc/pucch_f2.cu",
    replaces="srsran_tpu/phy/upper/pucch.py:764"))


@functools.lru_cache(maxsize=None)
def _ncs_table(n_id: int, slot: int) -> np.ndarray:
    """n_cs(ns, l) for all 14 symbols (TS38.211 §6.3.2.2.2)."""
    seq = gold_sequence_np(n_id, 8 * 14, advance=8 * 14 * slot)
    out = np.zeros(14, dtype=np.int64)
    for l in range(14):
        bits = seq[8 * l: 8 * l + 8]
        out[l] = int(sum(int(b) << m for m, b in enumerate(bits)))
    return out


def ncs_for(n_id: int, slot: int) -> np.ndarray:
    """Host-side n_cs(ns, l) [14]."""
    return _ncs_table(n_id, slot).copy()


@dataclasses.dataclass(frozen=True)
class PucchF1Config:
    """Static PUCCH F1 description (same fields and defaults as the JAX
    package's PucchF1Config)."""

    prb: int
    start_symbol: int
    nof_symbols: int          # 4..14
    initial_cyclic_shift: int
    time_domain_occ: int
    n_id: int
    slot: int = 0
    nof_harq_bits: int = 1    # 1 or 2
    second_hop_prb: int | None = None  # intra-slot frequency hopping


def _occ(idx: int, length: int) -> np.ndarray:
    m = np.arange(length)
    return np.exp(2j * np.pi * idx * m / length).astype(np.complex64)


def _f1_hops(cfg: PucchF1Config):
    """[(prb, first_rel_symbol, nof_symbols)] — one hop, or two with
    intra-slot frequency hopping (hop 0 = first floor(N/2) symbols,
    pucch_detector_format1.cpp:172-192)."""
    if cfg.second_hop_prb is None:
        return ((cfg.prb, 0, cfg.nof_symbols),)
    n0 = cfg.nof_symbols // 2
    return ((cfg.prb, 0, n0), (cfg.second_hop_prb, n0, cfg.nof_symbols - n0))


def _split(s0: int, nsym: int) -> tuple:
    """(DM-RS, data) symbols of a hop, relative to the allocation: DM-RS on
    the even relative symbols of the whole allocation."""
    rel = list(range(s0, s0 + nsym))
    return [s for s in rel if s % 2 == 0], [s for s in rel if s % 2 == 1]


def f1_batch_weights(common: PucchF1Config, users: tuple,
                     slot: int | None = None) -> tuple:
    """Host-side per-hop weights for :func:`detect_format1_batch`:
    ((a_dm [U,S,12], ph [U,S,12], w_da [U,S]), ...) complex64, the same
    values as the JAX package's f1_batch_weights."""
    sl = common.slot if slot is None else slot
    n12 = np.arange(12)
    base = base_sequence(common.n_id % 30, 0, 12)
    m0s = np.array([u[0] for u in users], np.float32)
    out = []
    for prb, s0, nsym in _f1_hops(common):
        l_lo = common.start_symbol + s0
        dmrs_rel, data_rel = _split(s0, nsym)
        w_dm = np.zeros((len(users), nsym), np.complex64)
        w_da = np.zeros((len(users), nsym), np.complex64)
        for ui, (_, occ_i, _) in enumerate(users):
            od = _occ(occ_i, len(dmrs_rel))
            oa = _occ(occ_i, max(len(data_rel), 1))
            for i, s in enumerate(dmrs_rel):
                w_dm[ui, s - s0] = np.conj(od[i])
            for i, s in enumerate(data_rel):
                w_da[ui, s - s0] = np.conj(oa[i])
        ncs_v = _ncs_table(common.n_id, sl)[l_lo: l_lo + nsym]
        alpha = 2 * np.pi / 12 * ((m0s[:, None] + ncs_v[None]) % 12)
        # fold conj(base) in: the device applies these to the RAW rx slice
        ph = (np.exp(-1j * alpha[..., None] * n12)
              * np.conj(base)).astype(np.complex64)
        out.append(((ph * w_dm[..., None]).astype(np.complex64), ph, w_da))
    return tuple(out)


def _weight(common: PucchF1Config, users: tuple, hop: int,
            which: int) -> np.ndarray:
    """One array of :func:`f1_batch_weights` (for the device cache)."""
    return f1_batch_weights(common, users)[hop][which]


def _data_local(common: PucchF1Config, hop: int) -> np.ndarray:
    _, s0, nsym = _f1_hops(common)[hop]
    return np.array([s - s0 for s in _split(s0, nsym)[1]], np.int64)


def f1_detect_ref(grid: torch.Tensor, common: PucchF1Config, weights: tuple,
                  threshold: float) -> tuple:
    """Plain twin of :func:`f1_detect`."""
    dev = grid.device
    nports = grid.shape[0]
    u_count = weights[0][0].shape[0]
    z_chunks = []
    h_energy = torch.zeros((u_count,), dtype=torch.float32, device=dev)
    n_data_total = 0
    for hop_i, (prb, s0, nsym) in enumerate(_f1_hops(common)):
        l_lo = common.start_symbol + s0
        dmrs_rel, data_rel = _split(s0, nsym)
        n_dm = max(len(dmrs_rel), 1)
        d0 = grid[0:nports, l_lo:l_lo + nsym, prb * 12:prb * 12 + 12]
        a_dm, ph, w_da = weights[hop_i]
        # Channel per user: h0[u, p] = mean_n sum_s d0 * a_dm / n_dm
        dm = torch.einsum("psn,usn->upn", d0, a_dm)
        h0 = torch.mean(dm, dim=-1) / n_dm                   # [U, P]
        h_energy = h_energy + 12.0 * torch.sum(h0.abs() ** 2, dim=-1)
        # Matched filter per data symbol: z[u, s].
        z_us = torch.einsum("up,psn,usn->us", h0.conj(), d0, ph)
        if data_rel:
            idx = const(_data_local, common, hop_i, device=dev)
            z_chunks.append(z_us[:, idx] * w_da[:, idx])
        n_data_total += len(data_rel)
    z_s = torch.cat(z_chunks, dim=1)                         # [U, D]
    z_mean = torch.mean(z_s, dim=1)                          # [U]
    nhops = len(_f1_hops(common))
    d_hat = z_mean / torch.clamp_min(h_energy / nhops, 1e-12)
    var = torch.mean((z_s - z_mean[:, None]).abs() ** 2, dim=1)
    metric = n_data_total * z_mean.abs() ** 2 / torch.clamp_min(var, 1e-9)
    detected = metric > threshold
    bits = torch.stack([d_hat.real < 0, d_hat.imag < 0], dim=1).to(torch.int8)
    return detected, metric, bits, d_hat


def f1_detect(grid: torch.Tensor, common: PucchF1Config, weights: tuple,
              threshold: float) -> tuple:
    """(detected bool [U], metric f32 [U], bits int8 [U, 2], symbol
    complex64 [U]) of the users of one F1 occasion, from the grid
    (complex64 [P, nsym, nsc]) and the per-hop weights of
    :func:`f1_batch_weights` as tensors on the grid's device."""
    flat = [w for hop in weights for w in hop]
    if not is_cuda(grid, *flat):
        return f1_detect_ref(grid, common, weights, threshold)
    if grid.dtype != torch.complex64 or grid.ndim != 3:
        raise ValueError(f"grid must be complex64 [P, S, K], got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    hops = _f1_hops(common)
    if len(weights) != len(hops) or any(
            w.dtype != torch.complex64 for w in flat):
        raise ValueError("F1 weights must be complex64 (a_dm, ph, w_da) "
                         f"for each of the {len(hops)} hops")
    dev = grid.device
    u_count = weights[0][0].shape[0]
    grid = grid.contiguous()
    args, keep = [], []
    for i in range(2):                  # hop 1 repeats hop 0 without hopping
        prb, s0, nsym = hops[min(i, len(hops) - 1)]
        a_dm, ph, w_da = (w.contiguous()
                          for w in weights[min(i, len(hops) - 1)])
        if a_dm.shape != (u_count, nsym, 12) or w_da.shape != (u_count, nsym):
            raise ValueError(f"hop {i}: weights {tuple(a_dm.shape)} / "
                             f"{tuple(w_da.shape)} do not fit {nsym} symbols")
        keep += [a_dm, ph, w_da]
        args += [prb, common.start_symbol + s0, nsym, s0, _build.ptr(a_dm),
                 _build.ptr(ph), _build.ptr(w_da)]
    detected = torch.empty((u_count,), dtype=torch.bool, device=dev)
    metric = torch.empty((u_count,), dtype=torch.float32, device=dev)
    bits = torch.empty((u_count, 2), dtype=torch.int8, device=dev)
    d_hat = torch.empty((u_count,), dtype=torch.complex64, device=dev)
    lib = _build.load()
    _build.check(lib.srsran_pucch_f1(
        _build.ptr(grid), grid.shape[0], grid.shape[1], grid.shape[2],
        u_count, len(hops), *args, float(threshold), _build.ptr(detected),
        _build.ptr(metric), _build.ptr(bits), _build.ptr(d_hat),
        _build.stream_of(grid)), "pucch_f1")
    KERNEL.count()
    return detected, metric, bits, d_hat


def detect_format1_batch(grid: torch.Tensor, common: PucchF1Config,
                         users: tuple, threshold: float = 1.5, ncs=None):
    """Batch-detect all users multiplexed on one occasion.

    users: tuple of (initial_cyclic_shift, time_domain_occ, nof_harq_bits).
    ncs: None (weights built on the host for ``common.slot`` and cached per
    device) or the per-hop weight tuple of :func:`f1_batch_weights` as
    tensors (the slot context).  Returns a list of per-user result dicts
    (detected, metric, harq_bits, symbol) in the order given.
    """
    if not users:
        return []
    dev = grid.device
    if ncs is None:
        weights = tuple(tuple(const(_weight, common, tuple(users), h, j,
                                    device=dev) for j in range(3))
                        for h in range(len(_f1_hops(common))))
    elif isinstance(ncs, (tuple, list)):
        weights = ncs
    else:
        raise NotImplementedError(
            "PUCCH F1 from an n_cs table in the slot context is not ported; "
            "pass the weights of f1_batch_weights (ROADMAP §1 item 13)")
    detected, metric, bits, d_hat = f1_detect(grid, common, weights,
                                              threshold)
    return [{"detected": detected[ui], "metric": metric[ui],
             "harq_bits": bits[ui, :nbits], "symbol": d_hat[ui]}
            for ui, (_, _, nbits) in enumerate(users)]


def detect_format1(grid: torch.Tensor, cfg: PucchF1Config,
                   threshold: float = 1.5):
    """One user, plain: despread + coherently combine + decide
    (pucch_detector_format1.h:45-150), with host-built sequences."""
    if cfg.time_domain_occ >= cfg.nof_symbols // (
            4 if cfg.second_hop_prb is not None else 2):
        raise ValueError("time-domain OCC index too large for the symbol "
                         "count / hopping")
    dev = grid.device
    z_all = []
    h_energy = torch.zeros((), dtype=torch.float32, device=dev)
    n_data_total = 0
    nports = grid.shape[0]
    n12 = np.arange(12)
    base = base_sequence(cfg.n_id % 30, 0, 12)
    for prb, s0, nsym in _f1_hops(cfg):
        l_lo = cfg.start_symbol + s0
        dmrs_rel, data_rel = _split(s0, nsym)
        occ_dmrs = _occ(cfg.time_domain_occ, len(dmrs_rel))
        occ_data = _occ(cfg.time_domain_occ, max(len(data_rel), 1))
        rx = grid[0:nports, l_lo:l_lo + nsym, prb * 12:prb * 12 + 12]
        ncs_v = _ncs_table(cfg.n_id, cfg.slot)[l_lo: l_lo + nsym]
        alpha = 2 * np.pi / 12 * ((cfg.initial_cyclic_shift + ncs_v) % 12)
        refs = torch.as_tensor((np.exp(1j * alpha[:, None] * n12)
                                * base).astype(np.complex64)).to(dev)
        despread = rx * refs.conj()[None]                    # [P, nsym, 12]
        w_dm = np.zeros(nsym, dtype=np.complex64)
        w_dm[[s - s0 for s in dmrs_rel]] = np.conj(occ_dmrs)
        dm_acc = torch.einsum("psn,s->pn", despread,
                              torch.as_tensor(w_dm).to(dev))
        h0 = torch.mean(dm_acc, dim=-1) / max(len(dmrs_rel), 1)   # [P]
        h_energy = h_energy + 12.0 * torch.sum(h0.abs() ** 2)
        z_sym = torch.einsum("p,psn->s", h0.conj(), despread)     # [nsym]
        if data_rel:
            idx = torch.as_tensor([s - s0 for s in data_rel]).to(dev)
            z_all.append(z_sym[idx] * torch.as_tensor(
                np.conj(occ_data).astype(np.complex64)).to(dev))
        n_data_total += len(data_rel)
    z_s = torch.cat(z_all)
    z_mean = torch.mean(z_s)
    d_hat = z_mean / torch.clamp_min(
        h_energy / (2 if cfg.second_hop_prb is not None else 1), 1e-12)
    var = torch.mean((z_s - z_mean).abs() ** 2)
    metric = n_data_total * z_mean.abs() ** 2 / torch.clamp_min(var, 1e-9)
    bits = [d_hat.real < 0] + ([d_hat.imag < 0]
                               if cfg.nof_harq_bits == 2 else [])
    return {"detected": metric > threshold, "metric": metric,
            "harq_bits": torch.stack(bits).to(torch.int8), "symbol": d_hat}


def transmit_format1(grid: torch.Tensor, cfg: PucchF1Config,
                     bits) -> torch.Tensor:
    """UE-side PUCCH F1 into port 0 of a [P, nsym, nsc] grid (a copy):
    BPSK/QPSK symbol d spread by the time OCC over the data symbols, the
    OCC-weighted base sequence on the DM-RS symbols (TS38.211 §6.3.2.4)."""
    b = np.atleast_1d(np.asarray(bits)).astype(np.int8)
    if cfg.nof_harq_bits == 1:
        d = complex(1 - 2 * int(b[0]), 0)
    else:
        d = ((1 - 2 * int(b[0])) + 1j * (1 - 2 * int(b[1]))) / np.sqrt(2)
    base = base_sequence(cfg.n_id % 30, 0, 12)
    n12 = np.arange(12)
    out = grid.clone()
    for prb, s0, nsym in _f1_hops(cfg):
        l_lo = cfg.start_symbol + s0
        dmrs_rel, data_rel = _split(s0, nsym)
        occ_dmrs = _occ(cfg.time_domain_occ, len(dmrs_rel))
        occ_data = _occ(cfg.time_domain_occ, max(len(data_rel), 1))
        ncs_v = _ncs_table(cfg.n_id, cfg.slot)[l_lo: l_lo + nsym]
        alpha = 2 * np.pi / 12 * ((cfg.initial_cyclic_shift + ncs_v) % 12)
        refs = np.exp(1j * alpha[:, None] * n12) * base     # [nsym, 12]
        block = np.zeros((nsym, 12), dtype=np.complex64)
        for i, s in enumerate(dmrs_rel):
            block[s - s0] = refs[s - s0] * occ_dmrs[i]
        for i, s in enumerate(data_rel):
            block[s - s0] = refs[s - s0] * occ_data[i] * d
        out[0, l_lo:l_lo + nsym, prb * 12:(prb + 1) * 12] += torch.as_tensor(
            block).to(out.device)
    return out


# ----------------------------------------------------------------- Format 0

@dataclasses.dataclass(frozen=True)
class PucchF0Config:
    """Static PUCCH F0 description (same fields and defaults as the JAX
    package's PucchF0Config)."""

    prb: int                  # absolute PRB index
    start_symbol: int
    nof_symbols: int          # 1 or 2
    initial_cyclic_shift: int  # m0
    n_id: int                 # hopping id
    slot: int = 0
    nof_harq_bits: int = 1    # 0..2
    sr_opportunity: bool = False
    second_hop_prb: int | None = None  # PRB of symbol 1 with intra-slot hopping


# TS38.213 §9.2.3/9.2.4/9.2.5 cyclic-shift dictionaries: (m_cs, sr, harq)
# per (nof_harq_bits, sr_opportunity) -- mirror of the tables at
# pucch_detector_format0.cpp:45-66.
_F0_TABLES = {
    (0, True): ((0, 1, ()),),
    (1, False): ((0, None, (0,)), (6, None, (1,))),
    (2, False): ((0, None, (0, 0)), (3, None, (0, 1)),
                 (6, None, (1, 1)), (9, None, (1, 0))),
    (1, True): ((0, 0, (0,)), (6, 0, (1,)), (3, 1, (0,)), (9, 1, (1,))),
    (2, True): ((0, 0, (0, 0)), (3, 0, (0, 1)), (6, 0, (1, 1)),
                (9, 0, (1, 0)), (1, 1, (0, 0)), (4, 1, (0, 1)),
                (7, 1, (1, 1)), (10, 1, (1, 0))),
}


def _f0_table(cfg: PucchF0Config) -> tuple:
    key = (cfg.nof_harq_bits, cfg.sr_opportunity)
    if key not in _F0_TABLES:
        raise ValueError(
            "pucch_f0: nof_harq_bits=0 requires sr_opportunity=True "
            "(an F0 occasion must carry HARQ bits, SR, or both)")
    return _F0_TABLES[key]


def f0_refs_for(cfg: PucchF0Config, slot: int | None = None) -> np.ndarray:
    """Host-side candidate reference sequences [C, S, 12] complex64 (the
    conductor's slot context for F0)."""
    table = _f0_table(cfg)
    mcs = np.array([m for m, _, _ in table])
    n = np.arange(12)
    base = base_sequence(cfg.n_id % 30, 0, 12)
    sl = cfg.slot if slot is None else slot
    ncs_v = _ncs_table(cfg.n_id, sl)[
        cfg.start_symbol: cfg.start_symbol + cfg.nof_symbols]
    alpha = 2 * np.pi / 12 * ((cfg.initial_cyclic_shift
                               + mcs[:, None] + ncs_v[None, :]) % 12)
    return (np.exp(1j * alpha[..., None] * n) * base).astype(np.complex64)


def _f0_res(cfg: PucchF0Config) -> tuple:
    """(symbol, PRB) of each F0 symbol: the second one on second_hop_prb
    with intra-slot hopping."""
    return tuple((cfg.start_symbol + s,
                  cfg.second_hop_prb if s > 0 and cfg.second_hop_prb
                  is not None else cfg.prb) for s in range(cfg.nof_symbols))


def _f0_maps(nof_harq_bits: int, sr_opportunity: bool) -> np.ndarray:
    """int8 [C, 1 + nof_harq_bits]: each candidate's SR bit (0 where the
    dictionary has none), then its HARQ bits."""
    table = _F0_TABLES[(nof_harq_bits, sr_opportunity)]
    return np.array([[s if s is not None else 0, *h] for _, s, h in table],
                    dtype=np.int8).reshape(len(table), 1 + nof_harq_bits)


def f0_detect_ref(grid: torch.Tensor, cfg: PucchF0Config,
                  refs: torch.Tensor, threshold: float) -> tuple:
    """Plain twin of :func:`f0_detect`."""
    rx = torch.stack([grid[:, l, prb * 12:prb * 12 + 12]
                      for l, prb in _f0_res(cfg)], dim=1)        # [P, S, 12]
    t = torch.einsum("psn,csn->cps", rx, refs.conj())
    corr = torch.sum(t.abs() ** 2, dim=(1, 2)) / 12.0            # [C]
    energy = torch.sum(rx.abs() ** 2)
    noise = torch.clamp_min(energy - torch.max(corr), 1e-9) / 12.0
    metric = corr / noise
    best = torch.argmax(metric)
    maps = const(_f0_maps, cfg.nof_harq_bits, cfg.sr_opportunity,
                 device=grid.device)
    return (metric[best] > threshold, metric[best], maps[best, 1:],
            maps[best, 0], best)


def f0_detect(grid: torch.Tensor, cfg: PucchF0Config, refs: torch.Tensor,
              threshold: float) -> tuple:
    """(detected bool, metric f32, HARQ bits int8 [nof_harq_bits], SR bit
    int8, best candidate int64) of one F0 occasion, from the grid
    (complex64 [P, nsym, nsc]) and the candidates' references (complex64
    [C, S, 12], :func:`f0_refs_for`) on the grid's device."""
    if not is_cuda(grid, refs):
        return f0_detect_ref(grid, cfg, refs, threshold)
    table = _f0_table(cfg)
    s = cfg.nof_symbols
    if grid.dtype != torch.complex64 or grid.ndim != 3:
        raise ValueError(f"grid must be complex64 [P, S, K], got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    if refs.dtype != torch.complex64 or refs.shape != (len(table), s, 12):
        raise ValueError(f"refs must be complex64 [{len(table)}, {s}, 12], "
                         f"got {refs.dtype} {tuple(refs.shape)}")
    dev = grid.device
    nb = cfg.nof_harq_bits
    maps = const(_f0_maps, nb, cfg.sr_opportunity, device=dev)
    (l0, prb0), (_, prb1) = _f0_res(cfg)[0], _f0_res(cfg)[-1]
    grid = grid.contiguous()
    refs = refs.contiguous()
    detected = torch.empty((), dtype=torch.bool, device=dev)
    metric = torch.empty((), dtype=torch.float32, device=dev)
    out = torch.empty((1 + nb,), dtype=torch.int8, device=dev)
    best = torch.empty((), dtype=torch.int64, device=dev)
    lib = _build.load()
    _build.check(lib.srsran_pucch_f0(
        _build.ptr(grid), grid.shape[0], grid.shape[1], grid.shape[2], s, l0,
        prb0, prb1, _build.ptr(refs), len(table), _build.ptr(maps), nb,
        float(threshold), _build.ptr(detected), _build.ptr(metric),
        _build.ptr(out), _build.ptr(best), _build.stream_of(grid)),
        "pucch_f0")
    KERNEL_F0.count()
    return detected, metric, out[1:], out[0], best


def detect_format0(grid: torch.Tensor, cfg: PucchF0Config,
                   threshold: float = 4.0, ncs=None) -> dict:
    """Detect HARQ/SR on PUCCH F0 (pucch_detector_format0.cpp:118-235).

    ncs: None (references built on the host for ``cfg.slot`` and cached per
    device) or the candidates' references as a complex tensor (the slot
    context, :func:`f0_refs_for`).  Returns the JAX package's dict:
    detected, metric, harq_bits, sr_bit, best_mcs_index.
    """
    _f0_table(cfg)
    if ncs is None:
        refs = const(f0_refs_for, cfg, device=grid.device)
    elif isinstance(ncs, torch.Tensor) and ncs.is_complex():
        refs = ncs
    else:
        raise NotImplementedError(
            "PUCCH F0 from an n_cs table in the slot context is not ported; "
            "pass the references of f0_refs_for")
    detected, metric, harq, sr, best = f0_detect(grid, cfg, refs, threshold)
    return {"detected": detected, "metric": metric, "harq_bits": harq,
            "sr_bit": sr, "best_mcs_index": best}


def transmit_format0(grid: torch.Tensor, cfg: PucchF0Config, harq_bits=(),
                     sr: int = 0) -> torch.Tensor:
    """UE-side PUCCH F0 into port 0 of a [P, nsym, nsc] grid (a copy): the
    cyclic shift of the dictionary entry for (SR, HARQ bits), as
    :func:`f0_refs_for` builds the receiver's references.  Nothing is sent
    for a negative SR without HARQ bits."""
    want = tuple(int(b) for b in np.atleast_1d(np.asarray(harq_bits)))
    out = grid.clone()
    for c, (_, s, h) in enumerate(_f0_table(cfg)):
        if h == want and (s is None or s == int(sr)):
            refs = torch.as_tensor(f0_refs_for(cfg)[c]).to(out.device)
            for si, (l, prb) in enumerate(_f0_res(cfg)):
                out[0, l, prb * 12:(prb + 1) * 12] += refs[si]
            break
    return out


# ----------------------------------------------------------------- Format 2

@dataclasses.dataclass(frozen=True)
class PucchF2Config:
    """Static PUCCH F2 description (same fields and defaults as the JAX
    package's PucchF2Config)."""

    rb_start: int
    nof_rb: int
    start_symbol: int
    nof_symbols: int          # 1 or 2
    rnti: int
    n_id: int                 # scrambling (data)
    n_id0: int                # DM-RS scrambling
    nof_uci_bits: int
    slot: int = 0


def f2_dmrs_cinits(cfg: PucchF2Config, slot: int | None = None) -> np.ndarray:
    """Host-side DM-RS c_init per symbol (uint32 [nof_symbols])."""
    sl = cfg.slot if slot is None else slot
    return np.array(
        [((1 << 17) * (14 * sl + cfg.start_symbol + s + 1) * (2 * cfg.n_id0 + 1)
          + 2 * cfg.n_id0) % (1 << 31) for s in range(cfg.nof_symbols)],
        dtype=np.uint32)


def _f2_values_from_cinits(rb_start: int, nof_rb: int,
                           c_inits: tuple) -> np.ndarray:
    npil = 4 * nof_rb
    return np.stack([qpsk_np(gold_sequence_np(int(ci), 2 * npil,
                                              advance=2 * 4 * rb_start))
                     for ci in c_inits], axis=0).astype(np.complex64)


def f2_pilot_values_for(cfg: PucchF2Config,
                        slot: int | None = None) -> np.ndarray:
    """Host-side F2 DM-RS pilot values [nof_symbols, 4*nof_rb] complex64
    (the conductor's slot context for F2)."""
    seeds = tuple(int(c) for c in f2_dmrs_cinits(cfg, slot))
    return _f2_values_from_cinits(cfg.rb_start, cfg.nof_rb, seeds)


def _f2_polar_cfg(k: int, e: int):
    """F2 polar code parameters shared by transmit_format2 and
    process_format2 (TX and RX must agree)."""
    crc_len = 6 if k < 20 else 11
    return polar_params.polar_code(
        k + crc_len, e, nmax=10, ibil=True,
        n_pc=3 if k + crc_len <= 19 else 0), crc_len


@functools.lru_cache(maxsize=None)
def _f2_sc(rb_start: int, nof_rb: int) -> tuple:
    """(data, DM-RS) absolute subcarriers: DM-RS on k % 3 == 1 of each PRB."""
    data_sc, dmrs_sc = [], []
    for rb in range(rb_start, rb_start + nof_rb):
        for k in range(12):
            (dmrs_sc if k % 3 == 1 else data_sc).append(rb * 12 + k)
    return np.array(data_sc, np.int64), np.array(dmrs_sc, np.int64)


def _f2_data_sc(rb_start: int, nof_rb: int, first: int) -> np.ndarray:
    """The data subcarriers counted from subcarrier ``first``."""
    return _f2_sc(rb_start, nof_rb)[0] - first


def _f2_c_init(cfg: PucchF2Config) -> int:
    return ((cfg.rnti << 15) + cfg.n_id) % (1 << 31)


def _f2_pilots(cfg: PucchF2Config, dmrs_cinits, device) -> torch.Tensor:
    """The DM-RS pilot values [S, 4*nof_rb]: from the slot context (a
    complex tensor), from host c_init seeds, or from the config."""
    if isinstance(dmrs_cinits, torch.Tensor) and dmrs_cinits.is_complex():
        return dmrs_cinits
    if dmrs_cinits is None:
        return const(f2_pilot_values_for, cfg, device=device)
    if isinstance(dmrs_cinits, torch.Tensor):
        if dmrs_cinits.device.type != "cpu":
            raise ValueError("F2 DM-RS c_init seeds must stay on the host; "
                             "pass pilot values to run from the device")
        dmrs_cinits = dmrs_cinits.numpy()
    seeds = tuple(int(c) for c in np.asarray(dmrs_cinits).reshape(-1))
    return const(_f2_values_from_cinits, cfg.rb_start, cfg.nof_rb, seeds,
                 device=device)


def f2_estimate_args(grid: torch.Tensor, cfg: PucchF2Config,
                     pilots: torch.Tensor) -> tuple:
    """(args, kwargs) of ``chest.estimate_from_grid`` for the comb-3 DM-RS
    of one F2 PDU (the port channel estimator, as the JAX package runs it:
    stride 3, RC-filter smoothing, no CFO, 30 kHz)."""
    _, dmrs_sc = _f2_sc(cfg.rb_start, cfg.nof_rb)
    args = (grid, tuple(range(cfg.start_symbol,
                              cfg.start_symbol + cfg.nof_symbols)),
            cfg.rb_start * 12, pilots[None], dmrs_sc - cfg.rb_start * 12,
            12 * cfg.nof_rb, cfg.nof_symbols, 30e3)
    return args, dict(stride=3, smoothing="filter", estimate_cfo=False)


def f2_demap_ref(grid: torch.Tensor, coeffs: torch.Tensor,
                 noise_var: torch.Tensor, cfg: PucchF2Config) -> torch.Tensor:
    """Plain twin of :func:`f2_demap`."""
    dev = grid.device
    data_sc = const(_f2_data_sc, cfg.rb_start, cfg.nof_rb, 0, device=dev)
    h_data = coeffs[:, 0, 0][:, const(_f2_data_sc, cfg.rb_start, cfg.nof_rb,
                                      12 * cfg.rb_start, device=dev)]
    noise = torch.mean(noise_var)
    parts = []
    for s in range(cfg.nof_symbols):
        rx_d = grid[:, cfg.start_symbol + s][:, data_sc]
        corr = torch.sum(h_data.conj() * rx_d, dim=0)
        energy = torch.sum(h_data.abs() ** 2, dim=0)
        x = corr / torch.clamp_min(energy, 1e-12)
        nv = noise / torch.clamp_min(energy, 1e-12)
        parts.append(demodulate(x[None], nv[None], "qpsk")[0])
    llr = torch.cat(parts)
    return descramble_llrs(llr[None], _f2_c_init(cfg))[0]


def f2_demap(grid: torch.Tensor, coeffs: torch.Tensor,
             noise_var: torch.Tensor, cfg: PucchF2Config) -> torch.Tensor:
    """Descrambled QPSK LLRs f32 [16 * nof_rb * nof_symbols] of one F2
    PDU: per data RE, maximum-ratio combining over the rx ports with the
    channel estimate (``coeffs`` complex64 [P, 1, 1, 12 * nof_rb], K8's),
    the post-combining noise (mean of ``noise_var`` [P] over the combined
    energy), max-log QPSK and the Gold descramble."""
    if not is_cuda(grid, coeffs, noise_var):
        return f2_demap_ref(grid, coeffs, noise_var, cfg)
    p, nsc = grid.shape[0], 12 * cfg.nof_rb
    if grid.dtype != torch.complex64 or grid.ndim != 3:
        raise ValueError(f"grid must be complex64 [P, S, K], got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    if coeffs.dtype != torch.complex64 or coeffs.shape != (p, 1, 1, nsc):
        raise ValueError(f"coeffs must be complex64 [{p}, 1, 1, {nsc}], got "
                         f"{coeffs.dtype} {tuple(coeffs.shape)}")
    if noise_var.dtype != torch.float32 or noise_var.shape != (p,):
        raise ValueError(f"noise_var must be float32 [{p}]")
    dev = grid.device
    n = 16 * cfg.nof_rb * cfg.nof_symbols
    data_sc = const(_f2_data_sc, cfg.rb_start, cfg.nof_rb, 0, device=dev,
                    dtype=torch.int32)
    gold = gold_sequence(_f2_c_init(cfg), n, device=dev)
    grid = grid.contiguous()
    coeffs = coeffs.contiguous()
    noise_var = noise_var.contiguous()
    llr = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = _build.load()
    _build.check(lib.srsran_pucch_f2_demap(
        _build.ptr(grid), p, grid.shape[1], grid.shape[2], _build.ptr(coeffs),
        _build.ptr(noise_var), _build.ptr(data_sc), 8 * cfg.nof_rb,
        cfg.rb_start * 12, cfg.start_symbol, cfg.nof_symbols,
        float(pam_levels_scaled("qpsk")[0]), _build.ptr(gold),
        _build.ptr(llr), _build.stream_of(grid)), "pucch_f2_demap")
    KERNEL_F2.count()
    return llr


def process_format2(grid: torch.Tensor, cfg: PucchF2Config,
                    dmrs_cinits=None) -> dict:
    """F2 receive: comb-3 DM-RS estimate through the port channel
    estimator (K8), combine + demap + descramble (K13), UCI decode (K14 up
    to 11 bits, else K15).  dmrs_cinits: None, host c_init seeds, or the
    pilot values [S, 4*nof_rb] (the slot context).  Returns the JAX
    package's dict: uci_bits, valid, metric."""
    pilots = _f2_pilots(cfg, dmrs_cinits, grid.device)
    args, kw = f2_estimate_args(grid, cfg, pilots)
    est = chest.estimate_from_grid(*args, **kw)
    llr = f2_demap(grid, est.coeffs, est.noise_var, cfg)
    k = cfg.nof_uci_bits
    if k <= 11:
        bits, metric = short_block.detect(llr[None], k, 2)
        return {"uci_bits": bits[0], "valid": metric[0] > 0.5,
                "metric": metric[0]}
    code, crc_len = _f2_polar_cfg(k, llr.shape[0])
    dec, ok = polar_ops.decode(llr[None], code, f"crc{crc_len}")
    return {"uci_bits": dec[0, :k], "valid": ok[0],
            "metric": const(f32, (1.0,), device=grid.device)[0]}


def transmit_format2(grid: torch.Tensor, cfg: PucchF2Config,
                     bits) -> torch.Tensor:
    """UE-side PUCCH F2 into port 0 of a [P, nsym, nsc] grid (a copy):
    UCI-encode -> scramble -> QPSK on the 8 data subcarriers per PRB, comb-3
    DM-RS on k % 3 == 1 (TS38.211 §6.3.2.5), the exact counterpart of
    :func:`process_format2`."""
    dev = grid.device
    b = torch.as_tensor(np.atleast_1d(np.asarray(bits)).astype(np.int8),
                        device=dev)
    k = cfg.nof_uci_bits
    if b.shape[-1] != k:
        raise ValueError(f"F2 payload {b.shape[-1]} != {k} bits")
    e_tot = 16 * cfg.nof_rb * cfg.nof_symbols
    if k <= 11:
        enc = short_block.encode(b[None], e_tot, 2)[0]
    else:
        code, crc_len = _f2_polar_cfg(k, e_tot)
        with_crc = torch.cat([b[None], crc(b[None], f"crc{crc_len}")], dim=-1)
        u = polar_ops.allocate(with_crc, code)
        enc = polar_ops.rate_match(polar_ops.encode(u, code.n), code)[0]
    syms = modulate(scramble_bits(enc[None], _f2_c_init(cfg)), "qpsk")[0]
    data_sc, dmrs_sc = (torch.as_tensor(a, device=dev)
                        for a in _f2_sc(cfg.rb_start, cfg.nof_rb))
    pilots = torch.as_tensor(f2_pilot_values_for(cfg), device=dev)
    n_data = data_sc.numel()
    out = grid.clone()
    for s in range(cfg.nof_symbols):
        l = cfg.start_symbol + s
        out[0, l, data_sc] += syms[s * n_data:(s + 1) * n_data]
        out[0, l, dmrs_sc] += pilots[s]
    return out
