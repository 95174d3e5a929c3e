"""PUCCH format 1 receive and transmit (TS38.211 §6.3.2.4).

Port of the F1 part of srsran_tpu/phy/upper/pucch.py: time-OCC despreading
of DM-RS and data symbols, a per-hop channel estimate, coherent combining
and the BPSK/QPSK decision, for all users multiplexed on one occasion at
once (the batch API of the reference's pucch_processor.h:196-217).

:func:`detect_format1_batch` takes the host weights of
:func:`f1_batch_weights` (cyclic-shift phases with conj(base) folded in,
OCC weights): from the slot context, as the JAX conductor builds them, or
built here and cached per device.  :func:`f1_detect` is the K10 wrapper: on
CUDA tensors the hand kernel of csrc/pucch_f1.cu, on CPU tensors its twin
:func:`f1_detect_ref`.  :func:`detect_format1` (one user, host sequences)
and :func:`transmit_format1` (UE side) are plain, for tests and the UE
emulation.  Formats 0, 2, 3 and 4 are not ported (ROADMAP §1 item 13).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ... import kernels
from ...device import const, is_cuda
from ...kernels import _build
from ...ops.gold import gold_sequence_np
from ...ops.low_papr import base_sequence

KERNEL = kernels.register(kernels.Kernel(
    name="pucch_f1_detect", route="cuda",
    source="srsran_tpu_torch/csrc/pucch_f1.cu",
    replaces="srsran_tpu/phy/upper/pucch.py:325"))


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
            "pass the weights of f1_batch_weights (ROADMAP §1 item 11)")
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
