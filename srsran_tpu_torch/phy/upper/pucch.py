"""PUCCH formats 0 to 4: receive and transmit (TS38.211 §6.3.2).

Port of srsran_tpu/phy/upper/pucch.py:

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
- F3/F4 (:func:`process_format3`, DFT-s-OFDM): the low-PAPR DM-RS
  estimate through K8 at stride 1 (the full-rate RC filter), then per data
  symbol the port combining, IDFT, F4 OCC despread, QPSK or pi/2-BPSK
  demap and descrambling of the K19 wrapper :func:`f3_demap`
  (csrc/dft_s_ofdm.cu, twin :func:`f3_demap_ref`), then the UCI decode;
  with a slot axis each of them once for all slots.

:func:`detect_format1` (one user, host sequences), :func:`transmit_format0`,
:func:`transmit_format1`, :func:`transmit_format2` and :func:`f3_encode`
(UE side) are plain, for tests and the UE emulation, but for their UCI
encode: short blocks through K34, polar codes through K33
(``short_block.encode``, ``polar.encode_chain``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ... import kernels
from ...device import const, f32, is_cuda, slot_of, stack_slots
from ...kernels import _build
from ...ops import channel_estimate as chest
from ...ops import polar as polar_ops
from ...ops import short_block
from ...ops.crc import crc
from ...ops.gold import gold_sequence_np, gold_words
from ...ops.low_papr import base_sequence
from ...ops.modulation import (demodulate, modulate, pam_levels_scaled,
                               qpsk_np)
from ...ops.scrambling import descramble_llrs, scramble_bits
from ...ops.transform_precode import (deprecode, fft_plan, precode,
                                     twiddle_table)
from ...ops.ul_demap import demap_scalars, demap_threads
from ...ran import polar_params
from . import uci as uci_codec

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
KERNEL_BATCH = kernels.batched(KERNEL)
KERNEL_F0_BATCH = kernels.batched(KERNEL_F0)
KERNEL_F2_BATCH = kernels.batched(KERNEL_F2)
KERNEL_F3 = kernels.register(kernels.Kernel(
    name="pucch_f3_demap", route="cuda",
    source="srsran_tpu_torch/csrc/dft_s_ofdm.cu",
    replaces="srsran_tpu/phy/upper/pucch.py:656"))
KERNEL_F3_BATCH = kernels.batched(KERNEL_F3)


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


def _f1_slot_weights(weights: tuple, b: int) -> tuple:
    """Slot ``b``'s per-hop weights (each array shared or [B, ...])."""
    return tuple(tuple(slot_of(w, b, 3 if j < 2 else 2)
                       for j, w in enumerate(hop)) for hop in weights)


def f1_detect_ref(grid: torch.Tensor, common: PucchF1Config, weights: tuple,
                  threshold: float) -> tuple:
    """Plain twin of :func:`f1_detect` (a slot axis runs slot by slot)."""
    if grid.ndim == 4:
        return stack_slots([f1_detect_ref(grid[b], common,
                                          _f1_slot_weights(weights, b),
                                          threshold)
                            for b in range(grid.shape[0])])
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


@functools.lru_cache(maxsize=256)
def _f1_hop_fields(prb: int, start_symbol: int, nof_symbols: int,
                   second_hop_prb) -> tuple:
    """K10's by-value geometry of an occasion (what the kernel reads of
    its :class:`PucchF1Config`, not the slot): per hop (prb, first grid
    symbol, symbols, first symbol relative to the allocation, DM-RS
    symbols (at least 1), index of its first symbol among both hops')."""
    cfg = PucchF1Config(prb=prb, start_symbol=start_symbol,
                        nof_symbols=nof_symbols, initial_cyclic_shift=0,
                        time_domain_occ=0, n_id=0,
                        second_hop_prb=second_hop_prb)
    out, first = [], 0
    for hop_prb, s0, nsym in _f1_hops(cfg):
        out.append((hop_prb, start_symbol + s0, nsym, s0,
                    max(len(_split(s0, nsym)[0]), 1), first))
        first += nsym
    return tuple(out)


def _f1_params(shapes: tuple, dtypes: tuple, hops: tuple,
               threshold: float) -> _build.F1Params:
    """K10's parameters for one call signature: the shapes and dtypes of
    the grid and of the weights (a_dm, ph, w_da of each hop) and the hops
    of :func:`_f1_hop_fields`; raises on what the kernel does not take."""
    grid_s, weights_s = shapes[0], shapes[1:]
    if dtypes[0] != torch.complex64 or len(grid_s) not in (3, 4):
        raise ValueError(f"grid must be complex64 [(B,) P, S, K], got "
                         f"{dtypes[0]} {tuple(grid_s)}")
    if len(weights_s) != 3 * len(hops) or any(
            d != torch.complex64 for d in dtypes[1:]):
        raise ValueError("F1 weights must be complex64 (a_dm, ph, w_da) "
                         f"for each of the {len(hops)} hops")
    lead = tuple(grid_s[:-3])
    p, s_grid, k_grid = grid_s[-3:]
    u = weights_s[0][-3] if len(weights_s[0]) >= 3 else 0
    nsym = sum(h[2] for h in hops)
    if not 0 < p <= _build.F1_MAX_PORTS:
        raise ValueError(f"{p} rx ports: K10 takes 1 to "
                         f"{_build.F1_MAX_PORTS} ports")
    if not 0 < u <= _build.F1_MAX_USERS:
        raise ValueError(f"{u} users: K10 takes 1 to "
                         f"{_build.F1_MAX_USERS} users an occasion")
    if nsym > _build.F1_MAX_SYMBOLS:
        raise ValueError(f"{nsym} symbols: K10 takes at most "
                         f"{_build.F1_MAX_SYMBOLS} symbols an occasion")
    slots = lead[0] if lead else 1
    if max(slots * p * s_grid * k_grid, slots * u * nsym * 12) >= 1 << 31:
        raise ValueError("K10 takes at most 2^31 elements a grid or a "
                         "weight array (32-bit offsets)")
    stacked = 0
    for i, (prb, l_lo, ns, _, _, _) in enumerate(hops):
        if l_lo + ns > s_grid or 12 * (prb + 1) > k_grid:
            raise ValueError(f"hop {i} (PRB {prb}, symbols {l_lo}-"
                             f"{l_lo + ns - 1}) lies outside the grid "
                             f"{tuple(grid_s)}")
        want = ((u, ns, 12), (u, ns, 12), (u, ns))
        for j, shape in enumerate(want):
            w = tuple(weights_s[3 * i + j])
            if (w[len(w) - len(shape):] != shape
                    or w[:len(w) - len(shape)] not in ((), lead)):
                raise ValueError(f"hop {i}: weight {j} {w} does not fit "
                                 f"{u} users, {ns} symbols")
            stacked |= int(len(w) > len(shape)) << (3 * i + j)
    out = _build.F1Params(
        slots=slots, U=u, P=p, nhops=len(hops), nsym=nsym, S=s_grid,
        K=k_grid, stacked=stacked,
        n_data=sum(h[2] - len(_split(h[3], h[2])[0]) for h in hops),
        threads=-(-8 * nsym // 32) * 32, threshold=threshold)
    for i, h in enumerate(hops):
        out.hop[i] = _build.F1Hop(*h)
    return out


@functools.lru_cache(maxsize=1024)
def _f1_plan(shapes: tuple, dtypes: tuple, hops: tuple, threshold: float,
             index: int) -> tuple:
    """K10's launch for one call signature on CUDA device ``index`` and
    the shape of its outputs: [(B,) U]."""
    p = _f1_params(shapes, dtypes, hops, threshold)
    return (_build.Launch("srsran_pucch_f1", index, p),
            tuple(shapes[0][:-3]) + (p.U,))


def f1_detect(grid: torch.Tensor, common: PucchF1Config, weights: tuple,
              threshold: float) -> tuple:
    """(detected bool [U], metric f32 [U], bits int8 [U, 2], symbol
    complex64 [U]) of the users of one F1 occasion, from the grid
    (complex64 [P, nsym, nsc]) and the per-hop weights of
    :func:`f1_batch_weights` as tensors on the grid's device.  K10 reads
    a_dm on the DM-RS symbols only and ph on the data symbols only; the
    twin sums a_dm over every symbol of the hop, so the two agree for
    weights whose a_dm is zero on the data symbols, as
    :func:`f1_batch_weights` makes them.

    B slots at once: grid [B, P, nsym, nsc] and each weight array shared or
    with a leading slot axis give every result a leading slot axis, in one
    launch.  On the card: K10 through the cached plan of the call's
    signature (keyed on the occasion's geometry, not its slot)."""
    flat = [w for hop in weights for w in hop]
    if not (grid.is_cuda and all([w.is_cuda for w in flat])):
        is_cuda(grid, *flat)                                 # raises on a mix
        return f1_detect_ref(grid, common, weights, threshold)
    launch, shape = _f1_plan(
        (grid.shape, *[w.shape for w in flat]),
        (grid.dtype, *[w.dtype for w in flat]),
        _f1_hop_fields(common.prb, common.start_symbol, common.nof_symbols,
                       common.second_hop_prb),
        float(threshold), grid.get_device())
    # the kernel's inputs held in locals until it is enqueued; hop 1's
    # pointers repeat hop 0's without hopping
    g = grid if grid.is_contiguous() else grid.contiguous()
    ws = [w if w.is_contiguous() else w.contiguous() for w in flat]
    ptrs = [w.data_ptr() for w in ws]
    if len(ptrs) == 3:
        ptrs += ptrs
    detected = g.new_empty(shape, dtype=torch.bool)
    metric = g.new_empty(shape, dtype=torch.float32)
    bits = g.new_empty(shape + (2,), dtype=torch.int8)
    d_hat = g.new_empty(shape)
    launch(g.data_ptr(), *ptrs, detected.data_ptr(), metric.data_ptr(),
           bits.data_ptr(), d_hat.data_ptr())
    (KERNEL_BATCH if len(shape) == 2 else KERNEL).count()
    return detected, metric, bits, d_hat


def detect_format1_batch(grid: torch.Tensor, common: PucchF1Config,
                         users: tuple, threshold: float = 1.5, ncs=None):
    """Batch-detect all users multiplexed on one occasion.

    users: tuple of (initial_cyclic_shift, time_domain_occ, nof_harq_bits).
    ncs: None (weights built on the host for ``common.slot`` and cached per
    device) or the per-hop weight tuple of :func:`f1_batch_weights` as
    tensors (the slot context; each shared or [B, ...] with a slot axis on
    the grid).  Returns a list of per-user result dicts (detected, metric,
    harq_bits, symbol; each with the grid's slot axis) in the order given.
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
            "pass the weights of f1_batch_weights (ROADMAP §3)")
    detected, metric, bits, d_hat = f1_detect(grid, common, weights,
                                              threshold)
    return [{"detected": detected[..., ui], "metric": metric[..., ui],
             "harq_bits": bits[..., ui, :nbits], "symbol": d_hat[..., ui]}
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
    dictionary has none), then its HARQ bits; raises where no dictionary
    has that key."""
    key = (nof_harq_bits, sr_opportunity)
    if key not in _F0_TABLES:
        raise ValueError(
            "pucch_f0: nof_harq_bits=0 requires sr_opportunity=True "
            "(an F0 occasion must carry HARQ bits, SR, or both)")
    table = _F0_TABLES[key]
    return np.array([[s if s is not None else 0, *h] for _, s, h in table],
                    dtype=np.int8).reshape(len(table), 1 + nof_harq_bits)


def f0_detect_ref(grid: torch.Tensor, cfg: PucchF0Config,
                  refs: torch.Tensor, threshold: float) -> tuple:
    """Plain twin of :func:`f0_detect` (a slot axis runs slot by slot)."""
    if grid.ndim == 4:
        return stack_slots([f0_detect_ref(grid[b], cfg, slot_of(refs, b, 3),
                                          threshold)
                            for b in range(grid.shape[0])])
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


def _f0_fields(cfg: PucchF0Config) -> tuple:
    """What K12 reads of an F0 occasion (not its slot or hopping id: the
    references carry them): (prb, start_symbol, nof_symbols,
    second_hop_prb, nof_harq_bits, sr_opportunity)."""
    return (cfg.prb, cfg.start_symbol, cfg.nof_symbols, cfg.second_hop_prb,
            cfg.nof_harq_bits, cfg.sr_opportunity)


def _f0_params(shapes: tuple, dtypes: tuple, fields: tuple,
               threshold: float) -> _build.F0Params:
    """K12's parameters for one call signature: the shapes and dtypes of
    the grid and the references and the occasion's :func:`_f0_fields`;
    raises on what the kernel does not take."""
    prb, start, nsym, hop, nb, sr_opp = fields
    maps = _f0_maps(nb, sr_opp)
    grid_s, refs_s = shapes
    if dtypes[0] != torch.complex64 or len(grid_s) not in (3, 4):
        raise ValueError(f"grid must be complex64 [(B,) P, S, K], got "
                         f"{dtypes[0]} {tuple(grid_s)}")
    lead = tuple(grid_s[:-3])
    p, s_grid, k_grid = grid_s[-3:]
    c = maps.shape[0]
    if (dtypes[1] != torch.complex64 or tuple(refs_s[-3:]) != (c, nsym, 12)
            or tuple(refs_s[:-3]) not in ((), lead)):
        raise ValueError(f"refs must be complex64 [(B,) {c}, {nsym}, 12], "
                         f"got {dtypes[1]} {tuple(refs_s)}")
    if not 0 < p <= _build.F0_MAX_PORTS:
        raise ValueError(f"{p} rx ports: K12 takes 1 to "
                         f"{_build.F0_MAX_PORTS} ports")
    if nsym not in (1, 2):
        raise ValueError(f"{nsym} symbols: K12 takes 1 or 2 symbols")
    prb1 = hop if nsym > 1 and hop is not None else prb
    if start + nsym > s_grid or 12 * (max(prb, prb1) + 1) > k_grid:
        raise ValueError(f"the F0 occasion (PRB {prb}, {prb1}, symbols "
                         f"{start}-{start + nsym - 1}) lies outside the grid "
                         f"{tuple(grid_s)}")
    slots = lead[0] if lead else 1
    if slots * p * s_grid * k_grid >= 1 << 31:
        raise ValueError("K12 takes at most 2^31 elements a grid (32-bit "
                         "offsets)")
    lg = (p * nsym - 1).bit_length()
    word = 0
    for i, v in enumerate(maps.ravel().tolist()):
        word |= int(v) << i
    return _build.F0Params(
        slots=slots, P=p, S=nsym, C=c, nb=nb, lg=lg,
        passes=-(-(c << lg) // 32), nsym=s_grid, nsc=k_grid, l0=start,
        sc0=12 * prb, sc1=12 * prb1,
        refs_stride=c * nsym * 12 if len(refs_s) == 4 else 0, maps=word,
        threshold=threshold)


@functools.lru_cache(maxsize=1024)
def _f0_plan(shapes: tuple, dtypes: tuple, fields: tuple, threshold: float,
             index: int) -> tuple:
    """K12's launch for one call signature on CUDA device ``index``, the
    slot axis of its outputs and the SR/HARQ row's length."""
    p = _f0_params(shapes, dtypes, fields, threshold)
    return (_build.Launch("srsran_pucch_f0", index, p),
            tuple(shapes[0][:-3]), 1 + p.nb)


def f0_detect(grid: torch.Tensor, cfg: PucchF0Config, refs: torch.Tensor,
              threshold: float) -> tuple:
    """(detected bool, metric f32, HARQ bits int8 [nof_harq_bits], SR bit
    int8, best candidate int64) of one F0 occasion, from the grid
    (complex64 [P, nsym, nsc]) and the candidates' references (complex64
    [C, S, 12], :func:`f0_refs_for`) on the grid's device.

    B slots at once: grid [B, P, nsym, nsc] and the references shared or
    [B, C, S, 12] give every result a leading slot axis, in one launch.
    On the card: K12 through the cached plan of the call's signature
    (keyed on the occasion's geometry and dictionary, not its slot)."""
    if not (grid.is_cuda and refs.is_cuda):
        is_cuda(grid, refs)                                  # raises on a mix
        return f0_detect_ref(grid, cfg, refs, threshold)
    launch, lead, row = _f0_plan((grid.shape, refs.shape),
                                 (grid.dtype, refs.dtype), _f0_fields(cfg),
                                 float(threshold), grid.get_device())
    # the kernel's inputs held in locals until it is enqueued
    g = grid if grid.is_contiguous() else grid.contiguous()
    r = refs if refs.is_contiguous() else refs.contiguous()
    detected = g.new_empty(lead, dtype=torch.bool)
    metric = g.new_empty(lead, dtype=torch.float32)
    out = g.new_empty(lead + (row,), dtype=torch.int8)
    best = g.new_empty(lead, dtype=torch.int64)
    launch(g.data_ptr(), r.data_ptr(), detected.data_ptr(),
           metric.data_ptr(), out.data_ptr(), best.data_ptr())
    (KERNEL_F0_BATCH if lead else KERNEL_F0).count()
    return (detected, metric, out.narrow(-1, 1, row - 1), out.select(-1, 0),
            best)


def detect_format0(grid: torch.Tensor, cfg: PucchF0Config,
                   threshold: float = 4.0, ncs=None) -> dict:
    """Detect HARQ/SR on PUCCH F0 (pucch_detector_format0.cpp:118-235).

    ncs: None (references built on the host for ``cfg.slot`` and cached per
    device) or the candidates' references as a complex tensor (the slot
    context, :func:`f0_refs_for`; shared or [B, ...] with a slot axis on the
    grid).  Returns the JAX package's dict: detected, metric, harq_bits,
    sr_bit, best_mcs_index (each with the grid's slot axis).
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
    stride 3, RC-filter smoothing, no CFO, 30 kHz); pilots [S, 4*nof_rb],
    or [B, S, 4*nof_rb] for a grid with a slot axis."""
    _, dmrs_sc = _f2_sc(cfg.rb_start, cfg.nof_rb)
    args = (grid, tuple(range(cfg.start_symbol,
                              cfg.start_symbol + cfg.nof_symbols)),
            cfg.rb_start * 12, pilots.unsqueeze(-3),
            dmrs_sc - cfg.rb_start * 12,
            12 * cfg.nof_rb, cfg.nof_symbols, 30e3)
    return args, dict(stride=3, smoothing="filter", estimate_cfo=False)


def f2_demap_ref(grid: torch.Tensor, coeffs: torch.Tensor,
                 noise_var: torch.Tensor, cfg: PucchF2Config) -> torch.Tensor:
    """Plain twin of :func:`f2_demap` (a slot axis runs slot by slot)."""
    if grid.ndim == 4:
        return stack_slots([f2_demap_ref(grid[b], coeffs[b], noise_var[b],
                                         cfg) for b in range(grid.shape[0])])
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


def _f2_params(shapes: tuple, dtypes: tuple,
               pdu: tuple) -> _build.F2DemapParams:
    """K13's parameters for one call signature: the shapes and dtypes of
    (grid, coeffs, noise_var) and what the kernel reads of the PDU, ``pdu``
    = (c_init, rb_start, nof_rb, start_symbol, nof_symbols) (not its slot:
    the data scrambling does not depend on it); raises on what the kernel
    does not take."""
    c_init, rb_start, nof_rb, start_symbol, nof_symbols = pdu
    grid_s, coeffs_s, noise_s = shapes
    p, nsc = grid_s[-3], 12 * nof_rb
    if dtypes[0] != torch.complex64 or len(grid_s) not in (3, 4):
        raise ValueError(f"grid must be complex64 [(B,) P, S, K], got "
                         f"{dtypes[0]} {tuple(grid_s)}")
    lead = tuple(grid_s[:-3])
    if dtypes[1] != torch.complex64 or tuple(coeffs_s) != lead + (p, 1, 1,
                                                                  nsc):
        raise ValueError(f"coeffs must be complex64 {lead + (p, 1, 1, nsc)}, "
                         f"got {dtypes[1]} {tuple(coeffs_s)}")
    if dtypes[2] != torch.float32 or tuple(noise_s) != lead + (p,):
        raise ValueError(f"noise_var must be float32 {lead + (p,)}")
    if not 0 < p <= _build.F2_MAX_PORTS:
        raise ValueError(f"{p} rx ports: K13 takes 1 to "
                         f"{_build.F2_MAX_PORTS} ports")
    n_bits = 16 * nof_rb * nof_symbols
    max_bits = 32 * (_build.F2_GOLD_WORDS - 1)
    if not 0 < n_bits <= max_bits or nof_symbols not in (1, 2):
        raise ValueError(f"an F2 PDU of {nof_rb} RB x {nof_symbols} "
                         f"symbols has {n_bits} bits: K13 takes 1 or 2 "
                         f"symbols and at most {max_bits} bits")
    if (start_symbol + nof_symbols > grid_s[-2]
            or 12 * (rb_start + nof_rb) > grid_s[-1]):
        raise ValueError(f"the PDU lies outside the grid {tuple(grid_s)}")
    if math.prod(grid_s) >= 1 << 31:
        raise ValueError("K13 takes at most 2^31 elements a grid (32-bit "
                         "offsets)")
    out = _build.F2DemapParams(
        slots=lead[0] if lead else 1, P=p, S=grid_s[-2], K=grid_s[-1],
        nd=8 * nof_rb, nsym=nof_symbols, l0=start_symbol, sc0=12 * rb_start,
        nsc=nsc, threads=-(-n_bits // 2 // 32) * 32,
        level=float(pam_levels_scaled("qpsk")[0]))
    words = gold_words(c_init, n_bits)
    out.gold[:len(words)] = words.view(np.uint32).tolist()
    return out


@functools.lru_cache(maxsize=1024)
def _f2_plan(shapes: tuple, dtypes: tuple, pdu: tuple, index: int) -> tuple:
    """K13's launch for one call signature on CUDA device ``index`` and
    its output's shape."""
    p = _f2_params(shapes, dtypes, pdu)
    return (_build.Launch("srsran_pucch_f2_demap", index, p),
            tuple(shapes[0][:-3]) + (2 * p.nsym * p.nd,))


def f2_demap(grid: torch.Tensor, coeffs: torch.Tensor,
             noise_var: torch.Tensor, cfg: PucchF2Config) -> torch.Tensor:
    """Descrambled QPSK LLRs f32 [16 * nof_rb * nof_symbols] of one F2
    PDU: per data RE, maximum-ratio combining over the rx ports with the
    channel estimate (``coeffs`` complex64 [P, 1, 1, 12 * nof_rb], K8's),
    the post-combining noise (mean of ``noise_var`` [P] over the combined
    energy), max-log QPSK and the Gold descramble.  B slots at once: grid
    [B, P, nsym, nsc], coeffs [B, P, 1, 1, 12 * nof_rb] and noise_var
    [B, P] give LLRs [B, ...], in one launch.  On the card: K13 through the
    cached plan of the call's signature (keyed on the PDU's c_init and
    allocation, not its slot)."""
    if not (grid.is_cuda and coeffs.is_cuda and noise_var.is_cuda):
        is_cuda(grid, coeffs, noise_var)                     # raises on a mix
        return f2_demap_ref(grid, coeffs, noise_var, cfg)
    launch, shape = _f2_plan(
        (grid.shape, coeffs.shape, noise_var.shape),
        (grid.dtype, coeffs.dtype, noise_var.dtype),
        (_f2_c_init(cfg), cfg.rb_start, cfg.nof_rb, cfg.start_symbol,
         cfg.nof_symbols), grid.get_device())
    # the kernel's inputs held in locals until it is enqueued
    g = grid if grid.is_contiguous() else grid.contiguous()
    h = coeffs if coeffs.is_contiguous() else coeffs.contiguous()
    nv = noise_var if noise_var.is_contiguous() else noise_var.contiguous()
    llr = nv.new_empty(shape)
    launch(g.data_ptr(), h.data_ptr(), nv.data_ptr(), llr.data_ptr())
    (KERNEL_F2_BATCH if len(shape) == 2 else KERNEL_F2).count()
    return llr


def process_format2(grid: torch.Tensor, cfg: PucchF2Config,
                    dmrs_cinits=None) -> dict:
    """F2 receive: comb-3 DM-RS estimate through the port channel
    estimator (K8), combine + demap + descramble (K13), UCI decode (K14 up
    to 11 bits, else K15).  dmrs_cinits: None, host c_init seeds, or the
    pilot values [S, 4*nof_rb] (the slot context).  Returns the JAX
    package's dict: uci_bits, valid, metric.

    B slots at once: grid [B, P, nsym, nsc] and the pilot values shared or
    [B, S, 4*nof_rb] run K8, K13 and the decoder once for the B slots and
    give every value a leading slot axis."""
    pilots = _f2_pilots(cfg, dmrs_cinits, grid.device)
    args, kw = f2_estimate_args(grid, cfg, pilots)
    est = chest.estimate_from_grid(*args, **kw)
    llr = f2_demap(grid, est.coeffs, est.noise_var, cfg)[..., None, :]
    k = cfg.nof_uci_bits
    if k <= 11:
        bits, metric = short_block.detect(llr, k, 2)
        return {"uci_bits": bits[..., 0, :], "valid": metric[..., 0] > 0.5,
                "metric": metric[..., 0]}
    code, crc_len = _f2_polar_cfg(k, llr.shape[-1])
    dec, ok = polar_ops.decode(llr, code, f"crc{crc_len}")
    return {"uci_bits": dec[..., 0, :k], "valid": ok[..., 0],
            "metric": const(f32, (1.0,), device=grid.device)[0].expand(
                ok.shape[:-1])}


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
        enc = polar_ops.encode_chain(with_crc, code)[0]
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


# ------------------------------------------------------------- Format 3 / 4

# TS38.211 Table 6.4.1.3.3.2-1: DM-RS symbol positions within the PUCCH
# (no frequency hopping, no additional DM-RS).
_F34_DMRS_POS = {4: (1,), 5: (0, 3), 6: (1, 4), 7: (1, 4), 8: (1, 5),
                 9: (1, 6), 10: (2, 7), 11: (2, 7), 12: (2, 8), 13: (2, 9),
                 14: (3, 10)}


@dataclasses.dataclass(frozen=True)
class PucchF3Config:
    """Format 3 (and 4 via occ_length > 1): DFT-s-OFDM UCI carrier (same
    fields and defaults as the JAX package's PucchF3Config)."""

    rb_start: int
    nof_rb: int                # F4: must be 1
    start_symbol: int
    nof_symbols: int           # 4..14
    rnti: int
    n_id: int                  # data scrambling
    n_id_hopping: int          # group hopping id for DM-RS sequences
    nof_uci_bits: int
    slot: int = 0
    pi2_bpsk: bool = False
    occ_length: int = 1        # 1 (F3) | 2 | 4 (F4)
    occ_index: int = 0


def _f3_dmrs_seq(cfg: PucchF3Config, l: int,
                 slot: int | None = None) -> np.ndarray:
    """Low-PAPR DM-RS across the allocation for symbol ``l`` of ``slot``
    (default ``cfg.slot``; host)."""
    m = cfg.nof_rb * 12
    ncs = _ncs_table(cfg.n_id_hopping, cfg.slot if slot is None else slot)[l]
    alpha = 2 * np.pi / 12 * (ncs % 12)
    return (np.exp(1j * alpha * np.arange(m))
            * base_sequence(cfg.n_id_hopping % 30, 0, m)).astype(np.complex64)


def _f3_symbol_split(cfg: PucchF3Config):
    dmrs_rel = _F34_DMRS_POS[cfg.nof_symbols]
    data_rel = tuple(s for s in range(cfg.nof_symbols) if s not in dmrs_rel)
    return dmrs_rel, data_rel


def _f3_qm(cfg: PucchF3Config) -> int:
    return 1 if cfg.pi2_bpsk else 2


def _f3_scheme(cfg: PucchF3Config) -> str:
    return "pi2bpsk" if cfg.pi2_bpsk else "qpsk"


def _f3_c_init(cfg: PucchF3Config) -> int:
    return (cfg.rnti << 15) + cfg.n_id


def _f3_occ(occ_length: int, occ_index: int) -> np.ndarray:
    """The F4 pre-DFT block-spreading cover (TS38.211 §6.3.2.6.3)."""
    return np.exp(2j * np.pi * occ_index * np.arange(occ_length)
                  / occ_length).astype(np.complex64)


def _f3_occ_conj(occ_length: int, occ_index: int) -> np.ndarray:
    return np.conj(_f3_occ(occ_length, occ_index))


def _f3_data_symbols(cfg: PucchF3Config) -> np.ndarray:
    """Absolute symbols of the data (int32 [n_data])."""
    return np.array([cfg.start_symbol + s for s in _f3_symbol_split(cfg)[1]],
                    np.int32)


def f3_encode(uci_bits, cfg: PucchF3Config) -> torch.Tensor:
    """UE-side F3/F4 TX -> [nof_symbols, M] RE values (tests / UE
    emulation), on the device of ``uci_bits`` (a tensor) or the CPU."""
    bits = torch.as_tensor(uci_bits).to(torch.int8)
    dev = bits.device
    m = cfg.nof_rb * 12
    dmrs_rel, data_rel = _f3_symbol_split(cfg)
    qm = _f3_qm(cfg)
    m_data = m // cfg.occ_length
    e = len(data_rel) * m_data * qm
    coded = uci_codec.encode_uci(bits, e, qm)
    scr = scramble_bits(coded[None], _f3_c_init(cfg))
    syms = modulate(scr, _f3_scheme(cfg))[0]
    out = torch.zeros((cfg.nof_symbols, m), dtype=torch.complex64, device=dev)
    occ = _f3_occ(cfg.occ_length, cfg.occ_index)
    for i, s in enumerate(data_rel):
        blk = syms[i * m_data:(i + 1) * m_data]
        if cfg.occ_length > 1:
            blk = torch.cat([blk * complex(occ[j])
                             for j in range(cfg.occ_length)])
        out[s] = precode(blk)
    for s in dmrs_rel:
        out[s] = torch.as_tensor(_f3_dmrs_seq(cfg, cfg.start_symbol + s),
                                 device=dev)
    return out


def transmit_format3(grid: torch.Tensor, cfg: PucchF3Config,
                     bits) -> torch.Tensor:
    """UE-side PUCCH F3/F4 (:func:`f3_encode`) into port 0 of a [P, nsym,
    nsc] grid (a copy)."""
    tx = f3_encode(torch.as_tensor(np.atleast_1d(np.asarray(bits))).to(
        grid.device), cfg)
    out = grid.clone()
    sc0 = cfg.rb_start * 12
    out[0, cfg.start_symbol:cfg.start_symbol + cfg.nof_symbols,
        sc0:sc0 + tx.shape[1]] += tx
    return out


def f3_dmrs_values_for(cfg: PucchF3Config,
                       slot: int | None = None) -> np.ndarray:
    """Host-side F3/F4 DM-RS sequences [n_dmrs_symbols, M] complex64 in
    _f3_symbol_split order (the conductor's slot context for F3/F4)."""
    dmrs_rel, _ = _f3_symbol_split(cfg)
    return np.stack([_f3_dmrs_seq(cfg, cfg.start_symbol + s, slot)
                     for s in dmrs_rel], axis=0)


def _f3_pilots(cfg: PucchF3Config, ncs, device) -> torch.Tensor:
    """The DM-RS values [Sd, M]: from the slot context (a complex tensor)
    or built on the host for ``cfg.slot`` and cached per device."""
    if ncs is None:
        return const(f3_dmrs_values_for, cfg, device=device)
    if isinstance(ncs, torch.Tensor) and ncs.is_complex():
        return ncs
    raise NotImplementedError(
        "PUCCH F3/F4 from an n_cs table in the slot context is not ported; "
        "pass the values of f3_dmrs_values_for")


def f3_estimate_args(grid: torch.Tensor, cfg: PucchF3Config,
                     pilots: torch.Tensor) -> tuple:
    """(args, kwargs) of ``chest.estimate_from_grid`` for the DM-RS of one
    F3/F4 PDU: every subcarrier a pilot (stride 1, the full-rate RC
    filter), no CFO, 30 kHz, as the JAX package runs it; pilots [Sd, M],
    or [B, Sd, M] for a grid with a slot axis."""
    dmrs_rel, _ = _f3_symbol_split(cfg)
    m = 12 * cfg.nof_rb
    args = (grid, tuple(cfg.start_symbol + s for s in dmrs_rel),
            cfg.rb_start * 12, pilots.unsqueeze(-3), np.arange(m), m,
            cfg.nof_symbols, 30e3)
    return args, dict(stride=1, smoothing="filter", estimate_cfo=False)


def f3_demap_ref(grid: torch.Tensor, coeffs: torch.Tensor,
                 noise_var: torch.Tensor, cfg: PucchF3Config) -> torch.Tensor:
    """Plain twin of :func:`f3_demap` (the JAX package's steps; a slot axis
    runs slot by slot)."""
    if grid.ndim == 4:
        return stack_slots([f3_demap_ref(grid[b], coeffs[b], noise_var[b],
                                         cfg) for b in range(grid.shape[0])])
    m = cfg.nof_rb * 12
    sc0 = cfg.rb_start * 12
    _, data_rel = _f3_symbol_split(cfg)
    h_use = coeffs[:, 0, 0]                                  # [P, M]
    noise = torch.mean(noise_var)
    m_data = m // cfg.occ_length
    occ_conj = const(_f3_occ_conj, cfg.occ_length, cfg.occ_index,
                     device=grid.device)
    parts = []
    for s in data_rel:
        rx = grid[:, cfg.start_symbol + s, sc0:sc0 + m]
        corr = torch.sum(h_use.conj() * rx, dim=0)
        energy = torch.sum(h_use.abs() ** 2, dim=0)
        eq = corr / (energy + noise)
        nv = noise / torch.clamp_min(torch.mean(energy), 1e-12)
        x = deprecode(eq)
        if cfg.occ_length > 1:
            blocks = x.reshape(cfg.occ_length, m_data)
            x = torch.sum(blocks * occ_conj[:, None], dim=0) / cfg.occ_length
        parts.append(demodulate(x[None], nv.expand(x.shape)[None],
                                _f3_scheme(cfg))[0])
    llr = torch.cat(parts)
    return descramble_llrs(llr[None], _f3_c_init(cfg))[0]


def _f3_params(shapes: tuple, dtypes: tuple,
               cfg: PucchF3Config) -> _build.F3DemapParams:
    """K19's parameters for one call signature: the shapes and dtypes of
    (grid, coeffs, noise_var) and the PDU's configuration; raises on what
    the kernel does not take."""
    grid_s, coeffs_s, noise_s = shapes
    p, m = grid_s[-3], 12 * cfg.nof_rb
    if dtypes[0] != torch.complex64 or len(grid_s) not in (3, 4):
        raise ValueError(f"grid must be complex64 [(B,) P, S, K], got "
                         f"{dtypes[0]} {tuple(grid_s)}")
    lead = tuple(grid_s[:-3])
    if dtypes[1] != torch.complex64 or tuple(coeffs_s) != lead + (p, 1, 1, m):
        raise ValueError(f"coeffs must be complex64 {lead + (p, 1, 1, m)}, "
                         f"got {dtypes[1]} {tuple(coeffs_s)}")
    if (dtypes[2] != torch.float32 or tuple(noise_s) != lead + (p,)
            or not 0 < p <= _build.DEMAP_MAX_NOISE):
        raise ValueError(f"noise_var must be float32 {lead + (p,)}, at most "
                         f"{_build.DEMAP_MAX_NOISE} ports")
    if m % cfg.occ_length or cfg.occ_length > _build.F3_MAX_OCC:
        raise ValueError(f"occ_length {cfg.occ_length} for {m} subcarriers")
    syms = _f3_data_symbols(cfg)
    if not 1 <= len(syms) <= _build.F3_MAX_DATA_SYMBOLS:
        raise ValueError(f"{len(syms)} data symbols")
    kind, _, levels, two_scale = demap_scalars(_f3_scheme(cfg))
    out = _build.F3DemapParams(
        fft=fft_plan(m), nslots=lead[0] if lead else 1, P=p, S=grid_s[-2],
        K=grid_s[-1], sc0=cfg.rb_start * 12, n_data=len(syms),
        occ_len=cfg.occ_length, kind=kind, threads=demap_threads(m),
        gold_stride=_f3_gold_rows(cfg).shape[1], two_scale=two_scale)
    out.data_syms[:len(syms)] = syms.tolist()
    occ = _f3_occ_conj(cfg.occ_length, cfg.occ_index)
    out.occ_conj[:2 * len(occ)] = np.stack([occ.real, occ.imag], -1).reshape(
        -1).tolist()
    out.levels[:len(levels)] = levels.tolist()
    return out


def _f3_gold_rows(cfg: PucchF3Config) -> np.ndarray:
    """K19's Gold bits, uint8 [n_data, stride]: each data symbol's M /
    occ_length * Qm bits of the PDU's sequence in a row padded with zeros
    to a multiple of 4 bytes (the kernel copies its row in 4-byte words)."""
    n_data = len(_f3_symbol_split(cfg)[1])
    row = 12 * cfg.nof_rb // cfg.occ_length * _f3_qm(cfg)
    bits = gold_sequence_np(_f3_c_init(cfg), n_data * row)
    out = np.zeros((n_data, -(-row // 4) * 4), np.uint8)
    out[:, :row] = bits.reshape(n_data, row)
    return out


@functools.lru_cache(maxsize=1024)
def _f3_plan(shapes: tuple, dtypes: tuple, cfg: PucchF3Config,
             index: int) -> tuple:
    """K19's launch for one call signature on CUDA device ``index`` and
    its output's shape."""
    p = _f3_params(shapes, dtypes, cfg)
    seq = const(_f3_gold_rows, cfg, device=torch.device("cuda", index))
    launch = _build.Launch("srsran_pucch_f3_demap", index, p,
                           (twiddle_table(p.fft.M, index), seq))
    n = p.n_data * p.fft.M // p.occ_len * _f3_qm(cfg)
    return launch, tuple(shapes[0][:-3]) + (n,)


def f3_demap(grid: torch.Tensor, coeffs: torch.Tensor,
             noise_var: torch.Tensor, cfg: PucchF3Config) -> torch.Tensor:
    """Descrambled LLRs f32 [n_data * M / occ_length * Qm] of one F3/F4
    PDU: per data symbol, the combining corr / (energy + noise) over the rx
    ports with the channel estimate (``coeffs`` complex64 [P, 1, 1, M],
    K8's) and the mean estimator noise of ``noise_var`` [P], the unitary
    IDFT, the F4 OCC despread, max-log QPSK or pi/2-BPSK at noise / mean
    energy, and the Gold descramble.  B slots at once: grid [B, P, nsym,
    nsc], coeffs [B, P, 1, 1, M] and noise_var [B, P] give LLRs [B, ...],
    in one launch.  On the card: K19 through the cached plan of the call's
    signature."""
    if not (grid.is_cuda and coeffs.is_cuda and noise_var.is_cuda):
        is_cuda(grid, coeffs, noise_var)                     # raises on a mix
        return f3_demap_ref(grid, coeffs, noise_var, cfg)
    launch, shape = _f3_plan((grid.shape, coeffs.shape, noise_var.shape),
                             (grid.dtype, coeffs.dtype, noise_var.dtype),
                             cfg, grid.get_device())
    # the kernel's inputs held in locals until it is enqueued
    g = grid if grid.is_contiguous() else grid.contiguous()
    h = coeffs if coeffs.is_contiguous() else coeffs.contiguous()
    nv = noise_var if noise_var.is_contiguous() else noise_var.contiguous()
    llr = nv.new_empty(shape)
    launch(g.data_ptr(), h.data_ptr(), nv.data_ptr(), llr.data_ptr())
    (KERNEL_F3_BATCH if len(shape) == 2 else KERNEL_F3).count()
    return llr


def process_format3(grid: torch.Tensor, cfg: PucchF3Config, ncs=None) -> dict:
    """F3/F4 receive: the DM-RS estimate through the port channel
    estimator (K8 at stride 1), combine + IDFT + despread + demap +
    descramble (K19), UCI decode (K14 up to 11 bits, else K15).  ncs: None
    or the DM-RS values [Sd, M] of :func:`f3_dmrs_values_for` (the slot
    context).  Returns the JAX package's dict: uci_bits, valid, metric.

    B slots at once: grid [B, P, nsym, nsc] and the DM-RS values shared or
    [B, Sd, M] run K8, K19 and the decoder once for the B slots and give
    every value a leading slot axis."""
    pilots = _f3_pilots(cfg, ncs, grid.device)
    args, kw = f3_estimate_args(grid, cfg, pilots)
    est = chest.estimate_from_grid(*args, **kw)
    llr = f3_demap(grid, est.coeffs, est.noise_var, cfg)
    bits, ok, metric = uci_codec.decode_uci(llr, cfg.nof_uci_bits,
                                            _f3_qm(cfg))
    return {"uci_bits": bits, "valid": ok, "metric": metric}
