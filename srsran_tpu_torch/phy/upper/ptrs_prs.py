"""PT-RS (phase tracking) and PRS (positioning) reference signals.

Port of srsran_tpu/phy/upper/ptrs_prs.py (TS38.211 §7.4.1.2: PDSCH PT-RS
rides on the PDSCH DM-RS sequence on a sparse time/frequency lattice;
§7.4.1.7: the DL positioning RS with its comb-N staggered pattern).  The
sequence values are built on the host (:func:`ptrs_values_for`,
:func:`prs_values_for`: the conductor's slot context), and the grid map
runs as K25 (ops/dl_rs.py::rs_map) on the card: :func:`ptrs_blocks` and
:func:`prs_blocks` describe the REs in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...device import const
from ...ops import dl_rs
from ...ops.gold import gold_sequence_np
from ...ops.modulation import qpsk_np


# ----------------------------------------------------------------- PT-RS

@dataclasses.dataclass(frozen=True)
class PtrsConfig:
    """PDSCH PT-RS (TS38.211 §7.4.1.2.2); same fields and defaults as the
    JAX package's PtrsConfig."""

    rb_start: int
    rb_count: int
    first_symbol: int
    nof_symbols: int
    dmrs_symbols: tuple
    time_density: int = 1      # L_PT-RS: 1, 2, 4
    freq_density: int = 2      # K_PT-RS: 2 or 4 (every K-th RB)
    re_offset: int = 0         # k_RE_ref
    port: int = 0
    scrambling_id: int = 0
    n_scid: int = 0
    slot_in_frame: int = 0
    amplitude: float = 1.0


@functools.lru_cache(maxsize=None)
def ptrs_positions(cfg: PtrsConfig) -> np.ndarray:
    """(symbol, subcarrier) PT-RS RE positions: every L-th PDSCH symbol,
    restarting after each DM-RS symbol; one RE every K_PT-RS RBs."""
    out = []
    rbs = np.arange(cfg.rb_start, cfg.rb_start + cfg.rb_count,
                    cfg.freq_density)
    since_ref = 0
    for l in range(cfg.first_symbol, cfg.first_symbol + cfg.nof_symbols):
        if l in cfg.dmrs_symbols:
            since_ref = 0
            continue
        if since_ref % cfg.time_density == 0:
            for rb in rbs:
                out.append((l, rb * 12 + cfg.re_offset))
        since_ref += 1
    return np.array(out, dtype=np.int32).reshape(-1, 2)


def ptrs_cinits_for(cfg: PtrsConfig, slot: int | None = None) -> np.ndarray:
    """Host-side DM-RS-sequence c_init per PT-RS symbol (sorted)."""
    sl = cfg.slot_in_frame if slot is None else slot
    pos = ptrs_positions(cfg)
    syms = sorted(set(pos[:, 0].tolist())) if len(pos) else []
    return np.array(
        [((1 << 17) * (14 * sl + l + 1) * (2 * cfg.scrambling_id + 1)
          + 2 * cfg.scrambling_id + cfg.n_scid) % (1 << 31) for l in syms],
        dtype=np.uint32)


def _ptrs_values(cfg: PtrsConfig, cinits: tuple) -> np.ndarray:
    pos = ptrs_positions(cfg)
    if len(pos) == 0:
        return np.zeros(0, np.complex64)
    out = []
    for i, l in enumerate(sorted(set(pos[:, 0].tolist()))):
        npil = 6 * (cfg.rb_start + cfg.rb_count)
        seq = qpsk_np(gold_sequence_np(int(cinits[i]), 2 * npil))
        sel = pos[pos[:, 0] == l]
        out.append(seq[3 * (sel[:, 1] // 12)])
    return (np.concatenate(out) * cfg.amplitude).astype(np.complex64)


def ptrs_values_for(cfg: PtrsConfig, slot: int | None = None) -> np.ndarray:
    """Host-side PT-RS VALUES [n_pos] complex64 in ptrs_positions order
    (the PRB's type-1 DM-RS pilot, index 3n for PRB n, times the
    amplitude)."""
    return _ptrs_values(cfg, tuple(int(c) for c in ptrs_cinits_for(cfg, slot)))


def ptrs_blocks(cfg: PtrsConfig) -> tuple:
    """K25 blocks of the PT-RS (ops/dl_rs.py::rs_plan): value i at
    ptrs_positions[i] on the PT-RS port."""
    pos = ptrs_positions(cfg)
    blocks = []
    for l in sorted(set(pos[:, 0].tolist())):
        sel = np.nonzero(pos[:, 0] == l)[0]
        blocks.append((cfg.port, l, pos[sel, 1], sel, 1.0))
    return (len(pos),), tuple(blocks)


def _plan_cfg(cfg):
    """The config with its slot-varying fields cleared (the RE plan does
    not depend on them)."""
    return dataclasses.replace(cfg, slot_in_frame=0)


def _values(cfg, cinits, host_values, host_from_seeds, device):
    """Values on ``device``: from the config (None), the slot context's
    complex values as given, or host c_init seeds (kept on the host)."""
    if isinstance(cinits, torch.Tensor) and cinits.is_complex():
        return cinits
    if cinits is None:
        return const(host_values, cfg, device=device)
    if isinstance(cinits, torch.Tensor):
        if cinits.device.type != "cpu":
            raise ValueError("c_init seeds must stay on the host (got a "
                             f"{cinits.device.type} tensor); pass values to "
                             "run from the device")
        cinits = cinits.numpy()
    seeds = tuple(int(c) for c in np.asarray(cinits).reshape(-1))
    return const(host_from_seeds, cfg, seeds, device=device)


def ptrs_item(cfg: PtrsConfig, cinits=None, *, device) -> tuple:
    """((blocks fn, args), values) of one PT-RS for ops/dl_rs.py::rs_map."""
    return ((ptrs_blocks, (_plan_cfg(cfg),)),
            _values(cfg, cinits, ptrs_values_for, _ptrs_values, device))


def map_ptrs(grid: torch.Tensor, cfg: PtrsConfig, cinits=None) -> torch.Tensor:
    """Add the PT-RS into the grid (in place; K25).  cinits: None, host
    c_init seeds per PT-RS symbol, or the values ([n] or [B, n])."""
    if len(ptrs_positions(cfg)) == 0:
        return grid
    item, values = ptrs_item(cfg, cinits, device=grid.device)
    return dl_rs.rs_map(grid, (item,), (values,))


# ------------------------------------------------------------------- PRS

@dataclasses.dataclass(frozen=True)
class PrsConfig:
    """DL positioning RS (TS38.211 §7.4.1.7); same fields and defaults as
    the JAX package's PrsConfig."""

    rb_start: int
    rb_count: int
    first_symbol: int
    nof_symbols: int           # 2,4,6,12
    comb_size: int             # 2,4,6,12
    comb_offset: int
    n_id_prs: int
    slot_in_frame: int = 0
    amplitude: float = 1.0


# TS38.211 Table 7.4.1.7.3-1: frequency offset per symbol for each comb size.
_PRS_SYMBOL_OFFSETS = {
    2: (0, 1),
    4: (0, 2, 1, 3),
    6: (0, 3, 1, 4, 2, 5),
    12: (0, 6, 3, 9, 1, 7, 4, 10, 2, 8, 5, 11),
}


def prs_cinits_for(cfg: PrsConfig, slot: int | None = None) -> np.ndarray:
    """Host-side per-symbol Gold c_init (TS38.211 §7.4.1.7.2)."""
    sl = cfg.slot_in_frame if slot is None else slot
    return np.array(
        [(((1 << 22) * (cfg.n_id_prs // 1024)
           + (1 << 10) * (14 * sl + cfg.first_symbol + i + 1)
           * (2 * (cfg.n_id_prs % 1024) + 1)
           + (cfg.n_id_prs % 1024)) % (1 << 31))
         for i in range(cfg.nof_symbols)], dtype=np.uint32)


def _prs_values(cfg: PrsConfig, cinits: tuple) -> np.ndarray:
    npil = cfg.rb_count * 12 // cfg.comb_size
    adv = 2 * (cfg.rb_start * 12 // cfg.comb_size)
    rows = [qpsk_np(gold_sequence_np(int(ci), 2 * npil, advance=adv))
            for ci in cinits]
    return (np.stack(rows, axis=0) * cfg.amplitude).astype(np.complex64)


def prs_values_for(cfg: PrsConfig, slot: int | None = None) -> np.ndarray:
    """Host-side PRS sequence VALUES [nsym, npil] complex64 (amplitude
    applied)."""
    return _prs_values(cfg, tuple(int(c) for c in prs_cinits_for(cfg, slot)))


def prs_blocks(cfg: PrsConfig) -> tuple:
    """K25 blocks of the PRS: symbol i's values on its staggered comb of
    port 0."""
    offsets = _PRS_SYMBOL_OFFSETS[cfg.comb_size]
    npil = cfg.rb_count * 12 // cfg.comb_size
    blocks = []
    for i in range(cfg.nof_symbols):
        k0 = (cfg.comb_offset + offsets[i % len(offsets)]) % cfg.comb_size
        sc = cfg.rb_start * 12 + k0 + cfg.comb_size * np.arange(npil)
        blocks.append((0, cfg.first_symbol + i, sc,
                       i * npil + np.arange(npil), 1.0))
    return (cfg.nof_symbols, npil), tuple(blocks)


def prs_item(cfg: PrsConfig, cinits=None, *, device) -> tuple:
    """((blocks fn, args), values) of one PRS for ops/dl_rs.py::rs_map."""
    return ((prs_blocks, (_plan_cfg(cfg),)),
            _values(cfg, cinits, prs_values_for, _prs_values, device))


def map_prs(grid: torch.Tensor, cfg: PrsConfig, cinits=None) -> torch.Tensor:
    """Add the PRS into port 0 of the grid (in place; K25).  cinits: None,
    host c_init seeds per symbol, or the values ([nsym, npil] or [B, ...])."""
    item, values = prs_item(cfg, cinits, device=grid.device)
    return dl_rs.rs_map(grid, (item,), (values,))
