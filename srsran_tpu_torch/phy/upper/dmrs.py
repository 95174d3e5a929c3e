"""DM-RS for PDSCH/PUSCH (TS38.211 §7.4.1.1, §6.4.1.1).

Port of srsran_tpu/phy/upper/dmrs.py: QPSK Gold pilots of configuration
type 1 (a comb of 6 per PRB, ports 0-3) or type 2 (4 per PRB in CDM pairs,
ports 0-5) with per-port frequency/time covers, on a contiguous allocation
or, for type 1, on a scattered PRB set (RA type 0, interleaved VRBs): the
Gold sequence runs over the covering span at absolute positions and the
allocated PRBs' columns are selected (:func:`_prb_pilot_select`).  Pilot
base sequences are built on the host (:func:`pilot_values_for`) and
uploaded; the slot programs take either those values (the conductor's
slot context) or per-symbol c_init seeds.  The grid map runs as K26
(ops/dl_rs.py::dmrs_map) on the card.
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

# Type-1 CDM mapping for DM-RS ports 0..3:
# (cdm_group/delta, w_f over comb pair, w_t over symbol pair)
TYPE1_PORT_CONFIG = {
    0: (0, (+1, +1), (+1, +1)),
    1: (0, (+1, -1), (+1, +1)),
    2: (1, (+1, +1), (+1, +1)),
    3: (1, (+1, -1), (+1, +1)),
}

# Type-2 (TS38.211 Table 7.4.1.1.2-2): 3 CDM groups of adjacent RE pairs,
# group lambda occupies subcarriers {2λ, 2λ+1, 2λ+6, 2λ+7} per PRB (the
# comb of ops/dl_rs.py::_comb); ports 0..5 -> (group, w_f over the pair).
TYPE2_PORT_CONFIG = {
    0: (0, (+1, +1), (+1, +1)),
    1: (0, (+1, -1), (+1, +1)),
    2: (1, (+1, +1), (+1, +1)),
    3: (1, (+1, -1), (+1, +1)),
    4: (2, (+1, +1), (+1, +1)),
    5: (2, (+1, -1), (+1, +1)),
}


@dataclasses.dataclass(frozen=True)
class DmrsConfig:
    """Static DM-RS description for one PDSCH/PUSCH allocation."""

    rb_start: int
    rb_count: int
    symbols: tuple            # DM-RS symbol indices within the slot
    ports: tuple              # DM-RS port indices (0..3 type 1, 0..5 type 2)
    scrambling_id: int        # N_ID^{0/1}
    n_scid: int = 0
    config_type: int = 1      # DM-RS configuration type 1 or 2
    numerology: int = 0
    slot_in_frame: int = 0    # n_slot for c_init
    amplitude: float = 1.0    # beta_dmrs
    # Non-contiguous allocation (RA type 0 / interleaved VRB-PRB): sorted
    # absolute PRB tuple; overrides rb_start/rb_count for the comb
    # positions and the pilot selection.
    prbs: tuple | None = None

    @property
    def prb_list(self) -> tuple | range:
        """The allocation's sorted PRBs (K26's PRB table): ``prbs``, or
        the contiguous ``range``."""
        if self.prbs is not None:
            return tuple(sorted(self.prbs))
        return range(self.rb_start, self.rb_start + self.rb_count)


@functools.lru_cache(maxsize=8192)
def _prb_pilot_select_cached(prbs: tuple, per_rb: int):
    prbs = sorted(prbs)
    lo, hi = prbs[0], prbs[-1]
    span = per_rb * (hi - lo + 1)
    sel = np.concatenate([np.arange((p - lo) * per_rb,
                                    (p - lo + 1) * per_rb)
                          for p in prbs])
    return span, 2 * per_rb * lo, sel


def _prb_pilot_select(cfg: DmrsConfig, per_rb: int):
    """(gold span in pilots, advance, per-PRB column selector) for a
    possibly non-contiguous allocation: pilots are generated over the
    covering span [min_prb, max_prb] at the ABSOLUTE Gold positions and
    the allocated PRBs' columns selected (the sequence indexes by CRB).
    Type 2 on a PRB list raises AssertionError, as the JAX function does."""
    if cfg.prbs is None:
        return per_rb * cfg.rb_count, 2 * per_rb * cfg.rb_start, None
    assert cfg.config_type == 1, \
        "non-contiguous DM-RS allocations are implemented for type 1 only"
    return _prb_pilot_select_cached(tuple(cfg.prbs), per_rb)


def _c_init(scrambling_id: int, n_scid: int, slot_in_frame: int,
            symbol: int) -> int:
    return ((1 << 17) * (14 * slot_in_frame + symbol + 1)
            * (2 * scrambling_id + 1) + 2 * scrambling_id + n_scid) % (1 << 31)


def c_inits_for(cfg: DmrsConfig, slot_in_frame: int | None = None) -> np.ndarray:
    """Host-side per-DM-RS-symbol c_init values (uint32 [nof_dmrs_symbols])."""
    sif = cfg.slot_in_frame if slot_in_frame is None else slot_in_frame
    return np.array([_c_init(cfg.scrambling_id, cfg.n_scid, sif, l)
                     for l in cfg.symbols], dtype=np.uint32)


def _values_from_cinits(cfg: DmrsConfig, c_inits: tuple) -> np.ndarray:
    """QPSK base sequences [len(c_inits), per_rb * nof PRBs] (complex64),
    the Gold sequence advanced to the allocation's first PRB of a carrier
    starting at CRB 0; on a PRB list the span's sequence, the allocated
    PRBs' columns selected."""
    npilot, adv, sel = _prb_pilot_select(
        cfg, dl_rs.PILOTS_PER_PRB[cfg.config_type])
    rows = []
    for ci in c_inits:
        row = qpsk_np(gold_sequence_np(int(ci), 2 * npilot, advance=adv))
        rows.append(row if sel is None else row[sel])
    return (np.stack(rows, axis=0) * cfg.amplitude).astype(np.complex64)


@functools.lru_cache(maxsize=8192)
def pilot_values_for(cfg: DmrsConfig,
                     slot_in_frame: int | None = None) -> np.ndarray:
    """Host-side QPSK pilot base sequences [nsym, npilot] complex64 (the
    slot-context values the slot programs take in place of c_inits)."""
    seeds = tuple(int(c) for c in c_inits_for(cfg, slot_in_frame))
    return _values_from_cinits(cfg, seeds)


def sequence(cfg: DmrsConfig, symbol: int, c_init=None, *,
             device=None) -> torch.Tensor:
    """Base QPSK pilot sequence complex64 [per_rb * nof PRBs] of one DM-RS
    symbol (host-built, on ``device``, the CPU by default): the Gold
    sequence from ``c_init`` (default: the config's for ``symbol``)
    advanced to the allocation's first PRB, a PRB list's columns selected."""
    if c_init is None:
        c_init = _c_init(cfg.scrambling_id, cfg.n_scid, cfg.slot_in_frame,
                         symbol)
    return torch.from_numpy(_values_from_cinits(cfg, (int(c_init),))[0]).to(
        device or "cpu")


def type2_sc_indices(rb_start: int, rb_count: int, group: int) -> np.ndarray:
    """Subcarrier indices int32 of a type-2 CDM group (4 pilots per PRB:
    2 group, 2 group + 1, 2 group + 6, 2 group + 7)."""
    k0 = 12 * np.arange(rb_start, rb_start + rb_count)[:, None] + 2 * group
    return (k0 + np.array([0, 1, 6, 7])).reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _type1_sc_indices(rb_start: int, rb_count: int, delta: int,
                      prbs: tuple | None = None) -> np.ndarray:
    """Subcarrier indices of the comb for one CDM group."""
    if prbs is not None:
        return np.concatenate(
            [p * 12 + 2 * np.arange(6, dtype=np.int32) + delta
             for p in sorted(prbs)]).astype(np.int32)
    base = np.arange(rb_count * 6, dtype=np.int32)
    return (rb_start * 12 + 2 * base + delta).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _cover(config_type: int, port: int, nsym: int, npil: int) -> np.ndarray:
    """float32 [nsym, npil]: w_f over the pilot pair times w_t per symbol."""
    _, wf, wt = (TYPE1_PORT_CONFIG if config_type == 1
                 else TYPE2_PORT_CONFIG)[port]
    return (np.where(np.arange(npil) % 2 == 0, wf[0], wf[1])[None, :]
            * np.array([wt[i % 2] for i in range(nsym)],
                       np.float32)[:, None]).astype(np.float32)


def _is_values(c_inits) -> bool:
    return (isinstance(c_inits, torch.Tensor) and c_inits.ndim in (2, 3)
            and c_inits.is_complex())


def pilots_for_port(cfg: DmrsConfig, port: int, c_inits=None, *,
                    device: torch.device | str) -> torch.Tensor:
    """Dense pilot values [nsym, per_rb * nof PRBs] for one DM-RS port
    (w_f, w_t applied).

    c_inits: None (derive from the config), host c_init seeds
    [nof_dmrs_symbols] (numpy or a CPU tensor: they key the host-built
    pilot cache, so a seed read back from the card would sync every slot),
    or a complex tensor of pilot VALUES [nsym, npilot] (the slot context;
    its device wins over ``device``), or [B, nsym, npilot] for B slots at
    once.  ``device`` has no default: the pilots go where the caller says.
    """
    vals = base_values(cfg, c_inits, device=device)
    cover = const(_cover, cfg.config_type, port, vals.shape[-2],
                  vals.shape[-1], device=vals.device)
    return vals * cover


def base_values(cfg: DmrsConfig, c_inits=None, *,
                device: torch.device | str) -> torch.Tensor:
    """The base QPSK pilot sequences [nsym, per_rb * nof PRBs] (no covers),
    from the same sources as :func:`pilots_for_port`: the config, host
    c_init seeds, or pilot VALUES ([nsym, npilot] or [B, nsym, npilot], as
    given)."""
    if _is_values(c_inits):
        return c_inits
    if c_inits is None:
        return const(pilot_values_for, cfg, device=device)
    if isinstance(c_inits, torch.Tensor):
        if c_inits.device.type != "cpu":
            raise ValueError(
                "DM-RS c_init seeds must stay on the host (got a "
                f"{c_inits.device.type} tensor); pass pilot values to run "
                "from the device")
        c_inits = c_inits.numpy()
    seeds = tuple(int(c) for c in np.asarray(c_inits).reshape(-1))
    return const(_values_from_cinits, cfg, seeds, device=device)


def map_to_grid(grid: torch.Tensor, cfg: DmrsConfig,
                precoding: np.ndarray | torch.Tensor | None = None,
                c_inits=None, prg_matrices=None,
                prg_size: int = 0) -> torch.Tensor:
    """Add DM-RS for all ports into a [P, nsym, nsc] grid, in place (K26,
    ops/dl_rs.py::dmrs_map; its twin on CPU tensors).

    With ``precoding`` [P, L] (a host array, or a tensor on the grid's
    device) the per-layer pilots are precoded like data; without it layer
    l goes to port l.  With ``prg_matrices`` [G, P, L] (on the grid's
    device) and ``prg_size`` each pilot is precoded with its PRG's matrix,
    PRG boundaries aligned to CRB 0, the table's first PRG the one holding
    the allocation's first PRB, as the data's (JAX dmrs.py:222-226,
    pdsch.py:254-256).  Type 1 or 2, contiguous or on ``cfg.prbs`` (type 1;
    type 2 on a PRB list raises AssertionError, as in the JAX package).
    A leading slot axis on the grid ([B, P, nsym, nsc]) maps B slots in one
    launch, with the pilot values and matrices shared or [B, ...].
    """
    _prb_pilot_select(cfg, dl_rs.PILOTS_PER_PRB[cfg.config_type])  # asserts
    dev = grid.device
    if precoding is not None and not isinstance(precoding, torch.Tensor):
        precoding = torch.as_tensor(np.asarray(precoding)).to(dev)
    w = prg_matrices if prg_matrices is not None else precoding
    if w is not None:
        w = w.to(torch.complex64)
    vals = base_values(cfg, c_inits, device=dev)
    return dl_rs.dmrs_map(grid, vals, w, tuple(cfg.ports), tuple(cfg.symbols),
                          cfg.prb_list,
                          prg_size if prg_matrices is not None else 0,
                          cfg.config_type)
