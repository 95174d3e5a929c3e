"""DM-RS for PDSCH/PUSCH, configuration type 1 (TS38.211 §7.4.1.1, §6.4.1.1).

Port of srsran_tpu/phy/upper/dmrs.py for contiguous type-1 allocations:
QPSK Gold pilots on a comb with per-port frequency/time covers.  Pilot
base sequences are built on the host (:func:`pilot_values_for`) and
uploaded; the slot programs take either those values (the conductor's
slot context) or per-symbol c_init seeds.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...device import const
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


@dataclasses.dataclass(frozen=True)
class DmrsConfig:
    """Static DM-RS description for one PDSCH/PUSCH allocation."""

    rb_start: int
    rb_count: int
    symbols: tuple            # DM-RS symbol indices within the slot
    ports: tuple              # DM-RS port indices (0..3, type 1)
    scrambling_id: int        # N_ID^{0/1}
    n_scid: int = 0
    config_type: int = 1      # DM-RS configuration type 1 or 2
    numerology: int = 0
    slot_in_frame: int = 0    # n_slot for c_init
    amplitude: float = 1.0    # beta_dmrs
    prbs: tuple | None = None


def _check_supported(cfg: DmrsConfig) -> None:
    if cfg.config_type != 1:
        raise NotImplementedError(
            "DM-RS type 2 is not ported yet (ROADMAP §1 item 13)")
    if cfg.prbs is not None:
        raise NotImplementedError(
            "non-contiguous (RA type 0) DM-RS is not ported yet "
            "(ROADMAP §1 item 13)")


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
    """QPSK base sequences [len(c_inits), 6 * rb_count] (complex64), the
    Gold sequence advanced to PRB rb_start of a carrier starting at CRB 0."""
    npilot = 6 * cfg.rb_count
    rows = [qpsk_np(gold_sequence_np(int(ci), 2 * npilot,
                                     advance=12 * cfg.rb_start))
            for ci in c_inits]
    return (np.stack(rows, axis=0) * cfg.amplitude).astype(np.complex64)


@functools.lru_cache(maxsize=8192)
def pilot_values_for(cfg: DmrsConfig,
                     slot_in_frame: int | None = None) -> np.ndarray:
    """Host-side QPSK pilot base sequences [nsym, npilot] complex64 (the
    slot-context values the slot programs take in place of c_inits)."""
    _check_supported(cfg)
    seeds = tuple(int(c) for c in c_inits_for(cfg, slot_in_frame))
    return _values_from_cinits(cfg, seeds)


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


def _sc_long(rb_start: int, rb_count: int, delta: int) -> np.ndarray:
    return _type1_sc_indices(rb_start, rb_count, delta).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _cover(port: int, nsym: int, npil: int) -> np.ndarray:
    """float32 [nsym, npil]: w_f over the comb pair times w_t per symbol."""
    _, wf, wt = TYPE1_PORT_CONFIG[port]
    return (np.where(np.arange(npil) % 2 == 0, wf[0], wf[1])[None, :]
            * np.array([wt[i % 2] for i in range(nsym)],
                       np.float32)[:, None]).astype(np.float32)


def _is_values(c_inits) -> bool:
    return (isinstance(c_inits, torch.Tensor) and c_inits.ndim in (2, 3)
            and c_inits.is_complex())


def pilots_for_port(cfg: DmrsConfig, port: int, c_inits=None, *,
                    device: torch.device | str) -> torch.Tensor:
    """Dense pilot values [nsym, 6*rb_count] for one DM-RS port (w_f, w_t
    applied).

    c_inits: None (derive from the config), host c_init seeds
    [nof_dmrs_symbols] (numpy or a CPU tensor: they key the host-built
    pilot cache, so a seed read back from the card would sync every slot),
    or a complex tensor of pilot VALUES [nsym, npilot] (the slot context;
    its device wins over ``device``), or [B, nsym, npilot] for B slots at
    once.  ``device`` has no default: the pilots go where the caller says.
    """
    _check_supported(cfg)
    if _is_values(c_inits):
        vals = c_inits
    elif c_inits is None:
        vals = const(pilot_values_for, cfg, device=device)
    else:
        if isinstance(c_inits, torch.Tensor):
            if c_inits.device.type != "cpu":
                raise ValueError(
                    "DM-RS c_init seeds must stay on the host (got a "
                    f"{c_inits.device.type} tensor); pass pilot values to "
                    "run from the device")
            c_inits = c_inits.numpy()
        seeds = tuple(int(c) for c in np.asarray(c_inits).reshape(-1))
        vals = const(_values_from_cinits, cfg, seeds, device=device)
    cover = const(_cover, port, vals.shape[-2], vals.shape[-1],
                  device=vals.device)
    return vals * cover


def map_to_grid(grid: torch.Tensor, cfg: DmrsConfig,
                precoding: np.ndarray | torch.Tensor | None = None,
                c_inits=None) -> torch.Tensor:
    """Add DM-RS for all ports into a [P, nsym, nsc] grid, in place.

    With ``precoding`` [P, L] (a host array, or a tensor on the grid's
    device) the per-layer pilots are precoded like data.
    """
    dev = grid.device
    if precoding is not None and not isinstance(precoding, torch.Tensor):
        precoding = torch.as_tensor(np.asarray(precoding)).to(dev)
    for li, dmrs_port in enumerate(cfg.ports):
        delta = TYPE1_PORT_CONFIG[dmrs_port][0]
        sc = const(_sc_long, cfg.rb_start, cfg.rb_count, delta, device=dev)
        pilots = pilots_for_port(cfg, dmrs_port, c_inits, device=dev)
        if precoding is None:
            for si, l in enumerate(cfg.symbols):
                grid[li, l, sc] += pilots[si]
        else:
            w = precoding[:, li].to(grid.dtype)
            for si, l in enumerate(cfg.symbols):
                grid[:, l, sc] += w[:, None] * pilots[si][None, :]
    return grid
