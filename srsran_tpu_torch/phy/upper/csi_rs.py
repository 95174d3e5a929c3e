"""NZP-CSI-RS generator (TS38.211 §7.4.1.5).

Port of srsran_tpu/phy/upper/csi_rs.py: QPSK Gold pilots mapped per
TS38.211 Table 7.4.1.5.3-1 rows 1-18 with fd-CDM2 / CDM4-FD2-TD2 /
CDM8-FD2-TD4 covers, densities 3 / 1 / 0.5 (even/odd RB), and an optional
per-CSI-RS-port precoding matrix onto the physical antenna ports.  The
sequence values are built on the host (:func:`seq_values_for`, the
conductor's slot context); the grid map runs as K25 (ops/dl_rs.py::rs_map)
on the card, from :func:`csi_blocks`, which lists the REs, value indices
and weights (CDM cover x precoder entry) in the JAX function's emit order.
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

# CDM cover tables: per cdm index, (w_f over k'=0..1, w_t over l'=0..T-1).
_CDM_TABLES = {
    "no_CDM": ([[1.0]], [[1.0]]),
    "fd_CDM2": ([[1.0, 1.0], [1.0, -1.0]], [[1.0], [1.0]]),
    "cdm4_FD2_TD2": (
        [[1.0, 1.0], [1.0, -1.0], [1.0, 1.0], [1.0, -1.0]],
        [[1.0, 1.0], [1.0, 1.0], [1.0, -1.0], [1.0, -1.0]],
    ),
    "cdm8_FD2_TD4": (
        [[1.0, 1.0], [1.0, -1.0]] * 4,
        [[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0],
         [1.0, -1.0, 1.0, -1.0], [1.0, -1.0, 1.0, -1.0],
         [1.0, 1.0, -1.0, -1.0], [1.0, 1.0, -1.0, -1.0],
         [1.0, -1.0, -1.0, 1.0], [1.0, -1.0, -1.0, 1.0]],
    ),
}

# Row -> (nof_ports, cdm type, nof k_ref, allowed densities), default
# density first (TS38.211 Table 7.4.1.5.3-1).
_ROWS = {
    1: (1, "no_CDM", 1, ("three",)),
    2: (1, "no_CDM", 1, ("one", "dot5_even", "dot5_odd")),
    3: (2, "fd_CDM2", 1, ("one", "dot5_even", "dot5_odd")),
    4: (4, "fd_CDM2", 1, ("one",)),
    5: (4, "fd_CDM2", 1, ("one",)),
    6: (8, "fd_CDM2", 4, ("one",)),
    7: (8, "fd_CDM2", 2, ("one",)),
    8: (8, "cdm4_FD2_TD2", 2, ("one",)),
    9: (12, "fd_CDM2", 6, ("one",)),
    10: (12, "cdm4_FD2_TD2", 3, ("one",)),
    11: (16, "fd_CDM2", 4, ("one", "dot5_even", "dot5_odd")),
    12: (16, "cdm4_FD2_TD2", 4, ("one",)),
    13: (24, "fd_CDM2", 3, ("one", "dot5_even", "dot5_odd")),
    14: (24, "cdm4_FD2_TD2", 3, ("one", "dot5_even", "dot5_odd")),
    15: (24, "cdm8_FD2_TD4", 3, ("one", "dot5_even", "dot5_odd")),
    16: (32, "fd_CDM2", 4, ("one", "dot5_even", "dot5_odd")),
    17: (32, "cdm4_FD2_TD2", 4, ("one", "dot5_even", "dot5_odd")),
    18: (32, "cdm8_FD2_TD4", 4, ("one", "dot5_even", "dot5_odd")),
}


def nof_csi_rs_ports(row: int) -> int:
    return _ROWS[row][0]


@dataclasses.dataclass(frozen=True)
class CsiRsConfig:
    """Static NZP-CSI-RS description; same fields and defaults as the JAX
    package's CsiRsConfig."""

    row: int                  # 1..18
    rb_start: int
    rb_count: int
    symbol: int               # l0
    symbol2: int = -1         # l1, required by rows 13/14/16/17
    k0: int = 0               # first freq-domain allocation reference
    k_ref: tuple = ()         # all k references (defaults to (k0,))
    scrambling_id: int = 0
    density: str = ""         # "three"|"one"|"dot5_even"|"dot5_odd"; "" = row default
    slot_in_frame: int = 0
    amplitude: float = 1.0

    def resolved_k_ref(self) -> tuple:
        ks = tuple(self.k_ref) if self.k_ref else (self.k0,)
        _, _, nkref, _ = _ROWS[self.row]
        if len(ks) != nkref:
            raise ValueError(f"CSI-RS row {self.row} needs {nkref} k_ref values")
        return ks

    def resolved_density(self) -> str:
        dens = _ROWS[self.row][3]
        d = self.density or dens[0]
        if d not in dens:
            raise ValueError(f"CSI-RS row {self.row}: invalid density {d}")
        return d


@functools.lru_cache(maxsize=None)
def _cdm_groups(row: int, k_ref: tuple, l0: int, l1: int = -1):
    """[(k_bar, l_bar)] per CDM group + (cdm type, fd size, td size)."""
    _, cdm, _, _ = _ROWS[row]
    wf_tab, wt_tab = _CDM_TABLES[cdm]
    fd, td = len(wf_tab[0]), len(wt_tab[0])
    k = list(k_ref)
    if row in (13, 14, 16, 17) and l1 < 0:
        raise ValueError(f"CSI-RS row {row} requires symbol2 (l1)")
    if row in (1, 2, 3):
        groups = [(k[0], l0)]
    elif row == 4:
        groups = [(k[0], l0), (k[0] + 2, l0)]
    elif row == 5:
        groups = [(k[0], l0), (k[0], l0 + 1)]
    elif row in (6, 8, 9, 10, 12, 15, 18):
        groups = [(kr, l0) for kr in k]
    elif row == 7:
        groups = [(k[g % 2], l0 + g // 2) for g in range(4)]
    elif row == 11:
        groups = [(k[g % 4], l0 + g // 4) for g in range(8)]
    elif row in (13, 16):
        groups = [(kr, l) for l in (l0, l0 + 1, l1, l1 + 1) for kr in k]
    elif row in (14, 17):
        groups = [(kr, l) for l in (l0, l1) for kr in k]
    else:
        raise NotImplementedError(f"CSI-RS row {row}")
    return tuple(groups), cdm, fd, td


def _used_symbols(cfg: CsiRsConfig) -> list:
    groups, _, _, td = _cdm_groups(cfg.row, cfg.resolved_k_ref(), cfg.symbol,
                                   cfg.symbol2)
    return sorted({lb + lp for _, lb in groups for lp in range(td)})


def _used_rbs(cfg: CsiRsConfig) -> np.ndarray:
    """Occupied PRB indices."""
    d = cfg.resolved_density()
    rbs = np.arange(cfg.rb_start, cfg.rb_start + cfg.rb_count)
    if d == "dot5_even":
        return rbs[rbs % 2 == 0]
    if d == "dot5_odd":
        return rbs[rbs % 2 == 1]
    return rbs


def _seq_per_rb(cfg: CsiRsConfig) -> int:
    """QPSK sequence symbols consumed per occupied PRB."""
    if cfg.row == 1:
        return 3
    if cfg.row == 2:
        return 1
    return 2


def _nof_advance(cfg: CsiRsConfig) -> int:
    """Sequence symbols skipped before the first occupied PRB."""
    d = cfg.resolved_density()
    first_prb = cfg.rb_start
    if d == "dot5_even":
        first_prb += cfg.rb_start % 2
    elif d == "dot5_odd":
        first_prb += 1 - cfg.rb_start % 2
    if d == "three":
        return 3 * first_prb
    if d == "one":
        return first_prb if cfg.row == 2 else 2 * first_prb
    return first_prb // 2 if cfg.row == 2 else first_prb


def _c_init(cfg: CsiRsConfig, sif: int, l: int) -> int:
    return ((1 << 10) * (14 * sif + l + 1) * (2 * cfg.scrambling_id + 1)
            + cfg.scrambling_id) % (1 << 31)


def c_init_for(cfg: CsiRsConfig, slot_in_frame: int | None = None) -> np.ndarray:
    """Per-used-symbol Gold c_init values (a scalar array if one symbol)."""
    sif = cfg.slot_in_frame if slot_in_frame is None else slot_in_frame
    vals = [_c_init(cfg, sif, l) for l in _used_symbols(cfg)]
    if len(vals) == 1:
        return np.array(vals[0], dtype=np.uint32)
    return np.array(vals, dtype=np.uint32)


def _values_from_cinits(cfg: CsiRsConfig, cinits: tuple) -> np.ndarray:
    rbs = _used_rbs(cfg)
    spr = _seq_per_rb(cfg)
    adv = _nof_advance(cfg)
    rows = [qpsk_np(gold_sequence_np(int(ci), 2 * spr * len(rbs),
                                     advance=2 * adv)) for ci in cinits]
    return (np.stack(rows, axis=0) * cfg.amplitude).astype(np.complex64)


def seq_values_for(cfg: CsiRsConfig,
                   slot_in_frame: int | None = None) -> np.ndarray:
    """Host-side Gold/QPSK sequence VALUES [n_used_symbols, spr*n_used]
    complex64 (amplitude applied): the slot context of :func:`process`."""
    sif = cfg.slot_in_frame if slot_in_frame is None else slot_in_frame
    return _values_from_cinits(
        cfg, tuple(_c_init(cfg, sif, l) for l in _used_symbols(cfg)))


def _precoding_key(precoding, nof_csi_ports: int, nof_phys: int,
                   row: int) -> tuple:
    """The precoding matrix as a hashable tuple of complex rows (the
    identity prefix by default); raises where the row needs a matrix."""
    if precoding is None:
        if nof_csi_ports > nof_phys:
            raise ValueError(
                f"CSI-RS row {row}: {nof_csi_ports} CSI-RS ports > "
                f"{nof_phys} grid ports; pass a precoding matrix")
        precoding = np.eye(nof_csi_ports, nof_phys)
    m = np.asarray(precoding)
    if m.shape != (nof_csi_ports, nof_phys):
        raise ValueError(f"CSI-RS precoding {m.shape} vs {nof_csi_ports} "
                         f"CSI-RS ports x {nof_phys} grid ports")
    return tuple(tuple(complex(x) for x in r) for r in m)


def csi_blocks(cfg: CsiRsConfig, precoding: tuple) -> tuple:
    """K25 blocks of one NZP-CSI-RS (ops/dl_rs.py::rs_plan), in
    srsran_tpu/phy/upper/csi_rs.py::process's emit order: per CDM group,
    CDM index, symbol offset and frequency offset, every physical port with
    a non-zero precoder entry, weight = precoder entry x w_f x w_t."""
    k_ref = cfg.resolved_k_ref()
    groups, cdm, fd, td = _cdm_groups(cfg.row, k_ref, cfg.symbol, cfg.symbol2)
    wf_tab, wt_tab = _CDM_TABLES[cdm]
    syms = _used_symbols(cfg)
    rbs = _used_rbs(cfg)
    n_used = len(rbs)
    spr = _seq_per_rb(cfg)
    row_len = spr * n_used
    blocks = []

    def emit(csi_port, l, sc, m, cover):
        for p, w in enumerate(precoding[csi_port]):
            if w == 0.0:
                continue
            blocks.append((p, l, sc, syms.index(l) * row_len + m, w * cover))

    if cfg.row == 1:
        for j in range(3):
            emit(0, cfg.symbol, rbs * 12 + k_ref[0] + 4 * j,
                 np.arange(n_used) * 3 + j, 1.0)
    else:
        for g, (k_bar, l_bar) in enumerate(groups):
            for ci in range(len(wf_tab)):
                for lp in range(td):
                    for kp in range(fd):
                        emit(g * len(wf_tab) + ci, l_bar + lp,
                             rbs * 12 + k_bar + kp,
                             np.arange(n_used) * spr + kp,
                             wf_tab[ci][kp] * wt_tab[ci][lp])
    return (len(syms), row_len), tuple(blocks)


def csi_item(cfg: CsiRsConfig, nof_ports: int, c_init=None, precoding=None,
             *, device) -> tuple:
    """((blocks fn, args), values) of one CSI-RS for ops/dl_rs.py::rs_map."""
    k_ref = cfg.resolved_k_ref()
    groups, cdm, _, _ = _cdm_groups(cfg.row, k_ref, cfg.symbol, cfg.symbol2)
    nof_csi = len(groups) * len(_CDM_TABLES[cdm][0])
    pkey = _precoding_key(precoding, nof_csi, nof_ports, cfg.row)
    item = (csi_blocks, (dataclasses.replace(cfg, slot_in_frame=0), pkey))
    if isinstance(c_init, torch.Tensor) and c_init.is_complex():
        return item, c_init
    if c_init is None:
        return item, const(seq_values_for, cfg, device=device)
    if isinstance(c_init, torch.Tensor):
        if c_init.device.type != "cpu":
            raise ValueError("CSI-RS c_init seeds must stay on the host (got "
                             f"a {c_init.device.type} tensor); pass values to "
                             "run from the device")
        c_init = c_init.numpy()
    seeds = tuple(int(c) for c in np.asarray(c_init).reshape(-1))
    return item, const(_values_from_cinits, cfg, seeds, device=device)


def process(grid: torch.Tensor, cfg: CsiRsConfig, c_init=None,
            precoding: np.ndarray | None = None) -> torch.Tensor:
    """Map NZP-CSI-RS into a [P, nsym, nsc] grid (in place; K25).

    c_init: None, host c_init seeds (a scalar or [nof_used_symbols]), or the
    sequence values ([n_used_symbols, n] or [B, ...]).  ``precoding`` is a
    [nof_csi_ports, P] matrix onto the physical ports (identity prefix by
    default); rows with more CSI-RS ports than grid ports need one.
    """
    item, values = csi_item(cfg, grid.shape[-3], c_init, precoding,
                            device=grid.device)
    return dl_rs.rs_map(grid, (item,), (values,))
