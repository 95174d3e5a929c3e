"""PDSCH transmit chain (TS38.212 §7.2, TS38.211 §7.3.1).

Port of srsran_tpu/phy/upper/pdsch.py: TB CRC -> segmentation with CB
CRC24B -> LDPC encode (K5, ops/ldpc_encode.py::dlsch_encode) -> rate match
-> scramble -> modulate -> layer map -> precode -> grid add (K6,
ops/dl_map.py::pdsch_map; K22, its per-PRG form, when the PDU carries a
PrecodingConfig), then the DM-RS precoded like the data (K26,
ops/dl_rs.py::dmrs_map).  Every allocation of the JAX package runs:
contiguous, RA type 0 (``prbs``) and interleaved VRBs
(``vrb_prb_interleaved`` over ``bwp_size``), each resolved on the host to
one sorted PRB list (:func:`alloc_prbs`) that keys the data-RE plan, the
DM-RS comb and the PRG base (the first allocated PRB).  The data maps
around the PT-RS REs; the PT-RS itself, unprecoded on its port, is the DL
slot program's to map, with the slot's other RS PDUs in its one K25 launch
(phy/slot_programs.py).  On CPU tensors the kernels' plain twins run.  It
is the flagship DL slot's PDSCH and also the UE-side test transmitter of
the PUSCH receive path (the same chain blocks, as the JAX bench does).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...ran.ldpc_params import segment_tb, select_base_graph
from ...ran.precoding_codebooks import (PrecodingConfig, nof_prgs,
                                        resolve_matrices)
from ...ran.rb_allocation import allocated_prbs
from ...device import const
from ...ops import dl_map, ldpc_encode, ldpc_rate_match
from ...ops.modulation import BITS_PER_SYMBOL
from ...ops.precoding import identity_precoder
from .dmrs import DmrsConfig, map_to_grid as map_dmrs
from .ptrs_prs import PtrsConfig, ptrs_positions


@dataclasses.dataclass(frozen=True)
class PdschPtrs:
    """PT-RS parameters riding inside the PDSCH PDU."""

    time_density: int = 1
    freq_density: int = 2
    re_offset: int = 0
    port: int = 0


@dataclasses.dataclass(frozen=True)
class PdschConfig:
    """Static PDSCH PDU description (same fields and defaults as the JAX
    package's PdschConfig)."""

    rnti: int
    rb_start: int
    rb_count: int
    first_symbol: int
    nof_symbols: int
    modulation: str
    target_code_rate: float
    tbs: int
    nof_layers: int = 1
    rv: int = 0
    n_id: int = 0
    dmrs_symbols: tuple = (2,)
    dmrs_scrambling_id: int = 0
    n_scid: int = 0
    slot_in_frame: int = 0
    numerology: int = 0
    reserved_cdm_groups: int = 2
    ptrs: PdschPtrs | None = None
    precoding: PrecodingConfig | None = None
    prbs: tuple | None = None
    vrb_prb_interleaved: bool = False
    bwp_size: int | None = None


@functools.lru_cache(maxsize=4096)
def alloc_prbs(cfg) -> tuple | range:
    """The PDU's allocation as sorted absolute PRBs, resolved once per
    config: a tuple for an RA type 0 bitmap or interleaved VRBs over
    [0, bwp_size), a ``range`` for a contiguous one (and for a PUSCH
    config, which has no ``prbs``).  The plan key, the DM-RS PRB list and
    the PRG span all derive from it."""
    if (getattr(cfg, "prbs", None) is None
            and not getattr(cfg, "vrb_prb_interleaved", False)):
        return range(cfg.rb_start, cfg.rb_start + cfg.rb_count)
    return tuple(int(p) for p in allocated_prbs(
        cfg.rb_start, cfg.rb_count, cfg.prbs, cfg.vrb_prb_interleaved, 0,
        cfg.bwp_size))


def _plan_prbs_key(cfg) -> tuple | None:
    """The PRB tuple of a non-contiguous allocation; None for a contiguous
    one."""
    prbs = alloc_prbs(cfg)
    return None if isinstance(prbs, range) else prbs


def prg_span(cfg: PdschConfig) -> tuple:
    """(first PRB, PRB count) of the span the PDU's PRGs cover: from the
    first to the last allocated PRB (JAX fapi/validators.py:94-97)."""
    prbs = alloc_prbs(cfg)
    return (prbs[0], prbs[-1] - prbs[0] + 1) if prbs else (cfg.rb_start, 0)


def ptrs_config(cfg: PdschConfig) -> PtrsConfig | None:
    """The PDSCH's PT-RS (JAX pdsch.py:261-269), or None without PT-RS."""
    if cfg.ptrs is None:
        return None
    return PtrsConfig(
        rb_start=cfg.rb_start, rb_count=cfg.rb_count,
        first_symbol=cfg.first_symbol, nof_symbols=cfg.nof_symbols,
        dmrs_symbols=cfg.dmrs_symbols, time_density=cfg.ptrs.time_density,
        freq_density=cfg.ptrs.freq_density, re_offset=cfg.ptrs.re_offset,
        port=cfg.ptrs.port, scrambling_id=cfg.dmrs_scrambling_id,
        n_scid=cfg.n_scid, slot_in_frame=cfg.slot_in_frame)


@functools.lru_cache(maxsize=None)
def _data_re_plan(rb_start: int, rb_count: int, first_symbol: int,
                  nof_symbols: int, dmrs_symbols: tuple,
                  reserved_cdm_groups: int, ptrs=None,
                  prbs: tuple | None = None) -> np.ndarray:
    """(symbol, subcarrier) positions of data REs in mapping order:
    frequency-first within a symbol, symbols ascending; on DM-RS symbols the
    CDM groups without data are excluded, and PT-RS REs (when configured)
    on every layer -- data maps around them."""
    ptrs_re = set()
    if ptrs is not None:
        pos = ptrs_positions(PtrsConfig(
            rb_start=rb_start, rb_count=rb_count, first_symbol=first_symbol,
            nof_symbols=nof_symbols, dmrs_symbols=dmrs_symbols,
            time_density=ptrs.time_density, freq_density=ptrs.freq_density,
            re_offset=ptrs.re_offset, port=ptrs.port))
        ptrs_re = {(int(l), int(k)) for l, k in pos}
    out = []
    if prbs is not None:
        scs = np.concatenate([np.arange(p * 12, (p + 1) * 12)
                              for p in sorted(prbs)]).astype(np.int32)
    else:
        scs = np.arange(rb_start * 12, (rb_start + rb_count) * 12,
                        dtype=np.int32)
    for l in range(first_symbol, first_symbol + nof_symbols):
        if l in dmrs_symbols:
            if reserved_cdm_groups >= 2:
                continue
            keep = scs[scs % 2 == 1]
            out.extend((l, int(k)) for k in keep
                       if (l, int(k)) not in ptrs_re)
        else:
            out.extend((l, int(k)) for k in scs
                       if (l, int(k)) not in ptrs_re)
    return np.array(out, dtype=np.int32)


def data_re_plan_column(rb_start, rb_count, first_symbol, nof_symbols,
                        dmrs_symbols, reserved_cdm_groups, ptrs, prbs,
                        col: int):
    """One column of :func:`_data_re_plan` as int64 (0: symbol, 1: sc)."""
    return _data_re_plan(rb_start, rb_count, first_symbol, nof_symbols,
                         dmrs_symbols, reserved_cdm_groups, ptrs,
                         prbs)[:, col].astype(np.int64)


def plan_key(cfg) -> tuple:
    """The data-RE plan's key (a PUSCH config has no PT-RS and is
    contiguous)."""
    return (cfg.rb_start, cfg.rb_count, cfg.first_symbol, cfg.nof_symbols,
            tuple(cfg.dmrs_symbols), cfg.reserved_cdm_groups,
            getattr(cfg, "ptrs", None), _plan_prbs_key(cfg))


def nof_data_re(cfg: PdschConfig) -> int:
    return len(_data_re_plan(*plan_key(cfg)))


def _cb_rate_match_sizes(g_total: int, c: int, qm: int, nl: int) -> list:
    """TS38.212 §5.4.2.1 E_r distribution over codeblocks."""
    unit = nl * qm
    base = unit * (g_total // (unit * c))
    gamma = (g_total // unit) % c
    return [base if j < c - gamma else base + unit for j in range(c)]


def segmentation(cfg: PdschConfig):
    """The TB's segmentation (TS38.212 §5.2.2) for the PDU's TBS and rate."""
    return segment_tb(cfg.tbs, select_base_graph(cfg.tbs,
                                                 cfg.target_code_rate))


@functools.lru_cache(maxsize=4096)
def rate_match_sizes(cfg: PdschConfig) -> tuple:
    """The codeblocks' rate-matched lengths E_r for the PDU's allocation."""
    qm = BITS_PER_SYMBOL[cfg.modulation]
    g_total = nof_data_re(cfg) * qm * cfg.nof_layers
    return tuple(_cb_rate_match_sizes(g_total, segmentation(cfg).nof_codeblocks,
                                      qm, cfg.nof_layers))


def encode_transport_block(payload_bits: torch.Tensor, cfg: PdschConfig):
    """TB bits [tbs] -> rate-matched codeword bits int8 [G], SegmentParams."""
    seg = segmentation(cfg)
    z = seg.lifting_size
    cbs = ldpc_encode.dlsch_encode(payload_bits, seg.base_graph)  # [C, N]
    codeword = ldpc_rate_match.rate_match_batch(
        cbs, rate_match_sizes(cfg), cfg.rv, BITS_PER_SYMBOL[cfg.modulation],
        seg.base_graph, z, seg.cb_info_bits, seg.full_block_bits)  # [G]
    return codeword, seg


def prg_index_of_sc(sc: np.ndarray, rb_start: int, prg_size: int
                    ) -> np.ndarray:
    """Per-subcarrier PRG index (into the PDU's pm_indices), PRG boundaries
    aligned to CRB 0 (TS38.214 §5.1.2.3); host."""
    return (np.asarray(sc) // 12 // prg_size
            - rb_start // prg_size).astype(np.int32)


def dmrs_config(cfg: PdschConfig) -> DmrsConfig:
    return DmrsConfig(
        rb_start=cfg.rb_start, rb_count=cfg.rb_count, symbols=cfg.dmrs_symbols,
        ports=tuple(range(cfg.nof_layers)), scrambling_id=cfg.dmrs_scrambling_id,
        n_scid=cfg.n_scid, numerology=cfg.numerology,
        slot_in_frame=cfg.slot_in_frame, prbs=_plan_prbs_key(cfg))


def pm_matrices_for(nof_ports: int, cfg: PdschConfig, device) -> torch.Tensor:
    """The PDU's per-PRG matrices [G, P, L] resolved through the codebook
    repository, uploaded once per (ports, PrecodingConfig, device): the
    conductor's "pm" slot context."""
    return const(resolve_matrices, nof_ports, cfg.precoding, device=device,
                 dtype=torch.complex64)


def process(grid: torch.Tensor, payload_bits: torch.Tensor, cfg: PdschConfig,
            precoding: np.ndarray | None = None,
            dmrs_cinits=None, pm_matrices=None) -> torch.Tensor:
    """Run the PDSCH chain into a [P, nsym, nsc] resource grid (in place).

    dmrs_cinits: optional per-DM-RS-symbol c_init seeds or pilot values
    (slot context).  precoding: [P, L] matrix; default the identity
    mapping, uploaded once per device.
    pm_matrices: the per-PRG matrices [G, P, L] when cfg.precoding is set
    (the conductor's "pm" slot context; default resolved here through the
    codebook repository), so a PMI change is a new context tensor, never a
    new program; the G PRGs cover the allocation's span from its first
    PRB, and a subcarrier's PRG counts from that PRB's (JAX
    pdsch.py:239-258).  The data maps around the PT-RS REs of
    ``cfg.ptrs``; the PT-RS values are the DL slot program's to map (every
    RS of a slot in one K25 launch, after the PDSCHs, in the JAX package's
    order).
    With a slot axis -- grid [B, P, nsym, nsc], payload_bits [B, TBS], pilot
    values [B, nsym, npilot] or shared, PRG matrices [B, G, P, L] or shared
    -- K5, K6 and K26 run once for all slots.
    """
    nof_ports = grid.shape[-3]
    prg_size = 0
    base_prb = prg_span(cfg)[0]
    if cfg.precoding is not None:
        prg_size = cfg.precoding.prg_size
        w = (pm_matrices_for(nof_ports, cfg, grid.device)
             if pm_matrices is None else pm_matrices)
        g = nof_prgs(*prg_span(cfg), prg_size)
        if w.shape[-3:] != (g, nof_ports, cfg.nof_layers):
            raise ValueError(f"PRG matrices {tuple(w.shape)} vs {g} PRGs of "
                             f"{nof_ports} ports x {cfg.nof_layers} layers")
    elif precoding is None:
        w = identity(nof_ports, cfg.nof_layers, grid.device)
    else:
        w = torch.as_tensor(np.asarray(precoding)).to(grid.device,
                                                      torch.complex64)
    cbs = ldpc_encode.dlsch_encode(payload_bits,                   # K5
                                   segmentation(cfg).base_graph)
    dl_map.pdsch_map(*map_args(grid, cfg, cbs, w),                 # K6 / K22
                     prg_size=prg_size, rb_start=base_prb)
    map_dmrs(grid, dmrs_config(cfg), None if prg_size else w,     # K26
             dmrs_cinits, prg_matrices=w if prg_size else None,
             prg_size=prg_size)
    return grid


def identity(nof_ports: int, nof_layers: int, device) -> torch.Tensor:
    """The default port mapping as a complex64 [P, L] tensor on ``device``
    (uploaded once)."""
    return const(identity_precoder, nof_ports, nof_layers, device=device,
                 dtype=torch.complex64)


def map_args(grid: torch.Tensor, cfg: PdschConfig, cbs: torch.Tensor,
             precoder: torch.Tensor) -> tuple:
    """The arguments of ops/dl_map.py::pdsch_map for this PDSCH's encoded
    codeblocks ``cbs`` [C, N] on ``grid`` (its data-RE plan as int32
    device constants)."""
    seg = segmentation(cfg)
    dev = grid.device
    key = plan_key(cfg)
    return (grid, cbs, rate_match_sizes(cfg), cfg.rv, cfg.modulation,
            seg.base_graph, seg.lifting_size, seg.cb_info_bits,
            seg.full_block_bits, (cfg.rnti << 15) + cfg.n_id, cfg.nof_layers,
            const(data_re_plan_column, *key, 0, device=dev, dtype=torch.int32),
            const(data_re_plan_column, *key, 1, device=dev, dtype=torch.int32),
            precoder)
