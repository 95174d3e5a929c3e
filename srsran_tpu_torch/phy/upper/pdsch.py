"""PDSCH transmit chain (TS38.212 §7.2, TS38.211 §7.3.1).

Port of srsran_tpu/phy/upper/pdsch.py for contiguous allocations with the
identity port mapping: TB CRC -> segmentation with CB CRC24B -> LDPC encode
(K5, ops/ldpc_encode.py::dlsch_encode) -> rate match -> scramble ->
modulate -> layer map -> precode -> grid add (K6, ops/dl_map.py::
pdsch_map), then type-1 DM-RS (plain).  On CPU tensors the kernels' plain
twins run.  It is the flagship DL slot's PDSCH and also the UE-side test
transmitter of the PUSCH receive path (the same chain blocks, as the JAX
bench does).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...ran.ldpc_params import segment_tb, select_base_graph
from ...ran.precoding_codebooks import PrecodingConfig
from ...device import const
from ...ops import dl_map, ldpc_encode, ldpc_rate_match
from ...ops.modulation import BITS_PER_SYMBOL
from ...ops.precoding import identity_precoder
from .dmrs import DmrsConfig, map_to_grid as map_dmrs


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


def check_supported(cfg: PdschConfig) -> None:
    """Raise for PDU options this slice does not port."""
    if cfg.ptrs is not None:
        raise NotImplementedError("PT-RS is not ported yet (ROADMAP §1 item 13)")
    if cfg.precoding is not None:
        raise NotImplementedError(
            "per-PRG precoding is not ported yet (ROADMAP §1 item 8)")
    if cfg.prbs is not None or cfg.vrb_prb_interleaved:
        raise NotImplementedError(
            "RA type 0 / interleaved VRB allocations are not ported yet "
            "(ROADMAP §1 item 13)")


@functools.lru_cache(maxsize=None)
def _data_re_plan(rb_start: int, rb_count: int, first_symbol: int,
                  nof_symbols: int, dmrs_symbols: tuple,
                  reserved_cdm_groups: int, ptrs=None,
                  prbs: tuple | None = None) -> np.ndarray:
    """(symbol, subcarrier) positions of data REs in mapping order:
    frequency-first within a symbol, symbols ascending; on DM-RS symbols the
    CDM groups without data are excluded."""
    if ptrs is not None:
        raise NotImplementedError("PT-RS is not ported yet (ROADMAP §1 item 13)")
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
            out.extend((l, int(k)) for k in scs[scs % 2 == 1])
        else:
            out.extend((l, int(k)) for k in scs)
    return np.array(out, dtype=np.int32)


def data_re_plan_column(rb_start, rb_count, first_symbol, nof_symbols,
                        dmrs_symbols, reserved_cdm_groups, col: int):
    """One column of :func:`_data_re_plan` as int64 (0: symbol, 1: sc)."""
    return _data_re_plan(rb_start, rb_count, first_symbol, nof_symbols,
                         dmrs_symbols, reserved_cdm_groups)[:, col].astype(np.int64)


def plan_key(cfg) -> tuple:
    return (cfg.rb_start, cfg.rb_count, cfg.first_symbol, cfg.nof_symbols,
            tuple(cfg.dmrs_symbols), cfg.reserved_cdm_groups)


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


def dmrs_config(cfg: PdschConfig) -> DmrsConfig:
    return DmrsConfig(
        rb_start=cfg.rb_start, rb_count=cfg.rb_count, symbols=cfg.dmrs_symbols,
        ports=tuple(range(cfg.nof_layers)), scrambling_id=cfg.dmrs_scrambling_id,
        n_scid=cfg.n_scid, numerology=cfg.numerology,
        slot_in_frame=cfg.slot_in_frame)


def process(grid: torch.Tensor, payload_bits: torch.Tensor, cfg: PdschConfig,
            precoding: np.ndarray | None = None,
            dmrs_cinits=None) -> torch.Tensor:
    """Run the PDSCH chain into a [P, nsym, nsc] resource grid (in place).

    dmrs_cinits: optional per-DM-RS-symbol c_init seeds or pilot values
    (slot context).  precoding: [P, L] matrix; default the identity mapping,
    uploaded once per device.  With a slot axis -- grid [B, P, nsym, nsc],
    payload_bits [B, TBS], pilot values [B, nsym, npilot] or shared -- K5
    and K6 run once for all slots and the DM-RS map once per slot.
    """
    check_supported(cfg)
    if precoding is None:
        w = identity(grid.shape[-3], cfg.nof_layers, grid.device)
    else:
        w = torch.as_tensor(np.asarray(precoding)).to(grid.device)
    cbs = ldpc_encode.dlsch_encode(payload_bits,                   # K5
                                   segmentation(cfg).base_graph)
    dl_map.pdsch_map(*map_args(grid, cfg, cbs, w))                 # K6
    if grid.ndim == 3:
        return map_dmrs(grid, dmrs_config(cfg), w, dmrs_cinits)
    per_slot = isinstance(dmrs_cinits, torch.Tensor) and dmrs_cinits.ndim == 3
    for b in range(grid.shape[0]):
        map_dmrs(grid[b], dmrs_config(cfg), w,
                 dmrs_cinits[b] if per_slot else dmrs_cinits)
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
