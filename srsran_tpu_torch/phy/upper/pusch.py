"""PUSCH receive processor (TS38.211 §6.3.1, TS38.212 §6.2).

Port of srsran_tpu/phy/upper/pusch.py without UCI, frequency hopping or
transform precoding:

  DM-RS channel estimate (K8) -> [fused per-RE ZF equalize -> max-log
  demap -> descramble: the K3 kernel] -> EVM -> rate dematch + HARQ
  combine (K2) -> LDPC decode with CRC early stop (K1) -> CB/TB CRC.

All data REs of the allocation are gathered through one host plan; the
codeblock axis batches the decode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...ran.cyclic_prefix import CyclicPrefix, cp_lengths
from ...ran.ldpc_params import SegmentParams, segment_tb, select_base_graph
from ...ran.uci_on_pusch import UciOnPuschConfig
from ...device import const
from ...ops import channel_estimate as chest
from ...ops import evm as evm_ops
from ...ops import ul_demap
from ...ops.modulation import BITS_PER_SYMBOL
from . import sch_decoder
from .dmrs import DmrsConfig, _type1_sc_indices, pilots_for_port
from .pdsch import _cb_rate_match_sizes, data_re_plan_column, plan_key


@dataclasses.dataclass(frozen=True)
class PuschConfig:
    """Static PUSCH PDU description (same fields and defaults as the JAX
    package's PuschConfig)."""

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
    equalizer: str = "zf"
    td_interpolation: str = "average"
    uci: UciOnPuschConfig = UciOnPuschConfig()
    transform_precoding: bool = False
    second_hop_prb: int | None = None


@dataclasses.dataclass
class PuschResult:
    tb_bits: torch.Tensor
    tb_crc_ok: torch.Tensor
    cb_crc_ok: torch.Tensor
    new_soft: torch.Tensor
    csi: chest.ChannelEstimate
    evm: torch.Tensor
    nof_iterations: torch.Tensor


def check_supported(cfg: PuschConfig) -> None:
    """Raise for PDU options this slice does not port."""
    u = cfg.uci
    if u.o_ack or u.o_csi1 or u.o_csi2:
        raise NotImplementedError(
            "UCI on PUSCH is not ported yet (ROADMAP §1 item 13)")
    if cfg.second_hop_prb is not None:
        raise NotImplementedError(
            "PUSCH frequency hopping is not ported yet (ROADMAP §1 item 13)")
    if cfg.transform_precoding:
        raise NotImplementedError(
            "transform precoding is not ported yet (ROADMAP §1 item 13)")
    if cfg.equalizer != "zf" or cfg.nof_layers > 2:
        raise NotImplementedError(
            "MMSE and 3-4 layer PUSCH are not ported yet (ROADMAP §1, slice 5)")


def dmrs_config(cfg: PuschConfig) -> DmrsConfig:
    return DmrsConfig(
        rb_start=cfg.rb_start, rb_count=cfg.rb_count, symbols=cfg.dmrs_symbols,
        ports=tuple(range(cfg.nof_layers)), scrambling_id=cfg.dmrs_scrambling_id,
        n_scid=cfg.n_scid, numerology=cfg.numerology,
        slot_in_frame=cfg.slot_in_frame)


def estimate_channel(grid: torch.Tensor, cfg: PuschConfig,
                     dmrs_cinits=None) -> chest.ChannelEstimate:
    """Estimate the [P, L, S, nsc_alloc] channel from DM-RS (1-2 layers on
    type-1 CDM group 0)."""
    check_supported(cfg)
    return _estimate_group(grid, cfg, dmrs_cinits,
                           tuple(range(cfg.nof_layers)), 0)


def _symbol_times(numerology: int) -> np.ndarray:
    """Start times (s) of the 14 symbols' data at 2048-point sampling."""
    lens = cp_lengths(CyclicPrefix.NORMAL, numerology, 2048)
    fs = 2048 * (15_000 << numerology)
    starts = np.cumsum(np.concatenate([[0], (lens + 2048)[:-1]])) + lens
    return (starts / fs).astype(np.float64)


def estimate_args(grid: torch.Tensor, cfg: PuschConfig, dmrs_cinits,
                  ports: tuple, delta: int) -> tuple:
    """(args, kwargs) of ``chest.estimate_from_grid`` for the DM-RS ports
    of one CDM group."""
    dev = grid.device
    dmrs_cfg = dmrs_config(cfg)
    sc_abs = _type1_sc_indices(cfg.rb_start, cfg.rb_count, delta)
    expected = torch.stack([pilots_for_port(dmrs_cfg, p, dmrs_cinits, device=dev)
                            for p in ports])                      # [L, S, K]
    # Symbol times at the config's numerology, as the JAX package computes
    # them (PuschConfig.numerology defaults to 0; ROADMAP §3).
    scs = 15_000 << cfg.numerology
    times = _symbol_times(cfg.numerology)
    pilot_rel = sc_abs - cfg.rb_start * 12
    args = (grid, tuple(cfg.dmrs_symbols), cfg.rb_start * 12, expected,
            pilot_rel, cfg.rb_count * 12, 14, float(scs))
    kwargs = dict(stride=2, smoothing="filter",
                  dmrs_symbol_times_s=times[np.asarray(cfg.dmrs_symbols)],
                  td_strategy=cfg.td_interpolation,
                  dmrs_symbol_idx=np.asarray(cfg.dmrs_symbols),
                  cdm_pairs=len(ports) > 1)
    return args, kwargs


def _estimate_group(grid: torch.Tensor, cfg: PuschConfig, dmrs_cinits,
                    ports: tuple, delta: int) -> chest.ChannelEstimate:
    """Single-CDM-group estimate for the given DM-RS ports (K8 reads the
    pilots straight from the grid)."""
    args, kwargs = estimate_args(grid, cfg, dmrs_cinits, ports, delta)
    return chest.estimate_from_grid(*args, **kwargs)


def _plan(cfg: PuschConfig, device):
    """Data-RE plan (symbol, subcarrier) columns as device int64 tensors."""
    key = plan_key(cfg)
    return (const(data_re_plan_column, *key, 0, device=device),
            const(data_re_plan_column, *key, 1, device=device))


def segmentation(cfg: PuschConfig) -> SegmentParams:
    """Codeblock segmentation of the PUSCH's transport block (TS38.212
    §6.2.2/§6.2.3: base graph from TBS and target rate)."""
    return segment_tb(cfg.tbs, select_base_graph(cfg.tbs, cfg.target_code_rate))


def _frontend_hop(grid: torch.Tensor, cfg: PuschConfig, dmrs_cinits=None):
    """Plain front end: estimate -> gather -> equalize.

    Returns (x [RE, L], out_nv [RE, L], est)."""
    est = estimate_channel(grid, cfg, dmrs_cinits)
    sym_idx, sc_idx = _plan(cfg, grid.device)
    x, out_nv = ul_demap.gather_equalize(
        grid, est.coeffs, sym_idx, sc_idx, cfg.rb_start * 12,
        torch.mean(est.noise_var), cfg.nof_layers, cfg.equalizer)
    return x, out_nv, est


def codeword_llrs(grid: torch.Tensor, cfg: PuschConfig, dmrs_cinits=None):
    """Front end through descrambling: (codeword LLRs, estimate, EVM)."""
    est = estimate_channel(grid, cfg, dmrs_cinits)
    sym_idx, sc_idx = _plan(cfg, grid.device)
    c_init = (cfg.rnti << 15) + cfg.n_id
    llr, x = ul_demap.equalize_demap_descramble(
        grid, est.coeffs, sym_idx, sc_idx, cfg.rb_start * 12,
        torch.mean(est.noise_var), c_init, cfg.modulation, cfg.nof_layers)
    evm_val = evm_ops.evm(x.reshape(-1), llr, cfg.modulation)
    return llr, est, evm_val


def decode_from_llrs(llr: torch.Tensor, est, cfg: PuschConfig,
                     soft_buffer: torch.Tensor | None = None,
                     nof_iterations: int = 6,
                     evm_val: torch.Tensor | None = None) -> PuschResult:
    """Rate dematch + LDPC decode from descrambled codeword LLRs."""
    check_supported(cfg)
    qm = BITS_PER_SYMBOL[cfg.modulation]
    seg = segmentation(cfg)
    e_sizes = _cb_rate_match_sizes(llr.shape[0], seg.nof_codeblocks, qm,
                                   cfg.nof_layers)
    res = sch_decoder.decode(llr, seg, e_sizes, cfg.rv, qm, cfg.tbs,
                             soft_buffer=soft_buffer,
                             nof_iterations=nof_iterations)
    return PuschResult(tb_bits=res.tb_bits, tb_crc_ok=res.tb_crc_ok,
                       cb_crc_ok=res.cb_crc_ok, new_soft=res.new_soft,
                       csi=est,
                       evm=(torch.mean(llr.abs()) if evm_val is None
                            else evm_val),
                       nof_iterations=res.nof_iterations)


def process(grid: torch.Tensor, cfg: PuschConfig,
            soft_buffer: torch.Tensor | None = None,
            nof_iterations: int = 6, dmrs_cinits=None) -> PuschResult:
    """Full PUSCH receive.  grid: complex64 [P, nsym, nsc] rx resource grid."""
    llr, est, evm_val = codeword_llrs(grid, cfg, dmrs_cinits)
    return decode_from_llrs(llr, est, cfg, soft_buffer, nof_iterations,
                            evm_val=evm_val)

