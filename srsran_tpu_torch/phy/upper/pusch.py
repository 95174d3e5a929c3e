"""PUSCH receive processor (TS38.211 §6.3.1, TS38.212 §6.2).

Port of srsran_tpu/phy/upper/pusch.py:

  DM-RS channel estimate (K8; layers 3-4 on a second CDM group; the
  low-PAPR sequence with transform precoding) -> [fused per-RE ZF / MMSE
  equalize -> max-log demap -> descramble: K3 for ZF with 1-2 layers, K16
  otherwise; with transform precoding K18, which adds the IDFT per data
  symbol and its block's mean noise] -> EVM -> [UL-SCH / UCI demultiplex:
  K17] -> HARQ-ACK, CSI part 1 and part 2 decode (K14 short block, K15
  polar) -> rate dematch + HARQ combine (K2) -> LDPC decode with CRC early
  stop (K1) -> CB/TB CRC.

All data REs of the allocation are gathered through one host plan; the
codeblock axis batches the decode.  Intra-slot frequency hopping
(:func:`hop_configs`) estimates each hop on its own (K8 per hop, the DM-RS
pilot rows of the slot context split per hop); without transform
precoding K3/K16 then run once per hop, hop 2 descrambling from the Gold
bit where hop 1 ended, and with it one K18 launch takes both hops.  Only
hop 1's channel report is returned, as the JAX package does.

A leading slot axis on the grid (the slot-batch mode: grid [B, P, S, K],
soft buffers [B, C, N], DM-RS pilot values [B, nsym, npilot] or shared)
runs K8, K3 or K16 (or K18), K17, the UCI decoders (K14, K15), K2 and K1
once for all slots, with the LDPC early stop kept per slot.  Every result
then has the slot axis in front.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...ran.cyclic_prefix import CyclicPrefix, cp_lengths
from ...ran.ldpc_params import SegmentParams, segment_tb, select_base_graph
from ...ran.uci_on_pusch import (UciOnPuschConfig, uci_part2_get_size,
                                  uci_symbol_budget)
from ...device import const
from ...ops import channel_estimate as chest
from ...ops import evm as evm_ops
from ...ops import uci_demux, ul_demap, ulsch_demux
from ...ops.low_papr import base_sequence
from ...ops.modulation import BITS_PER_SYMBOL
from ...ops.scrambling import descramble_llrs
from . import sch_decoder
from . import uci as uci_codec
from .dmrs import (DmrsConfig, _type1_sc_indices, pilot_values_for,
                   pilots_for_port)
from .pdsch import (_cb_rate_match_sizes, _data_re_plan,
                    data_re_plan_column, plan_key)


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
    harq_ack_bits: torch.Tensor | None = None
    harq_ack_valid: torch.Tensor | None = None
    csi1_bits: torch.Tensor | None = None
    csi1_valid: torch.Tensor | None = None
    csi2_bits: torch.Tensor | None = None
    csi2_valid: torch.Tensor | None = None


def hop_configs(cfg: PuschConfig) -> tuple:
    """Split a hopping PUSCH into per-hop single-allocation configs (hop 1:
    the first floor(N/2) symbols; the JAX package's hop_configs)."""
    if cfg.second_hop_prb is None:
        return (cfg,)
    n1 = cfg.nof_symbols // 2
    hop1_syms = tuple(s for s in cfg.dmrs_symbols
                      if s < cfg.first_symbol + n1)
    hop2_syms = tuple(s for s in cfg.dmrs_symbols
                      if s >= cfg.first_symbol + n1)
    if not (hop1_syms and hop2_syms):
        raise ValueError("frequency hopping needs DM-RS in both hops")
    h1 = dataclasses.replace(cfg, nof_symbols=n1, dmrs_symbols=hop1_syms,
                             second_hop_prb=None)
    h2 = dataclasses.replace(cfg, rb_start=cfg.second_hop_prb,
                             first_symbol=cfg.first_symbol + n1,
                             nof_symbols=cfg.nof_symbols - n1,
                             dmrs_symbols=hop2_syms, second_hop_prb=None)
    return (h1, h2)


def dmrs_pilot_values(cfg: PuschConfig) -> np.ndarray:
    """The PUSCH's DM-RS pilot values [nsym, npilot] (the slot context):
    with frequency hopping hop 1's rows from hop 1's config, then hop 2's
    from hop 2's, each hop's Gold sequence advanced to its own first PRB.
    (The JAX conductor builds every row from hop 1's config, so its hop 2
    is estimated against the pilots of hop 1's PRBs; ROADMAP §3.)"""
    return np.concatenate([pilot_values_for(dmrs_config(h))
                           for h in hop_configs(cfg)], axis=0)


def _hop_rows(dmrs_cinits, first: int, count: int):
    """One hop's rows of a PUSCH's DM-RS slot context: pilot values [(B,)
    nsym, npilot] (rows on the next-to-last axis) or c_init seeds."""
    if dmrs_cinits is None:
        return None
    if isinstance(dmrs_cinits, torch.Tensor) and dmrs_cinits.is_complex():
        return dmrs_cinits[..., first:first + count, :]
    return dmrs_cinits[first:first + count]


def demux_plan(cfg: PuschConfig) -> ulsch_demux.DemuxConfig | None:
    """The §6.2.7 placement plan of this PUSCH (None without UCI)."""
    u = cfg.uci
    if u.o_ack == 0 and u.o_csi1 == 0 and u.o_csi2 == 0:
        return None
    qm = BITS_PER_SYMBOL[cfg.modulation]
    syms = range(cfg.first_symbol, cfg.first_symbol + cfg.nof_symbols)
    re_per_symbol = tuple(
        0 if l in cfg.dmrs_symbols else cfg.rb_count * 12 for l in syms)
    m_total = sum(re_per_symbol)
    # anchor l1: first symbol after the first DM-RS symbol
    first_dmrs = min(cfg.dmrs_symbols)
    m_from_l1 = sum(r for l, r in zip(syms, re_per_symbol) if l > first_dmrs)
    seg = segmentation(cfg)
    sum_kr = cfg.tbs + seg.tb_crc_bits + seg.nof_codeblocks * seg.cb_crc_bits
    q_ack = uci_symbol_budget(u.o_ack, u.beta_ack, u.alpha, m_total,
                              m_from_l1, sum_kr, qm, cfg.nof_layers)
    q_csi1 = uci_symbol_budget(u.o_csi1, u.beta_csi1, u.alpha, m_total,
                               m_total, sum_kr, qm, cfg.nof_layers,
                               already_used=q_ack)
    q_csi2 = uci_symbol_budget(u.o_csi2, u.beta_csi2, u.alpha, m_total,
                               m_total, sum_kr, qm, cfg.nof_layers,
                               already_used=q_ack + q_csi1)
    return ulsch_demux.DemuxConfig(
        nof_symbols=cfg.nof_symbols, first_symbol=cfg.first_symbol,
        re_per_symbol=re_per_symbol, dmrs_symbols=cfg.dmrs_symbols,
        qm=qm, nof_layers=cfg.nof_layers, q_ack=q_ack, q_csi1=q_csi1,
        q_csi2=q_csi2, ack_reserved=u.o_ack <= 2)


def dmrs_config(cfg: PuschConfig) -> DmrsConfig:
    return DmrsConfig(
        rb_start=cfg.rb_start, rb_count=cfg.rb_count, symbols=cfg.dmrs_symbols,
        ports=tuple(range(cfg.nof_layers)), scrambling_id=cfg.dmrs_scrambling_id,
        n_scid=cfg.n_scid, numerology=cfg.numerology,
        slot_in_frame=cfg.slot_in_frame)


def estimate_channel(grid: torch.Tensor, cfg: PuschConfig,
                     dmrs_cinits=None) -> chest.ChannelEstimate:
    """Estimate the [P, L, S, nsc_alloc] channel from DM-RS.

    Layers 1-2 ride DM-RS type-1 CDM group 0 (delta 0); layers 3-4 add CDM
    group 1 (delta 1), estimated apart (K8 twice) and concatenated on the
    layer axis, the reports averaged over the two groups.  With transform
    precoding (one layer only) the pilots are the low-PAPR sequence."""
    if cfg.transform_precoding and cfg.nof_layers != 1:
        raise ValueError("transform precoding is single-layer, got "
                         f"{cfg.nof_layers} layers")
    if cfg.nof_layers > 2:
        e0 = _estimate_group(grid, cfg, dmrs_cinits, (0, 1), 0)
        e1 = _estimate_group(grid, cfg, dmrs_cinits,
                             tuple(range(2, cfg.nof_layers)), 1)
        nv = (e0.noise_var + e1.noise_var) / 2
        rsrp = (e0.rsrp + e1.rsrp) / 2
        return chest.ChannelEstimate(
            coeffs=torch.cat([e0.coeffs, e1.coeffs], dim=-3),
            noise_var=nv, rsrp=rsrp, epre=(e0.epre + e1.epre) / 2,
            snr=rsrp / torch.clamp_min(nv, 1e-12),
            time_alignment_s=(e0.time_alignment_s + e1.time_alignment_s) / 2,
            cfo_hz=(e0.cfo_hz + e1.cfo_hz) / 2)
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
    sc_abs = _type1_sc_indices(cfg.rb_start, cfg.rb_count, delta)
    if cfg.transform_precoding:
        # DFT-s-OFDM DM-RS: the low-PAPR sequence (TS38.211 §6.4.1.1.1.2)
        expected = const(_low_papr_pilots, cfg.dmrs_scrambling_id % 30,
                         cfg.rb_count, len(cfg.dmrs_symbols), device=dev)
    else:
        dmrs_cfg = dmrs_config(cfg)
        expected = torch.stack([pilots_for_port(dmrs_cfg, p, dmrs_cinits,
                                                device=dev)
                                for p in ports], dim=-3)    # [(B,) L, S, K]
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


def _low_papr_pilots(u: int, rb_count: int, nsym: int) -> np.ndarray:
    """complex64 [1, nsym, 6 * rb_count]: the DFT-s-OFDM DM-RS on every
    DM-RS symbol."""
    seq = base_sequence(u, 0, 6 * rb_count)
    return np.ascontiguousarray(np.broadcast_to(
        seq, (1, nsym, 6 * rb_count))).astype(np.complex64)


def _estimate_group(grid: torch.Tensor, cfg: PuschConfig, dmrs_cinits,
                    ports: tuple, delta: int) -> chest.ChannelEstimate:
    """Single-CDM-group estimate for the given DM-RS ports (K8 reads the
    pilots straight from the grid)."""
    args, kwargs = estimate_args(grid, cfg, dmrs_cinits, ports, delta)
    return chest.estimate_from_grid(*args, **kwargs)


def _plan(cfg: PuschConfig, device):
    """Data-RE plan (symbol, subcarrier) columns as int32 tensors on
    ``device``, uploaded once (the layout K3 and K16 read)."""
    key = plan_key(cfg)
    return (const(data_re_plan_column, *key, 0, device=device,
                  dtype=torch.int32),
            const(data_re_plan_column, *key, 1, device=device,
                  dtype=torch.int32))


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
        est.noise_var.mean(dim=-1), cfg.nof_layers, cfg.equalizer)
    return x, out_nv, est


def _tp_key(cfg: PuschConfig) -> tuple:
    """The key of :func:`tp_plan`: each hop's ``plan_key``."""
    return tuple(plan_key(h) for h in hop_configs(cfg))


def tp_plan(hop_keys: tuple, which: int) -> np.ndarray:
    """K18's host plan of a transform-precoded PUSCH (``_tp_key``): 0 the
    int32 [3, RE] rows (symbol, subcarrier, coefficient column) of every
    data RE in codeword order, hop after hop, the column counting from hop
    h's first subcarrier plus h * M in the hops' side-by-side estimates;
    1 the int32 hop of each block of M REs (one block per data symbol)."""
    m = 12 * hop_keys[0][1]
    rows, hops = [], []
    for h, key in enumerate(hop_keys):
        plan = _data_re_plan(*key)
        if len(plan) % m:
            raise ValueError("transform precoding needs whole data symbols "
                             f"of {m} REs")
        rows.append(np.stack([plan[:, 0], plan[:, 1],
                              plan[:, 1] - 12 * key[0] + h * m]))
        hops += [h] * (len(plan) // m)
    out = np.concatenate(rows, axis=1) if which == 0 else np.asarray(hops)
    return np.ascontiguousarray(out, dtype=np.int32)


def codeword_llrs(grid: torch.Tensor, cfg: PuschConfig, dmrs_cinits=None):
    """Front end through descrambling: (codeword LLRs, estimate, EVM).

    Each hop is estimated with its own rows of the DM-RS context (the JAX
    package's slicing); the estimate returned is hop 1's."""
    dev = grid.device
    hops = hop_configs(cfg)
    ests, first = [], 0
    for h in hops:
        rows = (dmrs_cinits if len(hops) == 1 else
                _hop_rows(dmrs_cinits, first, len(h.dmrs_symbols)))
        ests.append(estimate_channel(grid, h, rows))
        first += len(h.dmrs_symbols)
    c_init = _c_init(cfg)
    if cfg.transform_precoding:
        key = _tp_key(cfg)
        coeffs = (ests[0].coeffs if len(ests) == 1
                  else torch.cat([e.coeffs for e in ests], dim=-1))
        llr, x = ul_demap.tp_equalize_demap_descramble(
            grid, coeffs, const(tp_plan, key, 0, device=dev),
            torch.stack([e.noise_var for e in ests], dim=-2),
            const(tp_plan, key, 1, device=dev), 12 * cfg.rb_count, c_init,
            cfg.modulation, cfg.equalizer)
    else:
        llrs, xs, advance = [], [], 0
        for h, est in zip(hops, ests):
            sym_idx, sc_idx = _plan(h, dev)
            llr_h, x_h = ul_demap.equalize_demap_descramble(
                grid, est.coeffs, sym_idx, sc_idx, h.rb_start * 12,
                est.noise_var.mean(dim=-1), c_init, cfg.modulation,
                cfg.nof_layers, cfg.equalizer, advance)
            advance += llr_h.shape[-1]
            llrs.append(llr_h)
            xs.append(x_h)
        llr, x = ((llrs[0], xs[0]) if len(hops) == 1 else
                  (torch.cat(llrs, dim=-1), torch.cat(xs, dim=-2)))
    # the BPSK EVMs remodulate the hard decisions of the demapped LLRs
    demapped = (descramble_llrs(llr, c_init)
                if BITS_PER_SYMBOL[cfg.modulation] == 1 else llr)
    evm_val = evm_ops.evm(x.flatten(-2), demapped, cfg.modulation)
    return llr, ests[0], evm_val


def _c_init(cfg: PuschConfig) -> int:
    return (cfg.rnti << 15) + cfg.n_id


def decode_uci_fields(llr: torch.Tensor, cfg: PuschConfig) -> tuple:
    """UL-SCH / UCI demultiplex (K17) and the UCI decodes: (data LLRs, dict
    of the PuschResult UCI fields).  Without UCI the LLRs pass through.
    LLRs [B, G] (a slot axis) run K17 and each decoder once for the B
    slots."""
    dcfg = demux_plan(cfg)
    if dcfg is None:
        return llr, {}
    u = cfg.uci
    qm = BITS_PER_SYMBOL[cfg.modulation]
    fields = uci_demux.demux(llr, dcfg, u.o_ack, u.o_csi1, _c_init(cfg))
    out = {}
    for name, o_bits, field in (("harq_ack", u.o_ack, fields[0]),
                                ("csi1", u.o_csi1, fields[1]),
                                ("csi2", u.o_csi2, fields[2])):
        if o_bits:
            bits, ok, _ = uci_codec.decode_uci(field, o_bits, qm)
            out.update({f"{name}_bits": bits, f"{name}_valid": ok})
    return fields[3], out


def decode_from_llrs(llr: torch.Tensor, est, cfg: PuschConfig,
                     soft_buffer: torch.Tensor | None = None,
                     nof_iterations: int = 6,
                     evm_val: torch.Tensor | None = None) -> PuschResult:
    """UL-SCH demux + UCI decode + rate dematch + LDPC decode from
    descrambled codeword LLRs."""
    llr, uci_out = decode_uci_fields(llr, cfg)
    qm = BITS_PER_SYMBOL[cfg.modulation]
    seg = segmentation(cfg)
    e_sizes = _cb_rate_match_sizes(llr.shape[-1], seg.nof_codeblocks, qm,
                                   cfg.nof_layers)
    res = sch_decoder.decode(llr, seg, e_sizes, cfg.rv, qm, cfg.tbs,
                             soft_buffer=soft_buffer,
                             nof_iterations=nof_iterations)
    return PuschResult(tb_bits=res.tb_bits, tb_crc_ok=res.tb_crc_ok,
                       cb_crc_ok=res.cb_crc_ok, new_soft=res.new_soft,
                       csi=est,
                       evm=(llr.abs().mean(dim=-1) if evm_val is None
                            else evm_val),
                       nof_iterations=res.nof_iterations, **uci_out)


def process(grid: torch.Tensor, cfg: PuschConfig,
            soft_buffer: torch.Tensor | None = None,
            nof_iterations: int = 6, dmrs_cinits=None) -> PuschResult:
    """Full PUSCH receive.  grid: complex64 [P, nsym, nsc] rx resource grid,
    or [B, P, nsym, nsc] with soft_buffer [B, C, N] for B slots at once."""
    llr, est, evm_val = codeword_llrs(grid, cfg, dmrs_cinits)
    return decode_from_llrs(llr, est, cfg, soft_buffer, nof_iterations,
                            evm_val=evm_val)


def process_with_part2_feedback(grid: torch.Tensor, cfg: PuschConfig,
                                part2_descr,
                                soft_buffer: torch.Tensor | None = None,
                                nof_iterations: int = 6,
                                dmrs_cinits=None) -> PuschResult:
    """PUSCH receive where the CSI part-2 size comes from the decoded part-1
    payload (the JAX package's process_with_part2_feedback).

    The front end runs once; CSI part 1 is decoded under the plan without
    part 2 (its placement does not depend on part 2) and its bits are read
    back to the host -- the one host sync -- to size part 2
    (``uci_part2_get_size`` over ``part2_descr``); then the full demux and
    decode run with that size.
    """
    u = cfg.uci
    if u.o_csi1 <= 0:
        raise ValueError("part-2 feedback needs CSI part 1 on the PUSCH")
    llr, est, evm_val = codeword_llrs(grid, cfg, dmrs_cinits)
    cfg1 = dataclasses.replace(cfg, uci=dataclasses.replace(u, o_csi2=0))
    _, c1, _, _ = uci_demux.demux(llr, demux_plan(cfg1), u.o_ack, u.o_csi1,
                                  _c_init(cfg))
    csi1_bits, csi1_ok, _ = uci_codec.decode_uci(
        c1, u.o_csi1, BITS_PER_SYMBOL[cfg.modulation])
    o_csi2 = uci_part2_get_size(csi1_bits.cpu().numpy(), part2_descr)
    cfg2 = dataclasses.replace(cfg, uci=dataclasses.replace(u, o_csi2=o_csi2))
    res = decode_from_llrs(llr, est, cfg2, soft_buffer, nof_iterations,
                           evm_val=evm_val)
    return dataclasses.replace(res, csi1_bits=csi1_bits, csi1_valid=csi1_ok)
