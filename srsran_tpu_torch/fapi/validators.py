"""FAPI message validators (analogue of the reference's lib/fapi/validators/).

The port's own copy of srsran_tpu/fapi/validators.py: each PDU config is
checked against the cell geometry and 3GPP ranges, raising ValidationError
with the offending field; the conductor calls these before it resolves a
slot phase.  PDU kinds and options the port does not run raise
NotImplementedError with their ROADMAP item instead (CSI-RS, PRS, PUCCH
F3/F4; PT-RS, per-PRG precoding and RA type 0 / interleaved PDSCH).
"""

from __future__ import annotations

from ..ops.modulation import BITS_PER_SYMBOL
from ..phy.slot_programs import CellConfig
from ..phy.upper import pdsch as pdsch_mod
from .messages import DlTtiRequest, TxDataRequest, UlTtiRequest


class ValidationError(ValueError):
    pass


def _check(cond, msg):
    if not cond:
        raise ValidationError(msg)


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(f"{kind} PDUs are not ported yet "
                               "(ROADMAP §1 item 13)")


def _check_alloc(name, cell: CellConfig, rb_start, rb_count, first_symbol,
                 nof_symbols):
    _check(0 <= rb_start and rb_start + rb_count <= cell.nof_rb,
           f"{name}: PRB range [{rb_start}, {rb_start + rb_count}) exceeds "
           f"carrier {cell.nof_rb} RB")
    _check(rb_count > 0, f"{name}: empty PRB allocation")
    _check(0 <= first_symbol and first_symbol + nof_symbols <= 14,
           f"{name}: symbol range [{first_symbol}, "
           f"{first_symbol + nof_symbols}) exceeds the slot")


def validate_dl_tti(dl: DlTtiRequest, cell: CellConfig):
    for s in dl.ssb:
        _check(0 <= s.phys_cell_id < 1008, "ssb: phys_cell_id out of range")
        _check(s.l_max in (4, 8, 64), "ssb: L_max must be 4, 8 or 64")
        _check(s.first_subcarrier + 240 <= cell.nof_sc,
               "ssb: 240-subcarrier block exceeds the carrier")
        _check(s.first_symbol + 4 <= 14, "ssb: block exceeds the slot")
    for p in dl.pdcch:
        _check(p.aggregation_level in (1, 2, 4, 8, 16),
               "pdcch: invalid aggregation level")
        cs = p.coreset
        _check(cs.nof_rb % 6 == 0, "pdcch: CORESET size must be 6-RB aligned")
        _check_alloc("pdcch", cell, cs.rb_start, cs.nof_rb, cs.start_symbol,
                     cs.duration)
        needed = (p.cce_index + p.aggregation_level) * 6
        _check(needed <= cs.nof_rb // 6 * 6 * cs.duration // 1,
               "pdcch: candidate exceeds the CORESET")
        _check(0 < p.payload_bits <= 140, "pdcch: DCI payload size")
    for p in dl.pdsch:
        _check_alloc("pdsch", cell, p.rb_start, p.rb_count, p.first_symbol,
                     p.nof_symbols)
        _check(1 <= p.nof_layers <= 4, "pdsch: 1..4 layers")
        _check(p.modulation in ("qpsk", "qam16", "qam64", "qam256"),
               "pdsch: modulation")
        _check(p.rv in (0, 1, 2, 3), "pdsch: rv")
        _check(all(p.first_symbol <= d < p.first_symbol + p.nof_symbols
                   for d in p.dmrs_symbols),
               "pdsch: DM-RS symbol outside the allocation")
        pdsch_mod.check_supported(p)
        # capacity check: the rate-matched TB must fit
        g = (pdsch_mod.nof_data_re(p) * BITS_PER_SYMBOL[p.modulation]
             * p.nof_layers)
        _check(p.tbs + 24 <= g,
               f"pdsch: TBS {p.tbs} exceeds capacity {g} bits")
    if dl.csi_rs:
        raise _not_ported("CSI-RS")
    if dl.prs:
        raise _not_ported("PRS")


def validate_ul_dci(ul_dci, cell: CellConfig):
    """ul_dci_request PDUs share the dl_tti pdcch validator rules (the
    reference routes both to the same PDCCH processor)."""
    validate_dl_tti(DlTtiRequest(slot=ul_dci.slot, pdcch=ul_dci.pdcch), cell)
    _check(len(ul_dci.payloads) == len(ul_dci.pdcch),
           "ul_dci: payload count != pdcch PDU count")


def validate_tx_data(tx: TxDataRequest, dl: DlTtiRequest):
    _check(len(tx.pdsch_payloads) == len(dl.pdsch),
           "tx_data: payload count != pdsch PDU count")
    for pl, cfg in zip(tx.pdsch_payloads, dl.pdsch):
        _check(len(pl) == cfg.tbs,
               f"tx_data: payload {len(pl)} bits != TBS {cfg.tbs}")
    _check(len(tx.pdcch_payloads) == len(dl.pdcch),
           "tx_data: DCI payload count != pdcch PDU count")
    _check(len(tx.ssb_mib) == len(dl.ssb), "tx_data: MIB count != ssb count")


def validate_ul_tti(ul: UlTtiRequest, cell: CellConfig):
    for p in ul.pusch:
        _check_alloc("pusch", cell, p.rb_start, p.rb_count, p.first_symbol,
                     p.nof_symbols)
        _check(1 <= p.nof_layers <= 4,
               "pusch: 1..4 layers (beyond the reference's 1-layer cap, "
               "pusch_processor_phy_capabilities.cpp:29)")
        _check(not (p.transform_precoding and p.nof_layers > 1),
               "pusch: transform precoding is single-layer")
    _check(not ul.pusch_harq or len(ul.pusch_harq) == len(ul.pusch),
           "ul_tti: pusch_harq length mismatch")
    for f in ul.pucch_f0:
        _check(f.prb < cell.nof_rb, "pucch_f0: PRB")
        _check(f.nof_symbols in (1, 2), "pucch_f0: 1-2 symbols")
        _check(0 <= f.initial_cyclic_shift < 12, "pucch_f0: cyclic shift")
        _check(0 <= f.nof_harq_bits <= 2, "pucch_f0: 0-2 HARQ bits")
        _check(f.nof_harq_bits > 0 or f.sr_opportunity,
               "pucch_f0: must carry HARQ bits, SR, or both")
    for f in ul.pucch_f1:
        _check(f.prb < cell.nof_rb, "pucch_f1: PRB")
        _check(4 <= f.nof_symbols <= 14, "pucch_f1: 4-14 symbols")
    for f in ul.pucch_f2:
        _check(f.rb_start + f.nof_rb <= cell.nof_rb, "pucch_f2: PRB range")
        _check(f.nof_symbols in (1, 2), "pucch_f2: 1-2 symbols")
        _check(f.nof_uci_bits >= 1, "pucch_f2: empty UCI")
    if ul.pucch_f3 or ul.pucch_f4:
        raise _not_ported("PUCCH F3/F4")
    for s in ul.srs:
        _check(s.rb_start + s.rb_count <= cell.nof_rb, "srs: PRB range")
        _check(s.nof_symbols in (1, 2, 4), "srs: 1/2/4 symbols")
        _check(s.comb in (2, 4), "srs: comb 2 or 4")
        _check(s.start_symbol + s.nof_symbols <= 14, "srs: symbol range")
