"""FAPI message validators (analogue of the reference's lib/fapi/validators/).

The port's own copy of srsran_tpu/fapi/validators.py: each PDU config is
checked against the cell geometry and 3GPP ranges, raising ValidationError
with the offending field; the conductor calls these before it resolves a
slot phase.  RA type 0 and interleaved-VRB PDSCHs, per-PRG precoding (its
PRG count over the allocation's span), PT-RS, CSI-RS and PRS are checked as
the JAX package checks them, message for message.  Every UL PDU kind
of the JAX package passes: PUSCHs of 1-4 layers with ZF or MMSE, UCI on
PUSCH, frequency hopping and transform precoding, PUCCH F0 to F4, PRACH
and SRS.
"""

from __future__ import annotations

from ..ops.modulation import BITS_PER_SYMBOL
from ..phy.slot_programs import CellConfig
from ..phy.upper import pdsch as pdsch_mod
from ..phy.upper.csi_rs import nof_csi_rs_ports
from ..ran import precoding_codebooks as pc
from .messages import DlTtiRequest, TxDataRequest, UlTtiRequest


class ValidationError(ValueError):
    pass


def _check(cond, msg):
    if not cond:
        raise ValidationError(msg)


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
        # allocation resolution first: malformed type-0/interleaved
        # configs must surface as ValidationError, not IndexError, BEFORE
        # the capacity check touches the RE plan
        if p.prbs is not None or p.vrb_prb_interleaved:
            try:
                alloc = pdsch_mod.alloc_prbs(p)
            except (IndexError, ValueError, AssertionError) as e:
                alloc = None
                _check(False, f"pdsch: bad type-0/interleaved allocation: "
                              f"{e}")
            _check(len(alloc) > 0, "pdsch: empty type-0 allocation")
            _check(len(alloc) == len(set(alloc)),
                   "pdsch: duplicate PRBs in type-0 allocation")
            _check(int(alloc[0]) >= 0 and int(alloc[-1]) < cell.nof_rb,
                   "pdsch: type-0/interleaved allocation exceeds carrier")
            _check(p.ptrs is None,
                   "pdsch: PT-RS with non-contiguous allocation is not "
                   "supported (PT-RS positions assume contiguous PRBs)")
        # capacity check: the rate-matched TB must fit
        g = (pdsch_mod.nof_data_re(p) * BITS_PER_SYMBOL[p.modulation]
             * p.nof_layers)
        _check(p.tbs + 24 <= g,
               f"pdsch: TBS {p.tbs} exceeds capacity {g} bits")
        if p.precoding is not None:
            pre = p.precoding
            _check(pre.prg_size >= 1, "pdsch: precoding prg_size >= 1")
            want = pc.nof_prgs(*pdsch_mod.prg_span(p), pre.prg_size)
            _check(len(pre.pm_indices) == want,
                   f"pdsch: precoding has {len(pre.pm_indices)} PM indices, "
                   f"allocation spans {want} PRGs")
            try:
                mats = pc.resolve_matrices(cell.nof_ports, pre)
            except (IndexError, ValueError) as e:
                _check(False, f"pdsch: precoding {e}")
            else:
                _check(mats.shape[2] == p.nof_layers,
                       f"pdsch: precoding matrices map {mats.shape[2]} "
                       f"layers, PDU has {p.nof_layers}")
    for c in dl.csi_rs:
        _check(1 <= c.row <= 18, "csi_rs: row must be 1..18 "
               "(Table 7.4.1.5.3-1; the reference caps at 12)")
        # The slot program maps CSI-RS ports 1:1 onto physical ports (no
        # precoding matrix in the FAPI PDU): a row needing more CSI-RS
        # ports than the cell has is rejected here.
        _check(nof_csi_rs_ports(c.row) <= cell.nof_ports,
               f"csi_rs: row {c.row} needs {nof_csi_rs_ports(c.row)} CSI-RS "
               f"ports but the cell has {cell.nof_ports} (a precoding matrix "
               "is required and the FAPI path does not carry one)")
        _check(c.rb_start + c.rb_count <= cell.nof_rb, "csi_rs: PRB range")
        try:
            c.resolved_k_ref()
            c.resolved_density()
        except ValueError as e:
            _check(False, f"csi_rs: {e}")
    for p in dl.prs:
        _check_alloc("prs", cell, p.rb_start, p.rb_count, p.first_symbol,
                     p.nof_symbols)
        _check(p.nof_symbols in (2, 4, 6, 12), "prs: 2/4/6/12 symbols")
        _check(p.comb_size in (2, 4, 6, 12), "prs: comb size")
        _check(0 <= p.comb_offset < p.comb_size, "prs: comb offset")
        _check(0 <= p.n_id_prs < 4096, "prs: n_id_prs")
        _check(p.rb_count * 12 % p.comb_size == 0,
               "prs: allocation not a comb multiple")
    for p in dl.pdsch:
        if p.ptrs is not None:
            _check(p.ptrs.time_density in (1, 2, 4), "ptrs: L_PT-RS 1/2/4")
            _check(p.ptrs.freq_density in (2, 4), "ptrs: K_PT-RS 2/4")
            _check(0 <= p.ptrs.re_offset < 12, "ptrs: RE offset")
            _check(p.ptrs.port < p.nof_layers, "ptrs: port not a layer")


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
    for f in ul.pucch_f3:
        _check(f.rb_start + f.nof_rb <= cell.nof_rb, "pucch_f3: PRB range")
        _check(f.nof_rb in (1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 15, 16),
               "pucch_f3: PRB count must be 2^a 3^b 5^c (DFT sizes)")
        _check(4 <= f.nof_symbols <= 14, "pucch_f3: 4-14 symbols")
        _check(f.occ_length == 1, "pucch_f3: occ_length must be 1 (F4 PDUs "
               "carry 2 or 4)")
        _check(f.nof_uci_bits >= 1, "pucch_f3: empty UCI")
    for f in ul.pucch_f4:
        _check(f.nof_rb == 1, "pucch_f4: exactly 1 PRB")
        _check(4 <= f.nof_symbols <= 14, "pucch_f4: 4-14 symbols")
        _check(f.occ_length in (2, 4), "pucch_f4: occ_length 2 or 4")
        _check(0 <= f.occ_index < f.occ_length, "pucch_f4: occ index")
        _check(f.nof_uci_bits >= 1, "pucch_f4: empty UCI")
    for s in ul.srs:
        _check(s.rb_start + s.rb_count <= cell.nof_rb, "srs: PRB range")
        _check(s.nof_symbols in (1, 2, 4), "srs: 1/2/4 symbols")
        _check(s.comb in (2, 4), "srs: comb 2 or 4")
        _check(s.start_symbol + s.nof_symbols <= 14, "srs: symbol range")
