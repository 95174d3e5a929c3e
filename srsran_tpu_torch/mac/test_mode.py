"""Test-mode MAC: synthetic full-rate slot request generator.

Analogue of the reference's mac_test_mode_adapter
(lib/du/du_high/test_mode/mac_test_mode_adapter.h:65-133): emits
spec-consistent DL/UL slot schedules for configured test UEs at line rate —
SSB every 20 ms, PDCCH+PDSCH on DL slots, PUSCH (+PUCCH) on UL slots per
the TDD pattern — so sustained end-to-end benchmarks run without a UE or
core network.

The port's own copy of srsran_tpu/mac/test_mode.py (host only, the same
numpy RNG calls in the same order), on the port's configs and
FAPI messages: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ran.slot_point import SlotPoint
from ..ran.tdd import TddPattern
from ..ran.mcs_tbs import mcs_config, tbs as tbs_calc
from ..phy.slot_programs import CellConfig
from ..phy.upper.ssb import SsbConfig
from ..phy.upper.pdsch import PdschConfig
from ..phy.upper.pdcch import PdcchConfig, CoresetConfig
from ..phy.upper.pusch import PuschConfig
from ..phy.upper.pucch import PucchF1Config
from ..fapi.messages import DlTtiRequest, TxDataRequest, UlTtiRequest


@dataclasses.dataclass
class TestUe:
    rnti: int
    mcs_table: str = "qam64"
    mcs_index: int = 27
    nof_layers_dl: int = 2
    nof_layers_ul: int = 1


class TestModeMac:
    """Generates (DlTtiRequest, TxDataRequest) / UlTtiRequest per slot."""

    def __init__(self, cell: CellConfig, phys_cell_id: int = 1,
                 ues: list | None = None, tdd: TddPattern | None = None,
                 seed: int = 0):
        self.cell = cell
        self.pci = phys_cell_id
        self.ues = ues or [TestUe(rnti=0x4601)]
        self.tdd = tdd or TddPattern()
        self.rng = np.random.default_rng(seed)
        self._dmrs_dl = (2, 11)
        self._dmrs_ul = (2, 7, 11)

    # ------------------------------------------------------------------ DL

    def _pdsch_for(self, ue: TestUe, rb_start: int, rb_count: int,
                   slot: SlotPoint) -> PdschConfig:
        mod, rate = mcs_config(ue.mcs_table, ue.mcs_index)
        # DM-RS symbols are fully reserved (CDM groups without data = 2).
        t = tbs_calc(rb_count, 12, 12 * len(self._dmrs_dl), mod, rate,
                     ue.nof_layers_dl)
        return PdschConfig(
            rnti=ue.rnti, rb_start=rb_start, rb_count=rb_count,
            first_symbol=1, nof_symbols=12, modulation=mod,
            target_code_rate=rate, tbs=t, nof_layers=ue.nof_layers_dl,
            n_id=self.pci, dmrs_symbols=self._dmrs_dl,
            dmrs_scrambling_id=self.pci, numerology=self.cell.numerology,
            slot_in_frame=slot.slot_index)

    def dl_requests(self, slot: SlotPoint):
        if not self.tdd.is_dl(slot.count):
            return (DlTtiRequest(slot=slot), TxDataRequest(slot=slot))
        ssb = ()
        mibs = ()
        if slot.slot_index == 0 and slot.sfn % 2 == 0:   # every 20 ms
            ssb = (SsbConfig(phys_cell_id=self.pci, ssb_idx=0, l_max=8,
                             sfn=slot.sfn, first_symbol=2,
                             first_subcarrier=(self.cell.nof_sc - 240) // 2),)
            mibs = (self.rng.integers(0, 2, 24).astype(np.int8),)
        coreset = CoresetConfig(rb_start=0, nof_rb=min(48, self.cell.nof_rb // 6 * 6),
                                start_symbol=0, duration=1)
        pdcch, dcis, pdsch, payloads = [], [], [], []
        nof_ue = len(self.ues)
        rb_per_ue = self.cell.nof_rb // nof_ue
        for i, ue in enumerate(self.ues):
            pdcch.append(PdcchConfig(
                coreset=coreset, rnti=ue.rnti, aggregation_level=4,
                cce_index=(4 * i) % (coreset.nof_rb // 6),
                payload_bits=40, n_id=self.pci, n_id_data=self.pci,
                slot_in_frame=slot.slot_index))
            dcis.append(self.rng.integers(0, 2, 40).astype(np.int8))
            cfg = self._pdsch_for(ue, i * rb_per_ue, rb_per_ue, slot)
            pdsch.append(cfg)
            payloads.append(self.rng.integers(0, 2, cfg.tbs).astype(np.int8))
        dl = DlTtiRequest(slot=slot, ssb=ssb, pdcch=tuple(pdcch),
                          pdsch=tuple(pdsch))
        tx = TxDataRequest(slot=slot, pdsch_payloads=tuple(payloads),
                           pdcch_payloads=tuple(dcis), ssb_mib=mibs)
        return dl, tx

    # ------------------------------------------------------------------ UL

    def _pusch_for(self, ue: TestUe, rb_start: int, rb_count: int,
                   slot: SlotPoint) -> PuschConfig:
        mod, rate = mcs_config(ue.mcs_table, min(ue.mcs_index, 27))
        t = tbs_calc(rb_count, 14, 12 * len(self._dmrs_ul), mod, rate,
                     ue.nof_layers_ul)
        return PuschConfig(
            rnti=ue.rnti, rb_start=rb_start, rb_count=rb_count,
            first_symbol=0, nof_symbols=14, modulation=mod,
            target_code_rate=rate, tbs=t, nof_layers=ue.nof_layers_ul,
            n_id=self.pci, dmrs_symbols=self._dmrs_ul,
            dmrs_scrambling_id=self.pci, numerology=self.cell.numerology,
            slot_in_frame=slot.slot_index)

    def ul_requests(self, slot: SlotPoint) -> UlTtiRequest:
        if not self.tdd.is_ul(slot.count):
            return UlTtiRequest(slot=slot)
        nof_ue = len(self.ues)
        # last PRB reserved for PUCCH
        rb_avail = self.cell.nof_rb - 1
        rb_per_ue = rb_avail // nof_ue
        pusch, harq, pucch = [], [], []
        for i, ue in enumerate(self.ues):
            pusch.append(self._pusch_for(ue, i * rb_per_ue, rb_per_ue, slot))
            harq.append((slot.count % 16, True))
            pucch.append(PucchF1Config(
                prb=self.cell.nof_rb - 1, start_symbol=0, nof_symbols=14,
                initial_cyclic_shift=(3 * i) % 12, time_domain_occ=0,
                n_id=self.pci, slot=slot.slot_index))
        return UlTtiRequest(slot=slot, pusch=tuple(pusch),
                            pusch_harq=tuple(harq), pucch_f1=tuple(pucch))
