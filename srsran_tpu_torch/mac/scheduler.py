"""Cell MAC scheduler: time-RR UE scheduling + HARQ manager + RA procedure.

Host-side analogue of the reference's lib/scheduler core
(scheduler_impl::slot_indication at lib/scheduler/scheduler_impl.h:50,
cell_scheduler::run_slot ordering at lib/scheduler/cell_scheduler.cpp:89-150,
time-RR policy lib/scheduler/policy/scheduler_time_rr.cpp, HARQ manager
lib/scheduler/cell/cell_harq_manager.*).  The full reference scheduler is
40k LoC of C++; this is the deployable core the SURVEY north star calls
for — a thin host driver that feeds the PHY FAPI-shaped slot requests:

- per-slot ordering: SSB -> SIB1 -> paging -> PRACH occasions -> RAR ->
  UE DL/UL (the reference's run_slot sequence; slicing is carried by the
  time-QoS policy's qos_weight quotas + the E2SM-RC weight control);
- paging (paging_scheduler analogue): page_ue() enqueues a 5G-S-TMSI;
  records transmit in a P-RNTI PDSCH on the UE's paging frame per the
  TS38.304 PF formula (SFN mod T == (T div N)(UE_ID mod N)) at the
  configured paging occasion slot;
- time-domain round robin over UEs with pending data, HARQ
  retransmissions first (scheduler_time_rr semantics);
- HARQ entities with 8+8 processes per UE, rv sequence (0, 2, 3, 1),
  configurable max retransmissions; CRC/UCI indications drive ack/nack;
- link adaptation: reported PUSCH SNR -> UL MCS via a spectral-efficiency
  threshold walk (the reference maps CQI tables similarly);
- RA procedure: rach_indication -> TC-RNTI allocation + RAR grant for
  Msg3 on the next UL slot (mac_rach_handler + ra_scheduler analogue).

The scheduler emits the same (DlTtiRequest, TxDataRequest, UlTtiRequest)
the test-mode MAC does, so it drops into gnb_sim / the split-6 du_low
unchanged.

The port's own copy of srsran_tpu/mac/scheduler.py (host only, the same
numpy RNG calls in the same order), on the port's configs and
FAPI messages: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ran.slot_point import SlotPoint
from ..ran.tdd import TddPattern
from ..ran.mcs_tbs import mcs_config, tbs as tbs_calc, TABLES
from ..ran import csi_report as csi_mod
from ..ran.precoding_codebooks import (PrecodingConfig, pmi_to_index,
                                       nof_prgs)
from ..phy.slot_programs import CellConfig
from ..phy.upper.ssb import SsbConfig
from ..phy.upper.pdsch import PdschConfig
from ..phy.upper.pdcch import PdcchConfig, CoresetConfig
from ..phy.upper.pusch import PuschConfig
from ..phy.upper.pucch import PucchF1Config, PucchF2Config
from ..phy.upper.prach import PrachConfig
from ..fapi.messages import DlTtiRequest, TxDataRequest, UlTtiRequest

RV_SEQUENCE = (0, 2, 3, 1)          # TS38.214 §5.1.2; reference default
NOF_HARQ_PROCESSES = 8


@dataclasses.dataclass
class HarqProcess:
    """One DL or UL HARQ process (cell_harq_manager analogue)."""

    active: bool = False
    payload: np.ndarray | None = None   # DL: the TB to (re)send
    cfg: object = None                  # the PdschConfig/PuschConfig in flight
    nof_retx: int = 0
    rv_idx: int = 0
    awaiting_ack: bool = False

    def new_tx(self, cfg, payload=None):
        self.active = True
        self.cfg = cfg
        self.payload = payload
        self.nof_retx = 0
        self.rv_idx = 0
        self.awaiting_ack = True

    def retx(self):
        self.nof_retx += 1
        self.rv_idx = (self.rv_idx + 1) % len(RV_SEQUENCE)
        self.awaiting_ack = True

    @property
    def rv(self) -> int:
        return RV_SEQUENCE[self.rv_idx]

    def stop(self):
        self.active = False
        self.payload = None
        self.cfg = None
        self.awaiting_ack = False


@dataclasses.dataclass
class SchedUeConfig:
    rnti: int
    mcs_table: str = "qam64"
    dl_mcs: int = 27
    ul_mcs: int = 25
    nof_layers_dl: int = 2
    nof_layers_ul: int = 1
    # full-buffer by default; finite buffers drain per scheduled TBS
    dl_buffer_bytes: int = -1        # -1 = full buffer
    ul_buffer_bytes: int = -1
    qos_weight: float = 1.0          # time-QoS policy weight (slice/5QI)


class UeContext:
    def __init__(self, cfg: SchedUeConfig):
        self.cfg = cfg
        self.dl_harq = [HarqProcess() for _ in range(NOF_HARQ_PROCESSES)]
        self.ul_harq = [HarqProcess() for _ in range(NOF_HARQ_PROCESSES)]
        self.dl_buffer = cfg.dl_buffer_bytes
        self.ul_buffer = cfg.ul_buffer_bytes
        self.last_ul_snr_db: float | None = None
        self.ul_mcs = cfg.ul_mcs
        # DL link adaptation state, driven by CSI reports (handle_csi):
        # starts at the configured values, adapts once the UE reports.
        self.dl_mcs = cfg.dl_mcs
        self.dl_layers = cfg.nof_layers_dl
        self.last_csi: "csi_mod.CsiReportData | None" = None
        # RIC-controlled MCS ceiling (E2SM-RC executor state); None = none
        self.mcs_cap: int | None = None
        # rank-restricted report config of the last CSI-on-PUSCH request
        self.pusch_csi_cfg = None
        # EWMA delivered rate (bits/slot) for the time-QoS PF metric
        self.avg_rate_dl = 1.0
        self.avg_rate_ul = 1.0

    def find_free(self, harqs) -> int | None:
        for i, h in enumerate(harqs):
            if not h.active:
                return i
        return None

    def find_pending_retx(self, harqs) -> int | None:
        for i, h in enumerate(harqs):
            if h.active and not h.awaiting_ack:
                return i
        return None

    def has_dl_data(self) -> bool:
        return self.dl_buffer != 0

    def has_ul_data(self) -> bool:
        return self.ul_buffer != 0


# Spectral-efficiency thresholds for UL link adaptation: minimum SNR (dB)
# at which each qam64-table MCS sustains ~10% BLER over AWGN (coarse,
# conservative; the reference maps CQI->MCS through similar tables in
# lib/scheduler/ue_context/ue_link_adaptation_controller.cpp).
_SNR_TO_MCS_DB = [(-4, 0), (-2, 2), (0, 4), (2, 6), (4, 8), (6, 10),
                  (8, 12), (10, 14), (12, 16), (14, 18), (16, 20),
                  (18, 22), (20, 24), (22, 26), (24, 28)]


def snr_to_mcs(snr_db: float, table: str = "qam64") -> int:
    mcs = 0
    for thr, m in _SNR_TO_MCS_DB:
        if snr_db >= thr:
            mcs = m
    return min(mcs, len(TABLES[table]) - 1)


def _free_segments(lo: int, hi: int, occupied: list) -> list:
    """Free [start, end) PRB segments of [lo, hi) after removing occupied."""
    segs = []
    cur = lo
    for a, b in sorted(occupied):
        if a > cur:
            segs.append([cur, min(a, hi)])
        cur = max(cur, b)
    if cur < hi:
        segs.append([cur, hi])
    return [s for s in segs if s[1] > s[0]]


def _take_segment(free: list, want_rb: int):
    """Carve up to want_rb PRBs from the first non-empty free segment
    (mutates `free`).  Returns (rb_start, rb_count) or None."""
    for seg in free:
        if seg[1] > seg[0]:
            start = seg[0]
            count = min(want_rb, seg[1] - seg[0])
            seg[0] += count
            return start, count
    return None


@dataclasses.dataclass
class RaEvent:
    preamble: int
    tc_rnti: int
    rar_pending: bool = True


class CellScheduler:
    """Per-cell MAC scheduler emitting FAPI-shaped slot requests.

    slot_indication() must be called once per slot in order; indication
    handlers (handle_crc, handle_uci, handle_rach) feed results back,
    exactly like mac_cell_processor::handle_slot_indication +
    the scheduler's HARQ/feedback entry points.
    """

    def __init__(self, cell: CellConfig, phys_cell_id: int = 1,
                 ues: list | None = None, tdd: TddPattern | None = None,
                 prach: PrachConfig | None = None,
                 ssb_period_ms: int = 20, sib1_period_ms: int = 160,
                 prach_period_slots: int = 40, max_harq_retx: int = 4,
                 link_adaptation: bool = True, seed: int = 0,
                 policy: str = "time_rr", csi_period_slots: int = 0,
                 dl_prg_size: int = 4, paging_drx_frames: int = 32,
                 paging_nof_pf: int = 4, paging_po_slot: int = 1):
        self.cell = cell
        self.pci = phys_cell_id
        self.tdd = tdd or TddPattern()
        self.prach_cfg = prach
        self.ssb_period_ms = ssb_period_ms
        self.sib1_period_ms = sib1_period_ms
        self.prach_period_slots = prach_period_slots
        self.max_harq_retx = max_harq_retx
        self.link_adaptation = link_adaptation
        assert policy in ("time_rr", "time_qos"), policy
        self.policy = policy
        self._ewma = 0.05               # PF averaging constant
        self.rng = np.random.default_rng(seed)
        self.ues: dict[int, UeContext] = {}
        for u in (ues or []):
            self.ues[u.rnti] = UeContext(u)
        self._rr_dl = 0                     # round-robin cursors
        self._rr_ul = 0
        self._ra_events: list[RaEvent] = []
        self._pucch_owners: dict[int, list[int]] = {}
        # CSI reporting (uci_scheduler analogue): every csi_period_slots a
        # PUCCH F2 occasion per UE carries a packed wideband CSI report
        # (CRI/RI/PMI/CQI, ran/csi_report); 0 disables.  The codebook
        # follows the cell's port count.
        self.csi_period_slots = csi_period_slots
        self.dl_prg_size = dl_prg_size
        # admin state (E2SM-RC cell_stop/cell_start; the reference's du
        # config executor can deactivate a cell): False = no transmissions
        self.active = True
        cb = {1: "one", 2: "two", 4: "typeI_4ports"}.get(cell.nof_ports)
        self.csi_cfg = (csi_mod.CsiReportConfig(pmi_codebook=cb)
                        if cb is not None else None)
        self._csi_owners: dict[int, list[int]] = {}
        # Paging (TS38.304 §7.1): DRX cycle T frames, N paging frames per
        # cycle, fixed PO slot (paging_scheduler analogue).
        self.paging_drx_frames = paging_drx_frames
        self.paging_nof_pf = max(1, min(paging_nof_pf, paging_drx_frames))
        self.paging_po_slot = paging_po_slot
        self._paging_queue: list[int] = []
        self._next_tc_rnti = 0x4601 + len(self.ues)
        self._dmrs_dl = (2, 11)
        self._dmrs_ul = (2, 7, 11)
        self._coreset = CoresetConfig(
            rb_start=0, nof_rb=min(48, cell.nof_rb // 6 * 6),
            start_symbol=0, duration=1)
        # metrics counters (scheduler_metrics analogue)
        self.counters = {"dl_tbs_bits": 0, "ul_tbs_bits": 0, "dl_tx": 0,
                         "ul_tx": 0, "dl_retx": 0, "ul_retx": 0,
                         "rar_tx": 0, "crc_ok": 0, "crc_nok": 0}

    # ------------------------------------------------------------ slot run

    def slot_indication(self, slot: SlotPoint):
        """cell_scheduler::run_slot ordering: SSB -> SIB1 -> PRACH -> RAR ->
        UE DL/UL (lib/scheduler/cell_scheduler.cpp:89-150)."""
        dl_pdsch, dl_pdcch, payloads, dcis = [], [], [], []
        ssb, mibs = (), ()
        slots_per_ms = slot.nof_slots_per_subframe()
        is_dl = self.tdd.is_dl(slot.count) and self.active
        is_ul = self.tdd.is_ul(slot.count) and self.active

        used_rb_dl = 0
        if is_dl and slot.slot_index == 0 \
                and slot.sfn % max(self.ssb_period_ms // 10, 1) == 0:
            ssb = (SsbConfig(
                phys_cell_id=self.pci, ssb_idx=0, l_max=8, sfn=slot.sfn,
                first_symbol=2,
                first_subcarrier=(self.cell.nof_sc - 240) // 2),)
            mibs = (self.rng.integers(0, 2, 24).astype(np.int8),)

        # SIB1: a broadcast PDSCH with SI-RNTI on its period (offset to a
        # slot that is DL under the TDD pattern and SSB-free).
        if is_dl and slot.count % (self.sib1_period_ms * slots_per_ms) == 1:
            si_rb = min(24, self.cell.nof_rb)
            cfg = PdschConfig(
                rnti=0xFFFF, rb_start=0, rb_count=si_rb, first_symbol=1,
                nof_symbols=12, modulation="qpsk", target_code_rate=0.12,
                tbs=1736, nof_layers=1, n_id=self.pci,
                dmrs_symbols=self._dmrs_dl, dmrs_scrambling_id=self.pci,
                numerology=self.cell.numerology,
                slot_in_frame=slot.slot_index)
            dl_pdsch.append(cfg)
            payloads.append(self.rng.integers(0, 2, cfg.tbs).astype(np.int8))
            dl_pdcch.append(self._dci_for(0xFFFF, len(dl_pdcch)))
            dcis.append(self.rng.integers(0, 2, 40).astype(np.int8))
            used_rb_dl += si_rb

        # Paging occasion (paging_scheduler analogue): one P-RNTI PDSCH
        # carrying every due record on this UE group's paging frame.
        if is_dl and self._paging_queue \
                and slot.slot_index == self.paging_po_slot:
            t, n = self.paging_drx_frames, self.paging_nof_pf
            due = [uid for uid in self._paging_queue
                   if slot.sfn % t == (t // n) * (uid % n)]
            if due:
                pg_rb = min(6, self.cell.nof_rb - used_rb_dl)
                if pg_rb > 0:
                    # 48-bit 5G-S-TMSI record per paged UE (RRC paging);
                    # cap records to what the QPSK allocation can carry
                    # (G = data_re * 2 bits; leave >2x coding margin) —
                    # overflow pages wait for the next DRX cycle
                    cap = max((pg_rb * 12 * 10 * 2 // 2 - 16) // 48, 1)
                    due = due[:cap]
                    rec_bits = 48 * len(due)
                    from ..ran.mcs_tbs import TBS_TABLE_38214
                    tbs_pg = next(v for v in TBS_TABLE_38214
                                  if v >= rec_bits + 16)
                    cfg = PdschConfig(
                        rnti=0xFFFE, rb_start=used_rb_dl, rb_count=pg_rb,
                        first_symbol=1, nof_symbols=12, modulation="qpsk",
                        target_code_rate=0.12, tbs=tbs_pg, nof_layers=1,
                        n_id=self.pci, dmrs_symbols=self._dmrs_dl,
                        dmrs_scrambling_id=self.pci,
                        numerology=self.cell.numerology,
                        slot_in_frame=slot.slot_index)
                    rec = np.zeros(tbs_pg, np.int8)
                    for i, uid in enumerate(due):
                        for b in range(48):
                            rec[48 * i + b] = (uid >> (47 - b)) & 1
                    dl_pdsch.append(cfg)
                    payloads.append(rec)
                    dl_pdcch.append(self._dci_for(0xFFFE, len(dl_pdcch)))
                    dcis.append(self.rng.integers(0, 2, 40).astype(np.int8))
                    used_rb_dl += pg_rb
                    self._paging_queue = [u for u in self._paging_queue
                                          if u not in due]
                    self.counters["paging_tx"] = \
                        self.counters.get("paging_tx", 0) + len(due)

        # RAR for pending RA events (ra_scheduler analogue): DL PDSCH with
        # RA-RNTI carrying the Msg3 grant; creates the UE context.
        if is_dl:
            for ev in [e for e in self._ra_events if e.rar_pending]:
                rar_rb = min(6, self.cell.nof_rb - used_rb_dl)
                if rar_rb <= 0:
                    break
                cfg = PdschConfig(
                    rnti=0x0001 + ev.preamble, rb_start=used_rb_dl,
                    rb_count=rar_rb, first_symbol=1, nof_symbols=12,
                    modulation="qpsk", target_code_rate=0.12, tbs=456,
                    nof_layers=1, n_id=self.pci, dmrs_symbols=self._dmrs_dl,
                    dmrs_scrambling_id=self.pci,
                    numerology=self.cell.numerology,
                    slot_in_frame=slot.slot_index)
                dl_pdsch.append(cfg)
                payloads.append(
                    self.rng.integers(0, 2, cfg.tbs).astype(np.int8))
                dl_pdcch.append(self._dci_for(cfg.rnti, len(dl_pdcch)))
                dcis.append(self.rng.integers(0, 2, 40).astype(np.int8))
                used_rb_dl += rar_rb
                ev.rar_pending = False
                self.counters["rar_tx"] += 1
                if ev.tc_rnti not in self.ues:
                    self.ues[ev.tc_rnti] = UeContext(
                        SchedUeConfig(rnti=ev.tc_rnti))

        # UE DL: retransmissions first, then new TX round-robin.
        if is_dl:
            dl_list = self._schedule_dl(slot, used_rb_dl)
            for cfg, payload in dl_list:
                dl_pdsch.append(cfg)
                payloads.append(payload)
                dl_pdcch.append(self._dci_for(cfg.rnti, len(dl_pdcch)))
                dcis.append(self.rng.integers(0, 2, 40).astype(np.int8))

        dl = DlTtiRequest(slot=slot, ssb=ssb, pdcch=tuple(dl_pdcch),
                          pdsch=tuple(dl_pdsch))
        tx = TxDataRequest(slot=slot, pdsch_payloads=tuple(payloads),
                           pdcch_payloads=tuple(dcis), ssb_mib=mibs)

        # UL slot: PRACH occasion on its period, then PUSCH + PUCCH.
        pusch, harq_meta, pucch = [], [], []
        pucch_f2 = []
        prach = ()
        if is_ul:
            if self.prach_cfg is not None and \
                    slot.count % self.prach_period_slots == \
                    self.prach_period_slots - 1:
                prach = (self.prach_cfg,)
            # CSI occasions (uci_scheduler analogue) on the csi period:
            # a UE with a NEW PUSCH grant this slot carries the report ON
            # PUSCH (UCI multiplexing on collision, the reference's ulsch
            # mux: rank-restricted to the current rank so the part-2 size
            # is static); the rest get a PUCCH F2 occasion on the top
            # PRBs (below the F1 PRB), symbols 12-13.
            csi_due = (self.csi_period_slots and self.csi_cfg is not None
                       and slot.count % self.csi_period_slots
                       == self.csi_period_slots - 1)
            # Reserve F2 PRBs only for UEs that will NOT get a new PUSCH
            # grant (no UL data / no free HARQ): grant-holders' CSI rides
            # their PUSCH instead, so reserving for everyone would waste
            # up to one PRB per UE of UL capacity every CSI period.
            need_f2 = []
            if csi_due:
                need_f2 = [r for r, u in sorted(self.ues.items())
                           if not (u.cfg.nof_layers_ul == 1
                                   and (u.find_pending_retx(u.ul_harq)
                                        is not None
                                        or (u.has_ul_data()
                                            and u.find_free(u.ul_harq)
                                            is not None)))]
            pusch, harq_meta = self._schedule_ul(
                slot, reserved_top_rb=1 + len(need_f2))
            on_pusch = set()
            if csi_due:
                from ..ran.uci_on_pusch import UciOnPuschConfig
                for i, (cfg, (hid, new)) in enumerate(
                        zip(pusch, harq_meta)):
                    ue = self.ues.get(cfg.rnti)
                    # ue_tx's UCI multiplexer is single-layer; multi-layer
                    # UEs keep PUCCH F2
                    if not new or ue is None or cfg.nof_layers != 1:
                        continue
                    rank = max(1, min(ue.dl_layers, self.cell.nof_ports))
                    cfg_r = dataclasses.replace(
                        self.csi_cfg, ri_restriction=1 << (rank - 1))
                    cfg2 = dataclasses.replace(cfg, uci=UciOnPuschConfig(
                        o_csi1=csi_mod.part1_size(cfg_r),
                        o_csi2=csi_mod.part2_size(cfg_r, rank)))
                    pusch[i] = cfg2
                    ue.ul_harq[hid].cfg = cfg2
                    ue.pusch_csi_cfg = cfg_r
                    on_pusch.add(cfg.rnti)
            if csi_due:
                nbits = csi_mod.pucch_size(self.csi_cfg)
                # PRBs occupied by this slot's PUSCH (retx keep their
                # original span): an F2 occasion may not overlap them
                spans = [(c.rb_start, c.rb_start + c.rb_count)
                         for c in pusch]
                owners = []
                k = 0
                for rnti in sorted(self.ues):
                    if rnti in on_pusch:
                        continue
                    rb0 = self.cell.nof_rb - 2 - k
                    if rb0 <= 0:
                        break
                    if any(a <= rb0 < b for a, b in spans):
                        continue      # collided with a retx: report next period
                    pucch_f2.append(PucchF2Config(
                        rb_start=rb0, nof_rb=1, start_symbol=12,
                        nof_symbols=2, rnti=rnti, n_id=self.pci,
                        n_id0=self.pci, nof_uci_bits=nbits,
                        slot=slot.slot_index))
                    owners.append(rnti)
                    k += 1
                self._csi_owners[slot.count] = owners
            # one PUCCH F1 occasion per UE with a DL HARQ awaiting ACK
            # (simplified UCI allocator: shared PRB, distinct cyclic shifts)
            ics = 0
            owners = []
            for rnti, ue in self.ues.items():
                if any(h.active and h.awaiting_ack for h in ue.dl_harq):
                    pucch.append(PucchF1Config(
                        prb=self.cell.nof_rb - 1, start_symbol=0,
                        nof_symbols=14, initial_cyclic_shift=ics % 12,
                        time_domain_occ=0, n_id=self.pci,
                        slot=slot.slot_index))
                    owners.append(rnti)
                    ics += 3
            self._pucch_owners[slot.count] = owners
        ul = UlTtiRequest(slot=slot, pusch=tuple(pusch),
                          pusch_harq=tuple(harq_meta),
                          pucch_f1=tuple(pucch), pucch_f2=tuple(pucch_f2),
                          prach=prach)
        return dl, tx, ul

    # ----------------------------------------------------------- policies

    def _dci_for(self, rnti: int, idx: int) -> PdcchConfig:
        nof_cce = self._coreset.nof_rb // 6
        return PdcchConfig(
            coreset=self._coreset, rnti=rnti, aggregation_level=4,
            cce_index=(4 * idx) % max(nof_cce - 3, 1), payload_bits=40,
            n_id=self.pci, n_id_data=self.pci)

    def _rr_order(self, cursor: int) -> list:
        keys = sorted(self.ues.keys())
        if not keys:
            return []
        k = cursor % len(keys)
        return keys[k:] + keys[:k]

    def _policy_order(self, cursor: int, dl: bool) -> list:
        """Candidate ordering per policy: time_rr rotates a cursor
        (scheduler_time_rr.cpp); time_qos ranks by qos_weight / average
        delivered rate — the qos-weighted proportional-fair metric of
        scheduler_time_qos.cpp."""
        if self.policy == "time_rr":
            return self._rr_order(cursor)

        def prio(rnti):
            ue = self.ues[rnti]
            avg = ue.avg_rate_dl if dl else ue.avg_rate_ul
            return -ue.cfg.qos_weight / max(avg, 1.0)

        return sorted(self.ues.keys(), key=prio)

    def _rb_shares(self, avail: int, cands: list) -> dict:
        """PRBs per new grant: equal split (time_rr) or qos_weight-
        proportional (time_qos)."""
        if not cands:
            return {}
        if self.policy == "time_rr":
            share = max(avail // len(cands), 1)
            return {r: share for r in cands}
        total_w = sum(self.ues[r].cfg.qos_weight for r in cands)
        return {r: max(int(avail * self.ues[r].cfg.qos_weight / total_w), 1)
                for r in cands}

    def _update_avg_rates(self, granted: dict, dl: bool):
        a = self._ewma
        for rnti, ue in self.ues.items():
            g = float(granted.get(rnti, 0))
            if dl:
                ue.avg_rate_dl = (1 - a) * ue.avg_rate_dl + a * g
            else:
                ue.avg_rate_ul = (1 - a) * ue.avg_rate_ul + a * g

    def _schedule_dl(self, slot: SlotPoint, used_rb: int):
        """Time-RR with retx priority (scheduler_time_rr.cpp semantics)."""
        out = []
        avail = self.cell.nof_rb - used_rb
        order = self._policy_order(self._rr_dl, dl=True)
        self._rr_dl += 1
        # retransmissions keep their original allocation size
        cands_retx, cands_new = [], []
        for rnti in order:
            ue = self.ues[rnti]
            if ue.find_pending_retx(ue.dl_harq) is not None:
                cands_retx.append(rnti)
            elif ue.has_dl_data() and ue.find_free(ue.dl_harq) is not None:
                cands_new.append(rnti)
        grants = cands_retx + cands_new
        if not grants:
            self._update_avg_rates({}, dl=True)
            return out
        # Retransmissions keep their original PRB allocation (HARQ soft
        # buffers are allocation-shaped); new grants fill around them.
        occupied = []
        for rnti in cands_retx:
            ue = self.ues[rnti]
            h = ue.dl_harq[ue.find_pending_retx(ue.dl_harq)]
            # a retx keeps its original PRB span (soft buffers are
            # allocation-shaped); if that span now overlaps this slot's
            # broadcast region (SIB1/RAR/paging, PRBs [0, used_rb)),
            # DEFER the retx to a later slot rather than colliding
            if h.cfg.rb_start < used_rb:
                continue
            h.retx()
            cfg = dataclasses.replace(
                h.cfg, rv=h.rv, slot_in_frame=slot.slot_index)
            h.cfg = cfg
            out.append((cfg, h.payload))
            occupied.append((cfg.rb_start, cfg.rb_start + cfg.rb_count))
            self.counters["dl_retx"] += 1
        free = _free_segments(used_rb, self.cell.nof_rb, occupied)
        avail = sum(b - a for a, b in free)
        if not cands_new or avail <= 0:
            self._update_avg_rates({}, dl=True)
            return out
        shares = self._rb_shares(avail, cands_new)
        granted_bits = {}
        for rnti in cands_new:
            ue = self.ues[rnti]
            seg = _take_segment(free, shares[rnti])
            if seg is None:
                break
            rb_cursor, rb_count = seg
            hid = ue.find_free(ue.dl_harq)
            # DL link adaptation: CQI-driven MCS + RI-driven layer count
            # once the UE has reported (handle_csi); configured defaults
            # until then (ue_link_adaptation_controller analogue).
            dl_mcs = ue.dl_mcs if self.link_adaptation else ue.cfg.dl_mcs
            if ue.mcs_cap is not None:
                dl_mcs = min(dl_mcs, ue.mcs_cap)
            layers = (ue.dl_layers if self.link_adaptation
                      else ue.cfg.nof_layers_dl)
            mod, rate = mcs_config(ue.cfg.mcs_table, dl_mcs)
            t = tbs_calc(rb_count, 12, 12 * len(self._dmrs_dl), mod, rate,
                         layers)
            if ue.dl_buffer > 0:
                t = min(t, ue.dl_buffer * 8)
                ue.dl_buffer = max(ue.dl_buffer - t // 8, 0)
            cfg = PdschConfig(
                rnti=rnti, rb_start=rb_cursor, rb_count=rb_count,
                first_symbol=1, nof_symbols=12, modulation=mod,
                target_code_rate=rate, tbs=t,
                nof_layers=layers, n_id=self.pci,
                dmrs_symbols=self._dmrs_dl, dmrs_scrambling_id=self.pci,
                numerology=self.cell.numerology,
                slot_in_frame=slot.slot_index,
                precoding=self._precoding_for(ue, rb_cursor, rb_count,
                                              layers))
            payload = self.rng.integers(0, 2, t).astype(np.int8)
            ue.dl_harq[hid].new_tx(cfg, payload)
            out.append((cfg, payload))
            granted_bits[rnti] = t
            self.counters["dl_tx"] += 1
            self.counters["dl_tbs_bits"] += t
        self._update_avg_rates(granted_bits, dl=True)
        return out

    def _prach_guard_rb(self) -> int:
        """PRBs reserved for the PRACH region (prach_scheduler keeps PUSCH
        off the occasion PRBs; here a static low-band guard like the
        reference's PUCCH guardbands)."""
        if self.prach_cfg is None:
            return 0
        scs = 15_000 << self.cell.numerology
        return -(-139 * self.prach_cfg.scs_hz // (12 * scs)) + 1

    def _schedule_ul(self, slot: SlotPoint, reserved_top_rb: int = 1):
        pusch, meta = [], []
        rb_lo = self._prach_guard_rb()
        # top PRBs reserved for PUCCH (F1 + this slot's CSI F2 occasions)
        avail = self.cell.nof_rb - reserved_top_rb
        order = self._policy_order(self._rr_ul, dl=False)
        self._rr_ul += 1
        cands = []
        for rnti in order:
            ue = self.ues[rnti]
            if ue.find_pending_retx(ue.ul_harq) is not None or (
                    ue.has_ul_data()
                    and ue.find_free(ue.ul_harq) is not None):
                cands.append(rnti)
        if not cands:
            self._update_avg_rates({}, dl=False)
            return pusch, meta
        occupied = []
        cands_new = []
        for rnti in cands:
            ue = self.ues[rnti]
            hid = ue.find_pending_retx(ue.ul_harq)
            if hid is None:
                cands_new.append(rnti)
                continue
            h = ue.ul_harq[hid]
            h.retx()
            cfg = dataclasses.replace(
                h.cfg, rv=h.rv, slot_in_frame=slot.slot_index)
            h.cfg = cfg
            pusch.append(cfg)
            meta.append((hid, False))         # soft-combine
            occupied.append((cfg.rb_start, cfg.rb_start + cfg.rb_count))
            self.counters["ul_retx"] += 1
        free = _free_segments(rb_lo, avail, occupied)
        n_free = sum(b - a for a, b in free)
        if not cands_new or n_free <= 0:
            self._update_avg_rates({}, dl=False)
            return pusch, meta
        shares = self._rb_shares(n_free, cands_new)
        granted_bits = {}
        for rnti in cands_new:
            ue = self.ues[rnti]
            seg = _take_segment(free, shares[rnti])
            if seg is None:
                break
            rb_cursor, rb_count = seg
            hid = ue.find_free(ue.ul_harq)
            mcs = ue.ul_mcs if self.link_adaptation else ue.cfg.ul_mcs
            if ue.mcs_cap is not None:
                mcs = min(mcs, ue.mcs_cap)
            mod, rate = mcs_config(ue.cfg.mcs_table, mcs)
            t = tbs_calc(rb_count, 14, 12 * len(self._dmrs_ul), mod, rate,
                         ue.cfg.nof_layers_ul)
            if ue.ul_buffer > 0:
                t = min(t, ue.ul_buffer * 8)
                ue.ul_buffer = max(ue.ul_buffer - t // 8, 0)
            cfg = PuschConfig(
                rnti=rnti, rb_start=rb_cursor, rb_count=rb_count,
                first_symbol=0, nof_symbols=14, modulation=mod,
                target_code_rate=rate, tbs=t,
                nof_layers=ue.cfg.nof_layers_ul, n_id=self.pci,
                dmrs_symbols=self._dmrs_ul, dmrs_scrambling_id=self.pci,
                numerology=self.cell.numerology,
                slot_in_frame=slot.slot_index)
            ue.ul_harq[hid].new_tx(cfg)
            pusch.append(cfg)
            meta.append((hid, True))
            granted_bits[rnti] = t
            self.counters["ul_tx"] += 1
            self.counters["ul_tbs_bits"] += t
        self._update_avg_rates(granted_bits, dl=False)
        return pusch, meta

    def _precoding_for(self, ue: UeContext, rb_start: int, rb_count: int,
                       layers: int) -> PrecodingConfig | None:
        """UE's reported PMI -> per-PRG precoding config for a new DL grant
        (the fapi_adaptor precoding_matrix_mapper direction: MAC PMI ->
        FAPI PM indices).  Wideband PMI repeats over the allocation's PRGs;
        None (identity) until the UE reports or when the codebook has no
        PMI (1 port)."""
        csi = ue.last_csi
        if (csi is None or self.csi_cfg is None
                or self.csi_cfg.quantities != "cri_ri_pmi_cqi"
                or self.cell.nof_ports not in (2, 4)
                or layers != csi.ri):
            return None
        idx = pmi_to_index(self.cell.nof_ports, ri=csi.ri,
                           i_1_1=csi.i_1_1, i_1_3=csi.i_1_3, i_2=csi.i_2)
        n = nof_prgs(rb_start, rb_count, self.dl_prg_size)
        return PrecodingConfig(prg_size=self.dl_prg_size,
                               pm_indices=(idx,) * n)

    # ------------------------------------------------------- RIC control

    def apply_ric_control(self, action: str, params: dict) -> dict:
        """E2SM-RC control executor (e2sm_rc_control_action_du_executor
        analogue): a RIC control request changes scheduler behavior from
        the next slot_indication on.  Raises on bad parameters (the agent
        converts that into ric_control_failure)."""
        if action == "set_ue_mcs_cap":
            ue = self.ues[int(params["rnti"])]
            cap = params.get("max_mcs")
            ue.mcs_cap = None if cap is None else int(cap)
            return {"rnti": int(params["rnti"]), "max_mcs": ue.mcs_cap}
        if action == "set_ue_qos_weight":
            ue = self.ues[int(params["rnti"])]
            ue.cfg = dataclasses.replace(
                ue.cfg, qos_weight=float(params["qos_weight"]))
            return {"rnti": int(params["rnti"]),
                    "qos_weight": ue.cfg.qos_weight}
        if action == "cell_stop":
            self.active = False
            return {"active": False}
        if action == "cell_start":
            self.active = True
            return {"active": True}
        raise ValueError(f"unknown control action {action!r}")

    # -------------------------------------------------------- indications

    def handle_csi(self, rnti: int, csi_bits) -> None:
        """PUCCH CSI report -> DL link adaptation (the piece the reference
        implements in csi_report_unpack_pucch + ue_link_adaptation):
        wideband CQI drives dl_mcs, RI drives the layer count, PMI feeds
        _precoding_for on the next grant."""
        ue = self.ues.get(rnti)
        if ue is None or self.csi_cfg is None or csi_bits is None:
            return
        try:
            data = csi_mod.unpack_pucch(csi_bits, self.csi_cfg)
        except AssertionError:
            return                        # malformed report: keep last state
        ue.last_csi = data
        if self.link_adaptation:
            ue.dl_mcs = csi_mod.cqi_to_mcs(data.wideband_cqi,
                                           ue.cfg.mcs_table)
            ue.dl_layers = max(1, min(data.ri, self.cell.nof_ports, 4))
        self.counters["csi_reports"] = self.counters.get("csi_reports", 0) + 1

    def handle_csi_pusch(self, rnti: int, csi1_bits,
                         csi2_bits=None) -> None:
        """Aperiodic CSI multiplexed on PUSCH -> DL link adaptation: the
        report was requested rank-restricted to the UE's current rank, so
        part sizes are static and the interpretation config is known."""
        ue = self.ues.get(rnti)
        if ue is None or ue.pusch_csi_cfg is None or csi1_bits is None:
            return
        try:
            data = csi_mod.unpack(csi1_bits, csi2_bits, ue.pusch_csi_cfg)
        except AssertionError:
            return
        ue.last_csi = data
        if self.link_adaptation:
            ue.dl_mcs = csi_mod.cqi_to_mcs(data.wideband_cqi,
                                           ue.cfg.mcs_table)
        self.counters["csi_reports"] = self.counters.get(
            "csi_reports", 0) + 1

    def handle_crc(self, rnti: int, harq_id: int, crc_ok: bool,
                   snr_db: float | None = None):
        """CRC indication -> UL HARQ ack/nack + link adaptation."""
        ue = self.ues.get(rnti)
        if ue is None:
            return
        h = ue.ul_harq[harq_id % NOF_HARQ_PROCESSES]
        self.counters["crc_ok" if crc_ok else "crc_nok"] += 1
        if crc_ok:
            h.stop()
        else:
            h.awaiting_ack = False           # eligible for retx
            if h.nof_retx >= self.max_harq_retx:
                h.stop()                     # drop the TB (reference: NACKed out)
        if snr_db is not None and self.link_adaptation:
            ue.last_ul_snr_db = snr_db
            ue.ul_mcs = snr_to_mcs(snr_db, ue.cfg.mcs_table)

    def handle_uci(self, rnti: int, harq_ack_bits) -> None:
        """UCI (PUCCH) indication -> DL HARQ ack/nack.

        Acks the oldest awaiting DL HARQ per bit, mirroring the reference's
        HARQ-ACK codebook walk (simplified to in-order)."""
        ue = self.ues.get(rnti)
        if ue is None:
            return
        bits = np.atleast_1d(np.asarray(harq_ack_bits))
        awaiting = [h for h in ue.dl_harq if h.active and h.awaiting_ack]
        for h, b in zip(awaiting, bits):
            if int(b) == 0:                  # 0 = ACK in our convention
                h.stop()
            else:
                h.awaiting_ack = False
                if h.nof_retx >= self.max_harq_retx:
                    h.stop()

    def handle_uci_indications(self, slot_count: int, uci_pdus) -> None:
        """Map positional PUCCH indications of a slot back to their UEs
        (the owners recorded at scheduling time): F1 -> HARQ feedback,
        F2 -> CSI reports.  Indication order follows the conductor's
        SlotResults.uci (F1 PDUs then F2 PDUs for this scheduler's plans).
        A non-detected F1 occasion counts as DTX -> NACK, like the
        reference's uci_scheduler handling of missing HARQ-ACK."""
        owners = self._pucch_owners.pop(slot_count, [])
        csi_owners = self._csi_owners.pop(slot_count, [])
        if csi_owners:
            f2_pdus = uci_pdus[len(owners):len(owners) + len(csi_owners)]
            for rnti, pdu in zip(csi_owners, f2_pdus):
                if getattr(pdu, "detected", False):
                    self.handle_csi(rnti, getattr(pdu, "csi_bits", None))
            uci_pdus = uci_pdus[:len(owners)]
        for rnti, pdu in zip(owners, uci_pdus):
            detected = getattr(pdu, "detected", None)
            bits = getattr(pdu, "harq_bits", None)
            if detected:
                self.handle_uci(rnti, bits)
            else:
                ue = self.ues.get(rnti)
                if ue is None:
                    continue
                for h in ue.dl_harq:
                    if h.active and h.awaiting_ack:
                        h.awaiting_ack = False
                        if h.nof_retx >= self.max_harq_retx:
                            h.stop()
                        break

    #: Bound on concurrently pending RA procedures: the reference's RACH
    #: handler likewise caps outstanding RARs (scheduler cell config
    #: ra_sched limits); an unbounded flood would otherwise inflate the
    #: slot plans (one RAR PDSCH per event) without bound.
    MAX_PENDING_RA = 16

    #: Bound on queued paging records (the RA-event cap's analogue): an
    #: unbounded flood would otherwise grow the queue without limit.
    MAX_PENDING_PAGING = 64

    def page_ue(self, ue_id_5g: int) -> None:
        """Enqueue a paging record (48-bit 5G-S-TMSI); it transmits in a
        P-RNTI PDSCH on the UE's paging frame (mac paging_information
        handler analogue).  Dropped + counted when the queue is full."""
        if len(self._paging_queue) >= self.MAX_PENDING_PAGING:
            self.counters["paging_dropped"] = self.counters.get(
                "paging_dropped", 0) + 1
            return
        self._paging_queue.append(int(ue_id_5g) & ((1 << 48) - 1))

    def handle_rach(self, preamble_index: int) -> int:
        """RACH indication -> RA event + TC-RNTI (mac_rach_handler).

        Returns 0 when the RA queue is full (event dropped + counted)."""
        if len([e for e in self._ra_events if e.rar_pending]) \
                >= self.MAX_PENDING_RA:
            self.counters["ra_dropped"] = self.counters.get(
                "ra_dropped", 0) + 1
            return 0
        tc = self._next_tc_rnti
        self._next_tc_rnti += 1
        self._ra_events.append(RaEvent(preamble=preamble_index, tc_rnti=tc))
        return tc
