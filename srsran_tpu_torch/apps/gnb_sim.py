"""gnb_sim — run the gNB PHY at line rate with a MAC, on the card.

Port of apps/gnb_sim.py (the reference's gnb application in its MAC test
mode, apps/gnb/gnb.cpp + mac_test_mode_adapter): a MAC -- the test-mode
traffic generator, or the cell scheduler with HARQ, CSI link adaptation,
per-PRG precoding, RACH and paging -- schedules DL and UL per the TDD
pattern; the slot conductor drives the slot programs; a UE emulator closes
the UL loop through the same chain blocks, over an optional TDL fading
channel (K20).  In scheduler mode with PRACH the UL samples pass through
the lower-PHY baseband processor, whose PRACH collector demodulates each
completed window (K21).  Prints per-stage metrics and the slot rate at the
end.

Runs on the CUDA device unless the caller names another (``run(cfg,
device="cpu")`` in the tests, where the kernels' plain twins run).  The
UE-side HARQ buffers live in a per-run object; the channel's generator is
seeded per UL slot from the slot count (a CPU and a CUDA generator draw
differently, and neither as ``jax.random`` does).  The registry times of
``dl_slot`` / ``ul_slot`` measure the launch (enqueue) only, as in the
JAX app; on CUDA each slot program is also bracketed by CUDA events, and
the median device span over the last ``EVENT_WINDOW`` DL and UL slots is
printed and returned (``result["slot_device_us"]``).

Usage:
  python -m srsran_tpu_torch.apps.gnb_sim [-c config.yaml]
      [--set run.nof_slots=200] [--trace out.json] [--page 0x1234]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from ..device import require_cuda
from ..emulation import channel as chan
from ..fapi.conductor import SlotConductor, normalize_dl_plan
from ..fapi.messages import DlTtiRequest
from ..mac.scheduler import CellScheduler, SchedUeConfig
from ..mac.test_mode import TestModeMac
from ..ops import ofdm
from ..phy.lower.baseband import BasebandProcessor, PrachOccasionRequest
from ..phy.slot_programs import CellConfig, dl_slot_fn
from ..phy.upper import prach as prach_mod
from ..phy.upper import pucch as pucch_mod
from ..phy.upper import ue_tx as ue_tx_mod
from ..phy.upper.pdsch import PdschConfig
from ..phy.upper.prach import PrachConfig
from ..ran import csi_report as csi_mod
from ..ran.prach_params import SHORT_FORMATS, zc_sequence
from ..ran.slot_point import SlotPoint
from ..utils import config as config_mod
from ..utils import resource_usage
from ..utils.metrics import MetricsRegistry
from ..utils.tracing import EventTracer

_NOT_PORTED = "is not ported yet (ROADMAP §1 item 16)"
EVENT_WINDOW = 64          # slots of each kind whose CUDA events are kept


def run(cfg: config_mod.AppConfig, device=None, trace: str = "",
        pages=(), verbose: bool = True) -> dict:
    """Run ``cfg.nof_slots`` slots; print the JAX app's lines (unless
    ``verbose`` is False) and return its counters:
    crc_ok, crc_fail, dl_slots, ul_slots; prach: (slot, preamble, TC-RNTI,
    metric) per detection; counters: the scheduler's (None in test mode);
    prach_windows: PRACH windows the baseband completed; elapsed_s; report:
    the registry's per-block summaries; slot_device_us: on CUDA, per kind
    ("dl", "ul") the median device span of the slot program by CUDA events
    over the last ``EVENT_WINDOW`` slots and their number, (us, n)."""
    dev = require_cuda() if device is None else torch.device(device)
    out = print if verbose else (lambda *a, **k: None)
    tracer = EventTracer(enabled=bool(trace))
    registry = MetricsRegistry()
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    out(f"gnb_sim: cell {cfg.cell.nof_rb} RB mu={cfg.cell.numerology} "
        f"{cfg.cell.nof_ports} ports, {len(cfg.ues)} UE(s), "
        f"{cfg.nof_slots} slots on {where}")

    use_sched = cfg.mac == "sched"
    bb = bb_ru = prach_cfg = None
    bb_stash: dict = {}
    if use_sched:
        if cfg.prach_period_slots > 0:
            # PRACH occasions route through the lower-PHY baseband collector
            # FSM (host-sample path, like samples arriving from a radio).
            prach_cfg = PrachConfig(
                format="B4", root_sequence_index=1, zero_correlation_zone=0,
                ra_scs_hz=15_000 << cfg.cell.numerology)
            out("note: PRACH host-sample path active; slot timings are "
                "functional only")
            bb_ru = _UlFeedRu()
            bb = BasebandProcessor(
                bb_ru, nof_ports=cfg.cell.nof_ports,
                dft_size=cfg.cell.dft_size, numerology=cfg.cell.numerology,
                rx_notifier=lambda s, x, ts: bb_stash.update(samples=x),
                prach_notifier=lambda req, fd: bb_stash.setdefault(
                    "prach_fd", []).append(fd), device=dev)
            bb.start()
        sched = CellScheduler(
            cfg.cell, cfg.phys_cell_id,
            ues=[SchedUeConfig(rnti=u.rnti, mcs_table=u.mcs_table,
                               dl_mcs=u.mcs_index,
                               ul_mcs=min(u.mcs_index, 25),
                               nof_layers_dl=u.nof_layers_dl,
                               nof_layers_ul=u.nof_layers_ul)
                 for u in cfg.ues],
            tdd=cfg.tdd, seed=cfg.seed, prach=prach_cfg,
            prach_period_slots=max(cfg.prach_period_slots, 1),
            csi_period_slots=cfg.csi_period_slots,
            # short DRX cycle + PO on a DL slot so short sim drives hit
            # the paging frame (deployment values are ctor defaults)
            **({"paging_drx_frames": 4, "paging_po_slot": 0}
               if pages else {}))
        for pid in pages:
            sched.page_ue(int(pid, 0) if isinstance(pid, str) else int(pid))
        mac = None
    else:
        if pages:
            out("warning: --page requires run.mac=sched; ignored")
        sched = None
        mac = TestModeMac(cfg.cell, cfg.phys_cell_id, cfg.ues, cfg.tdd,
                          cfg.seed)
    ue = _UeEmulator(cfg, dev)
    cond = SlotConductor(cfg.cell, device=dev)
    m_dl = registry.block("dl_slot")
    m_ul = registry.block("ul_slot")
    events = {kind: collections.deque(maxlen=EVENT_WINDOW)
              for kind in ("dl", "ul")}

    def timed(kind, fn):
        if dev.type != "cuda":
            return fn()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        result = fn()
        end.record()
        events[kind].append((start, end))
        return result

    usage0 = resource_usage.snapshot()
    res = {"crc_ok": 0, "crc_fail": 0, "dl_slots": 0, "ul_slots": 0,
           "prach": []}

    def consume_ul(pending, ul, launch_count):
        r = pending.resolve()
        for rach in r.rach:
            tc = sched.handle_rach(rach.preamble_index)
            res["prach"].append((launch_count, rach.preamble_index, tc,
                                 rach.metric))
            out(f"slot {launch_count}: PRACH preamble {rach.preamble_index} "
                f"detected (metric {rach.metric:.1f}) -> TC-RNTI 0x{tc:04x}")
        for c, (hid, _) in zip(r.crc, ul.pusch_harq or ()):
            res["crc_ok"] += int(c.tb_crc_ok)
            res["crc_fail"] += int(not c.tb_crc_ok)
            if use_sched:
                sched.handle_crc(c.rnti, hid, bool(c.tb_crc_ok), c.snr_db)
        if use_sched:
            for u in r.uci:
                # gate on the decode validity flag (like the F2 path's
                # `detected`): garbage CSI at low SINR must not drive
                # link adaptation to max MCS
                if u.source == "pusch" and u.detected \
                        and u.csi_bits is not None:
                    sched.handle_csi_pusch(u.rnti, u.csi_bits, u.csi2_bits)
            sched.handle_uci_indications(
                launch_count, [u for u in r.uci if u.source != "pusch"])

    ul_inflight = collections.deque()
    t_start = time.monotonic()
    for count in range(cfg.nof_slots):
        slot = SlotPoint(cfg.cell.numerology, count)
        with tracer.span("slot", count=count):
            if use_sched:
                dl, tx, ul = sched.slot_indication(slot)
            if cfg.tdd.is_dl(slot.count):
                if not use_sched:
                    dl, tx = mac.dl_requests(slot)
                if dl.pdsch or dl.ssb:
                    with m_dl.measure(units=1), tracer.span("dl_slot"):
                        timed("dl", lambda: cond.process_dl(dl, tx))
                    res["dl_slots"] += 1
            if cfg.tdd.is_ul(slot.count):
                if not use_sched:
                    ul = mac.ul_requests(slot)
                if ul.pusch or (bb is not None and ul.prach):
                    # UE TX emulation: run the same chain as a waveform source
                    ue_tx = ue.transmit(ul, mac, sched)
                    prach_fds = ()
                    if bb is not None:
                        ul, ue_tx, prach_fds = _through_baseband(
                            bb, bb_ru, bb_stash, ul, ue_tx, sched, prach_cfg,
                            cfg.cell, dev)
                    with m_ul.measure(units=1), tracer.span("ul_slot"):
                        pending = timed("ul", lambda: cond.process_ul(
                            ul, ue_tx, prach_fd=prach_fds))
                    ul_inflight.append((pending, ul, slot.count))
                    while len(ul_inflight) > max(cfg.resolve_lag, 0):
                        consume_ul(*ul_inflight.popleft())
                    res["ul_slots"] += 1
                elif use_sched:
                    sched.handle_uci_indications(slot.count, [])
    while ul_inflight:                 # drain deferred indications
        consume_ul(*ul_inflight.popleft())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.monotonic() - t_start
    slot_device_us = {
        kind: (statistics.median(1e3 * a.elapsed_time(b) for a, b in q),
               len(q)) for kind, q in events.items() if q}

    out(f"done: {cfg.nof_slots} slots in {elapsed:.2f}s "
        f"({cfg.nof_slots / elapsed:.0f} slots/s wall; "
        f"{res['dl_slots']} DL, {res['ul_slots']} UL)")
    out(f"UL CRC: {res['crc_ok']} ok / {res['crc_fail']} failed")
    if use_sched:
        out(f"scheduler: {sched.counters}")
    for kind, (us, n) in slot_device_us.items():
        out(f"  {kind}_slot device span: median {us:.0f}us over the last "
            f"{n} (CUDA events)")
    report = registry.report()
    for s in report:
        if s.get("count"):
            out(f"  {s['name']}: avg {s['lat_us_avg']:.0f}us "
                f"p99 {s['lat_us_p99']:.0f}us max {s['lat_us_max']:.0f}us")
    out(f"resource usage: "
        f"{resource_usage.diff(usage0, resource_usage.snapshot())}")
    if trace:
        tracer.dump(trace)
        out(f"trace written to {trace}")
    res.update(counters=dict(sched.counters) if use_sched else None,
               prach_windows=bb.metrics["prach_windows"] if bb else 0,
               elapsed_s=elapsed, report=report,
               slot_device_us=slot_device_us)
    return res


def _through_baseband(bb, bb_ru, bb_stash, ul, ue_tx, sched, prach_cfg,
                      cell, dev) -> tuple:
    """Route one UL slot's samples through the lower-PHY baseband loop:
    PRACH windows are collected by its FSM, the slot samples come back via
    the rx notifier.  Returns (ul, samples on the device, PRACH captures)."""
    ue_np = ue_tx.cpu().numpy()
    if ul.prach:
        pre_idx = int(sched.rng.integers(0, 16))
        # PRACH rides the low edge of the grid — the PRBs _prach_guard_rb()
        # reserves — which is NEGATIVE baseband frequency (grid SC 0 maps
        # to -nof_sc/2 * scs after the half-spectrum swap).  Waveform and
        # demod window agree.
        scs = 15_000 << cell.numerology
        prach_f0 = -(cell.nof_sc // 2) * scs
        ue_np = ue_np + _ue_prach_waveform(prach_cfg, pre_idx, cell,
                                           ue_np.shape,
                                           freq_offset_hz=prach_f0)
        bb.request_prach(PrachOccasionRequest(
            slot=bb.current_slot, start_sample=0, fmt=prach_cfg.format,
            freq_offset_hz=prach_f0, ra_scs_hz=prach_cfg.scs_hz))
    bb_stash.pop("prach_fd", None)
    bb_ru.push(ue_np)
    bb.push_dl(bb.current_slot, np.zeros_like(ue_np))   # rx-only tick
    bb.tick()
    samples = torch.from_numpy(bb_stash["samples"]).to(dev)
    prach_fds = tuple(bb_stash.get("prach_fd", ()))
    if len(prach_fds) < len(ul.prach):
        # a window straddling the slot boundary has not completed yet —
        # defer those PDUs (the FSM notifies on a later tick)
        ul = dataclasses.replace(ul, prach=ul.prach[:len(prach_fds)])
    return ul, samples, prach_fds


class _UlFeedRu:
    """RadioUnit served one UL slot block at a time (UE emulator feeds it,
    the baseband processor consumes it — the rx half of a radio session)."""

    def __init__(self):
        self._q = collections.deque()
        self._ts = 0

    def start(self):
        pass

    def stop(self):
        pass

    def send_dl(self, samples, timestamp=0):
        pass

    def push(self, samples):
        self._q.append(np.asarray(samples, dtype=np.complex64))

    def receive_ul(self, count):
        if not self._q:
            return None
        s = self._q.popleft()
        if s.shape[-1] != count:
            raise ValueError(f"UL block of {s.shape[-1]} samples, slot "
                             f"needs {count}")
        ts, self._ts = self._ts, self._ts + count
        return s, ts


def _ue_prach_waveform(prach_cfg, preamble, cell, shape,
                       freq_offset_hz: float = 0.0):
    """Short-preamble time waveform at the cell rate (UE-side TX, host
    numpy so no device round trip happens on the PRACH path).

    freq_offset_hz positions the preamble's first RA subcarrier in baseband
    (negative = below DC = low grid PRBs) — must match the demod window's
    PrachOccasionRequest.freq_offset_hz."""
    roots, pmap, _ = prach_mod._root_set(prach_cfg)
    root_idx, cs = pmap[prach_cfg.start_preamble + preamble]
    td_seq = zc_sequence(roots[root_idx], prach_cfg.l_ra, cs)
    fd = np.fft.fft(td_seq) / np.sqrt(prach_cfg.l_ra)
    fs = cell.dft_size * (15_000 << cell.numerology)
    n_u = fs // prach_cfg.scs_hz
    first_bin = int(round(freq_offset_hz / prach_cfg.scs_hz)) % n_u
    spec = np.zeros(n_u, dtype=np.complex64)
    bins = (first_bin + np.arange(fd.shape[0])) % n_u
    spec[bins] = fd
    td = np.fft.ifft(spec) * np.sqrt(n_u)       # unitary, matches prach_demod
    sig = np.tile(td, SHORT_FORMATS[prach_cfg.format]).astype(np.complex64)
    out = np.zeros(shape, dtype=np.complex64)
    out[:, : sig.shape[0]] = sig[None, :]
    return out


class _UeEmulator:
    """The UE side of the loop for one run: builds each UL slot's waveform
    for its PUSCH PDUs (and PUCCH occasions in scheduler mode), keeping the
    UE's HARQ buffers: a retransmission resends the SAME transport block."""

    def __init__(self, cfg: config_mod.AppConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.harq_tbs: dict = {}        # (rnti, harq_id) -> payload bits
        c = cfg.cell
        self.cell = CellConfig(nof_ports=c.nof_ports, nof_rb=c.nof_rb,
                               dft_size=c.dft_size, numerology=c.numerology,
                               center_freq_hz=c.center_freq_hz)

    def _tb(self, rng, pu, hid: int, new: bool) -> np.ndarray:
        key = (pu.rnti, hid)
        if new or key not in self.harq_tbs \
                or len(self.harq_tbs[key]) != pu.tbs:
            self.harq_tbs[key] = rng.integers(0, 2, pu.tbs).astype(np.int8)
        return self.harq_tbs[key]

    def _modulate(self, grid, slot_in_sf):
        c = self.cfg.cell
        return ofdm.modulate_slot(grid, c.dft_size, c.numerology,
                                  slot_in_subframe=slot_in_sf,
                                  center_freq_hz=c.center_freq_hz)

    def transmit(self, ul, mac=None, sched=None) -> torch.Tensor:
        """The UL waveform [P, T] on the device.  In scheduler mode (sched
        not None), HARQ retransmissions resend the same transport block,
        and PUCCH F1 occasions carry ACKs so the DL HARQ loop closes."""
        cfg, dev = self.cfg, self.device
        rng = sched.rng if sched is not None else mac.rng
        harq_meta = ul.pusch_harq or tuple((0, True) for _ in ul.pusch)
        pd_cfgs, payloads = [], []
        uci_pdus = []                  # (cfg, tb): PDUs with UCI ride ue_tx
        for pu, (hid, new) in zip(ul.pusch, harq_meta):
            if sched is not None and (pu.uci.o_csi1 or pu.uci.o_ack):
                uci_pdus.append((pu, self._tb(rng, pu, hid, new)))
                continue
            pd_cfgs.append(PdschConfig(
                rnti=pu.rnti, rb_start=pu.rb_start, rb_count=pu.rb_count,
                first_symbol=pu.first_symbol, nof_symbols=pu.nof_symbols,
                modulation=pu.modulation,
                target_code_rate=pu.target_code_rate, tbs=pu.tbs,
                nof_layers=pu.nof_layers, rv=pu.rv, n_id=pu.n_id,
                dmrs_symbols=pu.dmrs_symbols,
                dmrs_scrambling_id=pu.dmrs_scrambling_id,
                slot_in_frame=pu.slot_in_frame))
            if sched is None:
                tb = rng.integers(0, 2, pu.tbs).astype(np.int8)
            else:
                tb = self._tb(rng, pu, hid, new)
            payloads.append(torch.from_numpy(tb).to(dev))
        slot_in_sf = ul.slot.subframe_slot_index
        sinr = (cfg.channel_sinr_db if cfg.channel_profile != "none"
                else 30.0)
        cqi = int(np.clip((sinr + 6.0) / 1.9, 1, 15))
        if payloads:
            plan, ctx = normalize_dl_plan(
                DlTtiRequest(slot=ul.slot, pdsch=tuple(pd_cfgs)), device=dev)
            samples, grid = dl_slot_fn(self.cell, plan, slot_in_sf)(
                (), (), tuple(payloads), ctx)
            grid_dirty = False
        else:                          # no data PDU: an empty grid
            grid = torch.zeros((cfg.cell.nof_ports, 14, cfg.cell.nof_sc),
                               dtype=torch.complex64, device=dev)
            samples, grid_dirty = None, True
        for pu, tb in uci_pdus:
            # CSI-on-PUSCH PDUs: the UE packs the rank-restricted report
            # and multiplexes it into the PUSCH codeword (phy/upper/ue_tx)
            uec = sched.ues.get(pu.rnti)
            cfg_r = uec.pusch_csi_cfg if uec is not None else None
            csi1 = csi2 = None
            if cfg_r is not None and pu.uci.o_csi1:
                rep = csi_mod.CsiReportData(
                    ri=cfg_r.allowed_ranks()[0], wideband_cqi=cqi,
                    i_1_1=pu.rnti % 8, i_2=pu.rnti % 2)
                csi1, csi2 = csi_mod.pack(rep, cfg_r)
                if csi2.size == 0:
                    csi2 = None
            grid[:1] += ue_tx_mod.pusch_transmit(
                pu, tb, csi1=csi1, csi2=csi2, nof_sc=cfg.cell.nof_sc,
                device=dev)
            grid_dirty = True
        if sched is not None and (ul.pucch_f1 or ul.pucch_f2):
            # The UE transmits ACKs on its PUCCH F1 occasions (bit 0 = ACK)
            # and packed wideband CSI reports on its F2 occasions, closing
            # the DL HARQ and link-adaptation loops.
            for fc in ul.pucch_f1:
                grid = pucch_mod.transmit_format1(
                    grid, fc, [0] * max(fc.nof_harq_bits, 1))
            for fc in ul.pucch_f2:
                # UE-side CSI: CQI from the emulated channel SINR, rank
                # from its configured DL layers, a deterministic beam PMI.
                uec = sched.ues.get(fc.rnti)
                ranks = sched.csi_cfg.allowed_ranks()
                want_ri = uec.cfg.nof_layers_dl if uec is not None else 1
                ri = max(r for r in ranks if r <= max(want_ri, ranks[0]))
                data = csi_mod.CsiReportData(
                    ri=ri, wideband_cqi=cqi, i_1_1=fc.rnti % 8,
                    i_2=fc.rnti % 2)
                grid = pucch_mod.transmit_format2(
                    grid, fc, csi_mod.pack_pucch(data, sched.csi_cfg))
            grid_dirty = True
        if grid_dirty:             # one re-OFDM after all grid writes
            samples = self._modulate(grid, slot_in_sf)
        if cfg.channel_profile != "none":
            ch = chan.ChannelConfig(
                profile=cfg.channel_profile, sinr_db=cfg.channel_sinr_db,
                nof_tx_ports=cfg.cell.nof_ports,
                nof_rx_ports=cfg.cell.nof_ports, nof_subc=cfg.cell.nof_sc,
                scs_hz=15000 << cfg.cell.numerology)
            gen = torch.Generator(device=dev)
            gen.manual_seed(ul.slot.count)
            rx_grid, _ = chan.run(grid, ch, gen)                    # K20
            return self._modulate(rx_grid, slot_in_sf)
        return samples


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="dotted override, e.g. --set run.nof_slots=200")
    ap.add_argument("--trace", default="")
    ap.add_argument("--dump-config", action="store_true")
    ap.add_argument("--remote-port", type=int, default=-1,
                    help="remote-control WebSocket server (not ported)")
    ap.add_argument("--pcap", default="",
                    help="FAPI slot-message pcap capture (not ported)")
    ap.add_argument("--e2", default="",
                    help="E2/KPM agent connection (not ported)")
    ap.add_argument("--page", action="append", default=[],
                    help="page a UE (48-bit 5G-S-TMSI, decimal or "
                         "0x-prefixed hex); sched mode only — the record "
                         "transmits on its TS38.304 paging frame")
    args = ap.parse_args(argv)
    for flag, on in (("--remote-port", args.remote_port >= 0),
                     ("--pcap", bool(args.pcap)), ("--e2", bool(args.e2))):
        if on:
            raise NotImplementedError(f"{flag} {_NOT_PORTED}")
    cfg = config_mod.load(args.config, args.set)
    if args.dump_config:
        print(config_mod.dump(cfg))
        return
    res = run(cfg, trace=args.trace, pages=args.page)
    if res["ul_slots"] and res["crc_ok"] == 0:
        sys.exit("ERROR: no UL transport block decoded")


if __name__ == "__main__":
    main()
