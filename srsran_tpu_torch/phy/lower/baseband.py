"""Lower-PHY baseband processor: the slot-clocked sample-domain engine.

The analogue of the reference's real-time baseband core
(lib/phy/lower/lower_phy_baseband_processor.cpp:80-200 — self-rescheduling
``dl_process``/``ul_process`` task chains; lower_phy_baseband_processor.h:41-95
— rx->tx timestamp slaving via ``tx_time_offset`` and ``rx_to_tx_max_delay``)
plus the PRACH occasion worker FSM
(lib/phy/lower/processors/uplink/prach/prach_processor_worker.h:46-126 —
wait-window -> collect -> demodulate) and the downlink TTI-in-advance
notification (downlink_processor_baseband_impl.h:53-60).

The reference needs four executors because CPUs overlap slots with threads;
here the slot programs are launched asynchronously on the device, so one
host-side loop suffices: each tick pulls one slot of UL samples from the
radio unit (establishing the rx timeline), feeds PRACH collectors, notifies
the UL handler, and transmits the DL slot produced by the upper PHY at
``rx_timestamp + tx_time_offset`` — the same timestamp-slaving discipline,
without threads.

States mirror the reference's internal_fsm: IDLE -> RUNNING -> STOPPED.

The port's copy of srsran_tpu/phy/lower/baseband.py.  The collectors keep
host numpy buffers, as in JAX; a completed PRACH window is uploaded once,
as one host-to-device copy, and demodulated on the processor's device by
K21 (prach_demod.demodulate; its plain twin on the CPU).  The processor
runs on the card unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ...device import require_cuda
from ...ran.cyclic_prefix import CyclicPrefix, slot_num_samples
from ...ran.prach_params import LONG_FORMATS, SHORT_FORMATS
from ...utils import sanitize
from . import prach_demod


@dataclasses.dataclass(frozen=True)
class PrachOccasionRequest:
    """One PRACH capture window (prach_processor_worker ``configuration``)."""

    slot: int                  # slot whose start anchors the window
    start_sample: int          # offset of the preamble sequence within slot
    fmt: str                   # "0".."3" long, "A1".. short
    freq_offset_hz: float = 0.0
    nof_fd_occasions: int = 1
    ra_scs_hz: int = 0         # short formats: 15000 << mu (0 = 15 kHz)

    def window_samples(self, sample_rate_hz: int) -> int:
        if self.fmt in LONG_FORMATS:
            _, ra_scs, reps = LONG_FORMATS[self.fmt]
        else:
            ra_scs = self.ra_scs_hz or 15_000
            reps = SHORT_FORMATS[self.fmt]
        return (sample_rate_hz // ra_scs) * reps


class _PrachCollector:
    """FSM: WAIT (window not reached) -> COLLECTING (may straddle slot
    boundaries, prach_processor_worker.h:56-66) -> DONE (demodulate+notify)."""

    def __init__(self, req: PrachOccasionRequest, abs_start: int,
                 nof_ports: int, sample_rate_hz: int, notifier,
                 device: torch.device | str = "cpu"):
        self.req = req
        self.device = torch.device(device)
        self.abs_start = abs_start
        self.needed = req.window_samples(sample_rate_hz)
        self.buf = np.zeros((nof_ports, self.needed), dtype=np.complex64)
        self.filled = 0
        self.sample_rate_hz = sample_rate_hz
        self.notifier = notifier

    def feed(self, samples: np.ndarray, timestamp: int) -> bool:
        """Offer one block; returns True when the window completed."""
        t0, t1 = timestamp, timestamp + samples.shape[-1]
        w0 = self.abs_start + self.filled
        if t1 <= w0:
            return False                       # WAIT: window not reached yet
        lo = max(t0, w0)
        hi = min(t1, self.abs_start + self.needed)
        if hi > lo:
            dst = lo - self.abs_start
            self.buf[:, dst:dst + (hi - lo)] = samples[:, lo - t0:hi - t0]
            self.filled = dst + (hi - lo)
        if self.filled < self.needed:
            return False                       # COLLECTING
        fd = prach_demod.demodulate(
            torch.from_numpy(self.buf).to(self.device),      # one upload
            self.req.fmt, self.sample_rate_hz, 0,
            self.req.freq_offset_hz, self.req.nof_fd_occasions,
            ra_scs_hz=self.req.ra_scs_hz)
        self.notifier(self.req, fd)
        return True


class BasebandProcessor:
    """Slot-clocked DL/UL sample engine over a RadioUnit.

    Callbacks (the reference's notifier seams):
    - ``tti_notifier(slot)`` — called ``nof_slot_tti_in_advance`` slots
      ahead of transmission (on_tti_boundary analogue); the upper PHY must
      eventually ``push_dl(slot, samples)``.
    - ``rx_notifier(slot, samples, timestamp)`` — one slot of UL samples.
    - ``prach_notifier(request, fd_capture)`` — completed PRACH window,
      its capture complex64 [ports, repetitions, L_ra] on ``device``.

    ``device``: where PRACH windows are demodulated; None means the
    current CUDA device (raises without one).
    """

    def __init__(self, ru, nof_ports: int, dft_size: int, numerology: int,
                 cp: CyclicPrefix = CyclicPrefix.NORMAL,
                 tx_time_offset: int = 0, rx_to_tx_max_delay: int | None = None,
                 nof_slot_tti_in_advance: int = 1,
                 tti_notifier=None, rx_notifier=None, prach_notifier=None,
                 device=None):
        self.ru = ru
        self.device = require_cuda() if device is None else torch.device(device)
        self.nof_ports = nof_ports
        self.dft_size = dft_size
        self.numerology = numerology
        self.cp = cp
        self.sample_rate_hz = dft_size * (15_000 << numerology)
        self.tx_time_offset = tx_time_offset
        self.rx_to_tx_max_delay = rx_to_tx_max_delay
        self.tti_advance = nof_slot_tti_in_advance
        self.tti_notifier = tti_notifier
        self.rx_notifier = rx_notifier
        self.prach_notifier = prach_notifier
        self.state = "IDLE"
        self._dl_queue: dict[int, np.ndarray] = {}
        self._prach: deque[_PrachCollector] = deque()
        self._pending_prach: deque[PrachOccasionRequest] = deque()
        self._slot = 0
        self._slot_start_ts: dict[int, int] = {}
        self.metrics = {"late_dl": 0, "tx_slots": 0, "rx_slots": 0,
                        "prach_windows": 0, "deadline_miss": 0}
        # Host-loop deadline budget: one slot duration (the RT contract;
        # utils/sanitize.DeadlineGuard counts misses, PARANOID raises).
        self.slot_budget_s = 1e-3 / (1 << numerology)

    # ---- control plane (ru_controller / internal_fsm analogue) ----------
    def start(self):
        assert self.state == "IDLE"
        self.ru.start()
        self.state = "RUNNING"
        for s in range(self.tti_advance):
            if self.tti_notifier:
                self.tti_notifier(s)

    def stop(self):
        if self.state == "RUNNING":
            self.ru.stop()
        self.state = "STOPPED"

    # ---- upper-PHY facing ------------------------------------------------
    def push_dl(self, slot: int, samples: np.ndarray):
        """DL samples for ``slot`` from the upper PHY (rg_gateway.send)."""
        self._dl_queue[slot] = np.asarray(samples, dtype=np.complex64)

    def request_prach(self, req: PrachOccasionRequest):
        self._pending_prach.append(req)

    @property
    def current_slot(self) -> int:
        """Slot index the next tick() will process."""
        return self._slot

    def slot_samples(self, slot: int) -> int:
        spsf = 1 << self.numerology
        return slot_num_samples(self.cp, self.numerology, self.dft_size,
                                slot % spsf)

    # ---- the engine (one dl_process+ul_process round per call) ----------
    def tick(self) -> bool:
        """Process one slot; returns False when UL samples ran out."""
        assert self.state == "RUNNING"
        with sanitize.DeadlineGuard(self.slot_budget_s, "baseband.tick",
                                    self.metrics):
            return self._tick()

    def _tick(self) -> bool:
        slot = self._slot
        nsamp = self.slot_samples(slot)
        got = self.ru.receive_ul(nsamp)
        if got is None:
            return False
        samples, rx_ts = got
        self._slot_start_ts[slot] = rx_ts
        self.metrics["rx_slots"] += 1

        # arm PRACH collectors whose absolute window is now computable
        while self._pending_prach and self._pending_prach[0].slot <= slot:
            req = self._pending_prach.popleft()
            base = self._slot_start_ts.get(req.slot)
            if base is None:            # request for a past, unseen slot
                continue
            self._prach.append(_PrachCollector(
                req, base + req.start_sample, self.nof_ports,
                self.sample_rate_hz, self._on_prach, self.device))
        for c in list(self._prach):
            if c.feed(samples, rx_ts):
                self._prach.remove(c)

        if self.rx_notifier:
            self.rx_notifier(slot, samples, rx_ts)

        # TTI boundary notification n slots in advance
        if self.tti_notifier:
            self.tti_notifier(slot + self.tti_advance)

        # transmit this slot's DL at the slaved timestamp
        tx_ts = rx_ts + self.tx_time_offset
        dl = self._dl_queue.pop(slot, None)
        if dl is None:
            self.metrics["late_dl"] += 1    # late grid -> silence (error path)
            dl = np.zeros((self.nof_ports, nsamp), dtype=np.complex64)
        self.ru.send_dl(dl, tx_ts)
        self.metrics["tx_slots"] += 1

        # bound the rx->tx pipeline depth (rx_to_tx_max_delay guard)
        if self.rx_to_tx_max_delay is not None:
            assert self.tx_time_offset <= self.rx_to_tx_max_delay, \
                "tx_time_offset exceeds rx_to_tx_max_delay"
        self._slot += 1
        # retire old slot timestamps (bounded memory)
        for s in [s for s in self._slot_start_ts if s < slot - 8]:
            del self._slot_start_ts[s]
        return True

    def run(self, nof_slots: int):
        for _ in range(nof_slots):
            if not self.tick():
                break

    def _on_prach(self, req, fd):
        self.metrics["prach_windows"] += 1
        if self.prach_notifier:
            self.prach_notifier(req, fd)
