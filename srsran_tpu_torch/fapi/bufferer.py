"""FAPI message bufferer: absorbs L2->L1 jitter.

Port of srsran_tpu/fapi/bufferer.py.  Analogue of the reference's
lib/fapi/message_buffering/message_bufferer_*: slot messages arriving
ahead of their slot are held and replayed when the timing tick reaches
that slot -- the mechanism that lets the MAC run up to
``max_processing_delay_slots`` (reference default 5) ahead of the air
interface.  Out-of-window messages are rejected with an error indication.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from ..ran.slot_point import SlotPoint


@dataclasses.dataclass
class LateMessage:
    slot: SlotPoint
    kind: str
    delta: int


class MessageBufferer:
    """Holds (dl_tti, tx_data, ul_tti) keyed by slot until their tick."""

    def __init__(self, max_advance_slots: int = 5):
        self.max_advance = max_advance_slots
        self._pending = defaultdict(dict)
        self._current = None
        self.errors: list = []

    def _delta(self, slot: SlotPoint) -> int:
        if self._current is None:
            return 0
        return slot - self._current

    def push(self, kind: str, slot: SlotPoint, message) -> bool:
        """Queue a message for its slot.  Returns False (and records an
        error indication) if outside the [0, max_advance] window."""
        d = self._delta(slot)
        if d < 0 or d > self.max_advance:
            self.errors.append(LateMessage(slot=slot, kind=kind, delta=d))
            return False
        self._pending[slot.count][kind] = message
        return True

    def tick(self, slot: SlotPoint) -> dict:
        """Advance the timing to ``slot``; returns that slot's messages and
        drops anything older (counted as late)."""
        self._current = slot
        for count in [c for c in self._pending if c < slot.count]:
            for kind in self._pending[count]:
                self.errors.append(LateMessage(
                    slot=SlotPoint(slot.numerology, count), kind=kind,
                    delta=count - slot.count))
            del self._pending[count]
        return self._pending.pop(slot.count, {})
