"""Slot timing arithmetic (TS38.211 §4.3).

The port's own copy of srsran_tpu/ran/slot_point.py: a slot point is
(numerology mu, system frame number, slot index) folded into a single
monotonically wrapping counter.  The conductor keys its slot phases by it.
tests/test_torch_host_plans.py pins the copy to its original.
"""

from __future__ import annotations

import dataclasses

NOF_SFNS = 1024
NOF_SUBFRAMES_PER_FRAME = 10


@dataclasses.dataclass(frozen=True, order=False)
class SlotPoint:
    """A (numerology, count) slot identifier; count wraps at 1024 frames."""

    numerology: int  # mu in 0..4  (15 kHz << mu)
    count: int       # slot count in [0, 10240 * 2**mu)

    def __post_init__(self):
        if not 0 <= self.numerology <= 4:
            raise ValueError(f"numerology {self.numerology} not in 0..4")
        object.__setattr__(self, "count",
                           self.count % self.nof_slots_per_system_frame())

    # -- derived quantities -------------------------------------------------
    def nof_slots_per_subframe(self) -> int:
        return 1 << self.numerology

    def nof_slots_per_frame(self) -> int:
        return NOF_SUBFRAMES_PER_FRAME * self.nof_slots_per_subframe()

    def nof_slots_per_system_frame(self) -> int:
        return NOF_SFNS * self.nof_slots_per_frame()

    @property
    def sfn(self) -> int:
        return self.count // self.nof_slots_per_frame()

    @property
    def slot_index(self) -> int:
        """Slot index within the frame."""
        return self.count % self.nof_slots_per_frame()

    @property
    def subframe_index(self) -> int:
        return self.slot_index // self.nof_slots_per_subframe()

    @property
    def subframe_slot_index(self) -> int:
        return self.slot_index % self.nof_slots_per_subframe()

    @property
    def scs_hz(self) -> int:
        return 15_000 << self.numerology

    def slot_duration_s(self) -> float:
        return 1e-3 / self.nof_slots_per_subframe()

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, n: int) -> "SlotPoint":
        return SlotPoint(self.numerology,
                         (self.count + n) % self.nof_slots_per_system_frame())

    def __sub__(self, other):
        if isinstance(other, SlotPoint):
            if other.numerology != self.numerology:
                raise ValueError("slot points of different numerologies")
            period = self.nof_slots_per_system_frame()
            d = (self.count - other.count) % period
            # Interpret as signed distance in (-period/2, period/2].
            return d - period if d > period // 2 else d
        return SlotPoint(self.numerology,
                         (self.count - other) % self.nof_slots_per_system_frame())

    def __lt__(self, other: "SlotPoint") -> bool:
        return (other - self) > 0

    @classmethod
    def from_sfn_slot(cls, numerology: int, sfn: int, slot: int) -> "SlotPoint":
        per_frame = NOF_SUBFRAMES_PER_FRAME * (1 << numerology)
        return cls(numerology, sfn * per_frame + slot)
