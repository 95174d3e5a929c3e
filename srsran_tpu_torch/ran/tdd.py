"""TDD UL/DL pattern helper (TS38.213 §11.1).

Analogue of the reference's lib/ran/tdd_ul_dl_config.cpp: resolves each slot
of the pattern period to DL / UL / special.

The port's own copy of srsran_tpu/ran/tdd.py: the port imports nothing
of the JAX package.  tests/test_torch_host_plans.py pins the copy to its
original.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TddPattern:
    """e.g. the common 5 ms DDDSU pattern at 30 kHz: periodicity 5 ms,
    nof_dl_slots=3, nof_ul_slots=1, special slot between."""

    periodicity_slots: int = 5
    nof_dl_slots: int = 3
    nof_ul_slots: int = 1
    nof_dl_symbols_special: int = 10
    nof_ul_symbols_special: int = 2

    def slot_type(self, slot_count: int) -> str:
        pos = slot_count % self.periodicity_slots
        if pos < self.nof_dl_slots:
            return "dl"
        if pos >= self.periodicity_slots - self.nof_ul_slots:
            return "ul"
        return "special"

    def is_dl(self, slot_count: int) -> bool:
        return self.slot_type(slot_count) in ("dl", "special")

    def is_ul(self, slot_count: int) -> bool:
        return self.slot_type(slot_count) == "ul"
