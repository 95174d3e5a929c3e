"""Host real-time sanitizer: the slot-deadline guard.

The port's copy of ``DeadlineGuard`` and its assertion level from
srsran_tpu/utils/sanitize.py (the analogue of the reference's
ASSERT_LEVEL paranoia ladder, CMakeLists.txt:97-99): a host loop that
blows its slot deadline is counted (NORMAL) or raises (PARANOID); MINIMAL
disables the check.  Level via ``SRSRAN_TPU_ASSERT_LEVEL`` = minimal |
normal | paranoid.  The JAX package's checkify instrumentation of jitted
functions has no counterpart here.
"""

from __future__ import annotations

import os
import time

MINIMAL, NORMAL, PARANOID = "minimal", "normal", "paranoid"


def level() -> str:
    lv = os.environ.get("SRSRAN_TPU_ASSERT_LEVEL", NORMAL).lower()
    return lv if lv in (MINIMAL, NORMAL, PARANOID) else NORMAL


class DeadlineError(RuntimeError):
    pass


class DeadlineGuard:
    """Assert a host RT section stays within its slot budget.

    ``with DeadlineGuard(budget_s, name, metrics): ...`` — a miss
    increments ``metrics['deadline_miss']`` (NORMAL) or raises
    ``DeadlineError`` (PARANOID).  MINIMAL disables the check entirely,
    like the reference's ASSERT_LEVEL=MINIMAL builds.
    """

    def __init__(self, budget_s: float, name: str = "rt_section",
                 metrics: dict | None = None):
        self.budget_s = budget_s
        self.name = name
        self.metrics = metrics
        self.elapsed_s = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.elapsed_s = time.monotonic() - self._t0
        if exc_type is not None or level() == MINIMAL:
            return False
        if self.elapsed_s > self.budget_s:
            if self.metrics is not None:
                self.metrics["deadline_miss"] = (
                    self.metrics.get("deadline_miss", 0) + 1)
            if level() == PARANOID:
                raise DeadlineError(
                    f"{self.name}: {self.elapsed_s * 1e6:.0f} us exceeded "
                    f"the {self.budget_s * 1e6:.0f} us budget")
        return False
