"""Process resource-usage metrics (rusage + RAPL energy when available).

Analogue of the reference's apps/services/app_resource_usage and
lib/support/resource_usage (rusage_trace_recorder.h, RAPL MSR/powercap
energy readers rapl_msr_energy_reader_impl.cpp): snapshot/diff CPU time,
max RSS and context switches, plus package energy from the Linux powercap
sysfs when the platform exposes it (containers usually don't).

The port's own copy of srsran_tpu/utils/resource_usage.py (host only): the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import glob
import resource
import time


@dataclasses.dataclass
class UsageSnapshot:
    wall_s: float
    user_s: float
    system_s: float
    max_rss_mb: float
    vol_ctx_switches: int
    invol_ctx_switches: int
    energy_uj: int | None    # RAPL package energy, None if unavailable


def _read_energy_uj():
    total = 0
    found = False
    for path in glob.glob("/sys/class/powercap/intel-rapl:*/energy_uj"):
        try:
            with open(path) as f:
                total += int(f.read().strip())
            found = True
        except OSError:
            pass
    return total if found else None


def snapshot() -> UsageSnapshot:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return UsageSnapshot(
        wall_s=time.monotonic(),
        user_s=ru.ru_utime, system_s=ru.ru_stime,
        max_rss_mb=ru.ru_maxrss / 1024.0,
        vol_ctx_switches=ru.ru_nvcsw, invol_ctx_switches=ru.ru_nivcsw,
        energy_uj=_read_energy_uj())


def diff(a: UsageSnapshot, b: UsageSnapshot) -> dict:
    """Usage between two snapshots (a older).  Mirrors the reference's
    resource_usage_metrics fields (cpu time, rss, energy consumption)."""
    out = {
        "wall_s": round(b.wall_s - a.wall_s, 3),
        "cpu_user_s": round(b.user_s - a.user_s, 3),
        "cpu_system_s": round(b.system_s - a.system_s, 3),
        "max_rss_mb": round(b.max_rss_mb, 1),
        "vol_ctx_switches": b.vol_ctx_switches - a.vol_ctx_switches,
        "invol_ctx_switches": b.invol_ctx_switches - a.invol_ctx_switches,
    }
    if a.energy_uj is not None and b.energy_uj is not None:
        out["energy_j"] = round((b.energy_uj - a.energy_uj) / 1e6, 3)
        if out["wall_s"] > 0:
            out["avg_power_w"] = round(out["energy_j"] / out["wall_s"], 2)
    return out
