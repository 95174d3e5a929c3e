"""Per-block PHY metrics aggregation.

Analogue of the reference's lib/phy/upper/metrics/aggregators/ (20 headers)
+ lib/phy/metrics decorators: each pipeline stage reports (count, elapsed,
payload size) samples; aggregators expose min/avg/max latency and
throughput.  Host-side and allocation-free on the hot path (samples are
appended to preallocated ring buffers).

The port's own copy of srsran_tpu/utils/metrics.py (host only): the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager

import numpy as np


class BlockMetrics:
    """Latency/throughput aggregator for one named block."""

    def __init__(self, name: str, capacity: int = 4096):
        self.name = name
        self._lat_us = np.zeros(capacity, dtype=np.float64)
        self._units = np.zeros(capacity, dtype=np.float64)
        self._n = 0
        self._cap = capacity

    def record(self, elapsed_s: float, units: float = 0.0):
        i = self._n % self._cap
        self._lat_us[i] = elapsed_s * 1e6
        self._units[i] = units
        self._n += 1

    @contextmanager
    def measure(self, units: float = 0.0):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.record(time.monotonic() - t0, units)

    def summary(self) -> dict:
        n = min(self._n, self._cap)
        if n == 0:
            return {"name": self.name, "count": 0}
        lat = self._lat_us[:n]
        units = self._units[:n]
        total_t = lat.sum() / 1e6
        return {
            "name": self.name, "count": self._n,
            "lat_us_avg": float(lat.mean()),
            "lat_us_p50": float(np.percentile(lat, 50)),
            "lat_us_p99": float(np.percentile(lat, 99)),
            "lat_us_max": float(lat.max()),
            "throughput_per_s": float(units.sum() / total_t) if total_t else 0.0,
        }


class MetricsRegistry:
    """Named registry, mirrors the upper-PHY metrics collector."""

    def __init__(self):
        self._blocks = {}

    def block(self, name: str) -> BlockMetrics:
        if name not in self._blocks:
            self._blocks[name] = BlockMetrics(name)
        return self._blocks[name]

    def report(self) -> list:
        return [b.summary() for b in self._blocks.values()]


registry = MetricsRegistry()
