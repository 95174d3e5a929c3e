"""Chrome trace-event tracer (host-side spans).

Analogue of the reference's event tracer
(include/srsran/support/tracing/event_tracing.h:132-226,
lib/support/tracing/event_tracing.cpp): named spans per slot stage written
as Chrome trace-event JSON (open in chrome://tracing or Perfetto).  Device-
side profiling uses torch.profiler separately; this covers the host
conductor timeline.

The port's own copy of srsran_tpu/utils/tracing.py (host only): the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager


class EventTracer:
    """Lock-protected in-memory trace buffer with JSON file dump."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._events = []
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def _now_us(self) -> float:
        return (time.monotonic() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, **args):
        if not self.enabled:
            yield
            return
        start = self._now_us()
        try:
            yield
        finally:
            end = self._now_us()
            with self._lock:
                self._events.append({
                    "name": name, "ph": "X", "ts": start,
                    "dur": end - start, "pid": os.getpid(),
                    "tid": threading.get_ident() % 100000, "args": args})

    def instant(self, name: str, **args):
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "ph": "i", "ts": self._now_us(), "s": "t",
                "pid": os.getpid(), "tid": threading.get_ident() % 100000,
                "args": args})

    def dump(self, path: str):
        with self._lock:
            with open(path, "w") as f:
                json.dump({"traceEvents": self._events}, f)


# Domain tracer singletons, mirroring lib/instrumentation/traces/.
l1_dl_tracer = EventTracer()
l1_ul_tracer = EventTracer()
app_tracer = EventTracer()


def enable_all():
    for t in (l1_dl_tracer, l1_ul_tracer, app_tracer):
        t.enabled = True
