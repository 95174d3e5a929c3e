"""Split-8 radio units over the native sampio runtime.

Port of srsran_tpu/ru/units.py: the sample boundary between the lower PHY
and a radio.  Samples cross it as host numpy arrays (complex64 [ports,
count]); a caller on the card copies its slot's samples to the host once.
"""

from __future__ import annotations

import numpy as np

from ..io.sampio import SampleFileReader, SampleFileWriter, SampleRing


class RadioUnit:
    """Lifecycle + DL/UL sample planes (radio_unit, include/srsran/ru/ru.h:37)."""

    def start(self):
        pass

    def stop(self):
        pass

    def send_dl(self, samples: np.ndarray, timestamp: int):
        raise NotImplementedError

    def receive_ul(self, count: int):
        """Returns (samples [ports, count], timestamp) or None."""
        raise NotImplementedError


class RuDummy(RadioUnit):
    """Loopback RU: DL samples become UL samples, optionally through a
    channel function (lib/ru/dummy analogue, used for benchmarks/tests)."""

    def __init__(self, nof_ports: int, channel_fn=None, capacity: int = 1 << 20):
        self.ring = SampleRing(capacity, nof_ports)
        self.channel_fn = channel_fn

    def send_dl(self, samples: np.ndarray, timestamp: int = 0):
        s = np.asarray(samples, dtype=np.complex64)
        if self.channel_fn is not None:
            s = np.asarray(self.channel_fn(s), dtype=np.complex64)
        if not self.ring.write(s):
            raise BufferError("RU dummy ring overflow")

    def receive_ul(self, count: int):
        return self.ring.read(count)


class RuRing(RadioUnit):
    """Sample boundary over two native rings (tx to peer, rx from peer)."""

    def __init__(self, nof_ports: int, capacity: int = 1 << 22):
        self.tx = SampleRing(capacity, nof_ports)
        self.rx = SampleRing(capacity, nof_ports)

    def send_dl(self, samples: np.ndarray, timestamp: int = 0):
        if not self.tx.write(np.asarray(samples, dtype=np.complex64)):
            raise BufferError("RU tx ring overflow (peer too slow)")

    def receive_ul(self, count: int):
        return self.rx.read(count)


class RuFile(RadioUnit):
    """Record DL samples to a file and/or replay UL samples from one."""

    def __init__(self, nof_ports: int, sample_rate: float,
                 dl_path: str | None = None, ul_path: str | None = None):
        self._writer = (SampleFileWriter(dl_path, nof_ports, sample_rate)
                        if dl_path else None)
        self._reader = SampleFileReader(ul_path) if ul_path else None
        self._ts = 0

    def send_dl(self, samples: np.ndarray, timestamp: int = 0):
        if self._writer:
            self._writer.write(np.asarray(samples, dtype=np.complex64))

    def receive_ul(self, count: int):
        if not self._reader:
            return None
        data = self._reader.read(count)
        if data.shape[1] < count:
            return None
        ts, self._ts = self._ts, self._ts + count
        return data, ts

    def stop(self):
        if self._writer:
            self._writer.close()
        if self._reader:
            self._reader.close()
