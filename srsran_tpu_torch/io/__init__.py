"""Sample-level I/O runtime (native C++ core + ctypes bindings).

Port of srsran_tpu/io: timestamped ring buffers between a sample source
(file replay, another process, a future SDR bridge) and the slot
conductor, and a cf32 file format for record and replay -- the same C ABI
(native/sampio.cpp) and the same bytes on disk, so either package reads
the other's files.
"""

from .sampio import SampleFileReader, SampleFileWriter, SampleRing  # noqa: F401
