"""Radio Unit (analogue of include/srsran/ru/ru.h + lib/ru/): the port of
srsran_tpu/ru.

The reference's radio_unit interface (controller + DL plane + UL plane)
maps to a start/stop lifecycle, ``send_dl`` consuming the DL slot samples
and ``receive_ul`` producing UL slot samples.  Implementations:

- RuOfh      -- the split-7.2 O-RAN fronthaul (``ofh``) over an
                ``InMemoryCable`` or a ``SocketEndpoint``;
- RuDummy    -- split-8 loopback with an optional channel function
                (lib/ru/dummy);
- RuRing     -- native timestamped sample rings (sampio) to another
                process (the split-8 sample boundary without SDR hardware);
- RuFile     -- record DL / replay UL through cf32 files.
"""

from .ofh import InMemoryCable, RuOfh, SocketEndpoint  # noqa: F401
from .units import RadioUnit, RuDummy, RuFile, RuRing  # noqa: F401
