"""Cyclic-prefix lengths per TS38.211 §5.3.1.

Analogue of the reference's include/srsran/ran/cyclic_prefix.h.  CP lengths
are expressed in samples at the sampling rate implied by a DFT size
(fs = dft_size * scs):

  normal CP:   144 * N/2048, plus N*2**mu/128 extra for the first symbol of
               each half-subframe (l == 0 or l == 7*2**mu, l counted within
               the subframe);
  extended CP: N/4 for every symbol (mu == 2 only in practice).

The port's own copy of srsran_tpu/ran/cyclic_prefix.py:
the port imports nothing of the JAX package.  tests/test_torch_host_plans.py
pins the copy to its original.
"""

from __future__ import annotations

import enum
import numpy as np

from .constants import NSYMB_PER_SLOT_NORMAL, NSYMB_PER_SLOT_EXTENDED


class CyclicPrefix(enum.Enum):
    NORMAL = "normal"
    EXTENDED = "extended"


def symbols_per_slot(cp: CyclicPrefix) -> int:
    return NSYMB_PER_SLOT_NORMAL if cp is CyclicPrefix.NORMAL else NSYMB_PER_SLOT_EXTENDED


def cp_lengths(cp: CyclicPrefix, numerology: int, dft_size: int,
               slot_in_subframe: int = 0) -> np.ndarray:
    """CP length in samples for each OFDM symbol of one slot.

    ``slot_in_subframe`` selects which slot of the subframe this is (the long
    CP lands on subframe-symbol 0 and 7*2**mu; for mu>=1 that is symbol 0 of
    slot 0 and symbol 0 of slot 2**mu / 2 ... in general any slot whose first
    symbol index within the subframe is a multiple of 7*2**mu).
    """
    nsym = symbols_per_slot(cp)
    if cp is CyclicPrefix.EXTENDED:
        return np.full(nsym, dft_size // 4, dtype=np.int64)
    base = (144 * dft_size) // 2048
    extra = (dft_size << numerology) // 128
    lens = np.full(nsym, base, dtype=np.int64)
    first_l = slot_in_subframe * nsym  # symbol index within the subframe
    for i in range(nsym):
        l = first_l + i
        if l % (7 << numerology) == 0:
            lens[i] += extra
    return lens


def slot_num_samples(cp: CyclicPrefix, numerology: int, dft_size: int,
                     slot_in_subframe: int = 0) -> int:
    """Total baseband samples in one slot (symbols + CPs)."""
    lens = cp_lengths(cp, numerology, dft_size, slot_in_subframe)
    return int(lens.sum() + len(lens) * dft_size)
