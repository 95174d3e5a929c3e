"""The FAPI precoding configuration (per-PRG precoding-matrix indices).

The port's own copy of ``PrecodingConfig`` and ``nof_prgs`` from
srsran_tpu/ran/precoding_codebooks.py: the port imports nothing of the JAX
package.  The codebook repository itself is not ported (per-PRG precoding,
ROADMAP §1 item 8); a PDSCH that sets a PrecodingConfig raises.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PrecodingConfig:
    """FAPI Tx precoding PDU essentials (SCF-222 txPrecodingAndBeamforming:
    numPRGs, prgSize, PMidx per PRG).  Same fields as the JAX package's.

    PRGs partition the carrier aligned to CRB 0 (TS38.214 §5.1.2.3):
    PRB p belongs to entry ``p // prg_size - rb_start // prg_size``.
    """

    prg_size: int                 # PRBs per precoding resource block group
    pm_indices: tuple             # per-PRG repository index (len = nof PRGs)


def nof_prgs(rb_start: int, rb_count: int, prg_size: int) -> int:
    """PRG count covering [rb_start, rb_start+rb_count) with CRB0-aligned
    PRG boundaries."""
    first = rb_start // prg_size
    last = (rb_start + rb_count - 1) // prg_size
    return last - first + 1
