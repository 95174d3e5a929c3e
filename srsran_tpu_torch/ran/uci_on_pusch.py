"""UCI-on-PUSCH bit budgeting (TS38.212 §6.3.2.4) — host-side.

Analogue of the reference's ulsch_info (lib/ran/pusch/ulsch_info.cpp):
computes the number of coded modulation symbols Q' for HARQ-ACK, CSI part 1
and CSI part 2 multiplexed on PUSCH, given beta offsets and the data code
rate, per TS38.212 §6.3.2.4.1.1-3.

The port's own copy of srsran_tpu/ran/uci_on_pusch.py:
the port imports nothing of the JAX package.  tests/test_torch_host_plans.py
pins the copy to its original.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class UciOnPuschConfig:
    o_ack: int = 0
    o_csi1: int = 0
    o_csi2: int = 0
    beta_ack: float = 12.625
    beta_csi1: float = 6.25
    beta_csi2: float = 6.25
    alpha: float = 1.0


@dataclasses.dataclass(frozen=True)
class Part2Parameter:
    """One CSI part-1 field that selects the part-2 size (bit offset/width)."""
    offset: int
    width: int


@dataclasses.dataclass(frozen=True)
class Part2Entry:
    parameters: tuple            # tuple[Part2Parameter]
    size_map: tuple              # 2^sum(width) part-2 sizes in bits


@dataclasses.dataclass(frozen=True)
class Part2SizeDescription:
    """UCI part-1 → part-2 size correspondence (mirror of the reference's
    uci_part2_size_description, include/srsran/ran/uci/
    uci_part2_size_description.h; evaluation per
    lib/ran/uci/uci_part2_size_calculator.cpp:55-90)."""
    entries: tuple = ()          # tuple[Part2Entry]

    @staticmethod
    def fixed(size: int) -> "Part2SizeDescription":
        if size == 0:
            return Part2SizeDescription(())
        return Part2SizeDescription(
            (Part2Entry((Part2Parameter(0, 0),), (size,)),))

    def possible_sizes(self) -> tuple:
        """All part-2 sizes reachable under this description (ascending)."""
        if not self.entries:
            return (0,)
        totals = {0}
        for e in self.entries:
            totals = {t + s for t in totals for s in e.size_map}
        return tuple(sorted(totals))


def uci_part2_get_size(part1_bits, descr: Part2SizeDescription) -> int:
    """Part-2 payload size from decoded part-1 bits.  Parameters are read
    MSB-first (the first part-1 bit of the field is the most significant),
    matching uci_part2_size_calculator.cpp:28-52 (to_uint64 + bit_reverse)."""
    import numpy as np
    bits = np.asarray(part1_bits).astype(np.int64)
    total = 0
    for entry in descr.entries:
        index = 0
        for p in entry.parameters:
            value = 0
            for i in range(p.width):
                value = (value << 1) | int(bits[p.offset + i])
            index = (index << p.width) | value
        total += entry.size_map[index]
    return total


def _crc_len(o: int) -> int:
    if o <= 11:
        return 0
    if o < 20:
        return 6
    return 11


def uci_symbol_budget(o_bits: int, beta: float, alpha: float,
                      m_uci_total: int, m_uci_from_l1: int,
                      sum_kr: int, qm: int, nof_layers: int,
                      already_used: int = 0) -> int:
    """Q' per TS38.212 §6.3.2.4.1.1 (shape shared by ACK/CSI1/CSI2).

    m_uci_total: sum over all symbols of UCI-capable REs (per layer);
    m_uci_from_l1: same but only symbols from the anchor symbol onward;
    sum_kr: total data payload+CRC bits of the UL-SCH (denominator);
    already_used: RE budget consumed by higher-priority UCI.
    """
    if o_bits == 0:
        return 0
    l = _crc_len(o_bits)
    if sum_kr > 0:
        q1 = math.ceil((o_bits + l) * beta * m_uci_total / sum_kr)
    else:
        # No UL-SCH data: rate follows the CSI/ACK-only formulas; fall back
        # to spreading over everything available.
        q1 = m_uci_from_l1
    q2 = math.ceil(alpha * m_uci_from_l1) - already_used
    return max(0, min(q1, max(q2, 0)))


def e_uci(q_prime: int, qm: int, nof_layers: int) -> int:
    """Coded bits for a UCI field."""
    return q_prime * qm * nof_layers
