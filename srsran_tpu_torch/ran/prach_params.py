"""PRACH preamble parameters (TS38.211 §6.3.3.1) — host-side.

Analogue of the reference's lib/ran/prach/ (prach_cyclic_shifts.cpp,
prach_preamble_information.cpp): sequence lengths, N_cs from
zeroCorrelationZone, logical->physical root ordering, cyclic shift counts.

The port's own copy of srsran_tpu/ran/prach_params.py:
the port imports nothing of the JAX package.  tests/test_torch_host_plans.py
pins the copy to its original.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent.parent / "data" / "prach_tables.npz"

LONG_SEQ = 839
SHORT_SEQ = 139

# TS38.211 Tables 6.3.3.1-5/-6/-7 N_cs columns (unrestricted / restricted
# type A / restricted type B) — the same tables the reference ships in
# lib/ran/prach/prach_cyclic_shifts.cpp.  None marks reserved entries.
NCS_1_25_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119,
                         167, 279, 419)
NCS_1_25_TYPE_A = (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128, 158,
                   202, 237, None)
NCS_1_25_TYPE_B = (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 118, 137,
                   None, None, None)
NCS_5_UNRESTRICTED = (0, 13, 26, 33, 38, 41, 49, 55, 64, 76, 93, 119, 139,
                      209, 279, 419)
NCS_5_TYPE_A = (36, 57, 72, 81, 89, 94, 103, 112, 121, 132, 137, 152, 173,
                195, 216, 237)
NCS_5_TYPE_B = (36, 57, 60, 63, 65, 68, 71, 77, 81, 85, 97, 109, 122, 137,
                None, None)
NCS_SHORT_UNRESTRICTED = (0, 2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 23, 27, 34,
                          46, 69)

# Long preamble formats (TS38.211 Table 6.3.3.1-1): name -> (L, scs_hz,
# nof_repetitions within the preamble OFDM portion).
LONG_FORMATS = {
    "0": (839, 1250, 1),
    "1": (839, 1250, 2),
    "2": (839, 1250, 4),
    "3": (839, 5000, 4),
}
# Short preamble formats (Table 6.3.3.1-2): name -> nof symbol repetitions
# (at the PUSCH-numerology-scaled RA SCS).
SHORT_FORMATS = {"A1": 2, "A2": 4, "A3": 6, "B1": 2, "B2": 4, "B3": 6,
                 "B4": 12, "C0": 1, "C2": 4}

# Cyclic-prefix lengths N_CP^RA (TS38.211 Tables 6.3.3.1-1/-2, in kappa*Tc
# units; short-format entries additionally scale by 2^-mu, which cancels
# against the 2^mu RA SCS when converting to sequence-sample units — see
# prach.cp_seq_samples).  The reference carries these in
# lib/ran/prach/prach_preamble_information.cpp.
PRACH_CP_KAPPA = {
    "0": 3168, "1": 21024, "2": 4688, "3": 3168,
    "A1": 288, "A2": 576, "A3": 864, "B1": 216, "B2": 360, "B3": 504,
    "B4": 936, "C0": 1240, "C2": 2048,
}


@functools.lru_cache(maxsize=None)
def _long_root_order() -> np.ndarray:
    return np.load(_DATA)["long_root_order"]


def root_sequence_number(logical_index: int, long_format: bool) -> int:
    """Logical root index -> physical sequence number u."""
    if long_format:
        lut = _long_root_order()
        return int(lut[logical_index % len(lut)])
    i = logical_index % (SHORT_SEQ - 1)
    # Table 6.3.3.1-4 is the alternating pattern 1,138,2,137,...
    return (i // 2 + 1) if i % 2 == 0 else (SHORT_SEQ - 1 - i // 2)


def n_cs(zero_correlation_zone: int, ra_scs_hz: int,
         restricted: str = "unrestricted") -> int:
    if ra_scs_hz == 1250:
        cols = {"unrestricted": NCS_1_25_UNRESTRICTED,
                "type_a": NCS_1_25_TYPE_A, "type_b": NCS_1_25_TYPE_B}
    elif ra_scs_hz == 5000:
        cols = {"unrestricted": NCS_5_UNRESTRICTED,
                "type_a": NCS_5_TYPE_A, "type_b": NCS_5_TYPE_B}
    else:
        assert restricted == "unrestricted", \
            "restricted sets only exist for the 839-long formats"
        cols = {"unrestricted": NCS_SHORT_UNRESTRICTED}
    v = cols[restricted][zero_correlation_zone]
    assert v is not None, \
        f"zeroCorrelationZone {zero_correlation_zone} reserved for {restricted}"
    return v


def preambles_per_root(ncs: int, l_ra: int) -> int:
    """Number of cyclic-shift preambles one root supports."""
    return l_ra // ncs if ncs else 1


def _d_u(u: int, l_ra: int) -> int:
    """Doppler-shift distance d_u (TS38.211 §6.3.3.1): d_u = p when
    0 <= p < L/2 else L - p, with p the smallest non-negative integer
    satisfying (p*u) mod L = 1."""
    p = pow(u, -1, l_ra)          # u and prime L_RA are coprime
    return p if p < l_ra // 2 else l_ra - p


def restricted_cyclic_shifts(u: int, ncs: int, l_ra: int,
                             restricted: str) -> list[int]:
    """All restricted-set cyclic shifts C_v for root u (TS38.211 §6.3.3.1).

    Goes beyond the reference, whose generator asserts restricted sets out
    (prach_generator_impl.cpp:260) while only shipping the N_cs tables.
    Type A covers every d_u range; type B covers its first two ranges
    (N_cs <= d_u < L/5 and L/5 <= d_u <= (L-N_cs)/4); the remaining type B
    ranges (very-high-speed corner) raise.
    """
    if restricted == "unrestricted":
        return list(range(0, l_ra - ncs + 1, ncs)) if ncs else [0]
    du = _d_u(u, l_ra)
    if restricted == "type_a":
        if ncs <= du < l_ra // 3:
            n_shift = du // ncs
            d_start = 2 * du + n_shift * ncs
            n_group = l_ra // d_start
            n_shift_bar = max((l_ra - 2 * du - n_group * d_start) // ncs, 0)
        elif l_ra // 3 <= du <= (l_ra - ncs) // 2:
            n_shift = (l_ra - 2 * du) // ncs
            d_start = l_ra - 2 * du + n_shift * ncs
            n_group = du // d_start
            n_shift_bar = min(max((du - n_group * d_start) // ncs, 0), n_shift)
        else:
            return []            # this root supports no type-A preambles
    elif restricted == "type_b":
        if ncs <= du < l_ra // 5:
            n_shift = du // ncs
            d_start = 4 * du + n_shift * ncs
            n_group = l_ra // d_start
            n_shift_bar = max((l_ra - 4 * du - n_group * d_start) // ncs, 0)
        elif l_ra // 5 <= du <= (l_ra - ncs) // 4:
            n_shift = (l_ra - 4 * du) // ncs
            d_start = l_ra - 4 * du + n_shift * ncs
            n_group = du // d_start
            n_shift_bar = min(max((du - n_group * d_start) // ncs, 0), n_shift)
        else:
            raise NotImplementedError(
                f"restricted type B with d_u={du} outside the two main "
                "ranges (TS38.211 §6.3.3.1 ranges 3-5) is not supported")
    else:
        raise ValueError(restricted)
    if n_shift == 0:
        return []
    w = n_group * n_shift + n_shift_bar
    return [d_start * (v // n_shift) + (v % n_shift) * ncs for v in range(w)]


@functools.lru_cache(maxsize=None)
def _config_tables():
    import json
    return json.loads((_DATA.parent / "prach_config_tables.json").read_text())


def prach_configuration(index: int, duplex: str = "fr1_unpaired"):
    """TS38.211 Table 6.3.3.2-2/-3: the PRACH occasion schedule of a config
    index (format, x, y, subframes, starting_symbol, ...), or None for a
    reserved entry; from the port's copy of the JAX package's table."""
    return _config_tables()[duplex][index]


def zc_sequence(u: int, l_ra: int, cyclic_shift: int = 0) -> np.ndarray:
    """Zadoff-Chu x_{u,v}(n) = exp(-j pi u n(n+1) / L), cyclically shifted."""
    n = (np.arange(l_ra) + cyclic_shift) % l_ra
    phase = -np.pi * u * n * (n + 1.0) / l_ra
    return np.exp(1j * phase).astype(np.complex64)
