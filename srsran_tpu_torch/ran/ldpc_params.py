"""LDPC segmentation / lifting parameters per TS38.212 §5.2.2, §5.3.2, §7.2.2.

Host-side scalar math equivalent to the reference's
include/srsran/phy/upper/channel_coding/ldpc/ldpc.h +
lib/phy/upper/channel_coding/ldpc/ldpc_segmenter_helpers.h: selects base
graph, lifting size, codeblock count and filler bits for a transport block.
All outputs are static shapes for the jit-compiled coding kernels.

The port's own copy of srsran_tpu/ran/ldpc_params.py:
the port imports nothing of the JAX package.  tests/test_torch_host_plans.py
pins the copy to its original.
"""

from __future__ import annotations

import dataclasses
import functools

# All 51 valid lifting sizes: a * 2**j, a in {2,3,5,7,9,11,13,15}, Z <= 384.
LIFTING_SIZES = sorted(
    {a << j for a in (2, 3, 5, 7, 9, 11, 13, 15) for j in range(8) if (a << j) <= 384}
)
assert len(LIFTING_SIZES) == 51

# Lifting set index iLS keyed by the odd factor a (TS38.212 Table 5.3.2-1).
_SET_INDEX = {2: 0, 3: 1, 5: 2, 7: 3, 9: 4, 11: 5, 13: 6, 15: 7}


def lifting_set_index(z: int) -> int:
    a = z
    while a % 2 == 0 and a > 2:
        a //= 2
    return _SET_INDEX[a]


# Base-graph dimensions.
BG1_ROWS, BG1_COLS, BG1_KB = 46, 68, 22
BG2_ROWS, BG2_COLS, BG2_KB = 42, 52, 10
MAX_CB_BG1 = 8448   # Kcb
MAX_CB_BG2 = 3840


def select_base_graph(tbs: int, rate: float) -> int:
    """TS38.212 §7.2.2 (DL-SCH) / §6.2.2 (UL-SCH): returns 1 or 2."""
    if tbs <= 292 or (tbs <= 3824 and rate <= 0.67) or rate <= 0.25:
        return 2
    return 1


@dataclasses.dataclass(frozen=True)
class SegmentParams:
    """Static segmentation description of one transport block."""

    base_graph: int          # 1 or 2
    nof_codeblocks: int      # C
    lifting_size: int        # Z
    cb_info_bits: int        # K' : payload+CRC bits per codeblock (pre-filler)
    full_block_bits: int     # K  : info-part length incl. filler bits
    filler_bits: int         # K - K'
    tb_crc_bits: int         # 16 or 24 (CRC24A)
    cb_crc_bits: int         # 24 (CRC24B) if C > 1 else 0
    codeword_bits: int       # N = 66Z (BG1) / 50Z (BG2)

    @property
    def nof_info_base_cols(self) -> int:
        return BG1_KB if self.base_graph == 1 else BG2_KB


@functools.lru_cache(maxsize=None)
def segment_tb(tbs: int, base_graph: int) -> SegmentParams:
    """Compute segmentation for a TB of ``tbs`` payload bits (TS38.212 §5.2.2)."""
    l_tb = 24 if tbs > 3824 else 16
    b = tbs + l_tb
    kcb = MAX_CB_BG1 if base_graph == 1 else MAX_CB_BG2
    if b <= kcb:
        c, l_cb, b_eff = 1, 0, b
    else:
        l_cb = 24
        c = -(-b // (kcb - l_cb))
        b_eff = b + c * l_cb
    # K' = B'/C; NR TBS determination (TS38.214) guarantees divisibility for
    # real transport blocks — for arbitrary payloads we round up and the
    # segmenter zero-pads the tail block.
    k_prime = -(-b_eff // c)

    if base_graph == 1:
        kb = 22
    else:
        if b > 640:
            kb = 10
        elif b > 560:
            kb = 9
        elif b > 192:
            kb = 8
        else:
            kb = 6

    z = next(zz for zz in LIFTING_SIZES if kb * zz >= k_prime)
    k = 22 * z if base_graph == 1 else 10 * z
    n = 66 * z if base_graph == 1 else 50 * z
    return SegmentParams(
        base_graph=base_graph,
        nof_codeblocks=c,
        lifting_size=z,
        cb_info_bits=k_prime,
        full_block_bits=k,
        filler_bits=k - k_prime,
        tb_crc_bits=l_tb,
        cb_crc_bits=l_cb,
        codeword_bits=n,
    )


def rate_match_k0(base_graph: int, rv: int, n_cb: int, z: int) -> int:
    """Starting position k0, TS38.212 Table 5.4.2.1-2."""
    if base_graph == 1:
        num = {0: 0, 1: 17, 2: 33, 3: 56}[rv]
        den = 66
    else:
        num = {0: 0, 1: 13, 2: 25, 3: 43}[rv]
        den = 50
    return (num * n_cb // (den * z)) * z
