"""Polar code construction per TS38.212 §5.3.1 / §5.4.1 (host-side).

Analogue of the reference's polar_code_impl
(lib/phy/upper/channel_coding/polar/polar_code_impl.h:84-129, NMAX=1024):
given (K, E, nmax, ibil) produce the static code description — mother code
size N, frozen mask, info-bit positions, rate-matching mode — that the
device kernels bake in at trace time.

The port's own copy of srsran_tpu/ran/polar_params.py:
the port imports nothing of the JAX package.  tests/test_torch_host_plans.py
pins the copy to its original.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent.parent / "data" / "polar_tables.npz"

# TS38.212 §5.4.1.1 Table 5.4.1.1-1: sub-block interleaver pattern P(i).
SUBBLOCK_PATTERN = np.array(
    [0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19, 12, 20, 13, 21,
     14, 22, 15, 23, 24, 25, 26, 28, 27, 29, 30, 31], dtype=np.int32)

EBPSK_NMAX_LOG = 10  # Nmax = 1024


@functools.lru_cache(maxsize=None)
def _tables():
    z = np.load(_DATA)
    return z["reliability_1024"], z["interleaver_pattern"]


def reliability_sequence(n: int) -> np.ndarray:
    """Q_N: subsequence of the universal Q_1024 with entries < N (ascending
    reliability; last entry = most reliable)."""
    q1024, _ = _tables()
    big_n = 1 << n
    return q1024[q1024 < big_n]


def subblock_interleave_map(big_n: int) -> np.ndarray:
    """J(j) per TS38.212 §5.4.1.1: position in mother codeword feeding
    circular-buffer index j."""
    j = np.arange(big_n, dtype=np.int32)
    return SUBBLOCK_PATTERN[(32 * j) // big_n] * (big_n // 32) + j % (big_n // 32)


def input_interleave_map(k: int) -> np.ndarray:
    """TS38.212 §5.3.1.1 (i_IL=1, DL): out[i] = in[perm[i]], len K <= 164."""
    _, pattern = _tables()
    kmax = len(pattern)
    assert k <= kmax
    sel = pattern[pattern >= (kmax - k)] - (kmax - k)
    return sel.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class PolarCode:
    """Static polar code description."""

    k: int                 # info+crc (+pc) bits fed to the encoder
    e: int                 # rate-matched length
    n: int                 # log2 N
    big_n: int             # mother code length
    info_set: np.ndarray   # int32 [K] encoder input positions of info bits (sorted)
    frozen_mask: np.ndarray  # uint8 [N], 1 = frozen
    mode: str              # 'puncture' | 'shorten' | 'repeat' | 'none'
    ibil: bool             # channel (triangular) interleaver enabled (UL UCI)
    iil: bool              # input interleaver enabled (DL)
    n_pc: int = 0          # parity-check bits (UCI 12<=K<=19); 0 otherwise
    n_pc_wm: int = 0
    pc_set: np.ndarray = dataclasses.field(default=None)  # encoder positions of PC bits


@functools.lru_cache(maxsize=None)
def polar_code(k: int, e: int, nmax: int = 9, ibil: bool = False,
               n_pc: int = 0, n_pc_wm: int = 0) -> PolarCode:
    """Construct the code (TS38.212 §5.3.1.2).

    nmax = 9 for DL (PBCH/PDCCH), 10 for UL (PUCCH/PUSCH UCI).
    DL implies the input interleaver (i_IL = 1); UL implies ibil.
    """
    # E may exceed the mother code length by a large factor (repetition
    # mode, TS38.212 §5.4.1.1 allows E up to 8192 — e.g. PDCCH AL16 has
    # E = 1728 over N = 512).
    assert k >= 1 and e <= 8192  # sanity
    # n determination
    cl2e = int(np.ceil(np.log2(e)))
    if e <= (9 / 8) * (1 << (cl2e - 1)) and k / e < 9 / 16:
        n1 = cl2e - 1
    else:
        n1 = cl2e
    rmin = 1 / 8
    n2 = int(np.ceil(np.log2(k / rmin)))
    n = max(min(min(n1, n2), nmax), 5)
    big_n = 1 << n

    # Rate-matching mode
    if e >= big_n:
        mode = "repeat" if e > big_n else "none"
    elif 16 * k <= 7 * e:
        mode = "puncture"
    else:
        mode = "shorten"

    jmap = subblock_interleave_map(big_n)
    frozen = np.zeros(big_n, dtype=np.uint8)
    if mode == "puncture":
        # Bits J(0..N-E-1) are not transmitted; their encoder inputs are frozen.
        frozen[jmap[: big_n - e]] = 1
        # Additionally freeze the first T low-indexed inputs (§5.4.1.1).
        if e >= 3 * big_n // 4:
            t = int(np.ceil(3 * big_n / 4 - e / 2))
        else:
            t = int(np.ceil(9 * big_n / 16 - e / 4))
        frozen[:t] = 1
    elif mode == "shorten":
        # Bits J(E..N-1) are transmitted as 0: freeze those encoder outputs'
        # inputs (shortening freezes the corresponding input positions).
        frozen[jmap[e:]] = 1

    # Pick the K + n_pc most reliable non-forced-frozen positions.
    q = reliability_sequence(n)           # ascending reliability
    usable = q[frozen[q] == 0]
    assert len(usable) >= k + n_pc, (k, e, n, mode)
    chosen = usable[-(k + n_pc):]
    info_and_pc = np.sort(chosen.astype(np.int32))

    pc_set = np.array([], dtype=np.int32)
    if n_pc > 0:
        # TS38.212 §5.3.1.2: the n_pc - n_pc_wm least reliable of the chosen;
        # plus n_pc_wm of minimum row weight among the most reliable.
        chosen_by_rel = chosen  # ascending reliability
        pc = list(chosen_by_rel[: n_pc - n_pc_wm].astype(np.int32))
        if n_pc_wm > 0:
            rest = chosen_by_rel[n_pc - n_pc_wm:]
            weights = np.array([bin(int(i)).count("1") for i in rest])
            # minimum row weight; tie -> highest reliability (last occurrence)
            wmin = weights.min()
            cands = rest[weights == wmin]
            pc.extend(cands[-n_pc_wm:].astype(np.int32))
        pc_set = np.sort(np.array(pc, dtype=np.int32))
        info_set = np.sort(np.array(
            [i for i in info_and_pc if i not in set(pc_set.tolist())], dtype=np.int32))
    else:
        info_set = info_and_pc

    full_frozen = np.ones(big_n, dtype=np.uint8)
    full_frozen[info_set] = 0
    if len(pc_set):
        full_frozen[pc_set] = 0  # PC bits are computed, not frozen-zero

    return PolarCode(k=k, e=e, n=n, big_n=big_n, info_set=info_set,
                     frozen_mask=full_frozen, mode=mode, ibil=ibil,
                     iil=not ibil, n_pc=n_pc, n_pc_wm=n_pc_wm, pc_set=pc_set)
