"""Polar encode chain as one GF(2) matrix (TS38.212 §5.3.1, §5.4.1), host side.

Port of the host part of srsran_tpu/ops/polar.py (:88-159): the matrix M
[K, E] with ``rate_match(encode(allocate(msg))) == msg @ M mod 2`` and the
rate-matching index plans it is built from.  The PDCCH and PBCH chains fold
M into their affine maps (phy/upper/pdcch.py, phy/upper/ssb.py), so the
slot runs no polar op on the device.  The device encoder and the SC/SCL
decoders are not ported yet (ROADMAP §1 item 13).
"""

from __future__ import annotations

import functools

import numpy as np

from ..ran.polar_params import (PolarCode, input_interleave_map,
                                subblock_interleave_map)

_ENCODE_MATRIX_CACHE: dict = {}


def encode_matrix(code: PolarCode) -> np.ndarray:
    """GF(2) matrix M [K, E] (uint8) of allocate -> u F^{(x)n} -> rate match
    (+ i_BIL); linear for n_pc == 0."""
    if code.n_pc != 0:
        raise ValueError("PC-polar (UCI 12..19 bits) is not linear")
    key = (code.k, code.e, code.n, code.mode, code.ibil, code.iil,
           code.info_set.tobytes())
    hit = _ENCODE_MATRIX_CACHE.get(key)
    if hit is not None:
        return hit
    k, big_n = code.k, code.big_n
    placed = np.eye(k, dtype=np.uint8)
    if code.iil:
        # allocate() takes msg' = msg[perm]; on basis rows that is a
        # column reorder: placed[r, i] = (perm[i] == r).
        placed = placed[:, input_interleave_map(code.k)]
    u = np.zeros((k, big_n), dtype=np.uint8)
    u[:, code.info_set] = placed
    x = u
    for s in range(code.n):
        half = 1 << s
        x = x.reshape(k, big_n // (2 * half), 2, half)
        left = x[:, :, 0] ^ x[:, :, 1]
        x = np.stack([left, x[:, :, 1]], axis=2)
    x = x.reshape(k, big_n)
    out = x[:, _rm_plan(code.big_n, code.e, code.mode)]
    if code.ibil:
        out = out[:, _triangle_perm(code.e)]
    out = out.astype(np.uint8)
    _ENCODE_MATRIX_CACHE[key] = out
    return out


@functools.lru_cache(maxsize=None)
def _rm_plan(big_n: int, e: int, mode: str) -> np.ndarray:
    """src index in mother codeword for each of the E transmitted bits."""
    jmap = subblock_interleave_map(big_n)
    if mode == "puncture":
        sel = np.arange(big_n - e, big_n)
    elif mode == "shorten":
        sel = np.arange(e)
    else:  # none / repeat
        sel = np.arange(e) % big_n
    return jmap[sel].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _triangle_perm(e: int) -> np.ndarray:
    """TS38.212 §5.4.1.3 triangular channel interleaver: out[i] = in[perm[i]]."""
    t = 1
    while t * (t + 1) // 2 < e:
        t += 1
    k = 0
    mat = -np.ones((t, t), dtype=np.int64)
    for r in range(t):
        for c in range(t - r):
            if k < e:
                mat[r, c] = k
                k += 1
    perm = mat.T.reshape(-1)
    return perm[perm >= 0].astype(np.int32)
