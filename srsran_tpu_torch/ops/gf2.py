"""GF(2) linear-algebra helpers (host-side precompute, numpy).

The TPU-native trick used throughout this framework: bit-sequential
operations of the reference (CRC long division, Gold LFSR stepping,
scrambling) become GF(2) matrix products, which on device are int8 matmuls
on the MXU followed by ``& 1``.  This module builds those matrices once on
the host.

The port's own copy of srsran_tpu/ops/gf2.py:
the port imports nothing of the JAX package.  tests/test_torch_host_plans.py
pins the copy to its original.
"""

from __future__ import annotations

import numpy as np


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2) (uint8 in/out)."""
    return (a.astype(np.uint32) @ b.astype(np.uint32)) & 1


def gf2_matpow(a: np.ndarray, k: int) -> np.ndarray:
    """a**k over GF(2) by log-squaring."""
    n = a.shape[0]
    result = np.eye(n, dtype=np.uint8)
    base = a.astype(np.uint8)
    while k:
        if k & 1:
            result = gf2_matmul(result, base).astype(np.uint8)
        base = gf2_matmul(base, base).astype(np.uint8)
        k >>= 1
    return result


def companion_from_taps(taps: list[int], n: int) -> np.ndarray:
    """State-update matrix A for an LFSR with x(m+n) = sum_t x(m+t).

    State vector s_m = (x(m), ..., x(m+n-1)); s_{m+1} = A @ s_m.
    """
    a = np.zeros((n, n), dtype=np.uint8)
    for i in range(n - 1):
        a[i, i + 1] = 1
    for t in taps:
        a[n - 1, t] = 1
    return a
