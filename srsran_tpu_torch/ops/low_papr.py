"""Low-PAPR (type 1) base sequences r_{u,v} (TS38.211 §5.2.2), host-side.

The port's own copy of the numpy part of srsran_tpu/ops/low_papr.py
(``base_sequence``, ``_largest_prime_below``): closed-form phi tables for
M_sc in {6, 12, 18, 24}, cyclically extended Zadoff-Chu for M_sc >= 36.
tests/test_torch_host_plans.py pins the copy to its original.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent.parent / "data" / "low_papr_tables.npz"


@functools.lru_cache(maxsize=None)
def _phi_tables():
    z = np.load(_DATA)
    return {m: z[f"phi_{m}"] for m in (6, 12, 18, 24)}


@functools.lru_cache(maxsize=None)
def base_sequence(u: int, v: int, m_sc: int) -> np.ndarray:
    """r̄_{u,v}(n), complex64 [m_sc]."""
    if m_sc in (6, 12, 18, 24):
        phi = _phi_tables()[m_sc][u]
        return np.exp(1j * np.pi * phi / 4.0).astype(np.complex64)
    # M >= 36: cyclic extension of ZC of largest prime < m_sc.
    nzc = _largest_prime_below(m_sc)
    q_bar = nzc * (u + 1) / 31.0
    q = int(np.floor(q_bar + 0.5)) + v * (1 if (int(np.floor(2 * q_bar)) % 2) == 0 else -1)
    m = np.arange(nzc)
    x_q = np.exp(-1j * np.pi * q * m * (m + 1) / nzc)
    n = np.arange(m_sc)
    return x_q[n % nzc].astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _largest_prime_below(n: int) -> int:
    for cand in range(n - 1, 1, -1):
        if all(cand % d for d in range(2, int(cand ** 0.5) + 1)):
            return cand
    raise ValueError(n)
