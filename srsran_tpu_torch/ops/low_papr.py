"""Low-PAPR (type 1) base sequences r_{u,v} (TS38.211 §5.2.2), host-side.

The port's own copy of the numpy part of srsran_tpu/ops/low_papr.py
(``base_sequence``, ``_largest_prime_below``): closed-form phi tables for
M_sc in {6, 12, 18, 24}, cyclically extended Zadoff-Chu for M_sc >= 36.
tests/test_torch_host_plans.py pins the copy to its original.
:func:`sequence` (the cyclic shift alpha applied) and :func:`group_hopping`
((u, v) per slot and symbol) are built on the host, as in the JAX package.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

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


def sequence(u: int, v: int, alpha: float, m_sc: int) -> torch.Tensor:
    """r_{u,v}^{(alpha)}(n) = e^{j alpha n} r̄_{u,v}(n), complex64 [m_sc]
    (host)."""
    n = np.arange(m_sc)
    return torch.from_numpy((np.exp(1j * alpha * n)
                             * base_sequence(u, v, m_sc)).astype(np.complex64))


def group_hopping(n_id: int, group_hopping_enabled: bool = False,
                  sequence_hopping_enabled: bool = False,
                  slot: int = 0, symbol: int = 0, m_sc: int = 12) -> tuple:
    """(u, v) per TS38.211 §6.3.2.2.1 (PUCCH) / §6.4.1.1.1.2 (PUSCH DM-RS):
    group hopping f_gh = sum_m 2^m c(8(14 ns + l) + m) mod 30 from the Gold
    sequence seeded by floor(n_id / 30); sequence hopping takes v from one
    bit of it (only for M_sc >= 6 PRB)."""
    from .gold import gold_sequence_np
    f_gh, v = 0, 0
    if group_hopping_enabled:
        seq = gold_sequence_np(n_id // 30, 8, advance=8 * (14 * slot + symbol))
        f_gh = int(sum(int(b) << m for m, b in enumerate(seq))) % 30
    elif sequence_hopping_enabled and m_sc >= 6 * 12:
        seq = gold_sequence_np(n_id // 30, 1, advance=(14 * slot + symbol))
        v = int(seq[0])
    return (f_gh + n_id) % 30, v
