"""Transform precoding (DFT-s-OFDM, TS38.211 §6.3.1.4 / §6.3.2.6.1).

Port of srsran_tpu/ops/transform_precode.py: the per-symbol unitary DFT
over the M_sc data REs (M_sc = 12 * n_RB, factors 2, 3 and 5) as a dense
matmul with one host matrix (:func:`_dft_mat`, the JAX package's, cast to
complex64 once and cached per device).  :func:`precode` is UE-side only
(the PUCCH F3/F4 and PUSCH test transmitters); :func:`deprecode` is the
plain IDFT inside the twins of K18 (ops/ul_demap.py) and K19
(phy/upper/pucch.py), whose kernels evaluate the same sums directly from
the twiddle table of :func:`twiddles`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import const


@functools.lru_cache(maxsize=None)
def _dft_mat(n: int, inverse: bool) -> np.ndarray:
    k = np.arange(n)
    sign = 2j if inverse else -2j
    return (np.exp(sign * np.pi * np.outer(k, k) / n) / np.sqrt(n)).astype(np.complex64)


def _dft_mat_t(n: int, inverse: bool) -> np.ndarray:
    return np.ascontiguousarray(_dft_mat(n, inverse).T)


def precode(x: torch.Tensor) -> torch.Tensor:
    """y = DFT(x) / sqrt(M) over the last axis (unitary)."""
    return torch.matmul(x, const(_dft_mat_t, x.shape[-1], False,
                                 device=x.device))


def deprecode(y: torch.Tensor) -> torch.Tensor:
    """x = IDFT(y) * sqrt(M) over the last axis (unitary inverse)."""
    return torch.matmul(y, const(_dft_mat_t, y.shape[-1], True,
                                 device=y.device))


@functools.lru_cache(maxsize=None)
def twiddles(n: int) -> np.ndarray:
    """The inverse DFT's M distinct entries, complex64 [n]:
    exp(2j pi m / n) / sqrt(n), built in float64 and rounded once, so that
    entry (k * j) mod n is row k, column j of ``_dft_mat(n, True)`` but for
    the float64 rounding of the phase."""
    m = np.arange(n)
    return (np.exp(2j * np.pi * m / n) / np.sqrt(n)).astype(np.complex64)
