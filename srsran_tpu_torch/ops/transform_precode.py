"""Transform precoding (DFT-s-OFDM, TS38.211 §6.3.1.4 / §6.3.2.6.1).

Port of srsran_tpu/ops/transform_precode.py: the per-symbol unitary DFT
over the M_sc data REs (M_sc = 12 * n_RB, factors 2, 3 and 5) as a dense
matmul with one host matrix (:func:`_dft_mat`, the JAX package's, cast to
complex64 once and cached per device).  :func:`precode` is UE-side only
(the PUCCH F3/F4 and PUSCH test transmitters); :func:`deprecode` is the
plain IDFT inside the twins of K18 (ops/ul_demap.py) and K19
(phy/upper/pucch.py), whose kernels compute the same transform as a
mixed-radix Stockham FFT in shared memory (csrc/dft_s_ofdm.cuh): the
radix plan of :func:`fft_plan`, by value in the launch's parameters, and
the table of :func:`twiddles`, uploaded once per size and device
(:func:`twiddle_table`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import const
from ..kernels import _build


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
    """The inverse DFT's n distinct roots of unity, complex64 [n]:
    exp(2j pi m / n), built in float64 and rounded once, so that entry
    (k * j) mod n over sqrt(n) is row k, column j of ``_dft_mat(n, True)``
    but for the float64 rounding of the phase.  The kernels' FFT stages
    read it at exact indices below n."""
    m = np.arange(n)
    return np.exp(2j * np.pi * m / n).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def twiddle_table(n: int, index: int) -> torch.Tensor:
    """:func:`twiddles` on CUDA device ``index``, uploaded once per size and
    kept for the life of the process (at most 53 sizes of DFT-s-OFDM occur;
    a captured CUDA graph may read the table at any replay)."""
    return torch.from_numpy(twiddles(n)).to(torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def fft_radices(n: int) -> tuple:
    """The radix order of the kernels' Stockham IDFT of ``n`` points: radix
    4 while 4 divides, then a 2, then 3s, then 5s.  Raises unless n = 2^a
    3^b 5^c, as M = 12 n_RB of a transform-precoded allocation is
    (TS38.211 §6.3.1.4)."""
    if n < 1:
        raise ValueError(f"{n} points")
    out, rest = [], n
    while rest % 4 == 0:
        out.append(4)
        rest //= 4
    if rest % 2 == 0:
        out.append(2)
        rest //= 2
    for r in (3, 5):
        while rest % r == 0:
            out.append(r)
            rest //= r
    if rest != 1:
        raise ValueError(f"{n} points: a DFT-s-OFDM size is 2^a 3^b 5^c")
    return tuple(out)


def fft_plan(n: int) -> _build.FftPlan:
    """csrc/dft_s_ofdm.cuh's FftPlan of the ``n``-point IDFT: per stage its
    radix R, the span of the sub-transforms it reads (the product of the
    earlier radices), the twiddle step n / (span R) and the magic number
    2^32 // span + 1 whose 32-bit high product with j is j // span (checked
    for every butterfly j < n / R; 0 for span 1, where the kernel takes j
    mod span as 0); and 1 / sqrt(n) from float64, rounded once."""
    radices = fft_radices(n)
    if len(radices) > _build.FFT_MAX_STAGES:
        raise ValueError(f"{n} points take {len(radices)} FFT stages, more "
                         f"than {_build.FFT_MAX_STAGES}")
    p = _build.FftPlan(M=n, stages=len(radices),
                       scale=float(np.float32(1.0 / np.sqrt(np.float64(n)))))
    span = 1
    for s, r in enumerate(radices):
        magic = 0xFFFFFFFF // span + 1 if span > 1 else 0
        j = np.arange(n // r, dtype=np.uint64)
        if span > 1 and not np.array_equal(
                (j * np.uint64(magic)) >> np.uint64(32), j // np.uint64(span)):
            raise ValueError(f"{n} points: no exact 32-bit quotient by "
                             f"{span}")
        p.radix[s], p.span[s], p.step[s] = r, span, n // (span * r)
        p.magic[s] = magic
        span *= r
    return p
