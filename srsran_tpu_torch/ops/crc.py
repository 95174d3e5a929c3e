"""CRC calculators per TS38.212 §5.1 as GF(2) products.

Port of srsran_tpu/ops/crc.py.  The CRC of an MSB-first message is
``bits @ M mod 2`` with M the host remainder matrix.  PyTorch has no
integer matmul on CUDA, so the product runs in float32 and is reduced mod 2:
every partial sum is an integer no larger than the message length, exact in
float32 while it stays below 2**24 (the flagship TB CRC has 311,424 rows).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import const

# Generator polynomials, TS38.212 §5.1 (low L bits; the x**L term is implicit).
POLYS = {
    "crc24A": (24, 0x864CFB),
    "crc24B": (24, 0x800063),
    "crc24C": (24, 0xB2B117),
    "crc16": (16, 0x1021),
    "crc11": (11, 0x621),
    "crc6": (6, 0x21),
}

_F32_EXACT = 1 << 24


@functools.lru_cache(maxsize=64)
def _remainder_words(poly_name: str, nbits: int) -> np.ndarray:
    """uint32 [nbits]: word i = remainder of x**(nbits-1-i+L) mod g(x)."""
    length, poly = POLYS[poly_name]
    mask = (1 << length) - 1
    top = 1 << (length - 1)
    words = np.zeros(nbits, dtype=np.uint32)
    r = poly & mask
    for i in range(nbits - 1, -1, -1):
        words[i] = r
        carry = r & top
        r = (r << 1) & mask
        if carry:
            r ^= poly & mask
    words.setflags(write=False)
    return words


@functools.lru_cache(maxsize=64)
def _remainder_matrix(poly_name: str, nbits: int) -> np.ndarray:
    """M[nbits, L] (int8): row i holds the bits of _remainder_words, MSB
    first; crc(bits) = bits @ M mod 2."""
    length, _ = POLYS[poly_name]
    w = _remainder_words(poly_name, nbits).astype(np.int64)
    shifts = np.arange(length - 1, -1, -1, dtype=np.int64)
    m = ((w[:, None] >> shifts[None, :]) & 1).astype(np.int8)
    m.setflags(write=False)
    return m


def crc_matrix(poly_name: str, nbits: int) -> torch.Tensor:
    """The host remainder matrix [nbits, L] as a tensor (CPU)."""
    return torch.from_numpy(_remainder_matrix(poly_name, nbits).copy())


def crc(bits: torch.Tensor, poly_name: str) -> torch.Tensor:
    """CRC of MSB-first bit array; batched over leading dims.

    bits: int [..., N] in {0,1}.  Returns int8 [..., L].
    """
    n = bits.shape[-1]
    if n >= _F32_EXACT:
        raise ValueError(f"CRC over {n} bits is not exact in float32")
    m = const(_remainder_matrix, poly_name, n, device=bits.device,
              dtype=torch.float32)
    acc = torch.matmul(bits.to(torch.float32), m)
    return (acc.to(torch.int32) & 1).to(torch.int8)


def crc_check(bits_with_crc: torch.Tensor, poly_name: str) -> torch.Tensor:
    """True where the trailing CRC matches; batched.  [..., N+L] -> [...]."""
    return torch.all(crc(bits_with_crc, poly_name) == 0, dim=-1)
