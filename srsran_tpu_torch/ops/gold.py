"""Gold pseudo-random sequence (TS38.211 §5.2.1), built on the host.

Port of srsran_tpu/ops/gold.py.  The sequence is computed on the host
(:func:`gold_sequence_np`, the same bit-serial recurrences as the JAX
package's reference, evaluated 28 bits at a time: x(n+31) depends on
x(n+3) at the nearest), cached per (c_init, length, advance) and uploaded
once per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import const

NC = 1600


@functools.lru_cache(maxsize=256)
def gold_sequence_np(c_init: int, length: int, advance: int = 0) -> np.ndarray:
    """Gold bits c(advance .. advance+length) for one seed (uint8 [length])."""
    n_total = NC + advance + length
    x1 = np.zeros(n_total + 31, dtype=np.uint8)
    x2 = np.zeros(n_total + 31, dtype=np.uint8)
    x1[0] = 1
    x2[:31] = (int(c_init) >> np.arange(31)) & 1
    for i in range(0, n_total, 28):
        e = min(i + 28, n_total)
        x1[i + 31:e + 31] = x1[i + 3:e + 3] ^ x1[i:e]
        x2[i + 31:e + 31] = (x2[i + 3:e + 3] ^ x2[i + 2:e + 2]
                             ^ x2[i + 1:e + 1] ^ x2[i:e])
    c = x1[NC + advance:n_total] ^ x2[NC + advance:n_total]
    c.setflags(write=False)
    return c


def gold_sequence(c_init: int, length: int, advance: int = 0, *,
                  device: torch.device | str) -> torch.Tensor:
    """Gold bits as a uint8 [length] tensor on ``device`` (cached); the
    device is always the caller's, never a default."""
    return const(gold_sequence_np, int(c_init), int(length), int(advance),
                 device=device)
