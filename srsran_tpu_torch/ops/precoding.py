"""Layer mapping and precoding (TS38.211 §7.3.1.3-4).

Port of srsran_tpu/ops/precoding.py.  :func:`precode_prg` is the plain
twin of K22 (ops/dl_map.py::pdsch_map with a PRG table).
"""

from __future__ import annotations

import numpy as np
import torch


def layer_map(symbols: torch.Tensor, nof_layers: int) -> torch.Tensor:
    """Codeword -> layers: d(i) -> layer i%v, pos i//v.  [..., S] -> [..., v, S/v]."""
    s = symbols.shape[-1]
    if s % nof_layers:
        raise ValueError(f"{s} symbols do not split over {nof_layers} layers")
    x = symbols.reshape(symbols.shape[:-1] + (s // nof_layers, nof_layers))
    return x.transpose(-1, -2)


def layer_demap(layers: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`layer_map`: [..., v, M] -> [..., v*M] (a transpose
    and a reshape, no arithmetic)."""
    x = layers.transpose(-1, -2)
    return x.reshape(x.shape[:-2] + (-1,))


def precode(layers: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Apply precoding.  layers [..., L, S], matrix [P, L] -> [..., P, S]."""
    return torch.einsum("pl,...ls->...ps", matrix.to(layers.dtype), layers)


def identity_precoder(nof_ports: int, nof_layers: int) -> np.ndarray:
    """Default port mapping when no codebook is given (scaled)."""
    m = np.zeros((nof_ports, nof_layers), dtype=np.complex64)
    for l in range(nof_layers):
        m[l % nof_ports, l] = 1.0
    return m / np.sqrt(nof_layers)


def precode_prg(layers: torch.Tensor, matrices: torch.Tensor,
                prg_of_re: torch.Tensor) -> torch.Tensor:
    """Per-PRG precoding: each RE's PRG matrix times its layer values.

    layers [L, S], matrices [G, P, L], prg_of_re int [S] -> [P, S].  The
    products and sums are rounded one by one in K22's order (layer 0
    first, real then imaginary parts as separate ops), so the kernel
    matches this bit for bit; the JAX package's one gather + einsum
    (srsran_tpu/ops/precoding.py:38) agrees to float32 rounding.
    """
    w = matrices.to(torch.complex64)[prg_of_re.long()]          # [S, P, L]
    out_r = out_i = None
    for l in range(layers.shape[-2]):
        wr, wi = w[:, :, l].real.T, w[:, :, l].imag.T           # [P, S]
        xr, xi = layers[l].real, layers[l].imag                 # [S]
        tr = wr * xr - wi * xi
        ti = wr * xi + wi * xr
        out_r = tr if out_r is None else out_r + tr
        out_i = ti if out_i is None else out_i + ti
    return torch.complex(out_r, out_i)
