"""EVM from hard decisions, closed form per I/Q axis.

Port of srsran_tpu/ops/evm.py::evm: for square QAM the nearest Gray-QAM
point separates per axis, so the error is computed from each coordinate;
the BPSK forms remodulate the hard decisions of the LLRs.
"""

from __future__ import annotations

import torch

from .modulation import BITS_PER_SYMBOL, _SCALE, modulate


def _axis_error(coord: torch.Tensor, nof_levels: int, scale: float):
    """Distance from a PAM coordinate to the nearest level in
    {±1, ±3, … ±(2L-1)} * scale."""
    y = coord.abs() / scale
    nearest = torch.clamp(2.0 * torch.floor(y / 2.0) + 1.0, 1.0,
                          2.0 * nof_levels - 1.0)
    up = torch.clamp_max(nearest + 2.0, 2.0 * nof_levels - 1.0)
    err = torch.minimum((y - nearest).abs(), (y - up).abs())
    return err * scale


def evm(symbols: torch.Tensor, llrs: torch.Tensor, scheme: str) -> torch.Tensor:
    """RMS EVM.  symbols [..., S] equalized; llrs [..., S*Qm] the demapped
    (not descrambled) LLRs, read by the BPSK forms only."""
    if scheme in ("bpsk", "pi2bpsk"):
        ref = modulate((llrs < 0).to(torch.int8), scheme)
        return torch.sqrt(torch.mean((symbols - ref).abs() ** 2, dim=-1))
    qm = BITS_PER_SYMBOL[scheme]
    nof_levels = 1 << (qm // 2 - 1)
    scale = _SCALE[scheme]
    ei = _axis_error(symbols.real, nof_levels, scale)
    eq = _axis_error(symbols.imag, nof_levels, scale)
    return torch.sqrt(torch.mean(ei * ei + eq * eq, dim=-1))
