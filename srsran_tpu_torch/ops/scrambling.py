"""Scrambling / descrambling with the Gold sequence (TS38.211).

Port of srsran_tpu/ops/scrambling.py: bit XOR on TX, LLR sign flip on RX.
On the PUSCH receive path the descramble is fused into the demap kernel
(ops/ul_demap.py); these are the plain forms.
"""

from __future__ import annotations

import torch

from .gold import gold_sequence


def scramble_bits(bits: torch.Tensor, c_init: int,
                  advance: int = 0) -> torch.Tensor:
    """bits int8 [..., N] ^ c(c_init)."""
    seq = gold_sequence(c_init, bits.shape[-1], advance, device=bits.device)
    return (bits.to(torch.int8) ^ seq.to(torch.int8))


def descramble_llrs(llrs: torch.Tensor, c_init: int,
                    advance: int = 0) -> torch.Tensor:
    """Flip LLR signs where the scrambling bit is 1."""
    seq = gold_sequence(c_init, llrs.shape[-1], advance, device=llrs.device)
    return torch.where(seq.bool(), -llrs, llrs)
