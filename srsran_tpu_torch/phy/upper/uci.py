"""UCI codec: encode/decode for any payload size (TS38.212 §6.3).

Port of srsran_tpu/phy/upper/uci.py: <=11 bits -> short-block (RM/simplex/
repetition) with ML detection (K14); 12..19 -> polar with CRC6 + 3 PC bits;
>=20 -> polar with CRC11 (K15).  The UE side encodes by K34 (short block)
and K33 (polar).  Shared by PUCCH F3/F4 and UCI on PUSCH
(PUCCH F2 keeps its own polar parameters, pucch._f2_polar_cfg).
"""

from __future__ import annotations

import torch

from ...device import const, f32
from ...ops import polar as polar_ops
from ...ops import short_block
from ...ops.crc import crc
from ...ran import polar_params


def _polar_cfg(o_bits: int, e: int):
    crc_len = 6 if o_bits < 20 else 11
    n_pc = 3 if (o_bits + crc_len) <= 22 and o_bits < 20 else 0
    code = polar_params.polar_code(o_bits + crc_len, e, nmax=10, ibil=True,
                                   n_pc=n_pc)
    return code, crc_len


def encode_uci(bits: torch.Tensor, e: int, qm: int) -> torch.Tensor:
    """[K] -> [E] coded bits (UE side), on the device of ``bits``: K34 for
    short blocks, K33 for polar codes."""
    k = bits.shape[-1]
    if k <= 11:
        return short_block.encode(bits[None], e, qm)[0]
    code, crc_len = _polar_cfg(k, e)
    with_crc = torch.cat([bits[None].to(torch.int8),
                          crc(bits[None], f"crc{crc_len}")], dim=-1)
    return polar_ops.encode_chain(with_crc, code)[0]


def decode_uci(llrs: torch.Tensor, o_bits: int, qm: int):
    """[E] LLRs -> (bits int8 [K], valid bool, metric f32), on the device of
    the LLRs (K14 for short blocks, K15 for polar codes); [B, E] (a slot
    batch) -> every value with a leading slot axis, from one launch."""
    llrs = llrs[..., None, :]                   # [(B,) 1, E]: one codeword
    if o_bits <= 11:
        bits, metric = short_block.detect(llrs, o_bits, qm)
        return bits[..., 0, :], metric[..., 0] > 0.25, metric[..., 0]
    code, crc_len = _polar_cfg(o_bits, llrs.shape[-1])
    dec, ok = polar_ops.decode(llrs, code, f"crc{crc_len}")
    return (dec[..., 0, :o_bits], ok[..., 0],
            const(f32, (1.0,), device=llrs.device)[0].expand(ok.shape[:-1]))
