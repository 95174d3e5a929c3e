"""Shared-channel decoder: rate dematch + HARQ combine + LDPC decode + CRC.

Port of srsran_tpu/phy/upper/sch_decoder.py.  The codeblock axis is the
batch axis of the K2 (dematch/combine) and K1 (decoder) kernels; the CB
CRC24B and TB CRC checks that follow are GF(2) products (ops/crc.py).
A leading slot axis (the slot-batch mode) runs through the same kernels
once for all slots, with the decoder's early stop kept per slot.
"""

from __future__ import annotations

import dataclasses

import torch

from ...ran.ldpc_params import SegmentParams
from ...ops import ldpc_decode, ldpc_rate_match
from ...ops.crc import crc_check


@dataclasses.dataclass
class SchDecodeResult:
    """One TB's decode; each field has the slot axis in front when the
    LLRs had one."""

    tb_bits: torch.Tensor        # int8 [tbs]
    tb_crc_ok: torch.Tensor      # bool scalar
    cb_crc_ok: torch.Tensor      # bool [C]
    new_soft: torch.Tensor       # f32 [C, N] combined LLRs (HARQ buffer state)
    nof_iterations: torch.Tensor  # i32 scalar: sweeps used (early stop)


def decode(llrs: torch.Tensor, seg: SegmentParams, e_sizes: list, rv: int,
           qm: int, tbs: int, soft_buffer: torch.Tensor | None = None,
           nof_iterations: int = 6) -> SchDecodeResult:
    """Decode a codeword's LLRs [G] into a transport block.

    soft_buffer: f32 [C, N] previous-transmission combined LLRs (HARQ).
    With a slot axis: llrs [B, G], soft_buffer [B, C, N].
    """
    lead = tuple(llrs.shape[:-1])
    bg, z, c = seg.base_graph, seg.lifting_size, seg.nof_codeblocks
    k_prime, k, n = seg.cb_info_bits, seg.full_block_bits, seg.codeword_bits
    new_soft, full = ldpc_rate_match.rate_dematch_combine(
        llrs, c, e_sizes, rv, qm, bg, z, k_prime, k, n, soft_buffer)
    # Active layers cover the filled extent of the (combined) buffer; with a
    # HARQ soft buffer or rv > 0 the extent can reach the full N.
    if soft_buffer is not None or rv != 0:
        nof_layers = bg_rows(bg)
    else:
        nof_layers = max(4, min(seg_layers(seg, e_sizes), bg_rows(bg)))
    es_poly = "crc24B" if seg.cb_crc_bits else (
        "crc24A" if seg.tb_crc_bits == 24 else "crc16")
    bits, _, nof_iter_used = ldpc_decode.decode_early_stop(
        full, bg, z, nof_layers, nof_iterations,
        ldpc_decode.DEFAULT_SCALING, es_poly, k_prime)
    info = bits[..., :k_prime]                                  # [C, K']
    if seg.cb_crc_bits:
        cb_ok = crc_check(info, "crc24B")
        payload = info[..., :k_prime - seg.cb_crc_bits].reshape(lead + (-1,))
    else:
        cb_ok = torch.ones(lead + (c,), dtype=torch.bool, device=llrs.device)
        payload = info.reshape(lead + (-1,))
    tb_with_crc = payload[..., : tbs + seg.tb_crc_bits]
    poly = "crc24A" if seg.tb_crc_bits == 24 else "crc16"
    tb_ok = crc_check(tb_with_crc, poly) & torch.all(cb_ok, dim=-1)
    return SchDecodeResult(tb_bits=tb_with_crc[..., :tbs], tb_crc_ok=tb_ok,
                           cb_crc_ok=cb_ok, new_soft=new_soft,
                           nof_iterations=nof_iter_used)


def bg_rows(bg: int) -> int:
    return 46 if bg == 1 else 42


def seg_layers(seg: SegmentParams, e_sizes: list) -> int:
    """Active decoder layers adapted to the received length."""
    z = seg.lifting_size
    bg_k = 22 if seg.base_graph == 1 else 10
    max_e = max(e_sizes)
    cb_len = min(seg.codeword_bits + 2 * z,
                 ((max_e + 2 * z + z - 1) // z) * z)
    return max(4, cb_len // z - bg_k)
