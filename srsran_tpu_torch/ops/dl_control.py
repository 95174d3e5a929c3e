"""DL control map: K27, csrc/dl_control_map.cu.

The JAX package computes the PDCCH's and the PBCH's whole bit chain as one
GF(2) affine map in each function's body (srsran_tpu/phy/upper/pdcch.py::
process :283-307, ssb.py::ssb_block :298-333), maps the coded bits to QPSK
and adds a dense patch into the grid (map_ssb_to_grid :336-341).  On CUDA
tensors :func:`control_map` runs every PDCCH and SSB of a DL slot in one
launch (one for every 16 PDUs); each PDU is a :class:`ControlItem` built
by phy/upper/pdcch.py or ssb.py, whose ``ref`` is the plain version of
that PDU (the port's GF(2) product as a float product reduced mod 2, QPSK
and the patch add).  On CPU tensors the items' plain versions run in plan
order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from ..device import is_cuda
from ..kernels import _build

KERNEL = kernels.register(kernels.Kernel(
    name="control_map", route="cuda",
    source="srsran_tpu_torch/csrc/dl_control_map.cu",
    replaces="srsran_tpu/phy/upper/pdcch.py:283"))

QPSK = float(np.float32(2 ** -0.5))
MAX_WORDS = 8                 # csrc/dl_control_map.cu kMaxWords


@dataclasses.dataclass
class ControlItem:
    """One PDCCH or SSB of a DL slot, as K27 takes it.

    rows int32 [E, W] the fused GF(2) map by output bit (bit j of word w is
    M[32 w + j, e]); offset int32 [E] its constant bits; index int32
    [h * w] the patch plan (0: base, 1 + k: data symbol k, 1 + nd + j:
    pilot j); base complex64 [h * w] or None (zeros); bits the payload
    (int8 [n0] or [B, n0]) and, for the SSB's slot-context form, the timing
    bits and the scrambling mask (int8 [n1] or [B, n1]), XOR-ed after it;
    pilots complex64 [n] or [B, n], or None; ``ref(grid)`` the plain
    version of this PDU, adding into ``grid`` in place.
    """

    rows: torch.Tensor
    offset: torch.Tensor
    index: torch.Tensor
    base: torch.Tensor | None
    l0: int
    sc0: int
    h: int
    w: int
    all_ports: bool
    nd: int
    amplitude: float
    bits: tuple
    pilots: torch.Tensor | None
    ref: object


def pack_rows(m: np.ndarray) -> np.ndarray:
    """A GF(2) map M [A, E] (0/1) by output bit, 32 payload bits to a word:
    int32 [E, ceil(A / 32)] with bit j of word w = M[32 w + j, e]."""
    a, e = m.shape
    words = -(-a // 32)
    padded = np.zeros((e, 32 * words), np.uint8)
    padded[:, :a] = np.asarray(m, np.uint8).T & 1
    packed = np.packbits(padded, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").view(np.int32)


def _groups(items) -> list:
    """Item indices grouped by overlapping patch rectangles (in plan
    order within a group); groups are disjoint in REs."""
    groups: list = []
    for i, it in enumerate(items):
        hit = [g for g in groups if any(_overlap(it, items[j]) for j in g)]
        merged = [i]
        for g in hit:
            merged = g + merged
            groups.remove(g)
        groups.append(sorted(merged))
    return groups


def _overlap(a: ControlItem, b: ControlItem) -> bool:
    return (a.l0 < b.l0 + b.h and b.l0 < a.l0 + a.h
            and a.sc0 < b.sc0 + b.w and b.sc0 < a.sc0 + a.w)


def _int8_bits(t: torch.Tensor) -> torch.Tensor:
    t = t if t.dtype == torch.int8 else t.to(torch.int8)
    return t if t.stride(-1) == 1 else t.contiguous()


def _slot_stride(t: torch.Tensor, lead: tuple) -> int:
    if t.ndim == 1:
        return 0
    if tuple(t.shape[:-1]) != lead:
        raise ValueError(f"control input {tuple(t.shape)} vs slot axis {lead}")
    return t.stride(0)


def control_map(grid: torch.Tensor, items) -> torch.Tensor:
    """Add a DL slot's PDCCHs and SSBs into the grid (in place).

    grid complex64 [P, S, K] or [B, P, S, K]; items the slot's
    :class:`ControlItem` in plan order.  On CUDA one launch for every
    CONTROL_MAX_PDUS PDUs (the launch's PDU table; a slot of up to 16
    PDCCHs and SSBs takes one), a CTA per group of PDUs whose patches
    overlap (run in plan order).  Launches follow one another on the
    grid's stream in plan order, so PDUs of one group that fall in two
    launches still add in plan order.
    """
    items = tuple(items)
    if not items:
        return grid
    tensors = [grid] + [t for it in items for t in
                        (*it.bits, it.rows, it.offset, it.index, it.pilots,
                         it.base) if t is not None]
    if not is_cuda(*tensors):
        for it in items:
            it.ref(grid)
        return grid
    lead = tuple(grid.shape[:-3])
    if (grid.dtype != torch.complex64 or not grid.is_contiguous()
            or len(lead) > 1):
        raise ValueError("the grid must be contiguous complex64 [(B,) P, S, K]")
    n = _build.CONTROL_MAX_PDUS
    for c in range(0, len(items), n):
        _launch(grid, items[c:c + n], lead)
    return grid


def _launch(grid: torch.Tensor, items: tuple, lead: tuple) -> None:
    """One K27 launch for at most CONTROL_MAX_PDUS PDUs."""
    p, s, k = grid.shape[-3:]
    args = _build.ControlArgs()
    args.qpsk = QPSK
    keep = []                         # tensors whose pointers the launch holds
    u = 0
    groups = _groups(items)
    for gi, group in enumerate(groups):
        args.group_start[gi] = u
        for i in group:
            it = items[i]
            d = args.pdu[u]
            bits = [_int8_bits(b) for b in it.bits]
            keep += bits
            n0 = bits[0].shape[-1]
            n1 = bits[1].shape[-1] if len(bits) > 1 else 0
            words = -(-(n0 + n1) // 32)
            if (words > MAX_WORDS or it.rows.shape[-1] != words
                    or it.h + it.l0 > s or it.sc0 + it.w > k):
                raise ValueError(f"control PDU: {n0} + {n1} payload bits, map "
                                 f"{tuple(it.rows.shape)}, patch at "
                                 f"({it.l0}, {it.sc0}) {it.h} x {it.w}")
            d.bits0 = bits[0].data_ptr()
            d.stride0 = _slot_stride(bits[0], lead)
            if n1:
                d.bits1, d.bits2 = bits[1].data_ptr(), bits[2].data_ptr()
                d.stride1 = _slot_stride(bits[1], lead)
                d.stride2 = _slot_stride(bits[2], lead)
            if it.pilots is not None:
                pil = it.pilots.to(torch.complex64).contiguous()
                keep.append(pil)
                d.pilots = pil.data_ptr()
                d.pilot_stride = _slot_stride(pil, lead)
            d.rows, d.offset = it.rows.data_ptr(), it.offset.data_ptr()
            d.index = it.index.data_ptr()
            d.base = it.base.data_ptr() if it.base is not None else None
            d.n0, d.n1, d.words, d.nd = n0, n1, words, it.nd
            d.l0, d.sc0, d.h, d.w = it.l0, it.sc0, it.h, it.w
            d.all_ports = int(it.all_ports)
            d.amplitude = float(it.amplitude)
            u += 1
    args.group_start[len(groups)] = u
    lib = _build.load()
    _build.check(lib.srsran_control_map(
        args, len(groups), _build.ptr(torch.view_as_real(grid)), p, s, k,
        p * s * k, lead[0] if lead else 1, _build.stream_of(grid)),
        "control_map")
    del keep
    KERNEL.count()
