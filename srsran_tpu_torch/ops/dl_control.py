"""DL control map (K27, csrc/dl_control_map.cu) and its UE-side receive
demap (K28, csrc/dl_control_rx.cu).

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

K28, :func:`control_llrs`: the receive side of the same PDUs.  The JAX
package's UE-side receivers (srsran_tpu/phy/upper/pdcch.py::recover
:311-317, ssb.py::pbch_decode :356-361) gather a codeword's data REs from
a grid, demap them to max-log QPSK LLRs at a given noise variance
(ops/modulation.py::demodulate) and descramble them with a Gold sequence
(ops/scrambling.py::descramble_llrs).  The port describes each codeword as
an :class:`RxItem` -- its RE offsets in the grid, noise variance, Gold
c_init and advance -- and one launch computes the LLRs of every codeword
of a slot (every DCI and the PBCH), in item order, into one flat buffer;
:func:`control_llrs_ref` is its twin, the JAX chain op for op.  The polar
decode that follows is K15 (ops/polar.py::decode).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build
from .gold import gold_sequence_np
from .modulation import demodulate
from .scrambling import descramble_llrs

KERNEL = kernels.register(kernels.Kernel(
    name="control_map", route="cuda",
    source="srsran_tpu_torch/csrc/dl_control_map.cu",
    replaces="srsran_tpu/phy/upper/pdcch.py:283"))

KERNEL_RX = kernels.register(kernels.Kernel(
    name="control_llrs", route="cuda",
    source="srsran_tpu_torch/csrc/dl_control_rx.cu",
    replaces="srsran_tpu/phy/upper/pdcch.py:310"))

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


# ------------------------------------------------------------------ K28

@dataclasses.dataclass(frozen=True)
class RxItem:
    """One codeword of K28: ``re_fn(*re_args)`` its data REs as int64 flat
    offsets into the grid, in the codeword's symbol order (E / 2 of them);
    the noise variance of its max-log LLRs; its Gold scrambling seed and
    advance (a PDCCH: (n_rnti << 16) + n_id_data, 0; the PBCH: the cell
    id, v * 864)."""

    re_fn: Callable
    re_args: tuple
    noise_var: float
    c_init: int
    advance: int = 0


@functools.lru_cache(maxsize=256)
def rx_plan(items: tuple, grid_size: int) -> dict:
    """The host plan of one K28 launch: ``re`` int32 [R] every codeword's
    RE offsets in item order, ``re_off`` int32 [B + 1] each codeword's
    first RE, ``nv`` float32 [B], ``gold`` int32 words of every LLR's Gold
    bit packed LSB first, ``e`` the codewords' LLR counts."""
    res = [np.asarray(it.re_fn(*it.re_args), np.int64) for it in items]
    for r in res:
        if r.size and (r.min() < 0 or r.max() >= grid_size):
            raise ValueError(f"K28 REs outside a grid of {grid_size}")
    re_off = np.concatenate([[0], np.cumsum([r.size for r in res])])
    bits = np.concatenate([gold_sequence_np(it.c_init, 2 * r.size,
                                            it.advance)
                           for it, r in zip(items, res)] + [
        np.zeros(0, np.uint8)])
    packed = np.packbits(bits, bitorder="little")
    packed = np.concatenate([packed, np.zeros(-len(packed) % 4, np.uint8)])
    return dict(re=np.concatenate(res + [np.zeros(0, np.int64)]).astype(
                    np.int32),
                re_off=re_off.astype(np.int32),
                nv=np.array([it.noise_var for it in items], np.float32),
                gold=packed.view("<u4").view(np.int32),
                e=tuple(2 * r.size for r in res))


def _rx_array(items: tuple, grid_size: int, name: str) -> np.ndarray:
    return rx_plan(items, grid_size)[name]


def control_llrs_ref(grid: torch.Tensor, items: tuple) -> torch.Tensor:
    """Plain twin of :func:`control_llrs`: per codeword, the JAX chain --
    the RE gather, ``demodulate(..., "qpsk")`` at the codeword's noise
    variance and ``descramble_llrs`` -- op for op."""
    flat = grid.reshape(-1)
    outs = []
    for it in items:
        re = torch.as_tensor(np.asarray(it.re_fn(*it.re_args), np.int64),
                             device=grid.device)
        syms = flat[re]
        nv = torch.full(syms.shape, it.noise_var, dtype=torch.float32,
                        device=grid.device)
        llr = demodulate(syms[None], nv[None], "qpsk")
        outs.append(descramble_llrs(llr, it.c_init, it.advance)[0])
    if not outs:
        return torch.zeros(0, dtype=torch.float32, device=grid.device)
    return torch.cat(outs)


def control_llrs(grid: torch.Tensor, items: tuple) -> torch.Tensor:
    """LLRs float32 [sum E] of every codeword in ``items`` (:class:`RxItem`,
    in order), read from ``grid`` (complex64, any shape, contiguous: the
    items' offsets index it flat).  Split them with ``rx_plan(items,
    grid.numel())["e"]``.  One launch for all the codewords."""
    items = tuple(items)
    if not is_cuda(grid):
        return control_llrs_ref(grid, items)
    if grid.dtype != torch.complex64 or not grid.is_contiguous():
        raise ValueError("the grid must be contiguous complex64")
    n = grid.numel()
    plan = rx_plan(items, n)
    nre = int(plan["re"].size)
    out = torch.empty(2 * nre, dtype=torch.float32, device=grid.device)
    if nre == 0:
        return out
    re, re_off, nv, gold = (const(_rx_array, items, n, name,
                                  device=grid.device)
                            for name in ("re", "re_off", "nv", "gold"))
    lib = _build.load()
    _build.check(lib.srsran_control_llrs(
        _build.ptr(torch.view_as_real(grid)), _build.ptr(re),
        _build.ptr(re_off), len(items), _build.ptr(nv), _build.ptr(gold),
        nre, ctypes.c_float(QPSK), _build.ptr(out), _build.stream_of(grid)),
        "control_llrs")
    KERNEL_RX.count()
    return out
