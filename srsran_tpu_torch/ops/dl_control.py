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

K27 launches through a plan kept per call signature (what the plan reads
of the PDUs: their tables by identity, which the plan holds, their places
and amplitudes, the payloads' and pilots' shapes and slot strides, the
grid's shape and the device): :func:`_control_params` lists, on the host, every grid
RE the launch's PDUs add to, once, with its sources in plan order, in
tiles of :data:`THREADS` REs (a CTA each); the plan uploads those tables
once, and a call passes the grid, an array of the payloads' and pilots'
pointers, and the stream (``kernels/_build.py::Launch``).

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

import collections
import ctypes
import dataclasses
import functools
import threading
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
THREADS = 128                 # csrc/dl_control_map.cu kThreads: REs a tile
KIND_DATA, KIND_PILOT, KIND_CONST = 1, 2, 3     # an RE's source
PLANS_MAX = 256               # K27 plans kept (least recently used go)


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


def unpack_rows(rows: np.ndarray, a: int) -> np.ndarray:
    """:func:`pack_rows`' inverse: M [A, E] (uint8 0/1)."""
    e = rows.shape[0]
    bits = np.unpackbits(np.ascontiguousarray(rows, "<i4").view(np.uint8)
                         .reshape(e, -1), axis=1, bitorder="little")
    return np.ascontiguousarray(bits[:, :a].T)


@dataclasses.dataclass(frozen=True)
class HostPdu:
    """A PDU of K27 as the host plan reads it: the item's tables as numpy
    arrays, its geometry, and the call's payload and pilot shapes (n0
    payload bits, n1 context bits, the slot strides; npilots 0 without
    pilots)."""

    rows: np.ndarray
    offset: np.ndarray
    index: np.ndarray
    base: np.ndarray | None
    l0: int
    sc0: int
    h: int
    w: int
    all_ports: bool
    nd: int
    amplitude: float
    n0: int
    n1: int
    strides: tuple            # bits0, bits1, bits2, pilots (0: shared)
    npilots: int


def row_words(nbits: int) -> int:
    """Words of a packed row in K27's table: payload bits + the constant
    bit, rounded up to 1, 2, 4 or 8 words (16-byte loads)."""
    need = -(-(nbits + 1) // 32)
    for w in (1, 2, 4, MAX_WORDS):
        if need <= w:
            return w
    raise ValueError(f"control PDU: {nbits} payload bits, more than "
                     f"{32 * MAX_WORDS - 1}")


def row_table(rows: np.ndarray, offset: np.ndarray, nbits: int) -> tuple:
    """K27's row table of one PDU: uint32 [E / 2, stride], data RE k's I
    row (coded bit 2k) and Q row (2k + 1) interleaved word by word, the
    map's constant bit at row bit ``nbits`` (against a payload bit fixed
    at 1), each RE's pair padded to ``stride`` = max(2 W, 4) words; and W
    (:func:`row_words`)."""
    words = row_words(nbits)
    e = rows.shape[0]
    m = np.concatenate([unpack_rows(rows, nbits),
                        (np.asarray(offset) & 1).astype(np.uint8)[None]])
    packed = np.zeros((e, words), np.int32)
    packed[:, :-(-(nbits + 1) // 32)] = pack_rows(m)
    stride = max(2 * words, 4)
    table = np.zeros((e // 2, stride), np.uint32)
    table[:, 0:2 * words:2] = packed[0::2].view(np.uint32)
    table[:, 1:2 * words:2] = packed[1::2].view(np.uint32)
    return table, words


def _sources(d: HostPdu, K: int, first_row: int, first_const: int) -> tuple:
    """One PDU's RE sources over its patch rectangle: (pos, kind, arg,
    const values, row table, W); kind 0 a hole (a zero added), pos the
    plane offset l * K + k, arg a data RE's first row word, a pilot's index
    or a base value's index."""
    n = d.h * d.w
    r = np.arange(n)
    pos = (d.l0 + r // d.w) * K + d.sc0 + r % d.w
    idx = np.asarray(d.index, np.int64)
    kind = np.zeros(n, np.int64)
    arg = np.zeros(n, np.int64)
    data = (idx >= 1) & (idx <= d.nd)
    pil = idx > d.nd
    if pil.any() and int(idx.max()) - 1 - d.nd >= d.npilots:
        raise ValueError(f"control PDU: pilot {int(idx.max()) - 1 - d.nd} of "
                         f"{d.npilots}")
    table, words = row_table(d.rows, d.offset, d.n0 + d.n1)
    kind[data], kind[pil] = KIND_DATA, KIND_PILOT
    arg[data] = first_row + (idx[data] - 1) * table.shape[1]
    arg[pil] = idx[pil] - 1 - d.nd
    values = np.zeros(0, np.complex64)
    if d.base is not None:
        base = np.asarray(d.base, np.complex64).reshape(-1)
        nonzero = (idx == 0) & (base.view(np.uint64) != 0)   # +0+0j: a hole
        kind[nonzero] = KIND_CONST
        arg[nonzero] = first_const + np.arange(int(nonzero.sum()))
        values = base[nonzero]
    return pos, kind, arg, values, table, words


def _control_params(pdus, shape: tuple) -> tuple:
    """K27's host plan of one launch: (params, items int32 [N + X, 4],
    rows uint32, consts complex64, tiles int32 [ceil(N / THREADS)]).

    ``pdus`` the launch's :class:`HostPdu` in plan order (at most
    CONTROL_MAX_PDUS), ``shape`` the grid's [(B,) P, S, K].  Every grid RE
    of the [S, K] plane that a PDU's patch rectangle covers is one of the
    N items, in the order of the first PDU that adds a value there (holes
    last): x its offset, y its first value source (kind | PDU << 2 | every
    port << 6 | W << 8), z the zeros added (bit 0 on port 0, bit 1 on
    every port), bit 2 spanning every port, the count of further sources
    << 3 and the first of them << 8 (X entries after the N, in plan
    order), w the source's argument.  A tile's entry is the mask of the
    PDUs whose payload it reads.  Raises on what the kernel does not
    take."""
    *lead, P, S, K = shape
    n = len(pdus)
    if not 1 <= n <= _build.CONTROL_MAX_PDUS:
        raise ValueError(f"{n} control PDUs in a launch, not 1 to "
                         f"{_build.CONTROL_MAX_PDUS}")
    params = _build.ControlParams()
    a = params.args
    a.npdus, a.nslots, a.P, a.S, a.K = n, lead[0] if lead else 1, P, S, K
    a.qpsk, a.grid_stride = QPSK, P * S * K
    cols = {k: [] for k in ("pos", "u", "kind", "arg", "all")}
    tables, consts = [], []
    nrow = nconst = nptr = 0
    words = []
    for u, d in enumerate(pdus):
        e = d.rows.shape[0]
        if (d.rows.shape[-1] != -(-(d.n0 + d.n1) // 32) or e != 2 * d.nd
                or d.index.size != d.h * d.w or d.l0 < 0 or d.sc0 < 0
                or d.l0 + d.h > S or d.sc0 + d.w > K):
            raise ValueError(f"control PDU: {d.n0} + {d.n1} payload bits, "
                             f"map {tuple(d.rows.shape)}, {d.nd} data REs, "
                             f"patch at ({d.l0}, {d.sc0}) {d.h} x {d.w} in "
                             f"a {S} x {K} grid")
        pos, kind, arg, values, table, wds = _sources(d, K, nrow, nconst)
        tables.append(table.reshape(-1))
        consts.append(values)
        nrow += table.size
        nconst += values.size
        words.append(wds)
        pd = a.pdu[u]
        pd.n0, pd.n1, pd.words, pd.amplitude = d.n0, d.n1, wds, d.amplitude
        pd.stride0, pd.stride1, pd.stride2, pd.pilot_stride = d.strides
        has = (True, d.n1 > 0, d.n1 > 0, d.npilots > 0)
        for j, h in enumerate(has):
            params.ptr[u][j] = nptr if h else -1
            nptr += h
        cols["pos"].append(pos)
        cols["u"].append(np.full(pos.size, u))
        cols["kind"].append(kind)
        cols["arg"].append(arg)
        cols["all"].append(np.full(pos.size, bool(d.all_ports)))
    pos, u, kind, arg, allp = (np.concatenate(cols[k]) for k in
                               ("pos", "u", "kind", "arg", "all"))
    order = np.lexsort((u, pos))            # by RE, then plan order
    pos, u, kind, arg, allp = (x[order] for x in (pos, u, kind, arg, allp))
    starts = np.flatnonzero(np.r_[True, pos[1:] != pos[:-1]])
    value = kind != 0
    count = np.add.reduceat(value.astype(np.int64), starts)
    at = np.where(value, np.arange(pos.size), pos.size)
    first = np.minimum.reduceat(at, starts)
    hole = ~value
    hole0 = np.logical_or.reduceat(hole & ~allp, starts)
    hole_all = np.logical_or.reduceat(hole & allp, starts)
    spans = np.logical_or.reduceat(allp, starts)
    wds = np.asarray(words, np.int64)

    def code(i):
        return kind[i] | u[i] << 2 | allp[i].astype(np.int64) << 6 | \
            wds[u[i]] << 8

    some = count > 0
    fi = np.where(some, first, 0)
    lead_u = np.where(some, u[fi], n)
    item_order = np.lexsort((pos[starts], lead_u))
    nitems = starts.size
    items = np.zeros((nitems, 4), np.int64)
    items[:, 0] = pos[starts]
    items[:, 1] = np.where(some, code(fi), 0)
    items[:, 3] = np.where(some, arg[fi], 0)
    flags = (hole0.astype(np.int64) | hole_all.astype(np.int64) << 1
             | spans.astype(np.int64) << 2)
    data_mask = np.where(kind == KIND_DATA, 1 << u, 0)
    masks = np.bitwise_or.reduceat(data_mask, starts)
    extras = []
    for g in np.flatnonzero(count > 1):
        lo = starts[g]
        hi = starts[g + 1] if g + 1 < nitems else pos.size
        more = [i for i in range(lo, hi) if value[i] and i != first[g]]
        flags[g] |= len(more) << 3 | len(extras) << 8
        extras += [(0, int(code(i)), 0, int(arg[i])) for i in more]
    items[:, 2] = flags
    items = items[item_order]
    masks = masks[item_order]
    ntiles = -(-nitems // THREADS)
    tiles = np.bitwise_or.reduceat(masks, np.arange(0, nitems, THREADS))
    a.nitems, a.ntiles = nitems, ntiles
    table = np.concatenate(tables + [np.zeros(4, np.uint32)])
    return (params,
            np.concatenate([items, np.asarray(extras, np.int64)
                            .reshape(-1, 4)]).astype(np.int32),
            table, np.concatenate(consts + [np.zeros(1, np.complex64)]),
            tiles.astype(np.int32))


def _int8_bits(t: torch.Tensor) -> torch.Tensor:
    t = t if t.dtype == torch.int8 else t.to(torch.int8)
    return t if t.stride(-1) == 1 else t.contiguous()


def _slot_stride(t: torch.Tensor, lead: tuple) -> int:
    if t.ndim == 1:
        return 0
    if tuple(t.shape[:-1]) != lead:
        raise ValueError(f"control input {tuple(t.shape)} vs slot axis {lead}")
    return t.stride(0)


def host_pdu(it: ControlItem, bits: tuple, pilots, lead: tuple) -> HostPdu:
    """The :class:`HostPdu` of one item and the call's (converted) bits
    and pilots; reads the item's tables to the host."""
    def host(t):
        return None if t is None else t.detach().cpu().numpy()

    n0 = bits[0].shape[-1]
    n1 = bits[1].shape[-1] if len(bits) > 1 else 0
    if len(bits) not in (1, 3) or (n1 and bits[2].shape[-1] != n1):
        raise ValueError(f"control PDU: payload parts "
                         f"{[tuple(b.shape) for b in bits]}")
    strides = (_slot_stride(bits[0], lead),
               _slot_stride(bits[1], lead) if n1 else 0,
               _slot_stride(bits[2], lead) if n1 else 0,
               _slot_stride(pilots, lead) if pilots is not None else 0)
    return HostPdu(rows=host(it.rows), offset=host(it.offset),
                   index=host(it.index), base=host(it.base), l0=it.l0,
                   sc0=it.sc0, h=it.h, w=it.w, all_ports=bool(it.all_ports),
                   nd=it.nd, amplitude=float(it.amplitude), n0=n0, n1=n1,
                   strides=strides,
                   npilots=0 if pilots is None else pilots.shape[-1])


class _ControlLaunch:
    """One K27 launch of a plan: its :class:`_build.Launch` over the
    uploaded tables, the slice of the call's pointers it takes, and the
    item tables its signature names by identity (held, so that no other
    tensor takes their ids while the plan is kept)."""

    __slots__ = ("launch", "lo", "hi", "array", "held")

    def __init__(self, params, tables: tuple, index: int, lo: int, hi: int,
                 held: tuple):
        self.launch = _build.Launch("srsran_control_map", index, params,
                                    tables)
        self.lo, self.hi = lo, hi
        self.array = ctypes.c_uint64 * (hi - lo)
        self.held = held

    def __call__(self, grid_ptr: int, ptrs: list) -> None:
        arr = self.array(*ptrs[self.lo:self.hi])
        self.launch(grid_ptr, ctypes.addressof(arr))


_PLANS: collections.OrderedDict = collections.OrderedDict()
_LOCK = threading.Lock()          # _PLANS (serve_phy's thread)


def _call_inputs(grid: torch.Tensor, items: tuple) -> tuple:
    """(signature, pointers, inputs) of a K27 call.

    ``inputs`` is each item's (bits, pilots) as the kernel reads them --
    int8 and complex64, last stride 1 -- copied only where the item's are
    not; the caller holds it until the launches are queued (a copy freed
    sooner would hand its memory to the next one's).  The signature names
    what the plan reads: the grid's shape and device, each item's tables
    by identity, place, size, ports, data REs and amplitude, and its
    inputs' shapes and strides.  The pointers are the inputs', in the
    plan's order."""
    index = grid.get_device()
    sig, ptrs, inputs = [grid.shape, index], [], []
    for it in items:
        p = it.pilots
        sig.append((id(it.rows), id(it.offset), id(it.index), id(it.base),
                    it.l0, it.sc0, it.h, it.w, it.all_ports, it.nd,
                    it.amplitude, len(it.bits), p is None))
        bits = []
        for t in it.bits:
            if t.dtype is not torch.int8 or t.stride()[-1] != 1:
                t = _int8_bits(t)
            bits.append(t)
        if p is not None:
            if p.dtype is not torch.complex64 or p.stride()[-1] != 1:
                p = p.to(torch.complex64).contiguous()
            bits.append(p)
        for t in bits:
            if t.get_device() != index:
                raise ValueError("control PDU inputs on another device "
                                 "than the grid")
            sig.append(t.shape)
            sig.append(t.stride())
            ptrs.append(t.data_ptr())
        inputs.append((tuple(bits[:-1]) if p is not None else tuple(bits),
                       p))
    return tuple(sig), ptrs, inputs


def _control_plan(sig: tuple, grid: torch.Tensor, items: tuple,
                  inputs: list) -> tuple:
    """The plan of a call signature: a :class:`_ControlLaunch` for every
    CONTROL_MAX_PDUS PDUs, kept in a bounded LRU (its tables with it)."""
    with _LOCK:
        plan = _PLANS.get(sig)
        if plan is not None:
            _PLANS.move_to_end(sig)
            return plan
    lead = tuple(grid.shape[:-3])
    n = _build.CONTROL_MAX_PDUS
    dev, index = grid.device, grid.get_device()
    launches, ptr = [], 0
    for c in range(0, len(items), n):
        chunk, given = items[c:c + n], inputs[c:c + n]
        pdus = [host_pdu(it, b, p, lead) for it, (b, p) in zip(chunk, given)]
        params, *tables = _control_params(pdus, tuple(grid.shape))
        count = sum(len(b) + (p is not None) for b, p in given)
        launches.append(_ControlLaunch(
            params, tuple(torch.from_numpy(np.ascontiguousarray(t).view(
                np.int32) if t.dtype != np.complex64 else t).to(dev)
                for t in tables), index, ptr, ptr + count,
            tuple((it.rows, it.offset, it.index, it.base) for it in chunk)))
        ptr += count
    plan = tuple(launches)
    with _LOCK:
        _PLANS[sig] = plan
        if len(_PLANS) > PLANS_MAX:
            _PLANS.popitem(last=False)
    return plan


def control_map(grid: torch.Tensor, items) -> torch.Tensor:
    """Add a DL slot's PDCCHs and SSBs into the grid (in place).

    grid complex64 [P, S, K] or [B, P, S, K]; items the slot's
    :class:`ControlItem` in plan order.  On CUDA one launch for every
    CONTROL_MAX_PDUS PDUs (a slot of up to 16 PDCCHs and SSBs takes one),
    through the plan of the call's signature; the launches follow one
    another on the current stream in plan order, so PDUs that share REs
    across two launches still add in plan order.
    """
    items = tuple(items)
    if not items:
        return grid
    if not grid.is_cuda:
        is_cuda(grid, *[t for it in items for t in
                        (*it.bits, it.rows, it.offset, it.index, it.pilots,
                         it.base) if t is not None])      # raises on a mix
        for it in items:
            it.ref(grid)
        return grid
    if (grid.dtype is not torch.complex64 or not grid.is_contiguous()
            or grid.ndim not in (3, 4)):
        raise ValueError("the grid must be contiguous complex64 [(B,) P, S, K]")
    sig, ptrs, inputs = _call_inputs(grid, items)     # inputs held
    plan = _control_plan(sig, grid, items, inputs)
    g = grid.data_ptr()
    for launch in plan:
        launch(g, ptrs)
        KERNEL.count()
    return grid


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
