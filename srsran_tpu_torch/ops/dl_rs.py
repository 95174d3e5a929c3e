"""DL reference-signal maps: K25 (NZP-CSI-RS, PT-RS, PRS) and K26 (the DL
DM-RS), both in csrc/dl_rs_map.cu.

K25, :func:`rs_map`.  The JAX package adds each RS PDU with its own
scatter-adds (srsran_tpu/phy/upper/csi_rs.py::process :219,
ptrs_prs.py::map_ptrs :94 and map_prs :170).  The port describes every RS
PDU of a slot as *blocks* -- (port, symbol, subcarriers, value indices,
weight) in the JAX package's emit order -- and builds from them, once per
plan key, one list grouped by target RE (:func:`rs_plan`): each target's
flat grid offset and its terms (value source, value index, complex
weight); :func:`rs_records` turns it into the kernel's 16-byte records,
the targets sorted by term count and the records term-major.  One launch
adds every PDU's values (one for every 32 PDUs), through a plan per call
signature on ``kernels/_build.py::Launch`` (:func:`_rs_plan`, its struct
:func:`_rs_params`); the plain twin :func:`rs_map_ref` adds the same terms
rank by rank with products and sums rounded one by one, as the kernel
rounds them.

K26, :func:`dmrs_map`.  srsran_tpu/phy/upper/dmrs.py::map_to_grid (:198)
adds the DM-RS of each layer (configuration type 1 or 2, on a contiguous
or scattered PRB set), precoded by the port's matrix or by the RE's PRG
matrix; the kernel does it for every layer, symbol and port in one launch
(a thread a subcarrier pair over every port), through a plan per call
signature on ``kernels/_build.py::Launch`` (:func:`_dmrs_plan`, its
struct :func:`_dmrs_params`), and :func:`dmrs_map_ref` is its twin.

On CPU tensors both run their twins; on CUDA tensors they launch their
kernel or raise.  Both take a leading slot axis on the grid (the
slot-batch mode), with each value source, pilot set and matrix either
shared or stacked per slot.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build

KERNEL_RS = kernels.register(kernels.Kernel(
    name="rs_map", route="cuda", source="srsran_tpu_torch/csrc/dl_rs_map.cu",
    replaces="srsran_tpu/phy/upper/csi_rs.py:219"))
KERNEL_DMRS = kernels.register(kernels.Kernel(
    name="dmrs_map", route="cuda",
    source="srsran_tpu_torch/csrc/dl_rs_map.cu",
    replaces="srsran_tpu/phy/upper/dmrs.py:198"))

_MAX_LAYERS = 4


# ------------------------------------------------------------------ K25

@functools.lru_cache(maxsize=256)
def rs_plan(items: tuple, shape: tuple) -> dict:
    """The target-grouped plan of a slot's RS PDUs on a [P, S, K] grid.

    items: ((blocks_fn, args), ...), one per value source, in the order
    the JAX slot program adds them; ``blocks_fn(*args)`` returns
    (value_shape, blocks), each block (port, symbol, subcarriers, value
    indices, weight) in emit order.  Returns numpy arrays: ``tgt`` int64
    [T] flat offsets, ``start`` int32 [T + 1], per term ``src`` and ``idx``
    int32 [N] and ``w`` complex64 [N]; ``shapes`` the value shapes; and
    ``ranks``, for the twin, (targets, terms) of every term rank.
    """
    p_n, s_n, k_n = shape
    terms: dict = {}
    shapes = []
    for s, (fn, args) in enumerate(items):
        value_shape, blocks = fn(*args)
        shapes.append(tuple(value_shape))
        for port, symbol, scs, idxs, weight in blocks:
            if not (0 <= port < p_n and 0 <= symbol < s_n):
                raise ValueError(f"RS target port {port} symbol {symbol} "
                                 f"outside a {shape} grid")
            scs = np.asarray(scs, np.int64)
            if scs.size and (scs.min() < 0 or scs.max() >= k_n):
                raise ValueError(f"RS subcarriers outside {k_n}")
            base = (port * s_n + symbol) * k_n
            for k, i in zip(scs.tolist(), np.asarray(idxs).tolist()):
                terms.setdefault(base + k, []).append((s, i, weight))
    tgt = np.fromiter(terms, np.int64, len(terms))
    counts = np.array([len(v) for v in terms.values()], np.int64)
    start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    flat = [t for v in terms.values() for t in v]
    src = np.array([t[0] for t in flat], np.int32)
    idx = np.array([t[1] for t in flat], np.int32)
    w = np.array([t[2] for t in flat], np.complex64)
    ranks = []
    for r in range(int(counts.max()) if counts.size else 0):
        sel = np.nonzero(counts > r)[0]
        ranks.append((sel, start[sel].astype(np.int64) + r))
    return dict(tgt=tgt, start=start, src=src, idx=idx, w=w,
                shapes=tuple(shapes), ranks=tuple(ranks))


def _source_strides(value_shapes: tuple, shapes: tuple,
                    lead: tuple) -> tuple:
    """Each value source's per-slot stride in complex values (0: shared
    by every slot), from the values' shapes and the plan's."""
    if len(value_shapes) != len(shapes):
        raise ValueError(f"{len(value_shapes)} value sources for "
                         f"{len(shapes)} RS PDUs")
    out = []
    for got, shape in zip(value_shapes, shapes):
        if tuple(got) == shape:
            out.append(0)
        elif lead and tuple(got) == lead + shape:
            out.append(int(np.prod(shape)))
        else:
            raise ValueError(f"RS values {tuple(got)} vs {shape} (slot "
                             f"axis {lead})")
    return tuple(out)


def _sources(values, shapes: tuple, lead: tuple) -> list:
    """Each value source as (tensor, per-slot stride in complex values)."""
    for v in values:
        if v.dtype != torch.complex64:
            raise ValueError(f"RS values must be complex64, got {v.dtype}")
    strides = _source_strides(tuple(v.shape for v in values), shapes, lead)
    return [(v.contiguous(), st) for v, st in zip(values, strides)]


def rs_map_ref(grid: torch.Tensor, items: tuple, values) -> torch.Tensor:
    """Plain twin of :func:`rs_map`: every target's terms added rank by
    rank, each product and sum rounded on its own (the kernel's order)."""
    lead = tuple(grid.shape[:-3])
    plan = rs_plan(items, tuple(grid.shape[-3:]))
    srcs = _sources(values, plan["shapes"], lead)
    if not plan["ranks"]:
        return grid
    nb = int(np.prod(lead)) if lead else 1
    dev = grid.device
    flat = grid.view(nb, -1)
    vals = torch.cat([(v.reshape(nb, -1) if stride else
                       v.reshape(1, -1).expand(nb, -1)) for v, stride in srcs],
                     dim=1)
    base = np.concatenate([[0], np.cumsum([int(np.prod(s))
                                           for s in plan["shapes"]])])
    gidx = torch.as_tensor(base[plan["src"]] + plan["idx"]).to(dev)
    w = torch.as_tensor(plan["w"]).to(dev)
    tgt = torch.as_tensor(plan["tgt"]).to(dev)
    acc = flat[:, tgt]
    ar, ai = acc.real.contiguous(), acc.imag.contiguous()
    for sel, js in plan["ranks"]:
        sel_t = torch.as_tensor(sel).to(dev)
        js_t = torch.as_tensor(js).to(dev)
        v = vals[:, gidx[js_t]]
        wr, wi = w[js_t].real, w[js_t].imag
        vr, vi = v.real, v.imag
        ar[:, sel_t] = ar[:, sel_t] + (vr * wr - vi * wi)
        ai[:, sel_t] = ai[:, sel_t] + (vr * wi + vi * wr)
    flat[:, tgt] = torch.complex(ar, ai)
    return grid


@functools.lru_cache(maxsize=256)
def rs_records(items: tuple, shape: tuple) -> dict:
    """K25's records of :func:`rs_plan`'s plan (csrc/dl_rs_map.cu).

    The targets sorted by descending term count (stable: ``order``, into
    the plan's targets), so that term rank r covers the first ``rank_n[r]``
    of them; one 16-byte record a term, term-major (rank 0's, then rank
    1's, ...): int32 [N, 4] {the target's flat offset in a [P, S, K] grid,
    source << RS_INDEX_BITS | value index, the weight's real and imaginary
    float32 bits}.  Raises a ValueError past RS_MAX_RANKS terms a target,
    2^RS_INDEX_BITS values a source or 2^31 elements a grid.
    """
    plan = rs_plan(items, shape)
    if math.prod(shape) >= 1 << 31:
        raise ValueError(f"K25 takes at most 2^31 elements a grid (32-bit "
                         f"offsets), got {shape}")
    counts = np.diff(plan["start"])
    order = np.argsort(-counts, kind="stable")
    nranks = int(counts.max()) if counts.size else 0
    if nranks > _build.RS_MAX_RANKS:
        raise ValueError(f"an RS target with {nranks} terms (K25 takes "
                         f"{_build.RS_MAX_RANKS}, RS_MAX_RANKS)")
    if plan["idx"].size and int(plan["idx"].max()) >> _build.RS_INDEX_BITS:
        raise ValueError(f"an RS value index of {int(plan['idx'].max())} "
                         f"(K25 takes < 2^{_build.RS_INDEX_BITS}, "
                         f"RS_INDEX_BITS)")
    rank_n = tuple(int((counts > r).sum()) for r in range(nranks))
    w = plan["w"].view(np.float32).reshape(-1, 2).view(np.int32)
    records = []
    for r, n in enumerate(rank_n):
        sel = order[:n]
        j = plan["start"][sel] + r
        rec = np.empty((n, 4), np.int32)
        rec[:, 0] = plan["tgt"][sel]
        rec[:, 1] = ((plan["src"][j].astype(np.uint32) << _build.RS_INDEX_BITS)
                     | plan["idx"][j].astype(np.uint32)).view(np.int32)
        rec[:, 2:] = w[j]
        records.append(rec)
    return dict(records=(np.concatenate(records) if records
                         else np.zeros((0, 4), np.int32)),
                rank_n=rank_n, order=order)


def _rs_params(records: dict, strides: tuple, grid_shape: tuple
               ) -> _build.RsMapParams:
    """K25's launch parameters for one call signature: the records of
    :func:`rs_records`, the sources' per-slot strides and the grid's shape
    [(B,) P, S, K]."""
    rank_n = records["rank_n"]
    base = np.concatenate([[0], np.cumsum(rank_n)])[:-1]
    lead = tuple(grid_shape[:-3])
    if math.prod(grid_shape) >= 1 << 31:
        raise ValueError(f"K25 takes at most 2^31 elements a grid (32-bit "
                         f"offsets), got {tuple(grid_shape)}")
    pad = _build.RS_MAX_RANKS - len(rank_n)
    return _build.RsMapParams(
        ntgt=rank_n[0], nslots=lead[0] if lead else 1,
        grid_stride=math.prod(grid_shape[-3:]), nranks=len(rank_n),
        nsrc=len(strides),
        rank_n=(ctypes.c_int * _build.RS_MAX_RANKS)(*rank_n, *[0] * pad),
        rank_base=(ctypes.c_int * _build.RS_MAX_RANKS)(
            *[int(b) for b in base], *[0] * pad),
        stride=(ctypes.c_int * _build.RS_MAX_SOURCES)(
            *strides, *[0] * (_build.RS_MAX_SOURCES - len(strides))))


class _RsLaunch:
    """One K25 launch of a plan: its :class:`_build.Launch` over the
    uploaded records, and the slice of the call's value pointers it
    takes."""

    __slots__ = ("launch", "lo", "hi", "array")

    def __init__(self, launch: _build.Launch, lo: int, hi: int):
        self.launch, self.lo, self.hi = launch, lo, hi
        self.array = ctypes.c_uint64 * (hi - lo)

    def __call__(self, grid_ptr: int, ptrs: list) -> None:
        arr = self.array(*ptrs[self.lo:self.hi])
        self.launch(grid_ptr, ctypes.addressof(arr))


@functools.lru_cache(maxsize=256)
def _rs_plan(items: tuple, grid_shape: tuple, values: tuple,
             index: int) -> tuple:
    """K25's launches for one call signature: the RS PDUs' items, the
    grid's shape, each value source's (shape, dtype, CUDA device) and the
    grid's CUDA device ``index``.  One :class:`_RsLaunch` for every
    RS_MAX_SOURCES PDUs that reach a target, each holding its records."""
    lead = tuple(grid_shape[:-3])
    shape = tuple(grid_shape[-3:])
    if any(dt != torch.complex64 for _, dt, _ in values):
        raise ValueError(f"RS values must be complex64, got "
                         f"{[dt for _, dt, _ in values]}")
    devices = {d for _, _, d in values} | {index}
    if len(devices) != 1:
        raise ValueError(f"the grid and the RS values on CUDA devices "
                         f"{sorted(devices)}")
    n = _build.RS_MAX_SOURCES
    launches = []
    for c in range(0, len(items), n):
        chunk = items[c:c + n]
        plan = rs_plan(chunk, shape)
        strides = _source_strides(tuple(v[0] for v in values[c:c + n]),
                                  plan["shapes"], lead)
        if not plan["tgt"].size:
            continue
        rec = rs_records(chunk, shape)
        table = torch.from_numpy(rec["records"]).to(
            torch.device("cuda", index))
        launches.append(_RsLaunch(_build.Launch(
            "srsran_rs_map", index, _rs_params(rec, strides, grid_shape),
            (table,)), c, c + len(chunk)))
    return tuple(launches)


def rs_map(grid: torch.Tensor, items: tuple, values) -> torch.Tensor:
    """Add a slot's RS PDUs to the grid (in place); returns the grid.

    grid complex64 [P, S, K], or [B, P, S, K] for B slots; items the RS
    PDUs' block functions and arguments (:func:`rs_plan`); values one
    complex64 tensor per item, of the item's value shape or with the
    slot axis in front.  One launch for every RS_MAX_SOURCES PDUs (the
    launch's table of value sources; a slot of up to 32 RS PDUs takes
    one): a target's terms follow the PDUs' order, so launches in that
    order add them as one launch would.  On the card: through the cached
    plan of the call's signature (:func:`_rs_plan`); a call allocates
    nothing on the device.
    """
    if not is_cuda(grid, *values):
        return rs_map_ref(grid, items, values)
    if (grid.dtype != torch.complex64 or not grid.is_contiguous()
            or grid.dim() not in (3, 4)):
        raise ValueError("the grid must be contiguous complex64 [(B,) P, S, K]")
    if len(items) != len(values):
        raise ValueError(f"{len(values)} value sources for {len(items)} "
                         f"RS PDUs")
    plan = _rs_plan(tuple(items), grid.shape, tuple(
        (v.shape, v.dtype, v.get_device()) for v in values),
        grid.get_device())
    vs = [v if v.is_contiguous() else v.contiguous() for v in values]
    ptrs = [v.data_ptr() for v in vs]
    g = grid.data_ptr()
    for launch in plan:
        launch(g, ptrs)
        KERNEL_RS.count()
    return grid


# ------------------------------------------------------------------ K26

# Per PRB, per configuration type: the pilots one CDM group takes.
PILOTS_PER_PRB = {1: 6, 2: 4}


def _check_dmrs(ports: tuple, symbols: tuple, config_type: int) -> None:
    allowed = {1: {0, 1, 2, 3}, 2: {0, 1, 2, 3, 4, 5}}.get(config_type)
    if allowed is None:
        raise ValueError(f"DM-RS configuration type {config_type} (1 or 2)")
    if not 1 <= len(ports) <= _MAX_LAYERS or not set(ports) <= allowed:
        raise ValueError(f"DM-RS ports {ports} (type {config_type}, ports "
                         f"{min(allowed)}..{max(allowed)}, at most "
                         f"{_MAX_LAYERS} layers)")
    if not 1 <= len(symbols) <= 4:
        raise ValueError(f"{len(symbols)} DM-RS symbols (the kernel takes 1..4)")


@functools.lru_cache(maxsize=256)
def _comb(prbs, group: int, config_type: int) -> np.ndarray:
    """int64 [per_rb * len(prbs)]: the subcarriers of CDM group ``group``
    over the PRBs, in pilot order (type 1: 12 p + 2 i + group, i < 6; type
    2: 12 p + 2 group + {0, 1, 6, 7}; JAX dmrs.py:43-49, :164-173)."""
    offs = (2 * np.arange(6) + group if config_type == 1
            else 2 * group + np.array([0, 1, 6, 7]))
    return (12 * np.asarray(prbs, np.int64)[:, None] + offs[None, :]
            ).reshape(-1)


@functools.lru_cache(maxsize=None)
def _cover(port: int, nsym: int, npil: int) -> np.ndarray:
    """float32 [nsym, npil]: w_f (-1 on odd pilots for odd ports) times w_t
    (+1 for every port of either type)."""
    wf = np.where((np.arange(npil) % 2 == 1) & (port % 2 == 1), -1.0, 1.0)
    return np.broadcast_to(wf, (nsym, npil)).astype(np.float32)


def _prb_table(prbs) -> np.ndarray:
    return np.asarray(prbs, np.int32)


def dmrs_map_ref(grid: torch.Tensor, pilots: torch.Tensor, w, ports: tuple,
                 symbols: tuple, prbs, prg_size: int = 0,
                 config_type: int = 1) -> torch.Tensor:
    """Plain twin of :func:`dmrs_map`: layer after layer, as the JAX
    package adds them, with the precoder's products and sums rounded one by
    one in the kernel's order."""
    _check_dmrs(ports, symbols, config_type)
    dev = grid.device
    nsym, npil = pilots.shape[-2:]
    for li, port in enumerate(ports):
        # the port's CDM group is port >> 1 in both types
        sc = const(_comb, prbs, port >> 1, config_type, device=dev)
        p_l = pilots * const(_cover, port, nsym, npil, device=dev)
        if w is None:
            for si, l in enumerate(symbols):
                grid[..., li, l, sc] += p_l[..., si, :]
            continue
        if prg_size:
            prg = sc // 12 // prg_size - prbs[0] // prg_size
            wl = w[..., li][..., prg, :].transpose(-1, -2)  # [(B,) P, K]
        else:
            wl = w[..., :, li, None]                        # [(B,) P, 1]
        wr, wi = wl.real, wl.imag
        for si, l in enumerate(symbols):
            x = p_l[..., si, :].unsqueeze(-2)               # [(B,) 1, K]
            xr, xi = x.real, x.imag
            t = torch.complex(wr * xr - wi * xi, wr * xi + wi * xr)
            grid[..., :, l, sc] += t
    return grid


def _dmrs_params(shapes: tuple, ports: tuple, symbols: tuple, prbs,
                 prg_size: int, config_type: int) -> _build.DmrsMapParams:
    """K26's parameters for one call signature: the shapes of the grid, the
    pilots and the matrix (None: none), the layers' ports, the DM-RS
    symbols, the allocation's sorted PRBs, the PRG size and the type;
    raises on what the kernel does not take."""
    _check_dmrs(ports, symbols, config_type)
    grid_s, pil_s, w_s = shapes
    lead = tuple(grid_s[:-3])
    p, s, k = grid_s[-3:]
    nprb = len(prbs)
    npil = PILOTS_PER_PRB[config_type] * nprb
    n_l = len(ports)
    if (len(lead) > 1 or tuple(pil_s[-2:]) != (len(symbols), npil)
            or tuple(pil_s[:-2]) not in ((), lead)
            or nprb == 0 or min(prbs) < 0 or 12 * (max(prbs) + 1) > k
            or max(symbols) >= s or min(symbols) < 0):
        raise ValueError(f"DM-RS map: grid {tuple(grid_s)}, pilots "
                         f"{tuple(pil_s)} vs {len(symbols)} symbols "
                         f"x {npil}, {nprb} PRBs")
    if not 0 < p <= _build.DMRS_MAX_PORTS:
        raise ValueError(f"{p} grid ports: K26 takes 1 to "
                         f"{_build.DMRS_MAX_PORTS}")
    if k % 2:
        raise ValueError(f"{k} subcarriers: K26 stores subcarrier pairs "
                         f"and takes an even count")
    slots = lead[0] if lead else 1
    if slots * p * s * k >= 1 << 31:
        raise ValueError("K26 takes at most 2^31 elements a grid (32-bit "
                         "offsets)")
    wkind, w_stride = 0, 0
    if w_s is None:
        if n_l > p:
            raise ValueError(f"{n_l} layers without a matrix on {p} ports")
    else:
        table = 1 if prg_size else 0
        w_lead = tuple(w_s[:len(w_s) - 2 - table])
        if (tuple(w_s[-2:]) != (p, n_l) or w_lead not in ((), lead)
                or len(w_s) < 2 + table):
            raise ValueError(f"DM-RS precoder {tuple(w_s)} vs {p} ports "
                             f"x {n_l} layers (PRG size {prg_size})")
        wkind = 2 if prg_size else 1
        if table and w_s[-3] <= max(prbs) // prg_size - prbs[0] // prg_size:
            raise ValueError(f"DM-RS PRG table of {w_s[-3]} matrices vs "
                             f"the PRBs {prbs[0]}..{max(prbs)} at PRG size "
                             f"{prg_size}")
        w_stride = math.prod(w_s[len(w_lead):]) if w_lead else 0
    contiguous = list(prbs) == list(range(prbs[0], prbs[0] + nprb))
    pow2 = prg_size > 0 and prg_size & (prg_size - 1) == 0
    return _build.DmrsMapParams(
        nslots=slots, P=p, S=s, K=k, nprb=nprb, npairs=6 * nprb, L=n_l,
        ports=sum(pt << (8 * i) for i, pt in enumerate(ports)),
        type2=int(config_type == 2), prb0=prbs[0], contiguous=int(contiguous),
        wkind=wkind, prg_shift=prg_size.bit_length() - 1 if pow2 else -1,
        prg_size=prg_size, prg_base=prbs[0] // prg_size if prg_size else 0,
        npil=npil, pilot_stride=len(symbols) * npil if len(pil_s) == 3 else 0,
        w_stride=w_stride,
        symbols=(ctypes.c_int * _build.DMRS_MAX_SYMBOLS)(
            *(tuple(symbols) + (-1,) * (_build.DMRS_MAX_SYMBOLS
                                        - len(symbols)))))


@functools.lru_cache(maxsize=256)
def _dmrs_plan(shapes: tuple, dtypes: tuple, ports: tuple, symbols: tuple,
               prbs, prg_size: int, config_type: int, index: int):
    """K26's launch for one call signature on CUDA device ``index``; the
    plan holds the PRB table."""
    if any(d != torch.complex64 for d in dtypes):
        raise ValueError(f"DM-RS map: grid, pilots and matrix must be "
                         f"complex64, got {dtypes}")
    p = _dmrs_params(shapes, ports, symbols, prbs, prg_size, config_type)
    table = torch.from_numpy(_prb_table(prbs)).to(f"cuda:{index}")
    return _build.Launch("srsran_dmrs_map", index, p, (table,))


def dmrs_map(grid: torch.Tensor, pilots: torch.Tensor, w, ports: tuple,
             symbols: tuple, prbs, prg_size: int = 0,
             config_type: int = 1) -> torch.Tensor:
    """Add the DL DM-RS of every layer into the grid (in place).

    grid complex64 [P, S, K] (or [B, P, S, K]); pilots the base QPSK
    sequences complex64 [nsym, per_rb * len(prbs)] (or [B, ...]), per_rb
    6 for configuration type 1 and 4 for type 2; w None (layer l on port
    l), a [P, L] matrix, or with ``prg_size`` > 0 a [G, P, L] table of the
    allocation's PRGs from the one holding its first PRB (each shared or
    [B, ...]); ports the layers' DM-RS ports (type 1: 0..3, type 2: 0..5);
    symbols the DM-RS symbols; prbs the allocation's sorted PRBs (a
    ``range`` for a contiguous one).  On the card: K26 through the cached
    plan of the call's signature (which holds the PRB table); a call
    allocates nothing.  Returns the grid.
    """
    if not (grid.is_cuda and pilots.is_cuda
            and (w is None or w.is_cuda)):
        is_cuda(*((grid, pilots) + ((w,) if w is not None else ())))
        return dmrs_map_ref(grid, pilots, w, ports, symbols, prbs, prg_size,
                            config_type)
    launch = _dmrs_plan(
        (grid.shape, pilots.shape, None if w is None else w.shape),
        (grid.dtype, pilots.dtype) + (() if w is None else (w.dtype,)),
        tuple(ports), tuple(symbols), prbs, int(prg_size), int(config_type),
        grid.get_device())
    if not grid.is_contiguous() or grid.data_ptr() & 15:
        raise ValueError("DM-RS map: K26 maps in place into a contiguous, "
                         "16-byte aligned grid")
    pil = pilots if pilots.is_contiguous() else pilots.contiguous()
    if w is None:
        launch(grid.data_ptr(), pil.data_ptr(), 0)
    else:
        wc = w if w.is_contiguous() else w.contiguous()
        launch(grid.data_ptr(), pil.data_ptr(), wc.data_ptr())
    KERNEL_DMRS.count()
    return grid
