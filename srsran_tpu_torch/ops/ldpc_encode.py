"""Batched LDPC encoder (TS38.212 §5.3.2) and the DL-SCH encode (K5).

Port of srsran_tpu/ops/ldpc_encode.py::encode: every lifted-circulant
product is a gather over a host index plan (shift folded into the indices)
and every check row's XOR a sum mod 2; the double-diagonal core parities
are solved from the graph structure.  :func:`encode` maps bits int8 [B, K]
(K = 22Z or 10Z, filler bits 0) to the full codeword int8 [B, NV*Z]
including the 2Z punctured systematic bits.

:func:`dlsch_encode` is the K5 wrapper: a transport block in, its encoded
codeblocks out (TB CRC, segmentation with CB CRC24B, LDPC encode; the
first half of srsran_tpu/phy/upper/pdsch.py::encode_transport_block).  On
CUDA tensors it runs csrc/ldpc_encode.cu (one launch: a CTA per codeblock
packs its bits 32 to a word, takes both CRCs as one carry-less product
per word, and encodes by rotating packed columns) through
``kernels/_build.py::Launch``, one plan per (TBS, base graph, slots,
device) (:func:`_encode_plan`; its struct from :func:`_encode_params`,
its CRC tables from :func:`_crc_word_tables`); on CPU tensors it runs
:func:`dlsch_encode_ref`, the plain twin built from :func:`encode` and
ops/crc.py.  On the card it is a small memory pass (the TB once and 2.5
MB out at the flagship); the design is in the .cu file.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .ldpc_graph import get_graph
from ..ran.ldpc_params import segment_tb
from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build
from .crc import POLYS, _remainder_words, crc

KERNEL = kernels.register(kernels.Kernel(
    name="dlsch_encode", route="cuda",
    source="srsran_tpu_torch/csrc/ldpc_encode.cu",
    replaces="srsran_tpu/ops/ldpc_encode.py:56"))
KERNEL_BATCH = kernels.batched(KERNEL)
ENCODE_THREADS = 512       # csrc/ldpc_encode.cu kThreads


@functools.lru_cache(maxsize=None)
def _row_sum_plan(base_graph: int, z: int, rows: tuple, col_limit: int):
    """[len(rows), max_d, Z] gather plan: row edges with their circulant
    shifts folded in; padding points at a zero slot appended at col_limit."""
    g = get_graph(base_graph, z)
    j = np.arange(z)
    sel = [[c * z + (j + s) % z for c, s in g.rows[r] if c < col_limit]
           for r in rows]
    max_d = max(len(s) for s in sel)
    pad = col_limit * z + j
    plan = np.stack([np.concatenate(s + [pad] * (max_d - len(s)))
                     for s in sel])
    return plan.reshape(len(rows), max_d, z).astype(np.int32)


def _row_sums(flat_with_zero: torch.Tensor, plan: torch.Tensor) -> torch.Tensor:
    """XOR-reduce each row's gathered edges: [B, R, Z] parities."""
    v = flat_with_zero[:, plan]                          # [B, R, max_d, Z]
    return (torch.sum(v.to(torch.int32), dim=2) & 1).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _core_schedule(base_graph: int, z: int) -> np.ndarray:
    """How the core parities solve, int32 [28]: the p0 shift that survives
    the sum of the four core rows (the double diagonal cancels; exactly one
    survives in the NR base graphs), then three back-substitution steps,
    each (row, target column, nterms, (column, shift) x 3, zero-padded):
    the row's one unknown parity column (shift 0) is its info sum XOR the
    known parity columns rolled by their shifts."""
    g = get_graph(base_graph, z)
    kb = g.nof_info_cols
    p0_shifts = [g.row_shift(r, kb) for r in range(4) if kb in g.row_cols(r)]
    surviving = [s for s in set(p0_shifts) if p0_shifts.count(s) % 2 == 1]
    if len(surviving) != 1:
        raise ValueError(f"core p0 shifts {p0_shifts} do not reduce")
    known = {0}
    flat = [surviving[0]]
    for _ in range(3):
        for r in range(4):
            unknown = [c for c in g.row_cols(r)
                       if kb <= c < kb + 4 and (c - kb) not in known]
            if len(unknown) != 1:
                continue
            terms = [(c, g.row_shift(r, c)) for c in g.row_cols(r)
                     if kb <= c < kb + 4 and c != unknown[0]]
            flat += [r, unknown[0], len(terms)]
            flat += [v for t in terms for v in t] + [0, 0] * (3 - len(terms))
            known.add(unknown[0] - kb)
    if len(flat) != 28:
        raise ValueError("core parities do not solve in three steps")
    return np.asarray(flat, dtype=np.int32)


def encode(bits: torch.Tensor, base_graph: int, z: int) -> torch.Tensor:
    """Encode a batch of codeblocks.  bits int8 [B, K] -> int8 [B, NV*Z]."""
    g = get_graph(base_graph, z)
    kb = g.nof_info_cols
    batch = bits.shape[0]
    if bits.shape[1] != kb * z:
        raise ValueError(f"bits {tuple(bits.shape)} vs K={kb * z}")
    dev = bits.device
    info = bits.reshape(batch, kb, z).to(torch.uint8)
    zero = torch.zeros((batch, z), dtype=torch.uint8, device=dev)

    info_flat = torch.cat([info.reshape(batch, kb * z), zero], dim=1)
    core_plan = const(_row_sum_plan, base_graph, z, (0, 1, 2, 3), kb,
                      device=dev, dtype=torch.long)
    cs = _row_sums(info_flat, core_plan)                           # [B, 4, Z]
    core_sums = [cs[:, r] for r in range(4)]

    # p0, then p1..p3 by back-substitution, in the order of the host
    # schedule K5 follows too.
    sched = _core_schedule(base_graph, z).tolist()
    total = core_sums[0] ^ core_sums[1] ^ core_sums[2] ^ core_sums[3]
    parities = {kb: torch.roll(total, sched[0], dims=-1)}
    for st in range(3):
        r, target, nterms, *terms = sched[1 + 9 * st:10 + 9 * st]
        acc = core_sums[r]
        for c, s in zip(terms[0:2 * nterms:2], terms[1:2 * nterms:2]):
            p = parities[c]
            acc = acc ^ (torch.roll(p, -s, dims=-1) if s else p)
        parities[target] = acc

    core = torch.stack([parities[kb + i] for i in range(4)], dim=1)  # [B, 4, Z]
    known = torch.cat([info, core], dim=1)                        # [B, kb+4, Z]
    known_flat = torch.cat([known.reshape(batch, (kb + 4) * z), zero], dim=1)
    ext_plan = const(_row_sum_plan, base_graph, z, tuple(range(4, g.nof_rows)),
                     kb + 4, device=dev, dtype=torch.long)
    ext = _row_sums(known_flat, ext_plan)                         # [B, R-4, Z]
    full = torch.cat([known, ext], dim=1)
    return full.reshape(batch, g.nof_cols * z).to(torch.int8)


def encode_graph(bits: torch.Tensor, graph) -> torch.Tensor:
    """:func:`encode` for an ``ops.ldpc_graph.LdpcGraph``."""
    return encode(bits, graph.base_graph, graph.z)


def _tb_crc_poly(seg) -> str:
    return "crc24A" if seg.tb_crc_bits == 24 else "crc16"


def dlsch_encode_ref(tb: torch.Tensor, base_graph: int) -> torch.Tensor:
    """Plain twin of :func:`dlsch_encode` (a slot axis runs slot by
    slot)."""
    if tb.ndim == 2:
        return torch.stack([dlsch_encode_ref(t, base_graph) for t in tb])
    seg = segment_tb(tb.shape[0], base_graph)
    payload = tb.to(torch.int8)
    b = torch.cat([payload, crc(payload[None], _tb_crc_poly(seg))[0]])
    c, z = seg.nof_codeblocks, seg.lifting_size
    k_prime, k = seg.cb_info_bits, seg.full_block_bits
    payload_per_cb = k_prime - seg.cb_crc_bits
    pad = payload_per_cb * c - b.shape[0]
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    cbs = b.reshape(c, payload_per_cb)
    if seg.cb_crc_bits:
        cbs = torch.cat([cbs, crc(cbs, "crc24B")], dim=-1)       # [C, K']
    cbs_full = torch.cat([cbs, cbs.new_zeros((c, k - k_prime))], dim=-1)
    return encode(cbs_full, base_graph, z)[:, 2 * z:]


def _xpow(poly: str, e: int) -> int:
    """x^e mod G, as an L-bit word."""
    length, g = POLYS[poly]
    r = 1
    for _ in range(e):
        r = (r << 1) ^ (g if r >> (length - 1) & 1 else 0)
        r &= (1 << length) - 1
    return r


def _word_shares(poly: str, n: int, starts: np.ndarray) -> np.ndarray:
    """K5's CRC table words for 32-bit words of an n-bit message, the word
    at position s holding message bits s..s+31 (bit b is bit s + b): the
    bits of its reversed value p weigh x^(n - 32 - s + L), so its share of
    the remainder is p(x) x^e mod G, taken a byte at a time: uint32 [len,
    4], word k = x^(e + 8k) mod G (byte k of p weighs x^(8k)).  A word that
    runs past the message has e < L and, below 0, p shifted right by -e
    instead (its low bits are past the message, zero), kept in bits 24..31
    of word 0.  A word at or past n gets zeros."""
    length = POLYS[poly][0]
    s = np.asarray(starts, dtype=np.int64)
    out = np.zeros(s.shape + (4,), dtype=np.int64)
    whole = s + 31 < n
    rem = _remainder_words(poly, n)       # rem[i] = x^(n - 1 - i + L)
    for k in range(4):
        out[whole, k] = rem[s[whole] + 31 - 8 * k]
    for i in np.flatnonzero(~whole & (s < n)):
        e = n - 32 - int(s[i]) + length
        out[i] = [_xpow(poly, max(e, 0) + 8 * k) for k in range(4)]
        out[i, 0] |= max(0, -e) << 24
    return out.astype(np.uint32)


@functools.lru_cache(maxsize=16)
def _crc_word_tables(tbs: int, base_graph: int) -> tuple:
    """K5's CRC tables for one TB size (csrc/ldpc_encode.cu): the CB
    CRC24B's [kb * nw, 4] over a codeblock's packed columns (word w of
    column c starts at c * Z + 32 w), and the TB CRC's [C * kb * nw, 4]
    over every codeblock's, 0 where a word holds no TB bits."""
    seg = segment_tb(tbs, base_graph)
    z = seg.lifting_size
    kb = get_graph(base_graph, z).nof_info_cols
    nw = -(-z // 32)
    ppc = seg.cb_info_bits - seg.cb_crc_bits
    local = (np.arange(kb)[:, None] * z + 32 * np.arange(nw)[None, :]
             ).reshape(-1)
    cb_tab = _word_shares("crc24B", ppc, local)
    glob = (np.arange(seg.nof_codeblocks)[:, None] * ppc + local[None, :])
    tb_tab = _word_shares(_tb_crc_poly(seg), tbs, glob.reshape(-1))
    tb_tab[np.broadcast_to(local >= ppc, glob.shape).reshape(-1)] = 0
    return cb_tab, tb_tab


def _encode_params(tbs: int, base_graph: int,
                   slots: int) -> _build.DlschEncodeParams:
    """K5's launch for ``slots`` TBs of ``tbs`` bits: the sizes, the CRC
    polynomials, the core schedule and the edge tables by value (per edge
    its column times the column's words, nw + 1, in the low half and its
    shift in the high half)."""
    seg = segment_tb(tbs, base_graph)
    z = seg.lifting_size
    g = get_graph(base_graph, z)
    nw = -(-z // 32)
    rows = g.rows
    ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    edge = [c * (nw + 1) | s << 16 for r in rows for c, s in r]
    tb_len, tb_poly = POLYS[_tb_crc_poly(seg)]
    p = _build.DlschEncodeParams(
        tbs=tbs, tb_crc_len=seg.tb_crc_bits, cb_crc_len=seg.cb_crc_bits,
        ppc=seg.cb_info_bits - seg.cb_crc_bits, kb=g.nof_info_cols, z=z,
        nw=nw, ncols=g.nof_cols, nrows=g.nof_rows,
        ncb=seg.nof_codeblocks, nslots=slots, threads=ENCODE_THREADS,
        tb_poly=tb_poly | 1 << tb_len, cb_poly=POLYS["crc24B"][1] | 1 << 24)
    p.core[:] = _core_schedule(base_graph, z).tolist()
    p.row_ptr[:len(ptr)] = ptr.tolist()
    p.edge[:len(edge)] = edge
    return p


@functools.lru_cache(maxsize=64)
def _encode_plan(tbs: int, base_graph: int, slots: int, index: int) -> tuple:
    """K5's plan on CUDA device ``index``: (its launch, with the CRC tables;
    C; N)."""
    params = _encode_params(tbs, base_graph, slots)
    dev = torch.device("cuda", index)
    tables = tuple(torch.from_numpy(t.view(np.int32)).to(dev)
                   for t in _crc_word_tables(tbs, base_graph))
    launch = _build.Launch("srsran_dlsch_encode", index, params, tables)
    return launch, params.ncb, (params.ncols - 2) * params.z


def dlsch_encode(tb: torch.Tensor, base_graph: int) -> torch.Tensor:
    """Encode one transport block: TB bits int8 [TBS] -> the encoded
    codeblocks int8 [C, N] (TB CRC and CB CRC24B attached, fillers 0, the
    2Z punctured systematic bits dropped), bit for bit
    ``encode(...)[:, 2Z:]`` of the segmented block.  With a slot axis, B
    TBs int8 [B, TBS] -> [B, C, N] in one launch, each TB with its own TB
    CRC."""
    if not is_cuda(tb):
        return dlsch_encode_ref(tb, base_graph)
    if tb.ndim not in (1, 2) or 0 in tb.shape:
        raise ValueError(f"tb must be [TBS] or [B, TBS], got "
                         f"{tuple(tb.shape)}")
    slots = tb.shape[0] if tb.ndim == 2 else 1
    launch, c, n = _encode_plan(tb.shape[-1], base_graph, slots,
                                tb.get_device())
    if tb.dtype is not torch.int8 or not tb.is_contiguous():
        tb = tb.to(torch.int8).contiguous()
    out = tb.new_empty(tb.shape[:-1] + (c, n))
    scratch = tb.new_empty(2 * slots, dtype=torch.int32)
    launch(tb.data_ptr(), out.data_ptr(), scratch.data_ptr())
    (KERNEL_BATCH if tb.ndim == 2 else KERNEL).count()
    return out
