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
CUDA tensors it runs csrc/ldpc_encode.cu (a TB-CRC pass, then one CTA per
codeblock that adds its CB CRC and encodes in shared memory); on CPU
tensors it runs :func:`dlsch_encode_ref`, the plain twin built from
:func:`encode` and ops/crc.py.  On the card both passes are small memory
passes (about 5 MB at the flagship); the design is in the .cu file.
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
from .crc import _remainder_words, crc
from .ldpc_decode import _edge_tables

KERNEL = kernels.register(kernels.Kernel(
    name="dlsch_encode", route="cuda",
    source="srsran_tpu_torch/csrc/ldpc_encode.cu",
    replaces="srsran_tpu/ops/ldpc_encode.py:56"))
KERNEL_BATCH = kernels.batched(KERNEL)


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


def _words_i32(poly: str, nbits: int) -> np.ndarray:
    return _remainder_words(poly, nbits).view(np.int32)


def dlsch_encode(tb: torch.Tensor, base_graph: int) -> torch.Tensor:
    """Encode one transport block: TB bits int8 [TBS] -> the encoded
    codeblocks int8 [C, N] (TB CRC and CB CRC24B attached, fillers 0, the
    2Z punctured systematic bits dropped), bit for bit
    ``encode(...)[:, 2Z:]`` of the segmented block.  With a slot axis, B
    TBs int8 [B, TBS] -> [B, C, N] in one launch of each pass, each TB
    with its own TB CRC."""
    if not is_cuda(tb):
        return dlsch_encode_ref(tb, base_graph)
    if tb.ndim not in (1, 2):
        raise ValueError(f"tb must be [TBS] or [B, TBS], got "
                         f"{tuple(tb.shape)}")
    lead = tuple(tb.shape[:-1])
    slots = lead[0] if lead else 1
    tbs = tb.shape[-1]
    seg = segment_tb(tbs, base_graph)
    c, z = seg.nof_codeblocks, seg.lifting_size
    g = get_graph(base_graph, z)
    dev = tb.device
    lib = _build.load()
    tb8 = tb.to(torch.int8).contiguous()
    tb_poly = _tb_crc_poly(seg)
    tb_words = const(_words_i32, tb_poly, tbs, device=dev)
    ppc = seg.cb_info_bits - seg.cb_crc_bits
    cb_words = const(_words_i32, "crc24B", ppc, device=dev)
    edges = const(_edge_tables, base_graph, z, g.nof_rows, device=dev)
    n_edges = (edges.shape[0] - g.nof_rows - 1) // 2
    row_ptr = edges[:g.nof_rows + 1]
    edge_col = edges[g.nof_rows + 1:g.nof_rows + 1 + n_edges]
    edge_shift = edges[g.nof_rows + 1 + n_edges:]
    core = const(_core_schedule, base_graph, z, device=dev)
    scratch = torch.empty(slots, dtype=torch.int32, device=dev)
    out = torch.empty(lead + (c, seg.codeword_bits), dtype=torch.int8,
                      device=dev)
    _build.check(lib.srsran_dlsch_encode(
        _build.ptr(tb8), tbs, _build.ptr(tb_words), seg.tb_crc_bits,
        _build.ptr(scratch), _build.ptr(cb_words), seg.cb_crc_bits, ppc,
        g.nof_info_cols, z, g.nof_cols, g.nof_rows, _build.ptr(row_ptr),
        _build.ptr(edge_col), _build.ptr(edge_shift), _build.ptr(core), c,
        _build.ptr(out), slots, _build.stream_of(tb8)), "dlsch_encode")
    (KERNEL_BATCH if lead else KERNEL).count()
    return out
