"""Batched layered normalized min-sum LDPC decoder with CRC early stop.

Port of srsran_tpu/ops/ldpc_decode.py: one lifted check row at a time,
normalized min-sum with scaling 0.8 and at most 6 sweeps; after each sweep
the first k' hard bits of every codeblock are CRC-checked and the decoder
stops once every codeblock passes (the JAX package's all-CBs rule).  Given
a slot axis ([S, C, NV*Z] LLRs, the slot-batch mode), the rule holds per
slot, as ``jax.vmap`` of the JAX decoder keeps it: a slot whose codeblocks
all pass stops sweeping while the others go on.  LLR > 0
means bit 0; input LLRs cover the full NV*Z codeword with the 2Z punctured
positions at 0 and filler positions strongly positive.

:func:`decode_early_stop` and :func:`decode` are the K1 wrappers: on CUDA
tensors they run csrc/ldpc_decode.cu (one launch per sweep, the stop flag
and the iteration count on the device); on CPU tensors they run the plain
twins :func:`decode_early_stop_ref` / :func:`decode_ref`.  They replace
srsran_tpu/ops/ldpc_decode.py::decode_early_stop and decode; on the card a
sweep is latency-bound on shared memory (46 dependent rows per CTA, one CTA
per codeblock, so 37 of 132 SMs busy at the flagship).

:func:`check_parity` is the K36 wrapper (csrc/ldpc_parity.cu: one CTA per
codeword over K1's edge tables, a block-wide OR of the rows' syndromes);
on CPU tensors its twin :func:`check_parity_ref`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .ldpc_graph import get_graph
from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build
from .crc import _remainder_words, crc_check

KERNEL = kernels.register(kernels.Kernel(
    name="ldpc_decode", route="cuda",
    source="srsran_tpu_torch/csrc/ldpc_decode.cu",
    replaces="srsran_tpu/ops/ldpc_decode.py:112"))
KERNEL_BATCH = kernels.batched(KERNEL)
PARITY_KERNEL = kernels.register(kernels.Kernel(
    name="ldpc_check_parity", route="cuda",
    source="srsran_tpu_torch/csrc/ldpc_parity.cu",
    replaces="srsran_tpu/ops/ldpc_decode.py:158"))

DEFAULT_SCALING = 0.8
DEFAULT_MAX_ITER = 6
_MAX_DEGREE = 24        # per-edge sign bits the kernel packs in one word


@functools.lru_cache(maxsize=None)
def _layer_gather_indices(base_graph: int, z: int, nof_layers: int):
    """Per-layer flat gather indices: layer r reads its d_r lifted columns
    with the cyclic shifts folded in as one index plan [d_r * Z]."""
    g = get_graph(base_graph, z)
    plans = []
    for row in g.rows[:nof_layers]:
        j = np.arange(z)
        idx = np.concatenate([c * z + (j + s) % z for c, s in row])
        plans.append(idx.astype(np.int32))
    return plans


def _layer_plan(base_graph: int, z: int, nof_layers: int, r: int) -> np.ndarray:
    return _layer_gather_indices(base_graph, z, nof_layers)[r].astype(np.int64)


def _sweep_ref(llr, c2v, base_graph, z, nrows, scaling):
    """One layer sweep of the twin over [B, NV*Z] LLRs, in place."""
    g = get_graph(base_graph, z)
    batch = llr.shape[0]
    for r, row in enumerate(g.rows[:nrows]):
        d = len(row)
        plan = const(_layer_plan, base_graph, z, nrows, r, device=llr.device)
        v = llr[:, plan].reshape(batch, d, z)                  # [B, d, Z]
        t = v - c2v[:, r, :d]
        abs_t = t.abs()
        min1, idx = torch.min(abs_t, dim=1, keepdim=True)      # first minimum
        ar = torch.arange(d, device=llr.device)[None, :, None]
        is_min = ar == idx
        min2 = torch.amin(torch.where(is_min, torch.inf, abs_t), dim=1,
                          keepdim=True)
        neg = t < 0
        sgn_prod = (neg.sum(dim=1, keepdim=True) % 2).bool()
        mag = torch.where(is_min, min2, min1)
        edge_sign = torch.logical_xor(sgn_prod, neg)
        new = scaling * torch.where(edge_sign, -mag, mag)
        llr[:, plan] = (t + new).reshape(batch, d * z)
        c2v[:, r, :d] = new


def _prepare(llrs, base_graph, z, nof_layers):
    g = get_graph(base_graph, z)
    nrows = nof_layers if nof_layers > 0 else g.nof_rows
    batch = llrs.shape[0]
    if llrs.shape[-1] != g.nof_cols * z:
        raise ValueError(f"llrs {tuple(llrs.shape)} vs NV*Z={g.nof_cols * z}")
    return g, nrows, batch


def decode_early_stop_ref(llrs, base_graph, z, nof_layers, max_iter, scaling,
                          crc_poly, k_prime):
    """Plain twin of :func:`decode_early_stop`.  Its stop test reads the CRC
    flags on the host after each sweep; a slot axis runs slot by slot."""
    if llrs.ndim == 3:
        outs = [decode_early_stop_ref(x, base_graph, z, nof_layers, max_iter,
                                      scaling, crc_poly, k_prime)
                for x in llrs]
        return tuple(torch.stack(o) for o in zip(*outs))
    g, nrows, batch = _prepare(llrs, base_graph, z, nof_layers)
    llr = llrs.reshape(batch, -1).to(torch.float32).clone()
    max_d = max(len(r) for r in g.rows[:nrows])
    c2v = llr.new_zeros((batch, nrows, max_d, z))
    iters = 0
    while iters < max_iter:
        _sweep_ref(llr, c2v, base_graph, z, nrows, scaling)
        iters += 1
        hard = (llr[:, :k_prime] < 0).to(torch.int8)
        if bool(torch.all(crc_check(hard, crc_poly))):
            break
    bits = (llr < 0).to(torch.int8)
    return bits, llr, torch.tensor(iters, dtype=torch.int32, device=llr.device)


def decode_ref(llrs, base_graph, z, nof_layers=0, max_iter=DEFAULT_MAX_ITER,
               scaling=DEFAULT_SCALING):
    """Plain twin of :func:`decode` (fixed number of sweeps)."""
    g, nrows, batch = _prepare(llrs, base_graph, z, nof_layers)
    llr = llrs.reshape(batch, -1).to(torch.float32).clone()
    max_d = max(len(r) for r in g.rows[:nrows])
    c2v = llr.new_zeros((batch, nrows, max_d, z))
    for _ in range(max_iter):
        _sweep_ref(llr, c2v, base_graph, z, nrows, scaling)
    return (llr < 0).to(torch.int8), llr


@functools.lru_cache(maxsize=None)
def _edge_tables(base_graph: int, z: int, nrows: int) -> np.ndarray:
    """int32 [nrows + 1 + 2E]: row pointers, then edge columns, then shifts."""
    g = get_graph(base_graph, z)
    rows = g.rows[:nrows]
    ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    cols = np.array([c for r in rows for c, _ in r], dtype=np.int64)
    shifts = np.array([s for r in rows for _, s in r], dtype=np.int64)
    return np.concatenate([ptr, cols, shifts]).astype(np.int32)


def _crc_words_i32(poly: str, k_prime: int) -> np.ndarray:
    return _remainder_words(poly, k_prime).view(np.int32)


def _decode_cuda(llrs, base_graph, z, nof_layers, max_iter, scaling,
                 crc_poly, k_prime):
    slots = llrs.shape[0] if llrs.ndim == 3 else 1
    shape = llrs.shape
    llrs = llrs.reshape(-1, shape[-1])
    g, nrows, batch = _prepare(llrs, base_graph, z, nof_layers)
    if llrs.dtype != torch.float32:
        raise ValueError(f"llrs must be float32, got {llrs.dtype}")
    if max(len(r) for r in g.rows[:nrows]) > _MAX_DEGREE:
        raise ValueError("check-row degree above the kernel's sign word")
    dev = llrs.device
    lib = _build.load()
    llr = llrs.reshape(batch, -1).contiguous().clone()
    bits = torch.empty(llr.shape, dtype=torch.int8, device=dev)
    m1 = torch.zeros((batch, nrows, z), dtype=torch.float32, device=dev)
    m2 = torch.zeros_like(m1)
    meta = torch.zeros((batch, nrows, z), dtype=torch.int32, device=dev)
    state = torch.zeros((slots, 2), dtype=torch.int32, device=dev)  # done, iters
    cb_ok = torch.zeros(batch, dtype=torch.int32, device=dev)
    edges = const(_edge_tables, base_graph, z, nrows, device=dev)
    n_edges = (edges.shape[0] - nrows - 1) // 2
    row_ptr = edges[:nrows + 1]
    edge_col = edges[nrows + 1:nrows + 1 + n_edges]
    edge_shift = edges[nrows + 1 + n_edges:]
    crc_rows = (const(_crc_words_i32, crc_poly, k_prime, device=dev)
                if crc_poly else None)
    stream = _build.stream_of(llr)
    for _ in range(max_iter):
        _build.check(lib.srsran_ldpc_sweep(
            _build.ptr(llr), _build.ptr(bits), _build.ptr(m1), _build.ptr(m2),
            _build.ptr(meta), _build.ptr(row_ptr), _build.ptr(edge_col),
            _build.ptr(edge_shift), nrows, g.nof_cols, z, float(scaling),
            _build.ptr(crc_rows) if crc_rows is not None else None,
            k_prime, _build.ptr(cb_ok), _build.ptr(state), batch,
            batch // slots, stream), "ldpc_sweep")
        if crc_rows is not None:
            _build.check(lib.srsran_ldpc_check(
                _build.ptr(cb_ok), slots, batch // slots, _build.ptr(state),
                stream), "ldpc_check")
    if len(shape) == 3:
        KERNEL_BATCH.count()
        return bits.reshape(shape), llr.reshape(shape), state[:, 1]
    KERNEL.count()
    return bits, llr, state[0, 1]


def decode_early_stop(llrs: torch.Tensor, base_graph: int, z: int,
                      nof_layers: int, max_iter: int, scaling: float,
                      crc_poly: str, k_prime: int):
    """Layered min-sum with per-sweep CRC early stop.

    llrs f32 [B, NV*Z].  Returns (bits int8 [B, NV*Z], soft f32 [B, NV*Z],
    nof_iterations int32 scalar).  With a slot axis, llrs f32 [S, B, NV*Z]
    stop per slot (one launch per sweep for all S slots) and the count is
    int32 [S].  On CUDA no host sync happens: the count stays a device
    tensor.
    """
    if not is_cuda(llrs):
        return decode_early_stop_ref(llrs, base_graph, z, nof_layers,
                                     max_iter, scaling, crc_poly, k_prime)
    return _decode_cuda(llrs, base_graph, z, nof_layers, max_iter, scaling,
                        crc_poly, k_prime)


def decode(llrs: torch.Tensor, base_graph: int, z: int, nof_layers: int = 0,
           max_iter: int = DEFAULT_MAX_ITER, scaling: float = DEFAULT_SCALING):
    """Decode a batch of codeblocks with a fixed number of sweeps.

    Returns (bits int8 [B, NV*Z], soft f32 [B, NV*Z]).
    """
    if not is_cuda(llrs):
        return decode_ref(llrs, base_graph, z, nof_layers, max_iter, scaling)
    bits, soft, _ = _decode_cuda(llrs, base_graph, z, nof_layers, max_iter,
                                 scaling, None, 0)
    return bits, soft


def check_parity_ref(bits: torch.Tensor, base_graph: int,
                     z: int) -> torch.Tensor:
    """Plain twin of :func:`check_parity`: each lifted row's XOR of its
    rolled columns."""
    g = get_graph(base_graph, z)
    b = bits.reshape(bits.shape[0], g.nof_cols, z).to(torch.uint8) & 1
    ok = torch.ones(bits.shape[0], dtype=torch.bool, device=bits.device)
    for row in g.rows:
        acc = torch.zeros((bits.shape[0], z), dtype=torch.uint8,
                          device=bits.device)
        for c, s in row:
            acc = acc ^ (torch.roll(b[:, c], -s, dims=-1) if s else b[:, c])
        ok = ok & (acc == 0).all(dim=-1)
    return ok


def check_parity(bits: torch.Tensor, base_graph: int, z: int) -> torch.Tensor:
    """Syndrome-zero check, batched: hard bits int8 [B, NV*Z] -> bool [B]."""
    if not is_cuda(bits):
        return check_parity_ref(bits, base_graph, z)
    g = get_graph(base_graph, z)
    if bits.ndim != 2 or bits.shape[1] != g.nof_cols * z:
        raise ValueError(f"bits must be [B, {g.nof_cols * z}], got "
                         f"{tuple(bits.shape)}")
    dev = bits.device
    nrows = len(g.rows)
    edges = const(_edge_tables, base_graph, z, nrows, device=dev)
    n_edges = (edges.shape[0] - nrows - 1) // 2
    x = bits.to(torch.int8).contiguous()
    ok = torch.empty(x.shape[0], dtype=torch.bool, device=dev)
    _build.check(_build.load().srsran_ldpc_parity(
        _build.ptr(x), x.shape[0], nrows, g.nof_cols, z,
        _build.ptr(edges[:nrows + 1]),
        _build.ptr(edges[nrows + 1:nrows + 1 + n_edges]),
        _build.ptr(edges[nrows + 1 + n_edges:]), _build.ptr(ok),
        _build.stream_of(x)), "ldpc_check_parity")
    PARITY_KERNEL.count()
    return ok
