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
tensors they run csrc/ldpc_decode.cu (every sweep in one launch while the
codeblocks fill at most half the SMs, else a launch per sweep; the edge
tables by value, the stop flags and the iteration count on the device)
through ``kernels/_build.py::Launch``, one plan per call signature
(:func:`_decode_plan`; its struct alone, testable on the CPU, from
:func:`_decode_params`); on CPU tensors they run the plain twins
:func:`decode_early_stop_ref` / :func:`decode_ref`.  They replace
srsran_tpu/ops/ldpc_decode.py::decode_early_stop and decode; on the card a
sweep is bound by its rows' latency and issue (one CTA per codeblock, so
37 of 132 SMs busy at the flagship).

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
_MAX_DEGREE = 19        # csrc/ldpc_decode.cu kLdpcMaxDegree (registers)


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


@functools.lru_cache(maxsize=None)
def _live_columns(base_graph: int, z: int, nrows: int) -> int:
    """The columns K1 keeps in shared memory: every column the first
    ``nrows`` rows touch, and at least the info columns (the CRC reads
    their hard bits); the rest of a codeword goes straight through."""
    g = get_graph(base_graph, z)
    touched = max(c for row in g.rows[:nrows] for c, _ in row)
    return max(g.nof_info_cols, touched + 1)


@functools.lru_cache(maxsize=None)
def _edge_words(base_graph: int, z: int, nrows: int) -> tuple:
    """K1's edge tables by value (csrc/ldpc_decode.cu): row pointers uint16
    [nrows + 1] and per edge int32 [2]: the byte offset 4 (c Z + s) of its
    column c at shift s in shared memory, and Z - s, the first lane whose
    read wraps (lane j reads LLR c Z + (j + s) mod Z)."""
    g = get_graph(base_graph, z)
    rows = g.rows[:nrows]
    ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    edge = np.array([(4 * (c * z + s), z - s) for r in rows for c, s in r],
                    dtype=np.int32)
    return ptr.astype(np.uint16), edge


@functools.lru_cache(maxsize=None)
def _sync_mask(base_graph: int, z: int, nrows: int) -> int:
    """K1's barriers: bit r set when a barrier follows row r -- when row r
    + 1 shares a column with a row since the last barrier (and after the
    last row).  Rows between two barriers touch disjoint LLRs, so running
    them without one gives the sequential schedule's values exactly."""
    rows = [{c for c, _ in r} for r in get_graph(base_graph, z).rows[:nrows]]
    mask, touched = 0, set()
    for r, cols in enumerate(rows):
        touched |= cols
        if r + 1 == len(rows) or rows[r + 1] & touched:
            mask |= 1 << r
            touched = set()
    return mask


def _decode_params(base_graph: int, z: int, nof_layers: int, shape: tuple,
                   max_iter: int, scaling: float, k_prime: int,
                   sms: int = 0) -> _build.LdpcDecodeParams:
    """K1's launch for LLRs of ``shape`` ([B, NV*Z], or [S, B, NV*Z] with a
    slot axis) on a card of ``sms`` SMs: ``single`` (every sweep in one
    launch, each slot's CTAs meeting after each sweep) while the codeblocks
    fill at most half the SMs, so that every CTA is resident even beside a
    second such launch; else a launch per sweep.  The state holds
    ``stride`` ints a slot (4 + one failure count a sweep); ``sync`` marks
    the rows a barrier follows.
    Raises on what the kernel does not take."""
    if len(shape) not in (2, 3) or 0 in shape:
        raise ValueError(f"llrs must be [B, NV*Z] or [S, B, NV*Z], got "
                         f"{tuple(shape)}")
    g = get_graph(base_graph, z)
    nrows = nof_layers if nof_layers > 0 else g.nof_rows
    if shape[-1] != g.nof_cols * z:
        raise ValueError(f"llrs {tuple(shape)} vs NV*Z={g.nof_cols * z}")
    if max(len(r) for r in g.rows[:nrows]) > _MAX_DEGREE:
        raise ValueError("check-row degree above the kernel's registers")
    if max_iter < 1:
        raise ValueError(f"max_iter must be at least 1, got {max_iter}")
    ptr, edge = _edge_words(base_graph, z, nrows)
    slots = shape[0] if len(shape) == 3 else 1
    batch = slots * shape[-2]
    p = _build.LdpcDecodeParams(
        nb=batch, cbs_per_slot=shape[-2], nslots=slots, nrows=nrows,
        ncols=g.nof_cols, live=_live_columns(base_graph, z, nrows), z=z,
        threads=-(-z // 32) * 32, single=2 * batch <= sms,
        stride=4 + max_iter, k_prime=k_prime,
        sweeps=max_iter, scaling=scaling,
        sync=_sync_mask(base_graph, z, nrows))
    p.row_ptr[:len(ptr)] = ptr.tolist()
    for e, (off, wrap) in enumerate(edge.tolist()):
        p.edge[e][:] = (off, wrap)
    return p


@functools.lru_cache(maxsize=64)
def _decode_plan(base_graph: int, z: int, nof_layers: int, shape: tuple,
                 max_iter: int, scaling: float, crc_poly, k_prime: int,
                 index: int) -> tuple:
    """K1's plan on CUDA device ``index``: (its launch, with the CRC's
    remainder words as its table; the state's ints a slot; the scratch's
    int32 count: the state [S, 4 + max_iter], then the compressed c2v [3,
    B, nrows, Z])."""
    params = _decode_params(
        base_graph, z, nof_layers, shape, max_iter, scaling,
        k_prime if crc_poly else 0,
        torch.cuda.get_device_properties(index).multi_processor_count)
    dev = torch.device("cuda", index)
    crc_rows = (torch.tensor(_crc_words_i32(crc_poly, k_prime), device=dev)
                if crc_poly else torch.zeros(1, dtype=torch.int32, device=dev))
    launch = _build.Launch("srsran_ldpc_decode", index, params, (crc_rows,))
    return (launch, params.stride,
            params.stride * params.nslots + 3 * params.nb * params.nrows * z)


def _decode_cuda(llrs, base_graph, z, nof_layers, max_iter, scaling,
                 crc_poly, k_prime):
    """K1 on CUDA: one allocation of scratch (state and c2v) beside the
    outputs, one ctypes call that launches the decode; the caller's LLRs
    stay as they are (the first sweep reads them and writes the output)."""
    launch, stride, scratch_n = _decode_plan(
        base_graph, z, nof_layers, tuple(llrs.shape), max_iter,
        float(scaling), crc_poly, k_prime, llrs.get_device())
    if llrs.dtype is not torch.float32:
        raise ValueError(f"llrs must be float32, got {llrs.dtype}")
    x = llrs if llrs.is_contiguous() else llrs.contiguous()
    soft = torch.empty_like(x)
    bits = torch.empty_like(x, dtype=torch.int8)
    scratch = x.new_empty(scratch_n, dtype=torch.int32)
    launch(x.data_ptr(), soft.data_ptr(), bits.data_ptr(), scratch.data_ptr())
    if llrs.ndim == 3:
        KERNEL_BATCH.count()
        return bits, soft, scratch[1:stride * llrs.shape[0]:stride]
    KERNEL.count()
    return bits, soft, scratch[1]


def decode_early_stop(llrs: torch.Tensor, base_graph: int, z: int,
                      nof_layers: int, max_iter: int, scaling: float,
                      crc_poly: str, k_prime: int):
    """Layered min-sum with per-sweep CRC early stop.

    llrs f32 [B, NV*Z].  Returns (bits int8 [B, NV*Z], soft f32 [B, NV*Z],
    nof_iterations int32 scalar).  With a slot axis, llrs f32 [S, B, NV*Z]
    stop per slot (all S slots in the same launches) and the count is int32
    [S].  On CUDA no host sync happens: the count stays a device tensor (a
    view of the launch's scratch).
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
