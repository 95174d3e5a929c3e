"""LDPC rate matching / dematching (TS38.212 §5.4.2), window form.

Port of srsran_tpu/ops/ldpc_rate_match.py.  Bit selection is a circular
contiguous window over the filler-free circular buffer (start k0'), so both
directions use the one geometry of :func:`_window_plan`; the JAX package's
second, environment-selected formulation is not carried.

:func:`rate_dematch_combine` is the K2 wrapper: on CUDA tensors the
dematch, the HARQ soft-buffer add and the decoder-input layout (2Z zero
prefix) are one pass of csrc/rate_dematch.cu; on CPU tensors it runs
:func:`rate_dematch_combine_ref`, the plain twin.  It replaces
srsran_tpu/ops/ldpc_rate_match.py::rate_dematch_batch with the soft add
and prefix of phy/upper/sch_decoder.py::decode; on the card it is a pure
memory pass (about 10 MB at the flagship).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ran.ldpc_params import rate_match_k0
from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build

KERNEL = kernels.register(kernels.Kernel(
    name="rate_dematch", route="cuda",
    source="srsran_tpu_torch/csrc/rate_dematch.cu",
    replaces="srsran_tpu/ops/ldpc_rate_match.py:159"))
KERNEL_BATCH = kernels.batched(KERNEL)

FILLER_LLR = 1e4


@functools.lru_cache(maxsize=None)
def _window_plan(rv: int, base_graph: int, z: int, k_prime: int, k: int,
                 n: int, n_ref: int = 0):
    """(fs, fe, n_nf, k0p): filler range [fs, fe) within [0, n_cb), the
    filler-free buffer length, and the window start in filler-free coords."""
    n_cb = min(n_ref, n) if n_ref else n
    k0 = rate_match_k0(base_graph, rv, n_cb, z)
    fs = min(k_prime - 2 * z, n_cb)
    fe = min(k - 2 * z, n_cb)
    n_nf = n_cb - (fe - fs)
    k0p = k0 - max(0, min(k0, fe) - fs)
    return fs, fe, n_nf, k0p


def _group_e_sizes(e_sizes: tuple):
    """Contiguous runs of equal E (TS38.212 yields at most two values)."""
    groups = []
    start = 0
    for j in range(1, len(e_sizes) + 1):
        if j == len(e_sizes) or e_sizes[j] != e_sizes[start]:
            groups.append((start, j, e_sizes[start]))
            start = j
    return groups


def _check_n_ref(n_ref: int, n: int) -> None:
    if n_ref and n_ref < n:
        raise NotImplementedError(
            "limited-buffer rate matching (n_ref < N) is not ported yet "
            "(ROADMAP §1 item 13)")


def rate_match_batch(codewords: torch.Tensor, e_sizes, rv: int, qm: int,
                     base_graph: int, z: int, k_prime: int, k: int,
                     n_ref: int = 0) -> torch.Tensor:
    """Rate-match all codeblocks of a TB: int8 [C, N] -> int8 [G]."""
    _, n = codewords.shape
    _check_n_ref(n_ref, n)
    fs, fe, n_nf, k0p = _window_plan(rv, base_graph, z, k_prime, k, n, n_ref)
    nofill = torch.cat([codewords[:, :fs], codewords[:, fe:n]], dim=1)
    outs = []
    for g0, g1, e in _group_e_sizes(tuple(e_sizes)):
        reps = -(-(k0p + e) // n_nf)
        tiled = nofill[g0:g1].repeat(1, reps)
        sel = tiled[:, k0p:k0p + e]
        inter = sel.reshape(g1 - g0, qm, e // qm)
        outs.append(inter.transpose(1, 2).reshape(-1))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def rate_dematch_batch(llrs: torch.Tensor, nof_codeblocks: int, e_sizes,
                       rv: int, qm: int, base_graph: int, z: int,
                       k_prime: int, k: int, n: int, n_ref: int = 0,
                       filler_llr: float = FILLER_LLR) -> torch.Tensor:
    """Inverse of rate_match_batch: f32 [G] -> f32 [C, N], summing
    repetitions in window order and setting filler LLRs."""
    _check_n_ref(n_ref, n)
    fs, fe, n_nf, k0p = _window_plan(rv, base_graph, z, k_prime, k, n, n_ref)
    accs = []
    off = 0
    for g0, g1, e in _group_e_sizes(tuple(e_sizes)):
        cg = g1 - g0
        seg = llrs[off:off + cg * e].reshape(cg, e)
        off += cg * e
        sel = seg.reshape(cg, e // qm, qm).transpose(1, 2).reshape(cg, e)
        reps = -(-(k0p + e) // n_nf)
        buf = llrs.new_zeros((cg, reps * n_nf))
        buf[:, k0p:k0p + e] = sel
        accs.append(buf.reshape(cg, reps, n_nf).sum(dim=1))      # [cg, n_nf]
    acc = torch.cat(accs, dim=0) if len(accs) > 1 else accs[0]
    out = llrs.new_empty((nof_codeblocks, n))
    out[:, :fs] = acc[:, :fs]
    out[:, fe:] = acc[:, fs:]
    out[:, fs:fe] = filler_llr
    return out


def rate_dematch_combine_ref(llrs, nof_codeblocks, e_sizes, rv, qm,
                             base_graph, z, k_prime, k, n,
                             soft_buffer=None):
    """Plain twin of :func:`rate_dematch_combine` (a slot axis runs slot
    by slot)."""
    if llrs.ndim == 2:
        outs = [rate_dematch_combine_ref(
            llrs[b], nof_codeblocks, e_sizes, rv, qm, base_graph, z, k_prime,
            k, n, None if soft_buffer is None else soft_buffer[b])
            for b in range(llrs.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    buf = rate_dematch_batch(llrs, nof_codeblocks, e_sizes, rv, qm,
                             base_graph, z, k_prime, k, n)
    if soft_buffer is not None:
        buf = buf + soft_buffer
    full = torch.cat([buf.new_zeros((nof_codeblocks, 2 * z)), buf], dim=-1)
    return buf, full


def _cb_offsets(e_sizes: tuple, slots: int = 1) -> np.ndarray:
    """int32 [slots * C]: each codeblock's first LLR in the [slots, G]
    codeword LLRs."""
    off = np.concatenate([[0], np.cumsum(e_sizes)[:-1]])
    g = int(np.sum(e_sizes))
    return (np.arange(slots)[:, None] * g + off[None, :]).reshape(-1).astype(
        np.int32)


def _cb_sizes(e_sizes: tuple, slots: int = 1) -> np.ndarray:
    return np.tile(np.asarray(e_sizes, dtype=np.int32), slots)


def rate_dematch_combine(llrs: torch.Tensor, nof_codeblocks: int, e_sizes,
                         rv: int, qm: int, base_graph: int, z: int,
                         k_prime: int, k: int, n: int,
                         soft_buffer: torch.Tensor | None = None):
    """Dematch the codeword LLRs [G] and combine with the HARQ buffer.

    Returns (new_soft f32 [C, N], decoder input f32 [C, 2Z + N]): new_soft
    is the combined circular buffer (the next HARQ state); the decoder input
    prepends the 2Z punctured systematic positions as zero LLRs.  With a
    slot axis -- llrs [S, G], soft buffer [S, C, N] -- the outputs are
    [S, C, N] and [S, C, 2Z + N], from one launch over S * C codeblocks.
    """
    tensors = (llrs,) if soft_buffer is None else (llrs, soft_buffer)
    if not is_cuda(*tensors):
        return rate_dematch_combine_ref(llrs, nof_codeblocks, e_sizes, rv, qm,
                                        base_graph, z, k_prime, k, n,
                                        soft_buffer)
    e_sizes = tuple(int(e) for e in e_sizes)
    lead = tuple(llrs.shape[:-1])
    if len(e_sizes) != nof_codeblocks or any(e % qm for e in e_sizes):
        raise ValueError(f"E sizes {e_sizes} vs C={nof_codeblocks}, Qm={qm}")
    if (llrs.dtype != torch.float32 or len(lead) > 1
            or llrs.shape[-1] != sum(e_sizes)):
        raise ValueError(f"llrs must be f32 [S, {sum(e_sizes)}] or "
                         f"[{sum(e_sizes)}], got {llrs.dtype} "
                         f"{tuple(llrs.shape)}")
    if soft_buffer is not None and (
            soft_buffer.dtype != torch.float32
            or soft_buffer.shape != lead + (nof_codeblocks, n)):
        raise ValueError(f"soft buffer must be f32 {lead + (nof_codeblocks, n)}")
    slots = lead[0] if lead else 1
    fs, fe, n_nf, k0p = _window_plan(rv, base_graph, z, k_prime, k, n)
    dev = llrs.device
    lib = _build.load()
    off = const(_cb_offsets, e_sizes, slots, device=dev)
    es = const(_cb_sizes, e_sizes, slots, device=dev)
    llrs = llrs.contiguous()
    soft = soft_buffer.contiguous() if soft_buffer is not None else None
    new_soft = torch.empty(lead + (nof_codeblocks, n), dtype=torch.float32,
                           device=dev)
    full = torch.empty(lead + (nof_codeblocks, 2 * z + n), dtype=torch.float32,
                       device=dev)
    _build.check(lib.srsran_rate_dematch(
        _build.ptr(llrs), _build.ptr(soft) if soft is not None else None,
        _build.ptr(new_soft), _build.ptr(full), _build.ptr(off),
        _build.ptr(es), slots * nof_codeblocks, n, 2 * z, qm, fs, fe, n_nf,
        k0p, FILLER_LLR, _build.stream_of(llrs)), "rate_dematch")
    (KERNEL_BATCH if lead else KERNEL).count()
    return new_soft, full
