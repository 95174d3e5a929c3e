"""LDPC rate matching / dematching (TS38.212 §5.4.2), window form.

Port of srsran_tpu/ops/ldpc_rate_match.py.  Bit selection is a circular
contiguous window over the filler-free circular buffer (start k0'), so both
directions use the one geometry of :func:`_window_plan`; the JAX package's
second, environment-selected formulation is not carried.  Limited-buffer
rate matching (``n_ref`` < N) cuts the circular buffer at n_cb = n_ref:
the window and the filler range stay inside it, and the dematched
columns n_cb .. N-1 hold 0 (JAX ldpc_rate_match.py:147, :190-202).

:func:`rate_dematch_combine` is the K2 wrapper: on CUDA tensors the
dematch, the HARQ soft-buffer add and the decoder-input layout (2Z zero
prefix) are one pass of csrc/rate_dematch.cu; on CPU tensors it runs
:func:`rate_dematch_combine_ref`, the plain twin.  It replaces
srsran_tpu/ops/ldpc_rate_match.py::rate_dematch_batch with the soft add
and prefix of phy/upper/sch_decoder.py::decode; on the card it is a pure
memory pass (about 10 MB at the flagship).

:func:`rate_match_batch` and the single-codeblock :func:`rate_match` are
the K32 wrapper: on CUDA tensors csrc/rate_match.cu (a thread per output
bit: its window index, the filler gap and the Qm-row interleave), launched
through a plan cached per call signature (``kernels/_build.py::Launch``),
so a call allocates its output and makes one C call; on CPU tensors
:func:`rate_match_batch_ref`, the plain twin.  The single-codeblock
:func:`rate_dematch` runs K2 with one codeblock per row and no soft buffer.
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
KERNEL_RM = kernels.register(kernels.Kernel(
    name="rate_match", route="cuda",
    source="srsran_tpu_torch/csrc/rate_match.cu",
    replaces="srsran_tpu/ops/ldpc_rate_match.py:53"))

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


def rate_match_batch_ref(codewords: torch.Tensor, e_sizes, rv: int, qm: int,
                         base_graph: int, z: int, k_prime: int, k: int,
                         n_ref: int = 0) -> torch.Tensor:
    """Plain twin of :func:`rate_match_batch`."""
    _, n = codewords.shape
    fs, fe, n_nf, k0p = _window_plan(rv, base_graph, z, k_prime, k, n, n_ref)
    n_cb = n_nf + fe - fs
    nofill = torch.cat([codewords[:, :fs], codewords[:, fe:n_cb]], dim=1)
    outs = []
    for g0, g1, e in _group_e_sizes(tuple(e_sizes)):
        reps = -(-(k0p + e) // n_nf)
        tiled = nofill[g0:g1].repeat(1, reps)
        sel = tiled[:, k0p:k0p + e]
        inter = sel.reshape(g1 - g0, qm, e // qm)
        outs.append(inter.transpose(1, 2).reshape(-1))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def gather_index(e_sizes, rv: int, qm: int, base_graph: int, z: int,
                 k_prime: int, k: int, n: int, n_ref: int = 0) -> np.ndarray:
    """int64 [G]: each output bit's flat index into the codewords [C, N],
    csrc/rate_match.cu's index math on the host."""
    fs, fe, n_nf, k0p = _window_plan(rv, base_graph, z, k_prime, k, n, n_ref)
    parts = []
    for c, e in enumerate(e_sizes):
        i = np.arange(e)
        q = (k0p + (i % qm) * (e // qm) + i // qm) % n_nf
        parts.append(np.where(q >= fs, q + fe - fs, q) + c * n)
    return np.concatenate(parts)


def _rate_match_params(e_sizes: tuple, rv: int, qm: int, base_graph: int,
                       z: int, k_prime: int, k: int, n_ref: int,
                       shape: tuple, dtype: torch.dtype) -> tuple:
    """K32's parameters for one call signature and its output length G:
    the window plan and the codeblocks' (first output bit, E) as runs of
    equal E; raises on what the kernel does not take."""
    e_sizes = tuple(int(e) for e in e_sizes)
    runs = _group_e_sizes(e_sizes)
    if (dtype != torch.int8 or len(shape) != 2 or shape[0] != len(e_sizes)
            or any(e < 1 or e % qm for e in e_sizes)):
        raise ValueError(f"codewords must be int8 [C, N] with C = "
                         f"{len(e_sizes)} E sizes divisible by Qm={qm}, got "
                         f"{dtype} {tuple(shape)} {e_sizes}")
    if len(runs) > _build.RM_MAX_RUNS:
        raise ValueError(f"{len(runs)} runs of equal E, more than "
                         f"{_build.RM_MAX_RUNS} (TS38.212 gives at most 2)")
    c, n = shape
    fs, fe, n_nf, k0p = _window_plan(rv, base_graph, z, k_prime, k, n, n_ref)
    p = _build.RateMatchParams(c, n, max(e_sizes), qm, fs, fe, n_nf, k0p,
                               len(runs))
    off = 0
    for i, (_, g1, e) in enumerate(runs):
        p.run_end[i], p.run_e[i], p.run_off[i] = g1, e, off
        off += (g1 - runs[i][0]) * e
    return p, off


@functools.lru_cache(maxsize=1024)
def _rate_match_plan(e_sizes: tuple, rv: int, qm: int, base_graph: int,
                     z: int, k_prime: int, k: int, n_ref: int, shape: tuple,
                     dtype: torch.dtype, index: int) -> tuple:
    """K32's launch for one call signature on CUDA device ``index`` and
    its output length G."""
    p, g = _rate_match_params(e_sizes, rv, qm, base_graph, z, k_prime, k,
                              n_ref, shape, dtype)
    return _build.Launch("srsran_rate_match", index, p), g


def rate_match_batch(codewords: torch.Tensor, e_sizes, rv: int, qm: int,
                     base_graph: int, z: int, k_prime: int, k: int,
                     n_ref: int = 0) -> torch.Tensor:
    """Rate-match all codeblocks of a TB: int8 [C, N] -> int8 [G] (each
    codeblock's E_c bits in turn).  On the card one K32 launch through the
    cached plan of the call's signature."""
    if not codewords.is_cuda:
        return rate_match_batch_ref(codewords, e_sizes, rv, qm, base_graph, z,
                                    k_prime, k, n_ref)
    launch, g = _rate_match_plan(
        e_sizes if type(e_sizes) is tuple else tuple(e_sizes), rv, qm,
        base_graph, z, k_prime, k, n_ref, codewords.shape, codewords.dtype,
        codewords.get_device())
    cw = codewords if codewords.is_contiguous() else codewords.contiguous()
    out = cw.new_empty(g)
    launch(cw.data_ptr(), out.data_ptr())
    KERNEL_RM.count()
    return out


def rate_match(codeword: torch.Tensor, e: int, rv: int, qm: int,
               base_graph: int, z: int, k_prime: int, k: int,
               n_ref: int = 0) -> torch.Tensor:
    """Select and interleave E bits from each codeword: int8 [B, N] (the 2Z
    punctured bits already removed) -> int8 [B, E] (JAX
    ldpc_rate_match.py:53)."""
    b = codeword.shape[0]
    return rate_match_batch(codeword, (e,) * b, rv, qm, base_graph, z,
                            k_prime, k, n_ref).reshape(b, e)


def rate_dematch_batch(llrs: torch.Tensor, nof_codeblocks: int, e_sizes,
                       rv: int, qm: int, base_graph: int, z: int,
                       k_prime: int, k: int, n: int, n_ref: int = 0,
                       filler_llr: float = FILLER_LLR) -> torch.Tensor:
    """Inverse of rate_match_batch: f32 [G] -> f32 [C, N], summing
    repetitions in window order and setting filler LLRs; the columns past
    the limited buffer (n_cb .. N-1) hold 0."""
    fs, fe, n_nf, k0p = _window_plan(rv, base_graph, z, k_prime, k, n, n_ref)
    n_cb = n_nf + fe - fs
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
        buf = buf.reshape(cg, reps, n_nf)
        acc = buf[:, 0]
        for r in range(1, reps):        # in window order, as K2 sums them
            acc = acc + buf[:, r]
        accs.append(acc)                                         # [cg, n_nf]
    acc = torch.cat(accs, dim=0) if len(accs) > 1 else accs[0]
    out = llrs.new_zeros((nof_codeblocks, n))
    out[:, :fs] = acc[:, :fs]
    out[:, fe:n_cb] = acc[:, fs:]
    out[:, fs:fe] = filler_llr
    return out


def rate_dematch_combine_ref(llrs, nof_codeblocks, e_sizes, rv, qm,
                             base_graph, z, k_prime, k, n,
                             soft_buffer=None, n_ref: int = 0):
    """Plain twin of :func:`rate_dematch_combine` (a slot axis runs slot
    by slot)."""
    if llrs.ndim == 2:
        outs = [rate_dematch_combine_ref(
            llrs[b], nof_codeblocks, e_sizes, rv, qm, base_graph, z, k_prime,
            k, n, None if soft_buffer is None else soft_buffer[b], n_ref)
            for b in range(llrs.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    buf = rate_dematch_batch(llrs, nof_codeblocks, e_sizes, rv, qm,
                             base_graph, z, k_prime, k, n, n_ref)
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
                         soft_buffer: torch.Tensor | None = None,
                         n_ref: int = 0):
    """Dematch the codeword LLRs [G] and combine with the HARQ buffer
    (``n_ref``: the limited buffer's length, 0 for the full N).

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
                                        soft_buffer, n_ref)
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
    fs, fe, n_nf, k0p = _window_plan(rv, base_graph, z, k_prime, k, n, n_ref)
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


def rate_dematch(llrs: torch.Tensor, rv: int, qm: int, base_graph: int,
                 z: int, k_prime: int, k: int, n: int, n_ref: int = 0,
                 filler_llr: float = FILLER_LLR) -> torch.Tensor:
    """Inverse of :func:`rate_match`: f32 [B, E] -> f32 [B, N] (JAX
    ldpc_rate_match.py:206), each row one codeblock through K2 with no soft
    buffer (its twin on the CPU).  Repetitions are summed in window order,
    where JAX's scatter adds them in the interleaved stream's order: with
    three or more copies of a position the float32 sums may differ in
    their last bits.  Filler positions [k' - 2Z, k - 2Z) get
    ``filler_llr``."""
    b, e = llrs.shape
    soft, _ = rate_dematch_combine(llrs.reshape(-1), b, (e,) * b, rv, qm,
                                   base_graph, z, k_prime, k, n, n_ref=n_ref)
    fs, fe = k_prime - 2 * z, k - 2 * z
    if fe > fs:          # JAX sets the whole range, past n_cb too
        soft[:, fs:fe] = filler_llr
    return soft
