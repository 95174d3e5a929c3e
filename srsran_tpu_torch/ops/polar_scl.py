"""CA-SCL polar list decoding (K29), batched.

Port of srsran_tpu/ops/polar_scl.py::scl_decode: successive-cancellation
list decoding with list size L over the whole decode tree (every leaf, no
Rate-0 / Rate-1 pruning: the frozen leaves add their penalties to the path
metrics), path splits as the best L of the 2L candidates ordered by
(metric, candidate index), and at the end the best-metric path, or with
``crc_poly`` the best path whose trailing CRC passes (CA-SCL).

:func:`scl_decode` is the K29 wrapper: on CUDA tensors one launch of
csrc/polar_scl.cu (a CTA per codeword, a warp per path, the paths' LLR and
partial-sum trees in shared memory, walking a host-built leaf-by-leaf
schedule); on CPU tensors :func:`scl_decode_ref`, the plain twin, which
follows the JAX recursion op for op (its live set of ancestor arrays
gathered by the survivors at every split).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build
from ..ran.polar_params import PolarCode
from .crc import POLYS, crc_check
from .polar import _code_keys, _pc_sources, _readout

KERNEL = kernels.register(kernels.Kernel(
    name="polar_scl_decode", route="cuda",
    source="srsran_tpu_torch/csrc/polar_scl.cu",
    replaces="srsran_tpu/ops/polar_scl.py:35"))

MAX_LIST = 8             # csrc/polar_scl.cu: a warp per path, 8 warps
MAX_N = 1024
DEAD_METRIC = 1e30       # paths 1..L-1 before the first split
CRC_FAIL_PENALTY = 1e20  # added to a failing path's metric at selection


def _f(a, b):
    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


def _g(a, b, x):
    return b + (1.0 - 2.0 * x) * a


def _pcs(code: PolarCode) -> tuple:
    """((PC position, its sources), ...) of the code; () without PC bits."""
    if not code.n_pc:
        return ()
    return _pc_sources(code.big_n, tuple(code.pc_set.tolist()),
                       tuple(code.info_set.tolist()))


def scl_decode_ref(llrs: torch.Tensor, code: PolarCode, list_size: int = 8,
                   crc_poly: str | None = None) -> tuple:
    """Plain twin of :func:`scl_decode` (the JAX recursion, op for op)."""
    frozen = code.frozen_mask.astype(bool)
    batch, big_l, dev = llrs.shape[0], list_size, llrs.device
    pc_sources = dict(_pcs(code))
    pm = torch.zeros((batch, big_l), dtype=torch.float32, device=dev)
    pm[:, 1:] = DEAD_METRIC
    state = dict(pm=pm, u=torch.zeros((batch, big_l, code.big_n),
                                      dtype=torch.float32, device=dev),
                 live=[], pos=0)

    def take(arr, idx):
        return torch.gather(arr, 1, idx.reshape(
            idx.shape + (1,) * (arr.ndim - 2)).expand(arr.shape))

    def leaf(llr):
        pos = state["pos"]
        state["pos"] += 1
        if frozen[pos] or pos in pc_sources:
            src = pc_sources.get(pos, ())
            if src:
                idx = torch.as_tensor(src, dtype=torch.int64, device=dev)
                bit = torch.remainder(state["u"][:, :, idx].sum(dim=-1), 2.0)
            else:
                bit = torch.zeros_like(llr)
            mismatch = torch.where(bit > 0.5, llr > 0, llr < 0)
            state["pm"] = state["pm"] + torch.where(mismatch, llr.abs(),
                                                    torch.zeros_like(llr))
            state["u"][:, :, pos] = bit
            return bit
        zero = torch.zeros_like(llr)
        pen0 = torch.where(llr < 0, llr.abs(), zero)
        pen1 = torch.where(llr > 0, llr.abs(), zero)
        cand = torch.cat([state["pm"] + pen0, state["pm"] + pen1], dim=1)
        # the best L by (metric, candidate index), as jax.lax.top_k orders
        # ties (the lower index first)
        metric, idx2 = torch.sort(cand, dim=1, stable=True)
        idx2 = idx2[:, :big_l]
        src = idx2 % big_l
        bit = (idx2 >= big_l).to(torch.float32)
        state["pm"] = metric[:, :big_l].contiguous()
        state["u"] = take(state["u"], src)
        state["live"] = [take(a, src) for a in state["live"]]
        state["u"][:, :, pos] = bit
        return bit

    def rec(seg, fro):
        m = seg.shape[-1]
        if m == 1:
            return leaf(seg[..., 0])[..., None]
        h = m // 2
        live = state["live"]
        live.append(seg[..., :h])
        live.append(seg[..., h:])
        a, b = seg[..., :h], seg[..., h:]
        x_left = rec(_f(a, b), fro[:h])
        live = state["live"]
        b2 = live.pop()
        a2 = live.pop()
        live.append(x_left)
        x_right = rec(_g(a2, b2, x_left), fro[h:])
        x_left2 = state["live"].pop()
        return torch.cat([(x_left2 - x_right).abs(), x_right], dim=-1)

    seg0 = llrs.to(torch.float32)[:, None, :].expand(
        batch, big_l, code.big_n).contiguous()
    rec(seg0, frozen)

    readout = const(_readout, *_code_keys(code)["readout"], device=dev)
    msgs = state["u"][:, :, readout].to(torch.int8)               # [B, L, K]
    pm = state["pm"]
    if crc_poly is not None:
        ok = crc_check(msgs.reshape(batch * big_l, -1), crc_poly).reshape(
            batch, big_l)
        best = torch.argmin(torch.where(ok, pm, pm + CRC_FAIL_PENALTY), dim=1)
        any_ok = ok.any(dim=1)
    else:
        best = torch.argmin(pm, dim=1)
        any_ok = torch.ones(batch, dtype=torch.bool, device=dev)
    out = torch.gather(msgs, 1, best[:, None, None].expand(
        batch, 1, msgs.shape[-1]))[:, 0]
    return out, any_ok


# ------------------------------------------------------------------ K29

_OP_F, _OP_G, _OP_SAVE, _OP_COMB, _OP_FROZEN, _OP_INFO, _OP_PC = range(7)


@functools.lru_cache(maxsize=None)
def _scl_program(frozen: bytes, pc: tuple) -> np.ndarray:
    """The leaf-by-leaf schedule of :func:`scl_decode_ref`'s recursion for
    the kernel: int32 [n_ops, 3] rows (op, log2 m, first u index) with F /
    G (the LLRs of a length-m node's left / right child), SAVE (keep the
    left child's bits), COMB (x of the node from both children) and one
    leaf row per position: FROZEN, INFO, or PC (its second column the PC
    bit's index in the source table)."""
    fro = np.frombuffer(frozen, dtype=np.uint8).astype(bool)
    pc_index = {pos: j for j, (pos, _) in enumerate(pc)}
    ops = []

    def rec(lo: int, m: int):
        if m == 1:
            if lo in pc_index:
                ops.append((_OP_PC, pc_index[lo], lo))
            else:
                ops.append((_OP_FROZEN if fro[lo] else _OP_INFO, 0, lo))
            return
        lg = int(m).bit_length() - 1
        h = m // 2
        ops.append((_OP_F, lg, lo))
        rec(lo, h)
        ops.append((_OP_SAVE, lg, lo))
        ops.append((_OP_G, lg, lo))
        rec(lo + h, h)
        ops.append((_OP_COMB, lg, lo))

    rec(0, len(fro))
    return np.asarray(ops, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _pc_table(pc: tuple) -> np.ndarray:
    """int32 [n_pc + 1 + sources]: each PC bit's first source in the list
    that follows the n_pc + 1 offsets (CSR), then the source positions."""
    starts = np.cumsum([0] + [len(s) for _, s in pc]) + len(pc) + 1
    srcs = [p for _, s in pc for p in s]
    return np.asarray(list(starts) + srcs, dtype=np.int32)


def scl_decode(llrs: torch.Tensor, code: PolarCode, list_size: int = 8,
               crc_poly: str | None = None) -> tuple:
    """Decode mother-codeword LLRs f32 [B, N] (LLR > 0 -> bit 0).

    Returns (msg int8 [B, K], ok bool [B]): with ``crc_poly`` the most
    likely path whose trailing CRC passes (``ok``: any path passed);
    otherwise the best-metric path (``ok`` all true).  The message includes
    its CRC bits (K = code.k)."""
    if not is_cuda(llrs):
        return scl_decode_ref(llrs, code, list_size, crc_poly)
    if (llrs.dtype != torch.float32 or llrs.ndim != 2
            or llrs.shape[1] != code.big_n or code.big_n > MAX_N):
        raise ValueError(f"llrs must be float32 [B, {code.big_n}] with N <= "
                         f"{MAX_N}, got {llrs.dtype} {tuple(llrs.shape)}")
    if not 1 <= list_size <= MAX_LIST:
        raise ValueError(f"list size {list_size} outside 1..{MAX_LIST}")
    dev = llrs.device
    b = llrs.shape[0]
    pc = _pcs(code)
    keys = _code_keys(code)
    program = const(_scl_program, *keys["program"], pc, device=dev)
    pc_table = const(_pc_table, pc, device=dev)
    readout = const(_readout, *keys["readout"], device=dev,
                    dtype=torch.int32)
    crc_len, poly = POLYS[crc_poly] if crc_poly is not None else (0, 0)
    llrs = llrs.contiguous()
    bits = torch.empty((b, code.k), dtype=torch.int8, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    lib = _build.load()
    _build.check(lib.srsran_polar_scl(
        _build.ptr(llrs), b, code.n, list_size, _build.ptr(program),
        program.shape[0], _build.ptr(pc_table), _build.ptr(readout), code.k,
        crc_len, poly, _build.ptr(bits), _build.ptr(ok),
        _build.stream_of(llrs)), "polar_scl_decode")
    KERNEL.count()
    return bits, ok
