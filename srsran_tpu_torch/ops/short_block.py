"""Short-block UCI codes (TS38.212 §5.3.3): encode + ML detection.

Port of srsran_tpu/ops/short_block.py: 1-bit repetition, 2-bit simplex and
the Reed-Muller (32, K<=11) code.  Every short-block code is affine over
GF(2) and periodic in the codeword index (period 32 for RM, Qm for K=1,
3 or 3*Qm for K=2), so a codeword is ``ones ^ XOR_i m_i G[i]`` tiled to E.

:func:`detect` is the K14 wrapper: on CUDA tensors the hand kernel of
csrc/short_block.cu (one block per codeword, threads over the 2^K
candidates, each built from the generator bits: no [2^K, E] table); on CPU
tensors its twin :func:`detect_ref`, the JAX package's correlation against
the host candidate bank.  :func:`encode` (UE side) is plain.
"""

from __future__ import annotations

import functools
import itertools
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build

KERNEL = kernels.register(kernels.Kernel(
    name="short_block_detect", route="cuda",
    source="srsran_tpu_torch/csrc/short_block.cu",
    replaces="srsran_tpu/ops/short_block.py:80"))

_DATA = Path(__file__).resolve().parent.parent / "data" / "short_block_tables.npz"
MAX_K = 11
MAX_PERIOD = 64


@functools.lru_cache(maxsize=None)
def rm_basis() -> np.ndarray:
    return np.load(_DATA)["rm_basis"]  # int8 [11, 32]


def _encode_np(bits: np.ndarray, e: int, qm: int) -> np.ndarray:
    """Host encoder: [B, K] (K <= 11) -> int8 [B, E] (the JAX ``encode``)."""
    k = bits.shape[-1]
    b = bits.astype(np.int8)
    if k >= 3:
        code = ((b.astype(np.int32) @ rm_basis()[:k].astype(np.int32)) & 1
                ).astype(np.int8)
        return np.tile(code, (1, -(-e // 32)))[:, :e]
    if k == 1:
        # TS38.212 Table 5.3.3.1-1: [b, y, ...] with Qm-1 placeholders; the
        # placeholder y repeats b (so QPSK carries b twice).
        sym = np.concatenate([b, np.tile(b, (1, qm - 1))], -1) if qm > 1 else b
        return np.tile(sym, (1, -(-e // qm)))[:, :e]
    # k == 2, Table 5.3.3.1-2: c = [b0, b1, b2=b0^b1] with placeholders.
    b2 = b[:, 0:1] ^ b[:, 1:2]
    if qm == 1:
        base = np.concatenate([b, b2], axis=-1)
    else:
        ones = np.ones_like(b[:, :1])
        g0 = np.concatenate([b[:, 0:1], b[:, 1:2], np.tile(ones, (1, qm - 2))], -1)
        g1 = np.concatenate([b2, b[:, 0:1], np.tile(ones, (1, qm - 2))], -1)
        g2 = np.concatenate([b[:, 1:2], b2, np.tile(ones, (1, qm - 2))], -1)
        base = np.concatenate([g0, g1, g2], axis=-1)
    return np.tile(base, (1, -(-e // base.shape[-1])))[:, :e]


def encode(bits: torch.Tensor, e: int, qm: int = 1) -> torch.Tensor:
    """Encode [B, K] (K<=11) -> int8 [B, E] (UE side: encoded on the host,
    returned on the device of ``bits``).

    K=1: c = [b, y(=b), ...] repeated to E with Qm-spaced placeholders.
    K=2: c = [b0, b1, b0^b1] (+ placeholders for Qm>1), cycled to E.
    K>=3: RM(32,K) then repeated to E.
    """
    return torch.as_tensor(_encode_np(bits.cpu().numpy(), e, qm)).to(
        bits.device)


def _period(k: int, qm: int) -> int:
    if k >= 3:
        return 32
    if k == 1:
        return qm
    return 3 if qm == 1 else 3 * qm


@functools.lru_cache(maxsize=None)
def _generator_np(k: int, qm: int) -> tuple:
    """(ones uint8 [P], G uint8 [K, P]): one period of the affine code,
    codeword = ones ^ (m @ G mod 2), read off the host encoder."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"short-block codes carry 1..{MAX_K} bits, not {k}")
    p = _period(k, qm)
    zero = _encode_np(np.zeros((1, k), np.int8), p, qm)[0]
    unit = _encode_np(np.eye(k, dtype=np.int8), p, qm)
    return zero.astype(np.uint8), (unit ^ zero[None]).astype(np.uint8)


def _kernel_tables(k: int, qm: int) -> np.ndarray:
    """int32 [2, P]: per codeword position r < P, the candidate-index bit
    mask of the message bits that flip it (message bit i is bit K-1-i of
    the candidate index, as the candidate bank orders them), and its
    placeholder/offset bit."""
    ones, gen = _generator_np(k, qm)
    weights = (1 << np.arange(k - 1, -1, -1)).astype(np.int64)
    masks = (gen.astype(np.int64) * weights[:, None]).sum(axis=0)
    return np.stack([masks, ones.astype(np.int64)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _candidates(k: int, e: int, qm: int) -> np.ndarray:
    """All 2^K codewords as +-1 rows: [2^K, E] (+1 for bit 0)."""
    msgs = np.array(list(itertools.product([0, 1], repeat=k)), dtype=np.int8)
    return (1.0 - 2.0 * _encode_np(msgs, e, qm)).astype(np.float32)


def _candidates_t(k: int, e: int, qm: int) -> np.ndarray:
    return np.ascontiguousarray(_candidates(k, e, qm).T)


def _shifts(k: int) -> np.ndarray:
    return np.arange(k - 1, -1, -1, dtype=np.int64)


def detect_ref(llrs: torch.Tensor, k: int, qm: int = 1) -> tuple:
    """Plain twin of :func:`detect`: correlation with the candidate bank."""
    dev = llrs.device
    e = llrs.shape[-1]
    cands_t = const(_candidates_t, k, e, qm, device=dev)       # [E, 2^K]
    corr = torch.matmul(llrs, cands_t)
    best = torch.argmax(corr, dim=-1)
    bits = ((best[:, None] >> const(_shifts, k, device=dev)) & 1).to(torch.int8)
    norm = torch.linalg.norm(llrs, dim=-1) * float(np.sqrt(np.float32(e))) + 1e-9
    metric = torch.gather(corr, 1, best[:, None])[:, 0] / norm
    return bits, metric


def detect(llrs: torch.Tensor, k: int, qm: int = 1) -> tuple:
    """ML detection.  llrs f32 [B, E] -> (bits int8 [B, K], metric f32 [B]):
    the first candidate of largest correlation (ties to the lower index)
    and its correlation over ||llr|| sqrt(E)."""
    if not is_cuda(llrs):
        return detect_ref(llrs, k, qm)
    if llrs.dtype != torch.float32 or llrs.ndim != 2:
        raise ValueError(f"llrs must be float32 [B, E], got {llrs.dtype} "
                         f"{tuple(llrs.shape)}")
    dev = llrs.device
    b, e = llrs.shape
    tables = const(_kernel_tables, k, qm, device=dev)
    period = tables.shape[1]
    if period > MAX_PERIOD:
        raise ValueError(f"short-block period {period} > {MAX_PERIOD}")
    llrs = llrs.contiguous()
    bits = torch.empty((b, k), dtype=torch.int8, device=dev)
    metric = torch.empty((b,), dtype=torch.float32, device=dev)
    lib = _build.load()
    _build.check(lib.srsran_short_block_detect(
        _build.ptr(llrs), b, e, k, period, _build.ptr(tables),
        _build.ptr(bits), _build.ptr(metric), _build.stream_of(llrs)),
        "short_block_detect")
    KERNEL.count()
    return bits, metric
