"""Short-block UCI codes (TS38.212 §5.3.3): encode + ML detection.

Port of srsran_tpu/ops/short_block.py: 1-bit repetition, 2-bit simplex and
the Reed-Muller (32, K<=11) code.  Every short-block code is affine over
GF(2) and periodic in the codeword index (period 32 for RM, Qm for K=1,
3 or 3*Qm for K=2), so a codeword is ``ones ^ XOR_i m_i G[i]`` tiled to E.

:func:`detect` is the K14 wrapper: on CUDA tensors the hand kernel of
csrc/short_block.cu (a warp per codeword: the LLRs folded over the code's
period, the 2^K candidates' correlations as Walsh-Hadamard butterflies
over the lanes, no [2^K, E] table), launched through a plan cached per
(K, Qm, E, B, device) with its struct (:func:`_detect_params`) and a
word a lane (:func:`_detect_table`); on CPU tensors its twin
:func:`detect_ref`, the JAX package's correlation against the host
candidate bank.  A slot batch's codewords [B, N, E] fold into one launch.

:func:`encode` (UE side) is the K34 wrapper: on CUDA tensors the encode
kernel of the same source (a warp per codeword: the message packed by a
ballot, one period of the code from a [2, P] table in registers, the
codeword written as 8-byte stores), launched through a plan cached per
(K, Qm, E, B, device) (``kernels/_build.py::Launch``), so a call
allocates its output and makes one C call; on CPU tensors its twin
:func:`encode_ref` (the generator tables' affine map in torch ops).
Either stays on the device of its bits.
"""

from __future__ import annotations

import functools
import itertools
import math
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..device import const
from ..kernels import _build

KERNEL = kernels.register(kernels.Kernel(
    name="short_block_detect", route="cuda",
    source="srsran_tpu_torch/csrc/short_block.cu",
    replaces="srsran_tpu/ops/short_block.py:80"))
KERNEL_BATCH = kernels.batched(KERNEL)
ENCODE_KERNEL = kernels.register(kernels.Kernel(
    name="short_block_encode", route="cuda",
    source="srsran_tpu_torch/csrc/short_block.cu",
    replaces="srsran_tpu/ops/short_block.py:32"))

_DATA = Path(__file__).resolve().parent.parent / "data" / "short_block_tables.npz"
MAX_K = 11
MAX_PERIOD = 64
ENCODE_WARPS = 4            # codewords (warps) a CTA of K34
DETECT_WARPS = 4            # codewords (warps) a CTA of K14


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


def _period_index(e: int, p: int) -> np.ndarray:
    return np.arange(e, dtype=np.int64) % p


def encode_ref(bits: torch.Tensor, e: int, qm: int = 1) -> torch.Tensor:
    """Plain twin of :func:`encode`: codeword = ones ^ (m @ G mod 2), one
    period from the generator tables, tiled to E, on the device of
    ``bits``."""
    dev = bits.device
    k = bits.shape[-1]
    tables = const(_kernel_tables, k, qm, device=dev)            # [2, P]
    w = ((bits.to(torch.int32) & 1)
         << const(_shifts, k, device=dev).to(torch.int32)).sum(dim=-1)
    x = w[:, None] & tables[0][None]                             # [B, P]
    for s in (8, 4, 2, 1):                  # parity of the 11-bit words
        x = x ^ (x >> s)
    code = ((x & 1) ^ tables[1][None]).to(torch.int8)
    return code[:, const(_period_index, e, tables.shape[1], device=dev)]


def _encode_params(k: int, e: int, p: int,
                   b: int) -> _build.ShortBlockEncodeParams:
    """K34's launch for B codewords of K bits, E transmitted bits, a code
    of period P; raises on what the kernel does not take."""
    if not (1 <= k <= MAX_K and 1 <= p <= MAX_PERIOD and b >= 1 and e >= 1):
        raise ValueError(f"K34 takes K 1..{MAX_K}, P 1..{MAX_PERIOD}, B and "
                         f"E >= 1; got K {k}, P {p}, B {b}, E {e}")
    return _build.ShortBlockEncodeParams(b, k, e, p, min(b, ENCODE_WARPS))


@functools.lru_cache(maxsize=256)
def _encode_plan(k: int, qm: int, e: int, b: int,
                 index: int) -> _build.Launch:
    """K34's launch for B codewords of K bits to E at Qm on CUDA device
    ``index``, with its period table."""
    table = torch.from_numpy(_kernel_tables(k, qm, False)).to(
        torch.device("cuda", index))
    return _build.Launch("srsran_short_block_encode", index,
                         _encode_params(k, e, table.shape[1], b), (table,))


def encode(bits: torch.Tensor, e: int, qm: int = 1) -> torch.Tensor:
    """Encode [B, K] (K<=11) -> int8 [B, E], on the device of ``bits``.

    K=1: c = [b, y(=b), ...] repeated to E with Qm-spaced placeholders.
    K=2: c = [b0, b1, b0^b1] (+ placeholders for Qm>1), cycled to E.
    K>=3: RM(32,K) then repeated to E.
    """
    if not bits.is_cuda:
        return encode_ref(bits, e, qm)
    if bits.ndim != 2:
        raise ValueError(f"bits must be [B, K], got {tuple(bits.shape)}")
    b, k = bits.shape
    launch = _encode_plan(k, qm, e, b, bits.get_device())
    if bits.dtype is not torch.int8 or not bits.is_contiguous():
        bits = bits.to(torch.int8).contiguous()
    out = bits.new_empty(b, e)
    launch(bits.data_ptr(), out.data_ptr())
    ENCODE_KERNEL.count()
    return out


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


def _kernel_tables(k: int, qm: int, msb_first: bool = True) -> np.ndarray:
    """int32 [2, P]: per codeword position r < P, the bit mask of the
    message bits that flip it, and its placeholder/offset bit.  Message
    bit i is bit K-1-i of the mask with ``msb_first`` (K14's candidate
    index, as the candidate bank orders them), else bit i (K34's word, as
    its ballot packs the message)."""
    ones, gen = _generator_np(k, qm)
    weights = (1 << (np.arange(k - 1, -1, -1) if msb_first
                     else np.arange(k))).astype(np.int64)
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
    """Plain twin of :func:`detect`: correlation with the candidate bank
    (a slot axis folds into the codeword axis)."""
    if llrs.ndim == 3:
        bits, metric = detect_ref(llrs.reshape(-1, llrs.shape[-1]), k, qm)
        return (bits.reshape(llrs.shape[:2] + (k,)),
                metric.reshape(llrs.shape[:2]))
    dev = llrs.device
    e = llrs.shape[-1]
    cands_t = const(_candidates_t, k, e, qm, device=dev)       # [E, 2^K]
    corr = torch.matmul(llrs, cands_t)
    best = torch.argmax(corr, dim=-1)
    bits = ((best[:, None] >> const(_shifts, k, device=dev)) & 1).to(torch.int8)
    norm = torch.linalg.norm(llrs, dim=-1) * float(np.sqrt(np.float32(e))) + 1e-9
    metric = torch.gather(corr, 1, best[:, None])[:, 0] / norm
    return bits, metric


def _fold_period(p: int) -> int:
    """K14's fold period for a code of period ``p`` <= 32: as many whole
    periods as fit in a warp's 32 lanes."""
    return p * (32 // p)


def _lane_bits(k: int) -> int:
    """The candidate bits K14 spreads over the lanes: those of the RM
    basis rows 1..5 (at most K - 1 of them) for K >= 3, none for K <= 2."""
    return min(5, k - 1) if k >= 3 else 0


def _k_split(k: int) -> tuple:
    """(s, t) of K14's loop index: candidate c = ((j >> s) << t) | (j & (2^s
    - 1)) | the lane's part, for loop index j < 2^(K - lane bits) -- the
    bits of row 0 (the all-ones row) and of rows 6..K-1 for K >= 6, of row
    0 for K 3..5, all K bits for K <= 2."""
    if k >= 6:
        return k - 6, k - 1
    if k >= 3:
        return 0, k - 1
    return k, k


def _detect_table(k: int, qm: int) -> np.ndarray:
    """K14's word a lane, int32 [32]: the lane's source lane (bits 0-4) and
    whether it has one (5), the placeholder bit of the lane's own fold
    position (6), whether the lane holds candidates (7), the source
    position's mask bits read by the loop index (8-15, ``_k_split``'s
    order) and the lane's part of the candidate index (16-26).  For K >= 3
    lane l takes the position whose RM rows 1..5 spell l (a permutation of
    the 32: so the lane part of every correlation is one Walsh-Hadamard
    transform over the lanes); for K <= 2 its own position."""
    masks, ones = _kernel_tables(k, qm).astype(np.int64)
    period = masks.shape[0]
    q = _fold_period(period)
    nl = _lane_bits(k)
    s, t = _k_split(k)
    if k >= 3:
        rows = rm_basis()[1:6].astype(np.int64)                 # [5, 32]
        spell = (rows << np.arange(5)[:, None]).sum(axis=0)
        src = np.argsort(spell)                      # lane l <- position
    else:
        src = np.arange(32)
    lane = np.arange(32)
    valid = src < q
    mask = np.where(valid, masks[src % period], 0)
    kmask = ((mask >> t) << s) | (mask & ((1 << s) - 1))
    part = sum(((lane >> j) & 1) << (k - 2 - j) for j in range(nl))
    own = np.where(lane < q, ones[lane % period], 0)
    word = ((src & 31) | valid << 5 | own << 6 | (lane < (1 << nl)) << 7
            | kmask << 8 | np.asarray(part) << 16)
    return word.astype(np.int32)


def _detect_params(k: int, qm: int, e: int,
                   b: int) -> _build.ShortBlockDetectParams:
    """K14's launch for B codewords of E LLRs of a K-bit code at Qm (its
    lane words: :func:`_detect_table`); raises on what the kernel does not
    take."""
    if not (1 <= k <= MAX_K and b >= 1 and e >= 1):
        raise ValueError(f"K14 takes K 1..{MAX_K}, B and E >= 1; got K {k}, "
                         f"B {b}, E {e}")
    if b * e >= 1 << 31:
        raise ValueError("K14 takes at most 2^31 LLRs a call (32-bit "
                         "offsets)")
    period = _period(k, qm)
    if period > _build.SB_MAX_PERIOD:
        raise ValueError(f"short-block period {period}: K14 takes at most "
                         f"{_build.SB_MAX_PERIOD}")
    s, t = _k_split(k)
    return _build.ShortBlockDetectParams(
        B=b, K=k, E=e, Q=_fold_period(period), warps=min(b, DETECT_WARPS),
        nk=1 << (k - _lane_bits(k)), ks=s, kt=t,
        sqrt_e=float(np.sqrt(np.float32(e))))


@functools.lru_cache(maxsize=256)
def _detect_plan(k: int, qm: int, e: int, b: int,
                 index: int) -> _build.Launch:
    """K14's launch for B codewords of E LLRs of a K-bit code at Qm on CUDA
    device ``index``."""
    table = torch.from_numpy(_detect_table(k, qm)).to(
        torch.device("cuda", index))
    return _build.Launch("srsran_short_block_detect", index,
                         _detect_params(k, qm, e, b), (table,))


def detect(llrs: torch.Tensor, k: int, qm: int = 1) -> tuple:
    """ML detection.  llrs f32 [B, E] -> (bits int8 [B, K], metric f32 [B]):
    the first candidate of largest correlation (ties to the lower index)
    and its correlation over ||llr|| sqrt(E).  A slot batch's llrs
    [S, B, E] give [S, B, K] and [S, B] from one launch."""
    if not llrs.is_cuda:
        return detect_ref(llrs, k, qm)
    if llrs.dtype != torch.float32 or llrs.ndim not in (2, 3):
        raise ValueError(f"llrs must be float32 [(S,) B, E], got "
                         f"{llrs.dtype} {tuple(llrs.shape)}")
    lead = tuple(llrs.shape[:-1])
    launch = _detect_plan(k, qm, llrs.shape[-1], math.prod(lead),
                          llrs.get_device())
    # the kernel's input held in a local until it is enqueued
    x = llrs if llrs.is_contiguous() else llrs.contiguous()
    bits = x.new_empty(lead + (k,), dtype=torch.int8)
    metric = x.new_empty(lead)
    launch(x.data_ptr(), bits.data_ptr(), metric.data_ptr())
    (KERNEL_BATCH if len(lead) > 1 else KERNEL).count()
    return bits, metric
