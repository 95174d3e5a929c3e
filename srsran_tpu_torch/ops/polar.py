"""Polar encode / rate (de)matching / SC decode (TS38.212 §5.3.1, §5.4.1).

Port of srsran_tpu/ops/polar.py.  Host side: the GF(2) matrix M [K, E] of
the whole encode chain (``rate_match(encode(allocate(msg))) == msg @ M mod
2`` for codes without PC bits; the PDCCH and PBCH chains fold it into their
affine maps) and the rate-matching index plans.  Device side: the UE-side
encoder steps (:func:`allocate` with PC bits, :func:`encode`,
:func:`rate_match`, plain, under the JAX names), and the receiver's
:func:`rate_dematch` and :func:`sc_decode` (plain, the JAX package's
tree-pruned simplified SC, node classes RATE_0 / RATE_1 / RATE_R of
polar_decoder_impl.h:36-143).

:func:`encode_chain` is the K33 wrapper, the whole chain the callers use
(message bits int8 [B, K] -> transmitted bits int8 [B, E]): on CUDA tensors
one launch of csrc/polar_encode.cu (a warp per codeword and up to 512
transmitted bits, u packed 32 bits a lane, host tables of each position's
message source, the PC bits' source masks and the rate-match gather),
through a plan cached per (code, message shape, device)
(``kernels/_build.py::Launch``), so a call allocates its output and makes
one C call; on CPU tensors its twin :func:`encode_chain_ref` (the three
steps).

:func:`decode` is the K15 wrapper: rate dematch, SC decode and the CRC
check of the decoded message, on CUDA tensors in one launch of
csrc/polar_sc.cu (a warp per codeword, several a CTA: the node schedule
as one word a step by value, :func:`_sc_words`, a mixed node of 16 one
step decided whole in registers; nodes of 16 and 32 LLRs in registers,
the hard bits packed 32 to a word; the CRC as the XOR of the set bits'
remainder words), through a plan cached per (code, CRC, syndrome,
LLR shape, device) on the lean launch path (``kernels/_build.py::Launch``:
:func:`_decode_plan`, :func:`_decode_params`, :func:`_decode_table`), on
CPU tensors in its twin :func:`decode_ref`; a slot batch's codewords [S,
B, E] go in the same launch.  The CA-SCL list decoder is ``polar_scl``
(K29).
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

from .. import kernels
from ..device import const
from ..kernels import _build
from ..ran.polar_params import (PolarCode, input_interleave_map,
                                subblock_interleave_map)
from .crc import POLYS, _remainder_words, crc

KERNEL = kernels.register(kernels.Kernel(
    name="polar_decode", route="cuda",
    source="srsran_tpu_torch/csrc/polar_sc.cu",
    replaces="srsran_tpu/ops/polar.py:171"))
KERNEL_BATCH = kernels.batched(KERNEL)
ENCODE_KERNEL = kernels.register(kernels.Kernel(
    name="polar_encode", route="cuda",
    source="srsran_tpu_torch/csrc/polar_encode.cu",
    replaces="srsran_tpu/ops/polar.py:37"))

_ENCODE_MATRIX_CACHE: dict = {}
MAX_N = 1024            # csrc/polar_encode.cu: n <= 10
ENCODE_WARPS = 4        # K33's warps a codeword, and a CTA's, at most
ENCODE_PLANS_MAX = 256


def encode_matrix(code: PolarCode) -> np.ndarray:
    """GF(2) matrix M [K, E] (uint8) of allocate -> u F^{(x)n} -> rate match
    (+ i_BIL); linear for n_pc == 0."""
    if code.n_pc != 0:
        raise ValueError("PC-polar (UCI 12..19 bits) is not linear")
    key = (code.k, code.e, code.n, code.mode, code.ibil, code.iil,
           code.info_set.tobytes())
    hit = _ENCODE_MATRIX_CACHE.get(key)
    if hit is not None:
        return hit
    k, big_n = code.k, code.big_n
    placed = np.eye(k, dtype=np.uint8)
    if code.iil:
        # allocate() takes msg' = msg[perm]; on basis rows that is a
        # column reorder: placed[r, i] = (perm[i] == r).
        placed = placed[:, input_interleave_map(code.k)]
    u = np.zeros((k, big_n), dtype=np.uint8)
    u[:, code.info_set] = placed
    x = u
    for s in range(code.n):
        half = 1 << s
        x = x.reshape(k, big_n // (2 * half), 2, half)
        left = x[:, :, 0] ^ x[:, :, 1]
        x = np.stack([left, x[:, :, 1]], axis=2)
    x = x.reshape(k, big_n)
    out = x[:, _rm_plan(code.big_n, code.e, code.mode)]
    if code.ibil:
        out = out[:, _triangle_perm(code.e)]
    out = out.astype(np.uint8)
    _ENCODE_MATRIX_CACHE[key] = out
    return out


@functools.lru_cache(maxsize=None)
def _rm_plan(big_n: int, e: int, mode: str) -> np.ndarray:
    """src index in mother codeword for each of the E transmitted bits."""
    jmap = subblock_interleave_map(big_n)
    if mode == "puncture":
        sel = np.arange(big_n - e, big_n)
    elif mode == "shorten":
        sel = np.arange(e)
    else:  # none / repeat
        sel = np.arange(e) % big_n
    return jmap[sel].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _triangle_perm(e: int) -> np.ndarray:
    """TS38.212 §5.4.1.3 triangular channel interleaver: out[i] = in[perm[i]]."""
    t = 1
    while t * (t + 1) // 2 < e:
        t += 1
    k = 0
    mat = -np.ones((t, t), dtype=np.int64)
    for r in range(t):
        for c in range(t - r):
            if k < e:
                mat[r, c] = k
                k += 1
    perm = mat.T.reshape(-1)
    return perm[perm >= 0].astype(np.int32)


# ------------------------------------------------------ encoding (UE side)

def encode(u: torch.Tensor, n: int) -> torch.Tensor:
    """x = u F^{(x)n}, natural order (no bit reversal in NR).  [B, N] int8."""
    big_n = 1 << n
    x = u.to(torch.int8)
    batch = x.shape[0]
    for s in range(n):
        half = 1 << s
        x = x.reshape(batch, big_n // (2 * half), 2, half)
        x = torch.stack([x[:, :, 0] ^ x[:, :, 1], x[:, :, 1]], dim=2)
    return x.reshape(batch, big_n)


@functools.lru_cache(maxsize=None)
def _pc_sources(big_n: int, pc_set: tuple, info_set: tuple) -> tuple:
    """TS38.212 §5.3.1.2 parity-check bits: ((pc position, sorted info
    positions whose XOR it carries), ...), from the length-5 cyclic shift
    register walked over positions 0..N-1 on the host."""
    pc_pos = set(pc_set)
    info_pos = set(info_set)
    reg = [set() for _ in range(5)]
    out = []
    for i in range(big_n):
        reg = reg[1:] + [reg[0]]  # cyclic left shift
        if i in pc_pos:
            out.append((i, tuple(sorted(reg[0]))))
        elif i in info_pos:
            reg[0] = reg[0] ^ {i}
    return tuple(out)


def allocate(msg: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """Place K message bits into the encoder input (frozen = 0), with the
    input interleaver (i_IL) when enabled and the PC bits.  [B, K] -> [B, N]."""
    dev = msg.device
    if code.iil:
        msg = msg[:, torch.as_tensor(input_interleave_map(code.k),
                                     dtype=torch.int64, device=dev)]
    u = torch.zeros((msg.shape[0], code.big_n), dtype=torch.int8, device=dev)
    u[:, torch.as_tensor(code.info_set, dtype=torch.int64,
                         device=dev)] = msg.to(torch.int8)
    for pos, src in _pc_sources(code.big_n, _pc_set(code),
                                tuple(code.info_set.tolist())):
        if src:
            idx = torch.as_tensor(src, dtype=torch.int64, device=dev)
            u[:, pos] = (u[:, idx].to(torch.int32).sum(dim=-1) % 2).to(
                torch.int8)
        else:
            u[:, pos] = 0
    return u


def rate_match(x: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """Mother codeword [B, N] -> transmitted bits [B, E]."""
    dev = x.device
    i64 = dict(dtype=torch.int64, device=dev)
    out = x[:, torch.as_tensor(_rm_plan(code.big_n, code.e, code.mode), **i64)]
    if code.ibil:
        out = out[:, torch.as_tensor(_triangle_perm(code.e), **i64)]
    return out


def _pc_set(code: PolarCode) -> tuple:
    return () if code.pc_set is None else tuple(code.pc_set.tolist())


@functools.lru_cache(maxsize=256)
def _encode_tables(big_n: int, e: int, mode: str, ibil: bool, iil: bool,
                   info_set: tuple, pc_set: tuple) -> tuple:
    """K33's tables of one code (csrc/polar_encode.cu): src int16 [32 * 32],
    lane l's row of 32: the message index of encoder position 32t + l
    (u[info_set[j]] = msg[src], i_IL folded in), or -1 (frozen, PC, past
    N); pc int32 [npc * 32 + npc] (at least one word), per PC bit the 32
    words' masks of its sources (each PC bit the XOR of u there), then the
    PC positions; plan int16 [E] padded with zeros to a multiple of 16
    (transmitted bit i = x[plan[i]], i_BIL folded in)."""
    k = len(info_set)
    src = np.full(1024, -1, np.int16)
    src[np.asarray(info_set, np.int64)] = (input_interleave_map(k) if iil
                                           else np.arange(k))
    src = np.ascontiguousarray(src.reshape(32, 32).T).reshape(-1)
    pcs = _pc_sources(big_n, pc_set, info_set)
    masks = np.zeros((len(pcs), 32), np.uint32)
    for p, (_, sources) in enumerate(pcs):
        for i in sources:
            masks[p, i >> 5] |= np.uint32(1 << (i & 31))
    pc = np.concatenate([masks.reshape(-1), [pos for pos, _ in pcs]]
                        ).astype(np.uint32)
    plan = np.zeros(-(-e // 16) * 16, np.int16)    # 32-byte rounds a lane
    plan[:e] = _rm_plan(big_n, e, mode)
    if ibil:
        plan[:e] = plan[:e][_triangle_perm(e)]
    return (src, (pc if pc.size else np.zeros(1, np.uint32)).view(np.int32),
            plan)


def encode_chain_ref(msg: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """Plain twin of :func:`encode_chain`: allocate -> encode ->
    rate_match, on the device of ``msg``."""
    return rate_match(encode(allocate(msg, code), code.n), code)


def _encode_params(code: PolarCode, shape: tuple) -> _build.PolarEncodeParams:
    """K33's launch for messages of ``shape`` [B, K] in ``code``: 1, 2 or
    ENCODE_WARPS warps a codeword, for up to 512 transmitted bits a warp
    (they take its gather's rounds in turn), up to ENCODE_WARPS warps a
    CTA; raises on what the kernel does not take."""
    if (len(shape) != 2 or shape[0] < 1 or shape[1] != code.k
            or not 32 <= code.big_n <= MAX_N):
        raise ValueError(f"msg must be [B, {code.k}] for 32 <= N <= {MAX_N}, "
                         f"got {tuple(shape)} at N = {code.big_n}")
    b = shape[0]
    split = min(ENCODE_WARPS, 1 << (-(-code.e // 512) - 1).bit_length())
    return _build.PolarEncodeParams(b, code.k, code.n, code.e,
                                    len(_pc_set(code)),
                                    min(ENCODE_WARPS, b * split), split)


_ENCODE_PLANS: collections.OrderedDict = collections.OrderedDict()
_ENCODE_LOCK = threading.Lock()     # _ENCODE_PLANS (serve_phy's thread)


def _encode_plan(code: PolarCode, shape, index: int) -> tuple:
    """K33's plan for messages of ``shape`` in ``code`` on CUDA device
    ``index``: (its launch, with the code's tables; B; E; the code), kept
    in a bounded LRU keyed by the code's identity (a PolarCode holds numpy
    arrays and cannot key a cache itself; the plan holds the code, so its
    id is not reused while the plan lives)."""
    key = (id(code), shape, index)
    with _ENCODE_LOCK:
        plan = _ENCODE_PLANS.get(key)
        if plan is not None:
            _ENCODE_PLANS.move_to_end(key)
            return plan
    params = _encode_params(code, shape)
    dev = torch.device("cuda", index)
    tables = tuple(torch.from_numpy(t).to(dev) for t in _encode_tables(
        code.big_n, code.e, code.mode, code.ibil, code.iil,
        tuple(code.info_set.tolist()), _pc_set(code)))
    plan = (_build.Launch("srsran_polar_encode", index, params, tables),
            shape[0], code.e, code)
    with _ENCODE_LOCK:
        _ENCODE_PLANS[key] = plan
        if len(_ENCODE_PLANS) > ENCODE_PLANS_MAX:
            _ENCODE_PLANS.popitem(last=False)
    return plan


def encode_chain(msg: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """The whole TS38.212 polar TX chain: message bits int8 [B, K] (CRC
    attached) -> transmitted bits int8 [B, E] -- input interleaver (DL),
    info and PC bits, the butterfly, rate matching and the channel
    interleaver (UL), as :func:`allocate`, :func:`encode` and
    :func:`rate_match` compose them."""
    if not msg.is_cuda:
        return encode_chain_ref(msg, code)
    launch, b, e, _ = _encode_plan(code, msg.shape, msg.get_device())
    if msg.dtype is not torch.int8 or not msg.is_contiguous():
        msg = msg.to(torch.int8).contiguous()
    out = msg.new_empty(b, e)      # ints: a shape tuple parses slower
    launch(msg.data_ptr(), out.data_ptr())
    ENCODE_KERNEL.count()
    return out


# ------------------------------------------------------------- receiving

def _shortened(big_n: int, e: int) -> np.ndarray:
    return subblock_interleave_map(big_n)[e:]


def rate_dematch(llrs: torch.Tensor, code: PolarCode,
                 shorten_llr: float = 1e4) -> torch.Tensor:
    """Transmitted-bit LLRs [B, E] -> mother-codeword LLRs [B, N].

    Punctured bits get 0, shortened bits a strong known-zero LLR, repeated
    bits accumulate (in transmission order)."""
    i64 = dict(device=llrs.device, dtype=torch.int64)
    if code.ibil:
        buf = torch.zeros_like(llrs)
        buf[:, const(_triangle_perm, code.e, **i64)] = llrs
        llrs = buf
    out = torch.zeros(llrs.shape[:-1] + (code.big_n,), dtype=llrs.dtype,
                      device=llrs.device)
    out.index_add_(1, const(_rm_plan, code.big_n, code.e, code.mode, **i64),
                   llrs)
    if code.mode == "shorten":
        out[:, const(_shortened, code.big_n, code.e, **i64)] = shorten_llr
    return out


def _f(a, b):
    """Check-node (min-sum box-plus approximation)."""
    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


def _g(a, b, x_left):
    return b + (1.0 - 2.0 * x_left) * a


def _xor_f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XOR of {0.,1.}-valued float arrays."""
    return (a - b).abs()


def _unencode(x: torch.Tensor) -> torch.Tensor:
    """Invert the polar butterfly on hard bits (float {0,1}): self-inverse."""
    batch, m = x.shape
    u = x
    for s in range(int(np.log2(m))):
        half = 1 << s
        u = u.reshape(batch, m // (2 * half), 2, half)
        u = torch.stack([_xor_f(u[:, :, 0], u[:, :, 1]), u[:, :, 1]], dim=2)
    return u.reshape(batch, m)


def _readout(info_set: tuple, iil: bool) -> np.ndarray:
    """Encoder positions of the message bits in message order (the inverse
    input interleaver folded in when enabled)."""
    idx = np.asarray(info_set, dtype=np.int64)
    if iil:
        perm = input_interleave_map(len(info_set))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(info_set), dtype=np.int32)
        idx = idx[inv]
    return idx


def _code_keys(code: PolarCode) -> dict:
    """Hashable keys of the device constants of one code (a PolarCode
    holds numpy arrays, so it cannot key a cache itself)."""
    return dict(readout=(tuple(code.info_set.tolist()), code.iil),
                program=(np.asarray(code.frozen_mask, np.uint8).tobytes(),),
                tables=(code.big_n, code.e, code.mode, code.ibil))


def sc_decode(llrs: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """Successive-cancellation decode, batched: mother-codeword LLRs f32
    [B, N] (LLR > 0 -> bit 0) -> message bits int8 [B, K].

    Tree-pruned on the host's frozen mask: all-frozen segments return
    zeros (RATE_0); all-info segments hard-decide and re-encode (RATE_1),
    as the JAX package does.  PC bits are not frozen, so they decode as
    info bits; only the message positions are read out."""
    frozen = code.frozen_mask.astype(bool)
    batch = llrs.shape[0]
    dev = llrs.device

    def rec(seg: torch.Tensor, fro: np.ndarray):
        m = seg.shape[-1]
        if fro.all():
            z = torch.zeros((batch, m), dtype=torch.float32, device=dev)
            return z, z
        if not fro.any():
            x = (seg < 0).to(torch.float32)
            return _unencode(x), x
        h = m // 2
        a, b = seg[:, :h], seg[:, h:]
        u_l, x_l = rec(_f(a, b), fro[:h])
        u_r, x_r = rec(_g(a, b, x_l), fro[h:])
        return (torch.cat([u_l, u_r], dim=-1),
                torch.cat([_xor_f(x_l, x_r), x_r], dim=-1))

    u_hat, _ = rec(llrs.to(torch.float32), frozen)
    readout = const(_readout, *_code_keys(code)["readout"], device=dev)
    return u_hat[:, readout].to(torch.int8)


# ------------------------------------------------------------------ K15

# K15's step ops (csrc/polar_sc.cu's enum; 4, the twin's SAVE of the left
# child's bits, is done by the G step after it)
_OP_R0, _OP_R1, _OP_F, _OP_G, _OP_COMB = 0, 1, 2, 3, 5


def _dematch_tables(n: int, e: int, mode: str, ibil: bool) -> np.ndarray:
    """int32 [2, N + E] for the kernel's rate dematch: per mother position n
    the first transmitted index i feeding it (-1: none; later ones at
    i + N, i + 2N, ...) and whether it is shortened; per deinterleaved
    index i, the received index it is read from (the inverse triangular
    interleaver, or i)."""
    plan = _rm_plan(n, e, mode)
    first = np.full(n, -1, np.int64)
    for i in range(min(e, n) - 1, -1, -1):
        first[plan[i]] = i
    short = np.zeros(n, np.int64)
    if mode == "shorten":
        short[subblock_interleave_map(n)[e:]] = 1
    src = np.arange(e, dtype=np.int64)
    if ibil:
        src[_triangle_perm(e)] = np.arange(e)
    return np.stack([np.concatenate([first, src]),
                     np.concatenate([short, np.zeros(e, np.int64)])]
                    ).astype(np.int32)


def _bit_weights(length: int) -> np.ndarray:
    return (1 << np.arange(length - 1, -1, -1)).astype(np.int64)


def crc_word(bits: torch.Tensor, crc_name: str) -> torch.Tensor:
    """int64 [...]: the CRC remainder of each message's K bits (its
    trailing CRC included) as a word, MSB first; 0 where a plain trailing
    CRC matches."""
    c = crc(bits, crc_name).to(torch.int64)                       # [..., L]
    return (c * const(_bit_weights, POLYS[crc_name][0],
                      device=bits.device)).sum(dim=-1)


def decode_ref(llrs: torch.Tensor, code: PolarCode, crc_name: str,
               syndrome: int = 0) -> tuple:
    """Plain twin of :func:`decode` (a slot axis folds into the codeword
    axis)."""
    if llrs.ndim == 3:
        bits, ok = decode_ref(llrs.reshape(-1, llrs.shape[-1]), code,
                              crc_name, syndrome)
        return (bits.reshape(llrs.shape[:2] + (code.k,)),
                ok.reshape(llrs.shape[:2]))
    bits = sc_decode(rate_dematch(llrs, code), code)
    return bits, crc_word(bits, crc_name) == int(syndrome)


_OP_SHIFT, _LG_SHIFT, _LO_SHIFT = 0, 3, 7
_OP_SUB = 6              # a mixed node of SUB_M positions, whole
SUB_M = 16
_SUB_LO_SHIFT, _SUB_MASK_SHIFT = 7, 13
DECODE_WARPS = 4         # codewords a CTA, at most
DECODE_PLANS_MAX = 256


@functools.lru_cache(maxsize=None)
def _sc_words(frozen: bytes) -> np.ndarray:
    """K15's step words over this frozen mask, uint32 [n_steps]: the node
    schedule of :func:`sc_decode`'s recursion, a word a step -- op | log2 m
    << 3 | first u index << 7, op a RATE_0 / RATE_1 leaf, F / G (the LLRs
    of a length-m node's left / right child; G first keeps the left
    child's bits) or COMB (x of the node from both children) -- but for a
    mixed node of SUB_M positions, which is one word: _OP_SUB | log2 SUB_M
    << 3 | first u index / SUB_M << 7 | its frozen flags << 13 (bit i:
    position i frozen), the kernel decoding the whole node by the same
    recursion in each lane's registers."""
    fro = np.frombuffer(frozen, dtype=np.uint8).astype(bool)
    words = []

    def rec(lo: int, m: int):
        f = fro[lo:lo + m]
        lg = int(m).bit_length() - 1
        if f.all() or not f.any():
            words.append((_OP_R0 if f.all() else _OP_R1) << _OP_SHIFT
                         | lg << _LG_SHIFT | lo << _LO_SHIFT)
            return
        if m == SUB_M:
            mask = int(np.dot(f.astype(np.int64), 1 << np.arange(m)))
            words.append(_OP_SUB << _OP_SHIFT | lg << _LG_SHIFT
                         | lo // SUB_M << _SUB_LO_SHIFT
                         | mask << _SUB_MASK_SHIFT)
            return
        h = m // 2
        words.append(_OP_F << _OP_SHIFT | lg << _LG_SHIFT | lo << _LO_SHIFT)
        rec(lo, h)
        words.append(_OP_G << _OP_SHIFT | lg << _LG_SHIFT | lo << _LO_SHIFT)
        rec(lo + h, h)
        words.append(_OP_COMB << _OP_SHIFT | lg << _LG_SHIFT
                     | lo << _LO_SHIFT)

    rec(0, len(fro))
    return np.asarray(words, dtype=np.uint32)


@functools.lru_cache(maxsize=64)
def _dematch_rounds(big_n: int, e: int, mode: str, ibil: bool) -> np.ndarray:
    """int32 [R, N]: round j of mother position q -- the received index of
    the j-th transmitted bit feeding q (the inverse triangular interleaver
    folded in), -1 past its last, -2 at round 0 of a shortened position --
    from :func:`_dematch_tables`; R the most bits feeding a position."""
    dm = _dematch_tables(big_n, e, mode, ibil)
    first, src, short = dm[0, :big_n], dm[0, big_n:], dm[1, :big_n]
    rounds = max(1, -(-e // big_n))
    out = np.full((rounds, big_n), -1, np.int32)
    for j in range(rounds):
        i = first + j * big_n
        live = (first >= 0) & (i < e)
        out[j, live] = src[i[live]]
    out[0, short == 1] = -2
    return out


@functools.lru_cache(maxsize=64)
def _decode_table(big_n: int, e: int, mode: str, ibil: bool,
                  info_set: tuple, iil: bool, crc_name: str) -> np.ndarray:
    """K15's int32 table of one code (csrc/polar_sc.cu): the rate dematch's
    rounds (:func:`_dematch_rounds`), the message bits' positions in u
    (:func:`_readout`) and each message bit's CRC remainder word
    (``ops/crc.py::_remainder_words``: the CRC register is the XOR of those
    of the set bits)."""
    return np.concatenate([
        _dematch_rounds(big_n, e, mode, ibil).reshape(-1),
        _readout(info_set, iil).astype(np.int32),
        _remainder_words(crc_name, len(info_set)).view(np.int32)]).astype(
            np.int32)


def _decode_params(code: PolarCode, crc_name: str, syndrome: int,
                   shape: tuple) -> _build.PolarDecodeParams:
    """K15's launch for received LLRs of ``shape`` [(S,) B, E] in
    ``code``: a warp per codeword, up to DECODE_WARPS a CTA; the rate
    dematch's rounds; the CRC register a good message leaves (``syndrome``
    masked to the CRC's length); the node schedule by value
    (:func:`_sc_words`); raises on what the kernel does not take."""
    if (len(shape) not in (2, 3) or shape[-1] != code.e or 0 in shape
            or not 32 <= code.big_n <= MAX_N):
        raise ValueError(f"llrs must be float32 [(S,) B, {code.e}] for 32 "
                         f"<= N <= {MAX_N}, got {tuple(shape)} at N = "
                         f"{code.big_n}")
    words = _sc_words(np.asarray(code.frozen_mask, np.uint8).tobytes())
    if len(words) > _build.POLAR_MAX_STEPS:
        raise ValueError(f"K15 takes up to {_build.POLAR_MAX_STEPS} steps, "
                         f"this code has {len(words)}")
    b = int(np.prod(shape[:-1]))
    crc_len, _ = POLYS[crc_name]
    p = _build.PolarDecodeParams(
        B=b, E=code.e, n=code.n, K=code.k, R=max(1, -(-code.e // code.big_n)),
        nops=len(words), warps=min(DECODE_WARPS, b),
        expect=int(syndrome) & ((1 << crc_len) - 1))
    p.words[:len(words)] = words.tolist()
    return p


_DECODE_PLANS: collections.OrderedDict = collections.OrderedDict()
_DECODE_LOCK = threading.Lock()


def _decode_plan(code: PolarCode, crc_name: str, syndrome: int, shape,
                 index: int) -> tuple:
    """K15's plan on CUDA device ``index``: (its launch, with the code's
    table; the outputs' leading shape; K; the code), in a bounded LRU keyed
    by the code's identity (the plan holds the code, so its id is not
    reused while the plan lives), the CRC, the syndrome and the shape."""
    key = (id(code), crc_name, syndrome, shape, index)
    with _DECODE_LOCK:
        plan = _DECODE_PLANS.get(key)
        if plan is not None:
            _DECODE_PLANS.move_to_end(key)
            return plan
    params = _decode_params(code, crc_name, syndrome, shape)
    keys = _code_keys(code)
    table = torch.from_numpy(_decode_table(
        *keys["tables"], *keys["readout"], crc_name)).to(
            torch.device("cuda", index))
    plan = (_build.Launch("srsran_polar_decode", index, params, (table,)),
            tuple(shape[:-1]), code.k, code)
    with _DECODE_LOCK:
        _DECODE_PLANS[key] = plan
        if len(_DECODE_PLANS) > DECODE_PLANS_MAX:
            _DECODE_PLANS.popitem(last=False)
    return plan


def decode(llrs: torch.Tensor, code: PolarCode, crc_name: str,
           syndrome: int = 0) -> tuple:
    """Received LLRs f32 [B, E] -> (message bits int8 [B, K], CRC ok bool
    [B]): rate dematch, SC decode and the check of the message's CRC
    (``crc_name``, e.g. "crc11"): its remainder over the K decoded bits
    must equal ``syndrome`` -- 0 for a plain trailing CRC, a DCI's
    :func:`pdcch.dci_syndrome` for its RNTI.  A slot batch's llrs
    [S, B, E] give [S, B, K] and [S, B] from one launch."""
    if not llrs.is_cuda:
        return decode_ref(llrs, code, crc_name, syndrome)
    if llrs.dtype is not torch.float32:
        raise ValueError(f"llrs must be float32, got {llrs.dtype}")
    launch, lead, k, _ = _decode_plan(code, crc_name, int(syndrome),
                                      tuple(llrs.shape), llrs.get_device())
    if not llrs.is_contiguous():
        llrs = llrs.contiguous()
    bits = llrs.new_empty(lead + (k,), dtype=torch.int8)
    ok = llrs.new_empty(lead, dtype=torch.bool)
    launch(llrs.data_ptr(), bits.data_ptr(), ok.data_ptr())
    (KERNEL_BATCH if len(lead) > 1 else KERNEL).count()
    return bits, ok
