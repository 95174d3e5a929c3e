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
check of the decoded message, on CUDA tensors in one hand kernel
(csrc/polar_sc.cu: one CTA per codeword, the LLR tree in shared memory,
walking a host-built node schedule), on CPU tensors in its twin
:func:`decode_ref`; a slot batch's codewords [B, N, E] fold into one
launch of B * N CTAs.  The CA-SCL list decoder is ``polar_scl`` (K29).
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build
from ..ran.polar_params import (PolarCode, input_interleave_map,
                                subblock_interleave_map)
from .crc import POLYS, crc

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

_OP_R0, _OP_R1, _OP_F, _OP_G, _OP_SAVE, _OP_COMB = range(6)


@functools.lru_cache(maxsize=None)
def _sc_program(frozen: bytes) -> np.ndarray:
    """The node schedule of :func:`sc_decode`'s recursion over this frozen
    mask, for the kernel: int32 [n_ops, 3] rows (op, log2 m, first u index)
    with op RATE_0 / RATE_1 leaves, F / G (the LLRs of a length-m node's
    left / right child), SAVE (keep the left child's bits) and COMB (x of
    the node from both children)."""
    fro = np.frombuffer(frozen, dtype=np.uint8).astype(bool)
    ops = []

    def rec(lo: int, m: int):
        f = fro[lo:lo + m]
        lg = int(m).bit_length() - 1
        if f.all():
            ops.append((_OP_R0, lg, lo))
            return
        if not f.any():
            ops.append((_OP_R1, lg, lo))
            return
        h = m // 2
        ops.append((_OP_F, lg, lo))
        rec(lo, h)
        ops.append((_OP_SAVE, lg, lo))
        ops.append((_OP_G, lg, lo))
        rec(lo + h, h)
        ops.append((_OP_COMB, lg, lo))

    rec(0, len(fro))
    return np.asarray(ops, dtype=np.int32)


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


def decode(llrs: torch.Tensor, code: PolarCode, crc_name: str,
           syndrome: int = 0) -> tuple:
    """Received LLRs f32 [B, E] -> (message bits int8 [B, K], CRC ok bool
    [B]): rate dematch, SC decode and the check of the message's CRC
    (``crc_name``, e.g. "crc11"): its remainder over the K decoded bits
    must equal ``syndrome`` -- 0 for a plain trailing CRC, a DCI's
    :func:`pdcch.dci_syndrome` for its RNTI.  A slot batch's llrs
    [S, B, E] give [S, B, K] and [S, B] from one launch."""
    if not is_cuda(llrs):
        return decode_ref(llrs, code, crc_name, syndrome)
    if (llrs.dtype != torch.float32 or llrs.ndim not in (2, 3)
            or llrs.shape[-1] != code.e):
        raise ValueError(f"llrs must be float32 [(S,) B, {code.e}], got "
                         f"{llrs.dtype} {tuple(llrs.shape)}")
    dev = llrs.device
    lead = tuple(llrs.shape[:-1])
    b = llrs.numel() // code.e
    keys = _code_keys(code)
    program = const(_sc_program, *keys["program"], device=dev)
    tables = const(_dematch_tables, *keys["tables"], device=dev)
    readout = const(_readout, *keys["readout"], device=dev,
                    dtype=torch.int32)
    crc_len, poly = POLYS[crc_name]
    llrs = llrs.contiguous()
    bits = torch.empty(lead + (code.k,), dtype=torch.int8, device=dev)
    ok = torch.empty(lead, dtype=torch.bool, device=dev)
    lib = _build.load()
    _build.check(lib.srsran_polar_decode(
        _build.ptr(llrs), b, code.e, code.n, _build.ptr(tables),
        _build.ptr(program), program.shape[0], _build.ptr(readout), code.k,
        crc_len, poly, int(syndrome),
        _build.ptr(bits), _build.ptr(ok), _build.stream_of(llrs)),
        "polar_decode")
    (KERNEL_BATCH if len(lead) > 1 else KERNEL).count()
    return bits, ok
