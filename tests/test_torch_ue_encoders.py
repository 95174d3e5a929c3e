"""K33's and K34's host plans and numpy models of their kernels, on the CPU.

K33 (csrc/polar_encode.cu, a warp per codeword with u packed 32 bits a
lane): its tables (``polar._encode_tables``) entry by entry against the
code's info set, input interleaver, PC sources and rate-match plan; a
numpy model of the packed butterfly (the in-word masks, then the lane
XOR) against the twin's ``encode`` for N = 32..1024; a numpy model of the
whole kernel (ballot, shuffles, PC parities by popc and an XOR over the
warp, butterfly, gather) against ``encode_chain_ref``; its launch struct.
K34 (csrc/short_block.cu): its period table in message order and a model
of the kernel on it against ``encode_ref`` for K 1-11 at Qm 1, 2, 4, 6;
its launch struct.  Both: the chunk stores of csrc/warp_bits.cuh (every
byte once, 8- and 16-byte stores aligned and inside the row) at each
alignment.  Bit
paths are held exactly.  Imports nothing of JAX: the twins are held to
the JAX package by tests/test_torch_last_functions.py.
"""

import numpy as np
import pytest
import torch

from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import polar
from srsran_tpu_torch.ops import short_block
from srsran_tpu_torch.ran import polar_params
from srsran_tpu_torch.ran.polar_params import input_interleave_map

# (K, E, nmax, ibil, n_pc): tests/test_torch_last_kernels.py's codes, the
# smallest mother code (N = 32) and the widest with E = 8192 (repetition)
POLAR_CASES = {
    "pbch": (56, 864, 9, False, 0), "dci_al1": (64, 108, 9, False, 0),
    "dci_al2": (64, 216, 9, False, 0), "dci_al4": (64, 432, 9, False, 0),
    "dci_al8": (64, 864, 9, False, 0), "dci_al16": (64, 1728, 9, False, 0),
    "uci_pc_none": (18, 64, 10, True, 3),
    "uci_pc_puncture": (25, 200, 10, True, 3),
    "uci_crc11": (33, 64, 10, True, 0),
    "uci_puncture": (111, 1000, 10, True, 0),
    "uci_shorten": (30, 40, 10, True, 0),
    "uci_repeat": (100, 2000, 10, True, 0),
    "n32": (8, 24, 9, False, 0),
    "n1024_e8192": (200, 8192, 10, True, 0),
}


def _code(case):
    k, e, nmax, ibil, npc = POLAR_CASES[case]
    return polar_params.polar_code(k, e, nmax=nmax, ibil=ibil, n_pc=npc)


def _tables(code):
    return polar._encode_tables(code.big_n, code.e, code.mode, code.ibil,
                                code.iil, tuple(code.info_set.tolist()),
                                polar._pc_set(code))


def _bits(seed, shape):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int8)


# ------------------------------------------------------------------ K33

@pytest.mark.parametrize("case", sorted(POLAR_CASES))
def test_polar_encode_tables(case):
    """src (lane l's row: positions 32t + l): each info position's message
    index (i_IL folded in), -1 elsewhere; each PC bit's masks hold exactly
    its ``_pc_sources``, then its position; the plan is the rate-match (+
    i_BIL) gather, below N, padded with zeros to a lane's 32-byte
    rounds."""
    code = _code(case)
    src, pc, plan = _tables(code)
    k, n = code.k, code.big_n
    assert src.dtype == np.int16 and pc.dtype == np.int32
    assert plan.dtype == np.int16 and src.shape == (1024,)
    src = src.reshape(32, 32).T.reshape(-1)                # by position
    assert (src[n:] == -1).all()
    info_src = input_interleave_map(k) if code.iil else np.arange(k)
    np.testing.assert_array_equal(src[code.info_set], info_src)
    others = np.setdiff1d(np.arange(n), code.info_set)
    assert (src[others] == -1).all()
    pcs = polar._pc_sources(n, polar._pc_set(code),
                            tuple(code.info_set.tolist()))
    npc = len(pcs)
    assert npc == code.n_pc and pc.size == max(1, 33 * npc)
    words = pc.view(np.uint32)
    for p, (pos, sources) in enumerate(pcs):
        mask = words[32 * p:32 * (p + 1)]
        got = [32 * lane + b for lane in range(32) for b in range(32)
               if (int(mask[lane]) >> b) & 1]
        assert got == sorted(sources)
        assert int(words[32 * npc + p]) == pos
        assert src[pos] == -1
    want = polar._rm_plan(n, code.e, code.mode)
    if code.ibil:
        want = want[polar._triangle_perm(code.e)]
    np.testing.assert_array_equal(plan[:code.e], want)
    assert plan.shape == (-(-code.e // 16) * 16,) and not plan[code.e:].any()
    assert 0 <= plan.min() and plan.max() < n


def _butterfly_packed(x: np.ndarray, n: int) -> np.ndarray:
    """The kernel's butterfly on packed words x uint64 [..., 32 lanes]:
    stages 0-4 inside a word, stages 5..n-1 across lanes."""
    x = x.copy()
    for h, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                 (8, 0x00FF00FF), (16, 0x0000FFFF)):
        x ^= (x >> np.uint64(h)) & np.uint64(m)
    lanes = np.arange(32)
    for s in range(5, n):
        d = 1 << (s - 5)
        y = x[..., lanes ^ d]                        # __shfl_xor_sync
        x = np.where((lanes & d) == 0, x ^ y, x)
    return x


def _pack(u: np.ndarray) -> np.ndarray:
    """u [..., N] (0/1) -> words uint64 [..., 32]: position 32L + b is bit b
    of lane L's word, lanes past N zero."""
    pad = np.zeros(u.shape[:-1] + (1024,), np.uint64)
    pad[..., :u.shape[-1]] = u
    w = pad.reshape(u.shape[:-1] + (32, 32))
    return (w << np.arange(32, dtype=np.uint64)).sum(axis=-1)


def _unpack(x: np.ndarray, n: int) -> np.ndarray:
    bits = (x[..., None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
    return bits.reshape(x.shape[:-1] + (1024,))[..., :n].astype(np.int8)


@pytest.mark.parametrize("n", range(5, 11))
def test_packed_butterfly_matches_encode(n):
    u = _bits(n, (3, 1 << n))
    want = polar.encode(torch.as_tensor(u), n).numpy()
    np.testing.assert_array_equal(_unpack(_butterfly_packed(_pack(u), n),
                                          1 << n),
                                  want)


def _kernel_model(msg: np.ndarray, code) -> np.ndarray:
    """csrc/polar_encode.cu in numpy, lane by lane: the ballot-packed
    message, u a word a round (lane l's bit of round t by shuffle from its
    src row, the round's ballot word kept by lane t), the PC parities (popc
    under the masks, XOR over the warp), the packed butterfly, the
    gather."""
    src, pc, plan = _tables(code)
    words = code.big_n // 32
    npc = len(polar._pc_set(code))
    pcw = pc.view(np.uint32).astype(np.uint64)
    lanes = np.arange(32)
    out = []
    for m in msg:
        bits = np.zeros(1024, np.uint64)
        bits[:code.k] = m & 1
        mw = _pack(bits)                             # lane w: word w
        e = src.reshape(32, 32).astype(np.int64)     # [lane l, round t]
        got = mw[(e >> 5) & 31]
        bit = ((got >> (e & 31).astype(np.uint64)) & np.uint64(1)) * (e >= 0)
        ballots = (bit << lanes[:, None].astype(np.uint64)).sum(axis=0)
        x = np.where(lanes < words, ballots, 0).astype(np.uint64)
        for p in range(npc):
            ones = [bin(int(v)).count("1") & 1 for v in
                    x & pcw[32 * p:32 * (p + 1)]]
            par = np.bitwise_xor.reduce(ones)          # __reduce_xor_sync
            pos = int(pcw[32 * npc + p])
            x[pos >> 5] |= np.uint64(par) << np.uint64(pos & 31)
        x = _butterfly_packed(x, code.n)
        q = plan[:code.e].astype(np.int64)
        out.append(((x[q >> 5] >> (q & 31).astype(np.uint64))
                    & np.uint64(1)).astype(np.int8))
    return np.asarray(out)


@pytest.mark.parametrize("case", sorted(POLAR_CASES))
def test_polar_kernel_model_matches_twin(case):
    code = _code(case)
    msg = _bits(len(case), (3, code.k))
    want = polar.encode_chain_ref(torch.as_tensor(msg), code).numpy()
    np.testing.assert_array_equal(_kernel_model(msg, code), want)


@pytest.mark.parametrize("b", [1, 3, 4, 7, 64, 65])
@pytest.mark.parametrize("case,split", [("uci_pc_none", 1), ("uci_crc11", 1),
                                        ("uci_pc_puncture", 1),
                                        ("uci_shorten", 1), ("pbch", 2),
                                        ("dci_al2", 1), ("dci_al4", 1),
                                        ("dci_al8", 2), ("dci_al16", 4),
                                        ("n1024_e8192", 4),
                                        ("uci_puncture", 2)])
def test_polar_encode_params(case, split, b):
    """1, 2 or 4 warps a codeword, for up to 512 transmitted bits a warp,
    and up to 4 warps a CTA, a whole number of codewords each."""
    code = _code(case)
    p = polar._encode_params(code, (b, code.k))
    assert isinstance(p, _build.PolarEncodeParams)
    assert (p.B, p.K, p.n, p.E, p.npc) == (b, code.k, code.n, code.e,
                                           code.n_pc)
    assert p.split == split and 512 * split >= min(code.e, 2048)
    assert p.warps == min(polar.ENCODE_WARPS, b * split)
    for shape in ((b, code.k + 1), (code.k,), (0, code.k), (1, b, code.k)):
        with pytest.raises(ValueError):
            polar._encode_params(code, shape)


# ------------------------------------------------------------------ K34

def _sb_model(bits: np.ndarray, e: int, qm: int) -> np.ndarray:
    """csrc/short_block.cu's encoder in numpy: the ballot word (bit i =
    message bit i), the period's bits parity(w & mask[r]) ^ ones[r], byte j
    = period bit j % P."""
    table = short_block._kernel_tables(bits.shape[1], qm, False)
    p = table.shape[1]
    w = ((bits.astype(np.int64) & 1) << np.arange(bits.shape[1])).sum(-1)
    ones = np.vectorize(lambda v: bin(int(v)).count("1") & 1)
    period = ones(w[:, None] & table[0][None]) ^ table[1][None]
    return period[:, np.arange(e) % p].astype(np.int8)


@pytest.mark.parametrize("qm", [1, 2, 4, 6])
@pytest.mark.parametrize("k", range(1, 12))
def test_short_block_period_table(k, qm):
    """The period table in message order (K14's masks with their K bits
    reversed), and the kernel's model on it equal to the twin."""
    table = short_block._kernel_tables(k, qm, False)
    msb = short_block._kernel_tables(k, qm)
    assert table.dtype == np.int32 and table.shape == msb.shape
    assert table.shape[1] == short_block._period(k, qm) <= 64
    np.testing.assert_array_equal(table[1], msb[1])
    rev = [int(format(int(v), f"0{k}b")[::-1], 2) for v in msb[0]]
    np.testing.assert_array_equal(table[0], rev)
    bits = _bits(16 * k + qm, (5, k))
    for e in sorted({k * qm, 3 * qm + 1, 32, 517}):
        want = short_block.encode_ref(torch.as_tensor(bits), e, qm).numpy()
        np.testing.assert_array_equal(_sb_model(bits, e, qm), want)


@pytest.mark.parametrize("b", [1, 4, 64])
def test_short_block_encode_params(b):
    p = short_block._encode_params(11, 512, 32, b)
    assert isinstance(p, _build.ShortBlockEncodeParams)
    assert (p.B, p.K, p.E, p.P) == (b, 11, 512, 32)
    assert p.warps == min(b, short_block.ENCODE_WARPS)
    for args in ((12, 512, 32, b), (0, 512, 32, b), (11, 512, 65, b),
                 (11, 0, 32, b), (11, 512, 32, 0)):
        with pytest.raises(ValueError):
            short_block._encode_params(*args)


# ------------------------------------------------------ warp_bits.cuh

def _store_chunk(addr: int, e: int, c: int) -> list:
    """csrc/warp_bits.cuh's store_chunk of chunk c of a row at ``addr`` mod
    16: the bytes each of its stores writes."""
    left = e - 8 * c
    if left >= 8 and (addr + 8 * c) % 8 == 0:
        return [list(range(8 * c, 8 * c + 8))]
    return [[8 * c + q] for q in range(min(8, left))]


def _store16(addr: int, e: int, c: int) -> list:
    """store16 of bytes 16c..16c+15."""
    if e - 16 * c >= 16 and (addr + 16 * c) % 16 == 0:
        return [list(range(16 * c, 16 * c + 16))]
    stores = _store_chunk(addr, e, 2 * c)
    if e > 16 * c + 8:
        stores += _store_chunk(addr, e, 2 * c + 1)
    return stores


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("e", [1, 7, 8, 9, 15, 16, 17, 33, 120, 129, 864,
                               1728])
def test_chunk_stores_write_each_byte_once(width, e):
    """Every byte of the row once, each wide store aligned and inside the
    row, at every alignment of the row."""
    store = _store_chunk if width == 8 else _store16
    for addr in range(16):
        stores = [s for c in range(-(-e // width))
                  for s in store(addr, e, c)]
        assert sorted(j for s in stores for j in s) == list(range(e))
        for s in stores:
            assert len(s) in (1, 8, 16) and (addr + s[0]) % len(s) == 0
        if addr == 0:
            assert sum(len(s) == width for s in stores) == e // width
