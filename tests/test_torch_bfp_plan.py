"""K23's and K24's host plans and numpy models of their kernels, on the
CPU.

The quotient K24 rests on (csrc/bfp.cu), for every mantissa m in
[-2^15, 2^15) and every exponent e in 0..15: IEEE(m / 32767) x 2^e is the
IEEE quotient of m 2^e by 32767, and IEEE(m / 32767) is q0 = m r (r =
RN(1 / 32767)) after one Newton step on the remainder, two FMAs -- bit for
bit, each FMA rounded once from its exact value (numpy float32, float64
where exact, and the rounding error of the last sum).
K24 (``bfp_decompress_sections_kernel``): a numpy model built from its
launch structs alone (:func:`compression._sections_params`) and the byte
buffer -- per tile, the aligned 16-byte chunks covering its records staged
over stale bytes, each lane's exponent and its 24 fields taken from two
byte-swapped words by a funnel shift, each value the quotient times 2^e,
each PRB of the tile written -- against the
plain twin ``decompress_sections_ref``: the flagship cases of
``flagship.ofh_kernel_cases`` and ``ofh_profile_cases``, 1- to 18-PRB
sections at odd byte offsets at every width from 1 to 16 and at every
address of the buffer mod 16, a table of mixed widths, and one of more
tiles than a launch takes.  The tiles cover each section's PRBs exactly
once, in table order.  K24's (exp, mant) mode and K23's byte packing as
numpy models against the twins at every width.  The launch structs'
fields and limits against the C source, and the refusals past them.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ofh import compression as jc

from srsran_tpu_torch import flagship
from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ofh import compression as tc

torch.set_num_threads(2)

F32 = np.float32
SCALE = F32(32767)


def _c_struct_fields(src: str, struct: str) -> list:
    """The field names of a C struct in csrc, in order (arrays by name)."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / src).read_text())
    body = re.search(rf"struct {struct} {{(.*?)}};", text, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            _, rest = decl.split(None, 1)
            names += [re.sub(r"\[.*\]", "", v).strip()
                      for v in rest.split(",")]
    return names


def _c_constant(src: str, name: str) -> int:
    text = (_build.CSRC / src).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("struct,cls", [
    ("BfpCompressParams", _build.BfpCompressParams),
    ("BfpTile", _build.BfpTile),
    ("BfpSectionsParams", _build.BfpSectionsParams),
    ("BfpExpandParams", _build.BfpExpandParams)])
def test_structs_match_the_source(struct, cls):
    assert _c_struct_fields("bfp.cu", struct) == [f for f, _ in cls._fields_]


@pytest.mark.parametrize("name,value", [
    ("kBfpMaxTiles", _build.BFP_MAX_TILES),
    ("kBfpTilePrbs", _build.BFP_TILE_PRBS),
    ("kBfpPrbBits", _build.BFP_PRB_BITS)])
def test_limits_match_the_source(name, value):
    assert _c_constant("bfp.cu", name) == value


def test_struct_sizes():
    """Two ints, then the tiles two ints each: the C layout, no padding."""
    assert ctypes.sizeof(_build.BfpTile) == 8
    assert (ctypes.sizeof(_build.BfpSectionsParams)
            == 8 + 8 * _build.BFP_MAX_TILES)
    assert ctypes.sizeof(_build.BfpCompressParams) == 8
    # the tile word's fields: 22 bits of PRB, 5 of n - 1, 4 of width - 1
    assert _build.BFP_PRB_BITS + 5 + 4 == 31
    assert _build.BFP_TILE_PRBS == 32


@pytest.mark.parametrize("e", range(16))
def test_quotient_identity(e):
    """IEEE(m / 32767) x 2^e == IEEE(m 2^e / 32767) for every 16-bit m."""
    m = np.arange(-(1 << 15), 1 << 15, dtype=np.int64)
    table = m.astype(F32) / SCALE * F32(2.0 ** e)
    direct = (m << e).astype(F32) / SCALE
    assert (m << e).astype(F32).astype(np.int64).tolist() == (m << e).tolist()
    np.testing.assert_array_equal(table.view(np.uint32),
                                  direct.view(np.uint32))


def _rn32_sum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 RN(a + b) of exact float64 terms, rounded once: the double
    sum's own rounding error (two-sum) decides a sum that lands exactly
    halfway between two float32 values."""
    s = a + b
    t = s - a
    err = (a - (s - t)) + (b - t)
    f = s.astype(F32)
    lo = np.where(f.astype(np.float64) > s, np.nextafter(f, F32(-np.inf)), f)
    hi = np.nextafter(lo, F32(np.inf))
    tie = s == (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    return np.where(tie & (err > 0), hi, np.where(tie & (err < 0), lo, f))


def _quotient(m: np.ndarray) -> np.ndarray:
    """csrc/bfp.cu ``quotient``: q0 = RN(m r), then RN(RN(m - 32767 q0) r
    + q0).  m r, 32767 q0, m - 32767 q0 and the remainder's product are
    exact in float64 (at most 40, 39, 53 and 48 bits)."""
    r = F32(1) / SCALE
    x = m.astype(F32).astype(np.float64)
    q0 = (x * np.float64(r)).astype(F32)
    rem = (x - q0.astype(np.float64) * np.float64(SCALE)).astype(F32)
    return _rn32_sum(rem.astype(np.float64) * np.float64(r),
                     q0.astype(np.float64))


def test_quotient_is_the_ieee_quotient():
    """The two-FMA quotient of every 16-bit mantissa is IEEE m / 32767."""
    m = np.arange(-(1 << 15), 1 << 15, dtype=np.int64)
    assert F32(1) / SCALE == F32(float.fromhex("0x1.0002p-15"))
    np.testing.assert_array_equal(_quotient(m).view(np.uint32),
                                  (m.astype(F32) / SCALE).view(np.uint32))


def test_rn32_sum_rounds_once():
    """The model's rounding of a sum, at ties broken by the error term and
    at exact ties to even, against exact rational arithmetic."""
    from fractions import Fraction
    one, ulp = 1.0, 2.0 ** -23
    a = np.array([one, one, one, one + ulp, one], np.float64)
    b = np.array([ulp / 2, ulp / 2 + 2.0 ** -60, ulp / 2 - 2.0 ** -60,
                  ulp / 2, 2.0 ** -70], np.float64)
    want = [F32(one), F32(one + ulp), F32(one), F32(one + 2 * ulp), F32(one)]
    got = _rn32_sum(a, b)
    assert got.tolist() == want
    for x, y, g in zip(a, b, got):
        exact = Fraction(float(x)) + Fraction(float(y))
        assert abs(Fraction(float(g)) - exact) <= Fraction(2) ** -24


# ------------------------------------------------------------ K24 model

def _big_endian_words(stage: np.ndarray) -> np.ndarray:
    """The staged bytes as 32-bit words, each byte-swapped
    (``__byte_perm(w, 0, 0x0123)`` of the little-endian word)."""
    return stage.view("<u4").byteswap().astype(np.uint64)


def _k24_model(params, buf: np.ndarray, grid: np.ndarray, shift: int = 0,
               seed: int = 0) -> np.ndarray:
    """csrc/bfp.cu's ``bfp_decompress_sections_kernel`` from its launch
    structs: writes ``grid`` (complex64, in place) and returns how often
    each PRB was written.  ``shift``: the buffer's address mod 16 (the
    kernel's chunks are aligned on the address); the stage starts as stale
    bytes."""
    rng = np.random.default_rng(seed)
    flat = grid.view(np.float32).reshape(-1, 24)
    written = np.zeros(len(flat), np.int32)
    for p in params:
        tiles = np.frombuffer(bytes(p.tiles), np.int32).reshape(-1, 2)
        for start, word in tiles[:p.ntiles].astype(np.int64):
            prb = word & ((1 << _build.BFP_PRB_BITS) - 1)
            n = ((word >> _build.BFP_PRB_BITS) & 31) + 1
            w = ((word >> (_build.BFP_PRB_BITS + 5)) & 15) + 1
            r = 1 + 3 * w
            assert 0 <= start and start + n * r <= p.buf_len
            off0 = (shift + start) % 16
            first = start - off0                 # a buffer index, maybe < 0
            nch = (off0 + n * r + 15) // 16
            assert nch <= 100
            stage = rng.integers(0, 256, 1600, dtype=np.uint8)
            idx = first + np.arange(16 * nch)
            inside = (idx >= 0) & (idx < p.buf_len)
            stage[:16 * nch] = np.where(inside, buf[np.clip(idx, 0, len(buf)
                                                            - 1)], 0)
            words = _big_endian_words(stage)
            b = off0 + r * np.arange(n)
            e = (stage[b] & 0x0F).astype(np.int64)
            bit = 8 * b[:, None] + 8 + w * np.arange(24)
            x = ((((words[bit >> 5] << np.uint64(32)) | words[(bit >> 5) + 1])
                  << (bit & 31).astype(np.uint64)) >> np.uint64(32)
                 ) & np.uint64(0xFFFFFFFF)
            m = x.astype(np.uint32).view(np.int32).astype(np.int64) >> (32 - w)
            flat[prb:prb + n] = _quotient(m) * np.ldexp(F32(1), e)[
                :, None].astype(F32)
            written[prb:prb + n] += 1
    return written


def _covered(rows, grid_shape) -> np.ndarray:
    """How often the table's sections cover each PRB of the flat grid."""
    ports, nsym, nsc = grid_shape
    cover = np.zeros(ports * nsym * (nsc // 12), np.int32)
    for _, port, sym, p0, n, _ in np.asarray(rows).reshape(-1, 6):
        a = (port * nsym + sym) * (nsc // 12) + p0
        cover[a:a + n] += 1
    return cover


def _check_k24(buf: torch.Tensor, table: torch.Tensor, grid: torch.Tensor,
               shift: int = 0, launches: int | None = None) -> None:
    """The model on the plan's structs, bit for bit against the twin, and
    the tiles covering exactly the sections' PRBs, once each."""
    rows = table.numpy()
    tc.validate_table(rows, buf.numel(), tuple(grid.shape))
    params = tc._sections_params(rows, buf.numel(), tuple(grid.shape))
    if launches is not None:
        assert len(params) == launches
    want = tc.decompress_sections_ref(buf, table, grid.clone()).numpy()
    got = grid.numpy().copy()
    written = _k24_model(params, buf.numpy(), got, shift)
    np.testing.assert_array_equal(written, _covered(rows, grid.shape))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _flagship_cases(name: str) -> dict:
    rng = np.random.default_rng(11)
    return {**flagship.ofh_kernel_cases(rng, "cpu"),
            **flagship.ofh_profile_cases(rng, "cpu")}[name]


@pytest.mark.parametrize("name", ["bfp_decompress", "bfp_decompress_w8",
                                  "bfp_decompress_w14", "bfp_decompress_small",
                                  "bfp_decompress_batch2"])
def test_k24_model_on_the_flagship_cases(name):
    """One launch each: 504 tiles (255 + 18 PRB sections), 336 (1-, 7-,
    18-PRB sections at odd offsets), 1,008 (two slots' grids)."""
    _, _, (buf, table) = _flagship_cases(name)
    shape = (8 if name.endswith("batch2") else 4, 14, flagship.CELL.nof_sc)
    grid = torch.zeros(shape, dtype=torch.complex64)
    _check_k24(buf, table, grid, launches=1)


def _odd_sections(width: int, rng, grid_shape=(2, 3, 12 * 70),
                  runs=((0, 1), (3, 7), (12, 18), (31, 33), (66, 4))):
    """A packed grid's runs at odd offsets (flagship._scattered_sections)
    over a grid of 3 + 3j (others untouched)."""
    iq = torch.from_numpy(flagship._ofh_grid(rng, grid_shape))
    payload = tc.compress_ref(iq, width)[2].numpy()
    buf, rows = flagship._scattered_sections(payload, runs, width, rng)
    grid = torch.full(grid_shape, 3 + 3j, dtype=torch.complex64)
    return torch.from_numpy(buf), tc.section_table(rows), grid


@pytest.mark.parametrize("width", range(1, 17))
def test_k24_model_small_sections_every_width(width):
    """1-, 7-, 18-, 33- and 4-PRB sections in a seeded order at odd
    offsets."""
    buf, table, grid = _odd_sections(width, np.random.default_rng(width))
    _check_k24(buf, table, grid, launches=1)


@pytest.mark.parametrize("shift", [1, 7, 15])
def test_k24_model_any_buffer_address(shift):
    """The chunks aligned on the buffer's address, whatever it is mod 16;
    the chunks reaching past either end read byte by byte."""
    buf, table, grid = _odd_sections(9, np.random.default_rng(shift))
    _check_k24(buf, table, grid, shift=shift)


def test_k24_model_mixed_widths():
    """Widths 9, 14 and 4 in one table, each tile at its own width."""
    rng = np.random.default_rng(5)
    parts = [_odd_sections(w, rng, runs=((3 * i, 2),))
             for i, w in enumerate((9, 14, 4))]
    rows, off = [], 0
    for buf, table, _ in parts:
        t = table.numpy().copy()
        t[:, 0] += off
        rows.append(t)
        off += buf.numel()
    table = torch.from_numpy(np.concatenate(rows))
    buf = torch.cat([b for b, _, _ in parts])
    _check_k24(buf, table, parts[0][2], launches=1)


def test_k24_model_past_one_launch():
    """1,344 one-PRB sections: two launches, 1,024 tiles then 320."""
    rng = np.random.default_rng(3)
    shape = (4, 14, 12 * 24)
    iq = torch.from_numpy(flagship._ofh_grid(rng, shape))
    payload = tc.compress_ref(iq, 9)[2].numpy()
    buf, rows = flagship._scattered_sections(
        payload, tuple((p, 1) for p in range(24)), 9, rng)
    table = tc.section_table(rows)
    grid = torch.zeros(shape, dtype=torch.complex64)
    params = tc._sections_params(table.numpy(), len(buf), shape)
    assert [p.ntiles for p in params] == [1024, 320]
    _check_k24(torch.from_numpy(buf), table, grid, launches=2)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 255, 273])
def test_tiles_in_table_order(n):
    """A section of n PRBs: ceil(n / 32) tiles of 32 PRBs, the last the
    rest, at the records' byte offsets; an empty one none."""
    rows = np.array([[5, 1, 2, 0, n, 9], [1000, 0, 0, 3, 2, 14]], np.int32)
    tiles = tc._tiles(rows, (2, 3, 12 * 273)).astype(np.int64)
    k = -(-n // 32)
    assert len(tiles) == k + 1
    start, word = tiles.T
    prb = word & ((1 << 22) - 1)
    cnt = ((word >> 22) & 31) + 1
    width = (word >> 27) + 1
    assert start.tolist() == [5 + 32 * i * 28 for i in range(k)] + [1000]
    assert prb.tolist() == [(1 * 3 + 2) * 273 + 32 * i for i in range(k)] + [3]
    assert cnt[:k].sum() == n and (cnt[:k - 1] == 32).all()
    assert width.tolist() == [9] * k + [14] and cnt[-1] == 2


@pytest.mark.parametrize("shape,buf_len,match", [
    ((64, 14, 12 * 4700), 100, "2\\^22 PRBs"),
    ((4, 14, 3276), 1 << 31, "2\\^31 bytes")])
def test_sections_params_refuse_past_their_fields(shape, buf_len, match):
    rows = np.array([[0, 0, 0, 0, 1, 9]], np.int32)
    with pytest.raises(ValueError, match=match):
        tc._sections_params(rows, buf_len, shape)


# ---------------------------------------------- K24 (exp, mant), K23 models

def _expand_model(exp: np.ndarray, mant: np.ndarray) -> np.ndarray:
    """csrc/bfp.cu's ``bfp_decompress_kernel``: the quotient times 2^e for
    |m| <= 2^15 and e <= 15, else (float)(int)((unsigned)m << e) / 32767;
    complex64 [..., 12 P]."""
    e = exp.astype(np.int64)[..., None]
    m = mant.astype(np.int64)
    inside = (e <= 15) & (m >= -(1 << 15)) & (m < 1 << 15)
    lookup = _quotient(np.where(inside, m, 0)) * np.ldexp(
        F32(1), np.minimum(e, 15)).astype(F32)
    shifted = np.where(e < 32, (m << np.minimum(e, 31)) & 0xFFFFFFFF, 0)
    direct = shifted.astype(np.uint32).view(np.int32).astype(F32) / SCALE
    f = np.where(inside, lookup, direct)
    return f.astype(F32).reshape(*f.shape[:-2], -1).view(np.complex64)


@pytest.mark.parametrize("width", [1, 4, 9, 12, 14, 16])
def test_expand_model_matches_the_twin(width):
    """Width 1 reaches e = 16 (a -32768 value): the division."""
    iq = flagship._ofh_grid(np.random.default_rng(width), (2, 3, 12 * 20))
    iq[0, 0, :4] = [1.0, -1.0 + 1j, -1.00001 - 1.00001j, 3.0 - 7.5j]
    exp, mant, _ = tc.compress_ref(torch.from_numpy(iq), width,
                                   mantissas=True)
    want = tc.bfp_decompress_ref(exp, mant).numpy()
    got = _expand_model(exp.numpy(), mant.numpy())
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    j_exp, j_mant = jc.bfp_compress(jnp.asarray(iq), width)
    np.testing.assert_array_equal(
        got, np.asarray(jc.bfp_decompress(j_exp, j_mant)))


def _pack_model(exp: np.ndarray, mant: np.ndarray, width: int) -> np.ndarray:
    """csrc/bfp.cu's ``bfp_compress_kernel`` record: the exponent byte,
    then per field acc = acc << w | field and at most two bytes out."""
    acc = np.zeros(len(exp), np.uint64)
    nacc, out = 0, [exp.astype(np.uint64) & np.uint64(0x0F)]
    for i in range(24):
        field = mant[:, i].astype(np.int64) & ((1 << width) - 1)
        acc = ((acc << np.uint64(width)) | field.astype(np.uint64)
               ) & np.uint64(0xFFFFFFFF)
        nacc += width
        for _ in range(2):
            if nacc >= 8:
                nacc -= 8
                out.append((acc >> np.uint64(nacc)) & np.uint64(0xFF))
    assert nacc == 0 and len(out) == tc.record_bytes(width)
    return np.stack(out, axis=-1).astype(np.uint8)


@pytest.mark.parametrize("width", range(1, 17))
def test_pack_model_matches_the_twin(width):
    """K23's byte packing, at every width, against compress_ref's payload
    and the JAX package's pack_section."""
    iq = flagship._ofh_grid(np.random.default_rng(width), (1, 2, 12 * 40))
    exp, mant, payload = tc.compress_ref(torch.from_numpy(iq), width,
                                         mantissas=True)
    got = _pack_model(exp.numpy().reshape(-1), mant.numpy().reshape(-1, 24),
                      width)
    np.testing.assert_array_equal(got, payload.numpy().reshape(got.shape))
    # a warp's tile of 32 records stays 16-byte aligned
    assert 32 * tc.record_bytes(width) % 16 == 0
    j_exp, j_mant = jc.bfp_compress(jnp.asarray(iq[0, 0]), width)
    assert jc.pack_section(np.asarray(j_exp), np.asarray(j_mant),
                           width) == got[:40].tobytes()
