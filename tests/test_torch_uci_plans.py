"""K12's and K14's host plans and numpy models of their kernels, on the
CPU.

K12 (csrc/pucch_f0.cu): a numpy model of the kernel built from its launch
struct alone -- row r of candidate c's lane group of 2^lg lanes (one warp,
``passes`` groups of candidates) at port
r >> (S - 1), symbol r & (S - 1), subcarriers sc0 or sc1 on; per row t =
sum_n rx conj(ref) in two chains (even, odd n) and its |t|^2, the row's
energy likewise; the group's butterfly sums; corr / 12 as a product with
the float 1 / 12, the noise, the quotients, the first maximum and the
SR/HARQ bits of the winner from the ``maps`` word -- against JAX
``detect_format0`` on seeded grids: every ``_F0_TABLES`` dictionary, 1, 4
and 8 ports, 1 and 2 symbols, with and without a second hop, a slot axis
with shared and per-slot references, and an occasion where nothing was
sent.  Decisions, HARQ and SR equal, metric within rtol 1e-4 at 10 dB
(sums in another order).
K14 (csrc/short_block.cu, ``short_block_kernel``): its lane words and loop
index, read as the kernel reads them, give every one of the 2^K
correlations once (K = 1..11, Qm 1 to 8, in float64 against the direct
sum over the fold period), and a numpy model of the kernel from its
struct and words -- the LLRs folded over the period Q in index order, the
norm's butterfly, each lane's source sum signed by the loop index's mask
bits, the lanes' Walsh-Hadamard butterfly, the lane's first maximum, the
warp's (value, index) butterfly -- against JAX ``short_block.detect``:
K = 1..11 at Qm 1 and 2, E a multiple of the period and not, E = 512,
all-zero LLRs (ties go to candidate 0) and a slot axis.  Bits equal,
metric within rtol 1e-5.
Both launch structs' fields against the C sources, and the refusals.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import short_block as j_short_block
from srsran_tpu.phy.upper import pucch as j_pucch

from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import short_block as t_short_block
from srsran_tpu_torch.phy.upper import pucch as t_pucch

torch.set_num_threads(2)

C64 = torch.complex64
F32 = np.float32
K = 288                   # a 24-RB cell's subcarriers


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


@pytest.mark.parametrize("src,struct,cls", [
    ("pucch_f0.cu", "F0Params", _build.F0Params),
    ("short_block.cu", "ShortBlockDetectParams",
     _build.ShortBlockDetectParams)])
def test_structs_match_the_sources(src, struct, cls):
    assert _c_struct_fields(src, struct) == [f for f, _ in cls._fields_]


@pytest.mark.parametrize("src,name,value", [
    ("pucch_f0.cu", "kF0MaxPorts", _build.F0_MAX_PORTS),
    ("pucch_f0.cu", "kF0MaxCandidates", _build.F0_MAX_CANDIDATES),
    ("short_block.cu", "kSbMaxPeriod", _build.SB_MAX_PERIOD)])
def test_limits_match_the_sources(src, name, value):
    assert _c_constant(src, name) == value


def _cgauss(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale / np.sqrt(2)).astype(np.complex64)


def _tree(v: np.ndarray) -> np.ndarray:
    """A __shfl_xor_sync butterfly sum over the last axis (a power of
    two): lane i adds lane i + m for m = n/2, ..., 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = (v[..., :h] + v[..., h:]).astype(F32)
    return v[..., 0]


def _abs2(x):
    """|x|^2 as the kernels take it: x x + y y in float32."""
    x = np.asarray(x, np.complex64)
    return (x.real * x.real + x.imag * x.imag).astype(F32)


# ------------------------------------------------------------------ K12

def _k12_model(grid: np.ndarray, refs: np.ndarray, p) -> tuple:
    """csrc/pucch_f0.cu on numpy from its F0Params: (detected bool, metric
    f32, SR/HARQ row int8 [.., 1 + nb], best int64), each [slots]."""
    grid = grid.reshape((p.slots, p.P, p.nsym, p.nsc))
    refs = refs.reshape((-1, p.C, p.S, 12))
    g = 1 << p.lg
    detected = np.zeros(p.slots, bool)
    metric = np.zeros(p.slots, F32)
    row = np.zeros((p.slots, 1 + p.nb), np.int8)
    best = np.zeros(p.slots, np.int64)
    for b in range(p.slots):
        w_all = refs[b if p.refs_stride else 0]
        tsq = np.zeros((p.C, g), F32)
        energy = np.zeros(g, F32)
        for r in range(p.P * p.S):
            s, port = r & (p.S - 1), r >> (p.S - 1)
            sc = p.sc1 if s else p.sc0
            x = grid[b, port, p.l0 + s, sc:sc + 12]
            w = w_all[:, s]                                   # [C, 12]
            acc = [np.zeros(p.C, np.complex64), np.zeros(p.C, np.complex64)]
            e = [F32(0), F32(0)]
            for k in range(12):
                acc[k & 1] = (acc[k & 1] + x[k] * np.conj(w[:, k])).astype(
                    np.complex64)
                e[k & 1] = F32(e[k & 1] + _abs2(x[k]))
            tsq[:, r] = _abs2(acc[0] + acc[1])
            energy[r] = F32(e[0] + e[1])
        inv12 = F32(1) / F32(12)
        corr = (_tree(tsq) * inv12).astype(F32)
        noise = F32(max(F32(_tree(energy) - corr.max()), F32(1e-9)) * inv12)
        m = (corr / noise).astype(F32)
        bi = int(np.argmax(m))
        detected[b], metric[b], best[b] = m[bi] > F32(p.threshold), m[bi], bi
        row[b] = [(p.maps >> (bi * (1 + p.nb) + i)) & 1
                  for i in range(1 + p.nb)]
    return detected, metric, row, best


def _f0_cfg(key, nsym=2, hop=None, slot=6, m0=3):
    nbits, sr = key
    return t_pucch.PucchF0Config(prb=20, start_symbol=14 - nsym,
                                 nof_symbols=nsym, initial_cyclic_shift=m0,
                                 n_id=1, slot=slot, nof_harq_bits=nbits,
                                 sr_opportunity=sr, second_hop_prb=hop)


def _f0_grid(cfg, ports, rng, entry, snr_db=10.0):
    """One slot's grid [P, 14, K]: the dictionary entry ``entry`` sent
    (None: nothing) through a random gain a port, noise to ``snr_db`` over
    the occasion's REs."""
    grid = np.zeros((ports, 14, K), np.complex64)
    if entry is not None:
        _, sr, harq = t_pucch._F0_TABLES[(cfg.nof_harq_bits,
                                          cfg.sr_opportunity)][entry]
        one = t_pucch.transmit_format0(torch.zeros((1, 14, K), dtype=C64),
                                       cfg, harq, sr or 0)[0].numpy()
        grid = _cgauss(rng, (ports,))[:, None, None] * one
    sigma = 1.0 / np.sqrt(10 ** (snr_db / 10))
    return (grid + _cgauss(rng, grid.shape, sigma)).astype(np.complex64)


def _k12_check(grid, refs, cfgs, threshold=4.0):
    """The K12 model against JAX ``detect_format0`` slot by slot; returns
    the model's (detected, metric, row, best)."""
    slots = grid.ndim == 4
    p = t_pucch._f0_params((grid.shape, refs.shape), (C64, C64),
                           t_pucch._f0_fields(cfgs[0]), threshold)
    assert p.slots == (grid.shape[0] if slots else 1)
    out = _k12_model(grid, refs, p)
    for b, cfg in enumerate(cfgs):
        jcfg = j_pucch.PucchF0Config(**dataclasses.asdict(cfg))
        r = refs[b] if refs.ndim == 4 else refs
        ref = j_pucch.detect_format0(jnp.asarray(grid[b] if slots else grid),
                                     jcfg, threshold, ncs=jnp.asarray(r))
        assert bool(out[0][b]) == bool(ref["detected"])
        assert int(out[3][b]) == int(ref["best_mcs_index"])
        assert out[2][b, 0] == int(ref["sr_bit"])
        assert out[2][b, 1:].tolist() == np.asarray(
            ref["harq_bits"]).tolist()
        np.testing.assert_allclose(float(out[1][b]), float(ref["metric"]),
                                   rtol=1e-4)
    return out


@pytest.mark.parametrize("key", sorted(t_pucch._F0_TABLES))
def test_f0_kernel_model_every_dictionary(key):
    """Each dictionary (C = 1, 2, 4, 4, 8) with each of its entries sent,
    4 ports, 2 symbols: the model's decisions are JAX's and find what was
    sent."""
    cfg = _f0_cfg(key)
    refs = t_pucch.f0_refs_for(cfg)
    rng = np.random.default_rng(7 * key[0] + key[1])
    table = t_pucch._F0_TABLES[key]
    for entry in range(len(table)):
        out = _k12_check(_f0_grid(cfg, 4, rng, entry), refs, [cfg])
        assert bool(out[0][0]) and int(out[3][0]) == entry


@pytest.mark.parametrize("ports", [1, 4, 8])
@pytest.mark.parametrize("nsym,hop", [(1, None), (2, None), (2, 3)])
def test_f0_kernel_model_ports_symbols_hops(ports, nsym, hop):
    cfg = _f0_cfg((2, True), nsym, hop)
    p = t_pucch._f0_params(((ports, 14, K), (8, nsym, 12)), (C64, C64),
                           t_pucch._f0_fields(cfg), 4.0)
    assert 1 << p.lg >= ports * nsym > (1 << p.lg) // 2
    assert p.passes == -(-(8 << p.lg) // 32) and p.passes in (1, 2, 4)
    assert (p.sc0, p.sc1) == (240, 12 * (hop if hop is not None else 20))
    rng = np.random.default_rng(ports * nsym + (hop or 0))
    refs = t_pucch.f0_refs_for(cfg)
    for entry in (0, 5):
        _k12_check(_f0_grid(cfg, ports, rng, entry), refs, [cfg])


def test_f0_kernel_model_nothing_sent():
    """Noise alone: not detected, as JAX decides."""
    cfg = _f0_cfg((1, True))
    out = _k12_check(_f0_grid(cfg, 4, np.random.default_rng(3), None),
                     t_pucch.f0_refs_for(cfg), [cfg])
    assert not bool(out[0][0])


@pytest.mark.parametrize("per_slot", [False, True])
def test_f0_kernel_model_over_a_slot_axis(per_slot):
    """Three slots, each its own entry sent; the references per slot (each
    slot its own slot number) or shared."""
    cfgs = [_f0_cfg((2, True), slot=2 * s if per_slot else 6)
            for s in range(3)]
    rng = np.random.default_rng(41 + per_slot)
    grid = np.stack([_f0_grid(c, 4, rng, 3 * s + 1)
                     for s, c in enumerate(cfgs)])
    refs = (np.stack([t_pucch.f0_refs_for(c) for c in cfgs]) if per_slot
            else t_pucch.f0_refs_for(cfgs[0]))
    p = t_pucch._f0_params((grid.shape, refs.shape), (C64, C64),
                           t_pucch._f0_fields(cfgs[0]), 4.0)
    assert p.refs_stride == (8 * 2 * 12 if per_slot else 0)
    out = _k12_check(grid, refs, cfgs)
    assert out[3].tolist() == [1, 4, 7]


def test_f0_maps_word_is_the_dictionary():
    """Bit c (1 + nb) + i of ``maps``: candidate c's SR (i = 0) and HARQ
    bits, as ``_f0_maps`` lists them."""
    for (nb, sr), table in t_pucch._F0_TABLES.items():
        cfg = _f0_cfg((nb, sr))
        p = t_pucch._f0_params(((4, 14, K), (len(table), 2, 12)),
                               (C64, C64), t_pucch._f0_fields(cfg), 4.0)
        want = t_pucch._f0_maps(nb, sr)
        got = [[(p.maps >> (c * (1 + nb) + i)) & 1 for i in range(1 + nb)]
               for c in range(len(table))]
        assert got == want.tolist()
        assert (p.C, p.nb) == (len(table), nb)


def _f0_refusal(ports=4, nsym=2, prb=20, grid_symbols=14, slots=None,
                refs_c=8, key=(2, True)):
    lead = () if slots is None else (slots,)
    fields = (prb, 14 - nsym, nsym, None, *key)
    shapes = (lead + (ports, grid_symbols, K), (refs_c, nsym, 12))
    return lambda: t_pucch._f0_params(shapes, (C64, C64), fields, 4.0)


@pytest.mark.parametrize("change,match", [
    (dict(ports=9), "1 to 8 ports"), (dict(nsym=3), "1 or 2 symbols"),
    (dict(prb=24), "outside the grid"),
    (dict(grid_symbols=12, nsym=1), "outside the grid"),
    (dict(slots=140000), "2\\^31 elements"),
    (dict(refs_c=4), "refs must be complex64"),
    (dict(key=(0, False), refs_c=1), "nof_harq_bits=0 requires")])
def test_f0_refusals_name_their_limit(change, match):
    _f0_refusal()()                     # the unchanged call is taken
    with pytest.raises(ValueError, match=match):
        _f0_refusal(**change)()


# ------------------------------------------------------------------ K14

def _k14_lanes(fold: np.ndarray, p, table: np.ndarray, dtype=F32):
    """The lanes of csrc/short_block.cu's loop from the folded LLRs [32]
    (zeros past Q) and the lane words: yields (candidate index [32], its
    correlation [32], whether the lane holds a candidate [32]) for each
    loop index j < nk, the lanes' Walsh-Hadamard butterfly in the kernel's
    order."""
    lanes = np.arange(32)
    src, valid = table & 31, (table >> 5) & 1
    own, cand = (table >> 6) & 1, (table >> 7) & 1
    kmask, part = (table >> 8) & 255, table >> 16
    v = np.where(own == 1, -fold, fold).astype(dtype)
    g = np.where(valid == 1, v[src], 0).astype(dtype)
    for j in range(p.nk):
        par = np.array([bin(j & int(m)).count("1") & 1 for m in kmask])
        x = np.where(par == 1, -g, g).astype(dtype)
        for s in (1, 2, 4, 8, 16):
            y = x[lanes ^ s]
            x = np.where(lanes & s, y - x, x + y).astype(dtype)
        c = ((j >> p.ks) << p.kt) | (j & ((1 << p.ks) - 1)) | part
        yield c, x, cand == 1


def _k14_model(llr: np.ndarray, p, table: np.ndarray) -> tuple:
    """csrc/short_block.cu's detect kernel on numpy from its
    ShortBlockDetectParams and lane words: (bits int8 [B, K], metric f32
    [B])."""
    llr = np.asarray(llr, F32).reshape(p.B, p.E)
    lanes = np.arange(32)
    bits = np.zeros((p.B, p.K), np.int8)
    metric = np.zeros(p.B, F32)
    for cw in range(p.B):
        x = llr[cw]
        fold = np.zeros(32, F32)
        sq = np.zeros(32, F32)
        for r in range(p.Q):
            for j in range(r, p.E, p.Q):
                fold[r] = F32(fold[r] + x[j])
                sq[r] = F32(sq[r] + x[j] * x[j])
        norm2 = _tree(sq)
        best = np.full(32, -np.inf, F32)
        idx = np.zeros(32, np.int64)
        for c, corr, cand in _k14_lanes(fold, p, table):
            take = cand & (corr > best)
            best, idx = np.where(take, corr, best), np.where(take, c, idx)
        m = 16
        while m >= 1:
            ov, oi = best[lanes ^ m], idx[lanes ^ m]
            take = (ov > best) | ((ov == best) & (oi < idx))
            best, idx = np.where(take, ov, best), np.where(take, oi, idx)
            m >>= 1
        bi = int(idx[0])
        bits[cw] = [(bi >> (p.K - 1 - i)) & 1 for i in range(p.K)]
        metric[cw] = F32(best[0] / F32(F32(np.sqrt(norm2) * F32(p.sqrt_e))
                                       + F32(1e-9)))
    return bits, metric


@pytest.mark.parametrize("k", range(1, 12))
@pytest.mark.parametrize("qm", [1, 2, 4, 6, 8])
def test_sb_lane_words_give_every_correlation(k, qm):
    """The lane words and the loop index, read as the kernel reads them,
    give each of the 2^K candidates once, on a lane that holds candidates,
    with sum_r (-1)^(ones[r] ^ parity(c & mask[r])) fold[r] over the fold
    period Q (a multiple of the code's period), in float64 on random
    folds: the transform over the lanes is exact up to rounding."""
    p = t_short_block._detect_params(k, qm, 100, 3)
    table = t_short_block._detect_table(k, qm)
    masks, ones = t_short_block._kernel_tables(k, qm)
    period = masks.shape[0]
    assert p.Q % period == 0 and p.Q <= 32 < p.Q + period
    fold = np.zeros(32)
    fold[:p.Q] = np.random.default_rng(k + 10 * qm).standard_normal(p.Q)
    r = np.arange(p.Q)
    got = {}
    for c, corr, cand in _k14_lanes(fold, p, table, np.float64):
        for lane in np.nonzero(cand)[0]:
            assert int(c[lane]) not in got
            got[int(c[lane])] = corr[lane]
    assert sorted(got) == list(range(1 << k))
    for c, corr in got.items():
        par = np.array([bin(c & int(m)).count("1") & 1
                        for m in masks[r % period]])
        want = np.sum(np.where(par ^ ones[r % period], -1.0, 1.0) * fold[r])
        assert abs(corr - want) < 1e-9


def _sb_llrs(k, qm, e, n, rng, zero_rows=()):
    msg = torch.as_tensor(rng.integers(0, 2, (n, k)).astype(np.int8))
    cw = t_short_block.encode(msg, e, qm).numpy()
    llr = ((1.0 - 2.0 * cw) + rng.standard_normal(cw.shape)).astype(F32)
    llr[list(zero_rows)] = 0.0
    return llr


def _k14_check(llr, k, qm):
    """The K14 model against JAX ``short_block.detect`` on [B, E]."""
    p = t_short_block._detect_params(k, qm, llr.shape[-1], llr.shape[0])
    bits, metric = _k14_model(llr, p, t_short_block._detect_table(k, qm))
    j_bits, j_metric = j_short_block.detect(jnp.asarray(llr), k, qm)
    np.testing.assert_array_equal(bits, np.asarray(j_bits))
    np.testing.assert_allclose(metric, np.asarray(j_metric), rtol=1e-5,
                               atol=1e-6)
    return bits, metric


@pytest.mark.parametrize("k", range(1, 12))
@pytest.mark.parametrize("qm,e", [(1, 32), (2, 37), (1, 100)])
def test_sb_kernel_model_matches_jax(k, qm, e):
    """K = 1..11 at Qm 1 and 2, E a multiple of the fold period or not;
    a row of all-zero LLRs decides candidate 0 as argmax does."""
    rng = np.random.default_rng(100 * k + e)
    llr = _sb_llrs(k, qm, e, 5, rng, zero_rows=(4,))
    bits, metric = _k14_check(llr, k, qm)
    assert not bits[4].any() and metric[4] == 0


@pytest.mark.parametrize("k,qm", [(11, 2), (6, 2), (2, 2), (1, 2)])
def test_sb_kernel_model_at_e512(k, qm):
    _k14_check(_sb_llrs(k, qm, 512, 3, np.random.default_rng(512 + k)),
               k, qm)


def test_sb_kernel_model_over_a_slot_axis():
    """A slot axis [S, B, E] folds into S B codewords: the model on the
    flat rows against JAX slot by slot, and the plan's B is S B."""
    rng = np.random.default_rng(61)
    llr = _sb_llrs(6, 2, 32, 12, rng).reshape(4, 3, 32)
    p = t_short_block._detect_params(6, 2, 32, 12)
    assert (p.B, p.warps) == (12, t_short_block.DETECT_WARPS)
    bits, metric = _k14_model(llr.reshape(12, 32), p,
                              t_short_block._detect_table(6, 2))
    for s in range(4):
        j_bits, j_metric = j_short_block.detect(jnp.asarray(llr[s]), 6, 2)
        np.testing.assert_array_equal(bits[3 * s:3 * s + 3],
                                      np.asarray(j_bits))
        np.testing.assert_allclose(metric[3 * s:3 * s + 3],
                                   np.asarray(j_metric), rtol=1e-5)


@pytest.mark.parametrize("args,match", [
    ((0, 2, 32, 1), "K 1..11"), ((12, 2, 32, 1), "K 1..11"),
    ((6, 2, 0, 1), "E >= 1"), ((6, 2, 32, 0), "B and E >= 1"),
    ((6, 2, 1 << 16, 1 << 15), "2\\^31 LLRs"),
    ((2, 24, 32, 1), "period 72: K14 takes at most 32")])
def test_sb_refusals_name_their_limit(args, match):
    t_short_block._detect_params(6, 2, 32, 1)      # the flagship is taken
    with pytest.raises(ValueError, match=match):
        t_short_block._detect_params(*args)
