"""K6's (K22's) and K3's host plans and numpy models of their kernels, on
the CPU.

K6 (csrc/pdsch_map.cu): a numpy model of the kernel built from its launch
struct alone -- the closed-form codeblock and first RE of each tile (the
codeblock sizes as two runs of equal E), each bit plane's run of the
circular buffer from its once-a-tile start (stepped by E / Qm mod N_nf),
with its wrap at N_nf and its jump over the fillers, the packed Gold words
read through one 64-bit window an RE, the level table, and the precode and
grid add rounded in the kernel's order -- against the JAX chain
``rate_match_batch`` -> ``scramble_bits`` -> ``modulate`` -> ``layer_map``
-> ``precode`` / ``precode_prg`` on seeded codeblocks and grids: QPSK to
256QAM, 1-4 layers, rv 0-3, n_ref, the repetition shape (E beyond N_nf), a
PRG table and a slot axis.  The layer symbols are bit-equal to JAX's; the
grid is within 1e-6 of its largest magnitude (JAX's einsum sums the layers
in its own order), and bit-equal to the port's twin with a PRG table (its
products and sums rounded as the kernel's).
K3 (csrc/pusch_demap.cu): a numpy model of the kernel's outputs -- the
closed-form ZF solve with one reciprocal a solve and one a layer's noise,
the demap by that reciprocal, the Gold signs from the packed words with
the call's offset folded in, and the store order (RE-major, layer-minor,
then b0(I) b1(Q) ...) -- against JAX ``equalize_zf_1xn`` / ``_2xn`` ->
``demodulate`` -> ``descramble_llrs`` for every demap kind at 1 and 2
layers from an odd first symbol (pi/2-BPSK's rot0), within K3's tolerance
on the card (rtol 1e-4, atol 1e-4 of the largest magnitude: the model's
reciprocals are IEEE, the kernel's the SFU's, within 2 ulp).
Both launch structs' fields against the C sources (K3 takes K16's), and
the new refusals.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import equalizer as j_eq
from srsran_tpu.ops import ldpc_rate_match as j_rm
from srsran_tpu.ops import modulation as j_mod
from srsran_tpu.ops import precoding as j_pre
from srsran_tpu.ops import scrambling as j_scr
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc

from srsran_tpu_torch import flagship
from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import dl_map, gold, ul_demap
from srsran_tpu_torch.ops.modulation import BITS_PER_SYMBOL
from srsran_tpu_torch.phy.upper import pdsch, pusch
from srsran_tpu_torch.ran.precoding_codebooks import PrecodingConfig, nof_prgs

torch.set_num_threads(2)

C64 = np.complex64
F32 = np.float32
I32 = torch.int32
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


def _cgauss(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale / np.sqrt(2)).astype(C64)


# ------------------------------------------------------------------ K6

def _pdsch(**kw):
    base = dict(rnti=0x4601, rb_start=0, rb_count=24, first_symbol=1,
                nof_symbols=12, modulation="qam256", target_code_rate=0.8,
                tbs=tbs_calc(24, 12, 24, "qam256", 0.8, 4), nof_layers=4,
                n_id=1, dmrs_symbols=(2, 11))
    base.update(kw)
    return pdsch.PdschConfig(**base)


def _pdsch_at(modulation: str, layers: int, rv: int, **kw):
    rate = {"qpsk": 0.3, "qam16": 0.5, "qam64": 0.6, "qam256": 0.8}[
        modulation]
    return _pdsch(modulation=modulation, nof_layers=layers, rv=rv,
                  target_code_rate=rate,
                  tbs=tbs_calc(24, 12, 24, modulation, rate, layers), **kw)


def _k6_inputs(cfg, rng, lead=(), ports=4, nsc=K, n_ref=0):
    """(grid numpy [lead, P, S, K], map_args as the wrapper takes them
    without the grid (on the CPU), the precoder numpy) for random
    codeblocks of ``cfg``'s segmentation."""
    seg = pdsch.segmentation(cfg)
    cbs = rng.integers(0, 2, lead + (seg.nof_codeblocks,
                                     seg.codeword_bits)).astype(np.int8)
    if cfg.precoding:
        w = _cgauss(rng, (nof_prgs(*pdsch.prg_span(cfg),
                                   cfg.precoding.prg_size), ports,
                          cfg.nof_layers), 0.5)
    else:
        w = _cgauss(rng, (ports, cfg.nof_layers), 0.5)
    grid = _cgauss(rng, lead + (ports, 14, nsc), 0.1)
    args = pdsch.map_args(torch.from_numpy(grid), cfg, torch.from_numpy(cbs),
                          torch.from_numpy(w))[1:]
    prg = cfg.precoding.prg_size if cfg.precoding else 0
    return grid, args + (prg, pdsch.prg_span(cfg)[0], n_ref), w


def _k6_params(grid: np.ndarray, args: tuple):
    cbs, e_sizes, rv, modulation, bg, z, k_prime, k, _, n_l, sym, sc, w, \
        prg, rb_start, n_ref = args
    return dl_map._map_params(
        (grid.shape, tuple(cbs.shape), tuple(sym.shape), tuple(sc.shape),
         tuple(w.shape)),
        (torch.complex64, cbs.dtype, sym.dtype, sc.dtype, w.dtype),
        tuple(e_sizes), rv, modulation, bg, z, k_prime, k, n_l, prg,
        rb_start, n_ref)


def _cmul(wr, wi, xr, xi):
    """(w x) rounded as the kernel's cmul: products, then one add each."""
    return (wr * xr - wi * xi).astype(F32), (wr * xi + wi * xr).astype(F32)


def _k6_model(p, grid: np.ndarray, cbs: np.ndarray, sym: np.ndarray,
              sc: np.ndarray, w: np.ndarray, words: np.ndarray) -> tuple:
    """The kernel on the CPU from its struct ``p``: (grid after the add,
    layer symbols [slots, RE, L])."""
    qm, n_l, n_p = p.qm, p.L, p.P
    levels = np.asarray(p.levels[:1 << (qm // 2)], F32)
    words = words.view(np.uint32).astype(np.uint64)
    g = grid.reshape((p.nslots, n_p) + grid.shape[-2:]).copy()
    cw = cbs.reshape((p.nslots, p.C, p.N))
    w_all = w.reshape((p.nslots if p.w_stride else 1,) + w.shape[-2 - (
        p.prg_size > 0):])
    xs = np.zeros((p.nslots, p.nre, n_l), C64)
    for slot in range(p.nslots):
        wt = w_all[slot if p.w_stride else 0]
        for cb in range(p.C):
            n_cb = p.n0 if cb < p.C0 else p.n1
            before = min(cb, p.C0)
            for tile in range(p.tiles):
                r0 = tile * p.T                    # the tile's first RE
                nt = min(p.T, n_cb - r0)
                if nt <= 0:
                    continue
                re0 = before * p.n0 + (cb - before) * p.n1 + r0
                m = nt * n_l
                q0 = (p.k0p + r0 * n_l) % p.n_nf   # once a tile
                step = (n_cb * n_l) % p.n_nf
                planes = np.empty((qm, m), np.int64)
                for b in range(qm):
                    q = q0 + np.arange(m)
                    while (q >= p.n_nf).any():     # the wrap
                        q = np.where(q >= p.n_nf, q - p.n_nf, q)
                    pos = np.where(q < p.fs, q, q + p.gap)   # the fillers
                    planes[b] = cw[slot, cb, pos]
                    q0 = q0 + step
                    q0 = q0 - p.n_nf if q0 >= p.n_nf else q0
                re = re0 + np.arange(nt)
                g0 = re * (n_l * qm)
                pair = words[g0 >> 5] | (words[(g0 >> 5) + 1] << np.uint64(32))
                gbits = (pair >> (g0 & 31).astype(np.uint64)) & np.uint64(
                    0xFFFFFFFF)
                for l in range(n_l):
                    vi = np.zeros(nt, np.int64)
                    vq = np.zeros(nt, np.int64)
                    for b in range(qm):
                        bit = (planes[b, np.arange(nt) * n_l + l] ^ (
                            gbits >> np.uint64(l * qm + b)).astype(
                                np.int64)) & 1
                        if b & 1:
                            vq = (vq << 1) | bit
                        else:
                            vi = (vi << 1) | bit
                    xs[slot, re, l] = levels[vi] + 1j * levels[vq]
                s, k = sym[re], sc[re]
                mat = (wt[k // 12 // p.prg_size - p.prg_base]
                       if p.prg_size else np.broadcast_to(wt, (nt,) + wt.shape))
                x = xs[slot, re]
                for pp in range(n_p):
                    ar, ai = _cmul(mat[:, pp, 0].real, mat[:, pp, 0].imag,
                                   x[:, 0].real, x[:, 0].imag)
                    for l in range(1, n_l):
                        tr, ti = _cmul(mat[:, pp, l].real, mat[:, pp, l].imag,
                                       x[:, l].real, x[:, l].imag)
                        ar, ai = (ar + tr).astype(F32), (ai + ti).astype(F32)
                    v = g[slot, pp, s, k]
                    g[slot, pp, s, k] = ((v.real + ar).astype(F32)
                                         + 1j * (v.imag + ai).astype(F32))
    return g.reshape(grid.shape), xs


def _k6_jax(grid: np.ndarray, args: tuple) -> tuple:
    """The JAX chain for one slot: (grid after the add, layers [RE, L])."""
    cbs, e_sizes, rv, modulation, bg, z, k_prime, k, c_init, n_l, sym, sc, \
        w, prg, rb_start, n_ref = args
    qm = BITS_PER_SYMBOL[modulation]
    cw = j_rm.rate_match_batch(jnp.asarray(cbs.numpy()), tuple(e_sizes), rv,
                               qm, bg, z, k_prime, k, n_ref)
    bits = j_scr.scramble_bits(cw[None], c_init)
    layers = j_pre.layer_map(j_mod.modulate(bits, modulation)[0], n_l)
    sym, sc = sym.numpy(), sc.numpy()
    if prg:
        prg_of_re = sc // 12 // prg - rb_start // prg
        out = j_pre.precode_prg(layers, jnp.asarray(w.numpy()),
                                jnp.asarray(prg_of_re))
    else:
        out = j_pre.precode(layers, jnp.asarray(w.numpy()))
    g = grid.copy()
    g[:, sym, sc] += np.asarray(out)
    return g, np.asarray(layers).T


def _check_k6(grid: np.ndarray, args: tuple, lead=()) -> None:
    p = _k6_params(grid, args)
    words = gold.gold_words(args[8], p.nre * p.L * p.qm)
    cbs, sym, sc, w = (args[0].numpy(), args[10].numpy(), args[11].numpy(),
                       args[12].numpy())
    got, xs = _k6_model(p, grid, cbs, sym, sc, w, words)
    per_slot_w = w.ndim == (4 if args[13] else 3)
    for b in range(lead[0] if lead else 1):
        slot = args if not lead else (args[0][b],) + args[1:12] + (
            args[12][b] if per_slot_w else args[12],) + args[13:]
        want, layers = _k6_jax(grid[b] if lead else grid, slot)
        np.testing.assert_array_equal(xs[b], layers)       # bit-equal
        mine = got[b] if lead else got
        np.testing.assert_allclose(mine, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    twin = dl_map.pdsch_map_ref(torch.from_numpy(grid.copy()), *args).numpy()
    if args[13]:            # the PRG twin rounds as the kernel: bit-equal
        np.testing.assert_array_equal(got, twin)
    else:
        np.testing.assert_allclose(got, twin, rtol=0,
                                   atol=1e-6 * np.abs(twin).max())


K6_CASES = [(m, n_l, (i + n_l) % 4)
            for i, m in enumerate(("qpsk", "qam16", "qam64", "qam256"))
            for n_l in (1, 2, 3, 4)]


@pytest.mark.parametrize("modulation,n_l,rv", K6_CASES)
def test_k6_model_matches_jax(modulation, n_l, rv):
    """QPSK to 256QAM at 1-4 layers, every rv among them, one matrix."""
    rng = np.random.default_rng(n_l * 10 + rv)
    grid, args, _ = _k6_inputs(_pdsch_at(modulation, n_l, rv), rng)
    _check_k6(grid, args)


def test_k6_model_with_n_ref():
    """Limited-buffer rate matching: the window wraps at N_nf of the cut
    buffer."""
    cfg = _pdsch_at("qam64", 2, 2)
    n_ref = 3 * (pdsch.segmentation(cfg).codeword_bits // 4)
    grid, args, _ = _k6_inputs(cfg, np.random.default_rng(3), n_ref=n_ref)
    p = _k6_params(grid, args)
    assert p.n_nf + p.gap == min(n_ref, args[0].shape[-1])
    _check_k6(grid, args)


def test_k6_model_at_the_repetition_shape():
    """:data:`flagship.REPETITION`: one codeblock whose E exceeds N_nf,
    so the window wraps within a codeblock and a plane's step E / Qm
    exceeds N_nf; 720 REs in 6 tiles of 120."""
    cfg = flagship.REPETITION
    grid, args, _ = _k6_inputs(cfg, np.random.default_rng(4),
                               nsc=flagship.CELL.nof_sc)
    p = _k6_params(grid, args)
    assert (p.C, p.C0, p.n0, p.tiles, p.T) == (1, 1, 720, 6, 120)
    assert p.n0 * p.L * p.qm > p.n_nf and p.n0 * p.L > p.n_nf
    _check_k6(grid, args)


@pytest.mark.parametrize("n_l,prg_size", [(2, 4), (4, 2)])
def test_k6_model_with_a_prg_table(n_l, prg_size):
    """K22: each RE takes its PRG's matrix, PRGs aligned to CRB 0 from
    the allocation's first PRB."""
    cfg = _pdsch_at("qam256", n_l, 0, rb_start=3, rb_count=20,
                    precoding=PrecodingConfig(prg_size=prg_size,
                                              pm_indices=(1,) * nof_prgs(
                                                  3, 20, prg_size)))
    cfg = dataclasses.replace(cfg, tbs=tbs_calc(20, 12, 24, "qam256", 0.8,
                                                n_l))
    grid, args, w = _k6_inputs(cfg, np.random.default_rng(5 + n_l))
    p = _k6_params(grid, args)
    assert (p.prg_size, p.prg_base, p.w_stride) == (
        prg_size, 3 // prg_size, 0)
    _check_k6(grid, args)


@pytest.mark.parametrize("per_slot_w", [False, True])
def test_k6_model_with_a_slot_axis(per_slot_w):
    """Two slots, each its own codeblocks and grid; the precoder shared or
    one a slot (``w_stride``)."""
    cfg = _pdsch_at("qam16", 3, 1)
    rng = np.random.default_rng(6)
    grid, args, w = _k6_inputs(cfg, rng, lead=(2,))
    if per_slot_w:
        w2 = _cgauss(rng, (2,) + w.shape, 0.5)
        args = args[:12] + (torch.from_numpy(w2),) + args[13:]
    p = _k6_params(grid, args)
    assert p.nslots == 2 and p.w_stride == (w.size if per_slot_w else 0)
    _check_k6(grid, args, lead=(2,))


def test_k6_tile_plan_at_the_flagship():
    """The flagship PDSCH: 100 codeblocks as 40 of 327 REs then 60 of 328,
    three tiles of 110 a codeblock (300 CTAs), the window of
    ``_window_plan``, the level table."""
    cfg = flagship.PDSCH
    seg = pdsch.segmentation(cfg)
    key = pdsch.plan_key(cfg)
    nre = len(pdsch.data_re_plan_column(*key, 0))
    shapes = ((4, 14, 3276), (seg.nof_codeblocks, seg.codeword_bits),
              (nre,), (nre,), (4, 4))
    dtypes = (torch.complex64, torch.int8, I32, I32, torch.complex64)
    e = pdsch.rate_match_sizes(cfg)
    p = dl_map._map_params(shapes, dtypes, e, 0, "qam256", seg.base_graph,
                           seg.lifting_size, seg.cb_info_bits,
                           seg.full_block_bits, 4, 0, 0, 0)
    assert (p.C, p.C0, p.n0, p.n1, p.tiles, p.T) == (100, 40, 327, 328, 3,
                                                     110)
    assert p.C0 * p.n0 + (p.C - p.C0) * p.n1 == p.nre == 32760
    fs, fe, n_nf, k0p = dl_map._window_plan(
        0, seg.base_graph, seg.lifting_size, seg.cb_info_bits,
        seg.full_block_bits, seg.codeword_bits)
    assert (p.fs, p.gap, p.n_nf, p.k0p) == (fs, fe - fs, n_nf, k0p)
    assert (p.qm, p.L, p.P, p.S, p.K, p.nslots) == (8, 4, 4, 14, 3276, 1)
    np.testing.assert_array_equal(
        np.asarray(p.levels[:16]),
        dl_map.pam_levels_scaled("qam256").astype(F32))
    assert _c_struct_fields("pdsch_map.cu", "MapParams") == [
        f for f, _ in _build.MapParams._fields_]


def _refuses(match: str, **change):
    cfg = _pdsch_at("qam64", 2, 0)
    grid, args, _ = _k6_inputs(cfg, np.random.default_rng(9))
    shapes = [grid.shape, tuple(args[0].shape), tuple(args[10].shape),
              tuple(args[11].shape), tuple(args[12].shape)]
    kw = dict(e_sizes=tuple(args[1]), modulation="qam64", n_l=2)
    kw.update(change)
    if "ports" in change:
        shapes[0] = (change.pop("ports"),) + shapes[0][1:]
        shapes[4] = (shapes[0][0], 2)
        kw.pop("ports")
    if "nre" in change:
        shapes[2] = shapes[3] = (kw.pop("nre"),)
    with pytest.raises(ValueError, match=match):
        dl_map._map_params(
            tuple(shapes), (torch.complex64, torch.int8, I32, I32,
                            torch.complex64), kw["e_sizes"], 0,
            kw["modulation"], args[4], args[5], args[6], args[7], kw["n_l"],
            0, 0, 0)


def test_k6_refusals():
    """What K6 does not take raises, naming the limit: E sizes not in two
    runs, more than 8 ports, BPSK, 5 layers, a codeword past 32-bit bit
    indices."""
    cfg = _pdsch_at("qam64", 2, 0)
    e = pdsch.rate_match_sizes(cfg)
    c = len(e)
    assert c >= 3
    unit = 12
    swapped = (e[0] + unit, e[1] - unit) + tuple(e[2:-1]) + (e[-1],)
    if len(set(swapped)) < 3:
        swapped = (e[0] + unit,) + tuple(e[1:-1]) + (e[-1] - unit,)
        swapped = (swapped[0], swapped[1] - 2 * unit) + swapped[2:-1] + (
            swapped[-1] + 2 * unit,)
    assert sum(swapped) == sum(e) and len(set(swapped)) >= 3
    _refuses("two runs of equal E", e_sizes=swapped)
    _refuses("up to 8", ports=9)
    _refuses("QPSK to 256QAM", modulation="bpsk")
    _refuses("1..4", n_l=5)
    big = 3 << 26                       # REs of 12 bits in 3 codeblocks
    _refuses("32 bits", nre=big, e_sizes=(big * 4,) * 3)


def test_k6_takes_any_prg_table():
    """The kernel reads its PRG rows through L1, so the table's size is
    no limit: 701 PRGs of 4 x 2 make a plan, its stride 0 (one table for
    every slot)."""
    cfg = _pdsch_at("qam64", 2, 0)
    grid, args, _ = _k6_inputs(cfg, np.random.default_rng(9))
    p = dl_map._map_params(
        (grid.shape, tuple(args[0].shape), tuple(args[10].shape),
         tuple(args[11].shape), (701, grid.shape[0], 2)),
        (torch.complex64, torch.int8, I32, I32, torch.complex64),
        tuple(args[1]), 0, "qam64", args[4], args[5], args[6], args[7], 2,
        2, 0, 0)
    assert (p.prg_size, p.prg_base, p.w_stride, p.nslots) == (2, 0, 0, 1)


# ------------------------------------------------------------------ K3

def _k3_model(p, grid, coeffs, sym, sc, nv, words, modulation):
    """K3 on the CPU from its struct ``p``: (LLRs [slots, RE L Qm], x
    [slots, RE, L])."""
    qm = BITS_PER_SYMBOL[modulation]
    n_l, half = p.L, p.half
    levels = np.asarray(p.levels[:1 << half], F32)
    words = words.view(np.uint32)
    gbits = ((words[np.arange(p.nre * n_l * qm) >> 5]
              >> (np.arange(p.nre * n_l * qm) & 31)) & 1).astype(bool)
    lead = grid.reshape((-1,) + grid.shape[-3:])
    hs = coeffs.reshape((-1,) + coeffs.shape[-4:])
    llrs, xs = [], []
    one = F32(1.0)
    for b in range(p.nslots):
        t = sym if p.T > 1 else np.zeros_like(sym)
        y = lead[b][:, sym, sc].T                            # [RE, P]
        h = hs[b][:, :, t, sc - p.sc_off].transpose(2, 0, 1)  # [RE, P, L]
        nvb = F32(np.asarray(nv).reshape(-1)[b])

        def csum(terms):
            acc_r = np.zeros(terms.shape[0], F32)
            acc_i = np.zeros(terms.shape[0], F32)
            for pp in range(terms.shape[1]):
                acc_r = (acc_r + terms[:, pp].real).astype(F32)
                acc_i = (acc_i + terms[:, pp].imag).astype(F32)
            return acc_r + 1j * acc_i

        def cj(a, c):          # conj(a) c, each product and sum rounded
            re_ = (a.real * c.real).astype(F32) + (a.imag * c.imag).astype(F32)
            im_ = (a.real * c.imag).astype(F32) - (a.imag * c.real).astype(F32)
            return re_.astype(F32) + 1j * im_.astype(F32)

        def a2(a):
            return ((a.real * a.real).astype(F32)
                    + (a.imag * a.imag).astype(F32)).astype(F32)

        def rsum(v):
            acc = np.zeros(v.shape[0], F32)
            for pp in range(v.shape[1]):
                acc = (acc + v[:, pp]).astype(F32)
            return acc

        if n_l == 1:
            energy = rsum(a2(h[:, :, 0]))
            corr = csum(cj(h[:, :, 0], y))
            inv = (one / np.maximum(energy, F32(1e-12))).astype(F32)
            x = ((corr.real * inv).astype(F32)
                 + 1j * (corr.imag * inv).astype(F32))[:, None]
            nvs = np.where(energy < 1e-12, F32(1e12), nvb * inv)[:, None]
        else:
            h0, h1 = h[:, :, 0], h[:, :, 1]
            a, d = rsum(a2(h0)), rsum(a2(h1))
            bb, z0, z1 = csum(cj(h0, h1)), csum(cj(h0, y)), csum(cj(h1, y))
            det = ((a * d).astype(F32) - a2(bb)).astype(F32)
            det = np.where(det < 1e-12, F32(1e-12), det)
            rdet = (one / det).astype(F32)
            bz1r = ((bb.real * z1.real).astype(F32)
                    - (bb.imag * z1.imag).astype(F32)).astype(F32)
            bz1i = ((bb.real * z1.imag).astype(F32)
                    + (bb.imag * z1.real).astype(F32)).astype(F32)
            cbz0 = cj(bb, z0)
            x0 = ((((d * z0.real).astype(F32) - bz1r) * rdet).astype(F32)
                  + 1j * (((d * z0.imag).astype(F32) - bz1i) * rdet
                          ).astype(F32))
            x1 = ((((a * z1.real).astype(F32) - cbz0.real) * rdet).astype(F32)
                  + 1j * (((a * z1.imag).astype(F32) - cbz0.imag) * rdet
                          ).astype(F32))
            x = np.stack([x0, x1], axis=1)
            nvs = np.stack([((nvb * d).astype(F32) * rdet).astype(F32),
                            ((nvb * a).astype(F32) * rdet).astype(F32)],
                           axis=1)
        x = x.astype(C64)
        inv = (one / np.maximum(nvs, F32(1e-12))).astype(F32)   # [RE, L]
        if p.kind < 2:
            v = x.copy()
            if p.kind == 1:
                odd = (p.rot0 + np.arange(p.nre * n_l).reshape(
                    p.nre, n_l)) & 1
                v = np.where(odd == 1, v.imag - 1j * v.real, v)
            proj = ((v.real + v.imag).astype(F32) * F32(p.two_scale)
                    ).astype(F32)
            llr = ((F32(2.0) * proj).astype(F32) * inv).astype(F32)
            llr = llr.reshape(-1)
        else:
            out = np.zeros((p.nre, n_l, half, 2), F32)
            for axis, coord in enumerate((x.real, x.imag)):
                d2 = ((coord[..., None] - levels) ** 2).astype(F32)
                for i in range(half):
                    one_bit = ((np.arange(1 << half) >> (half - 1 - i)) & 1
                               ).astype(bool)
                    d1 = d2[..., one_bit].min(axis=-1)
                    d0 = d2[..., ~one_bit].min(axis=-1)
                    out[:, :, i, axis] = ((d1 - d0).astype(F32) * inv
                                          ).astype(F32)
            llr = out.reshape(-1)
        llrs.append(np.where(gbits, -llr, llr).astype(F32))
        xs.append(x)
    return np.stack(llrs), np.stack(xs)


def _k3_inputs(rng, n_l: int, nre_cfg, lead=()):
    cfg = nre_cfg
    sym, sc = (t.numpy() for t in pusch._plan(cfg, torch.device("cpu")))
    nsc = 12 * cfg.rb_count
    grid = _cgauss(rng, lead + (4, 14, K))
    eye = np.eye(4, n_l, dtype=C64)[:, :, None, None]
    coeffs = (eye + 0.25 * _cgauss(rng, lead + (4, n_l, 1, nsc))).astype(C64)
    coeffs[..., :, :, :, :3] = 0           # three REs with no channel
    nv = np.full(lead, 0.05, F32) if lead else np.float32(0.05)
    return grid, coeffs, sym, sc, nv


K3_PUSCH = pusch.PuschConfig(
    rnti=0x17, rb_start=0, rb_count=24, first_symbol=0, nof_symbols=14,
    modulation="qam64", target_code_rate=0.7,
    tbs=tbs_calc(24, 14, 36, "qam64", 0.7, 2), nof_layers=2, n_id=1,
    dmrs_symbols=(2, 7, 11))


@pytest.mark.parametrize("modulation", ["bpsk", "pi2bpsk", "qpsk", "qam16",
                                        "qam64", "qam256"])
@pytest.mark.parametrize("n_l", [1, 2])
def test_k3_model_matches_jax(modulation, n_l):
    """Every demap kind at 1 and 2 layers, from an odd first codeword
    symbol (3 symbols into the Gold sequence: pi/2-BPSK's rot0 = 1), REs
    with no channel among them (the clamps)."""
    rng = np.random.default_rng(7 + n_l)
    grid, coeffs, sym, sc, nv = _k3_inputs(rng, n_l, K3_PUSCH)
    qm = BITS_PER_SYMBOL[modulation]
    advance = 3 * qm
    c_init = (0x17 << 15) + 1
    nre = len(sym)
    shapes = (grid.shape, coeffs.shape, (nre,), (nre,), ())
    p = ul_demap._lxn_params(shapes, (torch.complex64, torch.complex64,
                                      I32, I32, torch.float32), 0,
                             modulation, n_l, "zf", advance)
    assert p.rot0 == 1 and p.nslots == 1
    words = gold.gold_words(c_init, nre * n_l * qm, advance)
    llr, x = _k3_model(p, grid, coeffs, sym, sc, nv, words, modulation)

    y = grid[:, sym, sc].T
    h = coeffs[:, :, 0, sc].transpose(2, 0, 1)
    if n_l == 1:
        jx, jnv = j_eq.equalize_zf_1xn(jnp.asarray(y), jnp.asarray(h[..., 0]),
                                       jnp.asarray(np.full(nre, nv, F32)))
        jx, jnv = jx[:, None], jnv[:, None]
    else:
        jx, jnv = j_eq.equalize_zf_2xn(jnp.asarray(y), jnp.asarray(h),
                                       jnp.asarray(np.full(nre, nv, F32)))
    flat_x = jnp.concatenate([jnp.zeros(3, jnp.complex64),
                              jnp.reshape(jx, (-1,))])
    flat_nv = jnp.concatenate([jnp.ones(3, jnp.float32),
                               jnp.reshape(jnv, (-1,))])
    jl = j_mod.demodulate(flat_x[None], flat_nv[None], modulation)[0][
        3 * qm:]
    jl = np.asarray(j_scr.descramble_llrs(jl, c_init, advance))
    np.testing.assert_allclose(x[0], np.asarray(jx), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jx)).max())
    np.testing.assert_allclose(llr[0], jl, rtol=1e-4,
                               atol=1e-4 * np.abs(jl).max())
    tl, tx = ul_demap.equalize_demap_descramble_ref(
        torch.from_numpy(grid), torch.from_numpy(coeffs),
        torch.from_numpy(sym), torch.from_numpy(sc), 0, torch.tensor(nv),
        c_init, modulation, n_l, "zf", advance)
    np.testing.assert_allclose(llr[0], tl.numpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(tl.numpy()).max())


def test_k3_model_with_a_slot_axis_and_an_offset_band():
    """Two slots, each its own grid, channel and noise; the coefficients
    from subcarrier sc_off on (hop 2 of a hopping PUSCH): each slot's
    model equals its own twin."""
    cfg = dataclasses.replace(K3_PUSCH, rb_start=4, rb_count=20)
    rng = np.random.default_rng(12)
    grid, coeffs, sym, sc, _ = _k3_inputs(rng, 2, cfg, lead=(2,))
    nv = np.asarray([0.05, 0.2], F32)
    nre = len(sym)
    p = ul_demap._lxn_params(
        (grid.shape, coeffs.shape, (nre,), (nre,), (2,)),
        (torch.complex64, torch.complex64, I32, I32, torch.float32), 48,
        "qam16", 2, "zf", 96)
    assert (p.nslots, p.sc_off, p.Ka, p.rot0) == (2, 48, 240, 0)
    words = gold.gold_words(99, nre * 8, 96)
    llr, x = _k3_model(p, grid, coeffs, sym, sc, nv, words, "qam16")
    for b in range(2):
        tl, tx = ul_demap.equalize_demap_descramble_ref(
            torch.from_numpy(grid[b]), torch.from_numpy(coeffs[b]),
            torch.from_numpy(sym), torch.from_numpy(sc), 48,
            torch.tensor(nv[b]), 99, "qam16", 2, "zf", 96)
        np.testing.assert_allclose(x[b], tx.numpy(), rtol=1e-4,
                                   atol=1e-4 * np.abs(tx.numpy()).max())
        np.testing.assert_allclose(llr[b], tl.numpy(), rtol=1e-4,
                                   atol=1e-4 * np.abs(tl.numpy()).max())


def test_k3_struct_at_the_flagship():
    """The flagship PUSCH (2 layers ZF QAM64, 35,508 REs) and the struct's
    field order against the C source (K16's, which K3 shares)."""
    cfg = flagship.PUSCH
    sym, _ = pusch._plan(cfg, torch.device("cpu"))
    nre = sym.shape[0]
    assert nre == 35508
    p = ul_demap._lxn_params(
        ((4, 14, 3276), (4, 2, 1, 12 * cfg.rb_count), (nre,), (nre,), ()),
        (torch.complex64, torch.complex64, I32, I32, torch.float32), 0,
        "qam64", 2, "zf", 0)
    kind, half, levels, two_scale = ul_demap.demap_scalars("qam64")
    assert (p.nre, p.P, p.L, p.T, p.Ka, p.kind, p.half, p.rot0) == (
        nre, 4, 2, 1, 3228, kind, half, 0)
    np.testing.assert_array_equal(np.asarray(p.levels[:8]), levels)
    assert p.two_scale == pytest.approx(two_scale)
    assert p.mmse == 0
    assert _c_struct_fields("pusch_demap.cuh", "LxnParams") == [
        f for f, _ in _build.LxnParams._fields_]

