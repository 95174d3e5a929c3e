"""K10's and K13's host plans and numpy models of their kernels, on the
CPU.

K10 (csrc/pucch_f1.cu): its by-value hop fields against ``_f1_hops`` and
``_split`` (the port's and the JAX package's), and a numpy model of the
kernel built from its launch struct alone -- the per-(port, symbol)
despread t[p, s] with a_dm on the DM-RS and ph on the data symbols (the
DM-RS rule of each hop by the parity of s0 + s), each hop's channel from
its DM-RS columns times 1 / (12 n_dm), the energy (|x|^2 as x x + y y,
summed over both hops before the factor 12), z from t, mean and variance
times 1 / D, the symbol times the energy's reciprocal, decisions --
against JAX ``detect_format1_batch`` on seeded grids: 1 to 64 users, 4
and 8 ports, both hops with different symbol counts, a slot axis with
per-slot and shared weights.  Decisions and bits equal, metric and symbol
within rtol 1e-4 (sums in another order).
K13 (csrc/pucch_f2.cu): the PDU's Gold bits packed in the struct against
the JAX package's descramble sequence, the closed-form data subcarriers
against ``_f2_data_sc`` and the subcarriers JAX's transmitter fills, and a
numpy model of the kernel from its struct (two quotients a RE, |h|^2 as
x x + y y, the max-log difference as 4 a x) against the JAX tail of
``process_format2`` (LLRs within rtol 1e-4, atol 1e-5 of the largest).
Both launch structs' fields against the C sources, and the refusals.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import gold as j_gold
from srsran_tpu.ops.modulation import demodulate as j_demodulate
from srsran_tpu.ops.scrambling import descramble_llrs as j_descramble
from srsran_tpu.phy.upper import pucch as j_pucch

from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import channel_estimate as t_chest
from srsran_tpu_torch.phy.upper import pucch as t_pucch

torch.set_num_threads(2)

C64 = torch.complex64
F32 = torch.float32
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
            * scale / np.sqrt(2)).astype(np.complex64)


@pytest.mark.parametrize("src,struct,cls", [
    ("pucch_f1.cu", "F1Hop", _build.F1Hop),
    ("pucch_f1.cu", "F1Params", _build.F1Params),
    ("pucch_f2.cu", "F2DemapParams", _build.F2DemapParams)])
def test_structs_match_the_sources(src, struct, cls):
    assert _c_struct_fields(src, struct) == [f for f, _ in cls._fields_]


# ------------------------------------------------------------------ K10

# (nof_symbols, start_symbol, second_hop_prb)
F1_SHAPES = [(14, 0, None), (14, 0, 9), (13, 0, 9), (11, 3, 20), (4, 10, 2),
             (5, 9, None), (4, 2, None)]


@pytest.mark.parametrize("nsym,start,hop", F1_SHAPES)
def test_f1_hop_fields_are_the_hops_and_their_split(nsym, start, hop):
    """K10's by-value hop fields equal what ``_f1_hops`` and ``_split``
    give (and the JAX package's ``_f1_hops``), and the kernel's rules
    recover each hop's DM-RS and data symbols: data where s0 + s is odd,
    the DM-RS from s0 & 1 in steps of 2, among both hops' symbols from
    the hop's ``first``."""
    cfg = t_pucch.PucchF1Config(prb=3, start_symbol=start, nof_symbols=nsym,
                                initial_cyclic_shift=0, time_domain_occ=0,
                                n_id=1, slot=7, second_hop_prb=hop)
    fields = t_pucch._f1_hop_fields(3, start, nsym, hop)
    hops = t_pucch._f1_hops(cfg)
    jcfg = j_pucch.PucchF1Config(prb=3, start_symbol=start, nof_symbols=nsym,
                                 initial_cyclic_shift=0, time_domain_occ=0,
                                 n_id=1, slot=7, second_hop_prb=hop)
    assert tuple(j_pucch._f1_hops(jcfg)) == tuple(hops)
    assert len(fields) == len(hops) == (1 if hop is None else 2)
    first, data_all = 0, []
    for (prb, l_lo, ns, s0, n_dm, f), (hprb, hs0, hns) in zip(fields, hops):
        dmrs, data = t_pucch._split(hs0, hns)
        assert (prb, l_lo, ns, s0, n_dm, f) == (
            hprb, start + hs0, hns, hs0, max(len(dmrs), 1), first)
        assert [f + k for k in range(ns) if (s0 + k) % 2 == 1] == [
            f + s - s0 for s in data]
        assert list(range(s0 & 1, ns, 2)) == [s - s0 for s in dmrs]
        data_all += data
        first += ns
    p = t_pucch._f1_params(
        ((4, 14, K),) + tuple(w.shape for h in t_pucch.f1_batch_weights(
            cfg, ((0, 0, 1),)) for w in h),
        (C64,) * (1 + 3 * len(hops)), fields, 1.5)
    assert (p.nsym, p.n_data, p.nhops, p.P, p.U) == (
        nsym, len(data_all), len(hops), 4, 1)
    assert p.threads == 32 * -(-8 * nsym // 32)
    assert [tuple(getattr(p.hop[i], f) for f, _ in _build.F1Hop._fields_)
            for i in range(len(hops))] == list(fields)


@pytest.mark.parametrize("nsym,start,hop", F1_SHAPES)
def test_f1_weights_a_dm_is_zero_on_the_data_symbols(nsym, start, hop):
    """K10 reads a_dm on the DM-RS symbols only, where the twin and JAX
    sum it over every symbol of the hop: the port's and the JAX package's
    f1_batch_weights give an a_dm of exactly zero on each hop's data
    symbols (and nonzero on its DM-RS symbols), for 12 users over both
    OCCs."""
    kw = dict(prb=3, start_symbol=start, nof_symbols=nsym,
              initial_cyclic_shift=0, time_domain_occ=0, n_id=1, slot=7,
              second_hop_prb=hop)
    cfg = t_pucch.PucchF1Config(**kw)
    users = tuple((u % 12, u % 2, 1 + u % 2) for u in range(12))
    port = t_pucch.f1_batch_weights(cfg, users)
    jax_w = j_pucch.f1_batch_weights(j_pucch.PucchF1Config(**kw), users)
    for (_, s0, ns), hop_w, hop_j in zip(t_pucch._f1_hops(cfg), port,
                                         jax_w):
        dmrs, data = t_pucch._split(s0, ns)
        for a_dm in (np.asarray(hop_w[0]), np.asarray(hop_j[0])):
            assert a_dm.shape == (12, ns, 12)
            assert not a_dm[:, [s - s0 for s in data]].any()
            assert np.abs(a_dm[:, [s - s0 for s in dmrs]]).min() > 0


def _f1_users(n: int, hop) -> tuple:
    """n users on distinct (cyclic shift, OCC) pairs where they fit."""
    occs = 3 if hop is not None else 7
    return tuple((u % 12, (u // 12) % occs, 1 + u % 2) for u in range(n))


def _f1_grid(common, users, ports, rng, nsc=K):
    grid = torch.zeros((ports, 14, nsc), dtype=C64)
    for m0, occ, nbits in users:
        cfg = dataclasses.replace(common, initial_cyclic_shift=m0,
                                  time_domain_occ=occ, nof_harq_bits=nbits)
        one = t_pucch.transmit_format1(torch.zeros_like(grid), cfg,
                                       rng.integers(0, 2, nbits))[0]
        grid += torch.as_tensor(_cgauss(rng, (ports,)))[:, None, None] * one
    return (grid + 0.05 * torch.as_tensor(_cgauss(rng, grid.shape))).numpy()


def _abs2(x):
    """|x|^2 as the kernels take it: x x + y y in float32."""
    x = np.asarray(x, np.complex64)
    return x.real * x.real + x.imag * x.imag


def _k10_model(grid: np.ndarray, weights: tuple, p) -> tuple:
    """csrc/pucch_f1.cu on numpy from its F1Params: (detected bool,
    metric f32, bits int8 [.., 2], symbol c64), each [slots, U]."""
    grid = grid.reshape((p.slots, p.P, p.S, p.K))
    detected = np.zeros((p.slots, p.U), bool)
    metric = np.zeros((p.slots, p.U), np.float32)
    bits = np.zeros((p.slots, p.U, 2), np.int8)
    symbol = np.zeros((p.slots, p.U), np.complex64)

    def weight(h, j, b):
        w = weights[h][j]
        return w[b] if (p.stacked >> (3 * h + j)) & 1 else w

    for b in range(p.slots):
        for u in range(p.U):
            t = np.zeros((p.P, p.nsym), np.complex64)
            data = []
            for s in range(p.nsym):
                h = int(s >= p.hop[0].ns and p.nhops > 1)
                hp = p.hop[h]
                local = s - hp.first
                dmrs = (hp.s0 + local) % 2 == 0
                w = weight(h, 0 if dmrs else 1, b)[u, local]
                d = grid[b, :, hp.l_lo + local, 12 * hp.prb:12 * hp.prb + 12]
                t[:, s] = (d * w).sum(-1)
                if not dmrs:
                    data.append((s, h, weight(h, 2, b)[u, local]))
            h0, energy = [], np.float32(0)
            inv_nd = np.float32(1) / np.float32(p.n_data)
            for h in range(p.nhops):
                hp = p.hop[h]
                cols = t[:, hp.first + (hp.s0 & 1):hp.first + hp.ns:2]
                h0.append(cols.sum(-1) * (np.float32(1) / np.float32(
                    12 * hp.n_dm)))
                energy = energy + _abs2(h0[h]).sum()
            z = np.array([(np.conj(h0[h]) * t[:, s]).sum() * wda
                          for s, h, wda in data], np.complex64)
            zm = z.sum() * inv_nd
            var = _abs2(z - zm).sum() * inv_nd
            dh = zm * (np.float32(1) / max(np.float32(12) * energy
                                           / np.float32(p.nhops),
                                           np.float32(1e-12)))
            m = np.float32(p.n_data) * _abs2(zm) / max(var, np.float32(1e-9))
            symbol[b, u], metric[b, u] = dh, m
            bits[b, u] = (dh.real < 0, dh.imag < 0)
            detected[b, u] = m > np.float32(p.threshold)
    return detected, metric, bits, symbol


def _k10_check(grid, common, users, weights, threshold, slots=()):
    """The K10 model against JAX's ``detect_format1_batch`` slot by
    slot."""
    flat = [w for h in weights for w in h]
    p = t_pucch._f1_params(
        (grid.shape, *(w.shape for w in flat)),
        (C64,) * (1 + len(flat)),
        t_pucch._f1_hop_fields(common.prb, common.start_symbol,
                               common.nof_symbols, common.second_hop_prb),
        threshold)
    out = [o if slots else o[0] for o in _k10_model(grid, weights, p)]
    jcommon = j_pucch.PucchF1Config(**dataclasses.asdict(common))
    for b in range(len(slots) or 1):
        ws = tuple(tuple(jnp.asarray(w[b] if w.ndim > base else w)
                         for w, base in zip(h, (3, 3, 2))) for h in weights)
        ref = j_pucch.detect_format1_batch(
            jnp.asarray(grid[b] if slots else grid), jcommon, users,
            threshold, ncs=ws)
        got = [o[b] if slots else o for o in out]
        for u, r in enumerate(ref):
            nbits = users[u][2]
            assert bool(got[0][u]) == bool(r["detected"])
            assert got[2][u, :nbits].tolist() == np.asarray(
                r["harq_bits"]).tolist()
            np.testing.assert_allclose(float(got[1][u]), float(r["metric"]),
                                       rtol=1e-4)
            np.testing.assert_allclose(complex(got[3][u]),
                                       complex(r["symbol"]), rtol=1e-4,
                                       atol=1e-6)
    return out


@pytest.mark.parametrize("n_users,ports,nsym,hop", [
    (1, 4, 14, None), (3, 4, 14, 9), (12, 4, 14, 9), (64, 4, 14, None),
    (2, 8, 14, None), (5, 8, 13, 9), (4, 2, 11, 20)])
def test_f1_kernel_model_matches_jax(n_users, ports, nsym, hop):
    common = t_pucch.PucchF1Config(prb=1, start_symbol=14 - nsym,
                                   nof_symbols=nsym, initial_cyclic_shift=0,
                                   time_domain_occ=0, n_id=1, slot=4,
                                   second_hop_prb=hop)
    users = _f1_users(n_users, hop)
    rng = np.random.default_rng(n_users * ports + nsym)
    grid = _f1_grid(common, users, ports, rng)
    weights = t_pucch.f1_batch_weights(common, users)
    out = _k10_check(grid, common, users, weights, 1.5)
    assert bool(out[0].any())


@pytest.mark.parametrize("hop", [None, 9])
def test_f1_kernel_model_over_a_slot_axis(hop):
    """Three slots, each its own slot number (a_dm and ph per slot, w_da
    shared), as the conductor stacks its slot contexts."""
    users = _f1_users(3, hop)
    commons = [t_pucch.PucchF1Config(prb=1, start_symbol=0, nof_symbols=14,
                                     initial_cyclic_shift=0,
                                     time_domain_occ=0, n_id=1, slot=2 * s,
                                     second_hop_prb=hop) for s in range(3)]
    rng = np.random.default_rng(31)
    grid = np.stack([_f1_grid(c, users, 4, rng) for c in commons])
    per = [t_pucch.f1_batch_weights(c, users) for c in commons]
    weights = tuple(tuple(np.stack([q[h][j] for q in per]) if j < 2
                          else per[0][h][j] for j in range(3))
                    for h in range(len(per[0])))
    p = t_pucch._f1_params(
        (grid.shape, *(w.shape for h in weights for w in h)),
        (C64,) * (1 + 3 * len(weights)),
        t_pucch._f1_hop_fields(1, 0, 14, hop), 1.5)
    assert p.slots == 3
    assert p.stacked == sum(0b011 << (3 * h) for h in range(len(weights)))
    _k10_check(grid, commons[0], users, weights, 1.5, slots=(0, 1, 2))


def _f1_refusal(ports=4, users=1, nsym=14, grid_symbols=14, slots=None):
    fields = t_pucch._f1_hop_fields(0, 0, nsym, None)
    lead = () if slots is None else (slots,)
    shapes = (lead + (ports, grid_symbols, 3276), (users, nsym, 12),
              (users, nsym, 12), (users, nsym))
    return lambda: t_pucch._f1_params(shapes, (C64,) * 4, fields, 1.5)


@pytest.mark.parametrize("change,match", [
    (dict(ports=9), "1 to 8 ports"), (dict(users=65), "1 to 64 users"),
    (dict(nsym=15, grid_symbols=16), "at most 14 symbols"),
    (dict(nsym=14, grid_symbols=12), "outside the grid"),
    (dict(slots=12000), "2\\^31 elements")])
def test_f1_refusals_name_their_limit(change, match):
    _f1_refusal()()                     # the unchanged call is taken
    with pytest.raises(ValueError, match=match):
        _f1_refusal(**change)()


def test_f1_refuses_weights_that_do_not_fit():
    fields = t_pucch._f1_hop_fields(0, 0, 14, 9)
    one_hop = ((4, 14, K), (1, 7, 12), (1, 7, 12), (1, 7))
    with pytest.raises(ValueError, match="for each of the 2 hops"):
        t_pucch._f1_params(one_hop, (C64,) * 4, fields, 1.5)
    with pytest.raises(ValueError, match="does not fit"):
        t_pucch._f1_params(one_hop + ((2, 7, 12), (1, 7, 12), (1, 7)),
                           (C64,) * 7, fields, 1.5)


# ------------------------------------------------------------------ K13

def _f2_cfg(nof_rb, nsym, rnti=0x19, n_id=1, rb_start=None):
    return t_pucch.PucchF2Config(
        rb_start=23 - nof_rb if rb_start is None else rb_start,
        nof_rb=nof_rb, start_symbol=14 - nsym, nof_symbols=nsym, rnti=rnti,
        n_id=n_id, n_id0=1, nof_uci_bits=11 if 16 * nof_rb * nsym >= 32
        else 2, slot=3)


def _f2_pdu(cfg) -> tuple:
    """What ``f2_demap`` keys K13's plan on."""
    return (t_pucch._f2_c_init(cfg), cfg.rb_start, cfg.nof_rb,
            cfg.start_symbol, cfg.nof_symbols)


def _f2_shapes(cfg, ports=4, lead=()):
    return ((lead + (ports, 14, K), lead + (ports, 1, 1, 12 * cfg.nof_rb),
             lead + (ports,)), (C64, C64, F32))


@pytest.mark.parametrize("nof_rb,nsym,rnti,n_id", [
    (1, 1, 0x19, 1), (1, 2, 0x4601, 0), (2, 2, 0x19, 1), (4, 1, 0xFFFF, 1007),
    (16, 2, 0x19, 1), (16, 2, 0x7FFF, 1023)])
def test_f2_gold_words_are_the_jax_descramble_bits(nof_rb, nsym, rnti, n_id):
    """The struct's packed words, read as the kernel reads them (word gid
    >> 4, bits 2 (gid & 15) and + 1 for RE gid), are the JAX package's
    descramble sequence for the PDU's c_init; the words past them are 0."""
    cfg = _f2_cfg(nof_rb, nsym, rnti, n_id)
    p = t_pucch._f2_params(*_f2_shapes(cfg), _f2_pdu(cfg))
    n = 16 * nof_rb * nsym
    want = np.asarray(j_gold.gold_sequence(((rnti << 15) + n_id) % (1 << 31),
                                           n))
    words = list(p.gold)
    got = []
    for gid in range(n // 2):
        w = words[gid >> 4] >> (2 * (gid & 15))
        got += [w & 1, (w >> 1) & 1]
    assert got == want.tolist()
    assert all(v == 0 for v in words[-(-n // 32):])
    assert (p.nd, p.nsym, p.nsc, p.l0, p.sc0) == (
        8 * nof_rb, nsym, 12 * nof_rb, 14 - nsym, 12 * (23 - nof_rb))
    assert p.threads == 32 * -(-n // 64) and p.threads >= p.nsym * p.nd


def _k13_subcarriers(nof_rb: int) -> np.ndarray:
    """The kernel's closed form: RE j of a symbol at k = 12 (j >> 3) + m +
    (m + 1) / 2, m = j & 7, relative to the allocation."""
    j = np.arange(8 * nof_rb)
    m = j & 7
    return 12 * (j >> 3) + m + ((m + 1) >> 1)


def _jax_data_subcarriers(jcfg, nsc=K, payloads=16) -> np.ndarray:
    """The subcarriers JAX's ``transmit_format2`` fills with data: where
    seeded payloads' grids differ (the DM-RS is the same for all)."""
    rng = np.random.default_rng(jcfg.nof_rb)
    grids = [np.asarray(j_pucch.transmit_format2(
        jnp.zeros((1, 14, nsc), jnp.complex64), jcfg,
        rng.integers(0, 2, jcfg.nof_uci_bits).astype(np.int8)))[0]
        for _ in range(payloads)]
    row = grids[0][jcfg.start_symbol]
    differs = np.zeros(nsc, bool)
    for g in grids[1:]:
        differs |= g[jcfg.start_symbol] != row
    return np.nonzero(differs)[0]


@pytest.mark.parametrize("nof_rb,rb_start", [(1, 0), (2, 5), (16, 7)])
def test_f2_closed_form_subcarriers(nof_rb, rb_start):
    """K13's closed-form subcarriers are ``_f2_data_sc`` and the ones JAX's
    transmitter puts the data on, in the same order."""
    cfg = _f2_cfg(nof_rb, 2, rb_start=rb_start)
    sc = 12 * rb_start + _k13_subcarriers(nof_rb)
    np.testing.assert_array_equal(sc, t_pucch._f2_data_sc(rb_start, nof_rb,
                                                          0))
    jcfg = j_pucch.PucchF2Config(**dataclasses.asdict(cfg))
    np.testing.assert_array_equal(sc, _jax_data_subcarriers(jcfg))


def _k13_model(grid, coeffs, noise, p) -> np.ndarray:
    """csrc/pucch_f2.cu on numpy from its F2DemapParams: the LLRs [slots,
    2 nsym nd]."""
    grid = grid.reshape((p.slots, p.P, p.S, p.K))
    coeffs = coeffs.reshape((p.slots, p.P, p.nsc))
    noise = noise.reshape((p.slots, p.P))
    gid = np.arange(p.nsym * p.nd)
    s, j = gid // p.nd, gid % p.nd
    k = 12 * (j >> 3) + (j & 7) + (((j & 7) + 1) >> 1)
    y = grid[:, :, p.l0 + s, p.sc0 + k]                        # [B, P, n]
    h = coeffs[:, :, k]
    nz = noise.sum(-1, keepdims=True) / np.float32(p.P)
    corr = (np.conj(h) * y).sum(1)
    inv_den = np.float32(1) / np.maximum(_abs2(h).sum(1), np.float32(1e-12))
    scale = np.float32(4 * p.level) / np.maximum(nz * inv_den,
                                                 np.float32(1e-12))
    llr = [corr.real * inv_den * scale, corr.imag * inv_den * scale]
    words = np.array(list(p.gold), np.uint64)
    bits = (words[gid >> 4] >> (2 * (gid & 15)).astype(np.uint64)) & 3
    sign = [1 - 2 * (bits & 1).astype(np.float32),
            1 - 2 * (bits >> 1).astype(np.float32)]
    return np.stack([llr[0] * sign[0], llr[1] * sign[1]], -1).reshape(
        p.slots, -1).astype(np.float32)


@pytest.mark.parametrize("nof_rb,nsym,ports,slots", [
    (1, 2, 4, 0), (2, 2, 4, 0), (16, 2, 4, 0), (4, 1, 8, 0), (2, 2, 4, 3)])
def test_f2_kernel_model_matches_the_jax_tail(nof_rb, nsym, ports, slots):
    """The K13 model on the port's channel estimate against the JAX tail
    of ``process_format2`` (pucch.py:757-771) slot by slot."""
    cfg = _f2_cfg(nof_rb, nsym)
    jcfg = j_pucch.PucchF2Config(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(nof_rb * nsym + ports + slots)
    lead = (slots,) if slots else ()
    grids, coeffs, noises = [], [], []
    for _ in range(slots or 1):
        sent = t_pucch.transmit_format2(
            torch.zeros((1, 14, K), dtype=C64), cfg,
            rng.integers(0, 2, cfg.nof_uci_bits))[0]
        grid = (torch.as_tensor(_cgauss(rng, (ports,)))[:, None, None] * sent
                + 0.05 * torch.as_tensor(_cgauss(rng, (ports, 14, K))))
        args, kw = t_pucch.f2_estimate_args(
            grid, cfg, torch.as_tensor(t_pucch.f2_pilot_values_for(cfg)))
        est = t_chest.estimate_from_grid_ref(*args, **kw)
        grids.append(grid.numpy())
        coeffs.append(est.coeffs.numpy())
        noises.append(est.noise_var.numpy())
    grid, coeff, noise = (np.stack(x) if slots else x[0]
                          for x in (grids, coeffs, noises))
    p = t_pucch._f2_params(*_f2_shapes(cfg, ports, lead), _f2_pdu(cfg))
    got = _k13_model(grid, coeff, noise, p)
    data_sc = t_pucch._f2_sc(cfg.rb_start, nof_rb)[0]
    for b in range(slots or 1):
        h = jnp.asarray(coeffs[b][:, 0, 0])[:, data_sc - 12 * cfg.rb_start]
        nz = jnp.mean(jnp.asarray(noises[b]))
        parts = []
        for s in range(nsym):
            rx = jnp.asarray(grids[b])[:, cfg.start_symbol + s, data_sc]
            energy = jnp.sum(jnp.abs(h) ** 2, axis=0)
            x = jnp.sum(jnp.conj(h) * rx, axis=0) / jnp.maximum(energy,
                                                                1e-12)
            parts.append(j_demodulate(
                x[None], (nz / jnp.maximum(energy, 1e-12))[None], "qpsk")[0])
        want = np.asarray(j_descramble(jnp.concatenate(parts)[None],
                                       (cfg.rnti << 15) + cfg.n_id)[0])
        np.testing.assert_allclose(got[b], want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("change,match", [
    (dict(nof_rb=17), "at most 512 bits"), (dict(ports=9), "1 to 8 ports"),
    (dict(nof_rb=16, nsym=3), "1 or 2 symbols"),
    (dict(nof_rb=2, rb_start=23), "outside the grid"),
    (dict(slots=140000), "2\\^31 elements")])
def test_f2_refusals_name_their_limit(change, match):
    ports = change.pop("ports", 4)
    lead = (change.pop("slots"),) if "slots" in change else ()
    kw = dict(nof_rb=2, nsym=2)
    kw.update(change)
    nof_rb, nsym = kw.pop("nof_rb"), kw.pop("nsym")
    t_pucch._f2_params(*_f2_shapes(_f2_cfg(2, 2)), _f2_pdu(_f2_cfg(2, 2)))
    cfg = dataclasses.replace(_f2_cfg(nof_rb, min(nsym, 2), **kw),
                              nof_symbols=nsym,
                              start_symbol=max(0, 14 - nsym))
    with pytest.raises(ValueError, match=match):
        t_pucch._f2_params(*_f2_shapes(cfg, ports, lead), _f2_pdu(cfg))

