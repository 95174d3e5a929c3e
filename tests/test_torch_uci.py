"""The PUCCH F0/F2 + UCI path on the CPU: the twins of K12 (F0 detect), K13
(F2 demap), K14 (short-block ML) and K15 (polar rate dematch + SC decode +
CRC) against the JAX package, and the kernels' own arithmetic (the K14
candidate fold, the K15 node schedule) replayed in numpy.

Inputs are made from numpy seeds and go through the JAX function and the
port's on the same values.  Tolerances: decisions, bits, CRC/valid flags
and argmax indices equal; metrics within rtol 1e-4 (sums in another
order); LLRs within rtol 1e-4 and atol 1e-5 of max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import polar as j_polar
from srsran_tpu.ops import short_block as j_sb
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper import uci as j_uci
from srsran_tpu.ran import polar_params as j_pp

from srsran_tpu_torch import convert
from srsran_tpu_torch.ops import channel_estimate as t_chest
from srsran_tpu_torch.ops import gold as t_gold
from srsran_tpu_torch.ops import polar as t_polar
from srsran_tpu_torch.ops import short_block as t_sb
from srsran_tpu_torch.phy.upper import dmrs as t_dmrs
from srsran_tpu_torch.phy.upper import pucch as t_pucch
from srsran_tpu_torch.phy.upper import uci as t_uci
from srsran_tpu_torch.ran import polar_params as t_pp

torch.set_num_threads(2)


def _noisy(bits: np.ndarray, sigma: float, rng) -> np.ndarray:
    return ((1.0 - 2.0 * bits) + sigma * rng.standard_normal(bits.shape)
            ).astype(np.float32)


def _cgauss(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape)) / np.sqrt(2)
            ).astype(np.complex64)


# ------------------------------------------------------ the repaired defaults

@pytest.mark.parametrize("call", ["gold_sequence", "pilots_for_port",
                                  "normalize_dl_plan", "normalize_ul_plan"])
def test_device_is_required(call):
    """No port entry point picks the CPU by itself."""
    from srsran_tpu_torch.fapi import conductor as t_cond
    from srsran_tpu_torch.fapi import messages as t_msgs
    cfg = t_dmrs.DmrsConfig(rb_start=0, rb_count=2, symbols=(2,), ports=(0,),
                            scrambling_id=1)
    slot = t_msgs.SlotPoint(1, 0)
    fn = {
        "gold_sequence": lambda **kw: t_gold.gold_sequence(7, 16, **kw),
        "pilots_for_port": lambda **kw: t_dmrs.pilots_for_port(cfg, 0, **kw),
        "normalize_dl_plan": lambda **kw: t_cond.normalize_dl_plan(
            t_msgs.DlTtiRequest(slot=slot), (), 1, **kw),
        "normalize_ul_plan": lambda **kw: t_cond.normalize_ul_plan(
            t_msgs.UlTtiRequest(slot=slot), **kw),
    }[call]
    with pytest.raises(TypeError):
        fn()
    fn(device="cpu")


# ------------------------------------------------------------ K14's twin

SB_CASES = [(k, qm) for k in range(1, 12) for qm in (1, 2)]


@pytest.mark.parametrize("k,qm", SB_CASES)
def test_short_block_detect_matches_jax(k, qm):
    rng = np.random.default_rng(100 * k + qm)
    e = 32 if k >= 3 else 18
    msg = rng.integers(0, 2, (4, k)).astype(np.int8)
    cw = np.asarray(j_sb.encode(jnp.asarray(msg), e, qm))
    np.testing.assert_array_equal(
        t_sb.encode(torch.as_tensor(msg), e, qm).numpy(), cw)
    llr = _noisy(cw, 0.9, rng)
    jb, jm = j_sb.detect(jnp.asarray(llr), k, qm)
    tb, tm = t_sb.detect(torch.as_tensor(llr), k, qm)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4)


@pytest.mark.parametrize("k,qm", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 2),
                                  (6, 2), (11, 1), (11, 2)])
def test_short_block_kernel_tables_build_the_candidates(k, qm):
    """K14 builds candidate c's bit j as parity(c & mask[j % P]) ^
    ones[j % P]; folding the LLRs over the period P gives the twin's
    correlations and the same first argmax."""
    e = 64 if k >= 3 else 20
    tables = t_sb._kernel_tables(k, qm)
    masks, ones = tables
    period = tables.shape[1]
    c = np.arange(1 << k)[:, None]
    j = np.arange(e)[None, :]
    parity = np.vectorize(lambda v: bin(int(v)).count("1") & 1)
    bits = parity(c & masks[j % period]) ^ ones[j % period]
    np.testing.assert_array_equal(1.0 - 2.0 * bits,
                                  t_sb._candidates(k, e, qm))
    rng = np.random.default_rng(k)
    llr = rng.standard_normal(e).astype(np.float32)
    fold = np.array([llr[r::period].sum() for r in range(period)])
    corr = ((1.0 - 2.0 * (parity(c & masks) ^ ones)) * fold).sum(axis=1)
    ref = t_sb._candidates(k, e, qm) @ llr
    np.testing.assert_allclose(corr, ref, rtol=1e-5, atol=1e-5)
    assert int(np.argmax(corr)) == int(np.argmax(ref))


def test_short_block_zero_llrs_pick_candidate_zero():
    bits, metric = t_sb.detect(torch.zeros((1, 32)), 6, 2)
    assert bits.abs().sum() == 0 and float(metric[0]) == 0.0


# ------------------------------------------------------------ K15's twin

# (payload K', E, n_pc): shorten, puncture, none and repeat modes, with PC
# bits (UCI 12-19) and without (>= 20), all with the channel interleaver.
POLAR_CASES = [(18, 40, 3), (18, 100, 3), (14, 30, 3), (33, 64, 0),
               (33, 200, 0), (40, 50, 0), (25, 300, 0), (31, 600, 0)]


def _codes(k, e, n_pc):
    return (j_pp.polar_code(k, e, nmax=10, ibil=True, n_pc=n_pc),
            t_pp.polar_code(k, e, nmax=10, ibil=True, n_pc=n_pc))


def test_polar_cases_cover_every_mode():
    modes = {_codes(*c)[1].mode for c in POLAR_CASES}
    assert modes == {"shorten", "puncture", "none", "repeat"}


@pytest.mark.parametrize("k,e,n_pc", POLAR_CASES)
def test_polar_encode_matches_jax(k, e, n_pc):
    jcode, tcode = _codes(k, e, n_pc)
    msg = np.random.default_rng(k + e).integers(0, 2, (3, k)).astype(np.int8)
    ju = np.asarray(j_polar.allocate(jnp.asarray(msg), jcode))
    tu = t_polar.allocate(torch.as_tensor(msg), tcode)
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_array_equal(
        t_polar.rate_match(t_polar.encode(tu, tcode.n), tcode).numpy(),
        np.asarray(j_polar.rate_match(j_polar.encode(jnp.asarray(ju),
                                                     jcode.n), jcode)))


@pytest.mark.parametrize("k,e,n_pc", POLAR_CASES)
def test_polar_decode_matches_jax(k, e, n_pc):
    """rate_dematch + sc_decode bits equal the JAX package's on noisy
    LLRs (some codewords decode wrong at this noise: they must be wrong
    the same way)."""
    jcode, tcode = _codes(k, e, n_pc)
    rng = np.random.default_rng(7 * k + e)
    msg = rng.integers(0, 2, (4, k)).astype(np.int8)
    x = np.asarray(j_polar.rate_match(j_polar.encode(
        j_polar.allocate(jnp.asarray(msg), jcode), jcode.n), jcode))
    llr = _noisy(x, 0.8, rng)
    llr[0, ::5] = 0.0                      # exact zeros decide bit 0
    j_lm = j_polar.rate_dematch(jnp.asarray(llr), jcode)
    t_lm = t_polar.rate_dematch(torch.as_tensor(llr), tcode)
    np.testing.assert_array_equal(t_lm.numpy(), np.asarray(j_lm))
    np.testing.assert_array_equal(
        t_polar.sc_decode(t_lm, tcode).numpy(),
        np.asarray(j_polar.sc_decode(j_lm, jcode)))


def test_polar_decode_all_zero_llrs():
    jcode, tcode = _codes(33, 64, 0)
    llr = np.zeros((1, 64), np.float32)
    want = np.asarray(j_polar.sc_decode(
        j_polar.rate_dematch(jnp.asarray(llr), jcode), jcode))
    bits, ok = t_polar.decode(torch.as_tensor(llr), tcode, "crc11")
    np.testing.assert_array_equal(bits.numpy(), want)
    assert not want.any() and bool(ok[0])   # all-zero message, zero CRC


def _run_program(llr_n: np.ndarray, code) -> np.ndarray:
    """K15's node schedule replayed in numpy: level buffers of LLRs and
    hard bits, the decided bits u; returns u (float32 arithmetic)."""
    n = code.big_n
    lvl = {m: 2 * n - 2 * m for m in [1 << i for i in range(code.n + 1)]}
    L = np.zeros(2 * n, np.float32)
    X = np.zeros(2 * n, np.uint8)
    U = np.zeros(n, np.uint8)
    L[:n] = llr_n
    prog = t_polar._sc_program(np.asarray(code.frozen_mask, np.uint8).tobytes())
    for op, lg, lo in prog:
        m = 1 << lg
        h = m // 2
        lm, lh = lvl[m], lvl.get(h, 0)
        if op == t_polar._OP_F:
            a, b = L[lm:lm + h], L[lm + h:lm + m]
            L[lh:lh + h] = np.sign(a) * np.sign(b) * np.minimum(abs(a), abs(b))
        elif op == t_polar._OP_G:
            a, b = L[lm:lm + h], L[lm + h:lm + m]
            L[lh:lh + h] = b + (np.float32(1) - 2 * X[lm:lm + h]
                                .astype(np.float32)) * a
        elif op == t_polar._OP_SAVE:
            X[lm:lm + h] = X[lh:lh + h]
        elif op == t_polar._OP_COMB:
            r = X[lh:lh + h].copy()
            X[lm:lm + h] ^= r
            X[lm + h:lm + m] = r
        elif op == t_polar._OP_R0:
            X[lm:lm + m] = 0
        else:
            X[lm:lm + m] = L[lm:lm + m] < 0
            U[lo:lo + m] = X[lm:lm + m]
            half = 1
            while half < m:
                for i in range(h):
                    a = lo + (i // half) * 2 * half + i % half
                    U[a] ^= U[a + half]
                half *= 2
    return U


@pytest.mark.parametrize("k,e,n_pc", POLAR_CASES)
def test_polar_kernel_schedule_decodes_as_the_twin(k, e, n_pc):
    """The K15 kernel's rate-dematch tables and node schedule, replayed in
    numpy, give the twin's message bits and CRC flag."""
    _, code = _codes(k, e, n_pc)
    rng = np.random.default_rng(k * e)
    llr = _noisy(rng.integers(0, 2, e), 1.0, rng)
    llr[::7] = 0.0
    tables = t_polar._dematch_tables(code.big_n, code.e, code.mode, code.ibil)
    first, src = tables[0, :code.big_n], tables[0, code.big_n:]
    short = tables[1, :code.big_n]
    mother = np.zeros(code.big_n, np.float32)
    for p in range(code.big_n):
        i = first[p]
        while 0 <= i < e:
            mother[p] += llr[src[i]]
            i += code.big_n
        if short[p]:
            mother[p] = 1e4
    want_lm = t_polar.rate_dematch(torch.as_tensor(llr[None]), code)[0]
    np.testing.assert_array_equal(mother, want_lm.numpy())
    u = _run_program(mother, code)
    readout = t_polar._readout(*t_polar._code_keys(code)["readout"])
    bits, _ = t_polar.decode_ref(torch.as_tensor(llr[None]), code,
                                 "crc11" if k > 25 else "crc6")
    np.testing.assert_array_equal(u[readout], bits[0].numpy())


# ------------------------------------------------------------------ UCI

@pytest.mark.parametrize("o_bits,e,qm", [(3, 24, 2), (11, 48, 1), (12, 72, 2),
                                         (19, 80, 2), (22, 96, 2),
                                         (40, 240, 1)])
def test_decode_uci_matches_jax(o_bits, e, qm):
    rng = np.random.default_rng(o_bits + e)
    bits = rng.integers(0, 2, o_bits).astype(np.int8)
    coded = np.asarray(j_uci.encode_uci(jnp.asarray(bits), e, qm))
    np.testing.assert_array_equal(
        t_uci.encode_uci(torch.as_tensor(bits), e, qm).numpy(), coded)
    llr = _noisy(coded, 0.6, rng)
    jb, jv, jm = j_uci.decode_uci(jnp.asarray(llr), o_bits, qm)
    tb, tv, tm = t_uci.decode_uci(torch.as_tensor(llr), o_bits, qm)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert bool(tv) == bool(jv)
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-4)
    np.testing.assert_array_equal(tb.numpy(), bits)


# ------------------------------------------------------- K12's twin (F0)

F0_KEYS = sorted(j_pucch._F0_TABLES)


@pytest.mark.parametrize("hop", [None, 9])
@pytest.mark.parametrize("nbits,sr_opp", F0_KEYS)
def test_detect_format0_matches_jax(nbits, sr_opp, hop):
    """Every dictionary entry of every (HARQ bits, SR) key, sent through a
    2-port channel with noise, detected equally by both packages."""
    jcfg = j_pucch.PucchF0Config(prb=3, start_symbol=12, nof_symbols=2,
                                 initial_cyclic_shift=5, n_id=77, slot=4,
                                 nof_harq_bits=nbits, sr_opportunity=sr_opp,
                                 second_hop_prb=hop)
    tcfg = convert.config(jcfg)
    np.testing.assert_array_equal(t_pucch.f0_refs_for(tcfg),
                                  j_pucch.f0_refs_for(jcfg))
    rng = np.random.default_rng(nbits + 10 * sr_opp + (hop or 0))
    for c, (_, sr, harq) in enumerate(j_pucch._F0_TABLES[(nbits, sr_opp)]):
        sent = t_pucch.transmit_format0(
            torch.zeros((1, 14, 120), dtype=torch.complex64), tcfg, harq,
            sr if sr is not None else 0)
        ch = _cgauss(rng, (2,))
        # noise at -10 dB: the metric's noise term (energy - max corr)
        # then keeps its digits in float32
        grid = (ch[:, None, None] * sent.numpy()[0]
                + _cgauss(rng, (2, 14, 120), 0.3)).astype(np.complex64)
        ref = j_pucch.detect_format0(jnp.asarray(grid), jcfg)
        ctx = torch.as_tensor(j_pucch.f0_refs_for(jcfg))
        for ncs in (None, ctx):
            got = t_pucch.detect_format0(torch.as_tensor(grid), tcfg, ncs=ncs)
            assert set(got) == set(ref)
            for key in ("detected", "harq_bits", "sr_bit", "best_mcs_index"):
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(ref[key]), key)
            np.testing.assert_allclose(float(got["metric"]),
                                       float(ref["metric"]), rtol=1e-4)
            assert int(got["best_mcs_index"]) == c and bool(got["detected"])


def test_transmit_format0_negative_sr_sends_nothing():
    cfg = t_pucch.PucchF0Config(prb=3, start_symbol=12, nof_symbols=2,
                                initial_cyclic_shift=5, n_id=77,
                                nof_harq_bits=0, sr_opportunity=True)
    grid = torch.zeros((1, 14, 120), dtype=torch.complex64)
    assert torch.equal(t_pucch.transmit_format0(grid, cfg, (), 0), grid)
    assert t_pucch.transmit_format0(grid, cfg, (), 1).abs().sum() > 0


def test_f0_without_harq_or_sr_raises():
    cfg = t_pucch.PucchF0Config(prb=3, start_symbol=12, nof_symbols=2,
                                initial_cyclic_shift=5, n_id=77,
                                nof_harq_bits=0)
    with pytest.raises(ValueError, match="HARQ bits, SR, or both"):
        t_pucch.detect_format0(torch.zeros((1, 14, 120),
                                           dtype=torch.complex64), cfg)


# ------------------------------------------------ K13's twin and F2 whole

def _f2_grid(jcfg, bits, rng, nports=4, nsc=120):
    """The UE's F2 (the JAX transmitter) through a flat channel + noise."""
    one = np.asarray(j_pucch.transmit_format2(
        jnp.zeros((1, 14, nsc), jnp.complex64), jcfg, bits))[0]
    ch = _cgauss(rng, (nports,))
    return (ch[:, None, None] * one + _cgauss(rng, (nports, 14, nsc), 0.05)
            ).astype(np.complex64)


F2_CASES = {4: (1, 2), 11: (1, 2), 16: (2, 2), 22: (2, 2), 6: (1, 1)}


@pytest.mark.parametrize("k", sorted(F2_CASES))
def test_process_format2_matches_jax(k):
    nof_rb, nsym = F2_CASES[k]
    jcfg = j_pucch.PucchF2Config(rb_start=4, nof_rb=nof_rb, start_symbol=11,
                                 nof_symbols=nsym, rnti=0x4601, n_id=9,
                                 n_id0=3, nof_uci_bits=k, slot=5)
    tcfg = convert.config(jcfg)
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, k).astype(np.int8)
    grid = _f2_grid(jcfg, bits, rng)
    sent = t_pucch.transmit_format2(
        torch.zeros((1, 14, 120), dtype=torch.complex64), tcfg, bits)
    np.testing.assert_allclose(sent.numpy(), np.asarray(
        j_pucch.transmit_format2(jnp.zeros((1, 14, 120), jnp.complex64),
                                 jcfg, bits)), rtol=1e-6, atol=1e-6)
    ctx = j_pucch.f2_pilot_values_for(jcfg)
    np.testing.assert_array_equal(t_pucch.f2_pilot_values_for(tcfg), ctx)
    ref = j_pucch.process_format2(jnp.asarray(grid), jcfg, jnp.asarray(ctx))
    for ci in (None, torch.as_tensor(ctx), j_pucch.f2_dmrs_cinits(jcfg)):
        got = t_pucch.process_format2(torch.as_tensor(grid), tcfg, ci)
        assert set(got) == set(ref)
        np.testing.assert_array_equal(got["uci_bits"].numpy(),
                                      np.asarray(ref["uci_bits"]))
        assert bool(got["valid"]) == bool(ref["valid"]) is True
        np.testing.assert_allclose(float(got["metric"]), float(ref["metric"]),
                                   rtol=1e-4)
        np.testing.assert_array_equal(got["uci_bits"].numpy(), bits)


@pytest.mark.parametrize("nof_rb,nsym", [(1, 1), (1, 2), (2, 2), (4, 1)])
def test_f2_demap_matches_the_jax_tail(nof_rb, nsym):
    """K13's twin equals process_format2's tail (pucch.py:764-775) on the
    same channel estimate: LLRs within rtol 1e-4."""
    jcfg = j_pucch.PucchF2Config(rb_start=2, nof_rb=nof_rb, start_symbol=12,
                                 nof_symbols=nsym, rnti=0x17, n_id=1,
                                 n_id0=1, nof_uci_bits=8)
    tcfg = convert.config(jcfg)
    rng = np.random.default_rng(nof_rb * nsym)
    grid = torch.as_tensor(_f2_grid(jcfg, rng.integers(0, 2, 8), rng))
    args, kw = t_pucch.f2_estimate_args(
        grid, tcfg, torch.as_tensor(t_pucch.f2_pilot_values_for(tcfg)))
    est = t_chest.estimate_from_grid_ref(*args, **kw)
    got = t_pucch.f2_demap_ref(grid, est.coeffs, est.noise_var, tcfg)
    # the JAX tail, on the port's estimate
    from srsran_tpu.ops.modulation import demodulate
    from srsran_tpu.ops.scrambling import descramble_llrs
    data_sc = t_pucch._f2_sc(tcfg.rb_start, nof_rb)[0]
    h = jnp.asarray(est.coeffs[:, 0, 0].numpy())[:, data_sc - 24]
    noise = jnp.mean(jnp.asarray(est.noise_var.numpy()))
    parts = []
    for s in range(nsym):
        rx = jnp.asarray(grid.numpy())[:, 12 + s, data_sc]
        corr = jnp.sum(jnp.conj(h) * rx, axis=0)
        energy = jnp.sum(jnp.abs(h) ** 2, axis=0)
        x = corr / jnp.maximum(energy, 1e-12)
        nv = noise / jnp.maximum(energy, 1e-12)
        parts.append(demodulate(x[None], nv[None], "qpsk")[0])
    want = np.asarray(descramble_llrs(jnp.concatenate(parts)[None],
                                      (0x17 << 15) + 1)[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    assert got.shape == (16 * nof_rb * nsym,)


def test_f2_channel_estimate_matches_jax():
    """K8's twin at F2's comb-3 shape (4-8 pilots, 1-2 symbols) against the
    JAX estimator, as process_format2 calls it."""
    from srsran_tpu.ops import channel_estimate as j_chest
    for nof_rb, nsym in ((1, 2), (2, 2), (2, 1)):
        jcfg = j_pucch.PucchF2Config(rb_start=3, nof_rb=nof_rb,
                                     start_symbol=11, nof_symbols=nsym,
                                     rnti=0x17, n_id=1, n_id0=1,
                                     nof_uci_bits=6)
        tcfg = convert.config(jcfg)
        rng = np.random.default_rng(nof_rb)
        grid = torch.as_tensor(_f2_grid(jcfg, rng.integers(0, 2, 6), rng))
        pil = t_pucch.f2_pilot_values_for(tcfg)
        args, kw = t_pucch.f2_estimate_args(grid, tcfg, torch.as_tensor(pil))
        got = t_chest.estimate_from_grid_ref(*args, **kw)
        _, dmrs_sc = t_pucch._f2_sc(3, nof_rb)
        rx_pil = np.stack([grid.numpy()[:, 11 + s, dmrs_sc]
                           for s in range(nsym)], axis=1)
        ref = j_chest.estimate(jnp.asarray(rx_pil), jnp.asarray(pil[None]),
                               dmrs_sc - 36, nof_sc=12 * nof_rb,
                               nof_symbols=nsym, scs_hz=30e3, stride=3,
                               smoothing="filter", estimate_cfo=False)
        assert float(got.time_alignment_s) == float(ref.time_alignment_s)
        for key in ("coeffs", "noise_var", "rsrp", "epre", "snr"):
            a, b = getattr(got, key).numpy(), np.asarray(getattr(ref, key))
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max())
