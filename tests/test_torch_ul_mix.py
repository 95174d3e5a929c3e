"""The full UL slot mix on the CPU: the port's channel estimator (K8's
twin), PRACH detector (K9's), PUCCH F1 batch detector (K10's) and SRS
estimator (K11's) against the JAX package, then the whole UL slot with
PUSCH + PUCCH F1 + PRACH + SRS.

Inputs are made from numpy seeds and go through the JAX function and the
port's on the same values.  Tolerances: decisions (TA, detection flags,
HARQ bits, decoded bits, CRC flags, LDPC sweeps) equal; channel
coefficients, noise, RSRP and EPRE within rtol 1e-5 and atol 1e-6 of
max|ref| (float32 sums in another order); detection metrics within rtol
1e-4 (ratios of such sums).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import channel_estimate as j_chest
from srsran_tpu.ops import ofdm as j_ofdm
from srsran_tpu.phy import slot_programs as j_slots
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import prach as j_prach
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper import pusch as j_pusch
from srsran_tpu.phy.upper import srs as j_srs
from srsran_tpu.ran.ldpc_params import segment_tb, select_base_graph
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.ops import channel_estimate as t_chest
from srsran_tpu_torch.phy import slot_programs as t_slots
from srsran_tpu_torch.phy.upper import prach as t_prach
from srsran_tpu_torch.phy.upper import pucch as t_pucch
from srsran_tpu_torch.phy.upper import srs as t_srs

torch.set_num_threads(2)


def close(port, ref, rtol=1e-5, atol_rel=1e-6):
    ref = np.asarray(ref)
    atol = atol_rel * float(np.max(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(np.asarray(port), ref, rtol=rtol, atol=atol)


def _cgauss(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape)) / np.sqrt(2)
            ).astype(np.complex64)


# ------------------------------------------------------------ K8's twin

def _chest_case(layers, cdm, cfo, td, comb=2, seed=0):
    """A 4-port grid holding `layers` pilot streams through a delayed
    channel (and a CFO rotation) plus noise, and the estimate's args."""
    rng = np.random.default_rng(seed)
    nrb = 6
    if comb == 2 and layers <= 2 and cfo:                    # PUSCH-like
        symbols, first_sc, k_p = (2, 7, 11), 12, 6 * nrb
        stride = 2
    else:                                                     # SRS-like
        symbols, first_sc, k_p = (13,), 12 + 1, nrb * 12 // comb
        stride = comb
    pilot_scs = stride * np.arange(k_p)
    nsc = k_p * stride
    n_s = len(symbols)
    expected = np.exp(1j * np.pi / 2 * rng.integers(0, 4, (layers, n_s, k_p))
                      ).astype(np.complex64)
    if cdm:                                  # fd-OCC over pilot pairs
        cover = np.where(np.arange(k_p) % 2 == 0, 1.0, -1.0)
        expected[1] = expected[0] * cover
    h = _cgauss(rng, (4, layers))
    ramp = np.exp(-2j * np.pi * pilot_scs * 30e3 * 0.3e-6)
    times = np.array([0.0714e-3, 0.25e-3, 0.3928e-3])[:n_s]
    rot = np.exp(2j * np.pi * 120.0 * times) if cfo else np.ones(n_s)
    rx = np.einsum("pl,lsk,k,s->psk", h, expected, ramp, rot)
    rx = (rx + _cgauss(rng, rx.shape, 0.05)).astype(np.complex64)
    grid = _cgauss(rng, (4, 14, 12 * 10), 0.05)
    for i, s in enumerate(symbols):
        grid[:, s, first_sc + pilot_scs] = rx[:, i]
    kw = dict(stride=stride, smoothing="filter", estimate_cfo=cfo,
              dmrs_symbol_times_s=times if cfo else None, td_strategy=td,
              dmrs_symbol_idx=np.asarray(symbols), cdm_pairs=cdm)
    return grid, symbols, first_sc, expected, pilot_scs, nsc, kw


CHEST_CASES = {
    "1l_average": (1, False, True, "average", 2),
    "1l_interpolate": (1, False, True, "interpolate", 2),
    "2l_cdm_average": (2, True, True, "average", 2),
    "2l_cdm_interpolate": (2, True, True, "interpolate", 2),
    "srs_comb2_1p": (1, False, False, "average", 2),
    "srs_comb2_2p": (2, False, False, "average", 2),
    "srs_comb2_4p": (4, False, False, "average", 2),
    "srs_comb4_1p": (1, False, False, "average", 4),
    "srs_comb4_2p": (2, False, False, "average", 4),
    "srs_comb4_4p": (4, False, False, "average", 4),
}


@pytest.mark.parametrize("case", sorted(CHEST_CASES))
def test_estimate_from_grid_matches_jax(case):
    layers, cdm, cfo, td, comb = CHEST_CASES[case]
    grid, symbols, first_sc, expected, pilot_scs, nsc, kw = _chest_case(
        layers, cdm, cfo, td, comb, seed=len(case))
    rx = grid[:, list(symbols)][:, :, first_sc + pilot_scs]
    ref = j_chest.estimate(jnp.asarray(rx), jnp.asarray(expected), pilot_scs,
                           nsc, 14, 30e3, **kw)
    got = t_chest.estimate_from_grid(
        torch.as_tensor(grid), symbols, first_sc, torch.as_tensor(expected),
        pilot_scs, nsc, 14, 30e3, **kw)
    assert got.coeffs.shape == ref.coeffs.shape
    assert float(got.time_alignment_s) == float(ref.time_alignment_s)
    for key in ("coeffs", "noise_var", "rsrp", "epre", "snr"):
        close(getattr(got, key).numpy(), getattr(ref, key))
    assert abs(float(got.cfo_hz) - float(ref.cfo_hz)) < 1e-2


def _band_to_dense(first, weights, k):
    """Scatter a band form back into its dense [nof_sc, k] matrix."""
    out = np.zeros((len(first), k), np.float32)
    cols = first[:, None] + np.arange(weights.shape[1])
    np.put_along_axis(out, cols, weights, axis=1)
    return out


@pytest.mark.parametrize("nrb,pairs", [(6, True), (273, True), (24, False),
                                       (4, False), (1, True), (3, False)])
def test_band_form_is_the_dense_operator(nrb, pairs):
    """K8's band form scatters back to the exact dense operator (also for
    bands that touch both edges of the allocation)."""
    scs = 2 * np.arange(6 * nrb)
    if pairs:
        scs = (scs[0::2] + scs[1::2]) // 2
    key = (tuple(int(s) for s in scs), 12 * nrb, "filter", 4 if pairs else 2)
    first, weights = t_chest._band(*key)
    dense = t_chest._smooth_interp_matrix(*key)
    np.testing.assert_array_equal(
        _band_to_dense(first, weights, len(scs)), dense)
    # the kernel's tables, keyed by the comb, are the same band
    comb = (int(scs[0]), key[3], len(scs), key[1], "filter")
    np.testing.assert_array_equal(t_chest._band_table(0, *comb), first)
    np.testing.assert_array_equal(t_chest._band_table(1, *comb), weights)
    assert weights.shape[1] <= (8 if pairs else 16)


def test_band_width_at_the_flagship():
    """Every row of the flagship PUSCH operator (3228 x 807) has at most 8
    nonzeros in a span of 8 columns."""
    scs = 2 * np.arange(6 * 269)
    scs = (scs[0::2] + scs[1::2]) // 2
    first, weights = t_chest._band(tuple(int(s) for s in scs), 3228,
                                   "filter", 4)
    assert weights.shape == (3228, 8)
    assert first.min() == 0 and first.max() == 807 - 8


# ------------------------------------------------------------ K11's twin

SRS_CASES = [(2, 1), (2, 2), (2, 4), (4, 1), (4, 2), (4, 4)]


@pytest.mark.parametrize("comb,ports", SRS_CASES)
def test_srs_estimate_matches_jax(comb, ports):
    """With several SRS ports the TA power has exact ties: every layer's LS
    holds every port at a cyclic-shift delay offset, so the sum over layers
    puts the same power (noise included, permuted) on each of the L
    aliases, and rounding picks the first.  There the port's TA must be one
    of JAX's tied aliases, and the SRS noise (which follows the TA) is held
    against JAX at JAX's TA."""
    rng = np.random.default_rng(comb * 10 + ports)
    cfg = j_srs.SrsConfig(rb_start=4, rb_count=8, start_symbol=12,
                          nof_symbols=2, comb=comb, comb_offset=1,
                          cyclic_shift=3, nof_ports=ports, sequence_id=7,
                          numerology=1)
    tx = np.asarray(j_srs.map_to_grid(jnp.zeros((4, 14, 288), jnp.complex64),
                                      cfg))
    h = _cgauss(rng, (4, 4))
    delay = np.exp(-2j * np.pi * np.arange(288) * 30e3 * 0.2e-6)
    grid = (np.einsum("rp,psk->rsk", h, tx) * delay
            + _cgauss(rng, (4, 14, 288), 0.02)).astype(np.complex64)
    ref = j_srs.estimate(jnp.asarray(grid), cfg)
    tcfg = convert.config(cfg)
    got = t_srs.estimate(torch.as_tensor(grid), tcfg)
    for key in ("coeffs", "rsrp", "epre"):
        close(getattr(got, key).numpy(), getattr(ref, key))
    ta, ta_ref = float(got.time_alignment_s), float(ref.time_alignment_s)
    if ports == 1:
        assert ta == ta_ref
        got_nv, got_snr = got.noise_var, got.snr
    else:
        alias = 1.0 / (ports * 30e3 * comb)         # the tied peaks' spacing
        steps = (ta - ta_ref) / alias
        assert abs(steps - round(steps)) < 1e-3, (ta, ta_ref)
        got_nv, got_snr = t_srs.srs_noise(
            torch.as_tensor(grid), tcfg,
            torch.tensor(ta_ref, dtype=torch.float32), got.rsrp)
    close(got_nv.numpy(), ref.noise_var)
    close(got_snr.numpy(), ref.snr)
    np.testing.assert_array_equal(
        t_srs.map_to_grid(torch.zeros((4, 14, 288), dtype=torch.complex64),
                          tcfg).numpy(), tx)


# ------------------------------------------------------------ K10's twin

def _f1_case(n_users, hopping, seed):
    common = j_pucch.PucchF1Config(
        prb=3, start_symbol=0, nof_symbols=14, initial_cyclic_shift=0,
        time_domain_occ=0, n_id=5, slot=3, nof_harq_bits=2,
        second_hop_prb=9 if hopping else None)
    rng = np.random.default_rng(seed)
    users, bits = [], []
    grid = jnp.zeros((4, 14, 144), jnp.complex64)
    for u in range(n_users):
        cfg = dataclasses.replace(common, initial_cyclic_shift=4 * u,
                                  time_domain_occ=u % 2,
                                  nof_harq_bits=1 + u % 2)
        b = rng.integers(0, 2, cfg.nof_harq_bits)
        users.append((cfg.initial_cyclic_shift, cfg.time_domain_occ,
                      cfg.nof_harq_bits))
        bits.append(b)
        one = np.asarray(j_pucch.transmit_format1(
            jnp.zeros((4, 14, 144), jnp.complex64), cfg, b))[0]
        grid = grid + np.einsum("p,sk->psk", _cgauss(rng, (4,)), one)
    grid = np.asarray(grid) + _cgauss(rng, (4, 14, 144), 0.05)
    return common, tuple(users), bits, grid.astype(np.complex64)


@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("hopping", [False, True])
@pytest.mark.parametrize("n_users", [1, 2, 3])
def test_detect_format1_batch_matches_jax(n_users, hopping, with_ctx):
    common, users, bits, grid = _f1_case(n_users, hopping,
                                         n_users + 10 * hopping)
    weights = j_pucch.f1_batch_weights(common, users)
    ref = j_pucch.detect_format1_batch(
        jnp.asarray(grid), common, users,
        ncs=tuple(tuple(jnp.asarray(w) for w in hop) for hop in weights)
        if with_ctx else None)
    ctx = (convert.slot_context({"f1": (weights,)}, "cpu")["f1"][0]
           if with_ctx else None)
    got = t_pucch.detect_format1_batch(torch.as_tensor(grid),
                                       convert.config(common), users, ncs=ctx)
    assert len(got) == len(ref) == n_users
    for g, r, b in zip(got, ref, bits):
        assert bool(g["detected"]) == bool(r["detected"])
        np.testing.assert_array_equal(g["harq_bits"].numpy(),
                                      np.asarray(r["harq_bits"]))
        np.testing.assert_array_equal(g["harq_bits"].numpy(), b)
        close(g["metric"].numpy(), r["metric"], rtol=1e-4)
        close(g["symbol"].numpy(), r["symbol"], rtol=1e-4)


@pytest.mark.parametrize("hopping", [False, True])
def test_f1_batch_weights_match_jax(hopping):
    common, users, _, _ = _f1_case(3, hopping, 1)
    for a, b in zip(j_pucch.f1_batch_weights(common, users),
                    t_pucch.f1_batch_weights(convert.config(common), users)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("nbits", [1, 2])
def test_transmit_format1_loopback(nbits):
    """The port's UE-side F1 on an empty grid equals the JAX package's and
    is detected back with the sent bits."""
    cfg = j_pucch.PucchF1Config(prb=2, start_symbol=0, nof_symbols=14,
                                initial_cyclic_shift=3, time_domain_occ=1,
                                n_id=9, slot=5, nof_harq_bits=nbits)
    bits = np.array([1, 0][:nbits])
    ref = np.asarray(j_pucch.transmit_format1(
        jnp.zeros((2, 14, 48), jnp.complex64), cfg, bits))
    tcfg = convert.config(cfg)
    grid = t_pucch.transmit_format1(
        torch.zeros((2, 14, 48), dtype=torch.complex64), tcfg, bits)
    np.testing.assert_allclose(grid.numpy(), ref, rtol=0, atol=1e-6)
    (res,) = t_pucch.detect_format1_batch(
        grid, tcfg, ((3, 1, nbits),))
    assert bool(res["detected"])
    np.testing.assert_array_equal(res["harq_bits"].numpy(), bits)
    one = t_pucch.detect_format1(grid, tcfg)
    np.testing.assert_array_equal(one["harq_bits"].numpy(), bits)
    close(one["metric"].numpy(),
          j_pucch.detect_format1(jnp.asarray(ref), cfg)["metric"], rtol=1e-4)


# ------------------------------------------------------------- K9's twin

def _format0_capture(cfg, preamble, seed):
    rng = np.random.default_rng(seed)
    tx = j_prach.generate_np(cfg, preamble)
    k = np.arange(cfg.l_ra)
    ramp = np.exp(-2j * np.pi * k * cfg.scs_hz * 5e-6)
    fd = np.stack([g * tx * ramp for g in (1.0, 0.8)])[:, None, :]
    return (fd + 0.1 * (rng.standard_normal(fd.shape)
                        + 1j * rng.standard_normal(fd.shape))
            ).astype(np.complex64)


PRACH_CASES = {
    "b4_flagship": (j_prach.PrachConfig(format="B4", root_sequence_index=39,
                                        zero_correlation_zone=10,
                                        ra_scs_hz=30_000), None),
    "format0": (j_prach.PrachConfig(format="0", root_sequence_index=22,
                                    zero_correlation_zone=10), 37),
}


@pytest.mark.parametrize("case", sorted(PRACH_CASES))
def test_prach_detect_matches_jax(case):
    cfg, preamble = PRACH_CASES[case]
    if preamble is None:          # the bench's capture, preamble 21
        preamble = flagship.PRACH_PREAMBLE
        fd = flagship.prach_capture(np.random.default_rng(0))
    else:
        fd = _format0_capture(cfg, preamble, 3)
    ref = j_prach.detect(jnp.asarray(fd), cfg)
    got = t_prach.detect(torch.as_tensor(fd), convert.config(cfg))
    det = got.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(ref.detected))
    assert np.flatnonzero(det).tolist() == [preamble]
    np.testing.assert_array_equal(got.time_advance_s.numpy(),
                                  np.asarray(ref.time_advance_s))
    close(got.metrics.numpy(), ref.metrics, rtol=1e-4)
    close(got.rssi.numpy(), ref.rssi)


@pytest.mark.parametrize("cfg", [
    PRACH_CASES["b4_flagship"][0], PRACH_CASES["format0"][0],
    j_prach.PrachConfig(format="0", root_sequence_index=100,
                        zero_correlation_zone=5, restricted="type_a"),
    j_prach.PrachConfig(format="A1", root_sequence_index=3,
                        zero_correlation_zone=0, nof_preambles=8,
                        start_preamble=4)])
def test_prach_host_tables_match_jax(cfg):
    tcfg = convert.config(cfg)
    assert t_prach._root_set(tcfg) == j_prach._root_set(cfg)
    np.testing.assert_array_equal(t_prach._root_fd(tcfg), j_prach._root_fd(cfg))
    np.testing.assert_array_equal(t_prach.generate_np(tcfg, 3),
                                  j_prach.generate_np(cfg, 3))
    assert t_prach.cp_seq_samples(tcfg) == j_prach.cp_seq_samples(cfg)
    assert t_prach.calibrated_threshold(tcfg, 4) == \
        j_prach.calibrated_threshold(cfg, 4)


# ------------------------------------------------------------ the UL slot

TBS = tbs_calc(18, 14, 36, "qam64", 0.7, 2)
SEG = segment_tb(TBS, select_base_graph(TBS, 0.7))
J_CELL = j_slots.CellConfig(nof_ports=4, nof_rb=24, dft_size=512, numerology=1)
J_PUSCH = j_pusch.PuschConfig(rnti=0x17, rb_start=0, rb_count=18,
                              first_symbol=0, nof_symbols=14,
                              modulation="qam64", target_code_rate=0.7,
                              tbs=TBS, nof_layers=2, n_id=1,
                              dmrs_symbols=(2, 7, 11))
J_UE = j_pdsch.PdschConfig(rnti=0x17, rb_start=0, rb_count=18, first_symbol=0,
                           nof_symbols=14, modulation="qam64",
                           target_code_rate=0.7, tbs=TBS, nof_layers=2,
                           n_id=1, dmrs_symbols=(2, 7, 11))
J_F1 = j_pucch.PucchF1Config(prb=18, start_symbol=0, nof_symbols=14,
                             initial_cyclic_shift=0, time_domain_occ=0,
                             n_id=1)
J_PRACH = PRACH_CASES["b4_flagship"][0]
J_SRS = j_srs.SrsConfig(rb_start=20, rb_count=4, start_symbol=13,
                        nof_symbols=1, comb=2, comb_offset=0, cyclic_shift=0,
                        nof_ports=1, sequence_id=1, numerology=1, rnti=0x17)
SLOT = 6
UL_PLAN = ((J_PUSCH,), (), (J_F1,), (), (J_PRACH,), (J_SRS,))


@pytest.fixture(scope="module")
def ul_mix():
    """The small cell's full-mix UL slot through the JAX program and the
    port's, on the same numpy-made samples, capture and slot context."""
    rng = np.random.default_rng(2027)
    payload = rng.integers(0, 2, TBS).astype(np.int8)
    ue = dataclasses.replace(J_UE, slot_in_frame=SLOT)
    _, grid = j_slots.dl_slot_fn(J_CELL, ((), (), (J_UE,), ()))(
        (), (), (jnp.asarray(payload),),
        {"pdsch": (jnp.asarray(j_dmrs.pilot_values_for(
            j_pdsch.dmrs_config(ue))),)})
    grid = j_srs.map_to_grid(grid, J_SRS)
    f1_bits = np.array([1])
    grid = j_pucch.transmit_format1(
        grid, dataclasses.replace(J_F1, slot=SLOT), f1_bits)
    samples = np.asarray(j_ofdm.modulate_slot(grid, 512, 1,
                                              center_freq_hz=3.5e9))
    h = _cgauss(rng, (4, 2))
    rx = h @ samples[:2]
    sigma = np.sqrt(np.mean(np.abs(rx) ** 2) * 10 ** (-30 / 10) / 2)
    rx = (rx + sigma * (rng.standard_normal(rx.shape)
                        + 1j * rng.standard_normal(rx.shape))
          ).astype(np.complex64)
    fd = flagship.prach_capture(np.random.default_rng(0))
    soft = np.zeros((SEG.nof_codeblocks, SEG.codeword_bits), np.float32)
    ctx = {"pusch": (j_dmrs.pilot_values_for(j_pusch.dmrs_config(
               dataclasses.replace(J_PUSCH, slot_in_frame=SLOT))),),
           "f0": (), "f2": (), "f3": (),
           "f1": (j_pucch.f1_batch_weights(
               dataclasses.replace(J_F1, slot=SLOT),
               ((0, 0, 1),)),)}
    j_ctx = {k: tuple(tuple(tuple(jnp.asarray(w) for w in hop) for hop in e)
                      if k == "f1" else jnp.asarray(e) for e in v)
             for k, v in ctx.items()}
    ref = j_slots.ul_slot_fn(J_CELL, UL_PLAN)(
        jnp.asarray(rx), (jnp.asarray(fd),), (jnp.asarray(soft),), j_ctx)
    got = t_slots.ul_slot_fn(convert.config(J_CELL), convert.plan(UL_PLAN))(
        torch.as_tensor(rx), (torch.as_tensor(fd),),
        convert.soft_buffers((soft,), "cpu"), convert.slot_context(ctx, "cpu"))
    return dict(ref=ref, got=got, payload=payload, f1_bits=f1_bits)


EQUAL = {"tb_bits", "tb_crc_ok", "nof_iterations", "ta_s", "detected",
         "harq_bits"}


def test_ul_mix_keys(ul_mix):
    ref, got = ul_mix["ref"], ul_mix["got"]
    assert set(got) == set(ref)
    for kind in ref:
        assert len(got[kind]) == len(ref[kind]), kind
        for g, r in zip(got[kind], ref[kind]):
            assert set(g) == set(r), kind


@pytest.mark.parametrize("kind", ["pusch", "pucch_f1", "prach", "srs"])
def test_ul_mix_entries_match_jax(ul_mix, kind):
    """Every key of every entry: decisions equal, CFO within 1 Hz, the new
    soft buffer within 1e-3, the other floats within 1e-4."""
    for g, r in zip(ul_mix["got"][kind], ul_mix["ref"][kind]):
        for key in r:
            a, b = g[key].numpy(), np.asarray(r[key])
            assert a.shape == b.shape, (kind, key)
            if kind == "prach" and key == "ta_s":
                # XLA's jit turns the division by the constant N * scs
                # into a multiply by its reciprocal (1 ulp); the port
                # divides, as the JAX detect does outside jit.
                np.testing.assert_allclose(a, b, rtol=2e-7, atol=0)
            elif key in EQUAL:
                np.testing.assert_array_equal(a, b, err_msg=f"{kind} {key}")
            elif key == "cfo_hz":
                assert abs(float(a) - float(b)) < 1.0
            else:
                close(a, b, rtol=1e-3 if key == "new_soft" else 1e-4)


def test_ul_mix_decodes(ul_mix):
    got = ul_mix["got"]
    assert bool(got["pusch"][0]["tb_crc_ok"])
    np.testing.assert_array_equal(got["pusch"][0]["tb_bits"].numpy(),
                                  ul_mix["payload"])
    f1 = got["pucch_f1"][0]
    assert bool(f1["detected"])
    np.testing.assert_array_equal(f1["harq_bits"].numpy(), ul_mix["f1_bits"])
    det = got["prach"][0]["detected"].numpy()
    assert np.flatnonzero(det).tolist() == [flagship.PRACH_PREAMBLE]


def test_ul_mix_without_context_matches(ul_mix):
    """Without ctx the F1 weights come from the host (the plan's slot) and
    the PUSCH pilots from the config: the call still runs and keeps the
    PRACH and SRS results."""
    got = ul_mix["got"]
    plan = convert.plan(((), (), (J_F1,), (), (J_PRACH,), (J_SRS,)))
    fn = t_slots.ul_slot_fn(convert.config(J_CELL), plan)
    rx = torch.zeros((4, J_CELL.slot_samples()), dtype=torch.complex64)
    fd = torch.as_tensor(flagship.prach_capture(np.random.default_rng(0)))
    out = fn(rx, (fd,), None)
    assert torch.equal(out["prach"][0]["detected"], got["prach"][0]["detected"])
    assert not bool(out["pucch_f1"][0]["detected"])
    assert out["srs"][0]["wideband_h"].shape == (4, 1)
