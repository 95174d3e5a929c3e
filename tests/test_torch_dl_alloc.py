"""Every PDSCH allocation and option of the JAX package through the port,
and the UE-side DL receivers, against the JAX package on the CPU.

RA type 0 bitmaps and interleaved VRBs (ran/rb_allocation.py), with and
without per-PRG precoding: the PDSCH chain, the DM-RS (type 1 on a PRB
list, type 2 on ports 0-5), the validators' messages, the conductors and
the two DU-low servers; limited-buffer rate matching (``n_ref``); the
receivers ``pdcch.decode_dci`` / ``recover`` at every aggregation level,
``ssb.pbch_decode`` / ``pbch_extract_mib`` and ``prach.generate``.  On the
CPU every kernel wrapper runs its plain twin.  Bits are exact (PRB lists,
RE plans, rate-matched bits, decoded payloads, CRC flags); grids within
1e-6 of max|ref| (the same float ops in the same order, up to the
precoder's sum), samples within 1e-4 of max|ref| (the FFTs differ), LLRs
within 1e-5 relative (XLA's and PyTorch's demap round alike up to the
last bit, the dematch's repetition sums in another order).  Cells of 24 to
52 RB; the DU-low's flagship slots E and F run under ``-m slow``.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.fapi import conductor as j_cond
from srsran_tpu.fapi import config_messages as j_cm
from srsran_tpu.fapi import transport as j_tr
from srsran_tpu.fapi.messages import DlTtiRequest, TxDataRequest
from srsran_tpu.fapi.validators import ValidationError as JValidationError
from srsran_tpu.fapi.validators import validate_dl_tti as j_validate_dl
from srsran_tpu.ops import ldpc_rate_match as j_rm
from srsran_tpu.ops import ofdm as j_ofdm
from srsran_tpu.phy.slot_programs import CellConfig
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pdcch as j_pdcch
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import prach as j_prach
from srsran_tpu.phy.upper import ssb as j_ssb
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc
from srsran_tpu.ran.precoding_codebooks import PrecodingConfig, nof_prgs
from srsran_tpu.ran.slot_point import SlotPoint

from srsran_tpu_torch import convert
from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.fapi import transport as t_tr
from srsran_tpu_torch.fapi.validators import ValidationError
from srsran_tpu_torch.fapi.validators import validate_dl_tti as t_validate_dl
from srsran_tpu_torch.ops import dl_control
from srsran_tpu_torch.ops import ldpc_rate_match as t_rm
from srsran_tpu_torch.ops import ofdm as t_ofdm
from srsran_tpu_torch.phy.upper import dmrs as t_dmrs
from srsran_tpu_torch.phy.upper import pdcch as t_pdcch
from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
from srsran_tpu_torch.phy.upper import prach as t_prach
from srsran_tpu_torch.phy.upper import ssb as t_ssb

torch.set_num_threads(2)

NSC = 24 * 12


def _cgauss(rng, shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _close(port, ref, rtol):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=rtol * float(np.max(np.abs(ref))))


def _cfg(**kw):
    """tests/test_rb_allocation.py's PDSCH on 24 RB."""
    base = dict(rnti=0x4601, rb_start=0, rb_count=8, first_symbol=1,
                nof_symbols=12, modulation="qam16", target_code_rate=0.5,
                tbs=824, nof_layers=1, dmrs_symbols=(2, 7), n_id=7,
                dmrs_scrambling_id=7)
    base.update(kw)
    return j_pdsch.PdschConfig(**base)


def _prg(rb_start, rb_count, ports, layers, shift=0):
    """A per-PRG PrecodingConfig over [rb_start, rb_start + rb_count) (PRG
    size 4), cycling the repository's (ports, layers) matrices."""
    base = {(2, 1): 2, (2, 2): 6, (4, 1): 2, (4, 2): 34, (4, 4): 82}[
        (ports, layers)]
    width = {(2, 1): 4, (2, 2): 2, (4, 1): 32, (4, 2): 32, (4, 4): 16}[
        (ports, layers)]
    n = nof_prgs(rb_start, rb_count, 4)
    return PrecodingConfig(prg_size=4, pm_indices=tuple(
        base + (g + shift) % width for g in range(n)))


# ------------------------------------------------------------ the PDSCH

PDSCH_CASES = {
    "type0": dict(rb_start=1, rb_count=22, prbs=(1, 4, 5, 9, 13, 20, 21, 22)),
    "type0_2l": dict(rb_start=0, rb_count=24, nof_layers=2, tbs=1608,
                     dmrs_symbols=(2, 11),
                     prbs=(0, 2, 3, 8, 9, 15, 16, 23)),
    "type0_prg": dict(rb_start=2, rb_count=14, nof_layers=2,
                      prbs=(2, 3, 8, 9, 14, 15),
                      precoding=_prg(2, 14, 2, 2)),
    "interleaved": dict(rb_count=8, vrb_prb_interleaved=True, bwp_size=24),
    "interleaved_prg": dict(rb_start=4, rb_count=10, vrb_prb_interleaved=True,
                            bwp_size=24, nof_layers=2),
    "interleaved_no_bwp": dict(rb_start=2, rb_count=12,
                               vrb_prb_interleaved=True),
    "type0_reserved1": dict(rb_start=3, rb_count=18, reserved_cdm_groups=1,
                            prbs=(3, 6, 7, 12, 20)),
}


def _case_cfg(name):
    cfg = _cfg(**PDSCH_CASES[name])
    if name == "interleaved_prg":        # PRGs over the interleaved span
        prbs = j_pdsch.alloc_prbs(cfg)
        cfg = dataclasses.replace(cfg, precoding=_prg(
            int(prbs[0]), int(prbs[-1] - prbs[0] + 1), 2, 2, 1))
    return cfg


@pytest.mark.parametrize("name", sorted(PDSCH_CASES))
def test_pdsch_allocation_matches_jax(name):
    """The PDU's PRB list, plan key, data-RE count and rate-match sizes
    exactly, and ``pdsch.process`` into a 2-port grid within 1e-6 of max
    |ref| (the per-PRG cases with their PRG base at the first allocated
    PRB)."""
    cfg = _case_cfg(name)
    tcfg = convert.config(cfg)
    np.testing.assert_array_equal(t_pdsch.alloc_prbs(tcfg),
                                  j_pdsch.alloc_prbs(cfg))
    assert t_pdsch._plan_prbs_key(tcfg) == j_pdsch._plan_prbs_key(cfg)
    assert t_pdsch.nof_data_re(tcfg) == j_pdsch.nof_data_re(cfg)
    bits = np.random.default_rng(len(name)).integers(
        0, 2, cfg.tbs).astype(np.int8)
    ref = j_pdsch.process(jnp.zeros((2, 14, NSC), jnp.complex64),
                          jnp.asarray(bits), cfg)
    got = t_pdsch.process(torch.zeros((2, 14, NSC), dtype=torch.complex64),
                          torch.as_tensor(bits), tcfg)
    _close(got, ref, 1e-6)
    prbs = set(t_pdsch.alloc_prbs(tcfg))
    energy = got.abs().sum(dim=(0, 1)).reshape(24, 12).sum(dim=1)
    assert {int(p) for p in torch.nonzero(energy).flatten()} == prbs


# ------------------------------------------------------------ the DM-RS

DMRS_CASES = {
    "type0_1l": dict(rb_start=1, rb_count=22, ports=(0,),
                     prbs=(1, 4, 5, 9, 13, 20, 21, 22)),
    "type0_4l": dict(rb_start=0, rb_count=24, ports=(0, 1, 2, 3),
                     prbs=(0, 2, 3, 8, 9, 15, 16, 23)),
    "type2_1l": dict(rb_start=2, rb_count=20, ports=(4,), config_type=2),
    "type2_2l": dict(rb_start=2, rb_count=20, ports=(0, 1), config_type=2),
    "type2_4l": dict(rb_start=0, rb_count=24, ports=(0, 1, 4, 5),
                     config_type=2),
}


@pytest.mark.parametrize("precoder", ["none", "matrix", "prg"])
@pytest.mark.parametrize("name", sorted(DMRS_CASES))
def test_dmrs_map_matches_jax(name, precoder):
    """``dmrs.map_to_grid`` on a PRB list (type 1) and for type 2 (ports 0,
    1, 4, 5), with the port map, a [P, L] matrix or per-PRG matrices whose
    PRG base is the first allocated PRB: pilot values exact, the grid
    equal (identity) or within 1e-6 of max|ref|."""
    kw = dict(symbols=(2, 11), scrambling_id=5, slot_in_frame=3,
              **DMRS_CASES[name])
    jc, tc = j_dmrs.DmrsConfig(**kw), t_dmrs.DmrsConfig(**kw)
    np.testing.assert_array_equal(t_dmrs.pilot_values_for(tc),
                                  j_dmrs.pilot_values_for(jc))
    layers = len(kw["ports"])
    rng = np.random.default_rng(layers)
    g = _cgauss(rng, (4, 14, NSC))
    prbs = tc.prb_list
    if precoder == "prg":
        n = prbs[-1] // 4 - prbs[0] // 4 + 1
        w = _cgauss(rng, (n, 4, layers))
        ref = j_dmrs.map_to_grid(
            jnp.asarray(g), jc, None, None, prg_matrices=jnp.asarray(w),
            prg_of_sc=lambda sc: j_pdsch.prg_index_of_sc(sc, prbs[0], 4))
        got = t_dmrs.map_to_grid(torch.as_tensor(g.copy()), tc, None, None,
                                 prg_matrices=torch.as_tensor(w), prg_size=4)
        _close(got, ref, 1e-6)
        return
    w = _cgauss(rng, (4, layers)) if precoder == "matrix" else None
    ref = j_dmrs.map_to_grid(jnp.asarray(g), jc, w)
    got = t_dmrs.map_to_grid(torch.as_tensor(g.copy()), tc, w)
    if w is None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        _close(got, ref, 1e-6)


def test_dmrs_type2_layout():
    """tests/test_pdcch_dmrs2.py::test_dmrs_type2_layout through the port:
    group 0 on {0, 1, 6, 7}, group 1 on {2, 3, 8, 9}, group 2 on {4, 5, 10,
    11} of every PRB, and the same grid as the JAX package's."""
    kw = dict(rb_start=0, rb_count=2, symbols=(2,), ports=(0, 2, 4),
              scrambling_id=1, config_type=2)
    ref = np.asarray(j_dmrs.map_to_grid(
        jnp.zeros((3, 14, 24), jnp.complex64), j_dmrs.DmrsConfig(**kw)))
    got = t_dmrs.map_to_grid(torch.zeros((3, 14, 24), dtype=torch.complex64),
                             t_dmrs.DmrsConfig(**kw)).numpy()
    np.testing.assert_array_equal(got, ref)
    for port, group in ((0, 0), (1, 1), (2, 2)):
        assert set(np.nonzero(got[port, 2])[0].tolist()) == {
            12 * rb + 2 * group + d for rb in (0, 1) for d in (0, 1, 6, 7)}


def test_dmrs_type2_on_a_prb_list_raises_as_jax():
    kw = dict(rb_start=0, rb_count=8, symbols=(2,), ports=(0,),
              scrambling_id=1, config_type=2, prbs=(0, 3, 7))
    with pytest.raises(AssertionError):
        j_dmrs.map_to_grid(jnp.zeros((1, 14, 96), jnp.complex64),
                           j_dmrs.DmrsConfig(**kw))
    with pytest.raises(AssertionError):
        t_dmrs.map_to_grid(torch.zeros((1, 14, 96), dtype=torch.complex64),
                           t_dmrs.DmrsConfig(**kw))


# ------------------------------------------- limited-buffer rate matching

# tests/test_ldpc_decode.py:97-101's cases, then n_ref cutting the buffer
# before and inside the filler range: (bg, z, k_prime, c, qm, nl, g, n_ref)
RM_CASES = [
    (1, 64, 64 * 20, 3, 8, 4, 8 * 4 * 3 * 700, 0),
    (2, 52, 52 * 9, 2, 4, 1, 4 * 2 * 1100, 0),
    (1, 384, 384 * 21, 4, 6, 2, 6 * 2 * 4 * 2000, 20000),
    (1, 64, 64 * 20, 3, 4, 2, 4 * 2 * 3 * 500, 64 * 20 - 128 - 50),
    (1, 64, 64 * 20, 3, 4, 2, 4 * 2 * 3 * 500, 64 * 20 - 128 + 40),
    (2, 52, 52 * 9, 2, 2, 1, 2 * 2 * 900, 1500),
]


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
@pytest.mark.parametrize("case", range(len(RM_CASES)))
def test_rate_match_n_ref_matches_jax(case, rv):
    """rate_match_batch bit for bit (the codewords cut at n_cb, JAX
    ldpc_rate_match.py:147) and rate_dematch_batch within 1e-5 (the
    repetitions summed in window order) with the filler LLRs and the 0
    columns past n_cb exact."""
    bg, z, kp, c, qm, nl, g_total, n_ref = RM_CASES[case]
    k = (22 if bg == 1 else 10) * z
    n = (66 if bg == 1 else 50) * z - 2 * z
    unit = nl * qm
    base = unit * (g_total // (unit * c))
    gamma = (g_total // unit) % c
    e_sizes = tuple(base if j < c - gamma else base + unit for j in range(c))
    rng = np.random.default_rng(case)
    cws = rng.integers(0, 2, (c, n)).astype(np.int8)
    want = np.asarray(j_rm.rate_match_batch(
        jnp.asarray(cws), e_sizes, rv, qm, bg, z, kp, k, n_ref))
    got = t_rm.rate_match_batch(torch.as_tensor(cws), e_sizes, rv, qm, bg, z,
                                kp, k, n_ref)
    np.testing.assert_array_equal(got.numpy(), want)
    llrs = rng.normal(size=sum(e_sizes)).astype(np.float32)
    want = np.asarray(j_rm.rate_dematch_batch(
        jnp.asarray(llrs), c, e_sizes, rv, qm, bg, z, kp, k, n, n_ref))
    got = t_rm.rate_dematch_batch(torch.as_tensor(llrs), c, e_sizes, rv, qm,
                                  bg, z, kp, k, n, n_ref).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    fs, fe, n_nf, _ = t_rm._window_plan(rv, bg, z, kp, k, n, n_ref)
    np.testing.assert_array_equal(got[:, fs:fe], want[:, fs:fe])
    np.testing.assert_array_equal(got[:, n_nf + fe - fs:], 0.0)


def test_pdsch_map_n_ref_twin_matches_jax_chain():
    """K6's twin with a limited buffer: the JAX package's rate match,
    scramble, modulate, layer map and precode on the same codeblocks."""
    from srsran_tpu.ops import ldpc_encode as j_enc
    from srsran_tpu.ops.modulation import modulate
    from srsran_tpu.ops.precoding import layer_map
    from srsran_tpu.ops.scrambling import scramble_bits
    from srsran_tpu_torch.ops import dl_map
    cfg = _cfg(rb_start=0, rb_count=24, nof_layers=2, tbs=3240,
               modulation="qpsk", target_code_rate=0.3)
    tcfg = convert.config(cfg)
    seg = t_pdsch.segmentation(tcfg)
    rng = np.random.default_rng(9)
    info = rng.integers(0, 2, (seg.nof_codeblocks,
                               (22 if seg.base_graph == 1 else 10)
                               * seg.lifting_size)).astype(np.int8)
    cbs = np.asarray(j_enc.encode(jnp.asarray(info), seg.base_graph,
                                  seg.lifting_size))[:, 2 * seg.lifting_size:]
    n_ref = 3 * cbs.shape[1] // 5
    e_sizes = t_pdsch.rate_match_sizes(tcfg)
    cw = j_rm.rate_match_batch(jnp.asarray(cbs), e_sizes, cfg.rv, 2,
                               seg.base_graph, seg.lifting_size,
                               seg.cb_info_bits, seg.full_block_bits, n_ref)
    syms = modulate(scramble_bits(cw[None], (cfg.rnti << 15) + cfg.n_id),
                    "qpsk")
    want = np.asarray(layer_map(syms[0], 2))                    # [L, RE]
    w = torch.eye(2, dtype=torch.complex64)
    args = t_pdsch.map_args(torch.zeros((2, 14, NSC), dtype=torch.complex64),
                            tcfg, torch.as_tensor(cbs), w)
    grid = dl_map.pdsch_map(*args, n_ref=n_ref)
    sym, sc = args[-3].long(), args[-2].long()
    _close(grid[:, sym, sc], want, 1e-6)


# ------------------------------------------------- the UE-side receivers

@pytest.mark.parametrize("al", [1, 2, 4, 8, 16])
def test_decode_dci_and_recover_match_jax(al):
    """A DCI at each aggregation level through a noisy grid: ``recover``
    (K28's twin, then K15's) gives the JAX payload and CRC flag; the LLRs
    within 1e-5; ``decode_dci`` with another RNTI fails its CRC in both."""
    cs = j_pdcch.CoresetConfig(rb_start=0, nof_rb=96, start_symbol=0,
                               duration=1 + al % 3)
    cfg = j_pdcch.PdcchConfig(coreset=cs, rnti=0x4601 + al,
                              aggregation_level=al, cce_index=0,
                              payload_bits=41 + al, n_id=1, n_id_data=3,
                              n_rnti=al)
    rng = np.random.default_rng(al)
    pay = rng.integers(0, 2, cfg.payload_bits).astype(np.int8)
    g = np.asarray(j_pdcch.process(jnp.zeros((2, 14, 96 * 12), jnp.complex64),
                                   jnp.asarray(pay), cfg))
    g = g + 0.3 * _cgauss(rng, g.shape)
    tcfg = convert.config(cfg)
    jb, jok = j_pdcch.recover(jnp.asarray(g), cfg, noise_var=0.18)
    tb, tok = t_pdcch.recover(torch.as_tensor(g), tcfg, noise_var=0.18)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tb.numpy(), pay)
    assert bool(tok) and bool(jok)
    llr = dl_control.control_llrs(torch.as_tensor(g),
                                  (t_pdcch.rx_item(tcfg, g.shape, 0.18),))
    other = dataclasses.replace(cfg, rnti=0x1234)
    assert not bool(t_pdcch.decode_dci(llr, convert.config(other))[1])
    assert not bool(j_pdcch.decode_dci(jnp.asarray(llr.numpy()), other)[1])


def test_control_llrs_match_jax_chain():
    """K28's twin against the JAX chain (gather, QPSK demodulate,
    descramble) for two DCIs and an SSB's PBCH of one grid, in one call."""
    from srsran_tpu.ops.modulation import demodulate
    from srsran_tpu.ops.scrambling import descramble_llrs
    rng = np.random.default_rng(3)
    g = _cgauss(rng, (2, 14, 52 * 12))
    cs = j_pdcch.CoresetConfig(rb_start=24, nof_rb=24, start_symbol=0,
                               duration=2)
    dcis = [j_pdcch.PdcchConfig(coreset=cs, rnti=0x50 + j,
                                aggregation_level=al, cce_index=cce,
                                payload_bits=40, n_id_data=9, n_rnti=j)
            for j, (al, cce) in enumerate(((4, 0), (2, 4)))]
    sb = j_ssb.SsbConfig(phys_cell_id=11, ssb_idx=5, l_max=8,
                         first_symbol=2, first_subcarrier=48)
    items = tuple([t_pdcch.rx_item(convert.config(c), g.shape, 0.05)
                   for c in dcis]
                  + [t_ssb.rx_item(convert.config(sb), g.shape, port=1,
                                   noise_var=0.07)])
    got = dl_control.control_llrs(torch.as_tensor(g), items)
    want = []
    for c in dcis:
        pos, _, _ = j_pdcch._candidate_re_plan(c.coreset, c.cce_index,
                                               c.aggregation_level)
        syms = jnp.asarray(g[0, pos[:, 0], pos[:, 1]])
        llr = demodulate(syms[None], jnp.full((1, syms.shape[0]), 0.05,
                                              jnp.float32), "qpsk")
        want.append(np.asarray(descramble_llrs(
            llr, (c.n_rnti << 16) + c.n_id_data)[0]))
    _, pos = j_ssb._ssb_re_maps(sb.phys_cell_id % 4)
    syms = jnp.asarray(g[1, 2 + pos[:, 0], 48 + pos[:, 1]])
    llr = demodulate(syms[None], jnp.full((1, syms.shape[0]), 0.07,
                                          jnp.float32), "qpsk")
    want.append(np.asarray(descramble_llrs(llr, sb.phys_cell_id,
                                           advance=5 * 864)[0]))
    np.testing.assert_allclose(got.numpy(), np.concatenate(want), rtol=1e-5,
                               atol=1e-5)
    assert dl_control.rx_plan(items, g.size)["e"] == (432, 216, 864)


def test_pbch_decode_ofdm_loopback():
    """tests/test_ssb.py:55's loopback (MIB -> SSB -> OFDM -> noise ->
    demodulation -> PBCH decode) through both packages on the same
    samples: the payload, the CRC flag and the 24 MIB bits."""
    cfg = j_ssb.SsbConfig(phys_cell_id=42, ssb_idx=1, l_max=8, sfn=77,
                          first_symbol=2, first_subcarrier=48)
    rng = np.random.default_rng(1)
    mib = rng.integers(0, 2, 24).astype(np.int8)
    nof_sc, dft, mu = 360, 512, 1
    grid = j_ssb.map_ssb_to_grid(jnp.zeros((14, nof_sc), jnp.complex64), cfg,
                                 mib)
    tx = np.asarray(j_ofdm.modulate_slot(grid, dft, mu, center_freq_hz=3.5e9))
    amp = 0.05
    rx = (tx + rng.normal(0, amp, tx.shape)
          + 1j * rng.normal(0, amp, tx.shape)).astype(np.complex64)
    j_patch = j_ofdm.demodulate_slot(jnp.asarray(rx), nof_sc, dft, mu,
                                     center_freq_hz=3.5e9)[2:6, 48:288]
    a, ok = j_ssb.pbch_decode(j_patch, cfg, noise_var=2 * amp ** 2)
    t_grid = t_ofdm.demodulate_slot(torch.as_tensor(rx)[None], nof_sc, dft,
                                    mu, center_freq_hz=3.5e9)[0]
    tcfg = convert.config(cfg)
    ta, tok = t_ssb.pbch_decode(t_grid[2:6, 48:288], tcfg,
                                noise_var=2 * amp ** 2)
    assert bool(ok) and bool(tok)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(a))
    np.testing.assert_array_equal(t_ssb.pbch_extract_mib(ta, tcfg),
                                  j_ssb.pbch_extract_mib(np.asarray(a), cfg))
    np.testing.assert_array_equal(t_ssb.pbch_extract_mib(ta, tcfg), mib)


@pytest.mark.parametrize("cfg,preamble", [
    (dict(format="B4", root_sequence_index=39, zero_correlation_zone=10,
          ra_scs_hz=30000), 21),
    (dict(format="0", root_sequence_index=22, zero_correlation_zone=5), 0),
    (dict(format="A1", root_sequence_index=1, zero_correlation_zone=0,
          ra_scs_hz=15000), 63)])
def test_prach_generate_matches_jax(cfg, preamble):
    jc = j_prach.PrachConfig(**cfg)
    got = t_prach.generate(convert.config(jc), preamble, device="cpu")
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_prach.generate(jc, preamble)))


# ------------------------------------------------------- the validators

VCELL = CellConfig(nof_ports=2, nof_rb=52, dft_size=1024, numerology=1)


def _bad_pdsch():
    ptrs = j_pdsch.PdschPtrs()
    ok = _cfg(rb_start=0, rb_count=52, prbs=(0, 1, 7, 30, 51))
    return {
        "outside": dataclasses.replace(ok, prbs=(0, 60)),
        "duplicate": dataclasses.replace(ok, prbs=(3, 3, 5)),
        "empty": dataclasses.replace(ok, prbs=()),
        "ptrs": dataclasses.replace(ok, ptrs=ptrs),
        "interleaved_ptrs": _cfg(rb_count=8, vrb_prb_interleaved=True,
                                 bwp_size=52, ptrs=ptrs),
        "interleaved_beyond_bwp": _cfg(rb_start=20, rb_count=10,
                                       vrb_prb_interleaved=True, bwp_size=24),
        "capacity": dataclasses.replace(ok, tbs=8000),
        "prg_count": dataclasses.replace(ok, nof_layers=2, precoding=_prg(
            0, 40, 2, 2)),
        "prg_span": dataclasses.replace(ok, rb_start=10, rb_count=20,
                                        prbs=(12, 13, 30), precoding=_prg(
                                            10, 20, 2, 1)),
    }


@pytest.mark.parametrize("case", sorted(_bad_pdsch()))
def test_pdsch_allocation_validation_messages_match_jax(case):
    """Both validators reject each malformed type 0 / interleaved PDSCH
    with the same message."""
    dl = DlTtiRequest(slot=SlotPoint(1, 0), pdsch=(_bad_pdsch()[case],))
    with pytest.raises(JValidationError) as want:
        j_validate_dl(dl, VCELL)
    with pytest.raises(ValidationError) as got:
        t_validate_dl(convert.requests(dl), convert.config(VCELL))
    assert str(got.value) == str(want.value)


def test_pdsch_allocation_validation_passes_as_jax():
    """A type 0 PDSCH whose PRGs cover its span, and an interleaved one,
    pass both validators."""
    span = _cfg(rb_start=10, rb_count=20, prbs=(12, 13, 30), nof_layers=2,
                precoding=_prg(12, 19, 2, 2))
    inter = _cfg(rb_count=8, vrb_prb_interleaved=True, bwp_size=52)
    dl = DlTtiRequest(slot=SlotPoint(1, 0), pdsch=(span, inter))
    j_validate_dl(dl, VCELL)
    t_validate_dl(convert.requests(dl), convert.config(VCELL))


# ------------------------------------- the conductors and the servers

CELL = CellConfig(nof_ports=2, nof_rb=52, dft_size=1024, numerology=1)
SSB = j_ssb.SsbConfig(phys_cell_id=3, ssb_idx=0, l_max=8, first_symbol=2,
                      first_subcarrier=48)
CORESET = j_pdcch.CoresetConfig(rb_start=0, nof_rb=24, start_symbol=0,
                                duration=2)
# Type 0 with RBG size 4 (a 52-RB BWP): RBGs 6-8 and 10-12, around the
# SSB's PRBs 4-23 and the CORESET.
E_PRBS = tuple(range(24, 36)) + tuple(range(40, 52))
E_PDSCH = j_pdsch.PdschConfig(
    rnti=0x4601, rb_start=24, rb_count=28, first_symbol=2, nof_symbols=12,
    modulation="qam64", target_code_rate=0.7, nof_layers=2, n_id=1,
    dmrs_symbols=(2, 11), prbs=E_PRBS,
    tbs=tbs_calc(len(E_PRBS), 12, 24, "qam64", 0.7, 2),
    precoding=_prg(24, 28, 2, 2))
F_PDSCH = dataclasses.replace(
    E_PDSCH, rb_start=0, rb_count=24, prbs=None, vrb_prb_interleaved=True,
    bwp_size=52, precoding=None, first_symbol=1,
    tbs=tbs_calc(24, 12, 24, "qam64", 0.7, 2))
A_PDSCH = dataclasses.replace(E_PDSCH, rb_start=0, rb_count=52, prbs=None,
                              precoding=None, first_symbol=1,
                              ptrs=j_pdsch.PdschPtrs(),
                              tbs=tbs_calc(52, 12, 24, "qam64", 0.7, 2))


def _dcis(kind, sl):
    if kind == "E":
        return tuple(j_pdcch.PdcchConfig(
            coreset=CORESET, rnti=0x4611 + j, aggregation_level=al,
            cce_index=cce, payload_bits=40, n_id=3, n_id_data=3, n_rnti=j,
            slot_in_frame=sl) for j, (al, cce) in enumerate(((4, 0), (2, 4),
                                                             (1, 6))))
    return (j_pdcch.PdcchConfig(
        coreset=dataclasses.replace(CORESET, duration=1), rnti=0x4620,
        aggregation_level=4, cce_index=0, payload_bits=40, n_id=3,
        n_id_data=3, slot_in_frame=sl),)


def _slot(kind, count, rng):
    """(dl, tx, dci payloads, mib) of a small DU-low slot: E (SSB, three
    DCIs, type 0 PDSCH precoded per PRG), F and F_prg (a DCI and an
    interleaved PDSCH, without and with per-PRG precoding), G (type 0 with
    PT-RS) or A (a contiguous PDSCH with PT-RS)."""
    slot = SlotPoint(1, count)
    sl = slot.slot_index
    if kind.startswith("F"):
        cfg = F_PDSCH
        if kind == "F_prg":
            prbs = j_pdsch.alloc_prbs(F_PDSCH)
            cfg = dataclasses.replace(F_PDSCH, precoding=_prg(
                int(prbs[0]), int(prbs[-1] - prbs[0] + 1), 2, 2, 1))
    else:
        cfg = {"E": E_PDSCH, "A": A_PDSCH,
               "G": dataclasses.replace(E_PDSCH,
                                        ptrs=j_pdsch.PdschPtrs())}[kind]
    dcis = _dcis(kind, sl) if kind in ("E", "F", "F_prg") else ()
    ssbs = (dataclasses.replace(SSB, sfn=slot.sfn),) if kind == "E" else ()
    pays = [rng.integers(0, 2, c.payload_bits).astype(np.int8) for c in dcis]
    mib = rng.integers(0, 2, 24).astype(np.int8)
    dl = DlTtiRequest(slot=slot, ssb=ssbs, pdcch=dcis,
                      pdsch=(dataclasses.replace(cfg, slot_in_frame=sl),))
    tx = TxDataRequest(
        slot=slot, ssb_mib=tuple(mib for _ in ssbs),
        pdcch_payloads=tuple(pays),
        pdsch_payloads=(rng.integers(0, 2, cfg.tbs).astype(np.int8),))
    return dl, tx, pays, mib


@pytest.mark.parametrize("kind", ["E", "F", "F_prg"])
def test_alloc_slot_through_conductors(kind):
    """A DU-low slot with a type 0 or interleaved PDSCH through both
    conductors (validators on): samples within 1e-4 and grids within 1e-6
    of max|ref|; the UE side decodes every DCI (and slot E's PBCH) from the
    port's grid with the port's receivers, as the JAX ones do."""
    dl, tx, pays, mib = _slot(kind, 2, np.random.default_rng(len(kind)))
    js, jg = j_cond.SlotConductor(CELL).process_dl(dl, tx)
    ts, tg = t_cond.SlotConductor(convert.config(CELL), device="cpu"
                                  ).process_dl(convert.requests(dl),
                                               convert.requests(tx))
    _close(tg, jg, 1e-6)
    _close(ts, js, 1e-4)
    for cfg, pay in zip(dl.pdcch, pays):
        bits, ok = t_pdcch.recover(tg, convert.config(cfg))
        jbits, jok = j_pdcch.recover(jg, cfg)
        assert bool(ok) and bool(jok)
        np.testing.assert_array_equal(bits.numpy(), pay)
        np.testing.assert_array_equal(np.asarray(jbits), pay)
    for cfg in dl.ssb:
        a, ok = t_ssb.pbch_decode(tg[0, 2:6, 48:288], convert.config(cfg))
        assert bool(ok)
        np.testing.assert_array_equal(
            t_ssb.pbch_extract_mib(a, convert.config(cfg)), mib)


def _serve(serve, box, **kw):
    """serve_phy in a thread; what ended it goes to ``box["error"]``."""
    ready = threading.Event()

    def run():
        try:
            serve(ready_cb=lambda p: (box.update(port=p), ready.set()), **kw)
        except Exception as e:          # the JAX server's exit, shown below
            box["error"] = e
            ready.set()

    srv = threading.Thread(target=run, daemon=True)
    srv.start()
    assert ready.wait(30.0)
    return srv


def _drive(serve, slots, **kw):
    """The JAX FapiClient sends each (dl, tx) with want_samples; returns
    the replies (samples or an ErrorIndication; ConnectionError where the
    server went away) and the box of the server's thread."""
    box = {}
    srv = _serve(serve, box, **kw)
    cli = j_tr.FapiClient("127.0.0.1", box["port"], timeout=120.0)
    cli.configure(CELL)
    out = []
    for dl, tx in slots:
        try:
            out.append(cli.dl_tti(dl, tx, want_samples=True))
        except ConnectionError as e:
            out.append(e)
            break
    if not isinstance(out[-1], ConnectionError):
        cli.stop()
    srv.join(60.0)
    assert not srv.is_alive()
    return out, box


@pytest.mark.parametrize("kind", ["E", "F", "F_prg"])
def test_alloc_dl_tti_through_both_servers(kind):
    """Repair: a type 0 or interleaved-VRB dl_tti (with and without
    per-PRG precoding), sent by the JAX FapiClient, is served by the port's
    serve_phy (it raised NotImplementedError and ended the server) with the
    JAX serve_phy's samples, within 1e-4 of max|ref|."""
    dl, tx, _, _ = _slot(kind, 2, np.random.default_rng(7))
    (want,), jbox = _drive(j_tr.serve_phy, [(dl, tx)])
    (got,), tbox = _drive(t_tr.serve_phy, [(dl, tx)], device="cpu")
    assert "error" not in jbox and "error" not in tbox
    _close(got, want, 1e-4)


def test_rejected_slot_ends_jax_server_not_port():
    """Repair: a type 0 PDSCH with PT-RS fails both validators.  The JAX
    serve_phy lets the ValidationError end it (the client's next read
    finds the socket closed); the port's answers an error_indication with
    MSG_SLOT_ERR and the validator's message, then serves slot A with the
    samples a server that never saw the rejected slot gives."""
    rng = np.random.default_rng(5)
    g_dl, g_tx, _, _ = _slot("G", 2, rng)
    a_dl, a_tx, _, _ = _slot("A", 4, rng)
    jout, jbox = _drive(j_tr.serve_phy, [(g_dl, g_tx), (a_dl, a_tx)])
    assert isinstance(jbox["error"], JValidationError)
    assert len(jout) == 1 and isinstance(jout[0], ConnectionError)
    tout, tbox = _drive(t_tr.serve_phy, [(g_dl, g_tx), (a_dl, a_tx)],
                        device="cpu")
    assert "error" not in tbox
    err, samples = tout
    assert isinstance(err, j_cm.ErrorIndication)
    assert err.error_code is j_cm.ErrorCode.MSG_SLOT_ERR
    assert (err.message_id, err.sfn, err.slot) == (
        "dl_tti", g_dl.slot.sfn, g_dl.slot.slot_index)
    assert str(jbox["error"]) == err.detail
    (want,), _ = _drive(j_tr.serve_phy, [(a_dl, a_tx)])
    _close(samples, want, 1e-4)


def test_rejected_ul_tti_answered_and_next_served():
    """The port's server answers a ul_tti that fails validation with
    MSG_SLOT_ERR (message id "ul_tti", as FapiClient matches it) and goes
    on: the next slot's dl_tti is served."""
    from srsran_tpu.fapi.messages import UlTtiRequest
    from srsran_tpu.phy.upper.pusch import PuschConfig
    rng = np.random.default_rng(6)
    a_dl, a_tx, _, _ = _slot("A", 4, rng)
    box = {}
    srv = _serve(t_tr.serve_phy, box, device="cpu")
    cli = j_tr.FapiClient("127.0.0.1", box["port"], timeout=120.0)
    cli.configure(CELL)
    bad = UlTtiRequest(slot=SlotPoint(1, 2), pusch=(PuschConfig(
        rnti=1, rb_start=40, rb_count=20, first_symbol=0, nof_symbols=14,
        modulation="qpsk", target_code_rate=0.5, tbs=1000),))
    cli.rx_samples(np.zeros((2, CELL.slot_samples(0)), np.complex64))
    err = cli.ul_tti(bad)
    samples = cli.dl_tti(a_dl, a_tx, want_samples=True)
    cli.stop()
    srv.join(60.0)
    assert "error" not in box and not srv.is_alive()
    assert isinstance(err, j_cm.ErrorIndication)
    assert (err.error_code, err.message_id) == (j_cm.ErrorCode.MSG_SLOT_ERR,
                                                "ul_tti")
    assert isinstance(samples, np.ndarray) and samples.shape[0] == 2


# ------------------------------------------------ the flagship slots (slow)

@pytest.mark.slow
@pytest.mark.parametrize("kind", ["E", "F"])
def test_flagship_alloc_slots_match_jax(kind):
    """flagship.py's DU-low slots E (SSB, five DCIs, the type 0 PDSCH
    precoded per PRG) and F (interleaved VRBs) through both conductors at
    273 RB: samples within 1e-4 of max|ref|; the port's UE side
    (flagship.du_control_rx) decodes every DCI and the PBCH."""
    from srsran_tpu_torch import flagship
    pay = flagship.du_alloc_payloads(np.random.default_rng(11))
    dl, tx = flagship.du_alloc_request(kind, 2, pay)
    # the JAX package's classes through the wire codec
    jdl, jtx, jcell = (j_tr.decode(t_tr.encode(m))
                       for m in (dl, tx, flagship.CELL))
    assert type(jdl).__module__ == "srsran_tpu.fapi.messages"
    js, _ = j_cond.SlotConductor(jcell).process_dl(jdl, jtx)
    ts, _ = t_cond.SlotConductor(flagship.CELL, device="cpu").process_dl(
        dl, tx, return_grid=False)
    _close(ts, js, 1e-4)
    dcis, pbch = flagship.du_control_rx(ts, dl)
    sent = pay["dci"][:len(dl.pdcch)] if kind == "E" else pay["dci"][-1:]
    for (bits, ok), d in zip(dcis, sent):
        assert bool(ok)
        np.testing.assert_array_equal(bits.numpy(), d)
    for (a, ok), c in zip(pbch, dl.ssb):
        assert bool(ok)
        np.testing.assert_array_equal(t_ssb.pbch_extract_mib(a, c),
                                      pay["mib"])
