"""The port's copies of the JAX package's host plans and tables, pinned to
their originals, and the port's import isolation from JAX and from the JAX
package.

The card's machine has no JAX, and the port imports nothing of the JAX
package, so it carries its own copies of the numpy plan builders, of the
``srsran_tpu.ran`` parameter modules it uses and of their data tables;
every copy must stay equal to its original for several configurations.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_tpu.ops import channel_estimate as j_chest
from srsran_tpu.ops import crc as j_crc
from srsran_tpu.ops import gf2 as j_gf2
from srsran_tpu.ops import gold as j_gold
from srsran_tpu.ops import ldpc_decode as j_dec
from srsran_tpu.ops import ldpc_encode as j_enc
from srsran_tpu.ops import ldpc_graph as j_graph
from srsran_tpu.ops import ldpc_rate_match as j_rm
from srsran_tpu.ops import low_papr as j_papr
from srsran_tpu.ops import modulation as j_mod
from srsran_tpu.ops import ofdm as j_ofdm
from srsran_tpu.ops import polar as j_polar
from srsran_tpu.ops import short_block as j_sb
from srsran_tpu.ops import ulsch_demux as j_dmx
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pdcch as j_pdcch
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper import pusch as j_pusch
from srsran_tpu.phy.upper import ue_tx as j_ue_tx
from srsran_tpu.phy.upper import uci as j_uci_codec
from srsran_tpu.phy.upper import ssb as j_ssb
from srsran_tpu.ran import cyclic_prefix as j_cp
from srsran_tpu.ran import ldpc_params as j_ldpc
from srsran_tpu.ran import polar_params
from srsran_tpu.ran import prach_params as j_prachp
from srsran_tpu.ran import slot_point as j_sp
from srsran_tpu.ran import uci_on_pusch as j_uci
from srsran_tpu.ran.cyclic_prefix import CyclicPrefix

from srsran_tpu_torch.ops import channel_estimate as t_chest
from srsran_tpu_torch.ops import crc as t_crc
from srsran_tpu_torch.ops import gf2 as t_gf2
from srsran_tpu_torch.ops import gold as t_gold
from srsran_tpu_torch.ops import ldpc_decode as t_dec
from srsran_tpu_torch.ops import ldpc_encode as t_enc
from srsran_tpu_torch.ops import ldpc_graph as t_graph
from srsran_tpu_torch.ops import ldpc_rate_match as t_rm
from srsran_tpu_torch.ops import low_papr as t_papr
from srsran_tpu_torch.ops import modulation as t_mod
from srsran_tpu_torch import convert
from srsran_tpu_torch.ops import ofdm as t_ofdm
from srsran_tpu_torch.ops import polar as t_polar
from srsran_tpu_torch.ops import short_block as t_sb
from srsran_tpu_torch.ops import ulsch_demux as t_dmx
from srsran_tpu_torch.phy.upper import dmrs as t_dmrs
from srsran_tpu_torch.phy.upper import pdcch as t_pdcch
from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
from srsran_tpu_torch.phy.upper import pucch as t_pucch
from srsran_tpu_torch.phy.upper import pusch as t_pusch
from srsran_tpu_torch.phy.upper import ue_tx as t_ue_tx
from srsran_tpu_torch.phy.upper import uci as t_uci_codec
from srsran_tpu_torch.phy.upper import ssb as t_ssb
from srsran_tpu_torch.ran import cyclic_prefix as t_cp
from srsran_tpu_torch.ran import ldpc_params as t_ldpc
from srsran_tpu_torch.ran import polar_params as t_polar_params
from srsran_tpu_torch.ran import prach_params as t_prachp
from srsran_tpu_torch.ran import slot_point as t_sp
from srsran_tpu_torch.ran import uci_on_pusch as t_uci

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("bg,z,nrows", [(1, 320, 46), (1, 384, 12),
                                        (2, 64, 42), (2, 15, 7)])
def test_layer_gather_indices(bg, z, nrows):
    a = j_dec._layer_gather_indices(bg, z, nrows)
    b = t_dec._layer_gather_indices(bg, z, nrows)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bg,z,rows,limit", [
    (1, 320, (0, 1, 2, 3), 22), (1, 320, tuple(range(4, 46)), 26),
    (2, 64, (0, 1, 2, 3), 10), (2, 64, tuple(range(4, 42)), 14)])
def test_row_sum_plan(bg, z, rows, limit):
    np.testing.assert_array_equal(j_enc._row_sum_plan(bg, z, rows, limit),
                                  t_enc._row_sum_plan(bg, z, rows, limit))


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
@pytest.mark.parametrize("seg", [(1, 320, 6688, 7040, 21120),
                                 (1, 384, 8441, 8448, 25344),
                                 (2, 64, 600, 640, 3200)])
def test_window_plan(rv, seg):
    bg, z, kp, k, n = seg
    assert j_rm._window_plan(rv, bg, z, kp, k, n) == \
        t_rm._window_plan(rv, bg, z, kp, k, n)


@pytest.mark.parametrize("e_sizes", [(100, 100, 106), (96,), (8, 8, 8, 12, 12)])
def test_group_e_sizes(e_sizes):
    assert j_rm._group_e_sizes(e_sizes) == t_rm._group_e_sizes(e_sizes)


@pytest.mark.parametrize("args", [
    (0, 24, 0, 14, (2, 7, 11), 2), (3, 20, 0, 14, (2, 7, 11), 2),
    (0, 269, 0, 14, (2, 7, 11), 2), (5, 10, 1, 12, (2, 11), 1),
    (0, 24, 2, 10, (2,), 1)])
def test_data_re_plan(args):
    np.testing.assert_array_equal(j_pdsch._data_re_plan(*args),
                                  t_pdsch._data_re_plan(*args))


@pytest.mark.parametrize("g,c,qm,nl", [(41472, 4, 6, 2), (426096, 37, 6, 2),
                                       (1000, 3, 2, 1), (5000, 7, 4, 2)])
def test_cb_rate_match_sizes(g, c, qm, nl):
    assert j_pdsch._cb_rate_match_sizes(g, c, qm, nl) == \
        t_pdsch._cb_rate_match_sizes(g, c, qm, nl)


@pytest.mark.parametrize("rb_start,rb_count,delta", [(0, 24, 0), (3, 20, 1),
                                                     (0, 269, 0)])
def test_type1_sc_indices(rb_start, rb_count, delta):
    np.testing.assert_array_equal(
        j_dmrs._type1_sc_indices(rb_start, rb_count, delta),
        t_dmrs._type1_sc_indices(rb_start, rb_count, delta))


def _pilot_scs(rb_count, pairs):
    scs = 2 * np.arange(6 * rb_count)
    if pairs:
        scs = (scs[0::2] + scs[1::2]) // 2
    return tuple(int(s) for s in scs)


@pytest.mark.parametrize("rb_count,pairs,strategy", [
    (24, True, "filter"), (24, False, "filter"), (3, False, "filter"),
    (1, True, "filter"), (20, False, "mean"), (8, False, "none")])
def test_smooth_interp_matrix(rb_count, pairs, strategy):
    key = _pilot_scs(rb_count, pairs)
    stride = 4 if pairs else 2
    np.testing.assert_array_equal(
        j_chest._smooth_interp_matrix(key, 12 * rb_count, strategy, stride),
        t_chest._smooth_interp_matrix(key, 12 * rb_count, strategy, stride))


@pytest.mark.parametrize("dmrs,nsym", [((2, 7, 11), 14), ((2, 11), 14),
                                       ((3,), 14), ((2, 3, 8, 9), 14)])
def test_td_weights(dmrs, nsym):
    for x, y in zip(j_chest._td_weights(dmrs, nsym),
                    t_chest._td_weights(dmrs, nsym)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("stride", [2, 4, 1])
def test_rc_filter(stride):
    np.testing.assert_array_equal(j_chest._rc_filter(stride=stride),
                                  t_chest._rc_filter(stride=stride))


@pytest.mark.parametrize("kw,sif", [
    (dict(rb_start=0, rb_count=24, symbols=(2, 7, 11), ports=(0, 1),
          scrambling_id=0), 0),
    (dict(rb_start=0, rb_count=24, symbols=(2, 7, 11), ports=(0, 1),
          scrambling_id=0), 7),
    (dict(rb_start=3, rb_count=20, symbols=(2,), ports=(0,),
          scrambling_id=5, n_scid=1, slot_in_frame=13), None),
    (dict(rb_start=0, rb_count=269, symbols=(2, 7, 11), ports=(0, 1),
          scrambling_id=1, amplitude=1.5), 18)])
def test_pilot_values_for(kw, sif):
    a = j_dmrs.pilot_values_for(j_dmrs.DmrsConfig(**kw), sif)
    b = t_dmrs.pilot_values_for(t_dmrs.DmrsConfig(**kw), sif)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j_dmrs.c_inits_for(j_dmrs.DmrsConfig(**kw), sif),
                                  t_dmrs.c_inits_for(t_dmrs.DmrsConfig(**kw), sif))


@pytest.mark.parametrize("poly,nbits", [("crc24A", 26656), ("crc24B", 6688),
                                        ("crc16", 300), ("crc11", 40),
                                        ("crc6", 20), ("crc24C", 64)])
def test_remainder_matrix(poly, nbits):
    np.testing.assert_array_equal(j_crc._remainder_matrix(poly, nbits),
                                  t_crc._remainder_matrix(poly, nbits))


@pytest.mark.parametrize("c_init,length,advance", [
    (0, 100, 0), (1, 31, 0), ((0x17 << 15) + 1, 41472, 0),
    (12345678, 3228, 0), (2 ** 31 - 1, 577, 1234), (987654, 96, 36)])
def test_gold_sequence_np(c_init, length, advance):
    np.testing.assert_array_equal(
        j_gold.gold_sequence_np(c_init, length, advance),
        t_gold.gold_sequence_np(c_init, length, advance))


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_pam_levels(order):
    for x, y in zip(j_mod._pam_levels(order), t_mod._pam_levels(order)):
        np.testing.assert_array_equal(x, y)


def test_qpsk_np():
    bits = np.random.default_rng(3).integers(0, 2, 64)
    np.testing.assert_array_equal(j_mod.qpsk_np(bits), t_mod.qpsk_np(bits))


OFDM_CASES = [(CyclicPrefix.NORMAL, 1, 512, 0), (CyclicPrefix.NORMAL, 1, 512, 1),
              (CyclicPrefix.NORMAL, 0, 256, 0), (CyclicPrefix.NORMAL, 1, 4096, 0),
              (CyclicPrefix.EXTENDED, 2, 512, 0)]


@pytest.mark.parametrize("cp,mu,n,sis", OFDM_CASES)
def test_cp_insert_plan(cp, mu, n, sis):
    np.testing.assert_array_equal(j_ofdm._cp_insert_plan(cp, mu, n, sis),
                                  t_ofdm._cp_insert_plan(convert.value(cp), mu, n, sis))


@pytest.mark.parametrize("cp,mu,n,sis", OFDM_CASES)
@pytest.mark.parametrize("offset", [0, 8])
def test_window_plan_rx(cp, mu, n, sis, offset):
    np.testing.assert_array_equal(
        j_ofdm._window_plan_rx(cp, mu, n, sis, offset),
        t_ofdm._window_plan_rx(convert.value(cp), mu, n, sis, offset))


@pytest.mark.parametrize("cp,mu,n,sis", OFDM_CASES)
@pytest.mark.parametrize("fc", [0.0, 3.5e9, 1.8e9 + 7.5e3])
def test_phase_compensation(cp, mu, n, sis, fc):
    np.testing.assert_array_equal(
        j_ofdm.phase_compensation(cp, mu, n, sis, fc),
        t_ofdm.phase_compensation(convert.value(cp), mu, n, sis, fc))


# ------------------------------------------------------------ polar, PDCCH

@pytest.mark.parametrize("k,e,ibil", [(84, 864, False), (56, 864, False),
                                      (44, 108, False), (100, 1728, False),
                                      (40, 300, True), (30, 60, False)])
def test_polar_encode_matrix(k, e, ibil):
    code = polar_params.polar_code(k, e, nmax=9 if not ibil else 10, ibil=ibil)
    np.testing.assert_array_equal(j_polar.encode_matrix(code),
                                  t_polar.encode_matrix(code))
    np.testing.assert_array_equal(j_polar._rm_plan(code.big_n, e, code.mode),
                                  t_polar._rm_plan(code.big_n, e, code.mode))
    np.testing.assert_array_equal(j_polar._triangle_perm(e),
                                  t_polar._triangle_perm(e))


@pytest.mark.parametrize("args", [(60, 864, 0x4601, 0, 1),
                                  (41, 108, 0xFFFF, 0x4601, 1007),
                                  (12, 216, 1, 7, 0), (140, 1728, 0x1234, 0, 3)])
def test_fused_dci_maps(args):
    for x, y in zip(j_pdcch._fused_dci_maps(*args),
                    t_pdcch._fused_dci_maps(*args)):
        np.testing.assert_array_equal(x, y)


CORESETS = [
    dict(rb_start=0, nof_rb=48, start_symbol=0, duration=1),
    dict(rb_start=6, nof_rb=96, start_symbol=1, duration=2),
    dict(rb_start=12, nof_rb=36, start_symbol=0, duration=3),
    dict(rb_start=0, nof_rb=48, start_symbol=0, duration=1, interleaved=True,
         reg_bundle_size=2, interleaver_size=6, shift_index=5),
    dict(rb_start=6, nof_rb=96, start_symbol=1, duration=2, interleaved=True,
         reg_bundle_size=6, interleaver_size=2, shift_index=1),
    dict(rb_start=0, nof_rb=24, start_symbol=0, duration=3, interleaved=True,
         reg_bundle_size=3, interleaver_size=3, shift_index=7),
]


@pytest.mark.parametrize("kw", CORESETS)
def test_bundle_map(kw):
    np.testing.assert_array_equal(
        j_pdcch._bundle_map(j_pdcch.CoresetConfig(**kw)),
        t_pdcch._bundle_map(t_pdcch.CoresetConfig(**kw)))


@pytest.mark.parametrize("al,cce", [(1, 3), (4, 4), (8, 0)])
@pytest.mark.parametrize("kw", CORESETS)
def test_candidate_re_plan(kw, al, cce):
    a = (j_pdcch.CoresetConfig(**kw), cce, al)
    b = (t_pdcch.CoresetConfig(**kw), cce, al)
    for x, y in zip(j_pdcch._candidate_re_plan(*a),
                    t_pdcch._candidate_re_plan(*b)):
        np.testing.assert_array_equal(x, y)
    pa, pb = j_pdcch._patch_plan(*a), t_pdcch._patch_plan(*b)
    np.testing.assert_array_equal(pa[0], pb[0])
    assert pa[1:] == pb[1:]


@pytest.mark.parametrize("sif", [None, 0, 11, 19])
@pytest.mark.parametrize("kw,al,cce", [(CORESETS[0], 8, 0),
                                       (CORESETS[1], 4, 8),
                                       (CORESETS[4], 16, 16),
                                       (CORESETS[5], 2, 6)])
def test_pdcch_dmrs_values_for(kw, al, cce, sif):
    cfg = j_pdcch.PdcchConfig(coreset=j_pdcch.CoresetConfig(**kw), rnti=0x4601,
                              aggregation_level=al, cce_index=cce,
                              payload_bits=60, n_id=3, slot_in_frame=7)
    np.testing.assert_array_equal(
        j_pdcch.dmrs_values_for(cfg, sif),
        t_pdcch.dmrs_values_for(convert.config(cfg), sif))
    np.testing.assert_array_equal(
        j_pdcch.dmrs_cinits_for(cfg, sif),
        t_pdcch.dmrs_cinits_for(convert.config(cfg), sif))


# --------------------------------------------------------------------- SSB

SSBS = [
    dict(phys_cell_id=1, ssb_idx=0, l_max=8, sfn=0, first_symbol=2,
         first_subcarrier=48),
    dict(phys_cell_id=503, ssb_idx=3, l_max=4, hrf=True, sfn=17, k_ssb=16,
         beta_pss_db=3.0),
    dict(phys_cell_id=77, ssb_idx=37, l_max=64, sfn=1023),
    dict(phys_cell_id=1006, ssb_idx=7, l_max=8, hrf=True, sfn=514, k_ssb=23),
]


@pytest.mark.parametrize("args", [(0, False, 0, 8, 0), (17, True, 3, 4, 16),
                                  (1023, False, 37, 64, 0),
                                  (514, True, 7, 8, 23)])
def test_payload_maps(args):
    for x, y in zip(j_ssb._payload_maps(*args), t_ssb._payload_maps(*args)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("pci,sfn,l_max", [(1, 0, 8), (503, 17, 4),
                                           (77, 1023, 64), (1006, 6, 8)])
def test_scramble_mask(pci, sfn, l_max):
    np.testing.assert_array_equal(j_ssb._scramble_mask(pci, sfn, l_max),
                                  t_ssb._scramble_mask(pci, sfn, l_max))


@pytest.mark.parametrize("kw", SSBS)
def test_ssb_slot_ctx_for(kw):
    cfg = j_ssb.SsbConfig(**kw)
    for sfn, hrf in ((None, None), (kw.get("sfn", 0) + 3, True), (2, False)):
        for x, y in zip(j_ssb.slot_ctx_for(cfg, sfn, hrf),
                        t_ssb.slot_ctx_for(convert.config(cfg), sfn, hrf)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", SSBS)
def test_fused_pbch_maps(kw):
    cfg = j_ssb.SsbConfig(**kw)
    for x, y in zip(j_ssb._fused_pbch_maps(cfg),
                    t_ssb._fused_pbch_maps(convert.config(cfg))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", SSBS)
def test_ssb_base_patch(kw):
    cfg = j_ssb.SsbConfig(**kw)
    for x, y in zip(j_ssb._ssb_base_patch(cfg),
                    t_ssb._ssb_base_patch(convert.config(cfg))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_id2", [0, 1, 2])
def test_pss_sss_sequences(n_id2):
    np.testing.assert_array_equal(j_ssb.pss_sequence(n_id2),
                                  t_ssb.pss_sequence(n_id2))
    for n_id1 in (0, 111, 335):
        np.testing.assert_array_equal(j_ssb.sss_sequence(n_id1, n_id2),
                                      t_ssb.sss_sequence(n_id1, n_id2))


# ------------------------------------------- the port's copies of ran/ops

@pytest.mark.parametrize("rate", [0.1, 0.3, 0.67, 0.7, 0.95])
@pytest.mark.parametrize("tbs", [24, 200, 296, 3816, 8424, 26632, 311400,
                                 835584, 1277992])
def test_segment_tb_copy(tbs, rate):
    bg = j_ldpc.select_base_graph(tbs, rate)
    assert t_ldpc.select_base_graph(tbs, rate) == bg
    assert dataclasses.asdict(t_ldpc.segment_tb(tbs, bg)) == \
        dataclasses.asdict(j_ldpc.segment_tb(tbs, bg))
    z = j_ldpc.segment_tb(tbs, bg).lifting_size
    for rv in range(4):
        assert t_ldpc.rate_match_k0(bg, rv, 66 * z, z) == \
            j_ldpc.rate_match_k0(bg, rv, 66 * z, z)


@pytest.mark.parametrize("k,e,nmax,ibil", [
    (84, 864, 9, False), (56, 864, 9, False), (12, 60, 10, True),
    (19, 120, 10, True), (40, 300, 10, True), (164, 432, 9, False)])
def test_polar_code_copy(k, e, nmax, ibil):
    a = polar_params.polar_code(k, e, nmax=nmax, ibil=ibil)
    b = t_polar_params.polar_code(k, e, nmax=nmax, ibil=ibil)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("cp", ["NORMAL", "EXTENDED"])
@pytest.mark.parametrize("mu,n,sis", [(0, 2048, 0), (1, 4096, 0),
                                      (1, 512, 1), (2, 1024, 3), (3, 256, 5)])
def test_cp_lengths_copy(cp, mu, n, sis):
    a, b = j_cp.CyclicPrefix[cp], t_cp.CyclicPrefix[cp]
    assert a.value == b.value
    np.testing.assert_array_equal(j_cp.cp_lengths(a, mu, n, sis),
                                  t_cp.cp_lengths(b, mu, n, sis))
    assert j_cp.slot_num_samples(a, mu, n, sis) == \
        t_cp.slot_num_samples(b, mu, n, sis)
    assert j_cp.symbols_per_slot(a) == t_cp.symbols_per_slot(b)


@pytest.mark.parametrize("bg,z", [(1, 384), (1, 320), (1, 2), (2, 64),
                                  (2, 15), (2, 384)])
def test_ldpc_graph_copy(bg, z):
    a, b = j_graph.get_graph(bg, z), t_graph.get_graph(bg, z)
    assert (a.base_graph, a.z, a.nof_rows, a.nof_cols, a.nof_info_cols) == \
        (b.base_graph, b.z, b.nof_rows, b.nof_cols, b.nof_info_cols)
    assert a.rows == b.rows
    bits = np.random.default_rng(z).integers(0, 2, a.nof_cols * z,
                                             dtype=np.uint8)
    np.testing.assert_array_equal(j_graph.parity_check_np(a, bits),
                                  t_graph.parity_check_np(b, bits))


def test_gf2_copy():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2, (9, 13)).astype(np.uint8)
    b = rng.integers(0, 2, (13, 7)).astype(np.uint8)
    np.testing.assert_array_equal(j_gf2.gf2_matmul(a, b), t_gf2.gf2_matmul(a, b))
    sq = rng.integers(0, 2, (11, 11)).astype(np.uint8)
    np.testing.assert_array_equal(j_gf2.gf2_matpow(sq, 37),
                                  t_gf2.gf2_matpow(sq, 37))


@pytest.mark.parametrize("m_sc", [6, 12, 18, 24, 36, 48, 1614])
def test_base_sequence_copy(m_sc):
    for u in (0, 1, 7, 29):
        for v in ((0, 1) if m_sc >= 72 else (0,)):
            np.testing.assert_array_equal(j_papr.base_sequence(u, v, m_sc),
                                          t_papr.base_sequence(u, v, m_sc))
    assert j_papr._largest_prime_below(m_sc) == \
        t_papr._largest_prime_below(m_sc)


@pytest.mark.parametrize("restricted", ["unrestricted", "type_a", "type_b"])
@pytest.mark.parametrize("scs", [1250, 5000])
def test_prach_params_copy(scs, restricted):
    for zcz in range(16):
        try:
            ncs = j_prachp.n_cs(zcz, scs, restricted)
        except AssertionError:              # a reserved entry
            with pytest.raises(AssertionError):
                t_prachp.n_cs(zcz, scs, restricted)
            continue
        assert t_prachp.n_cs(zcz, scs, restricted) == ncs
        for u in (1, 25, 129, 400, 838):
            try:
                want = j_prachp.restricted_cyclic_shifts(u, ncs, 839,
                                                         restricted)
            except NotImplementedError:
                with pytest.raises(NotImplementedError):
                    t_prachp.restricted_cyclic_shifts(u, ncs, 839, restricted)
                continue
            assert t_prachp.restricted_cyclic_shifts(
                u, ncs, 839, restricted) == want


def test_prach_roots_and_sequences_copy():
    for i in (0, 1, 39, 137, 500, 837, 900):
        for long_format in (True, False):
            assert t_prachp.root_sequence_number(i, long_format) == \
                j_prachp.root_sequence_number(i, long_format)
    for zcz in range(16):
        assert t_prachp.n_cs(zcz, 30_000) == j_prachp.n_cs(zcz, 30_000)
    for u, l_ra, cs in ((1, 839, 0), (129, 839, 76), (25, 139, 19),
                        (138, 139, 0)):
        np.testing.assert_array_equal(t_prachp.zc_sequence(u, l_ra, cs),
                                      j_prachp.zc_sequence(u, l_ra, cs))
    assert t_prachp.PRACH_CP_KAPPA == j_prachp.PRACH_CP_KAPPA
    assert t_prachp.LONG_FORMATS == j_prachp.LONG_FORMATS


def test_uci_on_pusch_config_copy():
    assert dataclasses.asdict(t_uci.UciOnPuschConfig()) == \
        dataclasses.asdict(j_uci.UciOnPuschConfig())
    assert [f.name for f in dataclasses.fields(t_uci.UciOnPuschConfig)] == \
        [f.name for f in dataclasses.fields(j_uci.UciOnPuschConfig)]


@pytest.mark.parametrize("mu,count", [(0, 0), (1, 6), (1, 20479), (2, 999),
                                      (4, 163839), (1, -3), (3, 81920)])
def test_slot_point_copy(mu, count):
    a, b = j_sp.SlotPoint(mu, count), t_sp.SlotPoint(mu, count)
    for name in ("count", "sfn", "slot_index", "subframe_index",
                 "subframe_slot_index", "scs_hz"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.slot_duration_s() == b.slot_duration_s()
    for n in (1, 7, 20480, 10 ** 6):
        assert (a + n).count == (b + n).count
        assert (a - n).count == (b - n).count
        assert (a + n) - a == (b + n) - b
        assert (a < a + n) == (b < b + n)
    assert j_sp.SlotPoint.from_sfn_slot(mu, 513, 3).count == \
        t_sp.SlotPoint.from_sfn_slot(mu, 513, 3).count


@pytest.mark.parametrize("k,e,qm", [(1, 12, 1), (1, 32, 2), (2, 18, 1),
                                    (2, 32, 2), (3, 32, 2), (7, 40, 1),
                                    (11, 64, 2)])
def test_short_block_tables_copy(k, e, qm):
    np.testing.assert_array_equal(t_sb.rm_basis(), j_sb.rm_basis())
    np.testing.assert_array_equal(t_sb._candidates(k, e, qm),
                                  j_sb._candidates(k, e, qm))


def test_f0_tables_copy():
    assert t_pucch._F0_TABLES == j_pucch._F0_TABLES


@pytest.mark.parametrize("key", sorted(j_pucch._F0_TABLES))
@pytest.mark.parametrize("slot", [0, 7, 19])
def test_f0_refs_for_copy(key, slot):
    kw = dict(prb=269, start_symbol=11, nof_symbols=2, initial_cyclic_shift=4,
              n_id=55, nof_harq_bits=key[0], sr_opportunity=key[1])
    np.testing.assert_array_equal(
        t_pucch.f0_refs_for(t_pucch.PucchF0Config(**kw), slot),
        j_pucch.f0_refs_for(j_pucch.PucchF0Config(**kw), slot))


@pytest.mark.parametrize("kw", [
    dict(rb_start=270, nof_rb=1, start_symbol=11, nof_symbols=2),
    dict(rb_start=3, nof_rb=16, start_symbol=0, nof_symbols=1),
    dict(rb_start=100, nof_rb=4, start_symbol=12, nof_symbols=2)])
@pytest.mark.parametrize("slot", [0, 13])
def test_f2_pilot_values_for_copy(kw, slot):
    kw = dict(kw, rnti=0x19, n_id=3, n_id0=7, nof_uci_bits=22)
    a, b = j_pucch.PucchF2Config(**kw), t_pucch.PucchF2Config(**kw)
    np.testing.assert_array_equal(t_pucch.f2_dmrs_cinits(b, slot),
                                  j_pucch.f2_dmrs_cinits(a, slot))
    np.testing.assert_array_equal(t_pucch.f2_pilot_values_for(b, slot),
                                  j_pucch.f2_pilot_values_for(a, slot))


def _same_code(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("k,e", [(12, 32), (14, 64), (19, 80), (20, 64),
                                 (22, 64), (40, 512), (100, 1000)])
def test_uci_polar_cfg_copy(k, e):
    """The F2 and the UCI codec's polar parameters (their PC-bit rules
    differ) equal the JAX package's."""
    for t_fn, j_fn in ((t_pucch._f2_polar_cfg, j_pucch._f2_polar_cfg),
                       (t_uci_codec._polar_cfg, j_uci_codec._polar_cfg)):
        (tc, tl), (jc, jl) = t_fn(k, e), j_fn(k, e)
        assert tl == jl
        _same_code(jc, tc)


def test_validators_copy():
    """tx_data and ul_dci validation raise where the JAX package's do."""
    from srsran_tpu.fapi import messages as jm
    from srsran_tpu.fapi import validators as jv
    from srsran_tpu.phy.slot_programs import CellConfig
    from srsran_tpu_torch.fapi import messages as tm
    from srsran_tpu_torch.fapi import validators as tv
    cell = CellConfig(nof_ports=2, nof_rb=24, dft_size=512, numerology=1)
    pdcch = j_pdcch.PdcchConfig(
        coreset=j_pdcch.CoresetConfig(rb_start=0, nof_rb=24, start_symbol=0,
                                      duration=1),
        rnti=1, aggregation_level=2, cce_index=0, payload_bits=40, n_id=1,
        n_id_data=1)
    pdsch = j_pdsch.PdschConfig(rnti=1, rb_start=0, rb_count=8,
                                first_symbol=1, nof_symbols=12,
                                modulation="qpsk", target_code_rate=0.5,
                                tbs=1000, dmrs_symbols=(2,))
    slot = j_sp.SlotPoint(1, 4)
    dl = jm.DlTtiRequest(slot=slot, pdcch=(pdcch,), pdsch=(pdsch,))
    cases = [
        (jv.validate_tx_data, jm.TxDataRequest(
            slot=slot, pdsch_payloads=(np.zeros(1000),),
            pdcch_payloads=(np.zeros(40),)), dl),
        (jv.validate_tx_data, jm.TxDataRequest(
            slot=slot, pdsch_payloads=(np.zeros(999),),
            pdcch_payloads=(np.zeros(40),)), dl),
        (jv.validate_tx_data, jm.TxDataRequest(
            slot=slot, pdsch_payloads=(np.zeros(1000),)), dl),
        (jv.validate_ul_dci, jm.UlDciRequest(
            slot=slot, pdcch=(pdcch,), payloads=(np.zeros(40),)), cell),
        (jv.validate_ul_dci, jm.UlDciRequest(
            slot=slot, pdcch=(pdcch,), payloads=()), cell),
        (jv.validate_ul_dci, jm.UlDciRequest(
            slot=slot, pdcch=(dataclasses.replace(pdcch, cce_index=5),),
            payloads=(np.zeros(40),)), cell),
    ]
    outcomes = []
    for fn, msg, other in cases:
        t_fn = getattr(tv, fn.__name__)
        t_other = convert.requests(other) if isinstance(
            other, jm.DlTtiRequest) else convert.config(other)
        try:
            fn(msg, other)
            want = None
        except jv.ValidationError:
            want = "raised"
        try:
            t_fn(convert.requests(msg), t_other)
            got = None
        except tv.ValidationError:
            got = "raised"
        assert got == want, fn.__name__
        outcomes.append(want)
    assert outcomes.count("raised") == 4
    assert issubclass(tv.ValidationError, ValueError)
    assert tm.SlotResults.__name__ == jm.SlotResults.__name__


def test_data_tables_are_copies():
    """The port's data/ tables are byte-equal to the JAX package's."""
    port = REPO / "srsran_tpu_torch" / "data"
    names = sorted(f.name for f in port.iterdir())
    assert names == ["ldpc_bg_tables.npz", "low_papr_tables.npz",
                     "polar_tables.npz", "prach_tables.npz",
                     "prach_thresholds.json", "short_block_tables.npz"]
    for name in names:
        assert (port / name).read_bytes() == \
            (REPO / "srsran_tpu" / "data" / name).read_bytes(), name


# ------------------------------------------- UL-SCH / UCI demux plans

DEMUX_GRID = [(layers, o_ack, csi, dmrs)
              for layers in (1, 2, 3, 4) for o_ack in (0, 1, 2, 4, 11)
              for csi in ((0, 0), (6, 0), (6, 20))
              for dmrs in ((2,), (2, 11), (2, 7, 11))]


def _uci_pusch_pair(mod, layers, o_ack, o_csi1, o_csi2, dmrs, rb_count=4):
    jc = j_pusch.PuschConfig(
        rnti=0x31, rb_start=0, rb_count=rb_count, first_symbol=0,
        nof_symbols=14, modulation=mod, target_code_rate=0.5, tbs=1000,
        nof_layers=layers, n_id=3, dmrs_symbols=dmrs,
        uci=j_uci.UciOnPuschConfig(o_ack=o_ack, o_csi1=o_csi1,
                                   o_csi2=o_csi2))
    return jc, convert.config(jc)


@pytest.mark.parametrize("mod", ["qpsk", "qam16", "qam64", "qam256"])
def test_ulsch_demux_copy(mod):
    """ops/ulsch_demux.py and pusch.demux_plan against the originals over
    layers 1-4, O_ack 0/1/2/4/11, CSI1 and CSI2 on and off and 1-3 DM-RS
    symbols: the plan, the class map, the field positions, the placeholder
    classes, the UE's multiplexer and its placeholder scrambling."""
    rng = np.random.default_rng(len(mod))
    for layers, o_ack, (o_csi1, o_csi2), dmrs in DEMUX_GRID:
        jc, tc = _uci_pusch_pair(mod, layers, o_ack, o_csi1, o_csi2, dmrs)
        jd, td = j_pusch.demux_plan(jc), t_pusch.demux_plan(tc)
        if jd is None:
            assert td is None and not (o_ack or o_csi1)
            continue
        assert type(td) is t_dmx.DemuxConfig
        assert dataclasses.asdict(td) == dataclasses.asdict(jd)
        np.testing.assert_array_equal(t_dmx.build_class_map(td),
                                      j_dmx.build_class_map(jd))
        jf, tf = j_dmx.field_positions(jd), t_dmx.field_positions(td)
        assert sorted(jf) == sorted(tf)
        for name in jf:
            np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
        cls = j_dmx.placeholder_bit_classes(jd, o_ack, o_csi1)
        np.testing.assert_array_equal(
            t_dmx.placeholder_bit_classes(td, o_ack, o_csi1), cls)
        bpre = jd.qm * layers
        ack_pos = jf["ack_punct"] if len(jf["ack_punct"]) else jf["ack"]
        coded = [rng.integers(0, 2, len(p) * bpre).astype(np.int8)
                 for p in (jf["data"], ack_pos, jf["csi1"], jf["csi2"])]
        cw = j_dmx.mux_codeword(jd, *coded)
        np.testing.assert_array_equal(t_dmx.mux_codeword(td, *coded), cw)
        seq = rng.integers(0, 2, cw.shape[0]).astype(np.int8)
        np.testing.assert_array_equal(
            t_dmx.scramble_with_placeholders(cw, seq, cls),
            j_dmx.scramble_with_placeholders(cw, seq, cls))


@pytest.mark.parametrize("mod,o_ack,o_csi1,o_csi2", [
    ("qam16", 0, 0, 0), ("qam16", 4, 7, 0), ("qpsk", 1, 0, 0),
    ("qam64", 2, 2, 0), ("qam16", 4, 8, 12), ("qam16", 0, 4, 7)])
def test_pusch_transmit_copy(mod, o_ack, o_csi1, o_csi2):
    """ue_tx.pusch_transmit's grid equals the JAX UE's: the data rate-matched
    around the UCI fields, the UCI codes, the placeholder scrambling and the
    DM-RS (without UCI, the DL chain's codeword)."""
    jc, tc = _uci_pusch_pair(mod, 1, o_ack, o_csi1, o_csi2, (2, 7, 11),
                             rb_count=12)
    jc = dataclasses.replace(jc, rb_start=2, slot_in_frame=5, tbs=2152)
    tc = convert.config(jc)
    rng = np.random.default_rng(o_ack + 3 * o_csi1 + o_csi2)
    payload = rng.integers(0, 2, jc.tbs).astype(np.int8)
    bits = [rng.integers(0, 2, n).astype(np.int8) if n else None
            for n in (o_ack, o_csi1, o_csi2)]
    want = j_ue_tx.pusch_transmit(jc, payload, *bits, nof_sc=200)
    got = t_ue_tx.pusch_transmit(tc, payload, *bits, nof_sc=200,
                                 device="cpu")
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["srsran_tpu"] = None     # and so does any import of the JAX package
import srsran_tpu_torch
names = ["srsran_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    srsran_tpu_torch.__path__, "srsran_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules if m in ("jax", "srsran_tpu")
                or m.startswith(("jax.", "jaxlib", "srsran_tpu.")))
assert not [m for m in loaded if sys.modules[m] is not None], loaded
print(" ".join(names))
"""


def test_port_imports_without_jax():
    """Every port module and chip_smoke import with JAX and the JAX package
    blocked."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 25
    assert {"srsran_tpu_torch.ops.polar", "srsran_tpu_torch.ops.dl_map",
            "srsran_tpu_torch.ops.short_block",
            "srsran_tpu_torch.fapi.conductor",
            "srsran_tpu_torch.fapi.messages",
            "srsran_tpu_torch.fapi.validators",
            "srsran_tpu_torch.phy.upper.uci",
            "srsran_tpu_torch.ran.slot_point",
            "srsran_tpu_torch.phy.upper.pdcch",
            "srsran_tpu_torch.phy.upper.ssb",
            "srsran_tpu_torch.phy.upper.prach",
            "srsran_tpu_torch.phy.upper.pucch",
            "srsran_tpu_torch.phy.upper.srs",
            "srsran_tpu_torch.ran.prach_params",
            "srsran_tpu_torch.ops.low_papr",
            "srsran_tpu_torch.ops.ulsch_demux",
            "srsran_tpu_torch.ops.uci_demux",
            "srsran_tpu_torch.ops.ul_demap",
            "srsran_tpu_torch.phy.upper.ue_tx",
            "srsran_tpu_torch.graphs",
            "srsran_tpu_torch.parallel.mesh"} <= names


def _import_lines(path: Path):
    for line in path.read_text().splitlines():
        s = line.strip().split("#")[0]
        if s.startswith(("import ", "from ")):
            yield s


def test_port_sources_never_import_jax():
    """No port source (or chip_smoke.py) names jax, or the JAX package
    (``srsran_tpu``; ``srsran_tpu_torch`` is the port), in an import."""
    files = list((REPO / "srsran_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for s in _import_lines(f):
            assert "jax" not in s, f"{f}: {s}"
            words = s.replace(",", " ").split()
            assert not any(w == "srsran_tpu" or w.startswith("srsran_tpu.")
                           for w in words), f"{f}: {s}"
