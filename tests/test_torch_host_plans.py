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
from srsran_tpu.mac import scheduler as j_sched
from srsran_tpu.mac import test_mode as j_tm
from srsran_tpu.ran import cyclic_prefix as j_cp
from srsran_tpu.ran import csi_report as j_csi
from srsran_tpu.ran import mcs_tbs as j_mcs
from srsran_tpu.ran import precoding_codebooks as j_pcb
from srsran_tpu.ran import tdd as j_tdd
from srsran_tpu.ran import ldpc_params as j_ldpc
from srsran_tpu.ran import polar_params
from srsran_tpu.ran import rb_allocation as j_rba
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
from srsran_tpu_torch.mac import scheduler as t_sched
from srsran_tpu_torch.mac import test_mode as t_tm
from srsran_tpu_torch.ran import csi_report as t_csi
from srsran_tpu_torch.ran import cyclic_prefix as t_cp
from srsran_tpu_torch.ran import mcs_tbs as t_mcs
from srsran_tpu_torch.ran import precoding_codebooks as t_pcb
from srsran_tpu_torch.ran import tdd as t_tdd
from srsran_tpu_torch.utils import config as t_config
from srsran_tpu_torch.ran import ldpc_params as t_ldpc
from srsran_tpu_torch.ran import polar_params as t_polar_params
from srsran_tpu_torch.ran import prach_params as t_prachp
from srsran_tpu_torch.ran import rb_allocation as t_rba
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


@pytest.mark.parametrize("args", [
    (0, 0, (7, 2, 11)), (0, 0, tuple(range(32, 144)) + tuple(range(160, 273))),
    (3, 4, None), (0, 136, None, True, 0, 273, 2), (0, 24, None, True, 0, 52, 4),
    (2, 9, None, True, 0, 25, 2), (0, 7, None, True, 0, 27, 4),
    (4, 8, None, True), (8, 12, None, True, 8, 37, 4)])
def test_rb_allocation_copy(args):
    """ran/rb_allocation.py: type 0 bitmaps, contiguous, interleaved at
    L = 2 and 4 over even and odd BWP sizes, a guessed BWP size and a BWP
    start other than 0."""
    np.testing.assert_array_equal(t_rba.allocated_prbs(*args),
                                  j_rba.allocated_prbs(*args))


@pytest.mark.parametrize("bwp_start,bwp_size,bundle", [
    (0, 273, 2), (0, 273, 4), (0, 51, 2), (4, 25, 4), (2, 3, 2), (0, 1, 2)])
def test_vrb_to_prb_interleaved_copy(bwp_start, bwp_size, bundle):
    assert (t_rba.vrb_to_prb_interleaved(bwp_start, bwp_size, bundle)
            == j_rba.vrb_to_prb_interleaved(bwp_start, bwp_size, bundle))


@pytest.mark.parametrize("bwp_start,bundle", [(1, 2), (2, 4), (0, 3)])
def test_vrb_to_prb_interleaved_rejects_as_jax(bwp_start, bundle):
    """The copy keeps the original's refusals (unaligned BWP starts,
    bundle sizes other than 2 and 4)."""
    with pytest.raises(AssertionError):
        j_rba.vrb_to_prb_interleaved(bwp_start, 24, bundle)
    with pytest.raises(AssertionError):
        t_rba.vrb_to_prb_interleaved(bwp_start, 24, bundle)


@pytest.mark.parametrize("args", [
    (0, 24, 1, 12, (2, 11), 2, None, (1, 4, 5, 9, 13, 20, 21, 22)),
    (0, 24, 1, 12, (2, 11), 1, None, (0, 2, 3, 8, 9, 15, 16, 23)),
    (0, 273, 2, 12, (2, 11), 2, None,
     tuple(range(32, 144)) + tuple(range(160, 273)))])
def test_data_re_plan_prbs(args):
    np.testing.assert_array_equal(j_pdsch._data_re_plan(*args),
                                  t_pdsch._data_re_plan(*args))


@pytest.mark.parametrize("prbs", [range(0, 24), range(3, 23),
                                  (1, 4, 5, 9, 13, 20, 21, 22)])
@pytest.mark.parametrize("group", [0, 1, 2])
def test_dmrs_comb(prbs, group):
    """K26's comb per CDM group (ops/dl_rs.py::_comb) against the JAX
    package's type 1 (``_type1_sc_indices``, groups 0-1) and type 2
    (``type2_sc_indices``, contiguous) subcarriers."""
    from srsran_tpu_torch.ops import dl_rs as t_dl_rs
    if group < 2:
        want = j_dmrs._type1_sc_indices(
            prbs[0], len(prbs), group,
            None if isinstance(prbs, range) else tuple(prbs))
        np.testing.assert_array_equal(t_dl_rs._comb(prbs, group, 1), want)
    if isinstance(prbs, range):
        np.testing.assert_array_equal(
            t_dl_rs._comb(prbs, group, 2),
            j_dmrs.type2_sc_indices(prbs[0], len(prbs), group))


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


def test_prach_config_tables_copy():
    """prach_configuration reads the same entries from the port's copy of
    the PRACH configuration tables (test_data_tables_are_copies holds the
    bytes)."""
    for duplex in ("fr1_unpaired", "fr1_paired"):
        for index in (0, 16, 158, 159, 255):
            assert (t_prachp.prach_configuration(index, duplex)
                    == j_prachp.prach_configuration(index, duplex))


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
                     "polar_tables.npz", "prach_config_tables.json",
                     "prach_tables.npz", "prach_thresholds.json",
                     "short_block_tables.npz"]
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


# ------------------------------------------------------- the cell edge

@pytest.mark.parametrize("n", [12, 24, 72, 180, 3240])
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_mat_copy(n, inverse):
    from srsran_tpu.ops import transform_precode as j_tp
    from srsran_tpu_torch.ops import transform_precode as t_tp
    np.testing.assert_array_equal(t_tp._dft_mat(n, inverse),
                                  j_tp._dft_mat(n, inverse))


def test_f3_symbol_split_copy():
    """_F34_DMRS_POS and the DM-RS / data split of every F3/F4 length."""
    assert t_pucch._F34_DMRS_POS == j_pucch._F34_DMRS_POS
    for nsym in range(4, 15):
        j_cfg = j_pucch.PucchF3Config(rb_start=0, nof_rb=1, start_symbol=0,
                                      nof_symbols=nsym, rnti=1, n_id=1,
                                      n_id_hopping=1, nof_uci_bits=4)
        assert t_pucch._f3_symbol_split(convert.config(j_cfg)) == \
            j_pucch._f3_symbol_split(j_cfg)


@pytest.mark.parametrize("kw", [
    dict(rb_start=4, nof_rb=3, start_symbol=0, nof_symbols=10,
         n_id_hopping=21),
    dict(rb_start=246, nof_rb=2, start_symbol=0, nof_symbols=14,
         n_id_hopping=1),
    dict(rb_start=248, nof_rb=1, start_symbol=2, nof_symbols=12,
         n_id_hopping=1, occ_length=2, occ_index=1),
    dict(rb_start=0, nof_rb=16, start_symbol=3, nof_symbols=4,
         n_id_hopping=1000)])
@pytest.mark.parametrize("slot", [0, 7, 19])
def test_f3_dmrs_values_for_copy(kw, slot):
    j_cfg = j_pucch.PucchF3Config(rnti=0x1a, n_id=1, nof_uci_bits=8, **kw)
    np.testing.assert_array_equal(
        t_pucch.f3_dmrs_values_for(convert.config(j_cfg), slot),
        j_pucch.f3_dmrs_values_for(j_cfg, slot))


HOP_CASES = [dict(dmrs_symbols=(2, 9), second_hop_prb=24),
             dict(dmrs_symbols=(2, 7, 11), second_hop_prb=3),
             dict(first_symbol=2, nof_symbols=11, dmrs_symbols=(2, 8),
                  second_hop_prb=40),
             dict(dmrs_symbols=(2, 9), second_hop_prb=None)]


def _hop_pusch(**kw):
    return j_pusch.PuschConfig(**{
        **dict(rnti=0x21, rb_start=0, rb_count=12, first_symbol=0,
               nof_symbols=14, modulation="qpsk", target_code_rate=0.3,
               tbs=1544, n_id=3), **kw})


@pytest.mark.parametrize("kw", HOP_CASES)
def test_hop_configs_copy(kw):
    j_cfg = _hop_pusch(**kw)
    got = t_pusch.hop_configs(convert.config(j_cfg))
    want = j_pusch.hop_configs(j_cfg)
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(convert.config(w)) for w in want]


@pytest.mark.parametrize("kw", HOP_CASES)
def test_tp_plan(kw):
    """K18's per-RE plan: each hop's data REs as the JAX receiver gathers
    them (its _data_re_plan per hop config), the coefficient column of
    each RE in the hops' side-by-side estimates, the hop of each block."""
    j_cfg = _hop_pusch(transform_precoding=True, **kw)
    key = t_pusch._tp_key(convert.config(j_cfg))
    plan, hops = t_pusch.tp_plan(key, 0), t_pusch.tp_plan(key, 1)
    assert plan.dtype == hops.dtype == np.int32
    m = 12 * j_cfg.rb_count
    rows, cols, blocks = [], [], []
    for h, hc in enumerate(j_pusch.hop_configs(j_cfg)):
        p = j_pdsch._data_re_plan(hc.rb_start, hc.rb_count, hc.first_symbol,
                                  hc.nof_symbols, hc.dmrs_symbols,
                                  hc.reserved_cdm_groups)
        rows.append(p)
        cols.append(p[:, 1] - 12 * hc.rb_start + h * m)
        blocks += [h] * (len(p) // m)
    np.testing.assert_array_equal(plan[:2].T, np.concatenate(rows))
    np.testing.assert_array_equal(plan[2], np.concatenate(cols))
    np.testing.assert_array_equal(hops, blocks)


def test_edge_scenario_tbs():
    """flagship.EDGE's TBS are TS38.214 §5.1.3.2 through the JAX package's
    ran/mcs_tbs.py."""
    from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc
    from srsran_tpu_torch import flagship
    assert flagship.EDGE.pusch_a.tbs == tbs_calc(240, 14, 36, "qam64", 0.7,
                                                 2) == 262376
    assert flagship.EDGE.pusch_c.tbs == tbs_calc(6, 14, 24, "qpsk", 0.3,
                                                 1) == 528


def test_f3_f4_and_tp_validators_copy():
    """UL_TTI.request validation of F3/F4 and transform precoding raises
    where the JAX package's does."""
    from srsran_tpu.fapi import messages as jm
    from srsran_tpu.fapi import validators as jv
    from srsran_tpu.phy.slot_programs import CellConfig
    from srsran_tpu_torch.fapi import validators as tv
    cell = CellConfig(nof_ports=2, nof_rb=52, dft_size=1024, numerology=1)
    f3 = j_pucch.PucchF3Config(rb_start=34, nof_rb=2, start_symbol=0,
                               nof_symbols=14, rnti=0x1a, n_id=1,
                               n_id_hopping=1, nof_uci_bits=22)
    f4 = dataclasses.replace(f3, nof_rb=1, occ_length=2, occ_index=1)
    pusch = j_pusch.PuschConfig(
        rnti=0x19, rb_start=28, rb_count=6, first_symbol=0, nof_symbols=14,
        modulation="qpsk", target_code_rate=0.3, tbs=528, n_id=1,
        dmrs_symbols=(2, 9), transform_precoding=True, second_hop_prb=40)
    slot = j_sp.SlotPoint(1, 4)
    cases = [dict(pucch_f3=(f3,)), dict(pucch_f4=(f4,)),
             dict(pusch=(pusch,)),
             dict(pucch_f3=(dataclasses.replace(f3, nof_rb=7),)),
             dict(pucch_f3=(dataclasses.replace(f3, rb_start=51),)),
             dict(pucch_f3=(dataclasses.replace(f3, occ_length=2),)),
             dict(pucch_f3=(dataclasses.replace(f3, nof_symbols=3),)),
             dict(pucch_f3=(dataclasses.replace(f3, nof_uci_bits=0),)),
             dict(pucch_f4=(dataclasses.replace(f4, nof_rb=2),)),
             dict(pucch_f4=(dataclasses.replace(f4, occ_length=3),)),
             dict(pucch_f4=(dataclasses.replace(f4, occ_index=2),)),
             dict(pusch=(dataclasses.replace(pusch, nof_layers=2),))]
    outcomes = []
    for kw in cases:
        msg = jm.UlTtiRequest(slot=slot, **kw)
        try:
            jv.validate_ul_tti(msg, cell)
            want = None
        except jv.ValidationError:
            want = "raised"
        try:
            tv.validate_ul_tti(convert.requests(msg), convert.config(cell))
            got = None
        except tv.ValidationError:
            got = "raised"
        assert got == want, kw
        outcomes.append(want)
    assert outcomes == [None] * 3 + ["raised"] * 9


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["srsran_tpu"] = None     # and so does any import of the JAX package
sys.modules["yaml"] = None           # PyYAML is not a dependency of the port
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
    """Every port module and chip_smoke import with JAX, the JAX package
    and PyYAML blocked."""
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
            "srsran_tpu_torch.parallel.mesh",
            "srsran_tpu_torch.ops.transform_precode",
            "srsran_tpu_torch.apps.gnb_sim",
            "srsran_tpu_torch.emulation.channel",
            "srsran_tpu_torch.phy.lower.baseband",
            "srsran_tpu_torch.phy.lower.prach_demod",
            "srsran_tpu_torch.mac.scheduler",
            "srsran_tpu_torch.mac.test_mode",
            "srsran_tpu_torch.ran.csi_report",
            "srsran_tpu_torch.ran.mcs_tbs",
            "srsran_tpu_torch.ran.tdd",
            "srsran_tpu_torch.utils.config",
            "srsran_tpu_torch.utils.metrics",
            "srsran_tpu_torch.utils.tracing",
            "srsran_tpu_torch.utils.resource_usage",
            "srsran_tpu_torch.utils.sanitize",
            "srsran_tpu_torch.ofh.compression",
            "srsran_tpu_torch.ofh.cplane",
            "srsran_tpu_torch.ofh.ecpri",
            "srsran_tpu_torch.ofh.timing",
            "srsran_tpu_torch.ofh.uplane",
            "srsran_tpu_torch.ru.ofh",
            "srsran_tpu_torch.apps.ru_emulator",
            "srsran_tpu_torch.fapi.transport",
            "srsran_tpu_torch.fapi.config_messages",
            "srsran_tpu_torch.fapi.bufferer",
            "srsran_tpu_torch.apps.du_low",
            "srsran_tpu_torch.phy.upper.csi_rs",
            "srsran_tpu_torch.phy.upper.ptrs_prs",
            "srsran_tpu_torch.ops.dl_rs",
            "srsran_tpu_torch.ops.dl_control",
            "srsran_tpu_torch.ran.rb_allocation",
            "srsran_tpu_torch.io.sampio",
            "srsran_tpu_torch.ru.units",
            "srsran_tpu_torch.phy.lower.cfo",
            "srsran_tpu_torch.phy.lower.amplitude_control",
            "srsran_tpu_torch.ops.polar_scl",
            "srsran_tpu_torch.apps.ssb_tx",
            "srsran_tpu_torch.apps.rx_power",
            "srsran_tpu_torch.ops.llr"} <= names


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


# ------------------------------------------------ the gNB simulator's host

@pytest.mark.parametrize("tdd", [j_tdd.TddPattern(),
                                 j_tdd.TddPattern(10, 7, 2, 6, 4)])
def test_tdd_copy(tdd):
    port = convert.config(tdd)
    assert isinstance(port, t_tdd.TddPattern)
    for n in range(40):
        assert (port.slot_type(n), port.is_dl(n), port.is_ul(n)) == \
            (tdd.slot_type(n), tdd.is_dl(n), tdd.is_ul(n))


def test_mcs_tbs_copy():
    assert t_mcs.TABLES == j_mcs.TABLES and t_mcs.QM == j_mcs.QM
    assert t_mcs.TBS_TABLE_38214 == j_mcs.TBS_TABLE_38214
    for table, rows in j_mcs.TABLES.items():
        for i in range(len(rows)):
            assert t_mcs.mcs_config(table, i) == j_mcs.mcs_config(table, i)
            mod, rate = j_mcs.mcs_config(table, i)
            for nrb, nsym, dmrs, nl in ((1, 12, 24, 1), (24, 14, 36, 2),
                                        (273, 12, 24, 4), (6, 10, 12, 1)):
                assert t_mcs.tbs(nrb, nsym, dmrs, mod, rate, nl) == \
                    j_mcs.tbs(nrb, nsym, dmrs, mod, rate, nl)


CSI_CFGS = [("typeI_4ports", 0b1111), ("typeI_4ports", 0b0010),
            ("two", 0b11), ("one", 0b1)]


@pytest.mark.parametrize("codebook,restriction", CSI_CFGS)
def test_csi_report_copy(codebook, restriction):
    """Sizes, the part-2 correspondence, and pack / unpack round trips on
    PUSCH and PUCCH equal to the JAX package's, for every allowed rank."""
    jc = j_csi.CsiReportConfig(pmi_codebook=codebook,
                               ri_restriction=restriction)
    tc = convert.config(jc)
    assert isinstance(tc, t_csi.CsiReportConfig)
    assert tc.allowed_ranks() == jc.allowed_ranks()
    assert t_csi.part1_size(tc) == j_csi.part1_size(jc)
    assert t_csi.pucch_size(tc) == j_csi.pucch_size(jc)
    assert convert.config(j_csi.part2_correspondence(jc)) == \
        t_csi.part2_correspondence(tc)
    for ri in jc.allowed_ranks():
        sz = j_csi.pmi_sizes(jc, ri)
        assert dataclasses.asdict(t_csi.pmi_sizes(tc, ri)) == \
            dataclasses.asdict(sz)
        kw = dict(ri=ri, wideband_cqi=11, li=(1 << j_csi.li_size(jc, ri)) - 1,
                  i_1_1=(1 << sz.i_1_1) - 1, i_1_3=(1 << sz.i_1_3) - 1,
                  i_2=(1 << sz.i_2) - 1)
        jb1, jb2 = j_csi.pack(j_csi.CsiReportData(**kw), jc)
        tb1, tb2 = t_csi.pack(t_csi.CsiReportData(**kw), tc)
        np.testing.assert_array_equal(tb1, jb1)
        np.testing.assert_array_equal(tb2, jb2)
        assert dataclasses.asdict(t_csi.unpack(tb1, tb2, tc)) == \
            dataclasses.asdict(j_csi.unpack(jb1, jb2, jc))
        pb = j_csi.pack_pucch(j_csi.CsiReportData(**kw), jc)
        np.testing.assert_array_equal(
            t_csi.pack_pucch(t_csi.CsiReportData(**kw), tc), pb)
        assert dataclasses.asdict(t_csi.unpack_pucch(pb, tc)) == \
            dataclasses.asdict(j_csi.unpack_pucch(pb, jc))
    for cqi in range(16):
        for table in ("qam64", "qam256"):
            assert t_csi.cqi_to_mcs(cqi, table) == j_csi.cqi_to_mcs(cqi, table)


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_precoding_codebooks_copy(ports):
    """The repository, every PMI index and resolve_matrices equal."""
    jr, tr = j_pcb.repository(ports), t_pcb.repository(ports)
    assert len(tr) == len(jr)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == a.dtype
    for ri in range(1, ports + 1):
        for i11 in range(8 if ports == 4 else 1):
            for i13 in range(2):
                for i2 in range(4 if ports > 1 else 1):
                    try:
                        want = j_pcb.pmi_to_index(ports, ri, i11, i13, i2)
                    except ValueError:
                        with pytest.raises(ValueError):
                            t_pcb.pmi_to_index(ports, ri, i11, i13, i2)
                        continue
                    assert t_pcb.pmi_to_index(ports, ri, i11, i13, i2) == want
    by_layers = {}
    for i, m in enumerate(jr):
        by_layers.setdefault(m.shape[1], []).append(i)
    for idx in by_layers.values():
        pre = j_pcb.PrecodingConfig(prg_size=2, pm_indices=tuple(idx))
        np.testing.assert_array_equal(
            t_pcb.resolve_matrices(ports, convert.config(pre)),
            j_pcb.resolve_matrices(ports, pre))
    with pytest.raises(IndexError):
        t_pcb.get_matrix(ports, len(jr))


def _app_cell(nof_rb=24, ports=4):
    from srsran_tpu.phy.slot_programs import CellConfig
    return CellConfig(nof_ports=ports, nof_rb=nof_rb, dft_size=512,
                      numerology=1)


def _same_tx(j_tx, t_tx):
    for f in ("ssb_mib", "pdcch_payloads", "pdsch_payloads"):
        a, b = getattr(j_tx, f), getattr(t_tx, f)
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


@pytest.mark.parametrize("nof_ue", [1, 2])
def test_test_mode_copy(nof_ue):
    """20 slots of the test-mode MAC's requests equal the JAX one's."""
    from srsran_tpu.ran.slot_point import SlotPoint
    ues = [j_tm.TestUe(rnti=0x4601 + i, nof_layers_dl=1 + i)
           for i in range(nof_ue)]
    jm = j_tm.TestModeMac(_app_cell(), 3, ues, j_tdd.TddPattern(), seed=7)
    tm = t_tm.TestModeMac(convert.config(_app_cell()), 3,
                          [convert.config(u) for u in ues],
                          t_tdd.TddPattern(), seed=7)
    for n in range(20):
        js, ts = SlotPoint(1, n), convert.value(SlotPoint(1, n))
        jdl, jtx = jm.dl_requests(js)
        tdl, ttx = tm.dl_requests(ts)
        assert tdl == convert.requests(jdl)
        _same_tx(jtx, ttx)
        assert tm.ul_requests(ts) == convert.requests(jm.ul_requests(js))


def _csi_bits(sched):
    data = j_csi.CsiReportData(ri=2, wideband_cqi=12, i_1_1=3, i_2=1)
    return j_csi.pack_pucch(data, sched.csi_cfg)


def _feedback(sched, slot_count, ul, crc_fail: bool, ack: int):
    """The same CRC, UCI and RACH indications for either scheduler."""
    import types
    for pu, (hid, _) in zip(ul.pusch, ul.pusch_harq):
        sched.handle_crc(pu.rnti, hid, not crc_fail, 17.5)
        if pu.uci.o_csi1:
            cfg = sched.ues[pu.rnti].pusch_csi_cfg
            b1, b2 = j_csi.pack(j_csi.CsiReportData(
                ri=cfg.allowed_ranks()[0], wideband_cqi=9, i_1_1=2,
                i_2=1), cfg)
            sched.handle_csi_pusch(pu.rnti, b1, b2 if b2.size else None)
    pdus = [types.SimpleNamespace(detected=True,
                                  harq_bits=np.array([ack], np.uint8),
                                  csi_bits=None) for _ in ul.pucch_f1]
    pdus += [types.SimpleNamespace(detected=True, harq_bits=None,
                                   csi_bits=_csi_bits(sched))
             for _ in ul.pucch_f2]
    sched.handle_uci_indications(slot_count, pdus)
    if ul.prach:
        sched.handle_rach(slot_count % 16)


@pytest.mark.parametrize("nof_ue,ports", [(1, 4), (2, 2)])
def test_scheduler_copy(nof_ue, ports):
    """slot_indication over 40 slots, with the same CRC (failures too),
    UCI, CSI and RACH feedback fed to both, gives equal requests: HARQ
    retransmissions, RARs, CSI on PUSCH and PUCCH F2, per-PRG precoding."""
    from srsran_tpu.phy.upper.prach import PrachConfig
    from srsran_tpu.ran.slot_point import SlotPoint
    cell = _app_cell(ports=ports)
    prach_cfg = PrachConfig(format="B4", root_sequence_index=1,
                            zero_correlation_zone=0, ra_scs_hz=30_000)
    ues = [j_sched.SchedUeConfig(rnti=0x4601 + i, nof_layers_dl=2)
           for i in range(nof_ue)]
    kw = dict(tdd=j_tdd.TddPattern(), seed=5, prach_period_slots=10,
              csi_period_slots=10, paging_drx_frames=4, paging_po_slot=0)
    js = j_sched.CellScheduler(cell, 1, ues=ues, prach=prach_cfg, **kw)
    ts = t_sched.CellScheduler(
        convert.config(cell), 1, ues=[convert.config(u) for u in ues],
        prach=convert.config(prach_cfg),
        **dict(kw, tdd=convert.config(kw["tdd"])))
    ts.page_ue(0x1234)
    js.page_ue(0x1234)
    precoded = 0
    for n in range(40):
        jdl, jtx, jul = js.slot_indication(SlotPoint(1, n))
        tdl, ttx, tul = ts.slot_indication(convert.value(SlotPoint(1, n)))
        assert tdl == convert.requests(jdl), n
        _same_tx(jtx, ttx)
        assert tul == convert.requests(jul), n
        precoded += sum(c.precoding is not None for c in tdl.pdsch)
        if j_tdd.TddPattern().is_ul(n):
            for sched, ul in ((js, jul), (ts, tul)):
                _feedback(sched, n, ul, crc_fail=n % 15 == 4, ack=n % 2)
    assert ts.counters == js.counters
    assert js.counters["ul_retx"] and js.counters["rar_tx"]
    assert js.counters.get("csi_reports") and js.counters.get("paging_tx")
    assert precoded > 0


YAML_VALUES = ["200", "52", "273", "4096", "sched", "TDLA", "none", "28",
               "28.5", "3.5e9", "3.5e+9", "0x4601", "true", "no", "null", "~",
               "'x'", '"y"', "-3", "+7", "1_000", "010", "0b101", ".5",
               "-.inf", "qam64", "1e5", "-1.5e-3", "0", "typeI_4ports", "On",
               "", " 12 "]


@pytest.mark.parametrize("text", YAML_VALUES)
def test_config_scalar_parser_as_yaml(text):
    import yaml
    want, got = yaml.safe_load(text), t_config.parse_scalar(text)
    assert type(got) is type(want) and got == want


def test_config_copy():
    """The defaults, --set overrides and a YAML file load as the JAX
    package's do, and the AppConfig converts field for field."""
    import tempfile
    import yaml
    from srsran_tpu.utils import config as j_config
    assert t_config.DEFAULTS == yaml.safe_load(j_config.DEFAULT_YAML)
    sets = ["run.nof_slots=40", "cell.nof_rb=52", "cell.dft_size=1024",
            "run.mac=sched", "run.prach_period_slots=10",
            "run.channel_profile=TDLA", "run.channel_sinr_db=28",
            "cell.center_freq_hz=3.5e9", "ues.0.rnti=0x4603"]
    j = j_config.load(None, sets)
    assert t_config.load(None, sets) == convert.config(j)
    with tempfile.NamedTemporaryFile("w", suffix=".yaml") as f:
        f.write(j_config.dump(j))
        f.flush()
        assert t_config.load(f.name) == convert.config(j_config.load(f.name))
    assert t_config.dump(convert.config(j)) == j_config.dump(j)
    with pytest.raises(ValueError, match="unsupported"):
        t_config.parse_scalar("[1, 2]")


# ------------------------------------------------------- DU-low host copies

from srsran_tpu.fapi import config_messages as j_cm          # noqa: E402
from srsran_tpu.phy.upper import csi_rs as j_csirs           # noqa: E402
from srsran_tpu.phy.upper import ptrs_prs as j_pp            # noqa: E402

from srsran_tpu_torch.fapi import config_messages as t_cm    # noqa: E402
from srsran_tpu_torch.phy.upper import csi_rs as t_csirs     # noqa: E402
from srsran_tpu_torch.phy.upper import ptrs_prs as t_pp      # noqa: E402


def test_csi_rs_tables_copy():
    assert t_csirs._ROWS == j_csirs._ROWS
    assert t_csirs._CDM_TABLES == j_csirs._CDM_TABLES


@pytest.mark.parametrize("row", range(1, 19))
def test_csi_rs_host_plan_copy(row):
    """Groups, used symbols and RBs, sequence advance, c_init and values
    of every row and density, at two allocations."""
    nk = j_csirs._ROWS[row][2]
    for rb_start, rb_count in ((0, 52), (7, 30)):
        for d in j_csirs._ROWS[row][3]:
            kw = dict(row=row, rb_start=rb_start, rb_count=rb_count,
                      symbol=4, symbol2=10, k_ref=tuple(range(0, 2 * nk, 2)),
                      density=d, scrambling_id=37, slot_in_frame=9,
                      amplitude=0.7)
            jc, tc = j_csirs.CsiRsConfig(**kw), t_csirs.CsiRsConfig(**kw)
            assert t_csirs._cdm_groups(row, tc.resolved_k_ref(), 4, 10) == \
                j_csirs._cdm_groups(row, jc.resolved_k_ref(), 4, 10)
            assert t_csirs._used_symbols(tc) == j_csirs._used_symbols(jc)
            np.testing.assert_array_equal(t_csirs._used_rbs(tc),
                                          j_csirs._used_rbs(jc))
            assert t_csirs._nof_advance(tc) == j_csirs._nof_advance(jc)
            np.testing.assert_array_equal(t_csirs.c_init_for(tc, 3),
                                          j_csirs.c_init_for(jc, 3))
            np.testing.assert_array_equal(t_csirs.seq_values_for(tc),
                                          j_csirs.seq_values_for(jc))
            assert t_csirs.nof_csi_rs_ports(row) == \
                j_csirs.nof_csi_rs_ports(row)


@pytest.mark.parametrize("time_density,freq_density,offset", [
    (1, 2, 0), (2, 4, 5), (4, 2, 11)])
def test_ptrs_prs_host_copy(time_density, freq_density, offset):
    kw = dict(rb_start=3, rb_count=41, first_symbol=0, nof_symbols=14,
              dmrs_symbols=(2, 7, 11), time_density=time_density,
              freq_density=freq_density, re_offset=offset, port=1,
              scrambling_id=9, n_scid=1, slot_in_frame=13, amplitude=1.2)
    jc, tc = j_pp.PtrsConfig(**kw), t_pp.PtrsConfig(**kw)
    np.testing.assert_array_equal(t_pp.ptrs_positions(tc),
                                  j_pp.ptrs_positions(jc))
    np.testing.assert_array_equal(t_pp.ptrs_cinits_for(tc, 5),
                                  j_pp.ptrs_cinits_for(jc, 5))
    np.testing.assert_array_equal(t_pp.ptrs_values_for(tc),
                                  j_pp.ptrs_values_for(jc))
    for comb, nsym in ((2, 2), (4, 4), (6, 6), (12, 12)):
        pk = dict(rb_start=2, rb_count=48, first_symbol=1, nof_symbols=nsym,
                  comb_size=comb, comb_offset=comb - 1, n_id_prs=2049,
                  slot_in_frame=offset, amplitude=0.5)
        jp, tp = j_pp.PrsConfig(**pk), t_pp.PrsConfig(**pk)
        np.testing.assert_array_equal(t_pp.prs_cinits_for(tp),
                                      j_pp.prs_cinits_for(jp))
        np.testing.assert_array_equal(t_pp.prs_values_for(tp, 7),
                                      j_pp.prs_values_for(jp, 7))
    assert t_pp._PRS_SYMBOL_OFFSETS == j_pp._PRS_SYMBOL_OFFSETS


@pytest.mark.parametrize("ptrs", [None, (1, 2, 0, 0), (2, 4, 3, 1),
                                  (4, 2, 11, 0)])
def test_pdsch_ptrs_re_plan_copy(ptrs):
    """The PDSCH's data-RE plan around its PT-RS REs (one and two CDM
    groups reserved)."""
    j_ptrs = None if ptrs is None else j_pdsch.PdschPtrs(*ptrs)
    t_ptrs = None if ptrs is None else t_pdsch.PdschPtrs(*ptrs)
    for rcg in (1, 2):
        args = (2, 40, 1, 12, (2, 11), rcg)
        np.testing.assert_array_equal(
            t_pdsch._data_re_plan(*args, t_ptrs),
            j_pdsch._data_re_plan(*args, j_ptrs))


def test_config_plane_copy():
    assert [(e.name, e.value) for e in t_cm.ErrorCode] == \
        [(e.name, e.value) for e in j_cm.ErrorCode]
    assert [(e.name, e.value) for e in t_cm.PhyState] == \
        [(e.name, e.value) for e in j_cm.PhyState]
    assert dataclasses.astuple(t_cm.ParamResponse())[1:] == \
        dataclasses.astuple(j_cm.ParamResponse())[1:]
    for kw in (dict(nof_ports=4, nof_rb=273, dft_size=4096, numerology=1),
               dict(nof_ports=9, nof_rb=300, dft_size=100, numerology=7),
               dict(nof_ports=1, nof_rb=52, dft_size=512, numerology=0)):
        jc = j_cm.ConfigRequest(cell=j_cp_cell(**kw))
        tc = t_cm.ConfigRequest(cell=convert.config(jc.cell))
        assert t_cm.validate_config(tc) == j_cm.validate_config(jc)


def j_cp_cell(**kw):
    from srsran_tpu.phy.slot_programs import CellConfig
    return CellConfig(**kw)
