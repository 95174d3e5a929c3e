"""The hand kernels against their plain twins, on a CUDA GPU.

Each case builds the kernel library, runs a kernel wrapper on CUDA tensors
and its twin on the same inputs, at the small PUSCH's and PDSCH's shapes
(the UL-mix kernels K8-K11 at the flagship's and at an edge case each,
the UCI kernels K12-K15 at the conductor scenario's shapes and beyond).
On a machine without a GPU every case skips (the twins are covered by the
parity tests against the JAX package).  ``python3 chip_smoke.py`` runs the same checks at
the flagship shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from srsran_tpu.ran.ldpc_params import segment_tb, select_base_graph
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc

from srsran_tpu_torch import flagship
from srsran_tpu_torch.ops import channel_estimate as chest
from srsran_tpu_torch.ops import (crc, dl_map, ldpc_decode, ldpc_encode,
                                  ldpc_rate_match, ofdm, polar, short_block,
                                  ul_demap)
from srsran_tpu_torch.phy.upper import pdsch, prach, pucch, pusch, srs
from srsran_tpu_torch.ran import polar_params

torch.set_num_threads(2)

TBS = tbs_calc(24, 14, 36, "qam64", 0.7, 2)
SEG = segment_tb(TBS, select_base_graph(TBS, 0.7))
PUSCH = pusch.PuschConfig(rnti=0x17, rb_start=0, rb_count=24, first_symbol=0,
                          nof_symbols=14, modulation="qam64",
                          target_code_rate=0.7, tbs=TBS, nof_layers=2, n_id=1,
                          dmrs_symbols=(2, 7, 11))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _cgauss(rng, shape):
    return torch.as_tensor(((rng.standard_normal(shape)
                             + 1j * rng.standard_normal(shape)) / np.sqrt(2)
                            ).astype(np.complex64))


def _close(a, b, rtol):
    torch.testing.assert_close(a.cpu(), b.cpu(), rtol=rtol,
                               atol=rtol * float(b.abs().max()))


@pytest.mark.parametrize("offset", [0, 8])
def test_ofdm_demodulate_kernel(cuda, offset):
    samples = _cgauss(np.random.default_rng(1), (4, 7680)).to(cuda)
    args = (288, 512, 1, ofdm.CyclicPrefix.NORMAL, 0, 3.5e9, 1.0, offset)
    _close(ofdm.demodulate_slot(samples, *args),
           ofdm.demodulate_slot_ref(samples, *args), 1e-4)


@pytest.mark.parametrize("layers", [1, 2])
def test_pusch_demap_kernel(cuda, layers):
    rng = np.random.default_rng(layers)
    grid = _cgauss(rng, (4, 14, 288)).to(cuda)
    coeffs = _cgauss(rng, (4, layers, 1, 288)).to(cuda)
    sym, sc = pusch._plan(PUSCH, cuda)
    nv = torch.tensor(0.05, device=cuda)
    args = (grid, coeffs, sym, sc, 0, nv, 12345, "qam64", layers)
    llr, x = ul_demap.equalize_demap_descramble(*args)
    llr_ref, x_ref = ul_demap.equalize_demap_descramble_ref(*args)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-4)


@pytest.mark.parametrize("rv", [0, 2])
def test_rate_dematch_kernel(cuda, rv):
    rng = np.random.default_rng(rv)
    g = pdsch.nof_data_re(PUSCH) * 12
    e = pdsch._cb_rate_match_sizes(g, SEG.nof_codeblocks, 6, 2)
    llr = torch.as_tensor(rng.standard_normal(g).astype(np.float32)).to(cuda)
    soft = torch.as_tensor(rng.standard_normal(
        (SEG.nof_codeblocks, SEG.codeword_bits)).astype(np.float32)).to(cuda)
    args = (llr, SEG.nof_codeblocks, e, rv, 6, 1, SEG.lifting_size,
            SEG.cb_info_bits, SEG.full_block_bits, SEG.codeword_bits, soft)
    for a, b in zip(ldpc_rate_match.rate_dematch_combine(*args),
                    ldpc_rate_match.rate_dematch_combine_ref(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("snr_db", [12.0, 4.0])
def test_ldpc_decode_kernel(cuda, snr_db):
    rng = np.random.default_rng(int(snr_db))
    z = SEG.lifting_size
    info = rng.integers(0, 2, (SEG.nof_codeblocks, 22 * z)).astype(np.int8)
    info[:, SEG.cb_info_bits:] = 0
    cbs = torch.as_tensor(info)
    kp = SEG.cb_info_bits
    cbs[:, kp - 24:kp] = crc.crc(cbs[:, :kp - 24], "crc24B")
    cw = ldpc_encode.encode(cbs, 1, z).numpy()
    sigma = 10 ** (-snr_db / 20)
    llr = 2 * ((1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)) / sigma ** 2
    llr[:, :2 * z] = 0.0
    llr[:, kp:22 * z] = 1e4
    llr = torch.as_tensor(llr.astype(np.float32)).to(cuda)
    args = (llr, 1, z, 46, 6, 0.8, "crc24B", kp)
    bits, _, it = ldpc_decode.decode_early_stop(*args)
    bits_ref, _, it_ref = ldpc_decode.decode_early_stop_ref(*args)
    assert torch.equal(bits, bits_ref)
    assert int(it) == int(it_ref)


# DL kernels: a 4-layer 256QAM PDSCH on 24 RB (DM-RS on 2 and 11), a
# repetition case at rv 2, and other rv at another Qm.
def _pdsch(**kw):
    base = dict(rnti=0x4601, rb_start=0, rb_count=24, first_symbol=1,
                nof_symbols=12, modulation="qam256", target_code_rate=0.8,
                tbs=tbs_calc(24, 12, 24, "qam256", 0.8, 4), nof_layers=4,
                n_id=1, dmrs_symbols=(2, 11))
    base.update(kw)
    return pdsch.PdschConfig(**base)


DL_CASES = {
    "4l_qam256": _pdsch(),
    "repetition_rv2": _pdsch(rb_start=10, rb_count=6, modulation="qpsk",
                             target_code_rate=0.1, tbs=296, rv=2),
    "2l_qam64_rv1": _pdsch(modulation="qam64", nof_layers=2, rv=1,
                           tbs=tbs_calc(24, 12, 24, "qam64", 0.5, 2)),
    "3l_qam16_rv3": _pdsch(modulation="qam16", nof_layers=3, rv=3,
                           tbs=tbs_calc(24, 12, 24, "qam16", 0.4, 3)),
}


@pytest.mark.parametrize("tbs,rate", [(311400, 0.7), (26632, 0.7),
                                      (3816, 0.3), (296, 0.1)])
def test_dlsch_encode_kernel(cuda, tbs, rate):
    bg = select_base_graph(tbs, rate)
    tb = torch.as_tensor(np.random.default_rng(tbs).integers(
        0, 2, tbs).astype(np.int8)).to(cuda)
    assert torch.equal(ldpc_encode.dlsch_encode(tb, bg),
                       ldpc_encode.dlsch_encode_ref(tb, bg))


@pytest.mark.parametrize("case", sorted(DL_CASES))
def test_pdsch_map_kernel(cuda, case):
    cfg = DL_CASES[case]
    seg = pdsch.segmentation(cfg)
    rng = np.random.default_rng(len(case))
    tb = torch.as_tensor(rng.integers(0, 2, cfg.tbs).astype(np.int8)).to(cuda)
    cbs = ldpc_encode.dlsch_encode_ref(tb, seg.base_graph)
    grid = _cgauss(rng, (4, 14, 288)).to(cuda)
    w = _cgauss(rng, (4, cfg.nof_layers)).to(cuda)
    args = pdsch.map_args(grid, cfg, cbs, w)[1:]
    out = dl_map.pdsch_map(grid.clone(), *args)
    ref = dl_map.pdsch_map_ref(grid.clone(), *args)
    _close(out, ref, 1e-6)


@pytest.mark.parametrize("cp,mu,n,sis,scale", [
    (ofdm.CyclicPrefix.NORMAL, 1, 512, 0, 1.0),
    (ofdm.CyclicPrefix.NORMAL, 0, 512, 1, 0.5),
    (ofdm.CyclicPrefix.EXTENDED, 2, 1024, 0, 1.0)])
def test_ofdm_modulate_kernel(cuda, cp, mu, n, sis, scale):
    nsym = 14 if cp is ofdm.CyclicPrefix.NORMAL else 12
    grid = _cgauss(np.random.default_rng(n), (4, nsym, 288)).to(cuda)
    args = (n, mu, cp, sis, 3.5e9, scale)
    _close(ofdm.modulate_slot(grid, *args), ofdm.modulate_slot_ref(grid, *args),
           1e-4)


# UL mix kernels: K8 channel estimator, K9 PRACH, K10 PUCCH F1, K11 SRS, at
# the flagship shapes and at one edge case each.

def _chest_inputs(rng, nrb, layers, symbols, stride, cdm, rb_start=0,
                  nsc_grid=3276):
    """A channel through `layers` pilot streams on a 4-port grid."""
    k_p = nrb * 12 // stride
    scs = stride * np.arange(k_p)
    expected = np.exp(1j * np.pi / 2 * rng.integers(
        0, 4, (layers, len(symbols), k_p))).astype(np.complex64)
    if cdm:
        expected[1] = expected[0] * np.where(np.arange(k_p) % 2 == 0, 1, -1)
    h = _cgauss(rng, (4, layers)).numpy()
    ramp = np.exp(-2j * np.pi * scs * 30e3 * 0.4e-6)
    rx = np.einsum("pl,lsk,k->psk", h, expected, ramp)
    grid = _cgauss(rng, (4, 14, nsc_grid)).numpy() * 0.05
    for i, s in enumerate(symbols):
        grid[:, s, rb_start * 12 + scs] += rx[:, i]
    return torch.as_tensor(grid), torch.as_tensor(expected), scs


CHEST_KERNEL_CASES = {
    # the flagship PUSCH: 2 layers with fd-OCC pairs, CFO on, average
    "pusch_flagship": (269, 2, (2, 7, 11), 2, True, "average", 0),
    # per-symbol interpolation
    "pusch_interpolate": (269, 2, (2, 7, 11), 2, True, "interpolate", 0),
    # 1 RB at the top of the carrier: the band touches both edges
    "one_rb_edges": (1, 1, (2, 11), 2, False, "average", 272),
    # the flagship SRS: 1 port, comb 2, 4 RB, one symbol, CFO off
    "srs_flagship": (4, 1, (13,), 2, False, "average", 269),
}


@pytest.mark.parametrize("case", sorted(CHEST_KERNEL_CASES))
def test_channel_estimate_kernel(cuda, case):
    nrb, layers, symbols, stride, cdm, td, rb0 = CHEST_KERNEL_CASES[case]
    rng = np.random.default_rng(len(case))
    grid, expected, scs = _chest_inputs(rng, nrb, layers, symbols, stride,
                                        cdm, rb0)
    cfo = len(symbols) > 1
    times = np.array([0.1428, 0.5, 0.7857])[:len(symbols)] * 1e-3
    args = (grid.to(cuda), symbols, rb0 * 12, expected.to(cuda), scs,
            nrb * 12, 14, 15e3)
    kw = dict(stride=stride, estimate_cfo=cfo,
              dmrs_symbol_times_s=times if cfo else None, td_strategy=td,
              dmrs_symbol_idx=np.asarray(symbols), cdm_pairs=cdm)
    out = chest.estimate_from_grid(*args, **kw)
    ref = chest.estimate_from_grid_ref(*args, **kw)
    assert torch.equal(out.time_alignment_s.cpu(), ref.time_alignment_s.cpu())
    assert abs(float(out.cfo_hz) - float(ref.cfo_hz)) < 1e-2
    for key in ("coeffs", "noise_var", "rsrp", "epre", "snr"):
        _close(getattr(out, key), getattr(ref, key), 1e-4)


def _prach_capture(cfg, preamble, ports, symbols, rng):
    tx = prach.generate_np(cfg, preamble)
    ramp = np.exp(-2j * np.pi * np.arange(cfg.l_ra) * cfg.scs_hz * 2e-6)
    fd = np.tile((tx * ramp)[None, None], (ports, symbols, 1))
    return torch.as_tensor((fd + 0.05 * (rng.standard_normal(fd.shape)
                                         + 1j * rng.standard_normal(fd.shape))
                            ).astype(np.complex64))


@pytest.mark.parametrize("fmt", ["B4", "0"])
def test_prach_detect_kernel(cuda, fmt):
    if fmt == "B4":
        cfg = flagship.PRACH
        fd = torch.as_tensor(flagship.prach_capture(np.random.default_rng(0)))
        want = flagship.PRACH_PREAMBLE
    else:                                  # format 0: L 839, 1.25 kHz
        cfg = prach.PrachConfig(format="0", root_sequence_index=22,
                                zero_correlation_zone=10)
        want = 37
        fd = _prach_capture(cfg, want, 4, 1, np.random.default_rng(3))
    out = prach.detect(fd.to(cuda), cfg)
    ref = prach.detect_ref(fd.to(cuda), cfg)
    assert torch.equal(out.detected, ref.detected)
    assert torch.nonzero(out.detected).flatten().tolist() == [want]
    assert torch.equal(out.time_advance_s, ref.time_advance_s)
    _close(out.metrics, ref.metrics, 1e-4)
    _close(out.rssi, ref.rssi, 1e-4)


@pytest.mark.parametrize("n_users,hop", [(1, None), (3, 9)])
def test_pucch_f1_kernel(cuda, n_users, hop):
    common = pucch.PucchF1Config(prb=0, start_symbol=0, nof_symbols=14,
                                 initial_cyclic_shift=0, time_domain_occ=0,
                                 n_id=1, slot=4, second_hop_prb=hop)
    users = tuple((4 * u, u % 2, 1 + u % 2) for u in range(n_users))
    grid = torch.zeros((4, 14, 3276), dtype=torch.complex64)
    rng = np.random.default_rng(n_users)
    for m0, occ, nbits in users:
        cfg = dataclasses.replace(common, initial_cyclic_shift=m0,
                                  time_domain_occ=occ, nof_harq_bits=nbits)
        one = pucch.transmit_format1(torch.zeros_like(grid), cfg,
                                     rng.integers(0, 2, nbits))[0]
        grid += _cgauss(rng, (4,))[:, None, None] * one
    grid = (grid + 0.05 * _cgauss(rng, grid.shape)).to(cuda)
    weights = tuple(tuple(torch.as_tensor(w).to(cuda) for w in h)
                    for h in pucch.f1_batch_weights(common, users))
    out = pucch.f1_detect(grid, common, weights, 1.5)
    ref = pucch.f1_detect_ref(grid, common, weights, 1.5)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    _close(out[1], ref[1], 1e-4)
    _close(out[3], ref[3], 1e-4)


@pytest.mark.parametrize("ports,comb", [(1, 2), (4, 4)])
def test_srs_estimate_kernel(cuda, ports, comb):
    cfg = srs.SrsConfig(rb_start=269 if ports == 1 else 200,
                        rb_count=4 if ports == 1 else 48, start_symbol=13,
                        nof_symbols=1, comb=comb, comb_offset=0,
                        cyclic_shift=0, nof_ports=ports, sequence_id=1,
                        numerology=1)
    rng = np.random.default_rng(ports)
    tx = srs.map_to_grid(torch.zeros((4, 14, 3276), dtype=torch.complex64),
                         cfg)
    grid = (torch.einsum("rp,psk->rsk", _cgauss(rng, (4, 4)), tx)
            + 0.05 * _cgauss(rng, tx.shape)).to(cuda)
    args, kw = srs.estimate_args(grid, cfg)
    est = chest.estimate_from_grid_ref(*args, **kw)
    out = srs.srs_noise(grid, cfg, est.time_alignment_s, est.rsrp)
    ref = srs.srs_noise_ref(grid, cfg, est.time_alignment_s, est.rsrp)
    for a, b in zip(out, ref):
        _close(a, b, 1e-4)


# UCI kernels: K12 PUCCH F0 detect, K13 PUCCH F2 demap, K14 short-block ML,
# K15 polar decode, and K8 at the F2 comb-3 shape.

def _f0_grid(cfg, rng, harq, sr):
    sent = pucch.transmit_format0(torch.zeros((1, 14, 3276),
                                              dtype=torch.complex64),
                                  cfg, harq, sr)[0]
    return (_cgauss(rng, (4,))[:, None, None] * sent
            + 0.3 * _cgauss(rng, (4, 14, 3276)))


@pytest.mark.parametrize("key", sorted(pucch._F0_TABLES))
@pytest.mark.parametrize("hop", [None, 272])
def test_pucch_f0_kernel(cuda, key, hop):
    nbits, sr_opp = key
    cfg = pucch.PucchF0Config(prb=269, start_symbol=11, nof_symbols=2,
                              initial_cyclic_shift=3, n_id=1, slot=6,
                              nof_harq_bits=nbits, sr_opportunity=sr_opp,
                              second_hop_prb=hop)
    rng = np.random.default_rng(nbits + 7 * sr_opp)
    refs = torch.as_tensor(pucch.f0_refs_for(cfg)).to(cuda)
    for _, sr, harq in pucch._F0_TABLES[key]:
        grid = _f0_grid(cfg, rng, harq, sr or 0).to(cuda)
        out = pucch.f0_detect(grid, cfg, refs, 4.0)
        ref = pucch.f0_detect_ref(grid, cfg, refs, 4.0)
        for i in (0, 2, 3, 4):
            assert torch.equal(out[i], ref[i]), i
        _close(out[1], ref[1], 1e-4)
        assert bool(out[0]) and out[2].tolist() == list(harq)


def _f2_cfg(nof_rb, nsym):
    """An F2 PDU ending at PRB 271 with 22 CSI bits (polar) where it has room
    for them (E >= 64), else 6 (short block)."""
    k = 22 if 16 * nof_rb * nsym >= 64 else 6
    return pucch.PucchF2Config(rb_start=271 - nof_rb + 1, nof_rb=nof_rb,
                               start_symbol=11, nof_symbols=nsym, rnti=0x19,
                               n_id=1, n_id0=1, nof_uci_bits=k, slot=2)


def _f2_grid(cfg, rng):
    sent = pucch.transmit_format2(
        torch.zeros((1, 14, 3276), dtype=torch.complex64), cfg,
        rng.integers(0, 2, cfg.nof_uci_bits))[0]
    return (_cgauss(rng, (4,))[:, None, None] * sent
            + 0.05 * _cgauss(rng, (4, 14, 3276)))


@pytest.mark.parametrize("nof_rb,nsym", [(1, 2), (2, 2), (2, 1), (16, 2)])
def test_channel_estimate_kernel_f2_comb3(cuda, nof_rb, nsym):
    """K8 at its first stride-3 comb: 4 * nof_rb pilots over 1-2 symbols."""
    cfg = _f2_cfg(nof_rb, nsym)
    rng = np.random.default_rng(nof_rb)
    grid = _f2_grid(cfg, rng).to(cuda)
    pil = torch.as_tensor(pucch.f2_pilot_values_for(cfg)).to(cuda)
    args, kw = pucch.f2_estimate_args(grid, cfg, pil)
    out = chest.estimate_from_grid(*args, **kw)
    ref = chest.estimate_from_grid_ref(*args, **kw)
    assert torch.equal(out.time_alignment_s.cpu(), ref.time_alignment_s.cpu())
    for key in ("coeffs", "noise_var", "rsrp", "epre", "snr"):
        _close(getattr(out, key), getattr(ref, key), 1e-4)


@pytest.mark.parametrize("nof_rb,nsym", [(1, 2), (2, 2), (4, 1), (16, 2)])
def test_pucch_f2_demap_kernel(cuda, nof_rb, nsym):
    cfg = _f2_cfg(nof_rb, nsym)
    rng = np.random.default_rng(10 + nof_rb)
    grid = _f2_grid(cfg, rng).to(cuda)
    pil = torch.as_tensor(pucch.f2_pilot_values_for(cfg)).to(cuda)
    args, kw = pucch.f2_estimate_args(grid, cfg, pil)
    est = chest.estimate_from_grid_ref(*args, **kw)
    _close(pucch.f2_demap(grid, est.coeffs, est.noise_var, cfg),
           pucch.f2_demap_ref(grid, est.coeffs, est.noise_var, cfg), 1e-4)


@pytest.mark.parametrize("k,qm,e", [(1, 2, 32), (2, 2, 32), (2, 1, 20),
                                    (3, 2, 32), (6, 2, 32), (11, 2, 512),
                                    (11, 1, 100)])
def test_short_block_kernel(cuda, k, qm, e):
    rng = np.random.default_rng(k * e)
    msg = torch.as_tensor(rng.integers(0, 2, (5, k)).astype(np.int8))
    cw = short_block.encode(msg, e, qm).numpy()
    llr = torch.as_tensor(((1.0 - 2.0 * cw) + rng.standard_normal(cw.shape)
                           ).astype(np.float32))
    llr[4] = 0.0                                   # all ties: candidate 0
    llr = llr.to(cuda)
    bits, metric = short_block.detect(llr, k, qm)
    bits_ref, metric_ref = short_block.detect_ref(llr, k, qm)
    assert torch.equal(bits, bits_ref)
    _close(metric, metric_ref, 1e-5)


@pytest.mark.parametrize("k,e,n_pc,crc_name", [
    (33, 64, 0, "crc11"), (18, 32, 3, "crc6"), (18, 100, 3, "crc6"),
    (40, 50, 0, "crc11"), (25, 300, 0, "crc11"), (111, 1000, 0, "crc11"),
    (200, 1024, 0, "crc11")])
def test_polar_decode_kernel(cuda, k, e, n_pc, crc_name):
    """K'-bit codewords (message + CRC) at E bits, N from 32 to 1024, with
    exact-zero LLRs: bits and CRC flags equal the twin's."""
    code = polar_params.polar_code(k, e, nmax=10, ibil=True, n_pc=n_pc)
    rng = np.random.default_rng(k + e)
    msg = rng.integers(0, 2, (6, k)).astype(np.int8)
    x = polar.rate_match(polar.encode(polar.allocate(torch.as_tensor(msg),
                                                     code), code.n),
                         code).numpy()
    llr = ((1.0 - 2.0 * x) + 0.8 * rng.standard_normal(x.shape)
           ).astype(np.float32)
    llr[1, ::3] = 0.0
    llr[5] = 0.0
    llr = torch.as_tensor(llr).to(cuda)
    bits, ok = polar.decode(llr, code, crc_name)
    bits_ref, ok_ref = polar.decode_ref(llr, code, crc_name)
    assert torch.equal(bits, bits_ref)
    assert torch.equal(ok, ok_ref)
