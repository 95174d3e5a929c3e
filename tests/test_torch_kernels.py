"""The hand kernels against their plain twins, on a CUDA GPU.

Each case builds the kernel library, runs a kernel wrapper on CUDA tensors
and its twin on the same inputs, at the small PUSCH's and PDSCH's shapes
(the UL-mix kernels K8-K11 at the flagship's and at an edge case each,
the UCI kernels K12-K15 at the conductor scenario's shapes and beyond,
K16 at 1-4 layers with ZF and MMSE, K17 over the UCI-on-PUSCH
configurations, K8 on CDM group 1, the conductor's empty results on
the card, and the gNB simulator's K20 TDL channel, K21 PRACH occasion
demodulator and K22 per-PRG PDSCH map, and the fronthaul's K23 BFP compress
and pack and K24 unpack and decompress, with RuOfh on the card).
K1 at 4, 10 and every layer of BG1 and BG2, with a slot axis whose slots
stop apart, without a CRC, and K1 and K5 captured in a CUDA graph; K5 at
every lifting-size class, alone and with a slot axis.
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

from srsran_tpu_torch import flagship, kernels
from srsran_tpu_torch.ops import channel_estimate as chest
from srsran_tpu_torch.ops import (crc, dl_map, dl_rs, ldpc_decode,
                                  ldpc_encode, ldpc_rate_match, ofdm, polar,
                                  short_block, ul_demap)
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


NORMAL, EXTENDED = ofdm.CyclicPrefix.NORMAL, ofdm.CyclicPrefix.EXTENDED
# K4's and K7's cases: (N, K, numerology, CP, slot_in_subframe, window
# offset (K4), slot axis): the radix-16 form at every size (the flagship's
# 4096 among them, alone, at the largest offset and over 4 slots), extended
# CP, and the Stockham form at 1536 (with an offset and a slot axis) and
# 3000.
OFDM_CASES = {
    "n512": (512, 288, 1, NORMAL, 0, 0, ()),
    "n512_offset8": (512, 288, 1, NORMAL, 0, 8, ()),
    "flagship": (4096, 3276, 1, NORMAL, 0, 0, ()),
    "flagship_offset_max": (4096, 3276, 1, NORMAL, 0, 144, ()),
    "flagship_batch4": (4096, 3276, 1, NORMAL, 0, 0, (4,)),
    "n2048_sis1": (2048, 1638, 1, NORMAL, 1, 20, ()),
    "n1024_extended": (1024, 600, 2, EXTENDED, 0, 36, ()),
    "n256_extended_mu0": (256, 180, 0, EXTENDED, 1, 0, ()),
    "n128_odd": (128, 71, 0, NORMAL, 1, 4, ()),
    "stockham_1536": (1536, 1200, 1, NORMAL, 0, 0, ()),
    "stockham_1536_offset_batch2": (1536, 1200, 1, NORMAL, 1, 54, (2,)),
    "stockham_3000": (3000, 2400, 0, NORMAL, 0, 10, ()),
}


def _ofdm_counter(kernel, lead):
    return (kernels.REGISTRY[f"{kernel.name}_batch"] if lead else kernel)


@pytest.mark.parametrize("case", list(OFDM_CASES))
def test_ofdm_demodulate_kernel(cuda, case):
    """K4 against its twin at rtol 1e-4, one launch a call."""
    n, k, mu, cp, sis, offset, lead = OFDM_CASES[case]
    total = ofdm._symbol_layout(cp, mu, n, sis)[2]
    samples = _cgauss(np.random.default_rng(n + k), lead + (4, total)).to(
        cuda)
    args = (k, n, mu, cp, sis, 3.5e9, 0.8, offset)
    counter = _ofdm_counter(ofdm.KERNEL, lead)
    before = counter.launches
    out = ofdm.demodulate_slot(samples, *args)
    assert counter.launches == before + 1
    _close(out, ofdm.demodulate_slot_ref(samples, *args), 1e-4)


@pytest.mark.parametrize("modulation", ["qam64", "bpsk", "pi2bpsk"])
@pytest.mark.parametrize("layers", [1, 2])
def test_pusch_demap_kernel(cuda, layers, modulation):
    rng = np.random.default_rng(layers)
    grid = _cgauss(rng, (4, 14, 288)).to(cuda)
    coeffs = _cgauss(rng, (4, layers, 1, 288)).to(cuda)
    sym, sc = pusch._plan(PUSCH, cuda)
    nv = torch.tensor(0.05, device=cuda)
    args = (grid, coeffs, sym, sc, 0, nv, 12345, modulation, layers)
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


def _k1_llrs(rng, bg, z, lead, snr_db):
    """BPSK LLRs of the twin's codewords of random CRC24B'd blocks, the 2Z
    punctured bits 0 and the fillers (8 a block) strongly positive;
    ``snr_db`` per leading slot (or one for all).  Returns (llrs on the
    CPU, k')."""
    kb = 22 if bg == 1 else 10
    kp = kb * z - 8
    info = rng.integers(0, 2, (int(np.prod(lead)), kb * z)).astype(np.int8)
    info[:, kp:] = 0
    cbs = torch.as_tensor(info)
    cbs[:, kp - 24:kp] = crc.crc(cbs[:, :kp - 24], "crc24B")
    cw = ldpc_encode.encode(cbs, bg, z).numpy().reshape(lead + (-1,))
    sigma = 10 ** (-np.asarray(snr_db, dtype=np.float64) / 20)
    sigma = sigma.reshape(sigma.shape + (1,) * (len(lead) + 1 - sigma.ndim))
    llr = 2 * ((1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
               ) / sigma ** 2
    llr[..., :2 * z] = 0.0
    llr[..., kp:kb * z] = 1e4
    return torch.as_tensor(llr.astype(np.float32)), kp


def _k1_equal(got, want):
    """K1 bit for bit: hard bits, soft values and sweeps."""
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1].cpu().view(torch.int32),
                       want[1].cpu().view(torch.int32))
    assert torch.equal(got[2].cpu(), want[2].cpu())


@pytest.mark.parametrize("bg,z", [(1, 384), (1, 208), (1, 36), (2, 384),
                                  (2, 208), (2, 15)])
@pytest.mark.parametrize("layers", [4, 10, 46])
def test_ldpc_decode_layers(cuda, bg, z, layers):
    """K1 at 4, 10 and every layer (46 at BG1, 42 at BG2) on noisy
    codewords that take several sweeps, against its twin."""
    rng = np.random.default_rng(bg * 1000 + z + layers)
    llr, kp = _k1_llrs(rng, bg, z, (5,), 1.5)
    nrows = min(layers, 46 if bg == 1 else 42)
    args = (bg, z, nrows, 6, 0.8, "crc24B", kp)
    got = ldpc_decode.decode_early_stop(llr.to(cuda), *args)
    torch.cuda.synchronize()
    _k1_equal(got, ldpc_decode.decode_early_stop_ref(llr, *args))
    assert got[0].device == llr.to(cuda).device


def test_ldpc_decode_input_unchanged(cuda):
    """The caller's LLRs stay as they were; a strided input decodes as
    its contiguous copy."""
    rng = np.random.default_rng(5)
    llr, kp = _k1_llrs(rng, 1, 384, (4,), 2.0)
    x = llr.to(cuda)
    keep = x.clone()
    args = (1, 384, 46, 6, 0.8, "crc24B", kp)
    got = ldpc_decode.decode_early_stop(x, *args)
    torch.cuda.synchronize()
    assert torch.equal(x, keep)
    _k1_equal(got, ldpc_decode.decode_early_stop_ref(llr, *args))
    wide = torch.stack([x, x], dim=1)[:, 0]         # rows apart: strided
    assert not wide.is_contiguous()
    _k1_equal(ldpc_decode.decode_early_stop(wide, *args), got)


@pytest.mark.parametrize("bg,z", [(1, 384), (2, 208)])
def test_ldpc_decode_slots_stop_apart(cuda, bg, z):
    """A slot axis: the clean slot stops after one sweep while the noisy
    ones sweep on; every slot equals its own run and the twin's."""
    rng = np.random.default_rng(z)
    llr, kp = _k1_llrs(rng, bg, z, (3, 4), [9.0, 1.2, 1.8])
    args = (bg, z, 46 if bg == 1 else 42, 6, 0.8, "crc24B", kp)
    got = ldpc_decode.decode_early_stop(llr.to(cuda), *args)
    _k1_equal(got, ldpc_decode.decode_early_stop_ref(llr, *args))
    assert got[2].shape == (3,) and int(got[2][0]) == 1
    assert int(got[2].max()) > 1
    for s in range(3):
        one = ldpc_decode.decode_early_stop(llr[s].to(cuda), *args)
        _k1_equal(tuple(o[s] for o in got), one)


def test_ldpc_decode_launch_paths(cuda):
    """K1's two launch forms on the same codeblocks: batches of more
    codeblocks than half the SMs (a launch per sweep) and of at most half
    (every sweep in one launch): each equal to the twin and to the others,
    slot by slot."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    per_slot = sms // 2 + 1              # 2 or 3 slots: a launch a sweep
    rng = np.random.default_rng(77)
    llr, kp = _k1_llrs(rng, 2, 36, (3, per_slot), [2.0, 1.4, 8.0])
    args = (2, 36, 42, 6, 0.8, "crc24B", kp)
    x = llr.to(cuda)
    three = ldpc_decode.decode_early_stop(x, *args)
    _k1_equal(three, ldpc_decode.decode_early_stop_ref(llr, *args))
    two = ldpc_decode.decode_early_stop(x[:2], *args)
    _k1_equal(two, tuple(o[:2] for o in three))
    small = ldpc_decode.decode_early_stop(x[:, :per_slot // 2], *args)
    _k1_equal(small, ldpc_decode.decode_early_stop_ref(
        llr[:, :per_slot // 2], *args))
    for s in range(3):
        one = ldpc_decode.decode_early_stop(x[s, :per_slot // 2], *args)
        _k1_equal(one, tuple(o[s] for o in small))


@pytest.mark.parametrize("bg,z,layers", [(1, 384, 10), (2, 36, 0)])
def test_ldpc_decode_fixed_sweeps(cuda, bg, z, layers):
    """``decode`` (no CRC): every sweep runs, against its twin."""
    rng = np.random.default_rng(layers + z)
    llr, _ = _k1_llrs(rng, bg, z, (3,), 1.0)
    got = ldpc_decode.decode(llr.to(cuda), bg, z, layers, 4)
    want = ldpc_decode.decode_ref(llr, bg, z, layers, 4)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu().view(torch.int32),
                       want[1].view(torch.int32))


def test_ldpc_decode_and_encode_in_a_cuda_graph(cuda):
    """A K1 and a K5 launch captured in a CUDA graph replay on new inputs
    equal to eager launches and to the twins."""
    rng = np.random.default_rng(21)
    llr, kp = _k1_llrs(rng, 1, 208, (2, 3), 1.8)
    x = llr.to(cuda)
    args = (1, 208, 46, 6, 0.8, "crc24B", kp)
    tb = torch.as_tensor(rng.integers(0, 2, (2, 8456)).astype(np.int8)
                         ).to(cuda)
    ldpc_decode.decode_early_stop(x, *args)
    ldpc_encode.dlsch_encode(tb, 1)                 # plans built, warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dec = ldpc_decode.decode_early_stop(x, *args)
        enc = ldpc_encode.dlsch_encode(tb, 1)
    for snr in (1.5, 3.0, 9.0):
        new, _ = _k1_llrs(rng, 1, 208, (2, 3), snr)
        x.copy_(new.to(cuda))
        tb.copy_(torch.as_tensor(rng.integers(0, 2, (2, 8456)).astype(
            np.int8)))
        graph.replay()
        torch.cuda.synchronize()
        _k1_equal(dec, ldpc_decode.decode_early_stop(x, *args))
        _k1_equal(dec, ldpc_decode.decode_early_stop_ref(new, *args))
        assert torch.equal(enc, ldpc_encode.dlsch_encode(tb, 1))
        assert torch.equal(enc.cpu(), ldpc_encode.dlsch_encode_ref(
            tb.cpu(), 1))


# (TBS, base graph) of every lifting-size class: Z = 2, 15, 36, 208 (one
# codeblock), 208 over two BG2 codeblocks, 320 over four, 384 over two
# and over the flagship's 100
ENCODE_Z_CASES = [(24, 1), (72, 2), (696, 1), (1912, 2), (3832, 2),
                  (26632, 1), (15424, 1), (835584, 1)]


@pytest.mark.parametrize("tbs,bg", ENCODE_Z_CASES)
@pytest.mark.parametrize("slots", [0, 3])
def test_dlsch_encode_lifting_sizes(cuda, tbs, bg, slots):
    """K5 at every lifting-size class, alone and with a slot axis (each
    slot its own TB and TB CRC, equal to its own launch)."""
    rng = np.random.default_rng(tbs + slots)
    shape = (slots, tbs) if slots else (tbs,)
    tb = torch.as_tensor(rng.integers(0, 2, shape).astype(np.int8)).to(cuda)
    got = ldpc_encode.dlsch_encode(tb, bg)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ldpc_encode.dlsch_encode_ref(tb.cpu(), bg))
    for s in range(slots):
        assert torch.equal(got[s], ldpc_encode.dlsch_encode(tb[s], bg))


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


K6_CASES = ("pdsch_map", "pdsch_map_interleaved", "pdsch_map_nref",
            "pdsch_map_repetition", "pdsch_map_prg_type0")
K3_CASES = ("pusch_demap", "pusch_demap_1l", "pusch_demap_hop1",
            "pusch_demap_hop2")


def _map_demap_case(name: str, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(25)
    return flagship.map_demap_profile_cases(gen, device)[name]


@pytest.mark.parametrize("case", K6_CASES)
def test_pdsch_map_kernel_at_the_flagship(cuda, case):
    """K6 / K22 at the flagship's shapes (100 codeblocks, 4 layers 256QAM;
    slot F's interleaved plan, n_ref, the repetition shape with E beyond
    N_nf, slot E's PRG table) within 1e-6 of max|ref| of its twin, one
    launch a call."""
    fn, twin, args = _map_demap_case(case, cuda)
    counter = (dl_map.KERNEL_PRG if case.endswith("type0")
               else dl_map.KERNEL)
    before = counter.launches
    out = fn(args[0].clone(), *args[1:])
    assert counter.launches == before + 1
    ref = twin(args[0].clone(), *args[1:])
    _close(out, ref, 1e-6)


@pytest.mark.parametrize("case", K3_CASES)
def test_pusch_demap_kernel_at_the_flagship(cuda, case):
    """K3 at the flagship PUSCH (2 layers ZF QAM64, 35,508 REs), at 1
    layer, and on both hops of the pi/2-BPSK PUSCH (hop 2 from hop 1's
    Gold offset) within rtol 1e-4 of its twin, one launch a call."""
    fn, twin, args = _map_demap_case(case, cuda)
    before = ul_demap.KERNEL.launches
    llr, x = fn(*args)
    assert ul_demap.KERNEL.launches == before + 1
    llr_ref, x_ref = twin(*args)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-4)


def test_map_demap_kernels_in_a_cuda_graph(cuda):
    """K6 and K3 at the flagship shapes captured in one CUDA graph and
    replayed on new codeblocks, grids and channels (no synchronisation,
    no allocation inside either launch)."""
    k6 = _map_demap_case("pdsch_map", cuda)[2]
    k3 = _map_demap_case("pusch_demap", cuda)[2]
    dl_grid = k6[0].clone()
    dl_map.pdsch_map(dl_grid, *k6[1:])
    ul_demap.equalize_demap_descramble(*k3)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dl_map.pdsch_map(dl_grid, *k6[1:])
        llr, x = ul_demap.equalize_demap_descramble(*k3)
    rng = np.random.default_rng(5)
    start = _cgauss(rng, tuple(dl_grid.shape)).to(cuda)
    dl_grid.copy_(start)
    k6[1].copy_(torch.as_tensor(rng.integers(
        0, 2, tuple(k6[1].shape)).astype(np.int8)).to(cuda))
    k3[0].copy_(_cgauss(rng, tuple(k3[0].shape)).to(cuda))
    k3[1].copy_(_cgauss(rng, tuple(k3[1].shape)).to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    _close(dl_grid, dl_map.pdsch_map_ref(start.clone(), *k6[1:]), 1e-6)
    llr_ref, x_ref = ul_demap.equalize_demap_descramble_ref(*k3)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-4)


@pytest.mark.parametrize("case", ["scale_half"] + list(OFDM_CASES))
def test_ofdm_modulate_kernel(cuda, case):
    """K7 against its twin at rtol 1e-4, one launch a call."""
    if case == "scale_half":
        n, k, mu, cp, sis, scale, lead = 512, 288, 0, NORMAL, 1, 0.5, ()
    else:
        n, k, mu, cp, sis, _, lead = OFDM_CASES[case]
        scale = 1.0
    nsym = 14 if cp is NORMAL else 12
    grid = _cgauss(np.random.default_rng(n), lead + (4, nsym, k)).to(cuda)
    args = (n, mu, cp, sis, 3.5e9, scale)
    counter = _ofdm_counter(ofdm.KERNEL_TX, lead)
    before = counter.launches
    out = ofdm.modulate_slot(grid, *args)
    assert counter.launches == before + 1
    _close(out, ofdm.modulate_slot_ref(grid, *args), 1e-4)


@pytest.mark.parametrize("case", ["flagship", "stockham_1536"])
def test_ofdm_kernels_in_cuda_graph(cuda, case):
    """K4 and K7 captured in one CUDA graph and replayed on new inputs
    (no synchronisation, no allocation inside either launch)."""
    n, k, mu, cp, sis, offset, _ = OFDM_CASES[case]
    rng = np.random.default_rng(7)
    total = ofdm._symbol_layout(cp, mu, n, sis)[2]
    samples = _cgauss(rng, (4, total)).to(cuda)
    grid = _cgauss(rng, (4, 14, k)).to(cuda)
    rx = (k, n, mu, cp, sis, 3.5e9, 1.0, offset)
    tx = (n, mu, cp, sis, 3.5e9, 1.0)
    ofdm.demodulate_slot(samples, *rx)
    ofdm.modulate_slot(grid, *tx)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_rx = ofdm.demodulate_slot(samples, *rx)
        out_tx = ofdm.modulate_slot(grid, *tx)
    samples.copy_(_cgauss(rng, (4, total)).to(cuda))
    grid.copy_(_cgauss(rng, (4, 14, k)).to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    _close(out_rx, ofdm.demodulate_slot_ref(samples, *rx), 1e-4)
    _close(out_tx, ofdm.modulate_slot_ref(grid, *tx), 1e-4)


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
    # 4 rx ports x 4 streams (P L = 16): a 4-port SRS at comb 4 on two
    # symbols, and 4 layers at stride 2 with CFO
    "srs_4port_comb4": (64, 4, (12, 13), 4, False, "average", 100),
    "four_layers": (100, 4, (2, 11), 2, False, "average", 0),
    # every subcarrier a pilot (the F3/F4's comb), and comb 3 (the F2's)
    "stride1": (16, 1, (3, 10), 1, False, "average", 200),
    "comb3": (16, 1, (11, 12), 3, False, "average", 50),
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


@pytest.mark.parametrize("case", ["pusch_flagship", "pusch_interpolate",
                                  "srs_4port_comb4"])
def test_channel_estimate_kernel_in_a_cuda_graph(cuda, case):
    """K8's one launch captured in a CUDA graph (its plan made by a call
    before the capture) and replayed on a new grid: the twin's results on
    that grid."""
    nrb, layers, symbols, stride, cdm, td, rb0 = CHEST_KERNEL_CASES[case]
    rng = np.random.default_rng(3 + len(case))
    grid, expected, scs = _chest_inputs(rng, nrb, layers, symbols, stride,
                                        cdm, rb0)
    cfo = len(symbols) > 1
    times = np.array([0.1428, 0.5, 0.7857])[:len(symbols)] * 1e-3
    static = grid.to(cuda)
    args = (static, symbols, rb0 * 12, expected.to(cuda), scs, nrb * 12, 14,
            15e3)
    kw = dict(stride=stride, estimate_cfo=cfo,
              dmrs_symbol_times_s=times if cfo else None, td_strategy=td,
              dmrs_symbol_idx=np.asarray(symbols), cdm_pairs=cdm)
    chest.estimate_from_grid(*args, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chest.estimate_from_grid(*args, **kw)
    fresh, _, _ = _chest_inputs(np.random.default_rng(99), nrb, layers,
                                symbols, stride, cdm, rb0)
    static.copy_(fresh.to(cuda))
    graph.replay()
    torch.cuda.synchronize()
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


# K9's other configurations: the gNB simulator's zcz 0 (64 roots of one
# preamble each), a restricted set, and the IDFT sizes the kernel takes.
K9_MORE = {
    "zcz0": (prach.PrachConfig(format="B4", root_sequence_index=1,
                               zero_correlation_zone=0, ra_scs_hz=30_000),
             5, 4, 12),
    "restricted": (prach.PrachConfig(format="0", root_sequence_index=22,
                                     zero_correlation_zone=5,
                                     restricted="type_a"), 9, 4, 1),
    "format0_8ports": (prach.PrachConfig(format="0", root_sequence_index=22,
                                         zero_correlation_zone=10),
                       37, 8, 1),
}


def _k9_hold(out, ref, want=None):
    """K9 against its twin: the decisions and the TA equal, the metrics
    and the RSSI within 1e-4 of their largest magnitude; the preamble sent
    detected."""
    assert torch.equal(out.detected, ref.detected)
    assert torch.equal(out.time_advance_s, ref.time_advance_s)
    _close(out.metrics, ref.metrics, 1e-4)
    _close(out.rssi, ref.rssi, 1e-4)
    if want is not None:
        assert bool(out.detected[..., want].all())


@pytest.mark.parametrize("name", sorted(K9_MORE))
def test_prach_detect_kernel_configs(cuda, name):
    """K9 at zcz 0 (R 64), on a restricted set and at 8 ports: one launch
    each, the twin's decisions, TA, metrics and RSSI."""
    cfg, want, ports, symbols = K9_MORE[name]
    fd = _prach_capture(cfg, want, ports, symbols,
                        np.random.default_rng(len(name))).to(cuda)
    before = prach.KERNEL.launches
    out = prach.detect(fd, cfg)
    assert prach.KERNEL.launches == before + 1
    _k9_hold(out, prach.detect_ref(fd, cfg), want)


@pytest.mark.parametrize("idft_size", [256, 512, 2048, 4096])
@pytest.mark.parametrize("fmt", ["B4", "0"])
def test_prach_detect_kernel_idft_sizes(cuda, fmt, idft_size):
    """K9 at every IDFT size it takes (format 0 from 1024 on), against the
    twin at the same size."""
    if fmt == "B4":
        cfg, want = flagship.PRACH, flagship.PRACH_PREAMBLE
        fd = torch.as_tensor(flagship.prach_capture(np.random.default_rng(1)))
    else:
        if idft_size < 1024:
            pytest.skip("format 0's 839 bins need 1024 points or more")
        cfg = prach.PrachConfig(format="0", root_sequence_index=22,
                                zero_correlation_zone=10)
        want = 37
        fd = _prach_capture(cfg, want, 4, 1, np.random.default_rng(4))
    fd = fd.to(cuda)
    _k9_hold(prach.detect(fd, cfg, idft_size=idft_size),
             prach.detect_ref(fd, cfg, idft_size=idft_size), want)


def test_prach_detect_kernel_refuses_an_idft_size(cuda):
    fd = torch.zeros((4, 12, 139), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="256 to 4096"):
        prach.detect(fd, flagship.PRACH, idft_size=8192)


def test_prach_detect_kernel_repeats(cuda):
    """K9 is deterministic: the same capture gives the same bits."""
    fd = torch.as_tensor(flagship.prach_capture(
        np.random.default_rng(2))).to(cuda)
    a, b = prach.detect(fd, flagship.PRACH), prach.detect(fd, flagship.PRACH)
    for key in ("metrics", "time_advance_s", "detected", "rssi"):
        assert torch.equal(getattr(a, key), getattr(b, key))


def test_prach_detect_kernel_in_a_cuda_graph(cuda):
    """K9's one launch captured in a CUDA graph and replayed on a new
    capture: the twin's result on that capture."""
    rng = np.random.default_rng(6)
    cfg = flagship.PRACH
    static = torch.as_tensor(flagship.prach_capture(rng)).to(cuda)
    prach.detect(static, cfg)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = prach.detect(static, cfg)
    static.copy_(torch.as_tensor(flagship.prach_capture(rng)).to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    _k9_hold(out, prach.detect_ref(static, cfg), flagship.PRACH_PREAMBLE)


def _f1_users(n_users):
    """The occasion's users: up to 12 on distinct cyclic shifts (the first
    three (0, 0, 1), (4, 1, 2), (8, 0, 1)), more over 7 OCCs."""
    if n_users <= 12:
        return flagship._f1_case_users(n_users)
    return tuple((u % 12, u // 12, 1 + u % 2) for u in range(n_users))


def _f1_case(n_users, hop, ports=4, nsym=14, seed=None):
    """(grid on the CPU, common, weights on the CPU) of one F1 occasion at
    PRB 0 ending at symbol 13: every user's random bits through a random
    gain a port, noise of variance 0.0025."""
    common = pucch.PucchF1Config(prb=0, start_symbol=14 - nsym,
                                 nof_symbols=nsym, initial_cyclic_shift=0,
                                 time_domain_occ=0, n_id=1, slot=4,
                                 second_hop_prb=hop)
    users = _f1_users(n_users)
    grid = torch.zeros((ports, 14, 3276), dtype=torch.complex64)
    rng = np.random.default_rng(n_users if seed is None else seed)
    for m0, occ, nbits in users:
        cfg = dataclasses.replace(common, initial_cyclic_shift=m0,
                                  time_domain_occ=occ, nof_harq_bits=nbits)
        one = pucch.transmit_format1(torch.zeros_like(grid), cfg,
                                     rng.integers(0, 2, nbits))[0]
        grid += _cgauss(rng, (ports,))[:, None, None] * one
    grid = grid + 0.05 * _cgauss(rng, grid.shape)
    weights = tuple(tuple(torch.as_tensor(w) for w in h)
                    for h in pucch.f1_batch_weights(common, users))
    return grid, common, weights


def _f1_hold(out, ref):
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    _close(out[1], ref[1], 1e-4)
    _close(out[3], ref[3], 1e-4)


@pytest.mark.parametrize("n_users,hop,ports,nsym", [
    (1, None, 4, 14), (3, 9, 4, 14), (12, 9, 4, 14), (64, None, 4, 14),
    (2, None, 8, 14), (5, 9, 8, 13), (4, 20, 4, 11)])
def test_pucch_f1_kernel(cuda, n_users, hop, ports, nsym):
    """K10 at 1 to 64 users, 4 and 8 ports, one hop or two (of 6 and 7
    symbols at 13, 5 and 6 at 11): decisions and bits equal to its
    twin's, metric and symbol within 1e-4; one launch a call."""
    grid, common, weights = _f1_case(n_users, hop, ports, nsym)
    grid = grid.to(cuda)
    weights = tuple(tuple(w.to(cuda) for w in h) for h in weights)
    kernels.reset_counts()
    out = pucch.f1_detect(grid, common, weights, 1.5)
    assert kernels.REGISTRY["pucch_f1_detect"].launches == 1
    ref = pucch.f1_detect_ref(grid, common, weights, 1.5)
    _f1_hold(out, ref)
    assert bool(out[0].all())
    _same_bits(out, pucch.f1_detect(grid, common, weights, 1.5))


def _same_bits(a, b):
    """Two calls' outputs bit-equal (the kernel sums in a fixed order)."""
    for x, y in zip(a, b):
        x = torch.view_as_real(x) if x.is_complex() else x
        y = torch.view_as_real(y) if y.is_complex() else y
        assert torch.equal(x, y)


def test_pucch_f1_kernel_in_a_cuda_graph(cuda):
    """K10's one launch captured in a CUDA graph (3 users, a hop) and
    replayed on a new grid: the twin's result on that grid."""
    grid, common, weights = _f1_case(3, 9)
    static = grid.to(cuda)
    weights = tuple(tuple(w.to(cuda) for w in h) for h in weights)
    pucch.f1_detect(static, common, weights, 1.5)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pucch.f1_detect(static, common, weights, 1.5)
    static.copy_(_f1_case(3, 9, seed=77)[0].to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    _f1_hold(out, pucch.f1_detect_ref(static, common, weights, 1.5))


def test_pucch_kernels_refuse_past_their_limits(cuda):
    """On the card a shape past K10's or K13's limits raises a ValueError
    naming the limit (no fallback to the twin): 9 ports, 65 users, an F2
    PDU of 17 RB x 2 symbols (544 bits)."""
    grid, common, weights = _f1_case(1, None)
    weights = tuple(tuple(w.to(cuda) for w in h) for h in weights)
    with pytest.raises(ValueError, match="1 to 8 ports"):
        pucch.f1_detect(torch.zeros((9, 14, 3276), dtype=torch.complex64,
                                    device=cuda), common, weights, 1.5)
    many = tuple(tuple(w.expand((65,) + w.shape[1:]).contiguous()
                       for w in h) for h in weights)
    with pytest.raises(ValueError, match="1 to 64 users"):
        pucch.f1_detect(grid.to(cuda), common, many, 1.5)
    cfg = _f2_cfg(17, 2)
    with pytest.raises(ValueError, match="at most 512 bits"):
        pucch.f2_demap(grid.to(cuda), torch.zeros(
            (4, 1, 1, 204), dtype=torch.complex64, device=cuda),
            torch.ones(4, device=cuda), cfg)


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


def _srs_grid(cfg, rng, nof_sc=3276):
    """A 4-port slot grid with the SRS of every port through a random
    4 x 4 channel and noise (26 dB a RE)."""
    tx = srs.map_to_grid(torch.zeros((4, 14, nof_sc), dtype=torch.complex64),
                         cfg)
    return (torch.einsum("rp,psk->rsk", _cgauss(rng, (4, 4)), tx)
            + 0.05 * _cgauss(rng, tx.shape))


@pytest.mark.parametrize("comb,ports,nsym,rb,cs", [
    (2, 1, 1, 4, 0), (4, 2, 2, 16, 5), (2, 2, 1, 48, 1), (2, 4, 2, 96, 7),
    (4, 4, 4, 272, 11), (2, 4, 4, 272, 3)])
def test_srs_noise_kernel_shapes(cuda, comb, ports, nsym, rb, cs):
    """K11 over combs 2 and 4, 1, 2 and 4 SRS ports and symbols, cyclic
    shifts, K = 24 to 1632 (1, 2, 4 and 8 warps a rx port), TA and RSRP
    from K8's twin (K8 takes no comb of 1632): within 1e-4 of its twin,
    one launch a call."""
    cfg = srs.SrsConfig(rb_start=272 - rb, rb_count=rb,
                        start_symbol=14 - nsym, nof_symbols=nsym, comb=comb,
                        comb_offset=comb - 1, cyclic_shift=cs,
                        nof_ports=ports, sequence_id=9, numerology=1)
    grid = _srs_grid(cfg, np.random.default_rng(rb + cs)).to(cuda)
    args, kw = srs.estimate_args(grid, cfg)
    est = chest.estimate_from_grid_ref(*args, **kw)
    kernels.reset_counts()
    out = srs.srs_noise(grid, cfg, est.time_alignment_s, est.rsrp)
    assert kernels.REGISTRY["srs_estimate"].launches == 1
    ref = srs.srs_noise_ref(grid, cfg, est.time_alignment_s, est.rsrp)
    for a, b in zip(out, ref):
        _close(a, b, 1e-4)


@pytest.fixture(scope="module")
def rs_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand kernels have no CPU mode)")
    return flagship.rs_profile_cases(torch.device("cuda"))


@pytest.mark.parametrize("name", [
    "srs_noise", "srs_noise_48rb", "srs_noise_k1632", "dmrs_map",
    "dmrs_map_prg", "dmrs_map_type0", "dmrs_map_interleaved",
    "dmrs_map_type2"])
def test_rs_profile_cases(rs_cases, name):
    """``flagship.rs_profile_cases``: K11 (the flagship SRS, 48 RB at comb
    4 with 4 SRS ports, K = 1632) within 1e-4 of its twin, K26 (the
    flagship PDSCH, 69 PRGs, slot E's type 0 PRBs, slot F's interleaved
    PRBs, type 2) bit-exact on copies of the grid; one launch a call."""
    fn, twin, args = rs_cases[name]
    kernels.reset_counts()
    if name.startswith("dmrs_map"):
        got = fn(args[0].clone(), *args[1:])
        assert torch.equal(got, twin(args[0].clone(), *args[1:]))
        assert kernels.REGISTRY["dmrs_map"].launches == 1
        return
    out = fn(*args)
    assert kernels.REGISTRY["srs_estimate"].launches == 1
    for a, b in zip(out, twin(*args)):
        _close(a, b, 1e-4)


def test_rs_kernels_in_a_cuda_graph(rs_cases):
    """K11 and K26 captured in one CUDA graph and replayed on new grids:
    the twins' results on them."""
    _, _, k11 = rs_cases["srs_noise"]
    _, _, k26 = rs_cases["dmrs_map_prg"]
    g11, g26 = k11[0].clone(), k26[0].clone()
    srs.srs_noise(g11, *k11[1:])
    dl_rs.dmrs_map(g26.clone(), *k26[1:])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = srs.srs_noise(g11, *k11[1:])
        dl_rs.dmrs_map(g26, *k26[1:])
    rng = np.random.default_rng(28)
    new11 = _srs_grid(flagship.SRS, rng).to(g11.device)
    new26 = _cgauss(rng, tuple(g26.shape)).to(g26.device)
    g11.copy_(new11)
    g26.copy_(new26)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, srs.srs_noise_ref(new11, *k11[1:])):
        _close(a, b, 1e-4)
    assert torch.equal(g26, dl_rs.dmrs_map_ref(new26, *k26[1:]))


def test_rs_kernels_refuse_on_the_card(cuda):
    """On CUDA tensors K11 and K26 raise a ValueError naming their limit:
    17 rx ports, a grid view that is not 16-byte aligned."""
    cfg = flagship.SRS
    grid = torch.zeros((17, 14, 3276), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="1 to 16"):
        srs.srs_noise(grid, cfg, torch.zeros((), device=cuda),
                      torch.ones(17, device=cuda))
    from srsran_tpu_torch.phy.upper import dmrs
    dcfg = dmrs.DmrsConfig(rb_start=0, rb_count=4, symbols=(2,), ports=(0,),
                           scrambling_id=1)
    buf = torch.zeros(4 * 14 * 48 + 1, dtype=torch.complex64, device=cuda)
    pil = torch.as_tensor(dmrs.pilot_values_for(dcfg)).to(cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dl_rs.dmrs_map(buf[1:].view(4, 14, 48), pil, None, (0,), (2,),
                       range(4))


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


def _f0_slot_grid(cfg, rng, ports, entry):
    """The dictionary entry ``entry`` of ``cfg`` sent on every port through
    a random gain, noise at -10 dB of it."""
    _, sr, harq = pucch._F0_TABLES[(cfg.nof_harq_bits,
                                    cfg.sr_opportunity)][entry]
    sent = pucch.transmit_format0(torch.zeros((1, 14, 3276),
                                              dtype=torch.complex64),
                                  cfg, harq, sr or 0)[0]
    return (_cgauss(rng, (ports,))[:, None, None] * sent
            + 0.3 * _cgauss(rng, (ports, 14, 3276)))


@pytest.mark.parametrize("ports,nsym,hop", [
    (1, 1, None), (1, 2, 272), (2, 2, 3), (8, 1, None), (8, 2, None),
    (8, 2, 0)])
def test_pucch_f0_kernel_shapes(cuda, ports, nsym, hop):
    """K12 at 1, 2 and 8 ports (lane groups of 1 to 16 rows), 1 and 2
    symbols, with and without a second hop: decisions equal to its twin's,
    the metric within 1e-4, one launch a call."""
    cfg = pucch.PucchF0Config(prb=269, start_symbol=14 - nsym,
                              nof_symbols=nsym, initial_cyclic_shift=3,
                              n_id=1, slot=6, nof_harq_bits=2,
                              sr_opportunity=True, second_hop_prb=hop)
    rng = np.random.default_rng(ports * nsym + (hop or 0))
    refs = torch.as_tensor(pucch.f0_refs_for(cfg)).to(cuda)
    for entry in (0, 3, 7):
        grid = _f0_slot_grid(cfg, rng, ports, entry).to(cuda)
        kernels.reset_counts()
        out = pucch.f0_detect(grid, cfg, refs, 4.0)
        assert kernels.REGISTRY["pucch_f0_detect"].launches == 1
        ref = pucch.f0_detect_ref(grid, cfg, refs, 4.0)
        for i in (0, 2, 3, 4):
            assert torch.equal(out[i], ref[i]), i
        _close(out[1], ref[1], 1e-4)
        assert int(out[4]) == entry


def test_pucch_f0_kernel_in_a_cuda_graph(cuda):
    """K12's one launch captured in a CUDA graph and replayed on a new
    grid with another entry sent: the twin's decisions on it."""
    cfg = pucch.PucchF0Config(prb=269, start_symbol=12, nof_symbols=2,
                              initial_cyclic_shift=3, n_id=1, slot=6,
                              nof_harq_bits=2, sr_opportunity=True)
    rng = np.random.default_rng(14)
    refs = torch.as_tensor(pucch.f0_refs_for(cfg)).to(cuda)
    grid = _f0_slot_grid(cfg, rng, 4, 1).to(cuda)
    pucch.f0_detect(grid, cfg, refs, 4.0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pucch.f0_detect(grid, cfg, refs, 4.0)
    grid.copy_(_f0_slot_grid(cfg, rng, 4, 6).to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    ref = pucch.f0_detect_ref(grid, cfg, refs, 4.0)
    for i in (0, 2, 3, 4):
        assert torch.equal(out[i], ref[i]), i
    assert int(out[4]) == 6


def _f2_cfg(nof_rb, nsym):
    """An F2 PDU ending at PRB 271 with 22 CSI bits (polar) where it has room
    for them (E >= 64), else 6 (short block)."""
    k = 22 if 16 * nof_rb * nsym >= 64 else 6
    return pucch.PucchF2Config(rb_start=271 - nof_rb + 1, nof_rb=nof_rb,
                               start_symbol=11, nof_symbols=nsym, rnti=0x19,
                               n_id=1, n_id0=1, nof_uci_bits=k, slot=2)


def _f2_grid(cfg, rng, ports=4):
    sent = pucch.transmit_format2(
        torch.zeros((1, 14, 3276), dtype=torch.complex64), cfg,
        rng.integers(0, 2, cfg.nof_uci_bits))[0]
    return (_cgauss(rng, (ports,))[:, None, None] * sent
            + 0.05 * _cgauss(rng, (ports, 14, 3276)))


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


def _f2_case(nof_rb, nsym, ports, rng, cuda):
    cfg = _f2_cfg(nof_rb, nsym)
    grid = _f2_grid(cfg, rng, ports).to(cuda)
    pil = torch.as_tensor(pucch.f2_pilot_values_for(cfg)).to(cuda)
    args, kw = pucch.f2_estimate_args(grid, cfg, pil)
    est = chest.estimate_from_grid_ref(*args, **kw)
    return grid, est.coeffs.contiguous(), est.noise_var, cfg


@pytest.mark.parametrize("nof_rb,nsym,ports", [
    (1, 2, 4), (2, 2, 4), (4, 1, 4), (16, 2, 4), (2, 2, 8), (16, 1, 8)])
def test_pucch_f2_demap_kernel(cuda, nof_rb, nsym, ports):
    """K13 at 1 to 16 RB, 1 and 2 symbols, 4 and 8 ports: the LLRs within
    1e-4 of its twin's; one launch a call."""
    case = _f2_case(nof_rb, nsym, ports, np.random.default_rng(10 + nof_rb),
                    cuda)
    kernels.reset_counts()
    out = pucch.f2_demap(*case)
    assert kernels.REGISTRY["pucch_f2_demap"].launches == 1
    _close(out, pucch.f2_demap_ref(*case), 1e-4)


def test_pucch_f2_demap_kernel_in_a_cuda_graph(cuda):
    """K13's one launch captured in a CUDA graph (16 RB) and replayed on a
    new grid, channel and noise: the twin's LLRs on them."""
    rng = np.random.default_rng(12)
    grid, coeffs, noise, cfg = _f2_case(16, 2, 4, rng, cuda)
    pucch.f2_demap(grid, coeffs, noise, cfg)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pucch.f2_demap(grid, coeffs, noise, cfg)
    for static, new in zip((grid, coeffs, noise),
                           _f2_case(16, 2, 4, rng, cuda)):
        static.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    _close(out, pucch.f2_demap_ref(grid, coeffs, noise, cfg), 1e-4)


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


@pytest.mark.parametrize("k", range(1, 12))
@pytest.mark.parametrize("qm,e", [(1, 37), (2, 512)])
def test_short_block_kernel_every_k(cuda, k, qm, e):
    """K14 at K = 1..11 (1 to 64 candidates a lane), E not a multiple of
    the period and E = 512: bits equal to its twin's, metric within 1e-5,
    a row of exact zeros to candidate 0, one launch a call."""
    rng = np.random.default_rng(1000 * qm + 10 * k + e)
    msg = torch.as_tensor(rng.integers(0, 2, (6, k)).astype(np.int8))
    cw = short_block.encode(msg, e, qm).numpy()
    llr = torch.as_tensor(((1.0 - 2.0 * cw) + rng.standard_normal(cw.shape)
                           ).astype(np.float32))
    llr[5] = 0.0
    llr = llr.to(cuda)
    kernels.reset_counts()
    bits, metric = short_block.detect(llr, k, qm)
    assert kernels.REGISTRY["short_block_detect"].launches == 1
    bits_ref, metric_ref = short_block.detect_ref(llr, k, qm)
    assert torch.equal(bits, bits_ref)
    _close(metric, metric_ref, 1e-5)
    assert not bits[5].any()


def test_short_block_kernel_in_a_cuda_graph(cuda):
    """K14's one launch captured in a CUDA graph (K = 6, E = 32, 5
    codewords: two CTAs) and replayed on new LLRs: the twin's bits."""
    rng = np.random.default_rng(15)

    def llrs():
        cw = short_block.encode(torch.as_tensor(
            rng.integers(0, 2, (5, 6)).astype(np.int8)), 32, 2).numpy()
        return torch.as_tensor(((1.0 - 2.0 * cw) + rng.standard_normal(
            cw.shape)).astype(np.float32)).to(cuda)

    llr = llrs()
    short_block.detect(llr, 6, 2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bits, metric = short_block.detect(llr, 6, 2)
    llr.copy_(llrs())
    graph.replay()
    torch.cuda.synchronize()
    bits_ref, metric_ref = short_block.detect_ref(llr, 6, 2)
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


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("k,e,crc_name", [(33, 64, "crc11"),
                                          (111, 1000, "crc11")])
def test_polar_decode_kernel_in_a_cuda_graph(cuda, b, k, e, crc_name):
    """K15's one launch for B codewords captured in a CUDA graph and
    replayed on new LLRs: the twin's bits and flags."""
    code = polar_params.polar_code(k, e, nmax=10, ibil=True)
    rng = np.random.default_rng(b + k)

    def llrs():
        msg = rng.integers(0, 2, (b, k)).astype(np.int8)
        x = polar.rate_match(polar.encode(polar.allocate(
            torch.as_tensor(msg), code), code.n), code).numpy()
        return torch.as_tensor(((1.0 - 2.0 * x) + 0.8 * rng.standard_normal(
            x.shape)).astype(np.float32))

    static = llrs().to(cuda)
    polar.decode(static, code, crc_name)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bits, ok = polar.decode(static, code, crc_name)
    static.copy_(llrs().to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    bits_ref, ok_ref = polar.decode_ref(static, code, crc_name)
    assert torch.equal(bits, bits_ref) and torch.equal(ok, ok_ref)


# The two-UE UL slot's kernels: K16 L x N equalize-demap, K17 UL-SCH / UCI
# demultiplex, K8 on DM-RS CDM group 1.

def _lxn_hold(out, ref):
    """K16 against its twin (an LDL^H solve against the twin's LU inverse):
    x within 1e-4 of max|x|, the LLRs within 1e-3 of max|LLR|, and equal
    hard decisions wherever |LLR| is above that."""
    (llr, x), (llr_ref, x_ref) = out, ref
    big = llr_ref.abs() > 1e-3 * float(llr_ref.abs().max())
    assert torch.equal(llr[big] > 0, llr_ref[big] > 0)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-3)


@pytest.mark.parametrize("modulation", ["qpsk", "qam256", "pi2bpsk",
                                        "bpsk", "qam16"])
@pytest.mark.parametrize("method", ["zf", "mmse"])
@pytest.mark.parametrize("layers", [1, 2, 3, 4])
def test_pusch_demap_lxn_kernel(cuda, layers, method, modulation):
    """K16 on a well-conditioned channel (I + 0.25 (N + jN) per subcarrier)
    at 24 RB, 4 ports: every layer count, both methods, the smallest and
    the largest constellation; each call adds one to K16's launch count."""
    rng = np.random.default_rng(layers * 10 + len(method) + len(modulation))
    h = np.eye(4, layers)[:, :, None, None] + 0.25 * _cgauss(
        rng, (4, layers, 1, 288)).numpy()
    coeffs = torch.as_tensor(h.astype(np.complex64)).to(cuda)
    grid = _cgauss(rng, (4, 14, 288)).to(cuda)
    sym, sc = pusch._plan(PUSCH, cuda)
    nv = torch.tensor(0.05, device=cuda)
    args = (grid, coeffs, sym, sc, 0, nv, 12345, modulation, layers, method)
    before = ul_demap.KERNEL_LXN.launches
    out = ul_demap.equalize_demap_descramble_lxn(*args)
    assert ul_demap.KERNEL_LXN.launches == before + 1
    _lxn_hold(out, ul_demap.equalize_demap_descramble_ref(*args))


def _lxn_args(cuda, rng, layers, method, modulation, zero_every=0,
              advance=0):
    h = np.eye(4, layers)[:, :, None, None] + 0.25 * _cgauss(
        rng, (4, layers, 1, 288)).numpy()
    if zero_every:
        h[..., ::zero_every] = 0
    coeffs = torch.as_tensor(h.astype(np.complex64)).to(cuda)
    grid = _cgauss(rng, (4, 14, 288)).to(cuda)
    sym, sc = pusch._plan(PUSCH, cuda)
    nv = torch.tensor(0.05, device=cuda)
    return (grid, coeffs, sym, sc, 0, nv, 12345, modulation, layers, method,
            advance)


@pytest.mark.parametrize("layers,method", [(1, "zf"), (1, "mmse"),
                                           (3, "mmse"), (4, "mmse")])
def test_pusch_demap_lxn_kernel_singular(cuda, layers, method):
    """K16 where every third subcarrier has no channel at all: the 1e12
    noise there (one layer, MMSE), the twin elsewhere."""
    args = _lxn_args(cuda, np.random.default_rng(70 + layers), layers,
                     method, "qam64", zero_every=3)
    out = ul_demap.equalize_demap_descramble_lxn(*args)
    ref = ul_demap.equalize_demap_descramble_ref(*args)
    _lxn_hold(out, ref)
    assert torch.equal(out[0] == 0, ref[0] == 0)


@pytest.mark.parametrize("advance", [0, 6, 7])
def test_pusch_demap_lxn_kernel_advance(cuda, advance):
    """K16 from a Gold offset (a hopping PUSCH's second hop; pi/2-BPSK's
    parity from it) and with odd spans, so the 16-byte stores start and
    end on scalars."""
    args = _lxn_args(cuda, np.random.default_rng(80 + advance), 3, "mmse",
                     "pi2bpsk", advance=advance)
    _lxn_hold(ul_demap.equalize_demap_descramble_lxn(*args),
              ul_demap.equalize_demap_descramble_ref(*args))


def test_pusch_demap_lxn_kernel_repeats(cuda):
    args = _lxn_args(cuda, np.random.default_rng(90), 4, "mmse", "qam256")
    a = ul_demap.equalize_demap_descramble_lxn(*args)
    b = ul_demap.equalize_demap_descramble_lxn(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_pusch_demap_lxn_kernel_in_a_cuda_graph(cuda):
    """K16's one launch captured in a CUDA graph and replayed on a new grid
    and channel: the twin's result on those."""
    rng = np.random.default_rng(91)
    args = _lxn_args(cuda, rng, 4, "mmse", "qam64")
    grid, coeffs = args[0], args[1]
    ul_demap.equalize_demap_descramble_lxn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ul_demap.equalize_demap_descramble_lxn(*args)
    new = _lxn_args(cuda, rng, 4, "mmse", "qam64")
    grid.copy_(new[0])
    coeffs.copy_(new[1])
    graph.replay()
    torch.cuda.synchronize()
    _lxn_hold(out, ul_demap.equalize_demap_descramble_ref(*args))


@pytest.mark.parametrize("layers,method,kernel", [
    (1, "zf", "KERNEL"), (2, "zf", "KERNEL"), (1, "mmse", "KERNEL_LXN"),
    (2, "mmse", "KERNEL_LXN"), (3, "zf", "KERNEL_LXN"),
    (4, "mmse", "KERNEL_LXN")])
def test_pusch_demap_routes(cuda, layers, method, kernel):
    """equalize_demap_descramble launches K3 for ZF with 1-2 layers and K16
    for the rest, as the JAX equalize dispatches."""
    rng = np.random.default_rng(layers)
    grid = _cgauss(rng, (4, 14, 288)).to(cuda)
    coeffs = (torch.as_tensor(np.eye(4, layers)[:, :, None, None]
                              .astype(np.complex64))
              + 0.25 * _cgauss(rng, (4, layers, 1, 288))).to(cuda)
    sym, sc = pusch._plan(PUSCH, cuda)
    nv = torch.tensor(0.05, device=cuda)
    args = (grid, coeffs, sym, sc, 0, nv, 7, "qam64", layers, method)
    counter = getattr(ul_demap, kernel)
    before = counter.launches
    out = ul_demap.equalize_demap_descramble(*args)
    assert counter.launches == before + 1
    _lxn_hold(out, ul_demap.equalize_demap_descramble_ref(*args))


def _uci_pusch(modulation, rate, tbs, o_ack, o_csi1, o_csi2=0):
    from srsran_tpu_torch.ran.uci_on_pusch import UciOnPuschConfig
    return pusch.PuschConfig(
        rnti=0x31, rb_start=0, rb_count=12, first_symbol=0, nof_symbols=14,
        modulation=modulation, target_code_rate=rate, tbs=tbs, nof_layers=1,
        n_id=3, dmrs_symbols=(2, 7, 11),
        uci=UciOnPuschConfig(o_ack=o_ack, o_csi1=o_csi1, o_csi2=o_csi2))


# tests/test_uci_on_pusch.py's UCI configurations, and UE B of the two-UE
# slot at its full width (64 RB, ACK 4, CSI1 8, CSI2 24).
DEMUX_CASES = {
    "rm_ack4": _uci_pusch("qam16", 0.4, 2152, 4, 0),
    "rm_ack4_csi7": _uci_pusch("qam16", 0.4, 2152, 4, 7),
    "rm_ack11_csi4": _uci_pusch("qam16", 0.4, 2152, 11, 4),
    "punct_ack1_qpsk": _uci_pusch("qpsk", 0.3, 1096, 1, 0),
    "placeholder_ack1_qam16": _uci_pusch("qam16", 0.4, 2152, 1, 0),
    "placeholder_ack2_csi2_qam64": _uci_pusch("qam64", 0.4, 3240, 2, 2),
    "part2": _uci_pusch("qam16", 0.4, 2152, 0, 4, 7),
    "ue_b": flagship.MU.ue_b(1),
}


@pytest.mark.parametrize("case", sorted(DEMUX_CASES))
def test_ulsch_demux_kernel(cuda, case):
    """K17: the four fields bit-exact against the twin's gathers."""
    from srsran_tpu_torch.ops import uci_demux
    cfg = DEMUX_CASES[case]
    dcfg = pusch.demux_plan(cfg)
    g = sum(dcfg.re_per_symbol) * dcfg.qm * dcfg.nof_layers
    llr = torch.as_tensor(np.random.default_rng(len(case)).standard_normal(
        g).astype(np.float32)).to(cuda)
    args = (llr, dcfg, cfg.uci.o_ack, cfg.uci.o_csi1,
            (cfg.rnti << 15) + cfg.n_id)
    before = uci_demux.KERNEL.launches
    out = uci_demux.demux(*args)
    assert uci_demux.KERNEL.launches == before + 1
    ref = uci_demux.demux_ref(*args)
    assert [o.numel() for o in out] == [r.numel() for r in ref]
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_channel_estimate_kernel_cdm_group1(cuda):
    """K8 on the second CDM group (delta 1, ports 2-3 with fd-OCC) of a
    4-layer PUSCH at 24 RB, read from the grid as pusch.estimate_channel
    does."""
    rng = np.random.default_rng(41)
    cfg = dataclasses.replace(PUSCH, nof_layers=4, slot_in_frame=3)
    grid = _cgauss(rng, (4, 14, 288)).to(cuda)
    args, kw = pusch.estimate_args(grid, cfg, None, (2, 3), 1)
    out = chest.estimate_from_grid(*args, **kw)
    ref = chest.estimate_from_grid_ref(*args, **kw)
    assert torch.equal(out.time_alignment_s.cpu(), ref.time_alignment_s.cpu())
    assert abs(float(out.cfo_hz) - float(ref.cfo_hz)) < 1e-2
    for key in ("coeffs", "noise_var", "rsrp", "epre", "snr"):
        _close(getattr(out, key), getattr(ref, key), 1e-4)


def test_empty_ul_results_lie_on_the_card(cuda):
    """An empty UL request through the conductor on the card: the empty
    packed results lie on cuda (pack_ul_results takes the conductor's
    device)."""
    from srsran_tpu_torch.fapi import conductor, messages
    from srsran_tpu_torch.phy.slot_programs import CellConfig
    cell = CellConfig(nof_ports=2, nof_rb=24, dft_size=512, numerology=1)
    c = conductor.SlotConductor(cell)
    rx = torch.zeros((2, cell.slot_samples(0)), dtype=torch.complex64,
                     device=cuda)
    pend = c.process_ul(messages.UlTtiRequest(
        slot=messages.SlotPoint(1, 4)), rx)
    assert pend.scalars.device.type == pend.payload.device.type == "cuda"
    assert not pend.resolve().crc


# ---------------------------------------------- K18, K19 (DFT-s-OFDM)

def _tp_case(rng, dev, modulation, method, hop, rb_count=6, ports=4,
             interpolate=False):
    """K18's inputs for a transform-precoded PUSCH on a random grid: the
    hops' estimates side by side (random), each hop's noise."""
    cfg = dataclasses.replace(
        flagship.EDGE.pusch_c, modulation=modulation, equalizer=method,
        rb_start=240 if hop else 0, rb_count=rb_count,
        second_hop_prb=256 if hop else None)
    nhops = 2 if hop else 1
    m = 12 * rb_count
    t = 14 if interpolate else 1
    grid = _cgauss(rng, (ports, 14, 3276)).to(dev)
    coeffs = _cgauss(rng, (ports, 1, t, nhops * m)).to(dev)
    noise = torch.as_tensor(rng.uniform(0.05, 0.2, (nhops, ports)).astype(
        np.float32)).to(dev)
    key = pusch._tp_key(cfg)
    plan = torch.as_tensor(pusch.tp_plan(key, 0)).to(dev)
    hops = torch.as_tensor(pusch.tp_plan(key, 1)).to(dev)
    return (grid, coeffs, plan, noise, hops, m, 0x19 << 15 | 1, modulation,
            method)


@pytest.mark.parametrize("modulation,method,hop,interpolate", [
    ("qpsk", "mmse", True, False), ("pi2bpsk", "zf", False, False),
    ("bpsk", "mmse", True, True), ("qam16", "zf", True, False),
    ("qam256", "mmse", False, True)])
def test_pusch_tp_demap_kernel(cuda, modulation, method, hop, interpolate):
    """K18 against its twin: x after the IDFT within 1e-4 and the LLRs
    within 1e-3 of their largest magnitude."""
    args = _tp_case(np.random.default_rng(len(modulation)), cuda, modulation,
                    method, hop, interpolate=interpolate)
    llr, x = ul_demap.tp_equalize_demap_descramble(*args)
    llr_ref, x_ref = ul_demap.tp_equalize_demap_descramble_ref(*args)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-3)


def test_pusch_tp_demap_kernel_widest(cuda):
    """K18 at M = 3240 (270 RB, the widest DFT-s-OFDM allocation of the
    flagship cell; above 48 KB of shared memory)."""
    args = _tp_case(np.random.default_rng(3240), cuda, "qam64", "zf", False,
                    rb_count=270)
    llr, x = ul_demap.tp_equalize_demap_descramble(*args)
    llr_ref, x_ref = ul_demap.tp_equalize_demap_descramble_ref(*args)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-3)


def _smooth(n):
    for f in (2, 3, 5):
        while n % f == 0:
            n //= f
    return n == 1


# Every DFT-s-OFDM allocation: n_RB = 2^a 3^b 5^c up to 273 (53 sizes).
TP_RB = tuple(n for n in range(1, 274) if _smooth(n))
TP_MODULATIONS = ("qpsk", "pi2bpsk", "qam16", "qam64", "qam256", "bpsk")


@pytest.mark.parametrize("i,rb", list(enumerate(TP_RB)))
def test_pusch_tp_demap_kernel_every_size(cuda, i, rb):
    """K18 at each of the 53 sizes M = 12 n_RB (the FFT's radix plans), a
    modulation and an equalizer each: x within 1e-4 and the LLRs within
    1e-3 of their largest magnitudes."""
    modulation = TP_MODULATIONS[i % len(TP_MODULATIONS)]
    method = ("zf", "mmse")[(i // 3) % 2]
    args = _tp_case(np.random.default_rng(1000 + rb), cuda, modulation,
                    method, False, rb_count=rb)
    llr, x = ul_demap.tp_equalize_demap_descramble(*args)
    llr_ref, x_ref = ul_demap.tp_equalize_demap_descramble_ref(*args)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-3)


def test_dft_s_ofdm_kernels_many_ports(cuda):
    """K18 at 1 RB, two hops of 32 ports (64 noise values, the most a
    launch reads, over a CTA of 32 threads) and K19 at 1 RB with 40 ports,
    against their twins."""
    rng = np.random.default_rng(64)
    args = _tp_case(rng, cuda, "qpsk", "mmse", True, rb_count=1, ports=32)
    llr, x = ul_demap.tp_equalize_demap_descramble(*args)
    llr_ref, x_ref = ul_demap.tp_equalize_demap_descramble_ref(*args)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-3)
    cfg = flagship.EDGE.f4
    grid = _cgauss(rng, (40, 14, 3276)).to(cuda)
    coeffs = _cgauss(rng, (40, 1, 1, 12)).to(cuda)
    noise = torch.as_tensor(rng.uniform(0.05, 0.2, 40).astype(np.float32)).to(
        cuda)
    _close(pucch.f3_demap(grid, coeffs, noise, cfg),
           pucch.f3_demap_ref(grid, coeffs, noise, cfg), 1e-3)


@pytest.mark.parametrize("occ", [1, 2, 4])
@pytest.mark.parametrize("nof_rb", [n for n in TP_RB if n <= 16])
def test_pucch_f3_demap_kernel_sizes(cuda, nof_rb, occ):
    """K19 at 1-16 RB (every DFT-s-OFDM size up to M = 192) with OCC 1, 2
    and 4, pi/2-BPSK and QPSK in turn (LLRs within 1e-3 of their largest
    magnitude)."""
    rng = np.random.default_rng(200 + nof_rb * occ)
    cfg = pucch.PucchF3Config(rb_start=10, nof_rb=nof_rb, start_symbol=0,
                              nof_symbols=14 - 2 * (nof_rb % 3),
                              rnti=0x1a, n_id=1, n_id_hopping=1,
                              nof_uci_bits=8, pi2_bpsk=bool(nof_rb % 2),
                              occ_length=occ, occ_index=occ - 1)
    m = 12 * nof_rb
    grid = _cgauss(rng, (4, 14, 480)).to(cuda)
    coeffs = _cgauss(rng, (4, 1, 1, m)).to(cuda)
    noise = torch.as_tensor(rng.uniform(0.05, 0.2, 4).astype(np.float32)).to(
        cuda)
    _close(pucch.f3_demap(grid, coeffs, noise, cfg),
           pucch.f3_demap_ref(grid, coeffs, noise, cfg), 1e-3)


def test_dft_s_ofdm_plans_under_cuda_graph(cuda):
    """K18 (M = 3240 and UE C's hopping M = 72) and K19 (the F4) launched
    from their cached plans inside a captured CUDA graph: replays on new
    inputs (copied in place) equal the twins and the eager calls, also
    after the plans have left their caches (the graph holds the parameter
    structs it launched with; the twiddle tables live for the process), and
    a non-contiguous input is copied, never read as laid out."""
    rng = np.random.default_rng(18)
    wide = _tp_case(rng, cuda, "qam64", "zf", False, rb_count=270)
    ue_c = _tp_case(rng, cuda, "qpsk", "mmse", True)
    f4 = flagship.EDGE.f4
    f4_in = (_cgauss(rng, (4, 14, 3276)).to(cuda),
             _cgauss(rng, (4, 1, 1, 12)).to(cuda),
             torch.full((4,), 0.1, device=cuda), f4)
    calls = (lambda: ul_demap.tp_equalize_demap_descramble(*wide),
             lambda: ul_demap.tp_equalize_demap_descramble(*ue_c),
             lambda: pucch.f3_demap(*f4_in))
    refs = (lambda: ul_demap.tp_equalize_demap_descramble_ref(*wide),
            lambda: ul_demap.tp_equalize_demap_descramble_ref(*ue_c),
            lambda: pucch.f3_demap_ref(*f4_in))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in calls]
    ul_demap._tp_plan.cache_clear()
    pucch._f3_plan.cache_clear()
    for seed in (19, 20):
        r = np.random.default_rng(seed)
        for t in (wide[0], wide[1], ue_c[0], ue_c[1], f4_in[0], f4_in[1]):
            t.copy_(_cgauss(r, tuple(t.shape)))
        eager = [f() for f in calls]
        graph.replay()
        torch.cuda.synchronize()
        for out, one, ref in zip(outs, eager, refs):
            want = ref()
            if isinstance(out, tuple):
                _close(out[1], want[1], 1e-4)
                _close(out[0], want[0], 1e-3)
            else:
                _close(out, want, 1e-3)
            for a, b in zip(out if isinstance(out, tuple) else (out,),
                            one if isinstance(one, tuple) else (one,)):
                assert torch.equal(a, b)
    # a transposed view of the grid: copied to a contiguous grid first
    grid_t = wide[0].transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not grid_t.is_contiguous()
    got = ul_demap.tp_equalize_demap_descramble(grid_t, *wide[1:])
    want = ul_demap.tp_equalize_demap_descramble(*wide)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nof_rb,occ,pi2,nsym", [
    (2, 1, True, 14), (3, 1, False, 10), (16, 1, False, 4), (1, 2, False, 12),
    (1, 4, True, 8)])
def test_pucch_f3_demap_kernel(cuda, nof_rb, occ, pi2, nsym):
    """K19 against its twin (LLRs within 1e-3 of their largest magnitude),
    F3 at 2, 3 and 16 RB, F4 with OCC 2 and 4."""
    rng = np.random.default_rng(nof_rb * occ)
    cfg = pucch.PucchF3Config(rb_start=10, nof_rb=nof_rb, start_symbol=14 - nsym,
                              nof_symbols=nsym, rnti=0x1a, n_id=1,
                              n_id_hopping=1, nof_uci_bits=8, pi2_bpsk=pi2,
                              occ_length=occ, occ_index=occ - 1)
    m = 12 * nof_rb
    grid = _cgauss(rng, (4, 14, 480)).to(cuda)
    coeffs = _cgauss(rng, (4, 1, 1, m)).to(cuda)
    noise = torch.as_tensor(rng.uniform(0.05, 0.2, 4).astype(np.float32)).to(
        cuda)
    _close(pucch.f3_demap(grid, coeffs, noise, cfg),
           pucch.f3_demap_ref(grid, coeffs, noise, cfg), 1e-3)


@pytest.mark.parametrize("nof_rb", [1, 2, 16])
def test_channel_estimate_kernel_stride1(cuda, nof_rb):
    """K8 at the F3/F4 shape: every subcarrier a pilot, the full-rate RC
    filter (band of width up to 31)."""
    rng = np.random.default_rng(nof_rb)
    cfg = pucch.PucchF3Config(rb_start=2, nof_rb=nof_rb, start_symbol=0,
                              nof_symbols=14, rnti=0x1a, n_id=1,
                              n_id_hopping=1, nof_uci_bits=8)
    grid = _cgauss(rng, (4, 14, 480)).to(cuda)
    pilots = torch.as_tensor(pucch.f3_dmrs_values_for(cfg)).to(cuda)
    args, kw = pucch.f3_estimate_args(grid, cfg, pilots)
    out = chest.estimate_from_grid(*args, **kw)
    ref = chest.estimate_from_grid_ref(*args, **kw)
    _close(out.coeffs, ref.coeffs, 1e-4)
    _close(out.noise_var, ref.noise_var, 1e-4)
    assert torch.equal(out.time_alignment_s.cpu(), ref.time_alignment_s.cpu())


@pytest.mark.parametrize("modulation", ["qam16", "bpsk", "pi2bpsk"])
def test_pusch_demap_gold_offset(cuda, modulation):
    """K3 and K16 descramble from a Gold offset (hop 2 of a hopping
    PUSCH); with BPSK the odd offset is an odd codeword symbol index, so
    pi/2-BPSK's derotation starts on the other parity."""
    rng = np.random.default_rng(11)
    grid = _cgauss(rng, (4, 14, 288)).to(cuda)
    coeffs = _cgauss(rng, (4, 1, 1, 288)).to(cuda)
    sym, sc = pusch._plan(PUSCH, cuda)
    nv = torch.tensor(0.05, device=cuda)
    for method in ("zf", "mmse"):
        args = (grid, coeffs, sym, sc, 0, nv, 12345, modulation, 1, method,
                7777)
        llr, x = ul_demap.equalize_demap_descramble(*args)
        llr_ref, x_ref = ul_demap.equalize_demap_descramble_ref(*args)
        _close(x, x_ref, 1e-4)
        _close(llr, llr_ref, 1e-3)


# ------------------------------------------ K20-K22 (the gNB simulator)

@pytest.mark.parametrize("profile,cfo,fading,r,k", [
    ("TDLA", 0.0, "rayleigh", 2, 288), ("TDLC", 600.0, "rayleigh", 2, 288),
    ("single-tap", 0.0, "rayleigh", 2, 288),
    ("TDLA", 0.0, "rayleigh", 4, 3276),           # the gNB simulator's
    ("TDLA", 0.0, "uniform-phase", 4, 3276),
    ("TDLB", 0.0, "rayleigh", 1, 3276),
    ("TDLC", 750.0, "uniform-phase", 1, 625)])    # odd K: 8-byte accesses
def test_tdl_channel_kernel(cuda, profile, cfo, fading, r, k):
    """K20 within 1e-5 of max|rx| and max|H| of its twin, and equal to
    itself run to run (the partial sums reduce in a fixed order)."""
    from srsran_tpu_torch.emulation import channel as chan
    cfg = chan.ChannelConfig(profile=profile, fading=fading, sinr_db=20.0,
                             cfo_hz=cfo, nof_tx_ports=4, nof_rx_ports=r,
                             nof_subc=k)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    gains, noise = chan.draw(cfg, gen)
    tx = _cgauss(np.random.default_rng(2), (4, 14, k)).to(cuda)
    rx, h = chan.apply(tx, cfg, gains, noise)
    rx_ref, h_ref = chan.apply_ref(tx, cfg, gains, noise)
    _close(h, h_ref, 1e-5)
    _close(rx, rx_ref, 1e-5)
    assert torch.equal(chan.apply(tx, cfg, gains, noise)[0], rx)


def test_tdl_channel_kernel_on_views(cuda):
    """K20 on inputs that are not 16-byte aligned (8-byte accesses) and on
    non-contiguous ones, against its twin."""
    from srsran_tpu_torch.emulation import channel as chan
    cfg = chan.ChannelConfig(profile="TDLA", sinr_db=15.0, nof_tx_ports=2,
                             nof_rx_ports=2, nof_subc=624)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    gains, noise = chan.draw(cfg, gen)
    buf = _cgauss(np.random.default_rng(4), (2 * 14 * 624 + 1,)).to(cuda)
    tx = buf[1:].view(2, 14, 624)                   # 8 bytes off
    wide = _cgauss(np.random.default_rng(5), (2, 14, 1248)).to(cuda)
    for x in (tx, wide[..., ::2]):
        rx, h = chan.apply(x, cfg, gains, noise)
        rx_ref, h_ref = chan.apply_ref(x, cfg, gains, noise)
        _close(h, h_ref, 1e-5)
        _close(rx, rx_ref, 1e-5)


def test_tdl_channel_kernel_on_two_streams(cuda):
    """One call signature on two streams at once, on grids of different
    power: every call brings its own partial sums, so every call gives
    the bits of the same call on the default stream."""
    from srsran_tpu_torch.emulation import channel as chan
    cfg = chan.ChannelConfig(profile="TDLA", sinr_db=28.0, nof_tx_ports=4,
                             nof_rx_ports=4, nof_subc=3276)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    gains, noise = chan.draw(cfg, gen)
    txs = [_cgauss(np.random.default_rng(12 + i), (4, 14, 3276)).to(cuda)
           * (1 + 3 * i) for i in range(2)]
    want = [chan.apply(tx, cfg, gains, noise)[0] for tx in txs]
    streams = [torch.cuda.Stream(cuda) for _ in txs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(16):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(chan.apply(txs[i], cfg, gains, noise)[0])
    torch.cuda.synchronize()
    for i in range(2):
        for out in outs[i]:
            assert torch.equal(out, want[i])


def test_tdl_channel_kernel_in_a_cuda_graph(cuda):
    """K20 (its two launches, the second a programmatic dependent launch)
    captured in a CUDA graph after one call on the current stream: each
    replay gives the bits of the eager call on the same inputs."""
    from srsran_tpu_torch.emulation import channel as chan
    cfg = chan.ChannelConfig(profile="TDLA", sinr_db=28.0, nof_tx_ports=4,
                             nof_rx_ports=4, nof_subc=3276)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(13)
    gains, noise = chan.draw(cfg, gen)
    tx = _cgauss(np.random.default_rng(14), (4, 14, 3276)).to(cuda)
    want = chan.apply(tx, cfg, gains, noise)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = chan.apply(tx, cfg, gains, noise)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tdl_channel_refuses_on_the_card(cuda):
    from srsran_tpu_torch.emulation import channel as chan
    cfg = chan.ChannelConfig(nof_tx_ports=9, nof_rx_ports=1, nof_subc=48)
    tx = torch.zeros((9, 14, 48), dtype=torch.complex64, device=cuda)
    gains = torch.zeros((1, 9, 12), dtype=torch.complex64, device=cuda)
    noise = torch.zeros((1, 14, 48), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="K20 takes 8 / 16"):
        chan.apply(tx, cfg, gains, noise)
    with pytest.raises(ValueError, match="complex64"):
        chan.apply(tx.to(torch.complex128), cfg, gains, noise)


@pytest.mark.parametrize("ports", [1, 4])
@pytest.mark.parametrize("fmt,fs,start,f_off,ra_scs", [
    ("B4", 512 * 30_000, 16, -144 * 30_000, 30_000),
    ("B4", 4096 * 30_000, 0, -1638 * 30_000, 30_000),
    ("B4", 4096 * 30_000, 7, -30_000, 30_000),           # b0 = N_u - 1
    ("B4", 6144 * 30_000, 5, -2000 * 30_000, 30_000),    # widest shared table
    ("B4", 8192 * 30_000, 0, -2000 * 30_000, 30_000),    # table read from L2
    ("0", 30_720_000, 3, -1638 * 30_000, 0),             # split-K
    ("0", 30_720_000, 0, 700 * 1250, 0)])                # b0 + k > N_u
def test_prach_demod_kernel(cuda, fmt, fs, start, f_off, ra_scs, ports):
    """K21 within 1e-4 of max|out| of its twin (cuBLAS on the card), and
    equal to itself run to run (split-K sums in a fixed order)."""
    from srsran_tpu_torch.phy.lower import prach_demod
    _, n_u, reps, _ = prach_demod.geometry(fmt, fs, f_off, ra_scs)
    x = _cgauss(np.random.default_rng(n_u), (ports, start + reps * n_u)).to(
        cuda)
    args = (x, fmt, fs, start, f_off, 1, ra_scs)
    out = prach_demod.demodulate(*args)
    _close(out, prach_demod.demodulate_ref(*args), 1e-4)
    assert torch.equal(prach_demod.demodulate(*args), out)


@pytest.mark.parametrize("ports,layers,prg", [(4, 2, 4), (2, 1, 2),
                                              (4, 4, 2)])
def test_pdsch_map_prg_kernel(cuda, ports, layers, prg):
    """K22 bit-exact to its twin, also with its table padded to 701 PRGs
    (any size: the kernel reads its rows through L1); with one PRG and the
    identity, to K6."""
    from srsran_tpu_torch.ran.precoding_codebooks import (PrecodingConfig,
                                                          nof_prgs)
    base = {(4, 2): 34, (2, 1): 2, (4, 4): 82}[(ports, layers)]
    n = nof_prgs(3, 20, prg)
    cfg = pdsch.PdschConfig(
        rnti=0x4601, rb_start=3, rb_count=20, first_symbol=1, nof_symbols=12,
        modulation="qam64", target_code_rate=0.6,
        tbs=tbs_calc(20, 12, 24, "qam64", 0.6, layers), nof_layers=layers,
        n_id=1, dmrs_symbols=(2, 11),
        precoding=PrecodingConfig(prg_size=prg, pm_indices=tuple(
            base + g % 4 for g in range(n))))
    rng = np.random.default_rng(ports + layers)
    tb = torch.as_tensor(rng.integers(0, 2, cfg.tbs).astype(np.int8)).to(cuda)
    cbs = ldpc_encode.dlsch_encode_ref(
        tb, pdsch.segmentation(cfg).base_graph).contiguous()
    grid = _cgauss(rng, (ports, 14, 288)).to(cuda)
    table = pdsch.pm_matrices_for(ports, cfg, cuda)
    args = pdsch.map_args(grid, cfg, cbs, table) + (prg, cfg.rb_start)
    out = dl_map.pdsch_map(grid.clone(), *args[1:])
    ref = dl_map.pdsch_map_ref(grid.clone(), *args[1:])
    assert torch.equal(out, ref)
    big = torch.cat([table, table.new_zeros((701 - n,) + table.shape[1:])])
    assert torch.equal(dl_map.pdsch_map(grid.clone(), *args[1:13], big,
                                        *args[14:]), out)
    w = pdsch.identity(ports, layers, cuda)
    k6 = pdsch.map_args(grid, dataclasses.replace(cfg, precoding=None), cbs,
                        w)
    one = dl_map.pdsch_map(grid.clone(), *k6[1:-1], w[None], 288, 0)
    assert torch.equal(one, dl_map.pdsch_map(grid.clone(), *k6[1:]))


def _bfp_grid(rng, shape):
    """Gaussian IQ with components past full scale, +-1.0, a value that
    rounds to -32768 and an all-zero PRB."""
    iq = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * 0.6
    iq = iq.astype(np.complex64)
    iq[0, 0, :4] = [1.0, -1.0 + 1j, -1.00001 - 1.00001j, 3.0 - 7.5j]
    iq[-1, -1, :12] = 0
    return torch.from_numpy(iq)


@pytest.mark.parametrize("width", range(1, 17))
def test_bfp_compress_kernel(cuda, width):
    """K23 bit-exact to its twin: exp, mant and the packed payload."""
    from srsran_tpu_torch.ofh import compression
    iq = _bfp_grid(np.random.default_rng(width), (2, 3, 12 * 37))
    got = compression.compress(iq.to(cuda), width, mantissas=True)
    want = compression.compress_ref(iq, width, mantissas=True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    payload = compression.compress(iq.to(cuda), width)
    assert payload[0] is None and torch.equal(payload[2].cpu(), want[2])


@pytest.mark.parametrize("width", range(1, 17))
def test_bfp_decompress_kernel(cuda, width):
    """K24 bit-exact to its twin, from (exp, mant) and from packed sections
    (255 + 18 PRB cuts, out of order, one row left untouched)."""
    from srsran_tpu_torch.ofh import compression
    iq = _bfp_grid(np.random.default_rng(width), (2, 3, 12 * 273))
    exp, mant, payload = compression.compress_ref(iq, width, mantissas=True)
    assert torch.equal(compression.bfp_decompress(exp.to(cuda),
                                                  mant.to(cuda)).cpu(),
                       compression.bfp_decompress_ref(exp, mant))
    r = compression.record_bytes(width)
    rows, chunks, off = [], [], 0
    for p, s in [(1, 2), (0, 0), (1, 0), (0, 2), (0, 1)]:
        for a, b in [(255, 273), (0, 255)]:
            chunks.append(payload[p, s, a:b].reshape(-1))
            rows.append((off, p, s, a, b - a, width))
            off += (b - a) * r
    buf = torch.cat(chunks)
    table = compression.section_table(rows)
    grid = torch.full((2, 3, 12 * 273), 2 + 2j, dtype=torch.complex64)
    want = compression.decompress_sections_ref(buf, table, grid.clone())
    got = compression.decompress_sections(buf.to(cuda), table, grid.to(cuda))
    assert torch.equal(got.cpu(), want)
    # the twin divides by 32767 as IEEE division on the card too
    twin = compression.decompress_sections_ref(buf.to(cuda), table,
                                               grid.to(cuda))
    assert torch.equal(twin.cpu(), want)


def _bfp_sections_case(width, rng, shape, runs):
    """(buf, table, grid of 2 + 2j): ``runs`` of every port and symbol of
    a packed grid at odd byte offsets, in a seeded order."""
    from srsran_tpu_torch import flagship
    from srsran_tpu_torch.ofh import compression
    iq = _bfp_grid(rng, shape)
    payload = compression.compress_ref(iq, width)[2].numpy()
    buf, rows = flagship._scattered_sections(payload, runs, width, rng)
    grid = torch.full(shape, 2 + 2j, dtype=torch.complex64)
    return torch.from_numpy(buf), compression.section_table(rows), grid


@pytest.mark.parametrize("width", range(1, 17))
@pytest.mark.parametrize("runs", [
    ((0, 1), (5, 7), (40, 18), (100, 1), (130, 7), (200, 18)),
    ((0, 255), (255, 18)), ((3, 33), (36, 32), (68, 31), (99, 64))])
def test_bfp_decompress_sections_shapes(cuda, width, runs):
    """K24 bit-exact to its twin on 1-, 7- and 18-PRB sections, RuOfh's
    255 + 18 cut and runs about a tile's 32 PRBs, at odd byte offsets,
    from a buffer that starts at an odd address; one launch each; REs of
    no section keep their values."""
    from srsran_tpu_torch.ofh import compression
    buf, table, grid = _bfp_sections_case(
        width, np.random.default_rng(width), (2, 3, 12 * 273), runs)
    want = compression.decompress_sections_ref(buf, table, grid.clone())
    odd = torch.cat([torch.zeros(1, dtype=torch.uint8), buf]).to(cuda)[1:]
    assert odd.data_ptr() & 15
    before = compression.KERNEL_DECOMPRESS.launches
    got = compression.decompress_sections(odd, table, grid.to(cuda))
    assert compression.KERNEL_DECOMPRESS.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_bfp_decompress_sections_past_one_launch(cuda):
    """1,344 one-PRB sections of widths 9 and 14 in one table: two launches
    (1,024 tiles, then 320), bit-exact to the twin."""
    from srsran_tpu_torch.ofh import compression
    rng = np.random.default_rng(7)
    parts = [_bfp_sections_case(w, rng, (2, 14, 12 * 24),
                                tuple((p, 1) for p in range(24)))
             for w in (9, 14)]
    rows, off = [], 0
    for port, (buf, table, _) in enumerate(parts):
        t = table.numpy().copy()
        t[:, 0] += off
        t[:, 1] += 2 * port
        rows.append(t)
        off += buf.numel()
    table = torch.from_numpy(np.concatenate(rows))
    buf = torch.cat([b for b, _, _ in parts])
    grid = torch.zeros((4, 14, 12 * 24), dtype=torch.complex64)
    want = compression.decompress_sections_ref(buf, table, grid.clone())
    before = compression.KERNEL_DECOMPRESS.launches
    got = compression.decompress_sections(buf.to(cuda), table, grid.to(cuda))
    assert compression.KERNEL_DECOMPRESS.launches == before + 2
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("width", [1, 9, 14, 16])
def test_bfp_kernels_on_views_and_batches(cuda, width):
    """K23 on a view that starts 8 bytes past an alignment and on a batch
    of two slots' grids; K24's (exp, mant) mode on the batch; all
    bit-exact to the twins."""
    from srsran_tpu_torch.ofh import compression
    iq = _bfp_grid(np.random.default_rng(width), (4, 14, 12 * 273)).reshape(
        2, 2, 14, -1)
    flat = iq.reshape(-1).to(cuda)
    view = flat[1:1 + 12 * 273 * 5].reshape(5, -1)
    assert view.data_ptr() & 15
    want = compression.compress_ref(view.cpu(), width, mantissas=True)
    for g, w in zip(compression.compress(view, width, mantissas=True), want):
        assert torch.equal(g.cpu(), w)
    exp, mant, payload = compression.compress(iq.to(cuda), width,
                                              mantissas=True)
    want = compression.compress_ref(iq, width, mantissas=True)
    for g, w in zip((exp, mant, payload), want):
        assert torch.equal(g.cpu(), w)
    got = compression.bfp_decompress(exp, mant)
    assert torch.equal(got.cpu(), compression.bfp_decompress_ref(*want[:2]))


def test_bfp_kernels_in_a_cuda_graph(cuda):
    """K23 and K24 captured in one CUDA graph and replayed on new grids."""
    from srsran_tpu_torch import flagship
    from srsran_tpu_torch.ofh import compression
    rng = np.random.default_rng(29)
    shape = (4, 14, 12 * 273)
    iq = _bfp_grid(rng, shape).to(cuda)
    table = compression.section_table(flagship.ofh_sections(4, 14, 273, 9))
    grid = torch.zeros(shape, dtype=torch.complex64, device=cuda)
    compression.decompress_sections(
        compression.compress(iq, 9)[2].reshape(-1), table, grid)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        payload = compression.compress(iq, 9)[2]
        compression.decompress_sections(payload.reshape(-1), table, grid)
    for seed in (1, 2):
        iq.copy_(_bfp_grid(np.random.default_rng(seed), shape).to(cuda))
        graph.replay()
        torch.cuda.synchronize()
        want = compression.compress_ref(iq.cpu(), 9)[2]
        assert torch.equal(payload.cpu(), want)
        assert torch.equal(grid.cpu(), compression.decompress_sections_ref(
            want.reshape(-1), table, torch.zeros(shape,
                                                 dtype=torch.complex64)))


def test_ru_ofh_on_the_card(cuda):
    """RuOfh on the card writes the CPU RuOfh's frames and returns its
    grid; K23 and K24 launch once per grid."""
    from srsran_tpu_torch import kernels
    from srsran_tpu_torch.ru import ofh
    iq = _bfp_grid(np.random.default_rng(0), (2, 14, 12 * 273))
    cables, grids = [], []
    kernels.reset_counts()
    for dev in (cuda, "cpu"):
        cable = ofh.InMemoryCable()
        du = ofh.RuOfh(cable.endpoint_a(), 2, 273, device=dev)
        ru = ofh.RuOfh(cable.endpoint_b(), 2, 273, device=dev)
        du.send_dl_grid(iq.to(dev), slot=1)
        cables.append(list(cable.a_to_b))
        grids.append(ru.receive_ul_grid(14).cpu())
    assert cables[0] == cables[1]
    assert torch.equal(grids[0], grids[1])
    counts = {k.name: k.launches for k in kernels.REGISTRY.values()}
    assert counts["bfp_compress"] == 1 and counts["bfp_decompress"] == 1


# -------------------------------------------- K25-K27 (the DU-low's DL)

def _du_case(name, cuda):
    from srsran_tpu_torch import flagship
    return flagship.du_kernel_cases(np.random.default_rng(25), cuda)[name]


@pytest.mark.parametrize("name", [
    "rs_map", "rs_map_trs", "rs_map_prs", "rs_map_many", "rs_map_terms",
    "dmrs_map",
    "dmrs_map_matrix", "dmrs_map_prg", "control_map", "control_map_al1",
    "control_map_al2", "control_map_al4", "control_map_al16",
    "control_map_ssb_static", "control_map_many", "control_map_overlap"])
@pytest.mark.parametrize("batch", ["", "_b4"])
def test_dl_map_kernels_bit_exact(cuda, name, batch):
    """K25 (CSI-RS + PT-RS, TRS + PT-RS, PRS, 33 CSI-RS in two launches,
    targets of 1-3 terms at odd offsets),
    K26 (identity, a [4, 4] matrix, 69 PRG matrices) and K27 (SSB + PDCCH,
    each aggregation level, the SSB without its slot context, the SSB and
    17 DCIs in two launches) at the flagship shapes, bit-exact to their
    twins on the card, with and without a slot axis."""
    kernel, ref, args = _du_case(name + batch, cuda)
    got, want = kernel(*args), ref(*args)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["rs_map", "dmrs_map_prg", "control_map",
                                  "rs_map_many", "rs_map_terms",
                                  "control_map_many", "control_map_overlap"])
def test_dl_map_kernels_slot_axis(cuda, name):
    """B = 4 in one launch equals four B = 1 launches on each slot's
    inputs (the slot axis reads the per-slot strides)."""
    from srsran_tpu_torch import flagship
    kernel, _, args = _du_case(name + "_b4", cuda)
    got = kernel(*args)
    for b in range(4):
        assert torch.equal(got[b], kernel(*flagship.du_slot_of(name, args, b)))


def _int_bits(t):
    return torch.view_as_real(t).view(torch.int32).cpu()


@pytest.mark.parametrize("name", ["control_map", "control_map_many",
                                  "control_map_overlap",
                                  "control_map_negzero"])
def test_control_map_bitwise(cuda, name):
    """K27 equal to its twins bit for bit, -0.0 apart from +0.0: the
    many-UE slot, two PDCCHs sharing REs across tiles, and a grid of -0.0,
    which the twins' dense adds turn to +0.0 under every hole of a patch
    rectangle (the hole rule)."""
    kernel, ref, args = _du_case(name, cuda)
    got, want = kernel(*args), ref(*args)
    assert torch.equal(_int_bits(got), _int_bits(want))
    if name == "control_map_negzero":
        assert not torch.equal(_int_bits(got), _int_bits(args[0]))


@pytest.mark.parametrize("name", ["control_map", "control_map_many"])
def test_control_map_converted_inputs(cuda, name):
    """K27 on payloads and SSB context that are not int8 (int64, as
    ``pdcch.process`` takes them) and pilots with a stride of 2: each PDU
    reads its own converted copy (the copies live until the launches are
    queued), bit for bit equal to the twins on the int8 inputs, on a plan
    miss and on a hit; slot A's SSB and AL8 PDCCH, and the SSB with 17
    DCIs in two launches."""
    from srsran_tpu_torch.ops import dl_control
    kernel, ref, (grid, inputs, items) = _du_case(name, cuda)
    wide = {k: v.to(torch.int64) if v.dtype == torch.int8
            else torch.stack([v, v], -1)[..., 0] for k, v in inputs.items()}
    want = _int_bits(ref(grid, inputs, items))
    with dl_control._LOCK:
        dl_control._PLANS.clear()
    for _ in range(2):
        assert torch.equal(_int_bits(kernel(grid, wide, items)), want)


def test_control_map_graph_replay(cuda):
    """A K27 launch (slot A's SSB and AL8 PDCCH) captured in a CUDA graph
    and replayed on new payloads, context and pilots copied into the
    captured inputs equals eager K27 on those inputs, three times."""
    from srsran_tpu_torch.ops import dl_control
    _, _, (grid, inputs, items_fn) = _du_case("control_map", cuda)
    static = {k: v.clone() for k, v in inputs.items()}
    out = grid.clone()
    items = items_fn(out, static)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                   # warm: the plan
        out.copy_(grid)
        dl_control.control_map(out, items)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(grid)
        dl_control.control_map(out, items)
    rng = np.random.default_rng(19)
    for _ in range(3):
        new = {k: (torch.as_tensor(rng.integers(0, 2, v.shape).astype(
                       np.int8)).to(cuda) if v.dtype == torch.int8 else
                   v * torch.as_tensor(np.exp(1j * rng.uniform(0, 6, v.shape))
                                       .astype(np.complex64)).to(cuda))
               for k, v in inputs.items()}
        for k, v in new.items():
            static[k].copy_(v)
        graph.replay()
        want = grid.clone()
        dl_control.control_map(want, items_fn(want, new))
        torch.cuda.synchronize()
        assert torch.equal(_int_bits(out), _int_bits(want))


def test_du_low_dl_slot_launches(cuda):
    """A DU-low slot of each kind through the port's conductor on the
    card: samples equal the CPU conductor's within 1e-4 of max|ref|, and
    K25-K27 launch in the slots that carry their PDUs."""
    from srsran_tpu_torch import flagship, kernels
    from srsran_tpu_torch.fapi.conductor import SlotConductor
    pay = flagship.dl_payloads(np.random.default_rng(0))
    gpu = SlotConductor(flagship.CELL, device=cuda)
    cpu = SlotConductor(flagship.CELL, device="cpu")
    for i in range(4):
        dl, tx = flagship.du_dl_request(i), flagship.du_tx_request(i, pay)
        kernels.reset_counts()
        got, _ = gpu.process_dl(dl, tx, return_grid=False)
        torch.cuda.synchronize()
        n = {k.name: k.launches for k in kernels.REGISTRY.values()}
        want, _ = cpu.process_dl(dl, tx, return_grid=False)
        _close(got, want, 1e-4)
        kind = flagship.du_kind(i)
        assert n["rs_map"] == (kind != "D")
        assert n["control_map"] == (kind != "D")
        assert n["dmrs_map"] == (kind in "AB")


def test_du_low_many_dcis(cuda):
    """A DL_TTI of the SSB and 17 DCIs (more than one K27 launch takes)
    through the port's conductor on the card: two K27 launches, samples
    equal the CPU conductor's within 1e-4 of max|ref|."""
    from srsran_tpu_torch import flagship, kernels
    from srsran_tpu_torch.fapi.conductor import SlotConductor
    dl, tx = flagship.du_many_request(
        flagship.dl_payloads(np.random.default_rng(0)), 2)
    gpu = SlotConductor(flagship.CELL, device=cuda)
    kernels.reset_counts()
    got, _ = gpu.process_dl(dl, tx, return_grid=False)
    torch.cuda.synchronize()
    assert kernels.REGISTRY["control_map"].launches == 2
    want, _ = SlotConductor(flagship.CELL, device="cpu").process_dl(
        dl, tx, return_grid=False)
    _close(got, want, 1e-4)


# ------------- the DU-low's allocations: K2, K6, K15, K22, K26, K28 (PR 11)

@pytest.fixture(scope="module")
def alloc_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand kernels have no CPU mode)")
    from srsran_tpu_torch import flagship
    return flagship.alloc_kernel_cases(np.random.default_rng(28),
                                       torch.device("cuda"))


@pytest.mark.parametrize("name", [
    "control_llrs", "control_llrs_many", "dmrs_map_type0",
    "dmrs_map_interleaved", "dmrs_map_type2", "rate_dematch_type0",
    "rate_dematch_nref", "polar_decode_al16", "polar_decode_pbch"])
def test_alloc_kernels_against_twins(alloc_cases, name):
    """K28 (slot E's DCIs and PBCH; 17 DCIs and the PBCH), K26 (type 0
    with 61 PRG matrices, interleaved, type 2 on ports 0, 1, 4, 5), K2
    (slot E's G, a limited buffer) and K15 (an AL16 DCI with its syndrome,
    the PBCH) at the flagship shapes: bit-exact to their twins (K22 and
    K6 at slot E's and F's plans and with a limited buffer are
    ``K6_CASES``)."""
    kernel, ref, args = alloc_cases[name]
    got, want = kernel(*args), ref(*args)
    if isinstance(got, tuple):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("where", ["before", "inside", "after"])
def test_limited_buffer_kernels(cuda, where):
    """K2 and K6 with n_ref cutting the circular buffer before, inside and
    after the filler range (BG1, Z 64, K' 1280): bit-exact to their twins,
    K2's columns n_cb .. N-1 at 0 and its filler range at 1e4."""
    z, kp, c, qm, nl = 64, 64 * 20, 3, 4, 2
    k, n = 22 * z, 64 * z
    n_ref = {"before": kp - 2 * z - 50, "inside": kp - 2 * z + 40,
             "after": 3 * n // 4}[where]
    e = [qm * nl * 500] * c
    rng = np.random.default_rng(len(where))
    llr = torch.as_tensor(rng.standard_normal(sum(e)).astype(np.float32)
                          ).to(cuda)
    for rv in (0, 2):
        args = (llr, c, e, rv, qm, 1, z, kp, k, n, None, n_ref)
        got = ldpc_rate_match.rate_dematch_combine(*args)
        want = ldpc_rate_match.rate_dematch_combine_ref(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        fs, fe, n_nf, _ = ldpc_rate_match._window_plan(rv, 1, z, kp, k, n,
                                                       n_ref)
        assert not got[0][:, n_nf + fe - fs:].any()
        assert bool((got[0][:, fs:fe] == ldpc_rate_match.FILLER_LLR).all())
    cbs = torch.as_tensor(rng.integers(0, 2, (c, n)).astype(np.int8)).to(cuda)
    nre = sum(e) // (qm * nl)
    sym = torch.as_tensor(np.repeat(np.arange(14), 300)[:nre].astype(
        np.int32)).to(cuda)
    sc = torch.as_tensor(np.tile(np.arange(300), 14)[:nre].astype(
        np.int32)).to(cuda)
    grid = _cgauss(rng, (4, 14, 300)).to(cuda)
    w = _cgauss(rng, (4, nl)).to(cuda)
    margs = (cbs, e, 2, "qam16", 1, z, kp, k, 0x1234, nl, sym, sc, w, 0, 0,
             n_ref)
    _close(dl_map.pdsch_map(grid.clone(), *margs),
           dl_map.pdsch_map_ref(grid.clone(), *margs), 1e-6)


@pytest.mark.parametrize("layers", [1, 2, 4])
@pytest.mark.parametrize("precoder", ["none", "matrix", "prg"])
def test_dmrs_type2_and_prb_list_kernel(cuda, layers, precoder):
    """K26 with type 2 on ports (0, 1, 4, 5)[:L] and with type 1 on a
    scattered PRB list, bit-exact to its twin."""
    from srsran_tpu_torch.ops import dl_rs
    from srsran_tpu_torch.phy.upper import dmrs
    rng = np.random.default_rng(layers)
    grid = _cgauss(rng, (4, 14, 24 * 12)).to(cuda)
    for cfg in (dmrs.DmrsConfig(rb_start=2, rb_count=20, symbols=(2, 11),
                                ports=(0, 1, 4, 5)[:layers], scrambling_id=3,
                                config_type=2),
                dmrs.DmrsConfig(rb_start=1, rb_count=22, symbols=(2, 7),
                                ports=tuple(range(layers)), scrambling_id=3,
                                prbs=(1, 4, 5, 9, 13, 20, 21, 22))):
        prbs = cfg.prb_list
        pil = torch.as_tensor(dmrs.pilot_values_for(cfg)).to(cuda)
        w, prg = None, 0
        if precoder == "matrix":
            w = _cgauss(rng, (4, layers)).to(cuda)
        elif precoder == "prg":
            prg = 4
            w = _cgauss(rng, (prbs[-1] // 4 - prbs[0] // 4 + 1, 4, layers)
                        ).to(cuda)
        args = (pil, w, cfg.ports, cfg.symbols, prbs, prg, cfg.config_type)
        assert torch.equal(dl_rs.dmrs_map(grid.clone(), *args),
                           dl_rs.dmrs_map_ref(grid.clone(), *args))


def test_du_low_alloc_slots(cuda):
    """DU-low slots E and F through the port's conductor on the card:
    samples within 1e-4 of max|ref| of the CPU conductor's, K22, K6, K26
    launched; the UE side decodes every DCI and the PBCH (K4, K28, K15)
    with their exact payloads; slot G is rejected by the validator."""
    from srsran_tpu_torch import flagship, kernels
    from srsran_tpu_torch.fapi.conductor import SlotConductor
    from srsran_tpu_torch.fapi.validators import ValidationError
    from srsran_tpu_torch.phy.upper import ssb
    pay = flagship.du_alloc_payloads(np.random.default_rng(11))
    gpu = SlotConductor(flagship.CELL, device=cuda)
    cpu = SlotConductor(flagship.CELL, device="cpu")
    for kind, count in (("E", 2), ("F", 4)):
        dl, tx = flagship.du_alloc_request(kind, count, pay)
        kernels.reset_counts()
        got, _ = gpu.process_dl(dl, tx, return_grid=False)
        dcis, pbch = flagship.du_control_rx(got, dl)
        torch.cuda.synchronize()
        n = {k.name: k.launches for k in kernels.REGISTRY.values()}
        assert n["pdsch_map_prg" if kind == "E" else "pdsch_map"] == 1
        assert n["dmrs_map"] == 1 and n["control_llrs"] == 1
        assert n["polar_decode"] == len(dl.pdcch) + len(dl.ssb)
        want, _ = cpu.process_dl(dl, tx, return_grid=False)
        _close(got, want, 1e-4)
        sent = pay["dci"][:len(dl.pdcch)] if kind == "E" else pay["dci"][-1:]
        for (bits, ok), d in zip(dcis, sent):
            assert bool(ok) and np.array_equal(bits.cpu().numpy(), d)
        for (a, ok), cfg in zip(pbch, dl.ssb):
            assert bool(ok)
            assert np.array_equal(ssb.pbch_extract_mib(a, cfg), pay["mib"])
    dl, tx = flagship.du_alloc_request("G", 6, pay)
    with pytest.raises(ValidationError, match="PT-RS"):
        gpu.process_dl(dl, tx)


# The split-8 slice's kernels: K29 CA-SCL list decoding, K30 CFO, K31
# amplitude control, K32 LDPC rate match (bits out).

@pytest.mark.parametrize("k,e,nmax,ibil,n_pc,size,crc_name", [
    (56, 864, 9, False, 0, 8, "crc24C"), (40, 100, 9, False, 0, 8, None),
    (18, 60, 10, True, 3, 4, None), (25, 64, 9, False, 0, 1, "crc11"),
    (100, 1024, 10, False, 0, 8, "crc11"), (39, 108, 9, False, 0, 2, None)])
def test_polar_scl_kernel(cuda, k, e, nmax, ibil, n_pc, size, crc_name):
    """K29 bit-exact to its twin (messages and ok), N from 64 to 1024,
    with exact-zero LLRs and an all-zero row."""
    from srsran_tpu_torch.ops import polar_scl
    code = polar_params.polar_code(k, e, nmax=nmax, ibil=ibil, n_pc=n_pc)
    rng = np.random.default_rng(k + e + size)
    msg = rng.integers(0, 2, (12, k)).astype(np.int8)
    x = polar.rate_match(polar.encode(polar.allocate(torch.as_tensor(msg),
                                                     code), code.n),
                         code).numpy()
    llr = ((1.0 - 2.0 * x) + 1.0 * rng.standard_normal(x.shape)
           ).astype(np.float32)
    llr[1, ::3] = 0.0
    llr[5] = 0.0
    lm = polar.rate_dematch(torch.as_tensor(llr), code).to(cuda)
    got = polar_scl.scl_decode(lm, code, size, crc_name)
    ref = polar_scl.scl_decode_ref(lm, code, size, crc_name)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
@pytest.mark.parametrize("bg,z,k_prime,n_ref,e_sizes,qm", [
    (1, 384, 8000, 0, (25344, 25344, 25350), 6),
    (2, 16, 150, 0, (2400,), 4), (1, 24, 520, 1000, (2598, 2604), 6),
    (2, 16, 150, 0, (2400, 2404, 2404, 2400), 4),
    (1, 384, 8000, 3 * 66 * 384 // 4, (25344,), 6)])
def test_rate_match_kernel(cuda, rv, bg, z, k_prime, n_ref, e_sizes, qm):
    """K32 bit-exact to its twin, over whole TBs (E in up to three runs)
    and one codeblock, with filler bits and a limited buffer."""
    k = (22 if bg == 1 else 10) * z
    n = (66 if bg == 1 else 50) * z
    cw = torch.as_tensor(np.random.default_rng(rv).integers(
        0, 2, (len(e_sizes), n)).astype(np.int8)).to(cuda)
    args = (e_sizes, rv, qm, bg, z, k_prime, k, n_ref)
    assert torch.equal(ldpc_rate_match.rate_match_batch(cw, *args),
                       ldpc_rate_match.rate_match_batch_ref(cw, *args))
    one = ldpc_rate_match.rate_match(cw[:1], e_sizes[0], *args[1:])
    assert torch.equal(one[0], ldpc_rate_match.rate_match_batch_ref(
        cw[:1], e_sizes[:1], *args[1:]))


def test_launch_plans_under_cuda_graph(cuda):
    """K32's and K21's cached plans in a captured CUDA graph (on PyTorch's
    capture stream): replays after the inputs change in place equal the
    twins, also once every plan has been dropped from its cache (the
    graph holds the parameters it launched with, the twiddle table lives
    for the process), and eager calls between replays count launches."""
    from srsran_tpu_torch.phy.lower import prach_demod
    rng = np.random.default_rng(5)
    rm = (3 * (6336,), 0, 2, 1, 24, 400, 528, 0)
    cw = torch.as_tensor(rng.integers(0, 2, (3, 66 * 24)).astype(
        np.int8)).to(cuda)
    pr = ("B4", 4096 * 30_000, 3, -1638 * 30_000, 1, 30_000)
    x = _cgauss(rng, (4, 3 + 12 * 4096)).to(cuda)
    fmt0 = ("0", 30_720_000, 0, 700 * 1250, 1, 0)
    y = _cgauss(rng, (1, 24_576)).to(cuda)
    calls = (lambda: ldpc_rate_match.rate_match_batch(cw, *rm),
             lambda: prach_demod.demodulate(x, *pr),
             lambda: prach_demod.demodulate(y, *fmt0))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in calls]
    ldpc_rate_match._rate_match_plan.cache_clear()
    prach_demod._demod_plan.cache_clear()
    for seed in (6, 7):
        r = np.random.default_rng(seed)
        cw.copy_(torch.as_tensor(r.integers(0, 2, tuple(cw.shape)).astype(
            np.int8)))
        x.copy_(_cgauss(r, tuple(x.shape)))
        y.copy_(_cgauss(r, tuple(y.shape)))
        before = prach_demod.KERNEL.launches
        eager = [f() for f in calls]
        assert prach_demod.KERNEL.launches == before + 2
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(outs[0], ldpc_rate_match.rate_match_batch_ref(
            cw, *rm))
        assert torch.equal(outs[0], eager[0])
        _close(outs[1], prach_demod.demodulate_ref(x, *pr), 1e-4)
        _close(outs[2], prach_demod.demodulate_ref(y, *fmt0), 1e-4)
        assert torch.equal(outs[1], eager[1]) and torch.equal(outs[2],
                                                              eager[2])


@pytest.mark.parametrize("cfo_hz,offset", [(370.0, 0), (-7e3, 2 ** 24 + 9)])
def test_cfo_kernel(cuda, cfo_hz, offset):
    """K30 within 1e-6 of its twin (sincosf against sin and cos)."""
    from srsran_tpu_torch.phy.lower import cfo
    x = _cgauss(np.random.default_rng(1), (4, 61440)).to(cuda)
    c = cfo_hz / 122.88e6
    _close(cfo.apply_cfo(x, c, offset), cfo.apply_cfo_ref(x, c, offset), 1e-6)


@pytest.mark.parametrize("gain_db,ceiling_dbfs", [(0.0, 0.0), (0.0, 9.5),
                                                  (-3.0, None)])
def test_amplitude_kernel(cuda, gain_db, ceiling_dbfs):
    """K31: samples within 1e-6 of the twin's, peak and clipped share
    equal, average power within 1e-5 dB."""
    from srsran_tpu_torch.phy.lower import amplitude_control as amp
    x = _cgauss(np.random.default_rng(2), (4, 61440)).to(cuda)
    if ceiling_dbfs is None:
        got, m = amp.scale(x, gain_db)
        ref, r = amp.clip_ref(x, gain_db, float("inf"))
    else:
        got, m = amp.clip(x, gain_db, ceiling_dbfs)
        ref, r = amp.clip_ref(x, gain_db, ceiling_dbfs)
    _close(got, ref, 1e-6)
    assert float(m.clipped_ratio) == float(r.clipped_ratio)
    assert abs(float(m.peak_power_db) - float(r.peak_power_db)) < 1e-6
    assert abs(float(m.avg_power_db) - float(r.avg_power_db)) < 1e-5
