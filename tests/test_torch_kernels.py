"""The hand kernels against their plain twins, on a CUDA GPU.

Each case builds the kernel library, runs a kernel wrapper on CUDA tensors
and its twin on the same inputs, at the small PUSCH's and PDSCH's shapes.  On a machine
without a GPU every case skips (the twins are covered by the parity tests
against the JAX package).  ``python3 chip_smoke.py`` runs the same checks at
the flagship shapes.
"""

import numpy as np
import pytest
import torch

from srsran_tpu.ran.ldpc_params import segment_tb, select_base_graph
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc

from srsran_tpu_torch.ops import (crc, dl_map, ldpc_decode, ldpc_encode,
                                  ldpc_rate_match, ofdm, ul_demap)
from srsran_tpu_torch.phy.upper import pdsch, pusch

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
