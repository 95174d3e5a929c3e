"""The slot-batch forms of K1-K8 and the conductor's CUDA graphs, on a CUDA
GPU.

Each batched kernel runs on B slots of seeded inputs at the small PUSCH's
and PDSCH's shapes and is held against its plain twin (which runs slot by
slot), at B = 1 and B = 4; at B = 1 it must also give the unbatched
kernel's output.  The conductor's ``process_slot`` (one CUDA graph per slot
phase) is held against the phase's eager slot program over three slots with
differing payloads and samples, and ``process_slot_batch`` against
``process_slot``.  On a machine without a GPU every case skips (the twins
are covered by tests/test_torch_batch.py against the JAX package); on the
card run ``python -m pytest --noconftest tests/test_torch_batch_kernels.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.fapi import messages as msgs
from srsran_tpu_torch.ops import channel_estimate as chest
from srsran_tpu_torch.ops import (dl_map, ldpc_decode, ldpc_encode,
                                  ldpc_rate_match, ofdm, ul_demap)
from srsran_tpu_torch.phy.slot_programs import CellConfig
from srsran_tpu_torch.phy.upper import dmrs, pdcch, pdsch, pucch, pusch
from srsran_tpu_torch.ran.slot_point import SlotPoint

torch.set_num_threads(2)
pytestmark = pytest.mark.gpu

PUSCH = pusch.PuschConfig(rnti=0x17, rb_start=0, rb_count=24, first_symbol=0,
                          nof_symbols=14, modulation="qam64",
                          target_code_rate=0.7, tbs=17424, nof_layers=2,
                          n_id=1, dmrs_symbols=(2, 7, 11))
PDSCH = pdsch.PdschConfig(rnti=0x4601, rb_start=0, rb_count=24,
                          first_symbol=1, nof_symbols=12, modulation="qam256",
                          target_code_rate=0.8, tbs=20496, nof_layers=4,
                          n_id=1, dmrs_symbols=(2, 11))
SEG = pusch.segmentation(PUSCH)


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


def _grid(rng, b, cuda, ports=4):
    return _cgauss(rng, (b, ports, 14, 288)).to(cuda)


@pytest.mark.parametrize("b", [1, 4])
def test_ofdm_batched(cuda, b):
    """K4 and K7 over B x P rows."""
    rng = np.random.default_rng(b)
    samples = _cgauss(rng, (b, 4, 7680)).to(cuda)
    rx = (288, 512, 1, ofdm.CyclicPrefix.NORMAL, 0, 3.5e9)
    grid = ofdm.demodulate_slot(samples, *rx)
    _close(grid, ofdm.demodulate_slot_ref(samples, *rx), 1e-4)
    _close(grid[0], ofdm.demodulate_slot(samples[0], *rx), 1e-6)
    tx = (512, 1, ofdm.CyclicPrefix.NORMAL, 0, 3.5e9, 1.0)
    out = ofdm.modulate_slot(grid, *tx)
    _close(out, ofdm.modulate_slot_ref(grid, *tx), 1e-4)
    _close(out[0], ofdm.modulate_slot(grid[0], *tx), 1e-6)


@pytest.mark.parametrize("b", [1, 4])
def test_channel_estimate_batched(cuda, b):
    """K8 with per-slot pilots (each slot its own slot_in_frame): each
    slot's DM-RS through its own flat 4x2 channel at about 26 dB."""
    rng = np.random.default_rng(10 + b)
    grid = 0.05 * _grid(rng, b, cuda)
    vals = torch.stack([torch.as_tensor(dmrs.pilot_values_for(
        pusch.dmrs_config(dataclasses.replace(PUSCH, slot_in_frame=2 * i))))
        for i in range(b)]).to(cuda)
    for i in range(b):
        dmrs.map_to_grid(grid[i], pusch.dmrs_config(PUSCH),
                         _cgauss(rng, (4, 2)).to(cuda), vals[i])
    args, kw = pusch.estimate_args(grid, PUSCH, vals, (0, 1), 0)
    est = chest.estimate_from_grid(*args, **kw)
    ref = chest.estimate_from_grid_ref(*args, **kw)
    assert torch.equal(est.time_alignment_s.cpu(), ref.time_alignment_s.cpu())
    for key in ("coeffs", "noise_var", "rsrp", "epre", "snr"):
        _close(getattr(est, key), getattr(ref, key), 1e-4)
    torch.testing.assert_close(est.cfo_hz.cpu(), ref.cfo_hz.cpu(), rtol=0,
                               atol=1e-2)
    for i in range(b):                       # each slot as its own launch
        args1, kw1 = pusch.estimate_args(grid[i], PUSCH, vals[i], (0, 1), 0)
        one = chest.estimate_from_grid(*args1, **kw1)
        _close(est.coeffs[i], one.coeffs, 1e-6)
        assert torch.equal(est.time_alignment_s[i], one.time_alignment_s)


@pytest.mark.parametrize("b", [1, 4])
def test_pusch_demap_batched(cuda, b):
    """K3 with a slot axis on the grid, coefficients and noise."""
    rng = np.random.default_rng(20 + b)
    grid = _grid(rng, b, cuda)
    coeffs = _cgauss(rng, (b, 4, 2, 1, 288)).to(cuda)
    nv = torch.as_tensor(rng.uniform(0.01, 0.1, b).astype(np.float32)).to(cuda)
    sym, sc = pusch._plan(PUSCH, cuda)
    args = (grid, coeffs, sym, sc, 0, nv, 12345, "qam64", 2)
    llr, x = ul_demap.equalize_demap_descramble(*args)
    llr_ref, x_ref = ul_demap.equalize_demap_descramble_ref(*args)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-4)
    llr1, _ = ul_demap.equalize_demap_descramble(grid[0], coeffs[0], sym, sc,
                                                 0, nv[0], 12345, "qam64", 2)
    assert torch.equal(llr[0], llr1)


@pytest.mark.parametrize("b", [1, 4])
def test_rate_dematch_and_decode_batched(cuda, b):
    """K2 over B x C codeblocks, then K1 with the early stop per slot: slot
    0 clean (1 sweep), the others noisier (more sweeps)."""
    rng = np.random.default_rng(30 + b)
    g = pdsch.nof_data_re(PUSCH) * 2 * 6
    e_sizes = pdsch._cb_rate_match_sizes(g, SEG.nof_codeblocks, 6, 2)
    llrs = torch.as_tensor(rng.standard_normal((b, g)).astype(np.float32)
                           ).to(cuda)
    soft = torch.as_tensor(rng.standard_normal(
        (b, SEG.nof_codeblocks, SEG.codeword_bits)).astype(np.float32)).to(cuda)
    args = (SEG.nof_codeblocks, e_sizes, 0, 6, SEG.base_graph,
            SEG.lifting_size, SEG.cb_info_bits, SEG.full_block_bits,
            SEG.codeword_bits)
    out = ldpc_rate_match.rate_dematch_combine(llrs, *args, soft)
    ref = ldpc_rate_match.rate_dematch_combine_ref(llrs, *args, soft)
    assert all(torch.equal(a.cpu(), r.cpu()) for a, r in zip(out, ref))
    one = ldpc_rate_match.rate_dematch_combine(llrs[0], *args, soft[0])
    assert torch.equal(out[1][0], one[1])

    tb = torch.as_tensor(rng.integers(0, 2, (b, PUSCH.tbs)).astype(np.int8))
    cbs = ldpc_encode.dlsch_encode_ref(tb, SEG.base_graph).float()
    z = SEG.lifting_size
    sigma = torch.tensor([0.3] + [0.75] * (b - 1))[:, None, None]
    noisy = 2 * ((1 - 2 * cbs) + sigma * torch.as_tensor(
        rng.standard_normal(cbs.shape).astype(np.float32))) / sigma ** 2
    noisy[..., SEG.cb_info_bits - 2 * z:SEG.full_block_bits - 2 * z] = 1e4
    dec_in = torch.cat([torch.zeros(cbs.shape[:-1] + (2 * z,)), noisy],
                       dim=-1).to(cuda)
    k1 = (SEG.base_graph, z, 46, 6, 0.8, "crc24B", SEG.cb_info_bits)
    bits, llr, iters = ldpc_decode.decode_early_stop(dec_in, *k1)
    bits_r, _, iters_r = ldpc_decode.decode_early_stop_ref(dec_in, *k1)
    assert iters.shape == (b,) and torch.equal(iters.cpu(), iters_r.cpu())
    assert torch.equal(bits.cpu(), bits_r.cpu())
    for s in range(b):                       # each slot as its own run
        b1, l1, i1 = ldpc_decode.decode_early_stop(dec_in[s], *k1)
        assert int(i1) == int(iters[s])
        assert torch.equal(b1, bits[s]) and torch.equal(l1, llr[s])
    if b > 1:
        assert int(iters[0]) < int(iters.max())


@pytest.mark.parametrize("b", [1, 4])
def test_dlsch_encode_and_map_batched(cuda, b):
    """K5 with a TB CRC per slot, then K6 onto each slot's grid."""
    rng = np.random.default_rng(40 + b)
    seg = pdsch.segmentation(PDSCH)
    tb = torch.as_tensor(rng.integers(0, 2, (b, PDSCH.tbs)).astype(np.int8)
                         ).to(cuda)
    cbs = ldpc_encode.dlsch_encode(tb, seg.base_graph)
    assert torch.equal(cbs.cpu(), ldpc_encode.dlsch_encode_ref(
        tb.cpu(), seg.base_graph))
    assert torch.equal(cbs[0], ldpc_encode.dlsch_encode(tb[0],
                                                        seg.base_graph))
    grid = _grid(rng, b, cuda)
    w = pdsch.identity(4, PDSCH.nof_layers, cuda)
    args = pdsch.map_args(grid, PDSCH, cbs, w)
    out = dl_map.pdsch_map(grid.clone(), *args[1:])
    ref = dl_map.pdsch_map_ref(grid.clone(), *args[1:])
    _close(out, ref, 1e-6)
    one = dl_map.pdsch_map(grid[0].clone(), cbs[0], *args[2:])
    assert torch.equal(out[0], one)


# ----------------------------------------------------- conductor graphs

CELL = CellConfig(nof_ports=2, nof_rb=24, dft_size=512, numerology=1)
CORESET = pdcch.CoresetConfig(rb_start=0, nof_rb=24, start_symbol=0,
                              duration=1)
PDCCH = pdcch.PdcchConfig(coreset=CORESET, rnti=0x4601, aggregation_level=2,
                          cce_index=0, payload_bits=40, n_id=1, n_id_data=1)
SMALL_PDSCH = dataclasses.replace(PDSCH, modulation="qam16",
                                  target_code_rate=0.5, tbs=8192,
                                  nof_layers=2)
SMALL_PUSCH = dataclasses.replace(PUSCH, modulation="qpsk",
                                  target_code_rate=0.5, tbs=4096,
                                  nof_layers=1)
F1 = pucch.PucchF1Config(prb=0, start_symbol=0, nof_symbols=14,
                         initial_cyclic_shift=0, time_domain_occ=0, n_id=1)


def _requests(k, rng):
    slot = SlotPoint(1, 2 * k)
    sl = slot.slot_index
    dl = msgs.DlTtiRequest(
        slot=slot, pdcch=(dataclasses.replace(PDCCH, slot_in_frame=sl),),
        pdsch=(dataclasses.replace(SMALL_PDSCH, slot_in_frame=sl),))
    ul = msgs.UlTtiRequest(
        slot=slot, pusch=(dataclasses.replace(SMALL_PUSCH, slot_in_frame=sl),),
        pucch_f1=(dataclasses.replace(F1, slot=sl),))
    tx = msgs.TxDataRequest(
        slot=slot,
        pdsch_payloads=(np.packbits(rng.integers(0, 2, 8192).astype(np.uint8)),),
        pdcch_payloads=(np.packbits(rng.integers(0, 2, 40).astype(np.uint8)),))
    return dl, ul, tx


def test_slot_graph_replays_equal_the_eager_program(cuda):
    """Three slots of differing payloads and samples: each graph replay
    gives the eager slot program's outputs (a stale static input would show
    as the previous slot's)."""
    rng = np.random.default_rng(50)
    cond = t_cond.SlotConductor(CELL)
    reqs = [_requests(k, rng) for k in range(3)]
    staged = cond.stage_payloads([(d, t) for d, _, t in reqs])
    t = CELL.slot_samples(0)
    for k, (dl, ul, _) in enumerate(reqs):
        rx = (0.1 * _cgauss(rng, (2, t))).to(cuda)
        tx, pend = cond.process_slot(dl, ul, staged, k, rx)
        phase = cond.slot_phase(dl, ul, staged.stride)
        softs = cond._soft_buffers(ul, phase.soft_shapes)[1]
        blob = staged.buf[k * staged.stride:k * staged.stride + phase.total]
        e_tx, e_sc, e_pay, _ = phase.run(blob, rx, (), softs)
        _close(tx, e_tx, 1e-5)
        torch.testing.assert_close(pend.scalars, e_sc, rtol=1e-5, atol=1e-5)
        assert torch.equal(pend.payload, e_pay)
    graph = cond.graph_of(reqs[0][0], reqs[0][1], staged.stride)
    assert graph is not None and graph.replays == 1 and graph.nbytes >= 0


def test_slot_batch_equals_process_slot(cuda):
    rng = np.random.default_rng(51)
    cond = t_cond.SlotConductor(CELL)
    reqs = [_requests(k, rng) for k in range(4)]
    staged = cond.stage_payloads([(d, t) for d, _, t in reqs])
    rx = (0.1 * _cgauss(rng, (4, 2, CELL.slot_samples(0)))).to(cuda)
    tx_b, pend_b = cond.process_slot_batch([(d, u) for d, u, _ in reqs],
                                           staged, rx)
    got = pend_b.resolve()
    for k, (dl, ul, _) in enumerate(reqs):
        tx, pend = cond.process_slot(dl, ul, staged, k, rx[k])
        _close(tx_b[k], tx, 1e-5)
        torch.testing.assert_close(pend_b.scalars[k], pend.scalars,
                                   rtol=2e-4, atol=2e-4)
        ref = pend.resolve()
        assert got[k].crc[0].tb_crc_ok == ref.crc[0].tb_crc_ok
        assert (got[k].crc[0].nof_ldpc_iterations
                == ref.crc[0].nof_ldpc_iterations)
