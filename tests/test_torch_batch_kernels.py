"""The slot-batch forms of K1-K19 and the conductor's CUDA graphs, on a
CUDA GPU.

Each batched kernel runs on B slots of seeded inputs at the small PUSCH's
and PDSCH's shapes (K9-K15: at the UL mix's, each slot with its own slot
context; K16-K19: at the two-UE and cell-edge slots' full-width shapes)
and is held against its plain twin (which runs slot by slot), at B = 1
and B = 4; at B = 1 it must also give the unbatched kernel's output
(K9-K19: every slot equals its own unbatched launch, and the batch counts
one launch of the kernel's ``_batch`` row).  Tolerances as the unbatched
GPU tests (tests/test_torch_kernels.py): decisions, bits and flags
exact, floats within 1e-4 of their twin's (K14's metric 1e-5; the LLRs of
K16, K18 and K19 1e-3).  The conductor's ``process_slot`` (one CUDA graph per slot
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

from srsran_tpu_torch import flagship, kernels
from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.fapi import messages as msgs
from srsran_tpu_torch.ops import channel_estimate as chest
from srsran_tpu_torch.ops import (dl_map, ldpc_decode, ldpc_encode,
                                  ldpc_rate_match, ofdm, polar, short_block,
                                  ul_demap)
from srsran_tpu_torch.phy.slot_programs import CellConfig
from srsran_tpu_torch.phy.upper import (dmrs, pdcch, pdsch, prach, pucch,
                                        pusch, srs)
from srsran_tpu_torch.ran import polar_params
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


@pytest.mark.parametrize("n,k,cp,offset", [
    (512, 288, "normal", 0), (4096, 3276, "normal", 0),
    (4096, 3276, "normal", 144), (1024, 600, "extended", 0),
    (1536, 1200, "normal", 54)])
@pytest.mark.parametrize("b", [1, 4])
def test_ofdm_batched(cuda, b, n, k, cp, offset):
    """K4 and K7 over B x P rows in one launch each: the flagship size,
    the largest window offset, extended CP and the Stockham form too."""
    rng = np.random.default_rng(b)
    cpv = (ofdm.CyclicPrefix.NORMAL if cp == "normal"
           else ofdm.CyclicPrefix.EXTENDED)
    mu = 1 if cp == "normal" else 2
    total = ofdm._symbol_layout(cpv, mu, n, 0)[2]
    samples = _cgauss(rng, (b, 4, total)).to(cuda)
    rx = (k, n, mu, cpv, 0, 3.5e9, 1.0, offset)
    before = kernels.REGISTRY["ofdm_demodulate_batch"].launches
    grid = ofdm.demodulate_slot(samples, *rx)
    assert kernels.REGISTRY["ofdm_demodulate_batch"].launches == before + 1
    _close(grid, ofdm.demodulate_slot_ref(samples, *rx), 1e-4)
    _close(grid[0], ofdm.demodulate_slot(samples[0], *rx), 1e-6)
    tx = (n, mu, cpv, 0, 3.5e9, 1.0)
    before = kernels.REGISTRY["ofdm_modulate_batch"].launches
    out = ofdm.modulate_slot(grid, *tx)
    assert kernels.REGISTRY["ofdm_modulate_batch"].launches == before + 1
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
def test_channel_estimate_batched_16_streams(cuda, b):
    """K8 with a slot axis at P L = 16 (a 4-port SRS-like comb 4 on 4 rx
    ports, shared pilots), one launch for the B slots, then the same
    launch captured in a CUDA graph and replayed on new slots."""
    rng = np.random.default_rng(40 + b)
    scs = 4 * np.arange(72)
    expected = torch.as_tensor(np.exp(1j * np.pi / 2 * rng.integers(
        0, 4, (4, 1, 72))).astype(np.complex64)).to(cuda)

    def grid():
        g = 0.05 * _grid(rng, b, cuda)
        h = _cgauss(rng, (b, 4, 4)).to(cuda)
        g[:, :, 13, scs] += torch.einsum("bpl,lk->bpk", h, expected[:, 0])
        return g

    static = grid()
    args = (static, (13,), 0, expected, scs, 288, 14, 30e3)
    kw = dict(stride=4, estimate_cfo=False)
    est = chest.estimate_from_grid(*args, **kw)
    ref = chest.estimate_from_grid_ref(*args, **kw)
    assert est.coeffs.shape == (b, 4, 4, 1, 288)
    assert torch.equal(est.time_alignment_s.cpu(), ref.time_alignment_s.cpu())
    for key in ("coeffs", "noise_var", "rsrp", "epre", "snr"):
        _close(getattr(est, key), getattr(ref, key), 1e-4)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chest.estimate_from_grid(*args, **kw)
    static.copy_(grid())
    graph.replay()
    torch.cuda.synchronize()
    ref = chest.estimate_from_grid_ref(*args, **kw)
    assert torch.equal(out.time_alignment_s.cpu(), ref.time_alignment_s.cpu())
    for key in ("coeffs", "noise_var", "rsrp", "epre", "snr"):
        _close(getattr(out, key), getattr(ref, key), 1e-4)


@pytest.mark.parametrize("modulation", ["qam64", "pi2bpsk"])
@pytest.mark.parametrize("b", [1, 4])
def test_pusch_demap_batched(cuda, b, modulation):
    """K3 with a slot axis on the grid, coefficients and noise (pi/2-BPSK:
    one LLR per symbol, so the slots' LLRs lie Qm = 1 apart per symbol)."""
    rng = np.random.default_rng(20 + b)
    grid = _grid(rng, b, cuda)
    coeffs = _cgauss(rng, (b, 4, 2, 1, 288)).to(cuda)
    nv = torch.as_tensor(rng.uniform(0.01, 0.1, b).astype(np.float32)).to(cuda)
    sym, sc = pusch._plan(PUSCH, cuda)
    args = (grid, coeffs, sym, sc, 0, nv, 12345, modulation, 2)
    llr, x = ul_demap.equalize_demap_descramble(*args)
    llr_ref, x_ref = ul_demap.equalize_demap_descramble_ref(*args)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-4)
    for s in range(b):
        llr1, _ = ul_demap.equalize_demap_descramble(
            grid[s], coeffs[s], sym, sc, 0, nv[s], 12345, modulation, 2)
        assert torch.equal(llr[s], llr1)


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


def test_map_demap_batched_at_the_flagship(cuda):
    """K6 and K3 over 4 flagship slots (the PDSCH's 100 codeblocks a slot,
    the PUSCH's 35,508 REs a slot): one launch of each batch row, within
    the twins' tolerances, each slot bit-equal to its own launch, and the
    pair captured in one CUDA graph, replayed on new inputs."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(25)
    cases = flagship.map_demap_profile_cases(gen, cuda)
    k6 = cases["pdsch_map_batch4"][2]
    k3 = cases["pusch_demap_batch4"][2]
    base = k6[0].clone()
    out6 = _counted(lambda: dl_map.pdsch_map(base.clone(), *k6[1:]),
                    "pdsch_map")
    _close(out6, dl_map.pdsch_map_ref(base.clone(), *k6[1:]), 1e-6)
    llr, x = _counted(lambda: ul_demap.equalize_demap_descramble(*k3),
                      "pusch_demap")
    llr_ref, x_ref = ul_demap.equalize_demap_descramble_ref(*k3)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-4)
    for s in range(4):
        one = dl_map.pdsch_map(base[s].clone(), k6[1][s], *k6[2:])
        assert torch.equal(out6[s], one)
        llr1, x1 = ul_demap.equalize_demap_descramble(
            k3[0][s], k3[1][s], *k3[2:5], k3[5][s], *k3[6:])
        assert torch.equal(llr[s], llr1) and torch.equal(x[s], x1)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dl_map.pdsch_map(k6[0], *k6[1:])
        llr, x = ul_demap.equalize_demap_descramble(*k3)
    rng = np.random.default_rng(6)
    start = _cgauss(rng, tuple(k6[0].shape)).to(cuda)
    k6[0].copy_(start)
    k6[1].copy_(torch.as_tensor(rng.integers(
        0, 2, tuple(k6[1].shape)).astype(np.int8)).to(cuda))
    k3[0].copy_(_cgauss(rng, tuple(k3[0].shape)).to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    _close(k6[0], dl_map.pdsch_map_ref(start.clone(), *k6[1:]), 1e-6)
    llr_ref, x_ref = ul_demap.equalize_demap_descramble_ref(*k3)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-4)


# ------------------------------------------------ K9-K15 with a slot axis

def _counted(fn, name):
    """fn() with the launch counts reset: its result, after checking that
    it launched the ``name`` kernel's batch row once and its per-slot row
    never."""
    kernels.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = (kernels.REGISTRY[f"{name}_batch"].launches,
           kernels.REGISTRY[name].launches)
    assert got == (1, 0), got
    return out


def _same(a, b):
    """Two kernel outputs (tensors or tuples of them) bit-equal."""
    if isinstance(a, torch.Tensor):
        assert a.shape == b.shape and torch.equal(a, b)
        return
    for x, y in zip(a, b):
        _same(x, y)


def _slot(out, s):
    return out[s] if isinstance(out, torch.Tensor) else tuple(
        _slot(o, s) for o in out)


UL_GRID = (4, 14, 3276)


@pytest.mark.parametrize("b", [1, 4])
def test_prach_detect_batched(cuda, b):
    """K9's three launches over B captures (preamble 21, noise alone in
    slot 1)."""
    rng = np.random.default_rng(60 + b)
    caps = [flagship.prach_capture(rng) for _ in range(b)]
    if b > 1:
        caps[1] = 0.05 * _cgauss(rng, caps[1].shape).numpy()
    fd = torch.as_tensor(np.stack(caps)).to(cuda)
    cfg = flagship.PRACH
    out = _counted(lambda: prach.detect(fd, cfg), "prach_detect")
    ref = prach.detect_ref(fd, cfg)
    assert torch.equal(out.detected, ref.detected)
    assert torch.equal(out.time_advance_s, ref.time_advance_s)
    _close(out.metrics, ref.metrics, 1e-4)
    _close(out.rssi, ref.rssi, 1e-4)
    for s in range(b):
        one = prach.detect(fd[s], cfg)
        want = [] if s == 1 else [flagship.PRACH_PREAMBLE]
        assert torch.nonzero(out.detected[s]).flatten().tolist() == want
        assert torch.equal(out.detected[s], one.detected)
        assert torch.equal(out.time_advance_s[s], one.time_advance_s)
        _close(out.metrics[s], one.metrics, 1e-6)
        _close(out.rssi[s], one.rssi, 1e-6)


def test_prach_detect_batched_in_a_cuda_graph(cuda):
    """K9's one launch for 4 captures (noise alone in slot 1) captured in a
    CUDA graph and replayed on new captures: the twin slot by slot."""
    rng = np.random.default_rng(64)
    cfg = flagship.PRACH

    def captures():
        caps = [flagship.prach_capture(rng) for _ in range(4)]
        caps[1] = 0.05 * _cgauss(rng, caps[1].shape).numpy()
        return torch.as_tensor(np.stack(caps)).to(cuda)

    static = captures()
    prach.detect(static, cfg)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = prach.detect(static, cfg)
    static.copy_(captures())
    graph.replay()
    torch.cuda.synchronize()
    ref = prach.detect_ref(static, cfg)
    assert torch.equal(out.detected, ref.detected)
    assert torch.equal(out.time_advance_s, ref.time_advance_s)
    _close(out.metrics, ref.metrics, 1e-4)
    _close(out.rssi, ref.rssi, 1e-4)
    assert not bool(out.detected[1].any())


def _f1_slot(common, users, rng, ports=4):
    grid = torch.zeros((ports,) + UL_GRID[1:], dtype=torch.complex64)
    for m0, occ, nbits in users:
        cfg = dataclasses.replace(common, initial_cyclic_shift=m0,
                                  time_domain_occ=occ, nof_harq_bits=nbits)
        one = pucch.transmit_format1(torch.zeros_like(grid), cfg,
                                     rng.integers(0, 2, nbits))[0]
        grid += _cgauss(rng, (ports,))[:, None, None] * one
    return grid + 0.05 * _cgauss(rng, grid.shape)


def _f1_batch(b, hop, n_users, ports, nsym, cuda, seed):
    """(grid [b, P, 14, K], commons, per-slot host weights, weights with
    a_dm and ph stacked per slot and w_da shared) of B slots of one
    occasion ending at symbol 13, each slot its own slot number."""
    users = (tuple((4 * u, u % 2, 1 + u % 2) for u in range(n_users))
             if n_users <= 3 else
             tuple((u % 12, u // 12 % (3 if hop else 7), 1 + u % 2)
                   for u in range(n_users)))
    rng = np.random.default_rng(seed)
    commons = [pucch.PucchF1Config(prb=0, start_symbol=14 - nsym,
                                   nof_symbols=nsym, initial_cyclic_shift=0,
                                   time_domain_occ=0, n_id=1, slot=2 * s,
                                   second_hop_prb=hop)
               for s in range(b)]
    grid = torch.stack([_f1_slot(c, users, rng, ports)
                        for c in commons]).to(cuda)
    per = [pucch.f1_batch_weights(c, users) for c in commons]
    weights = tuple(
        tuple(torch.as_tensor(np.stack([p[h][j] for p in per])).to(cuda)
              if j < 2 else torch.as_tensor(per[0][h][j]).to(cuda)
              for j in range(3)) for h in range(len(per[0])))
    return grid, commons, per, weights


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("hop,n_users,ports,nsym", [
    (None, 3, 4, 14), (9, 3, 4, 14), (9, 12, 4, 14), (None, 64, 4, 14),
    (9, 5, 8, 13)])
def test_pucch_f1_batched(cuda, b, hop, n_users, ports, nsym):
    """K10 over B slots (3, 12 or 64 users, 4 or 8 ports, one hop or two
    of 6 and 7 symbols), each slot its own slot number (the cyclic shifts
    and so a_dm and ph per slot; w_da shared).  The three-user points
    keep their seed 70 + b; the others add their user count."""
    grid, commons, per, weights = _f1_batch(
        b, hop, n_users, ports, nsym, cuda,
        70 + b + (n_users if n_users != 3 else 0))
    out = _counted(lambda: pucch.f1_detect(grid, commons[0], weights, 1.5),
                   "pucch_f1_detect")
    ref = pucch.f1_detect_ref(grid, commons[0], weights, 1.5)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    _close(out[1], ref[1], 1e-4)
    _close(out[3], ref[3], 1e-4)
    for s in range(b):
        one = pucch.f1_detect(grid[s], commons[s], tuple(
            tuple(torch.as_tensor(w).to(cuda) for w in h) for h in per[s]),
            1.5)
        _same(_slot(out, s), one)


def test_pucch_batched_in_a_cuda_graph(cuda):
    """K10 (3 users, a hop) and K13 (2 RB) over 4 slots, both captured in
    one CUDA graph and replayed on new grids, channels and noise: the
    twins' results on them."""
    grid, commons, _, weights = _f1_batch(4, 9, 3, 4, 14, cuda, 75)
    rng = np.random.default_rng(76)
    cfg = pucch.PucchF2Config(rb_start=270, nof_rb=2, start_symbol=11,
                              nof_symbols=2, rnti=0x19, n_id=1, n_id0=1,
                              nof_uci_bits=22)

    def f2_inputs():
        return (_cgauss(rng, (4,) + UL_GRID).to(cuda),
                (1 + 0.25 * _cgauss(rng, (4, 4, 1, 1, 24))).to(cuda),
                torch.full((4, 4), 0.05, device=cuda))

    f2 = f2_inputs()

    def run():
        return (pucch.f1_detect(grid, commons[0], weights, 1.5),
                pucch.f2_demap(*f2, cfg))

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        f1_out, llr = run()
    grid.copy_(_f1_batch(4, 9, 3, 4, 14, cuda, 77)[0])
    for static, new in zip(f2, f2_inputs()):
        static.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    ref = pucch.f1_detect_ref(grid, commons[0], weights, 1.5)
    assert torch.equal(f1_out[0], ref[0]) and torch.equal(f1_out[2], ref[2])
    _close(f1_out[1], ref[1], 1e-4)
    _close(f1_out[3], ref[3], 1e-4)
    _close(llr, pucch.f2_demap_ref(*f2, cfg), 1e-4)


@pytest.mark.parametrize("b", [1, 4])
def test_srs_estimate_batched(cuda, b):
    """K11 after K8's batch form, on B slots through their own channels."""
    cfg = srs.SrsConfig(rb_start=200, rb_count=48, start_symbol=13,
                        nof_symbols=1, comb=4, comb_offset=0, cyclic_shift=0,
                        nof_ports=4, sequence_id=1, numerology=1)
    rng = np.random.default_rng(80 + b)
    tx = srs.map_to_grid(torch.zeros(UL_GRID, dtype=torch.complex64), cfg)
    grid = torch.stack([
        torch.einsum("rp,psk->rsk", _cgauss(rng, (4, 4)), tx)
        + 0.05 * _cgauss(rng, tx.shape) for _ in range(b)]).to(cuda)
    args, kw = srs.estimate_args(grid, cfg)
    est = chest.estimate_from_grid(*args, **kw)
    ta, rsrp = est.time_alignment_s, est.rsrp
    out = _counted(lambda: srs.srs_noise(grid, cfg, ta, rsrp),
                   "srs_estimate")
    for a, r in zip(out, srs.srs_noise_ref(grid, cfg, ta, rsrp)):
        _close(a, r, 1e-4)
    for s in range(b):
        _same(_slot(out, s), srs.srs_noise(grid[s], cfg, ta[s], rsrp[s]))


def test_srs_noise_batched_widest(cuda):
    """K11 over 4 slots of the widest SRS (K = 1632, 4 ports, 4 symbols:
    8 warps a rx port), TA and RSRP (from K8's twin: K8 takes no comb of
    1632) read through strided views of one [4, P + 1] tensor, as K8 hands
    them on: within 1e-4 of its twin, every slot equal to its own launch,
    one launch."""
    cfg = flagship.SRS_WIDEST
    rng = np.random.default_rng(28)
    tx = srs.map_to_grid(torch.zeros(UL_GRID, dtype=torch.complex64), cfg)
    grid = torch.stack([
        torch.einsum("rp,psk->rsk", _cgauss(rng, (4, 4)), tx)
        + 0.05 * _cgauss(rng, tx.shape) for _ in range(4)]).to(cuda)
    args, kw = srs.estimate_args(grid, cfg)
    est = chest.estimate_from_grid_ref(*args, **kw)
    stats = torch.cat([est.rsrp, est.time_alignment_s[:, None]], -1)
    ta, rsrp = stats[:, -1], stats[:, :-1]
    assert ta.stride(0) == rsrp.stride(0) == 5
    out = _counted(lambda: srs.srs_noise(grid, cfg, ta, rsrp),
                   "srs_estimate")
    for a, r in zip(out, srs.srs_noise_ref(grid, cfg, ta, rsrp)):
        _close(a, r, 1e-4)
    for s in range(4):
        _same(_slot(out, s), srs.srs_noise(grid[s], cfg, ta[s], rsrp[s]))


@pytest.mark.parametrize("precoder", ["none", "matrix", "prg"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_dmrs_map_batched(cuda, precoder, per_slot):
    """K26 over 4 slots of the flagship PDSCH's DM-RS (4 layers, 273 RB),
    the pilots and the matrix or PRG table shared or one a slot: bit-exact
    to its twin and every slot to its own launch, one launch."""
    from srsran_tpu_torch.ops import dl_rs
    cfg = pdsch.dmrs_config(flagship.PDSCH)
    rng = np.random.default_rng(26 + per_slot)
    lead = (4,) if per_slot else ()
    pil = torch.stack([torch.as_tensor(dmrs.pilot_values_for(
        dataclasses.replace(cfg, slot_in_frame=k))) for k in range(4)])
    pil = (pil if per_slot else pil[0]).to(cuda)
    w, prg = None, 0
    if precoder == "matrix":
        w = _cgauss(rng, lead + (4, 4)).to(cuda)
    elif precoder == "prg":
        w, prg = _cgauss(rng, lead + (69, 4, 4)).to(cuda), 4
    grid = _cgauss(rng, (4, 4, 14, 3276)).to(cuda)
    args = (pil, w, cfg.ports, cfg.symbols, cfg.prb_list, prg,
            cfg.config_type)
    g = grid.clone()
    kernels.reset_counts()
    got = dl_rs.dmrs_map(g, *args)
    assert kernels.REGISTRY["dmrs_map"].launches == 1
    assert torch.equal(got, dl_rs.dmrs_map_ref(grid.clone(), *args))
    for s in range(4):
        one = (pil[s] if per_slot else pil,
               w[s] if per_slot and w is not None else w) + args[2:]
        assert torch.equal(got[s], dl_rs.dmrs_map(grid[s].clone(), *one))


@pytest.mark.parametrize("b", [1, 4])
def test_pucch_f0_batched(cuda, b):
    """K12 over B slots, each its own slot number (references per slot)
    and its own SR/HARQ candidate sent."""
    rng = np.random.default_rng(90 + b)
    table = pucch._F0_TABLES[(2, True)]
    cfgs = [pucch.PucchF0Config(prb=269, start_symbol=11, nof_symbols=2,
                                initial_cyclic_shift=3, n_id=1, slot=2 * s,
                                nof_harq_bits=2, sr_opportunity=True)
            for s in range(b)]
    sent = [table[(3 * s + 1) % len(table)] for s in range(b)]
    grid = []
    for cfg, (_, sr, harq) in zip(cfgs, sent):
        one = pucch.transmit_format0(torch.zeros((1,) + UL_GRID[1:],
                                                 dtype=torch.complex64),
                                     cfg, harq, sr or 0)[0]
        grid.append(_cgauss(rng, (4,))[:, None, None] * one
                    + 0.3 * _cgauss(rng, UL_GRID))
    grid = torch.stack(grid).to(cuda)
    refs = torch.as_tensor(np.stack([pucch.f0_refs_for(c) for c in cfgs])
                           ).to(cuda)
    out = _counted(lambda: pucch.f0_detect(grid, cfgs[0], refs, 4.0),
                   "pucch_f0_detect")
    ref = pucch.f0_detect_ref(grid, cfgs[0], refs, 4.0)
    for i in (0, 2, 3, 4):
        assert torch.equal(out[i], ref[i]), i
    _close(out[1], ref[1], 1e-4)
    for s, (_, sr, harq) in enumerate(sent):
        one = pucch.f0_detect(grid[s], cfgs[s], refs[s], 4.0)
        _same(_slot(out, s), one)
        assert bool(one[0]) and one[2].tolist() == list(harq)


@pytest.mark.parametrize("b", [2, 4])
def test_pucch_f0_batched_shared_refs(cuda, b):
    """K12 over B slots with one set of references for all (the same slot
    number), each slot its own candidate sent; 8 ports, one symbol."""
    rng = np.random.default_rng(95 + b)
    cfg = pucch.PucchF0Config(prb=100, start_symbol=13, nof_symbols=1,
                              initial_cyclic_shift=5, n_id=1, slot=4,
                              nof_harq_bits=1, sr_opportunity=True)
    table = pucch._F0_TABLES[(1, True)]
    grid = []
    for s in range(b):
        _, sr, harq = table[s % len(table)]
        one = pucch.transmit_format0(torch.zeros((1,) + UL_GRID[1:],
                                                 dtype=torch.complex64),
                                     cfg, harq, sr or 0)[0]
        grid.append(_cgauss(rng, (8,))[:, None, None] * one
                    + 0.3 * _cgauss(rng, (8,) + UL_GRID[1:]))
    grid = torch.stack(grid).to(cuda)
    refs = torch.as_tensor(pucch.f0_refs_for(cfg)).to(cuda)
    out = _counted(lambda: pucch.f0_detect(grid, cfg, refs, 4.0),
                   "pucch_f0_detect")
    ref = pucch.f0_detect_ref(grid, cfg, refs, 4.0)
    for i in (0, 2, 3, 4):
        assert torch.equal(out[i], ref[i]), i
    _close(out[1], ref[1], 1e-4)
    assert out[4].tolist() == [s % len(table) for s in range(b)]
    for s in range(b):
        _same(_slot(out, s), pucch.f0_detect(grid[s], cfg, refs, 4.0))


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("nof_rb,k,ports", [(1, 6, 4), (2, 22, 4),
                                           (16, 22, 4), (2, 22, 8)])
def test_pucch_f2_batched(cuda, b, nof_rb, k, ports):
    """K8 (comb 3), K13, then K14 or K15 on B slots (1 to 16 RB, 4 or 8
    ports), each its own pilots: process_format2 with the slot axis
    launches each once.  The 4-port points keep their seed 100 + b +
    nof_rb; the 8-port point adds its port count."""
    rng = np.random.default_rng(100 + b + nof_rb + (ports if ports != 4
                                                     else 0))
    cfgs = [pucch.PucchF2Config(rb_start=272 - nof_rb, nof_rb=nof_rb,
                                start_symbol=11, nof_symbols=2, rnti=0x19,
                                n_id=1, n_id0=1, nof_uci_bits=k, slot=2 * s)
            for s in range(b)]
    sent = [rng.integers(0, 2, k) for _ in range(b)]
    grid = torch.stack([
        _cgauss(rng, (ports,))[:, None, None] * pucch.transmit_format2(
            torch.zeros((1,) + UL_GRID[1:], dtype=torch.complex64), c, m)[0]
        + 0.05 * _cgauss(rng, (ports,) + UL_GRID[1:])
        for c, m in zip(cfgs, sent)]).to(cuda)
    pil = torch.as_tensor(np.stack([pucch.f2_pilot_values_for(c)
                                    for c in cfgs])).to(cuda)
    args, kw = pucch.f2_estimate_args(grid, cfgs[0], pil)
    est = chest.estimate_from_grid(*args, **kw)
    k13 = (grid, est.coeffs, est.noise_var, cfgs[0])
    llr = _counted(lambda: pucch.f2_demap(*k13), "pucch_f2_demap")
    _close(llr, pucch.f2_demap_ref(*k13), 1e-4)
    for s in range(b):
        _same(llr[s], pucch.f2_demap(grid[s], est.coeffs[s],
                                     est.noise_var[s], cfgs[s]))
    kernels.reset_counts()
    res = pucch.process_format2(grid, cfgs[0], pil)
    decoder = "short_block_detect" if k <= 11 else "polar_decode"
    counts = {n: kernels.REGISTRY[n].launches
              for n in ("channel_estimate_batch", "pucch_f2_demap_batch",
                        f"{decoder}_batch", "channel_estimate",
                        "pucch_f2_demap", decoder)}
    assert list(counts.values()) == [1, 1, 1, 0, 0, 0], counts
    for s in range(b):
        one = pucch.process_format2(grid[s], cfgs[s], pil[s])
        assert res["uci_bits"][s].tolist() == list(sent[s])
        for key in ("uci_bits", "valid"):
            assert torch.equal(res[key][s], one[key]), key
        _close(res["metric"][s], one["metric"], 1e-6)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("k,qm,e", [(6, 2, 32), (11, 2, 512)])
def test_short_block_batched(cuda, b, k, qm, e):
    """K14 over B slots of 3 codewords each: one launch of 3B blocks."""
    rng = np.random.default_rng(110 + b + k)
    msg = torch.as_tensor(rng.integers(0, 2, (b * 3, k)).astype(np.int8))
    cw = short_block.encode(msg, e, qm).numpy()
    llr = torch.as_tensor(((1.0 - 2.0 * cw) + rng.standard_normal(cw.shape)
                           ).astype(np.float32)).reshape(b, 3, e).to(cuda)
    bits, metric = _counted(lambda: short_block.detect(llr, k, qm),
                            "short_block_detect")
    bits_ref, metric_ref = short_block.detect_ref(llr, k, qm)
    assert bits.shape == (b, 3, k) and torch.equal(bits, bits_ref)
    _close(metric, metric_ref, 1e-5)
    for s in range(b):
        _same((bits[s], metric[s]), short_block.detect(llr[s], k, qm))


@pytest.mark.parametrize("k,qm,e", [(6, 2, 32), (11, 2, 512), (1, 1, 40)])
def test_short_block_batched_partial_cta(cuda, k, qm, e):
    """K14 over 3 slots of 3 codewords: 9 warps, the last CTA holding one
    codeword; each slot equal to its own launch."""
    rng = np.random.default_rng(120 + k + e)
    msg = torch.as_tensor(rng.integers(0, 2, (9, k)).astype(np.int8))
    cw = short_block.encode(msg, e, qm).numpy()
    llr = torch.as_tensor(((1.0 - 2.0 * cw) + rng.standard_normal(cw.shape)
                           ).astype(np.float32)).reshape(3, 3, e).to(cuda)
    bits, metric = _counted(lambda: short_block.detect(llr, k, qm),
                            "short_block_detect")
    bits_ref, metric_ref = short_block.detect_ref(llr, k, qm)
    assert bits.shape == (3, 3, k) and torch.equal(bits, bits_ref)
    _close(metric, metric_ref, 1e-5)
    for s in range(3):
        _same((bits[s], metric[s]), short_block.detect(llr[s], k, qm))


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("k,e,n_pc,crc_name", [(33, 64, 0, "crc11"),
                                               (18, 32, 3, "crc6")])
def test_polar_decode_batched(cuda, b, k, e, n_pc, crc_name):
    """K15 over B slots of 2 codewords each (one of them at exact-zero
    LLRs): one launch of 2B CTAs."""
    code = polar_params.polar_code(k, e, nmax=10, ibil=True, n_pc=n_pc)
    rng = np.random.default_rng(120 + b + k)
    msg = rng.integers(0, 2, (2 * b, k)).astype(np.int8)
    x = polar.rate_match(polar.encode(polar.allocate(torch.as_tensor(msg),
                                                     code), code.n),
                         code).numpy()
    llr = ((1.0 - 2.0 * x) + 0.8 * rng.standard_normal(x.shape)
           ).astype(np.float32)
    llr[-1] = 0.0
    llr = torch.as_tensor(llr).reshape(b, 2, e).to(cuda)
    bits, ok = _counted(lambda: polar.decode(llr, code, crc_name),
                        "polar_decode")
    bits_ref, ok_ref = polar.decode_ref(llr, code, crc_name)
    assert bits.shape == (b, 2, k)
    assert torch.equal(bits, bits_ref) and torch.equal(ok, ok_ref)
    for s in range(b):
        _same((bits[s], ok[s]), polar.decode(llr[s], code, crc_name))


@pytest.mark.parametrize("b", [1, 16])
def test_polar_decode_batched_in_a_cuda_graph(cuda, b):
    """K15 over B slots of 8 PBCH-sized codewords (N = 512), one launch
    captured in a CUDA graph and replayed on new LLRs."""
    code = polar_params.polar_code(56, 864, nmax=9, ibil=False)
    rng = np.random.default_rng(140 + b)

    def llrs():
        msg = rng.integers(0, 2, (8 * b, code.k)).astype(np.int8)
        x = polar.rate_match(polar.encode(polar.allocate(
            torch.as_tensor(msg), code), code.n), code).numpy()
        return torch.as_tensor(((1.0 - 2.0 * x) + 0.8 * rng.standard_normal(
            x.shape)).astype(np.float32)).reshape(b, 8, code.e).to(cuda)

    static = llrs()
    polar.decode(static, code, "crc24C")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bits, ok = polar.decode(static, code, "crc24C")
    static.copy_(llrs())
    graph.replay()
    torch.cuda.synchronize()
    bits_ref, ok_ref = polar.decode_ref(static, code, "crc24C")
    assert bits.shape == (b, 8, code.k)
    assert torch.equal(bits, bits_ref) and torch.equal(ok, ok_ref)


# ---------------------------- K16-K19 with a slot axis (two-UE, cell edge)

FULL_GRID = (4, 14, 3276)


def _lxn_hold(out, ref):
    """K16 against its twin, as tests/test_torch_kernels.py holds it: x
    within 1e-4 of max|x|, the LLRs within 1e-3 of max|LLR|, equal hard
    decisions wherever |LLR| is above that."""
    (llr, x), (llr_ref, x_ref) = out, ref
    big = llr_ref.abs() > 1e-3 * float(llr_ref.abs().max())
    assert torch.equal(llr[big] > 0, llr_ref[big] > 0)
    _close(x, x_ref, 1e-4)
    _close(llr, llr_ref, 1e-3)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("ue", ["a", "b"])
def test_pusch_demap_lxn_batched(cuda, b, ue):
    """K16 at the two-UE slot's shapes (UE A: 4 layers MMSE on 205 RB; UE
    B: 1 layer MMSE on 64 RB), each slot its own grid, channel (I + 0.25
    (N + jN)) and noise: one launch, and every slot bit-equal to its own
    unbatched launch."""
    cfg = flagship.MU.pusch_a if ue == "a" else flagship.MU.ue_b(1)
    layers, nsc = cfg.nof_layers, 12 * cfg.rb_count
    rng = np.random.default_rng(130 + b + layers)
    grid = torch.stack([_cgauss(rng, FULL_GRID) for _ in range(b)]).to(cuda)
    h = (np.eye(4, layers)[None, :, :, None, None]
         + 0.25 * _cgauss(rng, (b, 4, layers, 1, nsc)).numpy())
    coeffs = torch.as_tensor(h.astype(np.complex64)).to(cuda)
    nv = torch.as_tensor(rng.uniform(0.02, 0.1, b).astype(np.float32)).to(
        cuda)
    sym, sc = pusch._plan(cfg, cuda)
    c_init = (cfg.rnti << 15) + cfg.n_id
    args = (grid, coeffs, sym, sc, cfg.rb_start * 12, nv, c_init,
            cfg.modulation, layers, cfg.equalizer)
    out = _counted(lambda: ul_demap.equalize_demap_descramble(*args),
                   "pusch_demap_lxn")
    assert out[0].shape[0] == out[1].shape[0] == b
    _lxn_hold(out, ul_demap.equalize_demap_descramble_ref(*args))
    for s in range(b):
        _same(_slot(out, s), ul_demap.equalize_demap_descramble_lxn(
            grid[s], coeffs[s], sym, sc, cfg.rb_start * 12, nv[s], c_init,
            cfg.modulation, layers, cfg.equalizer))


def test_pusch_demap_lxn_batched_in_a_cuda_graph(cuda):
    """K16 at UE A's shapes over 4 slots, captured in a CUDA graph and
    replayed on new grids and channels: the twin slot by slot."""
    cfg = flagship.MU.pusch_a
    layers, nsc = cfg.nof_layers, 12 * cfg.rb_count
    rng = np.random.default_rng(140)

    def inputs():
        grid = torch.stack([_cgauss(rng, FULL_GRID) for _ in range(4)])
        h = (np.eye(4, layers)[None, :, :, None, None]
             + 0.25 * _cgauss(rng, (4, 4, layers, 1, nsc)).numpy())
        return grid.to(cuda), torch.as_tensor(h.astype(np.complex64)).to(
            cuda)

    grid, coeffs = inputs()
    nv = torch.as_tensor(rng.uniform(0.02, 0.1, 4).astype(np.float32)).to(
        cuda)
    sym, sc = pusch._plan(cfg, cuda)
    args = (grid, coeffs, sym, sc, cfg.rb_start * 12, nv,
            (cfg.rnti << 15) + cfg.n_id, cfg.modulation, layers,
            cfg.equalizer)
    ul_demap.equalize_demap_descramble(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ul_demap.equalize_demap_descramble(*args)
    new_grid, new_coeffs = inputs()
    grid.copy_(new_grid)
    coeffs.copy_(new_coeffs)
    graph.replay()
    torch.cuda.synchronize()
    _lxn_hold(out, ul_demap.equalize_demap_descramble_ref(*args))


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("case", ["ue_b", "ue_c", "punct_ack1"])
def test_ulsch_demux_batched(cuda, b, case):
    """K17 on B codewords (UE B of the two-UE slot with ACK, CSI1 and CSI2;
    UE C of the cell edge with 2 ACK bits on QPSK; a punctured 1-bit ACK on
    QAM16): one launch, the four fields [B, n] contiguous, bit-exact to the
    twin and to each slot's own launch."""
    from srsran_tpu_torch.ops import uci_demux
    from srsran_tpu_torch.ran.uci_on_pusch import UciOnPuschConfig
    cfg = {"ue_b": flagship.MU.ue_b(1), "ue_c": flagship.EDGE.pusch_c,
           "punct_ack1": dataclasses.replace(
               flagship.MU.ue_b(1), uci=UciOnPuschConfig(o_ack=1))}[case]
    dcfg = pusch.demux_plan(cfg)
    g = sum(dcfg.re_per_symbol) * dcfg.qm * dcfg.nof_layers
    rng = np.random.default_rng(140 + b + len(case))
    llr = torch.as_tensor(rng.standard_normal((b, g)).astype(np.float32)
                          ).to(cuda)
    args = (dcfg, cfg.uci.o_ack, cfg.uci.o_csi1, (cfg.rnti << 15) + cfg.n_id)
    out = _counted(lambda: uci_demux.demux(llr, *args), "ulsch_demux")
    ref = uci_demux.demux_ref(llr, *args)
    assert [tuple(o.shape) for o in out] == [
        (b, n) for n in uci_demux.field_sizes(dcfg)]
    assert all(o.is_contiguous() for o in out)
    _same(out, ref)
    for s in range(b):
        _same(_slot(out, s), uci_demux.demux(llr[s], *args))


def _tp_batch(rng, b, cfg, dev):
    """K18's inputs on B random slots: grids, the hops' estimates side by
    side and each hop's noise per slot; the plan shared."""
    nhops = len(pusch.hop_configs(cfg))
    m = 12 * cfg.rb_count
    key = pusch._tp_key(cfg)
    grid = torch.stack([_cgauss(rng, FULL_GRID) for _ in range(b)]).to(dev)
    coeffs = _cgauss(rng, (b, 4, 1, 1, nhops * m)).to(dev)
    noise = torch.as_tensor(rng.uniform(0.05, 0.2, (b, nhops, 4)).astype(
        np.float32)).to(dev)
    return (grid, coeffs, torch.as_tensor(pusch.tp_plan(key, 0)).to(dev),
            noise, torch.as_tensor(pusch.tp_plan(key, 1)).to(dev), m,
            (cfg.rnti << 15) + cfg.n_id, cfg.modulation, cfg.equalizer)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("case", ["ue_c", "widest", "m300", "m2916"])
def test_pusch_tp_demap_batched(cuda, b, case):
    """K18 at UE C's shape (M = 72, both hops, MMSE), at the widest
    allocation (M = 3240, above 48 KB of shared memory) and at M = 300 and
    2916 (radix-5 and six radix-3 stages): one launch, within the twin's
    tolerances, every slot bit-equal to its own launch."""
    cfg = (flagship.EDGE.pusch_c if case == "ue_c" else
           flagship.widest_tp() if case == "widest" else
           dataclasses.replace(flagship.widest_tp(),
                               rb_count=flagship.TP_EXTRA_RB[case]))
    args = _tp_batch(np.random.default_rng(150 + b + len(case)), b, cfg,
                     cuda)
    out = _counted(lambda: ul_demap.tp_equalize_demap_descramble(*args),
                   "pusch_tp_demap")
    llr_ref, x_ref = ul_demap.tp_equalize_demap_descramble_ref(*args)
    _close(out[1], x_ref, 1e-4)
    _close(out[0], llr_ref, 1e-3)
    grid, coeffs, plan, noise, *rest = args
    for s in range(b):
        _same(_slot(out, s), ul_demap.tp_equalize_demap_descramble(
            grid[s], coeffs[s], plan, noise[s], *rest))


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("fmt", ["f3", "f4"])
def test_pucch_f3_batched(cuda, b, fmt):
    """K8 (stride 1), K19, then K15 (F3, 22 bits) or K14 (F4, 8 bits) on B
    slots of the cell edge's PUCCH, each slot its own DM-RS values (its
    slot number), payload and channel: ``process_format3`` with the slot
    axis launches each once, K19 alone equals its twin and every slot its
    own launch, and every slot decodes its payload."""
    base = flagship.EDGE.f3 if fmt == "f3" else flagship.EDGE.f4
    cfgs = [dataclasses.replace(base, slot=2 * s) for s in range(b)]
    rng = np.random.default_rng(160 + b + len(fmt))
    sent = [rng.integers(0, 2, base.nof_uci_bits) for _ in range(b)]
    grid = torch.stack([
        _cgauss(rng, (4,))[:, None, None] * pucch.transmit_format3(
            torch.zeros((1,) + FULL_GRID[1:], dtype=torch.complex64), c, m)[0]
        + 0.05 * _cgauss(rng, FULL_GRID) for c, m in zip(cfgs, sent)]).to(cuda)
    vals = torch.as_tensor(np.stack([pucch.f3_dmrs_values_for(c)
                                     for c in cfgs])).to(cuda)
    args, kw = pucch.f3_estimate_args(grid, base, vals)
    est = chest.estimate_from_grid(*args, **kw)
    k19 = (grid, est.coeffs, est.noise_var, base)
    llr = _counted(lambda: pucch.f3_demap(*k19), "pucch_f3_demap")
    _close(llr, pucch.f3_demap_ref(*k19), 1e-3)
    for s in range(b):
        _same(llr[s], pucch.f3_demap(grid[s], est.coeffs[s],
                                     est.noise_var[s], base))
    kernels.reset_counts()
    res = pucch.process_format3(grid, base, vals)
    decoder = "polar_decode" if fmt == "f3" else "short_block_detect"
    counts = {n: kernels.REGISTRY[n].launches
              for n in ("channel_estimate_batch", "pucch_f3_demap_batch",
                        f"{decoder}_batch", "channel_estimate",
                        "pucch_f3_demap", decoder)}
    assert list(counts.values()) == [1, 1, 1, 0, 0, 0], counts
    for s in range(b):
        one = pucch.process_format3(grid[s], cfgs[s], vals[s])
        assert res["uci_bits"][s].tolist() == list(sent[s])
        for key in ("uci_bits", "valid"):
            assert torch.equal(res[key][s], one[key]), key
        _close(res["metric"][s], one["metric"], 1e-6)


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
