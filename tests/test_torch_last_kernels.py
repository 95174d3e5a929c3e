"""K33-K36 and K8 over an irregular pilot comb against their twins, on a
CUDA GPU.

K33 (the polar encode chain) on the PBCH, DCIs at AL 1-16, UCI codes with
and without PC bits in every rate-match mode, N = 32 and N = 1024 at E =
8192, at B = 1 and 64, at batches that leave a CTA's warps idle (B = 7,
65), on inputs that are not contiguous or not int8; K34 (the short-block
encoder) for K 1-11 at Qm 1, 2, 4, 6; K33 and K34 captured in a CUDA
graph and replayed on new messages; K35 (int8 LLRs)
with ties and saturation; K36 (the LDPC syndrome check) on valid and
corrupted codewords; K8 on a type 0 PRB list's DM-RS comb with and
without the fd-OCC despread, every smoothing and both time strategies;
the PBCH and DCI step chains on the card against the fused maps of K27's
twin.  Bit paths bit-exact; K8 at rtol 1e-4 (atol 1e-4 * max|ref|), the
TA exactly, the CFO within 0.01 Hz.  On a machine without a GPU every
case skips (the twins are held to the JAX package by
tests/test_torch_last_functions.py).  Imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from srsran_tpu_torch import kernels
from srsran_tpu_torch.ops import channel_estimate as chest
from srsran_tpu_torch.ops import ldpc_decode, ldpc_encode, llr, polar
from srsran_tpu_torch.ops import short_block
from srsran_tpu_torch.ops.scrambling import scramble_bits
from srsran_tpu_torch.phy.upper import dmrs, pdcch, ssb, uci
from srsran_tpu_torch.ran import polar_params

pytestmark = pytest.mark.gpu

# (K, E, nmax, ibil, n_pc), as tests/test_torch_last_functions.py
POLAR_CASES = {
    "pbch": (56, 864, 9, False, 0), "dci_al1": (64, 108, 9, False, 0),
    "dci_al2": (64, 216, 9, False, 0), "dci_al4": (64, 432, 9, False, 0),
    "dci_al8": (64, 864, 9, False, 0), "dci_al16": (64, 1728, 9, False, 0),
    "uci_pc_none": (18, 64, 10, True, 3),
    "uci_pc_puncture": (25, 200, 10, True, 3),
    "uci_crc11": (33, 64, 10, True, 0),
    "uci_puncture": (111, 1000, 10, True, 0),
    "uci_shorten": (30, 40, 10, True, 0),
    "uci_repeat": (100, 2000, 10, True, 0),
    "n32": (8, 24, 9, False, 0),
    "n1024_e8192": (200, 8192, 10, True, 0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(rng, shape, dev):
    return torch.as_tensor(rng.integers(0, 2, shape).astype(np.int8)).to(dev)


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("case", sorted(POLAR_CASES))
def test_polar_encode_kernel(cuda, case, batch):
    k, e, nmax, ibil, npc = POLAR_CASES[case]
    code = polar_params.polar_code(k, e, nmax=nmax, ibil=ibil, n_pc=npc)
    msg = _bits(np.random.default_rng(batch), (batch, k), cuda)
    before = polar.ENCODE_KERNEL.launches
    got = polar.encode_chain(msg, code)
    torch.cuda.synchronize()
    assert polar.ENCODE_KERNEL.launches == before + 1
    assert torch.equal(got, polar.encode_chain_ref(msg, code))


@pytest.mark.parametrize("batch", [1, 7, 65])
@pytest.mark.parametrize("case", ["uci_pc_puncture", "dci_al16",
                                  "n1024_e8192"])
def test_polar_encode_kernel_partial_ctas(cuda, case, batch):
    """Batches that do not fill a CTA's warps, with and without PC bits."""
    k, e, nmax, ibil, npc = POLAR_CASES[case]
    code = polar_params.polar_code(k, e, nmax=nmax, ibil=ibil, n_pc=npc)
    msg = _bits(np.random.default_rng(batch + k), (batch, k), cuda)
    got = polar.encode_chain(msg, code)
    assert torch.equal(got, polar.encode_chain_ref(msg, code))


def test_polar_encode_kernel_strided_input(cuda):
    """A message that is a strided view, and one not int8, give the twin's
    bits (the wrapper copies them first)."""
    code = polar_params.polar_code(25, 200, nmax=10, ibil=True, n_pc=3)
    wide = _bits(np.random.default_rng(3), (9, 2 * code.k), cuda)
    for msg in (wide[:, ::2], wide[:, 5:5 + code.k], wide.T[:code.k].T,
                wide[:, :code.k].to(torch.int32)):
        assert not msg.is_contiguous() or msg.dtype != torch.int8
        got = polar.encode_chain(msg, code)
        assert torch.equal(got, polar.encode_chain_ref(msg.to(torch.int8),
                                                       code))


def test_ue_encoders_in_a_cuda_graph(cuda):
    """A K33 and a K34 launch captured in a CUDA graph replay on new
    messages equal to eager launches."""
    code = polar_params.polar_code(56, 864, nmax=9)
    rng = np.random.default_rng(20)
    msg = _bits(rng, (4, code.k), cuda)
    sb = _bits(rng, (4, 11), cuda)
    polar.encode_chain(msg, code)
    short_block.encode(sb, 120, 2)                  # plans built, warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_polar = polar.encode_chain(msg, code)
        out_sb = short_block.encode(sb, 120, 2)
    for _ in range(3):
        msg.copy_(_bits(rng, (4, code.k), cuda))
        sb.copy_(_bits(rng, (4, 11), cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out_polar, polar.encode_chain(msg, code))
        assert torch.equal(out_polar, polar.encode_chain_ref(msg, code))
        assert torch.equal(out_sb, short_block.encode(sb, 120, 2))
        assert torch.equal(out_sb, short_block.encode_ref(sb, 120, 2))


@pytest.mark.parametrize("qm", [1, 2, 4, 6])
@pytest.mark.parametrize("k", range(1, 12))
def test_short_block_encode_kernel(cuda, k, qm):
    bits = _bits(np.random.default_rng(k), (64, k), cuda)
    for e in sorted({k * qm, 3 * qm + 1, 32, 517}):
        got = short_block.encode(bits, e, qm)
        torch.cuda.synchronize()
        assert got.device == bits.device
        assert torch.equal(got, short_block.encode_ref(bits, e, qm))


def test_uci_encoders_launch_k33_k34(cuda):
    kernels.reset_counts()
    for k in (6, 16, 24):
        bits = _bits(np.random.default_rng(k), (k,), cuda)
        got = uci.encode_uci(bits, 120, 2)
        assert torch.equal(got.cpu(), uci.encode_uci(bits.cpu(), 120, 2))
    assert short_block.ENCODE_KERNEL.launches == 1
    assert polar.ENCODE_KERNEL.launches == 2


def test_llr_kernels(cuda):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 15, 1 << 16),
                        (np.arange(-130, 131) + 0.5) / 6.0,
                        [1e9, -1e9, 0.0, -0.0]]).astype(np.float32)
    xt = torch.as_tensor(x).to(cuda)
    q = llr.quantize(xt)
    assert torch.equal(q, llr.quantize_ref(xt))
    qa = torch.arange(-128, 128, dtype=torch.int8, device=cuda)
    for t in (q, qa):
        d = llr.dequantize(t)
        assert torch.equal(d.view(torch.int32),
                           llr.dequantize_ref(t).view(torch.int32))
        assert torch.equal(llr.to_float(t), d)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4111, 426_096])
def test_llr_kernels_sizes(cuda, n):
    """K35 at sizes that are and are not a multiple of 16 (the vector body
    and the scalar tail), with saturation at +-127 and x.5 ties (round half
    to even) in the data, bit-exact to the twins both ways."""
    rng = np.random.default_rng(n)
    x = rng.normal(0, 15, n).astype(np.float32)
    ties = ((np.arange(n) % 261) - 130 + 0.5).astype(np.float32) / 6.0
    x[1::3] = ties[1::3]                      # x * 6 = k + 0.5 exactly
    x[2::7] = np.float32(1e9) * np.sign(x[2::7] + 0.5)
    xt = torch.as_tensor(x).to(cuda)
    q = llr.quantize(xt)
    assert torch.equal(q, llr.quantize_ref(xt))
    if n > 2:
        assert int(q.abs().max()) == 127
    d = llr.dequantize(q)
    assert torch.equal(d.view(torch.int32),
                       llr.dequantize_ref(q).view(torch.int32))


def test_llr_kernels_unaligned(cuda):
    """Inputs whose data do not start on 16 bytes (the scalar path) and a
    non-contiguous input (copied first) give the twins' results."""
    rng = np.random.default_rng(35)
    x = torch.as_tensor(rng.normal(0, 15, 4099).astype(np.float32)).to(cuda)
    for t in (x[1:], x[3:4098], x[::2]):
        q = llr.quantize(t)
        assert torch.equal(q, llr.quantize_ref(t))
        assert torch.equal(llr.dequantize(q[1:]).view(torch.int32),
                           llr.dequantize_ref(q[1:]).view(torch.int32))


@pytest.mark.parametrize("bg,z", [(1, 384), (2, 64)])
def test_check_parity_kernel(cuda, bg, z):
    rng = np.random.default_rng(z)
    kb = 22 if bg == 1 else 10
    cw = ldpc_encode.encode(_bits(rng, (8, kb * z), cuda), bg, z)
    bad = cw.clone()
    flip = torch.as_tensor(rng.integers(0, cw.shape[1], 8)).to(cuda)
    bad[torch.arange(8, device=cuda), flip] ^= 1
    x = torch.cat([cw, bad])
    got = ldpc_decode.check_parity(x, bg, z)
    assert torch.equal(got, ldpc_decode.check_parity_ref(x, bg, z))
    assert bool(got[:8].all()) and not bool(got[8:].any())


@pytest.mark.parametrize("td", ["average", "interpolate"])
@pytest.mark.parametrize("smoothing", ["filter", "none", "mean"])
@pytest.mark.parametrize("cdm", [False, True])
def test_channel_estimate_irregular_kernel(cuda, cdm, smoothing, td):
    rng = np.random.default_rng(7)
    prbs = (2, 3, 4, 7, 8, 12, 13, 14, 15, 20, 40, 41)
    scs = dmrs._type1_sc_indices(0, 0, 0, prbs)
    nsc, syms = 12 * 42, (2, 11)
    h = ((rng.normal(size=(4, 2, 1)) + 1j * rng.normal(size=(4, 2, 1)))
         * np.exp(-2j * np.pi * np.arange(nsc) * 9 / 2048)[None, None])
    exp = np.exp(2j * np.pi * rng.random((2, 2, len(scs))))
    if cdm:
        exp[1, :, 1::2] *= -1
    rx = (h[:, :, None, scs] * exp[None]).sum(axis=1)
    grid = 0.05 * (rng.normal(size=(4, 14, nsc + 24))
                   + 1j * rng.normal(size=(4, 14, nsc + 24)))
    for i, s in enumerate(syms):
        grid[:, s, 7 + scs] += rx[:, i]
    grid_t = torch.as_tensor(grid.astype(np.complex64)).to(cuda)
    exp_t = torch.as_tensor(exp.astype(np.complex64)).to(cuda)
    args = (grid_t, syms, 7, exp_t, scs, nsc, 14, 30e3)
    kw = dict(stride=2, smoothing=smoothing,
              dmrs_symbol_times_s=np.array(syms) * 35.7e-6, td_strategy=td,
              dmrs_symbol_idx=np.array(syms), cdm_pairs=cdm)
    got = chest.estimate_from_grid(*args, **kw)
    ref = chest.estimate_from_grid_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.time_alignment_s.cpu(), ref.time_alignment_s.cpu())
    assert float(ref.time_alignment_s) != 0.0
    assert abs(float(got.cfo_hz) - float(ref.cfo_hz)) < 1e-2
    for name in ("coeffs", "noise_var", "rsrp", "epre", "snr"):
        a, b = getattr(got, name), getattr(ref, name)
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


def test_pbch_and_dci_chains_on_the_card(cuda):
    """The step chains through K33 equal the fused GF(2) maps of K27's
    twin bit for bit."""
    cfg = ssb.SsbConfig(phys_cell_id=500, ssb_idx=3, l_max=8, sfn=777,
                        hrf=True, first_symbol=0, first_subcarrier=0)
    mib = _bits(np.random.default_rng(1), (24,), cuda)
    syms = ssb.pbch_modulate(ssb.pbch_encode(cfg, mib), cfg)
    patch = ssb.ssb_block_ref(cfg, mib)
    _, data_pos = ssb._ssb_re_maps(cfg.phys_cell_id % 4)
    pos = torch.as_tensor(data_pos.astype(np.int64)).to(cuda)
    fused = patch[pos[:, 0], pos[:, 1]]
    assert torch.equal(torch.view_as_real(fused), torch.view_as_real(syms))
    for a, al, rnti in ((39, 4, 0x4601), (128, 16, 17), (12, 1, 1)):
        c = pdcch.PdcchConfig(
            coreset=pdcch.CoresetConfig(rb_start=0, nof_rb=96,
                                        start_symbol=0, duration=1),
            rnti=rnti, aggregation_level=al, cce_index=0, payload_bits=a,
            n_id=5, n_id_data=5)
        pay = _bits(np.random.default_rng(a), (a,), cuda)
        enc = scramble_bits(pdcch.encode_dci(pay, c)[None], 5)[0]
        m, const = pdcch._fused_dci_maps(a, 108 * al, rnti, 0, 5)
        want = (pay.cpu().numpy().astype(np.int32) @ m.astype(np.int32)
                + const) & 1
        assert np.array_equal(enc.cpu().numpy(), want.astype(np.int8))
