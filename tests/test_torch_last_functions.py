"""The last JAX device functions of the port against the JAX package.

K33's twin (``polar.encode_chain_ref``: allocate -> encode -> rate_match)
on the PBCH, DCIs at AL 1-16, UCI with and without PC bits and all three
rate-match modes, and a numpy replay of K33's table walk; the UE-side
encoders that now run through K33/K34 (``encode_uci``,
``transmit_format2``, ``f3_encode``); K34's twin for K 1-11 at Qm 1, 2,
4, 6, which never leaves the device of its bits; the step-by-step PBCH
and DCI encoders (against JAX and against the port's fused K27 twin);
K8's twin over irregular pilot combs (a type 0 PRB list, with and
without the fd-OCC despread, every smoothing and time strategy) and the
band tables the kernel reads; K35's twins (ties, saturation, every int8
value, the quantized decode of tests/test_llr_grid.py); K36's twin on
valid and corrupted codewords; and the thin counterparts of the JAX
functions that had no name in the port.  Bit paths are held exactly;
float paths at rtol 1e-4 with atol 1e-4 * max|ref| (as
tests/test_torch_frontend.py::test_channel_estimate), TA exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import channel_estimate as j_chest
from srsran_tpu.ops import crc as j_crc
from srsran_tpu.ops import gold as j_gold
from srsran_tpu.ops import ldpc_decode as j_ldpc_dec
from srsran_tpu.ops import ldpc_encode as j_ldpc_enc
from srsran_tpu.ops import llr as j_llr
from srsran_tpu.ops import low_papr as j_papr
from srsran_tpu.ops import polar as j_polar
from srsran_tpu.ops import precoding as j_prec
from srsran_tpu.ops import short_block as j_sb
from srsran_tpu.ops.ldpc_graph import get_graph as j_get_graph
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pdcch as j_pdcch
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper import ssb as j_ssb
from srsran_tpu.phy.upper import uci as j_uci
from srsran_tpu.ran import polar_params as j_pp
from srsran_tpu.ran import prach_params as j_prachp

from srsran_tpu_torch import convert
from srsran_tpu_torch.ops import channel_estimate as t_chest
from srsran_tpu_torch.ops import crc as t_crc
from srsran_tpu_torch.ops import gold as t_gold
from srsran_tpu_torch.ops import ldpc_decode as t_ldpc_dec
from srsran_tpu_torch.ops import ldpc_encode as t_ldpc_enc
from srsran_tpu_torch.ops import llr as t_llr
from srsran_tpu_torch.ops import low_papr as t_papr
from srsran_tpu_torch.ops import polar as t_polar
from srsran_tpu_torch.ops import precoding as t_prec
from srsran_tpu_torch.ops import short_block as t_sb
from srsran_tpu_torch.ops.ldpc_graph import get_graph as t_get_graph
from srsran_tpu_torch.ops.scrambling import scramble_bits
from srsran_tpu_torch.phy.upper import dmrs as t_dmrs
from srsran_tpu_torch.phy.upper import pdcch as t_pdcch
from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
from srsran_tpu_torch.phy.upper import pucch as t_pucch
from srsran_tpu_torch.phy.upper import ssb as t_ssb
from srsran_tpu_torch.phy.upper import uci as t_uci
from srsran_tpu_torch.ran import polar_params as t_pp
from srsran_tpu_torch.ran import prach_params as t_prachp

torch.set_num_threads(2)


def close(got, want, rtol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# ------------------------------------------------------------- K33 polar

# (K, E, nmax, ibil, n_pc): the PBCH (repeat), DCIs at AL 1 (shorten), 2,
# 4, 8, 16 (repeat), UCI with the 3 PC bits (none, puncture), without
# (none, puncture, shorten, repeat) and the widest mother code.
POLAR_CASES = {
    "pbch": (56, 864, 9, False, 0),
    "dci_al1": (64, 108, 9, False, 0),
    "dci_al2": (64, 216, 9, False, 0),
    "dci_al4": (64, 432, 9, False, 0),
    "dci_al8": (64, 864, 9, False, 0),
    "dci_al16": (64, 1728, 9, False, 0),
    "uci_pc_none": (18, 64, 10, True, 3),
    "uci_pc_puncture": (25, 200, 10, True, 3),
    "uci_crc11": (33, 64, 10, True, 0),
    "uci_puncture": (111, 1000, 10, True, 0),
    "uci_shorten": (30, 40, 10, True, 0),
    "uci_repeat": (100, 2000, 10, True, 0),
}


def _codes(case):
    k, e, nmax, ibil, npc = POLAR_CASES[case]
    return (j_pp.polar_code(k, e, nmax=nmax, ibil=ibil, n_pc=npc),
            t_pp.polar_code(k, e, nmax=nmax, ibil=ibil, n_pc=npc))


def _jax_chain(msg, code):
    """JAX allocate -> encode -> rate_match, jitted (eager dispatch of its
    butterfly stages takes seconds on the CPU)."""
    fn = jax.jit(lambda m: j_polar.rate_match(
        j_polar.encode(j_polar.allocate(m, code), code.n), code))
    return np.asarray(fn(jnp.asarray(msg)))


def _replay_k33(msg: np.ndarray, code) -> np.ndarray:
    """csrc/polar_encode.cu's walk of its host tables, in numpy: each
    position's message source, each PC bit the parity of u under its
    source masks, the butterfly, the gather."""
    src, pc, plan = t_polar._encode_tables(
        code.big_n, code.e, code.mode, code.ibil, code.iil,
        tuple(code.info_set.tolist()), t_polar._pc_set(code))
    n, npc = code.big_n, len(t_polar._pc_set(code))
    src = src.reshape(32, 32).T.reshape(-1)[:n]     # position 32t + l
    pc = pc.view(np.uint32)
    masks = pc[:32 * npc].reshape(npc, 32)
    lane_bits = (masks[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    sources = lane_bits.reshape(npc, 1024)[:, :n].astype(bool)
    out = []
    for m in msg:
        u = np.where(src >= 0, m[np.maximum(src, 0)] & 1, 0).astype(np.uint8)
        for p in range(npc):
            u[pc[32 * npc + p]] = np.bitwise_xor.reduce(u[sources[p]],
                                                        initial=0)
        for s in range(code.n):
            q = np.arange(n // 2)
            i0 = (q >> s) * (2 << s) + (q & ((1 << s) - 1))
            u[i0] ^= u[i0 + (1 << s)]
        out.append(u[plan[:code.e]])
    return np.asarray(out, np.int8)


@pytest.mark.parametrize("case", sorted(POLAR_CASES))
def test_polar_encode_chain_matches_jax(case):
    jcode, tcode = _codes(case)
    msg = np.random.default_rng(len(case)).integers(
        0, 2, (3, jcode.k)).astype(np.int8)
    want = _jax_chain(msg, jcode)
    got = t_polar.encode_chain(torch.as_tensor(msg), tcode)
    assert got.dtype == torch.int8 and got.shape == (3, jcode.e)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_replay_k33(msg, tcode), want)


def test_polar_encode_chain_modes_and_interleavers_covered():
    codes = [_codes(c)[1] for c in POLAR_CASES]
    assert {c.mode for c in codes} >= {"puncture", "shorten", "repeat"}
    assert any(c.iil for c in codes) and any(c.ibil for c in codes)
    assert any(c.n_pc for c in codes) and max(c.big_n for c in codes) == 1024


@pytest.mark.parametrize("k,e,qm", [(4, 40, 2), (11, 96, 4), (12, 64, 2),
                                    (16, 120, 1), (19, 90, 6), (20, 160, 2),
                                    (40, 400, 4)])
def test_encode_uci_matches_jax(k, e, qm):
    """<= 11 bits by K34's twin, 12-19 polar with CRC6 and 3 PC bits, >= 20
    polar with CRC11 (uci.py:19-24's rule)."""
    bits = np.random.default_rng(k).integers(0, 2, k).astype(np.int8)
    want = np.asarray(jax.jit(j_uci.encode_uci, static_argnums=(1, 2))(
        jnp.asarray(bits), e, qm))
    np.testing.assert_array_equal(
        t_uci.encode_uci(torch.as_tensor(bits), e, qm).numpy(), want)


@pytest.mark.parametrize("k,nof_rb", [(6, 1), (22, 2), (16, 2)])
def test_transmit_format2_matches_jax(k, nof_rb):
    """The F2 UE side with its own polar rule (pucch.py:456-462)."""
    jcfg = j_pucch.PucchF2Config(rb_start=3, nof_rb=nof_rb, start_symbol=12,
                                 nof_symbols=2, rnti=0x4601, n_id=9, n_id0=3,
                                 nof_uci_bits=k, slot=5)
    bits = np.random.default_rng(k).integers(0, 2, k).astype(np.int8)
    want = np.asarray(j_pucch.transmit_format2(
        jnp.zeros((1, 14, 96), jnp.complex64), jcfg, bits))
    got = t_pucch.transmit_format2(torch.zeros((1, 14, 96),
                                               dtype=torch.complex64),
                                   convert.config(jcfg), bits)
    close(got, want, rtol=1e-6)


@pytest.mark.parametrize("k,occ", [(8, 1), (22, 1), (6, 2)])
def test_f3_encode_matches_jax(k, occ):
    cfg = j_pucch.PucchF3Config(
        rb_start=4, nof_rb=1 if occ > 1 else 2, start_symbol=0,
        nof_symbols=10, rnti=0x55, n_id=7, n_id_hopping=21, nof_uci_bits=k,
        slot=6, occ_length=occ, occ_index=occ - 1)
    uci = np.random.default_rng(k).integers(0, 2, k).astype(np.int8)
    want = np.asarray(jax.jit(j_pucch.f3_encode, static_argnums=1)(
        jnp.asarray(uci), cfg))
    close(t_pucch.f3_encode(torch.as_tensor(uci), convert.config(cfg)), want)


# ------------------------------------------------------- K34 short block

@pytest.mark.parametrize("qm", [1, 2, 4, 6])
@pytest.mark.parametrize("k", range(1, 12))
def test_short_block_encode_matches_jax(k, qm):
    rng = np.random.default_rng(16 * k + qm)
    bits = rng.integers(0, 2, (5, k)).astype(np.int8)
    for e in sorted({k * qm, 3 * qm + 1, 32, 517}):
        want = np.asarray(j_sb.encode(jnp.asarray(bits), e, qm))
        got = t_sb.encode(torch.as_tensor(bits), e, qm)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


def test_short_block_encode_stays_on_device(monkeypatch):
    """No host round trip: the encoder (its CPU twin here) calls neither
    ``.cpu()`` nor ``.numpy()`` on the bits or its intermediates."""
    bits = torch.as_tensor(np.random.default_rng(0).integers(
        0, 2, (4, 7)).astype(np.int8))
    want = t_sb.encode(bits, 64, 2)                      # tables cached

    def refuse(*_a, **_k):
        raise AssertionError("short_block.encode left the device")

    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    for k in (1, 2, 7, 11):
        t_sb.encode(bits[:, :k], 40, 4)
    assert torch.equal(t_sb.encode(bits, 64, 2), want)


# --------------------------------------------------------- PBCH and DCI

SSB_CASES = [(1, 0, 8, 0, False), (500, 3, 8, 777, True),
             (261, 5, 64, 123, False), (7, 1, 4, 42, True)]


@pytest.mark.parametrize("nid,idx,lmax,sfn,hrf", SSB_CASES)
def test_pbch_chain_matches_jax_and_fused(nid, idx, lmax, sfn, hrf):
    kw = dict(phys_cell_id=nid, ssb_idx=idx, l_max=lmax, sfn=sfn, hrf=hrf,
              first_symbol=0, first_subcarrier=0)
    jcfg, tcfg = j_ssb.SsbConfig(**kw), t_ssb.SsbConfig(**kw)
    mib = np.random.default_rng(nid).integers(0, 2, 24).astype(np.int8)
    tmib = torch.as_tensor(mib)
    np.testing.assert_array_equal(t_ssb.pbch_payload(tcfg, tmib).numpy(),
                                  np.asarray(j_ssb.pbch_payload(jcfg, mib)))
    enc = t_ssb.pbch_encode(tcfg, tmib)
    j_encode = jax.jit(j_ssb.pbch_encode, static_argnums=0)
    np.testing.assert_array_equal(enc.numpy(),
                                  np.asarray(j_encode(jcfg, mib)))
    ctx_j = j_ssb.slot_ctx_for(jcfg, sfn=sfn + 5, hrf=not hrf)
    ctx_t = t_ssb.slot_ctx_for(tcfg, sfn=sfn + 5, hrf=not hrf)
    np.testing.assert_array_equal(
        t_ssb.pbch_encode(tcfg, tmib, ctx_t).numpy(),
        np.asarray(j_encode(jcfg, mib, ctx_j)))
    syms = t_ssb.pbch_modulate(enc, tcfg)
    close(syms, j_ssb.pbch_modulate(jnp.asarray(enc.numpy()), jcfg), 1e-6)
    close(t_ssb.pbch_dmrs(tcfg), j_ssb.pbch_dmrs(jcfg), 1e-6)
    # the port's fused K27 twin: the PBCH REs of its patch, bit for bit
    patch = t_ssb.ssb_block_ref(tcfg, tmib).numpy()
    _, data_pos = t_ssb._ssb_re_maps(nid % 4)
    np.testing.assert_array_equal(
        patch[data_pos[:, 0], data_pos[:, 1]].view(np.int32),
        syms.numpy().view(np.int32))


DCI_CASES = [(39, 4, 0x4601, 0, 1), (60, 8, 0xFFFE, 0x4601, 777),
             (12, 1, 1, 0, 0), (128, 16, 17, 17, 2), (40, 2, 0x1234, 0, 5)]


@pytest.mark.parametrize("a,al,rnti,n_rnti,n_id", DCI_CASES)
def test_encode_dci_matches_jax_and_fused(a, al, rnti, n_rnti, n_id):
    kw = dict(rnti=rnti, aggregation_level=al, cce_index=0, payload_bits=a,
              n_id=n_id, n_id_data=n_id, n_rnti=n_rnti)
    jcfg = j_pdcch.PdcchConfig(coreset=j_pdcch.CoresetConfig(
        rb_start=0, nof_rb=96, start_symbol=0, duration=1), **kw)
    tcfg = convert.config(jcfg)
    payload = np.random.default_rng(a).integers(0, 2, a).astype(np.int8)
    enc = t_pdcch.encode_dci(torch.as_tensor(payload), tcfg)
    np.testing.assert_array_equal(
        enc.numpy(), np.asarray(jax.jit(j_pdcch.encode_dci, static_argnums=1)(
            jnp.asarray(payload), jcfg)))
    m, c = t_pdcch._fused_dci_maps(a, 108 * al, rnti, n_rnti, n_id)
    fused = (payload.astype(np.int32) @ m.astype(np.int32) + c) & 1
    scr = scramble_bits(enc[None], ((n_rnti << 16) + n_id) % (1 << 31))[0]
    np.testing.assert_array_equal(scr.numpy(), fused.astype(np.int8))


# ------------------------------------------------- K8 on an irregular comb

TYPE0_PRBS = (2, 3, 4, 7, 8, 12, 13, 14, 15, 20)


def _irregular_case(cdm, seed=3, nof_layers=2, nports=4, delay=7):
    """Pilots of a type 0 PRB list (DM-RS type 1, CDM group 0) on two
    symbols through a channel with a clear delay peak, the second layer
    under the fd-OCC cover when ``cdm``."""
    rng = np.random.default_rng(seed)
    scs = j_dmrs._type1_sc_indices(0, 0, 0, TYPE0_PRBS)
    nsc = 12 * (max(TYPE0_PRBS) + 1)
    n_s, n_k = 2, len(scs)
    gains = (rng.normal(size=(nports, nof_layers, 1))
             + 1j * rng.normal(size=(nports, nof_layers, 1)))
    h = gains * np.exp(-2j * np.pi * np.arange(nsc) * delay / 2048)[None, None]
    exp = np.exp(2j * np.pi * rng.random((nof_layers, n_s, n_k)))
    if cdm:
        exp[1, :, 1::2] *= -1
    rx = (h[:, :, None, scs] * exp[None]).sum(axis=1)
    rx = rx + 0.05 * (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape))
    return rx.astype(np.complex64), exp.astype(np.complex64), scs, nsc


@pytest.mark.parametrize("td", ["average", "interpolate"])
@pytest.mark.parametrize("smoothing", ["filter", "none", "mean"])
@pytest.mark.parametrize("cdm", [False, True])
def test_estimate_irregular_comb_matches_jax(cdm, smoothing, td):
    rx, exp, scs, nsc = _irregular_case(cdm)
    syms = (2, 11)
    kw = dict(stride=2, smoothing=smoothing, estimate_cfo=True,
              dmrs_symbol_times_s=np.array(syms) * 35.7e-6, td_strategy=td,
              dmrs_symbol_idx=np.array(syms), cdm_pairs=cdm)
    want = j_chest.estimate(jnp.asarray(rx), jnp.asarray(exp), scs, nsc, 14,
                            30e3, **kw)
    got = t_chest.estimate(torch.as_tensor(rx), torch.as_tensor(exp), scs,
                           nsc, 14, 30e3, **kw)
    grid = np.zeros((rx.shape[0], 14, nsc + 24), np.complex64)
    for i, s in enumerate(syms):
        grid[:, s, 5 + scs] = rx[:, i]
    from_grid = t_chest.estimate_from_grid_ref(
        torch.as_tensor(grid), syms, 5, torch.as_tensor(exp), scs, nsc, 14,
        30e3, **kw)
    for est in (got, from_grid):
        close(est.coeffs, want.coeffs)
        for name in ("noise_var", "rsrp", "snr", "epre"):
            close(getattr(est, name), getattr(want, name))
        assert float(est.time_alignment_s) == float(want.time_alignment_s)
        assert abs(float(est.cfo_hz) - float(want.cfo_hz)) < 1.0
    assert float(want.time_alignment_s) != 0.0


@pytest.mark.parametrize("cdm", [False, True])
def test_estimate_from_grid_takes_irregular_comb(cdm):
    """The K8 wrapper no longer refuses an irregular comb: on the CPU it
    runs its twin, and the band tables it would hand the kernel reproduce
    the irregular smoothing-interpolation matrix exactly, narrow in
    pilot-index space."""
    rx, exp, scs, nsc = _irregular_case(cdm, seed=5)
    grid = np.zeros((rx.shape[0], 14, nsc), np.complex64)
    grid[:, 2, scs], grid[:, 11, scs] = rx[:, 0], rx[:, 1]
    est = t_chest.estimate_from_grid(torch.as_tensor(grid), (2, 11), 0,
                                     torch.as_tensor(exp), scs, nsc, 14,
                                     30e3, cdm_pairs=cdm)
    assert est.coeffs.shape == (4, 2, 1, nsc)
    scs_sm = (scs[0::2] + scs[1::2]) // 2 if cdm else scs
    for smoothing in ("filter", "none", "mean"):
        stride = 4 if cdm else 2
        m = t_chest._smooth_interp_matrix(tuple(int(s) for s in scs_sm), nsc,
                                          smoothing, stride)
        ints, w = t_chest._comb_tables(
            np.asarray(scs, np.int64).tobytes(), cdm, 5, nsc, smoothing,
            stride)
        first, cols, pilots, ta_idx = np.split(
            ints, np.cumsum([nsc, len(scs), len(scs)]))
        np.testing.assert_array_equal(cols, 5 + scs)
        np.testing.assert_array_equal(pilots, scs)
        np.testing.assert_array_equal(ta_idx, scs_sm)
        band = np.zeros_like(m)
        for n in range(nsc):
            band[n, first[n]:first[n] + w.shape[1]] = w[n]
        np.testing.assert_array_equal(band, m)
        if smoothing != "mean":
            assert w.shape[1] <= 16


# ------------------------------------------------------------- K35 LLRs

def test_llr_quantize_matches_jax():
    rng = np.random.default_rng(0)
    ties = (np.arange(-130, 131) + 0.5) / 6.0          # +-0.5-step ties
    x = np.concatenate([rng.normal(0, 15, 20000), ties, np.arange(-130, 131)
                        / 6.0, [1e9, -1e9, 21.0, -21.0, 0.0, -0.0]]
                       ).astype(np.float32)
    want = np.asarray(j_llr.quantize(jnp.asarray(x)))
    got = t_llr.quantize(torch.as_tensor(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) == 127 and int(got.min()) == -127


def test_llr_dequantize_and_to_float_match_jax():
    q = np.arange(-128, 128).astype(np.int8)
    want = np.asarray(j_llr.dequantize(jnp.asarray(q)))
    got = t_llr.dequantize(torch.as_tensor(q))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(
        t_llr.to_float(torch.as_tensor(q)).numpy(),
        np.asarray(j_llr.to_float(jnp.asarray(q))))
    f = np.linspace(-3, 3, 7, dtype=np.float32)
    np.testing.assert_array_equal(t_llr.to_float(torch.as_tensor(f)).numpy(),
                                  np.asarray(j_llr.to_float(jnp.asarray(f))))


def test_decode_with_quantized_llrs():
    """tests/test_llr_grid.py::test_decode_with_quantized_llrs on the port:
    int8 LLRs through the decoder give the payload."""
    bg, z = 2, 32
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(4, 10 * z)).astype(np.int8)
    code = t_ldpc_enc.encode(torch.as_tensor(bits), bg, z).numpy()
    llr = 6.0 * (1 - 2.0 * code.astype(np.float32))
    llr += rng.normal(0, 1.2, llr.shape).astype(np.float32)
    llr[:, :2 * z] = 0.0
    q = t_llr.to_float(t_llr.quantize(torch.as_tensor(llr)))
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(j_llr.to_float(j_llr.quantize(jnp.asarray(
            llr)))))
    dec, _ = t_ldpc_dec.decode(q, bg, z)
    np.testing.assert_array_equal(dec.numpy()[:, :10 * z], bits)


# --------------------------------------------------------- K36 syndrome

@pytest.mark.parametrize("bg,z", [(1, 8), (2, 16), (1, 64)])
def test_check_parity_matches_jax(bg, z):
    rng = np.random.default_rng(z)
    kb = 22 if bg == 1 else 10
    bits = rng.integers(0, 2, (3, kb * z)).astype(np.int8)
    cw = t_ldpc_enc.encode(torch.as_tensor(bits), bg, z).numpy()
    bad = cw.copy()
    bad[0, 3] ^= 1
    bad[1, -1] ^= 1
    bad[2, kb * z + 5] ^= 1
    x = np.concatenate([cw, bad, rng.integers(0, 2, (1, cw.shape[1]))
                        .astype(np.int8)])
    want = np.asarray(jax.jit(j_ldpc_dec.check_parity, static_argnums=(1, 2))(
        jnp.asarray(x), bg, z))
    got = t_ldpc_dec.check_parity(torch.as_tensor(x), bg, z)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:3].all() and not want[3:].any()


# ------------------------------------------------------ thin counterparts

def test_layer_demap_matches_jax():
    x = (np.random.default_rng(0).normal(size=(2, 3, 4, 10))
         + 0j).astype(np.complex64)
    np.testing.assert_array_equal(
        t_prec.layer_demap(torch.as_tensor(x)).numpy(),
        np.asarray(j_prec.layer_demap(jnp.asarray(x))))
    sym = torch.arange(12, dtype=torch.float32)
    assert torch.equal(t_prec.layer_demap(t_prec.layer_map(sym, 3)), sym)


@pytest.mark.parametrize("m_sc", [12, 36, 72])
def test_low_papr_sequence_and_hopping_match_jax(m_sc):
    np.testing.assert_array_equal(
        t_papr.sequence(5, 0, 0.7, m_sc).numpy(),
        np.asarray(j_papr.sequence(5, 0, 0.7, m_sc)))
    for kw in (dict(), dict(group_hopping_enabled=True, slot=3, symbol=9),
               dict(sequence_hopping_enabled=True, slot=7, symbol=2)):
        for n_id in (0, 31, 1007):
            assert (t_papr.group_hopping(n_id, m_sc=m_sc, **kw)
                    == j_papr.group_hopping(n_id, m_sc=m_sc, **kw))


def test_dmrs_sequence_and_type2_indices_match_jax():
    for kw in (dict(rb_start=3, rb_count=10, symbols=(2, 11), ports=(0, 1),
                    scrambling_id=7, slot_in_frame=4),
               dict(rb_start=0, rb_count=1, symbols=(2,), ports=(0,),
                    scrambling_id=7, prbs=(2, 3, 7, 9), amplitude=1.4)):
        jcfg, tcfg = j_dmrs.DmrsConfig(**kw), t_dmrs.DmrsConfig(**kw)
        for symbol, c_init in ((2, None), (11, 12345)):
            np.testing.assert_array_equal(
                t_dmrs.sequence(tcfg, symbol, c_init).numpy(),
                np.asarray(j_dmrs.sequence(jcfg, symbol, c_init)))
    for args in ((0, 1, 0), (5, 7, 2), (100, 20, 1)):
        np.testing.assert_array_equal(t_dmrs.type2_sc_indices(*args),
                                      j_dmrs.type2_sc_indices(*args))


def test_prg_index_and_c_init_state_match_jax():
    sc = np.arange(0, 12 * 40, 5)
    for rb_start, prg in ((0, 2), (7, 4), (13, 273)):
        np.testing.assert_array_equal(
            t_pdsch.prg_index_of_sc(sc, rb_start, prg),
            j_pdsch.prg_index_of_sc(sc, rb_start, prg))
    c = np.array([0, 1, 0x4601, (1 << 31) - 1], np.uint32)
    np.testing.assert_array_equal(
        t_gold.c_init_state(torch.as_tensor(c.astype(np.int64))).numpy(),
        np.asarray(j_gold.c_init_state(c)))
    np.testing.assert_array_equal(t_gold.c_init_state(77).numpy(),
                                  np.asarray(j_gold.c_init_state(77)))


def test_crc_matrix_and_encode_graph_match_jax():
    for poly, n in (("crc24C", 56), ("crc11", 33), ("crc6", 18)):
        np.testing.assert_array_equal(t_crc.crc_matrix(poly, n).numpy(),
                                      np.asarray(j_crc.crc_matrix(poly, n)))
    bits = np.random.default_rng(1).integers(0, 2, (2, 10 * 16)).astype(
        np.int8)
    np.testing.assert_array_equal(
        t_ldpc_enc.encode_graph(torch.as_tensor(bits),
                                t_get_graph(2, 16)).numpy(),
        np.asarray(j_ldpc_enc.encode_graph(jnp.asarray(bits),
                                           j_get_graph(2, 16))))


def test_prach_configuration_matches_jax():
    for duplex in ("fr1_unpaired", "fr1_paired", "fr2_unpaired"):
        for index in range(0, 256, 17):
            assert (t_prachp.prach_configuration(index, duplex)
                    == j_prachp.prach_configuration(index, duplex))
