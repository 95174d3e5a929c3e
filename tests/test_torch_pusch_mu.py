"""The port's PUSCH receiver beyond ZF with 1-2 layers, against the JAX
package on the CPU: MMSE (1-4 layers) and the L x N Gram solve, the 4-layer
PUSCH on two DM-RS CDM groups, UCI on PUSCH (the TS38.212 §6.2.7 UL-SCH /
UCI demultiplexer with placeholder repair and a punctured HARQ-ACK,
HARQ-ACK and CSI parts 1 and 2, the part-2 size taken from part 1), and the
two-UE UL slot of ``flagship.MU`` at a reduced width.

The same numpy-made inputs go to both.  Tolerances: decoded TB bits, CRC
flags, UCI bits and valid flags, LDPC sweeps, TAs and the demultiplexed
fields equal; equalized symbols and noise within rtol 1e-4 with atol
1e-4 * max|ref| (both invert the Gram matrix by LU with pivoting, the port
through torch.linalg.inv, so only the float32 rounding differs); LLRs and
soft buffers within rtol 1e-3 of max|ref| (as tests/test_torch_frontend.py);
CFO within 1 Hz.  On the CPU every wrapper runs its plain twin (the
kernels K16 and K17 are held to the twins in tests/test_torch_kernels.py
and chip_smoke.py, on the card).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import equalizer as j_eq
from srsran_tpu.ops import ulsch_demux as j_dmx
from srsran_tpu.ops.modulation import BITS_PER_SYMBOL
from srsran_tpu.phy import slot_programs as j_slots
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper import pusch as j_pusch
from srsran_tpu.phy.upper import srs as j_srs
from srsran_tpu.phy.upper import prach as j_prach
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc
from srsran_tpu.ran.uci_on_pusch import (Part2Entry, Part2Parameter,
                                         Part2SizeDescription,
                                         UciOnPuschConfig)

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.ops import equalizer as t_eq
from srsran_tpu_torch.ops import uci_demux
from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
from srsran_tpu_torch.phy.upper import pusch as t_pusch
from srsran_tpu_torch.phy.upper import ue_tx as t_ue_tx

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, rtol=1e-4):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    atol = rtol * float(np.max(np.abs(ref)))
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _cgauss(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape)) / np.sqrt(2)
            ).astype(np.complex64)


# ------------------------------------------------------------ equalizer

def _mimo_case(rng, n_re, p, l, snr_db=25.0):
    """tests/test_equalizer_4layer.py's case: a random channel, unit
    symbols, AWGN at ``snr_db``."""
    h = ((rng.normal(size=(n_re, p, l)) + 1j * rng.normal(size=(n_re, p, l)))
         / np.sqrt(2 * l)).astype(np.complex64)
    x = np.exp(2j * np.pi * rng.random((n_re, l))).astype(np.complex64)
    nv = 10 ** (-snr_db / 10)
    noise = (rng.normal(size=(n_re, p)) + 1j * rng.normal(size=(n_re, p))
             ).astype(np.complex64) * np.sqrt(nv / 2)
    y = np.einsum("rpl,rl->rp", h, x) + noise
    return y.astype(np.complex64), h, x, nv


EQ_CASES = [(1, "mmse"), (2, "mmse"), (3, "zf"), (3, "mmse"), (4, "zf"),
            (4, "mmse")]


@pytest.mark.parametrize("l,method", EQ_CASES)
@pytest.mark.parametrize("tx_scaling", [1.0, 0.8])
def test_equalize_matches_jax(l, method, tx_scaling):
    """The five multi-layer cases of tests/test_equalizer_4layer.py and MMSE
    1 x N on a well-conditioned channel (I + 0.25 (N + jN) per RE, as the
    4-layer PUSCH case): x and the output noise as the JAX dispatch gives
    them."""
    rng = np.random.default_rng(l * 7 + (method == "mmse"))
    y, _, _, nv = _mimo_case(rng, 512, 4, l)
    h = (np.eye(4, l) + 0.25 * _cgauss(rng, (512, 4, l))).astype(np.complex64)
    nvs = np.full(512, nv, np.float32)
    xa, na = j_eq.equalize(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nvs),
                           l, method, tx_scaling)
    xb, nb = t_eq.equalize(_t(y), _t(h), _t(nvs), l, method, tx_scaling)
    assert xb.shape == (512, l) and nb.shape == (512, l)
    close(xb, xa)
    close(nb, na)
    assert np.all(nb.numpy() > 0)


@pytest.mark.parametrize("l,method", EQ_CASES)
def test_equalize_random_channel_matches_jax(l, method):
    """tests/test_equalizer_4layer.py's random channel: the port recovers
    the symbols as JAX does, and agrees with it to 1e-4 on every RE whose
    Gram matrix has a condition number below 100 (on the others, ZF
    amplifies the two LU factorizations' float32 rounding by up to the
    condition number)."""
    rng = np.random.default_rng(l * 7 + (method == "mmse"))
    y, h, x, nv = _mimo_case(rng, 512, 4, l)
    nvs = np.full(512, nv, np.float32)
    xa, na = j_eq.equalize(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nvs),
                           l, method)
    xb, nb = t_eq.equalize(_t(y), _t(h), _t(nvs), l, method)
    assert np.median(np.abs(xb.numpy() - x)) < 0.25
    gram = np.einsum("rpl,rpm->rlm", h.conj(), h)
    ok = np.linalg.cond(gram) < 100
    assert ok.mean() > 0.5
    close(xb.numpy()[ok], np.asarray(xa)[ok])
    close(nb.numpy()[ok], np.asarray(na)[ok])


def test_lxn_matches_closed_form_2layer_zf():
    """The port's L x N solve against its own 2-layer closed form, as
    tests/test_equalizer_4layer.py holds the JAX pair."""
    rng = np.random.default_rng(0)
    y, h, _, nv = _mimo_case(rng, 256, 4, 2)
    nvs = _t(np.full(256, nv, np.float32))
    xa, nva = t_eq.equalize_zf_2xn(_t(y), _t(h), nvs)
    xb, nvb = t_eq.equalize_lxn(_t(y), _t(h), nvs, "zf")
    np.testing.assert_allclose(xb.numpy(), xa.numpy(), atol=2e-3)
    np.testing.assert_allclose(nvb.numpy(), nva.numpy(), rtol=2e-2)


def test_singular_channel_gives_large_noise():
    """A zero channel: the 1e12 guard of both forms, as in the JAX package."""
    y = np.ones((3, 4), np.complex64)
    for l, method in ((1, "mmse"), (3, "zf"), (4, "mmse")):
        h = np.zeros((3, 4, l), np.complex64)
        nv = np.full(3, 0.1, np.float32)
        _, na = j_eq.equalize(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv),
                              l, method)
        _, nb = t_eq.equalize(_t(y), _t(h), _t(nv), l, method)
        np.testing.assert_array_equal(nb.numpy() >= 1e11,
                                      np.asarray(na) >= 1e11)


# ------------------------------------------------------- 4-layer PUSCH

def _four_layer_rx(cfg, seed):
    """tests/test_equalizer_4layer.py's case: the port's transmitter (4
    layers, identity precoding) through I + 0.25 (N + jN), AWGN sigma 0.02."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, cfg.tbs).astype(np.int8)
    ue = t_pdsch.PdschConfig(
        rnti=cfg.rnti, rb_start=cfg.rb_start, rb_count=cfg.rb_count,
        first_symbol=cfg.first_symbol, nof_symbols=cfg.nof_symbols,
        modulation=cfg.modulation, target_code_rate=cfg.target_code_rate,
        tbs=cfg.tbs, nof_layers=4, n_id=cfg.n_id,
        dmrs_symbols=cfg.dmrs_symbols, slot_in_frame=cfg.slot_in_frame)
    tx = t_pdsch.process(torch.zeros((4, 14, 16 * 12), dtype=torch.complex64),
                         _t(payload), ue,
                         precoding=np.eye(4, dtype=np.complex64)).numpy()
    rng2 = np.random.default_rng(1)
    hmat = (np.eye(4) + 0.25 * (rng2.normal(size=(4, 4))
                                + 1j * rng2.normal(size=(4, 4))))
    rx = np.einsum("pl,lsk->psk", hmat, tx)
    rx = rx + (rng.normal(0, 0.02 / np.sqrt(2), rx.shape)
               + 1j * rng.normal(0, 0.02 / np.sqrt(2), rx.shape))
    return rx.astype(np.complex64), payload


@pytest.mark.parametrize("method", ["zf", "mmse"])
def test_pusch_four_layers_matches_jax(method):
    """16 RB, 4 layers on CDM groups 0 and 1 (K8 twice on the card): the
    estimate, the codeword LLRs and the decode equal JAX's."""
    cfg = j_pusch.PuschConfig(rnti=0x17, rb_start=0, rb_count=16,
                              first_symbol=0, nof_symbols=14,
                              modulation="qam16", target_code_rate=0.5,
                              tbs=11272, nof_layers=4, n_id=5,
                              dmrs_symbols=(2, 7, 11), slot_in_frame=3,
                              equalizer=method)
    tcfg = convert.config(cfg)
    rx, payload = _four_layer_rx(cfg, seed=9)
    pil = j_dmrs.pilot_values_for(j_pusch.dmrs_config(cfg))
    ea = j_pusch.estimate_channel(jnp.asarray(rx), cfg, jnp.asarray(pil))
    eb = t_pusch.estimate_channel(_t(rx), tcfg, _t(pil))
    assert eb.coeffs.shape == (4, 4, 1, 192)      # 'average': one estimate
    close(eb.coeffs, ea.coeffs)
    for name in ("noise_var", "rsrp", "snr", "epre"):
        close(getattr(eb, name), getattr(ea, name))
    assert float(eb.time_alignment_s) == float(ea.time_alignment_s)
    assert abs(float(eb.cfo_hz) - float(ea.cfo_hz)) < 1.0
    la, _, va = j_pusch.codeword_llrs(jnp.asarray(rx), cfg, jnp.asarray(pil))
    lb, _, vb = t_pusch.codeword_llrs(_t(rx), tcfg, _t(pil))
    close(lb, la, rtol=1e-3)
    close(vb, va, rtol=1e-3)
    a = j_pusch.decode_from_llrs(la, ea, cfg)
    b = t_pusch.decode_from_llrs(lb, eb, tcfg)
    assert bool(a.tb_crc_ok) and bool(b.tb_crc_ok)
    np.testing.assert_array_equal(b.tb_bits.numpy(), np.asarray(a.tb_bits))
    np.testing.assert_array_equal(b.tb_bits.numpy(), payload)
    np.testing.assert_array_equal(b.cb_crc_ok.numpy(), np.asarray(a.cb_crc_ok))
    assert int(a.nof_iterations) == int(b.nof_iterations)


# ---------------------------------------------------------- UCI on PUSCH

def _uci_cfg(rnti, modulation, rate, tbs, n_id, uci, layers=1):
    return j_pusch.PuschConfig(rnti=rnti, rb_start=0, rb_count=12,
                               first_symbol=0, nof_symbols=14,
                               modulation=modulation, target_code_rate=rate,
                               tbs=tbs, nof_layers=layers, n_id=n_id,
                               dmrs_symbols=(2, 7, 11), uci=uci)


# tests/test_uci_on_pusch.py's cases (rate-matched ACK with and without
# CSI1, a punctured 1-bit ACK, placeholders with a 1-bit ACK on QAM16 and
# with 2 + 2 bits on QAM64), plus UE B of the two-UE slot (ACK, CSI1 and a
# polar CSI2) at 12 RB.
UCI_CASES = {
    "rm_ack4": (_uci_cfg(0x31, "qam16", 0.4, 2152, 3,
                         UciOnPuschConfig(o_ack=4)), 0.05),
    "rm_ack4_csi7": (_uci_cfg(0x31, "qam16", 0.4, 2152, 3,
                              UciOnPuschConfig(o_ack=4, o_csi1=7)), 0.05),
    "rm_ack11_csi4": (_uci_cfg(0x31, "qam16", 0.4, 2152, 3,
                               UciOnPuschConfig(o_ack=11, o_csi1=4)), 0.05),
    "punct_ack1_qpsk": (_uci_cfg(0x32, "qpsk", 0.3, 1096, 3,
                                 UciOnPuschConfig(o_ack=1)), 0.05),
    "placeholder_ack1_qam16": (_uci_cfg(0x41, "qam16", 0.4, 2152, 7,
                                        UciOnPuschConfig(o_ack=1)), 0.04),
    "placeholder_ack2_csi2_qam64": (_uci_cfg(
        0x42, "qam64", 0.4, 3240, 9, UciOnPuschConfig(o_ack=2, o_csi1=2)),
        0.03),
    "ue_b_csi2_polar": (_uci_cfg(0x18, "qam16", 0.5, 2152, 1,
                                 UciOnPuschConfig(o_ack=4, o_csi1=8,
                                                  o_csi2=24)), 0.04),
}


def _uci_rx(cfg, sigma, seed):
    """The port's UE (``ue_tx.pusch_transmit``) onto two rx ports (0.9 and
    0.6 e^{0.4j}) with AWGN ``sigma``; returns (rx, payload, uci bits)."""
    rng = np.random.default_rng(seed)
    u = cfg.uci
    payload = rng.integers(0, 2, cfg.tbs).astype(np.int8)
    bits = {k: (rng.integers(0, 2, n).astype(np.int8) if n else None)
            for k, n in (("ack", u.o_ack), ("csi1", u.o_csi1),
                         ("csi2", u.o_csi2))}
    tx = t_ue_tx.pusch_transmit(convert.config(cfg), payload, bits["ack"],
                                bits["csi1"], bits["csi2"],
                                device="cpu")[0].numpy()
    rx = np.stack([0.9 * tx, 0.6 * np.exp(0.4j) * tx])
    rx = rx + (rng.normal(0, sigma / np.sqrt(2), rx.shape)
               + 1j * rng.normal(0, sigma / np.sqrt(2), rx.shape))
    return rx.astype(np.complex64), payload, bits


def _jax_fields(llr, cfg):
    """The JAX receiver's fields, as its decode_from_llrs gathers them:
    (ACK, CSI1, CSI2, data) LLRs."""
    dcfg = j_pusch.demux_plan(cfg)
    f = j_dmx.field_positions(dcfg)
    qm = BITS_PER_SYMBOL[cfg.modulation]
    bpre = qm * cfg.nof_layers
    c_init = (cfg.rnti << 15) + cfg.n_id
    llr_re = llr.reshape(-1, bpre)
    u = cfg.uci
    pos = f["ack_punct"] if len(f["ack_punct"]) else f["ack"]
    ack = j_pusch._repair_placeholders(llr_re[jnp.asarray(pos)].reshape(-1),
                                       pos, u.o_ack, qm, bpre, c_init,
                                       llr.shape[0])
    csi1 = j_pusch._repair_placeholders(
        llr_re[jnp.asarray(f["csi1"])].reshape(-1), f["csi1"], u.o_csi1, qm,
        bpre, c_init, llr.shape[0])
    csi2 = llr_re[jnp.asarray(f["csi2"])].reshape(-1)
    data = llr_re[jnp.asarray(f["data"])]
    if len(f["ack_punct"]):
        mask = np.isin(f["data"], f["ack_punct"])
        data = jnp.where(jnp.asarray(mask)[:, None], 0.0, data)
    return tuple(np.asarray(v) for v in (ack, csi1, csi2, data.reshape(-1)))


@pytest.mark.parametrize("case", sorted(UCI_CASES))
def test_uci_demux_fields_equal_jax(case):
    """The demultiplexed fields of the same codeword LLRs are exactly JAX's
    (a gather, the placeholder signs and the punctured zeros)."""
    cfg, _ = UCI_CASES[case]
    tcfg = convert.config(cfg)
    dcfg = t_pusch.demux_plan(tcfg)
    g = len(j_dmx.build_class_map(j_pusch.demux_plan(cfg))) * \
        BITS_PER_SYMBOL[cfg.modulation] * cfg.nof_layers
    llr = np.random.default_rng(len(case)).standard_normal(g).astype(
        np.float32)
    want = _jax_fields(jnp.asarray(llr), cfg)
    u = cfg.uci
    got = uci_demux.demux(_t(llr), dcfg, u.o_ack, u.o_csi1,
                          (cfg.rnti << 15) + cfg.n_id)
    assert [v.numel() for v in got] == list(uci_demux.field_sizes(dcfg))
    for a, b, name in zip(got, want, ("ack", "csi1", "csi2", "data")):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("case", sorted(set(UCI_CASES) - {"ue_b_csi2_polar"}))
def test_uci_on_pusch_matches_jax(case):
    """The received PUSCH with UCI: TB bits and CRC, HARQ-ACK, CSI1 and
    CSI2 bits and valid flags equal JAX's, and the bits as sent (UE B's
    polar CSI2 runs end to end in the two-UE slot below)."""
    cfg, sigma = UCI_CASES[case]
    rx, payload, sent = _uci_rx(cfg, sigma, seed=len(case))
    a = j_pusch.process(jnp.asarray(rx), cfg)
    b = t_pusch.process(_t(rx), convert.config(cfg))
    assert bool(a.tb_crc_ok) and bool(b.tb_crc_ok)
    np.testing.assert_array_equal(b.tb_bits.numpy(), np.asarray(a.tb_bits))
    np.testing.assert_array_equal(b.tb_bits.numpy(), payload)
    for key, name in (("harq_ack", "ack"), ("csi1", "csi1"),
                      ("csi2", "csi2")):
        ja, tb = getattr(a, f"{key}_bits"), getattr(b, f"{key}_bits")
        if sent[name] is None:
            assert ja is None and tb is None
            continue
        np.testing.assert_array_equal(tb.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), sent[name])
        assert bool(getattr(b, f"{key}_valid")) == \
            bool(getattr(a, f"{key}_valid")) is True


def test_part2_feedback_matches_jax():
    """tests/test_uci_on_pusch.py's part-2 case: the receiver's PDU has
    o_csi2 = 0, part 1's first bit selects 4 or 7 part-2 bits; both sizes
    come back exact and equal JAX's."""
    descr = Part2SizeDescription(
        (Part2Entry((Part2Parameter(0, 1),), (4, 7)),))
    rng = np.random.default_rng(93)
    for first in (0, 1):
        csi1 = np.array([first, 1, 0, 1], dtype=np.int8)
        o_csi2 = (4, 7)[first]
        csi2 = rng.integers(0, 2, o_csi2).astype(np.int8)
        cfg = _uci_cfg(0x43, "qam16", 0.4, 2152, 5,
                       UciOnPuschConfig(o_csi1=4, o_csi2=o_csi2))
        payload = rng.integers(0, 2, cfg.tbs).astype(np.int8)
        tx = t_ue_tx.pusch_transmit(convert.config(cfg), payload, None, csi1,
                                    csi2, device="cpu")[0].numpy()
        rx = np.stack([tx, 0.8 * tx])
        rx = (rx + (rng.normal(0, 0.04 / np.sqrt(2), rx.shape)
                    + 1j * rng.normal(0, 0.04 / np.sqrt(2), rx.shape))
              ).astype(np.complex64)
        rx_cfg = dataclasses.replace(
            cfg, uci=UciOnPuschConfig(o_csi1=4, o_csi2=0))
        a = j_pusch.process_with_part2_feedback(jnp.asarray(rx), rx_cfg,
                                                descr)
        b = t_pusch.process_with_part2_feedback(
            _t(rx), convert.config(rx_cfg), convert.config(descr))
        assert bool(b.tb_crc_ok) and bool(a.tb_crc_ok)
        np.testing.assert_array_equal(b.tb_bits.numpy(), payload)
        for key, sent in (("csi1", csi1), ("csi2", csi2)):
            got = getattr(b, f"{key}_bits").numpy()
            np.testing.assert_array_equal(got, np.asarray(
                getattr(a, f"{key}_bits")))
            np.testing.assert_array_equal(got, sent)
            assert bool(getattr(b, f"{key}_valid"))
        assert b.harq_ack_bits is None


def test_part2_feedback_needs_csi1():
    cfg = convert.config(_uci_cfg(0x43, "qam16", 0.4, 2152, 5,
                                  UciOnPuschConfig(o_ack=2)))
    with pytest.raises(ValueError, match="part 1"):
        t_pusch.process_with_part2_feedback(
            torch.zeros((2, 14, 144), dtype=torch.complex64), cfg, None)


# ------------------------------------------------- the two-UE UL slot

J_CELL = j_slots.CellConfig(nof_ports=4, nof_rb=36, dft_size=512,
                            numerology=1)
J_UE_A = j_pusch.PuschConfig(
    rnti=0x17, rb_start=0, rb_count=24, first_symbol=0, nof_symbols=14,
    modulation="qam64", target_code_rate=0.6,
    tbs=tbs_calc(24, 14, 36, "qam64", 0.6, 4), nof_layers=4, n_id=1,
    dmrs_symbols=(2, 7, 11), equalizer="mmse")
J_UE_B = j_pusch.PuschConfig(
    rnti=0x18, rb_start=24, rb_count=8, first_symbol=0, nof_symbols=14,
    modulation="qam16", target_code_rate=0.5,
    tbs=tbs_calc(8, 14, 36, "qam16", 0.5, 1), nof_layers=1, n_id=1,
    dmrs_symbols=(2, 7, 11), equalizer="mmse",
    uci=UciOnPuschConfig(o_ack=4, o_csi1=8))
J_F1 = j_pucch.PucchF1Config(prb=0, start_symbol=0, nof_symbols=14,
                             initial_cyclic_shift=0, time_domain_occ=0,
                             n_id=1)
J_PRACH = j_prach.PrachConfig(format="B4", root_sequence_index=39,
                              zero_correlation_zone=10, ra_scs_hz=30_000)
J_SRS = j_srs.SrsConfig(rb_start=32, rb_count=4, start_symbol=13,
                        nof_symbols=1, comb=2, comb_offset=0, cyclic_shift=0,
                        nof_ports=1, sequence_id=1, numerology=1, rnti=0x17)
SMALL_MU = flagship.MuScenario(
    cell=convert.config(J_CELL), pusch_a=convert.config(J_UE_A),
    pusch_b=convert.config(J_UE_B), pucch=convert.config(J_F1),
    prach=convert.config(J_PRACH), srs=convert.config(J_SRS))


def test_small_scenario_is_the_flagship_cut_to_size():
    """The reduced scenario keeps the flagship MU's every field but the
    cell width, the RB ranges and the TBS (TS38.214 at the new widths)."""
    full = flagship.MU
    for mine, theirs in ((SMALL_MU.pusch_a, full.pusch_a),
                         (SMALL_MU.pusch_b, full.pusch_b)):
        assert dataclasses.replace(
            mine, rb_start=theirs.rb_start, rb_count=theirs.rb_count,
            tbs=theirs.tbs) == theirs
    assert full.pusch_a.tbs == tbs_calc(205, 14, 36, "qam64", 0.6, 4)
    assert full.pusch_b.tbs == tbs_calc(64, 14, 36, "qam16", 0.5, 1)
    assert (t_pusch.segmentation(full.pusch_a).nof_codeblocks,
            t_pusch.segmentation(full.pusch_b).nof_codeblocks) == (47, 3)
    assert SMALL_MU.pucch == full.pucch and SMALL_MU.prach == full.prach
    assert dataclasses.replace(SMALL_MU.srs, rb_start=full.srs.rb_start) == \
        full.srs


def test_flagship_ue_b_uci_budgets():
    """UE B's UCI REs at full width, from its demux plan: ACK 26, CSI1 25,
    CSI2 56 (12 bits) or 109 (24 bits), one QAM16 layer (E = 4 x REs)."""
    for ri, q_csi2 in ((0, 56), (1, 109)):
        d = t_pusch.demux_plan(flagship.MU.ue_b(ri))
        assert (d.q_ack, d.q_csi1, d.q_csi2) == (26, 25, q_csi2)
        assert uci_demux.field_sizes(d)[:3] == (104, 100, 4 * q_csi2)


def _j_ctx(ctx):
    """The port's slot context as the JAX program takes it."""
    return {"pusch": tuple(jnp.asarray(p.numpy()) for p in ctx["pusch"]),
            "f0": (), "f2": (), "f3": (),
            "f1": tuple(tuple(tuple(jnp.asarray(w.numpy()) for w in hop)
                              for hop in e) for e in ctx["f1"])}


@pytest.fixture(scope="module")
def mu_slot():
    """One two-UE slot of the reduced scenario (RI 1: 24 CSI2 bits, polar)
    through the port's UL program and the JAX one, on the same samples."""
    rng = np.random.default_rng(4)
    gen = torch.Generator()
    gen.manual_seed(4)
    slots = flagship.make_mu_slots(2, rng, gen, "cpu", SMALL_MU)
    (slot,) = [s for s in slots if s["uci"]["ri"] == 1][:1]
    ri = slot["uci"]["ri"]
    fd = flagship.prach_capture(np.random.default_rng(0))
    softs = flagship.mu_soft_buffers("cpu", SMALL_MU)
    got = flagship.mu_program(ri, SMALL_MU)(slot["rx"], (_t(fd),), softs,
                                            slot["ctx"])
    j_b = dataclasses.replace(
        J_UE_B, uci=dataclasses.replace(J_UE_B.uci,
                                        o_csi2=flagship.CSI2_SIZES[ri]))
    plan = ((J_UE_A, j_b), (), (J_F1,), (), (J_PRACH,), (J_SRS,), ())
    ref = j_slots.ul_slot_fn(J_CELL, plan)(
        jnp.asarray(slot["rx"].numpy()), (jnp.asarray(fd),),
        tuple(jnp.asarray(s.numpy()) for s in softs), _j_ctx(slot["ctx"]))
    return dict(got=got, ref=ref, slot=slot)


UL_EQUAL = {"tb_bits", "tb_crc_ok", "nof_iterations", "ta_s", "detected",
            "harq_bits", "harq_ack_bits", "harq_ack_valid", "csi1_bits",
            "csi1_valid", "csi2_bits", "csi2_valid"}


@pytest.mark.parametrize("kind", ["pusch", "pucch_f1", "prach", "srs"])
def test_mu_slot_matches_jax(mu_slot, kind):
    """Every key of every entry of the two-UE slot: decisions and UCI bits
    equal, CFO within 1 Hz, soft buffers and EVM within 1e-3 (the 4-layer
    LLRs), other floats within 1e-4."""
    got, ref = mu_slot["got"][kind], mu_slot["ref"][kind]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r), kind
        for key in r:
            a, b = g[key].numpy(), np.asarray(r[key])
            assert a.shape == b.shape, (kind, key)
            if kind == "prach" and key == "ta_s":
                # XLA's jit turns the division by the constant N * scs into
                # a multiply by its reciprocal (1 ulp), as in
                # tests/test_torch_ul_mix.py
                np.testing.assert_allclose(a, b, rtol=2e-7, atol=0)
            elif key in UL_EQUAL:
                np.testing.assert_array_equal(a, b, err_msg=f"{kind} {key}")
            elif key == "cfo_hz":
                assert abs(float(a) - float(b)) < 1.0
            else:
                close(a, b, rtol=1e-3 if key in ("new_soft", "evm")
                      else 1e-4)


def test_mu_slot_decodes_everything_sent(mu_slot):
    flagship.check_mu_slot(mu_slot["got"], mu_slot["slot"], "reduced slot")
    assert mu_slot["got"]["pusch"][1]["csi2_bits"].numel() == 24


@pytest.mark.slow
def test_flagship_mu_slot_on_cpu_twins():
    """The full-width two-UE slot (273 RB, 4096-point FFT; UE A 4 layers on
    205 RB, TBS 393272; UE B with ACK, CSI1 and both CSI2 sizes) end to end
    on the CPU twins."""
    rng = np.random.default_rng(0)
    gen = torch.Generator()
    gen.manual_seed(0)
    slots = flagship.make_mu_slots(2, rng, gen, "cpu")
    fd = flagship.prach_fd("cpu")
    for s in slots:
        out = flagship.mu_program(s["uci"]["ri"])(
            s["rx"], fd, flagship.mu_soft_buffers("cpu"), s["ctx"])
        flagship.check_mu_slot(out, s, "flagship two-UE slot")


def test_mu_slot_through_the_conductor_matches_jax(mu_slot):
    """The same slot as a FAPI UL_TTI.request through the JAX conductor and
    the port's (on the CPU): validation, normalize_ul_plan, the packed UCI
    fields and the indications (CRC, RX_Data, UCI.indication from the
    PUSCH) equal; the SlotResults hold every bit as sent."""
    from srsran_tpu.fapi import conductor as j_cond
    from srsran_tpu.fapi.messages import UlTtiRequest
    from srsran_tpu.ran.slot_point import SlotPoint
    from srsran_tpu_torch.fapi import conductor as t_cond
    slot = mu_slot["slot"]
    ri = slot["uci"]["ri"]
    sp = SlotPoint(1, 0)                    # make_mu_slots' slot 0
    j_b = dataclasses.replace(J_UE_B, uci=dataclasses.replace(
        J_UE_B.uci, o_csi2=flagship.CSI2_SIZES[ri]))
    ul = UlTtiRequest(slot=sp, pusch=(J_UE_A, j_b), pucch_f1=(J_F1,),
                      prach=(J_PRACH,), srs=(J_SRS,))
    fd = flagship.prach_capture(np.random.default_rng(0))
    rx = slot["rx"].numpy()
    ref = j_cond.SlotConductor(J_CELL).process_ul(
        ul, jnp.asarray(rx), (jnp.asarray(fd),)).resolve()
    got = t_cond.SlotConductor(convert.config(J_CELL), device="cpu"
                               ).process_ul(convert.requests(ul), _t(rx),
                                            (_t(fd),)).resolve()
    convert.slot_results(ref, got, rtol=1e-3)
    assert [c.tb_crc_ok for c in got.crc] == [True, True]
    (u,) = [u for u in got.uci if u.source == "pusch"]
    assert u.rnti == J_UE_B.rnti
    for sent, bits in ((slot["uci"]["ack"], u.harq_bits),
                       (slot["uci"]["csi1"], u.csi_bits),
                       (slot["uci"]["csi2"], u.csi2_bits)):
        np.testing.assert_array_equal(bits, sent)
