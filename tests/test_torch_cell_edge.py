"""The cell-edge UL path of the port against the JAX package on the CPU:
transform precoding (DFT-s-OFDM), PUSCH intra-slot frequency hopping,
pi/2-BPSK and BPSK demap and EVM, PUCCH F3/F4, and the cell-edge slot of
``flagship.EDGE`` cut to a 52-RB, 2-port cell (1024-point FFT, 30 kHz),
through ``ul_slot_fn``, both ``SlotConductor``s and ``process_slot_batch``.

The same numpy-made inputs go to both.  Tolerances: decoded TB bits, CRC
flags, HARQ-ACK and UCI bits and valid flags, LDPC sweeps and TAs equal;
channel coefficients within atol 1e-5; the symbols after the IDFT within
atol 1e-4 of their largest magnitude (the K16 tolerance of PERF.md §6);
LLRs and soft buffers within 1e-3 of their largest magnitude; EVM rtol
1e-4; CFO within 1 Hz.  On the CPU every wrapper runs its plain twin (K18
and K19 are held to the twins in tests/test_torch_kernels.py and
chip_smoke.py, on the card).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.fapi import conductor as j_cond
from srsran_tpu.fapi.messages import UlTtiRequest
from srsran_tpu.ops import evm as j_evm
from srsran_tpu.ops import modulation as j_mod
from srsran_tpu.ops import transform_precode as j_tp
from srsran_tpu.phy import slot_programs as j_slots
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import prach as j_prach
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper import pusch as j_pusch
from srsran_tpu.phy.upper import srs as j_srs
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc
from srsran_tpu.ran.slot_point import SlotPoint
from srsran_tpu.ran.uci_on_pusch import UciOnPuschConfig

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.fapi import messages as t_msgs
from srsran_tpu_torch.ops import evm as t_evm
from srsran_tpu_torch.ops import modulation as t_mod
from srsran_tpu_torch.ops import transform_precode as t_tp
from srsran_tpu_torch.phy.upper import pucch as t_pucch
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


def _cgauss(rng, shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


# ------------------------------------------------- transform precoding

@pytest.mark.parametrize("m", [12, 36, 72, 180, 3240])
def test_transform_precode_matches_jax(m):
    """precode and deprecode against the JAX matmuls, within 1e-4 of the
    largest magnitude, and the IDFT's twiddle table against the matrix."""
    x = _cgauss(np.random.default_rng(m), (2 if m > 1000 else 4, m))
    close(t_tp.precode(_t(x)), j_tp.precode(jnp.asarray(x)))
    close(t_tp.deprecode(_t(x)), j_tp.deprecode(jnp.asarray(x)))
    if m <= 180:
        k, n = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
        np.testing.assert_allclose(t_tp.twiddles(m)[(k * n) % m]
                                   / np.sqrt(m), j_tp._dft_mat(m, True),
                                   atol=1e-6)


@pytest.mark.parametrize("scheme", ["bpsk", "pi2bpsk"])
def test_bpsk_demap_and_evm_match_jax(scheme):
    """The BPSK forms: modulate, demap (pi/2-BPSK derotated by the index
    along the codeword) and the EVM from the LLRs' hard decisions."""
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (1, 301)).astype(np.int8)
    sym = np.asarray(j_mod.modulate(jnp.asarray(bits), scheme))
    np.testing.assert_array_equal(t_mod.modulate(_t(bits), scheme).numpy(),
                                  sym)
    noisy = (sym + 0.3 * _cgauss(rng, sym.shape)).astype(np.complex64)
    nv = np.full(noisy.shape, 0.09, np.float32)
    ref = j_mod.demodulate(jnp.asarray(noisy), jnp.asarray(nv), scheme)
    got = t_mod.demodulate(_t(noisy), _t(nv), scheme)
    close(got, ref, rtol=1e-6)
    close(t_evm.evm(_t(noisy), got, scheme),
          j_evm.evm(jnp.asarray(noisy), ref, scheme))


# ------------------------------------------------------------ PUSCH

def _pusch_rx(cfg, seed, sigma=0.04, ack=None, nsc=480):
    """The UE's grid (the port's ``ue_tx.pusch_transmit``) through
    tests/test_freq_hopping.py's per-hop 2-port channels with AWGN; the
    payload."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, cfg.tbs).astype(np.int8)
    tx = t_ue_tx.pusch_transmit(convert.config(cfg), payload, ack,
                                nof_sc=nsc, device="cpu").numpy()
    n1 = cfg.first_symbol + cfg.nof_symbols // 2
    h1 = np.array([0.9 * np.exp(0.4j), 0.6 * np.exp(-0.2j)])
    h2 = (np.array([0.5 * np.exp(1.2j), 0.8 * np.exp(0.9j)])
          if cfg.second_hop_prb is not None else h1)
    rx = np.zeros((2, 14, nsc), dtype=np.complex64)
    rx[:, :n1] = h1[:, None, None] * tx[0, :n1][None]
    rx[:, n1:] = h2[:, None, None] * tx[0, n1:][None]
    rx += sigma / np.sqrt(2) * (rng.normal(size=rx.shape)
                                + 1j * rng.normal(size=rx.shape))
    return rx.astype(np.complex64), payload


def _j_pusch(grid, cfg):
    """The JAX receive, jitted as one program (the JAX package's functions
    unchanged): LLRs, estimate, EVM, then the decode from those LLRs."""
    llr, est, evm_val = j_pusch.codeword_llrs(grid, cfg)
    res = j_pusch.decode_from_llrs(llr, est, cfg, evm_val=evm_val)
    return (llr, est.coeffs, est.noise_var, evm_val, res.tb_bits,
            res.tb_crc_ok, res.nof_iterations, res.harq_ack_bits,
            res.harq_ack_valid)


def _hold_pusch(cfg, rx, payload, ack=None):
    """The port's PUSCH receive against the JAX package's on one grid:
    estimate, LLRs, EVM, decoded bits and HARQ-ACK."""
    tcfg = convert.config(cfg)
    (la, coeffs, noise, va, tb_bits, crc_ok, iters, ack_bits,
     ack_ok) = jax.jit(_j_pusch, static_argnums=1)(jnp.asarray(rx), cfg)
    lb, eb, vb = t_pusch.codeword_llrs(_t(rx), tcfg)
    np.testing.assert_allclose(eb.coeffs.numpy(), np.asarray(coeffs),
                               rtol=0, atol=1e-5)
    close(eb.noise_var, noise)
    close(lb, la, rtol=1e-3)
    close(vb, va)
    b = t_pusch.decode_from_llrs(lb, eb, tcfg, evm_val=vb)
    assert bool(crc_ok) and bool(b.tb_crc_ok)
    np.testing.assert_array_equal(b.tb_bits.numpy(), np.asarray(tb_bits))
    np.testing.assert_array_equal(b.tb_bits.numpy(), payload)
    assert int(iters) == int(b.nof_iterations)
    if ack is not None:
        np.testing.assert_array_equal(b.harq_ack_bits.numpy(),
                                      np.asarray(ack_bits))
        np.testing.assert_array_equal(b.harq_ack_bits.numpy(), ack)
        assert bool(ack_ok) and bool(b.harq_ack_valid)


# tests/test_ptrs_evm_tp.py::test_transform_precoded_pusch's PDU
J_TP = j_pusch.PuschConfig(
    rnti=0x19, rb_start=0, rb_count=12, first_symbol=0, nof_symbols=14,
    modulation="qpsk", target_code_rate=0.3, tbs=1288, nof_layers=1,
    n_id=4, dmrs_symbols=(2, 7, 11), dmrs_scrambling_id=7,
    transform_precoding=True)
# tests/test_freq_hopping.py::test_pusch_frequency_hopping_loopback's PDU
J_HOP = j_pusch.PuschConfig(
    rnti=0x21, rb_start=0, rb_count=12, first_symbol=0, nof_symbols=14,
    modulation="qpsk", target_code_rate=0.3, tbs=1544, nof_layers=1,
    n_id=3, dmrs_symbols=(2, 9), second_hop_prb=24)


@pytest.mark.parametrize("modulation,tbs", [("qpsk", 1288),
                                            ("pi2bpsk", 640)])
def test_transform_precoded_pusch_matches_jax(modulation, tbs):
    cfg = dataclasses.replace(J_TP, modulation=modulation, tbs=tbs)
    rx, payload = _pusch_rx(cfg, 1, nsc=144)
    _hold_pusch(cfg, rx, payload)


def test_ue_tx_builds_the_jax_tests_grids():
    """The port's UE transmitter with transform precoding and with hopping
    equals the grids the JAX tests build by hand (the per-symbol DFT and the
    low-PAPR DM-RS on comb 0; hop 2 on its PRBs with its own pilots)."""
    from srsran_tpu.ops.low_papr import base_sequence
    from srsran_tpu.ops.modulation import modulate
    from srsran_tpu.ops.scrambling import scramble_bits
    from srsran_tpu.phy.upper.pdsch import (PdschConfig, _data_re_plan,
                                            encode_transport_block)
    from srsran_tpu.phy.upper.pdsch import process as pdsch_process
    payload = np.random.default_rng(1).integers(0, 2, J_TP.tbs).astype(np.int8)
    tx_cfg = PdschConfig(rnti=J_TP.rnti, rb_start=0, rb_count=12,
                         first_symbol=0, nof_symbols=14, modulation="qpsk",
                         target_code_rate=0.3, tbs=J_TP.tbs, nof_layers=1,
                         n_id=J_TP.n_id, dmrs_symbols=J_TP.dmrs_symbols)
    cw, _ = encode_transport_block(jnp.asarray(payload), tx_cfg)
    scr = scramble_bits(cw[None], (J_TP.rnti << 15) + J_TP.n_id)
    syms = np.asarray(modulate(scr, "qpsk"))[0]
    blocks = np.asarray(j_tp.precode(jnp.asarray(syms.reshape(-1, 144))))
    grid = np.zeros((1, 14, 144), dtype=np.complex64)
    plan = _data_re_plan(0, 12, 0, 14, J_TP.dmrs_symbols, 2)
    grid[0, plan[:, 0], plan[:, 1]] = blocks.reshape(-1)
    for l in J_TP.dmrs_symbols:
        grid[0, l, 0:144:2] = base_sequence(7, 0, 72)
    got = t_ue_tx.pusch_transmit(convert.config(J_TP), payload, nof_sc=144,
                                 device="cpu").numpy()
    np.testing.assert_allclose(got, grid, atol=1e-6)

    payload = np.random.default_rng(0).integers(0, 2, J_HOP.tbs).astype(np.int8)
    base = dataclasses.replace(tx_cfg, rnti=J_HOP.rnti, tbs=J_HOP.tbs,
                               n_id=J_HOP.n_id, dmrs_symbols=(2, 9))
    g0 = np.asarray(pdsch_process(
        jnp.zeros((1, 14, 480), dtype=jnp.complex64), jnp.asarray(payload),
        base, precoding=np.eye(1, dtype=np.complex64)))
    tx = np.zeros_like(g0)
    tx[:, :7, :144] = g0[:, :7, :144]
    tx[:, 7:, 288:432] = g0[:, 7:, :144]
    d2 = j_dmrs.DmrsConfig(rb_start=24, rb_count=12, symbols=(9,), ports=(0,),
                           scrambling_id=0, n_scid=0)
    tx[0, 9, :] = 0
    tx[0, 9, j_dmrs._type1_sc_indices(24, 12, 0)] = np.asarray(
        j_dmrs.pilots_for_port(d2, 0))[0]
    got = t_ue_tx.pusch_transmit(convert.config(J_HOP), payload, nof_sc=480,
                                 device="cpu").numpy()
    np.testing.assert_allclose(got, tx, atol=1e-6)


@pytest.mark.parametrize("equalizer", ["zf", "mmse"])
@pytest.mark.parametrize("o_ack", [0, 2])
def test_hopping_pusch_matches_jax(equalizer, o_ack):
    """Each hop estimated on its own and demapped through its own RE plan,
    hop 2 descrambled from where hop 1 ended; the HARQ-ACK demultiplexed
    over both hops."""
    cfg = dataclasses.replace(J_HOP, equalizer=equalizer,
                              uci=UciOnPuschConfig(o_ack=o_ack))
    ack = (np.array([1, 0], np.int8) if o_ack else None)
    rx, payload = _pusch_rx(cfg, 0, ack=ack)
    _hold_pusch(cfg, rx, payload, ack)


@pytest.mark.parametrize("hop", [None, 24])
@pytest.mark.parametrize("layers,tbs", [(1, 640), (2, 1288)])
@pytest.mark.parametrize("modulation", ["bpsk", "pi2bpsk"])
def test_bpsk_pusch_matches_jax(modulation, layers, tbs, hop):
    """BPSK and pi/2-BPSK without transform precoding (K3 on the card):
    pi/2-BPSK's derotation counts codeword symbols, layer-minor, across
    both hops; the estimate, LLRs, EVM and the decode equal JAX's."""
    cfg = dataclasses.replace(J_HOP, modulation=modulation, tbs=tbs,
                              nof_layers=layers, second_hop_prb=hop)
    rx, payload = flagship.bpsk_rx(convert.config(cfg), 3, 480)
    _hold_pusch(cfg, rx, payload)


@pytest.mark.parametrize("equalizer", ["zf", "mmse"])
def test_hopping_transform_precoded_pusch_matches_jax(equalizer):
    """Both together, with 2 HARQ-ACK bits (UE C of flagship.EDGE)."""
    cfg = dataclasses.replace(J_HOP, transform_precoding=True,
                              dmrs_scrambling_id=7, equalizer=equalizer,
                              uci=UciOnPuschConfig(o_ack=2))
    ack = np.array([0, 1], np.int8)
    rx, payload = _pusch_rx(cfg, 2, ack=ack)
    _hold_pusch(cfg, rx, payload, ack)


def test_transform_precoding_is_single_layer():
    """Where the JAX receiver asserts (pusch.py:179), the port raises."""
    cfg = dataclasses.replace(J_TP, nof_layers=3)
    rx = np.zeros((2, 14, 144), np.complex64)
    with pytest.raises(AssertionError):
        j_pusch.process(jnp.asarray(rx), cfg)
    with pytest.raises(ValueError, match="single-layer"):
        t_pusch.process(_t(rx), convert.config(cfg))


# ------------------------------------------------------------ PUCCH F3/F4

@pytest.mark.parametrize("k,pi2,occ", [(8, False, 1), (16, False, 1),
                                       (22, True, 1), (6, False, 2),
                                       (6, False, 4)])
def test_pucch_f3_f4_matches_jax(k, pi2, occ):
    """tests/test_pucch_f3_srs.py::test_pucch_f3_f4_loopback's cases and
    OCC 4: the UE side (f3_encode), the stride-1 estimate, the LLRs and the
    decoded UCI."""
    cfg = j_pucch.PucchF3Config(
        rb_start=4, nof_rb=1 if occ > 1 else 3, start_symbol=0,
        nof_symbols=10, rnti=0x55, n_id=7, n_id_hopping=21,
        nof_uci_bits=k, slot=6, pi2_bpsk=pi2, occ_length=occ,
        occ_index=occ - 1)
    tcfg = convert.config(cfg)
    rng = np.random.default_rng(k)
    uci = rng.integers(0, 2, k).astype(np.int8)
    tx = np.asarray(jax.jit(j_pucch.f3_encode, static_argnums=1)(
        jnp.asarray(uci), cfg))
    close(t_pucch.f3_encode(_t(uci), tcfg), tx)
    g = np.zeros((2, 14, 120), dtype=np.complex64)
    ch = np.array([0.9 * np.exp(0.2j), 0.7 * np.exp(-0.7j)])
    sc = slice(cfg.rb_start * 12, cfg.rb_start * 12 + cfg.nof_rb * 12)
    for s in range(cfg.nof_symbols):
        g[:, cfg.start_symbol + s, sc] = ch[:, None] * tx[s][None, :]
    g += 0.03 * (rng.normal(size=g.shape) + 1j * rng.normal(size=g.shape))
    g = g.astype(np.complex64)
    a = jax.jit(j_pucch.process_format3, static_argnums=1)(jnp.asarray(g),
                                                           cfg)
    vals = t_pucch.f3_dmrs_values_for(tcfg)
    np.testing.assert_array_equal(vals, j_pucch.f3_dmrs_values_for(cfg))
    b = t_pucch.process_format3(_t(g), tcfg)
    assert bool(a["valid"]) and bool(b["valid"])
    np.testing.assert_array_equal(b["uci_bits"].numpy(),
                                  np.asarray(a["uci_bits"]))
    np.testing.assert_array_equal(b["uci_bits"].numpy(), uci)
    close(b["metric"], a["metric"])
    # the LLRs behind them: the JAX steps of process_format3, then K19's twin
    from srsran_tpu.ops import channel_estimate as j_chest
    m = cfg.nof_rb * 12
    dmrs_rel, _ = j_pucch._f3_symbol_split(cfg)
    rx_pil = np.stack([g[:, s, sc] for s in dmrs_rel], axis=1)
    est = jax.jit(lambda r, v: j_chest.estimate(
        r, v, np.arange(m), nof_sc=m, nof_symbols=cfg.nof_symbols,
        scs_hz=30e3, stride=1, smoothing="filter", estimate_cfo=False
    ).coeffs)(jnp.asarray(rx_pil), jnp.asarray(vals[None]))
    args, kw = t_pucch.f3_estimate_args(_t(g), tcfg, _t(vals))
    from srsran_tpu_torch.ops import channel_estimate as t_chest
    t_est = t_chest.estimate_from_grid(*args, **kw)
    np.testing.assert_allclose(t_est.coeffs.numpy(), np.asarray(est),
                               rtol=0, atol=1e-5)
    llr = t_pucch.f3_demap(_t(g), t_est.coeffs, t_est.noise_var, tcfg)
    assert llr.shape == (len(t_pucch._f3_symbol_split(tcfg)[1]) * m // occ
                         * (1 if pi2 else 2),)


# ------------------------------------------------- the cell-edge slot

J_CELL = j_slots.CellConfig(nof_ports=2, nof_rb=52, dft_size=1024,
                            numerology=1)
J_UE_A = j_pusch.PuschConfig(
    rnti=0x17, rb_start=0, rb_count=28, first_symbol=0, nof_symbols=14,
    modulation="qam64", target_code_rate=0.7,
    tbs=tbs_calc(28, 14, 36, "qam64", 0.7, 2), nof_layers=2, n_id=1,
    dmrs_symbols=(2, 7, 11), numerology=1)
J_UE_C = j_pusch.PuschConfig(
    rnti=0x19, rb_start=28, rb_count=6, first_symbol=0, nof_symbols=14,
    modulation="qpsk", target_code_rate=0.3, tbs=528, nof_layers=1, n_id=1,
    dmrs_symbols=(2, 9), numerology=1, equalizer="mmse",
    uci=UciOnPuschConfig(o_ack=2), transform_precoding=True,
    second_hop_prb=40)
J_F3 = j_pucch.PucchF3Config(rb_start=34, nof_rb=2, start_symbol=0,
                             nof_symbols=14, rnti=0x1a, n_id=1,
                             n_id_hopping=1, nof_uci_bits=22, pi2_bpsk=True)
J_F4 = j_pucch.PucchF3Config(rb_start=36, nof_rb=1, start_symbol=2,
                             nof_symbols=12, rnti=0x1b, n_id=1,
                             n_id_hopping=1, nof_uci_bits=8, occ_length=2,
                             occ_index=1)
J_F1 = j_pucch.PucchF1Config(prb=0, start_symbol=0, nof_symbols=14,
                             initial_cyclic_shift=0, time_domain_occ=0,
                             n_id=1)
J_PRACH = j_prach.PrachConfig(format="B4", root_sequence_index=39,
                              zero_correlation_zone=10, ra_scs_hz=30_000)
J_SRS = j_srs.SrsConfig(rb_start=48, rb_count=4, start_symbol=13,
                        nof_symbols=1, comb=2, comb_offset=0, cyclic_shift=0,
                        nof_ports=1, sequence_id=1, numerology=1, rnti=0x17)
SMALL_EDGE = flagship.EdgeScenario(
    cell=convert.config(J_CELL), pusch_a=convert.config(J_UE_A),
    pusch_c=convert.config(J_UE_C), f3=convert.config(J_F3),
    f4=convert.config(J_F4), pucch=convert.config(J_F1),
    prach=convert.config(J_PRACH), srs=convert.config(J_SRS))
J_PLAN = ((J_UE_A, J_UE_C), (), (J_F1,), (), (J_PRACH,), (J_SRS,),
          (J_F3, J_F4))


def test_small_scenario_is_the_flagship_cut_to_size():
    """The reduced scenario keeps flagship.EDGE's every field but the cell
    width, the RB positions and UE A's TBS (TS38.214 at its width)."""
    full = flagship.EDGE
    assert dataclasses.replace(
        SMALL_EDGE.pusch_a, rb_count=full.pusch_a.rb_count,
        tbs=full.pusch_a.tbs) == full.pusch_a
    assert dataclasses.replace(
        SMALL_EDGE.pusch_c, rb_start=full.pusch_c.rb_start,
        second_hop_prb=full.pusch_c.second_hop_prb) == full.pusch_c
    for mine, theirs in ((SMALL_EDGE.f3, full.f3), (SMALL_EDGE.f4, full.f4),
                         (SMALL_EDGE.srs, full.srs)):
        assert dataclasses.replace(mine, rb_start=theirs.rb_start) == theirs
    assert SMALL_EDGE.pucch == full.pucch and SMALL_EDGE.prach == full.prach
    assert full.pusch_a.tbs == tbs_calc(240, 14, 36, "qam64", 0.7, 2)
    assert full.pusch_c.tbs == tbs_calc(6, 14, 24, "qpsk", 0.3, 1)


def _j_ctx(ctx):
    """The port's slot context as the JAX program takes it."""
    def j(x):
        return jnp.asarray(x.numpy())
    return {"pusch": tuple(j(p) for p in ctx["pusch"]), "f0": (), "f2": (),
            "f3": tuple(j(v) for v in ctx["f3"]),
            "f1": tuple(tuple(tuple(j(w) for w in hop) for hop in e)
                        for e in ctx["f1"])}


@pytest.fixture(scope="module")
def edge_slots():
    """Two cell-edge slots of the reduced scenario (slot points (1, 0) and
    (1, 2)) through the port's UL program, slot 0 also through the JAX
    program, on the same samples and context."""
    rng = np.random.default_rng(5)
    gen = torch.Generator()
    gen.manual_seed(5)
    slots = flagship.make_edge_slots(2, rng, gen, "cpu", SMALL_EDGE)
    fd = flagship.prach_capture(np.random.default_rng(0), nof_ports=2)
    softs = flagship.edge_soft_buffers("cpu", SMALL_EDGE)
    prog = flagship.edge_program(SMALL_EDGE)
    got = [prog(s["rx"], (_t(fd),), softs, s["ctx"]) for s in slots]
    ref = j_slots.ul_slot_fn(J_CELL, J_PLAN)(
        jnp.asarray(slots[0]["rx"].numpy()), (jnp.asarray(fd),),
        tuple(jnp.asarray(s.numpy()) for s in softs), _j_ctx(slots[0]["ctx"]))
    return dict(got=got, ref=ref, slots=slots, fd=fd)


UL_EQUAL = {"tb_bits", "tb_crc_ok", "nof_iterations", "ta_s", "detected",
            "harq_bits", "harq_ack_bits", "harq_ack_valid", "uci_bits",
            "valid"}


@pytest.mark.parametrize("kind", ["pusch", "pucch_f1", "pucch_f3", "prach",
                                  "srs"])
def test_edge_slot_matches_jax(edge_slots, kind):
    """Every key of every entry of the cell-edge slot: decisions and UCI
    bits equal, CFO within 1 Hz, soft buffers and EVM within 1e-3, other
    floats within 1e-4."""
    got, ref = edge_slots["got"][0][kind], edge_slots["ref"][kind]
    assert len(got) == len(ref) > 0
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


def test_edge_slot_decodes_everything_sent(edge_slots):
    for i, (out, s) in enumerate(zip(edge_slots["got"], edge_slots["slots"])):
        flagship.check_edge_slot(out, s, f"reduced cell-edge slot {i}")


def _ul_request(i):
    sp = SlotPoint(1, 2 * i)
    sl = sp.slot_index
    return UlTtiRequest(
        slot=sp, pusch=tuple(dataclasses.replace(c, slot_in_frame=sl)
                             for c in (J_UE_A, J_UE_C)),
        pucch_f1=(dataclasses.replace(J_F1, slot=sl),),
        pucch_f3=(dataclasses.replace(J_F3, slot=sl),),
        pucch_f4=(dataclasses.replace(J_F4, slot=sl),),
        prach=(J_PRACH,), srs=(J_SRS,))


def test_edge_slot_through_the_conductors_matches_jax(edge_slots):
    """The same slot as a FAPI UL_TTI.request through the JAX conductor and
    the port's (on the CPU): validation, the F3/F4 context, the packing and
    the indications equal; the port's SlotResults hold every bit as sent.
    (UE C's DM-RS is the low-PAPR sequence, so the JAX conductor's hop-2
    pilot rows do not reach it; test_hopping_pilot_rows_diverge shows the
    PDU where they do.)"""
    ul = _ul_request(0)
    rx, fd = edge_slots["slots"][0]["rx"].numpy(), edge_slots["fd"]
    ref = j_cond.SlotConductor(J_CELL).process_ul(
        ul, jnp.asarray(rx), (jnp.asarray(fd),)).resolve()
    got = t_cond.SlotConductor(convert.config(J_CELL), device="cpu"
                               ).process_ul(convert.requests(ul), _t(rx),
                                            (_t(fd),)).resolve()
    convert.slot_results(ref, got, rtol=1e-3)
    flagship.check_edge_results(got, edge_slots["slots"][0],
                                "conductor cell-edge slot", SMALL_EDGE)


def test_edge_batch_equals_process_slot(edge_slots):
    """process_slot_batch at B = 2 with the cell-edge PDUs (on the card K18
    runs once for both slots and K19 once per PDU) equals process_slot slot
    by slot."""
    from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
    cond = t_cond.SlotConductor(convert.config(J_CELL), device="cpu")
    slots = edge_slots["slots"]
    pdsch_cfg = t_pdsch.PdschConfig(
        rnti=0x4601, rb_start=0, rb_count=52, first_symbol=1, nof_symbols=12,
        modulation="qpsk", target_code_rate=0.5, tbs=2056, nof_layers=1,
        n_id=1, dmrs_symbols=(2, 11))
    reqs, stage = [], []
    for i in range(2):
        sp = t_msgs.SlotPoint(1, 2 * i)
        dl = t_msgs.DlTtiRequest(slot=sp, pdsch=(dataclasses.replace(
            pdsch_cfg, slot_in_frame=sp.slot_index),))
        tx = t_msgs.TxDataRequest(slot=sp, pdsch_payloads=(
            np.random.default_rng(i).integers(0, 2, 2056).astype(np.uint8),))
        reqs.append((dl, convert.requests(_ul_request(i))))
        stage.append((dl, tx))
    fd = torch.stack([_t(edge_slots["fd"])] * 2)
    st = cond.stage_payloads(stage)
    rx_b = torch.stack([s["rx"] for s in slots])
    tx_b, pend_b = cond.process_slot_batch(reqs, st, rx_b, prach_fd=(fd,))
    res_b = pend_b.resolve()
    for b, (dl, ul) in enumerate(reqs):
        tx, pend = cond.process_slot(dl, ul, st, b, slots[b]["rx"],
                                     prach_fd=(fd[b],))
        close(tx_b[b], tx)
        np.testing.assert_allclose(pend_b.scalars[b].numpy(),
                                   pend.scalars.numpy(), rtol=2e-4, atol=2e-4)
        convert.slot_results(pend.resolve(), res_b[b], rtol=2e-4)
        flagship.check_edge_results(res_b[b], slots[b], f"batch slot {b}",
                                    SMALL_EDGE)


def test_hopping_pilot_rows_diverge():
    """The JAX conductor's DM-RS context of a hopping PUSCH builds every row
    from hop 1's config (dmrs.py:109 advances the Gold sequence to hop 1's
    first PRB), so its hop-2 rows differ from the pilots of its own hop-2
    config, and its receive fails where the port's conductor, which builds
    each hop's rows from that hop's config, decodes the payload."""
    cfg = dataclasses.replace(J_HOP, numerology=1, slot_in_frame=4)
    j_rows = np.asarray(j_cond._dev("pusch", cfg))
    h1, h2 = j_pusch.hop_configs(cfg)
    own = [j_dmrs.pilot_values_for(j_pusch.dmrs_config(h)) for h in (h1, h2)]
    np.testing.assert_array_equal(j_rows[:1], own[0])
    assert not np.allclose(j_rows[1:], own[1])
    np.testing.assert_array_equal(
        t_pusch.dmrs_pilot_values(convert.config(cfg)), np.concatenate(own))

    cell = j_slots.CellConfig(nof_ports=2, nof_rb=40, dft_size=1024,
                              numerology=1)
    rx_grid, payload = _pusch_rx(cfg, 0, nsc=480)
    from srsran_tpu_torch.ops import ofdm as t_ofdm
    rx = t_ofdm.modulate_slot(_t(rx_grid), 1024, 1,
                              center_freq_hz=cell.center_freq_hz).numpy()
    ul = UlTtiRequest(slot=SlotPoint(1, 4), pusch=(cfg,))
    ref = j_cond.SlotConductor(cell).process_ul(ul, jnp.asarray(rx)).resolve()
    got = t_cond.SlotConductor(convert.config(cell), device="cpu").process_ul(
        convert.requests(ul), _t(rx)).resolve()
    assert not ref.crc[0].tb_crc_ok
    assert got.crc[0].tb_crc_ok
    np.testing.assert_array_equal(got.rx_data[0].payload, payload)


@pytest.mark.slow
def test_flagship_edge_slot_on_cpu_twins():
    """The full-width cell-edge slot (273 RB, 4 ports, 4096-point FFT) end
    to end on the CPU twins."""
    rng = np.random.default_rng(0)
    gen = torch.Generator()
    gen.manual_seed(0)
    (s,) = flagship.make_edge_slots(1, rng, gen, "cpu")
    out = flagship.edge_program()(s["rx"], flagship.prach_fd("cpu"),
                                  flagship.edge_soft_buffers("cpu"), s["ctx"])
    flagship.check_edge_slot(out, s, "flagship cell-edge slot")
