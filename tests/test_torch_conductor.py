"""The port's FAPI slot conductor against the JAX package's, on the CPU.

The same FAPI requests (converted by ``convert.requests``), the same staged
payloads and the same numpy-made rx samples go through the JAX
``SlotConductor`` and the port's, on a small cell (2 ports, 24 RB, 512-point
FFT, 30 kHz, as tests/test_conductor_fast.py) with a UL plan of PUSCH +
PUCCH F0 + F1 + two F2 (a short-block and a polar one) + SRS.  Also: the
HARQ retransmission of tests/test_conductor.py, the 50-slot pending
lifetime, the bounded phase cache, and validation.

Tolerances: decisions, bits, CRC/valid flags, RNTIs and LDPC sweeps equal;
the CFO within 1 Hz, TAs within 1e-6; other floats (SNR, RSRP, EVM,
metrics, wideband channel) within rtol 1e-4 (``convert.slot_results``);
soft buffers within rtol 1e-3 of max|ref| (as test_torch_ul_mix.py); DL
samples within rtol 1e-4 of max|ref|.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.fapi import conductor as j_cond
from srsran_tpu.fapi.messages import (DlTtiRequest, TxDataRequest,
                                      UlTtiRequest)
from srsran_tpu.fapi.validators import ValidationError as JValidationError
from srsran_tpu.ops import ofdm as j_ofdm
from srsran_tpu.phy.slot_programs import CellConfig
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper import srs as j_srs
from srsran_tpu.phy.upper.pdcch import CoresetConfig, PdcchConfig
from srsran_tpu.phy.upper.pusch import PuschConfig
from srsran_tpu.ran.slot_point import SlotPoint

from srsran_tpu_torch import convert
from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.fapi import messages as t_msgs
from srsran_tpu_torch.fapi.validators import ValidationError
from srsran_tpu_torch.phy import slot_programs as t_slots

torch.set_num_threads(2)

CELL = CellConfig(nof_ports=2, nof_rb=24, dft_size=512, numerology=1)
T_CELL = convert.config(CELL)
PDCCH = PdcchConfig(
    coreset=CoresetConfig(rb_start=0, nof_rb=24, start_symbol=0, duration=1),
    rnti=0x4601, aggregation_level=2, cce_index=0, payload_bits=40,
    n_id=1, n_id_data=1)
PDSCH = j_pdsch.PdschConfig(rnti=0x4601, rb_start=0, rb_count=24,
                            first_symbol=1, nof_symbols=12,
                            modulation="qam16", target_code_rate=0.5,
                            tbs=8192, nof_layers=2, n_id=1,
                            dmrs_symbols=(2, 11))
PUSCH = PuschConfig(rnti=0x17, rb_start=0, rb_count=20, first_symbol=0,
                    nof_symbols=14, modulation="qpsk", target_code_rate=0.5,
                    tbs=2560, nof_layers=1, n_id=1, dmrs_symbols=(2, 7, 11))
F1 = j_pucch.PucchF1Config(prb=0, start_symbol=0, nof_symbols=14,
                           initial_cyclic_shift=0, time_domain_occ=0, n_id=1)
F0 = j_pucch.PucchF0Config(prb=20, start_symbol=11, nof_symbols=2,
                           initial_cyclic_shift=0, n_id=1, nof_harq_bits=2,
                           sr_opportunity=True)
F2_SB = j_pucch.PucchF2Config(rb_start=21, nof_rb=1, start_symbol=11,
                              nof_symbols=2, rnti=0x18, n_id=1, n_id0=1,
                              nof_uci_bits=6)
F2_POLAR = j_pucch.PucchF2Config(rb_start=22, nof_rb=2, start_symbol=11,
                                 nof_symbols=2, rnti=0x19, n_id=1, n_id0=1,
                                 nof_uci_bits=22)
SRS = j_srs.SrsConfig(rb_start=20, rb_count=4, start_symbol=13, nof_symbols=1,
                      comb=2, comb_offset=0, cyclic_shift=0, nof_ports=1,
                      sequence_id=1, numerology=1, rnti=0x17)
RNG = np.random.default_rng(3)
SCH_BITS = RNG.integers(0, 2, PDSCH.tbs).astype(np.uint8)
DCI_BITS = RNG.integers(0, 2, 40).astype(np.uint8)


def dl_req(i):
    s = SlotPoint(1, 2 * i)
    return DlTtiRequest(
        slot=s,
        pdcch=(dataclasses.replace(PDCCH, slot_in_frame=s.slot_index),),
        pdsch=(dataclasses.replace(PDSCH, slot_in_frame=s.slot_index),))


def tx_req(i):
    return TxDataRequest(slot=SlotPoint(1, 2 * i),
                         pdsch_payloads=(np.packbits(SCH_BITS),),
                         pdcch_payloads=(np.packbits(DCI_BITS),))


def ul_req(slot: SlotPoint, pusch_only=False):
    sl = slot.slot_index
    pusch = (dataclasses.replace(PUSCH, slot_in_frame=sl),)
    if pusch_only:
        return UlTtiRequest(slot=slot, pusch=pusch)
    return UlTtiRequest(
        slot=slot, pusch=pusch,
        pucch_f0=(dataclasses.replace(F0, slot=sl),),
        pucch_f1=(dataclasses.replace(F1, slot=sl),),
        pucch_f2=(dataclasses.replace(F2_SB, slot=sl),
                  dataclasses.replace(F2_POLAR, slot=sl)),
        srs=(SRS,))


def ue_samples(slot: SlotPoint, rng, with_uci=True):
    """The UE's slot (JAX UE side): PUSCH on port 0 (the PDSCH chain with
    the PUSCH's scrambling and DM-RS), its SRS, F0 (SR + 2 HARQ bits) and
    both F2s, through a 1x2 channel with noise.  Returns (rx complex64
    [2, T], TB bits, sent UCI)."""
    sl = slot.slot_index
    ue = j_pdsch.PdschConfig(
        rnti=PUSCH.rnti, rb_start=0, rb_count=20, first_symbol=0,
        nof_symbols=14, modulation="qpsk", target_code_rate=0.5,
        tbs=PUSCH.tbs, nof_layers=1, n_id=1, dmrs_symbols=(2, 7, 11),
        slot_in_frame=sl)
    tb = rng.integers(0, 2, PUSCH.tbs).astype(np.int8)
    grid = j_pdsch.process(jnp.zeros((1, 14, CELL.nof_sc), jnp.complex64),
                           jnp.asarray(tb), ue,
                           precoding=np.eye(1, dtype=np.complex64))
    sent = {}
    if with_uci:
        grid = j_srs.map_to_grid(grid, SRS)
        sent["f0"] = (rng.integers(0, 2, 2), int(rng.integers(0, 2)))
        table = j_pucch._F0_TABLES[(2, True)]
        c = [i for i, (_, s, h) in enumerate(table)
             if h == tuple(sent["f0"][0]) and s == sent["f0"][1]][0]
        refs = j_pucch.f0_refs_for(dataclasses.replace(F0, slot=sl))[c]
        for s in range(2):
            grid = grid.at[0, 11 + s, 240:252].add(jnp.asarray(refs[s]))
        for name, cfg in (("f2_sb", F2_SB), ("f2_polar", F2_POLAR)):
            sent[name] = rng.integers(0, 2, cfg.nof_uci_bits)
            grid = j_pucch.transmit_format2(
                grid, dataclasses.replace(cfg, slot=sl), sent[name])
    t = np.asarray(j_ofdm.modulate_slot(grid, CELL.dft_size, CELL.numerology,
                                        center_freq_hz=CELL.center_freq_hz))
    rx = np.stack([0.9 * t[0], 0.7 * np.exp(0.5j) * t[0]])
    # about 20 dB per RE: the F0 metric's noise term (energy - max corr)
    # keeps its digits in float32 (at 35 dB two summation orders differ
    # by 4e-4 in it)
    sigma = 0.1
    rx = rx + sigma / np.sqrt(2) * (rng.standard_normal(rx.shape)
                                    + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64), tb, sent


@pytest.fixture(scope="module")
def slot_pair():
    """Two slots (slot points (1, 0) and (1, 2)) through both conductors:
    staged payloads, process_slot, resolve."""
    rng = np.random.default_rng(11)
    j_c = j_cond.SlotConductor(CELL)
    t_c = t_cond.SlotConductor(T_CELL, device="cpu")
    reqs = [(dl_req(k), tx_req(k), ul_req(SlotPoint(1, 2 * k)))
            for k in range(2)]
    j_st = j_c.stage_payloads([(d, t) for d, t, _ in reqs])
    t_st = t_c.stage_payloads([(convert.requests(d), convert.requests(t))
                               for d, t, _ in reqs])
    out = []
    for k, (d, _, u) in enumerate(reqs):
        rx, tb, sent = ue_samples(u.slot, rng)
        j_tx, j_p = j_c.process_slot(d, u, j_st, k, jnp.asarray(rx))
        t_tx, t_p = t_c.process_slot(convert.requests(d), convert.requests(u),
                                     t_st, k, torch.as_tensor(rx))
        out.append(dict(j_tx=np.asarray(j_tx), t_tx=t_tx.numpy(),
                        j_scalars=np.asarray(j_p.scalars),
                        t_scalars=t_p.scalars.numpy(),
                        ref=j_p.resolve(), got=t_p.resolve(), tb=tb,
                        sent=sent))
    return out


@pytest.mark.parametrize("k", [0, 1])
def test_slot_results_equal_jax(slot_pair, k):
    convert.slot_results(slot_pair[k]["ref"], slot_pair[k]["got"])


@pytest.mark.parametrize("k", [0, 1])
def test_packed_scalars_match_jax(slot_pair, k):
    a, b = slot_pair[k]["t_scalars"], slot_pair[k]["j_scalars"]
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max())


@pytest.mark.parametrize("k", [0, 1])
def test_tx_samples_match_jax(slot_pair, k):
    ref = slot_pair[k]["j_tx"]
    np.testing.assert_allclose(slot_pair[k]["t_tx"], ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("k", [0, 1])
def test_slot_decodes_everything_sent(slot_pair, k):
    res, sent = slot_pair[k]["got"], slot_pair[k]["sent"]
    assert res.crc[0].tb_crc_ok
    np.testing.assert_array_equal(res.rx_data[0].payload, slot_pair[k]["tb"])
    f0, f1, f2_sb, f2_polar = res.uci
    assert f0.detected and f0.sr_bit == sent["f0"][1]
    np.testing.assert_array_equal(f0.harq_bits, sent["f0"][0])
    assert f2_sb.detected and f2_polar.detected
    np.testing.assert_array_equal(f2_sb.csi_bits, sent["f2_sb"])
    np.testing.assert_array_equal(f2_polar.csi_bits, sent["f2_polar"])
    assert f1.harq_bits.shape == (1,)
    assert res.srs[0].wideband_h.shape == (2, 1) and not res.rach


def test_requests_convert_to_port_messages():
    u = convert.requests(ul_req(SlotPoint(1, 6)))
    assert type(u) is t_msgs.UlTtiRequest
    assert type(u.slot).__name__ == "SlotPoint" and u.slot.slot_index == 6
    assert type(u.pucch_f2[1]).__module__.startswith("srsran_tpu_torch")
    tx = convert.requests(tx_req(0))
    assert type(tx) is t_msgs.TxDataRequest
    np.testing.assert_array_equal(tx.pdsch_payloads[0], np.packbits(SCH_BITS))
    with pytest.raises(TypeError):
        convert.requests(j_cond.HarqBufferPool())


def test_conductor_without_device_needs_cuda():
    """SlotConductor() runs on the card or raises; it never picks the CPU."""
    if torch.cuda.is_available():
        assert t_cond.SlotConductor(T_CELL).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_cond.SlotConductor(T_CELL)


UL_KINDS = ("pusch", "pucch_f0", "pucch_f1", "pucch_f2", "pucch_f3",
            "prach", "srs")


def test_empty_ul_results_lie_on_the_callers_device():
    """pack_ul_results makes a slot without results on the device it is
    given (here the meta device, which nothing falls back to) and never on
    the CPU by default; an empty UL request through a CPU conductor gives
    empty results on the CPU."""
    scalars, payload = t_cond.pack_ul_results({k: [] for k in UL_KINDS},
                                              torch.device("meta"))
    assert scalars.device.type == payload.device.type == "meta"
    assert scalars.numel() == payload.numel() == 0
    c = t_cond.SlotConductor(T_CELL, device="cpu")
    rx = torch.zeros((2, CELL.slot_samples(0)), dtype=torch.complex64)
    pend = c.process_ul(t_msgs.UlTtiRequest(slot=t_msgs.SlotPoint(1, 4)), rx)
    assert pend.scalars.device.type == pend.payload.device.type == "cpu"
    res = pend.resolve()
    assert not (res.crc or res.rx_data or res.uci or res.rach)


def test_unported_modes_raise():
    """pcap capture still raises (ROADMAP §1 item 16); a PUCCH F3 plan
    entry, once refused, now runs as the JAX program runs it (on noise: the
    same decision, bits and metric)."""
    with pytest.raises(NotImplementedError, match="item 16"):
        t_cond.SlotConductor(T_CELL, device="cpu", pcap=object())
    f3 = j_pucch.PucchF3Config(rb_start=20, nof_rb=1, start_symbol=0,
                               nof_symbols=14, rnti=0x1a, n_id=1,
                               n_id_hopping=1, nof_uci_bits=6)
    plan = ((), (), (), (), (), (), (f3,))
    rng = np.random.default_rng(8)
    t = CELL.slot_samples(0)
    rx = (0.1 * (rng.standard_normal((2, t))
                 + 1j * rng.standard_normal((2, t)))).astype(np.complex64)
    from srsran_tpu.phy import slot_programs as j_slots
    (ref,) = j_slots.ul_slot_core(CELL, plan)(jnp.asarray(rx), (), None)[
        "pucch_f3"]
    (got,) = t_slots.ul_slot_core(T_CELL, convert.plan(plan))(
        torch.as_tensor(rx), (), None)["pucch_f3"]
    np.testing.assert_array_equal(got["uci_bits"].numpy(),
                                  np.asarray(ref["uci_bits"]))
    assert bool(got["valid"]) == bool(ref["valid"])
    np.testing.assert_allclose(float(got["metric"]), float(ref["metric"]),
                               rtol=1e-4)


# -------------------------------------------------------------- HARQ

HARQ_CELL = CellConfig(nof_ports=2, nof_rb=52, dft_size=1024, numerology=1,
                       center_freq_hz=3.5e9)
HARQ_TBS = 4224


def _harq_rx(rv, payload, rng):
    """tests/test_conductor.py's UE (rv, 48 RB QAM64 at rate 0.8) through
    its channel, at a noise (sigma 1.0) where rv 0 alone fails."""
    cfg = j_pdsch.PdschConfig(
        rnti=0x22, rb_start=0, rb_count=48, first_symbol=0, nof_symbols=14,
        modulation="qam64", target_code_rate=0.8, tbs=HARQ_TBS, nof_layers=1,
        rv=rv, n_id=33, dmrs_symbols=(2, 7, 11), slot_in_frame=4)
    grid = j_pdsch.process(jnp.zeros((1, 14, HARQ_CELL.nof_sc), jnp.complex64),
                           jnp.asarray(payload), cfg,
                           precoding=np.eye(1, dtype=np.complex64))
    t = np.asarray(j_ofdm.modulate_slot(grid, HARQ_CELL.dft_size,
                                        HARQ_CELL.numerology,
                                        center_freq_hz=3.5e9))
    rx = np.stack([0.9 * t[0], 0.7 * np.exp(0.5j) * t[0]])
    rx += (rng.normal(0, 1 / np.sqrt(2), rx.shape)
           + 1j * rng.normal(0, 1 / np.sqrt(2), rx.shape))
    return rx.astype(np.complex64)


def _harq_ul(slot, rv, new_data):
    return UlTtiRequest(slot=slot, pusch=(PuschConfig(
        rnti=0x22, rb_start=0, rb_count=48, first_symbol=0, nof_symbols=14,
        modulation="qam64", target_code_rate=0.8, tbs=HARQ_TBS, nof_layers=1,
        rv=rv, n_id=33, dmrs_symbols=(2, 7, 11), slot_in_frame=4),),
        pusch_harq=((3, new_data),))


def test_ul_slot_with_harq_retransmission():
    """rv 0 fails, its soft buffer is kept (equal to the JAX pool's); rv 2
    with new_data=False combines with it and decodes, in both."""
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 2, HARQ_TBS).astype(np.int8)
    j_c = j_cond.SlotConductor(HARQ_CELL)
    t_c = t_cond.SlotConductor(convert.config(HARQ_CELL), device="cpu")
    slot = SlotPoint(1, 4)
    for rv, new, sl in ((0, True, slot), (2, False, slot + 8)):
        rx = _harq_rx(rv, payload, rng)
        ul = _harq_ul(sl, rv, new)
        ref = j_c.process_ul(ul, jnp.asarray(rx)).resolve()
        got = t_c.process_ul(convert.requests(ul), torch.as_tensor(rx)).resolve()
        convert.slot_results(ref, got)
        if rv == 0:
            assert not got.crc[0].tb_crc_ok
            want = np.asarray(j_c.harq_pool._bufs[(0x22, 3)])
            kept = t_c.harq_pool._bufs[(0x22, 3)].numpy()
            np.testing.assert_allclose(kept, want, rtol=1e-3,
                                       atol=1e-3 * np.abs(want).max())
    assert got.crc[0].tb_crc_ok
    np.testing.assert_array_equal(got.rx_data[0].payload, payload)
    assert (0x22, 3) not in t_c.harq_pool._bufs      # released on success


# ---------------------------------------------------------- lifetimes

def test_pending_results_outlive_50_slots():
    """50 slots through process_slot (slot points (1, 20 j): the same slot
    phase, so every rx decodes), resolving slot 0 last: its CRC passes and
    its payload is exact."""
    rng = np.random.default_rng(5)
    c = t_cond.SlotConductor(T_CELL, device="cpu")
    d, t = convert.requests(dl_req(0)), convert.requests(tx_req(0))
    staged = c.stage_payloads([(d, t)])
    slots = []
    for j in range(50):
        slot = SlotPoint(1, 20 * j)
        if j < 2:
            rx, tb, _ = ue_samples(slot, rng, with_uci=False)
        else:                              # other TBs, same waveform cost
            rx, tb = slots[j % 2][1], slots[j % 2][2]
        _, pend = c.process_slot(d, convert.requests(ul_req(slot, True)),
                                 staged, 0, torch.as_tensor(rx))
        slots.append((pend, rx, tb))
    for pend, _, tb in slots[1:]:
        res = pend.resolve()
        assert res.crc[0].tb_crc_ok
    res0 = slots[0][0].resolve()
    assert res0.slot == t_msgs.SlotPoint(1, 0)
    assert res0.crc[0].tb_crc_ok
    np.testing.assert_array_equal(res0.rx_data[0].payload, slots[0][2])
    assert len(c._slot_phases) == 1


def test_phase_cache_reuses_and_stays_bounded(monkeypatch):
    c = t_cond.SlotConductor(T_CELL, device="cpu")
    calls = []
    real = t_cond.normalize_ul_plan
    monkeypatch.setattr(t_cond, "normalize_ul_plan",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rx = torch.zeros((2, CELL.slot_samples(0)), dtype=torch.complex64)
    for rep in range(3):
        for i in range(4):
            c.process_ul(convert.requests(ul_req(SlotPoint(1, 2 * i), True)),
                         rx)
    assert len(c._ul_phases) == 4 and len(calls) == 4
    c._ul_phases.size = 2
    for i in range(4, 7):
        c.process_ul(convert.requests(ul_req(SlotPoint(1, 2 * i), True)), rx)
    assert len(c._ul_phases) == 2


# ---------------------------------------------------------- validation

def _bad_ul():
    s = SlotPoint(1, 0)
    return {
        "pusch_prbs": UlTtiRequest(slot=s, pusch=(dataclasses.replace(
            PUSCH, rb_count=30),)),
        "harq_len": UlTtiRequest(slot=s, pusch=(PUSCH,),
                                 pusch_harq=((0, True), (1, True))),
        "f0_symbols": UlTtiRequest(slot=s, pucch_f0=(dataclasses.replace(
            F0, nof_symbols=3),)),
        "f0_empty": UlTtiRequest(slot=s, pucch_f0=(dataclasses.replace(
            F0, nof_harq_bits=0, sr_opportunity=False),)),
        "f1_symbols": UlTtiRequest(slot=s, pucch_f1=(dataclasses.replace(
            F1, nof_symbols=3),)),
        "f2_prbs": UlTtiRequest(slot=s, pucch_f2=(dataclasses.replace(
            F2_POLAR, rb_start=23),)),
        "srs_comb": UlTtiRequest(slot=s, srs=(dataclasses.replace(
            SRS, comb=3),)),
    }


def _bad_dl():
    s = SlotPoint(1, 0)
    return {
        "pdcch_al": DlTtiRequest(slot=s, pdcch=(dataclasses.replace(
            PDCCH, aggregation_level=3),)),
        "pdsch_tbs": DlTtiRequest(slot=s, pdsch=(dataclasses.replace(
            PDSCH, tbs=80000),)),
        "pdsch_layers": DlTtiRequest(slot=s, pdsch=(dataclasses.replace(
            PDSCH, nof_layers=5),)),
    }


@pytest.mark.parametrize("case", sorted(_bad_ul()))
def test_ul_validation_matches_jax(case):
    ul = _bad_ul()[case]
    rx = np.zeros((2, CELL.slot_samples(0)), np.complex64)
    with pytest.raises(JValidationError):
        j_cond.SlotConductor(CELL).process_ul(ul, jnp.asarray(rx))
    with pytest.raises(ValidationError):
        t_cond.SlotConductor(T_CELL, device="cpu").process_ul(
            convert.requests(ul), torch.as_tensor(rx))


@pytest.mark.parametrize("case", sorted(_bad_dl()))
def test_dl_validation_matches_jax(case):
    dl = _bad_dl()[case]
    tx = TxDataRequest(slot=dl.slot,
                       pdsch_payloads=tuple(np.zeros(p.tbs, np.uint8)
                                            for p in dl.pdsch),
                       pdcch_payloads=tuple(np.zeros(p.payload_bits, np.uint8)
                                            for p in dl.pdcch))
    with pytest.raises(JValidationError):
        j_cond.SlotConductor(CELL).process_dl(dl, tx, return_grid=False)
    with pytest.raises(ValidationError):
        t_cond.SlotConductor(T_CELL, device="cpu").process_dl(
            convert.requests(dl), convert.requests(tx), return_grid=False)


def test_payload_validation_matches_jax():
    bad = TxDataRequest(slot=SlotPoint(1, 0),
                        pdsch_payloads=(SCH_BITS[:100],),
                        pdcch_payloads=(DCI_BITS,))
    none = TxDataRequest(slot=SlotPoint(1, 0))
    c = t_cond.SlotConductor(T_CELL, device="cpu")
    for tx in (bad, none):
        with pytest.raises(JValidationError):
            j_cond.SlotConductor(CELL).process_dl(dl_req(0), tx,
                                                  return_grid=False)
        with pytest.raises(ValidationError):
            c.process_dl(convert.requests(dl_req(0)), convert.requests(tx),
                         return_grid=False)
    with pytest.raises(ValidationError):
        c.stage_payloads([(convert.requests(dl_req(0)),
                           convert.requests(tx_req(0)))], stride=4)


def test_pack_payload_blob_bit_order():
    layout = t_cond._dl_payload_layout(((), (), (), (), ()), 0, 0, 0)
    assert layout[1] == 1
    blob = t_cond.pack_payload_blob(((((0, 1, 3)),), 1),
                                    (np.array([1, 0, 1], np.uint8),))
    assert blob[0] == 0b10100000
    segs = ((0, 3, 24), (3, 5, 40))
    unpack = t_cond._unpacker(segs, 1, 1, 0)
    bits = np.random.default_rng(2).integers(0, 2, 64).astype(np.uint8)
    blob = t_cond.pack_payload_blob((segs, 8), (bits[:24], bits[24:]))
    mib, dci, sch = unpack(torch.as_tensor(blob))
    np.testing.assert_array_equal(torch.cat([mib[0], dci[0]]).numpy(), bits)
    assert sch == ()
