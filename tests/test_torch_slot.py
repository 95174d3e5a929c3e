"""The slice as a whole: the port's DL (UE transmitter) and UL slot programs
against the JAX package's, plus the conversion helpers.

Small cell: 4 ports, 24 RB, 512-point FFT, 30 kHz SCS; a PUSCH-only UL plan
with 2-layer QAM64 at rate 0.7 (TBS 26632, BG1, Z=320, 4 CBs).  The same
numpy-seeded samples and slot context go through JAX ``ul_slot_fn`` and the
port's ``ul_slot_fn``: decoded bits, CRC flags, LDPC sweep counts and TA
must match exactly, CFO within 1 Hz, the other floats within tolerance.
"""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.phy import slot_programs as j_slots
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pdcch as j_pdcch
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper import pusch as j_pusch
from srsran_tpu.phy.upper import ssb as j_ssb
from srsran_tpu.phy.upper.pdsch import PdschPtrs
from srsran_tpu.ran.cyclic_prefix import CyclicPrefix
from srsran_tpu.ran.ldpc_params import segment_tb, select_base_graph
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc
from srsran_tpu.ran.precoding_codebooks import PrecodingConfig
from srsran_tpu.ran.uci_on_pusch import UciOnPuschConfig

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.phy import slot_programs as t_slots
from srsran_tpu_torch.phy.upper import pusch as t_pusch

torch.set_num_threads(2)

TBS = tbs_calc(24, 14, 36, "qam64", 0.7, 2)
J_CELL = j_slots.CellConfig(nof_ports=4, nof_rb=24, dft_size=512, numerology=1)
J_PUSCH = j_pusch.PuschConfig(rnti=0x17, rb_start=0, rb_count=24,
                              first_symbol=0, nof_symbols=14,
                              modulation="qam64", target_code_rate=0.7,
                              tbs=TBS, nof_layers=2, n_id=1,
                              dmrs_symbols=(2, 7, 11))
J_UE = j_pdsch.PdschConfig(rnti=0x17, rb_start=0, rb_count=24, first_symbol=0,
                           nof_symbols=14, modulation="qam64",
                           target_code_rate=0.7, tbs=TBS, nof_layers=2,
                           n_id=1, dmrs_symbols=(2, 7, 11))
SLOT = 6
SEG = segment_tb(TBS, select_base_graph(TBS, 0.7))


def close(port, ref, rtol=1e-4):
    ref = np.asarray(ref)
    atol = rtol * float(np.max(np.abs(ref)))
    np.testing.assert_allclose(port.numpy(), ref, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def slot_case():
    """JAX and port DL samples for one slot, the received samples made from
    the JAX samples with numpy, and the JAX and port UL results."""
    rng = np.random.default_rng(2026)
    payload = rng.integers(0, 2, TBS).astype(np.int8)
    ue_ctx = {"pdsch": (j_dmrs.pilot_values_for(j_pdsch.dmrs_config(
        dataclasses.replace(J_UE, slot_in_frame=SLOT))),)}
    ul_ctx = {"pusch": (j_dmrs.pilot_values_for(j_pusch.dmrs_config(
        dataclasses.replace(J_PUSCH, slot_in_frame=SLOT))),)}
    dl_plan = ((), (), (J_UE,), ())
    j_samples, _ = j_slots.dl_slot_fn(J_CELL, dl_plan)(
        (), (), (jnp.asarray(payload),),
        {"pdsch": tuple(jnp.asarray(v) for v in ue_ctx["pdsch"])})
    t_samples, _ = t_slots.dl_slot_fn(convert.config(J_CELL),
                                      convert.plan(dl_plan))(
        (), (), (torch.as_tensor(payload),), convert.slot_context(ue_ctx, "cpu"))
    h = ((rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2)))
         / np.sqrt(2)).astype(np.complex64)
    rx = h @ np.asarray(j_samples)[:2]
    sigma = np.sqrt(np.mean(np.abs(rx) ** 2) * 10 ** (-30 / 10) / 2)
    rx = (rx + sigma * (rng.standard_normal(rx.shape)
                        + 1j * rng.standard_normal(rx.shape))).astype(np.complex64)
    soft = np.zeros((SEG.nof_codeblocks, SEG.codeword_bits), np.float32)
    ul_plan = ((J_PUSCH,), (), (), (), ())
    j_out = j_slots.ul_slot_fn(J_CELL, ul_plan)(
        jnp.asarray(rx), None, (jnp.asarray(soft),),
        {"pusch": tuple(jnp.asarray(v) for v in ul_ctx["pusch"])})
    t_out = t_slots.ul_slot_fn(convert.config(J_CELL), convert.plan(ul_plan))(
        torch.as_tensor(rx), None, convert.soft_buffers((soft,), "cpu"),
        convert.slot_context(ul_ctx, "cpu"))
    return dict(payload=payload, j_samples=np.asarray(j_samples),
                t_samples=t_samples, j=j_out["pusch"][0], t=t_out["pusch"][0],
                t_out=t_out, rx=rx, soft=soft)


def test_dl_slot_samples(slot_case):
    close(slot_case["t_samples"], slot_case["j_samples"])


def test_ul_slot_keys(slot_case):
    assert set(slot_case["t"]) == set(slot_case["j"])
    assert set(slot_case["t_out"]) == {"pusch", "pucch_f0", "pucch_f1",
                                       "pucch_f2", "pucch_f3", "prach", "srs"}


def test_ul_slot_decoded_bits(slot_case):
    j, t = slot_case["j"], slot_case["t"]
    assert bool(j["tb_crc_ok"]) and bool(t["tb_crc_ok"])
    np.testing.assert_array_equal(t["tb_bits"].numpy(), np.asarray(j["tb_bits"]))
    np.testing.assert_array_equal(t["tb_bits"].numpy(), slot_case["payload"])
    assert int(t["nof_iterations"]) == int(j["nof_iterations"])


def test_ul_slot_csi(slot_case):
    j, t = slot_case["j"], slot_case["t"]
    for key in ("snr", "rsrp", "epre", "evm"):
        close(t[key], j[key])
    assert float(t["ta_s"]) == float(j["ta_s"])
    assert abs(float(t["cfo_hz"]) - float(j["cfo_hz"])) < 1.0


def test_ul_slot_soft_buffer(slot_case):
    close(slot_case["t"]["new_soft"], slot_case["j"]["new_soft"], rtol=1e-3)


def _fields(cfg) -> dict:
    """A config's fields, enum members by (class, member) name."""
    return {k: (type(v).__name__, v.name) if isinstance(v, enum.Enum) else v
            for k, v in dataclasses.asdict(cfg).items()}


def test_convert_configs():
    """Configs map field for field onto the port's own classes, nested
    configs and the CyclicPrefix enum included."""
    pusch = dataclasses.replace(J_PUSCH, uci=UciOnPuschConfig(o_ack=2))
    pdsch = dataclasses.replace(J_UE, ptrs=PdschPtrs(time_density=2),
                                precoding=PrecodingConfig(prg_size=4,
                                                          pm_indices=(1, 2)))
    cell = dataclasses.replace(J_CELL, cp=CyclicPrefix.EXTENDED)
    for cfg in (J_CELL, cell, pusch, pdsch, j_pusch.dmrs_config(J_PUSCH)):
        port = convert.config(cfg)
        assert type(port).__module__.startswith("srsran_tpu_torch.")
        assert _fields(port) == _fields(cfg)
    for nested in (convert.config(pdsch).ptrs, convert.config(pdsch).precoding,
                   convert.config(pusch).uci, convert.config(cell).cp):
        assert type(nested).__module__.startswith("srsran_tpu_torch.")
    assert convert.config(cell).cp.name == "EXTENDED"


def test_convert_state():
    soft = np.random.default_rng(1).standard_normal((2, 5)).astype(np.float32)
    (t,) = convert.soft_buffers((soft,), "cpu")
    np.testing.assert_array_equal(t.numpy(), soft)
    c_inits = j_dmrs.c_inits_for(j_pusch.dmrs_config(J_PUSCH))
    vals = j_dmrs.pilot_values_for(j_pusch.dmrs_config(J_PUSCH))
    ctx = convert.slot_context({"pusch": (vals, c_inits), "f1": (None,)}, "cpu")
    assert ctx["pusch"][0].dtype == torch.complex64
    np.testing.assert_array_equal(ctx["pusch"][1].numpy(), c_inits)
    assert ctx["f1"] == (None,)


def test_ul_slot_with_c_inits_matches_values():
    """ctx["pusch"] may carry c_init seeds instead of pilot values."""
    cfg = convert.config(J_PUSCH)
    grid = torch.zeros((4, 14, 24 * 12), dtype=torch.complex64)
    grid[:, :, :] = 0.1
    vals = torch.as_tensor(j_dmrs.pilot_values_for(j_pusch.dmrs_config(
        dataclasses.replace(J_PUSCH, slot_in_frame=3))))
    seeds = j_dmrs.c_inits_for(j_pusch.dmrs_config(J_PUSCH), 3)
    a = t_pusch.estimate_channel(grid, cfg, vals)
    b = t_pusch.estimate_channel(grid, cfg, seeds)
    assert torch.equal(a.coeffs, b.coeffs)


F3_SB = j_pucch.PucchF3Config(rb_start=20, nof_rb=2, start_symbol=0,
                              nof_symbols=14, rnti=0x1a, n_id=1,
                              n_id_hopping=1, nof_uci_bits=8)


J_HOP = dataclasses.replace(J_PUSCH, rb_count=12, second_hop_prb=12,
                            tbs=tbs_calc(12, 14, 36, "qam64", 0.7, 2))


@pytest.mark.parametrize("plan", [
    ((J_HOP,), (), (), (), ()),
    ((dataclasses.replace(J_HOP, uci=UciOnPuschConfig(o_ack=2)),),
     (), (), (), ()),
    ((dataclasses.replace(J_PUSCH, transform_precoding=True),),
     (), (), (), ()),
    ((dataclasses.replace(J_PUSCH, nof_layers=3, transform_precoding=True),),
     (), (), (), ()),
    ((J_PUSCH,), (), (), (), (), (), (F3_SB,))])
def test_ul_plan_entries_not_ported_raise(slot_case, plan):
    """The UL plan entries the port once refused, against the JAX program
    on the slot's samples: PUSCH frequency hopping (with UCI on PUSCH too)
    and a PUCCH F3 give the JAX program's results (CRC flags, LDPC sweeps,
    HARQ-ACK and F3 bits and valid flags equal, soft buffers within 1e-3,
    other floats within 1e-4; the hopping PDUs do not decode here, their
    UE sent no hops); transform precoding on these 2- and 3-layer PDUs
    raises where the JAX receiver asserts (pusch.py:179)."""
    rx = slot_case["rx"]
    seg = segment_tb(plan[0][0].tbs,
                     select_base_graph(plan[0][0].tbs, 0.7))
    soft = np.zeros((seg.nof_codeblocks, seg.codeword_bits), np.float32)
    t_fn = t_slots.ul_slot_fn(convert.config(J_CELL), convert.plan(plan))
    t_args = (torch.as_tensor(rx), None, convert.soft_buffers((soft,), "cpu"))
    j_args = (jnp.asarray(rx), None, (jnp.asarray(soft),))
    if plan[0][0].transform_precoding:
        with pytest.raises(AssertionError):
            j_slots.ul_slot_core(J_CELL, plan)(*j_args)
        with pytest.raises(ValueError, match="single-layer"):
            t_fn(*t_args)
        return
    ref = j_slots.ul_slot_fn(J_CELL, plan)(*j_args)
    got = t_fn(*t_args)
    for kind in ("pusch", "pucch_f3"):
        assert len(got[kind]) == len(ref[kind])
        for g, r in zip(got[kind], ref[kind]):
            assert set(g) == set(r)
            for key in r:
                a, b = g[key], np.asarray(r[key])
                if key == "tb_bits":
                    continue                # an undecoded TB's hard bits
                if key in ("tb_crc_ok", "nof_iterations", "harq_ack_bits",
                           "harq_ack_valid", "uci_bits", "valid"):
                    np.testing.assert_array_equal(a.numpy(), b, err_msg=key)
                elif key == "ta_s":
                    # within 1 ulp: XLA's jit multiplies by the reciprocal
                    # of N * scs (tests/test_torch_ul_mix.py)
                    np.testing.assert_allclose(a.numpy(), b, rtol=2e-7,
                                               atol=0)
                elif key == "cfo_hz":
                    assert abs(float(a) - float(b)) < 1.0
                else:
                    close(a, b, rtol=1e-3 if key in ("new_soft", "evm")
                          else 1e-4)


# RA type 0 and interleaved VRBs, with and without PT-RS (and interleaved
# without a BWP size, whose size the JAX package guesses): the plans that
# raised NotImplementedError before the port had these allocations now run,
# and the DL slot program matches the JAX package's (grid within 1e-6,
# samples within 1e-4 of max|ref|, as test_dl_control_only_plan_runs_on_
# payload_device holds them).  The slot programs do not validate: PT-RS on
# a scattered allocation maps as the JAX program maps it.
@pytest.mark.parametrize("plan", [
    ((), (), (dataclasses.replace(J_UE, prbs=tuple(range(0, 24, 2))),), (),
     ()),
    ((), (), (dataclasses.replace(J_UE, vrb_prb_interleaved=True),), ()),
    ((), (), (dataclasses.replace(J_UE, prbs=(0, 1, 5), ptrs=PdschPtrs()),),
     ()),
    ((), (), (dataclasses.replace(J_UE, vrb_prb_interleaved=True, bwp_size=24,
                                  ptrs=PdschPtrs()),), ())])
def test_dl_plan_entries_not_ported_raise(plan):
    payload = np.random.default_rng(len(plan)).integers(0, 2, TBS).astype(
        np.int8)
    j_samples, j_grid = j_slots.dl_slot_fn(J_CELL, plan)(
        (), (), (jnp.asarray(payload),))
    t_samples, t_grid = t_slots.dl_slot_fn(
        convert.config(J_CELL), convert.plan(plan))(
        (), (), (torch.as_tensor(payload),))
    np.testing.assert_allclose(t_grid.numpy(), np.asarray(j_grid), rtol=0,
                               atol=1e-6)
    close(t_samples, j_samples)


J_SSB = j_ssb.SsbConfig(phys_cell_id=1, ssb_idx=0, l_max=8, sfn=0,
                        first_symbol=2, first_subcarrier=24)
J_PDCCH = j_pdcch.PdcchConfig(
    coreset=j_pdcch.CoresetConfig(rb_start=0, nof_rb=24, start_symbol=0,
                                  duration=1),
    rnti=0x4601, aggregation_level=4, cce_index=0, payload_bits=60, n_id=1,
    n_id_data=1)
CONTROL_PLAN = ((J_SSB,), (J_PDCCH,), (), ())


def _control_payloads():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 2, 24).astype(np.int8),
            rng.integers(0, 2, 60).astype(np.int8))


def test_dl_control_only_plan_runs_on_payload_device():
    """An SSB + PDCCH plan (no PDSCH) builds its grid on the device of its
    payloads and matches the JAX program."""
    mib, dci = _control_payloads()
    j_samples, j_grid = j_slots.dl_slot_fn(J_CELL, CONTROL_PLAN)(
        (jnp.asarray(mib),), (jnp.asarray(dci),), ())
    t_samples, t_grid = t_slots.dl_slot_fn(
        convert.config(J_CELL), convert.plan(CONTROL_PLAN))(
        (torch.as_tensor(mib),), (torch.as_tensor(dci),), ())
    assert t_grid.device.type == "cpu" and t_samples.device.type == "cpu"
    np.testing.assert_allclose(t_grid.numpy(), np.asarray(j_grid), rtol=0,
                               atol=1e-6)
    close(t_samples, j_samples)


@pytest.mark.parametrize("where", ["ssb", "pdcch"])
def test_dl_payloads_on_mixed_devices_raise(where):
    mib, dci = _control_payloads()
    mib_t, dci_t = torch.as_tensor(mib), torch.as_tensor(dci)
    if where == "ssb":
        mib_t = mib_t.to("meta")
    else:
        dci_t = dci_t.to("meta")
    fn = t_slots.dl_slot_fn(convert.config(J_CELL), convert.plan(CONTROL_PLAN))
    with pytest.raises(ValueError, match="different devices"):
        fn((mib_t,), (dci_t,), ())


def test_dl_slot_without_payloads_raises():
    """The program never picks a device of its own."""
    fn = t_slots.dl_slot_fn(convert.config(J_CELL), ((), (), (), ()))
    with pytest.raises(ValueError, match="no device"):
        fn((), (), ())


def test_convert_dl_configs():
    """The DL configs map field for field; the CORESET nested in a PDCCH
    config converts too."""
    for cfg in (J_SSB, J_PDCCH, J_PDCCH.coreset):
        port = convert.config(cfg)
        assert type(port).__module__.startswith("srsran_tpu_torch.")
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert type(convert.config(J_PDCCH).coreset).__module__.startswith(
        "srsran_tpu_torch.")


def test_convert_ssb_context_pair():
    """ctx["ssb"][i] stays a pair (static_bits, scramble_mask) of int8
    tensors on the device; PDCCH pilot values go to the device too."""
    pair = j_ssb.slot_ctx_for(J_SSB, sfn=7, hrf=True)
    ctx = convert.slot_context(
        {"ssb": (pair,), "pdcch": (j_pdcch.dmrs_values_for(J_PDCCH),),
         "ptrs": (None,)}, "meta")
    (static, mask), = ctx["ssb"]
    assert static.dtype == mask.dtype == torch.int8
    assert static.shape == mask.shape == (32,)
    assert static.device.type == mask.device.type == "meta"
    assert ctx["pdcch"][0].dtype == torch.complex64
    assert ctx["ptrs"] == (None,)


@pytest.mark.slow
def test_flagship_loopback_on_cpu_twins():
    """The flagship slot (273 RB, 4096-point FFT, TBS 311400) end to end on
    the CPU twins: the port's transmitter into its receiver."""
    payload = torch.as_tensor(
        np.random.default_rng(0).integers(0, 2, 311400).astype(np.int8))
    samples = flagship.ue_samples(0, payload)
    rx = torch.cat([samples[:2], samples[:2]]) * 0.5
    out = flagship.ul_program()(rx, flagship.prach_fd("cpu"),
                                flagship.zero_soft_buffers("cpu"))
    assert bool(out["pusch"][0]["tb_crc_ok"])
    assert torch.equal(out["pusch"][0]["tb_bits"], payload)
