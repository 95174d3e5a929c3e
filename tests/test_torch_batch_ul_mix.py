"""The slot-batch mode's UL receivers, once per batch, on the CPU.

``SlotConductor.process_slot_batch`` (B = 3) runs the flagship's UL mix on
a small cell (2 ports, 24 RB, 512-point FFT, 30 kHz): a PUSCH on RBs 0-19
and in the four RBs above it a PUCCH F0 (SR + 2 HARQ bits), an F1 group of
two users, an F2 of 6 bits (short block) and one of 22 bits (polar), an SRS
and a B4 PRACH occasion.  The UE sends the PUSCH, both F1 users, the F0,
both F2s and the SRS through a 1x2 channel at about 20 dB.

- Against the JAX package's ``process_slot_batch`` (``jax.vmap`` of the
  slot program), with the plain twins: the JAX conductor feeds one PRACH
  capture to every slot (ROADMAP §3), so this comparison gives the port
  that one capture in every slot.
- Against the port's own ``process_slot``, slot by slot, on a distinct
  capture per slot (one of them noise alone).
- Each receiver with a slot axis against the same receiver slot by slot.
- The ctypes signatures of the kernels' C entry points against the
  sources (the CUDA kernels do not build here), and the slot count of the
  entry points with a slot axis (K3, K16-K19).

Tolerances: TB bits, UCI bits, detections, CRC and valid flags equal;
packed scalars within 2e-4 (as tests/test_torch_batch.py); indications by
``convert.slot_results`` at rtol 1e-4 (2e-4 against process_slot); a
receiver's slot axis against its per-slot runs: decisions equal, floats
within rtol 1e-6 of max|ref| (K14's twin is one product over all rows).
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.fapi import conductor as j_cond
from srsran_tpu.fapi.messages import (DlTtiRequest, TxDataRequest,
                                      UlTtiRequest)
from srsran_tpu.ops import ofdm as j_ofdm
from srsran_tpu.phy.slot_programs import CellConfig
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper import srs as j_srs
from srsran_tpu.phy.upper.pdcch import CoresetConfig, PdcchConfig
from srsran_tpu.phy.upper.pusch import PuschConfig
from srsran_tpu.ran.slot_point import SlotPoint

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import ofdm as t_ofdm
from srsran_tpu_torch.ops import short_block
from srsran_tpu_torch.phy import slot_programs as t_slots
from srsran_tpu_torch.phy.upper import prach as t_prach
from srsran_tpu_torch.phy.upper import pucch as t_pucch
from srsran_tpu_torch.phy.upper import srs as t_srs
from srsran_tpu_torch.phy.upper import uci as t_uci

torch.set_num_threads(2)

CELL = CellConfig(nof_ports=2, nof_rb=24, dft_size=512, numerology=1)
T_CELL = convert.config(CELL)
PDCCH = PdcchConfig(
    coreset=CoresetConfig(rb_start=0, nof_rb=24, start_symbol=0, duration=1),
    rnti=0x4601, aggregation_level=2, cce_index=0, payload_bits=40,
    n_id=1, n_id_data=1)
PUSCH = PuschConfig(rnti=0x17, rb_start=0, rb_count=20, first_symbol=0,
                    nof_symbols=14, modulation="qpsk", target_code_rate=0.5,
                    tbs=2560, nof_layers=1, n_id=1, dmrs_symbols=(2, 7, 11))
# Two F1 users on one occasion (PRB 21, symbols 0-9): one group.
F1 = j_pucch.PucchF1Config(prb=21, start_symbol=0, nof_symbols=10,
                           initial_cyclic_shift=0, time_domain_occ=0, n_id=1)
F1_USERS = ((0, 0, 1), (6, 1, 2))       # (m0, time-domain OCC, HARQ bits)
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
PRACH = convert.config(flagship.PRACH)   # B4, L = 139: fits any cell
B = 3
NOISE_SLOT = 1
DCI_BITS = np.random.default_rng(3).integers(0, 2, 40).astype(np.uint8)


def _f1_cfg(user):
    m0, occ, nbits = user
    return dataclasses.replace(F1, initial_cyclic_shift=m0,
                               time_domain_occ=occ, nof_harq_bits=nbits)


def dl_req(k):
    s = SlotPoint(1, 2 * k)
    return DlTtiRequest(
        slot=s, pdcch=(dataclasses.replace(PDCCH, slot_in_frame=s.slot_index),))


def tx_req(k):
    return TxDataRequest(slot=SlotPoint(1, 2 * k),
                         pdcch_payloads=(np.packbits(DCI_BITS),))


def ul_req(k):
    s = SlotPoint(1, 2 * k)
    sl = s.slot_index
    return UlTtiRequest(
        slot=s, pusch=(dataclasses.replace(PUSCH, slot_in_frame=sl),),
        pucch_f0=(dataclasses.replace(F0, slot=sl),),
        pucch_f1=tuple(dataclasses.replace(_f1_cfg(u), slot=sl)
                       for u in F1_USERS),
        pucch_f2=(dataclasses.replace(F2_SB, slot=sl),
                  dataclasses.replace(F2_POLAR, slot=sl)),
        prach=(flagship.PRACH,), srs=(SRS,))


def ue_samples(k, rng):
    """Slot (1, 2k) as the UE sends it (the JAX UE side): the PUSCH on
    port 0 (the PDSCH chain with the PUSCH's scrambling and DM-RS), the
    SRS, both F1 users, the F0 and both F2s, through a 1x2 channel with
    noise at about 20 dB.  Returns (rx complex64 [2, T], TB, sent UCI)."""
    sl = (2 * k) % 20
    ue = j_pdsch.PdschConfig(
        rnti=PUSCH.rnti, rb_start=0, rb_count=20, first_symbol=0,
        nof_symbols=14, modulation="qpsk", target_code_rate=0.5,
        tbs=PUSCH.tbs, nof_layers=1, n_id=1, dmrs_symbols=(2, 7, 11),
        slot_in_frame=sl)
    tb = rng.integers(0, 2, PUSCH.tbs).astype(np.int8)
    grid = j_pdsch.process(jnp.zeros((1, 14, CELL.nof_sc), jnp.complex64),
                           jnp.asarray(tb), ue,
                           precoding=np.eye(1, dtype=np.complex64))
    grid = j_srs.map_to_grid(grid, SRS)
    sent = {"f1": [rng.integers(0, 2, u[2]) for u in F1_USERS],
            "f0": (rng.integers(0, 2, 2), int(rng.integers(0, 2)))}
    for user, bits in zip(F1_USERS, sent["f1"]):
        grid = j_pucch.transmit_format1(
            grid, dataclasses.replace(_f1_cfg(user), slot=sl), bits)
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
    rx = rx + 0.1 / np.sqrt(2) * (rng.standard_normal(rx.shape)
                                  + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64), tb, sent


def _captures(rng):
    """One PRACH capture per slot (preamble 21 on both ports), noise alone
    in slot NOISE_SLOT; complex64 [B, 2, 12, 139]."""
    caps = [flagship.prach_capture(rng, nof_ports=2) for _ in range(B)]
    shape = caps[NOISE_SLOT].shape
    caps[NOISE_SLOT] = (0.05 * (rng.standard_normal(shape)
                                + 1j * rng.standard_normal(shape))
                        ).astype(np.complex64)
    return np.stack(caps)


@pytest.fixture(scope="module")
def mix():
    """B slots of the UL mix through the JAX batch (one shared PRACH
    capture), the port's batch on that capture in every slot, the port's
    batch on one capture per slot and the port's process_slot on each."""
    rng = np.random.default_rng(13)
    reqs = [(dl_req(k), tx_req(k), ul_req(k)) for k in range(B)]
    ue = [ue_samples(k, rng) for k in range(B)]
    rx_b = np.stack([u[0] for u in ue])
    caps = _captures(rng)
    j_c = j_cond.SlotConductor(CELL)
    j_st = j_c.stage_payloads([(d, t) for d, t, _ in reqs])
    _, j_p = j_c.process_slot_batch(
        [(d, u) for d, _, u in reqs], j_st, jnp.asarray(rx_b),
        prach_fd=(jnp.asarray(caps[0]),))
    t_c = t_cond.SlotConductor(T_CELL, device="cpu")
    t_st = t_c.stage_payloads([(convert.requests(d), convert.requests(t))
                               for d, t, _ in reqs])
    slots = [(convert.requests(d), convert.requests(u)) for d, _, u in reqs]
    rx_t = torch.as_tensor(rx_b)
    shared = torch.as_tensor(np.stack([caps[0]] * B))
    _, p_shared = t_c.process_slot_batch(slots, t_st, rx_t, prach_fd=(shared,))
    own = torch.as_tensor(caps)
    _, p_own = t_c.process_slot_batch(slots, t_st, rx_t, prach_fd=(own,))
    per_slot = []
    for k, (d, u) in enumerate(slots):
        _, p = t_c.process_slot(d, u, t_st, k, rx_t[k], prach_fd=(own[k],))
        per_slot.append((p.scalars.numpy(), p.payload.numpy(), p.resolve()))
    return dict(ue=ue, j_scalars=np.asarray(j_p.scalars), j_res=j_p.resolve(),
                t_scalars=p_shared.scalars.numpy(), t_res=p_shared.resolve(),
                own_scalars=p_own.scalars.numpy(),
                own_payload=p_own.payload.numpy(), own_res=p_own.resolve(),
                per_slot=per_slot)


def test_batch_scalars_match_jax(mix):
    got, ref = mix["t_scalars"], mix["j_scalars"]
    assert got.shape == ref.shape and got.shape[0] == B
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("k", range(B))
def test_batch_slot_matches_jax(mix, k):
    """Slot k's indications against the JAX batch's, and every PDU of the
    mix decoded as the UE sent it."""
    got = mix["t_res"][k]
    convert.slot_results(mix["j_res"][k], got)
    _, tb, sent = mix["ue"][k]
    assert got.crc[0].tb_crc_ok
    np.testing.assert_array_equal(got.rx_data[0].payload, tb)
    assert [r.preamble_index for r in got.rach] == [flagship.PRACH_PREAMBLE]
    f0, f1a, f1b, f2_sb, f2_polar = got.uci
    assert f0.detected and f0.sr_bit == sent["f0"][1]
    np.testing.assert_array_equal(f0.harq_bits, sent["f0"][0])
    for ind, bits in ((f1a, sent["f1"][0]), (f1b, sent["f1"][1])):
        assert ind.detected
        np.testing.assert_array_equal(ind.harq_bits, bits)
    for ind, bits in ((f2_sb, sent["f2_sb"]), (f2_polar, sent["f2_polar"])):
        assert ind.detected
        np.testing.assert_array_equal(ind.csi_bits, bits)
    assert np.all(np.isfinite(got.srs[0].wideband_h))


@pytest.mark.parametrize("k", range(B))
def test_batch_equals_process_slot(mix, k):
    """Each slot's own PRACH capture: the batch equals process_slot on the
    same slot, and only the slot with a preamble reports it."""
    scalars, payload, res = mix["per_slot"][k]
    np.testing.assert_allclose(mix["own_scalars"][k], scalars, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(mix["own_payload"][k], payload)
    convert.slot_results(res, mix["own_res"][k], rtol=2e-4)
    want = [] if k == NOISE_SLOT else [flagship.PRACH_PREAMBLE]
    assert [r.preamble_index for r in mix["own_res"][k].rach] == want


# ---------------------------------------------- each receiver's slot axis

def _slot_grids(rng):
    """B slots' UE grids at the receiver: demodulated [B, 2, 14, 288]."""
    rx = np.stack([ue_samples(k, rng)[0] for k in range(B)])
    return t_ofdm.demodulate_slot_ref(
        torch.as_tensor(rx), T_CELL.nof_sc, T_CELL.dft_size,
        T_CELL.numerology, T_CELL.cp, 0, T_CELL.center_freq_hz)


@pytest.fixture(scope="module")
def slot_inputs():
    """The B slots' grids, the stacked slot context of their UL requests
    (stack_ctx of each slot's normalize_ul_plan context, as the batch
    builds it) and one PRACH capture per slot."""
    rng = np.random.default_rng(29)
    grid = _slot_grids(rng)
    ctxs = [t_cond.normalize_ul_plan(convert.requests(ul_req(k)),
                                     device="cpu")[1] for k in range(B)]
    ctx, _ = t_slots.stack_ctx(ctxs)
    return dict(grid=grid, ctx=ctx, ctxs=ctxs,
                prach=torch.as_tensor(_captures(rng)))


def _uci_llrs(k, e, qm, seed):
    """B noisy codewords of k random bits at E = e (the UE's encoder)."""
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(rng.integers(0, 2, (B, k)).astype(np.int8))
    cw = torch.stack([t_uci.encode_uci(b, e, qm) for b in bits])
    return (1.0 - 2.0 * cw.to(torch.float32)
            + 0.7 * torch.as_tensor(rng.standard_normal(cw.shape),
                                    dtype=torch.float32))


def _receivers(inp):
    """name -> (run on the B slots, run on slot b): each receiver of the
    UL program's control entries, with the slot context of the batch."""
    grid, ctx, ctxs = inp["grid"], inp["ctx"], inp["ctxs"]
    t = convert.config
    f1_common, users = t(F1), F1_USERS
    sb, polar = _uci_llrs(6, 32, 2, 1), _uci_llrs(22, 64, 2, 2)
    return {
        "f0": (lambda: t_pucch.detect_format0(grid, t(F0), ncs=ctx["f0"][0]),
               lambda b: t_pucch.detect_format0(grid[b], t(F0),
                                                ncs=ctxs[b]["f0"][0])),
        "f1": (lambda: t_pucch.detect_format1_batch(
                   grid, f1_common, users, ncs=ctx["f1"][0]),
               lambda b: t_pucch.detect_format1_batch(
                   grid[b], f1_common, users, ncs=ctxs[b]["f1"][0])),
        "f2_short_block": (
            lambda: t_pucch.process_format2(grid, t(F2_SB), ctx["f2"][0]),
            lambda b: t_pucch.process_format2(grid[b], t(F2_SB),
                                              ctxs[b]["f2"][0])),
        "f2_polar": (
            lambda: t_pucch.process_format2(grid, t(F2_POLAR), ctx["f2"][1]),
            lambda b: t_pucch.process_format2(grid[b], t(F2_POLAR),
                                              ctxs[b]["f2"][1])),
        "srs": (lambda: t_srs.estimate(grid, t(SRS)),
                lambda b: t_srs.estimate(grid[b], t(SRS))),
        "prach": (lambda: t_prach.detect(inp["prach"], PRACH),
                  lambda b: t_prach.detect(inp["prach"][b], PRACH)),
        "uci_short_block": (lambda: t_uci.decode_uci(sb, 6, 2),
                            lambda b: t_uci.decode_uci(sb[b], 6, 2)),
        "uci_polar": (lambda: t_uci.decode_uci(polar, 22, 2),
                      lambda b: t_uci.decode_uci(polar[b], 22, 2)),
        "short_block_detect": (
            lambda: short_block.detect_ref(sb[:, None], 6, 2),
            lambda b: short_block.detect_ref(sb[b:b + 1], 6, 2)),
    }


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _leaves(v)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _leaves(v)]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in _leaves(getattr(obj, f.name))]
    return []


@pytest.mark.parametrize("name", ["f0", "f1", "f2_short_block", "f2_polar",
                                  "srs", "prach", "uci_short_block",
                                  "uci_polar", "short_block_detect"])
def test_receiver_slot_axis_equals_per_slot(slot_inputs, name):
    """The receiver on the B slots at once gives, in row b of every value,
    what it gives on slot b alone (with that slot's context)."""
    batch_fn, one_fn = _receivers(slot_inputs)[name]
    got = _leaves(batch_fn())
    for b in range(B):
        ref = _leaves(one_fn(b))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            g = g[b]
            assert g.shape == r.shape and g.dtype == r.dtype
            if r.is_floating_point() or r.is_complex():
                atol = 1e-6 * float(r.abs().max()) if r.numel() else 0.0
                torch.testing.assert_close(g, r, rtol=1e-6, atol=atol)
            else:
                assert torch.equal(g, r)


def test_receivers_take_shared_context(slot_inputs):
    """Without a slot context (the multi-cell programs) the receivers
    build one set of references, shared by the B slots: F0 and F1 then
    equal their per-slot runs on the plan's slot."""
    grid = slot_inputs["grid"]
    t = convert.config
    f0 = t_pucch.detect_format0(grid, t(F0))
    f1 = t_pucch.detect_format1_batch(grid, t(F1), F1_USERS)
    for b in range(B):
        one = t_pucch.detect_format0(grid[b], t(F0))
        assert all(torch.equal(f0[k][b], one[k]) for k in one)
        for u, v in zip(f1, t_pucch.detect_format1_batch(grid[b], t(F1),
                                                         F1_USERS)):
            assert all(torch.equal(u[k][b], v[k]) for k in v)


# ----------------------------------------- the kernels' C entry points

_CTYPES = {"void*": _build._P, "const void*": _build._P, "int": _build._I,
           "float": _build._F, "double": _build._D, "long long": _build._L,
           "ControlArgs": _build.ControlArgs}


def _c_entry_points() -> dict:
    """name -> parameter types of every ``extern "C"`` function in csrc."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = [re.sub(r"\s+\w+$", "", p.strip())
                     for p in params.split(",")]
            found[name] = [_CTYPES[re.sub(r"\s+", " ", t)] for t in types]
    return found


def test_ctypes_signatures_match_sources():
    """Every C entry point is bound with its own parameter list (a slot
    count or stride added to a kernel must reach its ctypes binding)."""
    assert _c_entry_points() == _build.SIGNATURES


def _c_parameter_names(name: str) -> list:
    """The parameter names of one ``extern "C"`` entry point in csrc."""
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        found = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        if found:
            return [p.split()[-1].lstrip("*")
                    for p in found.group(1).split(",")]
    raise AssertionError(f"{name} not in csrc")


def _slot_count_in_struct(name: str) -> None:
    """K16's, K18's and K19's slot count: an int field ``nslots`` of the
    parameter struct their entry point takes after the stream, which the
    wrapper fills from the slot axis (3) or with 1 without one."""
    from srsran_tpu_torch.ops import ul_demap
    from srsran_tpu_torch.phy.upper import pusch as t_pusch
    c64, f32, i32 = torch.complex64, torch.float32, torch.int32
    if name == "srsran_pusch_demap_lxn":
        assert _c_parameter_names(name)[-3:] == ["stream", "params", "seq"]
        assert ("nslots", _build._I) in _build.LxnParams._fields_

        def build(lead):
            return ul_demap._lxn_params(
                (lead + (4, 14, 3276), lead + (4, 4, 1, 2460), (27060,),
                 (27060,), lead), (c64, c64, i32, i32, f32), 0, "qam64", 4,
                "mmse", 0)
        assert build((3,)).nslots == 3 and build(()).nslots == 1
        return
    if name == "srsran_pusch_demap":
        assert _c_parameter_names(name)[-3:] == ["stream", "params", "seq"]
        assert ("nslots", _build._I) in _build.LxnParams._fields_

        def build(lead):
            return ul_demap._lxn_params(
                (lead + (4, 14, 3276), lead + (4, 2, 1, 3228), (35508,),
                 (35508,), lead), (c64, c64, i32, i32, f32), 0, "qam64", 2,
                "zf", 0)
        assert build((3,)).nslots == 3 and build(()).nslots == 1
        return
    assert _c_parameter_names(name)[-4:-1] == ["stream", "params",
                                               "twiddle"]
    if name == "srsran_pusch_tp_demap":
        assert ("nslots", _build._I) in _build.TpDemapParams._fields_
        cfg = flagship.EDGE.pusch_c
        key = t_pusch._tp_key(cfg)
        plan, hops = t_pusch.tp_plan(key, 0), t_pusch.tp_plan(key, 1)

        def build(lead):
            return ul_demap._tp_params(
                (lead + (4, 14, 3276), lead + (4, 1, 1, 144), plan.shape,
                 lead + (2, 4), hops.shape), (c64, c64, i32, f32, i32), 72,
                cfg.modulation, cfg.equalizer)
    else:
        assert ("nslots", _build._I) in _build.F3DemapParams._fields_

        def build(lead):
            return t_pucch._f3_params(
                (lead + (4, 14, 3276), lead + (4, 1, 1, 24), lead + (4,)),
                (c64, c64, f32), flagship.EDGE.f3)
    assert build((3,)).nslots == 3 and build(()).nslots == 1


@pytest.mark.parametrize("name", [
    "srsran_pusch_demap", "srsran_pusch_demap_lxn", "srsran_ulsch_demux",
    "srsran_pusch_tp_demap", "srsran_pucch_f3_demap"])
def test_batched_entry_points_take_a_slot_count(name):
    """The equalizers and the demultiplexer with a slot axis (K3, K16-K19)
    take a slot count: K17 just before the stream, as an int in its ctypes
    binding; K3, K16, K18 and K19 in the parameter struct of their lean
    launch path (``nslots``)."""
    if name in ("srsran_pusch_demap", "srsran_pusch_demap_lxn",
                "srsran_pusch_tp_demap", "srsran_pucch_f3_demap"):
        _slot_count_in_struct(name)
        return
    names = _c_parameter_names(name)
    assert names[-2:] == ["nslots", "stream"]
    assert _build.SIGNATURES[name][-2:] == [_build._I, _build._P]
