"""The flagship scenarios' host side, the slot context's seed handling, and
the profiler's trace arithmetic, on the CPU.

The flagship slots themselves run on the card (``chip_smoke.py``,
``python3 -m srsran_tpu_torch.profile_slot``); here their configuration is
held against the JAX package's segmentation and the JAX bench's DL plan
and slot context, and ``chip_smoke.py`` is held to importing nothing of
this repo but the port.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_tpu.fapi.conductor import normalize_dl_plan, normalize_ul_plan
from srsran_tpu.fapi.messages import DlTtiRequest, UlTtiRequest
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pdcch as j_pdcch
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import prach as j_prach
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper import pusch as j_pusch
from srsran_tpu.phy.upper import srs as j_srs
from srsran_tpu.phy.upper import ssb as j_ssb
from srsran_tpu.ran.ldpc_params import segment_tb, select_base_graph
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc
from srsran_tpu.ran.slot_point import SlotPoint

from srsran_tpu_torch import convert, flagship, profile_slot
from srsran_tpu_torch.phy.upper import dmrs as t_dmrs
from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
from srsran_tpu_torch.phy.upper import pusch as t_pusch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SMALL_TBS = tbs_calc(24, 14, 36, "qam64", 0.7, 2)


def _imported_modules(path: Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", ["chip_smoke.py",
                                  "srsran_tpu_torch/flagship.py",
                                  "srsran_tpu_torch/profile_slot.py"])
def test_drivers_import_only_the_port(path):
    """The card's drivers reach this repo only through srsran_tpu_torch."""
    mods = _imported_modules(REPO / path)
    assert mods
    bad = [m for m in mods if m.split(".")[0] in ("srsran_tpu", "jax", "jaxlib")]
    assert not bad, bad


@pytest.mark.parametrize("tbs,rate", [(311400, 0.7), (SMALL_TBS, 0.7),
                                      (3816, 0.3), (200, 0.5)])
def test_segmentation_matches_jax(tbs, rate):
    cfg = dataclasses.replace(flagship.PUSCH, tbs=tbs, target_code_rate=rate)
    assert dataclasses.asdict(t_pusch.segmentation(cfg)) == dataclasses.asdict(
        segment_tb(tbs, select_base_graph(tbs, rate)))


def test_flagship_is_the_bench_slot():
    seg = flagship.SEG
    assert (seg.base_graph, seg.lifting_size, seg.nof_codeblocks,
            seg.codeword_bits) == (1, 384, 37, 25344)
    assert flagship.CELL.nof_sc == 273 * 12
    assert flagship.UE.tbs == flagship.PUSCH.tbs
    assert flagship.UL_PLAN == ((flagship.PUSCH,), (), (flagship.PUCCH,),
                                (), (flagship.PRACH,), (flagship.SRS,), ())


def test_flagship_dl_is_the_bench_slot():
    """TBS 835584 -> BG1, Z=384, 100 CBs, K'=8381; G = 32,760 REs x 4 layers
    x 8 bits; E = 10464 for the first 40 CBs and 10496 for the last 60."""
    seg = flagship.DL_SEG
    assert (seg.base_graph, seg.lifting_size, seg.nof_codeblocks,
            seg.cb_info_bits, seg.full_block_bits,
            seg.codeword_bits) == (1, 384, 100, 8381, 8448, 25344)
    assert t_pdsch.nof_data_re(flagship.PDSCH) == 32760
    e = t_pdsch.rate_match_sizes(flagship.PDSCH)
    assert e == (10464,) * 40 + (10496,) * 60 and sum(e) == 1_048_320
    assert flagship.DL_CELL == flagship.CELL


# The JAX bench's DL configs (bench.py:256-265).
J_SSB = j_ssb.SsbConfig(phys_cell_id=1, ssb_idx=0, l_max=8, sfn=0,
                        first_symbol=2, first_subcarrier=48)
J_PDCCH = j_pdcch.PdcchConfig(
    coreset=j_pdcch.CoresetConfig(rb_start=0, nof_rb=48, start_symbol=0,
                                  duration=1),
    rnti=0x4601, aggregation_level=8, cce_index=0, payload_bits=60, n_id=1,
    n_id_data=1)
J_PDSCH = j_pdsch.PdschConfig(rnti=0x4601, rb_start=0, rb_count=273,
                              first_symbol=1, nof_symbols=12,
                              modulation="qam256", target_code_rate=0.8,
                              tbs=835584, nof_layers=4, n_id=1,
                              dmrs_symbols=(2, 11))


def _bench_dl_request(i):
    """bench.py's dl_request(i)."""
    slot = SlotPoint(1, 2 * i)
    with_ssb = i % 40 == 0
    return DlTtiRequest(
        slot=slot,
        ssb=(dataclasses.replace(J_SSB, sfn=slot.sfn),) if with_ssb else (),
        pdcch=(dataclasses.replace(J_PDCCH, slot_in_frame=slot.slot_index),),
        pdsch=(dataclasses.replace(J_PDSCH, slot_in_frame=slot.slot_index),))


@pytest.mark.parametrize("i", [0, 1, 7, 40, 53])
def test_flagship_dl_plan_and_context_match_the_conductor(i):
    """The port's DL plans and slot context equal what the JAX conductor's
    normalize_dl_plan makes of the bench's requests."""
    plan, ctx = normalize_dl_plan(_bench_dl_request(i))
    with_ssb = i % 40 == 0
    assert convert.plan(plan) == (flagship.DL_PLAN_SSB if with_ssb
                                  else flagship.DL_PLAN)
    want = convert.slot_context(ctx, "cpu")
    got = flagship.dl_slot_context(i, "cpu")
    assert set(got) == set(want)
    for key in want:
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            if b is None:
                assert a is None
            elif isinstance(b, tuple):
                assert all(torch.equal(x, y) for x, y in zip(a, b))
            else:
                assert torch.equal(a, b)


# The JAX bench's UL configs (bench.py:268-285).
J_PUSCH = j_pusch.PuschConfig(rnti=0x17, rb_start=0, rb_count=269,
                              first_symbol=0, nof_symbols=14,
                              modulation="qam64", target_code_rate=0.7,
                              tbs=311400, nof_layers=2, n_id=1,
                              dmrs_symbols=(2, 7, 11))
J_PUCCH = j_pucch.PucchF1Config(prb=0, start_symbol=0, nof_symbols=14,
                                initial_cyclic_shift=0, time_domain_occ=0,
                                n_id=1)
J_PRACH = j_prach.PrachConfig(format="B4", root_sequence_index=39,
                              zero_correlation_zone=10, ra_scs_hz=30_000)
J_SRS = j_srs.SrsConfig(rb_start=269, rb_count=4, start_symbol=13,
                        nof_symbols=1, comb=2, comb_offset=0, cyclic_shift=0,
                        nof_ports=1, sequence_id=1, numerology=1, rnti=0x17)


def _bench_ul_request(i):
    """bench.py's ul_request(i)."""
    slot = SlotPoint(1, 2 * i)
    return UlTtiRequest(
        slot=slot,
        pusch=(dataclasses.replace(J_PUSCH, slot_in_frame=slot.slot_index),),
        pucch_f1=(dataclasses.replace(J_PUCCH, slot=slot.slot_index),),
        prach=(J_PRACH,), srs=(J_SRS,))


def _same_leaves(a, b):
    if b is None:
        assert a is None
    elif isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_leaves(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("i", [0, 1, 7, 12])
def test_flagship_ul_plan_and_context_match_the_conductor(i):
    """The port's UL plan (the full mix) and slot context equal what the
    JAX conductor's normalize_ul_plan makes of the bench's requests."""
    plan, ctx = normalize_ul_plan(_bench_ul_request(i))
    assert convert.plan(plan) == flagship.UL_PLAN
    want = convert.slot_context(ctx, "cpu")
    got = flagship.ul_slot_context(i, "cpu")
    assert set(got) == set(want)
    for key in want:
        _same_leaves(got[key], want[key])


def test_slot_context_keeps_seeds_on_host():
    """Pilot values go to the device; c_init seeds stay on the host."""
    cfg = j_pusch.dmrs_config(j_pusch.PuschConfig(
        rnti=1, rb_start=0, rb_count=4, first_symbol=0, nof_symbols=14,
        modulation="qpsk", target_code_rate=0.5, tbs=200,
        dmrs_symbols=(2, 11)))
    vals = j_dmrs.pilot_values_for(cfg)
    seeds = j_dmrs.c_inits_for(cfg)
    ctx = convert.slot_context({"pusch": (vals, seeds)}, "meta")
    assert ctx["pusch"][0].device.type == "meta"
    assert ctx["pusch"][1].device.type == "cpu"
    np.testing.assert_array_equal(ctx["pusch"][1].numpy(), seeds)


def test_pilots_refuse_device_seeds():
    cfg = t_dmrs.DmrsConfig(rb_start=0, rb_count=4, symbols=(2,), ports=(0,),
                            scrambling_id=1)
    seeds = torch.as_tensor(t_dmrs.c_inits_for(cfg).astype(np.int64))
    host = t_dmrs.pilots_for_port(cfg, 0, seeds, device="cpu")
    assert host.shape == (1, 24)
    with pytest.raises(ValueError, match="host"):
        t_dmrs.pilots_for_port(cfg, 0, seeds.to("meta"), device="cpu")


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 5)], 15.0),
    ([(0, 10), (5, 10)], 15.0),          # overlap
    ([(0, 30), (5, 10), (40, 1)], 31.0),  # nested
    ([(40, 1), (0, 30), (5, 10)], 31.0),  # any order
])
def test_busy_is_union_of_intervals(intervals, busy):
    events = [("k", "kernel", float(ts), float(d)) for ts, d in intervals]
    assert profile_slot.busy_us(events) == busy


@pytest.mark.parametrize("name,cat,bucket", [
    ("ldpc_sweep_kernel(float*, ...)", "kernel", "ldpc_sweep_kernel"),
    ("void vector_fft<64u, 16u>(...)", "kernel", "cuFFT"),
    ("ampere_sgemm_32x32_sliced1x4_nn", "kernel", "GEMM/GEMV"),
    ("void gemv2T_kernel_val<int, int, float>", "kernel", "GEMM/GEMV"),
    ("void at::native::reduce_kernel<512, 1>", "kernel", "reductions"),
    ("void at::native::elementwise_kernel<128, 2>(copy_)", "kernel",
     "copy kernels (on the device)"),
    ("void at::native::index_elementwise_kernel", "kernel",
     "other elementwise / index kernels"),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy",
     "Memcpy DtoD (Device -> Device)"),
    ("dlsch_encode_kernel(signed char const*, ...)", "kernel",
     "dlsch_encode_kernel"),
    ("void pdsch_map_kernel<8>(...)", "kernel", "pdsch_map_kernel"),
    ("ofdm_cp_insert_kernel(float2 const*, ...)", "kernel",
     "ofdm_cp_insert_kernel"),
    ("chest_interp_kernel(int, int, ...)", "kernel", "chest_interp_kernel"),
    ("prach_detect_kernel(float const*, ...)", "kernel",
     "prach_detect_kernel"),
    ("pucch_f1_kernel(float2 const*, ...)", "kernel", "pucch_f1_kernel"),
    ("srs_noise_kernel(float2 const*, ...)", "kernel", "srs_noise_kernel"),
])
def test_profile_categories(name, cat, bucket):
    assert profile_slot.category(name, cat) == bucket


# The conductor scenario: the bench's requests (bench.py:306-334) with the
# PUCCH UEs' F0 and F2 PDUs.
J_F0 = j_pucch.PucchF0Config(prb=269, start_symbol=11, nof_symbols=2,
                             initial_cyclic_shift=0, n_id=1, nof_harq_bits=2,
                             sr_opportunity=True)
J_F2 = (j_pucch.PucchF2Config(rb_start=270, nof_rb=1, start_symbol=11,
                              nof_symbols=2, rnti=0x18, n_id=1, n_id0=1,
                              nof_uci_bits=6),
        j_pucch.PucchF2Config(rb_start=271, nof_rb=2, start_symbol=11,
                              nof_symbols=2, rnti=0x19, n_id=1, n_id0=1,
                              nof_uci_bits=22))


def _conductor_ul_request(i):
    req = _bench_ul_request(i)
    sl = req.slot.slot_index
    return dataclasses.replace(
        req, pucch_f0=(dataclasses.replace(J_F0, slot=sl),),
        pucch_f2=tuple(dataclasses.replace(c, slot=sl) for c in J_F2))


@pytest.mark.parametrize("i", [0, 1, 7, 9])
def test_conductor_requests_are_the_bench_requests(i):
    assert convert.requests(_bench_dl_request(i)) == flagship.dl_request(i)
    assert convert.requests(_conductor_ul_request(i)) == flagship.ul_request(i)
    assert 269 * 12 + 12 * 4 == flagship.CELL.nof_sc   # PRBs 269-272 fit


@pytest.mark.parametrize("i", [0, 3, 9])
def test_conductor_contexts_match_the_jax_conductor(i):
    """The port conductor's normalized plans and slot context (F0
    references, F1 weights, F2 pilots, DM-RS, SSB) equal the JAX
    conductor's for the scenario's requests."""
    from srsran_tpu_torch.fapi import conductor as t_cond
    plan, ctx = normalize_ul_plan(_conductor_ul_request(i))
    t_plan, t_ctx = t_cond.normalize_ul_plan(flagship.ul_request(i),
                                             device="cpu")
    assert convert.plan(plan) == t_plan
    want = convert.slot_context(ctx, "cpu")
    assert set(t_ctx) == set(want)
    for key in want:
        _same_leaves(t_ctx[key], want[key])
    plan, ctx = normalize_dl_plan(_bench_dl_request(i), (), 4)
    t_plan, t_ctx = t_cond.normalize_dl_plan(flagship.dl_request(i), (), 4,
                                             device="cpu")
    assert convert.plan(plan) == t_plan
    want = convert.slot_context(ctx, "cpu")
    assert set(t_ctx) == set(want)
    for key in want:
        _same_leaves(t_ctx[key], want[key])
