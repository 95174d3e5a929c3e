"""The port's gNB simulator (srsran_tpu_torch/apps/gnb_sim.py) and its
per-PRG precoding (K22's twin), against the JAX package, on the CPU.

* Per-PRG PDSCH: the port's ``pdsch.process`` with a PrecodingConfig
  against JAX's (24 RB, 2 and 4 ports, 1 and 2 layers, PRG sizes 2 and 4,
  an allocation not aligned to a PRG): the grid within 1e-6 of its
  largest magnitude (float32 products summed in another order).  Then the
  same PDSCH through both conductors' ``process_dl``: a PMI change gives
  JAX's samples and does not grow the port's DL phase cache.
* The app: ``run(cfg, device="cpu")`` against the JAX app run in-process
  (scheduler mode, 24 RB, 4 ports, no channel, PRACH and CSI periods 10):
  the same PRACH detections (slot, preamble and TC-RNTI exact, metric
  within 1%), UL CRC counts and scheduler counters.  Its 25 slots reach
  the DL slots after the first CSI report, which carry per-PRG precoding.
* Port-only runs of the app: test mode, scheduler mode over the TDLA
  channel, and the command line's unported flags.
"""

import contextlib
import dataclasses
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.fapi import conductor as j_cond
from srsran_tpu.fapi.messages import DlTtiRequest, TxDataRequest
from srsran_tpu.phy.slot_programs import CellConfig
from srsran_tpu.phy.upper import pdcch as j_pdcch
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.ran.precoding_codebooks import PrecodingConfig, nof_prgs
from srsran_tpu.ran.slot_point import SlotPoint

from srsran_tpu_torch import convert
from srsran_tpu_torch.apps import gnb_sim
from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
from srsran_tpu_torch.utils import config as t_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _pm_indices(ports, layers, n, shift=0):
    """n repository indices of ``layers``-layer matrices, varying per PRG."""
    if ports == 4:
        base, count = {1: (2, 32), 2: (34, 32)}[layers]
    else:
        base, count = {1: (2, 4), 2: (6, 2)}[layers]
    return tuple(base + (g + shift) % count for g in range(n))


def _prg_pdsch(ports, layers, prg, rb0, nrb, shift=0):
    return j_pdsch.PdschConfig(
        rnti=0x4601, rb_start=rb0, rb_count=nrb, first_symbol=1,
        nof_symbols=12, modulation="qam16", target_code_rate=0.5, tbs=2000,
        nof_layers=layers, n_id=1, dmrs_symbols=(2, 11), dmrs_scrambling_id=1,
        precoding=PrecodingConfig(prg_size=prg, pm_indices=_pm_indices(
            ports, layers, nof_prgs(rb0, nrb, prg), shift)))


@pytest.mark.parametrize("ports,layers,prg,rb0", [
    (2, 1, 2, 5), (2, 2, 4, 3), (4, 1, 4, 1), (4, 2, 2, 3)])
def test_pdsch_per_prg_matches_jax(ports, layers, prg, rb0):
    cfg = _prg_pdsch(ports, layers, prg, rb0, 24 - rb0 - 1)
    rng = np.random.default_rng(ports * 10 + layers + prg)
    tb = rng.integers(0, 2, cfg.tbs).astype(np.int8)
    grid = (0.1 * (rng.standard_normal((ports, 14, 288))
                   + 1j * rng.standard_normal((ports, 14, 288)))
            ).astype(np.complex64)
    ref = np.asarray(j_pdsch.process(jnp.asarray(grid), jnp.asarray(tb), cfg))
    out = t_pdsch.process(torch.as_tensor(grid.copy()), torch.as_tensor(tb),
                          convert.config(cfg)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))


def test_precode_prg_twin_rounds_like_the_kernel():
    """The twin's per-PRG product is the einsum's up to float32 rounding
    (its products and sums rounded one by one in K22's order)."""
    from srsran_tpu_torch.ops.precoding import precode_prg
    from srsran_tpu_torch.ran.precoding_codebooks import repository
    rng = np.random.default_rng(3)
    layers = torch.as_tensor((rng.standard_normal((2, 96))
                              + 1j * rng.standard_normal((2, 96))
                              ).astype(np.complex64))
    mats = torch.as_tensor(np.stack(repository(4)[34:40]))
    prg = torch.as_tensor(rng.integers(0, 6, 96))
    ref = torch.einsum("spl,ls->ps", mats[prg], layers)
    torch.testing.assert_close(precode_prg(layers, mats, prg), ref,
                               rtol=1e-6, atol=1e-6)


CELL = CellConfig(nof_ports=4, nof_rb=24, dft_size=512, numerology=1)


def _dl_request(shift):
    cfg = dataclasses.replace(_prg_pdsch(4, 2, 4, 2, 21, shift),
                              slot_in_frame=3)
    pdcch = j_pdcch.PdcchConfig(
        coreset=j_pdcch.CoresetConfig(rb_start=0, nof_rb=12, start_symbol=0,
                                      duration=1),
        rnti=0x4601, aggregation_level=2, cce_index=0, payload_bits=40,
        n_id=1, n_id_data=1, slot_in_frame=3)
    rng = np.random.default_rng(shift)
    tx = TxDataRequest(slot=SlotPoint(1, 3),
                       pdsch_payloads=(rng.integers(0, 2, cfg.tbs)
                                       .astype(np.int8),),
                       pdcch_payloads=(rng.integers(0, 2, 40)
                                       .astype(np.int8),))
    return DlTtiRequest(slot=SlotPoint(1, 3), pdcch=(pdcch,),
                        pdsch=(cfg,)), tx


def test_conductor_pmi_change_keeps_the_phase():
    """process_dl of a precoded PDSCH equals the JAX conductor's, for two
    PMI patterns, and the second pattern is a new context, not a new
    phase."""
    j_c = j_cond.SlotConductor(CELL)
    t_c = t_cond.SlotConductor(convert.config(CELL), device="cpu")
    for shift in (0, 5):
        dl, tx = _dl_request(shift)
        ref, _ = j_c.process_dl(dl, tx)
        got, _ = t_c.process_dl(convert.requests(dl), convert.requests(tx))
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()))
        assert len(t_c._dl_phases) == 1
    plan, ctx = t_cond.normalize_dl_plan(convert.requests(dl), nof_ports=4,
                                         device="cpu")
    assert plan[2][0].precoding.pm_indices == (0,) * 6
    assert ctx["pm"][0].shape == (6, 4, 2)
    with pytest.raises(ValueError, match="nof_ports"):
        t_cond.normalize_dl_plan(convert.requests(dl), device="cpu")


def _jax_app():
    spec = importlib.util.spec_from_file_location(
        "_jax_gnb_sim", REPO / "apps" / "gnb_sim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCHED_SETS = ["run.nof_slots=25", "cell.nof_rb=24", "cell.dft_size=512",
              "cell.nof_ports=4", "run.mac=sched",
              "run.prach_period_slots=10", "run.csi_period_slots=10"]


def test_app_matches_jax_app(monkeypatch):
    from srsran_tpu_torch.ops import dl_map
    precoded = []
    twin = dl_map.pdsch_map_ref

    def spy(*args):
        precoded.append(bool(args[14]))                # prg_size
        return twin(*args)

    monkeypatch.setattr(dl_map, "pdsch_map_ref", spy)
    app = _jax_app()
    argv = ["gnb_sim.py"] + [a for s in SCHED_SETS for a in ("--set", s)]
    monkeypatch.setattr(sys, "argv", argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        app.main()
    text = buf.getvalue()
    prach = [(int(s), int(p), float(m), int(t, 16)) for s, p, m, t in
             re.findall(r"slot (\d+): PRACH preamble (\d+) detected \(metric "
                        r"([\d.]+)\) -> TC-RNTI 0x([0-9a-f]+)", text)]
    crc = tuple(int(x) for x in re.search(
        r"UL CRC: (\d+) ok / (\d+) failed", text).groups())
    counters = eval(re.search(r"scheduler: (\{.*\})", text).group(1))

    res = gnb_sim.run(t_config.load(None, SCHED_SETS), device="cpu",
                      verbose=False)
    assert [(s, p, t) for s, p, t, _ in res["prach"]] == \
        [(s, p, t) for s, p, _, t in prach] and prach
    for (_, _, m, _), (_, _, _, mt) in zip(prach, res["prach"]):
        assert abs(mt - m) <= 0.01 * m + 0.05      # printed to 0.1
    assert (res["crc_ok"], res["crc_fail"]) == crc and crc[0] > 0
    assert res["counters"] == counters
    assert counters.get("csi_reports") and any(precoded)


def test_app_test_mode_decodes_every_tb():
    res = gnb_sim.run(t_config.load(None, [
        "run.nof_slots=10", "cell.nof_rb=24", "cell.dft_size=512",
        "cell.nof_ports=2"]), device="cpu", verbose=False)
    assert (res["dl_slots"], res["ul_slots"]) == (8, 2)
    assert res["crc_ok"] == 2 and res["crc_fail"] == 0
    assert res["counters"] is None and res["slot_device_us"] == {}


def test_app_over_the_tdl_channel():
    """Scheduler mode over TDLA at 28 dB: PRACH through the baseband
    collector, UL TBs decoded; two runs share no state (the UE HARQ
    buffers live in the run)."""
    sets = ["run.nof_slots=20", "cell.nof_rb=24", "cell.dft_size=512",
            "cell.nof_ports=2", "run.mac=sched", "run.prach_period_slots=10",
            "run.csi_period_slots=10", "run.channel_profile=TDLA",
            "run.channel_sinr_db=28"]
    runs = [gnb_sim.run(t_config.load(None, sets), device="cpu",
                        verbose=False) for _ in range(2)]
    for res in runs:
        assert res["crc_ok"] >= 3 and res["prach"]
        assert res["prach_windows"] == 2
    keep = ("crc_ok", "crc_fail", "prach", "counters")
    assert {k: runs[0][k] for k in keep} == {k: runs[1][k] for k in keep}


@pytest.mark.parametrize("flag", [["--pcap", "x.pcap"], ["--e2", "h:1"],
                                  ["--remote-port", "0"]])
def test_app_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="item 16"):
        gnb_sim.main(flag)


def test_app_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnb_sim.run(t_config.load(None, ["run.nof_slots=1"]))


def test_app_dump_config(capsys):
    gnb_sim.main(["--dump-config", "--set", "cell.nof_rb=273"])
    assert "nof_rb: 273" in capsys.readouterr().out
