"""Where a flagship slot's time goes on one CUDA GPU.

    python3 -m srsran_tpu_torch.profile_slot
        [--direction ul|dl|conductor|ul_mu|batch|batch_mu|batch_edge|edge|
                     gnb|du_low|du_alloc|split8|last]
        [--slots 8]
        [--calls 10]
        [--out DIR]

Drives the flagship UL slot (the full mix: PUSCH, PUCCH F1, PRACH, SRS),
DL slot (SSB in the first slot, PDCCH, 4-layer PDSCH, OFDM), conductor
slot (DL + UL with the PUCCH F0/F2 UCI PDUs through
``SlotConductor.process_slot``, payloads staged beforehand, results
resolved after the measurement) or two-UE UL slot (``ul_mu``: a 4-layer
MMSE PUSCH and a 1-layer PUSCH with HARQ-ACK and CSI parts 1-2 beside the
PUCCH F1, PRACH and SRS, through ``ul_slot_fn``; every slot checked after
the measurement) or slot batch (``batch``: conductor phases 1-4 as one
``process_slot_batch`` of B = 4 per call, ``--slots`` batches, each slot
checked after the measurement; "per slot" below then reads "per batch";
``batch_mu`` and ``batch_edge`` the same with the two-UE slot at one RI
and with the cell-edge slot, each slot its own payloads, UCI and samples
beside the flagship DL of phases 1-4, the bench's PRACH capture in every
slot) or cell-edge UL slot (``edge``: a 2-layer PUSCH, a DFT-s-OFDM PUSCH with
intra-slot hopping and HARQ-ACK, PUCCH F1, F3 and F4, PRACH and SRS,
through ``ul_slot_fn``; every slot checked after the measurement) of
:mod:`srsran_tpu_torch.flagship`, or the gNB simulator (``gnb``: one call
is a whole scheduler-mode run of ``apps/gnb_sim`` over ``--slots`` slots
at the flagship width, TDLA at 28 dB, PRACH and CSI periods of 10; "per
slot" below then reads "per run", and every run must decode a UL TB), or
the DU-low's DL slots (``du_low``: kinds A-D of ``flagship.du_dl_request``
in turn -- CSI-RS, TRS, PT-RS, PRS and an empty DL_TTI -- each through
``SlotConductor.process_dl`` as ``fapi/transport.py::serve_phy`` runs it,
eagerly, with its payload upload), or the DU-low's allocation slots and
their UE side (``du_alloc``: kinds E and F of ``flagship.du_alloc_request``
in turn -- a type 0 PDSCH precoded per PRG beside the SSB and five DCIs,
an interleaved-VRB PDSCH beside a DCI -- each through ``process_dl``, then
``flagship.du_control_rx`` on its samples: K4, one K28 launch, one K15
launch per codeword), or the split-8 radio's UE side (``split8``: apps/
ssb_tx.py's two SSB slots at the flagship width on one port in turn, each
clipped (K31) and CFO-rotated (K30), OFDM-demodulated (K4), its PBCH
demapped (K28) and decoded by K15 and by the list decoder K29, beside one
UE slot's 36 AL16 PDCCH candidates through K29; K32's case is the UE
transmitter's rate match), or the last device functions (``last``:
``flagship.last_path`` per call -- the PBCH and slot E's DCIs through
K33 beside K27 and back through K28 and K15, the F2s and a UCI batch
through K33/K34, K34 at every K and Qm, the flagship PUSCH's LLRs
through K35 and decoded, K1 on every row and K36, K8 on slot E's type 0
comb -- with K33-K36's and the type 0 K8's cases) and reports:

* the slot's wall time three ways: CUDA events around each call (as
  ``chip_smoke.py`` times it), the host clock over back-to-back calls with
  one synchronize at the end, and the host clock with a synchronize after
  every call;
* the slot's device time from a ``torch.profiler`` trace: every device
  activity (kernels, memcpys, memsets) of the profiled slots, as the sum
  of their durations and as the union of their intervals (the busy time),
  the span from the first start to the last end and the idle share of that
  span, and the busy time by category (hand kernels, FFT, GEMM, copies by
  direction, elementwise and reductions);
* the device activities with the most device time, by name;
* the plain glue: the device activities that are no hand kernel (PyTorch's
  own kernels, copies, memsets), grouped by name: device µs and count per
  slot and share of the glue's device time, the most first;
* for the same trace, the sum of ``self_device_time_total`` over the rows
  of ``key_averages()``: a second reading that counts some device time more
  than once, kept to show how far it lies from the trace;
* each hand kernel of the direction's path: its device time and device
  activities per call against its plain twin's, over ``--calls`` calls
  each (none for ``batch``: ``chip_smoke.py`` times the batched kernels);
* the hand kernels' launch counts over one call (for the conductor and the
  batch, through their CUDA graphs).

The conductor and batch directions run every call once before measuring,
so every slot phase's CUDA graph is captured beforehand; so do
``du_low`` and ``du_alloc``, so every slot kind's constants are on the
card.

The slot's trace and a JSON summary go to ``--out`` (``slot_trace.json``
and ``summary.json`` for the UL, ``dl_``, ``conductor_``, ``ul_mu_``,
``batch_``, ``batch_mu_``, ``batch_edge_``, ``edge_``, ``gnb_``,
``du_low_``, ``du_alloc_``, ``split8_`` or ``last_``
before both
names for the others);
the summary is also printed as the last line.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from . import flagship, kernels
from .apps import gnb_sim, ssb_tx
from .device import card_line, require_cuda
from .fapi.conductor import SlotConductor
from .fapi.messages import DlTtiRequest, TxDataRequest
from .kernels import _build
from .ops import dl_control, ofdm, polar, polar_scl
from .phy.lower import amplitude_control, cfo
from .phy.upper import ssb
from .ran.slot_point import SlotPoint
from .utils import config as app_config

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HAND_KERNELS = ("ldpc_sweep_kernel", "ldpc_decode_kernel",
                "rate_dematch_kernel", "pusch_demap_kernel",
                "ofdm_demod_kernel", "ofdm_demod_mixed_kernel",
                "dlsch_encode_kernel", "pdsch_map_kernel",
                "ofdm_mod_kernel", "ofdm_mod_mixed_kernel",
                "chest_kernel", "prach_detect_kernel", "pucch_f1_kernel",
                "srs_noise_kernel", "pucch_f0_kernel", "pucch_f2_kernel",
                "short_block_kernel", "polar_sc_kernel",
                "pusch_demap_lxn_kernel", "ulsch_demux_kernel",
                "pusch_tp_demap_kernel", "pucch_f3_demap_kernel",
                "dmrs_map_kernel", "rs_map_kernel", "control_map_kernel",
                "control_llrs_kernel", "polar_scl_kernel", "rate_match_kernel",
                "cfo_kernel", "amplitude_kernel", "amplitude_finish",
                "polar_encode_kernel", "short_block_encode_kernel",
                "llr_quantize_kernel", "llr_dequantize_kernel",
                "ldpc_parity_kernel", "prach_demod_kernel",
                "prach_demod_sum")


def category(name: str, cat: str) -> str:
    """The breakdown bucket of one device activity."""
    if cat != "kernel":
        return name                      # e.g. "Memcpy DtoD (Device -> Device)"
    for k in HAND_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "fft" in low:
        return "cuFFT"
    if "gemm" in low or "gemv" in low or "splitk" in low or "cutlass" in low:
        return "GEMM/GEMV"
    if "reduce" in low:
        return "reductions"
    if "copy" in low:
        return "copy kernels (on the device)"
    return "other elementwise / index kernels"


def device_events(prof, path: Path, keep: bool) -> list:
    """(name, category, start us, duration us) of every device activity in
    a finished profile, read back from its exported chrome trace (deleted
    afterwards unless ``keep``)."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    if not keep:
        path.unlink()
    return [(e["name"], e.get("cat", ""), float(e["ts"]), float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS]


def busy_us(events: list) -> float:
    """Length of the union of the activities' intervals."""
    total, end = 0.0, -float("inf")
    for _, _, ts, dur in sorted(events, key=lambda e: e[2]):
        if ts + dur <= end:
            continue
        total += ts + dur - max(ts, end)
        end = ts + dur
    return total


def self_device_us(prof) -> float:
    """Sum of self device time over the rows of key_averages()."""
    total = 0.0
    for row in prof.key_averages():
        total += float(getattr(row, "self_device_time_total",
                               getattr(row, "self_cuda_time_total", 0.0)))
    return total


def profiled(fn, n: int, path: Path, keep: bool = False):
    """Run fn() n times under torch.profiler; (device events, profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return device_events(prof, path, keep), prof


def top_activities(events: list, n: int, k: int = 12) -> dict:
    """The ``k`` device activities (by name, cut to 70 characters) with the
    most device time, in us per call."""
    total = collections.Counter()
    for name, _, _, dur in events:
        total[name[:70]] += dur / n
    return dict(total.most_common(k))


def glue_by_name(events: list, n: int, rows: int = 40) -> dict:
    """The device activities of ``n`` slots that are no hand kernel,
    grouped by name (cut to 90 characters): their device µs and count per
    slot, and each group's µs per slot, count per slot and share of the
    glue's device time, the most first, past ``rows`` groups summed as
    one."""
    glue = [e for e in events if category(e[0], e[1]) not in HAND_KERNELS]
    total = sum(e[3] for e in glue)
    groups = collections.defaultdict(lambda: [0.0, 0])
    for name, _, _, dur in glue:
        groups[name[:90]][0] += dur
        groups[name[:90]][1] += 1
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][0])
    if len(ranked) > rows:
        rest = ranked[rows:]
        ranked = ranked[:rows] + [(f"({len(rest)} other names)", [
            sum(v[0] for _, v in rest), sum(v[1] for _, v in rest)])]
    return {"us_per_slot": total / n, "activities_per_slot": len(glue) / n,
            "by_name": {name: {"us_per_slot": us / n, "count_per_slot": c / n,
                               "share": us / total if total else 0.0}
                        for name, (us, c) in ranked}}


def slot_profile(calls: list, path: Path) -> dict:
    """Trace one run of each of ``calls`` (one slot each)."""
    n = len(calls)
    it = iter(calls)
    events, prof = profiled(lambda: next(it)(), n, path, keep=True)
    starts = [ts for _, _, ts, _ in events]
    ends = [ts + dur for _, _, ts, dur in events]
    span = max(ends) - min(starts)
    busy = busy_us(events)
    by_cat = collections.defaultdict(list)
    for e in events:
        by_cat[category(e[0], e[1])].append(e)
    breakdown = {k: {"busy_us_per_slot": busy_us(v) / n,
                     "activities_per_slot": len(v) / n}
                 for k, v in sorted(by_cat.items(),
                                    key=lambda kv: -busy_us(kv[1]))}
    return {
        "slots": n,
        "top_activities_us_per_slot": top_activities(events, n),
        "device_activities_per_slot": len(events) / n,
        "device_sum_us_per_slot": sum(e[3] for e in events) / n,
        "device_busy_us_per_slot": busy / n,
        "device_span_us_per_slot": span / n,
        "device_idle_share_of_span": 1.0 - busy / span,
        "key_averages_self_device_us_per_slot": self_device_us(prof) / n,
        "breakdown": breakdown,
        "glue": glue_by_name(events, n),
    }


def kernel_profiles(cases: dict, calls: int, out: Path) -> dict:
    res = {}
    for name, (fn, ref_fn, args) in cases.items():
        row = {}
        for which, f in (("kernel", fn), ("twin", ref_fn)):
            f(*args)
            events, _ = profiled(lambda: f(*args), calls,
                                 out / f"{name}_{which}_trace.json")
            row[f"{which}_device_us_per_call"] = sum(e[3] for e in events) / calls
            row[f"{which}_activities_per_call"] = len(events) / calls
            row[f"{which}_top_activities_us"] = top_activities(events, calls, 6)
        res[name] = row
    return res


def wall_times(calls: list) -> dict:
    n = len(calls)
    ev = []
    for call in calls:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        ev.append(1e3 * start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for call in calls:
        call()
    torch.cuda.synchronize()
    back_to_back = 1e6 * (time.perf_counter() - t0) / n
    synced = []
    for call in calls:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        synced.append(1e6 * (time.perf_counter() - t0))
    return {"cuda_events_median_us": statistics.median(ev),
            "host_back_to_back_us_per_slot": back_to_back,
            "host_synced_median_us": statistics.median(synced)}


def ul_scenario(n: int, seed: int, dev, gen) -> tuple:
    """(one zero-argument call per UL slot, the UL kernels' cases): the
    full mix, PUSCH + PUCCH F1 + PRACH + SRS."""
    slots = flagship.make_slots(n, np.random.default_rng(seed), gen, dev)
    softs = flagship.zero_soft_buffers(dev)
    prach_in = flagship.prach_fd(dev, seed)
    ul = flagship.ul_program()
    calls = [lambda rx=rx, ctx=ctx: ul(rx, prach_in, softs, ctx)
             for _, rx, ctx in slots]
    _, rx, ctx = slots[0]
    return calls, flagship.kernel_cases(rx, ctx, gen, prach_in)


def dl_scenario(n: int, seed: int, dev) -> tuple:
    """(one zero-argument call per DL slot, the DL kernels' cases); the
    first slot carries the SSB."""
    slots = flagship.make_dl_slots(n, np.random.default_rng(seed), dev)
    calls = [lambda s=s: flagship.dl_program(s["with_ssb"])(*s["args"])
             for s in slots]
    return calls, flagship.dl_kernel_cases(slots[0])


def conductor_scenario(n: int, seed: int, dev, gen) -> tuple:
    """(one zero-argument call per conductor slot, the UCI kernels' cases,
    a function that resolves and checks every slot launched and returns
    their count): ``n`` (<= the staging depth) slots of the conductor
    scenario staged in one transfer beforehand; each call launches one slot
    through ``process_slot`` and keeps its pending results."""
    rng = np.random.default_rng(seed)
    phases = flagship.conductor_phases(rng, gen, dev)
    prach_in = flagship.prach_fd(dev, seed)
    pay = flagship.dl_payloads(rng)
    n = min(n, flagship.STAGE_DEPTH)
    dlr = [flagship.dl_request(i) for i in range(n)]
    ulr = [flagship.ul_request(i) for i in range(n)]
    cond = SlotConductor(flagship.CELL)
    staged = cond.stage_payloads([(d, flagship.tx_request(i, pay))
                                  for i, d in enumerate(dlr)])
    pending = []

    def call(i):
        _, pend = cond.process_slot(dlr[i], ulr[i], staged, i,
                                    phases[i]["rx"], prach_fd=prach_in)
        pending.append((pend, phases[i], i))

    cases = flagship.conductor_kernel_cases(phases[0]["rx"], 0, gen)
    for extra in ("pucch_f0_detect_10db", "pucch_f2_demap_1rb",
                  "short_block_detect_k11", "polar_decode_n1024"):
        cases.pop(extra)
    def resolve() -> int:
        for pend, phase, i in pending:
            flagship.check_results(pend.resolve(), phase,
                                   f"conductor slot {i}")
        return len(pending)

    return [lambda i=i: call(i) for i in range(n)], cases, resolve


def ul_mu_scenario(n: int, seed: int, dev, gen) -> tuple:
    """(one zero-argument call per two-UE UL slot, the cases of the kernels
    new on its path (K16 at both UEs, K17, K8 on CDM group 1), a function
    that checks every slot's last result and returns their count)."""
    slots = flagship.make_mu_slots(n, np.random.default_rng(seed), gen, dev)
    softs = flagship.mu_soft_buffers(dev)
    prach_in = flagship.prach_fd(dev, seed)
    outs = {}

    def call(i):
        s = slots[i]
        outs[i] = flagship.mu_program(s["uci"]["ri"])(s["rx"], prach_in,
                                                      softs, s["ctx"])

    cases = flagship.mu_kernel_cases(slots[0], gen)
    for extra in ("pusch_demap_lxn_3l_zf", "pusch_demap_lxn_2l_mmse",
                  "ulsch_demux_punctured"):
        cases.pop(extra)

    def check() -> int:
        for i, out in outs.items():
            flagship.check_mu_slot(out, slots[i], f"two-UE slot {i}")
        return len(outs)

    return [lambda i=i: call(i) for i in range(n)], cases, check


def edge_scenario(n: int, seed: int, dev, gen) -> tuple:
    """(one zero-argument call per cell-edge UL slot, the cases of the
    kernels new on its path (K18 at UE C, K19 at the F3 and the F4, K8 at
    stride 1), a function that checks every slot's last result and returns
    their count)."""
    slots = flagship.make_edge_slots(n, np.random.default_rng(seed), gen, dev)
    softs = flagship.edge_soft_buffers(dev)
    prach_in = flagship.prach_fd(dev, seed)
    prog = flagship.edge_program()
    outs = {}

    def call(i):
        s = slots[i]
        outs[i] = prog(s["rx"], prach_in, softs, s["ctx"])

    cases = flagship.edge_kernel_cases(slots[0], gen)

    def check() -> int:
        for i, out in outs.items():
            flagship.check_edge_slot(out, slots[i], f"cell-edge slot {i}")
        return len(outs)

    return [lambda i=i: call(i) for i in range(n)], cases, check


def _batch_calls(n: int, uls: list, rx_b: torch.Tensor, prach_b: tuple,
                 pay: dict, check) -> tuple:
    """(one zero-argument call per batch, no kernel cases, a function that
    resolves and checks every slot launched and returns their count):
    ``n`` batches of B = 4 slots -- the flagship DL of phases 1-4 beside
    the UL requests ``uls`` -- each staged beforehand; ``check(b, res)``
    holds slot b's SlotResults."""
    grp = flagship.BATCH_PHASES
    slots = [(flagship.dl_request(g), u) for g, u in zip(grp, uls)]
    cond = SlotConductor(flagship.CELL)
    staged = [cond.stage_payloads([(d, flagship.tx_request(g, pay))
                                   for g, (d, _) in zip(grp, slots)])
              for _ in range(n)]
    pending = []

    def call(i):
        _, pend = cond.process_slot_batch(slots, staged[i], rx_b,
                                          prach_fd=prach_b)
        pending.append(pend)

    def resolve() -> int:
        for pend in pending:
            for b, res in enumerate(pend.resolve()):
                check(b, res)
        return len(pending) * len(grp)

    return [lambda i=i: call(i) for i in range(n)], {}, resolve


def batch_scenario(n: int, seed: int, dev, gen) -> tuple:
    """``n`` batches of conductor phases 1-4 (B = 4), with each slot's own
    samples and PRACH capture (:func:`_batch_calls`)."""
    rng = np.random.default_rng(seed)
    phases = flagship.conductor_phases(rng, gen, dev)
    pay = flagship.dl_payloads(rng)
    grp = flagship.BATCH_PHASES

    def check(b, res):
        flagship.check_results(res, phases[grp[b]], f"batch slot {b}",
                               flagship.batch_preambles(b))

    return _batch_calls(n, [flagship.ul_request(g) for g in grp],
                        torch.stack([phases[g]["rx"] for g in grp]),
                        flagship.batch_prach_fd(dev, seed), pay, check)


def _shared_capture(dev, seed: int) -> tuple:
    """The bench's PRACH capture in every slot of a batch."""
    return (torch.stack([flagship.prach_fd(dev, seed)[0]] * flagship.BATCH),)


def batch_mu_scenario(n: int, seed: int, dev, gen) -> tuple:
    """``n`` batches of the two-UE slot (B = 4 at one RI, beside the
    flagship DL; :func:`_batch_calls`)."""
    rng = np.random.default_rng(seed)
    slots = flagship.mu_batch(rng, gen, dev)
    pay = flagship.dl_payloads(rng)

    def check(b, res):
        flagship.check_mu_results(res, slots[b], f"two-UE batch slot {b}")

    return _batch_calls(n, [flagship.mu_ul_request(g, flagship.MU_BATCH_RI)
                                 for g in flagship.BATCH_PHASES],
                        torch.stack([s["rx"] for s in slots]),
                        _shared_capture(dev, seed), pay, check)


def batch_edge_scenario(n: int, seed: int, dev, gen) -> tuple:
    """``n`` batches of the cell-edge slot (B = 4, beside the flagship DL;
    :func:`_batch_calls`)."""
    rng = np.random.default_rng(seed)
    slots = [flagship.edge_slot(g, rng, gen, dev)
             for g in flagship.BATCH_PHASES]
    pay = flagship.dl_payloads(rng)

    def check(b, res):
        flagship.check_edge_results(res, slots[b], f"cell-edge batch slot {b}")

    return _batch_calls(n, [flagship.edge_ul_request(g)
                                 for g in flagship.BATCH_PHASES],
                        torch.stack([s["rx"] for s in slots]),
                        _shared_capture(dev, seed), pay, check)


def gnb_scenario(n: int) -> tuple:
    """(one zero-argument call: a scheduler-mode gnb_sim run of ``n``
    slots; K20-K22's cases; a function that checks every run decoded a UL
    TB and returns the number of runs)."""
    cfg = app_config.load(None, [
        "cell.nof_rb=273", "cell.dft_size=4096", "cell.nof_ports=4",
        f"run.nof_slots={n}", "run.mac=sched", "run.prach_period_slots=10",
        "run.csi_period_slots=10", "run.channel_profile=TDLA",
        f"run.channel_sinr_db={flagship.GNB_SINR_DB}"])
    runs = []

    def call():
        runs.append(gnb_sim.run(cfg, verbose=False))

    def check() -> int:
        bad = [r["crc_ok"] for r in runs if not r["crc_ok"]]
        if bad:
            raise AssertionError(f"{len(bad)} gnb_sim runs decoded no TB")
        return len(runs)

    dev = require_cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    cases = flagship.gnb_kernel_cases(gen, np.random.default_rng(10), dev)
    return [call], cases, check


def du_low_scenario(n: int, seed: int, dev) -> tuple:
    """(one zero-argument call per DU-low DL slot, K25-K27's cases at the
    DU-low shapes)."""
    pay = flagship.dl_payloads(np.random.default_rng(seed))
    cond = SlotConductor(flagship.CELL, device=dev)
    calls = [lambda i=i: cond.process_dl(
        flagship.du_dl_request(i), flagship.du_tx_request(i, pay),
        return_grid=False)[0] for i in range(n)]
    cases = flagship.du_kernel_cases(np.random.default_rng(seed), dev)
    return calls, {k: cases[k] for k in ("rs_map", "dmrs_map", "control_map")}


def du_alloc_scenario(n: int, seed: int, dev) -> tuple:
    """(one zero-argument call per DU-low allocation slot, E and F in turn,
    each DL slot and its UE-side decode; K28's, K26's, K22's and K15's
    cases at those shapes)."""
    pay = flagship.du_alloc_payloads(np.random.default_rng(seed))
    cond = SlotConductor(flagship.CELL, device=dev)
    reqs = [flagship.du_alloc_request("EF"[i % 2], 2 * i + 2, pay)
            for i in range(n)]

    def call(dl, tx):
        samples, _ = cond.process_dl(dl, tx, return_grid=False)
        return flagship.du_control_rx(samples, dl)

    calls = [lambda r=r: call(*r) for r in reqs]
    cases = flagship.alloc_kernel_cases(np.random.default_rng(seed), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k22 = flagship.map_demap_profile_cases(gen, dev)["pdsch_map_prg_type0"]
    return calls, {**{k: cases[k] for k in ("control_llrs", "dmrs_map_type0",
                                            "polar_decode_al16")},
                   "pdsch_map_prg_type0": k22}


SPLIT8_CFO_HZ = 1500.0


def split8_scenario(n: int, seed: int, dev) -> tuple:
    """(one zero-argument call per split-8 UE slot, ssb_tx's SSB slots 0
    and 1 in turn; K29-K32's cases, K30 and K31 on DU-low slot E's 4-port
    samples as ``chip_smoke.py`` times them)."""
    rng = np.random.default_rng(seed)
    cell = flagship.SPLIT8_CELL
    cond = SlotConductor(cell, device=dev)
    slots = []
    for count in range(2):
        slot = SlotPoint(1, count)
        cfg = ssb_tx.ssb_config(slot, cell, 500)
        mib = rng.integers(0, 2, 24).astype(np.int8)
        samples, _ = cond.process_dl(DlTtiRequest(slot=slot, ssb=(cfg,)),
                                     TxDataRequest(slot=slot, ssb_mib=(mib,)),
                                     return_grid=False)
        slots.append((count, cfg, samples))
    cand, code = flagship.ue_candidates(rng, dev)
    cfo_norm = SPLIT8_CFO_HZ / (cell.dft_size * 30_000)
    ceiling = flagship.clip_ceiling_dbfs(slots[0][2])
    pbch = ssb._pbch_code()

    def call(count, cfg, samples):
        amplitude_control.clip(samples, 0.0, ceiling)
        cfo.apply_cfo(samples, cfo_norm)
        grid = ofdm.demodulate_slot(samples, cell.nof_sc, cell.dft_size,
                                    cell.numerology, cell.cp, count,
                                    cell.center_freq_hz).contiguous()
        llrs = dl_control.control_llrs(grid, (ssb.rx_item(
            cfg, tuple(grid.shape), 0),))
        ssb.pbch_decode_llrs(llrs, cfg)
        polar_scl.scl_decode(polar.rate_dematch(llrs.reshape(1, -1), pbch),
                             pbch, flagship.SCL_LIST, "crc24C")
        return polar_scl.scl_decode(cand, code, flagship.SCL_LIST)

    calls = [lambda s=slots[i % 2]: call(*s) for i in range(n)]
    pay = flagship.du_alloc_payloads(rng)
    dl_slot, _ = SlotConductor(flagship.CELL, device=dev).process_dl(
        *flagship.du_alloc_request("E", 2, pay), return_grid=False)
    return calls, flagship.split8_kernel_cases(
        rng, dev, dl_slot, SPLIT8_CFO_HZ / (flagship.CELL.dft_size * 30_000))


def last_scenario(n: int, seed: int, dev, gen) -> tuple:
    """(``n`` calls of ``flagship.last_path`` on one flagship UL slot;
    K33-K36's and the type 0 K8's cases, as ``chip_smoke.py`` times
    them)."""
    rng = np.random.default_rng(seed)
    slot = flagship.make_slots(1, rng, gen, dev)[0]
    inp = flagship.last_inputs(rng, slot, dev)
    out = flagship.last_path(inp)
    cases = flagship.last_kernel_cases(inp, out)
    return [lambda: flagship.last_path(inp)] * n, cases


BATCHES = {"batch": batch_scenario, "batch_mu": batch_mu_scenario,
           "batch_edge": batch_edge_scenario}


def launch_counts(call) -> dict:
    """The hand kernels' launches in one call."""
    torch.cuda.synchronize()
    kernels.reset_counts()
    call()
    torch.cuda.synchronize()
    return {k.name: k.launches for k in kernels.REGISTRY.values()
            if k.launches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--direction",
                    choices=("ul", "dl", "conductor", "ul_mu", "batch",
                             "batch_mu", "batch_edge", "edge", "gnb",
                             "du_low", "du_alloc", "split8", "last"),
                    default="ul")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args(argv)
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    _build.load()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    if args.direction == "ul":
        calls, cases = ul_scenario(args.slots, args.seed, dev, gen)
        prefix = ""
    elif args.direction == "dl":
        calls, cases = dl_scenario(args.slots, args.seed, dev)
        prefix = "dl_"
    elif args.direction == "ul_mu":
        calls, cases, resolve = ul_mu_scenario(args.slots, args.seed, dev,
                                               gen)
        prefix = "ul_mu_"
    elif args.direction == "edge":
        calls, cases, resolve = edge_scenario(args.slots, args.seed, dev, gen)
        prefix = "edge_"
    elif args.direction in BATCHES:
        calls, cases, resolve = BATCHES[args.direction](args.slots,
                                                        args.seed, dev, gen)
        prefix = f"{args.direction}_"
    elif args.direction == "gnb":
        calls, cases, resolve = gnb_scenario(args.slots)
        prefix = "gnb_"
    elif args.direction == "du_low":
        calls, cases = du_low_scenario(args.slots, args.seed, dev)
        prefix = "du_low_"
    elif args.direction == "du_alloc":
        calls, cases = du_alloc_scenario(args.slots, args.seed, dev)
        prefix = "du_alloc_"
    elif args.direction == "split8":
        calls, cases = split8_scenario(args.slots, args.seed, dev)
        prefix = "split8_"
    elif args.direction == "last":
        calls, cases = last_scenario(args.slots, args.seed, dev, gen)
        prefix = "last_"
    else:
        calls, cases, resolve = conductor_scenario(args.slots, args.seed, dev,
                                                   gen)
        prefix = "conductor_"
    # warm-up: device constants; for the conductor and the batch, every
    # slot phase's CUDA graph
    graphed = args.direction == "conductor" or args.direction in BATCHES
    for call in (calls if graphed or args.direction in ("du_low", "du_alloc")
                 else calls[:2]):
        call()
    torch.cuda.synchronize()
    summary = {"card": card_line(), "direction": args.direction,
               "slots_per_call": (flagship.BATCH if args.direction in BATCHES
                                  else args.slots if args.direction == "gnb"
                                  else 1),
               "launches_per_call": launch_counts(calls[0]),
               "wall": wall_times(calls),
               "slot": slot_profile(calls, out / f"{prefix}slot_trace.json"),
               "kernels": kernel_profiles(cases, args.calls, out)}
    if args.direction in ("conductor", "ul_mu", "edge", "gnb", *BATCHES):
        summary["slots_resolved_and_checked"] = resolve()
    (out / f"{prefix}summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
