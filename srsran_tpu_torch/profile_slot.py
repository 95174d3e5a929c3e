"""Where a flagship slot's time goes on one CUDA GPU.

    python3 -m srsran_tpu_torch.profile_slot
        [--direction ul|dl|conductor|ul_mu|batch] [--slots 8] [--calls 10]
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
checked after the measurement; "per slot" below then reads "per batch") of
:mod:`srsran_tpu_torch.flagship` and reports:

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
* for the same trace, the sum of ``self_device_time_total`` over the rows
  of ``key_averages()``: a second reading that counts some device time more
  than once, kept to show how far it lies from the trace;
* each hand kernel of the direction's path: its device time and device
  activities per call against its plain twin's, over ``--calls`` calls
  each (none for ``batch``: ``chip_smoke.py`` times the batched kernels);
* the hand kernels' launch counts over one call (for the conductor and the
  batch, through their CUDA graphs).

The conductor and batch directions run every call once before measuring,
so every slot phase's CUDA graph is captured beforehand.

The slot's trace and a JSON summary go to ``--out`` (``slot_trace.json``
and ``summary.json`` for the UL, ``dl_``, ``conductor_``, ``ul_mu_`` or
``batch_`` before both names for the others);
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
from .device import card_line, require_cuda
from .fapi.conductor import SlotConductor
from .kernels import _build

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HAND_KERNELS = ("ldpc_sweep_kernel", "ldpc_check_kernel", "rate_dematch_kernel",
                "pusch_demap_kernel", "ofdm_window_kernel", "ofdm_bins_kernel",
                "dlsch_crc_kernel", "dlsch_encode_kernel", "pdsch_map_kernel",
                "ofdm_grid_to_bins_kernel", "ofdm_cp_insert_kernel",
                "chest_ls_kernel", "chest_avg_kernel", "chest_interp_kernel",
                "chest_stats_kernel", "chest_ta_kernel", "prach_corr_kernel",
                "prach_power_kernel", "prach_detect_kernel", "pucch_f1_kernel",
                "srs_noise_kernel", "pucch_f0_kernel", "pucch_f2_kernel",
                "short_block_kernel", "polar_sc_kernel",
                "pusch_demap_lxn_kernel", "ulsch_demux_kernel")


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
    cases = flagship.dl_kernel_cases(slots[0])
    cases.pop("pdsch_map_repetition")
    return calls, cases


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


def batch_scenario(n: int, seed: int, dev, gen) -> tuple:
    """(one zero-argument call per batch, no kernel cases, a function that
    resolves and checks every slot launched and returns their count): ``n``
    batches of conductor phases 1-4 (B = 4), each staged beforehand, with
    each slot's own samples and PRACH capture."""
    rng = np.random.default_rng(seed)
    phases = flagship.conductor_phases(rng, gen, dev)
    pay = flagship.dl_payloads(rng)
    grp = flagship.BATCH_PHASES
    slots = [(flagship.dl_request(g), flagship.ul_request(g)) for g in grp]
    cond = SlotConductor(flagship.CELL)
    staged = [cond.stage_payloads([(d, flagship.tx_request(g, pay))
                                   for g, (d, _) in zip(grp, slots)])
              for _ in range(n)]
    rx_b = torch.stack([phases[g]["rx"] for g in grp])
    prach_b = flagship.batch_prach_fd(dev, seed)
    pending = []

    def call(i):
        _, pend = cond.process_slot_batch(slots, staged[i], rx_b,
                                          prach_fd=prach_b)
        pending.append(pend)

    def resolve() -> int:
        for pend in pending:
            for b, (g, res) in enumerate(zip(grp, pend.resolve())):
                flagship.check_results(res, phases[g], f"batch slot {b}",
                                       flagship.batch_preambles(b))
        return len(pending) * len(grp)

    return [lambda i=i: call(i) for i in range(n)], {}, resolve


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
                    choices=("ul", "dl", "conductor", "ul_mu", "batch"),
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
    elif args.direction == "batch":
        calls, cases, resolve = batch_scenario(args.slots, args.seed, dev, gen)
        prefix = "batch_"
    else:
        calls, cases, resolve = conductor_scenario(args.slots, args.seed, dev,
                                                   gen)
        prefix = "conductor_"
    # warm-up: device constants; for the conductor and the batch, every
    # slot phase's CUDA graph
    graphed = args.direction in ("conductor", "batch")
    for call in calls if graphed else calls[:2]:
        call()
    torch.cuda.synchronize()
    summary = {"card": card_line(), "direction": args.direction,
               "slots_per_call": (flagship.BATCH if args.direction == "batch"
                                  else 1),
               "launches_per_call": launch_counts(calls[0]),
               "wall": wall_times(calls),
               "slot": slot_profile(calls, out / f"{prefix}slot_trace.json"),
               "kernels": kernel_profiles(cases, args.calls, out)}
    if args.direction in ("conductor", "ul_mu", "batch"):
        summary["slots_resolved_and_checked"] = resolve()
    (out / f"{prefix}summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
