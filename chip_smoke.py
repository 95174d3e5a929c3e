#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (sm_90a) and nvcc; imports nothing of JAX.
It builds the hand kernels from ``srsran_tpu_torch/csrc`` (into
``build/kernels/``), then, on the flagship cell (100 MHz, 4 ports, 273 RB,
30 kHz SCS; the scenarios of ``srsran_tpu_torch/flagship.py``):

1. holds each kernel against its plain PyTorch twin on the same seeded
   input at the flagship shapes, and times both with CUDA events: the UL
   kernels K1 LDPC decoder, K2 rate dematch, K3 fused equalize/demap/
   descramble, K4 OFDM demodulation passes; the DL kernels K5 DL-SCH
   encode, K6 PDSCH map (also on a small allocation with repetition at rv
   2), K7 OFDM modulation passes;
2. drives the flagship PUSCH-only UL slot (2-layer QAM64 on 269 RB, TBS
   311400) through ``ul_slot_fn``, fed by the port's own UE-side
   transmitter (``dl_slot_fn``, which runs K5-K7) through a seeded flat 4x2
   channel with 30 dB AWGN: every slot must pass its TB CRC with the exact
   payload, every UL kernel's launch count must rise, one steady-state call
   runs under ``torch.cuda.set_sync_debug_mode("error")``, and slot 0 is
   also decoded by the plain twins on the CPU and compared;
3. drives the flagship DL slot (SSB every 40th slot, AL8 PDCCH, 4-layer
   256QAM PDSCH on 273 RB, TBS 835584) through ``dl_slot_fn_samples``: 8
   slots, the first with the SSB; every DL kernel's launch count must rise,
   one steady-state call runs under ``set_sync_debug_mode("error")``, an
   SSB slot and a plain slot match the same call on the plain twins on the
   CPU, and a plain slot is received back (K4, plain 256QAM demap, K2, K1)
   with its TB CRC passing and the exact payload.

It prints the card's name and power limit, one JSON line of per-kernel
results, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises, so the script then exits non-zero without that line.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from srsran_tpu_torch import flagship, kernels
from srsran_tpu_torch.device import card_line, require_cuda
from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops.crc import crc_check

SEED = 0
NOF_SLOTS = 8
TIMING_RUNS = 20
UL_KERNELS = ("ldpc_decode", "rate_dematch", "pusch_demap", "ofdm_demodulate")
DL_KERNELS = ("dlsch_encode", "pdsch_map", "ofdm_modulate")


def median_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median device time of fn() over ``runs`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def close(kernel: torch.Tensor, ref: torch.Tensor, name: str,
          rtol: float = 1e-4) -> float:
    """assert_close at rtol, atol = rtol * max|ref|; returns max |error|."""
    atol = rtol * float(ref.abs().max())
    torch.testing.assert_close(kernel, ref, rtol=rtol, atol=atol, msg=name)
    return float((kernel - ref).abs().max())


def compare(name: str, out, ref) -> float:
    """Hold one kernel's result against its twin's; returns max |error|
    (for K1, the number of hard bits that differ)."""
    if name in ("dlsch_encode", "pdsch_map", "pdsch_map_repetition"):
        # K5 and K6 are bit-exact (K6: the grid within 1e-6 of max|ref|,
        # for the precoder's sum order).
        if name == "dlsch_encode" and not torch.equal(out, ref):
            raise AssertionError(
                f"K5 differs from its twin in {int((out != ref).sum())} bits")
        err = float((out - ref).abs().max())
        if err > 1e-6 * float(ref.abs().max()):
            raise AssertionError(f"{name} differs from its twin by {err}")
        return err
    if name == "ofdm_modulate":                    # K7
        return close(out, ref, "K7 samples")
    if name == "ofdm_demodulate":                  # K4
        return close(out, ref, "K4 grid")
    if name == "pusch_demap":                      # K3: (llr, x)
        return max(close(out[1], ref[1], "K3 x"),
                   close(out[0], ref[0], "K3 llr"))
    if name == "rate_dematch":                     # K2: no repetition here
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError("K2 differs from its twin")
        return float((out[1] - ref[1]).abs().max())
    bits, _, iters = out                           # K1
    bits_ref, _, iters_ref = ref
    k = flagship.SEG.cb_info_bits
    ok = crc_check(bits[:, :k], "crc24B")
    ok_ref = crc_check(bits_ref[:, :k], "crc24B")
    if not (torch.equal(bits, bits_ref) and torch.equal(ok, ok_ref)
            and int(iters) == int(iters_ref)):
        raise AssertionError(
            f"K1 differs from its twin: bits {int((bits != bits_ref).sum())} "
            f"iters {int(iters)} vs {int(iters_ref)}")
    if int(iters) < 2:
        raise AssertionError("K1 phase did not exercise more than one sweep")
    print(f"K1 noisy input: {int(iters)} sweeps, "
          f"{int(ok.sum())}/{flagship.SEG.nof_codeblocks} CB CRCs pass",
          flush=True)
    return float((bits != bits_ref).sum())


def kernel_phases(cases: dict) -> dict:
    """Each kernel against its twin; all but the repetition case timed."""
    results = {}
    for name, (fn, ref_fn, args) in cases.items():
        err = compare(name, fn(*args), ref_fn(*args))
        if name == "pdsch_map_repetition":
            print(f"K6 repetition, rv 2: max_abs_err {err:.3g}", flush=True)
            continue
        results[name] = dict(max_abs_err=err,
                             ms=median_ms(lambda: fn(*args)),
                             plain_ms=median_ms(lambda: ref_fn(*args)))
    return results


def launched(names) -> dict:
    """Each named kernel's launch count; raises when one is 0."""
    counts = {k.name: k.launches for k in kernels.REGISTRY.values()}
    missing = [n for n in names if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return {n: counts[n] for n in names}


def timed(fn) -> tuple:
    """(fn(), its time in ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_slot(out: dict, payload: torch.Tensor, slot: int) -> None:
    r = out["pusch"][0]
    if not bool(r["tb_crc_ok"]):
        raise AssertionError(f"slot {slot}: TB CRC failed")
    if not torch.equal(r["tb_bits"], payload):
        raise AssertionError(f"slot {slot}: decoded TB differs from payload")
    for k in ("snr", "rsrp", "epre", "evm", "cfo_hz", "ta_s"):
        if not bool(torch.isfinite(r[k]).all()):
            raise AssertionError(f"slot {slot}: {k} not finite")


def ul_phases(dev, gen, rng, card) -> tuple:
    """The UL kernels against their twins, then the flagship UL slot."""
    ul = flagship.ul_program()
    # Inputs of every slot, built and uploaded before anything is timed.
    t0 = time.perf_counter()
    slots = flagship.make_slots(NOF_SLOTS + 2, rng, gen, dev)
    softs = flagship.zero_soft_buffers(dev)
    torch.cuda.synchronize()
    print(f"transmitter: {len(slots)} slots in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    results = kernel_phases(flagship.kernel_cases(slots[0][1], slots[0][2],
                                                  gen))

    # The main path.  Warm up (builds the device constants), then count
    # launches over NOF_SLOTS slots.
    for payload, rx, ctx in slots[:2]:
        check_slot(ul(rx, None, softs, ctx), payload, -1)
    torch.cuda.synchronize()
    kernels.reset_counts()
    slot_ms = []
    outs = []
    for payload, rx, ctx in slots[2:]:
        out, ms = timed(lambda: ul(rx, None, softs, ctx))
        slot_ms.append(ms)
        outs.append(out)
    launches = launched(UL_KERNELS)
    for i, ((payload, _, _), out) in enumerate(zip(slots[2:], outs)):
        check_slot(out, payload, i)
    iters = [int(o["pusch"][0]["nof_iterations"]) for o in outs]
    med_us = 1e3 * statistics.median(slot_ms)
    print(f"UL slot: {len(outs)} slots ok, median {med_us:.1f} us per slot "
          f"(CUDA events), LDPC sweeps {iters}, card {card}", flush=True)

    # One steady-state call with every synchronizing operation an error.
    payload, rx, ctx = slots[2]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ul(rx, None, softs, ctx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check_slot(out, payload, 0)
    print("UL sync-free steady-state call: ok", flush=True)

    # The same slot through the plain twins on the CPU.
    cpu = ul(rx.cpu(), None, tuple(s.cpu() for s in softs),
             {"pusch": tuple(p.cpu() for p in ctx["pusch"])})
    r, rc = out["pusch"][0], cpu["pusch"][0]
    for k in ("tb_bits", "tb_crc_ok", "nof_iterations", "ta_s"):
        if not torch.equal(r[k].cpu(), rc[k]):
            raise AssertionError(f"slot vs CPU twin: {k} differs")
    for k in ("snr", "rsrp", "epre", "evm", "new_soft"):
        close(r[k].cpu(), rc[k], f"slot vs CPU twin: {k}", rtol=1e-3)
    print("UL slot vs plain twins on the CPU: ok", flush=True)
    return results, launches


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, tuple):
        return tuple(_to_cpu(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def check_samples(samples: torch.Tensor, i: int) -> None:
    cell = flagship.DL_CELL
    if samples.shape != (cell.nof_ports, cell.slot_samples(0)):
        raise AssertionError(f"DL slot {i}: samples {tuple(samples.shape)}")
    if not bool(torch.isfinite(torch.view_as_real(samples)).all()):
        raise AssertionError(f"DL slot {i}: samples not finite")


def dl_phases(dev, rng, card) -> tuple:
    """The DL kernels against their twins, then the flagship DL slot."""
    t0 = time.perf_counter()
    warm = flagship.make_dl_slots(2, rng, dev)
    slots = flagship.make_dl_slots(NOF_SLOTS, rng, dev)
    torch.cuda.synchronize()
    print(f"DL inputs: {len(warm) + len(slots)} slots in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    results = kernel_phases(flagship.dl_kernel_cases(slots[0]))

    # The main path: both programs warm, then NOF_SLOTS slots counted.
    for s in warm:
        check_samples(flagship.dl_program(s["with_ssb"])(*s["args"]), -1)
    torch.cuda.synchronize()
    kernels.reset_counts()
    slot_ms = []
    outs = []
    for s in slots:
        out, ms = timed(lambda: flagship.dl_program(s["with_ssb"])(*s["args"]))
        slot_ms.append(ms)
        outs.append(out)
    launches = launched(DL_KERNELS)
    for i, out in enumerate(outs):
        check_samples(out, i)
    med_us = 1e3 * statistics.median(slot_ms)
    print(f"DL slot: {len(outs)} slots ({sum(s['with_ssb'] for s in slots)} "
          f"with SSB), median {med_us:.1f} us per slot (CUDA events), "
          f"card {card}", flush=True)

    # One steady-state call with every synchronizing operation an error.
    plain = slots[1]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = flagship.dl_program(False)(*plain["args"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check_samples(out, 1)
    print("DL sync-free steady-state call: ok", flush=True)

    # An SSB slot and a plain slot against the plain twins on the CPU.
    for s in (slots[0], plain):
        prog = flagship.dl_grid_program(s["with_ssb"])
        samples, grid = prog(*s["args"])
        samples_ref, grid_ref = prog(*_to_cpu(s["args"]))
        close(samples.cpu(), samples_ref, "DL slot vs CPU twin: samples")
        close(grid.cpu(), grid_ref, "DL slot vs CPU twin: grid", rtol=1e-5)
    print("DL slots (SSB and plain) vs plain twins on the CPU: ok", flush=True)

    # Receive a plain slot back through K4, K2 and K1.
    res = flagship.dl_loopback(outs[1])
    if not bool(res.tb_crc_ok):
        raise AssertionError("DL loopback: TB CRC failed")
    if not torch.equal(res.tb_bits, plain["tb"]):
        raise AssertionError("DL loopback: decoded TB differs from payload")
    print(f"DL loopback: TB CRC ok, {plain['tb'].numel()} bits exact, "
          f"LDPC sweeps {int(res.nof_iterations)}", flush=True)
    return results, launches


def main() -> int:
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    ul_results, ul_launches = ul_phases(dev, gen, rng, card)
    dl_results, dl_launches = dl_phases(dev, rng, card)
    results = {**ul_results, **dl_results}
    launches = {**ul_launches, **dl_launches}
    for name, r in results.items():
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"max_abs_err {r['max_abs_err']:.3g}", flush=True)

    line = {"kernels": [dict(name=k.name, route=k.route, source=k.source,
                             replaces=k.replaces, launches=launches[k.name],
                             **results[k.name])
                        for k in kernels.REGISTRY.values()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
