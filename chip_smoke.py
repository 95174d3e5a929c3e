#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (sm_90a) and nvcc; imports nothing of JAX or of
the JAX package.  It builds the hand kernels from ``srsran_tpu_torch/csrc``
(into ``build/kernels/``), then, on the flagship cell (100 MHz, 4 ports,
273 RB, 30 kHz SCS; the scenarios of ``srsran_tpu_torch/flagship.py``):

1. holds each kernel against its plain PyTorch twin on the same seeded
   input at the flagship shapes, and times both with CUDA events: the UL
   kernels K1 LDPC decoder, K2 rate dematch, K3 fused equalize/demap/
   descramble, K4 OFDM demodulation passes, K8 channel estimator, K9 PRACH
   detector, K10 PUCCH F1 detector, K11 SRS noise; the DL kernels K5 DL-SCH
   encode, K6 PDSCH map (also on a small allocation with repetition at rv
   2), K7 OFDM modulation passes.  Beside each it computes the kernel's
   bound: the larger of its bytes (inputs read once, outputs written once)
   over 3.35 TB/s and its operations over 67 TFLOP/s (H100 SXM, float32
   outside the tensor cores);
2. drives the flagship UL slot with the bench's full mix (2-layer QAM64
   PUSCH on 269 RB, TBS 311400; one PUCCH F1; one 64-preamble B4 PRACH
   occasion; one SRS) through ``ul_slot_fn`` for 8 slots, fed by the port's
   own UE-side transmitter (``dl_slot_fn``, which runs K5-K7, plus the SRS)
   through a seeded flat 4x2 channel with 30 dB AWGN and by the bench's
   PRACH capture: every slot must pass its TB CRC with the exact payload
   and detect PRACH preamble 21, every UL kernel's launch count must rise,
   one steady-state call runs under ``torch.cuda.set_sync_debug_mode
   ("error")``, slot 0's whole result dict matches the same call on the
   plain twins on the CPU, and a PUCCH F1 loopback on an otherwise empty
   grid detects the bits sent;
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

import dataclasses
import json
import math
import statistics
import sys
import time

import numpy as np
import torch

from srsran_tpu_torch import flagship, kernels
from srsran_tpu_torch.device import card_line, require_cuda
from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops.crc import crc_check
from srsran_tpu_torch.ops.ldpc_graph import get_graph
from srsran_tpu_torch.phy.upper import prach, pucch

SEED = 0
NOF_SLOTS = 8
TIMING_RUNS = 20
UL_KERNELS = ("ldpc_decode", "rate_dematch", "pusch_demap", "ofdm_demodulate",
              "channel_estimate", "prach_detect", "pucch_f1_detect",
              "srs_estimate")
DL_KERNELS = ("dlsch_encode", "pdsch_map", "ofdm_modulate")
# H100 SXM peaks (NVIDIA's data sheet): device memory, float32 outside the
# tensor cores.  A card set below 700 W runs below them.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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
    if name == "channel_estimate":                 # K8
        if not torch.equal(out.time_alignment_s.cpu(),
                           ref.time_alignment_s.cpu()):
            raise AssertionError("K8 TA differs from its twin's")
        if abs(float(out.cfo_hz) - float(ref.cfo_hz)) > 1e-2:
            raise AssertionError(f"K8 CFO {float(out.cfo_hz)} vs "
                                 f"{float(ref.cfo_hz)} Hz")
        for key in ("noise_var", "rsrp", "epre", "snr"):
            close(getattr(out, key), getattr(ref, key), f"K8 {key}")
        return close(out.coeffs, ref.coeffs, "K8 coeffs")
    if name == "prach_detect":                     # K9
        for key in ("detected", "time_advance_s"):
            if not torch.equal(getattr(out, key), getattr(ref, key)):
                raise AssertionError(f"K9 {key} differs from its twin's")
        close(out.rssi, ref.rssi, "K9 rssi")
        return close(out.metrics, ref.metrics, "K9 metrics")
    if name == "pucch_f1_detect":                  # K10
        if not (torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])):
            raise AssertionError("K10 decisions differ from its twin's")
        close(out[3], ref[3], "K10 symbol")
        return close(out[1], ref[1], "K10 metric")
    if name == "srs_estimate":                     # K11
        close(out[1], ref[1], "K11 snr")
        return close(out[0], ref[0], "K11 noise_var")
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


def nbytes(obj) -> int:
    """Bytes of every tensor in obj (tensors, tuples, lists, dataclasses)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(nbytes(o) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def fft_ops(n: int, count: int) -> float:
    """5 N log2 N operations per complex FFT of size N."""
    return 5.0 * n * math.log2(n) * count


def _edges(bg: int, z: int, rows: int) -> int:
    return sum(len(r) for r in get_graph(bg, z).rows[:rows]) * z


def work(name: str, args: tuple, out) -> tuple:
    """(bytes, operations) the function needs on these inputs: each input
    read once (for the estimators, the REs they read out of the grid),
    each output written once; operations counted per element as noted."""
    c64 = 8
    if name == "ofdm_demodulate":                  # K4: FFT + 6 per bin
        samples, nsc, n = args[0], args[1], args[2]
        p, s = samples.shape[0], 14
        return (nbytes(samples) + nbytes(out),
                fft_ops(n, p * s) + 6.0 * p * s * nsc)
    if name == "pusch_demap":                      # K3: ~230 per RE
        grid, coeffs, sym, sc = args[:4]
        n_re = sym.numel()
        return (n_re * grid.shape[0] * c64 + nbytes((coeffs, sym, sc))
                + nbytes(out), 230.0 * n_re)
    if name == "rate_dematch":                     # K2: an add per soft bit
        return nbytes((args[0], args[-1])) + nbytes(out), float(
            args[-1].numel())
    if name == "ldpc_decode":                      # K1: 8 per edge per sweep
        llr, bg, z, rows = args[0], args[1], args[2], args[3]
        sweeps = int(out[2])
        return (nbytes(llr) + nbytes(out),
                8.0 * _edges(bg, z, rows) * llr.shape[0] * sweeps)
    if name == "dlsch_encode":                     # K5: an XOR per edge + CRC
        tb, bg = args
        c = out.shape[0]
        z = out.shape[1] // (66 if bg == 1 else 50)
        return (nbytes(tb) + nbytes(out),
                float(_edges(bg, z, 46 if bg == 1 else 42) * c
                      + 2 * tb.numel()))
    if name in ("pdsch_map", "pdsch_map_repetition"):  # K6: ~40 per RE/port
        grid = args[0]
        return nbytes(args) + nbytes(out), 40.0 * grid.numel()
    if name == "ofdm_modulate":                    # K7: IFFT + 6 per sample
        grid, n = args[0], args[1]
        p, s = grid.shape[0], grid.shape[1]
        return (nbytes(grid) + nbytes(out),
                fft_ops(n, p * s) + 6.0 * out.numel())
    if name == "channel_estimate":                 # K8
        grid, symbols, _, expected, pilot_scs, nsc = args[:6]
        p, (n_l, n_s, n_k) = grid.shape[0], expected.shape
        nfft = 1 << math.ceil(math.log2(2 * nsc))
        band_w = 8
        pilots = p * n_s * n_k * c64
        return (pilots + nbytes(expected) + nsc * (4 * band_w + 4)
                + nbytes(out.coeffs) + 4 * (4 * p + 2),
                8.0 * p * n_l * n_s * n_k + 4.0 * band_w * out.coeffs.numel()
                + p * n_s * n_k * (8.0 * n_l + 10)
                + fft_ops(nfft, p * n_l) + 3.0 * p * n_l * nfft)
    if name == "prach_detect":                     # K9
        rx, cfg = args
        n_r = len(prach._root_set(cfg)[0])
        ps = rx.shape[0] * rx.shape[1]
        win, margin, _ = prach._window(cfg, 1024)
        return (nbytes(rx) + n_r * cfg.l_ra * c64 + nbytes(out),
                6.0 * ps * n_r * cfg.l_ra + fft_ops(1024, ps * n_r)
                + 4.0 * ps * n_r * 1024
                + 3.0 * cfg.nof_preambles * (win + 2 * margin))
    if name == "pucch_f1_detect":                  # K10
        grid, common, weights = args[:3]
        u = weights[0][0].shape[0]
        res = grid.shape[0] * common.nof_symbols * 12
        return (res * c64 + nbytes(weights) + nbytes(out),
                u * res * (8.0 + 14.0))
    if name == "srs_estimate":                     # K11
        grid, cfg = args[:2]
        p, k = grid.shape[0], cfg.seq_len
        n_l, n_s = cfg.nof_ports, cfg.nof_symbols
        return (p * n_s * k * c64 + n_l * n_s * k * c64 + 4 * (p + 1)
                + nbytes(out),
                p * n_l * k * (8.0 * n_s + 14) + p * k * (14.0 * n_l + 4 * n_s
                                                          + 6))
    raise KeyError(name)


def bound(name: str, args: tuple, out) -> dict:
    """The least time the card could take for the kernel's work."""
    b, ops = work(name, args, out)
    t_bytes, t_ops = b / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_phases(cases: dict) -> dict:
    """Each kernel against its twin; all but the repetition case timed.
    No single PyTorch call computes any of these functions, so
    ``library_ms`` is null for every kernel."""
    results = {}
    for name, (fn, ref_fn, args) in cases.items():
        out = fn(*args)
        err = compare(name, out, ref_fn(*args))
        if name == "pdsch_map_repetition":
            print(f"K6 repetition, rv 2: max_abs_err {err:.3g}", flush=True)
            continue
        results[name] = dict(max_abs_err=err,
                             ms=median_ms(lambda: fn(*args)),
                             plain_ms=median_ms(lambda: ref_fn(*args)),
                             **bound(name, args, out), library_ms=None)
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
    if not bool(out["prach"][0]["detected"][flagship.PRACH_PREAMBLE]):
        raise AssertionError(f"slot {slot}: PRACH preamble "
                             f"{flagship.PRACH_PREAMBLE} not detected")
    for kind, keys in (("srs", ("wideband_h", "snr", "ta_s")),
                       ("pucch_f1", ("metric", "symbol")),
                       ("prach", ("metrics", "rssi", "ta_s"))):
        for k in keys:
            v = out[kind][0][k]
            v = torch.view_as_real(v) if v.is_complex() else v
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"slot {slot}: {kind} {k} not finite")


# UL result keys held equal to the CPU twins'; the others within a tolerance.
UL_EXACT = {"tb_bits", "tb_crc_ok", "nof_iterations", "ta_s", "detected",
            "harq_bits"}


def compare_ul(out: dict, ref: dict) -> None:
    """The whole UL result dict against the CPU twins': decisions equal,
    CFO within 0.01 Hz, the LLR-derived EVM and soft buffer within 1e-3
    (K3's LLRs, as since PR 1), every other value within 1e-4."""
    for kind, entries in ref.items():
        if len(out[kind]) != len(entries):
            raise AssertionError(f"UL {kind}: {len(out[kind])} entries")
        for g, r in zip(out[kind], entries):
            for key in r:
                a, b = g[key].cpu(), r[key]
                what = f"UL slot vs CPU twin: {kind} {key}"
                if key in UL_EXACT:
                    if not torch.equal(a, b):
                        raise AssertionError(f"{what} differs")
                elif key == "cfo_hz":
                    if abs(float(a) - float(b)) > 1e-2:
                        raise AssertionError(f"{what}: {a} vs {b}")
                else:
                    close(a, b, what,
                          rtol=1e-3 if key in ("evm", "new_soft") else 1e-4)


def f1_loopback(dev) -> None:
    """PUCCH F1 of the flagship (PRB 0, 14 symbols) on an otherwise empty
    grid at slot 4, both bit values, through K10 with the context's
    weights."""
    cell = flagship.CELL
    cfg = dataclasses.replace(flagship.PUCCH, slot=4)
    ctx = flagship.ul_slot_context(2, dev)["f1"][0]
    for bit in (0, 1):
        grid = torch.zeros((cell.nof_ports, 14, cell.nof_sc),
                           dtype=torch.complex64, device=dev)
        grid = pucch.transmit_format1(grid, cfg, [bit])
        (res,) = pucch.detect_format1_batch(grid, flagship.PUCCH,
                                            flagship.F1_USERS, ncs=ctx)
        if not bool(res["detected"]) or int(res["harq_bits"][0]) != bit:
            raise AssertionError(f"F1 loopback: bit {bit} not detected "
                                 f"(metric {float(res['metric']):.3g})")
    print("UL PUCCH F1 loopback on an empty grid: both bits detected",
          flush=True)


def ul_phases(dev, gen, rng, card) -> tuple:
    """The UL kernels against their twins, then the flagship UL slot."""
    ul = flagship.ul_program()
    # Inputs of every slot, built and uploaded before anything is timed.
    t0 = time.perf_counter()
    slots = flagship.make_slots(NOF_SLOTS + 2, rng, gen, dev)
    softs = flagship.zero_soft_buffers(dev)
    prach_in = flagship.prach_fd(dev, SEED)
    torch.cuda.synchronize()
    print(f"transmitter: {len(slots)} slots in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    results = kernel_phases(flagship.kernel_cases(slots[0][1], slots[0][2],
                                                  gen, prach_in))

    # The main path.  Warm up (builds the device constants), then count
    # launches over NOF_SLOTS slots.
    for payload, rx, ctx in slots[:2]:
        check_slot(ul(rx, prach_in, softs, ctx), payload, -1)
    torch.cuda.synchronize()
    kernels.reset_counts()
    slot_ms = []
    outs = []
    for payload, rx, ctx in slots[2:]:
        out, ms = timed(lambda: ul(rx, prach_in, softs, ctx))
        slot_ms.append(ms)
        outs.append(out)
    launches = launched(UL_KERNELS)
    for i, ((payload, _, _), out) in enumerate(zip(slots[2:], outs)):
        check_slot(out, payload, i)
    iters = [int(o["pusch"][0]["nof_iterations"]) for o in outs]
    det = outs[0]["prach"][0]
    found = torch.nonzero(det["detected"]).flatten().tolist()
    pre = flagship.PRACH_PREAMBLE
    med_us = 1e3 * statistics.median(slot_ms)
    print(f"UL slot (PUSCH + PUCCH F1 + PRACH B4 + SRS): {len(outs)} slots "
          f"ok, median {med_us:.1f} us per slot (CUDA events), LDPC sweeps "
          f"{iters}, PRACH detected {found} (preamble {pre}: metric "
          f"{float(det['metrics'][pre]):.2f}, TA "
          f"{1e6 * float(det['ta_s'][pre]):.3f} us), card {card}", flush=True)

    # One steady-state call with every synchronizing operation an error.
    payload, rx, ctx = slots[2]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ul(rx, prach_in, softs, ctx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check_slot(out, payload, 0)
    print("UL sync-free steady-state call: ok", flush=True)

    # The same slot through the plain twins on the CPU.
    cpu = ul(rx.cpu(), _to_cpu(prach_in), _to_cpu(softs), _to_cpu(ctx))
    compare_ul(out, cpu)
    print("UL slot (full result dict) vs plain twins on the CPU: ok",
          flush=True)
    f1_loopback(dev)
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
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
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
