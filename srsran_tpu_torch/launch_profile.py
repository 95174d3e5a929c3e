"""The host side of a kernel launch on one CUDA GPU: K1's, K3's, K4's,
K5's, K6's, K7's, K8's, K10's, K11's, K12's, K13's, K14's, K15's, K20's,
K23's-K26's, K32's, K21's, K18's, K19's, K22's, K27's, K33's, K34's and
K35's wrappers against one PyTorch call each (K1, K3, K6, K8, K10, K13,
K15, K22, K23, K24: none computes it; their device µs alone).

    python3 -m srsran_tpu_torch.launch_profile [--calls 1000] [--out DIR]
        [--cases PREFIX ...]

Cases: K32 (``ldpc_rate_match.rate_match_batch``) on the flagship PUSCH's
37 codeblocks at rv 0, beside ``torch.take`` of its index plan; K21
(``prach_demod.demodulate``) on the gNB simulator's B4 window (N_u 4096),
at N_u 6144 and on format 0, beside ``torch.matmul`` of the bin matrix by
the windows; K18 (``ul_demap.tp_equalize_demap_descramble``) at the cell
edge's UE C (M = 72, both hops), at M = 300, 2916 and 3240, and K19
(``pucch.f3_demap``) at the cell edge's F3 and F4, each beside
``torch.fft.ifft`` of its IDFT stage (as many blocks of M points; a stage
of the function, not the whole), on seeded random inputs of those shapes
(``flagship.edge_profile_cases``); K27 (``dl_control.control_map`` on
its PDUs, built once) on the flagship DL slot's SSB and AL8 PDCCH, the AL8
PDCCH alone, the SSB alone, AL1, AL16 and the many-UE slot (the SSB and
17 DCIs, two launches), each beside ``torch.matmul`` of its GF(2) stage
(one product per PDU: :func:`gf2_stage`), with ``control_map_items`` the
host µs of building the slot's PDUs (``control_item`` of each); K35
(``llr.quantize`` / ``dequantize``) on the flagship PUSCH's 426,096 LLRs
(seeded), the dequantize beside ``torch.div`` by a 0-dim f32 device
tensor and the quantize beside its plain chain (``quantize_ref``: no one
PyTorch call computes it); K33 (``polar.encode_chain``) on phase 4's
22-bit F2 (``polar_encode``), the PBCH, an AL16 DCI and 64 F3 UCI
codewords (``_pbch``, ``_dci_al16``, ``_uci64``) and K34
(``short_block.encode``) on the 6-bit F2 and 64 11-bit messages
(``short_block_encode``, ``_k11``), from ``flagship.ue_encoder_cases``,
and one codeword through ``uci.encode_uci`` at K = 16 (K33, with CRC6
and PC bits) and K = 6 (K34), E = 120, Qm 2, as the UE emulation calls it
(``encode_uci_k16``, ``_k6``), each beside ``torch.matmul`` of its
message by the GF(2) matrix of the whole encoder, mod 2
(:func:`gf2_library`); K1 (``ldpc_decode.decode_early_stop``) on the
flagship's noisy 46-layer input (``ldpc_decode``), its clean slot at the
10 layers ``sch_decoder`` decodes (``_clean``), a batch of 4 with a slot
axis (``_batch4``), a HARQ retransmission (``_harq``) and a BG2 TB
(``_bg2``), with each case's sweeps in the summary; K5
(``ldpc_encode.dlsch_encode``) on the flagship TB (``dlsch_encode``), a
batch of 4 (``_batch4``) and a BG2 TB at Z = 208 (``_bg2``), each beside
one ``torch.mm`` of its encode stage's message bits by the code's GF(2)
generator, mod 2 (:func:`dlsch_library`); ``--cases ldpc dlsch`` ~1 min;
K8 (``channel_estimate.estimate_from_grid``) on the flagship PUSCH
(``channel_estimate``), the flagship SRS (``_srs``), the F2's comb 3
(``_f2``), the cell edge's F3 (``_f3``), slot E's type 0 comb averaged and
interpolated (``_type0``, ``_type0_interp``), the PUSCH over 4 slots
(``_batch4``) and the flagship PUSCH and SRS through their callers, whose
arguments are made anew each call (``_caller``, ``_srs_caller``: the host
µs the receive chains pay), and K15 (``polar.decode``) on the F2's codeword
(``polar_decode``), the PBCH (``_pbch``), an AL16 DCI at B = 4 with its
syndrome (``_al16``), N = 1024 (``_n1024``) and the F2's codeword over 4
slots (``_batch4``), from ``flagship.chest_polar_profile_cases``
(:func:`chest_polar_calls`); ``--cases channel_estimate polar_decode``;
K4 (``ofdm.demodulate_slot``) on the flagship UL slot (``ofdm_demodulate``),
a batch of 4 (``_batch4``), the DU-low's small cell at N = 1024
(``_n1024``), the largest window offset (``_offset_max``), extended CP
(``_extended``) and N = 1536 (``_n1536``), and K7 (``ofdm.modulate_slot``)
on the same but the offset, from ``flagship.ofdm_profile_cases``
(:func:`ofdm_calls`), each beside ``torch.fft.fft`` / ``ifft`` of its FFT
stage on the [(B,) P, S, N] buffer the former kernels built around cuFFT
(:func:`ofdm_fft_library`); ``--cases ofdm``, ~1 min; K6
(``dl_map.pdsch_map``) on the flagship PDSCH (``pdsch_map``), a batch of
4 (``_batch4``), slot F's interleaved plan (``_interleaved``), n_ref
(``_nref``) and the repetition shape (``_repetition``), K22 on slot E's
type 0 plan (``pdsch_map_prg_type0``), and K3
(``ul_demap.equalize_demap_descramble``) on the flagship PUSCH
(``pusch_demap``), a batch of 4 (``_batch4``), 1 layer (``_1l``) and both
hops of the pi/2-BPSK PUSCH (``_hop1``, ``_hop2``), from
``flagship.map_demap_profile_cases`` (:func:`map_demap_calls`), device µs
alone (no single PyTorch call computes either function); ``--cases
pdsch_map pusch_demap`` (which also keeps K16's ``pusch_demap_lxn``
cases), ~2 min; K10 (``pucch.f1_detect``) on the flagship occasion
(``pucch_f1_detect``), 3 and 12 users with a hop (``_3u_hop``,
``_12u_hop``) and a batch of 4 (``_batch4``), and K13
(``pucch.f2_demap``) on the conductor's F2s (``pucch_f2_demap``,
``_1rb``), 16 RB (``_16rb``) and a batch of 4 (``_batch4``), from
``flagship.kernel_cases``, ``conductor_kernel_cases`` and
``pucch_profile_cases`` (:func:`pucch_calls`), device µs alone;
``--cases pucch`` (which also keeps K19's two ``pucch_f3_demap`` cases),
~1 min; K12 (``pucch.f0_detect``) on the conductor slot's F0
(``pucch_f0_detect``: 8 candidates, 4 ports, 2 symbols), at 10 dB
(``_10db``), over a batch of 4 with per-slot references (``_batch4``)
and on 1 port and 1 symbol (``_p1``, its 1-pass build), and K14 (``short_block.detect``) on the 1-RB F2's codeword
(``short_block_detect``: K = 6, E = 32), at K = 11, E = 512 (``_k11``)
and over a slot axis of 4 (``_batch4``), from
``flagship.conductor_kernel_cases`` and ``uci_profile_cases``
(:func:`uci_calls`), each beside its correlation stage as one PyTorch call
(:func:`uci_stage`: ``torch.einsum`` / ``torch.matmul``); ``--cases
pucch_f0 short_block`` (which also keeps K34's ``short_block_encode``
cases), ~1 min; K11 (``srs.srs_noise``) on the flagship SRS
(``srs_noise``), a batch of 4 (``_batch4``), 48 RB at comb 4 with 4 SRS
ports (``_48rb``) and K = 1632 (``_k1632``), and K26
(``dl_rs.dmrs_map``, in place) on the flagship PDSCH (``dmrs_map``), a
batch of 4 (``_b4``), 69 PRGs (``_prg``), slot E's type 0 PRBs
(``_type0``), slot F's interleaved PRBs (``_interleaved``) and type 2
(``_type2``), from ``flagship.rs_profile_cases`` (:func:`rs_calls`), each
beside its named stage as one PyTorch call (:func:`rs_stage`: K11's
wideband ``torch.einsum``, K26's scatter ``index_put_``); ``--cases
srs_noise dmrs_map``, ~1 min; K23 (``compression.compress``) and K24
(``compression.decompress_sections`` into the case's grid, and
``bfp_decompress``) on the flagship fronthaul grid at widths 9, 8 and 14
and in their (exp, mant) modes (``bfp_compress``, ``_w8``, ``_w14``,
``_mant``; ``bfp_decompress``, ...), on 336 sections of 1, 7 and 18 PRBs at
odd offsets (``bfp_decompress_small``), two slots' grids
(``bfp_compress_batch2``, ``bfp_decompress_batch2``) and the (exp, mant)
mode at width 14 (``bfp_decompress_mant_w14``), from
``flagship.ofh_kernel_cases`` and ``ofh_profile_cases`` (:func:`bfp_calls`),
device µs alone (no PyTorch call computes BFP); ``--cases bfp_compress
bfp_decompress``, ~1 min; K20 (``channel.apply``) on
``flagship.channel_profile_cases`` (``tdl_channel``: the gNB simulator's
4x4 TDLA; ``_tdlc_cfo``, ``_uniform``, ``_r1``, ``_k288``), each also
timed in a CUDA graph of 20 calls (:func:`graph_us`), and ``channel.run``
whole (``_run``, its activities by name), beside its mix
``torch.einsum``, and K25 (``dl_rs.rs_map``, in place)
on ``du_kernel_cases``' ``rs_map*`` beside one ``index_put_`` of their
weighted terms (:func:`channel_calls`, :func:`rs_map_calls`); ``--cases
tdl_channel rs_map``, ~2 min.
``--cases`` keeps the cases whose names start with one of the prefixes
(and skips the pieces below, and building the cases it leaves out).  Per
case and call it reports:

* host µs: ``time.perf_counter_ns`` around the call alone, no synchronize
  (what the host spends to enqueue), median and quartiles of ``--calls``;
* event ms: CUDA events around one call, median of 20, as
  ``chip_smoke.py`` times a kernel (the host's enqueue shows in it);
* device µs: the device activities' time per call in a ``torch.profiler``
  trace of 50 calls, their span per call (the union of their intervals:
  where a call's launches overlap, less than their sum), the activities
  per call and the four longest by name;
* a ``cProfile`` of ``--calls`` calls: the functions with the most own
  time, to ``DIR/<case>_cprofile.txt``;
* the card's SM and memory clocks and power draw (``nvidia-smi``) just
  after the host timing.

Then the pieces a launch path chooses between, host µs each: reading the
current stream two ways, allocating an output three ways, a data pointer,
a ``device.const`` lookup, K33's PBCH output allocated three ways, a
ctypes call through ``CDLL`` and ``PyDLL``
with pointers as ``c_void_p`` and as ``c_uint64``, and K35's dequantize
split in two: its 1.7 MB output's allocation (from its shape, and like
its input), and its launch into an output made once.  The summary
is printed as the last line (JSON).
"""

from __future__ import annotations

import argparse
import cProfile
import ctypes
import io
import json
import pstats
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from . import flagship
from .device import card_line, const, require_cuda
from .kernels import _build
from .ops import (dl_control, dl_rs, ldpc_encode, ldpc_rate_match, llr,
                  ofdm, short_block, ul_demap)
from .emulation import channel as chan
from .ops.crc import crc
from .ops.transform_precode import deprecode
from .phy.lower import prach_demod
from .phy.upper import pdcch, prach, pucch, srs, ssb, uci
from .profile_slot import busy_us, profiled, top_activities
from .ran.ldpc_params import segment_tb

EVENT_RUNS = 20
PROFILED_CALLS = 50
UCI_E, UCI_QM = 120, 2     # one UCI codeword as the UE emulation sends it
# the cases also timed in a CUDA graph of 20 calls (K20's)
GRAPHED = tuple(flagship.CHANNEL_PROFILE_CASES)


def host_us(fn, calls: int) -> dict:
    """fn()'s enqueue time on the host clock, µs: (median, quartiles)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    q = statistics.quantiles(times, n=4)
    return {"median": statistics.median(times) / 1e3, "q1": q[0] / 1e3,
            "q3": q[2] / 1e3}


def event_ms(fn, runs: int = EVENT_RUNS) -> float:
    """Median of CUDA events around one fn() (as chip_smoke.median_ms)."""
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


def clocks() -> str:
    """The card's SM and memory clocks and power draw now, as nvidia-smi
    reads them (after a case's host loop: the card has just run it)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def device_profile(fn, path: Path, calls: int = PROFILED_CALLS,
                   top: int = 4) -> dict:
    """Device time per call: the sum of the device activities' durations
    in a torch.profiler trace of ``calls`` calls (its chrome trace goes
    to ``path`` and is deleted), the activities per call, and the ``top``
    with the most time (µs per call, by name)."""
    fn()
    events, _ = profiled(fn, calls, path)
    return {"us": sum(e[3] for e in events) / calls,
            "span_us": busy_us(events) / calls,
            "activities": len(events) / calls,
            "top": top_activities(events, calls, top)}


def graph_us(fn, calls: int = 20, runs: int = 10) -> float | None:
    """Device µs a call of ``calls`` calls captured in one CUDA graph:
    CUDA events around a replay, median of ``runs`` (None where the calls
    cannot be captured)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError:
        return None
    graph.replay()
    torch.cuda.synchronize()
    return 1e3 * event_ms(graph.replay, runs) / calls


def device_us(fn, path: Path, calls: int = PROFILED_CALLS) -> float:
    """:func:`device_profile`'s device µs per call."""
    return device_profile(fn, path, calls)["us"]


def cprofile_top(fn, calls: int, path: Path, rows: int = 20) -> list:
    """cProfile of ``calls`` calls; writes the stats by own time to
    ``path`` and returns the top ``rows`` as (function, own µs per call)."""
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    buf = io.StringIO()
    stats = pstats.Stats(prof, stream=buf).sort_stats("tottime")
    stats.print_stats(rows)
    path.write_text(buf.getvalue())
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:rows]
    return [(f"{Path(f).name}:{line}({name})", 1e6 * tt / calls)
            for (f, line, name), (_, _, tt, _, _) in top]


def take_call(rm_args: tuple):
    """``torch.take`` of K32's index plan (``gather_index``) on K32's
    arguments: one PyTorch call computing the same function, checked
    bit-equal to the twin."""
    cbs, e_sizes = rm_args[:2]
    plan = torch.from_numpy(ldpc_rate_match.gather_index(
        e_sizes, *rm_args[2:], cbs.shape[1])).to(cbs.device)
    if not torch.equal(torch.take(cbs, plan),
                       ldpc_rate_match.rate_match_batch_ref(*rm_args)):
        raise AssertionError("K32's library call differs from its twin")
    return lambda: torch.take(cbs, plan)


def matmul_call(args: tuple):
    """``torch.matmul`` of K21's [L_ra, N_u] bin matrix by the stacked
    windows [N_u, ports * reps] on K21's arguments: one PyTorch call
    computing the same function, checked within 1e-4 of max|out| of the
    twin."""
    samples, fmt, fs, start, f_off, _, ra = args
    l_ra, n_u, reps, b0 = prach_demod.geometry(fmt, fs, f_off, ra)
    m = torch.from_numpy(prach_demod._bin_dft_matrix(
        n_u, b0, l_ra)).to(samples.device)
    x = samples[:, start:start + reps * n_u].reshape(-1, n_u).T.contiguous()
    ref = prach_demod.demodulate_ref(*args)
    torch.testing.assert_close(torch.matmul(m, x).T.reshape(ref.shape), ref,
                               rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    return lambda: torch.matmul(m, x)


def ifft_call(name: str, args: tuple):
    """``torch.fft.ifft`` (norm "ortho") of K18's or K19's IDFT stage on as
    many blocks of M points as the kernel transforms: random blocks,
    checked within 1e-4 of max|out| of the twin's ``deprecode``."""
    if name.startswith("pusch_tp_demap"):
        m = args[5]
        blocks = args[2].shape[-1] // m
    else:
        cfg = args[3]
        m = 12 * cfg.nof_rb
        blocks = len(pucch._f3_symbol_split(cfg)[1])
    gen = torch.Generator(device=args[0].device)
    gen.manual_seed(m)
    x = torch.randn((blocks, m), dtype=torch.complex64, device=args[0].device,
                    generator=gen)
    ref = deprecode(x)
    torch.testing.assert_close(torch.fft.ifft(x, dim=-1, norm="ortho"), ref,
                               rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    return lambda: torch.fft.ifft(x, dim=-1, norm="ortho")


def gf2_stage(inputs: dict, pdcchs: tuple):
    """``torch.matmul`` of a K27 case's GF(2) stage, one float32 product
    over 0/1 values per PDU: the PBCH's map by the MIB (and its slot
    context, XOR-ed), each DCI's map by its payload -- the products the
    port ran before K27, exact (every sum is at most 140)."""
    ops = []
    if "mib" in inputs:
        dev = inputs["mib"].device
        if "static" in inputs:
            v = torch.cat([inputs["mib"], inputs["static"] ^ inputs["mask"]],
                          dim=-1)
            which = "full"
        else:
            v, which = inputs["mib"], "mib"
        ops.append((v.to(torch.float32),
                    const(ssb._pbch_operand, flagship.SSB, which, device=dev,
                          dtype=torch.float32)))
    for j, cfg in enumerate(pdcchs):
        dci = inputs[f"dci{j}"]
        key = (cfg.payload_bits, pdcch.BITS_PER_CCE * cfg.aggregation_level,
               cfg.rnti, cfg.n_rnti, cfg.n_id_data)
        ops.append((dci.to(torch.float32),
                    const(pdcch._dci_map, 0, *key, device=dci.device,
                          dtype=torch.float32)))
    return lambda: [torch.matmul(v, m) for v, m in ops]


def control_calls(rng: np.random.Generator, dev) -> tuple:
    """K27's cases: (calls, library) by name, and ``control_map_items``
    (building the flagship slot's PDUs; no library call)."""
    calls, library = {}, {}
    for name, (grid, inputs, items_fn, pdcchs) in \
            flagship.control_profile_cases(rng, dev).items():
        items = tuple(items_fn(grid, inputs))
        calls[name] = (lambda g=grid, it=items:
                       dl_control.control_map(g, it))
        library[name] = gf2_stage(inputs, pdcchs)
        if name == "control_map":
            calls["control_map_items"] = (lambda g=grid, i=inputs, f=items_fn:
                                          f(g, i))
            library["control_map_items"] = None
    return calls, library


def llr_calls(gen: torch.Generator, dev) -> tuple:
    """K35's cases on the flagship PUSCH's 426,096 LLRs: (calls, library)
    by name; the dequantize's library call checked bit-equal to the
    twin."""
    x = 8.0 * torch.randn(flagship.pusch_llr_count(), generator=gen,
                          device=dev)
    q = llr.quantize_ref(x)
    scale = torch.tensor(llr.LLR_INT_MAX / llr.LLR_RANGE, dtype=torch.float32,
                         device=dev)
    if not torch.equal(torch.div(q, scale).view(torch.int32),
                       llr.dequantize_ref(q).view(torch.int32)):
        raise AssertionError("K35's library call differs from its twin")
    return ({"llr_quantize": lambda: llr.quantize(x),
             "llr_dequantize": lambda: llr.dequantize(q)},
            {"llr_quantize": lambda: llr.quantize_ref(x),
             "llr_dequantize": lambda: torch.div(q, scale)})


def gf2_library(fn, bits: torch.Tensor, *args):
    """The yardstick of a UE-side encoder (K33, K34): ``torch.matmul`` of
    the message bits [B, K] by the GF(2) matrix of ``fn(bits, *args)``,
    mod 2, in float32 (every sum is exact).  The matrix is read off ``fn``
    on the CPU from the K unit messages; ``fn`` must map the zero message
    to zero (no placeholder bits)."""
    k = bits.shape[-1]
    if fn(torch.zeros((1, k), dtype=torch.int8), *args).any():
        raise ValueError("the encoder is not linear in its message")
    m = fn(torch.eye(k, dtype=torch.int8), *args).to(torch.float32).to(
        bits.device)
    x = bits.to(torch.float32)
    return lambda: torch.matmul(x, m) % 2


def _encode_uci_rows(bits: torch.Tensor, e: int, qm: int) -> torch.Tensor:
    """``uci.encode_uci`` of each row of ``bits`` [B, K] (its twins on the
    CPU)."""
    return torch.stack([uci.encode_uci(b, e, qm) for b in bits])


def ue_encoder_calls(rng: np.random.Generator, dev) -> tuple:
    """K33's and K34's cases: (calls, library) by name, each library call
    checked bit-equal to the kernel."""
    calls, library = {}, {}
    for name, (fn, twin, a) in flagship.ue_encoder_cases(
            flagship.ue_encoder_inputs(rng, dev)).items():
        calls[name] = lambda fn=fn, a=a: fn(*a)
        library[name] = gf2_library(twin, *a)
    for k in (16, 6):
        bits = torch.as_tensor(rng.integers(0, 2, k).astype(np.int8)).to(dev)
        calls[f"encode_uci_k{k}"] = (lambda b=bits:
                                     uci.encode_uci(b, UCI_E, UCI_QM))
        library[f"encode_uci_k{k}"] = gf2_library(
            _encode_uci_rows, bits[None], UCI_E, UCI_QM)
    for name, lib in library.items():
        if not torch.equal(lib().to(torch.int8).reshape(-1),
                           calls[name]().reshape(-1)):
            raise AssertionError(f"{name}: the GF(2) product differs")
    return calls, library


def _message_bits(tb: torch.Tensor, base_graph: int) -> torch.Tensor:
    """K5's encode-stage input as the twin builds it: the TB CRC, the
    segmentation, each codeblock's CRC24B and its fillers, [C, K] (or [B *
    C, K] for a slot axis)."""
    if tb.ndim == 2:
        return torch.cat([_message_bits(t, base_graph) for t in tb])
    seg = segment_tb(tb.shape[-1], base_graph)
    poly = "crc24A" if seg.tb_crc_bits == 24 else "crc16"
    b = torch.cat([tb, crc(tb[None], poly)[0]])
    ppc = seg.cb_info_bits - seg.cb_crc_bits
    b = torch.cat([b, b.new_zeros(ppc * seg.nof_codeblocks - b.shape[0])])
    cbs = b.reshape(seg.nof_codeblocks, ppc)
    if seg.cb_crc_bits:
        cbs = torch.cat([cbs, crc(cbs, "crc24B")], dim=-1)
    return torch.cat([cbs, cbs.new_zeros(
        (cbs.shape[0], seg.full_block_bits - seg.cb_info_bits))], dim=-1)


ENCODE_CHUNK = 256       # unit messages per twin encode of the generator


def dlsch_library(tb: torch.Tensor, base_graph: int):
    """K5's yardstick: one ``torch.mm`` of the encode stage's message bits
    [C, K] (:func:`_message_bits`) by the code's GF(2) generator [K, N],
    read off the twin's ``encode`` from the K unit messages, in bf16 with
    float32 out (``out_dtype``; every sum is an exact integer below 2**24),
    then mod 2; checked bit-equal to the twin.  Where this PyTorch has no
    ``out_dtype`` the product runs in float32 (``LIBRARY_KIND`` says
    which)."""
    seg = segment_tb(tb.shape[-1], base_graph)
    z, k = seg.lifting_size, seg.full_block_bits
    dev = tb.device
    rows = []
    for i in range(0, k, ENCODE_CHUNK):
        unit = torch.zeros((min(ENCODE_CHUNK, k - i), k), dtype=torch.int8,
                           device=dev)
        unit[torch.arange(unit.shape[0], device=dev),
             torch.arange(i, i + unit.shape[0], device=dev)] = 1
        rows.append(ldpc_encode.encode(unit, base_graph, z)[:, 2 * z:]
                    .to(torch.bfloat16))
    gen = torch.cat(rows)
    x = _message_bits(tb, base_graph).to(torch.bfloat16)
    try:
        torch.mm(x[:1], gen[:, :8], out_dtype=torch.float32)

        def call():
            return torch.mm(x, gen, out_dtype=torch.float32) % 2
        LIBRARY_KIND["dlsch_encode"] = "torch.mm bf16, out_dtype float32"
    except (TypeError, RuntimeError):
        x32, gen32 = x.float(), gen.float()

        def call():
            return torch.mm(x32, gen32) % 2
        LIBRARY_KIND["dlsch_encode"] = "torch.mm float32"
    want = ldpc_encode.dlsch_encode_ref(tb, base_graph)
    if not torch.equal(call().to(torch.int8).reshape(want.shape), want):
        raise AssertionError("K5's GF(2) product differs from its twin")
    return call


LIBRARY_KIND: dict = {}


def ldpc_cases(gen: torch.Generator, rng: np.random.Generator, dev) -> dict:
    """K1's and K5's cases: name -> (wrapper, twin, args).  K1: the
    flagship's noisy 46-layer case (``flagship.kernel_cases``), its clean
    slot at ``sch_decoder``'s layers, a batch of 4 with a slot axis, a
    HARQ retransmission and a BG2 TB (``flagship.ldpc_decode_cases``); K5:
    the flagship TB (835,584 bits), a batch of 4 and a BG2 TB at Z = 208
    (``flagship.dlsch_encode_cases``)."""
    _, rx, ctx = flagship.make_slots(1, rng, gen, dev)[0]
    cases = flagship.kernel_cases(rx, ctx, gen, flagship.prach_fd(dev))
    tb = torch.randint(0, 2, (flagship.PDSCH.tbs,), generator=gen,
                       device=dev, dtype=torch.int8)
    return {"ldpc_decode": cases["ldpc_decode"],
            **flagship.ldpc_decode_cases(cases, gen),
            "dlsch_encode": (ldpc_encode.dlsch_encode,
                             ldpc_encode.dlsch_encode_ref,
                             (tb, flagship.DL_SEG.base_graph)),
            **flagship.dlsch_encode_cases(tb, gen)}


def ldpc_calls(gen: torch.Generator, rng: np.random.Generator, dev) -> tuple:
    """K1's and K5's (calls, library, sweeps) by name, each kernel checked
    against its twin once (K1: hard bits and sweeps; K5: every bit); K1
    has no library call, K5 :func:`dlsch_library`."""
    calls, library, sweeps = {}, {}, {}
    for name, (fn, twin, a) in ldpc_cases(gen, rng, dev).items():
        out, ref = fn(*a), twin(*a)
        if name.startswith("ldpc"):
            if not (torch.equal(out[0], ref[0])
                    and torch.equal(out[2].cpu(), ref[2].cpu())):
                raise AssertionError(f"{name}: K1 differs from its twin")
            sweeps[name] = out[2].tolist()
            library[name] = None
        else:
            if not torch.equal(out, ref):
                raise AssertionError(f"{name}: K5 differs from its twin")
            library[name] = dlsch_library(*a)
        calls[name] = lambda fn=fn, a=a: fn(*a)
    return calls, library, sweeps


def chest_polar_calls(gen: torch.Generator, dev) -> tuple:
    """K8's and K15's (calls, library) by name
    (``flagship.chest_polar_profile_cases``), each checked against its
    twin once (K8: the TA equal, the rest within 1e-4 of the largest
    magnitude; K15: every bit and flag); no one PyTorch call computes
    either, so no library call."""
    calls, library = {}, {}
    for name, (fn, twin, a) in flagship.chest_polar_profile_cases(
            gen, dev).items():
        out, ref = fn(*a), twin(*a)
        if name.startswith("polar"):
            if not all(torch.equal(o, r) for o, r in zip(out, ref)):
                raise AssertionError(f"{name}: K15 differs from its twin")
        else:
            if not torch.equal(out.time_alignment_s, ref.time_alignment_s):
                raise AssertionError(f"{name}: K8's TA differs from its twin")
            for key in ("coeffs", "noise_var", "rsrp", "epre", "snr"):
                r = getattr(ref, key)
                torch.testing.assert_close(
                    getattr(out, key), r, rtol=1e-4,
                    atol=1e-4 * float(r.abs().max()), msg=f"{name} {key}")
        calls[name] = lambda fn=fn, a=a: fn(*a)
        library[name] = None
    return calls, library


def prach_idft_library(args: tuple):
    """``torch.fft.ifft`` of K9's IDFT stage on K9's arguments: the packed
    [(B,) P, S, R, N] buffer of the capture times the conjugate roots (the
    twin's ``_pack``), N = 1024, built once; a stage of the function, not
    the whole."""
    rx, cfg = args[:2]
    roots = torch.from_numpy(prach._root_fd(cfg)).to(rx.device)
    buf = prach._pack(rx[..., None, :] * roots.conj(), cfg.l_ra,
                      1024).contiguous()
    return lambda: torch.fft.ifft(buf, dim=-1)


def lxn_solve_library(args: tuple):
    """``torch.linalg.solve`` (as ``solve_ex``: no error check, so no
    host sync) of K16's solve stage on K16's arguments: the batched
    [(B) RE, L, L] systems (H^H H + c I) x = H^H y of the call's data REs
    (c = nv for MMSE, 1e-9 for ZF), built once and checked within 1e-4 of
    max|x| against the twin's symbols; a stage of the function, not the
    whole."""
    grid, coeffs, sym, sc, sc_off, nv = args[:6]
    layers, method = args[8], args[9]
    grids = grid.reshape((-1,) + grid.shape[-3:])
    hs = coeffs.reshape((-1,) + coeffs.shape[-4:])
    nvs = nv.reshape(-1)
    a, z = [], []
    for b in range(grids.shape[0]):
        y, h = ul_demap.gather_re(grids[b], hs[b], sym.long(), sc.long(),
                                  sc_off)
        ridge = nvs[b] if method == "mmse" else torch.tensor(
            1e-9, device=grid.device)
        a.append(h.conj().transpose(-1, -2) @ h + ridge * torch.eye(
            layers, dtype=h.dtype, device=h.device))
        z.append(h.conj().transpose(-1, -2) @ y[..., None])
    a, z = torch.cat(a), torch.cat(z)
    x_ref = ul_demap.equalize_demap_descramble_ref(*args)[1]
    x = torch.linalg.solve_ex(a, z)[0].reshape(x_ref.shape)
    if layers > 1 or method == "mmse":
        torch.testing.assert_close(x, x_ref, rtol=1e-4, atol=1e-4 * float(
            x_ref.abs().max()))
    return lambda: torch.linalg.solve_ex(a, z)


def prach_lxn_calls(gen: torch.Generator, dev) -> tuple:
    """K9's and K16's (calls, library) by name
    (``flagship.prach_lxn_profile_cases``), each checked against its twin
    once (K9: decisions and TA equal, metrics and RSSI within 1e-4 of the
    largest; K16: x within 1e-4, the LLRs within 1e-3 of the largest,
    equal hard decisions above that), beside the library call of its
    stage (:func:`prach_idft_library`, :func:`lxn_solve_library`)."""
    calls, library = {}, {}
    for name, (fn, twin, a) in flagship.prach_lxn_profile_cases(
            gen, dev).items():
        out, ref = fn(*a), twin(*a)
        if name.startswith("prach"):
            for key in ("detected", "time_advance_s"):
                if not torch.equal(getattr(out, key), getattr(ref, key)):
                    raise AssertionError(f"{name}: K9 {key} differs")
            pairs = ((out.metrics, ref.metrics), (out.rssi, ref.rssi))
            library[name] = prach_idft_library(a)
        else:
            big = ref[0].abs() > 1e-3 * float(ref[0].abs().max())
            if not torch.equal(out[0][big] > 0, ref[0][big] > 0):
                raise AssertionError(f"{name}: K16 hard decisions differ")
            pairs = ((out[1], ref[1]),)
            torch.testing.assert_close(out[0], ref[0], rtol=1e-3,
                                       atol=1e-3 * float(ref[0].abs().max()),
                                       msg=f"{name} llr")
            library[name] = lxn_solve_library(a)
        for o, r in pairs:
            torch.testing.assert_close(o, r, rtol=1e-4,
                                       atol=1e-4 * float(r.abs().max()),
                                       msg=name)
        calls[name] = lambda fn=fn, a=a: fn(*a)
    return calls, library


def ofdm_fft_library(name: str, args: tuple):
    """``torch.fft.fft`` (K4) or ``torch.fft.ifft`` (K7), norm "ortho", of
    the FFT stage on the [(B,) P, S, N] buffer the former K4 and K7 built
    around cuFFT: K4's windows (``ofdm._window_plan_rx``), K7's bins with
    zeros between the halves (``ofdm._grid_to_bins``), built once; a stage
    of the function, not the whole."""
    if name.startswith("ofdm_demodulate"):
        samples, _, n, mu, cp, sis = args[:6]
        offset = args[8] if len(args) > 8 else 0
        plan = torch.from_numpy(ofdm._window_plan_rx(
            cp, mu, n, sis, offset)).long().to(samples.device)
        buf = samples[..., plan].contiguous()
        return lambda: torch.fft.fft(buf, dim=-1, norm="ortho")
    buf = ofdm._grid_to_bins(args[0], args[1]).contiguous()
    return lambda: torch.fft.ifft(buf, dim=-1, norm="ortho")


def ofdm_calls(gen: torch.Generator, dev) -> tuple:
    """K4's and K7's (calls, library) by name
    (``flagship.ofdm_profile_cases``), each checked against its twin once
    (within 1e-4 of the largest magnitude), beside the library call of its
    FFT stage (:func:`ofdm_fft_library`)."""
    calls, library = {}, {}
    for name, (fn, twin, a) in flagship.ofdm_profile_cases(gen, dev).items():
        ref = twin(*a)
        torch.testing.assert_close(fn(*a), ref, rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()),
                                   msg=name)
        calls[name] = lambda fn=fn, a=a: fn(*a)
        library[name] = ofdm_fft_library(name, a)
    return calls, library


def map_demap_calls(gen: torch.Generator, dev) -> tuple:
    """K6's, K22's and K3's (calls, library) by name
    (``flagship.map_demap_profile_cases``), each checked against its twin
    once (K6 and K22 on copies of the grid, within 1e-6 of its largest
    magnitude; K3's symbols and LLRs at rtol 1e-4 and within 1e-4 of their
    largest); no single PyTorch call computes either function, so no
    library call.  The timed K6 calls add into the case's grid again and
    again (no copy in the time)."""
    calls, library = {}, {}
    for name, (fn, twin, a) in flagship.map_demap_profile_cases(
            gen, dev).items():
        if name.startswith("pdsch_map"):
            out, ref = fn(a[0].clone(), *a[1:]), twin(a[0].clone(), *a[1:])
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-6 * float(
                ref.abs().max()), msg=name)
        else:
            for o, r in zip(fn(*a), twin(*a)):
                torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(
                    r.abs().max()), msg=name)
        calls[name] = lambda fn=fn, a=a: fn(*a)
        library[name] = None
    return calls, library


def conductor_cases(gen: torch.Generator, rng: np.random.Generator,
                    dev) -> dict:
    """``flagship.conductor_kernel_cases`` on one conductor slot's samples
    (a seeded payload and UCI through the flagship channel)."""
    tb = torch.as_tensor(rng.integers(0, 2, flagship.PUSCH.tbs).astype(
        np.int8)).to(dev)
    rx = flagship.channel(flagship.ue_samples(0, tb, flagship.ue_uci(rng)),
                          gen)
    return flagship.conductor_kernel_cases(rx, 0, gen)


def pucch_cases(gen: torch.Generator, rng: np.random.Generator,
                dev) -> dict:
    """K10's and K13's cases: name -> (wrapper, twin, args).  The flagship
    occasion (``flagship.kernel_cases``' ``pucch_f1_detect``), the
    conductor slot's two F2 PDUs (``flagship.conductor_kernel_cases``'
    ``pucch_f2_demap``, ``_1rb``) and ``flagship.pucch_profile_cases``."""
    _, rx, ctx = flagship.make_slots(1, rng, gen, dev)[0]
    cases = {"pucch_f1_detect": flagship.kernel_cases(
        rx, ctx, gen, flagship.prach_fd(dev))["pucch_f1_detect"]}
    cases.update((k, v) for k, v in conductor_cases(gen, rng, dev).items()
                 if k.startswith("pucch_f2_demap"))
    cases.update(flagship.pucch_profile_cases(gen, dev))
    return cases


def pucch_calls(gen: torch.Generator, rng: np.random.Generator,
                dev) -> tuple:
    """K10's and K13's (calls, library) by name (:func:`pucch_cases`),
    each checked against its twin once (K10: decisions and bits equal,
    metric and symbol within 1e-4 of their largest; K13: the LLRs at rtol
    1e-4 and within 1e-4 of their largest); no single PyTorch call
    computes either, so no library call."""
    calls, library = {}, {}
    for name, (fn, twin, a) in pucch_cases(gen, rng, dev).items():
        out, ref = fn(*a), twin(*a)
        if name.startswith("pucch_f1"):
            if not (torch.equal(out[0], ref[0])
                    and torch.equal(out[2], ref[2])):
                raise AssertionError(f"{name}: K10 decisions differ")
            pairs = ((out[1], ref[1]), (out[3], ref[3]))
        else:
            pairs = ((out, ref),)
        for o, r in pairs:
            torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(
                r.abs().max()), msg=name)
        calls[name] = lambda fn=fn, a=a: fn(*a)
        library[name] = None
    return calls, library


def uci_stage(name: str, args: tuple):
    """The one PyTorch call of K12's or K14's correlation stage on the
    case's inputs, as its twin computes it, made ready once: K12's
    ``torch.einsum("psn,csn->cps", rx, refs.conj())`` on the occasion's
    REs gathered [(B,) P, S, 12] (a slot axis as "bpsn,(b)csn->bcps"),
    K14's ``torch.matmul(llrs, cands_t)`` of the [B, E] LLRs by the
    [E, 2^K] candidate bank; a stage of the function, not the whole."""
    if name.startswith("pucch_f0"):
        grid, cfg, refs = args[:3]
        rx = torch.stack([grid[..., l, 12 * prb:12 * prb + 12]
                          for l, prb in pucch._f0_res(cfg)], dim=-2)
        eq = ("psn,csn->cps" if rx.ndim == 3 else "bpsn,csn->bcps"
              if refs.ndim == 3 else "bpsn,bcsn->bcps")
        return lambda: torch.einsum(eq, rx, refs.conj())
    llrs, k, qm = args
    x = llrs.reshape(-1, llrs.shape[-1])
    cands_t = const(short_block._candidates_t, k, x.shape[-1], qm,
                    device=x.device)
    return lambda: torch.matmul(x, cands_t)


def uci_calls(gen: torch.Generator, rng: np.random.Generator,
              dev) -> tuple:
    """K12's and K14's (calls, library) by name: the conductor slot's F0
    (``pucch_f0_detect``, and at 10 dB ``_10db``) and 1-RB F2 codeword
    (``short_block_detect``, and K = 11, E = 512 ``_k11``) of
    ``flagship.conductor_kernel_cases``, and ``flagship.uci_profile_cases``
    (``_batch4`` each, K12's ``_p1``); each checked against its twin once (decisions and
    bits equal; K12's metric within 1e-4 where the noise term keeps its
    digits (10 dB), K14's within 1e-5), beside its correlation stage's
    library call (:func:`uci_stage`)."""
    cases = {k: v for k, v in conductor_cases(gen, rng, dev).items()
             if k.startswith(("pucch_f0_detect", "short_block_detect"))}
    cases.update(flagship.uci_profile_cases(gen, dev))
    calls, library = {}, {}
    for name, (fn, twin, a) in cases.items():
        out, ref = fn(*a), twin(*a)
        if name.startswith("pucch_f0"):
            if not all(torch.equal(out[i], ref[i]) for i in (0, 2, 3, 4)):
                raise AssertionError(f"{name}: K12 decisions differ")
            if name != "pucch_f0_detect":
                torch.testing.assert_close(out[1], ref[1], rtol=1e-4,
                                           atol=0.0, msg=name)
        else:
            if not torch.equal(out[0], ref[0]):
                raise AssertionError(f"{name}: K14 bits differ")
            torch.testing.assert_close(out[1], ref[1], rtol=1e-5, atol=1e-6,
                                       msg=name)
        calls[name] = lambda fn=fn, a=a: fn(*a)
        library[name] = uci_stage(name, a)
    return calls, library


def rs_stage(name: str, args: tuple):
    """The one PyTorch call of K11's or K26's named stage on the case's
    inputs, made ready once: K11's wideband stage
    ``torch.einsum("psk,lk->pl", rx, seq.conj() * ramp)`` on the gathered
    comb [(B,) P, S, K] (a slot axis as "bpsk,blk->bpl", a ramp a slot),
    K26's scatter stage, ``index_put_`` with ``accumulate=True`` of the
    precomputed precoded pilots at their REs (the grid's float32 view: every
    DM-RS RE of the layers' CDM groups on every port they reach); a stage of
    the function, not the whole."""
    if isinstance(args[1], srs.SrsConfig):
        grid, cfg, ta, _ = args
        dev = grid.device
        rx = grid[..., list(srs._symbols(cfg)), :][
            ..., torch.as_tensor(srs.sc_indices(cfg), device=dev).long()]
        seq = torch.from_numpy(srs._expected(cfg)[:, 0]).to(dev)
        k = torch.arange(cfg.seq_len, dtype=torch.float32, device=dev)
        ramp = torch.exp(1j * (srs._ramp_scale(cfg) * ta.float())[..., None]
                         * k).to(torch.complex64)
        cs = seq.conj() * ramp[..., None, :]
        eq = "psk,lk->pl" if rx.ndim == 3 else "bpsk,blk->bpl"
        return lambda: torch.einsum(eq, rx, cs)
    grid, pilots, w, ports, symbols, prbs, prg_size, config_type = args
    delta = dl_rs.dmrs_map_ref(torch.zeros_like(grid), *args[1:])
    p, s, k = grid.shape[-3:]
    groups = {q >> 1 for q in ports}
    sc = np.concatenate([dl_rs._comb(prbs, g, config_type) for g in groups])
    rows = [(o, l) for o in range(p) for l in symbols
            if w is not None or o < len(ports)]
    flat = np.concatenate([(o * s + l) * k + sc for o, l in rows])
    nb = grid.numel() // (p * s * k)
    flat = (np.arange(nb)[:, None] * (p * s * k) + flat[None]).ravel()
    idx = torch.as_tensor(np.stack([2 * flat, 2 * flat + 1], -1).ravel(),
                          device=grid.device)
    vals = torch.view_as_real(delta).reshape(-1)[idx]
    target = torch.view_as_real(grid.clone()).reshape(-1)
    return lambda: target.index_put_((idx,), vals, accumulate=True)


def rs_calls(dev) -> tuple:
    """K11's and K26's (calls, library) by name
    (``flagship.rs_profile_cases``), each checked against its twin once
    (K11 at rtol 1e-4 and within 1e-4 of the largest value, K26 bit-equal
    on copies of the grid), beside its named stage's library call
    (:func:`rs_stage`).  The timed K26 calls add into the case's grid again
    and again (no copy in the time)."""
    calls, library = {}, {}
    for name, (fn, twin, a) in flagship.rs_profile_cases(dev).items():
        if name.startswith("dmrs_map"):
            if not torch.equal(fn(a[0].clone(), *a[1:]),
                               twin(a[0].clone(), *a[1:])):
                raise AssertionError(f"{name}: K26 differs from its twin")
        else:
            for o, r in zip(fn(*a), twin(*a)):
                torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(
                    r.abs().max()), msg=name)
        library[name] = rs_stage(name, a)
        calls[name] = lambda fn=fn, a=a: fn(*a)
    return calls, library


def bfp_calls(rng, dev) -> tuple:
    """K23's and K24's (calls, library) by name (``flagship.ofh_kernel_cases``
    and ``ofh_profile_cases``), each checked bit for bit against its twin
    once; no library call (None)."""
    calls = {}
    cases = {**flagship.ofh_kernel_cases(rng, dev),
             **flagship.ofh_profile_cases(rng, dev)}
    for name, (fn, twin, a) in cases.items():
        out, ref = fn(*a), twin(*a)
        for o, r in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            if (o is None) != (r is None) or (o is not None and not
                                              torch.equal(o, r)):
                raise AssertionError(f"{name}: differs from its twin")
        calls[name] = lambda fn=fn, a=a: fn(*a)
    return calls, dict.fromkeys(calls)


def channel_calls(gen: torch.Generator, dev) -> tuple:
    """K20's (calls, library) by name (``flagship.channel_profile_cases``),
    each checked against its twin once (within 1e-5 of max|rx| and
    max|H|), beside its mix stage ``torch.einsum("rtk,tsk->rsk", H, tx)``,
    and "tdl_channel_run" ``channel.run`` whole, the draws and K20, as the
    app calls it once a slot (no library)."""
    calls, library = {}, {}
    cases = flagship.channel_profile_cases(gen, dev)
    for name, (fn, twin, a) in cases.items():
        (rx, h), (rx_ref, h_ref) = fn(*a), twin(*a)
        for got, ref in ((rx, rx_ref), (h, h_ref)):
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(
                ref.abs().max()), msg=name)
        calls[name] = lambda fn=fn, a=a: fn(*a)
        library[name] = (lambda h=h_ref, tx=a[0]:
                         torch.einsum("rtk,tsk->rsk", h, tx))
    tx = cases["tdl_channel"][2][0]
    run_gen = torch.Generator(device=dev)
    run_gen.manual_seed(30)
    calls["tdl_channel_run"] = lambda: chan.run(tx, flagship.GNB_CHANNEL,
                                                run_gen)
    library["tdl_channel_run"] = None
    return calls, library


def rs_map_stage(args: tuple):
    """K25's scatter stage as one PyTorch call: ``index_put_`` with
    ``accumulate=True`` of every term's precomputed weighted value (value
    x weight, complex64) at its target RE, in the grid's float32 view,
    on a copy of the case's grid; a stage of the function, not the
    whole."""
    grid, items, values = args
    lead = tuple(grid.shape[:-3])
    nb = lead[0] if lead else 1
    shape = tuple(grid.shape[-3:])
    stride = int(np.prod(shape))
    flats, vals = [], []
    n = _build.RS_MAX_SOURCES
    for c in range(0, len(items), n):
        plan = dl_rs.rs_plan(items[c:c + n], shape)
        srcs = dl_rs._sources(values[c:c + n], plan["shapes"], lead)
        tgt = np.repeat(plan["tgt"], np.diff(plan["start"]))
        w = torch.as_tensor(plan["w"], device=grid.device)
        for b in range(nb):
            v = torch.cat([(t.reshape(nb, -1)[b] if st else t.reshape(-1))
                           for t, st in srcs])
            base = np.concatenate([[0], np.cumsum(
                [int(np.prod(sh)) for sh in plan["shapes"]])])
            gidx = torch.as_tensor(base[plan["src"]] + plan["idx"],
                                   device=grid.device)
            flats.append(b * stride + tgt)
            vals.append(v[gidx] * w)
    flat = np.concatenate(flats)
    idx = torch.as_tensor(np.stack([2 * flat, 2 * flat + 1], -1).ravel(),
                          device=grid.device)
    terms = torch.view_as_real(torch.cat(vals)).reshape(-1)
    target = torch.view_as_real(grid.clone()).reshape(-1)
    return lambda: target.index_put_((idx,), terms, accumulate=True)


def rs_map_calls(rng: np.random.Generator, dev) -> tuple:
    """K25's (calls, library) by name: ``flagship.du_kernel_cases``'
    ``rs_map``, ``_trs``, ``_prs``, ``_many`` (33 CSI-RS, two launches),
    ``_terms`` (1-3 terms a target at odd offsets), each also with a slot
    axis of 4 (``_b4``), each checked bit for bit against its twin once on
    copies of its grid, then timed adding into the case's grid again and
    again (no copy in the time), beside its scatter stage
    (:func:`rs_map_stage`)."""
    calls, library = {}, {}
    for name, (fn, twin, a) in flagship.du_kernel_cases(rng, dev).items():
        if not name.startswith("rs_map"):
            continue
        if not torch.equal(torch.view_as_real(fn(*a)),
                           torch.view_as_real(twin(*a))):
            raise AssertionError(f"{name}: K25 differs from its twin")
        calls[name] = lambda a=a: dl_rs.rs_map(*a)
        library[name] = rs_map_stage(a)
    return calls, library


def _entry(loader, argtype):
    """K32's C entry point loaded through ``loader`` (ctypes.CDLL releases
    the interpreter lock around the call, ctypes.PyDLL keeps it) with four
    ``argtype`` arguments."""
    fn = loader(str(_build.library_path())).srsran_rate_match
    fn.argtypes = [argtype] * 4
    fn.restype = ctypes.c_int
    return fn


def pieces(rm_args: tuple, calls: int) -> dict:
    """Host µs of the steps a launch path may take, one at a time; the
    ctypes calls pass parameters K32's entry point refuses at once (no
    launch), so they time the call alone."""
    cbs = rm_args[0]
    dev = cbs.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    e_sizes = tuple(rm_args[1])
    g = sum(e_sizes)
    proto = torch.empty(g, dtype=torch.int8, device=dev)
    refused = _build.RateMatchParams()           # C = 0: refused
    addr = ctypes.addressof(refused)
    steps = {
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(index),
        "torch.empty(n, int8, device)":
            lambda: torch.empty(g, dtype=torch.int8, device=dev),
        "Tensor.new_empty(n)": lambda: cbs.new_empty(g),
        "torch.empty_like(a tensor of the output's shape)":
            lambda: torch.empty_like(proto),
        "Tensor.data_ptr()": cbs.data_ptr,
        "device.const lookup (K32's E sizes)":
            lambda: const(ldpc_rate_match._cb_sizes, e_sizes, 1, device=dev),
    }
    for loader in (ctypes.CDLL, ctypes.PyDLL):
        for argtype in (ctypes.c_void_p, ctypes.c_uint64):
            fn = _entry(loader, argtype)
            steps[f"ctypes call, {loader.__name__}, 4 x "
                  f"{argtype.__name__}"] = (lambda fn=fn: fn(0, 0, 0, addr))
    msg = torch.zeros((1, ssb._pbch_code().k), dtype=torch.int8, device=dev)
    e = ssb._pbch_code().e
    steps.update({
        "torch.empty((1, E), int8, device), K33's PBCH output":
            lambda: torch.empty((1, e), dtype=torch.int8, device=dev),
        "Tensor.new_empty((1, E)), K33's PBCH output":
            lambda: msg.new_empty((1, e)),
        "Tensor.new_empty(1, E), K33's PBCH output":
            lambda: msg.new_empty(1, e),
    })
    n = flagship.pusch_llr_count()
    q = torch.zeros(n, dtype=torch.int8, device=dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    launch = llr._llr_plan("srsran_llr_dequantize", n, index)
    steps.update({
        "Tensor.new_empty(shape, float32), K35's dequantize output":
            lambda: q.new_empty(q.shape, dtype=torch.float32),
        "torch.empty_like(q, float32), K35's dequantize output":
            lambda: torch.empty_like(q, dtype=torch.float32),
        "K35's dequantize launch alone (the output made once)":
            lambda: launch(q.data_ptr(), out.data_ptr()),
    })
    return {name: host_us(fn, calls)["median"] for name, fn in steps.items()}


def _wanted(cases, prefixes: tuple) -> bool:
    """Whether a ``--cases`` filter keeps a case named by a prefix in
    ``prefixes`` (no filter keeps every case)."""
    return cases is None or any(p.startswith(c) or c.startswith(p)
                                for c in cases for p in prefixes)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/launch_profile")
    ap.add_argument("--cases", nargs="*", default=None,
                    help="keep the cases whose names start with these")
    args = ap.parse_args(argv)
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    _build.load()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    rm_args = flagship.rate_match_args(rng, dev)
    k21 = {k: v for k, v in flagship.gnb_kernel_cases(gen, rng, dev).items()
           if k.startswith("prach_demod")}
    edge = flagship.edge_profile_cases(gen, dev)
    library = {"rate_match": take_call(rm_args),
               **{k: matmul_call(a) for k, (_, _, a) in k21.items()},
               **{k: ifft_call(k, a) for k, (_, _, a) in edge.items()}}
    calls = {"rate_match": lambda: ldpc_rate_match.rate_match_batch(
        *rm_args)}
    for name, (fn, _, a) in {**k21, **edge}.items():
        calls[name] = lambda fn=fn, a=a: fn(*a)
    builders = ((("control_map",), lambda: control_calls(rng, dev)),
                (("llr_",), lambda: llr_calls(gen, dev)),
                (("polar_encode", "short_block_encode", "encode_uci"),
                 lambda: ue_encoder_calls(rng, dev)),
                (("channel_estimate", "polar_decode"),
                 lambda: chest_polar_calls(gen, dev)),
                (("prach_detect", "pusch_demap_lxn"),
                 lambda: prach_lxn_calls(gen, dev)),
                (("ofdm_demodulate", "ofdm_modulate"),
                 lambda: ofdm_calls(gen, dev)),
                (("pdsch_map", "pusch_demap"),
                 lambda: map_demap_calls(gen, dev)),
                (("pucch_f1_detect", "pucch_f2_demap"),
                 lambda: pucch_calls(gen, rng, dev)),
                (("pucch_f0_detect", "short_block_detect"),
                 lambda: uci_calls(gen, rng, dev)),
                (("srs_noise", "dmrs_map"), lambda: rs_calls(dev)),
                (("bfp_compress", "bfp_decompress"),
                 lambda: bfp_calls(rng, dev)),
                (("tdl_channel",), lambda: channel_calls(gen, dev)),
                (("rs_map",), lambda: rs_map_calls(rng, dev)))
    for prefixes, build in builders:
        if _wanted(args.cases, prefixes):
            more_calls, more_library = build()
            calls.update(more_calls)
            library.update(more_library)
    sweeps = {}
    if _wanted(args.cases, ("ldpc_decode", "dlsch_encode")):
        more_calls, more_library, sweeps = ldpc_calls(gen, rng, dev)
        calls.update(more_calls)
        library.update(more_library)
    if args.cases is not None:
        calls = {k: f for k, f in calls.items()
                 if k.startswith(tuple(args.cases))}
    summary = {"card": card_line(), "torch": torch.__version__,
               "calls": args.calls, "sweeps": sweeps,
               "library_kind": LIBRARY_KIND, "cases": {}}
    for name, fn in calls.items():
        row = {}
        for which, f in (("kernel", fn), ("library", library[name])):
            if f is None:
                continue
            dev_prof = device_profile(f, out / f"{name}_{which}.json",
                                      top=12 if name.endswith("_run") else 4)
            row[which] = {
                "host_us": host_us(f, args.calls),
                "clocks": clocks(),
                "event_ms": event_ms(f),
                "device_us": dev_prof["us"],
                "span_us": dev_prof["span_us"],
                "activities": dev_prof["activities"],
                "top_activities": dev_prof["top"],
                "cprofile_top_us": cprofile_top(
                    f, args.calls, out / f"{name}_{which}_cprofile.txt")[:8],
            }
            if which == "kernel" and name in GRAPHED:
                row[which]["graph_us"] = graph_us(f)
        summary["cases"][name] = row
        print(f"{name}: " + "; ".join(
            f"{w} host {r['host_us']['median']:.2f} us, events "
            f"{r['event_ms']:.4f} ms, device {r['device_us']:.2f} us over "
            f"{r['activities']:g} activities, span {r['span_us']:.2f} us"
            + (f", graphed {r['graph_us']:.2f} us a call"
               if r.get("graph_us") is not None else "")
            + f" ({r['clocks']})"
            for w, r in row.items()),
            flush=True)
    if args.cases is None:
        summary["pieces_host_us"] = pieces(rm_args, args.calls)
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
