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
   detector, K10 PUCCH F1 detector (also with 3 and 12 users and a hop and
   over a batch of 4 with per-slot weights,
   ``flagship.pucch_profile_cases``), K11 SRS noise (also over a batch of
   4, on 48 RB at comb 4 with 4 SRS ports and at K = 1632,
   ``flagship.rs_profile_cases``, beside its wideband stage as one
   ``torch.einsum``, the library time); the DL kernels K5 DL-SCH
   encode, K6 PDSCH map (also on a small allocation with repetition at rv
   2), K7 OFDM modulation passes; the UCI kernels (phase 4's first step)
   K12 PUCCH F0 detect (decisions on the 30 dB slot; the metric too with
   noise added to 10 dB, and over a batch of 4 with per-slot references at
   10 dB), K13 PUCCH F2 demap (2 RB, 1 RB, 16 RB and over a batch of 4;
   K3, K4, K6, K7, K10, K12, K13 and K14 one launch a call), K14
   short-block ML (K = 6, E = 32, K = 11, E = 512, and over a slot axis
   of 4), each of K12 and K14 beside its correlation stage as one PyTorch
   call (``torch.einsum`` / ``torch.matmul``, the library time), K15 polar
   decode (K' = 33, E = 64, and N = 1024), plus K8 at the F2's comb-3
   shape.
   Beside each it computes the kernel's
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
   slots, the first with the SSB; every DL kernel's launch count must rise
   (K5-K7, K26 and K27; phases 4 and 6-8 check K26 and K27 too),
   one steady-state call runs under ``set_sync_debug_mode("error")``, an
   SSB slot and a plain slot match the same call on the plain twins on the
   CPU, and a plain slot is received back (K4, plain 256QAM demap, K2, K1)
   with its TB CRC passing and the exact payload;
4. drives the same slots through the FAPI slot conductor
   (``fapi.conductor.SlotConductor`` on the card) as bench.py:467-510 does:
   10 slot phases, payloads staged 8 slots per transfer, a warm-up, then 16
   slots through ``stage_payloads`` + ``process_slot``, each resolved 2
   slots behind the launch front.  The UL requests add a PUCCH F0 (SR + 2
   HARQ bits) and two PUCCH F2 (6 and 22 CSI bits) that the UE emulation
   sends.  Every slot must pass its PUSCH CRC with the exact payload,
   detect PRACH preamble 21 and return the F0 bits and both F2 payloads
   as sent; every kernel K1-K15 must launch; a HARQ retransmission (rv 0
   fails at 11 dB, rv 2 combined with its soft buffer decodes) runs
   through the conductor's HARQ pool; one steady-state
   ``process_slot`` runs under ``set_sync_debug_mode("error")``; one
   slot's ``SlotResults`` must equal the same requests through the port's
   conductor on the CPU.  It prints the conductor's us per slot by CUDA
   events and on the host clock (staging and resolve included);
5. holds K16 (L x N ZF/MMSE equalize-demap) against its twin at UE A's
   shape (4 layers, MMSE) and at 3 layers ZF, 2 layers MMSE and UE B's 1
   layer MMSE, K17 (UL-SCH / UCI demultiplex) bit-exact at UE B's codeword
   and with a punctured 1-bit HARQ-ACK on QAM16, and K8 on CDM group 1;
   then drives the two-UE UL slot of ``flagship.MU`` (UE A: 4-layer QAM64
   MMSE PUSCH on 205 RB, TBS 393272; UE B: 1-layer QAM16 MMSE PUSCH on 64
   RB, TBS 16896, with 4 HARQ-ACK bits, 8 CSI part-1 bits and 12 or 24
   part-2 bits by the RI in part 1; PUCCH F1, PRACH and SRS as above)
   through ``ul_slot_fn`` for 8 slots with fresh payloads and UCI: both
   TBs exact, UE B's ACK, CSI1 and CSI2 as sent and valid, PRACH 21, K16
   and K17 launched; one call under ``set_sync_debug_mode("error")``; slot
   0's result dict against the CPU twins; the same slots' UL requests
   beside the flagship DL through ``SlotConductor.process_slot`` (each
   slot's CRCs, payloads and UCI.indication from the PUSCH as sent); and
   ``pusch.process_with_part2_feedback`` on UE B once per RI, the part-2
   size unknown to the receiver;
6. graph: the conductor slot of phase 4 for each of its 10 slot phases
   through ``process_slot``, which runs the phase as one captured CUDA
   graph, held against the phase's eager slot program on the same inputs
   (tx samples within 1e-4, ``SlotResults`` equal: bits and CRC flags
   exact, floats within 1e-3), the memory each capture reserved, one
   phase's graph replayed on 3 slots of differing payloads and samples
   (each against the eager program and its payload), one replay with the
   DL branch on its own stream against DL after UL in one branch, and us
   per slot on the host clock and by CUDA events, graphed and eager, in
   the same run;
7. batch: the slot-batch mode, ``process_slot_batch`` at B = 4 on phases
   1-4 (SSB-free, bench.py:523-549) with each slot's own payload, samples
   and PRACH capture (slot 2's noise alone): 4/4 TBs with exact payloads,
   every indication as sent, each slot's packed results equal to
   ``process_slot``'s for the same slot (bits exact, scalars within 2e-4),
   PRACH detected per slot, every receiver of the plan once per batch
   (K1-K15 each once, K13 once per F2 PDU, K8 for the PUSCH, the SRS and
   both F2s: 1 + 3) and no kernel once per slot; us per slot; then the
   batched K1-K15 against their twins at B = 4 (timed, with their bounds)
   and at B = 1 against the unbatched kernels;
8. multi_cell: 4 cells of the flagship DL and UL plans through
   ``parallel.mesh.multi_cell_dl_fn`` / ``multi_cell_ul_fn``, each cell's
   samples and UL results equal to its single-cell program's, K1-K11
   launched once for the 4 cells (K8 twice: PUSCH and SRS);
9. cell-edge: K18 (the DFT-s-OFDM PUSCH's equalize, IDFT, demap and
   descramble) and K19 (PUCCH F3/F4) against their twins at the
   ``flagship.EDGE`` shapes (K18 also at M = 300, 2916 and 3240, K19 also
   at the F4, K8 at the F3's stride 1), with ``torch.fft.ifft`` on the
   same number of blocks as the IDFT stage's library time, and each K18 and
   K19 case's host and device µs per call beside ifft's; then 8 cell-edge
   UL slots (UE
   A: 2-layer QAM64 on 240 RB; UE C: DFT-s-OFDM QPSK with intra-slot
   hopping and 2 HARQ-ACK bits; PUCCH F3 with 22 bits, F4 with 8; F1,
   PRACH, SRS) through ``ul_slot_fn``: both TBs exact, UE C's ACK, the F3
   and F4 UCI as sent, PRACH 21, K18 and K19 launched; one call under
   ``set_sync_debug_mode("error")``; slot 0 against the CPU twins; the same
   slots through ``SlotConductor.process_slot`` (each through its CUDA
   graph and equal to its eager program), and four of them (slots 1-4,
   beside the flagship DL) as one ``process_slot_batch``: equal to
   ``process_slot`` slot by slot, every TB, UCI field and PRACH as sent,
   K18 and K17 once per batch, K19 once per F3/F4 PDU, K8 6 times and no
   kernel once per slot; the memory its capture reserved; us per slot
   over 8 graphed batches; then the batched K18 and K19 against their
   twins at B = 4 (timed, with their bounds), every slot bit-equal to its
   own unbatched launch;
10. gnb_sim: K20 (the TDL channel, 4x4 TDLA at 28 dB on shared draws), K21
   (the PRACH occasion demodulator: B4 at N_u = 4096, 12 repetitions; B4
   at N_u = 6144, the widest window its table in shared memory takes; and
   format 0 at N_u = 24,576) and K22 (K6 with a table of per-PRG
   precoders: a 2-layer 256QAM PDSCH on 273 RB in 69 PRGs of 4 PRBs,
   bit-exact, and with one PRG and the identity bit-exact to K6) against
   their twins, with the einsum mix stage of the channel and
   ``torch.matmul`` of the PRACH bin matrix as library times, K20's host
   path (host, events and device us a launch by the profiler, beside the
   mix stage); then the
   port's gNB simulator (``srsran_tpu_torch.apps.gnb_sim.run``) at the
   flagship width: test mode, no channel, 20 slots, every UL TB decoded;
   scheduler mode over TDLA at 28 dB with PRACH and CSI periods of 10, 40
   slots: a PRACH detected and turned into a TC-RNTI, a CSI report after
   which K22 launches, K20 once per emulated UL slot, K21 once per
   completed PRACH window, at least one UL TB decoded; us per DL and UL
   slot by CUDA events and on the host clock;
11. fronthaul: K23 (BFP compress and pack into the O-RAN U-plane payload)
   and K24 (unpack and BFP decompress into the grid, by section) against
   their twins, bit-exact, at the flagship's 4 x 14 x 3276 on a seeded
   grid with components past full scale, at widths 9, 8 and 14 (K23 also
   with (exp, mant), K24 also from them), and the cases of
   ``flagship.ofh_profile_cases``: K24 on 336 sections of 1, 7 and 18 PRBs
   at odd byte offsets, K23 and K24 on two slots' grids in one call, K24's
   (exp, mant) mode at width 14; no single PyTorch call computes
   BFP.  Then 8 flagship DL slots (``flagship.dl_grid_program``, the
   first with the SSB), each grid scaled by 0.5 before ``send_dl_grid``:
   a 6 dB back-off chosen here, by the caller (the unscaled grid peaks
   past the BFP full scale of 1.0; the port, like the JAX package, applies
   no scaling), sent by a DU ``RuOfh`` on the card over a
   ``socket.socketpair`` to the port's ``apps.ru_emulator.run`` in a
   thread (``loopback_delay=1``, its ``OfhTiming`` on wall time, the same
   card), which loops each slot back as UL: exactly one UL grid per DL
   slot with an SQNR of at least 40 dB against the grid sent, 112 U-plane
   and 4 C-plane frames each way per slot, no sequence drops, no
   unscheduled or incomplete slot, K23 and K24 launched once per grid per
   side; slot 0's frames byte-equal to a CPU ``RuOfh``'s on the same grid;
   the unscaled grid once over an in-memory cable (clipped share and
   one-hop SQNR printed, not asserted); us per slot on the host clock for
   ``send_dl_grid``, ``receive_ul_grid`` and the round trip, K23/K24
   device us by the profiler over 2 more slots (beside the received grids'
   ``torch.zeros``, which K24 writes into), and the emulator's
   reception-window counts (printed, not asserted: the DU does not pace
   itself to the OTA clock).  The phase has its own time limit: a hang
   raises instead of eating the smoke's budget.

12. du_low: K25 (the DL RS map: slot A's 4-port NZP-CSI-RS and PT-RS,
   slot B's TRS and PT-RS, slot C's comb-4 PRS, 33 CSI-RS in two launches,
   targets of 1-3 terms at odd offsets), K26 (the DL DM-RS map of
   the flagship PDSCH's 4 layers: identity, a [4, 4] matrix, 69 PRG
   matrices) and K27 (PDCCH and SSB: the GF(2) map, QPSK and patch; slot
   A's SSB with its slot context and AL8 PDCCH, each other aggregation
   level, the SSB without a context, the SSB and 17 DCIs in two launches,
   an AL4 DCI on the AL8 PDCCH's CCEs; K27 bit for bit, also on a grid of
   -0.0, which the twins turn to +0.0 under every hole of a patch) bit-exact
   to their twins at the flagship shapes, each also at B = 4 slot by slot
   against B = 1, timed with their bounds, K25's scatter stage as one
   ``index_put_`` and K27's GF(2) stage as ``torch.matmul`` (their library
   times); K25's host path on slot A, the PRS and the 33 CSI-RS (host,
   events and device us a launch by the profiler, in place, beside its
   stage); K27's host path (``launch_profile.
   control_calls``: slot A, the AL8 PDCCH, the SSB, AL1, AL16 and the
   many-UE slot on prebuilt PDUs, each beside the matmul of its GF(2)
   stage, and building slot A's PDUs).  Then the split-6 DU-low as a
   deployment runs it:
   ``python3 -m srsran_tpu_torch.apps.du_low --port 0`` in its own process,
   driven by the port's ``FapiClient`` over TCP -- param, config and start
   for the flagship cell; 10 slots of the DU-low scenario
   (``flagship.du_dl_request``: A SSB + PDCCH + PDSCH with PT-RS + 4-port
   CSI-RS, B PDCCH + PDSCH + TRS, C PDCCH + PRS, D empty, in turn), each
   DL with its samples (within 1e-4 of the in-process conductor's on the
   card), then rx_samples with the PRACH capture and ul_tti of phase 4's
   UL (every indication as phase 4 requires); slot A's PDSCH received back
   around its PT-RS (its known SSB cancelled: K4, demap, K2, K1, exact
   payload); the CSI-RS, TRS, PRS and PT-RS REs within 1e-3 of their
   values; 8 ul_tti_nb slots and a flush; a late slot answered with
   error.indication OUT_OF_SYNC; stop -> config (a 52-RB cell) -> start, a
   slot, and back.  The same slots then run through ``serve_phy`` in a
   thread of this process, where K25-K27's launches are counted (each in
   every DL slot that carries its PDUs) and the server's conductor calls
   timed by CUDA events, and a slot of the SSB and 17 DCIs takes two K27
   launches; us per message on the host clock and the wire's share are
   printed.  Last, a CellManager on the card runs slot A through its CUDA
   graph and reconfigures: the memory reserved after stop -> config ->
   start must have dropped by at least that graph's capture.  The phase
   has its own time limit.

13. du_low allocations and the UE side: K28 (UE-side control receive
   demap: slot E's five DCIs and PBCH, and 17 DCIs and the PBCH), K26
   (type 0 with 61 PRG matrices, interleaved VRBs, type 2 on ports 0, 1,
   4, 5), K22 and K6 (type 0, interleaved, a limited buffer n_ref = 3N/4),
   K2 (type 0, n_ref = 3N/4) and K15 (one AL16 DCI with its CRC
   syndrome, one PBCH codeword) against their twins (bit-exact; K6 within
   1e-6), timed with their bounds.  Then the port's du_low in its own process, driven over
   TCP by the port's FapiClient: slot E (the SSB, five DCIs at AL 16, 8,
   4, 2, 1 on disjoint CCEs of a 96-RB 2-symbol CORESET, a 4-layer 256QAM
   PDSCH precoded per PRG on RA type 0 RBGs 2-8 and 10-17 around the
   SSB), slot F (a DCI and a 4-layer PDSCH on interleaved VRBs 0-135),
   slot G (type 0 with PT-RS: answered error.indication MSG_SLOT_ERR) and
   phase 12's slot A again, each with phase 4's UL; E and F within 1e-4
   of the port's conductor on the CPU twins, A of its phase-12 reference.
   The UE side demodulates E's and F's samples (K4) and decodes every DCI
   and the PBCH (K28, K15): CRC ok, exact payloads, the MIB sent.  The
   same slots then run through ``serve_phy`` in a thread, with the UE
   side, between a reset and a read of the launch counts (K6, K22, K26,
   K28, K15 and the rest of the path launched; K28 once per UE slot).

14. split-8 radio and the UE-side list decoder: the port's ``ssb_tx``
   (``python -m srsran_tpu_torch.apps.ssb_tx``) in its own process at the
   flagship width (273 RB, 4096-point FFT, 1 port, 2 frames: 40 slots of
   61,440 samples, SSBs in slots 0, 1, 20 and 21) into a file under
   ``build/smoke/``, and the port's ``rx_power`` in its own process on it:
   its average, peak and PAPR within 0.01 dB of the same arithmetic in
   numpy, its occupied share equal.  Counted main path: the file read
   back through the port's ``SampleFileReader``, each SSB slot
   OFDM-demodulated (K4) at the app's SSB (first subcarrier 1518), its
   PBCH demapped (K28) and decoded by K15 and by K29 (CA-SCL, L = 8,
   CRC24C, after the port's polar rate dematch): both the MIB the app drew
   (``default_rng(0)``); a ``CfoProcessor`` with one command and a drift
   over the 40 blocks (K30 40 times, each block within 1e-6 of the twin);
   a clip of the file at a ceiling that clips about 1% of its samples
   (K31 once).  Then K29 (one UE slot's 36 AL16 blind-decode candidates,
   N = 512, L = 8, no CRC; the 4 PBCHs; the low-SNR batch) and K32 (the
   flagship PUSCH's codeblocks at rv 0-3 and one codeblock with n_ref =
   3N/4, ``torch.take`` of the index plan as its library time) bit-exact
   to their twins, K30 and K31 (slot E's 4 x 61,440 samples and the
   file's) within their tolerances, all timed with their bounds; the
   low-SNR PBCH-like experiment of tests/test_polar_scl.py at B = 256
   (CA-SCL8 fewer than half of K15's block errors); phase 13's DCIs at AL
   16-1 through K29 at L = 8 and 1 with no CRC (bit-exact to the twin, the
   payloads sent; at L = 1 K15's messages); RuRing and RuDummy round trips
   of slot E's samples with their timestamps.  Phase 10 also requires K32
   (the UE transmitter's rate match) to launch.

15. two-UE batch: 4 two-UE slots of ``flagship.MU`` at one RI
   (``flagship.mu_batch``: a batch shares one normalized plan, so UE B's
   CSI part 2 has one size) beside the flagship DL of phases 1-4, as one
   ``process_slot_batch``: equal to ``process_slot`` slot by slot, both
   TBs, UE B's ACK, CSI1 and CSI2 and PRACH 21 as sent in every slot, K16
   once per PUSCH (2) and K17 once per batch, K8 4 times, K14 twice, K15
   once, no kernel once per slot; the memory its capture reserved; us per
   slot over 8 graphed batches; then the batched K16 (UE A) and K17 (UE
   B) against their twins at B = 4 (timed, with their bounds), every slot
   bit-equal to its own unbatched launch.

16. the last device functions (``flagship.last_path``, counted): the
   PBCH through ``ssb.pbch_encode`` (K33, the polar encode chain) and
   ``pbch_modulate``, bit-equal to the PBCH REs of K27's SSB patch; slot
   E's five DCIs (AL 16-1) mapped by K27 and encoded again by
   ``pdcch.encode_dci`` (K33): scrambled, its bits equal K27's, and K28 +
   K15 decode the payloads; phase 4's 22-bit F2 (K33) and 6-bit F2 (K34,
   the short-block encoder) sent, each within 1e-6 of the CPU twins; 64
   UCI codewords of the cell edge's F3 code (K33); K34 at K 1-11, Qm 1,
   2, 4, 6; phase 2's flagship PUSCH LLRs (K4, K8, K3) quantized to int8
   and back (K35) and decoded (K2, K1) with the exact payload; K1 on
   every check row and K36 (the LDPC syndrome check) on its 37
   codeblocks: all pass, and with one bit flipped in each all fail; K8 on
   slot E's type 0 DM-RS comb (an irregular comb: 4 ports, 2 layers with
   the fd-OCC despread, filter smoothing, both time strategies) finding
   the channel's delay.  Then K33-K36 and K8's type 0 case against their
   twins (bit-exact; K8 at rtol 1e-4, the TA exact), timed with their
   bounds, K33 and K34 beside ``torch.matmul`` by their GF(2) encode
   matrix mod 2 and K35's dequantize beside ``torch.div`` by a 0-dim
   device tensor, bit-equal to it (library times).  Phases 4, 5 and 9
   also count the UE side's K33/K34 while their transmitters build the
   slots (the F2s; UE B's UCI on PUSCH; UE C's ACK, the F3 and the F4),
   and phase 10 K34 in the gnb_sim UE emulator (its CSI-on-PUSCH reports
   of 4 and 6 bits).

17. BPSK PUSCHs without transform precoding at the flagship width
   (``flagship.BPSK_PUSCH``: pi/2-BPSK, 2 layers, ZF, K3;
   ``BPSK_PUSCH_MMSE``: BPSK, 1 layer, MMSE, K16; each hopping over the
   band), each through ``pusch.process`` with the counts reset just before
   (K8, K3 or K16, K2, K1 launched): the TB decoded with the exact
   payload, the codeword LLRs within 1e-3 of the CPU twins'; then hop 2's
   K3 and K16 (their Gold offset and pi/2-BPSK parity from hop 1) against
   their twins, timed.

K32's, K21's, K18's, K19's and K35's cases (phases 14, 10, 9 and 16)
and K27's (phase 12) also print, beside their events, the host µs per
call (``time.perf_counter_ns`` around the enqueue, no synchronize, median
of 1000 calls) and the device µs per call (a ``torch.profiler`` trace of
50 calls), for the kernel and for its library call or plain twin
(``srsran_tpu_torch/launch_profile.py``'s timers).

It prints the card's name and power limit, one JSON line of per-kernel
results, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises, so the script then exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import select
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from srsran_tpu_torch import convert, flagship, kernels, launch_profile
from srsran_tpu_torch.apps import gnb_sim, ru_emulator, ssb_tx
from srsran_tpu_torch.emulation import channel as chan
from srsran_tpu_torch.device import card_line, const, require_cuda
from srsran_tpu_torch.fapi import config_messages as cm
from srsran_tpu_torch.fapi import messages
from srsran_tpu_torch.fapi.conductor import SlotConductor
from srsran_tpu_torch.fapi.transport import FapiClient, serve_phy
from srsran_tpu_torch.graphs import SlotGraph
from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.io.sampio import SampleFileReader
from srsran_tpu_torch.ofh import compression as bfp
from srsran_tpu_torch.ops import dl_control, dl_map, dl_rs
from srsran_tpu_torch.ops import ldpc_rate_match, ofdm, polar
from srsran_tpu_torch.ops import llr as llr_ops
from srsran_tpu_torch.ops import polar_scl, short_block, transform_precode
from srsran_tpu_torch.ops import ul_demap
from srsran_tpu_torch.ops.crc import crc, crc_check
from srsran_tpu_torch.ops.ldpc_graph import get_graph
from srsran_tpu_torch.ops.modulation import BITS_PER_SYMBOL
from srsran_tpu_torch.ops.scrambling import scramble_bits
from srsran_tpu_torch.parallel.mesh import multi_cell_dl_fn, multi_cell_ul_fn
from srsran_tpu_torch.phy.lower import amplitude_control, cfo, prach_demod
from srsran_tpu_torch.phy.slot_programs import ul_slot_fn
from srsran_tpu_torch.phy.upper import (pdcch, pdsch, prach, ptrs_prs, pucch,
                                        pusch, ssb)
from srsran_tpu_torch.ran import polar_params
from srsran_tpu_torch.ran.slot_point import SlotPoint
from srsran_tpu_torch.ru import RuDummy, RuRing
from srsran_tpu_torch.ru.ofh import InMemoryCable, RuOfh, SocketEndpoint
from srsran_tpu_torch.utils import config as app_config

SEED = 0
NOF_SLOTS = 8
TIMING_RUNS = 20
UL_KERNELS = ("ldpc_decode", "rate_dematch", "pusch_demap", "ofdm_demodulate",
              "channel_estimate", "prach_detect", "pucch_f1_detect",
              "srs_estimate")
DL_KERNELS = ("dlsch_encode", "pdsch_map", "ofdm_modulate", "dmrs_map",
              "control_map")
UCI_KERNELS = ("pucch_f0_detect", "pucch_f2_demap", "short_block_detect",
               "polar_decode")
MU_KERNELS = ("pusch_demap_lxn", "ulsch_demux")
EDGE_KERNELS = ("pusch_tp_demap", "pucch_f3_demap")
# The kernels the cell-edge slot (phase 9) launches: K3 for UE A, K18 for
# UE C, K17 and K14 for its HARQ-ACK, K19 with K15 (F3) and K14 (F4).
EDGE_PATH = ("ldpc_decode", "rate_dematch", "pusch_demap", "ofdm_demodulate",
             "channel_estimate", "prach_detect", "pucch_f1_detect",
             "srs_estimate", "ulsch_demux", "short_block_detect",
             "polar_decode") + EDGE_KERNELS
# The kernels the two-UE UL slot (phase 5) launches: no K3 (both UEs use
# MMSE), K14 and K15 for UE B's UCI on PUSCH.
MU_PATH = ("ldpc_decode", "rate_dematch", "ofdm_demodulate",
           "channel_estimate", "prach_detect", "pucch_f1_detect",
           "srs_estimate", "short_block_detect", "polar_decode") + MU_KERNELS
# Extra cases of a kernel at another shape: compared and timed, printed,
# not in the JSON line (which holds the main path's shape).
CASE_KERNEL = {**{f"ofdm_{k}{case}": f"ofdm_{k}"
                  for k in ("demodulate", "modulate")
                  for case in ("_batch4", "_n1024", "_offset_max",
                               "_extended", "_n1536")},
               "pdsch_map_repetition": "pdsch_map",
               "pdsch_map_batch4": "pdsch_map",
               **{f"pusch_demap{case}": "pusch_demap"
                  for case in ("_batch4", "_1l", "_hop1", "_hop2")},
               "ldpc_decode_clean": "ldpc_decode",
               "ldpc_decode_batch4": "ldpc_decode",
               "ldpc_decode_harq": "ldpc_decode",
               "ldpc_decode_bg2": "ldpc_decode",
               "dlsch_encode_batch4": "dlsch_encode",
               "dlsch_encode_bg2": "dlsch_encode",
               "pucch_f0_detect_10db": "pucch_f0_detect",
               "pucch_f0_detect_batch4": "pucch_f0_detect",
               "pucch_f0_detect_p1": "pucch_f0_detect",
               "short_block_detect_batch4": "short_block_detect",
               **{f"srs_noise{case}": "srs_estimate"
                  for case in ("_batch4", "_48rb", "_k1632")},
               "channel_estimate_f2": "channel_estimate",
               "pucch_f2_demap_1rb": "pucch_f2_demap",
               **{f"pucch_f1_detect{case}": "pucch_f1_detect"
                  for case in ("_3u_hop", "_12u_hop", "_batch4")},
               **{f"pucch_f2_demap{case}": "pucch_f2_demap"
                  for case in ("_16rb", "_batch4")},
               "short_block_detect_k11": "short_block_detect",
               "polar_decode_n1024": "polar_decode",
               "pusch_demap_lxn_3l_zf": "pusch_demap_lxn",
               "pusch_demap_lxn_2l_mmse": "pusch_demap_lxn",
               "pusch_demap_lxn_1l_mmse": "pusch_demap_lxn",
               "ulsch_demux_punctured": "ulsch_demux",
               "channel_estimate_delta1": "channel_estimate",
               "pusch_tp_demap_widest": "pusch_tp_demap",
               "pusch_tp_demap_m300": "pusch_tp_demap",
               "pusch_tp_demap_m2916": "pusch_tp_demap",
               "pucch_f3_demap_f4": "pucch_f3_demap",
               "channel_estimate_f3": "channel_estimate",
               "prach_demod_n6144": "prach_demod",
               "prach_demod_format0": "prach_demod",
               "pusch_demap_pi2bpsk": "pusch_demap",
               "pusch_demap_lxn_bpsk": "pusch_demap_lxn",
               "bfp_compress_w8": "bfp_compress",
               "bfp_compress_w14": "bfp_compress",
               "bfp_compress_mant": "bfp_compress",
               "bfp_decompress_w8": "bfp_decompress",
               "bfp_decompress_w14": "bfp_decompress",
               "bfp_decompress_mant": "bfp_decompress",
               "bfp_decompress_small": "bfp_decompress",
               "bfp_compress_batch2": "bfp_compress",
               "bfp_decompress_batch2": "bfp_decompress",
               "bfp_decompress_mant_w14": "bfp_decompress",
               **{f"{case}{tag}": case.split("_")[0] + "_map"
                  for case in ("rs_map_trs", "rs_map_prs", "rs_map_many",
                               "rs_map_terms", "dmrs_map_matrix",
                               "dmrs_map_prg",
                               "control_map_al1", "control_map_al2",
                               "control_map_al4", "control_map_al16",
                               "control_map_ssb_static", "control_map_many",
                               "control_map_overlap")
                  for tag in ("", "_b4")},
               "control_map_negzero": "control_map",
               **{f"{k}_b4": k for k in ("rs_map", "dmrs_map",
                                         "control_map")},
               "control_llrs_many": "control_llrs",
               "dmrs_map_type0": "dmrs_map",
               "dmrs_map_interleaved": "dmrs_map",
               "dmrs_map_type2": "dmrs_map",
               "pdsch_map_prg_type0": "pdsch_map_prg",
               "pdsch_map_interleaved": "pdsch_map",
               "pdsch_map_nref": "pdsch_map",
               "rate_dematch_type0": "rate_dematch",
               "rate_dematch_single": "rate_dematch",
               "rate_dematch_nref": "rate_dematch",
               "polar_decode_al16": "polar_decode",
               "polar_decode_pbch": "polar_decode",
               "polar_scl_decode_pbch": "polar_scl_decode",
               "polar_scl_decode_lowsnr": "polar_scl_decode",
               **{f"rate_match_{t}": "rate_match"
                  for t in ("rv1", "rv2", "rv3", "nref")},
               "cfo_rotate_file": "cfo_rotate",
               "amplitude_control_file": "amplitude_control",
               "amplitude_control_scale": "amplitude_control",
               "polar_encode_pbch": "polar_encode",
               "polar_encode_dci_al16": "polar_encode",
               "polar_encode_uci64": "polar_encode",
               "short_block_encode_k11": "short_block_encode",
               "channel_estimate_type0": "channel_estimate",
               "channel_estimate_type0_interp": "channel_estimate"}
CONDUCTOR_SLOTS = 16
RESOLVE_LAG = 2
# A HARQ retransmission through the conductor: at 11 dB the first
# transmission (rv 0) of the flagship PUSCH fails and rv 0 + rv 2 combined
# decode (a sweep of 8-18 dB on the H100 with this channel seed).
HARQ_SNR_DB = 11.0
HARQ_ID = 3
# H100 SXM peaks (NVIDIA's data sheet): device memory, float32 outside the
# tensor cores.  A card set below 700 W runs below them.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The kernels with a slot axis (K1-K15); each has a "<name>_batch" row.
# The first 11 are the flagship UL and DL plans' (K1-K11), the rest the
# conductor scenario's UCI kernels (K12-K15).
BATCHED = ("ofdm_demodulate", "pusch_demap", "rate_dematch", "ldpc_decode",
           "channel_estimate", "dlsch_encode", "pdsch_map", "ofdm_modulate",
           "prach_detect", "pucch_f1_detect", "srs_estimate",
           "pucch_f0_detect", "pucch_f2_demap", "short_block_detect",
           "polar_decode")
# K16-K19's slot-axis forms: the two-UE batch's (phase 15) and the cell
# edge's (phase 9).
BATCHED_UL = ("pusch_demap_lxn", "ulsch_demux", "pusch_tp_demap",
              "pucch_f3_demap")
BATCH_KERNELS = tuple(f"{n}_batch" for n in BATCHED + BATCHED_UL)
# Launches of each batch row in one batch of the conductor scenario: one,
# but K8 once for the PUSCH, the SRS and each F2 (1 + 3) and K13 once per
# F2 PDU; no kernel launches once per slot.
BATCH_LAUNCHES = {**{f"{n}_batch": 1 for n in BATCHED},
                  "channel_estimate_batch": 4, "pucch_f2_demap_batch": 2}
# The same for the multi-cell programs (the flagship plans: no F0, no F2;
# K8 for the PUSCH and the SRS).
MULTI_CELL_LAUNCHES = {**{f"{n}_batch": 1 for n in BATCHED[:11]},
                       "channel_estimate_batch": 2}
# The same in one two-UE or cell-edge batch of 4 beside the flagship DL:
# two PUSCHs (K2 and K1 twice) and no F0 or F2; two-UE: K16 once per PUSCH
# (no K3: both MMSE), K17 once (UE B), K8 for UE A's two CDM groups, UE B
# and the SRS, K14 for UE B's ACK and CSI1, K15 for its CSI2; cell edge:
# K3 (UE A), K18 and K17 (UE C), K19 once per F3/F4 PDU, K8 for UE A, UE
# C's two hops, the SRS, the F3 and the F4, K14 for UE C's ACK and the F4,
# K15 for the F3.
_TWO_PUSCH = {**{f"{n}_batch": 1 for n in BATCHED[:11]},
              "rate_dematch_batch": 2, "ldpc_decode_batch": 2,
              "polar_decode_batch": 1, "short_block_detect_batch": 2,
              "ulsch_demux_batch": 1}
MU_BATCH_LAUNCHES = {**{k: v for k, v in _TWO_PUSCH.items()
                        if k != "pusch_demap_batch"},
                     "pusch_demap_lxn_batch": 2, "channel_estimate_batch": 4}
EDGE_BATCH_LAUNCHES = {**_TWO_PUSCH, "pusch_tp_demap_batch": 1,
                       "pucch_f3_demap_batch": 2,
                       "channel_estimate_batch": 6}
# K4's, K7's, K9's, K16's, K32's, K21's, K18's, K19's, K33's, K34's and
# K35's cases:
# host µs per call over HOST_CALLS calls and device µs from a profiler
# trace, for the kernel and its library call (K35's quantize, which no one
# call computes: its plain twin).  K27's (phase 12) go through
# ``launch_profile.control_calls``.
HOST_TIMED = ("ofdm_demodulate", "ofdm_demodulate_batch4", "ofdm_modulate",
              "ofdm_modulate_batch4", "srs_estimate", "srs_noise_batch4",
              "prach_detect", "pusch_demap_lxn", "pusch_demap_lxn_1l_mmse",
              "rate_match", "prach_demod", "prach_demod_n6144",
              "prach_demod_format0", "pusch_tp_demap",
              "pusch_tp_demap_m300", "pusch_tp_demap_m2916",
              "pusch_tp_demap_widest", "pucch_f3_demap", "pucch_f3_demap_f4",
              "polar_encode", "polar_encode_pbch", "polar_encode_dci_al16",
              "polar_encode_uci64", "short_block_encode",
              "short_block_encode_k11", "llr_quantize", "llr_dequantize",
              "ldpc_decode", "ldpc_decode_clean", "ldpc_decode_batch4",
              "ldpc_decode_harq", "ldpc_decode_bg2", "dlsch_encode",
              "dlsch_encode_batch4", "dlsch_encode_bg2", "tdl_channel")
HOST_CALLS = 1000
# K1's cases: host µs of the kernel alone (no PyTorch call computes it, and
# its twin takes 15-460 ms a call).
HOST_KERNEL_ONLY = ("ldpc_decode", "ldpc_decode_clean", "ldpc_decode_batch4",
                    "ldpc_decode_harq", "ldpc_decode_bg2")
# The figures of the K1 and K5 these kernels replaced (a CTA per codeblock
# reading its edge tables from global memory per edge; a TB-CRC pass and a
# byte-per-bit encode), for comparison: device µs (profiler), host µs per
# call (median of 1000), events ms (median of 20), from ``python3 -m
# srsran_tpu_torch.launch_profile --cases ldpc dlsch`` on the same cases,
# NVIDIA H100 80GB HBM3 at 700 W.
PARENT_LDPC = {"ldpc_decode": (536.32, 547.17, 0.6726),
               "ldpc_decode_clean": (67.62, 321.89, 0.3690),
               "ldpc_decode_batch4": (296.20, 316.53, 0.4712),
               "ldpc_decode_harq": (114.31, 240.08, 0.3237),
               "ldpc_decode_bg2": (190.36, 320.40, 0.3127),
               "dlsch_encode": (38.60, 47.93, 0.1005),
               "dlsch_encode_batch4": (99.43, 87.94, 0.1819),
               "dlsch_encode_bg2": (17.12, 64.58, 0.1174)}
TRACE_DIR = Path(__file__).resolve().parent / "build" / "launch_traces"
N_TIMED_BATCHES = 8
BATCH_TIMING_RUNS = 5
GRAPH_PASSES = 2
GNB_KERNELS = ("tdl_channel", "prach_demod", "pdsch_map_prg", "rate_match")
# The flagship width, as ``--set`` overrides of the app's configuration.
GNB_CELL = ("cell.nof_rb=273", "cell.dft_size=4096", "cell.nof_ports=4")
GNB_TEST_SLOTS = 20
GNB_SCHED = ("run.mac=sched", "run.prach_period_slots=10",
             "run.csi_period_slots=10", "run.channel_profile=TDLA",
             f"run.channel_sinr_db={flagship.GNB_SINR_DB}")
GNB_SCHED_SLOTS = 40
OFH_KERNELS = ("bfp_compress", "bfp_decompress")
# The fronthaul round trip: a 6 dB back-off of the DL grid before the DU
# sends it (the flagship grid peaks past the BFP full scale of 1.0), 2
# slots more under the profiler, and the phase's own time limit.
OFH_BACKOFF = 0.5
OFH_MIN_SQNR_DB = 40.0
OFH_PROFILED_SLOTS = 2
OFH_PHASE_S = 300.0
OFH_PROFILE_SEED = 29
DU_KERNELS = ("rs_map", "dmrs_map", "control_map")
# Phase 13: the DU-low's allocation slots (flagship.du_alloc_request) at
# these slot points, then phase 12's slot 4 (kind A at (1, 8)) again; the
# kernels its main path launches, K28 the new one.
ALLOC_KERNELS = ("control_llrs",)
ALLOC_SLOTS = (("E", 2), ("F", 4), ("G", 6))
ALLOC_A = 4
ALLOC_PATH = ("pdsch_map", "pdsch_map_prg", "dmrs_map", "control_map",
              "rs_map", "control_llrs", "polar_decode", "ofdm_demodulate",
              "dlsch_encode", "ofdm_modulate")
# The DU-low phase: 10 slots (kinds A-D in turn), 8 ul_tti_nb slots, its
# own time limit, and the RS REs' tolerance after OFDM and back.
DU_SLOTS = 10
DU_NB_SLOTS = 8
DU_PHASE_S = 300.0
DU_RS_TOL = 1e-3
# Phase 14, the split-8 radio: ssb_tx at the flagship width (1 port, 2
# frames: 40 slots, SSBs in slots 0, 1, 20, 21) into a file under build/,
# and rx_power on it; the kernels its main path launches (K29-K31 new)
# and the phase's own time limit.
SPLIT8_KERNELS = ("polar_scl_decode", "cfo_rotate", "amplitude_control")
SPLIT8_PATH = ("ofdm_demodulate", "control_llrs", "polar_decode") + \
    SPLIT8_KERNELS
SPLIT8_FILE = _build.BUILD_DIR.parent / "smoke" / "ssb_tx.sio"
SSB_TX_CELL = flagship.SPLIT8_CELL
SSB_TX_FRAMES = 2
SSB_TX_PCI = 500
SPLIT8_PHASE_S = 300.0
RX_POWER_DB_TOL = 0.01
SCL_LIST = flagship.SCL_LIST
# The JAX test's low-SNR PBCH-like experiment (tests/test_polar_scl.py:
# 28-54) at B = 256.
LOWSNR_BLOCKS = 256
LOWSNR_SIGMA = 1.4
# The CFO run over the file's blocks: one command with a drift.
CFO_HZ = 1500.0
CFO_DRIFT_HZ_S = 2e4
AMP_METRICS = ("avg_power_db", "peak_power_db", "papr_db", "clipped_ratio")
# The UE-side encoders (K33, K34) that the transmitters of phases 4, 5 and 9
# launch while they build their slots, and gnb_sim's UE emulator in phase
# 10 (K34: its CSI-on-PUSCH reports are 4 and 6 bits); phase 16's kernels,
# and the rest of its counted path.
UE_KERNELS = ("polar_encode", "short_block_encode")
LAST_KERNELS = ("llr_quantize", "llr_dequantize", "ldpc_check_parity")
LAST_PATH = UE_KERNELS + LAST_KERNELS + (
    "control_map", "control_llrs", "polar_decode", "ofdm_demodulate",
    "channel_estimate", "pusch_demap", "rate_dematch", "ldpc_decode")


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


def compare(name: str, out, ref, case_args: tuple = ()) -> float:
    """Hold one kernel's result against its twin's; returns max |error|
    (for K1, the number of hard bits that differ; ``case_args``: its
    arguments)."""
    case, name = name, CASE_KERNEL.get(name, name)
    if name == "pucch_f0_detect":                  # K12: decisions equal
        if not all(torch.equal(out[i], ref[i]) for i in (0, 2, 3, 4)):
            raise AssertionError("K12 decisions differ from its twin's")
        if case == "pucch_f0_detect":
            # the metric's noise term is energy - max corr, a difference of
            # sums equal to ~3 digits at 30 dB: decisions only; the 10 dB
            # case holds the metric
            return float((out[1] - ref[1]).abs().max())
        return close(out[1], ref[1], "K12 metric at 10 dB")
    if name == "pucch_f2_demap":                   # K13
        return close(out, ref, "K13 llr")
    if name == "short_block_detect":               # K14: bits equal
        if not torch.equal(out[0], ref[0]):
            raise AssertionError("K14 bits differ from its twin's")
        return close(out[1], ref[1], "K14 metric", rtol=1e-5)
    if name == "polar_decode":                     # K15: bit-exact
        if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
            raise AssertionError("K15 bits or CRC flags differ from its twin's")
        return 0.0
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
    if name == "pusch_demap_lxn":                  # K16: (llr, x)
        # an LDL^H solve against the twin's LU inverse: x within 1e-4 and
        # the LLRs within 1e-3 of their largest magnitude, and the same hard
        # decisions wherever |LLR| is above that tolerance
        llr, llr_ref = out[0], ref[0]
        big = llr_ref.abs() > 1e-3 * float(llr_ref.abs().max())
        if not torch.equal(llr[big] > 0, llr_ref[big] > 0):
            raise AssertionError(f"{case}: hard decisions differ")
        return max(close(out[1], ref[1], f"{case} x"),
                   close(llr, llr_ref, f"{case} llr", rtol=1e-3))
    if name == "pusch_tp_demap":                   # K18: (llr, x)
        # x after the IDFT within 1e-4, the LLRs within 1e-3, of their
        # largest magnitudes
        return max(close(out[1], ref[1], f"{case} x"),
                   close(out[0], ref[0], f"{case} llr", rtol=1e-3))
    if name == "pucch_f3_demap":                   # K19
        return close(out, ref, f"{case} llr", rtol=1e-3)
    if name == "tdl_channel":                      # K20: (rx, H)
        return max(close(out[1], ref[1], "K20 H"),
                   close(out[0], ref[0], "K20 rx"))
    if name == "prach_demod":                      # K21
        return close(out, ref, f"{case} bins")
    if name in ("bfp_compress", "bfp_decompress"):  # K23, K24: bit-exact
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(outs, refs):
            if (o is None) != (r is None) or (o is not None and not torch.equal(
                    _bits(o), _bits(r))):
                raise AssertionError(f"{case} differs from its twin")
        return 0.0
    if name == "control_map":                      # K27: bit for bit
        if not torch.equal(_bits(out), _bits(ref)):   # -0.0 is not +0.0
            raise AssertionError(
                f"{case} differs from its twin by {(out - ref).abs().max()}")
        return 0.0
    if name in DU_KERNELS + ALLOC_KERNELS:         # K25-K28: bit-exact
        if not torch.equal(out, ref):
            raise AssertionError(
                f"{case} differs from its twin by {(out - ref).abs().max()}")
        return 0.0
    if name in ("pdsch_map_prg", "rate_match"):    # K22, K32: bit-exact
        if not torch.equal(out, ref):
            raise AssertionError(
                f"{case} differs from its twin by {(out - ref).abs().max()}")
        return 0.0
    if name in ("ulsch_demux", "polar_scl_decode"):  # K17, K29: bit-exact
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{case} differs from its twin")
        return 0.0
    if name in UE_KERNELS + LAST_KERNELS:          # K33-K36: bit-exact
        if not torch.equal(_bits(out), _bits(ref)):
            raise AssertionError(f"{case} differs from its twin")
        return 0.0
    if name == "cfo_rotate":                       # K30: sincosf vs sin, cos
        return close(out, ref, case, rtol=1e-6)
    if name == "amplitude_control":                # K31
        # samples within 1e-6 of max|ref|; the clipped share equal, the
        # peak within 1e-6 dB, mean power and PAPR within 1e-5 dB (the
        # kernel sums in float64 per CTA, the twin's mean in float32)
        (y, m), (y_ref, m_ref) = out, ref
        err = close(y, y_ref, f"{case} samples", rtol=1e-6)
        got = [float(getattr(m, k)) for k in AMP_METRICS]
        want = [float(getattr(m_ref, k)) for k in AMP_METRICS]
        if (got[3] != want[3] or abs(got[1] - want[1]) > 1e-6
                or abs(got[0] - want[0]) > 1e-5
                or abs(got[2] - want[2]) > 1e-5):
            raise AssertionError(f"{case} metrics {got} vs {want}")
        return err
    if name == "rate_dematch":                     # K2: bit-exact
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{case} differs from its twin")
        return float((out[1] - ref[1]).abs().max())
    bits, soft, iters = out                        # K1: per slot
    bits_ref, soft_ref, iters_ref = ref
    k = case_args[-1]
    ok = crc_check(bits[..., :k], "crc24B")
    ok_ref = crc_check(bits_ref[..., :k], "crc24B")
    if not (torch.equal(bits, bits_ref) and torch.equal(ok, ok_ref)
            and torch.equal(iters.cpu(), iters_ref.cpu())):
        raise AssertionError(
            f"{case}: K1 differs from its twin: bits "
            f"{int((bits != bits_ref).sum())} iters {iters.tolist()} vs "
            f"{iters_ref.tolist()}")
    if case == "ldpc_decode" and int(iters) < 2:
        raise AssertionError("K1 phase did not exercise more than one sweep")
    print(f"{case}: {case_args[3]} layers, sweeps {iters.tolist()}, "
          f"{int(ok.sum())}/{ok.numel()} CB CRCs pass, soft LLRs' largest "
          f"difference {float((soft - soft_ref).abs().max()):.3g}", flush=True)
    return float((bits != bits_ref).sum())


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, for bit-exact comparisons of floats."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


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
    name = CASE_KERNEL.get(name, name)
    if name == "pucch_f0_detect":                  # K12: 8 per complex MAC
        grid, cfg, refs = args[:3]
        res = math.prod(grid.shape[:-2]) * cfg.nof_symbols * 12
        return (res * c64 + nbytes(refs) + nbytes(out),
                8.0 * refs.shape[0] * res + 4.0 * res)
    if name == "pucch_f2_demap":                   # K13: ~11 per port, RE
        # per slot the data REs on every port, the coefficients of the
        # data subcarriers (8 of each PRB's 12) and the noise read and the
        # LLRs written once (the Gold sequence is a function of c_init,
        # not an input)
        grid, coeffs, noise, cfg = args
        n_re = 8 * cfg.nof_rb * cfg.nof_symbols
        nb = grid.numel() // math.prod(grid.shape[-3:])
        p = grid.shape[-3]
        return (nb * p * (n_re + 8 * cfg.nof_rb) * c64 + nbytes(noise)
                + nbytes(out), nb * n_re * (11.0 * p + 20))
    if name == "short_block_detect":               # K14: see below
        # per codeword: E adds to fold the LLRs over the code's period Q
        # (the code is periodic), 2 E for the norm, the 2^K correlations of
        # the Q folded sums at the cheaper of Q adds each and a K-stage
        # Walsh-Hadamard transform (K adds each), 2^K compares for the argmax
        llr, k, qm = args
        e = llr.shape[-1]
        q = short_block._fold_period(short_block._period(k, qm))
        words = llr.numel() // e
        return (nbytes(llr) + nbytes(out),
                words * (3.0 * e + (min(q, k) + 1) * (1 << k)))
    if name == "polar_decode":                     # K15: ~3 N log2 N
        llr, code = args[0], args[1]
        return (nbytes(llr) + nbytes(out) + 4 * code.big_n,
                3.0 * code.big_n * code.n * llr.shape[0])
    if name == "ofdm_demodulate":                  # K4: FFT + 6 per bin
        # the S windows of N samples a row (not the CP before them) read
        nsc, n = args[1], args[2]
        ffts = math.prod(out.shape[:-1])            # rows x S
        return (ffts * n * c64 + nbytes(out),
                fft_ops(n, ffts) + 6.0 * ffts * nsc)
    if name == "pusch_demap":                      # K3: ~230 per RE
        grid, coeffs, sym, sc = args[:4]
        n_re = sym.numel()
        nb = grid.numel() // math.prod(grid.shape[-3:])     # slots
        return (nb * n_re * grid.shape[-3] * c64 + nbytes((coeffs, sym, sc))
                + nbytes(out), 230.0 * n_re * nb)
    if name == "pusch_demap_lxn":                  # K16
        # per RE: 8 per complex MAC of G and z over the ports, ~30 L^3 for
        # the LDL^H solve, A^-1 and (MMSE) A^-1 G A^-1, and per layer and
        # axis 3 per PAM level of the demap
        grid, coeffs, sym, sc = args[:4]
        n_re, p, n_l = sym.numel(), grid.shape[0], coeffs.shape[1]
        levels = 2 ** (BITS_PER_SYMBOL[args[7]] // 2)
        return (n_re * p * c64 + nbytes((coeffs, sym, sc)) + nbytes(out),
                n_re * (8.0 * p * (n_l * (n_l + 1) // 2 + n_l)
                        + 30.0 * n_l ** 3 + 2 * n_l * 3.0 * levels))
    if name == "pusch_tp_demap":                   # K18
        # per RE: 8 per complex MAC of the 1 x N combining over the ports
        # and ~10 for the solve; per block the M-point IDFT at an FFT's
        # count, 5 M log2 M (the kernel's mixed-radix Stockham FFT does
        # about that); 3 per PAM level per axis of the demap
        grid, coeffs, plan, noise, hops, m = args[:6]
        n_re, p = plan.shape[-1], grid.shape[0]
        qm = BITS_PER_SYMBOL[args[7]]
        levels = 2 ** max(qm // 2, 1)
        return (n_re * p * c64 + nbytes((coeffs, plan, noise, hops))
                + m * c64 + n_re * qm + nbytes(out),
                n_re * (8.0 * p + 10 + 6.0 * levels) + fft_ops(m, n_re // m))
    if name == "pucch_f3_demap":                   # K19: as K18
        grid, coeffs, noise, cfg = args
        m, p = 12 * cfg.nof_rb, grid.shape[0]
        n_data = len(pucch._f3_symbol_split(cfg)[1])
        return (n_data * m * p * c64 + nbytes((coeffs, noise)) + m * c64
                + out.numel() + nbytes(out),
                n_data * m * (8.0 * p + 10 + 12) + fft_ops(m, n_data))
    if name == "ulsch_demux":                      # K17: a sign per bit
        llr = args[0]
        n = sum(o.numel() for o in out)
        return (nbytes(llr) + llr.numel() + 5 * n + nbytes(out), float(n))
    if name == "rate_dematch":                     # K2: an add per soft bit
        if len(args) < 11:        # one codeblock per row, no soft buffer
            return nbytes(args[0]) + nbytes(out), float(args[0].numel())
        return nbytes((args[0], args[10])) + nbytes(out), float(
            args[10].numel())
    if name == "ldpc_decode":                      # K1: 8 per edge per sweep
        # the sweeps this run's data took, per slot of a slot axis
        llr, bg, z, rows = args[0], args[1], args[2], args[3]
        sweeps = sum(int(v) for v in out[2].reshape(-1))
        return (nbytes(llr) + nbytes(out),
                8.0 * _edges(bg, z, rows) * llr.shape[-2] * sweeps)
    if name == "dlsch_encode":                     # K5: an XOR per edge + CRC
        tb, bg = args
        c = out.shape[-2] * (out.shape[0] if out.ndim == 3 else 1)
        z = out.shape[-1] // (66 if bg == 1 else 50)
        return (nbytes(tb) + nbytes(out),
                float(_edges(bg, z, 46 if bg == 1 else 42) * c
                      + 2 * tb.numel()))
    if name == "tdl_channel":                      # K20
        # H: 8 per complex MAC over the taps; rx: 8 per MAC over the TX
        # ports; 3 per RE for |rx|^2, 4 for the noise add
        tx, cfg, gains, noise = args
        r, t, d = gains.shape
        s, k = tx.shape[1], tx.shape[2]
        return (nbytes((tx, gains, noise)) + d * k * c64 + nbytes(out),
                8.0 * r * t * k * d + 8.0 * r * t * s * k + 7.0 * r * s * k)
    if name == "bfp_compress":                     # K23: ~12 per real value
        iq = args[0]
        return nbytes(iq) + nbytes(out), 12.0 * 2 * iq.numel()
    if name == "bfp_decompress":                   # K24: ~8 per real value
        # the sections' records and table (or exp and mant) read once, the
        # REs they cover written once
        if args[1].shape[-1] == len(bfp.TABLE_COLUMNS):
            covered = 12 * int(args[1][:, 4].sum())
            return nbytes(args) + covered * c64, 8.0 * 2 * covered
        return nbytes(args) + nbytes(out), 8.0 * 2 * out.numel()
    if name == "prach_demod":                      # K21
        # an N_u-point FFT per port and repetition gives the L_ra bins (the
        # kernel's direct sum does 8 L_ra N_u, the function needs no more)
        ports, reps, l_ra = out.shape
        n_u = prach_demod.geometry(args[1], args[2], args[4], args[6])[1]
        return (ports * reps * n_u * c64 + nbytes(out),
                fft_ops(n_u, ports * reps))
    if name in ("pdsch_map", "pdsch_map_repetition",
                "pdsch_map_prg"):                  # K6, K22
        # per slot: the window's distinct codeblock bytes (min(E_r, N_nf) a
        # codeblock), each data RE's grid value on every port read and
        # written; the RE plan and the precoder once (the Gold sequence is
        # a function of c_init, not an input); per RE 8 L P for the
        # precode, 2 P for the grid add, a XOR per bit
        grid, cbs, e_sizes, rv, _, bg, z, k_prime, k, _, n_l, sym = args[:12]
        n_ref = args[16] if len(args) > 16 else 0
        nb = grid.numel() // math.prod(grid.shape[-3:])
        p, n_re, g = grid.shape[-3], sym.numel(), sum(e_sizes)
        n_nf = ldpc_rate_match._window_plan(rv, bg, z, k_prime, k,
                                            cbs.shape[-1], n_ref)[2]
        window = sum(min(e, n_nf) for e in e_sizes)
        return (nb * (window + 2 * c64 * p * n_re) + 8 * n_re
                + nbytes(args[13]), nb * (n_re * (8.0 * n_l + 2) * p + g))
    if name == "ofdm_modulate":                    # K7: IFFT + 6 per sample
        grid, n = args[0], args[1]
        return (nbytes(grid) + nbytes(out),
                fft_ops(n, math.prod(grid.shape[:-1])) + 6.0 * out.numel())
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
        # per slot the occasion's REs on every port read once; of each
        # hop's weights a_dm on its DM-RS symbols, ph and w_da on its data
        # symbols (a weight the slots share once); the results written
        # once; 8 per complex MAC of the despread, 14 per term of the
        # matched filter
        grid, common, weights = args[:3]
        nb = grid.numel() // math.prod(grid.shape[-3:])
        p, u = grid.shape[-3], weights[0][0].shape[-3]
        w_bytes = ops = 0.0
        for (prb, s0, nsym), (a_dm, ph, w_da) in zip(
                pucch._f1_hops(common), weights):
            n_dm, n_da = map(len, pucch._split(s0, nsym))
            w_bytes += (nbytes(a_dm) * n_dm + nbytes((ph, w_da)) * n_da
                        ) / nsym
            ops += nb * u * p * 12 * (8.0 * n_dm + 14.0 * n_da)
        res = p * common.nof_symbols * 12
        return nb * res * c64 + w_bytes + nbytes(out), ops
    if name == "srs_estimate":                     # K11
        # per slot the comb's REs on every rx port read once, the TA and
        # RSRP once; the sequences [L, K] once; the outputs written once.
        # Per (rx port, subcarrier): the symbol sum, the ramp (~20), 8 per
        # complex MAC of the L correlations and of the reconstruction, 4
        # for the residual's energy
        grid, cfg = args[:2]
        nb = grid.numel() // math.prod(grid.shape[-3:])
        p, k = grid.shape[-3], cfg.seq_len
        n_l, n_s = cfg.nof_ports, cfg.nof_symbols
        return (nb * (p * n_s * k * c64 + 4 * (p + 1)) + n_l * k * c64
                + nbytes(out),
                nb * p * k * (2.0 * (n_s - 1) + 20 + 24.0 * n_l + 6))
    if name == "rs_map":                           # K25: 8 per term
        # each target read and written once a slot, its 16-byte records
        # and the values once (one plan per 32 PDUs)
        grid, items, values = args
        nb = grid.numel() // math.prod(grid.shape[-3:])
        t = n = 0
        for c in range(0, len(items), _build.RS_MAX_SOURCES):
            plan = dl_rs.rs_plan(items[c:c + _build.RS_MAX_SOURCES],
                                 tuple(grid.shape[-3:]))
            t, n = t + plan["tgt"].size, n + plan["src"].size
        return 16 * t * nb + nbytes(values) + 16 * n, 8.0 * n * nb
    if name == "dmrs_map":                         # K26: 8 per layer term
        # the DM-RS REs of the layers' CDM groups on every port read and
        # written once, the pilots, matrices and PRB table once; 8 per
        # layer at its CDM group's REs on every port
        grid, pilots, w, ports, symbols, prbs = args[:6]
        config_type = args[7] if len(args) > 7 else 1
        nb = grid.numel() // math.prod(grid.shape[-3:])
        p = grid.shape[-3]
        res = (len(symbols) * len(prbs) * dl_rs.PILOTS_PER_PRB[config_type]
               * len({q >> 1 for q in ports}) * p)
        return (16 * res * nb + nbytes((pilots, w)) + 4 * len(prbs),
                8.0 * len(symbols) * pilots.shape[-1] * p * len(ports) * nb)
    if name == "control_llrs":                     # K28: ~7 per LLR
        # per RE: its grid value and offset read, its two LLRs written;
        # per LLR its Gold bit; per codeword its first RE and noise
        # variance; 2 subtractions, 2 squares, a difference, a division
        # and a sign per LLR
        grid, items = args
        plan = dl_control.rx_plan(items, grid.numel())
        nre = plan["re"].size
        return (12 * nre + nbytes(out) + plan["gold"].nbytes
                + 8 * len(items) + 4, 7.0 * out.numel())
    if name == "control_map":                      # K27
        # every grid RE (and port) a PDU's patch rectangle covers read and
        # written once, however many PDUs add to it (K27's plan lists
        # each once); per PDU the map (E x W words), constants, patch
        # plan, base, payload and pilots read once; 2 W + 2 per coded bit,
        # 2 per RE and port
        grid, inputs, items_fn = args
        nb = grid.numel() // math.prod(grid.shape[-3:])
        items = items_fn(grid, inputs)
        ports = control_ports(grid, items)
        b = 16.0 * nb * sum(ports.values())
        ops = 2.0 * nb * sum(ports.values())
        for it in items:
            e, words = it.rows.shape
            b += (sum(x.numel() for x in it.bits)
                  + nbytes((it.rows, it.offset, it.index, it.base,
                            it.pilots)))
            ops += nb * e * (2.0 * words + 2)
        return b, ops
    if name == "polar_scl_decode":                 # K29
        # ~3 L N log2 N per codeword for f, g and the partial sums of the L
        # paths, and at each information leaf the rank of 2L candidates
        # (4 L^2 comparisons); the LLRs read once, the messages written
        llr, code, size = args[:3]
        info = int((np.asarray(code.frozen_mask) == 0).sum())
        return (nbytes(llr) + nbytes(out),
                llr.shape[0] * (3.0 * size * code.big_n * code.n
                                + 4.0 * size * size * info))
    if name == "rate_match":                       # K32: ~8 per output bit
        # the window's distinct positions read once (min(E_c, N_nf) per
        # codeblock), the E_c bits written once
        cw, e_sizes = args[:2]
        if isinstance(e_sizes, int):
            e_sizes = (e_sizes,) * cw.shape[0]
        idx = ldpc_rate_match.gather_index(e_sizes, *args[2:8], cw.shape[1],
                                           *args[8:])
        return np.unique(idx).size + nbytes(out), 8.0 * out.numel()
    if name == "cfo_rotate":                       # K30: sincos + product
        return 2 * nbytes(args[0]), 26.0 * args[0].numel()
    if name == "amplitude_control":                # K31: ~20 per sample
        return 2 * nbytes(args[0]) + 16, 20.0 * args[0].numel()
    if name == "polar_encode":                     # K33
        # the message bits read and the transmitted bits written once; an
        # XOR per butterfly (N/2 log2 N), a write per info and PC bit and a
        # read per transmitted bit
        msg, code = args
        return (nbytes(msg) + nbytes(out), msg.shape[0] * (
            code.big_n / 2 * code.n + code.k + code.e))
    if name == "short_block_encode":               # K34: K + 2 per bit
        bits = args[0]
        return nbytes(bits) + nbytes(out), out.numel() * (bits.shape[1] + 2.0)
    if name == "llr_quantize":                     # K35: 4 per LLR
        return nbytes(args[0]) + nbytes(out), 4.0 * out.numel()
    if name == "llr_dequantize":                   # K35: a division per LLR
        return nbytes(args[0]) + nbytes(out), float(out.numel())
    if name == "ldpc_check_parity":                # K36: an XOR per edge lane
        bits, bg, z = args
        return (nbytes(bits) + nbytes(out),
                float(bits.shape[0] * _edges(bg, z, len(get_graph(bg, z).rows))))
    raise KeyError(name)


def control_ports(grid: torch.Tensor, items) -> dict:
    """Grid RE (offset l * K + k in the [S, K] plane) -> the ports K27
    adds to there: the union of the PDUs' patch rectangles, on every port
    where a PDU spans them all, else on port 0."""
    P, K = grid.shape[-3], grid.shape[-1]
    ports = {}
    for it in items:
        p = P if it.all_ports else 1
        for l in range(it.l0, it.l0 + it.h):
            for k in range(it.sc0, it.sc0 + it.w):
                ports[l * K + k] = max(ports.get(l * K + k, 0), p)
    return ports


def bound(name: str, args: tuple, out) -> dict:
    """The least time the card could take for the kernel's work."""
    b, ops = work(name, args, out)
    t_bytes, t_ops = b / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_phases(cases: dict, library: dict | None = None) -> dict:
    """Each kernel against its twin; all but the repetition case timed.
    ``library`` names, per case, the PyTorch call timed as ``library_ms``:
    one that computes the same function (K35's dequantize: ``torch.div``)
    or a stage of it (the DFT-s-OFDM kernels' IDFT: ``torch.fft.ifft`` on
    the same number of blocks; a GF(2) stage as ``torch.matmul``); a case
    it does not name has null."""
    results = {}
    for name, (fn, ref_fn, args) in cases.items():
        out = fn(*args)
        err = compare(name, out, ref_fn(*args), args)
        lib = (library or {}).get(name)
        results[name] = dict(max_abs_err=err,
                             ms=median_ms(lambda: fn(*args)),
                             plain_ms=median_ms(lambda: ref_fn(*args)),
                             **bound(name, args, out),
                             library_ms=median_ms(lib) if lib else None)
        if name in HOST_TIMED:
            calls = {"kernel": lambda: fn(*args)}
            if name not in HOST_KERNEL_ONLY:
                yard = ("library", lib) if lib else (
                    "plain", lambda: ref_fn(*args))
                calls[yard[0]] = yard[1]
            print(host_path(name, calls), flush=True)
            if name in PARENT_LDPC:
                dev_us, host, ev = PARENT_LDPC[name]
                print(f"{name} parent kernel: device {dev_us:.2f} us, host "
                      f"{host:.2f} us per call, events {ev:.4f} ms; bound "
                      f"{results[name]['bound_ms'] * 1e3:.3f} us "
                      f"({results[name]['bound_by']})", flush=True)
    return results


def host_path(name: str, calls: dict) -> str:
    """Each call's host µs (the enqueue alone; median and quartiles of
    HOST_CALLS), events (median of 20) and device µs (profiler) per call:
    a kernel's wrapper and its library call or plain twin."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    parts = []
    for which, f in calls.items():
        host = launch_profile.host_us(f, HOST_CALLS)
        dev = launch_profile.device_us(f, TRACE_DIR / f"{name}.json")
        parts.append(f"{which} host {host['median']:.2f} us per call "
                     f"(q1 {host['q1']:.2f}, q3 {host['q3']:.2f}), events "
                     f"{launch_profile.event_ms(f):.4f} ms, device "
                     f"{dev:.2f} us")
    return f"{name} host path: " + "; ".join(parts)


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
            "harq_bits", "harq_ack_bits", "harq_ack_valid", "csi1_bits",
            "csi1_valid", "csi2_bits", "csi2_valid", "uci_bits", "valid"}


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


def ofdm_cases(prefix: str, dev) -> dict:
    """K4's (``prefix`` "ofdm_demodulate_") or K7's ("ofdm_modulate_")
    further cases of ``flagship.ofdm_profile_cases`` -- a batch of 4, N
    1024, the largest window offset (K4), extended CP, N 1536 -- from a
    generator of their own (the phases' draws stay as they were)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 24)
    return {k: v for k, v in flagship.ofdm_profile_cases(gen, dev).items()
            if k.startswith(prefix)}


def ofdm_library(cases: dict) -> dict:
    """K4's and K7's library calls: ``torch.fft`` of the FFT stage
    (``launch_profile.ofdm_fft_library``) per case."""
    return {name: launch_profile.ofdm_fft_library(name, args)
            for name, (_, _, args) in cases.items()
            if CASE_KERNEL.get(name, name) in ("ofdm_demodulate",
                                               "ofdm_modulate")}


def launch_row(name: str, args: tuple) -> str | None:
    """The launch count one call of a K3, K4, K6 (K22), K7, K10, K11, K12,
    K13, K14 or K26 case adds to: its kernel's row, its ``_batch`` row with
    a slot axis, K22's row with a PRG table; None for the other kernels."""
    kind = CASE_KERNEL.get(name, name)
    if kind in ("ofdm_demodulate", "ofdm_modulate"):
        rank = 2 if kind == "ofdm_demodulate" else 3
        return kind + ("_batch" if args[0].ndim > rank else "")
    if kind in ("pdsch_map", "pdsch_map_prg"):
        return ("pdsch_map_batch" if args[0].ndim == 4 else "pdsch_map_prg"
                if len(args) > 14 and args[14] else "pdsch_map")
    if kind in ("pusch_demap", "pucch_f1_detect", "pucch_f2_demap",
                "pucch_f0_detect", "srs_estimate"):
        return kind + ("_batch" if args[0].ndim == 4 else "")
    if kind == "dmrs_map":
        return kind
    if kind == "short_block_detect":
        return kind + ("_batch" if args[0].ndim == 3 else "")
    return None


def one_launch_a_call(cases: dict) -> None:
    """K3, K4, K6 (K22), K7, K10, K11, K12, K13, K14 and K26 launch once a
    call: each of their cases adds one to its kernel's count
    (:func:`launch_row`) and to no other."""
    rows = set()
    for name, (fn, _, args) in cases.items():
        row = launch_row(name, args)
        if row is None:
            continue
        before = {k.name: k.launches for k in kernels.REGISTRY.values()}
        fn(*args)
        added = {k.name: k.launches - before[k.name]
                 for k in kernels.REGISTRY.values()
                 if k.launches != before[k.name]}
        if added != {row: 1}:
            raise AssertionError(f"{name}: launches {added} in one call")
        rows.add(row)
    print(f"{', '.join(sorted(rows))}: one launch a call on every case",
          flush=True)


def map_demap_cases(prefix: str, dev) -> dict:
    """K6's and K22's (``prefix`` "pdsch_map_") or K3's ("pusch_demap_")
    cases of ``flagship.map_demap_profile_cases`` at other shapes than the
    flagship slot's (which the phase takes from its slot) -- a batch of 4;
    K6 on slot F's interleaved plan, with n_ref and on the repetition
    shape; K22 on slot E's plan; K3 at 1 layer and on both hops of a
    hopping pi/2-BPSK PUSCH -- from a generator of their own (K6 on a copy
    of its grid)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 25)
    out = {}
    for k, (fn, ref, args) in flagship.map_demap_profile_cases(
            gen, dev).items():
        if k.startswith(prefix) and k in CASE_KERNEL:
            if k.startswith("pdsch_map"):
                fn, ref = flagship._map_on_copy(fn), flagship._map_on_copy(ref)
            out[k] = (fn, ref, args)
    return out


def pucch_cases(prefix: str, dev) -> dict:
    """K10's (``prefix`` "pucch_f1_detect_") or K13's ("pucch_f2_demap_")
    cases of ``flagship.pucch_profile_cases`` -- K10 with 3 and 12 users
    and a hop and over a batch of 4 with per-slot weights; K13 at 16 RB
    and over a batch of 4 -- from a generator of their own (the flagship
    entries are the phase's own)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 26)
    return {k: v for k, v in flagship.pucch_profile_cases(gen, dev).items()
            if k.startswith(prefix)}


def uci_cases(dev) -> dict:
    """K12's and K14's cases of ``flagship.uci_profile_cases`` -- K12 over
    a batch of 4 with per-slot references at 10 dB and on 1 port and 1
    symbol, K14 over a slot axis of 4 -- from a generator of their own (the flagship entries are phase
    4's own)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 27)
    return flagship.uci_profile_cases(gen, dev)


def srs_cases(dev) -> dict:
    """K11's cases of ``flagship.rs_profile_cases`` beyond the flagship's
    (which phase 1 takes from its slot): a batch of 4, 48 RB at comb 4
    with 4 SRS ports, and K = 1632 (272 RB, comb 2, 4 symbols, 4 ports),
    their TA and RSRP from K8 (K26's cases are phase 12's and 13's)."""
    return {k: v for k, v in flagship.rs_profile_cases(dev).items()
            if k in CASE_KERNEL and k.startswith("srs_noise")}


def rs_library(cases: dict) -> dict:
    """K11's, K25's and K26's library time: each case's named stage as one
    PyTorch call (``launch_profile.rs_stage``: K11's wideband
    ``torch.einsum``, K26's ``index_put_`` of its precoded pilots;
    ``launch_profile.rs_map_stage``: K25's ``index_put_`` of its weighted
    terms)."""
    return {name: (launch_profile.rs_map_stage(args)
                   if CASE_KERNEL.get(name, name) == "rs_map" else
                   launch_profile.rs_stage(name, args))
            for name, (_, _, args) in cases.items()
            if CASE_KERNEL.get(name, name) in ("srs_estimate", "dmrs_map",
                                               "rs_map")}


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

    cases = flagship.kernel_cases(slots[0][1], slots[0][2], gen, prach_in)
    cases.update(flagship.ldpc_decode_cases(cases, gen))
    cases.update(ofdm_cases("ofdm_demodulate_", dev))
    cases.update(map_demap_cases("pusch_demap_", dev))
    cases.update(pucch_cases("pucch_f1_detect_", dev))
    cases.update(srs_cases(dev))
    one_launch_a_call(cases)
    results = kernel_phases(cases, {
        "prach_detect": launch_profile.prach_idft_library(
            cases["prach_detect"][2]),
        **ofdm_library(cases), **rs_library(cases)})

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
    return results, launches, slots


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

    cases = flagship.dl_kernel_cases(slots[0])
    cases.update(flagship.dlsch_encode_cases(cases["dlsch_encode"][2][0],
                                             torch.Generator(dev)))
    cases.update(ofdm_cases("ofdm_modulate_", dev))
    cases.update(map_demap_cases("pdsch_map_", dev))
    one_launch_a_call(cases)
    results = kernel_phases(cases, {
        **{name: launch_profile.dlsch_library(*args)
           for name, (_, _, args) in cases.items()
           if name.startswith("dlsch_encode")},
        **ofdm_library(cases)})

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
    return results, launches, slots


def _launch_group(cond, reqs: tuple, start: int, phases: list, prach_in,
                  stride: int) -> list:
    """Stage STAGE_DEPTH slots' payloads (slots start .. start + depth - 1,
    phase j % N_PHASES) in one transfer, then launch each slot; returns
    [(slot index, phase, pending results)]."""
    dlr, ulr, txd = reqs
    grp = [(start + d) % flagship.N_PHASES
           for d in range(flagship.STAGE_DEPTH)]
    st = cond.stage_payloads([(dlr[g], txd[g]) for g in grp], stride=stride)
    out = []
    for kk, g in enumerate(grp):
        _, pend = cond.process_slot(dlr[g], ulr[g], st, kk, phases[g]["rx"],
                                    prach_fd=prach_in)
        out.append((start + kk, g, pend))
    return out


def harq_retransmission(cond, reqs: tuple, prach_in, stride: int,
                        dev) -> None:
    """Slot phase 5 at HARQ_SNR_DB, twice: rv 0 as new data, which must
    fail and leave its soft buffer in the conductor's pool, then rv 2 with
    new_data=False, which K2 combines with it and which must decode."""
    dlr, ulr, txd = reqs
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    i = 5
    tb = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, 2, flagship.PUSCH.tbs).astype(np.int8)).to(dev)
    st = cond.stage_payloads([(dlr[i], txd[i])] * 2, stride=stride)
    sweeps = []
    for k, (rv, new) in enumerate(((0, True), (2, False))):
        ul = dataclasses.replace(
            ulr[i], pusch=(dataclasses.replace(ulr[i].pusch[0], rv=rv),),
            pusch_harq=((HARQ_ID, new),))
        rx = flagship.channel(flagship.ue_samples(2 * i, tb, rv=rv), gen,
                              snr_db=HARQ_SNR_DB)
        _, pend = cond.process_slot(dlr[i], ul, st, k, rx, prach_fd=prach_in)
        crc = pend.resolve().crc[0]
        sweeps.append(int(crc.nof_ldpc_iterations))
        if rv == 0 and (crc.tb_crc_ok or (flagship.PUSCH.rnti, HARQ_ID)
                        not in cond.harq_pool._bufs):
            raise AssertionError("HARQ: rv 0 decoded alone; no combining")
    if not crc.tb_crc_ok:
        raise AssertionError("HARQ: rv 0 + rv 2 combined did not decode")
    print(f"conductor HARQ retransmission at {HARQ_SNR_DB} dB: rv 0 fails "
          f"({sweeps[0]} sweeps), rv 2 combined with its soft buffer "
          f"decodes ({sweeps[1]} sweeps)", flush=True)


def conductor_phases(dev, gen, rng, card) -> tuple:
    """K12-K15 against their twins, then the flagship slot through the FAPI
    conductor as bench.py:467-510 drives it: 10 slot phases, payloads
    staged 8 slots per transfer with stride = the largest layout, a warm-up
    over every phase, then CONDUCTOR_SLOTS slots each resolved RESOLVE_LAG
    slots behind the launch front."""
    t0 = time.perf_counter()
    kernels.reset_counts()
    phases = flagship.conductor_phases(rng, gen, dev)
    torch.cuda.synchronize()
    ue_launches = launched(UE_KERNELS)
    print(f"conductor UE side (the F2s' 6 bits by K34, 22 bits by K33): "
          f"launches {ue_launches}", flush=True)
    prach_in = flagship.prach_fd(dev, SEED)
    pay = flagship.dl_payloads(rng)
    reqs = ([flagship.dl_request(i) for i in range(flagship.N_PHASES)],
            [flagship.ul_request(i) for i in range(flagship.N_PHASES)],
            [flagship.tx_request(i, pay) for i in range(flagship.N_PHASES)])
    torch.cuda.synchronize()
    print(f"conductor inputs: {flagship.N_PHASES} slot phases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cases = flagship.conductor_kernel_cases(phases[0]["rx"], 0, gen)
    cases.update(pucch_cases("pucch_f2_demap_", dev))
    cases.update(uci_cases(dev))
    one_launch_a_call(cases)
    # K12's and K14's library time: their correlation stage as one
    # PyTorch call (launch_profile.uci_stage)
    results = kernel_phases(cases, {
        name: launch_profile.uci_stage(name, args)
        for name, (_, _, args) in cases.items()
        if CASE_KERNEL.get(name, name) in ("pucch_f0_detect",
                                           "short_block_detect")})

    cond = SlotConductor(flagship.CELL)
    if cond.device.type != "cuda":
        raise AssertionError(f"SlotConductor() chose {cond.device}")
    stride = max(cond.payload_layout(d)[1] for d in reqs[0])
    # warm-up: every phase's slot program and context, then checked
    warm = []
    for start in range(0, flagship.N_PHASES, flagship.STAGE_DEPTH):
        warm += _launch_group(cond, reqs, start, phases, prach_in, stride)
    for j, g, pend in warm:
        flagship.check_results(pend.resolve(), phases[g], f"warm-up slot {j}")
    torch.cuda.synchronize()

    kernels.reset_counts()
    t0 = time.perf_counter()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    pending, done = [], []
    for start in range(0, CONDUCTOR_SLOTS, flagship.STAGE_DEPTH):
        for item in _launch_group(cond, reqs, start, phases, prach_in,
                                  stride):
            pending.append(item)
            if len(pending) > RESOLVE_LAG:
                j, g, pend = pending.pop(0)
                done.append((j, g, pend.resolve()))
    end.record()
    for j, g, pend in pending:
        done.append((j, g, pend.resolve()))
    torch.cuda.synchronize()
    host_us = 1e6 * (time.perf_counter() - t0) / CONDUCTOR_SLOTS
    launches = launched(UL_KERNELS + DL_KERNELS + UCI_KERNELS)
    for j, g, res in done:
        flagship.check_results(res, phases[g], f"conductor slot {j}")
    span_us = 1e3 * begin.elapsed_time(end) / CONDUCTOR_SLOTS
    print(f"conductor slot (DL + UL with PUSCH, F0, F1, 2 x F2, PRACH, SRS): "
          f"{len(done)} slots ok, {span_us:.1f} us per slot by CUDA events "
          f"(the device span of the slots' launches over their count), "
          f"{host_us:.1f} us per slot on the host clock with staging and "
          f"resolve, card {card}", flush=True)

    harq_retransmission(cond, reqs, prach_in, stride, dev)

    # one steady-state process_slot with every synchronizing op an error
    dlr, ulr, txd = reqs
    st = cond.stage_payloads([(dlr[1], txd[1])], stride=stride)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, pend = cond.process_slot(dlr[1], ulr[1], st, 0, phases[1]["rx"],
                                    prach_fd=prach_in)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    gpu = pend.resolve()
    flagship.check_results(gpu, phases[1], "sync-free slot")
    print("conductor sync-free steady-state process_slot: ok", flush=True)

    # the same requests through the port's conductor on the CPU twins
    cpu = SlotConductor(flagship.CELL, device="cpu")
    st = cpu.stage_payloads([(dlr[1], txd[1])], stride=stride)
    _, pend = cpu.process_slot(dlr[1], ulr[1], st, 0, phases[1]["rx"].cpu(),
                               prach_fd=_to_cpu(prach_in))
    # 1e-3: the EVM from K3's LLRs, as compare_ul; the F0 metric's noise
    # term (energy - max corr) loses digits at 30 dB
    convert.slot_results(pend.resolve(), gpu, rtol=1e-3)
    print("conductor SlotResults vs the same requests on the CPU twins: ok",
          flush=True)
    scenario = dict(phases=phases, reqs=reqs, prach_in=prach_in,
                    stride=stride, pay=pay)
    return results, {**launches, **ue_launches}, scenario


def mu_conductor(slots: list, prach_in, rng, card) -> None:
    """The two-UE slots' UL requests beside the flagship DL through the FAPI
    conductor: every slot staged in one transfer, a warm-up pass, then a
    pass resolved RESOLVE_LAG slots behind the launch front; each slot must
    return both CRCs with the exact payloads and UE B's UCI from its PUSCH
    as sent.  Both UL kernels of the slice must launch in that pass."""
    cond = SlotConductor(flagship.CELL)
    pay = flagship.dl_payloads(rng)
    n = len(slots)
    dlr = [flagship.dl_request(i) for i in range(n)]
    ulr = [flagship.mu_ul_request(i, s["uci"]["ri"])
           for i, s in enumerate(slots)]
    stride = max(cond.payload_layout(d)[1] for d in dlr)

    def run_pass(lag: int) -> float:
        st = cond.stage_payloads([(d, flagship.tx_request(i, pay))
                                  for i, d in enumerate(dlr)], stride=stride)
        t0 = time.perf_counter()
        pending = []
        for i in range(n):
            _, pend = cond.process_slot(dlr[i], ulr[i], st, i, slots[i]["rx"],
                                        prach_fd=prach_in)
            pending.append((i, pend))
            if len(pending) > lag:
                j, p = pending.pop(0)
                flagship.check_mu_results(p.resolve(), slots[j],
                                          f"conductor two-UE slot {j}")
        for j, p in pending:
            flagship.check_mu_results(p.resolve(), slots[j],
                                      f"conductor two-UE slot {j}")
        return 1e6 * (time.perf_counter() - t0) / n

    run_pass(0)                                    # warm-up, checked
    torch.cuda.synchronize()
    kernels.reset_counts()
    host_us = run_pass(RESOLVE_LAG)
    launched(MU_KERNELS)
    print(f"conductor two-UE slot (flagship DL + UL with 2 PUSCH, UCI on "
          f"PUSCH, F1, PRACH, SRS): {n} slots ok, both TBs and UE B's "
          f"HARQ-ACK/CSI1/CSI2 as sent, {host_us:.1f} us per slot on the "
          f"host clock with staging and resolve, card {card}", flush=True)


def part2_feedback(slots: list) -> None:
    """UE B through ``pusch.process_with_part2_feedback`` once per RI: the
    receiver's PDU carries o_csi2 = 0, the part-2 size comes from the
    decoded part 1, and the CSI2 payload must come back exact."""
    cell = flagship.MU.cell
    sizes = []
    for ri in (0, 1):
        i, s = next((i, s) for i, s in enumerate(slots)
                    if s["uci"]["ri"] == ri)
        grid = ofdm.demodulate_slot(s["rx"], cell.nof_sc, cell.dft_size,
                                    cell.numerology, cell.cp, 0,
                                    cell.center_freq_hz)
        cfg = dataclasses.replace(flagship.MU.pusch_b,
                                  slot_in_frame=(2 * i) % 20)
        res = pusch.process_with_part2_feedback(
            grid, cfg, flagship.PART2, dmrs_cinits=s["ctx"]["pusch"][1])
        uci = s["uci"]
        if not (bool(res.tb_crc_ok) and torch.equal(res.tb_bits, s["tb_b"])):
            raise AssertionError(f"part-2 feedback, RI {ri}: TB not decoded")
        for key, sent in (("harq_ack", uci["ack"]), ("csi1", uci["csi1"]),
                          ("csi2", uci["csi2"])):
            got = getattr(res, f"{key}_bits")
            if not (bool(getattr(res, f"{key}_valid"))
                    and np.array_equal(got.cpu().numpy(), sent)):
                raise AssertionError(f"part-2 feedback, RI {ri}: {key} "
                                     f"{got.cpu().numpy()} vs {sent}")
        sizes.append(res.csi2_bits.numel())
    print(f"part-2 feedback (o_csi2 unknown to the receiver): CSI2 of "
          f"{sizes[0]} and {sizes[1]} bits from RI 0 and 1, exact",
          flush=True)


def mu_phases(dev, gen, rng, card) -> tuple:
    """K16, K17 and K8 at delta 1 against their twins, then the two-UE UL
    slot (4-layer MMSE PUSCH + 1-layer PUSCH with HARQ-ACK and CSI parts 1
    and 2, PUCCH F1, PRACH, SRS) through ``ul_slot_fn``, the conductor and
    the part-2 feedback path."""
    t0 = time.perf_counter()
    kernels.reset_counts()
    slots = flagship.make_mu_slots(NOF_SLOTS + 2, rng, gen, dev)
    torch.cuda.synchronize()
    ue_launches = launched(UE_KERNELS)
    softs = flagship.mu_soft_buffers(dev)
    prach_in = flagship.prach_fd(dev, SEED)
    print(f"two-UE transmitters: {len(slots)} slots in "
          f"{time.perf_counter() - t0:.1f} s (UE B's ACK and CSI1 by K34, "
          f"CSI2 by K33: launches {ue_launches})", flush=True)
    cases = flagship.mu_kernel_cases(slots[0], gen)
    results = kernel_phases(cases, {
        name: launch_profile.lxn_solve_library(args)
        for name, (_, _, args) in cases.items()
        if name.startswith("pusch_demap_lxn")})

    def run(s):
        return flagship.mu_program(s["uci"]["ri"])(s["rx"], prach_in, softs,
                                                   s["ctx"])

    # Warm up both plans (one per part-2 size), then count launches over
    # NOF_SLOTS slots with fresh payloads and UCI.
    measured = slots[2:]
    for ri in (0, 1):
        s = next(s for s in slots if s["uci"]["ri"] == ri)
        flagship.check_mu_slot(run(s), s, f"warm-up RI {ri}")
    torch.cuda.synchronize()
    kernels.reset_counts()
    slot_ms, outs = [], []
    for s in measured:
        out, ms = timed(lambda: run(s))
        slot_ms.append(ms)
        outs.append(out)
    launches = launched(MU_PATH)
    for i, (s, out) in enumerate(zip(measured, outs)):
        flagship.check_mu_slot(out, s, f"two-UE slot {i}")
    ris = [s["uci"]["ri"] for s in measured]
    if set(ris) != {0, 1}:
        raise AssertionError(f"the slots' RIs {ris} miss a part-2 size")
    iters = [[int(r["nof_iterations"]) for r in o["pusch"]] for o in outs]
    mu = {k: launches[k] for k in MU_KERNELS}
    print(f"two-UE UL slot (4-layer MMSE PUSCH + 1-layer PUSCH with UCI + "
          f"F1 + PRACH + SRS): {len(outs)} slots ok (RIs {ris}), median "
          f"{1e3 * statistics.median(slot_ms):.1f} us per slot (CUDA "
          f"events), LDPC sweeps {iters}, launches {mu}, card {card}",
          flush=True)

    s = measured[0]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run(s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    flagship.check_mu_slot(out, s, "two-UE sync-free call")
    print("two-UE sync-free steady-state call: ok", flush=True)
    cpu = flagship.mu_program(s["uci"]["ri"])(
        s["rx"].cpu(), _to_cpu(prach_in), _to_cpu(softs), _to_cpu(s["ctx"]))
    compare_ul(out, cpu)
    print("two-UE slot (full result dict) vs plain twins on the CPU: ok",
          flush=True)
    mu_conductor(slots, prach_in, rng, card)
    part2_feedback(slots)
    return results, launches


# ---------------------------------------------------------------- phase 6

def _eager_slot(cond, dl, ul, staged, k, rx, prach_in):
    """process_slot's work through the phase's eager slot program (no
    graph): (tx_samples, PendingSlotResults)."""
    phase = cond.slot_phase(dl, ul, staged.stride)
    harq_meta, softs = cond._soft_buffers(ul, phase.soft_shapes)
    torch.cuda.current_stream().wait_event(staged.ready)
    blob = staged.buf[k * staged.stride:k * staged.stride + phase.total]
    tx, scalars, payload, new_softs = phase.run(blob, rx, tuple(prach_in),
                                                softs)
    return tx, cond._pending(ul, harq_meta, scalars, payload, new_softs)


def _graph_vs_eager(cond, dl, ul, staged, k, rx, prach_in, phase, where):
    """One slot through its graph and through the eager program on the
    same inputs: tx samples within 1e-4, SlotResults equal (bits exact,
    floats within 1e-3), and every indication as sent."""
    tx_g, pend_g = cond.process_slot(dl, ul, staged, k, rx, prach_fd=prach_in)
    tx_e, pend_e = _eager_slot(cond, dl, ul, staged, k, rx, prach_in)
    close(tx_g, tx_e, f"{where}: graph vs eager tx samples")
    res_g = pend_g.resolve()
    convert.slot_results(pend_e.resolve(), res_g, rtol=1e-3)
    flagship.check_results(res_g, phase, where)


def _replay_us(graph, n: int = 30) -> float:
    """Median device time of one replay of a captured graph (its static
    inputs as they are), by CUDA events."""
    times = []
    for _ in range(n):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        graph.graph.replay()
        end.record()
        end.synchronize()
        times.append(1e3 * begin.elapsed_time(end))
    return statistics.median(times)


def _timed_slots(launch, n: int, items: list) -> tuple:
    """Launch ``n`` slots (cycling ``items``), each resolved RESOLVE_LAG
    behind the launch front: (host us per slot, CUDA-event span us per
    slot, the results)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    pending, done = [], []
    for j in range(n):
        item = items[j % len(items)]
        pending.append((item, launch(*item)))
        if len(pending) > RESOLVE_LAG:
            it, pend = pending.pop(0)
            done.append((it, pend.resolve()))
    end.record()
    for it, pend in pending:
        done.append((it, pend.resolve()))
    torch.cuda.synchronize()
    host_us = 1e6 * (time.perf_counter() - t0) / n
    return host_us, 1e3 * begin.elapsed_time(end) / n, done


def graph_phase(scen: dict, gen, card) -> None:
    """Phase 6: each conductor slot phase as one CUDA graph against its
    eager slot program, a graph replayed on 3 differing slots, and graphed
    against eager us per slot."""
    phases, (dlr, ulr, txd) = scen["phases"], scen["reqs"]
    prach_in, stride = scen["prach_in"], scen["stride"]
    n = flagship.N_PHASES
    cond = SlotConductor(flagship.CELL)
    st = cond.stage_payloads([(dlr[g], txd[g]) for g in range(n)],
                             stride=stride)
    mem = []
    for g in range(n):
        _graph_vs_eager(cond, dlr[g], ulr[g], st, g, phases[g]["rx"],
                        prach_in, phases[g], f"graph phase {g}")
        mem.append(cond.graph_of(dlr[g], ulr[g], stride).nbytes)
    print(f"graph: {n} slot phases, each graph equal to its eager slot "
          f"program; memory reserved per capture {[m >> 20 for m in mem]} "
          f"MiB (first: the shared pool's growth), card {card}", flush=True)

    # one phase's graph on 3 slots of differing payloads and samples
    g = 1
    pay = scen["pay"]
    rng = np.random.default_rng(SEED + 6)
    st3 = cond.stage_payloads([(dlr[g], messages.TxDataRequest(
        slot=dlr[g].slot, pdsch_payloads=(pay["sch"][v],),
        pdcch_payloads=(pay["dci"][v],))) for v in range(3)], stride=stride)
    for j in range(3):
        tb = torch.as_tensor(rng.integers(0, 2, flagship.PUSCH.tbs).astype(
            np.int8)).to(phases[g]["rx"].device)
        uci = flagship.ue_uci(rng)
        rx = flagship.channel(flagship.ue_samples(2 * g, tb, uci), gen)
        _graph_vs_eager(cond, dlr[g], ulr[g], st3, j, rx, prach_in,
                        dict(tb=tb, uci=uci, rx=rx), f"graph replay {j}")
    graph = cond.graph_of(dlr[g], ulr[g], stride)
    missing = [k for k in ("dmrs_map", "control_map")
               if not graph.launches.get(k)]
    if missing:
        raise AssertionError(f"phase {g}'s graph does not launch {missing}")
    print(f"graph replays on 3 differing slots: each equal to the eager "
          f"program and decoded as sent ({graph.replays} replays of phase "
          f"{g}'s graph; K26 and K27 in it: "
          f"{ {k: graph.launches[k] for k in ('dmrs_map', 'control_map')} })",
          flush=True)

    # The DL branch on its own stream against DL after UL in one branch:
    # the same phase captured both ways, replays timed by CUDA events.
    phase = cond.slot_phase(dlr[g], ulr[g], stride)
    _, softs = cond._soft_buffers(ulr[g], phase.soft_shapes)
    ul_in = (phases[g]["rx"], tuple(prach_in), softs)
    dl_in = (st.buf[g * stride:g * stride + phase.total],)
    serial = SlotGraph((lambda u, d: (phase.ul(*u), phase.dl(*d)),),
                       ((ul_in, dl_in),))
    print(f"graph: one replay {_replay_us(graph):.1f} us with the DL branch "
          f"on its own stream, {_replay_us(serial):.1f} us with DL after UL "
          f"in one branch (CUDA events, median of 30 replays)", flush=True)

    items = [(g, g) for g in range(n)]
    graphed = _timed_slots(lambda g, k: cond.process_slot(
        dlr[g], ulr[g], st, k, phases[g]["rx"], prach_fd=prach_in)[1],
        GRAPH_PASSES * n, items)
    eager = _timed_slots(lambda g, k: _eager_slot(
        cond, dlr[g], ulr[g], st, k, phases[g]["rx"], prach_in)[1],
        GRAPH_PASSES * n, items)
    for (g, _), res in graphed[2] + eager[2]:
        flagship.check_results(res, phases[g], f"timed slot, phase {g}")
    print(f"graph: conductor slot {graphed[0]:.1f} us (host clock) / "
          f"{graphed[1]:.1f} us (CUDA events) per slot graphed, "
          f"{eager[0]:.1f} / {eager[1]:.1f} eager, {GRAPH_PASSES * n} slots "
          f"each, resolved {RESOLVE_LAG} behind, card {card}", flush=True)


# ---------------------------------------------------------------- phase 7

def batch_phase(scen: dict, card) -> dict:
    """Phase 7: the slot-batch mode on the flagship conductor scenario;
    returns the batched kernels' launches in one batch."""
    phases, (dlr, ulr, txd) = scen["phases"], scen["reqs"]
    stride = scen["stride"]
    grp = flagship.BATCH_PHASES
    dev = phases[0]["rx"].device
    cond = SlotConductor(flagship.CELL)
    prach_b = flagship.batch_prach_fd(dev, SEED)
    rx_b = torch.stack([phases[g]["rx"] for g in grp])
    slots = [(dlr[g], ulr[g]) for g in grp]

    def stage():
        return cond.stage_payloads([(dlr[g], txd[g]) for g in grp],
                                   stride=stride)

    def check(res, where):
        for b, (g, r) in enumerate(zip(grp, res)):
            flagship.check_results(r, phases[g], f"{where}, slot {b}",
                                   flagship.batch_preambles(b))

    st = stage()
    tx_b, pend_b = cond.process_slot_batch(slots, st, rx_b, prach_fd=prach_b)
    # each slot of the batch against process_slot on the same slot
    res_b = _batch_vs_slots(cond, slots, st, rx_b, prach_b, tx_b, pend_b,
                            "batch")
    check(res_b, "batch")
    rach = [[r.preamble_index for r in res.rach] for res in res_b]
    print(f"batch of {flagship.BATCH} (phases {list(grp)}): "
          f"{sum(r.crc[0].tb_crc_ok for r in res_b)}/{flagship.BATCH} TBs "
          f"exact, every indication as sent and equal to process_slot's "
          f"slot by slot, PRACH per slot {rach}", flush=True)

    # one batch on the main path, its launches counted
    st = stage()
    torch.cuda.synchronize()
    kernels.reset_counts()
    _, pend = cond.process_slot_batch(slots, st, rx_b, prach_fd=prach_b)
    check(pend.resolve(), "counted batch")
    launches = batch_counts(BATCH_LAUNCHES, "batch")
    dl_maps = launched(("dmrs_map", "control_map"))
    print(f"batch launches per batch of {flagship.BATCH}: {launches}, "
          f"K26/K27 {dl_maps}; no kernel launched once per slot; K1 runs "
          f"one device launch per sweep of all {flagship.BATCH} slots",
          flush=True)

    print(f"batch: {_timed_batches(cond, slots, stage, rx_b, prach_b, check)}"
          f", card {card}", flush=True)
    return launches


def _timed_batches(cond, slots, stage, rx_b, prach_b, check) -> str:
    """N_TIMED_BATCHES batches staged beforehand (one transfer each),
    launched back to back and resolved RESOLVE_LAG behind, each checked:
    each batch's device span by CUDA events around its launch (median over
    the batches, robust to a stall of the host) and the loop's host clock,
    per slot."""
    nb = len(slots)
    staged = [stage() for _ in range(N_TIMED_BATCHES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events, pending, done = [], [], []
    for st in staged:
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        pending.append(cond.process_slot_batch(slots, st, rx_b,
                                               prach_fd=prach_b)[1])
        end.record()
        events.append((begin, end))
        if len(pending) > RESOLVE_LAG:
            done.append(pending.pop(0).resolve())
    done += [p.resolve() for p in pending]
    torch.cuda.synchronize()
    host_us = 1e6 * (time.perf_counter() - t0) / (N_TIMED_BATCHES * nb)
    spans = [1e3 * b.elapsed_time(e) / nb for b, e in events]
    for res in done:
        check(res, "timed batch")
    return (f"{statistics.median(spans):.1f} us per slot by CUDA events "
            f"(median over {N_TIMED_BATCHES} batches of {nb}; "
            f"{min(spans):.1f}-{max(spans):.1f}), {host_us:.1f} us per slot "
            f"on the host clock with resolve, staged beforehand")


def _batch_vs_slots(cond, slots, st, rx_b, prach_b, tx_b, pend_b,
                    where: str) -> list:
    """Each slot of a batch against ``process_slot`` on the same slot: tx
    samples, scalars within 2e-4, payload exact, SlotResults within 2e-4.
    Returns the batch's SlotResults."""
    res_b = pend_b.resolve()
    for b, (dl, ul) in enumerate(slots):
        tx, pend = cond.process_slot(dl, ul, st, b, rx_b[b],
                                     prach_fd=tuple(p[b] for p in prach_b))
        close(tx_b[b], tx, f"{where} slot {b}: tx samples")
        torch.testing.assert_close(pend_b.scalars[b], pend.scalars,
                                   rtol=2e-4, atol=2e-4)
        if not torch.equal(pend_b.payload[b], pend.payload):
            raise AssertionError(f"{where} slot {b}: payload differs")
        convert.slot_results(pend.resolve(), res_b[b], rtol=2e-4)
    return res_b


def _last_graph(cond) -> SlotGraph:
    """The conductor's most recently used CUDA graph."""
    return next(reversed(cond._graphs._d.values()))


def batch_counts(want: dict, where: str) -> dict:
    """The batch rows' launch counts since the last reset; raises unless
    they are ``want`` and no kernel with a slot axis launched per slot."""
    counts = {k.name: k.launches for k in kernels.REGISTRY.values()}
    got = {n: counts[n] for n in BATCH_KERNELS if counts[n] or n in want}
    per_slot = {n: counts[n] for n in BATCHED + BATCHED_UL if counts[n]}
    if got != want or per_slot:
        raise AssertionError(f"{where} launches {got} (want {want}), per "
                             f"slot {per_slot}")
    return got


def _stack_tree(vals: list) -> tuple:
    """One argument's per-slot values -> (the argument with a slot axis on
    every tensor that differs across the slots, descending into tuples of
    tensors; a mask of the same shape, True where stacked)."""
    v0 = vals[0]
    if isinstance(v0, torch.Tensor):
        if all(v is v0 for v in vals):
            return v0, False
        return torch.stack(vals), True
    if isinstance(v0, tuple) and any(isinstance(x, (torch.Tensor, tuple))
                                     for x in v0):
        parts = [_stack_tree(list(z)) for z in zip(*vals)]
        return tuple(a for a, _ in parts), tuple(m for _, m in parts)
    return v0, False


def _slice_tree(arg, mask, index):
    """``arg[index]`` on every stacked tensor of an argument."""
    if mask is True:
        return arg[index]
    if isinstance(mask, tuple):
        return tuple(_slice_tree(a, m, index) for a, m in zip(arg, mask))
    return arg


def _stack_case(cases: list) -> tuple:
    """(fn, twin, args) over slots -> one case with the slot axis: the
    tensors that differ stack on a new axis (the mask says which), shared
    ones and the other arguments stay."""
    fn, ref_fn, _ = cases[0]
    stacked = [_stack_tree(list(vals)) for vals in zip(*(c[2] for c in cases))]
    return (fn, ref_fn, tuple(a for a, _ in stacked),
            tuple(m for _, m in stacked))


def _slot_of(obj, b: int):
    """Slot ``b`` of a batched kernel's output."""
    if isinstance(obj, torch.Tensor):
        return obj[b]
    if isinstance(obj, (tuple, list)):
        return tuple(_slot_of(o, b) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: _slot_of(getattr(obj, f.name), b)
                            for f in dataclasses.fields(obj)})
    return obj


# The kernels whose work count reads the slot axis of its arguments: what
# the slots share (the RE plan, a shared precoder, K10's shared weights) is
# counted once.
SLOT_AXIS_WORK = ("pusch_demap", "pdsch_map", "pdsch_map_prg",
                  "pucch_f1_detect", "pucch_f2_demap")


def batched_kernel_phase(names: tuple, per_slot: list, where: str,
                         library: dict | None = None) -> dict:
    """The batched form of each kernel of ``names`` at B = len(per_slot)
    against its twin (timed, with its bound: the work of the batched
    arguments for the kernels of :data:`SLOT_AXIS_WORK`, else summed over
    the slots), and its slot 0 at B = 1 against the unbatched kernel; K16-K19
    (BATCHED_UL) also every slot bit-equal to that slot's unbatched launch.
    ``per_slot[b]``: slot b's cases (name -> (wrapper, twin, args)), the
    tensors that differ across the slots stacked on a slot axis;
    ``library``: per name, the PyTorch call timed as the batch's
    ``library_ms`` (K18's and K19's IDFT stage over the B slots' blocks)."""
    nb = len(per_slot)
    results = {}
    for name in names:
        fn, ref_fn, args, mask = _stack_case([c[name] for c in per_slot])
        out = fn(*args)
        ref = ref_fn(*args)
        err = max(compare(name, _slot_of(out, b), _slot_of(ref, b),
                          per_slot[b][name][2]) for b in range(nb))
        if name in SLOT_AXIS_WORK:      # what the slots share counted once
            b_bytes, b_ops = work(name, args, out)
        else:
            b_bytes = b_ops = 0.0
            for b in range(nb):
                sl = tuple(_slice_tree(a, m, b) for a, m in zip(args, mask))
                w = work(name, sl, _slot_of(out, b))
                b_bytes += w[0]
                b_ops += w[1]
        if name in BATCHED_UL:
            for b in range(nb):
                _bit_equal(_slot_of(out, b), fn(*per_slot[b][name][2]),
                           f"{name} batch slot {b} vs its own launch")
        t_bytes, t_ops = b_bytes / MEM_BYTES_PER_S, b_ops / F32_OPS_PER_S
        # B = 1: the batched kernel's slot 0 against today's kernel
        one = fn(*(_slice_tree(a, m, slice(0, 1))
                   for a, m in zip(args, mask)))
        single = fn(*per_slot[0][name][2])
        compare(name, _slot_of(one, 0), single, per_slot[0][name][2])
        results[f"{name}_batch"] = dict(
            max_abs_err=err, ms=median_ms(lambda: fn(*args)),
            plain_ms=median_ms(lambda: ref_fn(*args), BATCH_TIMING_RUNS),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=(median_ms(library[name])
                        if library and name in library else None))
    print(f"batched {where} at B = {nb} against their twins and at B = 1 "
          f"against the unbatched kernels: ok", flush=True)
    return results


def _bit_equal(got, ref, what: str) -> None:
    """Two kernel outputs (tensors or tuples of them) equal bit for bit."""
    if isinstance(ref, torch.Tensor):
        if got.shape != ref.shape or not torch.equal(_bits(got), _bits(ref)):
            raise AssertionError(f"{what}: not bit-equal")
        return
    for g, r in zip(got, ref):
        _bit_equal(g, r, what)


def conductor_batch_cases(ul_slots, dl_slots, gen, scen) -> list:
    """Phase 7's per-slot cases of the batched K1-K15: K1-K11 on phase 2's
    and 3's slots (each slot its own context and PRACH capture), K12-K15 on
    the batch's conductor phases."""
    nb = flagship.BATCH
    prach_b = flagship.batch_prach_fd(ul_slots[0][1].device, SEED)
    phases = scen["phases"]
    return [{**flagship.kernel_cases(rx, ctx, gen, (prach_b[0][b],)),
             **flagship.dl_kernel_cases(d),
             **flagship.conductor_kernel_cases(
                 phases[g]["rx"], (2 * g) % 20, gen)}
            for b, ((_, rx, ctx), d, g) in enumerate(zip(
                ul_slots[:nb], dl_slots[:nb], flagship.BATCH_PHASES))]


# ---------------------------------------------------------------- phase 8

def multi_cell_phase(dev, gen, rng, card) -> None:
    """Phase 8: 4 cells of the flagship DL and UL plans in one program
    each, every cell against its single-cell program."""
    n = flagship.NOF_CELLS
    inp = flagship.multi_cell_inputs(rng, gen, dev)
    dl = multi_cell_dl_fn(flagship.DL_CELL, flagship.DL_PLAN, n)
    ul = multi_cell_ul_fn(flagship.CELL, flagship.UL_PLAN, n)
    kernels.reset_counts()
    (samples, _), ms_dl = timed(lambda: dl((), (inp["dci"],), (inp["sch"],)))
    out, ms_ul = timed(lambda: ul(inp["rx"], inp["prach"], inp["softs"]))
    launches = {**batch_counts(MULTI_CELL_LAUNCHES, "multi-cell"),
                **launched(("dmrs_map", "control_map"))}
    one_ul = ul_slot_fn(flagship.CELL, flagship.UL_PLAN)
    for c in range(n):
        s1 = flagship.dl_program(False)((), (inp["dci"][c],),
                                        (inp["sch"][c],))
        close(samples[c], s1, f"multi-cell DL, cell {c}")
        ref = one_ul(inp["rx"][c], (inp["prach"][0][c],),
                     (inp["softs"][0][c],))
        compare_ul(_slot_of_dict(out, c), _slot_of_dict(ref, None))
        r = out["pusch"][0]
        if not (bool(r["tb_crc_ok"][c])
                and torch.equal(r["tb_bits"][c], inp["tb"][c])):
            raise AssertionError(f"multi-cell UL, cell {c}: TB not decoded")
    print(f"multi-cell: {n} cells, DL {1e3 * ms_dl:.1f} us and UL "
          f"{1e3 * ms_ul:.1f} us for all cells (CUDA events), each cell "
          f"equal to its single-cell program, {n}/{n} TBs exact, batched "
          f"launches {launches}, card {card}", flush=True)


# ---------------------------------------------------------------- phase 9

def _ifft_blocks(blocks: int, m: int, dev):
    """torch.fft.ifft over ``blocks`` blocks of ``m`` points (norm="ortho",
    the IDFT stage of K18 and K19), as a callable to time."""
    x = torch.ones((blocks, m), dtype=torch.complex64, device=dev)
    return lambda: torch.fft.ifft(x, dim=-1, norm="ortho")


def edge_library(cases: dict, nslots: int = 1) -> dict:
    """The IDFT stage's library call for each K18 and K19 case, over the
    blocks of ``nslots`` slots."""
    out = {}
    for name, (_, _, args) in cases.items():
        kind = CASE_KERNEL.get(name, name)
        if kind == "pusch_tp_demap":
            plan, m = args[2], args[5]
            out[name] = _ifft_blocks(nslots * plan.shape[-1] // m, m,
                                     plan.device)
        elif kind == "pucch_f3_demap":
            cfg = args[3]
            out[name] = _ifft_blocks(
                nslots * len(pucch._f3_symbol_split(cfg)[1]),
                12 * cfg.nof_rb, args[0].device)
    return out


def edge_conductor(slots: list, prach_in, rng, card) -> dict:
    """The cell-edge slots' UL requests beside the flagship DL through the
    FAPI conductor: every slot through its phase's CUDA graph against the
    phase's eager program, a counted pass resolved RESOLVE_LAG behind
    (both TBs, UE C's ACK, the F3 and F4 payloads as sent, K18 and K19
    launched), then four slots as one process_slot_batch against
    process_slot (K18 and K17 once, K19 once per PDU, nothing per slot)
    and timed over N_TIMED_BATCHES graphed batches.  Returns the batch
    rows' launches in one batch."""
    cond = SlotConductor(flagship.CELL)
    pay = flagship.dl_payloads(rng)
    n = len(slots)
    dlr = [flagship.dl_request(i) for i in range(n)]
    ulr = [flagship.edge_ul_request(i) for i in range(n)]
    txd = [flagship.tx_request(i, pay) for i in range(n)]
    stride = max(cond.payload_layout(d)[1] for d in dlr)
    st = cond.stage_payloads(list(zip(dlr, txd)), stride=stride)
    for i, s in enumerate(slots):
        tx_g, pend_g = cond.process_slot(dlr[i], ulr[i], st, i, s["rx"],
                                         prach_fd=prach_in)
        tx_e, pend_e = _eager_slot(cond, dlr[i], ulr[i], st, i, s["rx"],
                                   prach_in)
        close(tx_g, tx_e, f"cell-edge slot {i}: graph vs eager tx samples")
        res = pend_g.resolve()
        convert.slot_results(pend_e.resolve(), res, rtol=1e-3)
        flagship.check_edge_results(res, s, f"cell-edge graph slot {i}")
    kernels.reset_counts()
    host_us, span_us, done = _timed_slots(lambda i, k: cond.process_slot(
        dlr[i], ulr[i], st, k, slots[i]["rx"], prach_fd=prach_in)[1], n,
        [(i, i) for i in range(n)])
    counts = launched(EDGE_KERNELS)
    for (i, _), res in done:
        flagship.check_edge_results(res, slots[i], f"conductor cell-edge {i}")
    print(f"conductor cell-edge slot (flagship DL + UL with 2 PUSCH, "
          f"DFT-s-OFDM + hopping, F1, F3, F4, PRACH, SRS): {n} slots ok, "
          f"each graph equal to its eager program; {span_us:.1f} us per slot "
          f"by CUDA events, {host_us:.1f} us on the host clock, launches "
          f"{counts}, card {card}", flush=True)

    # B = 4 slots at the batch mode's phases (no SSB in their DL), each
    # slot its own samples and the same PRACH capture
    b_idx = flagship.BATCH_PHASES
    batch = [(dlr[i], ulr[i]) for i in b_idx]
    rx_b = torch.stack([slots[i]["rx"] for i in b_idx])
    prach_b = (torch.stack([prach_in[0]] * len(b_idx)),)

    def stage():
        return cond.stage_payloads([(dlr[i], txd[i]) for i in b_idx],
                                   stride=stride)

    def check(res, where):
        for b, i in enumerate(b_idx):
            flagship.check_edge_results(res[b], slots[i],
                                        f"{where}, slot {b}")

    st_b = stage()
    tx_b, pend_b = cond.process_slot_batch(batch, st_b, rx_b,
                                           prach_fd=prach_b)
    mib = _last_graph(cond).nbytes >> 20
    check(_batch_vs_slots(cond, batch, st_b, rx_b, prach_b, tx_b, pend_b,
                          "cell-edge batch"), "cell-edge batch")
    torch.cuda.synchronize()
    kernels.reset_counts()
    _, pend_b = cond.process_slot_batch(batch, stage(), rx_b,
                                        prach_fd=prach_b)
    check(pend_b.resolve(), "counted cell-edge batch")
    launches = batch_counts(EDGE_BATCH_LAUNCHES, "cell-edge batch")
    print(f"cell-edge batch of {len(b_idx)} (slots {list(b_idx)}): equal to "
          f"process_slot slot by slot, every TB, UCI and PRACH as sent; "
          f"launches per batch {launches}, none per slot; memory reserved "
          f"by its capture {mib} MiB", flush=True)
    print(f"cell-edge batch: "
          f"{_timed_batches(cond, batch, stage, rx_b, prach_b, check)}, "
          f"card {card}", flush=True)
    return launches


def edge_phases(dev, gen, rng, card) -> tuple:
    """Phase 9: K18 and K19 (and K8 at stride 1) against their twins, then
    the cell-edge UL slot through ``ul_slot_fn`` and the conductor."""
    t0 = time.perf_counter()
    kernels.reset_counts()
    slots = flagship.make_edge_slots(NOF_SLOTS + 2, rng, gen, dev)
    torch.cuda.synchronize()
    ue_launches = launched(UE_KERNELS)
    softs = flagship.edge_soft_buffers(dev)
    prach_in = flagship.prach_fd(dev, SEED)
    print(f"cell-edge transmitters: {len(slots)} slots in "
          f"{time.perf_counter() - t0:.1f} s (UE C's ACK and the F4 by K34, "
          f"the F3 by K33: launches {ue_launches})", flush=True)
    cases = flagship.edge_kernel_cases(slots[0], gen)
    results = kernel_phases(cases, edge_library(cases))
    prog = flagship.edge_program()

    def run(s):
        return prog(s["rx"], prach_in, softs, s["ctx"])

    measured = slots[2:]
    for s in slots[:2]:
        flagship.check_edge_slot(run(s), s, "cell-edge warm-up")
    torch.cuda.synchronize()
    kernels.reset_counts()
    slot_ms, outs = [], []
    for s in measured:
        out, ms = timed(lambda: run(s))
        slot_ms.append(ms)
        outs.append(out)
    launches = launched(EDGE_PATH)
    for i, (s, out) in enumerate(zip(measured, outs)):
        flagship.check_edge_slot(out, s, f"cell-edge slot {i}")
    edge = {k: launches[k] for k in EDGE_KERNELS}
    print(f"cell-edge UL slot (2-layer PUSCH + DFT-s-OFDM hopping PUSCH with "
          f"HARQ-ACK + F1 + F3 + F4 + PRACH + SRS): {len(outs)} slots ok, "
          f"median {1e3 * statistics.median(slot_ms):.1f} us per slot (CUDA "
          f"events), launches {edge}, card {card}", flush=True)
    s = measured[0]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run(s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    flagship.check_edge_slot(out, s, "cell-edge sync-free call")
    print("cell-edge sync-free steady-state call: ok", flush=True)
    cpu = prog(s["rx"].cpu(), _to_cpu(prach_in), _to_cpu(softs),
               _to_cpu(s["ctx"]))
    compare_ul(out, cpu)
    print("cell-edge slot (full result dict) vs plain twins on the CPU: ok",
          flush=True)
    batch_launches = edge_conductor(slots[:NOF_SLOTS], prach_in, rng, card)
    per = [flagship.edge_kernel_cases(slots[i], gen)
           for i in flagship.BATCH_PHASES]
    results.update(batched_kernel_phase(
        EDGE_KERNELS, per, "K18-K19", edge_library(per[0], len(per))))
    return results, {**launches, **batch_launches}


# --------------------------------------------------------------- phase 10

def gnb_library(cases: dict) -> dict:
    """One PyTorch call for a part or the whole of K20's and K21's work:
    the channel's einsum mix stage alone (rx from H and tx; no single call
    computes the channel), and ``torch.matmul`` of the PRACH bin matrix
    with the stacked windows (the whole function, checked against the
    twin)."""
    tx, cfg, gains, noise = cases["tdl_channel"][2]
    _, h = chan.apply_ref(tx, cfg, gains, noise)
    return {"tdl_channel": lambda: torch.einsum("rtk,tsk->rsk", h, tx),
            **{name: launch_profile.matmul_call(cases[name][2])
               for name in flagship.PRACH_DEMOD_CASES}}


def _app_config(*overrides):
    return app_config.load(None, list(GNB_CELL + overrides))


def _slot_times(res: dict) -> str:
    """us per DL and UL slot: the device span of each slot program by
    CUDA events (median), and on the host clock the launch (the app's
    registry: enqueue only) and the loop's wall time per slot."""
    parts = []
    for kind in ("dl", "ul"):
        us, n = res["slot_device_us"][kind]
        enq = {r["name"]: r for r in res["report"]}[f"{kind}_slot"]
        parts.append(f"{kind.upper()} {us:.1f} us by CUDA events (n={n}), "
                     f"launch {enq['lat_us_avg']:.1f} us on the host clock")
    slots = res["dl_slots"] + res["ul_slots"]
    return "; ".join(parts) + (f"; wall {1e6 * res['elapsed_s'] / slots:.1f} "
                               f"us per slot")


def gnb_sim_phase(dev, gen, rng, card) -> tuple:
    """Phase 10: K20, K21 and K22 against their twins, then the port's
    gNB simulator at the flagship width in test mode and in scheduler
    mode over the TDLA channel."""
    cases = flagship.gnb_kernel_cases(gen, rng, dev)
    results = kernel_phases(cases, gnb_library(cases))
    with_table, k6 = flagship.prg_single_table_case(dev)
    one = dl_map.pdsch_map(with_table[0].clone(), *with_table[1:])
    ref = dl_map.pdsch_map(k6[0].clone(), *k6[1:])
    if not torch.equal(one, ref):
        raise AssertionError("K22 with one PRG and the identity differs "
                             "from K6")
    print("K22 with G = 1 (the identity): bit-exact to K6", flush=True)

    cfg = _app_config(f"run.nof_slots={GNB_TEST_SLOTS}")
    kernels.reset_counts()
    res = gnb_sim.run(cfg, verbose=False)
    torch.cuda.synchronize()
    if not (res["ul_slots"] and res["crc_fail"] == 0
            and res["crc_ok"] == res["ul_slots"]):
        raise AssertionError(f"gnb_sim test mode: UL CRC {res['crc_ok']} ok "
                             f"/ {res['crc_fail']} failed over "
                             f"{res['ul_slots']} UL slots")
    print(f"gnb_sim test mode, {cfg.cell.nof_rb} RB, {GNB_TEST_SLOTS} slots: "
          f"UL CRC: {res['crc_ok']} ok / {res['crc_fail']} failed; "
          f"{_slot_times(res)}; card {card}", flush=True)

    cfg = _app_config(f"run.nof_slots={GNB_SCHED_SLOTS}", *GNB_SCHED)
    kernels.reset_counts()
    res = gnb_sim.run(cfg, verbose=False)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels.REGISTRY.values()
              if k.launches}
    launches = launched(GNB_KERNELS)
    launched(UE_KERNELS[1:])            # the UE emulator's CSI on PUSCH
    ctr = res["counters"]
    checks = {
        "a PRACH detected and turned into a TC-RNTI":
            any(tc for _, _, tc, _ in res["prach"]),
        "a CSI report": ctr.get("csi_reports", 0) >= 1,
        "K20 once per emulated UL slot":
            launches["tdl_channel"] == res["ul_slots"],
        "K21 once per completed PRACH window":
            launches["prach_demod"] == res["prach_windows"] > 0,
        "a UL TB decoded": res["crc_ok"] >= 1,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"gnb_sim scheduler mode: not met: {failed}; "
                             f"{res}")
    for slot, pre, tc, metric in res["prach"]:
        print(f"  slot {slot}: PRACH preamble {pre} detected (metric "
              f"{metric:.1f}) -> TC-RNTI 0x{tc:04x}", flush=True)
    n = res["crc_ok"] + res["crc_fail"]
    print(f"gnb_sim scheduler mode, {cfg.cell.nof_rb} RB, TDLA "
          f"{cfg.channel_sinr_db} dB, {GNB_SCHED_SLOTS} slots: UL CRC: "
          f"{res['crc_ok']} ok / {res['crc_fail']} failed (CRC-ok share "
          f"{res['crc_ok'] / n:.3f}); scheduler {ctr}; "
          f"{_slot_times(res)}; launches {counts}; card {card}", flush=True)
    return results, launches


# --------------------------------------------------------------- phase 11

class _Tap:
    """A cable endpoint that keeps a copy of every frame it sends."""

    def __init__(self, endpoint):
        self.endpoint, self.sent = endpoint, []

    def send(self, frame: bytes):
        self.sent.append(frame)
        self.endpoint.send(frame)

    def recv(self):
        return self.endpoint.recv()


def sqnr_db(got: torch.Tensor, ref: torch.Tensor) -> float:
    err = float((got - ref).abs().pow(2).sum() / ref.abs().pow(2).sum())
    return -10.0 * math.log10(err)


def _ofh_slot(i: int) -> dict:
    """DL slot i's slot point (1, 2i), as flagship.make_dl_slots numbers
    them, as send_dl_grid's arguments."""
    sfn, sif = divmod(2 * i, 20)
    return dict(slot=sif % 2, subframe=sif // 2, frame_id=sfn % 256)


def _round_trip(du: RuOfh, grid: torch.Tensor, i: int, deadline: float,
                emu: threading.Thread, box: dict) -> tuple:
    """Send DL slot i, wait for its UL loopback; (the UL grid, host us of
    send_dl_grid, of the receive_ul_grid call that returned the grid, and
    of the whole round trip to the grid on the card)."""
    t0 = time.perf_counter()
    try:
        sent = du.send_dl_grid(grid, **_ofh_slot(i))
    except TimeoutError as e:
        raise AssertionError(f"fronthaul slot {i}: the emulator stopped "
                             f"reading (alive {emu.is_alive()}): {box}") from e
    if not sent:
        raise AssertionError(f"fronthaul slot {i}: DL grid not sent")
    t1 = time.perf_counter()
    while True:
        t2 = time.perf_counter()
        back = du.receive_ul_grid(14)
        if back is not None:
            break
        if "error" in box or not emu.is_alive():
            raise AssertionError(f"fronthaul slot {i}: the emulator stopped: "
                                 f"{box}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"fronthaul slot {i}: no UL grid within the "
                               f"phase's {OFH_PHASE_S} s")
        time.sleep(0.0002)
    t3 = time.perf_counter()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    return back, (1e6 * (t1 - t0), 1e6 * (t3 - t2), 1e6 * (t4 - t0))


def _device_us(prof, kernel: str) -> tuple:
    """(device us per launch, launches) of the device activities named
    after ``kernel`` in a profile."""
    total, count = 0.0, 0
    for row in prof.key_averages():
        if kernel in row.key:
            total += float(getattr(row, "device_time_total",
                                   getattr(row, "cuda_time_total", 0.0)))
            count += row.count
    return (total / count if count else float("nan")), count


def fronthaul_phase(dev, rng, card) -> tuple:
    """Phase 11: K23 and K24 against their twins, then the split-7.2
    fronthaul round trip of the flagship DL slots through the port's O-RU
    emulator over a socket."""
    cases = {**flagship.ofh_kernel_cases(rng, dev),
             **flagship.ofh_profile_cases(
                 np.random.default_rng(OFH_PROFILE_SEED), dev)}
    results = kernel_phases(cases)
    print("K23/K24 (BFP compress+pack, unpack+decompress): no single "
          "PyTorch call computes BFP (library: null)", flush=True)

    nof_slots = NOF_SLOTS + OFH_PROFILED_SLOTS
    slots = flagship.make_dl_slots(nof_slots, rng, dev)
    grids = [OFH_BACKOFF * flagship.dl_grid_program(s["with_ssb"])(
        *s["args"])[1] for s in slots]
    torch.cuda.synchronize()
    cell = flagship.CELL
    ports, nof_prb = cell.nof_ports, cell.nof_rb
    uplane = ports * 14 * -(-nof_prb // 255)          # frames per slot
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the profiler's first start takes seconds; the emulator, running,
    # takes 10 s without a slot for the DU going away
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
    deadline = time.monotonic() + OFH_PHASE_S

    a, b = socket.socketpair()
    with a, b:
        du_ep = _Tap(SocketEndpoint(a))
        du = RuOfh(du_ep, ports, nof_prb, iq_width=flagship.OFH_WIDTH,
                   device=dev)
        box = {}

        def serve():
            try:
                box["metrics"] = ru_emulator.run(
                    SocketEndpoint(b), ports, nof_prb,
                    nof_slots, loopback_delay=1, device=dev)
            except Exception as e:             # reported by the DU's loop
                box["error"] = repr(e)

        emu = threading.Thread(target=serve, daemon=True)
        emu.start()
        kernels.reset_counts()
        backs, times = [], []
        for i, g in enumerate(grids[:NOF_SLOTS]):
            back, t = _round_trip(du, g, i, deadline, emu, box)
            backs.append(back)
            times.append(t)
        launches = launched(OFH_KERNELS)
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(NOF_SLOTS, nof_slots):
                backs.append(_round_trip(du, grids[i], i, deadline, emu,
                                         box)[0])
            torch.cuda.synchronize()
        emu.join(timeout=max(1.0, deadline - time.monotonic()))
        if emu.is_alive() or "metrics" not in box:
            raise AssertionError(f"fronthaul: the emulator did not finish: "
                                 f"{box}")
        if du.receive_ul_grid(14) is not None:
            raise AssertionError("fronthaul: more UL grids than DL slots")

    if launches != {k: 2 * NOF_SLOTS for k in OFH_KERNELS}:
        raise AssertionError(f"fronthaul: K23/K24 launches {launches}, "
                             f"expected one per grid per side")
    sqnr = [sqnr_db(back, g) for back, g in zip(backs, grids)]
    if min(sqnr) < OFH_MIN_SQNR_DB:
        raise AssertionError(f"fronthaul: SQNR {sqnr} dB below "
                             f"{OFH_MIN_SQNR_DB} dB")
    emu_m = box["metrics"]
    want = {"tx_frames": nof_slots * uplane, "rx_frames": nof_slots * uplane,
            "cplane_tx": nof_slots * ports, "cplane_rx": nof_slots * ports,
            "dropped_seq": 0, "unscheduled_uplane": 0, "incomplete_slots": 0}
    for side, m in (("DU", du.metrics), ("emulator", emu_m)):
        bad = {k: m[k] for k, v in want.items() if m[k] != v}
        if bad:
            raise AssertionError(f"fronthaul {side}: {bad}, expected "
                                 f"{want}")
    print(f"fronthaul: {nof_slots} flagship DL slots ({ports} ports, "
          f"{nof_prb} PRB, BFP {flagship.OFH_WIDTH}, x{OFH_BACKOFF}) through "
          f"ru_emulator over a socket and back: one UL grid per slot, SQNR "
          f"min {min(sqnr):.2f} dB (per slot "
          f"{', '.join(f'{x:.2f}' for x in sqnr)}); {uplane} U-plane + "
          f"{ports} C-plane frames per slot each way; DU {du.metrics}; "
          f"emulator {emu_m}", flush=True)

    # the card's frames of slot 0 against a CPU RuOfh on the same grid
    cable = InMemoryCable()
    cpu = RuOfh(cable.endpoint_a(), ports, nof_prb,
                iq_width=flagship.OFH_WIDTH, device="cpu")
    cpu.send_dl_grid(grids[0].cpu(), **_ofh_slot(0))
    frames = list(cable.a_to_b)
    if du_ep.sent[:len(frames)] != frames:
        raise AssertionError("fronthaul: the card's frames differ from the "
                             "CPU's")
    print(f"fronthaul: slot 0's {len(frames)} frames "
          f"({sum(map(len, frames))} B) byte-equal to a CPU RuOfh's",
          flush=True)

    # the unscaled grid, one hop on the card
    raw = grids[0] / OFH_BACKOFF
    cable = InMemoryCable()
    tx, rx = (RuOfh(ep, ports, nof_prb, iq_width=flagship.OFH_WIDTH,
                    device=dev)
              for ep in (cable.endpoint_a(), cable.endpoint_b()))
    tx.send_dl_grid(raw, **_ofh_slot(0))
    hop = rx.receive_ul_grid(14)
    clipped = float((torch.view_as_real(raw).abs() > 1.0).double().mean())
    print(f"fronthaul, unscaled grid (no back-off): {100 * clipped:.3f}% of "
          f"components past full scale, one-hop SQNR {sqnr_db(hop, raw):.2f} "
          f"dB", flush=True)

    send_us, recv_us, trip_us = (statistics.median(x) for x in zip(*times))
    dev_us = {k: _device_us(prof, f"{k}_kernel") for k in (
        "bfp_compress", "bfp_decompress_sections")}
    # the received grids' torch.zeros before K24, one a side a slot
    dev_us["the grids' torch.zeros"] = _device_us(prof, "FillFunctor")
    print(f"fronthaul times, median over {NOF_SLOTS} slots on the host "
          f"clock: send_dl_grid {send_us:.1f} us, the receive_ul_grid call "
          f"that returned the grid {recv_us:.1f} us, round trip {trip_us:.1f} "
          f"us per slot; by the profiler over {OFH_PROFILED_SLOTS} slots: "
          + ", ".join(f"{k} {us:.2f} us per launch ({n} launches)"
                      for k, (us, n) in dev_us.items())
          + f"; emulator rx on time / early / late {emu_m['rx_on_time']} / "
          f"{emu_m['rx_early']} / {emu_m['rx_late']}; card {card}",
          flush=True)
    return results, launches


# --------------------------------------------------------------- phase 12

def du_library(cases: dict) -> dict:
    """K27's stage library time: the ``torch.matmul`` of the GF(2) stage
    the port ran before K27 (the PDCCH's DCI map and the PBCH's map with
    its slot context, as float32 products over 0/1 values) on the
    "control_map" case's inputs."""
    _, _, (_, inputs, _) = cases["control_map"]
    dev = inputs["dci0"].device
    cfg = flagship.PDCCH
    key = (cfg.payload_bits, 108 * cfg.aggregation_level, cfg.rnti,
           cfg.n_rnti, cfg.n_id_data)
    m_dci = const(pdcch._dci_map, 0, *key, device=dev, dtype=torch.float32)
    m_pbch = const(ssb._pbch_operand, flagship.SSB, "full", device=dev,
                   dtype=torch.float32)
    dci = inputs["dci0"].to(torch.float32)
    v = torch.cat([inputs["mib"], inputs["static"] ^ inputs["mask"]]).to(
        torch.float32)
    return {"control_map": lambda: (torch.matmul(dci, m_dci),
                                    torch.matmul(v, m_pbch))}


def _ready_port(proc, deadline: float) -> int:
    """The FAPI port du_low prints when it listens."""
    seen = []
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            if proc.poll() is not None:
                break
            continue
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line.rstrip())
        m = re.search(r"FAPI listening on 127\.0\.0\.1:(\d+)", line)
        if m:
            print("  " + "\n  ".join(seen), flush=True)
            return int(m.group(1))
    raise AssertionError(f"du_low printed no ready line: {seen}")


def _du_requests(n: int, pay: dict):
    """DU-low slots 0 .. n-1: (dl, tx, ul, conductor phase) at slot points
    (1, 2i); UL slot i is the conductor scenario's phase i % N_PHASES."""
    out = []
    for i in range(n):
        g = i % flagship.N_PHASES
        dl = flagship.du_dl_request(i)
        ul = dataclasses.replace(flagship.ul_request(g), slot=dl.slot)
        out.append((dl, flagship.du_tx_request(i, pay), ul, g))
    return out


def _host_rx(phases: list, prach_in) -> list:
    return ([p["rx"].cpu().numpy() for p in phases],
            [p.cpu().numpy() for p in prach_in])


def _small_cell_slot(cli, count: int):
    """A slot of the 52-RB 1-port cell: a 1-layer PDSCH looped back as the
    PUSCH of the same allocation (tests/test_fapi_config_plane.py's case);
    returns (SlotResults, payload)."""
    cell = flagship.DU_SMALL_CELL
    slot = SlotPoint(1, count)
    common = dict(rnti=0x11, rb_start=0, rb_count=cell.nof_rb,
                  first_symbol=0, nof_symbols=14, modulation="qam16",
                  target_code_rate=0.5, tbs=2400, nof_layers=1, n_id=0,
                  dmrs_symbols=(2, 7, 11), slot_in_frame=slot.slot_index)
    payload = np.random.default_rng(count).integers(0, 2, 2400).astype(
        np.int8)
    samples = cli.dl_tti(
        messages.DlTtiRequest(slot=slot, pdsch=(pdsch.PdschConfig(**common),)),
        messages.TxDataRequest(slot=slot, pdsch_payloads=(payload,)),
        want_samples=True)
    cli.rx_samples(samples)
    return cli.ul_tti(messages.UlTtiRequest(
        slot=slot, pusch=(pusch.PuschConfig(**common),))), payload


def _check_small(res, payload, where):
    if not (res.crc[0].tb_crc_ok and np.array_equal(
            res.rx_data[0].payload.astype(np.int8), payload)):
        raise AssertionError(f"{where}: the 52-RB cell's TB did not decode")


def _du_rs_check(samples: np.ndarray, dl, dev) -> tuple:
    """Demodulate a DU-low slot's samples (K4) and hold its RS REs (outside
    the SSB's rectangle) to their values: (REs checked, max error)."""
    cell = flagship.CELL
    grid = ofdm.demodulate_slot(torch.from_numpy(samples).to(dev), cell.nof_sc,
                                cell.dft_size, cell.numerology, cell.cp, 0,
                                cell.center_freq_hz).cpu()
    items, values = flagship.du_rs_items(dl, "cpu")
    want = dl_rs.rs_map_ref(torch.zeros_like(grid), items, values)
    mask = want != 0
    if dl.ssb:
        l0, k0 = flagship.SSB.first_symbol, flagship.SSB.first_subcarrier
        mask[:, l0:l0 + 4, k0:k0 + 240] = False
    err = float((grid[mask] - want[mask]).abs().max())
    if err > DU_RS_TOL:
        raise AssertionError(f"RS REs off their values by {err}")
    return int(mask.sum()), err


def _du_slots(cli, reqs, rx, prach, phases, refs, dev, times, where):
    """Each DU-low slot through a client: DL with samples (held to the
    in-process conductor's), rx_samples, ul_tti (held to phase 4's
    checks); returns the samples."""
    out = []
    for k, (dl, tx, ul, g) in enumerate(reqs):
        t0 = time.perf_counter()
        samples = cli.dl_tti(dl, tx, want_samples=True)
        t1 = time.perf_counter()
        cli.rx_samples(rx[g], prach_fd=prach)
        t2 = time.perf_counter()
        res = cli.ul_tti(ul)
        t3 = time.perf_counter()
        times["dl_tti"].append(t1 - t0)
        times["rx_samples"].append(t2 - t1)
        times["ul_tti"].append(t3 - t2)
        if refs is not None:
            close(torch.from_numpy(samples), refs[k],
                  f"{where} slot {k} ({flagship.du_kind(k)}): samples")
        flagship.check_results(res, phases[g], f"{where} slot {k}")
        out.append(samples)
    return out


def du_low_phase(dev, gen, rng, card) -> tuple:
    """Phase 12: K25-K27 against their twins, then the split-6 DU-low as a
    deployment runs it: ``python3 -m srsran_tpu_torch.apps.du_low`` in a
    process of its own, driven over TCP by the port's FapiClient; then the
    same slots through ``serve_phy`` in a thread, for the launch counts."""
    cases = flagship.du_kernel_cases(rng, dev)
    one_launch_a_call(cases)
    results = kernel_phases(cases, {**du_library(cases), **rs_library(cases)})
    for name in [n for n in cases if n.endswith("_b4")]:
        kernel, _, args = cases[name]
        got = kernel(*args)
        base = name[:-3]
        for b in range(4):
            if not torch.equal(got[b], kernel(*flagship.du_slot_of(base,
                                                                    args, b))):
                raise AssertionError(f"{name}: slot {b} differs from B = 1")
    print("K25-K27 bit-exact to their twins at the DU-low shapes and at "
          "B = 4 slot by slot against B = 1; K25 and K26 beside their "
          "scatter stage (index_put_)", flush=True)
    # K25's wrapper in place on its case's grid (no copy in the time)
    # beside its scatter stage
    for name in ("rs_map", "rs_map_prs", "rs_map_many"):
        args = cases[name][2]
        print(host_path(name, {
            "kernel": lambda a=args: dl_rs.rs_map(*a),
            "library": launch_profile.rs_map_stage(args)}), flush=True)
    # K27's wrapper on prebuilt PDUs beside the torch.matmul of its GF(2)
    # stage (one product per PDU), and building the slot's PDUs
    calls, library = launch_profile.control_calls(
        np.random.default_rng(SEED + 27), dev)
    for name, fn in calls.items():
        print(host_path(name, {"kernel": fn, "library": library[name]}
                        if library[name] else {"items": fn}), flush=True)

    deadline = time.monotonic() + DU_PHASE_S
    phases = flagship.conductor_phases(rng, gen, dev)
    prach_in = flagship.prach_fd(dev, SEED)
    pay = flagship.dl_payloads(rng)
    reqs = _du_requests(DU_SLOTS + DU_NB_SLOTS, pay)
    rx, prach = _host_rx(phases, prach_in)
    ref_cond = SlotConductor(flagship.CELL)
    refs = [ref_cond.process_dl(dl, tx, return_grid=False)[0].cpu()
            for dl, tx, _, _ in reqs[:DU_SLOTS]]

    proc = subprocess.Popen(
        [sys.executable, "-m", "srsran_tpu_torch.apps.du_low", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    times = {"dl_tti": [], "rx_samples": [], "ul_tti": [], "ul_tti_nb": []}
    try:
        port = _ready_port(proc, deadline)
        cli = FapiClient("127.0.0.1", port,
                         timeout=max(1.0, deadline - time.monotonic()))
        if not isinstance(cli.config_msg(cm.ParamRequest()), cm.ParamResponse):
            raise AssertionError("param.request: no param.response")
        resp = cli.config_msg(cm.ConfigRequest(cell=flagship.CELL))
        if resp.error_code is not cm.ErrorCode.MSG_OK:
            raise AssertionError(f"config.request refused: {resp}")
        if cli.config_msg(cm.StartRequest()) is not None:
            raise AssertionError("start.request refused")
        samples = _du_slots(cli, reqs[:DU_SLOTS], rx, prach, phases, refs,
                            dev, times, "du_low")
        # slot A's PDSCH back around its PT-RS REs (K4, demap, K2, K1)
        dl_a, tx_a = reqs[0][0], reqs[0][1]
        mib = torch.from_numpy(np.unpackbits(tx_a.ssb_mib[0])[:24].astype(
            np.int8)).to(dev)
        res = flagship.du_loopback(torch.from_numpy(samples[0]).to(dev),
                                   dl_a.pdsch[0], (dl_a.ssb[0], mib))
        tb = np.unpackbits(tx_a.pdsch_payloads[0])[:flagship.PDSCH.tbs]
        if not (bool(res.tb_crc_ok) and np.array_equal(
                res.tb_bits.cpu().numpy().astype(np.uint8), tb)):
            raise AssertionError("du_low slot A: PDSCH not received back "
                                 "around its PT-RS")
        rs = [_du_rs_check(samples[k], reqs[k][0], dev) for k in range(3)]
        print(f"du_low: slot A's PDSCH received back (its SSB cancelled) "
              f"around its "
              f"{len(ptrs_prs.ptrs_positions(pdsch.ptrs_config(dl_a.pdsch[0])))}"
              f" PT-RS REs (CRC ok, {flagship.PDSCH.tbs} bits exact, "
              f"{int(res.nof_iterations)} LDPC sweeps); CSI-RS + PT-RS, TRS "
              f"+ PT-RS and PRS REs within {DU_RS_TOL} of their values "
              f"({[n for n, _ in rs]} REs, max errors "
              f"{[f'{e:.2g}' for _, e in rs]})", flush=True)
        # non-blocking UL slots, resolved 2 behind and pushed; flush
        t0 = time.perf_counter()
        for k, (dl, tx, ul, g) in enumerate(reqs[DU_SLOTS:]):
            cli.dl_tti(dl, tx)
            cli.rx_samples(rx[g], prach_fd=prach)
            t1 = time.perf_counter()
            cli.ul_tti_nb(ul)
            times["ul_tti_nb"].append(time.perf_counter() - t1)
        nb = sorted(cli.flush(), key=lambda r: r.slot.count)
        nb_s = time.perf_counter() - t0
        if [r.slot for r in nb] != [r[2].slot for r in reqs[DU_SLOTS:]]:
            raise AssertionError(f"ul_tti_nb: results of {len(nb)} slots")
        for r, (_, _, _, g) in zip(nb, reqs[DU_SLOTS:]):
            flagship.check_results(r, phases[g], "du_low ul_tti_nb")
        # a slot far behind the front
        late = reqs[1]
        err = cli.dl_tti(late[0], late[1], want_samples=True)
        if not (isinstance(err, cm.ErrorIndication)
                and err.error_code is cm.ErrorCode.OUT_OF_SYNC):
            raise AssertionError(f"a late slot gave {type(err).__name__}")
        # stop -> config (the 52-RB cell) -> start, a slot, and back
        count = 2 * (DU_SLOTS + DU_NB_SLOTS) + 2
        cli.reconfigure(flagship.DU_SMALL_CELL)
        _check_small(*_small_cell_slot(cli, count), "du_low reconfigured")
        cli.reconfigure(flagship.CELL)
        back = _du_requests(1, pay)[0]
        _du_slots(cli, [back], rx, prach, phases, [refs[0]], dev,
                  {k: [] for k in times}, "du_low back on the flagship")
        cli.stop()
        code = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        tail = proc.stdout.read().strip()
        if code != 0:
            raise AssertionError(f"du_low exited {code}: {tail}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"du_low (its own process): {DU_SLOTS} slots A-D with every UL "
          f"indication as phase 4 requires (CRC + exact payload, PRACH 21, "
          f"F0 and F2 bits) and DL samples within 1e-4 of the in-process "
          f"conductor, {DU_NB_SLOTS} ul_tti_nb slots pushed and flushed in "
          f"{nb_s:.2f} s, error.indication {err.error_code.name} for a late "
          f"slot, stop -> config (52 RB) -> start and back: ok; "
          f"{tail!r}", flush=True)
    us = {k: 1e6 * statistics.median(v) for k, v in times.items()}
    nbytes_dl = 8 * refs[0].numel()

    # the same slots through serve_phy in a thread: launch counts, the
    # server's conductor times by CUDA events, memory over a reconfig
    stats: dict = {}
    box = {}
    ready = threading.Event()

    def serve():
        try:
            serve_phy(ready_cb=lambda p: (box.update(port=p), ready.set()),
                      device=dev, stats=stats)
        except BaseException as e:          # reported by the main thread
            box["error"] = e
            ready.set()

    srv = threading.Thread(target=serve, daemon=True)
    srv.start()
    if not ready.wait(30.0) or "error" in box:
        raise AssertionError(f"serve_phy did not start: {box.get('error')}")
    cli = FapiClient("127.0.0.1", box["port"],
                     timeout=max(1.0, deadline - time.monotonic()))
    cli.configure(flagship.CELL)
    thread_reqs = reqs[:DU_SLOTS]
    # warm: every plan once, then counted
    _du_slots(cli, thread_reqs, rx, prach, phases, None, dev,
              {k: [] for k in times}, "serve_phy warm-up")
    counted = [(dataclasses.replace(dl, slot=SlotPoint(1, dl.slot.count + 40)),
                dataclasses.replace(tx, slot=SlotPoint(1, tx.slot.count + 40)),
                dataclasses.replace(ul, slot=SlotPoint(1, ul.slot.count + 40)),
                g) for dl, tx, ul, g in thread_reqs]
    torch.cuda.synchronize()
    stats.clear()
    kernels.reset_counts()
    _du_slots(cli, counted, rx, prach, phases, None, dev,
              {k: [] for k in times}, "serve_phy")
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels.REGISTRY.values()}
    launches = launched(DU_KERNELS + UL_KERNELS + UCI_KERNELS + DL_KERNELS)
    kinds = [flagship.du_kind(i) for i in range(DU_SLOTS)]
    want = {"rs_map": sum(k in "ABC" for k in kinds),
            "control_map": sum(k in "ABC" for k in kinds),
            "dmrs_map": sum(k in "AB" for k in kinds)}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"K25-K27 launches {launches} vs the slots' "
                             f"PDUs {want}")
    dl_ms = [d for _, d in stats["dl_tti"]]
    ul_ms = [d for _, d in stats["ul_tti"]]
    host_dl = [h for h, _ in stats["dl_tti"]]
    # a MAC with many UEs: the SSB and 17 DCIs, two K27 launches
    many = flagship.du_many_request(pay, 2 * DU_SLOTS + 42)
    many_ref = ref_cond.process_dl(*many, return_grid=False)[0].cpu()
    torch.cuda.synchronize()
    kernels.reset_counts()
    close(torch.from_numpy(cli.dl_tti(*many, want_samples=True)), many_ref,
          "serve_phy: the SSB and 17 DCIs")
    if kernels.REGISTRY["control_map"].launches != 2:
        raise AssertionError(f"the SSB and 17 DCIs: "
                             f"{kernels.REGISTRY['control_map'].launches} "
                             f"K27 launches, not 2")
    cli.reconfigure(flagship.DU_SMALL_CELL)
    _check_small(*_small_cell_slot(cli, 2 * DU_SLOTS + 82), "serve_phy")
    cli.reconfigure(flagship.CELL)
    cli.stop()
    srv.join(timeout=max(1.0, deadline - time.monotonic()))
    if srv.is_alive() or "error" in box:
        raise AssertionError(f"serve_phy did not end: {box.get('error')}")
    mem0, mem1, graph_b = _reconfig_memory(dev, reqs[0], phases, prach_in)
    wire = 1.0 - statistics.median(host_dl) * 1e6 / us["dl_tti"]
    print(f"du_low launches over {DU_SLOTS} slots ({''.join(kinds)}): "
          f"{ {k: counts[k] for k in DU_KERNELS} } (K25 and K27 in the "
          f"{want['rs_map']} slots with RS / control PDUs, K26 in the "
          f"{want['dmrs_map']} with a PDSCH); the SSB and 17 DCIs in two "
          f"K27 launches, samples within 1e-4 of the in-process "
          f"conductor's; a CellManager's graphed slot A, then stop -> "
          f"config (52 RB) -> start: memory reserved {mem0 >> 20} MiB "
          f"before and {mem1 >> 20} MiB after (the slot graph's capture "
          f"{graph_b >> 20} MiB released)", flush=True)
    print(f"du_low us per message on the host clock (its own process, "
          f"median): dl_tti with samples {us['dl_tti']:.0f}, rx_samples "
          f"{us['rx_samples']:.0f}, ul_tti {us['ul_tti']:.0f}, ul_tti_nb "
          f"{us['ul_tti_nb']:.0f} ({nbytes_dl} B of samples a slot each "
          f"way); the server's process_dl {1e3 * statistics.median(dl_ms):.0f}"
          f" us and process_ul + resolve {1e3 * statistics.median(ul_ms):.0f}"
          f" us by CUDA events (in a thread); the wire and codec's share of "
          f"a dl_tti: {100 * wire:.0f}%; card {card}", flush=True)
    return results, {k: launches[k] for k in DU_KERNELS}, dict(
        req=reqs[ALLOC_A], ref=refs[ALLOC_A], phases=phases, rx=rx,
        prach=prach)


def _reconfig_memory(dev, req: tuple, phases: list, prach_in) -> tuple:
    """The old conductor's device memory released on reconfiguration: a
    CellManager on the card runs DU-low slot ``req`` through its CUDA
    graph (process_slot), then stop -> config (the 52-RB cell) -> start.
    Memory reserved is read after a synchronize, a collection and
    empty_cache on both sides; the reading after the cycle must lie at
    least the slot graph's capture (its static tensors and its pool's
    growth) below the one before.  Returns (before, after, graph bytes)."""
    def reserved() -> int:
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    def handle(*msgs) -> None:
        for msg in msgs:
            r = mgr.handle_config_msg(msg)
            if isinstance(r, cm.ErrorIndication) or getattr(
                    r, "error_code", cm.ErrorCode.MSG_OK) is not \
                    cm.ErrorCode.MSG_OK:
                raise AssertionError(f"CellManager: {type(msg).__name__} "
                                     f"refused: {r}")

    dl, tx, ul, g = req
    mgr = cm.CellManager(device=dev)
    handle(cm.ConfigRequest(cell=flagship.CELL), cm.StartRequest())
    cond = mgr.conductor
    st = cond.stage_payloads([(dl, tx)])
    _, pend = cond.process_slot(dl, ul, st, 0, phases[g]["rx"],
                                prach_fd=prach_in)
    flagship.check_results(pend.resolve(), phases[g],
                           "graphed DU-low slot before a reconfiguration")
    graph = cond.graph_of(dl, ul, st.stride)
    if graph is None:
        raise AssertionError("the DU-low slot ran without its CUDA graph")
    graph_b = graph.nbytes
    del cond, st, pend, graph
    before = reserved()
    handle(cm.StopRequest(), cm.ConfigRequest(cell=flagship.DU_SMALL_CELL),
           cm.StartRequest())
    after = reserved()
    del mgr
    if after > before - graph_b:
        raise AssertionError(
            f"reconfiguration: memory reserved {before} B before, {after} B "
            f"after; the old conductor's slot graph ({graph_b} B) not "
            f"released")
    return before, after, graph_b


# --------------------------------------------------------------- phase 13

def _alloc_requests(pay: dict, du: dict) -> list:
    """Phase 13's slots: (kind, dl, tx, ul, conductor phase) for E, F, G at
    ALLOC_SLOTS and then phase 12's slot ALLOC_A (kind A)."""
    out = []
    for kind, count in ALLOC_SLOTS:
        dl, tx = flagship.du_alloc_request(kind, count, pay)
        g = (count // 2) % flagship.N_PHASES
        ul = dataclasses.replace(flagship.ul_request(g), slot=dl.slot)
        out.append((kind, dl, tx, ul, g))
    dl, tx, ul, g = du["req"]
    return out + [("A", dl, tx, ul, g)]


def _alloc_slots(cli, reqs, du, refs, where) -> dict:
    """Each phase-13 slot through a client: dl_tti with samples (E, F, A
    held to their references; G answered with MSG_SLOT_ERR), rx_samples
    and ul_tti (held to phase 4's checks); returns the samples by kind."""
    out = {}
    for kind, dl, tx, ul, g in reqs:
        got = cli.dl_tti(dl, tx, want_samples=True)
        if kind == "G":
            if not (isinstance(got, cm.ErrorIndication)
                    and got.error_code is cm.ErrorCode.MSG_SLOT_ERR
                    and got.message_id == "dl_tti"
                    and (got.sfn, got.slot) == (dl.slot.sfn,
                                                dl.slot.slot_index)):
                raise AssertionError(f"{where}: slot G gave {got!r}")
            out[kind] = got
        else:
            if refs is not None:
                close(torch.from_numpy(got), refs[kind],
                      f"{where} slot {kind}: samples")
            out[kind] = got
        cli.rx_samples(du["rx"][g], prach_fd=du["prach"])
        flagship.check_results(cli.ul_tti(ul), du["phases"][g],
                               f"{where} slot {kind}")
    return out


def _ue_decode(samples: np.ndarray, dl, pay: dict, dev, where) -> str:
    """The UE side of slot E or F (K4, K28, K15): every DCI with crc_ok and
    its exact payload, and the PBCH with crc_ok and the MIB sent."""
    dcis, pbch = flagship.du_control_rx(torch.from_numpy(samples).to(dev), dl)
    sent = (pay["dci"][:len(dl.pdcch)] if dl.ssb else pay["dci"][-1:])
    for j, ((bits, ok), want) in enumerate(zip(dcis, sent)):
        if not (bool(ok) and np.array_equal(bits.cpu().numpy(), want)):
            raise AssertionError(f"{where}: DCI {j} (AL "
                                 f"{dl.pdcch[j].aggregation_level}) not "
                                 f"decoded")
    for (a, ok), cfg in zip(pbch, dl.ssb):
        if not (bool(ok) and np.array_equal(ssb.pbch_extract_mib(a, cfg),
                                            pay["mib"])):
            raise AssertionError(f"{where}: PBCH / MIB not decoded")
    return (f"{len(dcis)} DCI(s) at AL "
            f"{[c.aggregation_level for c in dl.pdcch]}"
            + (" and the PBCH (24 MIB bits)" if pbch else ""))


def du_alloc_phase(dev, rng, card, du: dict) -> tuple:
    """Phase 13: K28 and the extended K2, K15, K26 against their twins,
    then the DU-low's allocation slots: the port's du_low in its own
    process over TCP (slots E, F, G and phase 12's slot A), the UE side of
    E and F (K4, K28, K15), then the same through ``serve_phy`` in a thread
    with the launch counts reset before and read after."""
    cases = flagship.alloc_kernel_cases(rng, dev)
    results = kernel_phases(cases, rs_library(cases))
    print("K28, and K26 (type 0 with 61 PRG matrices, interleaved, type 2 "
          "on ports 0, 1, 4, 5), K2 (type 0, n_ref 3N/4) and K15 (an AL16 "
          "DCI with its syndrome, a PBCH codeword; one per launch, as the "
          "UE side) held to their twins (bit-exact); library: K26's scatter "
          "stage (index_put_), null for the others (no single PyTorch call "
          "computes them)", flush=True)

    deadline = time.monotonic() + DU_PHASE_S
    pay = flagship.du_alloc_payloads(rng)
    reqs = _alloc_requests(pay, du)
    cpu = SlotConductor(flagship.CELL, device="cpu")
    refs = {kind: cpu.process_dl(dl, tx, return_grid=False)[0]
            for kind, dl, tx, _, _ in reqs if kind in "EF"}
    refs["A"] = du["ref"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "srsran_tpu_torch.apps.du_low", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = _ready_port(proc, deadline)
        cli = FapiClient("127.0.0.1", port,
                         timeout=max(1.0, deadline - time.monotonic()))
        cli.configure(flagship.CELL)
        samples = _alloc_slots(cli, reqs, du, refs, "du_low")
        cli.stop()
        code = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        tail = proc.stdout.read().strip()
        if code != 0:
            raise AssertionError(f"du_low exited {code}: {tail}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    dl_of = {kind: dl for kind, dl, _, _, _ in reqs}
    said = [_ue_decode(samples[k], dl_of[k], pay, dev, f"UE slot {k}")
            for k in "EF"]
    print(f"du_low (its own process): slot E (SSB, five DCIs, a 4-layer "
          f"256QAM PDSCH on RA type 0 PRBs {flagship.DU_E_PRBS[0]}-143 and "
          f"160-{flagship.DU_E_PRBS[-1]} precoded per PRG) and F (a PDSCH on "
          f"interleaved VRBs 0-135) within 1e-4 of the port's conductor on "
          f"the CPU twins; G (type 0 with PT-RS) answered "
          f"{samples['G'].error_code.name} ({samples['G'].detail!r}); then "
          f"phase 12's slot A within 1e-4 of its reference; every UL "
          f"indication as phase 4 requires; {tail!r}", flush=True)
    print(f"UE side (K4, K28, K15): slot E {said[0]}; slot F {said[1]}: "
          f"CRC ok, exact payloads", flush=True)

    stats: dict = {}
    box = {}
    ready = threading.Event()

    def serve():
        try:
            serve_phy(ready_cb=lambda p: (box.update(port=p), ready.set()),
                      device=dev, stats=stats)
        except BaseException as e:          # reported by the main thread
            box["error"] = e
            ready.set()

    srv = threading.Thread(target=serve, daemon=True)
    srv.start()
    if not ready.wait(30.0) or "error" in box:
        raise AssertionError(f"serve_phy did not start: {box.get('error')}")
    cli = FapiClient("127.0.0.1", box["port"],
                     timeout=max(1.0, deadline - time.monotonic()))
    cli.configure(flagship.CELL)
    _alloc_slots(cli, reqs, du, None, "serve_phy warm-up")
    counted = [(kind, dataclasses.replace(dl, slot=SlotPoint(
                    1, dl.slot.count + 40)),
                dataclasses.replace(tx, slot=SlotPoint(1, tx.slot.count + 40)),
                dataclasses.replace(ul, slot=SlotPoint(1, ul.slot.count + 40)),
                g) for kind, dl, tx, ul, g in reqs]
    torch.cuda.synchronize()
    kernels.reset_counts()
    got = _alloc_slots(cli, counted, du, None, "serve_phy")
    said = [_ue_decode(got[k], dl, pay, dev, f"UE slot {k} (serve_phy)")
            for k, dl, _, _, _ in counted if k in "EF"]
    torch.cuda.synchronize()
    launches = launched(ALLOC_PATH)
    cli.stop()
    srv.join(timeout=max(1.0, deadline - time.monotonic()))
    if srv.is_alive() or "error" in box:
        raise AssertionError(f"serve_phy did not end: {box.get('error')}")
    if launches["control_llrs"] != 2:
        raise AssertionError(f"K28 launched {launches['control_llrs']} "
                             f"times for the two UE-side slots")
    print(f"phase 13 launches (slots E, F, G, A through serve_phy and the "
          f"UE side of E and F): {launches}; card {card}", flush=True)
    return results, {k: launches[k] for k in ALLOC_KERNELS}

# --------------------------------------------------------------- phase 14

def _app(module: str, args: list, deadline: float) -> str:
    """``python -m srsran_tpu_torch.apps.<module> args`` in its own process
    (on the card); its standard output."""
    proc = subprocess.run(
        [sys.executable, "-m", f"srsran_tpu_torch.apps.{module}", *args],
        capture_output=True, text=True,
        timeout=max(1.0, deadline - time.monotonic()))
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return proc.stdout


def _ssb_slots() -> list:
    """(slot count, SsbConfig, MIB bits) of ssb_tx's SSB slots, the MIBs
    drawn as the app draws them (``default_rng(0)``, 24 bits per SSB)."""
    rng = np.random.default_rng(0)
    out = []
    for count in range(SSB_TX_FRAMES * ssb_tx.SLOTS_PER_FRAME):
        cfg = ssb_tx.ssb_config(SlotPoint(1, count), SSB_TX_CELL, SSB_TX_PCI)
        if cfg is not None:
            out.append((count, cfg, rng.integers(0, 2, 24).astype(np.int8)))
    return out


def _pbch_llrs(block: torch.Tensor, count: int, cfg) -> torch.Tensor:
    """The PBCH's descrambled LLRs [864] of one SSB slot's samples [1, T]:
    K4 at the slot's place in its subframe, then K28 at the SSB's first
    subcarrier."""
    cell = SSB_TX_CELL
    grid = ofdm.demodulate_slot(block, cell.nof_sc, cell.dft_size,
                                cell.numerology, cell.cp,
                                SlotPoint(1, count).subframe_slot_index,
                                cell.center_freq_hz).contiguous()
    return dl_control.control_llrs(grid, (ssb.rx_item(
        cfg, tuple(grid.shape), 0, noise_var=0.01),))


def _mib_both(llrs: torch.Tensor, cfg) -> tuple:
    """The MIB from one PBCH's LLRs by K15 (SC) and by K29 (CA-SCL8 with
    CRC24C, after the port's polar rate dematch); with the dematched LLRs."""
    a, ok = ssb.pbch_decode_llrs(llrs, cfg)
    code = ssb._pbch_code()
    lm = polar.rate_dematch(llrs.reshape(1, -1), code)
    bits, ok8 = polar_scl.scl_decode(lm, code, SCL_LIST, "crc24C")
    a8 = ssb.pbch_scramble_payload(bits[0, :ssb.PBCH_A].cpu().numpy(), cfg)
    return ((ssb.pbch_extract_mib(a, cfg), bool(ok)),
            (ssb.pbch_extract_mib(a8, cfg), bool(ok8[0])), lm)


def _rx_power_numpy(x: np.ndarray, fft: int = 1024,
                    block: int = 1 << 16) -> list:
    """apps/rx_power.py's arithmetic in numpy on the same samples: per
    channel (avg dB, peak dB, PAPR dB, occupied share in %)."""
    nch, n = x.shape
    total, peak = np.zeros(nch), np.zeros(nch)
    psd, nseg, win = np.zeros((nch, fft)), 0, np.hanning(fft)
    for b0 in range(0, n, block):
        blk = x[:, b0:b0 + block]
        p = np.abs(blk) ** 2
        total += p.sum(axis=-1)
        peak = np.maximum(peak, p.max(axis=-1))
        starts = [s * fft // 2 for s in range(max(blk.shape[-1]
                                                  // (fft // 2) - 1, 0))]
        starts = [a for a in starts if a + fft <= blk.shape[-1]]
        if starts:
            seg = blk[:, np.asarray(starts)[:, None] + np.arange(fft)]
            spec = np.fft.fftshift(np.fft.fft(seg * win, axis=-1), axes=-1)
            psd += (np.abs(spec) ** 2).sum(axis=1)
            nseg += len(starts)
    p = psd / nseg
    occ = (p > p.max(axis=-1, keepdims=True) * 1e-3).mean(axis=-1)
    out = []
    for ch in range(nch):
        avg_db = 10 * math.log10(max(total[ch] / n, 1e-30))
        peak_db = 10 * math.log10(max(peak[ch], 1e-30))
        out.append((avg_db, peak_db, peak_db - avg_db, f"{occ[ch] * 100:.0f}"))
    return out


def _check_rx_power(printed: str, want: list) -> str:
    levels = re.findall(r"ch(\d+): avg\s+(-?[\d.]+) dBFS\s+peak\s+(-?[\d.]+) "
                        r"dBFS\s+PAPR\s+(-?[\d.]+) dB", printed)
    shares = re.findall(r"ch(\d+): occupied bandwidth ~(\d+)% of fs", printed)
    if len(levels) != len(want) or len(shares) != len(want):
        raise AssertionError(f"rx_power printed {printed!r}")
    for (ch, avg, pk, papr), (_, share), w in zip(levels, shares, want):
        got = (float(avg), float(pk), float(papr))
        if (any(abs(a - b) > RX_POWER_DB_TOL for a, b in zip(got, w[:3]))
                or share != w[3]):
            raise AssertionError(f"rx_power ch{ch}: {got}, {share}% vs "
                                 f"numpy {w}")
    return printed.strip().replace("\n", " |")


def _rate_match_one_ref(cw, e, *args):
    return ldpc_rate_match.rate_match_batch_ref(
        cw, (e,) * cw.shape[0], *args).reshape(cw.shape[0], e)


def _rate_dematch_one_ref(llrs, rv, qm, bg, z, k_prime, k, n):
    """Plain twin of the single-codeblock ``ldpc_rate_match.rate_dematch``
    (K2 with one codeblock per row and no soft buffer)."""
    b, e = llrs.shape
    soft, _ = ldpc_rate_match.rate_dematch_combine_ref(
        llrs.reshape(-1), b, (e,) * b, rv, qm, bg, z, k_prime, k, n)
    soft[:, k_prime - 2 * z:k - 2 * z] = ldpc_rate_match.FILLER_LLR
    return soft


def _noisy_llrs(bits: torch.Tensor, rng) -> torch.Tensor:
    """BPSK LLRs of ``bits`` with unit Gaussian noise from ``rng``."""
    noise = torch.from_numpy(rng.normal(size=tuple(bits.shape)).astype(
        np.float32)).to(bits.device)
    return 1.0 - 2.0 * bits.to(torch.float32) + noise


def _lowsnr(rng, dev) -> tuple:
    """The low-SNR PBCH-like experiment: K15 (SC) and K29 (CA-SCL8) block
    errors on the same LLRs, and K29's arguments."""
    k_payload = 32
    code = polar_params.polar_code(k_payload + 24, 240, 9, False)
    payload = rng.integers(0, 2, (LOWSNR_BLOCKS, k_payload)).astype(np.int8)
    with_crc = torch.cat([torch.as_tensor(payload),
                          crc(torch.as_tensor(payload), "crc24C")], dim=1)
    x = polar.rate_match(polar.encode(polar.allocate(with_crc, code),
                                      code.n), code).numpy()
    rx = (1.0 - 2.0 * x) + rng.normal(0, LOWSNR_SIGMA, x.shape)
    llr = torch.as_tensor((2 * rx / LOWSNR_SIGMA ** 2).astype(
        np.float32)).to(dev)
    sc, _ = polar.decode(llr, code, "crc24C")
    lm = polar.rate_dematch(llr, code)
    scl, _ = polar_scl.scl_decode(lm, code, SCL_LIST, "crc24C")
    want = torch.as_tensor(payload).to(dev)
    errors = [int((b[:, :k_payload] != want).any(dim=1).sum())
              for b in (sc, scl)]
    return errors, (lm, code, SCL_LIST, "crc24C")


def _dci_lists(dev, samples: torch.Tensor, dl, pay: dict) -> str:
    """Phase 13's slot E on the card: each DCI (AL 16, 8, 4, 2, 1) through
    K29 at L = 8 and L = 1 with crc_poly=None, bit-exact to the twin; at L
    = 1 the messages equal K15's; at L = 8 the payload sent."""
    cell = flagship.CELL
    grid = ofdm.demodulate_slot(samples, cell.nof_sc, cell.dft_size,
                                cell.numerology, cell.cp, 0,
                                cell.center_freq_hz).contiguous()
    items = tuple(pdcch.rx_item(c, tuple(grid.shape), 0.01) for c in dl.pdcch)
    llrs = dl_control.control_llrs(grid, items)
    parts = torch.split(llrs, dl_control.rx_plan(items, grid.numel())["e"])
    for p, c, sent in zip(parts, dl.pdcch, pay["dci"]):
        a = c.payload_bits
        code = pdcch._dci_code(a + 24, pdcch.BITS_PER_CCE * c.aggregation_level)
        lm = polar.rate_dematch(p.reshape(1, -1), code)
        for size in (SCL_LIST, 1):
            got = polar_scl.scl_decode(lm, code, size)
            ref = polar_scl.scl_decode_ref(lm, code, size)
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                                ref[1])):
                raise AssertionError(f"K29 L={size} on the AL"
                                     f"{c.aggregation_level} DCI differs "
                                     f"from its twin")
            if size == 1:
                sc, _ = polar.decode(p.reshape(1, -1), code, "crc24C",
                                     pdcch.dci_syndrome(a, c.rnti))
                if not torch.equal(got[0], sc):
                    raise AssertionError(f"K29 L=1 on the AL"
                                         f"{c.aggregation_level} DCI differs "
                                         f"from K15")
            elif not np.array_equal(got[0][0, :a].cpu().numpy(), sent):
                raise AssertionError(f"K29 L=8: the AL{c.aggregation_level} "
                                     f"DCI's payload not decoded")
    return (f"slot E's DCIs at AL {[c.aggregation_level for c in dl.pdcch]}: "
            f"K29 (L = 8 and 1, no CRC) bit-exact to its twin, L = 8 the "
            f"payloads sent, L = 1 equal to K15's messages")


def _bound_text(nbytes_: float, ops: float) -> str:
    t_bytes, t_ops = nbytes_ / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (f"bound {1e3 * max(t_bytes, t_ops):.6f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'})")


def _plain_products(rng, dev) -> str:
    """ms by events of the UE side's plain DFT products, each beside its
    bound: transform precoding of 12 data symbols at the cell edge's M = 72
    and the widest M = 3240 (the blocks read and written once; an FFT's
    operations), and the cell edge's PUCCH F3 encode (22 bits, 2 RB: the
    bits read and the RE values written once; an FFT's operations per
    data symbol and ~4 per coded bit for the polar encode, scrambling and
    modulation)."""
    out = []
    for m in (12 * flagship.EDGE.pusch_c.rb_count, 3240):
        x = torch.from_numpy((rng.normal(size=(12, m)) + 1j * rng.normal(
            size=(12, m))).astype(np.complex64)).to(dev)
        ms = median_ms(lambda x=x: transform_precode.precode(x))
        out.append(f"precode M = {m} {ms:.4f} ms, "
                   f"{_bound_text(2 * nbytes(x), fft_ops(m, 12))}")
    cfg = flagship.EDGE.f3
    bits = torch.from_numpy(rng.integers(0, 2, cfg.nof_uci_bits).astype(
        np.int8)).to(dev)
    ms = median_ms(lambda: pucch.f3_encode(bits, cfg))
    m, n_data = 12 * cfg.nof_rb, len(pucch._f3_symbol_split(cfg)[1])
    coded = n_data * m // cfg.occ_length * pucch._f3_qm(cfg)
    res = pucch.f3_encode(bits, cfg)
    bound_f3 = _bound_text(nbytes(bits) + nbytes(res),
                           fft_ops(m, n_data) + 4.0 * coded)
    out.append(f"f3_encode {ms:.4f} ms, {bound_f3}")
    return ", ".join(out)


def _round_trips(x: np.ndarray) -> str:
    """A DL slot's samples [P, T] through RuRing (both rings) and RuDummy
    in two reads each: equal samples and the reads' timestamps."""
    p, t = x.shape
    half = t // 2
    ring = RuRing(p, capacity=2 * t)
    ring.send_dl(x, 0)
    out, ts = ring.tx.read(t)
    if ts != 0 or not np.array_equal(out, x):
        raise AssertionError("RuRing: DL samples differ")
    ring.rx.write(x)
    (a, ta), (b, tb) = ring.receive_ul(half), ring.receive_ul(t - half)
    dummy = RuDummy(p, capacity=2 * t)
    dummy.send_dl(x[:, :half], 0)
    dummy.send_dl(x[:, half:], half)
    (c, tc), (d, td) = dummy.receive_ul(t - half), dummy.receive_ul(half)
    if ((ta, tb, tc, td) != (0, half, 0, t - half)
            or not np.array_equal(np.concatenate([a, b], axis=1), x)
            or not np.array_equal(np.concatenate([c, d], axis=1), x)
            or ring.receive_ul(1) is not None
            or dummy.receive_ul(1) is not None):
        raise AssertionError("RuRing / RuDummy round trip failed")
    return f"{p} x {t} samples, timestamps 0 and {half}: RuRing and RuDummy"


def split8_phase(dev, rng, card) -> tuple:
    """Phase 14: the split-8 radio and the UE-side list decoder.  ssb_tx
    and rx_power in their own processes at the flagship width; the file
    read back and each SSB's MIB decoded by K15 and by K29; a CFO processor
    (K30) over the file's blocks and a clip (K31) of them, counted; then
    K29-K32 against their twins and timed, the DCIs of phase 13's slot E
    through K29, the low-SNR experiment, and the radio units' round
    trips."""
    deadline = time.monotonic() + SPLIT8_PHASE_S
    path = SPLIT8_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    said = _app("ssb_tx", [str(path), "--pci", str(SSB_TX_PCI), "--nof-rb",
                           str(SSB_TX_CELL.nof_rb), "--dft",
                           str(SSB_TX_CELL.dft_size), "--frames",
                           str(SSB_TX_FRAMES)], deadline).strip()
    t_tx = time.perf_counter() - t0
    t0 = time.perf_counter()
    printed = _app("rx_power", [str(path)], deadline)
    t_rx = time.perf_counter() - t0
    rd = SampleFileReader(str(path))
    fs = rd.sample_rate
    x = rd.read(1 << 26)
    rd.close()
    slot_len = SSB_TX_CELL.slot_samples()
    n_slots = SSB_TX_FRAMES * ssb_tx.SLOTS_PER_FRAME
    if x.shape != (1, n_slots * slot_len):
        raise AssertionError(f"ssb_tx wrote {x.shape}, want "
                             f"{(1, n_slots * slot_len)}")
    print(f"ssb_tx (its own process, {t_tx:.1f} s): {said!r}; rx_power "
          f"({t_rx:.1f} s): {_check_rx_power(printed, _rx_power_numpy(x))}"
          f" -- within {RX_POWER_DB_TOL} dB of numpy, the share equal",
          flush=True)

    # The main path: the file's blocks on the card, each SSB's MIB by K15
    # and K29, a CFO processor over every block, a clip of the whole.
    ssbs = _ssb_slots()
    whole = torch.from_numpy(x).to(dev)
    blocks = [whole[:, i * slot_len:(i + 1) * slot_len]
              for i in range(n_slots)]
    ceiling = flagship.clip_ceiling_dbfs(whole)
    torch.cuda.synchronize()
    kernels.reset_counts()
    pbch_lm = []
    for count, cfg, mib in ssbs:
        (m15, ok15), (m29, ok29), lm = _mib_both(
            _pbch_llrs(blocks[count], count, cfg), cfg)
        if not (ok15 and ok29 and np.array_equal(m15, mib)
                and np.array_equal(m29, mib)):
            raise AssertionError(f"slot {count}: MIB not decoded (K15 "
                                 f"{ok15}, K29 {ok29})")
        pbch_lm.append(lm)
    proc = cfo.CfoProcessor(fs)
    proc.schedule(cfo.CfoCommand(time_s=0.0, cfo_hz=CFO_HZ,
                                 cfo_drift_hz_s=CFO_DRIFT_HZ_S))
    cfo_err = 0.0
    for i, blk in enumerate(blocks):
        proc.next_command(i * slot_len / fs)
        ref = cfo.apply_cfo_ref(blk, proc.cfo_norm, proc._sample_offset)
        cfo_err = max(cfo_err, close(proc.process(blk), ref,
                                     f"CFO block {i}", rtol=1e-6))
    clipped, m = amplitude_control.clip(whole, 0.0, ceiling)
    torch.cuda.synchronize()
    launches = launched(SPLIT8_PATH)
    compare("amplitude_control_file", (clipped, m),
            amplitude_control.clip_ref(whole, 0.0, ceiling))
    want = {"polar_scl_decode": len(ssbs), "cfo_rotate": n_slots,
            "amplitude_control": 1}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"phase 14 launches {launches}, want {want}")
    print(f"phase 14 main path: the MIB of SSB slots "
          f"{[c for c, _, _ in ssbs]} decoded by K15 and by K29 "
          f"(CA-SCL{SCL_LIST}, CRC24C) from ssb_tx's file; CFO {CFO_HZ} Hz + "
          f"{CFO_DRIFT_HZ_S} Hz/s over {n_slots} blocks within {cfo_err:.3g} "
          f"of the twin; clip at {ceiling:.2f} dBFS: "
          f"{float(m.clipped_ratio):.4f} clipped, PAPR "
          f"{float(m.papr_db):.2f} dB; launches {launches}; card {card}",
          flush=True)

    # K29-K32 against their twins, timed.
    pay = flagship.du_alloc_payloads(rng)
    dl, tx = flagship.du_alloc_request("E", 2, pay)
    cond = SlotConductor(flagship.CELL, device=dev)
    dl_slot, _ = cond.process_dl(dl, tx, return_grid=False)
    cases = flagship.split8_kernel_cases(rng, dev, dl_slot, CFO_HZ / fs)
    (sc_err, scl_err), lowsnr_args = _lowsnr(rng, dev)
    rm = cases["rate_match"][2]
    cbs, e_sizes = rm[:2]
    n_ref = 3 * cbs.shape[1] // 4
    cases.update({
        "polar_scl_decode_pbch": (polar_scl.scl_decode,
                                  polar_scl.scl_decode_ref,
                                  (torch.cat(pbch_lm), ssb._pbch_code(),
                                   SCL_LIST, "crc24C")),
        "polar_scl_decode_lowsnr": (polar_scl.scl_decode,
                                    polar_scl.scl_decode_ref, lowsnr_args),
        **{f"rate_match_rv{rv}": (ldpc_rate_match.rate_match_batch,
                                  ldpc_rate_match.rate_match_batch_ref,
                                  rm[:2] + (rv,) + rm[3:])
           for rv in (1, 2, 3)},
        "rate_match_nref": (ldpc_rate_match.rate_match, _rate_match_one_ref,
                            (cbs[:1], e_sizes[0]) + rm[2:] + (n_ref,)),
        "rate_dematch_single": (ldpc_rate_match.rate_dematch,
                                _rate_dematch_one_ref,
                                (_noisy_llrs(ldpc_rate_match.rate_match(
                                    cbs, e_sizes[0], *rm[2:]), rng),)
                                + rm[2:] + (cbs.shape[1],)),
        "cfo_rotate_file": (cfo.apply_cfo, cfo.apply_cfo_ref,
                            (whole, CFO_HZ / fs, 0)),
        "amplitude_control_file": (amplitude_control.clip,
                                   amplitude_control.clip_ref,
                                   (whole, 0.0, ceiling)),
        "amplitude_control_scale": (
            amplitude_control.scale,
            lambda s, g: amplitude_control.clip_ref(s, g, math.inf),
            (dl_slot, -3.0)),
    })
    results = kernel_phases(cases,
                            {"rate_match": launch_profile.take_call(rm)})
    if not (sc_err >= 8 and scl_err < sc_err // 2):
        raise AssertionError(f"low SNR: CA-SCL{SCL_LIST} {scl_err} block "
                             f"errors vs SC {sc_err}")
    print(f"K29 (the UE slot's {flagship.UE_CANDIDATES} AL16 candidates, the "
          f"{len(ssbs)} PBCHs, the low-SNR batch), K32 (the flagship "
          f"PUSCH's {cbs.shape[0]} codeblocks at rv 0-3, one codeblock at "
          f"n_ref = {n_ref}), K30 and K31 (slot E's {tuple(dl_slot.shape)} "
          f"samples, clip at {cases['amplitude_control'][2][2]:.2f} dBFS, "
          f"and the file's) held to their twins; low SNR (sigma {LOWSNR_SIGMA}, B = "
          f"{LOWSNR_BLOCKS}): CA-SCL{SCL_LIST} {scl_err} block errors, K15 "
          f"(SC) {sc_err}", flush=True)
    print(_dci_lists(dev, dl_slot, dl, pay), flush=True)
    print(f"UE-side plain products (torch.matmul, no kernel): "
          f"{_plain_products(rng, dev)}; card {card}", flush=True)
    print(f"split-8 round trips: {_round_trips(dl_slot.cpu().numpy())}; "
          f"phase 14 took {SPLIT8_PHASE_S - (deadline - time.monotonic()):.1f}"
          f" s of its {SPLIT8_PHASE_S} s", flush=True)
    return results, {k: launches[k] for k in SPLIT8_KERNELS}


# --------------------------------------------------------------- phase 15

def mu_batch_phase(dev, gen, rng, card) -> tuple:
    """Phase 15: the two-UE slot in the slot-batch mode.  B = 4 two-UE
    slots at one RI (``flagship.mu_batch``) beside the flagship DL of the
    batch mode's phases through ``process_slot_batch``: each slot equal to
    ``process_slot``, every TB, UCI field and PRACH detection as sent, K16
    once per PUSCH and K17 once per batch (nothing per slot), us per slot
    over N_TIMED_BATCHES graphed batches; then the batched K16 and K17
    against their twins and their unbatched launches.  Returns (the
    batched rows' results, their launches in one batch)."""
    t0 = time.perf_counter()
    slots = flagship.mu_batch(rng, gen, dev)
    grp = flagship.BATCH_PHASES
    cond = SlotConductor(flagship.CELL)
    pay = flagship.dl_payloads(rng)
    batch = [(flagship.dl_request(g),
              flagship.mu_ul_request(g, flagship.MU_BATCH_RI)) for g in grp]
    rx_b = torch.stack([s["rx"] for s in slots])
    prach_b = (torch.stack([flagship.prach_fd(dev, SEED)[0]] * len(grp)),)

    def stage():
        return cond.stage_payloads([(d, flagship.tx_request(g, pay))
                                    for g, (d, _) in zip(grp, batch)])

    def check(res, where):
        for b, s in enumerate(slots):
            flagship.check_mu_results(res[b], s, f"{where}, slot {b}")

    torch.cuda.synchronize()
    print(f"two-UE batch transmitters: {len(slots)} slots at RI "
          f"{flagship.MU_BATCH_RI} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    st = stage()
    tx_b, pend_b = cond.process_slot_batch(batch, st, rx_b, prach_fd=prach_b)
    mib = _last_graph(cond).nbytes >> 20
    check(_batch_vs_slots(cond, batch, st, rx_b, prach_b, tx_b, pend_b,
                          "two-UE batch"), "two-UE batch")
    torch.cuda.synchronize()
    kernels.reset_counts()
    _, pend_b = cond.process_slot_batch(batch, stage(), rx_b,
                                        prach_fd=prach_b)
    check(pend_b.resolve(), "counted two-UE batch")
    launches = batch_counts(MU_BATCH_LAUNCHES, "two-UE batch")
    csi2 = flagship.CSI2_SIZES[flagship.MU_BATCH_RI]
    print(f"two-UE batch of {len(grp)} (slots {list(grp)}, both PUSCHs MMSE, "
          f"UE B with ACK, CSI1 and {csi2} CSI2 bits): equal to "
          f"process_slot slot by slot, every TB, UCI field and PRACH as "
          f"sent; launches per batch {launches}, none per slot; memory "
          f"reserved by its capture {mib} MiB", flush=True)
    print(f"two-UE batch: "
          f"{_timed_batches(cond, batch, stage, rx_b, prach_b, check)}, "
          f"card {card}", flush=True)
    results = batched_kernel_phase(
        MU_KERNELS, [flagship.mu_kernel_cases(s, gen) for s in slots],
        "K16-K17")
    return results, launches


# --------------------------------------------------------------- phase 16

def _hard_bits(res: torch.Tensor) -> torch.Tensor:
    """QPSK hard decisions of REs [n] -> bits int8 [2n] (bit 1 below 0)."""
    return torch.stack([res.real < 0, res.imag < 0], dim=-1).reshape(-1).to(
        torch.int8)


def _dci_check(grid: torch.Tensor, cfg, payload: torch.Tensor,
               encoded: torch.Tensor, decoded: tuple) -> None:
    """``encode_dci``'s bits (K33), scrambled, equal the bits K27 mapped for
    this DCI into ``grid``, and K28 + K15 decode them back."""
    bits = scramble_bits(encoded[None],
                         ((cfg.n_rnti << 16) + cfg.n_id_data) % (1 << 31))[0]
    offs = const(pdcch._candidate_re_offsets, cfg.coreset, cfg.cce_index,
                 cfg.aggregation_level, tuple(grid.shape), device=grid.device)
    if not torch.equal(_hard_bits(grid.reshape(-1)[offs]), bits):
        raise AssertionError(f"AL{cfg.aggregation_level}: encode_dci differs "
                             f"from K27's PDCCH bits")
    dec, ok = decoded
    if not (bool(ok) and torch.equal(dec.to(torch.int8), payload)):
        raise AssertionError(f"AL{cfg.aggregation_level}: K28 + K15 did not "
                             f"decode encode_dci's DCI")


def last_functions_phase(dev, rng, ul_slot, card) -> tuple:
    """Phase 16: the last device functions on the flagship cell.  The
    counted main path is ``flagship.last_path`` (the PBCH and slot E's DCIs
    through K33 beside K27, the F2s and a UCI batch through K33/K34, K34
    at every K and Qm, phase 2's PUSCH LLRs through K35 and decoded, K1's
    codeblocks through K36, K8 on slot E's type 0 comb); then its checks,
    and each case against its twin, timed, with its bound and (K33, K34)
    the GF(2) product's time.  Returns (the results, K35's and K36's
    launches on the main path)."""
    t0 = time.perf_counter()
    cell = flagship.CELL
    inp = flagship.last_inputs(rng, ul_slot, dev)
    torch.cuda.synchronize()
    kernels.reset_counts()
    out = flagship.last_path(inp)
    torch.cuda.synchronize()
    launches = launched(LAST_PATH)

    pbch_res = out["ssb_patch"].reshape(-1)[const(
        ssb._data_index, flagship.SSB.phys_cell_id % 4, device=dev)]
    if not torch.equal(_bits(pbch_res), _bits(out["pbch"])):
        raise AssertionError("pbch_encode -> pbch_modulate differs from K27's "
                             "PBCH REs")
    for dci in zip(inp["dcis"], inp["dci_payloads"], out["encoded_dcis"],
                   out["decoded_dcis"]):
        _dci_check(out["pdcch_grid"], *dci)
    for got, cfg, key in zip(out["f2_grids"], (flagship.F2_POLAR,
                                               flagship.F2_SB),
                             ("f2_polar", "f2_sb")):
        ref = pucch.transmit_format2(torch.zeros_like(got, device="cpu"),
                                     cfg, inp["uci"][key])
        close(got.cpu(), ref, f"phase 16 F2 of {cfg.nof_uci_bits} bits",
              rtol=1e-6)
    res = out["pusch"]
    checks = {
        "the PUSCH's quantized LLRs decode (TB CRC)": bool(res.tb_crc_ok),
        "with the exact payload": torch.equal(res.tb_bits, ul_slot[0]),
        "K36: all of K1's codeblocks pass": bool(out["parity"].all()),
        "K36: each flipped codeblock fails":
            not bool(out["parity_flipped"].any()),
        "K34 equals its twin at K 1-11, Qm 1, 2, 4, 6": all(
            torch.equal(got, short_block.encode_ref(
                inp["sb_bits"][:, :k], e, qm))
            for (k, qm, e), got in out["short_blocks"].items()),
        "K33 on the UCI batch equals its twin": torch.equal(
            out["uci_batch"], polar.encode_chain_ref(inp["uci_msg"],
                                                     inp["uci_code"])),
    }
    for td, est in out["chest"].items():
        ta = float(est.time_alignment_s) * 2048 * (15_000 << cell.numerology)
        checks[f"K8 type 0 ({td}): the channel's delay"] = (
            round(ta) == flagship.TYPE0_DELAY)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 16: not met: {failed}")
    seg = flagship.SEG
    rows = len(get_graph(seg.base_graph, seg.lifting_size).rows)
    print(f"phase 16 main path: the PBCH through pbch_encode (K33) and "
          f"pbch_modulate equal to K27's patch bit for bit; slot E's DCIs at "
          f"AL {[d.aggregation_level for d in inp['dcis']]} through "
          f"encode_dci (K33) equal to K27's bits and decoded back by K28 + "
          f"K15; the F2s' 22 and 6 bits (K33, K34) and "
          f"{flagship.LAST_UCI_BATCH} UCI codewords (K = "
          f"{inp['uci_code'].k}, E = {inp['uci_code'].e}) sent; K34 at K "
          f"1-11, Qm {flagship.SB_QMS}; the flagship PUSCH's "
          f"{out['llr'].numel()} LLRs through K35 decoded with the exact "
          f"payload ({int(res.nof_iterations)} sweeps); K36 on K1's "
          f"{seg.nof_codeblocks} codeblocks ({int(out['sweeps'])} sweeps, all "
          f"{rows} rows): all pass, each with one bit flipped fails; K8 on "
          f"slot E's type 0 comb ({len(inp['chest']['average'][0][4])} "
          f"pilots, 2 layers, cdm_pairs): the channel's delay of "
          f"{flagship.TYPE0_DELAY} samples; launches {launches}; card {card}",
          flush=True)

    cases = flagship.last_kernel_cases(inp, out)
    library = {name: launch_profile.gf2_library(twin, *cases[name][2])
               for name, (_, twin, _) in cases.items()
               if name.startswith(("polar_encode", "short_block_encode"))}
    for name, lib in library.items():
        fn, _, args = cases[name]
        if not torch.equal(lib().to(torch.int8), fn(*args)):
            raise AssertionError(f"{name}: the GF(2) product differs")
    # K35's dequantize is one PyTorch call: int8 / a 0-dim f32 device
    # tensor promotes to f32 and divides in IEEE division, as the kernel
    q = out["llr_i8"]
    scale = torch.tensor(llr_ops.LLR_INT_MAX / llr_ops.LLR_RANGE,
                         dtype=torch.float32, device=dev)
    library["llr_dequantize"] = lambda: torch.div(q, scale)
    got = llr_ops.dequantize(q)
    if not torch.equal(library["llr_dequantize"]().view(torch.int32),
                       got.view(torch.int32)):
        raise AssertionError("llr_dequantize: torch.div differs")
    results = kernel_phases(cases, library)
    print(f"phase 16 (the last device functions): "
          f"{time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    return results, {k: launches[k] for k in LAST_KERNELS}


def _slot_of_dict(out: dict, c) -> dict:
    """Cell ``c`` of a multi-cell UL result dict (None: the whole of a
    single cell's), on the CPU."""
    return {kind: [{k: (v if c is None else v[c]).cpu() for k, v in e.items()}
                   for e in entries] for kind, entries in out.items()}


# --------------------------------------------------------------- phase 17

BPSK_PATH = ("channel_estimate", "rate_dematch", "ldpc_decode")


def bpsk_phase(dev, card) -> dict:
    """Phase 17: BPSK PUSCHs without transform precoding through
    ``pusch.process`` on the card, each counted (K3 or K16 on the path),
    decoded with the exact payload, its codeword LLRs within 1e-3 of the
    CPU twins'; then hop 2's K3 / K16 (Gold offset and pi/2-BPSK parity
    from hop 1) against their twins, timed."""
    cases = {}
    for name, cfg, kernel in (
            ("pusch_demap_pi2bpsk", flagship.BPSK_PUSCH, "pusch_demap"),
            ("pusch_demap_lxn_bpsk", flagship.BPSK_PUSCH_MMSE,
             "pusch_demap_lxn")):
        rx, payload = flagship.bpsk_rx(cfg, SEED + 17, flagship.CELL.nof_sc)
        grid = torch.as_tensor(rx).to(dev)
        kernels.reset_counts()
        res = pusch.process(grid, cfg)
        torch.cuda.synchronize()
        launches = launched(BPSK_PATH + (kernel,))
        if not (bool(res.tb_crc_ok) and np.array_equal(
                res.tb_bits.cpu().numpy(), payload)):
            raise AssertionError(f"{name}: the TB did not decode")
        llr, _, _ = pusch.codeword_llrs(grid, cfg)
        llr_cpu, _, _ = pusch.codeword_llrs(grid.cpu(), cfg)
        err = close(llr.cpu(), llr_cpu, f"{name} codeword LLRs", rtol=1e-3)
        print(f"phase 17, {cfg.modulation} PUSCH, {cfg.nof_layers} layers "
              f"{cfg.equalizer}, {cfg.rb_count} RB hopping to PRB "
              f"{cfg.second_hop_prb}: TB of {cfg.tbs} bits decoded "
              f"({int(res.nof_iterations)} sweeps), LLRs within {err:.3g} "
              f"of the CPU twins'; launches {launches}; card {card}",
              flush=True)
        hops = pusch.hop_configs(cfg)
        sym, sc = pusch._plan(hops[1], dev)
        est = pusch.estimate_channel(grid, hops[1], None)
        advance = (len(pusch._plan(hops[0], dev)[0]) * cfg.nof_layers
                   * BITS_PER_SYMBOL[cfg.modulation])
        cases[name] = (ul_demap.equalize_demap_descramble,
                       ul_demap.equalize_demap_descramble_ref,
                       (grid, est.coeffs, sym, sc, hops[1].rb_start * 12,
                        est.noise_var.mean(dim=-1), pusch._c_init(cfg),
                        cfg.modulation, cfg.nof_layers, cfg.equalizer,
                        advance))
    one_launch_a_call(cases)
    return kernel_phases(cases)


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
    kernel = "?"
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}",
                  flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    ul_results, ul_launches, ul_slots = ul_phases(dev, gen, rng, card)
    dl_results, dl_launches, dl_slots = dl_phases(dev, rng, card)
    uci_results, cond_launches, scen = conductor_phases(dev, gen, rng, card)
    # phase 5 draws from its own seed: its 8 measured slots carry both
    # RI values (RIs 0,0,0,1,1,0,1,0), so both part-2 sizes occur
    mu_results, mu_launches = mu_phases(
        dev, gen, np.random.default_rng(SEED + 5), card)
    graph_phase(scen, gen, card)
    batch_launches = batch_phase(scen, card)
    batch_results = batched_kernel_phase(
        BATCHED, conductor_batch_cases(ul_slots, dl_slots, gen, scen),
        "K1-K15")
    multi_cell_phase(dev, gen, np.random.default_rng(SEED + 8), card)
    t9 = time.perf_counter()
    edge_results, edge_launches = edge_phases(
        dev, gen, np.random.default_rng(SEED + 9), card)
    print(f"phase 9 (cell-edge): {time.perf_counter() - t9:.1f} s",
          flush=True)
    t10 = time.perf_counter()
    gnb_results, gnb_launches = gnb_sim_phase(
        dev, gen, np.random.default_rng(SEED + 10), card)
    print(f"phase 10 (gnb_sim): {time.perf_counter() - t10:.1f} s",
          flush=True)
    t11 = time.perf_counter()
    ofh_results, ofh_launches = fronthaul_phase(
        dev, np.random.default_rng(SEED + 11), card)
    print(f"phase 11 (fronthaul): {time.perf_counter() - t11:.1f} s",
          flush=True)
    t12 = time.perf_counter()
    du_results, du_launches, du = du_low_phase(
        dev, gen, np.random.default_rng(SEED + 12), card)
    print(f"phase 12 (du_low): {time.perf_counter() - t12:.1f} s",
          flush=True)
    t13 = time.perf_counter()
    alloc_results, alloc_launches = du_alloc_phase(
        dev, np.random.default_rng(SEED + 13), card, du)
    print(f"phase 13 (du_low allocations, UE side): "
          f"{time.perf_counter() - t13:.1f} s", flush=True)
    t14 = time.perf_counter()
    split8_results, split8_launches = split8_phase(
        dev, np.random.default_rng(SEED + 14), card)
    print(f"phase 14 (split-8 radio, UE-side list decoder): "
          f"{time.perf_counter() - t14:.1f} s", flush=True)
    t15 = time.perf_counter()
    mu_batch_results, mu_batch_launches = mu_batch_phase(
        dev, gen, np.random.default_rng(SEED + 15), card)
    print(f"phase 15 (two-UE batch): {time.perf_counter() - t15:.1f} s",
          flush=True)
    last_results, last_launches = last_functions_phase(
        dev, np.random.default_rng(SEED + 16), ul_slots[0], card)
    bpsk_results = bpsk_phase(dev, card)
    results = {**ul_results, **dl_results, **uci_results, **mu_results,
               **batch_results, **edge_results, **gnb_results, **ofh_results,
               **du_results, **alloc_results, **split8_results,
               **mu_batch_results, **last_results, **bpsk_results}
    # K1-K11 as their own paths launched them (phases 2, 3), K12-K15 as the
    # conductor's slots did (phase 4, which launched every kernel), K16-K17
    # as the two-UE slot did (phase 5), the batched K1-K15 as one batch of
    # phase 7 did, K18-K19 as the cell-edge slot did (phase 9), K20-K22 as
    # the scheduler-mode gnb_sim run did (phase 10), K23-K24 as the
    # fronthaul round trip did (phase 11), K25-K27 as the DU-low's slots
    # through serve_phy did (phase 12), K28 as the UE side of the DU-low's
    # allocation slots did (phase 13), K29-K31 as phase 14's main path did
    # (K32: the UE side of phase 10's gnb_sim run), the batched K18-K19 as
    # one cell-edge batch of phase 9 did, the batched K16-K17 as one
    # two-UE batch of phase 15 did, K33-K34 as phase 4's UE side did (its
    # F2s), K35-K36 as phase 16's main path did
    launches = {**cond_launches, **ul_launches, **dl_launches,
                **{k: mu_launches[k] for k in MU_KERNELS}, **batch_launches,
                **{k: edge_launches[k] for k in EDGE_KERNELS},
                **{f"{k}_batch": edge_launches[f"{k}_batch"]
                   for k in EDGE_KERNELS},
                **{f"{k}_batch": mu_batch_launches[f"{k}_batch"]
                   for k in MU_KERNELS},
                **gnb_launches, **ofh_launches, **du_launches,
                **alloc_launches, **split8_launches, **last_launches}
    for name, r in results.items():
        lib = ("" if r["library_ms"] is None
               else f", library {r['library_ms']:.4f} ms")
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}){lib}, "
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
