"""The flagship slot scenarios on one device: configs, inputs, kernel cases.

The JAX bench's flagship cell (bench.py:254-271): a 100 MHz cell with 4
ports, 273 RB, a 4096-point FFT and 30 kHz SCS.

* UL (bench.py:266-285, 317-383): the full mix of every UL slot -- a
  2-layer QAM64 PUSCH on 269 RB at rate 0.7, TBS 311400 (BG1, Z=384, 37
  codeblocks), one PUCCH F1 (PRB 0, 14 symbols), one 64-preamble B4 PRACH
  occasion (root 39, zcz 10, 30 kHz) and one SRS (RB 269-272, symbol 13,
  comb 2, 1 port).  The UE side transmits the PUSCH codeword with the
  port's PDSCH chain and its SRS (bench.py:339-362) through a seeded flat
  4x2 channel with AWGN; the PRACH capture is the bench's (preamble 21,
  2 us delay, port gains 0.9 to 0.6, noise 0.05, bench.py:364-383), built
  in numpy from a seed.
* DL (bench.py:256-265, 386-420): an SSB every 40th slot (pci 1, symbols
  2-5, subcarriers 48-287), an AL8 PDCCH in a 48-RB CORESET with a 60-bit
  DCI, and a 4-layer 256QAM PDSCH on all 273 RB, TBS 835584 (BG1, Z=384,
  100 codeblocks), with the slot context of the JAX conductor's
  ``normalize_dl_plan`` built by the port's own host builders.

* Conductor (bench.py:306-334, 463-510): the same DL slots and UL mix as
  FAPI requests through ``fapi.conductor.SlotConductor.process_slot`` (10
  slot phases, payloads staged 8 slots per transfer), the UL requests
  carrying also a PUCCH F0 (SR + 2 HARQ bits) and two PUCCH F2 (6 and 22
  CSI bits) in PRBs 269-272, symbols 11-12, sent by the UE emulation.

* Slot batch (bench.py:523-549): conductor phases 1-4 (SSB-free) as one
  batch of B = 4 through ``SlotConductor.process_slot_batch``; unlike the
  bench, each slot has its own payload, UCI and samples, and its own PRACH
  capture (one of them noise alone), so that a slot mix-up shows.
* Multi-cell: 4 cells of the flagship DL and UL plans through
  ``parallel.mesh.multi_cell_dl_fn`` / ``multi_cell_ul_fn``, each cell with
  its own payloads and samples.
* Cell edge (:data:`EDGE`): a UL slot of the same cell whose PUSCH REs go
  to a 2-layer QAM64 UE on RBs 0-239 and a power-limited cell-edge UE that
  sends DFT-s-OFDM (transform precoding) with intra-slot frequency hopping
  and 2 HARQ-ACK bits on its PUSCH, beside a PUCCH F3 (pi/2-BPSK, 22 UCI
  bits: polar) and a PUCCH F4 (OCC 2, 8 bits: short block), with the
  flagship's F1, PRACH and SRS.
* Two-UE and cell-edge batches: those UL slots (the two-UE one at one RI,
  :data:`MU_BATCH_RI`) at the slot-batch mode's phases 1-4 beside the
  flagship DL, B = 4 through ``process_slot_batch``.

* DU-low (split 6): the DL slots a split-6 MAC sends the port's
  apps/du_low.py -- the flagship PDSCH with PT-RS beside a 4-port
  NZP-CSI-RS or a TRS, a DL-PRS slot and an empty DL_TTI -- with the
  conductor scenario's UL slots, and K25-K27's cases at those shapes.
* gnb_sim: the kernels of the gNB simulator (apps/gnb_sim.py) at these
  shapes -- the 4x4 TDLA channel (K20), the B4 PRACH occasion demodulator
  (K21) and a 2-layer PDSCH precoded per PRG (K22); the app itself builds
  its slots from its MAC.
* Split 8: apps/ssb_tx.py's SSB slots at the flagship width on one port
  (:data:`SPLIT8_CELL`), one UE slot's 36 AL16 PDCCH blind-decode
  candidates for the list decoder (K29), and the kernels of the radio
  boundary at these shapes: CFO (K30) and amplitude control (K31) on a DL
  slot's samples, the UE transmitter's rate match (K32) on the flagship
  PUSCH's codeblocks.

``chip_smoke.py`` and ``python3 -m srsran_tpu_torch.profile_slot`` drive
these scenarios.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .emulation import channel as chan
from .fapi import messages
from .ops import channel_estimate as chest
from .ops import (dl_control, dl_map, dl_rs, ldpc_decode, ldpc_encode,
                  ldpc_rate_match, ofdm, polar, polar_scl, short_block,
                  uci_demux, ul_demap)
from .ops import llr as llr_ops
from .ops.crc import crc
from .ops.ldpc_graph import get_graph
from .ops.modulation import BITS_PER_SYMBOL, demodulate
from .ops.scrambling import descramble_llrs
from .phy.slot_programs import (CellConfig, dl_slot_fn, dl_slot_fn_samples,
                                stack_ctx, ul_slot_fn)
from .phy.upper import (csi_rs, dmrs, pdcch, pdsch, prach, ptrs_prs, pucch,
                        pusch, sch_decoder, srs, ssb, ue_tx)
from .phy.upper import uci as uci_codec
from .device import const
from .ofh import compression as bfp
from .phy.lower import amplitude_control, cfo, prach_demod
from .ran import mcs_tbs, polar_params
from .ran.ldpc_params import segment_tb
from .ran.precoding_codebooks import PrecodingConfig, nof_prgs
from .ran.prach_params import zc_sequence
from .ran.slot_point import SlotPoint
from .ran.uci_on_pusch import (Part2Entry, Part2Parameter,
                               Part2SizeDescription, UciOnPuschConfig)

SNR_DB = 30.0

CELL = CellConfig(nof_ports=4, nof_rb=273, dft_size=4096, numerology=1)
PUSCH = pusch.PuschConfig(rnti=0x17, rb_start=0, rb_count=269, first_symbol=0,
                          nof_symbols=14, modulation="qam64",
                          target_code_rate=0.7, tbs=311400, nof_layers=2,
                          n_id=1, dmrs_symbols=(2, 7, 11))
UE = pdsch.PdschConfig(rnti=PUSCH.rnti, rb_start=0, rb_count=269,
                       first_symbol=0, nof_symbols=14, modulation="qam64",
                       target_code_rate=0.7, tbs=PUSCH.tbs, nof_layers=2,
                       n_id=1, dmrs_symbols=(2, 7, 11))
SEG = pusch.segmentation(PUSCH)
PUCCH = pucch.PucchF1Config(prb=0, start_symbol=0, nof_symbols=14,
                            initial_cyclic_shift=0, time_domain_occ=0, n_id=1)
PRACH = prach.PrachConfig(format="B4", root_sequence_index=39,
                          zero_correlation_zone=10, ra_scs_hz=30_000)
SRS = srs.SrsConfig(rb_start=269, rb_count=4, start_symbol=13, nof_symbols=1,
                    comb=2, comb_offset=0, cyclic_shift=0, nof_ports=1,
                    sequence_id=1, numerology=1, rnti=0x17)
PRACH_PREAMBLE = 21
# The normalized plan, as normalize_ul_plan makes it (slot_in_frame=0 for
# the PUSCH, slot=0 for the PUCCH, an empty F3/F4 group last).
UL_PLAN = ((PUSCH,), (), (PUCCH,), (), (PRACH,), (SRS,), ())


def ul_program():
    """The flagship UL slot program, as a user calls it."""
    return ul_slot_fn(CELL, UL_PLAN)


def ue_samples(slot_in_frame: int, payload: torch.Tensor,
               uci: dict | None = None, rv: int = 0) -> torch.Tensor:
    """The UE's 4-port slot samples for one slot: the PUSCH layers (at
    redundancy version ``rv``) on ports 0-1 and the SRS on port 0
    (bench.py:347-362); with ``uci`` (:func:`ue_uci`) also the PUCCH UEs'
    F0 and both F2 on port 0."""
    dev = payload.device
    plan = ((), (), (dataclasses.replace(UE, slot_in_frame=0, rv=rv),), ())
    pilots = torch.as_tensor(dmrs.pilot_values_for(pdsch.dmrs_config(
        dataclasses.replace(UE, slot_in_frame=slot_in_frame)))).to(dev)
    _, grid = dl_slot_fn(CELL, plan)((), (), (payload,), {"pdsch": (pilots,)})
    grid = srs.map_to_grid(grid, SRS)
    if uci is not None:
        grid = pucch.transmit_format0(
            grid, dataclasses.replace(F0, slot=slot_in_frame),
            uci["f0_harq"], uci["f0_sr"])
        for key, cfg in (("f2_sb", F2_SB), ("f2_polar", F2_POLAR)):
            grid = pucch.transmit_format2(
                grid, dataclasses.replace(cfg, slot=slot_in_frame), uci[key])
    return ofdm.modulate_slot(grid, CELL.dft_size, CELL.numerology,
                              center_freq_hz=CELL.center_freq_hz)


def prach_capture(rng: np.random.Generator, nof_ports: int = 4) -> np.ndarray:
    """The bench's PRACH occasion (bench.py:364-383): preamble 21 through a
    2 us delay onto every rx port at gains 0.9 to 0.6, 12 repeated symbols,
    complex noise of 0.05 per part from ``rng``; complex64 [P, 12, 139]."""
    roots, pmap, _ = prach._root_set(PRACH)
    ri, cs = pmap[PRACH_PREAMBLE]
    td = zc_sequence(roots[ri], PRACH.l_ra, cs)
    tx = (np.fft.fft(td) / np.sqrt(PRACH.l_ra)).astype(np.complex64)
    k = np.arange(PRACH.l_ra)
    ramp = np.exp(-2j * np.pi * k * PRACH.scs_hz * 2e-6)
    gains = np.linspace(0.9, 0.6, nof_ports)
    fd = np.stack([g * tx * ramp for g in gains])[:, None, :]
    fd = np.tile(fd, (1, 12, 1))
    fd = fd + 0.05 * (rng.standard_normal(fd.shape)
                      + 1j * rng.standard_normal(fd.shape))
    return fd.astype(np.complex64)


def prach_fd(device, seed: int = 0) -> tuple:
    """The UL slot's PRACH input: the capture from a fresh seeded rng."""
    return (torch.as_tensor(prach_capture(np.random.default_rng(seed)))
            .to(device),)


F1_USERS = ((PUCCH.initial_cyclic_shift, PUCCH.time_domain_occ,
             PUCCH.nof_harq_bits),)


def ul_slot_context(index: int, device) -> dict:
    """The slot context of UL slot ``index`` (slot point (1, 2*index), as
    the bench numbers its slots), as the JAX conductor's normalize_ul_plan
    builds it: the PUSCH DM-RS pilot values and the F1 group's per-hop
    weights, every leaf on ``device``."""
    sif = (2 * index) % 20
    weights = pucch.f1_batch_weights(
        dataclasses.replace(PUCCH, slot=sif), F1_USERS)
    return {
        "pusch": (_up(dmrs.pilot_values_for(pusch.dmrs_config(
            dataclasses.replace(PUSCH, slot_in_frame=sif))), device),),
        "f0": (),
        "f1": (tuple(tuple(_up(w, device) for w in hop) for hop in weights),),
        "f2": (), "f3": (),
    }


def channel(samples: torch.Tensor, gen: torch.Generator,
            snr_db: float = SNR_DB) -> torch.Tensor:
    """Flat 4x2 complex channel on the two layer ports, then AWGN."""
    dev = samples.device
    h = torch.randn((4, 2), dtype=torch.complex64, device=dev, generator=gen)
    rx = h @ samples[:2]
    sigma2 = rx.abs().pow(2).mean() / 10 ** (snr_db / 10)
    noise = torch.randn(rx.shape, dtype=torch.complex64, device=dev,
                        generator=gen)
    return rx + noise * sigma2.sqrt()


def make_slots(n: int, rng: np.random.Generator, gen: torch.Generator,
               device) -> list:
    """``n`` slots of (payload int8 [TBS], rx samples, ctx), each with its own
    payload and slot point (1, 2i), all on ``device``; the DM-RS pilot
    values and F1 weights go through ctx as the conductor feeds them."""
    slots = []
    for i in range(n):
        payload = torch.as_tensor(
            rng.integers(0, 2, PUSCH.tbs).astype(np.int8)).to(device)
        rx = channel(ue_samples((2 * i) % 20, payload), gen)
        slots.append((payload, rx, ul_slot_context(i, device)))
    return slots


def zero_soft_buffers(device) -> tuple:
    """The HARQ soft buffers of a first transmission (the bench's)."""
    return (torch.zeros((SEG.nof_codeblocks, SEG.codeword_bits),
                        dtype=torch.float32, device=device),)


def kernel_cases(rx: torch.Tensor, ctx: dict, gen: torch.Generator,
                 prach_in: tuple) -> dict:
    """name -> (wrapper, plain twin, args) for each UL hand kernel at the
    flagship shapes.  Each kernel's input is what the plain twins upstream
    of it make from the slot's samples (and, for K9, the PRACH capture),
    except two: K2 combines with a random nonzero soft buffer, and K1
    decodes noisy LLRs at 5 dB Es/N0 (BPSK) so that the early stop runs
    several sweeps."""
    dev = rx.device
    cell = CELL
    k4 = (rx, cell.nof_sc, cell.dft_size, cell.numerology, cell.cp, 0,
          cell.center_freq_hz)
    grid = ofdm.demodulate_slot_ref(*k4)
    k8, k8_kw = pusch.estimate_args(grid, PUSCH, ctx["pusch"][0], (0, 1), 0)
    srs_args, srs_kw = srs.estimate_args(grid, SRS)
    srs_est = chest.estimate_from_grid_ref(*srs_args, **srs_kw)
    k11 = (grid, SRS, srs_est.time_alignment_s, srs_est.rsrp)

    est = chest.estimate_from_grid_ref(*k8, **k8_kw)
    sym_idx, sc_idx = pusch._plan(PUSCH, dev)
    c_init = (PUSCH.rnti << 15) + PUSCH.n_id
    k3 = (grid, est.coeffs, sym_idx, sc_idx, 0, est.noise_var.mean(), c_init,
          PUSCH.modulation, PUSCH.nof_layers)
    llr, _ = ul_demap.equalize_demap_descramble_ref(*k3)

    qm, seg = 6, SEG
    e_sizes = pdsch._cb_rate_match_sizes(llr.shape[0], seg.nof_codeblocks,
                                         qm, PUSCH.nof_layers)
    soft = torch.randn((seg.nof_codeblocks, seg.codeword_bits), device=dev,
                       generator=gen)
    k2 = (llr, seg.nof_codeblocks, e_sizes, 0, qm, seg.base_graph,
          seg.lifting_size, seg.cb_info_bits, seg.full_block_bits,
          seg.codeword_bits, soft)

    _, full_clean = ldpc_rate_match.rate_dematch_combine_ref(*k2[:-1])
    sign = torch.where(full_clean < 0, -1.0, 1.0)
    sigma = 10 ** (-5.0 / 20)
    noisy = 2 * (sign + sigma * torch.randn(sign.shape, device=dev,
                                            generator=gen)) / sigma ** 2
    dec_in = torch.where(full_clean == 0, 0.0, noisy)   # keep punctured 0s
    dec_in[:, seg.cb_info_bits:seg.full_block_bits] = ldpc_rate_match.FILLER_LLR
    k1 = (dec_in, seg.base_graph, seg.lifting_size, 46, 6, 0.8, "crc24B",
          seg.cb_info_bits)
    return {
        "ofdm_demodulate": (ofdm.demodulate_slot, ofdm.demodulate_slot_ref, k4),
        "pusch_demap": (ul_demap.equalize_demap_descramble,
                        ul_demap.equalize_demap_descramble_ref, k3),
        "rate_dematch": (ldpc_rate_match.rate_dematch_combine,
                         ldpc_rate_match.rate_dematch_combine_ref, k2),
        "ldpc_decode": (ldpc_decode.decode_early_stop,
                        ldpc_decode.decode_early_stop_ref, k1),
        "channel_estimate": (
            functools.partial(chest.estimate_from_grid, **k8_kw),
            functools.partial(chest.estimate_from_grid_ref, **k8_kw), k8),
        "prach_detect": (prach.detect, prach.detect_ref,
                         (prach_in[0], PRACH)),
        "pucch_f1_detect": (pucch.f1_detect, pucch.f1_detect_ref,
                            (grid, PUCCH, ctx["f1"][0], 1.5)),
        "srs_estimate": (srs.srs_noise, srs.srs_noise_ref, k11),
    }



# K1's and K5's further cases (the lean launch path's profile): a BG2 TB
# for K1 (7 codeblocks at Z = 384, 1.5 dB) and one for K5 at a lifting size
# that is not a multiple of 32 (two codeblocks at Z = 208).
LDPC_BG2_TBS = 26632
LDPC_BG2_SNR_DB = 1.5
ENCODE_BG2_TBS = 3832
BATCH_SLOTS = 4


def ldpc_decode_cases(cases: dict, gen: torch.Generator) -> dict:
    """name -> (wrapper, plain twin, args) for K1 beyond
    :func:`kernel_cases`' noisy 46-layer case, from its K2 and K1 inputs:
    the flagship's clean slot as ``sch_decoder.decode`` calls it (its
    layers from ``seg_layers``: 10); a batch of 4 slots with a slot axis at
    those layers, slot 2 the noisy input (it sweeps on after the others
    stop); a HARQ retransmission (the slot's LLRs combined with its first
    transmission's soft buffer, 46 layers); and a BG2 TB (7 codeblocks at Z
    = 384, BPSK at 1.5 dB, 42 layers)."""
    k2, k1 = cases["rate_dematch"][2], cases["ldpc_decode"][2]
    seg = SEG
    soft, clean = ldpc_rate_match.rate_dematch_combine_ref(*k2[:-1])
    _, combined = ldpc_rate_match.rate_dematch_combine_ref(*k2[:-1], soft)
    layers = max(4, min(sch_decoder.seg_layers(seg, k2[2]),
                        sch_decoder.bg_rows(seg.base_graph)))
    tail = (6, ldpc_decode.DEFAULT_SCALING, "crc24B", seg.cb_info_bits)
    bg, z = seg.base_graph, seg.lifting_size
    batch = torch.stack([clean, clean, k1[0], clean][:BATCH_SLOTS])
    pair = (ldpc_decode.decode_early_stop, ldpc_decode.decode_early_stop_ref)
    return {
        "ldpc_decode_clean": pair + ((clean, bg, z, layers) + tail,),
        "ldpc_decode_batch4": pair + ((batch, bg, z, layers) + tail,),
        "ldpc_decode_harq": pair + ((combined, bg, z, 46) + tail,),
        "ldpc_decode_bg2": pair + (_bg2_decode_args(gen, clean.device),),
    }


def _bg2_decode_args(gen: torch.Generator, device) -> tuple:
    """K1's args for :data:`LDPC_BG2_TBS` at BG2: the twin's codeblocks of
    a random TB as BPSK LLRs at :data:`LDPC_BG2_SNR_DB`, the 2Z punctured
    bits 0 and the fillers strongly positive."""
    seg = segment_tb(LDPC_BG2_TBS, 2)
    z = seg.lifting_size
    bits = torch.randint(0, 2, (LDPC_BG2_TBS,), generator=gen, device=device,
                         dtype=torch.int8)
    cw = ldpc_encode.dlsch_encode_ref(bits, 2).to(torch.float32)
    sigma = 10 ** (-LDPC_BG2_SNR_DB / 20)
    noise = torch.randn(cw.shape, generator=gen, device=device)
    llr = 2 * ((1 - 2 * cw) + sigma * noise) / sigma ** 2
    llr[:, seg.cb_info_bits - 2 * z:seg.full_block_bits - 2 * z] = \
        ldpc_rate_match.FILLER_LLR
    llr = torch.cat([llr.new_zeros((cw.shape[0], 2 * z)), llr], dim=1)
    return (llr, 2, z, 42, 6, ldpc_decode.DEFAULT_SCALING, "crc24B",
            seg.cb_info_bits)


def dlsch_encode_cases(tb: torch.Tensor, gen: torch.Generator) -> dict:
    """name -> (wrapper, plain twin, args) for K5 beyond the flagship TB
    ``tb``: a batch of 4 TBs with a slot axis (``tb`` first) and a BG2 TB
    of :data:`ENCODE_BG2_TBS` bits (two codeblocks at Z = 208)."""
    dev = tb.device
    more = torch.randint(0, 2, (BATCH_SLOTS - 1, tb.shape[-1]), generator=gen,
                         device=dev, dtype=torch.int8)
    bg2 = torch.randint(0, 2, (ENCODE_BG2_TBS,), generator=gen, device=dev,
                        dtype=torch.int8)
    pair = (ldpc_encode.dlsch_encode, ldpc_encode.dlsch_encode_ref)
    return {
        "dlsch_encode_batch4": pair + ((torch.cat([tb[None], more]),
                                        DL_SEG.base_graph),),
        "dlsch_encode_bg2": pair + ((bg2, 2),),
    }

# ----------------------------------------------------------------- DL slot

DL_CELL = CELL
SSB = ssb.SsbConfig(phys_cell_id=1, ssb_idx=0, l_max=8, sfn=0,
                    first_symbol=2, first_subcarrier=48)
CORESET = pdcch.CoresetConfig(rb_start=0, nof_rb=48, start_symbol=0,
                              duration=1)
PDCCH = pdcch.PdcchConfig(coreset=CORESET, rnti=0x4601, aggregation_level=8,
                          cce_index=0, payload_bits=60, n_id=1, n_id_data=1)
PDSCH = pdsch.PdschConfig(rnti=0x4601, rb_start=0, rb_count=273,
                          first_symbol=1, nof_symbols=12, modulation="qam256",
                          target_code_rate=0.8, tbs=835584, nof_layers=4,
                          n_id=1, dmrs_symbols=(2, 11))
DL_SEG = pdsch.segmentation(PDSCH)
SSB_PERIOD_SLOTS = 40          # 20 ms at 30 kHz SCS, every 2nd slot index
MIB_BITS = 24
# The normalized plans (normalize_dl_plan: sfn=0, hrf=False for the SSB,
# slot_in_frame=0 for the PDCCH and the PDSCH).
DL_PLAN_SSB = ((SSB,), (PDCCH,), (PDSCH,), (), ())
DL_PLAN = ((), (PDCCH,), (PDSCH,), (), ())


def dl_program(with_ssb: bool):
    """The flagship DL slot program (samples only), as the bench calls it."""
    return dl_slot_fn_samples(DL_CELL, DL_PLAN_SSB if with_ssb else DL_PLAN)


def dl_grid_program(with_ssb: bool):
    """The same plan's program that also returns the grid."""
    return dl_slot_fn(DL_CELL, DL_PLAN_SSB if with_ssb else DL_PLAN)


def _up(arr, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr)).to(device)


def dl_slot_context(index: int, device) -> dict:
    """The slot context of DL slot ``index`` (slot point (1, 2*index), as
    the bench numbers its slots), every leaf on ``device``."""
    sfn, sif = divmod(2 * index, 20)
    with_ssb = index % SSB_PERIOD_SLOTS == 0
    ssb_ctx = ((tuple(_up(a, device) for a in ssb.slot_ctx_for(
        dataclasses.replace(SSB, sfn=sfn))),) if with_ssb else ())
    return {
        "ssb": ssb_ctx,
        "pdcch": (_up(pdcch.dmrs_values_for(
            dataclasses.replace(PDCCH, slot_in_frame=sif)), device),),
        "pdsch": (_up(dmrs.pilot_values_for(pdsch.dmrs_config(
            dataclasses.replace(PDSCH, slot_in_frame=sif))), device),),
        "ptrs": (None,), "pm": (None,), "csi": (), "prs": (),
    }


def make_dl_slots(n: int, rng: np.random.Generator, device) -> list:
    """``n`` DL slots, each a dict: ``with_ssb``, ``args`` (ssb_mib,
    pdcch_payloads, pdsch_payloads, ctx) for the slot program, and ``tb``
    (the PDSCH payload).  Slot i is slot point (1, 2*i); every 40th carries
    the SSB.  Payloads and context are uploaded here, before any timing."""
    slots = []
    for i in range(n):
        with_ssb = i % SSB_PERIOD_SLOTS == 0
        tb = _up(rng.integers(0, 2, PDSCH.tbs).astype(np.int8), device)
        dci = _up(rng.integers(0, 2, PDCCH.payload_bits).astype(np.int8),
                  device)
        mib = (_up(rng.integers(0, 2, MIB_BITS).astype(np.int8), device),)
        slots.append(dict(with_ssb=with_ssb, tb=tb, args=(
            mib if with_ssb else (), (dci,), (tb,), dl_slot_context(i, device))))
    return slots


def dl_loopback(samples: torch.Tensor):
    """Receive a non-SSB DL slot's PDSCH back from its samples: OFDM
    demodulate (K4), take the data REs of ports 0-3 (identity precoding:
    port p carries 0.5 x layer p), demap 256QAM and descramble (plain), then
    rate dematch (K2) and LDPC decode with CRC early stop (K1).  Returns the
    shared-channel decoder's result."""
    cell = DL_CELL
    grid = ofdm.demodulate_slot(samples, cell.nof_sc, cell.dft_size,
                                cell.numerology, cell.cp, 0,
                                cell.center_freq_hz)
    key = pdsch.plan_key(PDSCH)
    dev = samples.device
    sym = torch.as_tensor(pdsch.data_re_plan_column(*key, 0)).to(dev)
    sc = torch.as_tensor(pdsch.data_re_plan_column(*key, 1)).to(dev)
    x = (grid[:, sym, sc] / 0.5).T.reshape(-1)       # codeword symbol order
    nv = torch.full((1, x.numel()), 1e-2, device=dev)
    llr = demodulate(x[None], nv, PDSCH.modulation)[0]
    llr = descramble_llrs(llr, (PDSCH.rnti << 15) + PDSCH.n_id)
    return sch_decoder.decode(llr, DL_SEG,
                              list(pdsch.rate_match_sizes(PDSCH)), PDSCH.rv,
                              8, PDSCH.tbs)


def _map_on_copy(fn):
    """K6 adds into its grid: compare and time it on a fresh copy."""
    def run(grid, *args):
        return fn(grid.clone(), *args)
    return run


# A small allocation at a low code rate, rv 2: every codeblock bit repeats.
REPETITION = dataclasses.replace(PDSCH, rb_start=100, rb_count=6,
                                 modulation="qpsk", target_code_rate=0.1,
                                 tbs=296, rv=2)


def dl_kernel_cases(slot: dict) -> dict:
    """name -> (wrapper, plain twin, args) for K5-K7 at the flagship DL
    shapes, from one SSB slot: K5 encodes its TB; K6 maps the encoded
    codeblocks onto the grid that holds its SSB and PDCCH; K7 modulates the
    twins' full grid."""
    mib, dci, tbs, ctx = slot["args"]
    tb = tbs[0]
    dev = tb.device
    cell = DL_CELL
    base = torch.zeros((cell.nof_ports, 14, cell.nof_sc), dtype=torch.complex64,
                       device=dev)
    if mib:
        ssb.map_ssb_to_grid(base, SSB, mib[0], ctx["ssb"][0])
    pdcch.process(base, dci[0], PDCCH, dmrs_cinits=ctx["pdcch"][0])
    cbs = ldpc_encode.dlsch_encode_ref(tb, DL_SEG.base_graph).contiguous()
    k6 = pdsch.map_args(base, PDSCH, cbs,
                        pdsch.identity(cell.nof_ports, PDSCH.nof_layers, dev))
    full = dl_map.pdsch_map_ref(base.clone(), *k6[1:])
    dmrs.map_to_grid(full, pdsch.dmrs_config(PDSCH), k6[-1], ctx["pdsch"][0])
    k7 = (full, cell.dft_size, cell.numerology, cell.cp, 0,
          cell.center_freq_hz, cell.tx_scale)
    return {
        "dlsch_encode": (ldpc_encode.dlsch_encode,
                         ldpc_encode.dlsch_encode_ref,
                         (tb, DL_SEG.base_graph)),
        "pdsch_map": (_map_on_copy(dl_map.pdsch_map),
                      _map_on_copy(dl_map.pdsch_map_ref), k6),
        "ofdm_modulate": (ofdm.modulate_slot, ofdm.modulate_slot_ref, k7),
    }


# ------------------------------------------------------------ conductor

# The bench's conductor protocol (bench.py:463-510): 10 slot phases (slot
# points (1, 2i): subframe slot 0, one plan per phase), payloads staged 8
# slots per transfer.  The UL requests carry the bench's full mix plus the
# PUCCH UEs' UCI in the four PRBs above the PUSCH (269-272, free in symbols
# 0-12): an F0 with SR and 2 HARQ bits, an F2 with 6 CSI bits (E = 32:
# short block) and an F2 with 22 CSI bits (E = 64: polar, CRC11, N = 64).
N_PHASES = 10
STAGE_DEPTH = 8
N_PAYLOAD_VARIANTS = 4
F0 = pucch.PucchF0Config(prb=269, start_symbol=11, nof_symbols=2,
                         initial_cyclic_shift=0, n_id=1, nof_harq_bits=2,
                         sr_opportunity=True)
F2_SB = pucch.PucchF2Config(rb_start=270, nof_rb=1, start_symbol=11,
                            nof_symbols=2, rnti=0x18, n_id=1, n_id0=1,
                            nof_uci_bits=6)
F2_POLAR = pucch.PucchF2Config(rb_start=271, nof_rb=2, start_symbol=11,
                               nof_symbols=2, rnti=0x19, n_id=1, n_id0=1,
                               nof_uci_bits=22)


def dl_request(i: int) -> messages.DlTtiRequest:
    """bench.py's dl_request(i): slot point (1, 2i), the SSB every 40th."""
    slot = SlotPoint(1, 2 * i)
    return messages.DlTtiRequest(
        slot=slot,
        ssb=((dataclasses.replace(SSB, sfn=slot.sfn),)
             if i % SSB_PERIOD_SLOTS == 0 else ()),
        pdcch=(dataclasses.replace(PDCCH, slot_in_frame=slot.slot_index),),
        pdsch=(dataclasses.replace(PDSCH, slot_in_frame=slot.slot_index),))


def ul_request(i: int) -> messages.UlTtiRequest:
    """bench.py's ul_request(i) (PUSCH, PUCCH F1, PRACH, SRS) with the F0
    and both F2 PDUs."""
    slot = SlotPoint(1, 2 * i)
    sl = slot.slot_index
    return messages.UlTtiRequest(
        slot=slot,
        pusch=(dataclasses.replace(PUSCH, slot_in_frame=sl),),
        pucch_f0=(dataclasses.replace(F0, slot=sl),),
        pucch_f1=(dataclasses.replace(PUCCH, slot=sl),),
        pucch_f2=(dataclasses.replace(F2_SB, slot=sl),
                  dataclasses.replace(F2_POLAR, slot=sl)),
        prach=(PRACH,), srs=(SRS,))


def dl_payloads(rng: np.random.Generator) -> dict:
    """The bench's packed DL payloads (bench.py:289-298): 4 TB and DCI
    variants and one MIB, as FAPI wire bytes."""
    sch = [np.packbits(rng.integers(0, 2, PDSCH.tbs).astype(np.uint8))
           for _ in range(N_PAYLOAD_VARIANTS)]
    dci = [np.packbits(rng.integers(0, 2, PDCCH.payload_bits).astype(np.uint8))
           for _ in range(N_PAYLOAD_VARIANTS)]
    mib = np.packbits(rng.integers(0, 2, MIB_BITS).astype(np.uint8))
    return dict(sch=sch, dci=dci, mib=mib)


def tx_request(i: int, payloads: dict) -> messages.TxDataRequest:
    """bench.py's tx_request(i)."""
    dl = dl_request(i)
    v = i % N_PAYLOAD_VARIANTS
    return messages.TxDataRequest(
        slot=dl.slot, pdsch_payloads=(payloads["sch"][v],),
        pdcch_payloads=(payloads["dci"][v],),
        ssb_mib=(payloads["mib"],) if dl.ssb else ())


def ue_uci(rng: np.random.Generator) -> dict:
    """One slot's UCI of the PUCCH UEs: F0 HARQ bits and SR, both F2s' CSI."""
    return dict(f0_harq=rng.integers(0, 2, F0.nof_harq_bits).astype(np.int8),
                f0_sr=int(rng.integers(0, 2)),
                f2_sb=rng.integers(0, 2, F2_SB.nof_uci_bits).astype(np.int8),
                f2_polar=rng.integers(0, 2, F2_POLAR.nof_uci_bits
                                      ).astype(np.int8))


def conductor_phases(rng: np.random.Generator, gen: torch.Generator,
                     device) -> list:
    """For each of the N_PHASES slot phases: the PUSCH payload, the UCI sent
    and the rx samples (the UE's PUSCH, SRS, F0 and both F2 on the layer
    ports through the flat 4x2 channel with AWGN), all on ``device``."""
    phases = []
    for i in range(N_PHASES):
        sif = (2 * i) % 20
        tb = torch.as_tensor(rng.integers(0, 2, PUSCH.tbs).astype(np.int8)
                             ).to(device)
        uci = ue_uci(rng)
        rx = channel(ue_samples(sif, tb, uci), gen)
        phases.append(dict(tb=tb, uci=uci, rx=rx))
    return phases


def check_results(res: messages.SlotResults, phase: dict, where: str,
                  prach_preambles: tuple = (PRACH_PREAMBLE,)) -> None:
    """A conductor slot's indications: the PUSCH CRC with the exact
    payload, the PRACH detections (preamble 21), the F0 HARQ/SR bits and
    both F2 CSI payloads as sent, with finite channel reports."""
    crc = res.crc[0]
    if not crc.tb_crc_ok:
        raise AssertionError(f"{where}: TB CRC failed")
    if not np.array_equal(res.rx_data[0].payload,
                          phase["tb"].cpu().numpy().astype(np.uint8)):
        raise AssertionError(f"{where}: decoded TB differs from payload")
    if [r.preamble_index for r in res.rach] != list(prach_preambles):
        raise AssertionError(f"{where}: PRACH detections "
                             f"{[r.preamble_index for r in res.rach]}")
    uci = phase["uci"]
    f0, _, f2_sb, f2_polar = res.uci
    if not (f0.detected and f0.sr_bit == uci["f0_sr"]
            and np.array_equal(f0.harq_bits, uci["f0_harq"])):
        raise AssertionError(f"{where}: F0 {f0} vs sent {uci}")
    for got, want in ((f2_sb, uci["f2_sb"]), (f2_polar, uci["f2_polar"])):
        if not (got.detected and np.array_equal(got.csi_bits, want)):
            raise AssertionError(f"{where}: F2 {got} vs sent {want}")
    floats = [crc.snr_db, crc.rsrp, crc.evm, crc.cfo_hz, res.srs[0].snr_db,
              *np.abs(res.srs[0].wideband_h).ravel()]
    if not np.all(np.isfinite(floats)):
        raise AssertionError(f"{where}: channel reports not finite")


def conductor_kernel_cases(rx: torch.Tensor, sif: int,
                           gen: torch.Generator) -> dict:
    """name -> (wrapper, plain twin, args) for K12-K15 at the conductor
    scenario's shapes, from one slot's samples through the plain twins
    upstream: K12 on the F0 (8 candidates), K13 on the 2-RB F2, K14 on the
    1-RB F2's LLRs (K = 6, E = 32), K15 on the 2-RB F2's (K' = 33, E = 64).
    Extra cases (compared and timed, not on the main path's list): K12 on
    the F0 occasion at 10 dB, K8 at the F2's comb-3 shape, K13 at 1 RB, K14
    at K = 11, E = 512 and K15 at N = 1024, on noisy LLRs of seeded
    codewords."""
    dev = rx.device
    cell = CELL
    grid = ofdm.demodulate_slot_ref(rx, cell.nof_sc, cell.dft_size,
                                    cell.numerology, cell.cp, 0,
                                    cell.center_freq_hz)
    f0 = dataclasses.replace(F0, slot=sif)
    refs = _up(pucch.f0_refs_for(f0), dev)
    cases = {"pucch_f0_detect": (pucch.f0_detect, pucch.f0_detect_ref,
                                 (grid, f0, refs, 4.0))}
    # The F0 occasion again at 10 dB, where the metric's noise term (energy
    # minus the largest correlation) keeps its digits.
    occ = grid[:, f0.start_symbol:f0.start_symbol + f0.nof_symbols,
               12 * f0.prb:12 * f0.prb + 12]
    sigma2 = occ.abs().pow(2).mean() / 10.0
    noisy = grid + sigma2.sqrt() * torch.randn(
        grid.shape, dtype=torch.complex64, device=dev, generator=gen)
    cases["pucch_f0_detect_10db"] = (pucch.f0_detect, pucch.f0_detect_ref,
                                     (noisy, f0, refs, 4.0))
    llrs = {}
    for name, cfg in (("", F2_POLAR), ("_1rb", F2_SB)):
        cfg = dataclasses.replace(cfg, slot=sif)
        args, kw = pucch.f2_estimate_args(
            grid, cfg, _up(pucch.f2_pilot_values_for(cfg), dev))
        est = chest.estimate_from_grid_ref(*args, **kw)
        k13 = (grid, est.coeffs, est.noise_var, cfg)
        cases["pucch_f2_demap" + name] = (pucch.f2_demap, pucch.f2_demap_ref,
                                          k13)
        llrs[name] = pucch.f2_demap_ref(*k13)
        if not name:
            cases["channel_estimate_f2"] = (
                functools.partial(chest.estimate_from_grid, **kw),
                functools.partial(chest.estimate_from_grid_ref, **kw), args)
    code, crc_len = pucch._f2_polar_cfg(F2_POLAR.nof_uci_bits, 64)
    cases["short_block_detect"] = (short_block.detect, short_block.detect_ref,
                                   (llrs["_1rb"][None], F2_SB.nof_uci_bits, 2))
    cases["polar_decode"] = (polar.decode, polar.decode_ref,
                             (llrs[""][None], code, f"crc{crc_len}"))
    big = polar_params.polar_code(111, 1000, nmax=10, ibil=True)
    for name, bits in (("short_block_detect_k11", short_block.encode(
            torch.randint(0, 2, (1, 11), device=dev, generator=gen,
                          dtype=torch.int8), 512, 2)),
                       ("polar_decode_n1024", polar.rate_match(polar.encode(
                           polar.allocate(torch.randint(
                               0, 2, (1, big.k), device=dev, generator=gen,
                               dtype=torch.int8), big), big.n), big))):
        llr = (1.0 - 2.0 * bits.to(torch.float32)) + 0.8 * torch.randn(
            bits.shape, device=dev, generator=gen)
        fn, ref = ((short_block.detect, short_block.detect_ref)
                   if name.startswith("short") else
                   (polar.decode, polar.decode_ref))
        args = (llr, 11, 2) if name.startswith("short") else (llr, big,
                                                               "crc11")
        cases[name] = (fn, ref, args)
    return cases


# ------------------------------------------------------- the two-UE UL slot

# A loaded 100 MHz cell gives the PUSCH REs of a slot to more than one UE:
# the flagship UL mix (PUCCH F1, PRACH, SRS as above) with its PUSCH split
# between a 4-layer QAM64 UE on RBs 0-204 (two DM-RS CDM groups, MMSE) and a
# 1-layer QAM16 UE on RBs 205-268 that multiplexes its HARQ-ACK (4 bits) and
# CSI report (part 1: 8 bits, RI in bit 0; part 2: 12 or 24 bits by RI) on
# its PUSCH, as the JAX MAC places UCI (single-layer UEs only).  Both TBS
# follow TS38.214 with 36 DM-RS REs per PRB.
CSI2_SIZES = (12, 24)
PART2 = Part2SizeDescription((Part2Entry((Part2Parameter(0, 1),),
                                         CSI2_SIZES),))


@dataclasses.dataclass(frozen=True)
class MuScenario:
    """The two-UE UL slot on one cell.  ``pusch_b`` is UE B's PDU as the
    receiver knows it before CSI part 1 (o_csi2 = 0)."""

    cell: CellConfig
    pusch_a: pusch.PuschConfig
    pusch_b: pusch.PuschConfig
    pucch: pucch.PucchF1Config
    prach: prach.PrachConfig
    srs: srs.SrsConfig

    def ue_b(self, ri: int) -> pusch.PuschConfig:
        """UE B's PDU with the part-2 size of rank indicator ``ri``."""
        return dataclasses.replace(self.pusch_b, uci=dataclasses.replace(
            self.pusch_b.uci, o_csi2=CSI2_SIZES[ri]))

    def ue_a_tx(self) -> pdsch.PdschConfig:
        """UE A's transmitter: the DL chain's PDSCH on the same REs."""
        a = self.pusch_a
        return pdsch.PdschConfig(
            rnti=a.rnti, rb_start=a.rb_start, rb_count=a.rb_count,
            first_symbol=a.first_symbol, nof_symbols=a.nof_symbols,
            modulation=a.modulation, target_code_rate=a.target_code_rate,
            tbs=a.tbs, nof_layers=a.nof_layers, n_id=a.n_id,
            dmrs_symbols=a.dmrs_symbols)

    def plan(self, ri: int) -> tuple:
        """The normalized UL plan of a slot whose RI is ``ri``."""
        return ((self.pusch_a, self.ue_b(ri)), (), (self.pucch,), (),
                (self.prach,), (self.srs,), ())


MU = MuScenario(
    cell=CELL,
    pusch_a=pusch.PuschConfig(
        rnti=0x17, rb_start=0, rb_count=205, first_symbol=0, nof_symbols=14,
        modulation="qam64", target_code_rate=0.6, tbs=393272, nof_layers=4,
        n_id=1, dmrs_symbols=(2, 7, 11), equalizer="mmse"),
    pusch_b=pusch.PuschConfig(
        rnti=0x18, rb_start=205, rb_count=64, first_symbol=0, nof_symbols=14,
        modulation="qam16", target_code_rate=0.5, tbs=16896, nof_layers=1,
        n_id=1, dmrs_symbols=(2, 7, 11), equalizer="mmse",
        uci=UciOnPuschConfig(o_ack=4, o_csi1=8)),
    pucch=PUCCH, prach=PRACH, srs=SRS)


def mu_program(ri: int, sc: MuScenario = MU):
    """The two-UE UL slot program of a slot whose RI is ``ri``."""
    return ul_slot_fn(sc.cell, sc.plan(ri))


def mu_uci(rng: np.random.Generator, sc: MuScenario = MU,
           ri: int | None = None) -> dict:
    """One slot's UCI of UE B: HARQ-ACK, CSI part 1 (bit 0 the RI, set to
    ``ri`` where given) and the part 2 that the RI sizes."""
    u = sc.pusch_b.uci
    csi1 = rng.integers(0, 2, u.o_csi1).astype(np.int8)
    if ri is not None:
        csi1[0] = ri
    ri = int(csi1[0])
    return dict(ri=ri, ack=rng.integers(0, 2, u.o_ack).astype(np.int8),
                csi1=csi1,
                csi2=rng.integers(0, 2, CSI2_SIZES[ri]).astype(np.int8))


def mu_context(index: int, device, sc: MuScenario = MU) -> dict:
    """The slot context of two-UE slot ``index`` (slot point (1, 2*index)):
    both PUSCHs' DM-RS pilot values and the F1 group's weights."""
    sif = (2 * index) % 20
    weights = pucch.f1_batch_weights(
        dataclasses.replace(sc.pucch, slot=sif),
        ((sc.pucch.initial_cyclic_shift, sc.pucch.time_domain_occ,
          sc.pucch.nof_harq_bits),))
    return {
        "pusch": tuple(_up(dmrs.pilot_values_for(pusch.dmrs_config(
            dataclasses.replace(c, slot_in_frame=sif))), device)
            for c in (sc.pusch_a, sc.pusch_b)),
        "f0": (),
        "f1": (tuple(tuple(_up(w, device) for w in hop) for hop in weights),),
        "f2": (), "f3": (),
    }


def mu_rx(sif: int, tb_a: torch.Tensor, tb_b: torch.Tensor, uci: dict,
          gen: torch.Generator, sc: MuScenario = MU,
          snr_db: float = SNR_DB) -> torch.Tensor:
    """The gNB's 4-port samples of one two-UE slot: UE A's 4 layers (the
    port's DL chain, identity precoding, plus the SRS on its port 0) through
    a flat, well-conditioned 4x4 channel I + 0.25 (N + jN), UE B's PUSCH
    with its UCI (``ue_tx.pusch_transmit``) through a flat 4x1 channel,
    summed, then AWGN at ``snr_db`` of the sum's power."""
    dev = tb_a.device
    cell = sc.cell
    ue_a = sc.ue_a_tx()
    pilots = _up(dmrs.pilot_values_for(pdsch.dmrs_config(
        dataclasses.replace(ue_a, slot_in_frame=sif))), dev)
    _, grid_a = dl_slot_fn(cell, ((), (), (ue_a,), ()))(
        (), (), (tb_a,), {"pdsch": (pilots,)})
    grid_a = srs.map_to_grid(grid_a, sc.srs)
    grid_b = ue_tx.pusch_transmit(
        dataclasses.replace(sc.ue_b(uci["ri"]), slot_in_frame=sif),
        tb_b.cpu().numpy(), uci["ack"], uci["csi1"], uci["csi2"],
        nof_sc=cell.nof_sc, device=dev)

    def samples(grid):
        return ofdm.modulate_slot(grid, cell.dft_size, cell.numerology,
                                  center_freq_hz=cell.center_freq_hz)

    def cn(shape):
        return torch.complex(torch.randn(shape, device=dev, generator=gen),
                             torch.randn(shape, device=dev, generator=gen))

    h_a = torch.eye(4, dtype=torch.complex64, device=dev) + 0.25 * cn((4, 4))
    h_b = cn((4, 1)) / np.sqrt(2)
    rx = h_a @ samples(grid_a) + h_b @ samples(grid_b)
    sigma2 = rx.abs().pow(2).mean() / 10 ** (snr_db / 10)
    return rx + torch.randn(rx.shape, dtype=torch.complex64, device=dev,
                            generator=gen) * sigma2.sqrt()


def mu_slot(i: int, rng: np.random.Generator, gen: torch.Generator,
            device, sc: MuScenario = MU, ri: int | None = None) -> dict:
    """Two-UE slot ``i`` (slot point (1, 2i)) as a dict: ``tb_a``, ``tb_b``
    (int8 payloads), ``uci`` (:func:`mu_uci`, its RI ``ri`` where given),
    ``rx`` (samples) and ``ctx``, all on ``device``."""
    tb_a = _up(rng.integers(0, 2, sc.pusch_a.tbs).astype(np.int8), device)
    tb_b = _up(rng.integers(0, 2, sc.pusch_b.tbs).astype(np.int8), device)
    uci = mu_uci(rng, sc, ri)
    return dict(tb_a=tb_a, tb_b=tb_b, uci=uci,
                rx=mu_rx((2 * i) % 20, tb_a, tb_b, uci, gen, sc),
                ctx=mu_context(i, device, sc))


def make_mu_slots(n: int, rng: np.random.Generator, gen: torch.Generator,
                  device, sc: MuScenario = MU) -> list:
    """``n`` two-UE slots (:func:`mu_slot`): slot i is slot point (1, 2i),
    with fresh payloads and UCI."""
    return [mu_slot(i, rng, gen, device, sc) for i in range(n)]


def mu_soft_buffers(device, sc: MuScenario = MU) -> tuple:
    """Zero HARQ soft buffers of both UEs (first transmissions)."""
    return tuple(torch.zeros((s.nof_codeblocks, s.codeword_bits),
                             dtype=torch.float32, device=device)
                 for s in (pusch.segmentation(sc.pusch_a),
                           pusch.segmentation(sc.pusch_b)))


def check_mu_slot(out: dict, slot: dict, where: str) -> None:
    """Both TBs exact, UE B's HARQ-ACK, CSI1 and CSI2 as sent and valid,
    PRACH preamble 21 detected, finite channel reports."""
    for r, tb, name in zip(out["pusch"], (slot["tb_a"], slot["tb_b"]), "AB"):
        if not bool(r["tb_crc_ok"]):
            raise AssertionError(f"{where}: UE {name} TB CRC failed")
        if not torch.equal(r["tb_bits"], tb):
            raise AssertionError(f"{where}: UE {name} TB differs from payload")
        for k in ("snr", "rsrp", "epre", "evm", "cfo_hz", "ta_s"):
            if not bool(torch.isfinite(r[k]).all()):
                raise AssertionError(f"{where}: UE {name} {k} not finite")
    b, uci = out["pusch"][1], slot["uci"]
    for key, sent in (("harq_ack", uci["ack"]), ("csi1", uci["csi1"]),
                      ("csi2", uci["csi2"])):
        if not bool(b[f"{key}_valid"]):
            raise AssertionError(f"{where}: UE B {key} not valid")
        if not np.array_equal(b[f"{key}_bits"].cpu().numpy(), sent):
            raise AssertionError(f"{where}: UE B {key} "
                                 f"{b[f'{key}_bits'].cpu().numpy()} vs {sent}")
    det = out["prach"][0]["detected"]
    if not bool(det[PRACH_PREAMBLE]) or int(det.sum()) != 1:
        raise AssertionError(f"{where}: PRACH detections "
                             f"{torch.nonzero(det).flatten().tolist()}")


def mu_ul_request(i: int, ri: int, sc: MuScenario = MU) -> messages.UlTtiRequest:
    """The two-UE slot's UL_TTI.request at slot point (1, 2i), UE B's part-2
    size set from its RI (as a MAC that knows the rank it asked for)."""
    slot = SlotPoint(1, 2 * i)
    sl = slot.slot_index
    return messages.UlTtiRequest(
        slot=slot,
        pusch=(dataclasses.replace(sc.pusch_a, slot_in_frame=sl),
               dataclasses.replace(sc.ue_b(ri), slot_in_frame=sl)),
        pucch_f1=(dataclasses.replace(sc.pucch, slot=sl),),
        prach=(sc.prach,), srs=(sc.srs,))


def check_mu_results(res: messages.SlotResults, slot: dict,
                     where: str) -> None:
    """A conductor two-UE slot's indications: a passing CRC and the exact
    payload per UE, UE B's UCI from its PUSCH as sent, PRACH 21."""
    tbs = (slot["tb_a"], slot["tb_b"])
    if [c.tb_crc_ok for c in res.crc] != [True, True]:
        raise AssertionError(f"{where}: CRCs {[c.tb_crc_ok for c in res.crc]}")
    for got, tb in zip(res.rx_data, tbs):
        if not np.array_equal(got.payload, tb.cpu().numpy().astype(np.uint8)):
            raise AssertionError(f"{where}: RNTI {got.rnti:#x} payload differs")
    (u,) = [u for u in res.uci if u.source == "pusch"]
    uci = slot["uci"]
    if not (u.rnti == MU.pusch_b.rnti and u.detected
            and np.array_equal(u.harq_bits, uci["ack"])
            and np.array_equal(u.csi_bits, uci["csi1"])
            and np.array_equal(u.csi2_bits, uci["csi2"])):
        raise AssertionError(f"{where}: UCI on PUSCH {u} vs sent {uci}")
    if [r.preamble_index for r in res.rach] != [PRACH_PREAMBLE]:
        raise AssertionError(f"{where}: PRACH detections "
                             f"{[r.preamble_index for r in res.rach]}")


def mu_kernel_cases(slot: dict, gen: torch.Generator,
                    sc: MuScenario = MU) -> dict:
    """name -> (wrapper, plain twin, args) for K16, K17 and K8 at the two-UE
    slot's shapes, from one slot's samples through the plain twins upstream:
    K16 at UE A (4 layers, MMSE) and K17 at UE B's codeword; extra cases
    (compared and timed, not in the main path's list): K16 at 3 layers ZF
    and 2 layers MMSE on UE A's first layers, and at UE B (1 layer, MMSE);
    K17 with a punctured 1-bit HARQ-ACK on UE B's QAM16 (the 'x'/'y'
    placeholder path); K8 on UE A's CDM group 1 (delta 1)."""
    rx, ctx = slot["rx"], slot["ctx"]
    cell = sc.cell
    dev = rx.device
    grid = ofdm.demodulate_slot_ref(rx, cell.nof_sc, cell.dft_size,
                                    cell.numerology, cell.cp, 0,
                                    cell.center_freq_hz)
    cases = {}
    llr_b = None
    for name, cfg, ci in (("a", sc.pusch_a, ctx["pusch"][0]),
                          ("b", sc.ue_b(slot["uci"]["ri"]), ctx["pusch"][1])):
        groups = ([((0, 1), 0), ((2, 3), 1)] if cfg.nof_layers > 2
                  else [((0,), 0)])
        ests = []
        for ports, delta in groups:
            args, kw = pusch.estimate_args(grid, cfg, ci, ports, delta)
            ests.append(chest.estimate_from_grid_ref(*args, **kw))
            if delta == 1:
                cases["channel_estimate_delta1"] = (
                    functools.partial(chest.estimate_from_grid, **kw),
                    functools.partial(chest.estimate_from_grid_ref, **kw),
                    args)
        coeffs = torch.cat([e.coeffs for e in ests], dim=1)
        nv = torch.stack([e.noise_var for e in ests]).mean(dim=0).mean()
        sym, sc_idx = pusch._plan(cfg, dev)
        c_init = (cfg.rnti << 15) + cfg.n_id
        k16 = (grid, coeffs, sym, sc_idx, cfg.rb_start * 12, nv, c_init,
               cfg.modulation, cfg.nof_layers, cfg.equalizer)
        if name == "a":
            cases["pusch_demap_lxn"] = (ul_demap.equalize_demap_descramble_lxn,
                                        ul_demap.equalize_demap_descramble_ref,
                                        k16)
            for layers, method in ((3, "zf"), (2, "mmse")):
                cases[f"pusch_demap_lxn_{layers}l_{method}"] = (
                    ul_demap.equalize_demap_descramble_lxn,
                    ul_demap.equalize_demap_descramble_ref,
                    (grid, coeffs[:, :layers].contiguous(), sym, sc_idx,
                     cfg.rb_start * 12, nv, c_init, cfg.modulation, layers,
                     method))
        else:
            cases["pusch_demap_lxn_1l_mmse"] = (
                ul_demap.equalize_demap_descramble_lxn,
                ul_demap.equalize_demap_descramble_ref, k16)
            llr_b, _ = ul_demap.equalize_demap_descramble_ref(*k16)
            dcfg = pusch.demux_plan(cfg)
            u = cfg.uci
            cases["ulsch_demux"] = (uci_demux.demux, uci_demux.demux_ref,
                                    (llr_b, dcfg, u.o_ack, u.o_csi1, c_init))
            punct = dataclasses.replace(cfg, uci=UciOnPuschConfig(o_ack=1))
            cases["ulsch_demux_punctured"] = (
                uci_demux.demux, uci_demux.demux_ref,
                (llr_b, pusch.demux_plan(punct), 1, 0, c_init))
    return cases


# ------------------------------------------------------------- slot batch

# bench.py:523-549: B = 4 same-phase slots of the conductor scenario, phases
# 1-4 (no SSB), in one program.  Each slot keeps its own payload, UCI and
# samples (the conductor phases'), and its own PRACH capture: the one of
# slot BATCH_NOISE_SLOT holds noise alone, so its slot reports no preamble.
BATCH = 4
BATCH_PHASES = tuple(range(1, 1 + BATCH))
BATCH_NOISE_SLOT = 2


def batch_prach_fd(device, seed: int = 0) -> tuple:
    """One PRACH capture per slot of the batch, complex64 [B, 4, 12, 139]:
    the bench's capture (fresh noise per slot), noise alone for slot
    BATCH_NOISE_SLOT."""
    rng = np.random.default_rng(seed)
    caps = [prach_capture(rng) for _ in range(BATCH)]
    noise = caps[BATCH_NOISE_SLOT]
    caps[BATCH_NOISE_SLOT] = (0.05 * (rng.standard_normal(noise.shape)
                                      + 1j * rng.standard_normal(noise.shape))
                              ).astype(np.complex64)
    return (torch.as_tensor(np.stack(caps)).to(device),)


def batch_preambles(b: int) -> tuple:
    """The PRACH preambles slot ``b`` of the batch must report."""
    return () if b == BATCH_NOISE_SLOT else (PRACH_PREAMBLE,)


# The two-UE and cell-edge UL slots in the same batch mode: B = 4 slots at
# BATCH_PHASES' slot points beside the flagship DL of those phases, each
# slot its own payloads, UCI and samples.  A batch shares one normalized
# plan, so the two-UE batch's slots share UE B's RI (its part-2 size), as a
# MAC groups them.
MU_BATCH_RI = 1


def mu_batch(rng: np.random.Generator, gen: torch.Generator, device,
             sc: MuScenario = MU, ri: int = MU_BATCH_RI) -> list:
    """The two-UE batch's slots: :func:`mu_slot` at each of BATCH_PHASES,
    every slot with RI ``ri``."""
    return [mu_slot(i, rng, gen, device, sc, ri) for i in BATCH_PHASES]


# ------------------------------------------------------------ multi-cell

NOF_CELLS = 4


def multi_cell_inputs(rng: np.random.Generator, gen: torch.Generator,
                      device) -> dict:
    """Four cells' inputs of one slot (slot point (1, 0), the normalized
    plans' slot): per cell a PDSCH TB, a DCI, a PUSCH TB and its rx samples
    (the UE's PUSCH and SRS through the flat 4x2 channel), stacked on a
    leading cell axis; the bench's PRACH capture per cell; zero soft
    buffers."""
    n = NOF_CELLS
    sch = _up(rng.integers(0, 2, (n, PDSCH.tbs)).astype(np.int8), device)
    dci = _up(rng.integers(0, 2, (n, PDCCH.payload_bits)).astype(np.int8),
              device)
    tb = _up(rng.integers(0, 2, (n, PUSCH.tbs)).astype(np.int8), device)
    rx = torch.stack([channel(ue_samples(0, tb[c]), gen) for c in range(n)])
    prach_b = torch.as_tensor(np.stack([prach_capture(rng) for _ in range(n)]))
    softs = torch.zeros((n, SEG.nof_codeblocks, SEG.codeword_bits),
                        dtype=torch.float32, device=device)
    return dict(sch=sch, dci=dci, tb=tb, rx=rx, prach=(prach_b.to(device),),
                softs=(softs,))


# ------------------------------------------------------- the cell-edge slot

# The UEs a gNB serves worst: a power-limited UE sends DFT-s-OFDM for its
# lower PAPR (TS38.211 §6.3.1.4), hops in frequency for diversity (TS38.214
# §6.3) and carries its HARQ-ACK on the PUSCH; two more UEs send UCI on
# PUCCH F3 and F4.  Every PDU sets numerology 1 (ROADMAP §3).  The TBS
# follow TS38.214 §5.1.3.2 (UE A with 36 DM-RS REs per PRB, UE C with 24:
# two DM-RS symbols, whole symbols under transform precoding).
EDGE_SNR_DB = 10.0


@dataclasses.dataclass(frozen=True)
class EdgeScenario:
    """The cell-edge UL slot on one cell: UE A's PUSCH, UE C's
    transform-precoded hopping PUSCH with HARQ-ACK, a PUCCH F3 and a PUCCH
    F4, and the flagship's F1, PRACH and SRS."""

    cell: CellConfig
    pusch_a: pusch.PuschConfig
    pusch_c: pusch.PuschConfig
    f3: pucch.PucchF3Config
    f4: pucch.PucchF3Config
    pucch: pucch.PucchF1Config
    prach: prach.PrachConfig
    srs: srs.SrsConfig

    def plan(self) -> tuple:
        """The normalized UL plan (F3 before F4, as the conductor orders
        them)."""
        return ((self.pusch_a, self.pusch_c), (), (self.pucch,), (),
                (self.prach,), (self.srs,), (self.f3, self.f4))

    def ue_a_tx(self) -> pdsch.PdschConfig:
        """UE A's transmitter: the DL chain's PDSCH on the same REs."""
        a = self.pusch_a
        return pdsch.PdschConfig(
            rnti=a.rnti, rb_start=a.rb_start, rb_count=a.rb_count,
            first_symbol=a.first_symbol, nof_symbols=a.nof_symbols,
            modulation=a.modulation, target_code_rate=a.target_code_rate,
            tbs=a.tbs, nof_layers=a.nof_layers, n_id=a.n_id,
            dmrs_symbols=a.dmrs_symbols)


EDGE = EdgeScenario(
    cell=CELL,
    pusch_a=pusch.PuschConfig(
        rnti=0x17, rb_start=0, rb_count=240, first_symbol=0, nof_symbols=14,
        modulation="qam64", target_code_rate=0.7, tbs=262376, nof_layers=2,
        n_id=1, dmrs_symbols=(2, 7, 11), numerology=1),
    pusch_c=pusch.PuschConfig(
        rnti=0x19, rb_start=240, rb_count=6, first_symbol=0, nof_symbols=14,
        modulation="qpsk", target_code_rate=0.3, tbs=528, nof_layers=1,
        n_id=1, dmrs_symbols=(2, 9), numerology=1, equalizer="mmse",
        uci=UciOnPuschConfig(o_ack=2), transform_precoding=True,
        second_hop_prb=256),
    f3=pucch.PucchF3Config(rb_start=246, nof_rb=2, start_symbol=0,
                           nof_symbols=14, rnti=0x1a, n_id=1, n_id_hopping=1,
                           nof_uci_bits=22, pi2_bpsk=True),
    f4=pucch.PucchF3Config(rb_start=248, nof_rb=1, start_symbol=2,
                           nof_symbols=12, rnti=0x1b, n_id=1, n_id_hopping=1,
                           nof_uci_bits=8, occ_length=2, occ_index=1),
    pucch=PUCCH, prach=PRACH, srs=SRS)


def edge_program(sc: EdgeScenario = EDGE):
    """The cell-edge UL slot program, as a user calls it."""
    return ul_slot_fn(sc.cell, sc.plan())


def edge_uci(rng: np.random.Generator, sc: EdgeScenario = EDGE) -> dict:
    """One slot's UCI: UE C's HARQ-ACK, the F3 and the F4 payloads."""
    return dict(ack=rng.integers(0, 2, sc.pusch_c.uci.o_ack).astype(np.int8),
                f3=rng.integers(0, 2, sc.f3.nof_uci_bits).astype(np.int8),
                f4=rng.integers(0, 2, sc.f4.nof_uci_bits).astype(np.int8))


def edge_context(index: int, device, sc: EdgeScenario = EDGE) -> dict:
    """The slot context of cell-edge slot ``index`` (slot point (1,
    2*index)), as the port's conductor builds it: both PUSCHs' DM-RS pilot
    values (UE C's hop by hop), the F1 group's weights and the F3/F4 DM-RS
    values."""
    sif = (2 * index) % 20
    weights = pucch.f1_batch_weights(
        dataclasses.replace(sc.pucch, slot=sif),
        ((sc.pucch.initial_cyclic_shift, sc.pucch.time_domain_occ,
          sc.pucch.nof_harq_bits),))
    return {
        "pusch": tuple(_up(pusch.dmrs_pilot_values(dataclasses.replace(
            c, slot_in_frame=sif)), device)
            for c in (sc.pusch_a, sc.pusch_c)),
        "f0": (),
        "f1": (tuple(tuple(_up(w, device) for w in hop) for hop in weights),),
        "f2": (),
        "f3": tuple(_up(pucch.f3_dmrs_values_for(c, sif), device)
                    for c in (sc.f3, sc.f4)),
    }


def edge_rx(sif: int, tb_a: torch.Tensor, tb_c: torch.Tensor, uci: dict,
            gen: torch.Generator, sc: EdgeScenario = EDGE,
            snr_db: float = SNR_DB,
            edge_snr_db: float = EDGE_SNR_DB) -> torch.Tensor:
    """The gNB's samples of one cell-edge slot.  UE A's 2 layers (the
    port's DL chain, plus the SRS on its port 0) through a flat 4x2
    channel; UE C (``ue_tx.pusch_transmit``: DFT-s-OFDM, hopping, HARQ-ACK)
    through a flat channel of unit gain and random phase per rx port, a
    new one for each hop, scaled to ``edge_snr_db`` per RE and rx port;
    the F3 and F4 UEs (``pucch.transmit_format3``) through a flat 4x1
    channel; then AWGN at ``snr_db`` of UE A's received power."""
    dev = tb_a.device
    cell = sc.cell
    ue_a = sc.ue_a_tx()
    pilots = _up(dmrs.pilot_values_for(pdsch.dmrs_config(
        dataclasses.replace(ue_a, slot_in_frame=sif))), dev)
    _, grid_a = dl_slot_fn(cell, ((), (), (ue_a,), ()))(
        (), (), (tb_a,), {"pdsch": (pilots,)})
    grid_a = srs.map_to_grid(grid_a, sc.srs)
    grid_c = ue_tx.pusch_transmit(
        dataclasses.replace(sc.pusch_c, slot_in_frame=sif),
        tb_c.cpu().numpy(), uci["ack"], nof_sc=cell.nof_sc, device=dev)[0]
    grid_p = torch.zeros((1, 14, cell.nof_sc), dtype=torch.complex64,
                         device=dev)
    for cfg, bits in ((sc.f3, uci["f3"]), (sc.f4, uci["f4"])):
        grid_p = pucch.transmit_format3(
            grid_p, dataclasses.replace(cfg, slot=sif), bits)

    def samples(grid):
        return ofdm.modulate_slot(grid, cell.dft_size, cell.numerology,
                                  center_freq_hz=cell.center_freq_hz)

    def cn(shape):
        return torch.complex(torch.randn(shape, device=dev, generator=gen),
                             torch.randn(shape, device=dev, generator=gen))

    p = cell.nof_ports
    rx = cn((p, 2)) @ samples(grid_a)[:2]
    sigma2 = rx.abs().pow(2).mean() / 10 ** (snr_db / 10)
    phase = torch.rand((2, p), device=dev, generator=gen) * (2 * np.pi)
    hops = torch.polar(torch.ones_like(phase), phase)            # [hop, P]
    n1 = sc.pusch_c.nof_symbols // 2
    first = (torch.arange(14, device=dev) < sc.pusch_c.first_symbol + n1)
    h_c = torch.where(first[None, :], hops[0][:, None], hops[1][:, None])
    # unit-power REs; the unitary FFTs keep the noise at sigma2 per RE
    gain = torch.sqrt(10 ** (edge_snr_db / 10) * sigma2)
    rx = (rx + gain * samples(h_c[:, :, None] * grid_c[None])
          + (cn((p, 1)) / np.sqrt(2)) @ samples(grid_p))
    return rx + torch.randn(rx.shape, dtype=torch.complex64, device=dev,
                            generator=gen) * sigma2.sqrt()


def edge_slot(i: int, rng: np.random.Generator, gen: torch.Generator,
              device, sc: EdgeScenario = EDGE) -> dict:
    """Cell-edge slot ``i`` (slot point (1, 2i)) as a dict: ``tb_a``,
    ``tb_c`` (int8 payloads), ``uci`` (:func:`edge_uci`), ``rx`` (samples)
    and ``ctx``, all on ``device``."""
    tb_a = _up(rng.integers(0, 2, sc.pusch_a.tbs).astype(np.int8), device)
    tb_c = _up(rng.integers(0, 2, sc.pusch_c.tbs).astype(np.int8), device)
    uci = edge_uci(rng, sc)
    return dict(tb_a=tb_a, tb_c=tb_c, uci=uci,
                rx=edge_rx((2 * i) % 20, tb_a, tb_c, uci, gen, sc),
                ctx=edge_context(i, device, sc))


def make_edge_slots(n: int, rng: np.random.Generator, gen: torch.Generator,
                    device, sc: EdgeScenario = EDGE) -> list:
    """``n`` cell-edge slots (:func:`edge_slot`): slot i is slot point (1,
    2i)."""
    return [edge_slot(i, rng, gen, device, sc) for i in range(n)]


def edge_soft_buffers(device, sc: EdgeScenario = EDGE) -> tuple:
    """Zero HARQ soft buffers of both PUSCHs (first transmissions)."""
    return tuple(torch.zeros((s.nof_codeblocks, s.codeword_bits),
                             dtype=torch.float32, device=device)
                 for s in (pusch.segmentation(sc.pusch_a),
                           pusch.segmentation(sc.pusch_c)))


def check_edge_slot(out: dict, slot: dict, where: str) -> None:
    """Both TBs exact, UE C's HARQ-ACK, the F3 and F4 UCI as sent and
    valid, PRACH preamble 21 alone, finite channel reports."""
    for r, tb, name in zip(out["pusch"], (slot["tb_a"], slot["tb_c"]), "AC"):
        if not bool(r["tb_crc_ok"]):
            raise AssertionError(f"{where}: UE {name} TB CRC failed")
        if not torch.equal(r["tb_bits"], tb):
            raise AssertionError(f"{where}: UE {name} TB differs from payload")
        for k in ("snr", "rsrp", "epre", "evm", "cfo_hz", "ta_s"):
            if not bool(torch.isfinite(r[k]).all()):
                raise AssertionError(f"{where}: UE {name} {k} not finite")
    c, uci = out["pusch"][1], slot["uci"]
    if not (bool(c["harq_ack_valid"]) and np.array_equal(
            c["harq_ack_bits"].cpu().numpy(), uci["ack"])):
        raise AssertionError(f"{where}: UE C HARQ-ACK "
                             f"{c['harq_ack_bits'].cpu().numpy()} vs "
                             f"{uci['ack']}")
    for r, key in zip(out["pucch_f3"], ("f3", "f4")):
        if not (bool(r["valid"]) and np.array_equal(
                r["uci_bits"].cpu().numpy(), uci[key])):
            raise AssertionError(f"{where}: PUCCH {key.upper()} "
                                 f"{r['uci_bits'].cpu().numpy()} vs "
                                 f"{uci[key]}")
    det = out["prach"][0]["detected"]
    if not bool(det[PRACH_PREAMBLE]) or int(det.sum()) != 1:
        raise AssertionError(f"{where}: PRACH detections "
                             f"{torch.nonzero(det).flatten().tolist()}")


def edge_ul_request(i: int, sc: EdgeScenario = EDGE) -> messages.UlTtiRequest:
    """The cell-edge slot's UL_TTI.request at slot point (1, 2i)."""
    slot = SlotPoint(1, 2 * i)
    sl = slot.slot_index
    return messages.UlTtiRequest(
        slot=slot,
        pusch=tuple(dataclasses.replace(c, slot_in_frame=sl)
                    for c in (sc.pusch_a, sc.pusch_c)),
        pucch_f1=(dataclasses.replace(sc.pucch, slot=sl),),
        pucch_f3=(dataclasses.replace(sc.f3, slot=sl),),
        pucch_f4=(dataclasses.replace(sc.f4, slot=sl),),
        prach=(sc.prach,), srs=(sc.srs,))


def check_edge_results(res: messages.SlotResults, slot: dict,
                       where: str, sc: EdgeScenario = EDGE) -> None:
    """A conductor cell-edge slot's indications: both CRCs with the exact
    payloads, UE C's HARQ-ACK from its PUSCH, the F3 and F4 payloads as
    sent, PRACH 21."""
    if [c.tb_crc_ok for c in res.crc] != [True, True]:
        raise AssertionError(f"{where}: CRCs {[c.tb_crc_ok for c in res.crc]}")
    for got, tb in zip(res.rx_data, (slot["tb_a"], slot["tb_c"])):
        if not np.array_equal(got.payload, tb.cpu().numpy().astype(np.uint8)):
            raise AssertionError(f"{where}: RNTI {got.rnti:#x} payload differs")
    uci = slot["uci"]
    (u,) = [u for u in res.uci if u.source == "pusch"]
    if not (u.rnti == sc.pusch_c.rnti and u.detected
            and np.array_equal(u.harq_bits, uci["ack"])):
        raise AssertionError(f"{where}: UCI on PUSCH {u} vs sent {uci['ack']}")
    for cfg, key in ((sc.f3, "f3"), (sc.f4, "f4")):
        (u,) = [u for u in res.uci if u.rnti == cfg.rnti]
        if not (u.detected and np.array_equal(u.csi_bits, uci[key])):
            raise AssertionError(f"{where}: PUCCH {key.upper()} {u} vs sent "
                                 f"{uci[key]}")
    if [r.preamble_index for r in res.rach] != [PRACH_PREAMBLE]:
        raise AssertionError(f"{where}: PRACH detections "
                             f"{[r.preamble_index for r in res.rach]}")


def widest_tp(sc: EdgeScenario = EDGE) -> pusch.PuschConfig:
    """UE C's PDU on the widest DFT-s-OFDM allocation of the cell: the most
    RBs of the form 2^a 3^b 5^c (270 on the flagship cell, M = 3240)."""
    def smooth(n):
        for f in (2, 3, 5):
            while n % f == 0:
                n //= f
        return n == 1
    n = max(k for k in range(1, sc.cell.nof_rb + 1) if smooth(k))
    return dataclasses.replace(sc.pusch_c, rb_start=0, rb_count=n, tbs=0,
                               uci=UciOnPuschConfig(), second_hop_prb=None)


# K18's extra widths beside UE C's and the widest: 25 RB (M = 300, a
# radix-5 stage) and 243 RB (M = 2916 = 4 x 3^6, six radix-3 stages).
TP_EXTRA_RB = {"m300": 25, "m2916": 243}


def _tp_random_channel_args(grid: torch.Tensor, rb_count: int,
                            gen: torch.Generator,
                            sc: EdgeScenario = EDGE) -> tuple:
    """K18's arguments for UE C's PDU widened to ``rb_count`` RBs from RB 0
    (no hopping, no UCI) on ``grid``, with a seeded random channel and an
    estimator noise of 0.1 per port."""
    cfg = dataclasses.replace(widest_tp(sc), rb_count=rb_count)
    m = 12 * rb_count
    dev = grid.device
    p = grid.shape[-3]
    h = torch.complex(torch.randn((p, 1, 1, m), device=dev, generator=gen),
                      torch.randn((p, 1, 1, m), device=dev, generator=gen))
    key = pusch._tp_key(cfg)
    return (grid, h, const(pusch.tp_plan, key, 0, device=dev),
            torch.full((1, p), 0.1, device=dev),
            const(pusch.tp_plan, key, 1, device=dev), m,
            (cfg.rnti << 15) + cfg.n_id, cfg.modulation, cfg.equalizer)


def _tp_wide_cases(grid: torch.Tensor, gen: torch.Generator,
                   sc: EdgeScenario = EDGE) -> dict:
    """K18 at the widest allocation and at those of :data:`TP_EXTRA_RB`
    that fit the cell, each on ``grid`` with its own random channel."""
    tp = (ul_demap.tp_equalize_demap_descramble,
          ul_demap.tp_equalize_demap_descramble_ref)
    cases = {"pusch_tp_demap_widest": tp + (_tp_random_channel_args(
        grid, widest_tp(sc).rb_count, gen, sc),)}
    for tag, n in TP_EXTRA_RB.items():
        if n <= sc.cell.nof_rb:
            cases[f"pusch_tp_demap_{tag}"] = tp + (_tp_random_channel_args(
                grid, n, gen, sc),)
    return cases


def edge_kernel_cases(slot: dict, gen: torch.Generator,
                      sc: EdgeScenario = EDGE) -> dict:
    """name -> (wrapper, plain twin, args) for K18 and K19 at the cell-edge
    slot's shapes, from one slot's samples through the plain twins
    upstream: K18 at UE C (M = 72, both hops in one launch, MMSE) and K19
    at the F3 (2 RB, pi/2-BPSK).  Extra cases (compared and timed, not on
    the main path's list): K18 at the widest allocation (M = 3240 on the
    flagship, :func:`widest_tp`) and at :data:`TP_EXTRA_RB`, on the slot's
    grid with seeded random channels, K19 at the F4 (OCC 2, QPSK) and K8
    at the F3's stride-1 shape."""
    rx, ctx = slot["rx"], slot["ctx"]
    cell = sc.cell
    dev = rx.device
    grid = ofdm.demodulate_slot_ref(rx, cell.nof_sc, cell.dft_size,
                                    cell.numerology, cell.cp, 0,
                                    cell.center_freq_hz)
    cfg = sc.pusch_c
    ests, first = [], 0
    for h in pusch.hop_configs(cfg):
        rows = ctx["pusch"][1][first:first + len(h.dmrs_symbols)]
        first += len(h.dmrs_symbols)
        args, kw = pusch.estimate_args(grid, h, rows, (0,), 0)
        ests.append(chest.estimate_from_grid_ref(*args, **kw))
    key = pusch._tp_key(cfg)
    c_init = (cfg.rnti << 15) + cfg.n_id
    k18 = (grid, torch.cat([e.coeffs for e in ests], dim=-1),
           const(pusch.tp_plan, key, 0, device=dev),
           torch.stack([e.noise_var for e in ests]),
           const(pusch.tp_plan, key, 1, device=dev), 12 * cfg.rb_count,
           c_init, cfg.modulation, cfg.equalizer)
    cases = {
        "pusch_tp_demap": (ul_demap.tp_equalize_demap_descramble,
                           ul_demap.tp_equalize_demap_descramble_ref, k18),
        **_tp_wide_cases(grid, gen, sc)}
    for name, f3, values in (("", sc.f3, ctx["f3"][0]),
                             ("_f4", sc.f4, ctx["f3"][1])):
        args, kw = pucch.f3_estimate_args(grid, f3, values)
        est = chest.estimate_from_grid_ref(*args, **kw)
        cases["pucch_f3_demap" + name] = (
            pucch.f3_demap, pucch.f3_demap_ref,
            (grid, est.coeffs, est.noise_var, f3))
        if not name:
            cases["channel_estimate_f3"] = (
                functools.partial(chest.estimate_from_grid, **kw),
                functools.partial(chest.estimate_from_grid_ref, **kw), args)
    return cases


def edge_profile_cases(gen: torch.Generator, device,
                       sc: EdgeScenario = EDGE) -> dict:
    """K18's and K19's cases of :func:`edge_kernel_cases` (but K8's) on a
    seeded random grid, channels and noise, without the cell-edge
    transmitters: the same shapes, configurations and launches, for
    timing the wrappers (``launch_profile``)."""
    cell = sc.cell
    p = cell.nof_ports

    def cgauss(*shape):
        return torch.complex(torch.randn(shape, device=device, generator=gen),
                             torch.randn(shape, device=device, generator=gen))

    grid = cgauss(p, 14, cell.nof_sc)
    cfg = sc.pusch_c
    m = 12 * cfg.rb_count
    key = pusch._tp_key(cfg)
    nhops = len(pusch.hop_configs(cfg))
    k18 = (grid, cgauss(p, 1, 1, nhops * m),
           const(pusch.tp_plan, key, 0, device=device),
           torch.full((nhops, p), 0.1, device=device),
           const(pusch.tp_plan, key, 1, device=device), m,
           (cfg.rnti << 15) + cfg.n_id, cfg.modulation, cfg.equalizer)
    cases = {
        "pusch_tp_demap": (ul_demap.tp_equalize_demap_descramble,
                           ul_demap.tp_equalize_demap_descramble_ref, k18),
        **_tp_wide_cases(grid, gen, sc)}
    for name, f3 in (("", sc.f3), ("_f4", sc.f4)):
        cases["pucch_f3_demap" + name] = (
            pucch.f3_demap, pucch.f3_demap_ref,
            (grid, cgauss(p, 1, 1, 12 * f3.nof_rb),
             torch.full((p,), 0.1, device=device), f3))
    return cases


# ------------------------------------------------------------- gnb_sim

# The gNB simulator's kernels at the flagship shapes: K20 the 4x4 TDLA
# channel at 28 dB on one UE grid; K21 the B4 occasion of the app's PRACH
# (N_u = 4096 at 122.88 Msps, 12 repetitions, the window at the grid's
# low edge), plus format 0 at 30.72 Msps (N_u = 24,576: the table in
# global memory); K22 a 2-layer 256QAM PDSCH on 273 RB precoded per PRG of
# 4 PRBs (69 PRGs, each its own Type-I 2-layer matrix).
GNB_SINR_DB = 28.0
GNB_CHANNEL = chan.ChannelConfig(
    profile="TDLA", sinr_db=GNB_SINR_DB, nof_tx_ports=CELL.nof_ports,
    nof_rx_ports=CELL.nof_ports, nof_subc=CELL.nof_sc,
    scs_hz=15_000 << CELL.numerology)
GNB_PRACH_OFFSET_HZ = -(CELL.nof_sc // 2) * (15_000 << CELL.numerology)
# K21's cases: name -> (format, sample rate, start sample, frequency
# offset, FD occasions, RA SCS, samples per port), each on 4 ports.
PRACH_DEMOD_CASES = {
    "prach_demod": ("B4", CELL.dft_size * (15_000 << CELL.numerology), 256,
                    GNB_PRACH_OFFSET_HZ, 1, 15_000 << CELL.numerology,
                    12 * 4096 + 256),
    "prach_demod_n6144": ("B4", 6144 * (15_000 << CELL.numerology), 0,
                          GNB_PRACH_OFFSET_HZ, 1, 15_000 << CELL.numerology,
                          12 * 6144),
    "prach_demod_format0": ("0", 30_720_000, 0, GNB_PRACH_OFFSET_HZ, 1, 0,
                            24_576),
}
PRG_SIZE = 4
PRG_PDSCH = dataclasses.replace(
    PDSCH, nof_layers=2,
    tbs=mcs_tbs.tbs(273, 12, 24, "qam256", 0.8, 2),
    precoding=PrecodingConfig(
        prg_size=PRG_SIZE,
        pm_indices=tuple(34 + g % 32 for g in range(
            nof_prgs(0, 273, PRG_SIZE)))))


def gnb_kernel_cases(gen: torch.Generator, rng: np.random.Generator,
                     device) -> dict:
    """name -> (wrapper, plain twin, args) for K20, K21 and K22 on seeded
    inputs: "tdl_channel" on a random 4-port UE grid with shared draws;
    "prach_demod" on a random 4-port window of 12 x 4096 samples (and
    "prach_demod_n6144" at 184.32 Msps, "prach_demod_format0");
    "pdsch_map_prg" on an empty grid."""
    tx = torch.complex(
        torch.randn((CELL.nof_ports, 14, CELL.nof_sc), generator=gen,
                    device=device),
        torch.randn((CELL.nof_ports, 14, CELL.nof_sc), generator=gen,
                    device=device))
    gains, noise = chan.draw(GNB_CHANNEL, gen)
    k21 = {}
    for name, (*args, length) in PRACH_DEMOD_CASES.items():
        shape = (CELL.nof_ports, length)
        samples = torch.complex(
            torch.randn(shape, generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device))
        k21[name] = (prach_demod.demodulate, prach_demod.demodulate_ref,
                     (samples, *args))
    tb = _up(rng.integers(0, 2, PRG_PDSCH.tbs).astype(np.int8), device)
    cbs = ldpc_encode.dlsch_encode_ref(
        tb, pdsch.segmentation(PRG_PDSCH).base_graph).contiguous()
    grid = torch.zeros((CELL.nof_ports, 14, CELL.nof_sc),
                       dtype=torch.complex64, device=device)
    table = pdsch.pm_matrices_for(CELL.nof_ports, PRG_PDSCH, device)
    k22 = pdsch.map_args(grid, PRG_PDSCH, cbs, table) + (PRG_SIZE, 0)
    return {
        "tdl_channel": (chan.apply, chan.apply_ref,
                        (tx, GNB_CHANNEL, gains, noise)),
        **k21,
        "pdsch_map_prg": (_map_on_copy(dl_map.pdsch_map),
                          _map_on_copy(dl_map.pdsch_map_ref), k22),
    }


# K20's cases (launch_profile --cases tdl_channel): the gNB simulator's
# 4x4 TDLA at 28 dB, TDLC with a CFO (the rotation), uniform-phase fading,
# one rx port, and K = 288 (no multiple of the kernel's 64-subcarrier run).
CHANNEL_PROFILE_CASES = {
    "tdl_channel": GNB_CHANNEL,
    "tdl_channel_tdlc_cfo": dataclasses.replace(GNB_CHANNEL, profile="TDLC",
                                                cfo_hz=750.0),
    "tdl_channel_uniform": dataclasses.replace(GNB_CHANNEL,
                                               fading="uniform-phase"),
    "tdl_channel_r1": dataclasses.replace(GNB_CHANNEL, nof_rx_ports=1),
    "tdl_channel_k288": dataclasses.replace(GNB_CHANNEL, nof_subc=288),
}


def channel_profile_cases(gen: torch.Generator, device) -> dict:
    """name -> (``channel.apply``, its twin, args) of every
    CHANNEL_PROFILE_CASES entry on a random UE grid and draws from
    ``gen``."""
    cases = {}
    for name, cfg in CHANNEL_PROFILE_CASES.items():
        shape = (cfg.nof_tx_ports, cfg.nof_symbols, cfg.nof_subc)
        tx = torch.complex(torch.randn(shape, generator=gen, device=device),
                           torch.randn(shape, generator=gen, device=device))
        gains, noise = chan.draw(cfg, gen)
        cases[name] = (chan.apply, chan.apply_ref, (tx, cfg, gains, noise))
    return cases


def prg_single_table_case(device) -> tuple:
    """K22 with one PRG (G = 1: PRG size 273, the identity for both
    layers) and K6 on the same codeblocks and grid: (args with the table,
    args of K6), which must give the same grid bit for bit."""
    tb = _up(np.random.default_rng(22).integers(
        0, 2, PRG_PDSCH.tbs).astype(np.int8), device)
    cfg = dataclasses.replace(PRG_PDSCH, precoding=None)
    cbs = ldpc_encode.dlsch_encode_ref(
        tb, pdsch.segmentation(cfg).base_graph).contiguous()
    grid = torch.zeros((CELL.nof_ports, 14, CELL.nof_sc),
                       dtype=torch.complex64, device=device)
    w = pdsch.identity(CELL.nof_ports, cfg.nof_layers, device)
    k6 = pdsch.map_args(grid, cfg, cbs, w)
    return k6[:-1] + (w[None], CELL.nof_rb, 0), k6


# ------------------------------------------------------------- fronthaul
#: BFP mantissa width of the flagship's split-7.2 fronthaul.
OFH_WIDTH = 9
#: Widths K23 and K24 are also held against their twins at.
OFH_OTHER_WIDTHS = (8, 14)


def ofh_sections(nof_ports: int, nsym: int, nof_prb: int, width: int) -> list:
    """The table rows of a whole packed grid cut as RuOfh cuts it: per
    (port, symbol), sections of at most 255 PRBs, each the byte range of
    its PRBs' records (the packed grid's rows lie back to back)."""
    r = bfp.record_bytes(width)
    return [((port * nsym + sym) * nof_prb * r + p0 * r, port, sym, p0,
             min(255, nof_prb - p0), width)
            for port in range(nof_ports) for sym in range(nsym)
            for p0 in range(0, nof_prb, 255)]


def _decompress_into(grid: torch.Tensor, fn):
    """fn (K24 or its twin) writing into its own grid."""
    return lambda buf, table: fn(buf, table, grid)


def ofh_kernel_cases(rng: np.random.Generator, device) -> dict:
    """name -> (wrapper, plain twin, args) for K23 and K24 at the
    flagship's fronthaul shape (4 ports x 14 symbols x 3276 REs): a seeded
    Gaussian grid at 0.45 RMS per component, ~2.6% of components past full
    scale (1.0), with +-1.0, a value that rounds to -32768 and an all-zero
    PRB.  "bfp_compress" packs at width 9 (the U-plane path: payload
    only), "bfp_compress_mant" also writes (exp, mant); "bfp_decompress"
    decodes the packed grid cut into RuOfh's 255 + 18 PRB sections,
    "bfp_decompress_mant" the (exp, mant) mode; "_w8"/"_w14" at the other
    widths."""
    shape = (CELL.nof_ports, 14, CELL.nof_sc)
    iq = ((rng.normal(size=shape) + 1j * rng.normal(size=shape)) * 0.45
          ).astype(np.complex64)
    iq[0, 0, :4] = [1.0, -1.0 + 1j, -1.00001 - 1.00001j, 3.0 - 7.5j]
    iq[-1, -1, :12] = 0
    iq = _up(iq, device)
    cases = {}
    for width in (OFH_WIDTH,) + OFH_OTHER_WIDTHS:
        tag = "" if width == OFH_WIDTH else f"_w{width}"
        _, _, payload = bfp.compress_ref(iq, width)
        table = bfp.section_table(ofh_sections(*shape[:2], CELL.nof_rb,
                                               width))
        cases[f"bfp_compress{tag}"] = (bfp.compress, bfp.compress_ref,
                                       (iq, width))
        cases[f"bfp_decompress{tag}"] = (
            _decompress_into(torch.zeros_like(iq), bfp.decompress_sections),
            _decompress_into(torch.zeros_like(iq),
                             bfp.decompress_sections_ref),
            (payload.reshape(-1), table))
    exp, mant, _ = bfp.compress_ref(iq, OFH_WIDTH, mantissas=True)
    cases["bfp_compress_mant"] = (bfp.compress, bfp.compress_ref,
                                  (iq, OFH_WIDTH, True))
    cases["bfp_decompress_mant"] = (bfp.bfp_decompress, bfp.bfp_decompress_ref,
                                    (exp, mant))
    return cases


#: Sections of K24's small-section case on every port and symbol: (start
#: PRB, nof PRB) runs of 1, 7 and 18 PRBs, twice each.
OFH_SMALL_RUNS = ((0, 1), (5, 7), (40, 18), (100, 1), (130, 7), (200, 18))


def _ofh_grid(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    """A seeded Gaussian grid at 0.45 RMS per component."""
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape)) * 0.45
            ).astype(np.complex64)


def _scattered_sections(payload: np.ndarray, runs, width: int,
                        rng: np.random.Generator) -> tuple:
    """(buf uint8, table rows): the records of ``runs`` on every port and
    symbol of a packed grid [P, S, nof_prb, R], in a seeded order, each
    after a gap of 1-3 bytes (so most sections start at odd offsets)."""
    items = [(p, s, a, n) for p in range(payload.shape[0])
             for s in range(payload.shape[1]) for a, n in runs]
    chunks, rows, off = [], [], 0
    for i in rng.permutation(len(items)):
        p, s, a, n = items[i]
        gap = int(rng.integers(1, 4))
        chunks += [np.zeros(gap, np.uint8), payload[p, s, a:a + n].ravel()]
        rows.append((off + gap, p, s, a, n, width))
        off += gap + n * bfp.record_bytes(width)
    return np.concatenate(chunks), rows


def ofh_profile_cases(rng: np.random.Generator, device) -> dict:
    """K23's and K24's cases beyond :func:`ofh_kernel_cases`, for
    ``launch_profile`` and ``chip_smoke.py``: name -> (wrapper, twin, args).
    ``bfp_decompress_small``: the flagship grid's :data:`OFH_SMALL_RUNS`
    (1-, 7- and 18-PRB sections, 336 of them) in a seeded order at odd
    byte offsets, the rest of the grid left at zero; ``_batch2``: two
    slots' grids [2, 4, 14, 3276] compressed in one call, and their
    payload decoded as one [8, 14, 3276] grid cut as RuOfh cuts it (224
    sections, 1,008 tiles: one launch); ``bfp_decompress_mant_w14``: the
    (exp, mant) mode at width 14, its mantissas past the kernel's
    quotient table."""
    shape = (CELL.nof_ports, 14, CELL.nof_sc)
    iq = _up(_ofh_grid(rng, shape), device)
    payload = bfp.compress_ref(iq, OFH_WIDTH)[2]
    buf, rows = _scattered_sections(payload.cpu().numpy(), OFH_SMALL_RUNS,
                                    OFH_WIDTH, rng)
    cases = {"bfp_decompress_small": (
        _decompress_into(torch.zeros_like(iq), bfp.decompress_sections),
        _decompress_into(torch.zeros_like(iq), bfp.decompress_sections_ref),
        (_up(buf, device), bfp.section_table(rows)))}
    two = _up(_ofh_grid(rng, (2,) + shape), device)
    grid2 = torch.zeros((2 * shape[0],) + shape[1:], dtype=torch.complex64,
                        device=device)
    table2 = bfp.section_table(ofh_sections(2 * shape[0], 14, CELL.nof_rb,
                                            OFH_WIDTH))
    cases["bfp_compress_batch2"] = (bfp.compress, bfp.compress_ref,
                                    (two, OFH_WIDTH))
    cases["bfp_decompress_batch2"] = (
        _decompress_into(grid2, bfp.decompress_sections),
        _decompress_into(grid2.clone(), bfp.decompress_sections_ref),
        (bfp.compress_ref(two, OFH_WIDTH)[2].reshape(-1), table2))
    exp, mant, _ = bfp.compress_ref(iq, 14, mantissas=True)
    cases["bfp_decompress_mant_w14"] = (bfp.bfp_decompress,
                                        bfp.bfp_decompress_ref, (exp, mant))
    return cases


# ---------------------------------------------------------------- DU-low
# The split-6 DU-low's DL slots (apps/du_low.py behind the FAPI transport):
# the flagship PDSCH with PT-RS (port 0, K = 2, L = 1: 1,370 REs, so G =
# 31,390 x 32 = 1,004,480 bits, TBS 835,584 + 24 still fits) and the RS
# PDUs a split-6 MAC sends, none of them on the PDSCH's symbols 1-12:
#   A: SSB, AL8 PDCCH, PDSCH with PT-RS, 4-port NZP-CSI-RS (row 4, density
#      1) on 273 RB at symbol 13;
#   B: PDCCH, the same PDSCH, a TRS (row 1, density 3) at symbol 13;
#   C: a DL-PRS slot: a PDCCH in symbols 0-1 and a comb-4 PRS on 272 RB
#      (a multiple of the comb) over symbols 2-13, no PDSCH;
#   D: an empty DL_TTI.
# The UL slots are the conductor scenario's (ul_request, conductor_phases).
DU_PTRS = pdsch.PdschPtrs(time_density=1, freq_density=2, re_offset=0,
                          port=0)
DU_PDSCH = dataclasses.replace(PDSCH, ptrs=DU_PTRS)
DU_CSI = csi_rs.CsiRsConfig(row=4, rb_start=0, rb_count=273, symbol=13, k0=0,
                            scrambling_id=1)
DU_TRS = csi_rs.CsiRsConfig(row=1, rb_start=0, rb_count=273, symbol=13, k0=1,
                            scrambling_id=1)
DU_PRS_PDCCH = dataclasses.replace(
    PDCCH, coreset=dataclasses.replace(CORESET, duration=2))
DU_PRS = ptrs_prs.PrsConfig(rb_start=0, rb_count=272, first_symbol=2,
                            nof_symbols=12, comb_size=4, comb_offset=0,
                            n_id_prs=1)
DU_KINDS = ("A", "B", "C", "D")
#: The cell of the reconfiguration step (stop -> config -> start).
DU_SMALL_CELL = CellConfig(nof_ports=1, nof_rb=52, dft_size=1024,
                           numerology=1)


#: A DL slot of a MAC with many UEs: the SSB and 17 AL1 DCIs in a 96-RB,
#: 2-symbol CORESET beside the SSB's RBs -- 18 PDUs, more than one K27
#: launch takes (16), so the slot takes two.  Each DCI's patch spans the
#: CORESET, so the DCIs form one group, which the two launches split; the
#: last DCI also takes the first one's CCE (a MAC would not), so its data
#: REs add onto the first one's across the launches, in plan order.
DU_MANY_CORESET = pdcch.CoresetConfig(rb_start=24, nof_rb=96, start_symbol=0,
                                      duration=2)
DU_MANY_PDCCHS = 17
#: 33 one-port CSI-RS (row 1, density 3) at symbols 4-13 and k0 0-3 --
#: more RS PDUs than one K25 launch takes (32); PDUs 20 apart share their
#: REs, PDU 32 with PDU 12 across the two launches.
DU_MANY_CSI = tuple(
    csi_rs.CsiRsConfig(row=1, rb_start=0, rb_count=273, symbol=4 + j % 10,
                       k0=j % 4, scrambling_id=j) for j in range(33))


def du_many_pdcchs(slot_in_frame: int = 0) -> tuple:
    """The DU_MANY_PDCCHS DCIs of the many-UE slot (RNTIs 0x4601 + j)."""
    return tuple(dataclasses.replace(
        PDCCH, coreset=DU_MANY_CORESET, aggregation_level=1,
        cce_index=j % (DU_MANY_PDCCHS - 1), rnti=0x4601 + j,
        slot_in_frame=slot_in_frame) for j in range(DU_MANY_PDCCHS))


def du_many_request(payloads: dict, count: int = 0) -> tuple:
    """(DlTtiRequest, TxDataRequest) of the many-UE DL slot at slot point
    (1, count): the SSB and :func:`du_many_pdcchs`."""
    slot = SlotPoint(1, count)
    pdcchs = du_many_pdcchs(slot.slot_index)
    dl = messages.DlTtiRequest(
        slot=slot, ssb=(dataclasses.replace(SSB, sfn=slot.sfn),),
        pdcch=pdcchs)
    tx = messages.TxDataRequest(
        slot=slot, ssb_mib=(payloads["mib"],),
        pdcch_payloads=tuple(payloads["dci"][j % N_PAYLOAD_VARIANTS]
                             for j in range(len(pdcchs))))
    return dl, tx


def du_kind(i: int) -> str:
    return DU_KINDS[i % len(DU_KINDS)]


def du_dl_request(i: int) -> messages.DlTtiRequest:
    """DU-low DL slot i at slot point (1, 2i), of kind A, B, C, D in turn."""
    slot = SlotPoint(1, 2 * i)
    sl = slot.slot_index
    kind = du_kind(i)
    at = {"slot_in_frame": sl}
    if kind == "D":
        return messages.DlTtiRequest(slot=slot)
    if kind == "C":
        return messages.DlTtiRequest(
            slot=slot, pdcch=(dataclasses.replace(DU_PRS_PDCCH, **at),),
            prs=(dataclasses.replace(DU_PRS, **at),))
    rs = DU_CSI if kind == "A" else DU_TRS
    return messages.DlTtiRequest(
        slot=slot,
        ssb=((dataclasses.replace(SSB, sfn=slot.sfn),) if kind == "A" else ()),
        pdcch=(dataclasses.replace(PDCCH, **at),),
        pdsch=(dataclasses.replace(DU_PDSCH, **at),),
        csi_rs=(dataclasses.replace(rs, **at),))


def du_tx_request(i: int, payloads: dict) -> messages.TxDataRequest:
    """The payloads of DU-low DL slot i (dl_payloads' variants)."""
    dl = du_dl_request(i)
    v = i % N_PAYLOAD_VARIANTS
    return messages.TxDataRequest(
        slot=dl.slot,
        pdsch_payloads=tuple(payloads["sch"][v] for _ in dl.pdsch),
        pdcch_payloads=tuple(payloads["dci"][v] for _ in dl.pdcch),
        ssb_mib=tuple(payloads["mib"] for _ in dl.ssb))


def du_rs_items(dl: messages.DlTtiRequest, device) -> tuple:
    """The K25 items and values of a DU-low DL request's RS PDUs (PT-RS,
    CSI-RS, PRS), in the slot program's order, with the slot's values."""
    rs = [ptrs_prs.ptrs_item(pdsch.ptrs_config(c), device=device)
          for c in dl.pdsch if c.ptrs is not None]
    rs += [csi_rs.csi_item(c, CELL.nof_ports, device=device)
           for c in dl.csi_rs]
    rs += [ptrs_prs.prs_item(c, device=device) for c in dl.prs]
    return tuple(i for i, _ in rs), tuple(v for _, v in rs)


def du_loopback(samples: torch.Tensor, cfg: pdsch.PdschConfig,
                ssb_pdu=None):
    """Receive a DU-low slot's PDSCH back from its samples around its
    PT-RS REs, as :func:`dl_loopback`.  The JAX transmitter sums the SSB
    onto the data REs it shares (no rate matching around it), which no
    decoder survives (the REs fall in one or two codeblocks); with
    ``ssb_pdu`` = (SsbConfig, MIB bits) the receiver cancels the SSB it
    knows before the demap."""
    cell = DL_CELL
    grid = ofdm.demodulate_slot(samples, cell.nof_sc, cell.dft_size,
                                cell.numerology, cell.cp, 0,
                                cell.center_freq_hz)
    if ssb_pdu is not None:
        own = torch.zeros_like(grid)
        ssb.map_ssb_to_grid(own, ssb_pdu[0], ssb_pdu[1])
        grid = grid - own
    key = pdsch.plan_key(cfg)
    dev = samples.device
    sym = torch.as_tensor(pdsch.data_re_plan_column(*key, 0)).to(dev)
    sc = torch.as_tensor(pdsch.data_re_plan_column(*key, 1)).to(dev)
    x = (grid[:, sym, sc] / 0.5).T.reshape(-1)       # codeword symbol order
    nv = torch.full((1, x.numel()), 1e-2, device=dev)
    llr = demodulate(x[None], nv, cfg.modulation)[0]
    llr = descramble_llrs(llr, (cfg.rnti << 15) + cfg.n_id)
    return sch_decoder.decode(llr, pdsch.segmentation(cfg),
                              list(pdsch.rate_match_sizes(cfg)), cfg.rv, 8,
                              cfg.tbs)


def _du_slot_args(i: int, rng: np.random.Generator, device, batch=None):
    """(items, values, grid) of DU-low slot i's K25 launch on a seeded
    grid ([batch, ...] with per-slot values of slots i, i + 4, ...)."""
    shape = (CELL.nof_ports, 14, CELL.nof_sc)
    dls = [du_dl_request(i + 4 * b) for b in range(batch or 1)]
    items, _ = du_rs_items(dls[0], device)
    values = [du_rs_items(d, device)[1] for d in dls]
    if batch:
        values = tuple(torch.stack(v) for v in zip(*values))
    else:
        values = values[0]
    lead = (batch,) if batch else ()
    g = (rng.normal(size=lead + shape) + 1j * rng.normal(size=lead + shape))
    return items, values, _up(g.astype(np.complex64), device)


def _on_copy(fn):
    def run(grid, *args):
        return fn(grid.clone(), *args)
    return run


def du_kernel_cases(rng: np.random.Generator, device) -> dict:
    """name -> (wrapper, plain twin, args) for K25-K27 at the DU-low
    shapes, each adding into a seeded grid (on a copy): "rs_map" slot A's
    CSI-RS and PT-RS, "rs_map_trs" slot B's, "rs_map_prs" slot C's PRS,
    "rs_map_many" 33 CSI-RS (two launches), "rs_map_terms" targets of 1,
    2 and 3 terms at odd offsets (:func:`rs_terms_args`);
    "dmrs_map" the flagship PDSCH's 4 layers with the identity port map,
    "dmrs_map_matrix" with a [4, 4] matrix, "dmrs_map_prg" with 69 PRG
    matrices (PRG size 4); "control_map" slot A's SSB (with its slot
    context) and AL8 PDCCH in one launch, "control_map_al{1,2,4,16}" one
    PDCCH at each other aggregation level, "control_map_ssb_static" the SSB
    from its own config, "control_map_many" the many-UE slot (the SSB and
    17 DCIs, two launches), "control_map_overlap" slot A's SSB and AL8
    PDCCH with an AL4 DCI on the same CCEs, "control_map_negzero" slot A
    on a grid of -0.0 (no slot axis).  "<name>_b4": the same at B = 4
    (compared with B = 1 slot by slot by the caller)."""
    cases = {}
    for name, i in (("rs_map", 0), ("rs_map_trs", 1), ("rs_map_prs", 2),
                    ("rs_map_many", None)):
        for b in (None, 4):
            items, values, grid = (_du_slot_args(i, rng, device, b)
                                   if i is not None else
                                   _many_rs_args(rng, device, b))
            tag = "_b4" if b else ""
            cases[name + tag] = (_on_copy(dl_rs.rs_map),
                                 _on_copy(dl_rs.rs_map_ref),
                                 (grid, items, values))
    dcfg = pdsch.dmrs_config(PDSCH)
    w44 = ((rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))) / 2
           ).astype(np.complex64)
    prg = ((rng.normal(size=(69, 4, 4)) + 1j * rng.normal(size=(69, 4, 4)))
           / 2).astype(np.complex64)
    for name, w, prg_size in (
            ("dmrs_map", pdsch.identity(4, 4, device), 0),
            ("dmrs_map_matrix", _up(w44, device), 0),
            ("dmrs_map_prg", _up(prg, device), 4)):
        for b in (None, 4):
            lead = (b,) if b else ()
            pil = _up(np.stack([dmrs.pilot_values_for(dataclasses.replace(
                dcfg, slot_in_frame=2 * k)) for k in range(b or 1)]), device)
            pil = pil if b else pil[0]
            g = rng.normal(size=lead + (4, 14, CELL.nof_sc)) * (1 + 1j)
            cases[name + ("_b4" if b else "")] = (
                _on_copy(dl_rs.dmrs_map), _on_copy(dl_rs.dmrs_map_ref),
                (_up(g.astype(np.complex64), device), pil, w,
                 dcfg.ports, dcfg.symbols, dcfg.prb_list, prg_size,
                 dcfg.config_type))
    for name, al, with_ssb, ctx in (
            ("control_map", 8, True, True), ("control_map_al1", 1, False, 0),
            ("control_map_al2", 2, False, 0), ("control_map_al4", 4, False, 0),
            ("control_map_al16", 16, False, 0),
            ("control_map_ssb_static", 0, True, False)):
        for b in (None, 4):
            cases[name + ("_b4" if b else "")] = _control_case(
                rng, device, al, with_ssb, ctx, b)
    for b in (None, 4):
        cases["control_map_many" + ("_b4" if b else "")] = _control_case(
            rng, device, 1, True, True, b, many=True)
        cases["control_map_overlap" + ("_b4" if b else "")] = _control_case(
            rng, device, 8, True, True, b, overlap=True)
    cases["control_map_negzero"] = _control_case(rng, device, 8, True, True,
                                                  None, negzero=True)
    for b in (None, 4):
        items, values, grid = rs_terms_args(rng, device, b)
        cases["rs_map_terms" + ("_b4" if b else "")] = (
            _on_copy(dl_rs.rs_map), _on_copy(dl_rs.rs_map_ref),
            (grid, items, values))
    return cases


# K25 targets of several terms at odd offsets: per item (values, first
# subcarrier, step, weight, port, symbol); items 0-2 overlap on odd
# subcarriers of port 1, symbol 5 (1, 2 and 3 terms a target), item 3 adds
# single terms on port 3, symbol 11.
RS_TERMS = ((300, 1, 2, 0.5 - 0.25j, 1, 5), (200, 101, 2, -1j, 1, 5),
            (50, 201, 2, 0.75 + 0.5j, 1, 5), (64, 7, 6, 1 + 1j, 3, 11))


def rs_term_blocks(n: int, start: int, step: int, weight: complex,
                   port: int, symbol: int) -> tuple:
    """K25 blocks (ops/dl_rs.py::rs_plan) of value i at subcarrier start
    + step i, weighted."""
    return (n,), ((port, symbol, start + step * np.arange(n), np.arange(n),
                   weight),)


def rs_terms_args(rng: np.random.Generator, device, batch=None):
    """(items, values, grid) of the RS_TERMS K25 case on a seeded grid
    ([batch, ...] with per-slot values)."""
    shape = (CELL.nof_ports, 14, CELL.nof_sc)
    lead = (batch,) if batch else ()
    items = tuple((rs_term_blocks, t) for t in RS_TERMS)
    values = tuple(_up(((rng.normal(size=lead + (t[0],)) + 1j * rng.normal(
        size=lead + (t[0],))) / 2).astype(np.complex64), device)
        for t in RS_TERMS)
    g = (rng.normal(size=lead + shape) + 1j * rng.normal(size=lead + shape))
    return items, values, _up(g.astype(np.complex64), device)


def _many_rs_args(rng: np.random.Generator, device, batch=None):
    """(items, values, grid) of the DU_MANY_CSI K25 case on a seeded grid
    ([batch, ...] with per-slot values of slot_in_frame 0, 1, ...)."""
    shape = (CELL.nof_ports, 14, CELL.nof_sc)
    rs = [[csi_rs.csi_item(dataclasses.replace(c, slot_in_frame=b),
                           CELL.nof_ports, device=device)
           for c in DU_MANY_CSI] for b in range(batch or 1)]
    items = tuple(i for i, _ in rs[0])
    values = tuple(v for _, v in rs[0])
    if batch:
        values = tuple(torch.stack([r[j][1] for r in rs])
                       for j in range(len(items)))
    lead = (batch,) if batch else ()
    g = (rng.normal(size=lead + shape) + 1j * rng.normal(size=lead + shape))
    return items, values, _up(g.astype(np.complex64), device)


def control_pdcchs(al: int, many: bool = False,
                   overlap: bool = False) -> tuple:
    """The PDCCHs of a K27 case: none (``al`` 0), the flagship PDCCH at
    aggregation level ``al`` (in a 96-RB CORESET for AL 16), with
    ``overlap`` then an AL4 DCI of another RNTI on its first CCEs (REs
    that both add to), or with ``many`` the many-UE slot's
    :func:`du_many_pdcchs`."""
    if many:
        return du_many_pdcchs()
    if not al:
        return ()
    coreset = dataclasses.replace(CORESET, nof_rb=96 if al == 16 else 48)
    first = dataclasses.replace(PDCCH, coreset=coreset, aggregation_level=al)
    if not overlap:
        return (first,)
    return first, dataclasses.replace(first, aggregation_level=4,
                                      rnti=PDCCH.rnti + 1, payload_bits=44)


#: K27's host-path cases (``launch_profile``, ``chip_smoke.py`` phase 12):
#: name -> (aggregation level, with the SSB, many-UE slot).  The SSB always
#: with its slot context, as the DL slot programs map it.
CONTROL_PROFILE = {"control_map": (8, True, False),
                   "control_map_al8": (8, False, False),
                   "control_map_ssb": (0, True, False),
                   "control_map_al1": (1, False, False),
                   "control_map_al16": (16, False, False),
                   "control_map_many": (1, True, True)}


def control_profile_cases(rng: np.random.Generator, device) -> dict:
    """name -> (grid, inputs, items, pdcchs) of :data:`CONTROL_PROFILE`:
    K27's inputs on a seeded grid (as :func:`du_kernel_cases`' K27 cases
    build them), ``items(grid, inputs)`` the PDUs and ``pdcchs`` the
    case's PDCCH configurations."""
    out = {}
    for name, (al, with_ssb, many) in CONTROL_PROFILE.items():
        _, _, (grid, inputs, items) = _control_case(rng, device, al,
                                                    with_ssb, True, None,
                                                    many=many)
        out[name] = (grid, inputs, items, control_pdcchs(al, many))
    return out


def pusch_llr_count(cfg=PUSCH) -> int:
    """A PUSCH's codeword length G (no UCI, no PT-RS): every data RE of
    its allocation times Qm and the layers -- 426,096 LLRs at the
    flagship, K35's shape."""
    data_symbols = cfg.nof_symbols - len(cfg.dmrs_symbols)
    return (12 * cfg.rb_count * data_symbols
            * BITS_PER_SYMBOL[cfg.modulation] * cfg.nof_layers)


def _control_case(rng, device, al: int, with_ssb: bool, ctx: bool,
                  batch, many: bool = False, overlap: bool = False,
                  negzero: bool = False) -> tuple:
    """K27 on a seeded grid (with ``negzero`` a grid of -0.0, which the
    twins' dense adds turn to +0.0 under every patch): an SSB (slot
    context or none) and/or :func:`control_pdcchs`.
    args = (grid, inputs, items): the payloads, SSB context and PDCCH
    pilots (each [batch, ...] with a slot axis), and items(grid, inputs)
    the PDUs as K27 takes them."""
    lead = (batch,) if batch else ()
    n = batch or 1

    def bits(k):
        return _up(rng.integers(0, 2, lead + (k,)).astype(np.int8), device)

    g = ((rng.normal(size=lead + (4, 14, CELL.nof_sc))
          + 1j * rng.normal(size=lead + (4, 14, CELL.nof_sc))) * 0.1
         ).astype(np.complex64)
    if negzero:
        g = np.full(g.shape, complex(-0.0, -0.0), np.complex64)
    g = _up(g, device)
    inputs = {}
    if with_ssb:
        inputs["mib"] = bits(MIB_BITS)
        if ctx:
            pairs = [ssb.slot_ctx_for(dataclasses.replace(SSB, sfn=s))
                     for s in range(n)]
            for j, key in enumerate(("static", "mask")):
                inputs[key] = _up(np.stack([p[j] for p in pairs]) if batch
                                  else pairs[0][j], device)
    cfgs = control_pdcchs(al, many, overlap)
    for j, cfg in enumerate(cfgs):
        inputs[f"dci{j}"] = bits(cfg.payload_bits)
        pil = _up(np.stack([pdcch.dmrs_values_for(dataclasses.replace(
            cfg, slot_in_frame=s)) for s in range(n)]), device)
        inputs[f"pilots{j}"] = pil if batch else pil[0]

    def items(grid, inp):
        out = []
        if "mib" in inp:
            sctx = (inp["static"], inp["mask"]) if "static" in inp else None
            out.append(ssb.control_item(grid, SSB, inp["mib"], sctx))
        out += [pdcch.control_item(grid, inp[f"dci{j}"], cfg,
                                   dmrs_cinits=inp[f"pilots{j}"])
                for j, cfg in enumerate(cfgs)]
        return out

    def kernel(grid, inp, items):
        grid = grid.clone()
        return dl_control.control_map(grid, items(grid, inp))

    def ref(grid, inp, items):
        grid = grid.clone()
        for it in items(grid, inp):
            it.ref(grid)
        return grid

    return kernel, ref, (g, inputs, items)


def du_slot_of(name: str, args: tuple, b: int) -> tuple:
    """Slot ``b``'s B = 1 arguments of a "<name>_b4" case of
    :func:`du_kernel_cases`."""
    if name.startswith("rs_map"):
        grid, items, values = args
        return grid[b], items, tuple(v[b] for v in values)
    if name.startswith("dmrs_map"):
        return (args[0][b], args[1][b]) + args[2:]
    grid, inputs, items = args
    return grid[b], {k: v[b] for k, v in inputs.items()}, items


# ------------------------------------------- DU-low allocations (E, F, G)
#   E: the SSB, five DCIs on disjoint CCEs of a CORESET of their own, and
#      a 4-layer 256QAM PDSCH on an RA type 0 allocation around the SSB,
#      precoded per PRG;
#   F: one DCI and a 4-layer PDSCH on interleaved VRBs, unprecoded;
#   G: a type 0 PDSCH with PT-RS, which the validators reject.
#: Slot E's CORESET: 96 RB x 2 symbols = 32 CCEs, non-interleaved.
DU_E_CORESET = pdcch.CoresetConfig(rb_start=0, nof_rb=96, start_symbol=0,
                                   duration=2)
#: Slot E's DCIs: (aggregation level, first CCE), disjoint.
DU_E_CANDIDATES = ((16, 0), (8, 16), (4, 24), (2, 28), (1, 30))
#: RBG size P for a 273-RB BWP (TS 38.214 Table 5.1.2.2.1-1, config 1).
DU_RBG = 16
#: Slot E's type 0 bitmap: RBGs 2-8 and 10-17, PRBs 32-143 and 160-272;
#: RBGs 0-1 hold the SSB's PRBs 4-23, RBG 9 is a gap.
DU_E_PRBS = tuple(p for r in (*range(2, 9), *range(10, 18))
                  for p in range(DU_RBG * r, min(DU_RBG * (r + 1),
                                                 CELL.nof_rb)))
DU_E_PDSCH = dataclasses.replace(
    PDSCH, rb_start=DU_E_PRBS[0], rb_count=DU_E_PRBS[-1] - DU_E_PRBS[0] + 1,
    first_symbol=2, prbs=DU_E_PRBS,
    tbs=mcs_tbs.tbs(len(DU_E_PRBS), 12, 24, "qam256", 0.8, 4),
    precoding=PrecodingConfig(prg_size=PRG_SIZE, pm_indices=tuple(
        82 + g % 16 for g in range(nof_prgs(
            DU_E_PRBS[0], DU_E_PRBS[-1] - DU_E_PRBS[0] + 1, PRG_SIZE)))))
#: Slot F's PDSCH: VRBs [0, 136) through the interleaver (bundle size 2)
#: over the 273-RB BWP.
DU_F_PDSCH = dataclasses.replace(
    PDSCH, rb_count=136, vrb_prb_interleaved=True, bwp_size=CELL.nof_rb,
    tbs=mcs_tbs.tbs(136, 12, 24, "qam256", 0.8, 4))
DU_G_PDSCH = dataclasses.replace(DU_E_PDSCH, ptrs=DU_PTRS)
DU_ALLOC_KINDS = ("E", "F", "G")
DU_ALLOC_DCI_BITS = PDCCH.payload_bits


def du_alloc_pdcchs(kind: str, slot_in_frame: int = 0) -> tuple:
    """The DCIs of slot E (RNTIs 0x4611 + j, UE-specific scrambling) or F."""
    if kind == "E":
        return tuple(dataclasses.replace(
            PDCCH, coreset=DU_E_CORESET, aggregation_level=al, cce_index=cce,
            rnti=0x4611 + j, n_rnti=0x4611 + j, slot_in_frame=slot_in_frame)
            for j, (al, cce) in enumerate(DU_E_CANDIDATES))
    if kind == "F":
        return (dataclasses.replace(PDCCH, rnti=0x4620, n_rnti=0x4620,
                                    slot_in_frame=slot_in_frame),)
    return ()


def du_alloc_payloads(rng: np.random.Generator) -> dict:
    """Each kind's TB bits, one DCI payload per DCI (distinct), the MIB; as
    unpacked int8 bits (:func:`du_alloc_request` packs them)."""
    def bits(n):
        return rng.integers(0, 2, n).astype(np.int8)
    return {"E": bits(DU_E_PDSCH.tbs), "F": bits(DU_F_PDSCH.tbs),
            "G": bits(DU_G_PDSCH.tbs),
            "dci": tuple(bits(DU_ALLOC_DCI_BITS)
                         for _ in range(len(DU_E_CANDIDATES) + 1)),
            "mib": bits(MIB_BITS)}


def _packed(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8))


def du_alloc_request(kind: str, count: int, pay: dict) -> tuple:
    """(DlTtiRequest, TxDataRequest) of DU-low slot ``kind`` at slot point
    (1, count), the payloads packed as on the wire."""
    slot = SlotPoint(1, count)
    sl = slot.slot_index
    pdcchs = du_alloc_pdcchs(kind, sl)
    dcis = {"E": pay["dci"][:-1], "F": pay["dci"][-1:], "G": ()}[kind]
    cfg = {"E": DU_E_PDSCH, "F": DU_F_PDSCH, "G": DU_G_PDSCH}[kind]
    ssbs = (dataclasses.replace(SSB, sfn=slot.sfn),) if kind == "E" else ()
    dl = messages.DlTtiRequest(
        slot=slot, ssb=ssbs, pdcch=pdcchs,
        pdsch=(dataclasses.replace(cfg, slot_in_frame=sl),))
    tx = messages.TxDataRequest(
        slot=slot, ssb_mib=tuple(_packed(pay["mib"]) for _ in ssbs),
        pdcch_payloads=tuple(_packed(d) for d in dcis),
        pdsch_payloads=(_packed(pay[kind]),))
    return dl, tx


def du_control_rx(samples: torch.Tensor, dl: messages.DlTtiRequest,
                  noise_var: float = 0.01) -> tuple:
    """The UE side of a DU-low DL slot: OFDM demodulation of its samples
    (K4), every DCI's and the PBCH's LLRs in one K28 launch from port 0,
    then each DCI and the PBCH decoded (K15).  Returns ([(payload int8
    [A], crc_ok)] per DCI, [(payload a int8 [32] on the host, crc_ok)]
    per SSB)."""
    cell = DL_CELL
    grid = ofdm.demodulate_slot(samples, cell.nof_sc, cell.dft_size,
                                cell.numerology, cell.cp, 0,
                                cell.center_freq_hz).contiguous()
    shape = tuple(grid.shape)
    items = tuple([pdcch.rx_item(c, shape, noise_var) for c in dl.pdcch]
                  + [ssb.rx_item(c, shape, 0, noise_var=noise_var)
                     for c in dl.ssb])
    llrs = dl_control.control_llrs(grid, items)
    parts = torch.split(llrs, dl_control.rx_plan(items, grid.numel())["e"])
    n = len(dl.pdcch)
    return ([pdcch.decode_dci(p, c) for p, c in zip(parts[:n], dl.pdcch)],
            [ssb.pbch_decode_llrs(p, c) for p, c in zip(parts[n:], dl.ssb)])


def alloc_kernel_cases(rng: np.random.Generator, device) -> dict:
    """name -> (wrapper, plain twin, args) for the kernels of the DU-low's
    allocation slots on seeded inputs: "control_llrs" K28 on slot E's five
    DCIs and PBCH, "control_llrs_many" on 17 DCIs and the PBCH;
    "dmrs_map_type0" K26 on slot E's type 0 PRBs with 61 PRG matrices,
    "dmrs_map_interleaved" on slot F's PRBs, "dmrs_map_type2" type 2 with
    4 layers on ports 0, 1, 4, 5 and a [4, 4] matrix (K6's and K22's cases
    at these slots' plans are :func:`map_demap_profile_cases`'s);
    "rate_dematch_type0" K2 at slot E's G and
    "rate_dematch_nref" at the flagship PDSCH's with n_ref = 3N/4;
    "polar_decode_al16" K15 on one AL16 DCI with its RNTI's syndrome and
    "polar_decode_pbch" on one PBCH codeword, one codeword per launch as
    the UE side decodes them."""
    shape = (CELL.nof_ports, 14, CELL.nof_sc)

    def cgrid(scale=1.0):
        g = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * scale
        return _up(g.astype(np.complex64), device)

    def cmat(*s):
        return _up(((rng.normal(size=s) + 1j * rng.normal(size=s)) / 2
                    ).astype(np.complex64), device)

    cases = {}
    e_dcis = du_alloc_pdcchs("E")
    for name, dcis in (("control_llrs", e_dcis),
                       ("control_llrs_many", du_many_pdcchs())):
        items = tuple([pdcch.rx_item(c, shape, 0.01) for c in dcis]
                      + [ssb.rx_item(SSB, shape, 0, noise_var=0.02)])
        cases[name] = (dl_control.control_llrs, dl_control.control_llrs_ref,
                       (cgrid(), items))
    type2 = dmrs.DmrsConfig(rb_start=0, rb_count=CELL.nof_rb, symbols=(2, 11),
                            ports=(0, 1, 4, 5), scrambling_id=1,
                            config_type=2, slot_in_frame=3)
    for name, cfg, w, prg_size in (
            ("dmrs_map_type0", pdsch.dmrs_config(DU_E_PDSCH),
             cmat(len(DU_E_PDSCH.precoding.pm_indices), 4, 4), PRG_SIZE),
            ("dmrs_map_interleaved", pdsch.dmrs_config(DU_F_PDSCH),
             pdsch.identity(4, 4, device), 0),
            ("dmrs_map_type2", type2, cmat(4, 4), 0)):
        pil = _up(dmrs.pilot_values_for(cfg), device)
        cases[name] = (_on_copy(dl_rs.dmrs_map), _on_copy(dl_rs.dmrs_map_ref),
                       (cgrid(0.1), pil, w, cfg.ports, cfg.symbols,
                        cfg.prb_list, prg_size, cfg.config_type))
    n_ref = 3 * (pdsch.segmentation(PDSCH).codeword_bits // 4)
    for name, cfg, nr in (("rate_dematch_type0", DU_E_PDSCH, 0),
                          ("rate_dematch_nref", PDSCH, n_ref)):
        seg = pdsch.segmentation(cfg)
        e_sizes = pdsch.rate_match_sizes(cfg)
        llr = _up(rng.normal(size=sum(e_sizes)).astype(np.float32), device)
        soft = _up(rng.normal(size=(seg.nof_codeblocks, seg.codeword_bits)
                              ).astype(np.float32), device)
        cases[name] = (ldpc_rate_match.rate_dematch_combine,
                       ldpc_rate_match.rate_dematch_combine_ref,
                       (llr, seg.nof_codeblocks, e_sizes, cfg.rv, 8,
                        seg.base_graph, seg.lifting_size, seg.cb_info_bits,
                        seg.full_block_bits, seg.codeword_bits, soft, nr))
    code = pdcch._dci_code(DU_ALLOC_DCI_BITS + 24, 16 * pdcch.BITS_PER_CCE)
    for name, code, syndrome in (
            ("polar_decode_al16", code,
             pdcch.dci_syndrome(DU_ALLOC_DCI_BITS, e_dcis[0].rnti)),
            ("polar_decode_pbch", ssb._pbch_code(), 0)):
        msg = _up(rng.integers(0, 2, (1, code.k)).astype(np.int8), device)
        x = polar.rate_match(polar.encode(polar.allocate(msg, code), code.n),
                             code).to(torch.float32)
        llr = (1.0 - 2.0 * x) + _up(0.8 * rng.normal(size=tuple(x.shape)),
                                    device).to(torch.float32)
        cases[name] = (polar.decode, polar.decode_ref,
                       (llr.contiguous(), code, "crc24C", syndrome))
    return cases


# ------------------------------------------- K8's and K15's profile cases

#: The delay (samples of a 2 x nsc point symbol) and noise of the K8
#: profile cases' channel: a clear TA peak, as a real slot has.
PROFILE_DELAY = 6.0
PROFILE_NOISE = 0.05


def _chest_signal(args: tuple, kw: dict, gen: torch.Generator) -> tuple:
    """K8's arguments ``args`` with their grid replaced by noise plus the
    pilots through a random flat channel per (port, layer) and a delay of
    PROFILE_DELAY samples (a slot axis: each slot its own channel)."""
    grid, symbols, first_sc, expected, scs = args[:5]
    dev = grid.device
    lead = tuple(grid.shape[:-3])
    n_p, n_l = grid.shape[-3], expected.shape[-3]
    noise = torch.randn(grid.shape, dtype=torch.complex64, device=dev,
                        generator=gen)
    h = torch.randn(lead + (n_p, n_l, 1), dtype=torch.complex64, device=dev,
                    generator=gen)
    nfft = 1 << int(np.ceil(np.log2(2 * args[5])))
    ramp = torch.as_tensor(np.exp(-2j * np.pi * np.asarray(scs)
                                  * PROFILE_DELAY / nfft).astype(np.complex64),
                           device=dev)
    out = PROFILE_NOISE * noise
    cols = torch.as_tensor(first_sc + np.asarray(scs), device=dev)
    for i, s in enumerate(symbols):
        rx = (h * expected[..., i, :].unsqueeze(-3) * ramp).sum(dim=-2)
        out[..., s, cols] += rx
    return (out,) + tuple(args[1:])


def _through_caller(build, fn):
    """``fn`` (K8 or its twin) on the arguments ``build`` makes from the
    grid anew on every call, as the receive chains call it."""
    def call(grid: torch.Tensor):
        args, kw = build(grid)
        return fn(*args, **kw)
    return call


def chest_polar_profile_cases(gen: torch.Generator, device) -> dict:
    """K8's and K15's cases for ``launch_profile``: name -> (wrapper, twin,
    args), on seeded random channels and messages of the main path's
    shapes.  K8: the flagship PUSCH (2 layers, fd-OCC, CFO), the flagship
    SRS, the F2's comb 3, the cell edge's F3 (stride 1), slot E's type 0
    comb averaged and interpolated, the PUSCH over a batch of 4 slots, and
    the flagship PUSCH and SRS through their callers (``_caller``: the
    arguments, numpy pilot lists and times among them, made anew each
    call by ``pusch.estimate_args`` / ``srs.estimate_args``);
    K15: the F2's codeword (N = 64), the PBCH (N = 512), an AL16 DCI with
    its RNTI's syndrome at B = 4, N = 1024 (K = 111, E = 1000), and the
    F2's codeword over a batch of 4 slots."""
    rng = np.random.default_rng(7)
    cases = {}
    grid = torch.zeros((CELL.nof_ports, 14, CELL.nof_sc),
                       dtype=torch.complex64, device=device)
    ctx = ul_slot_context(0, device)
    f2 = F2_POLAR
    edge = edge_context(0, device)
    ests = {
        "": pusch.estimate_args(grid, PUSCH, ctx["pusch"][0], (0, 1), 0),
        "_srs": srs.estimate_args(grid, SRS),
        "_f2": pucch.f2_estimate_args(
            grid, f2, _up(pucch.f2_pilot_values_for(f2), device)),
        "_f3": pucch.f3_estimate_args(grid, EDGE.f3, edge["f3"][0]),
    }
    vals = torch.stack([ul_slot_context(i, device)["pusch"][0]
                        for i in range(BATCH)])
    ests["_batch4"] = pusch.estimate_args(
        grid.expand((BATCH,) + grid.shape), PUSCH, vals, (0, 1), 0)
    for name, (args, kw) in ests.items():
        cases["channel_estimate" + name] = (
            functools.partial(chest.estimate_from_grid, **kw),
            functools.partial(chest.estimate_from_grid_ref, **kw),
            _chest_signal(args, kw, gen))
    for name, build in (
            ("", lambda g: pusch.estimate_args(g, PUSCH, ctx["pusch"][0],
                                               (0, 1), 0)),
            ("_srs", lambda g: srs.estimate_args(g, SRS))):
        cases["channel_estimate" + name + "_caller"] = (
            _through_caller(build, chest.estimate_from_grid),
            _through_caller(build, chest.estimate_from_grid_ref),
            cases["channel_estimate" + name][2][:1])
    for td in ("average", "interpolate"):
        args, kw = type0_chest_case(rng, device, td)
        cases["channel_estimate_type0" + ("" if td == "average"
                                          else "_interp")] = (
            functools.partial(chest.estimate_from_grid, **kw),
            functools.partial(chest.estimate_from_grid_ref, **kw), args)
    f2_code, f2_crc = pucch._f2_polar_cfg(f2.nof_uci_bits, 64)
    dci_code = pdcch._dci_code(DU_ALLOC_DCI_BITS + 24,
                               16 * pdcch.BITS_PER_CCE)
    for name, code, crc_name, syndrome, lead in (
            ("", f2_code, f"crc{f2_crc}", 0, (1,)),
            ("_pbch", ssb._pbch_code(), "crc24C", 0, (1,)),
            ("_al16", dci_code, "crc24C",
             pdcch.dci_syndrome(DU_ALLOC_DCI_BITS, PDCCH.rnti), (4,)),
            ("_n1024", polar_params.polar_code(111, 1000, nmax=10,
                                               ibil=True), "crc11", 0, (1,)),
            ("_batch4", f2_code, f"crc{f2_crc}", 0, (BATCH, 1))):
        b = int(np.prod(lead))
        msg = _up(rng.integers(0, 2, (b, code.k)).astype(np.int8), device)
        x = polar.rate_match(polar.encode(polar.allocate(msg, code), code.n),
                             code).to(torch.float32)
        llr = (1.0 - 2.0 * x) + 0.8 * torch.randn(
            x.shape, device=device, generator=gen)
        cases["polar_decode" + name] = (
            polar.decode, polar.decode_ref,
            (llr.reshape(lead + (code.e,)).contiguous(), code, crc_name,
             syndrome))
    return cases


# K9's further configurations: the gNB simulator's PRACH occasion at the
# flagship numerology (B4, root 1, zcz 0: 64 roots of one preamble each,
# apps/gnb_sim.py) and a long format 0 occasion (zcz 10, L_RA 839), both on
# 4 rx ports.
PRACH_ZCZ0 = prach.PrachConfig(format="B4", root_sequence_index=1,
                               zero_correlation_zone=0, ra_scs_hz=30_000)
PRACH_FORMAT0 = prach.PrachConfig(format="0", root_sequence_index=22,
                                  zero_correlation_zone=10)


def _prach_occasion(cfg, preamble: int, symbols: int,
                    rng: np.random.Generator) -> np.ndarray:
    """``preamble`` of ``cfg`` through a 2 us delay onto 4 rx ports at gains
    0.9 to 0.6, ``symbols`` repeated symbols, complex noise of 0.05 per
    part; complex64 [4, symbols, L]."""
    tx = prach.generate_np(cfg, preamble)
    ramp = np.exp(-2j * np.pi * np.arange(cfg.l_ra) * cfg.scs_hz * 2e-6)
    fd = np.linspace(0.9, 0.6, 4)[:, None, None] * np.tile(
        (tx * ramp)[None, None], (4, symbols, 1))
    fd = fd + 0.05 * (rng.standard_normal(fd.shape)
                      + 1j * rng.standard_normal(fd.shape))
    return fd.astype(np.complex64)


def prach_lxn_profile_cases(gen: torch.Generator, device) -> dict:
    """K9's and K16's cases for ``launch_profile``: name -> (wrapper, twin,
    args).  K9: the flagship occasion (``prach_detect``), a batch of 4
    (``_batch4``: :func:`batch_prach_fd`), the gNB simulator's zcz 0
    (``_zcz0``, R 64) and format 0 (``_format0``).  K16 on seeded channels
    (I + 0.25 (N + jN) a subcarrier) and grids of the two-UE slot's shapes:
    UE A (4 layers MMSE QAM64, 27,060 REs: ``pusch_demap_lxn``), UE A over
    4 slots (``_batch4``), UE B (1 layer MMSE QAM64: ``_ue_b``), UE A's REs
    at 3 layers ZF and 2 layers MMSE (``_3l_zf``, ``_2l_mmse``) and at 1
    layer BPSK MMSE (``_bpsk``)."""
    rng = np.random.default_rng(23)
    cases = {}
    for name, cfg, cap in (
            ("", PRACH, prach_capture(rng)[None]),
            ("_zcz0", PRACH_ZCZ0, _prach_occasion(PRACH_ZCZ0, 5, 12, rng)[
                None]),
            ("_format0", PRACH_FORMAT0, _prach_occasion(PRACH_FORMAT0, 37, 1,
                                                        rng)[None])):
        cases["prach_detect" + name] = (prach.detect, prach.detect_ref,
                                        (_up(cap[0], device), cfg))
    cases["prach_detect_batch4"] = (prach.detect, prach.detect_ref,
                                    (batch_prach_fd(device, 23)[0], PRACH))

    def cn(*shape):
        return torch.complex(torch.randn(shape, device=device, generator=gen),
                             torch.randn(shape, device=device, generator=gen)
                             ) / np.sqrt(2)

    for name, cfg, layers, method, modulation, lead in (
            ("", MU.pusch_a, 4, "mmse", "qam64", ()),
            ("_batch4", MU.pusch_a, 4, "mmse", "qam64", (BATCH,)),
            ("_ue_b", MU.ue_b(1), 1, "mmse", "qam64", ()),
            ("_3l_zf", MU.pusch_a, 3, "zf", "qam64", ()),
            ("_2l_mmse", MU.pusch_a, 2, "mmse", "qam64", ()),
            ("_bpsk", MU.pusch_a, 1, "mmse", "bpsk", ())):
        nsc = 12 * cfg.rb_count
        grid = cn(*lead, CELL.nof_ports, 14, CELL.nof_sc)
        eye = torch.eye(CELL.nof_ports, layers, dtype=torch.complex64,
                        device=device)[:, :, None, None]
        coeffs = (eye + 0.25 * cn(*lead, CELL.nof_ports, layers, 1, nsc))
        nv = torch.full(lead, 0.05, device=device)
        sym, sc = pusch._plan(cfg, device)
        cases["pusch_demap_lxn" + name] = (
            ul_demap.equalize_demap_descramble_lxn,
            ul_demap.equalize_demap_descramble_ref,
            (grid, coeffs.contiguous(), sym, sc, cfg.rb_start * 12, nv,
             (cfg.rnti << 15) + cfg.n_id, modulation, layers, method))
    return cases


# K4's and K7's further cases: extended CP at 60 kHz (100 MHz: 135 RB, N
# 2048) and a 20 MHz cell at 15 kHz sampled at 23.04 MHz (106 RB, N 1536,
# the Stockham form), both on the flagship's 4 ports.
OFDM_EXTENDED_CELL = CellConfig(nof_ports=4, nof_rb=135, dft_size=2048,
                                numerology=2, cp=ofdm.CyclicPrefix.EXTENDED)
OFDM_1536_CELL = CellConfig(nof_ports=4, nof_rb=106, dft_size=1536,
                            numerology=0)


def ofdm_profile_cases(gen: torch.Generator, device) -> dict:
    """K4's and K7's cases for ``launch_profile`` and ``chip_smoke.py``:
    name -> (wrapper, twin, args) on seeded random samples and grids.  K4
    (``ofdm_demodulate``): the flagship UL slot (P 4, S 14, N 4096, K
    3276), a batch of 4 (``_batch4``), the DU-low's small cell (1 port, N
    1024: ``_n1024``), the flagship at the largest window offset, 144
    (``_offset_max``), extended CP (:data:`OFDM_EXTENDED_CELL`:
    ``_extended``) and N = 1536 (:data:`OFDM_1536_CELL`: ``_n1536``, the
    Stockham form).  K7 (``ofdm_modulate``): the same but the offset, at
    the cell's TX scale."""
    def cn(*shape):
        return torch.complex(torch.randn(shape, device=device, generator=gen),
                             torch.randn(shape, device=device, generator=gen)
                             ) / np.sqrt(2)

    cases = {}
    for name, cell, lead, offset in (
            ("", CELL, (), 0), ("_batch4", CELL, (BATCH,), 0),
            ("_n1024", DU_SMALL_CELL, (), 0),
            ("_offset_max", CELL, (),
             ofdm.max_window_offset(CELL.dft_size)),
            ("_extended", OFDM_EXTENDED_CELL, (), 0),
            ("_n1536", OFDM_1536_CELL, (), 0)):
        samples = cn(*lead, cell.nof_ports, cell.slot_samples(0))
        cases["ofdm_demodulate" + name] = (
            ofdm.demodulate_slot, ofdm.demodulate_slot_ref,
            (samples, cell.nof_sc, cell.dft_size, cell.numerology, cell.cp,
             0, cell.center_freq_hz, 1.0, offset))
        if offset:
            continue
        nsym = 14 if cell.cp is ofdm.CyclicPrefix.NORMAL else 12
        grid = cn(*lead, cell.nof_ports, nsym, cell.nof_sc)
        cases["ofdm_modulate" + name] = (
            ofdm.modulate_slot, ofdm.modulate_slot_ref,
            (grid, cell.dft_size, cell.numerology, cell.cp, 0,
             cell.center_freq_hz, cell.tx_scale))
    return cases


def map_demap_profile_cases(gen: torch.Generator, device) -> dict:
    """K6's, K22's and K3's cases for ``launch_profile``, ``profile_slot``
    and ``chip_smoke.py`` (their one builder): name -> (wrapper, twin,
    args) on seeded random
    codeblocks, grids and channels.  K6 (``pdsch_map``; the wrappers add
    into the grid they are given: compare them on copies) on the flagship
    PDSCH (P 4, L 4, 256QAM, 32,760 REs, 100 codeblocks), over 4 slots
    (``_batch4``), on slot F's interleaved plan (``_interleaved``), with
    n_ref = 3N/4 (``_nref``) and on :data:`REPETITION` (``_repetition``:
    E beyond N_nf, the window wrapping); K22 on slot E's type 0 plan with
    its 61 PRG matrices (``pdsch_map_prg_type0``).  K3 (``pusch_demap``)
    on the flagship PUSCH (P 4, 2 layers ZF, QAM64, 35,508 REs), over 4
    slots (``_batch4``), at 1 layer (``_1l``), and on both hops of
    :data:`BPSK_PUSCH` (pi/2-BPSK, 2 layers): hop 1 (``_hop1``) and hop
    2 from hop 1's Gold offset (``_hop2``); channels I + 0.25 (N + jN) a
    subcarrier, noise variance 0.05."""
    rng = np.random.default_rng(25)

    def cn(*shape):
        return torch.complex(torch.randn(shape, device=device, generator=gen),
                             torch.randn(shape, device=device, generator=gen)
                             ) / np.sqrt(2)

    cases = {}
    n_ref = 3 * (pdsch.segmentation(PDSCH).codeword_bits // 4)
    for name, cfg, lead, nr in (
            ("pdsch_map", PDSCH, (), 0),
            ("pdsch_map_batch4", PDSCH, (BATCH,), 0),
            ("pdsch_map_interleaved", DU_F_PDSCH, (), 0),
            ("pdsch_map_nref", PDSCH, (), n_ref),
            ("pdsch_map_repetition", REPETITION, (), 0),
            ("pdsch_map_prg_type0", DU_E_PDSCH, (), 0)):
        tb = _up(rng.integers(0, 2, lead + (cfg.tbs,)).astype(np.int8), device)
        cbs = ldpc_encode.dlsch_encode_ref(
            tb, pdsch.segmentation(cfg).base_graph).contiguous()
        w = (pdsch.pm_matrices_for(CELL.nof_ports, cfg, device)
             if cfg.precoding else
             pdsch.identity(CELL.nof_ports, cfg.nof_layers, device))
        prg = cfg.precoding.prg_size if cfg.precoding else 0
        grid = 0.1 * cn(*lead, CELL.nof_ports, 14, CELL.nof_sc)
        cases[name] = (dl_map.pdsch_map, dl_map.pdsch_map_ref,
                       pdsch.map_args(grid, cfg, cbs, w)
                       + (prg, pdsch.prg_span(cfg)[0], nr))
    hop1, hop2 = pusch.hop_configs(BPSK_PUSCH)
    hop1_llrs = pusch._plan(hop1, device)[0].numel() * hop1.nof_layers
    for name, cfg, layers, lead, advance in (
            ("pusch_demap", PUSCH, 2, (), 0),
            ("pusch_demap_batch4", PUSCH, 2, (BATCH,), 0),
            ("pusch_demap_1l", PUSCH, 1, (), 0),
            ("pusch_demap_hop1", hop1, 2, (), 0),
            ("pusch_demap_hop2", hop2, 2, (), hop1_llrs)):
        nsc = 12 * cfg.rb_count
        grid = cn(*lead, CELL.nof_ports, 14, CELL.nof_sc)
        eye = torch.eye(CELL.nof_ports, layers, dtype=torch.complex64,
                        device=device)[:, :, None, None]
        coeffs = eye + 0.25 * cn(*lead, CELL.nof_ports, layers, 1, nsc)
        nv = torch.full(lead, 0.05, device=device)
        sym, sc = pusch._plan(cfg, device)
        cases[name] = (
            ul_demap.equalize_demap_descramble,
            ul_demap.equalize_demap_descramble_ref,
            (grid, coeffs.contiguous(), sym, sc, cfg.rb_start * 12, nv,
             (cfg.rnti << 15) + cfg.n_id, cfg.modulation, layers, "zf",
             advance))
    return cases


# K10's and K13's further cases: an F1 occasion hopping to PRB 9 (the GPU
# tests' shape) and the largest F2 PDU (16 RB x 2 symbols: 512 LLRs).
F1_HOP_PRB = 9
F2_WIDEST = dataclasses.replace(F2_POLAR, rb_start=200, nof_rb=16)


def _f1_case_users(n: int) -> tuple:
    """n users of one occasion on distinct cyclic shifts: (4u mod 12 +
    u // 3, u mod 2, 1 + u mod 2), the GPU tests' three users first."""
    return tuple(((4 * u) % 12 + u // 3, u % 2, 1 + u % 2) for u in range(n))


def _f1_case_grid(common, users, rng: np.random.Generator,
                  gen: torch.Generator, device) -> torch.Tensor:
    """One slot's grid [P, 14, K] with each user's F1 (random bits) on
    every port through a random complex gain, plus noise of variance
    0.0025."""
    p = CELL.nof_ports
    grid = torch.zeros((p, 14, CELL.nof_sc), dtype=torch.complex64,
                       device=device)
    for m0, occ, nbits in users:
        cfg = dataclasses.replace(common, initial_cyclic_shift=m0,
                                  time_domain_occ=occ, nof_harq_bits=nbits)
        one = pucch.transmit_format1(torch.zeros_like(grid), cfg,
                                     rng.integers(0, 2, nbits))[0]
        gain = rng.standard_normal((p, 2)).astype(np.float32) / np.sqrt(2)
        grid += _up(gain[:, 0] + 1j * gain[:, 1], device)[:, None, None] * one
    noise = torch.randn(grid.shape, dtype=torch.complex64, device=device,
                        generator=gen)
    return grid + 0.05 * noise


def pucch_profile_cases(gen: torch.Generator, device) -> dict:
    """K10's and K13's cases beyond the flagship's, for ``launch_profile``
    and ``chip_smoke.py``: name -> (wrapper, twin, args).  The flagship
    entries stay with their builders, :func:`kernel_cases`
    (``pucch_f1_detect``) and :func:`conductor_kernel_cases`
    (``pucch_f2_demap``, ``_1rb``).  Here: K10 with 3 users and a hop to
    :data:`F1_HOP_PRB` (``_3u_hop``), with 12 (``_12u_hop``), and over a
    batch of 4 (the flagship occasion in slots 1-4, each slot's weights
    stacked by ``stack_ctx`` as the conductor stacks its slot contexts:
    ``_batch4``), on grids of seeded F1 users (:func:`_f1_case_grid`); K13
    on :data:`F2_WIDEST` (``_16rb``) and over a batch of 4 of ``F2_POLAR``
    (``_batch4``), on seeded grids and channels I + 0.25 (N + jN) a
    subcarrier, noise variance 0.05."""
    rng = np.random.default_rng(26)
    cases = {}
    common = dataclasses.replace(PUCCH, slot=4, second_hop_prb=F1_HOP_PRB)
    for name, n in (("_3u_hop", 3), ("_12u_hop", 12)):
        users = _f1_case_users(n)
        weights = tuple(tuple(_up(w, device) for w in hop)
                        for hop in pucch.f1_batch_weights(common, users))
        cases["pucch_f1_detect" + name] = (
            pucch.f1_detect, pucch.f1_detect_ref,
            (_f1_case_grid(common, users, rng, gen, device), common,
             weights, 1.5))
    grids = torch.stack([_f1_case_grid(
        dataclasses.replace(PUCCH, slot=(2 * g) % 20), F1_USERS, rng, gen,
        device) for g in BATCH_PHASES])
    weights = stack_ctx([ul_slot_context(g, device)
                         for g in BATCH_PHASES])[0]["f1"][0]
    cases["pucch_f1_detect_batch4"] = (pucch.f1_detect, pucch.f1_detect_ref,
                                       (grids, PUCCH, weights, 1.5))

    def cn(*shape):
        return torch.complex(torch.randn(shape, device=device, generator=gen),
                             torch.randn(shape, device=device, generator=gen)
                             ) / np.sqrt(2)

    p = CELL.nof_ports
    for name, cfg, lead in (("_16rb", F2_WIDEST, ()),
                            ("_batch4", F2_POLAR, (BATCH,))):
        one = torch.ones((p, 1, 1, 12 * cfg.nof_rb), dtype=torch.complex64,
                         device=device)
        coeffs = one + 0.25 * cn(*lead, p, 1, 1, 12 * cfg.nof_rb)
        cases["pucch_f2_demap" + name] = (
            pucch.f2_demap, pucch.f2_demap_ref,
            (cn(*lead, p, 14, CELL.nof_sc), coeffs,
             torch.full(lead + (p,), 0.05, device=device), cfg))
    return cases


def uci_profile_cases(gen: torch.Generator, device) -> dict:
    """K12's and K14's cases beyond the flagship's, for ``launch_profile``
    and ``chip_smoke.py``: name -> (wrapper, twin, args).  The flagship
    entries stay with their builder, :func:`conductor_kernel_cases`
    (``pucch_f0_detect``, ``_10db``, ``short_block_detect``, ``_k11``).
    Here: K12 over a batch of 4 (the flagship F0 in slots 1-4, each slot's
    references and its own dictionary entry sent through a random gain a
    port, noise to 10 dB over the occasion: ``pucch_f0_detect_batch4``)
    and on one such slot with 1 port and 1 symbol (its candidate rows one
    lane each, one pass: ``pucch_f0_detect_p1``), and K14 over a slot axis
    of 4 slots of the 1-RB F2's codeword (K = 6, E = 32, Qm 2: [4, 1, 32],
    as a batch decodes it; ``short_block_detect_batch4``) on noisy LLRs of
    seeded messages."""
    rng = np.random.default_rng(27)
    table = pucch._F0_TABLES[(F0.nof_harq_bits, F0.sr_opportunity)]

    def occasion(cfg, p):
        _, sr, harq = table[rng.integers(len(table))]
        one = pucch.transmit_format0(
            torch.zeros((p, 14, CELL.nof_sc), dtype=torch.complex64,
                        device=device), cfg, harq, sr or 0)[0]
        gain = rng.standard_normal((p, 2)).astype(np.float32) / np.sqrt(2)
        sent = _up((gain[:, 0] + 1j * gain[:, 1]).astype(np.complex64),
                   device)[:, None, None] * one
        occ = sent[:, cfg.start_symbol:cfg.start_symbol + cfg.nof_symbols,
                   12 * cfg.prb:12 * cfg.prb + 12]
        sigma2 = occ.abs().pow(2).mean() / 10.0
        return (sent + sigma2.sqrt() * torch.randn(
            sent.shape, dtype=torch.complex64, device=device, generator=gen),
            _up(pucch.f0_refs_for(cfg), device))

    grids, refs = zip(*(occasion(dataclasses.replace(F0, slot=(2 * g) % 20),
                                 CELL.nof_ports) for g in BATCH_PHASES))
    cases = {"pucch_f0_detect_batch4": (
        pucch.f0_detect, pucch.f0_detect_ref,
        (torch.stack(grids), F0, torch.stack(refs), 4.0))}
    e, k = 16 * F2_SB.nof_rb * F2_SB.nof_symbols, F2_SB.nof_uci_bits
    bits = short_block.encode(torch.as_tensor(
        rng.integers(0, 2, (BATCH, k)).astype(np.int8)).to(device), e, 2)
    llr = (1.0 - 2.0 * bits.to(torch.float32)) + 0.8 * torch.randn(
        bits.shape, device=device, generator=gen)
    cases["short_block_detect_batch4"] = (
        short_block.detect, short_block.detect_ref, (llr[:, None], k, 2))
    f0_p1 = dataclasses.replace(F0, slot=2, nof_symbols=1)
    grid, refs = occasion(f0_p1, 1)
    cases["pucch_f0_detect_p1"] = (pucch.f0_detect, pucch.f0_detect_ref,
                                   (grid, f0_p1, refs, 4.0))
    return cases


# K11's further SRS occasions: 4 SRS ports on 48 RB at comb 4 (K = 144),
# and the widest, 4 ports on 272 RB at comb 2 over 4 symbols (K = 1632).
SRS_48RB = srs.SrsConfig(rb_start=200, rb_count=48, start_symbol=13,
                         nof_symbols=1, comb=4, comb_offset=0, cyclic_shift=0,
                         nof_ports=4, sequence_id=1, numerology=1)
SRS_WIDEST = srs.SrsConfig(rb_start=0, rb_count=272, start_symbol=10,
                           nof_symbols=4, comb=2, comb_offset=1,
                           cyclic_shift=3, nof_ports=4, sequence_id=7,
                           numerology=1)


def _srs_case(cfg, grids: torch.Tensor, k8: bool) -> tuple:
    """K11's arguments on ``grids`` ([(B,) P, 14, K]): the TA and RSRP of
    K8's estimate (its strided views over a slot axis), as ``estimate``
    hands them on, or with ``k8`` False of K8's twin (K8 holds at most
    ~2,000 averages a TA row in shared memory: not a comb of 1632)."""
    args, kw = srs.estimate_args(grids, cfg)
    est = (chest.estimate_from_grid if k8 else chest.estimate_from_grid_ref)(
        *args, **kw)
    return (grids, cfg, est.time_alignment_s, est.rsrp)


def rs_profile_cases(device) -> dict:
    """K11's and K26's cases for ``launch_profile`` and ``chip_smoke.py``:
    name -> (wrapper, twin, args), each wrapper in place (K26 adds into the
    case's grid; check it on copies).  K11 (``srs.srs_noise``) on the
    flagship SRS (``srs_noise``: 4 rx ports, K = 24, 1 SRS port, 1 symbol),
    over a batch of 4 (``_batch4``), on :data:`SRS_48RB` (``_48rb``: K =
    144, 4 SRS ports) and :data:`SRS_WIDEST` (``_k1632``: K = 1632, 4
    ports, 4 symbols), each sent through a seeded 4 x L channel with noise
    at 26 dB a RE, TA and RSRP from K8 as ``srs.estimate`` takes them (from
    its twin at K = 1632, :func:`_srs_case`); K26 (``dl_rs.dmrs_map``) on
    the flagship PDSCH (``dmrs_map``: 4 layers, 2 symbols, 273 RB, type 1,
    identity [4, 4]), over a batch of 4 with
    per-slot pilots (``_b4``), with 69 PRG matrices (``_prg``), slot E's
    type 0 PRBs with their PRG matrices (``_type0``), slot F's interleaved
    PRBs (``_interleaved``) and type 2 on ports 0, 1, 4, 5 with a [4, 4]
    matrix (``_type2``), on seeded grids."""
    rng = np.random.default_rng(28)

    def cn(*shape):
        return _up(((rng.standard_normal(shape) + 1j * rng.standard_normal(
            shape)) / np.sqrt(2)).astype(np.complex64), device)

    def srs_grid(cfg):
        p = CELL.nof_ports
        tx = srs.map_to_grid(torch.zeros((p, 14, CELL.nof_sc),
                                         dtype=torch.complex64,
                                         device=device), cfg)
        return (torch.einsum("rp,psk->rsk", cn(p, p), tx)
                + 0.05 * cn(p, 14, CELL.nof_sc))

    cases = {}
    for name, cfg, b in (("srs_noise", SRS, None),
                         ("srs_noise_batch4", SRS, BATCH),
                         ("srs_noise_48rb", SRS_48RB, None),
                         ("srs_noise_k1632", SRS_WIDEST, None)):
        grids = (srs_grid(cfg) if b is None
                 else torch.stack([srs_grid(cfg) for _ in range(b)]))
        cases[name] = (srs.srs_noise, srs.srs_noise_ref,
                       _srs_case(cfg, grids, cfg is not SRS_WIDEST))
    dcfg = pdsch.dmrs_config(PDSCH)
    type2 = dmrs.DmrsConfig(rb_start=0, rb_count=CELL.nof_rb, symbols=(2, 11),
                            ports=(0, 1, 4, 5), scrambling_id=1,
                            config_type=2, slot_in_frame=3)
    e_cfg = pdsch.dmrs_config(DU_E_PDSCH)
    for name, cfg, w, prg_size, b in (
            ("dmrs_map", dcfg, pdsch.identity(4, 4, device), 0, None),
            ("dmrs_map_b4", dcfg, pdsch.identity(4, 4, device), 0, BATCH),
            ("dmrs_map_prg", dcfg, cn(69, 4, 4), PRG_SIZE, None),
            ("dmrs_map_type0", e_cfg,
             cn(len(DU_E_PDSCH.precoding.pm_indices), 4, 4), PRG_SIZE, None),
            ("dmrs_map_interleaved", pdsch.dmrs_config(DU_F_PDSCH),
             pdsch.identity(4, 4, device), 0, None),
            ("dmrs_map_type2", type2, cn(4, 4), 0, None)):
        lead = (b,) if b else ()
        pil = _up(np.stack([dmrs.pilot_values_for(dataclasses.replace(
            cfg, slot_in_frame=2 * k + 1)) for k in range(b or 1)]), device)
        cases[name] = (dl_rs.dmrs_map, dl_rs.dmrs_map_ref, (
            cn(*lead, CELL.nof_ports, 14, CELL.nof_sc), pil if b else pil[0],
            w, cfg.ports, cfg.symbols, cfg.prb_list, prg_size,
            cfg.config_type))
    return cases


# ------------------------------------------------------------- split 8

# apps/ssb_tx.py's cell at the flagship width: 1 port, 273 RB, 4096 FFT.
SPLIT8_CELL = CellConfig(nof_ports=1, nof_rb=273, dft_size=4096, numerology=1)
# One UE slot's blind decodes: 36 monitored PDCCH candidates at 30 kHz
# (TS 38.213 Table 10.1-2), here all at AL16 (N = 512, E = 1728), at a
# noise sigma of 0.8 on BPSK; decoded at list size 8.
UE_CANDIDATES = 36
UE_CANDIDATE_SIGMA = 0.8
SCL_LIST = 8
CLIP_SHARE = 0.01


def ue_candidates(rng: np.random.Generator, device) -> tuple:
    """UE_CANDIDATES AL16 DCI codewords of random payloads through BPSK and
    AWGN, rate-dematched: (LLRs f32 [36, 512] on ``device``, code)."""
    a = DU_ALLOC_DCI_BITS
    code = pdcch._dci_code(a + 24, pdcch.BITS_PER_CCE * 16)
    msg = rng.integers(0, 2, (UE_CANDIDATES, a + 24)).astype(np.int8)
    x = polar.rate_match(polar.encode(polar.allocate(torch.as_tensor(msg),
                                                     code), code.n),
                         code).numpy()
    rx = ((1.0 - 2.0 * x) + UE_CANDIDATE_SIGMA * rng.standard_normal(
        x.shape)).astype(np.float32)
    return polar.rate_dematch(_up(rx, device), code), code


def clip_ceiling_dbfs(x: torch.Tensor, share: float = CLIP_SHARE) -> float:
    """A ceiling (dBFS, full scale 1) that clips about ``share`` of the
    samples of ``x``."""
    mag = np.sort(np.abs(x.cpu().numpy()).ravel())
    return 20 * float(np.log10(mag[int(len(mag) * (1 - share))]))


# BPSK PUSCHs without transform precoding at the flagship width (TS38.211
# allows pi/2-BPSK only with transform precoding, but the JAX receiver
# decodes either): pi/2-BPSK, 2 layers, ZF (K3), and BPSK, 1 layer, MMSE
# (K16), each on 130 RB hopping from PRB 0 to 136, a DM-RS symbol per hop.
BPSK_PUSCH = pusch.PuschConfig(
    rnti=0x23, rb_start=0, rb_count=130, first_symbol=0, nof_symbols=14,
    modulation="pi2bpsk", target_code_rate=0.4,
    tbs=mcs_tbs.tbs(130, 14, 12, "qpsk", 0.2, 2), nof_layers=2, n_id=3,
    dmrs_symbols=(2, 9), second_hop_prb=136, numerology=1)
BPSK_PUSCH_MMSE = dataclasses.replace(
    BPSK_PUSCH, modulation="bpsk", nof_layers=1, equalizer="mmse",
    tbs=mcs_tbs.tbs(130, 14, 12, "qpsk", 0.2, 1))


def bpsk_rx(cfg, seed: int, nof_sc: int, sigma: float = 0.04) -> tuple:
    """A received 2-port grid (numpy complex64 [2, 14, nof_sc]) of a PUSCH
    without transform precoding at 1 or 2 layers, and its payload: the
    port's PDSCH transmitter (on the CPU, identity precoding) on the
    PDU's first PRBs; with hopping its symbols from the second hop on moved
    to the hop-2 PRBs beside that hop's own DM-RS; a flat 2 x L channel
    per hop and AWGN, all drawn from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, cfg.tbs).astype(np.int8)
    layers = cfg.nof_layers
    ue = pdsch.PdschConfig(
        rnti=cfg.rnti, rb_start=cfg.rb_start, rb_count=cfg.rb_count,
        first_symbol=cfg.first_symbol, nof_symbols=cfg.nof_symbols,
        modulation=cfg.modulation, target_code_rate=cfg.target_code_rate,
        tbs=cfg.tbs, nof_layers=layers, n_id=cfg.n_id,
        dmrs_symbols=cfg.dmrs_symbols)
    eye = np.eye(layers, dtype=np.complex64)
    tx = pdsch.process(torch.zeros((layers, 14, nof_sc),
                                   dtype=torch.complex64),
                       torch.as_tensor(payload), ue, precoding=eye)
    hops = pusch.hop_configs(cfg)
    n1 = cfg.nof_symbols if len(hops) == 1 else hops[1].first_symbol
    if len(hops) > 1:
        k0, m = 12 * hops[1].rb_start, 12 * cfg.rb_count
        tx[:, n1:, k0:k0 + m] = tx[:, n1:, :m]
        tx[:, n1:, :m] = 0
        for sym in hops[1].dmrs_symbols:
            tx[:, sym] = 0
        dmrs.map_to_grid(tx, pusch.dmrs_config(hops[1]), eye)
    h1 = np.array([[0.9 * np.exp(0.4j), 0.3 * np.exp(1.1j)],
                   [0.2 * np.exp(-0.7j), 0.6 * np.exp(-0.2j)]])[:, :layers]
    h2 = np.array([[0.5 * np.exp(1.2j), 0.2 * np.exp(-0.3j)],
                   [0.3 * np.exp(0.5j), 0.8 * np.exp(0.9j)]])[:, :layers]
    tx = tx.numpy()
    rx = np.concatenate([np.einsum("pl,lsk->psk", h1, tx[:, :n1]),
                         np.einsum("pl,lsk->psk", h2, tx[:, n1:])], axis=1)
    rx += sigma / np.sqrt(2) * (rng.normal(size=rx.shape)
                                + 1j * rng.normal(size=rx.shape))
    return rx.astype(np.complex64), payload


def rate_match_args(rng: np.random.Generator, device) -> tuple:
    """K32's arguments on the flagship PUSCH (the UE transmitter's): a
    random TB's 37 codeblocks, their E sizes, rv 0 and the segmentation."""
    payload = _up(rng.integers(0, 2, UE.tbs).astype(np.int8), device)
    cbs = ldpc_encode.dlsch_encode(payload, SEG.base_graph)
    return (cbs, pdsch.rate_match_sizes(UE), 0,
            BITS_PER_SYMBOL[UE.modulation], SEG.base_graph, SEG.lifting_size,
            SEG.cb_info_bits, SEG.full_block_bits)


def split8_kernel_cases(rng: np.random.Generator, device,
                        dl_samples: torch.Tensor, cfo_norm: float) -> dict:
    """name -> (wrapper, plain twin, args) for the split-8 slice's kernels:
    "polar_scl_decode" K29 on one UE slot's 36 AL16 candidates (L = 8, no
    CRC: a DCI's CRC is masked by its RNTI), "rate_match" K32 on the
    flagship PUSCH's codeblocks at rv 0 (the UE transmitter's), and K30
    ("cfo_rotate") and K31 ("amplitude_control", a clip of about 1% of the
    samples) on ``dl_samples``."""
    cand, code = ue_candidates(rng, device)
    return {
        "polar_scl_decode": (polar_scl.scl_decode, polar_scl.scl_decode_ref,
                             (cand, code, SCL_LIST, None)),
        "rate_match": (ldpc_rate_match.rate_match_batch,
                       ldpc_rate_match.rate_match_batch_ref,
                       rate_match_args(rng, device)),
        "cfo_rotate": (cfo.apply_cfo, cfo.apply_cfo_ref,
                       (dl_samples, cfo_norm, 0)),
        "amplitude_control": (amplitude_control.clip,
                              amplitude_control.clip_ref,
                              (dl_samples, 0.0,
                               clip_ceiling_dbfs(dl_samples))),
    }


# ------------------------------------------------ the last device functions

#: Phase 16's K8 on an irregular comb: slot E's type 0 DM-RS (type 1, CDM
#: group 0, ports 0-1) on 4 rx ports, through a channel with a delay of
#: TYPE0_DELAY samples of a 2048-point symbol and noise of TYPE0_NOISE.
TYPE0_DELAY = 9
TYPE0_NOISE = 0.05


def type0_chest_case(rng: np.random.Generator, device,
                     td_strategy: str = "average") -> tuple:
    """(args, kw) of ``chest.estimate_from_grid`` on slot E's type 0 PRB
    list (``DU_E_PDSCH``): the pilots of DM-RS ports 0 and 1 (the fd-OCC
    cover on port 1, so ``cdm_pairs``) at their absolute subcarriers on
    the DM-RS symbols of a [4, 14, 3276] grid, ``filter`` smoothing, CFO
    from the symbol times, ``td_strategy`` as given."""
    cfg = dataclasses.replace(pdsch.dmrs_config(DU_E_PDSCH), ports=(0, 1))
    pilots = torch.stack([dmrs.pilots_for_port(cfg, p, device="cpu")
                          for p in cfg.ports]).numpy()             # [2, S, K]
    scs = dmrs._type1_sc_indices(cfg.rb_start, cfg.rb_count, 0, cfg.prbs)
    nsc, ports = CELL.nof_sc, CELL.nof_ports
    h = ((rng.normal(size=(ports, 2, 1)) + 1j * rng.normal(size=(ports, 2, 1)))
         * np.exp(-2j * np.pi * np.arange(nsc) * TYPE0_DELAY / 2048)[None, None])
    grid = TYPE0_NOISE * (rng.normal(size=(ports, 14, nsc))
                          + 1j * rng.normal(size=(ports, 14, nsc)))
    for i, s in enumerate(cfg.symbols):
        grid[:, s, scs] += (h[:, :, scs] * pilots[None, :, i]).sum(axis=1)
    syms = tuple(int(s) for s in cfg.symbols)
    args = (_up(grid.astype(np.complex64), device), syms, 0,
            _up(pilots.astype(np.complex64), device), scs, nsc, 14,
            float(15_000 << CELL.numerology))
    kw = dict(stride=2, smoothing="filter", cdm_pairs=True,
              dmrs_symbol_times_s=pusch._symbol_times(CELL.numerology)[
                  list(syms)],
              td_strategy=td_strategy, dmrs_symbol_idx=np.array(syms))
    return args, kw


#: Phase 16's batch of UCI codewords (the cell edge's F3 code) and the
#: short-block sweep: K 1-11 at each Qm, two lengths each.
LAST_UCI_BATCH = 64
SB_QMS = (1, 2, 4, 6)


def _f3_coded_bits(cfg: pucch.PucchF3Config) -> int:
    return (len(pucch._f3_symbol_split(cfg)[1]) * 12 * cfg.nof_rb
            // cfg.occ_length * pucch._f3_qm(cfg))


def ue_encoder_inputs(rng: np.random.Generator, device) -> dict:
    """The UE-side encoders' inputs on the flagship cell (K33, K34): a MIB,
    slot E's DCIs and payloads, one slot's PUCCH UCI (phase 4's F2s), the
    F2's and a batch of LAST_UCI_BATCH F3 polar messages (CRC attached)
    and 11-bit short-block messages."""
    def bits(shape):
        return _up(rng.integers(0, 2, shape).astype(np.int8), device)

    dcis = du_alloc_pdcchs("E")
    uci = ue_uci(rng)
    f2_code, f2_crc = pucch._f2_polar_cfg(
        F2_POLAR.nof_uci_bits, 16 * F2_POLAR.nof_rb * F2_POLAR.nof_symbols)
    f2_bits = _up(uci["f2_polar"], device)[None]
    uci_code, _ = uci_codec._polar_cfg(EDGE.f3.nof_uci_bits,
                                       _f3_coded_bits(EDGE.f3))
    return dict(
        mib=bits(MIB_BITS), dcis=dcis,
        dci_payloads=[_up(p, device) for p in
                      du_alloc_payloads(rng)["dci"][:len(dcis)]],
        uci=uci, f2_code=f2_code,
        f2_msg=torch.cat([f2_bits, crc(f2_bits, f"crc{f2_crc}")], dim=-1),
        uci_code=uci_code, uci_msg=bits((LAST_UCI_BATCH, uci_code.k)),
        sb_bits=bits((LAST_UCI_BATCH, 11)))


def last_inputs(rng: np.random.Generator, ul_slot: tuple, device) -> dict:
    """The inputs of :func:`last_path` on the flagship cell: the UE-side
    encoders' (:func:`ue_encoder_inputs`), K8's type 0 cases at both time
    strategies, and ``ul_slot`` (payload, rx samples, context) of
    :func:`make_slots`."""
    inp = ue_encoder_inputs(rng, device)
    inp.update(
        chest={td: type0_chest_case(rng, device, td)
               for td in ("average", "interpolate")},
        ul_slot=ul_slot,
        flip=_up(rng.integers(0, SEG.codeword_bits, SEG.nof_codeblocks),
                 device))
    return inp


def last_path(inp: dict) -> dict:
    """The last device functions on the flagship cell, as phase 16 of
    ``chip_smoke.py`` drives them: the PBCH by ``pbch_encode`` (K33) and
    ``pbch_modulate`` beside K27's SSB patch; slot E's DCIs mapped by K27,
    encoded again by ``encode_dci`` (K33) and received back (K28, K15);
    the F2s sent (K33, K34);
    the UCI batch (K33); K34 at every K and Qm; the flagship PUSCH's LLRs
    (K4, K8, K3) quantized and dequantized (K35) and decoded (K2, K1); K1
    on every check row and K36 on its codeblocks, clean and with one bit
    flipped in each; K8 on the type 0 comb.  Returns the outputs."""
    cell, seg, cfg = CELL, SEG, PUSCH
    payload, rx, ctx = inp["ul_slot"]
    dev = rx.device
    out = {}
    out["pbch"] = ssb.pbch_modulate(ssb.pbch_encode(SSB, inp["mib"]), SSB)
    out["ssb_patch"] = ssb.ssb_block(SSB, inp["mib"])
    empty = torch.zeros((1, 14, cell.nof_sc), dtype=torch.complex64,
                        device=dev)
    grid = empty.clone()
    for c, p in zip(inp["dcis"], inp["dci_payloads"]):
        pdcch.process(grid, p, c)
    out["pdcch_grid"] = grid
    out["encoded_dcis"] = [pdcch.encode_dci(p, c) for c, p in
                           zip(inp["dcis"], inp["dci_payloads"])]
    out["decoded_dcis"] = [pdcch.recover(grid, c) for c in inp["dcis"]]
    out["f2_grids"] = [pucch.transmit_format2(empty, c, inp["uci"][key])
                       for c, key in ((F2_POLAR, "f2_polar"),
                                      (F2_SB, "f2_sb"))]
    out["uci_batch"] = polar.encode_chain(inp["uci_msg"], inp["uci_code"])
    out["short_blocks"] = {
        (k, qm, e): short_block.encode(inp["sb_bits"][:, :k], e, qm)
        for k in range(1, 12) for qm in SB_QMS for e in (3 * qm + 1, 32 * qm)}
    grid_ul = ofdm.demodulate_slot(rx, cell.nof_sc, cell.dft_size,
                                   cell.numerology, cell.cp, 0,
                                   cell.center_freq_hz)
    llr, est, _ = pusch.codeword_llrs(grid_ul, cfg, ctx["pusch"][0])
    q = llr_ops.quantize(llr)
    soft = llr_ops.to_float(q)
    out.update(llr=llr, llr_i8=q, pusch=pusch.decode_from_llrs(soft, est, cfg))
    qm = BITS_PER_SYMBOL[cfg.modulation]
    bg, z, c = seg.base_graph, seg.lifting_size, seg.nof_codeblocks
    _, full = ldpc_rate_match.rate_dematch_combine(
        soft, c, pdsch._cb_rate_match_sizes(soft.shape[-1], c, qm,
                                            cfg.nof_layers),
        0, qm, bg, z, seg.cb_info_bits, seg.full_block_bits,
        seg.codeword_bits)
    cbs, _, out["sweeps"] = ldpc_decode.decode_early_stop(
        full, bg, z, len(get_graph(bg, z).rows), 6,
        ldpc_decode.DEFAULT_SCALING, "crc24B", seg.cb_info_bits)
    flipped = cbs.clone()
    flipped[torch.arange(c, device=dev), inp["flip"]] ^= 1
    out.update(codeblocks=cbs,
               parity=ldpc_decode.check_parity(cbs, bg, z),
               parity_flipped=ldpc_decode.check_parity(flipped, bg, z))
    out["chest"] = {td: chest.estimate_from_grid(*a, **kw)
                    for td, (a, kw) in inp["chest"].items()}
    return out


def ue_encoder_cases(inp: dict) -> dict:
    """name -> (wrapper, plain twin, args) for K33 and K34 on
    :func:`ue_encoder_inputs`: K33 on phase 4's 22-bit F2 (and the PBCH,
    one AL16 DCI, the UCI batch), K34 on its 6-bit F2 (and the 11-bit
    batch)."""
    dev = inp["mib"].device
    al16, pay16 = next((c, p) for c, p in zip(inp["dcis"],
                                              inp["dci_payloads"])
                       if c.aggregation_level == 16)
    ext = torch.cat([torch.ones((1, 24), dtype=torch.int8, device=dev),
                     pay16[None]], dim=-1)
    sb_e = 16 * F2_SB.nof_rb * F2_SB.nof_symbols
    cases = {
        "polar_encode": (inp["f2_msg"], inp["f2_code"]),
        "polar_encode_pbch": (ssb.pbch_message(SSB, inp["mib"]),
                              ssb._pbch_code()),
        "polar_encode_dci_al16": (torch.cat([pay16[None], crc(
            ext, "crc24C")], dim=-1), pdcch._dci_code(
                al16.payload_bits + 24, pdcch.BITS_PER_CCE * 16)),
        "polar_encode_uci64": (inp["uci_msg"], inp["uci_code"]),
    }
    cases = {k: (polar.encode_chain, polar.encode_chain_ref, a)
             for k, a in cases.items()}
    cases.update({
        "short_block_encode": (short_block.encode, short_block.encode_ref,
                               (_up(inp["uci"]["f2_sb"], dev)[None], sb_e,
                                2)),
        "short_block_encode_k11": (short_block.encode,
                                   short_block.encode_ref,
                                   (inp["sb_bits"], 512, 2)),
    })
    return cases


def last_kernel_cases(inp: dict, out: dict) -> dict:
    """name -> (wrapper, plain twin, args) for K33-K36 and K8's type 0
    comb at phase 16's shapes: K33 and K34 as :func:`ue_encoder_cases`,
    K35 on the flagship PUSCH's LLRs, K36 on K1's codeblocks."""
    seg = SEG
    cases = ue_encoder_cases(inp)
    cases.update({
        "llr_quantize": (llr_ops.quantize, llr_ops.quantize_ref,
                         (out["llr"],)),
        "llr_dequantize": (llr_ops.dequantize, llr_ops.dequantize_ref,
                           (out["llr_i8"],)),
        "ldpc_check_parity": (ldpc_decode.check_parity,
                              ldpc_decode.check_parity_ref,
                              (out["codeblocks"], seg.base_graph,
                               seg.lifting_size)),
    })
    for td, (a, kw) in inp["chest"].items():
        name = "channel_estimate_type0" + ("" if td == "average"
                                           else "_interp")
        cases[name] = (functools.partial(chest.estimate_from_grid, **kw),
                       functools.partial(chest.estimate_from_grid_ref, **kw),
                       a)
    return cases
