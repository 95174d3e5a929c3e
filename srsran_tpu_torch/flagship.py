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

``chip_smoke.py`` and ``python3 -m srsran_tpu_torch.profile_slot`` drive
these scenarios.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .fapi import messages
from .ops import channel_estimate as chest
from .ops import (dl_map, ldpc_decode, ldpc_encode, ldpc_rate_match, ofdm,
                  polar, short_block, uci_demux, ul_demap)
from .ops.modulation import demodulate
from .ops.scrambling import descramble_llrs
from .phy.slot_programs import (CellConfig, dl_slot_fn, dl_slot_fn_samples,
                                ul_slot_fn)
from .phy.upper import (dmrs, pdcch, pdsch, prach, pucch, pusch, sch_decoder,
                        srs, ssb, ue_tx)
from .ran import polar_params
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
    twins' full grid.  Plus "pdsch_map_repetition": K6 on
    :data:`REPETITION` (compared only)."""
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
    rep_seg = pdsch.segmentation(REPETITION)
    rep_tb = _up(np.random.default_rng(REPETITION.rv).integers(
        0, 2, REPETITION.tbs).astype(np.int8), dev)
    rep = pdsch.map_args(base, REPETITION, ldpc_encode.dlsch_encode_ref(
        rep_tb, rep_seg.base_graph).contiguous(), k6[-1])
    return {
        "dlsch_encode": (ldpc_encode.dlsch_encode,
                         ldpc_encode.dlsch_encode_ref,
                         (tb, DL_SEG.base_graph)),
        "pdsch_map": (_map_on_copy(dl_map.pdsch_map),
                      _map_on_copy(dl_map.pdsch_map_ref), k6),
        "ofdm_modulate": (ofdm.modulate_slot, ofdm.modulate_slot_ref, k7),
        "pdsch_map_repetition": (_map_on_copy(dl_map.pdsch_map),
                                 _map_on_copy(dl_map.pdsch_map_ref), rep),
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


def mu_uci(rng: np.random.Generator, sc: MuScenario = MU) -> dict:
    """One slot's UCI of UE B: HARQ-ACK, CSI part 1 (bit 0 the RI) and the
    part 2 that the RI sizes."""
    u = sc.pusch_b.uci
    csi1 = rng.integers(0, 2, u.o_csi1).astype(np.int8)
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


def make_mu_slots(n: int, rng: np.random.Generator, gen: torch.Generator,
                  device, sc: MuScenario = MU) -> list:
    """``n`` two-UE slots, each a dict: ``tb_a``, ``tb_b`` (int8 payloads),
    ``uci`` (:func:`mu_uci`), ``rx`` (samples) and ``ctx``, all on
    ``device``; slot i is slot point (1, 2i), with fresh payloads and UCI."""
    slots = []
    for i in range(n):
        tb_a = _up(rng.integers(0, 2, sc.pusch_a.tbs).astype(np.int8), device)
        tb_b = _up(rng.integers(0, 2, sc.pusch_b.tbs).astype(np.int8), device)
        uci = mu_uci(rng, sc)
        slots.append(dict(tb_a=tb_a, tb_b=tb_b, uci=uci,
                          rx=mu_rx((2 * i) % 20, tb_a, tb_b, uci, gen, sc),
                          ctx=mu_context(i, device, sc)))
    return slots


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
