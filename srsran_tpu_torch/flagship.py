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

``chip_smoke.py`` and ``python3 -m srsran_tpu_torch.profile_slot`` drive
these scenarios.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .ops import channel_estimate as chest
from .ops import (dl_map, ldpc_decode, ldpc_encode, ldpc_rate_match, ofdm,
                  ul_demap)
from .ops.modulation import demodulate
from .ops.scrambling import descramble_llrs
from .phy.slot_programs import (CellConfig, dl_slot_fn, dl_slot_fn_samples,
                                ul_slot_fn)
from .phy.upper import (dmrs, pdcch, pdsch, prach, pucch, pusch, sch_decoder,
                        srs, ssb)
from .ran.prach_params import zc_sequence

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


def ue_samples(slot_in_frame: int, payload: torch.Tensor) -> torch.Tensor:
    """The UE's 4-port slot samples for one slot: the PUSCH layers on ports
    0-1 and the SRS on port 0 (bench.py:347-362)."""
    dev = payload.device
    plan = ((), (), (dataclasses.replace(UE, slot_in_frame=0),), ())
    pilots = torch.as_tensor(dmrs.pilot_values_for(pdsch.dmrs_config(
        dataclasses.replace(UE, slot_in_frame=slot_in_frame)))).to(dev)
    _, grid = dl_slot_fn(CELL, plan)((), (), (payload,), {"pdsch": (pilots,)})
    return ofdm.modulate_slot(srs.map_to_grid(grid, SRS), CELL.dft_size,
                              CELL.numerology,
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
