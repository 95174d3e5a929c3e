"""Per-slot DL/UL programs for one cell.

Port of srsran_tpu/phy/slot_programs.py.  A slot plan (the tuple of PDU
configs) selects a program; the program is a Python closure over the plan,
cached per (cell, plan, slot_in_subframe), that runs eagerly on the device
of its input tensors.  The DL program covers SSB, PDCCH, PDSCH (every
allocation: contiguous, RA type 0, interleaved VRBs), CSI-RS, PT-RS and
PRS plans (the flagship DL slot, the DU-low's slots, and the UE-side test
transmitter); the UL program
PUSCH (1-4 layers, ZF or MMSE, UCI on PUSCH, frequency hopping, transform
precoding), PUCCH formats 0 to 4, PRACH and SRS plans (the JAX bench's
full UL mix, the conductor's UCI PDUs, the two-UE and the cell-edge
slots).
The cbf16 grid raises NotImplementedError naming its ROADMAP entry.

On CUDA both programs run without a host sync: their constants are cached
on the device after the first call, the slot context and payloads arrive
as device tensors, the LDPC early stop and its iteration count, the PRACH
and PUCCH decisions, the UCI decodes and every TA stay on the device, and
the results are device tensors.

Given a leading slot axis on every input, both programs run B slots of
one plan at once (the JAX package's ``jax.vmap`` of the slot programs, for
the conductor's slot-batch mode and the multi-cell programs), with the
slot context stacked by :func:`stack_ctx`.  The PDSCH and PUSCH chains and
the OFDM passes (K1-K8, with K16-K18 for the L x N, UCI-on-PUSCH and
DFT-s-OFDM PUSCHs), SSB and PDCCH (K27), the DL DM-RS (K26), the RS PDUs
(K25), PRACH (K9), PUCCH F0 to F4 (K12, K10, K8 + K13, K8 + K19), SRS (K8
+ K11) and the UCI decoders (K14, K15) run once for all B slots: no
kernel loops over the slots.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..device import resolve
from ..ran.cyclic_prefix import CyclicPrefix, slot_num_samples
from ..ops import dl_control, dl_rs, ofdm
from .upper import csi_rs as csi_rs_mod
from .upper import pdcch as pdcch_mod
from .upper import pdsch as pdsch_mod
from .upper import prach as prach_mod
from .upper import ptrs_prs as ptrs_prs_mod
from .upper import pucch as pucch_mod
from .upper import pusch as pusch_mod
from .upper import srs as srs_mod
from .upper import ssb as ssb_mod


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """Static cell numerology/geometry (same fields and defaults as the JAX
    package's CellConfig)."""

    nof_ports: int
    nof_rb: int
    dft_size: int
    numerology: int
    cp: CyclicPrefix = CyclicPrefix.NORMAL
    center_freq_hz: float = 3.5e9
    tx_scale: float = 1.0
    grid_cbf16: bool = False

    @property
    def nof_sc(self) -> int:
        return self.nof_rb * 12

    def slot_samples(self, slot_in_subframe: int = 0) -> int:
        return slot_num_samples(self.cp, self.numerology, self.dft_size,
                                slot_in_subframe)


def _check_cell(cell: CellConfig) -> None:
    if cell.grid_cbf16:
        raise NotImplementedError(
            "the cbf16 grid is not ported (ROADMAP §1, do-not-port list)")


# ----------------------------------------------------------------- DL slot

def _dl_device(device, *groups) -> torch.device:
    """The DL slot's device: the caller's (the conductor names its own), or
    else the one device of the payload tensors.  Raises when the payloads
    lie on different devices, or when there are none and the caller named
    no device (the program never picks a device of its own)."""
    devices = {t.device for group in groups for t in group}
    if len(devices) > 1:
        raise ValueError(f"DL payloads on different devices: "
                         f"{sorted(str(d) for d in devices)}")
    if device is not None:
        device = resolve(device)
        if devices and devices != {device}:
            raise ValueError(f"DL payloads on {devices.pop()}, program on "
                             f"{device}")
        return device
    if not devices:
        raise ValueError("a DL slot without payloads has no device: name one")
    return devices.pop()


# ------------------------------------------------------------ slot context

def _tree_map(fn, *trees):
    """fn over the leaves (tensors or None) of equally shaped slot-context
    trees (dicts and tuples)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        if any(set(t) != set(t0) for t in trees):
            raise ValueError("slot contexts differ in structure")
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        if any(len(t) != len(t0) for t in trees):
            raise ValueError("slot contexts differ in structure")
        return tuple(_tree_map(fn, *z) for z in zip(*trees))
    return fn(*trees)


def stack_ctx(ctxs) -> tuple:
    """Per-slot slot contexts -> (batched ctx, axes), as the JAX
    conductor's ``_stack_ctx``: a leaf that differs across the slots is
    stacked on a new leading axis (axis 0), a leaf every slot shares (the
    same tensor object, as ``device.const`` hands them out) stays once
    (axis None); None leaves pass through."""
    def axis(*xs):
        if xs[0] is None:
            if any(x is not None for x in xs):
                raise ValueError("slot contexts differ in structure")
            return None
        return None if all(x is xs[0] for x in xs) else 0

    axes = _tree_map(axis, *ctxs)
    ctx = _tree_map(lambda a, *xs: xs[0] if a is None else torch.stack(xs),
                    axes, *ctxs)
    return ctx, axes


def _ctx_leaf(ctx, kind: str, i: int):
    return ctx[kind][i] if ctx else None


# ----------------------------------------------------------------- DL slot

def _dl_plan(cell: CellConfig, plan) -> tuple:
    """The DL plan with its fifth entry, after the cell check."""
    _check_cell(cell)
    if len(plan) == 4:
        plan = plan + ((),)
    return plan


def _dl_symbols(cell: CellConfig) -> int:
    return 14 if cell.cp is CyclicPrefix.NORMAL else 12


def _ctx_entry(ctx, kind: str, n: int) -> tuple:
    """ctx[kind], or n Nones without a context (or without that entry)."""
    return tuple(ctx[kind]) if ctx and kind in ctx else (None,) * n


def dl_slot_core(cell: CellConfig, plan, slot_in_subframe: int = 0):
    """The DL slot program: SSB and PDCCH, then PDSCH, then the RS PDUs
    (the PDSCHs' PT-RS, CSI-RS, PRS), then OFDM.

    plan = (ssb_cfgs, pdcch_cfgs, pdsch_cfgs, csi_rs_cfgs[, prs_cfgs]).
    Returned fn(ssb_mib, pdcch_payloads, pdsch_payloads, ctx=None,
    device=None, batch=None) -> (samples [P, T], grid [P, S, K]).  ctx (the
    conductor's slot context, convert.slot_context): ctx["ssb"][i] a pair
    (static_bits, scramble_mask), ctx["pdcch"][i] and ctx["pdsch"][i] DM-RS
    pilot values or host c_inits, ctx["pm"][i] the PDSCH's per-PRG matrices
    [G, P, L] or None, ctx["ptrs"][i] the PDSCH's PT-RS values, ctx["csi"]
    [i] and ctx["prs"][i] the sequence values of each CSI-RS and PRS (or
    host c_inits; None builds them from the config).  ``device``: the
    program's device (the conductor passes its own; default the payloads',
    and a slot without payloads needs it).  On the card every PDCCH and
    SSB is one K27 launch and every RS PDU one K25 launch.

    B slots at once: every payload [B, bits] and a stacked slot context
    (:func:`stack_ctx`'s ctx; every DL step takes its leaves with or
    without the slot axis) give samples [B, P, T] and grid [B, P, S, K];
    ``batch`` names B where no payload carries the slot axis.
    """
    ssb_cfgs, pdcch_cfgs, pdsch_cfgs, csi_cfgs, prs_cfgs = _dl_plan(cell, plan)
    nsym = _dl_symbols(cell)

    def run(ssb_mib, pdcch_payloads, pdsch_payloads, ctx=None, device=None,
            batch=None):
        device = _dl_device(device, ssb_mib, pdcch_payloads, pdsch_payloads)
        payloads = (*ssb_mib, *pdcch_payloads, *pdsch_payloads)
        lead = (tuple(payloads[0].shape[:-1]) if payloads
                else () if batch is None else (batch,))
        grid = torch.zeros(lead + (cell.nof_ports, nsym, cell.nof_sc),
                           dtype=torch.complex64, device=device)
        ssb_ctx = _ctx_entry(ctx, "ssb", len(ssb_cfgs))
        pdcch_ctx = _ctx_entry(ctx, "pdcch", len(pdcch_cfgs))
        control = [ssb_mod.control_item(grid, cfg, mib, c)
                   for cfg, mib, c in zip(ssb_cfgs, ssb_mib, ssb_ctx)]
        control += [pdcch_mod.control_item(grid, bits, cfg, dmrs_cinits=c)
                    for cfg, bits, c in zip(pdcch_cfgs, pdcch_payloads,
                                            pdcch_ctx)]
        dl_control.control_map(grid, control)                       # K27
        pdsch_ctx = _ctx_entry(ctx, "pdsch", len(pdsch_cfgs))
        pm_ctx = _ctx_entry(ctx, "pm", len(pdsch_cfgs))
        ptrs_ctx = _ctx_entry(ctx, "ptrs", len(pdsch_cfgs))
        rs = []
        for cfg, bits, ci, pm, pci in zip(pdsch_cfgs, pdsch_payloads,
                                          pdsch_ctx, pm_ctx, ptrs_ctx):
            pdsch_mod.process(grid, bits, cfg, dmrs_cinits=ci,
                              pm_matrices=pm)
            if cfg.ptrs is not None:
                rs.append(ptrs_prs_mod.ptrs_item(
                    pdsch_mod.ptrs_config(cfg), pci, device=device))
        rs += [csi_rs_mod.csi_item(cfg, cell.nof_ports, c, device=device)
               for cfg, c in zip(csi_cfgs,
                                 _ctx_entry(ctx, "csi", len(csi_cfgs)))]
        rs += [ptrs_prs_mod.prs_item(cfg, c, device=device)
               for cfg, c in zip(prs_cfgs,
                                 _ctx_entry(ctx, "prs", len(prs_cfgs)))]
        if rs:
            dl_rs.rs_map(grid, tuple(i for i, _ in rs),             # K25
                         tuple(v for _, v in rs))
        samples = ofdm.modulate_slot(
            grid, cell.dft_size, cell.numerology, cell.cp, slot_in_subframe,
            cell.center_freq_hz, cell.tx_scale)
        return samples, grid

    return run


@functools.lru_cache(maxsize=64)
def dl_slot_fn(cell: CellConfig, plan, slot_in_subframe: int = 0):
    """Cached DL slot program (see :func:`dl_slot_core`)."""
    return dl_slot_core(cell, plan, slot_in_subframe)


@functools.lru_cache(maxsize=64)
def dl_slot_fn_samples(cell: CellConfig, plan, slot_in_subframe: int = 0):
    """Cached DL slot program returning the samples only (the radio path
    needs no grid)."""
    core = dl_slot_core(cell, plan, slot_in_subframe)

    def run(ssb_mib, pdcch_payloads, pdsch_payloads, ctx=None, device=None):
        return core(ssb_mib, pdcch_payloads, pdsch_payloads, ctx, device)[0]

    return run


# ----------------------------------------------------------------- UL slot

def _f1_groups(f1_cfgs) -> list:
    """Indices of the PUCCH F1 users of each occasion group, in plan order:
    users multiplexed on the same PRB/occasion are detected as one batch
    (as the JAX program and the conductor group them)."""
    groups: dict = {}
    for i, cfg in enumerate(f1_cfgs):
        key = (cfg.prb, cfg.start_symbol, cfg.nof_symbols, cfg.n_id,
               cfg.slot, cfg.second_hop_prb)
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def _ul_plan(cell: CellConfig, plan) -> tuple:
    """The UL plan with all seven entries, after the unsupported checks."""
    _check_cell(cell)
    return plan + ((),) * (7 - len(plan))


def _pusch_entries(grid, pusch_cfgs, soft_buffers, ctx) -> list:
    """The PUSCH results of the UL program's dict (a slot axis on the grid,
    the soft buffers and the pilots passes through to every value)."""
    entries = []
    for i, cfg in enumerate(pusch_cfgs):
        sb = soft_buffers[i] if soft_buffers is not None else None
        res = pusch_mod.process(grid, cfg, soft_buffer=sb,
                                dmrs_cinits=_ctx_leaf(ctx, "pusch", i))
        entry = {
            "tb_bits": res.tb_bits, "tb_crc_ok": res.tb_crc_ok,
            "new_soft": res.new_soft,
            "snr": res.csi.snr, "ta_s": res.csi.time_alignment_s,
            "rsrp": res.csi.rsrp, "epre": res.csi.epre,
            "cfo_hz": res.csi.cfo_hz,
            "evm": res.evm,
            "nof_iterations": res.nof_iterations}
        for k in ("harq_ack", "csi1", "csi2"):
            bits = getattr(res, f"{k}_bits")
            if bits is not None:
                entry[f"{k}_bits"] = bits
                entry[f"{k}_valid"] = getattr(res, f"{k}_valid")
        entries.append(entry)
    return entries


def _control_entries(grid, plan, f1_groups, prach_fd, ctx) -> dict:
    """PUCCH F0 to F4, SRS and PRACH (the JAX program's order) of one
    slot's grid, or of B slots' grid [B, P, S, K] at once: each receiver
    takes the slot axis on its grid, PRACH capture and context leaves
    (shared or stacked) and puts it in front of every value."""
    _, f0_cfgs, f1_cfgs, f2_cfgs, prach_cfgs, srs_cfgs, f3_cfgs = plan
    out = {"pucch_f0": [], "pucch_f1": [], "pucch_f2": [], "pucch_f3": [],
           "prach": [], "srs": []}
    for i, cfg in enumerate(f0_cfgs):
        out["pucch_f0"].append(pucch_mod.detect_format0(
            grid, cfg, ncs=_ctx_leaf(ctx, "f0", i)))
    f1_results = [None] * len(f1_cfgs)
    for idxs in f1_groups:
        common = f1_cfgs[idxs[0]]
        users = tuple((f1_cfgs[i].initial_cyclic_shift,
                       f1_cfgs[i].time_domain_occ,
                       f1_cfgs[i].nof_harq_bits) for i in idxs)
        rs = pucch_mod.detect_format1_batch(grid, common, users,
                                            ncs=_ctx_leaf(ctx, "f1", idxs[0]))
        for i, r in zip(idxs, rs):
            f1_results[i] = r
    out["pucch_f1"].extend(f1_results)
    for i, cfg in enumerate(f2_cfgs):
        out["pucch_f2"].append(pucch_mod.process_format2(
            grid, cfg, _ctx_leaf(ctx, "f2", i)))
    for i, cfg in enumerate(f3_cfgs):
        out["pucch_f3"].append(pucch_mod.process_format3(
            grid, cfg, _ctx_leaf(ctx, "f3", i)))
    for cfg in srs_cfgs:
        est = srs_mod.estimate(grid, cfg)
        # wideband channel: average the estimate over symbols/subcarriers
        out["srs"].append({
            "wideband_h": torch.mean(est.coeffs, dim=(-2, -1)),
            "ta_s": est.time_alignment_s, "snr": est.snr})
    for i, cfg in enumerate(prach_cfgs):
        det = prach_mod.detect(prach_fd[i], cfg)
        out["prach"].append({
            "metrics": det.metrics, "ta_s": det.time_advance_s,
            "detected": det.detected, "rssi": det.rssi})
    return out


def ul_slot_core(cell: CellConfig, plan, slot_in_subframe: int = 0):
    """The UL slot program: PUSCH, PUCCH F0, F1, F2 and F3/F4, SRS and
    PRACH (the JAX program's order).

    plan = (pusch_cfgs, f0_cfgs, f1_cfgs, f2_cfgs, prach_cfgs[, srs_cfgs
    [, f3_cfgs]]).  Returned fn(samples [P, T], prach_fd, soft_buffers,
    ctx=None) -> {"pusch": [dict per PUSCH], "pucch_f0": [dict per PDU],
    "pucch_f1": [dict per user], "pucch_f2": [dict per PDU], "prach": [...],
    "srs": [...], ...} with the same keys as the JAX program.  prach_fd[i]:
    complex64 [P, S, L] frequency-domain capture of PRACH occasion i.
    ctx["pusch"][i] carries DM-RS pilot values (or c_inits); ctx["f0"][i]
    the candidates' references (f0_refs_for); ctx["f1"][first user of a
    group] the group's per-hop weight tuple (f1_batch_weights);
    ctx["f2"][i] the DM-RS pilot values (f2_pilot_values_for); ctx["f3"][i]
    the F3/F4 DM-RS values (f3_dmrs_values_for); without ctx they are built
    on the host and cached per device.  A hopping PUSCH's ctx["pusch"][i]
    holds hop 1's DM-RS rows, then hop 2's.

    B slots at once: samples [B, P, T], prach_fd[i] [B, P, S, L] (each
    slot's own capture), soft_buffers[i] [B, C, N] and a stacked slot
    context (:func:`stack_ctx`) give the same dict with a leading slot axis
    on every value.  K4, the PUSCH chain (K8, K3 or K16 or K18, K17, K2,
    K1), PUCCH F0 to F4 (K12, K10, K8 + K13, K8 + K19), SRS (K8 + K11),
    PRACH (K9) and the UCI decoders (K14, K15) run once for the B slots,
    the LDPC early stop per slot.
    """
    plan = _ul_plan(cell, plan)
    f1_groups = _f1_groups(plan[2])

    def run(samples, prach_fd, soft_buffers, ctx=None):
        grid = ofdm.demodulate_slot(
            samples, cell.nof_sc, cell.dft_size, cell.numerology, cell.cp,
            slot_in_subframe, cell.center_freq_hz)
        return {"pusch": _pusch_entries(grid, plan[0], soft_buffers, ctx),
                **_control_entries(grid, plan, f1_groups, prach_fd, ctx)}

    return run


@functools.lru_cache(maxsize=64)
def ul_slot_fn(cell: CellConfig, plan, slot_in_subframe: int = 0):
    """Cached UL slot program (see :func:`ul_slot_core`)."""
    return ul_slot_core(cell, plan, slot_in_subframe)
