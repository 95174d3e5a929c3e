"""Slot conductor: the host-side engine that drives the slot programs.

Port of srsran_tpu/fapi/conductor.py (the reference's executor/notifier
machinery, fapi_to_phy_translator.cpp:333/534/629/684): FAPI-shaped
requests arrive, the conductor resolves the slot phase once (validation,
the normalized plan, the slot context on the device, the payload layout),
launches the slot's DL and UL programs on its device, and converts the
results into indication dataclasses.  HARQ soft buffers live in a pool
keyed by (rnti, harq_id), mirroring rx_buffer_pool_impl.

Copy-free launch: ``process_slot`` / ``process_ul`` return a
:class:`PendingSlotResults` holding only device tensors (one packed f32
scalar vector and one packed int8 payload vector per slot, plus the new
soft buffers).  Nothing is copied to the host until ``resolve()``, which
the caller runs a few slots behind the launch front: one device-to-host
copy per slot, of that slot's results only.  ``stage_payloads`` packs
several slots' DL payloads into one pinned host buffer and copies it to the
device on a side stream; the slot programs wait on its event.

One program per slot phase: on CUDA, ``process_slot`` runs each phase's
DL+UL slot program as one captured CUDA graph (:mod:`..graphs`; the DL
branch on a side stream inside it), and ``process_slot_batch`` -- the
slot-batch throughput mode, B same-phase slots in one program (the JAX
conductor's ``jax.jit(jax.vmap(...))``) -- runs its batch program as one
graph too.  On the CPU both stay eager.

Runs on the CUDA device unless the caller names another (the tests pass
``device="cpu"``, where the kernels' plain twins run).  pcap capture
(ROADMAP §1 item 16) is not ported.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..device import const, require_cuda, resolve
from ..graphs import SlotGraph
from ..phy.slot_programs import (CellConfig, dl_slot_core, stack_ctx,
                                 ul_slot_core)
from ..phy.upper import csi_rs as csi_rs_mod
from ..phy.upper import dmrs as dmrs_mod
from ..phy.upper import pdcch as pdcch_mod
from ..phy.upper import pdsch as pdsch_mod
from ..phy.upper import pucch as pucch_mod
from ..phy.upper import ptrs_prs as ptrs_prs_mod
from ..phy.upper import pusch as pusch_mod
from ..phy.upper import ssb as ssb_mod
from ..ran.ldpc_params import segment_tb, select_base_graph
from .messages import (CrcIndicationPdu, DlTtiRequest, RachIndicationPreamble,
                       RxDataIndicationPdu, SlotResults, SrsIndicationPdu,
                       TxDataRequest, UciIndicationPdu, UlDciRequest,
                       UlTtiRequest)
from .validators import (ValidationError, validate_dl_tti, validate_ul_dci,
                         validate_ul_tti)

# Resolved slot phases kept per conductor (least recently used go first);
# slot-varying fields cycle (slot in frame mod 20, SSB sfn mod 1024).
MAX_PHASES = 256
# Captured slot graphs kept per conductor (their static inputs and outputs
# stay on the device; their temporaries share one memory pool).
MAX_GRAPHS = 64


def _norm(cfg, **zero_fields):
    """dataclasses.replace clearing slot-varying fields from the plan key."""
    return dataclasses.replace(cfg, **zero_fields)


def _pm_free_key(dl_tti: DlTtiRequest) -> tuple:
    """The DL request's plan key with the PDSCH PM indices zeroed: the
    phase of ``process_dl`` (its slot context but the "pm" entries) does
    not depend on them."""
    key = dl_tti.plan_key()
    return key[:2] + (tuple(_zero_pm(c) for c in dl_tti.pdsch),) + key[3:]


# ----------------------------------------------------------- slot context

def _ssb_ctx(cfg, i: int) -> np.ndarray:
    return ssb_mod.slot_ctx_for(cfg)[i]


def _pdsch_pilots(cfg) -> np.ndarray:
    return dmrs_mod.pilot_values_for(pdsch_mod.dmrs_config(cfg))


def _ptrs_values(cfg) -> np.ndarray:
    return ptrs_prs_mod.ptrs_values_for(pdsch_mod.ptrs_config(cfg))


def _zero_pm(c):
    """The PDSCH with its per-PRG PM indices zeroed (the PRG structure --
    prg_size and count -- stays; the matrices are slot context)."""
    pre = c.precoding
    if pre is None:
        return c
    return dataclasses.replace(c, precoding=dataclasses.replace(
        pre, pm_indices=(0,) * len(pre.pm_indices)))


def _norm_pdsch(c):
    """PDSCH plan-key normalization: clear the slot index and the PM
    indices, as the JAX conductor's."""
    return _norm(_zero_pm(c), slot_in_frame=0)


def _pm_ctx(nof_ports, cfg, device):
    """The "pm" slot context of one PDSCH: its per-PRG matrices resolved
    through the codebook repository (uploaded once per PrecodingConfig and
    device), or None without precoding."""
    if cfg.precoding is None:
        return None
    return pdsch_mod.pm_matrices_for(nof_ports, cfg, device)


def _ctx(kind: str, cfg, device):
    """Slot-context tensors computed on the host and uploaded once per
    (kind, cfg, device) through the bounded ``device.const`` cache:
    sequence values (pilots, references, weights), so the slot programs run
    no Gold or trigonometric op on the slot-varying path."""
    if kind == "ssb":
        return tuple(const(_ssb_ctx, cfg, i, device=device) for i in (0, 1))
    if kind == "pdcch":
        return const(pdcch_mod.dmrs_values_for, cfg, device=device)
    if kind == "pdsch":
        return const(_pdsch_pilots, cfg, device=device)
    if kind == "ptrs":
        if cfg.ptrs is None:
            return None
        return const(_ptrs_values, cfg, device=device)
    if kind == "csi":
        return const(csi_rs_mod.seq_values_for, cfg, device=device)
    if kind == "prs":
        return const(ptrs_prs_mod.prs_values_for, cfg, device=device)
    if kind == "pusch":
        return const(pusch_mod.dmrs_pilot_values, cfg, device=device)
    if kind == "f0":
        return const(pucch_mod.f0_refs_for, cfg, device=device)
    if kind == "f1":        # cfg = (common, users)
        common, users = cfg
        return tuple(tuple(const(pucch_mod._weight, common, users, h, j,
                                 device=device) for j in range(3))
                     for h in range(len(pucch_mod._f1_hops(common))))
    if kind == "f2":
        return const(pucch_mod.f2_pilot_values_for, cfg, device=device)
    if kind == "f3":
        return const(pucch_mod.f3_dmrs_values_for, cfg, device=device)
    raise KeyError(kind)


def normalize_dl_plan(dl: DlTtiRequest, extra_pdcch: tuple = (),
                      nof_ports: int | None = None, *, device):
    """Slot-invariant plan + the slot context of this slot on ``device``.

    extra_pdcch: PDCCH PDUs of a ul_dci_request for the same slot (the
    reference routes both through the same PDCCH processor,
    fapi_to_phy_translator.cpp:629).  nof_ports: the cell's TX ports,
    needed to resolve PDSCH precoding PM indices through the codebook
    repository (required when any PDU sets precoding); the PM indices are
    zeroed in the plan and their matrices are the "pm" context; the
    PDSCHs' PT-RS, the CSI-RS and the PRS carry their slot's sequence
    values ("ptrs", None for a PDSCH without PT-RS; "csi"; "prs").
    """
    pdcch_all = dl.pdcch + tuple(extra_pdcch)
    if nof_ports is None and any(c.precoding is not None for c in dl.pdsch):
        raise ValueError(
            "normalize_dl_plan needs nof_ports to resolve PDSCH precoding")
    ssb_n = tuple(_norm(c, sfn=0, hrf=False) for c in dl.ssb)
    pdcch_n = tuple(_norm(c, slot_in_frame=0) for c in pdcch_all)
    pdsch_n = tuple(_norm_pdsch(c) for c in dl.pdsch)
    csi_n = tuple(_norm(c, slot_in_frame=0) for c in dl.csi_rs)
    prs_n = tuple(_norm(c, slot_in_frame=0) for c in dl.prs)
    ctx = {
        "ssb": tuple(_ctx("ssb", c, device) for c in dl.ssb),
        "pdcch": tuple(_ctx("pdcch", c, device) for c in pdcch_all),
        "pdsch": tuple(_ctx("pdsch", c, device) for c in dl.pdsch),
        "ptrs": tuple(_ctx("ptrs", c, device) for c in dl.pdsch),
        "pm": tuple(_pm_ctx(nof_ports, c, device) for c in dl.pdsch),
        "csi": tuple(_ctx("csi", c, device) for c in dl.csi_rs),
        "prs": tuple(_ctx("prs", c, device) for c in dl.prs),
    }
    return (ssb_n, pdcch_n, pdsch_n, csi_n, prs_n), ctx


def normalize_ul_plan(ul: UlTtiRequest, *, device):
    """Slot-invariant UL plan + the slot context of this slot on
    ``device`` (F1 weights per occasion group, at the group's first
    member, as the slot program groups them)."""
    pusch_n = tuple(_norm(c, slot_in_frame=0) for c in ul.pusch)
    f0_n = tuple(_norm(c, slot=0) for c in ul.pucch_f0)
    f1_n = tuple(_norm(c, slot=0) for c in ul.pucch_f1)
    f2_n = tuple(_norm(c, slot=0) for c in ul.pucch_f2)
    f34 = ul.pucch_f3 + ul.pucch_f4
    f34_n = tuple(_norm(c, slot=0) for c in f34)
    f1_groups: dict = {}
    for i, c in enumerate(ul.pucch_f1):
        key = (c.prb, c.start_symbol, c.nof_symbols, c.n_id, c.slot,
               c.second_hop_prb)
        f1_groups.setdefault(key, []).append(i)
    f1_ctx: list = [None] * len(ul.pucch_f1)
    for idxs in f1_groups.values():
        common = ul.pucch_f1[idxs[0]]
        users = tuple((ul.pucch_f1[i].initial_cyclic_shift,
                       ul.pucch_f1[i].time_domain_occ,
                       ul.pucch_f1[i].nof_harq_bits) for i in idxs)
        f1_ctx[idxs[0]] = _ctx("f1", (common, users), device)
    ctx = {
        "pusch": tuple(_ctx("pusch", c, device) for c in ul.pusch),
        "f0": tuple(_ctx("f0", c, device) for c in ul.pucch_f0),
        "f1": tuple(f1_ctx),
        "f2": tuple(_ctx("f2", c, device) for c in ul.pucch_f2),
        "f3": tuple(_ctx("f3", c, device) for c in f34),
    }
    return (pusch_n, f0_n, f1_n, f2_n, ul.prach, ul.srs, f34_n), ctx


# ------------------------------------------------------------------ HARQ

class HarqBufferPool:
    """Soft-combining buffer pool keyed by (rnti, harq_id), on one device;
    zero buffers (new data) are made once per shape and shared."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs = {}
        self._zeros = {}

    def get(self, rnti: int, harq_id: int, shape, new_data: bool):
        key = (rnti, harq_id)
        if new_data or key not in self._bufs:
            if shape not in self._zeros:
                self._zeros[shape] = torch.zeros(shape, dtype=torch.float32,
                                                 device=self.device)
            return self._zeros[shape]
        return self._bufs[key]

    def put(self, rnti: int, harq_id: int, buf):
        self._bufs[(rnti, harq_id)] = buf

    def release(self, rnti: int, harq_id: int):
        self._bufs.pop((rnti, harq_id), None)


# ------------------------------------------------------- results and blobs

@dataclasses.dataclass
class PendingSlotResults:
    """Device-side UL slot results; resolve() decodes them on the host.

    Between the launch and resolve() there is no device-to-host traffic;
    the caller keeps a few of these and resolves slots a few ticks behind
    the launch front (HARQ ids do not recycle that fast).
    """

    ul_tti: UlTtiRequest
    harq_meta: tuple
    scalars: torch.Tensor           # packed f32 vector (static layout)
    payload: torch.Tensor           # packed int8 TB bits of all PUSCH PDUs
    new_softs: tuple                # device tensors, one per PUSCH PDU
    conductor: "SlotConductor"
    ready: torch.cuda.Event | None = None   # recorded after the slot's work

    def resolve(self) -> SlotResults:
        return self.conductor._decode(self)


@dataclasses.dataclass
class PendingSlotBatch:
    """Device-side results of a slot batch (``process_slot_batch``):
    resolve() copies the whole batch to the host in one transfer and
    decodes each slot's indications."""

    slots: list                     # [(ul_tti, harq_meta)] in batch order
    scalars: torch.Tensor           # f32 [B, S]
    payload: torch.Tensor           # int8 [B, G]
    new_softs: tuple                # each [B, C, N]
    conductor: "SlotConductor"
    ready: torch.cuda.Event | None = None

    def resolve(self) -> list:
        s, pay = self.conductor._to_host(self.scalars, self.payload,
                                         self.ready)
        return [self.conductor._indications(
            ul_tti, harq_meta, s[b], pay[b],
            tuple(ns[b] for ns in self.new_softs))
            for b, (ul_tti, harq_meta) in enumerate(self.slots)]


def pack_ul_results(out: dict, device, batch: int | None = None) -> tuple:
    """Flatten every per-PDU result into one f32 vector + one int8 vector
    on ``device`` (the conductor's: the results' own, and the device of
    the empty vectors of a slot without results).  With ``batch``, every
    result has a leading slot axis of that size and so do the vectors.

    Layout per PDU type (static given the slot plan):
      pusch: [crc_ok, ta_s, cfo_hz, evm, iters, snr[P], rsrp[P], epre[P]]
             then optional [ack_valid, ack_bits...], [csi1_valid, bits...],
             [csi2_valid, bits...]
      f0:    [detected, metric, sr, harq bits...]
      f1:    [detected, metric, harq bits...]
      f2/f3: [valid, metric, uci bits...]
      prach: [detected[64], metrics[64], ta_s[64], rssi]
      srs:   [ta_s, mean snr, re(h)..., im(h)...]
    """
    parts = []
    lead = () if batch is None else (batch,)

    def scal(*xs):
        parts.extend(x.reshape(lead + (-1,)).to(torch.float32) for x in xs)

    for r in out["pusch"]:
        scal(r["tb_crc_ok"], r["ta_s"], r["cfo_hz"], r["evm"],
             r["nof_iterations"], r["snr"], r["rsrp"], r["epre"])
        for k in ("harq_ack", "csi1", "csi2"):
            v, b = r.get(f"{k}_valid"), r.get(f"{k}_bits")
            if b is not None:
                scal(v, b)
    for r in out["pucch_f0"]:
        scal(r["detected"], r["metric"], r["sr_bit"], r["harq_bits"])
    for r in out["pucch_f1"]:
        scal(r["detected"], r["metric"], r["harq_bits"])
    for r in out["pucch_f2"] + out["pucch_f3"]:
        scal(r["valid"], r["metric"], r["uci_bits"])
    for r in out["prach"]:
        scal(r["detected"], r["metrics"], r["ta_s"], r["rssi"])
    for r in out["srs"]:
        h = r["wideband_h"]
        scal(r["ta_s"], torch.mean(r["snr"].reshape(lead + (-1,)), dim=-1),
             h.real, h.imag)
    pay = [r["tb_bits"].to(torch.int8) for r in out["pusch"]]
    scalars = (torch.cat(parts, dim=-1) if parts
               else torch.zeros(lead + (0,), dtype=torch.float32,
                                device=device))
    payload = (torch.cat(pay, dim=-1) if pay
               else torch.zeros(lead + (0,), dtype=torch.int8, device=device))
    return scalars, payload


def _dl_payload_layout(dl_plan, n_ssb: int, n_pdcch: int, n_pdsch: int):
    """Static (offset, nof_bytes, nof_bits) per payload in blob order
    (mib..., dci..., sch...) of the slot's packed payload blob (the
    analogue of the reference's tx_data.request TLV byte buffers), and the
    blob's total bytes."""
    _, pdcch_cfgs, pdsch_cfgs, _, _ = dl_plan
    segs = []
    off = 0
    for _ in range(n_ssb):
        segs.append((off, 3, 24))               # MIB is 24 bits
        off += 3
    for cfg in pdcch_cfgs:
        nb = (cfg.payload_bits + 7) // 8
        segs.append((off, nb, cfg.payload_bits))
        off += nb
    for cfg in pdsch_cfgs:
        nb = (cfg.tbs + 7) // 8
        segs.append((off, nb, cfg.tbs))
        off += nb
    return tuple(segs), max(off, 1)


def pack_payload_blob(layout, payloads) -> np.ndarray:
    """Host side: the payloads as one packed uint8 blob.

    Each payload may be packed bytes (uint8, len == nof_bytes: the FAPI
    wire format) or unpacked bits (0/1 per element, len == nof_bits: packed
    here MSB first)."""
    segs, total = layout
    if len(payloads) != len(segs):
        raise ValidationError(
            f"payload count {len(payloads)} != plan's {len(segs)}")
    blob = np.zeros(total, np.uint8)
    for (off, nb, n_bits), p in zip(segs, payloads):
        a = np.asarray(p)
        if a.size == nb and n_bits != nb:
            blob[off:off + nb] = a.astype(np.uint8, copy=False)
        elif a.size == n_bits:
            blob[off:off + nb] = np.packbits(a.astype(np.uint8, copy=False))
        else:
            raise ValidationError(
                f"payload size {a.size} matches neither {n_bits} bits "
                f"nor {nb} packed bytes")
    return blob


def _unpack_plan(segs: tuple, which: int) -> np.ndarray:
    """The blob's (byte index, shift) plan over every payload bit in blob
    order: row 0 byte indices (int64), row 1 right shifts (MSB first)."""
    idx, sh = [], []
    for off, _, n_bits in segs:
        i = np.arange(n_bits)
        idx.append(off + i // 8)
        sh.append(7 - i % 8)
    if not idx:
        return np.zeros(0, np.int64 if which == 0 else np.uint8)
    out = np.concatenate(idx if which == 0 else sh)
    return out.astype(np.int64 if which == 0 else np.uint8)


def _unpacker(segs: tuple, n_ssb: int, n_pdcch: int, n_pdsch: int):
    """fn(blob uint8 on the device) -> (mib, dci, sch) tuples of int8 bit
    tensors: one gather, shift and mask over the blob, then views.  A blob
    with a leading slot axis ([B, bytes]) gives [B, bits] payloads."""
    sizes = [n_bits for _, _, n_bits in segs]

    def unpack(blob: torch.Tensor):
        dev = blob.device
        idx = const(_unpack_plan, segs, 0, device=dev)
        sh = const(_unpack_plan, segs, 1, device=dev)
        bits = ((blob[..., idx] >> sh) & 1).view(torch.int8)
        parts = torch.split(bits, sizes, dim=-1) if sizes else ()
        return (tuple(parts[:n_ssb]), tuple(parts[n_ssb:n_ssb + n_pdcch]),
                tuple(parts[n_ssb + n_pdcch:n_ssb + n_pdcch + n_pdsch]))

    return unpack


def _dl_fn(cell: CellConfig, plan, slot_in_subframe: int, return_grid: bool,
           device):
    """The DL slot program taking one packed payload blob, on ``device``."""
    if len(plan) == 4:
        plan = plan + ((),)
    n_ssb, n_pdcch, n_pdsch = len(plan[0]), len(plan[1]), len(plan[2])
    segs, _ = _dl_payload_layout(plan, n_ssb, n_pdcch, n_pdsch)
    core = dl_slot_core(cell, plan, slot_in_subframe)
    unpack = _unpacker(segs, n_ssb, n_pdcch, n_pdsch)

    def run(blob, ctx=None):
        samples, grid = core(*unpack(blob), ctx, device)
        return (samples, grid) if return_grid else samples

    return run


def _ul_fn(cell: CellConfig, plan, slot_in_subframe: int, device,
           batch: int | None = None):
    """The UL slot program returning (packed scalars, packed payload,
    per-PUSCH soft buffers) on ``device`` (with ``batch``, for that many
    slots at once: a stacked context, [B, ...] results)."""
    core = ul_slot_core(cell, plan, slot_in_subframe)

    def run(samples, prach_fd, soft_buffers, ctx=None):
        out = core(samples, prach_fd, soft_buffers, ctx)
        scalars, payload = pack_ul_results(out, device, batch)
        return scalars, payload, tuple(r["new_soft"] for r in out["pusch"])

    return run


@dataclasses.dataclass
class _SlotPhase:
    """A resolved slot phase (or batch of same-phase slots): its DL
    branch dl(blob) -> tx samples and UL branch ul(rx, prach_fd, softs) ->
    (scalars, payload, new_softs), with the phase's slot context bound in;
    ``run`` is the two in order, the eager slot program."""

    dl: object
    ul: object
    total: int              # payload blob bytes
    soft_shapes: tuple      # per PUSCH (per slot of a batch: [slot][pdu])

    def run(self, blob, rx_samples, prach_fd, soft_buffers,
            pm=None) -> tuple:
        """(tx_samples, scalars, payload, new_softs), eagerly (``pm``: this
        slot's per-PRG matrices, default the phase's own)."""
        tx_samples = self.dl(blob, pm)
        return (tx_samples, *self.ul(rx_samples, prach_fd, soft_buffers))


def _slot_phase(cell: CellConfig, dl_plan, ul_plan, slot_in_subframe: int,
                stride: int, device, dl_ctx, ul_ctx, soft_shapes,
                batch: int | None = None) -> _SlotPhase:
    """The full DL+UL slot step of one phase, taking its payload blob
    (with ``batch``: a [B, bytes] blob and stacked contexts)."""
    if len(dl_plan) == 4:
        dl_plan = dl_plan + ((),)
    n_ssb, n_pdcch, n_pdsch = (len(dl_plan[0]), len(dl_plan[1]),
                               len(dl_plan[2]))
    segs, total = _dl_payload_layout(dl_plan, n_ssb, n_pdcch, n_pdsch)
    if total > stride:
        raise ValidationError(f"payload layout {total} B exceeds stride "
                              f"{stride}")
    unpack = _unpacker(segs, n_ssb, n_pdcch, n_pdsch)
    dl_core = dl_slot_core(cell, dl_plan, slot_in_subframe)
    ul = _ul_fn(cell, ul_plan, slot_in_subframe, device, batch)

    def dl(blob, pm=None):
        ctx = dl_ctx if pm is None else dict(dl_ctx, pm=pm)
        return dl_core(*unpack(blob), ctx, device, batch)[0]

    def ul_run(rx_samples, prach_fd, soft_buffers):
        return ul(rx_samples, prach_fd, soft_buffers, ul_ctx)

    return _SlotPhase(dl=dl, ul=ul_run, total=total, soft_shapes=soft_shapes)


@dataclasses.dataclass
class StagedPayloads:
    """Device-resident payload blobs of several upcoming slots, copied in one
    transfer (the MAC runs up to max_processing_delay_slots=5 ahead of the
    PHY in the reference, du_low_config.h:40)."""

    buf: torch.Tensor          # uint8 [depth * stride] on the device
    stride: int
    depth: int
    ready: torch.cuda.Event | None = None   # the copy's completion
    host: torch.Tensor | None = None        # its pinned source, kept alive


@dataclasses.dataclass
class _DlPhase:
    """Per-slot-phase resolved DL state (the analogue of the reference
    translator's pre-resolved processors, fapi_to_phy_translator.cpp:333)."""

    fn: object
    ctx: dict
    layout: tuple
    n_payloads: tuple       # (n_ssb, n_pdcch incl. ul_dci, n_pdsch)
    plan: tuple


@dataclasses.dataclass
class _UlPhase:
    fn: object
    ctx: dict
    soft_shapes: tuple
    plan: tuple


class _PhaseCache:
    """A bounded dict of resolved slot phases (least recently used first
    out)."""

    def __init__(self, size: int):
        self.size = size
        self._d: collections.OrderedDict = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key, make):
        hit = self._d.get(key)
        if hit is None:
            hit = make()
            self._d[key] = hit
            while len(self._d) > self.size:
                self._d.popitem(last=False)
        else:
            self._d.move_to_end(key)
        return hit


class SlotConductor:
    """One cell's PHY engine on one device.  Thread-free: slot pipelining
    comes from the device's asynchronous launches (launch slot N+1 while N
    still runs).

    Per-slot-phase resolution (validation, plan normalization, slot-context
    upload, the slot program, payload layout) is memoized in bounded phase
    caches keyed by the request's PDU tuples: a repeat slot costs a dict
    lookup, its share of a staged payload transfer, and its launches.
    """

    def __init__(self, cell: CellConfig, device=None, validate: bool = True,
                 pcap=None):
        if pcap is not None:
            raise NotImplementedError(
                "FAPI pcap capture is not ported yet (ROADMAP §1 item 16)")
        self.cell = cell
        self.device = require_cuda() if device is None else resolve(device)
        self.validate = validate
        self.harq_pool = HarqBufferPool(self.device)
        self._dl_phases = _PhaseCache(MAX_PHASES)
        self._ul_phases = _PhaseCache(MAX_PHASES)
        self._slot_phases = _PhaseCache(MAX_PHASES)
        self._batch_phases = _PhaseCache(MAX_PHASES)
        self._graphs = _PhaseCache(MAX_GRAPHS)
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None

    def close(self) -> None:
        """Release what the conductor holds on its device: resolved slot
        phases (their contexts), CUDA graphs (their static tensors; their
        shared memory pool goes with the last graph) and HARQ buffers."""
        for cache in (self._dl_phases, self._ul_phases, self._slot_phases,
                      self._batch_phases, self._graphs):
            cache._d.clear()
        self.harq_pool = HarqBufferPool(self.device)
        self._pool = None

    # ---------------------------------------------------------------- DL

    def payload_layout(self, dl_tti: DlTtiRequest,
                       ul_dci: UlDciRequest | None = None):
        """(segments, total_bytes) of the slot's payload blob."""
        extra = ul_dci.pdcch if ul_dci is not None else ()
        return _dl_payload_layout(
            (dl_tti.ssb, dl_tti.pdcch + tuple(extra), dl_tti.pdsch, (), ()),
            len(dl_tti.ssb), len(dl_tti.pdcch) + len(extra),
            len(dl_tti.pdsch))

    def _resolve_dl_phase(self, dl_tti, ul_dci, slot_in_sf,
                          return_grid) -> _DlPhase:
        if self.validate:
            validate_dl_tti(dl_tti, self.cell)
            if ul_dci is not None:
                validate_ul_dci(ul_dci, self.cell)
        extra = ul_dci.pdcch if ul_dci is not None else ()
        plan, ctx = normalize_dl_plan(dl_tti, extra, self.cell.nof_ports,
                                      device=self.device)
        n = (len(dl_tti.ssb), len(dl_tti.pdcch) + len(extra),
             len(dl_tti.pdsch))
        return _DlPhase(fn=_dl_fn(self.cell, plan, slot_in_sf, return_grid,
                                  self.device),
                        ctx=ctx, layout=self.payload_layout(dl_tti, ul_dci),
                        n_payloads=n, plan=plan)

    @staticmethod
    def _payloads(tx_data: TxDataRequest, ul_dci) -> tuple:
        return (tuple(tx_data.ssb_mib) + tuple(tx_data.pdcch_payloads)
                + (tuple(ul_dci.payloads) if ul_dci is not None else ())
                + tuple(tx_data.pdsch_payloads))

    def process_dl(self, dl_tti: DlTtiRequest, tx_data: TxDataRequest,
                   ul_dci: UlDciRequest | None = None,
                   return_grid: bool = True):
        """(samples [P, T], grid [P, S, K]) on the device, launched
        asynchronously; with return_grid=False (the radio path) (samples,
        None).  Payloads (MIB/DCI/TB) may be packed bytes or 0/1 bit
        arrays; a slot's payloads ride one host-to-device transfer."""
        slot_in_sf = dl_tti.slot.subframe_slot_index
        key = (_pm_free_key(dl_tti),
               ul_dci.pdcch if ul_dci is not None else (),
               slot_in_sf, return_grid)
        phase = self._dl_phases.get(key, lambda: self._resolve_dl_phase(
            dl_tti, ul_dci, slot_in_sf, return_grid))
        pm = self._pm(dl_tti)
        ctx = phase.ctx if pm is None else dict(phase.ctx, pm=pm)
        if self.validate:
            n_ssb, n_pdcch, n_pdsch = phase.n_payloads
            if (len(tx_data.ssb_mib) != n_ssb
                    or len(tx_data.pdcch_payloads)
                    + (len(ul_dci.payloads) if ul_dci else 0) != n_pdcch
                    or len(tx_data.pdsch_payloads) != n_pdsch):
                raise ValidationError(
                    "tx_data: payload counts do not match the dl_tti/ul_dci "
                    f"PDUs ({len(tx_data.ssb_mib)}/"
                    f"{len(tx_data.pdcch_payloads)}/"
                    f"{len(tx_data.pdsch_payloads)} vs "
                    f"{n_ssb}/{n_pdcch}/{n_pdsch})")
        blob = torch.from_numpy(pack_payload_blob(
            phase.layout, self._payloads(tx_data, ul_dci))).to(self.device)
        out = phase.fn(blob, ctx)
        return out if return_grid else (out, None)

    # ----------------------------------------------------- fused slot path

    def stage_payloads(self, slots, stride: int | None = None
                       ) -> StagedPayloads:
        """One transfer for several slots' payloads.

        slots: (dl_tti, tx_data[, ul_dci]) tuples of upcoming slots.
        stride: bytes per slot (>= every slot's layout total; default the
        largest of this group).  On CUDA the blobs are packed into a pinned
        host buffer and copied on a side stream; the slot programs wait on
        the copy's event, the host does not.
        """
        entries = []
        for s in slots:
            ul_dci = s[2] if len(s) > 2 else None
            entries.append((self.payload_layout(s[0], ul_dci),
                            self._payloads(s[1], ul_dci)))
        if stride is None:
            stride = max(lay[1] for lay, _ in entries)
        host = torch.zeros(len(entries) * stride, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        buf = host.numpy()
        for k, (layout, payloads) in enumerate(entries):
            if layout[1] > stride:
                raise ValidationError(
                    f"slot payload blob {layout[1]} B exceeds stride {stride}")
            buf[k * stride:k * stride + layout[1]] = \
                pack_payload_blob(layout, payloads)
        if self.device.type != "cuda":
            return StagedPayloads(buf=host.to(self.device), stride=stride,
                                  depth=len(entries))
        side = self._copy_stream
        with torch.cuda.stream(side):
            dev_buf = torch.empty_like(host, device=self.device)
            dev_buf.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        # the slot programs read it on the compute stream
        dev_buf.record_stream(torch.cuda.current_stream(self.device))
        return StagedPayloads(buf=dev_buf, stride=stride, depth=len(entries),
                              ready=ready, host=host)

    def _soft_buffers(self, ul_tti: UlTtiRequest, shapes: tuple) -> tuple:
        harq_meta = ul_tti.pusch_harq or tuple((0, True) for _ in ul_tti.pusch)
        softs = tuple(
            self.harq_pool.get(c.rnti, hid, shape, new)
            for c, shape, (hid, new) in zip(ul_tti.pusch, shapes, harq_meta))
        return harq_meta, softs

    def _pending(self, ul_tti, harq_meta, scalars, payload, new_softs):
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return PendingSlotResults(ul_tti=ul_tti, harq_meta=harq_meta,
                                  scalars=scalars, payload=payload,
                                  new_softs=new_softs, conductor=self,
                                  ready=ready)

    @staticmethod
    def _slot_key(dl_tti, ul_tti, ul_dci, stride: int) -> tuple:
        return (_pm_free_key(dl_tti),
                ul_dci.pdcch if ul_dci is not None else (),
                ul_tti.plan_key(), dl_tti.slot.subframe_slot_index, stride)

    def slot_phase(self, dl_tti: DlTtiRequest, ul_tti: UlTtiRequest,
                   stride: int, ul_dci: UlDciRequest | None = None
                   ) -> _SlotPhase:
        """The resolved phase of a DL+UL slot (cached): its ``run`` is the
        eager slot program that ``process_slot`` captures on CUDA."""
        slot_in_sf = dl_tti.slot.subframe_slot_index

        def resolve():
            dl_phase = self._resolve_dl_phase(dl_tti, ul_dci, slot_in_sf,
                                              False)
            ul_phase = self._resolve_ul_phase(ul_tti, slot_in_sf)
            return _slot_phase(self.cell, dl_phase.plan, ul_phase.plan,
                               slot_in_sf, stride, self.device, dl_phase.ctx,
                               ul_phase.ctx, ul_phase.soft_shapes)

        return self._slot_phases.get(
            self._slot_key(dl_tti, ul_tti, ul_dci, stride), resolve)

    def _launch(self, key, phase: _SlotPhase, staged: StagedPayloads, blob,
                rx_samples, prach_fd: tuple, softs: tuple, pm=None) -> tuple:
        """Run a phase's program: eagerly off the card; on the card through
        its CUDA graph (captured at the phase's first call; the slot's
        per-PRG matrices ``pm``, if any, are one of its inputs).  Returns
        (tx_samples, scalars, payload, new_softs)."""
        if self.device.type != "cuda":
            return phase.run(blob, rx_samples, prach_fd, softs, pm)
        if staged.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(staged.ready)
        ul_in = (rx_samples, prach_fd, softs)
        dl_in = (blob,) if pm is None else (blob, pm)
        graph = self._graphs.get(key, lambda: SlotGraph(
            (phase.ul, phase.dl), (ul_in, dl_in), pool=self._pool))
        (scalars, payload, new_softs), tx_samples = graph(ul_in, dl_in)
        return tx_samples, scalars, payload, new_softs

    def graph_of(self, dl_tti: DlTtiRequest, ul_tti: UlTtiRequest,
                 stride: int, ul_dci: UlDciRequest | None = None):
        """The captured CUDA graph of a slot phase (None before its first
        ``process_slot`` on CUDA)."""
        return self._graphs._d.get(self._slot_key(dl_tti, ul_tti, ul_dci,
                                                  stride))

    def process_slot(self, dl_tti: DlTtiRequest, ul_tti: UlTtiRequest,
                     staged: StagedPayloads, k: int, rx_samples,
                     ul_dci: UlDciRequest | None = None, prach_fd=()):
        """A full DL+UL slot with its payloads pre-staged at index ``k`` of
        ``staged``.  Returns (tx_samples, PendingSlotResults); nothing is
        copied from the device and nothing waits on it.  On CUDA the slot
        runs as its phase's CUDA graph."""
        phase = self.slot_phase(dl_tti, ul_tti, staged.stride, ul_dci)
        if not 0 <= k < staged.depth:
            raise ValidationError(f"staged slot {k} of {staged.depth}")
        harq_meta, softs = self._soft_buffers(ul_tti, phase.soft_shapes)
        blob = staged.buf[k * staged.stride:k * staged.stride + phase.total]
        tx_samples, scalars, payload, new_softs = self._launch(
            self._slot_key(dl_tti, ul_tti, ul_dci, staged.stride), phase,
            staged, blob, rx_samples, tuple(prach_fd), softs,
            self._pm(dl_tti))
        return tx_samples, self._pending(ul_tti, harq_meta, scalars, payload,
                                         new_softs)

    def _pm(self, dl_tti: DlTtiRequest):
        """This request's "pm" slot context, None without precoding (a
        slot phase is keyed without the PM indices, so a PMI change is one
        cached upload and a copy into the graph's input, never a phase)."""
        if all(c.precoding is None for c in dl_tti.pdsch):
            return None
        return tuple(_pm_ctx(self.cell.nof_ports, c, self.device)
                     for c in dl_tti.pdsch)

    # ------------------------------------------------------- slot batches

    def _resolve_batch(self, slots, sif: int, stride: int) -> _SlotPhase:
        """Validation, normalization, slot-context stacking and the batch
        program, once per distinct batch of slot phases."""
        dls, uls = [], []
        for s in slots:
            if s[0].slot.subframe_slot_index != sif:
                raise ValidationError("a slot batch must share the subframe "
                                      "slot index (the CP layout)")
            dls.append(self._resolve_dl_phase(
                s[0], s[2] if len(s) > 2 else None, sif, False))
            uls.append(self._resolve_ul_phase(s[1], sif))
            if (dls[-1].plan, uls[-1].plan) != (dls[0].plan, uls[0].plan):
                raise ValidationError("a slot batch must share the "
                                      "normalized DL/UL plans")
        dl_ctx, _ = stack_ctx([d.ctx for d in dls])
        ul_ctx, _ = stack_ctx([u.ctx for u in uls])
        return _slot_phase(self.cell, dls[0].plan, uls[0].plan, sif, stride,
                           self.device, dl_ctx, ul_ctx,
                           tuple(u.soft_shapes for u in uls),
                           batch=len(slots))

    def process_slot_batch(self, slots, staged: StagedPayloads, rx_batch,
                           prach_fd=()):
        """The slot-batch throughput mode: B same-phase slots in one
        program (one CUDA graph on the card), every kernel of the plan
        (K1-K19) launched once for all B.

        slots: (dl_tti, ul_tti[, ul_dci]) tuples sharing the normalized DL
        and UL plans and the subframe slot index; slot i's payloads staged
        at index i of ``staged``.  rx_batch: complex64 [B, P, T].
        prach_fd[i]: complex64 [B, P, S, L], each slot's own capture of
        PRACH occasion i (the JAX conductor broadcasts one capture to every
        slot of the batch, which repeats its detections; ROADMAP §3).
        Returns (tx_samples [B, P, T], PendingSlotBatch).
        """
        if not slots or staged.depth < len(slots):
            raise ValidationError(f"{len(slots)} slots in a batch staged "
                                  f"{staged.depth} deep")
        nb = len(slots)
        sif = slots[0][0].slot.subframe_slot_index
        key = (tuple((s[0].plan_key(), s[2].pdcch if len(s) > 2 else (),
                      s[1].plan_key()) for s in slots), sif, staged.stride)
        phase = self._batch_phases.get(
            key, lambda: self._resolve_batch(slots, sif, staged.stride))
        metas, rows = [], []
        for s, shapes in zip(slots, phase.soft_shapes):
            harq_meta, softs = self._soft_buffers(s[1], shapes)
            metas.append((s[1], harq_meta))
            rows.append(softs)
        softs_b = tuple(torch.stack(col) for col in zip(*rows))
        prach_b = tuple(prach_fd)
        if rx_batch.shape[0] != nb or any(p.shape[0] != nb for p in prach_b):
            raise ValidationError(f"rx and PRACH inputs need a slot axis of "
                                  f"{nb}")
        blobs = staged.buf[:nb * staged.stride].view(
            nb, staged.stride)[:, :phase.total]
        tx, scalars, payload, new_softs = self._launch(
            ("batch",) + key, phase, staged, blobs, rx_batch, prach_b,
            softs_b)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return tx, PendingSlotBatch(slots=metas, scalars=scalars,
                                    payload=payload, new_softs=new_softs,
                                    conductor=self, ready=ready)

    # ---------------------------------------------------------------- UL

    def _pusch_soft_shape(self, cfg):
        seg = segment_tb(cfg.tbs, select_base_graph(cfg.tbs,
                                                    cfg.target_code_rate))
        return (seg.nof_codeblocks, seg.codeword_bits)

    def _resolve_ul_phase(self, ul_tti, slot_in_sf) -> _UlPhase:
        if self.validate:
            validate_ul_tti(ul_tti, self.cell)
        plan, ctx = normalize_ul_plan(ul_tti, device=self.device)
        return _UlPhase(fn=_ul_fn(self.cell, plan, slot_in_sf, self.device),
                        ctx=ctx,
                        soft_shapes=tuple(self._pusch_soft_shape(c)
                                          for c in ul_tti.pusch), plan=plan)

    def process_ul(self, ul_tti: UlTtiRequest, samples,
                   prach_fd=()) -> PendingSlotResults:
        """Launch the UL slot program; returns device-side pending results
        (resolve() them, ideally a few slots later, to get the indications;
        HARQ soft buffers are stored and released there)."""
        slot_in_sf = ul_tti.slot.subframe_slot_index
        phase = self._ul_phases.get(
            (ul_tti.plan_key(), slot_in_sf),
            lambda: self._resolve_ul_phase(ul_tti, slot_in_sf))
        if (self.validate and ul_tti.pusch_harq
                and len(ul_tti.pusch_harq) != len(ul_tti.pusch)):
            raise ValidationError("ul_tti: pusch_harq length mismatch")
        harq_meta, softs = self._soft_buffers(ul_tti, phase.soft_shapes)
        scalars, payload, new_softs = phase.fn(samples, tuple(prach_fd),
                                               softs, phase.ctx)
        return self._pending(ul_tti, harq_meta, scalars, payload, new_softs)

    # ------------------------------------------------------- indications

    def _to_host(self, scalars, payload, ready) -> tuple:
        """A slot's (or a batch's: [B, ...]) packed results on the host:
        one copy, of these results only (on the copy stream, after their
        own event)."""
        def packed():
            return torch.cat([scalars.view(torch.uint8),
                              payload.view(torch.uint8)], dim=-1).cpu()

        if ready is None:
            host = packed()
        else:
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(ready)
                host = packed()
        raw = host.numpy()
        n = 4 * scalars.shape[-1]
        return raw[..., :n].view(np.float32), raw[..., n:].view(np.int8)

    def _decode(self, pend: PendingSlotResults) -> SlotResults:
        """Host-side indication decoding (the single device-to-host point)."""
        s, payload = self._to_host(pend.scalars, pend.payload, pend.ready)
        return self._indications(pend.ul_tti, pend.harq_meta, s, payload,
                                 pend.new_softs)

    def _indications(self, ul_tti, harq_meta, s, payload,
                     new_softs) -> SlotResults:
        """One slot's indications from its packed host results; HARQ soft
        buffers are released (CRC ok) or stored (failed) here."""
        res = SlotResults(slot=ul_tti.slot)
        i = 0          # cursor into s
        p0 = 0         # cursor into payload

        def take(n):
            nonlocal i
            v = s[i:i + n]
            i += n
            return v

        nports = self.cell.nof_ports
        for cfg, (hid, _) in zip(ul_tti.pusch, harq_meta):
            crc_ok, ta, cfo, evm, iters = take(5)
            snr_p, rsrp_p, epre_p = take(nports), take(nports), take(nports)
            ok = bool(crc_ok > 0.5)
            snr_db = float(10 * np.log10(max(float(np.mean(snr_p)), 1e-9)))
            res.crc.append(CrcIndicationPdu(
                rnti=cfg.rnti, tb_crc_ok=ok, timing_advance_s=float(ta),
                snr_db=snr_db, rsrp=float(np.mean(rsrp_p)), cfo_hz=float(cfo),
                evm=float(evm), nof_ldpc_iterations=float(iters),
                snr_port_db=10 * np.log10(np.maximum(snr_p, 1e-9)),
                rsrp_port=rsrp_p.copy(), epre_port=epre_p.copy()))
            u = cfg.uci
            uci_bits = {}
            for name, n_bits in (("harq_ack", u.o_ack), ("csi1", u.o_csi1),
                                 ("csi2", u.o_csi2)):
                if n_bits:
                    v = take(1 + n_bits)
                    uci_bits[name] = (bool(v[0] > 0.5),
                                      (v[1:] > 0.5).astype(np.uint8))
            if uci_bits:
                ack = uci_bits.get("harq_ack", (False, None))
                csi1 = uci_bits.get("csi1", (False, None))
                csi2 = uci_bits.get("csi2", (False, None))
                res.uci.append(UciIndicationPdu(
                    rnti=cfg.rnti, detected=ack[0] or csi1[0],
                    harq_bits=ack[1], csi_bits=csi1[1], metric=1.0,
                    csi2_bits=csi2[1], source="pusch"))
            bits = payload[p0:p0 + cfg.tbs]
            p0 += cfg.tbs
            if ok:
                res.rx_data.append(RxDataIndicationPdu(
                    rnti=cfg.rnti, payload=(bits > 0).astype(np.uint8)))
                self.harq_pool.release(cfg.rnti, hid)
        # HARQ soft-buffer store for failed TBs (device tensors, no copy)
        for cfg, (hid, _), soft, pdu in zip(ul_tti.pusch, harq_meta,
                                            new_softs, res.crc):
            if not pdu.tb_crc_ok:
                self.harq_pool.put(cfg.rnti, hid, soft)
        for cfg in ul_tti.pucch_f0:
            det, metric, sr = take(3)
            bits = (take(cfg.nof_harq_bits) > 0.5).astype(np.uint8)
            res.uci.append(UciIndicationPdu(
                rnti=getattr(cfg, "rnti", 0), detected=bool(det > 0.5),
                harq_bits=bits, csi_bits=None, metric=float(metric),
                sr_bit=int(sr > 0.5)))
        for cfg in ul_tti.pucch_f1:
            det, metric = take(2)
            bits = (take(cfg.nof_harq_bits) > 0.5).astype(np.uint8)
            res.uci.append(UciIndicationPdu(
                rnti=getattr(cfg, "rnti", 0), detected=bool(det > 0.5),
                harq_bits=bits, csi_bits=None, metric=float(metric)))
        for cfg in ul_tti.pucch_f2 + ul_tti.pucch_f3 + ul_tti.pucch_f4:
            ok, metric = take(2)
            bits = (take(cfg.nof_uci_bits) > 0.5).astype(np.uint8)
            res.uci.append(UciIndicationPdu(
                rnti=cfg.rnti, detected=bool(ok > 0.5), harq_bits=None,
                csi_bits=bits, metric=float(metric)))
        for cfg in ul_tti.prach:
            npre = cfg.nof_preambles
            det = take(npre) > 0.5
            mets = take(npre)
            tas = take(npre)
            take(1)  # rssi
            for idx in np.nonzero(det)[0]:
                res.rach.append(RachIndicationPreamble(
                    preamble_index=int(idx), timing_advance_s=float(tas[idx]),
                    metric=float(mets[idx])))
        for cfg in ul_tti.srs:
            ta, snr = take(2)
            n = 2 * nports * cfg.nof_ports
            h = take(n)
            wh = (h[:n // 2] + 1j * h[n // 2:]).reshape(nports, cfg.nof_ports)
            snr_db = float(10 * np.log10(max(float(snr), 1e-9)))
            res.srs.append(SrsIndicationPdu(
                rnti=cfg.rnti, timing_advance_s=float(ta), snr_db=snr_db,
                wideband_h=wh))
        if i != len(s):
            raise RuntimeError(f"packed scalar layout mismatch: {i} != {len(s)}")
        return res
