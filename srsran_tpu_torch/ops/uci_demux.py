"""UL-SCH / UCI demultiplexing of a PUSCH codeword (the K17 wrapper).

The JAX package gathers the HARQ-ACK, CSI part 1, CSI part 2 and data
fields out of the descrambled codeword LLRs, undoes the uniform descramble
on the UCI placeholder bits and zeroes the data bits under a punctured
HARQ-ACK (srsran_tpu/phy/upper/pusch.py::decode_from_llrs :312-340 and
``_repair_placeholders`` :227-251).  :func:`demux_ref` is that code in
plain PyTorch.  On CUDA tensors :func:`demux` runs it as one gather,
csrc/ulsch_demux.cu, over a host plan made once per configuration by
:func:`_plan` from ops/ulsch_demux.py (the placement walk of TS38.212
§6.2.7).  Both return the four fields (ACK, CSI1, CSI2, data), each a 1-D
f32 tensor; the kernel's are views of one buffer.  A slot axis on the LLRs
(the slot-batch mode) gives [B, n] fields from one launch (counted on
K17's ``_batch`` row), each a contiguous view; the twin runs slot by slot.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..device import const, is_cuda, stack_slots
from ..kernels import _build
from .gold import gold_sequence
from .ulsch_demux import (DemuxConfig, build_class_map, field_positions,
                          placeholder_bit_classes)

KERNEL = kernels.register(kernels.Kernel(
    name="ulsch_demux", route="cuda",
    source="srsran_tpu_torch/csrc/ulsch_demux.cu",
    replaces="srsran_tpu/phy/upper/pusch.py:312"))
KERNEL_BATCH = kernels.batched(KERNEL)

NORMAL, X, Y, PUNCTURED = 0, 1, 2, 3


def _ack_positions(fields: dict) -> np.ndarray:
    """The HARQ-ACK REs: the reserved (punctured) ones for O_ack <= 2."""
    return fields["ack_punct"] if len(fields["ack_punct"]) else fields["ack"]


def _bits(pos: np.ndarray, bpre: int) -> np.ndarray:
    return (pos[:, None].astype(np.int64) * bpre + np.arange(bpre)).reshape(-1)


@functools.lru_cache(maxsize=256)
def field_sizes(cfg: DemuxConfig) -> tuple:
    """Bits of the ACK, CSI1, CSI2 and data fields, in output order."""
    f = field_positions(cfg)
    bpre = cfg.qm * cfg.nof_layers
    return tuple(len(p) * bpre for p in (_ack_positions(f), f["csi1"],
                                         f["csi2"], f["data"]))


@functools.lru_cache(maxsize=256)
def _plans(cfg: DemuxConfig, o_ack: int, o_csi1: int) -> tuple:
    f = field_positions(cfg)
    bpre = cfg.qm * cfg.nof_layers
    ack = _ack_positions(f)
    marks = placeholder_bit_classes(cfg, o_ack, o_csi1)
    src = np.concatenate([_bits(p, bpre) for p in (ack, f["csi1"], f["csi2"],
                                                   f["data"])])
    punct = np.isin(f["data"], f["ack_punct"])
    cls = np.concatenate([
        marks[_bits(ack, bpre)], marks[_bits(f["csi1"], bpre)],
        np.zeros(len(f["csi2"]) * bpre, np.int8),
        np.repeat(np.where(punct, PUNCTURED, NORMAL), bpre)]).astype(np.int8)
    return src.astype(np.int32), cls


def _plan(cfg: DemuxConfig, o_ack: int, o_csi1: int, which: int) -> np.ndarray:
    """K17's plan over the output bits: 0 the codeword bit each reads
    (int32), 1 its class (int8: normal, 'x', 'y', punctured)."""
    return _plans(cfg, o_ack, o_csi1)[which]


def _field_index(cfg: DemuxConfig, name: str, bits: bool) -> np.ndarray:
    """int64 RE positions of a field ("ack" means the HARQ-ACK REs of
    :func:`_ack_positions`), or with ``bits`` its codeword bits; "punct"
    flags (0/1) which data REs lie under a punctured HARQ-ACK."""
    f = field_positions(cfg)
    if name == "punct":
        return np.isin(f["data"], f["ack_punct"]).astype(np.int64)
    pos = _ack_positions(f) if name == "ack" else f[name]
    return (_bits(pos, cfg.qm * cfg.nof_layers) if bits
            else pos.astype(np.int64))


def _repair_placeholders(field: torch.Tensor, cfg: DemuxConfig, name: str,
                         o_field: int, c_init: int):
    """The JAX package's placeholder repair: for 1-bit payloads bit 1 ('y')
    takes bit 0's scrambling bit, bits 2..Qm-1 ('x') were never scrambled."""
    qm = cfg.qm
    if (qm == 1 or o_field == 0 or o_field > 2 or field.numel() == 0
            or (qm == 2 and o_field == 2)):
        return field
    dev = field.device
    total = len(build_class_map(cfg)) * qm * cfg.nof_layers
    seq = gold_sequence(c_init, total, device=dev)
    c = seq[const(_field_index, cfg, name, True, device=dev)].reshape(-1, qm)
    cols = [torch.ones((c.shape[0], 1), dtype=field.dtype, device=dev)]
    if o_field == 1:
        cols.append(torch.where((c[:, 0] ^ c[:, 1]) == 1, -1.0, 1.0
                                ).to(field.dtype)[:, None])
    else:
        cols.append(torch.ones((c.shape[0], 1), dtype=field.dtype, device=dev))
    if qm > 2:
        cols.append(torch.where(c[:, 2:] == 1, -1.0, 1.0).to(field.dtype))
    signs = torch.cat(cols, dim=1)
    return (field.reshape(-1, qm) * signs).reshape(-1)


def demux_ref(llr: torch.Tensor, cfg: DemuxConfig, o_ack: int, o_csi1: int,
              c_init: int) -> tuple:
    """Plain twin of :func:`demux`, written as the JAX package's gathers
    (a slot axis runs slot by slot)."""
    if llr.ndim == 2:
        return stack_slots([demux_ref(x, cfg, o_ack, o_csi1, c_init)
                            for x in llr])
    dev = llr.device
    llr_re = llr.reshape(-1, cfg.qm * cfg.nof_layers)

    def rows(name):
        return llr_re[const(_field_index, cfg, name, False, device=dev)]

    ack = _repair_placeholders(rows("ack").reshape(-1), cfg, "ack", o_ack,
                               c_init)
    csi1 = _repair_placeholders(rows("csi1").reshape(-1), cfg, "csi1",
                                o_csi1, c_init)
    csi2 = rows("csi2").reshape(-1)
    data = rows("data")
    if len(field_positions(cfg)["ack_punct"]):
        mask = const(_field_index, cfg, "punct", False, device=dev)
        data = torch.where(mask[:, None] == 1, 0.0, data)
    return ack, csi1, csi2, data.reshape(-1)


def demux(llr: torch.Tensor, cfg: DemuxConfig, o_ack: int, o_csi1: int,
          c_init: int) -> tuple:
    """Split descrambled codeword LLRs f32 [G] into (ACK, CSI1, CSI2, data)
    LLRs for the PUSCH geometry ``cfg`` (pusch.demux_plan) with ``o_ack``
    HARQ-ACK and ``o_csi1`` CSI part-1 bits, scrambled with ``c_init``.
    B slots at once: LLRs [B, G] give four [B, n] fields, in one launch."""
    if not is_cuda(llr):
        return demux_ref(llr, cfg, o_ack, o_csi1, c_init)
    g = len(build_class_map(cfg)) * cfg.qm * cfg.nof_layers
    lead = tuple(llr.shape[:-1])
    if (llr.dtype != torch.float32 or llr.ndim not in (1, 2)
            or llr.shape[-1] != g):
        raise ValueError(f"llr must be float32 [(B,) {g}], got {llr.dtype} "
                         f"{tuple(llr.shape)}")
    dev = llr.device
    nb = lead[0] if lead else 1
    src = const(_plan, cfg, o_ack, o_csi1, 0, device=dev)
    cls = const(_plan, cfg, o_ack, o_csi1, 1, device=dev)
    sizes = field_sizes(cfg)
    seq = gold_sequence(c_init, g, device=dev)
    llr = llr.contiguous()
    out = torch.empty(nb * sum(sizes), dtype=torch.float32, device=dev)
    _build.check(_build.load().srsran_ulsch_demux(
        _build.ptr(llr), _build.ptr(src), _build.ptr(cls), _build.ptr(seq),
        sum(sizes), g, *sizes[:3], _build.ptr(out), nb,
        _build.stream_of(llr)), "ulsch_demux")
    (KERNEL_BATCH if lead else KERNEL).count()
    # field-major: each field's rows back to back
    return tuple(f.view(lead + (n,)) for f, n in zip(
        torch.split(out, [nb * n for n in sizes]), sizes))
