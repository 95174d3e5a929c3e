"""CSI report sizing, packing and unpacking (TS38.212 §6.3.1.1.2/§6.3.2.1.2,
TS38.214 §5.2.2).

Host-side analogue of lib/ran/csi_report/: csi_report_on_puxch_helpers.cpp
(RI/PMI/CQI field widths and unpackers), csi_report_on_pusch_helpers.cpp
(part-1/part-2 splitting + the UCI part-2 correspondence) — the piece that
turns decoded CSI bits into RI/PMI/CQI the scheduler can act on, feeding
DL link adaptation and the per-PRG precoding of ran/precoding_codebooks.

Supported codebooks (pmi_codebook): 'one' (1 CSI-RS port, no PMI), 'two'
(2 ports), 'typeI_4ports' (TypeI-SinglePanel 4 ports mode 1) — the same
set the reference enumerates in pmi_codebook_type.

The port's own copy of srsran_tpu/ran/csi_report.py: the port imports
nothing of the JAX package.  tests/test_torch_host_plans.py pins the copy
to its original.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .uci_on_pusch import (Part2SizeDescription, Part2Entry, Part2Parameter)

CODEBOOK_PORTS = {"one": 1, "two": 2, "typeI_4ports": 4}

# TS38.214 Table 5.2.2.2.1-2 for 4 ports: N1=2, N2=1, O1=4, O2=1.
_N1, _N2, _O1, _O2 = 2, 1, 4, 1


def _log2_ceil(n: int) -> int:
    return max(int(math.ceil(math.log2(n))) if n > 1 else 0, 0)


@dataclasses.dataclass(frozen=True)
class CsiReportConfig:
    """Static CSI report configuration (csi_report_configuration mirror)."""

    pmi_codebook: str = "typeI_4ports"
    ri_restriction: int = 0b1111     # bitmask: bit v-1 allows rank v
    nof_csi_rs_resources: int = 1
    # quantities: cri_ri_pmi_cqi reports everything; cri_ri_cqi skips PMI
    quantities: str = "cri_ri_pmi_cqi"

    @property
    def nof_ports(self) -> int:
        return CODEBOOK_PORTS[self.pmi_codebook]

    def allowed_ranks(self) -> tuple:
        return tuple(v + 1 for v in range(self.nof_ports)
                     if (self.ri_restriction >> v) & 1)


@dataclasses.dataclass(frozen=True)
class PmiSizes:
    i_1_1: int = 0
    i_1_2: int = 0
    i_1_3: int = 0
    i_2: int = 0

    @property
    def total(self) -> int:
        return self.i_1_1 + self.i_1_2 + self.i_1_3 + self.i_2


def ri_size(cfg: CsiReportConfig) -> int:
    """RI field width (TS38.212 §6.3.1.1.2: log2_ceil of allowed ranks,
    capped per codebook like the reference's typeI_single_panel sizes)."""
    n_allowed = len(cfg.allowed_ranks())
    if cfg.nof_ports == 1:
        return 0
    cap = 1 if cfg.nof_ports == 2 else 2
    return min(cap, _log2_ceil(n_allowed))


def cri_size(cfg: CsiReportConfig) -> int:
    return _log2_ceil(cfg.nof_csi_rs_resources)


def li_size(cfg: CsiReportConfig, ri: int) -> int:
    if cfg.nof_ports == 1:
        return 0
    cap = 1 if cfg.nof_ports == 2 else 2
    return min(cap, _log2_ceil(ri))


def pmi_sizes(cfg: CsiReportConfig, ri: int) -> PmiSizes:
    """PMI field widths per TS38.212 Table 6.3.1.1.2-1 (mode 1)."""
    if cfg.quantities != "cri_ri_pmi_cqi" or cfg.nof_ports == 1:
        return PmiSizes()
    if cfg.nof_ports == 2:
        return PmiSizes(i_2=2 if ri == 1 else 1)
    i11 = _log2_ceil(_N1 * _O1)
    i12 = _log2_ceil(_N2 * _O2)          # 0 for N2=1
    if ri == 1:
        return PmiSizes(i_1_1=i11, i_1_2=i12, i_2=2)
    if ri == 2:
        return PmiSizes(i_1_1=i11, i_1_2=i12, i_1_3=1, i_2=1)
    return PmiSizes(i_1_1=i11, i_1_2=i12, i_2=1)          # ri 3, 4


def part1_size(cfg: CsiReportConfig) -> int:
    """CSI part 1: CRI + RI + wideband CQI (first TB), fixed size."""
    return cri_size(cfg) + ri_size(cfg) + 4


def part2_size(cfg: CsiReportConfig, ri: int) -> int:
    """CSI part 2: LI + PMI (second-TB CQI only above 4 layers — out of
    scope like the reference's typeI single panel <=4)."""
    return li_size(cfg, ri) + pmi_sizes(cfg, ri).total


def part2_correspondence(cfg: CsiReportConfig) -> Part2SizeDescription:
    """UCI part-1 -> part-2 size map for the PUSCH demultiplexer (the
    reference builds the same entry in get_csi_report_pusch_size,
    csi_report_on_pusch_helpers.cpp:196-231): the RI field (offset=cri
    bits, width=ri bits) selects among the per-rank part-2 sizes."""
    rs = ri_size(cfg)
    ranks = cfg.allowed_ranks()
    if rs == 0:
        return Part2SizeDescription.fixed(part2_size(cfg, ranks[0]))
    size_map = []
    for code in range(1 << rs):
        ri = ranks[code] if code < len(ranks) else ranks[-1]
        size_map.append(part2_size(cfg, ri))
    return Part2SizeDescription(
        (Part2Entry((Part2Parameter(cri_size(cfg), rs),),
                    tuple(size_map)),))


@dataclasses.dataclass
class CsiReportData:
    """Unpacked CSI (csi_report_data mirror)."""

    cri: int = 0
    ri: int = 1
    wideband_cqi: int = 0
    li: int = 0
    i_1_1: int = 0
    i_1_2: int = 0
    i_1_3: int = 0
    i_2: int = 0

    def pmi_fields(self) -> dict:
        return {"i_1_1": self.i_1_1, "i_1_3": self.i_1_3, "i_2": self.i_2}


def _extract(bits: np.ndarray, offset: int, width: int) -> int:
    """MSB-first field extraction (the reference's csi_report_packed
    bit_buffer extract)."""
    v = 0
    for b in bits[offset:offset + width]:
        v = (v << 1) | int(b)
    return v


def _put(bits: list, value: int, width: int):
    for k in range(width - 1, -1, -1):
        bits.append((value >> k) & 1)


def unpack_ri(code: int, cfg: CsiReportConfig) -> int:
    """RI codepoint -> rank via the restriction bitmap
    (csi_report_unpack_ri)."""
    ranks = cfg.allowed_ranks()
    return ranks[code] if code < len(ranks) else ranks[-1]


def unpack(csi1_bits, csi2_bits, cfg: CsiReportConfig) -> CsiReportData:
    """Part-1 + part-2 bit arrays -> structured report
    (csi_report_unpack_pusch).  csi2_bits may be empty/None when the
    report has no part 2 (1-port or cri_ri_cqi quantities)."""
    b1 = np.asarray(csi1_bits).astype(np.int64).ravel()
    assert b1.size == part1_size(cfg), \
        f"CSI part1 size {b1.size} != expected {part1_size(cfg)}"
    out = CsiReportData()
    pos = 0
    out.cri = _extract(b1, pos, cri_size(cfg))
    pos += cri_size(cfg)
    out.ri = unpack_ri(_extract(b1, pos, ri_size(cfg)), cfg)
    pos += ri_size(cfg)
    out.wideband_cqi = _extract(b1, pos, 4)
    b2 = (np.asarray(csi2_bits).astype(np.int64).ravel()
          if csi2_bits is not None else np.zeros(0, np.int64))
    want2 = part2_size(cfg, out.ri)
    if want2 == 0 or b2.size == 0:
        return out
    assert b2.size == want2, \
        f"CSI part2 size {b2.size} != expected {want2} for ri={out.ri}"
    pos = 0
    ls = li_size(cfg, out.ri)
    out.li = _extract(b2, pos, ls)
    pos += ls
    sz = pmi_sizes(cfg, out.ri)
    out.i_1_1 = _extract(b2, pos, sz.i_1_1)
    pos += sz.i_1_1
    out.i_1_2 = _extract(b2, pos, sz.i_1_2)
    pos += sz.i_1_2
    out.i_1_3 = _extract(b2, pos, sz.i_1_3)
    pos += sz.i_1_3
    out.i_2 = _extract(b2, pos, sz.i_2)
    return out


def pack(data: CsiReportData, cfg: CsiReportConfig) -> tuple:
    """Structured report -> (csi1_bits, csi2_bits) int8 arrays — the UE
    side of the exchange (test doubles / channel emulation)."""
    b1: list = []
    _put(b1, data.cri, cri_size(cfg))
    ranks = cfg.allowed_ranks()
    _put(b1, ranks.index(data.ri), ri_size(cfg))
    _put(b1, data.wideband_cqi, 4)
    b2: list = []
    _put(b2, data.li, li_size(cfg, data.ri))
    sz = pmi_sizes(cfg, data.ri)
    _put(b2, data.i_1_1, sz.i_1_1)
    _put(b2, data.i_1_2, sz.i_1_2)
    _put(b2, data.i_1_3, sz.i_1_3)
    _put(b2, data.i_2, sz.i_2)
    return (np.array(b1, np.int8), np.array(b2, np.int8))


# ------------------------------------------------------ PUCCH-format report

def _pucch_size_ri(cfg: CsiReportConfig, ri: int) -> int:
    """Unpadded PUCCH CSI size at a given rank (order per TS38.212 Table
    6.3.1.1.2-7: CRI, RI, [LI], PMI, wideband CQI)."""
    return (cri_size(cfg) + ri_size(cfg) + pmi_sizes(cfg, ri).total + 4)


def pucch_size(cfg: CsiReportConfig) -> int:
    """Fixed PUCCH CSI payload: max over allowed ranks, smaller ranks pad
    between RI and PMI (get_csi_report_pucch_size)."""
    return max(_pucch_size_ri(cfg, ri) for ri in cfg.allowed_ranks())


def unpack_pucch(bits, cfg: CsiReportConfig) -> CsiReportData:
    """One packed PUCCH report -> structured CSI
    (csi_report_unpack_pucch_cri_ri_li_pmi_cqi)."""
    b = np.asarray(bits).astype(np.int64).ravel()
    assert b.size == pucch_size(cfg), \
        f"PUCCH CSI size {b.size} != expected {pucch_size(cfg)}"
    out = CsiReportData()
    pos = 0
    out.cri = _extract(b, pos, cri_size(cfg))
    pos += cri_size(cfg)
    out.ri = unpack_ri(_extract(b, pos, ri_size(cfg)), cfg)
    pos += ri_size(cfg)
    pos += pucch_size(cfg) - _pucch_size_ri(cfg, out.ri)     # padding
    sz = pmi_sizes(cfg, out.ri)
    out.i_1_1 = _extract(b, pos, sz.i_1_1)
    pos += sz.i_1_1
    out.i_1_2 = _extract(b, pos, sz.i_1_2)
    pos += sz.i_1_2
    out.i_1_3 = _extract(b, pos, sz.i_1_3)
    pos += sz.i_1_3
    out.i_2 = _extract(b, pos, sz.i_2)
    pos += sz.i_2
    out.wideband_cqi = _extract(b, pos, 4)
    return out


def pack_pucch(data: CsiReportData, cfg: CsiReportConfig) -> np.ndarray:
    """Structured CSI -> one packed PUCCH report (UE side)."""
    b: list = []
    _put(b, data.cri, cri_size(cfg))
    _put(b, cfg.allowed_ranks().index(data.ri), ri_size(cfg))
    for _ in range(pucch_size(cfg) - _pucch_size_ri(cfg, data.ri)):
        b.append(0)                                          # padding
    sz = pmi_sizes(cfg, data.ri)
    _put(b, data.i_1_1, sz.i_1_1)
    _put(b, data.i_1_2, sz.i_1_2)
    _put(b, data.i_1_3, sz.i_1_3)
    _put(b, data.i_2, sz.i_2)
    _put(b, data.wideband_cqi, 4)
    return np.array(b, np.int8)


# --------------------------------------------------- CQI -> MCS mapping

# TS38.214 Table 5.2.2.1-2 (CQI table 1, qam64): spectral efficiency per
# CQI index 1..15 (0 = out of range).
CQI_TABLE_1_SE = (0.0, 0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758,
                  1.4766, 1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234,
                  5.1152, 5.5547)
# Table 5.2.2.1-3 (CQI table 2, 256QAM).
CQI_TABLE_2_SE = (0.0, 0.1523, 0.3770, 0.8770, 1.4766, 1.9141, 2.4063,
                  2.7305, 3.3223, 3.9023, 4.5234, 5.1152, 5.5547, 6.2266,
                  6.9141, 7.4063)


def cqi_to_mcs(cqi: int, mcs_table: str = "qam64") -> int:
    """Largest MCS whose spectral efficiency does not exceed the reported
    CQI's (ue_link_adaptation_controller's efficiency-match, simplified to
    wideband).  CQI 0 = out of range -> MCS 0."""
    from .mcs_tbs import TABLES, QM
    se_table = CQI_TABLE_2_SE if mcs_table == "qam256" else CQI_TABLE_1_SE
    target = se_table[min(max(cqi, 0), 15)]
    if target <= 0.0:
        return 0
    best = 0
    for i, (mod, rate_x1024) in enumerate(TABLES[mcs_table]):
        if QM[mod] * rate_x1024 / 1024.0 <= target + 1e-9:
            best = i
    return best
