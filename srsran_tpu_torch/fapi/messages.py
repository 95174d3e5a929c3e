"""FAPI slot message dataclasses (SCF-222-shaped, like the reference's).

The port's own copy of srsran_tpu/fapi/messages.py (which imports the JAX
package's channel processors): the same classes and fields, whose PDUs are
the port's config dataclasses.  Mirrors include/srsran/fapi/messages/:
dl_tti_request.h, ul_tti_request.h, tx_data_request.h, crc_indication.h,
rx_data_indication.h, uci_indication.h, rach_indication.h.  The conductor
uses the tuple of PDU configs as its slot-phase key (the "slot plan").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..ran.slot_point import SlotPoint


# ------------------------------------------------------------- DL direction

@dataclasses.dataclass
class DlTtiRequest:
    """Per-slot DL schedule (fapi::dl_tti_request_message)."""

    slot: SlotPoint
    ssb: tuple = ()        # tuple[SsbConfig]
    pdcch: tuple = ()      # tuple[PdcchConfig]
    pdsch: tuple = ()      # tuple[PdschConfig]
    csi_rs: tuple = ()     # tuple[CsiRsConfig]
    prs: tuple = ()        # tuple[PrsConfig]

    def plan_key(self):
        return (self.ssb, self.pdcch, self.pdsch, self.csi_rs, self.prs)


@dataclasses.dataclass
class UlDciRequest:
    """UL grants' PDCCH PDUs (fapi::ul_dci_request_message), transmitted in
    the DL slot program alongside the dl_tti PDUs."""

    slot: SlotPoint
    pdcch: tuple = ()         # tuple[PdcchConfig]
    payloads: tuple = ()      # DCI payload bits per PDU


@dataclasses.dataclass
class TxDataRequest:
    """Payloads of the slot's PDUs (fapi::tx_data_request_message):
    pdsch_payloads[i] for DlTtiRequest.pdsch[i], pdcch_payloads[i] for the
    DCIs, ssb_mib[i] for the SSBs; packed bytes or 0/1 bit arrays."""

    slot: SlotPoint
    pdsch_payloads: tuple = ()
    pdcch_payloads: tuple = ()
    ssb_mib: tuple = ()


# ------------------------------------------------------------- UL direction

@dataclasses.dataclass
class UlTtiRequest:
    """Per-slot UL schedule (fapi::ul_tti_request_message).

    pusch_harq[i] = (harq_id, new_data) for pusch[i]; kept outside the PDU
    config so HARQ state changes do not change the slot plan.
    """

    slot: SlotPoint
    pusch: tuple = ()      # tuple[PuschConfig]
    pusch_harq: tuple = ()  # tuple[(harq_id, new_data)]
    pucch_f0: tuple = ()   # tuple[PucchF0Config]
    pucch_f1: tuple = ()   # tuple[PucchF1Config]
    pucch_f2: tuple = ()   # tuple[PucchF2Config]
    pucch_f3: tuple = ()   # tuple[PucchF3Config], occ_length 1
    pucch_f4: tuple = ()   # tuple[PucchF3Config], occ_length 2 or 4
    prach: tuple = ()      # tuple[PrachConfig]
    srs: tuple = ()        # tuple[SrsConfig]

    def plan_key(self):
        return (self.pusch, self.pucch_f0, self.pucch_f1, self.pucch_f2,
                self.pucch_f3, self.pucch_f4, self.prach, self.srs)


# -------------------------------------------------------------- indications

@dataclasses.dataclass
class CrcIndicationPdu:
    """CRC.indication essentials + channel state information (per-port
    EPRE/RSRP/SINR, TA, CFO, EVM)."""

    rnti: int
    tb_crc_ok: bool
    timing_advance_s: float
    snr_db: float
    rsrp: float = 0.0            # linear, averaged over ports
    cfo_hz: float = 0.0
    evm: float = 0.0             # RMS EVM from hard decisions
    nof_ldpc_iterations: float = 0.0
    snr_port_db: Optional[np.ndarray] = None   # f32 [rx_ports]
    rsrp_port: Optional[np.ndarray] = None     # f32 [rx_ports], linear
    epre_port: Optional[np.ndarray] = None     # f32 [rx_ports], linear


@dataclasses.dataclass
class RxDataIndicationPdu:
    rnti: int
    payload: np.ndarray      # uint8 bits (only valid if crc ok)


@dataclasses.dataclass
class UciIndicationPdu:
    rnti: int
    detected: bool
    harq_bits: Optional[np.ndarray]
    csi_bits: Optional[np.ndarray]          # CSI part 1 (or PUCCH payload)
    metric: float
    sr_bit: Optional[int] = None   # PUCCH F0 SR opportunity result
    csi2_bits: Optional[np.ndarray] = None  # CSI part 2 (UCI on PUSCH)
    source: str = "pucch"                   # 'pucch' | 'pusch'


@dataclasses.dataclass
class RachIndicationPreamble:
    preamble_index: int
    timing_advance_s: float
    metric: float


@dataclasses.dataclass
class SrsIndicationPdu:
    """Sounding report (fapi srs_indication.h essentials)."""

    rnti: int
    timing_advance_s: float
    snr_db: float
    wideband_h: np.ndarray   # complex [rx_ports, srs_ports] wideband channel


@dataclasses.dataclass
class SlotResults:
    """Everything the UL slot produced (crc/rx_data/uci/rach/srs ind)."""

    slot: SlotPoint
    crc: list = dataclasses.field(default_factory=list)
    rx_data: list = dataclasses.field(default_factory=list)
    uci: list = dataclasses.field(default_factory=list)
    rach: list = dataclasses.field(default_factory=list)
    srs: list = dataclasses.field(default_factory=list)
