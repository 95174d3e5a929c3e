"""FAPI configuration-plane messages and the PHY cell state machine.

Port of srsran_tpu/fapi/config_messages.py: the same classes and fields
(the split-6 wire names them by the JAX package's module, see
fapi/transport.py).  Mirrors the reference's SCF-222 config messages
(include/srsran/fapi/messages/config_messages.h: param.request/response,
config.request/response, start.request, stop.request, stop.indication) and
error.indication (include/srsran/fapi/messages/error_indication.h), plus
the IDLE -> CONFIGURED -> RUNNING state machine the reference's
fapi_to_phy_translator enforces: slot messages outside RUNNING, or outside
the processing window, are answered with error.indication instead of being
processed.

Cell reconfiguration without process restart: a config.request in
CONFIGURED (after stop.request) closes the old conductor -- its resolved
slot phases, its CUDA graphs and their memory pool -- and makes a new one
on the manager's device.
"""

from __future__ import annotations

import dataclasses
import enum

from ..phy.slot_programs import CellConfig


class ErrorCode(enum.Enum):
    """fapi::error_code_id essentials (error_indication.h)."""

    MSG_OK = 0
    MSG_INVALID_STATE = 1       # message not legal in the current state
    MSG_INVALID_CONFIG = 2
    OUT_OF_SYNC = 3             # slot outside the processing window
    MSG_SLOT_ERR = 4            # malformed/failed slot message
    MSG_BCH_MISSING = 5
    MSG_TX_ERR = 6
    MSG_UL_DCI_ERR = 7


class PhyState(enum.Enum):
    IDLE = 0
    CONFIGURED = 1
    RUNNING = 2


@dataclasses.dataclass
class ParamRequest:
    """Capability query (fapi::param_request)."""


@dataclasses.dataclass
class ParamResponse:
    """PHY capabilities (fapi::param_response TLVs, param_request_tlvs.h)."""

    error_code: ErrorCode = ErrorCode.MSG_OK
    max_dl_layers: int = 4
    max_ul_layers: int = 4          # beyond the reference's 1-2 (ZF) cap
    modulations: tuple = ("qpsk", "qam16", "qam64", "qam256")
    max_nof_rb: int = 273
    numerologies: tuple = (0, 1, 2, 3)
    prach_formats: tuple = ("0", "1", "2", "3", "A1", "A2", "A3", "B1",
                            "B4", "C0", "C2")
    pucch_formats: tuple = (0, 1, 2, 3, 4)
    max_processing_delay_slots: int = 5


@dataclasses.dataclass
class ConfigRequest:
    """Cell configuration (fapi::config_request: carrier/cell/prach/ssb
    TLVs collapse into the CellConfig the TPU slot programs key on)."""

    cell: CellConfig
    cell_id: int = 0


@dataclasses.dataclass
class ConfigResponse:
    error_code: ErrorCode = ErrorCode.MSG_OK
    invalid_params: tuple = ()


@dataclasses.dataclass
class StartRequest:
    pass


@dataclasses.dataclass
class StopRequest:
    pass


@dataclasses.dataclass
class StopIndication:
    """PHY confirms the cell halted (fapi::stop_indication)."""


@dataclasses.dataclass
class ErrorIndication:
    """PHY -> MAC error report (fapi::error_indication)."""

    sfn: int
    slot: int
    message_id: str
    error_code: ErrorCode
    detail: str = ""


def validate_config(req: ConfigRequest):
    """Range checks for config.request (the reference's config validators,
    lib/fapi/validators/).  Returns a tuple of offending field names."""
    bad = []
    c = req.cell
    if not isinstance(c, CellConfig):
        return ("cell",)
    if not 1 <= c.nof_ports <= 8:
        bad.append("cell.nof_ports")
    if not 1 <= c.nof_rb <= 273:
        bad.append("cell.nof_rb")
    if c.dft_size not in (128, 256, 512, 1024, 2048, 4096):
        bad.append("cell.dft_size")
    elif c.nof_rb * 12 > c.dft_size:
        bad.append("cell.dft_size")          # carrier exceeds the DFT
    if c.numerology not in (0, 1, 2, 3, 4):
        bad.append("cell.numerology")
    return tuple(bad)


class CellManager:
    """One cell's FAPI config-plane endpoint + slot-message gatekeeper.

    handle_config_msg() drives the state machine; gate_slot() checks a slot
    message is currently processable and returns an ErrorIndication if not
    (the analogue of fapi_to_phy_translator's is_message_in_time checks).
    The default conductor factory makes a SlotConductor on ``device`` (the
    card when it is None).
    """

    def __init__(self, conductor_factory=None,
                 max_processing_delay_slots: int = 5, device=None):
        if conductor_factory is None:
            from .conductor import SlotConductor

            def conductor_factory(cell):
                return SlotConductor(cell, device=device)
        self._factory = conductor_factory
        self.state = PhyState.IDLE
        self.conductor = None
        self.cell: CellConfig | None = None
        self.max_delay = max_processing_delay_slots
        self._highest_slot = None       # monotonic slot front (count units)

    # ------------------------------------------------------------ config

    def handle_config_msg(self, msg):
        if isinstance(msg, ParamRequest):
            return ParamResponse()
        if isinstance(msg, ConfigRequest):
            if self.state is PhyState.RUNNING:
                return ConfigResponse(
                    error_code=ErrorCode.MSG_INVALID_STATE,
                    invalid_params=("state: send stop.request first",))
            bad = validate_config(msg)
            if bad:
                return ConfigResponse(error_code=ErrorCode.MSG_INVALID_CONFIG,
                                      invalid_params=bad)
            self.cell = msg.cell
            if self.conductor is not None and hasattr(self.conductor, "close"):
                self.conductor.close()
            self.conductor = None
            self.conductor = self._factory(msg.cell)
            self.state = PhyState.CONFIGURED
            self._highest_slot = None
            return ConfigResponse()
        if isinstance(msg, StartRequest):
            if self.state is not PhyState.CONFIGURED:
                return ErrorIndication(0, 0, "start.request",
                                       ErrorCode.MSG_INVALID_STATE,
                                       f"state={self.state.name}")
            self.state = PhyState.RUNNING
            return None
        if isinstance(msg, StopRequest):
            if self.state is not PhyState.RUNNING:
                return ErrorIndication(0, 0, "stop.request",
                                       ErrorCode.MSG_INVALID_STATE,
                                       f"state={self.state.name}")
            self.state = PhyState.CONFIGURED
            return StopIndication()
        raise TypeError(f"not a config-plane message: {type(msg).__name__}")

    # ------------------------------------------------------------- slots

    def gate_slot(self, message_id: str, slot) -> ErrorIndication | None:
        """None if the slot message may be processed now; an
        ErrorIndication otherwise.  Advances the slot front: a message more
        than max_processing_delay_slots BEHIND the front is late (the
        reference's translator drops it with OUT_OF_SYNC,
        fapi_to_phy_translator.cpp is_message_in_time)."""
        if self.state is not PhyState.RUNNING:
            return ErrorIndication(slot.sfn, slot.slot_index, message_id,
                                   ErrorCode.MSG_INVALID_STATE,
                                   f"state={self.state.name}")
        if self._highest_slot is None or (slot - self._highest_slot) > 0:
            self._highest_slot = slot          # wrap-aware signed distance
        elif (self._highest_slot - slot) > self.max_delay:
            return ErrorIndication(
                slot.sfn, slot.slot_index, message_id, ErrorCode.OUT_OF_SYNC,
                f"slot {slot.count} is {self._highest_slot - slot} slots "
                f"behind the front (window {self.max_delay})")
        return None
