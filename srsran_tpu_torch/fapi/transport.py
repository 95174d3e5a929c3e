"""Split-6 FAPI transport: slot messages over a local TCP socket.

Port of srsran_tpu/fapi/transport.py, the reference's split-6 deployment:
the MAC (du_high) and the PHY (apps/du_low -- upper PHY + FAPI, no MAC) run
in separate processes and exchange SCF-222 FAPI slot messages over the
network.  The wire is the JAX package's, byte for byte: length-prefixed
JSON with base64 arrays, self-describing for the message dataclasses, so a
JAX-side MAC (srsran_tpu.fapi.transport.FapiClient) drives this PHY and
this package's client drives the JAX one.

Class names on the wire.  The JAX codec names each dataclass and enum as
``srsran_tpu.<module>:<Class>``.  This codec writes, for a class of the
port, the name of the JAX module its own module is the counterpart of
(``srsran_tpu_torch.X`` -> ``srsran_tpu.X``; the layouts are 1:1), and
decodes a name under ``srsran_tpu.`` as the port's class of the same
module and name.  It never imports the JAX package and refuses any other
module -- ``srsran_tpu_torch.X`` written literally too.  Tensor fields are
encoded from host copies; received UL samples go to the conductor's device
in one copy.

Message types (as the JAX package's):
  fapi_config  MAC -> PHY: ParamRequest, ConfigRequest, StartRequest or
               StopRequest (fapi/config_messages.py); the reply is
               fapi_config_reply with the response dataclass (None for an
               accepted start.request).  stop -> config -> start
               reconfigures the cell without a process restart.
  config       shorthand: a bare CellConfig == config.request + start.request
  dl_tti       MAC -> PHY: {dl: DlTtiRequest, tx: TxDataRequest,
               want_samples}; dl_samples carries the antenna samples back
               when asked
  ul_tti       MAC -> PHY: {ul: UlTtiRequest} -> slot_results
  ul_tti_nb    the same without a reply: the PHY resolves 2 slots behind the
               launch front and pushes slot_results_nb; flush drains them
  rx_samples   UL antenna samples for the next UL slot (the RU-emulator
               path): an array, as the JAX package sends it, or -- this
               package's addition -- {"samples": array, "prach_fd": (arrays,)}
               with the frequency-domain PRACH captures of the slot's PRACH
               occasions
  error_indication PHY -> MAC: a slot message in the wrong state or outside
               the processing window (fapi::error_indication)
  stop         MAC -> PHY: shut down the server
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import importlib
import json
import select
import socket
import struct
import time
from collections import deque

import numpy as np
import torch

from ..device import require_cuda, resolve

WIRE_PREFIX = "srsran_tpu."
PORT_PREFIX = "srsran_tpu_torch."
RESOLVE_LAG = 2


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

def wire_name(cls) -> str:
    """A port class's name on the wire: its JAX counterpart's module."""
    mod = cls.__module__
    if not mod.startswith(PORT_PREFIX):
        raise ValueError(f"{mod}:{cls.__qualname__} has no name on the wire")
    return f"{WIRE_PREFIX}{mod[len(PORT_PREFIX):]}:{cls.__qualname__}"


def encode(obj):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return {"__enum__": wire_name(type(obj)), "v": obj.name}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dc__": wire_name(type(obj)),
                "f": {f.name: encode(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)}}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, tuple):
        return {"__tu__": [encode(x) for x in obj]}
    if isinstance(obj, list):
        return [encode(x) for x in obj]
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise ValueError("dict keys must be str")
        return {"__map__": {k: encode(v) for k, v in obj.items()}}
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    arr = np.asarray(obj)
    return {"__nd__": {"d": arr.dtype.str, "s": list(arr.shape),
                       "b": base64.b64encode(arr.tobytes()).decode()}}


def _resolve(spec: str):
    mod, qual = spec.split(":")
    if not mod.startswith(WIRE_PREFIX):
        raise ValueError(f"refusing to import {spec!r}")
    target = importlib.import_module(PORT_PREFIX + mod[len(WIRE_PREFIX):])
    for part in qual.split("."):
        target = getattr(target, part)
    return target


def decode(obj):
    if isinstance(obj, list):
        return [decode(x) for x in obj]
    if not isinstance(obj, dict):
        return obj
    if "__tu__" in obj:
        return tuple(decode(x) for x in obj["__tu__"])
    if "__map__" in obj:
        return {k: decode(v) for k, v in obj["__map__"].items()}
    if "__nd__" in obj:
        d = obj["__nd__"]
        raw = base64.b64decode(d["b"])
        return np.frombuffer(raw, dtype=np.dtype(d["d"])).reshape(d["s"]).copy()
    if "__enum__" in obj:
        cls = _resolve(obj["__enum__"])
        if not (isinstance(cls, type) and issubclass(cls, enum.Enum)):
            raise ValueError(f"{obj['__enum__']} is not an enum")
        return cls[obj["v"]]
    if "__dc__" in obj:
        cls = _resolve(obj["__dc__"])
        if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
            raise ValueError(f"{obj['__dc__']} is not a dataclass")
        return cls(**{k: decode(v) for k, v in obj["f"].items()})
    return {k: decode(v) for k, v in obj.items()}


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def send_msg(sock: socket.socket, msg_type: str, body=None) -> None:
    """One message: an 8-byte big-endian length, then the JSON."""
    payload = json.dumps({"t": msg_type, "b": encode(body)}).encode()
    sock.sendall(struct.pack(">Q", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 22))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket):
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if n > (1 << 31):
        raise ValueError(f"oversized frame: {n}")
    msg = json.loads(_recv_exact(sock, n).decode())
    return msg["t"], decode(msg.get("b"))


# ---------------------------------------------------------------------------
# MAC-side client
# ---------------------------------------------------------------------------

class FapiClient:
    """MAC-side endpoint of the split-6 link (fapi message gateway)."""

    def __init__(self, host: str, port: int, timeout: float = 300.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self.error_indications: list = []   # async fapi::error_indication
        self.results: list = []             # pushed slot_results_nb

    def _recv(self):
        """recv_msg that collects pushed slot_results_nb (pipelined
        indications may precede any request's reply)."""
        while True:
            t, body = recv_msg(self._sock)
            if t == "slot_results_nb":
                self.results.append(body)
                continue
            return t, body

    def _expect(self, want: str):
        t, body = self._recv()
        if t != want:
            raise ConnectionError(f"expected {want!r}, got {t!r}: {body!r}")
        return body

    def configure(self, cell) -> None:
        """Shorthand: config.request + start.request."""
        send_msg(self._sock, "config", cell)
        self._expect("config_ok")

    def config_msg(self, msg):
        """Send one config-plane message and return the PHY's reply
        dataclass (None for an accepted start.request)."""
        send_msg(self._sock, "fapi_config", msg)
        return self._expect("fapi_config_reply")

    def reconfigure(self, cell):
        """Cell reconfiguration without restarting the PHY process:
        stop.request -> config.request -> start.request."""
        from .config_messages import (ConfigRequest, ErrorCode, StartRequest,
                                      StopRequest)
        self.config_msg(StopRequest())
        resp = self.config_msg(ConfigRequest(cell=cell))
        if resp.error_code is not ErrorCode.MSG_OK:
            raise ValueError(f"config rejected: {resp.invalid_params}")
        self.config_msg(StartRequest())
        return resp

    def _slot_reply(self, want: str, message_id: str, slot):
        """The reply ``want`` to a slot message, or the ErrorIndication for
        that slot; earlier error indications are collected."""
        while True:
            t, body = self._recv()
            if t == want:
                return body
            if t != "error_indication":
                raise ConnectionError(f"expected {want!r}, got {t!r}")
            if (body.message_id == message_id and body.sfn == slot.sfn
                    and body.slot == slot.slot_index):
                return body
            self.error_indications.append(body)

    def dl_tti(self, dl, tx, want_samples: bool = False):
        """Send the DL slot.  want_samples=True returns the modulated
        antenna samples (numpy [P, T] complex64), or the ErrorIndication of
        a rejected slot."""
        send_msg(self._sock, "dl_tti",
                 {"dl": dl, "tx": tx, "want_samples": want_samples})
        if want_samples:
            return self._slot_reply("dl_samples", "dl_tti", dl.slot)
        return None

    def rx_samples(self, samples, prach_fd=()) -> None:
        """UL antenna samples for the next UL slot, with the PRACH
        occasions' frequency-domain captures when the slot has PRACH PDUs
        (then in this package's dict form)."""
        body = ({"samples": samples, "prach_fd": tuple(prach_fd)}
                if prach_fd else samples)
        send_msg(self._sock, "rx_samples", body)

    def ul_tti(self, ul):
        """The slot's SlotResults, or the ErrorIndication of this slot."""
        send_msg(self._sock, "ul_tti", {"ul": ul})
        return self._slot_reply("slot_results", "ul_tti", ul.slot)

    def ul_tti_nb(self, ul) -> None:
        """Non-blocking UL slot: its results arrive later in self.results
        (or through flush())."""
        send_msg(self._sock, "ul_tti_nb", {"ul": ul})
        self.drain_pushed()      # keep both socket buffers from filling

    def drain_pushed(self) -> int:
        """Consume the messages already pushed, without blocking."""
        n = 0
        while select.select([self._sock], [], [], 0.0)[0]:
            t, body = recv_msg(self._sock)
            if t == "slot_results_nb":
                self.results.append(body)
            elif t == "error_indication":
                self.error_indications.append(body)
            else:
                raise ConnectionError(f"unexpected pushed message {t!r}")
            n += 1
        return n

    def flush(self) -> list:
        """Resolve and deliver every in-flight non-blocking UL slot;
        returns (and drains) every result received so far."""
        send_msg(self._sock, "flush", None)
        while True:
            t, body = self._recv()
            if t == "error_indication":
                self.error_indications.append(body)
                continue
            if t != "flush_done":
                raise ConnectionError(f"expected 'flush_done', got {t!r}")
            out, self.results = self.results, []
            return out

    def stop(self) -> None:
        try:
            send_msg(self._sock, "stop")
        finally:
            self._sock.close()


# ---------------------------------------------------------------------------
# PHY-side server
# ---------------------------------------------------------------------------

def _rx_body(body, device) -> tuple:
    """An rx_samples body as (samples, prach captures) on ``device``."""
    if isinstance(body, dict):
        samples, prach = body["samples"], body.get("prach_fd", ())
    else:
        samples, prach = body, ()
    return (torch.from_numpy(np.asarray(samples)).to(device),
            tuple(torch.from_numpy(np.asarray(p)).to(device) for p in prach))


class _Clock:
    """Per-message handler times for ``serve_phy(stats=...)``: host seconds
    of the whole handler and, on the card, device milliseconds of the
    conductor call between two CUDA events."""

    def __init__(self, stats, device):
        self.stats = stats
        self.cuda = device.type == "cuda"

    def __call__(self, kind: str, fn):
        if self.stats is None:
            return fn()
        t0 = time.perf_counter()
        if self.cuda:
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
        out = fn()
        dev_ms = None
        if self.cuda:
            end.record()
            end.synchronize()
            dev_ms = begin.elapsed_time(end)
        self.stats.setdefault(kind, []).append(
            (time.perf_counter() - t0, dev_ms))
        return out


def serve_phy(port: int = 0, host: str = "127.0.0.1", ready_cb=None,
              device=None, stats: dict | None = None) -> None:
    """Run the DU-low FAPI server: one MAC client, slot messages in order.

    The PHY owns the cell manager (its conductor on ``device``: the card
    unless the caller names another) and an RU-emulator-style UL sample
    buffer: rx_samples messages stand in for the radio's receive path.
    A dl_tti, ul_tti or ul_tti_nb that fails validation is answered with
    an error_indication (MSG_SLOT_ERR, the validator's message) and the
    server serves the next message; the JAX package's server ends there
    (its loop catches only ConnectionError).  Nothing else is caught: any
    other fault, on the card or not, still ends the server.
    ``stats``, when given, collects per message kind ("dl_tti",
    "ul_tti", "ul_tti_nb") (host s, device ms) pairs of the conductor
    calls.
    """
    from .config_messages import (CellManager, ConfigRequest, ErrorCode,
                                  ErrorIndication, PhyState, StartRequest)
    from .validators import ValidationError

    dev = require_cuda() if device is None else resolve(device)
    clock = _Clock(stats, dev)
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind((host, port))
    lsock.listen(1)
    if ready_cb is not None:
        ready_cb(lsock.getsockname()[1])
    conn, _ = lsock.accept()
    mgr = CellManager(device=dev)
    pending = None                  # (samples, prach captures) of the next UL
    nb_pending: deque = deque()     # non-blocking UL slots in flight

    def gate(msg_id, slot):
        err = mgr.gate_slot(msg_id, slot)
        if err is not None:
            send_msg(conn, "error_indication", err)
        return err

    def slot_error(msg_id, slot, e):
        send_msg(conn, "error_indication", ErrorIndication(
            slot.sfn, slot.slot_index, msg_id, ErrorCode.MSG_SLOT_ERR,
            str(e)))

    def take_rx():
        nonlocal pending
        if pending is None:
            raise RuntimeError("ul_tti without UL samples (send rx_samples "
                               "first)")
        rx, pending = pending, None
        return rx

    try:
        while True:
            t, body = recv_msg(conn)
            if t == "stop":
                return
            if t == "fapi_config":
                send_msg(conn, "fapi_config_reply",
                         mgr.handle_config_msg(body))
            elif t == "config":
                resp = mgr.handle_config_msg(ConfigRequest(cell=body))
                if resp.error_code is ErrorCode.MSG_OK:
                    mgr.handle_config_msg(StartRequest())
                    send_msg(conn, "config_ok")
                else:
                    send_msg(conn, "error",
                             {"msg": f"bad config: {resp.invalid_params}",
                              "type": t})
            elif mgr.state is not PhyState.RUNNING and t in (
                    "dl_tti", "ul_tti", "rx_samples"):
                if t == "rx_samples":
                    send_msg(conn, "error_indication", ErrorIndication(
                        0, 0, t, ErrorCode.MSG_INVALID_STATE,
                        f"state={mgr.state.name}"))
                else:
                    slot = (body["dl"] if t == "dl_tti" else body["ul"]).slot
                    gate(t, slot)
            elif t == "dl_tti":
                if gate(t, body["dl"].slot) is not None:
                    continue
                try:
                    samples, _ = clock("dl_tti",
                                       lambda: mgr.conductor.process_dl(
                                           body["dl"], body["tx"],
                                           return_grid=False))
                except ValidationError as e:
                    slot_error(t, body["dl"].slot, e)
                    continue
                if body.get("want_samples"):
                    send_msg(conn, "dl_samples", samples.cpu().numpy())
                elif samples.is_cuda:
                    torch.cuda.current_stream(samples.device).synchronize()
            elif t == "rx_samples":
                pending = _rx_body(body, mgr.conductor.device)
            elif t == "ul_tti":
                if gate(t, body["ul"].slot) is not None:
                    continue
                rx, prach = take_rx()
                try:
                    res = clock("ul_tti", lambda: mgr.conductor.process_ul(
                        body["ul"], rx, prach).resolve())
                except ValidationError as e:
                    slot_error(t, body["ul"].slot, e)
                    continue
                send_msg(conn, "slot_results", res)
            elif t == "ul_tti_nb":
                if gate("ul_tti", body["ul"].slot) is not None:
                    continue
                rx, prach = take_rx()
                try:
                    nb_pending.append(clock("ul_tti_nb",
                                            lambda: mgr.conductor.process_ul(
                                                body["ul"], rx, prach)))
                except ValidationError as e:
                    slot_error("ul_tti", body["ul"].slot, e)
                    continue
                while len(nb_pending) > RESOLVE_LAG:
                    send_msg(conn, "slot_results_nb",
                             nb_pending.popleft().resolve())
            elif t == "flush":
                while nb_pending:
                    send_msg(conn, "slot_results_nb",
                             nb_pending.popleft().resolve())
                send_msg(conn, "flush_done")
            else:
                raise ValueError(f"unknown message type {t!r}")
    except ConnectionError:
        pass
    finally:
        conn.close()
        lsock.close()
