"""Carry JAX-side state into the port.

A PHY has no learned weights; what crosses over is configuration and slot
state: config dataclasses, FAPI requests, HARQ soft buffers and the
conductor's slot-context values (DM-RS pilot values or c_init seeds, SSB
bit pairs, PUCCH F1 weight tuples, F3/F4 DM-RS values);
:func:`slot_results` holds the indications of either package's
conductor to the other's.  Inputs are numpy arrays, plain dataclass fields
and enums, matched to the port's classes by name, so this module imports
neither JAX nor the JAX package.

The split-7.2 fronthaul (``ofh/``, ``ru/ofh.py``, ``apps/ru_emulator.py``)
has no parameters and no learned state: nothing of it crosses over here.
Its messages are bytes, equal in both packages, and its configuration is
the constructor arguments of ``RuOfh`` and ``OfhTimingConfig``.  Nor
do the encoders and LLR helpers (``polar.encode_chain``,
``short_block.encode``, ``ssb.pbch_encode``, ``pdcch.encode_dci``,
``llr.quantize``, ``ldpc_decode.check_parity``): they take bits and
configs that already cross over, and hold no state.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .emulation.channel import ChannelConfig
from .mac.scheduler import SchedUeConfig
from .mac.test_mode import TestUe
from .phy.slot_programs import CellConfig
from .phy.upper.csi_rs import CsiRsConfig
from .phy.upper.dmrs import DmrsConfig
from .phy.upper.pdcch import CoresetConfig, PdcchConfig
from .phy.upper.pdsch import PdschConfig, PdschPtrs
from .phy.upper.prach import PrachConfig
from .phy.upper.ptrs_prs import PrsConfig, PtrsConfig
from .phy.upper.pucch import (PucchF0Config, PucchF1Config, PucchF2Config,
                              PucchF3Config)
from .phy.upper.pusch import PuschConfig
from .phy.upper.srs import SrsConfig
from .phy.upper.ssb import SsbConfig
from .ran.csi_report import CsiReportConfig
from .ran.cyclic_prefix import CyclicPrefix
from .ran.precoding_codebooks import PrecodingConfig
from .ran.slot_point import SlotPoint
from .ran.tdd import TddPattern
from .ran.uci_on_pusch import (Part2Entry, Part2Parameter,
                               Part2SizeDescription, UciOnPuschConfig)
from .utils.config import AppConfig

# Port classes by name; a JAX config maps to the port class of its name.
CONFIG_CLASSES = {cls.__name__: cls for cls in
                  (AppConfig, CellConfig, ChannelConfig, CoresetConfig,
                   CsiReportConfig, CsiRsConfig, DmrsConfig, PdcchConfig,
                   PdschConfig, PdschPtrs, PrachConfig, PrecodingConfig,
                   PrsConfig, PtrsConfig,
                   Part2Entry, Part2Parameter, Part2SizeDescription,
                   PucchF0Config, PucchF1Config, PucchF2Config, PucchF3Config,
                   PuschConfig, SchedUeConfig, SlotPoint, SrsConfig,
                   SsbConfig, TddPattern, TestUe, UciOnPuschConfig)}
# Port enums by name; a JAX enum member maps to the member of its name.
ENUM_CLASSES = {cls.__name__: cls for cls in (CyclicPrefix,)}


def value(v):
    """A config field value (or an enum member, or a tuple or list of
    either) with the port's classes for the JAX package's."""
    if isinstance(v, (tuple, list)):
        return type(v)(value(x) for x in v)
    name = type(v).__name__
    if isinstance(v, enum.Enum) and name in ENUM_CLASSES:
        port = ENUM_CLASSES[name][v.name]
        if port.value != v.value:
            raise ValueError(f"{name}.{v.name}: values differ")
        return port
    if dataclasses.is_dataclass(v) and name in CONFIG_CLASSES:
        return config(v)
    return v


def config(jax_cfg):
    """The port config with the same field values as a JAX config.

    Field names must match the port class exactly.  Nested configs
    (PdschPtrs, PdcchConfig.coreset, UciOnPuschConfig, PrecodingConfig,
    the Part2Entry and Part2Parameter tuples of a Part2SizeDescription,
    AppConfig's cell, TDD pattern and list of TestUe) convert recursively
    and enums (CyclicPrefix) by member name, to the port's own classes.
    """
    cls = CONFIG_CLASSES[type(jax_cfg).__name__]
    names = {f.name for f in dataclasses.fields(jax_cfg)}
    port_names = {f.name for f in dataclasses.fields(cls)}
    if names != port_names:
        raise ValueError(f"{cls.__name__}: fields differ: "
                         f"{sorted(names ^ port_names)}")
    return cls(**{name: value(getattr(jax_cfg, name)) for name in names})


def plan(jax_plan: tuple) -> tuple:
    """A slot plan (tuple of tuples of PDU configs) with port configs."""
    return tuple(tuple(config(c) if type(c).__name__ in CONFIG_CLASSES else c
                       for c in group) for group in jax_plan)


def soft_buffers(buffers, device: torch.device | str) -> tuple:
    """HARQ soft buffers (numpy f32 [C, N] each) as device tensors."""
    return tuple(torch.as_tensor(np.asarray(b, dtype=np.float32)).to(device)
                 for b in buffers)


def _ctx_value(value, device):
    arr = np.asarray(value)
    if np.iscomplexobj(arr):
        return torch.as_tensor(arr.astype(np.complex64)).to(device)
    if arr.dtype == np.uint32:
        # c_init seeds key the host-built pilot cache: they stay on the host
        # (as int64, torch has no uint32 ops) so no slot reads them back.
        return torch.as_tensor(arr.astype(np.int64))
    return torch.as_tensor(np.array(arr)).to(device)


def _ctx_entry(entry, device):
    if entry is None:
        return None
    if isinstance(entry, (tuple, list)):
        # ctx["ssb"][i] is a pair (static_bits [32], scramble_mask [32]) and
        # ctx["f1"][i] a tuple of hops, each a triple (a_dm, ph, w_da):
        # tuples stay tuples, of tensors.
        return tuple(_ctx_entry(e, device) for e in entry)
    return _ctx_value(entry, device)


def slot_context(ctx: dict, device: torch.device | str) -> dict:
    """The conductor's slot context ({"pusch": (values, ...), ...}, numpy
    leaves: pilot values, SSB bit pairs and F1 weights moved to ``device``;
    c_inits uint32, kept on the host)."""
    return {key: tuple(_ctx_entry(e, device) for e in entries)
            for key, entries in ctx.items()}


def _message_value(v):
    if dataclasses.is_dataclass(v) and type(v).__name__ in CONFIG_CLASSES:
        return config(v)
    if isinstance(v, tuple):
        return tuple(_message_value(x) for x in v)
    return v


def requests(jax_msg):
    """A JAX FAPI request (DlTtiRequest, UlTtiRequest, TxDataRequest,
    UlDciRequest) as the port's message of the same name: PDU configs and
    the slot point as the port's classes, payloads and HARQ tuples as
    given."""
    from .fapi import messages
    name = type(jax_msg).__name__
    if name not in ("DlTtiRequest", "UlTtiRequest", "TxDataRequest",
                    "UlDciRequest"):
        raise TypeError(f"not a FAPI request: {name}")
    return getattr(messages, name)(**{f.name: _message_value(getattr(jax_msg, f.name))
                  for f in dataclasses.fields(jax_msg)})


def _same(ref, got, path: str, rtol: float) -> None:
    if ref is None or got is None:
        if ref is not got:
            raise AssertionError(f"{path}: {got!r} vs {ref!r}")
        return
    if isinstance(ref, (bool, int, str, np.bool_, np.integer)):
        if got != ref:
            raise AssertionError(f"{path}: {got!r} vs {ref!r}")
        return
    if isinstance(ref, (float, np.floating)):
        name = path.rsplit(".", 1)[-1]
        if name == "cfo_hz":                      # a phase slope: 1 Hz
            tol = 1.0
        elif name == "timing_advance_s":          # equal but for 1 ulp
            tol = 1e-6 * abs(ref)
        else:
            tol = rtol * max(abs(ref), 1e-2)
        if not abs(float(got) - float(ref)) <= tol:
            raise AssertionError(f"{path}: {got!r} vs {ref!r}")
        return
    if isinstance(ref, np.ndarray):
        got = np.asarray(got)
        if got.shape != ref.shape:
            raise AssertionError(f"{path}: shape {got.shape} vs {ref.shape}")
        if np.issubdtype(ref.dtype, np.inexact):
            atol = rtol * float(np.max(np.abs(ref))) if ref.size else 0.0
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                       err_msg=path)
        elif not np.array_equal(got, ref):
            raise AssertionError(f"{path}: {got} vs {ref}")
        return
    if isinstance(ref, list):
        if len(got) != len(ref):
            raise AssertionError(f"{path}: {len(got)} vs {len(ref)} entries")
        for i, (r, g) in enumerate(zip(ref, got)):
            _same(r, g, f"{path}[{i}]", rtol)
        return
    if dataclasses.is_dataclass(ref):
        if type(got).__name__ != type(ref).__name__:
            raise AssertionError(f"{path}: {type(got).__name__} vs "
                                 f"{type(ref).__name__}")
        for f in dataclasses.fields(ref):
            _same(getattr(ref, f.name), getattr(got, f.name),
                  f"{path}.{f.name}", rtol)
        return
    raise TypeError(f"{path}: cannot compare {type(ref).__name__}")


def slot_results(ref, got, rtol: float = 1e-4) -> None:
    """Hold ``got`` (a SlotResults) to ``ref`` (one of either package)
    field by field; raises AssertionError naming the first difference.

    Decisions, bits, indices and RNTIs equal; the CFO within 1 Hz; TAs
    within 1e-6 relative (PRACH TAs may differ by one ulp); every other
    float within ``rtol`` (relative, floored at 1e-2 in magnitude), float
    arrays within ``rtol`` and an absolute ``rtol * max|ref|``."""
    _same(ref, got, "SlotResults", rtol)
