"""Carry JAX-side state into the port.

A PHY has no learned weights; what crosses over is configuration and slot
state: config dataclasses, HARQ soft buffers and the conductor's
slot-context values (DM-RS pilot values or c_init seeds, SSB bit pairs,
PUCCH F1 weight tuples).  Inputs are numpy arrays, plain dataclass fields
and enums, matched to the port's classes by name, so this module imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .phy.slot_programs import CellConfig
from .phy.upper.dmrs import DmrsConfig
from .phy.upper.pdcch import CoresetConfig, PdcchConfig
from .phy.upper.pdsch import PdschConfig, PdschPtrs
from .phy.upper.prach import PrachConfig
from .phy.upper.pucch import PucchF1Config
from .phy.upper.pusch import PuschConfig
from .phy.upper.srs import SrsConfig
from .phy.upper.ssb import SsbConfig
from .ran.cyclic_prefix import CyclicPrefix
from .ran.precoding_codebooks import PrecodingConfig
from .ran.uci_on_pusch import UciOnPuschConfig

# Port classes by name; a JAX config maps to the port class of its name.
CONFIG_CLASSES = {cls.__name__: cls for cls in
                  (CellConfig, CoresetConfig, DmrsConfig, PdcchConfig,
                   PdschConfig, PdschPtrs, PrachConfig, PrecodingConfig,
                   PucchF1Config, PuschConfig, SrsConfig, SsbConfig,
                   UciOnPuschConfig)}
# Port enums by name; a JAX enum member maps to the member of its name.
ENUM_CLASSES = {cls.__name__: cls for cls in (CyclicPrefix,)}


def value(value):
    """A config field value (or an enum member) with the port's classes
    for the JAX package's."""
    name = type(value).__name__
    if isinstance(value, enum.Enum) and name in ENUM_CLASSES:
        port = ENUM_CLASSES[name][value.name]
        if port.value != value.value:
            raise ValueError(f"{name}.{value.name}: values differ")
        return port
    if dataclasses.is_dataclass(value) and name in CONFIG_CLASSES:
        return config(value)
    return value


def config(jax_cfg):
    """The port config with the same field values as a JAX config.

    Field names are read through ``dataclasses.asdict`` and must match the
    port class exactly.  Nested configs (PdschPtrs, PdcchConfig.coreset,
    UciOnPuschConfig, PrecodingConfig) convert recursively and enums
    (CyclicPrefix) by member name, to the port's own classes.
    """
    cls = CONFIG_CLASSES[type(jax_cfg).__name__]
    names = set(dataclasses.asdict(jax_cfg))
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
