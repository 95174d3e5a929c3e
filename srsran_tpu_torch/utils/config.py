"""Application configuration: defaults, a YAML file and dotted overrides.

The port's copy of srsran_tpu/utils/config.py (the analogue of the
reference's CLI11 + YAML system): a flat configuration maps onto the
dataclass configs, with dotted-path command-line overrides
(``--set cell.nof_rb=273``).  The port imports nothing of the JAX package.

PyYAML is not a dependency of the port: the defaults are a Python dict,
and a ``--set`` value goes through :func:`parse_scalar`, which reads plain
scalars the way ``yaml.safe_load`` does (YAML 1.1: ``3.5e9`` without a sign
in its exponent is a *string*, which ``float()`` then takes).  ``yaml`` is
imported only to read a ``-c file.yaml`` or to ``dump`` a configuration.
"""

from __future__ import annotations

import copy
import dataclasses
import re

from ..mac.test_mode import TestUe
from ..phy.slot_programs import CellConfig
from ..ran.cyclic_prefix import CyclicPrefix
from ..ran.tdd import TddPattern


@dataclasses.dataclass
class AppConfig:
    cell: CellConfig
    tdd: TddPattern
    ues: list
    phys_cell_id: int = 1
    nof_slots: int = 100
    seed: int = 0
    channel_profile: str = "none"     # 'none' | 'TDLA' | 'TDLB' | 'TDLC'
    channel_sinr_db: float = 25.0
    trace_file: str = ""
    metrics: bool = True
    mac: str = "test"                 # 'test' (line-rate synthetic) | 'sched'
                                      # (time-RR scheduler + HARQ feedback)
    prach_period_slots: int = 0       # sched mode: PRACH occasion period
                                      # (0 = no PRACH; occasions route through
                                      # the lower-PHY baseband collector FSM)
    resolve_lag: int = 2              # UL slots held in flight before the
                                      # indication d2h (PendingSlotResults);
                                      # reference runs up to 5 slots deep
                                      # (du_low_config.h:40)
    csi_period_slots: int = 20        # sched mode: PUCCH F2 wideband CSI
                                      # report period per UE (0 = off);
                                      # drives DL MCS/rank/PMI adaptation


# The JAX package's DEFAULT_YAML as the dict yaml.safe_load makes of it.
DEFAULTS = {
    "cell": {"nof_ports": 4, "nof_rb": 106,          # 40 MHz @ 30 kHz
             "dft_size": 2048, "numerology": 1,
             "center_freq_hz": "3.5e9"},             # a string in YAML 1.1
    "tdd": {"periodicity_slots": 5, "nof_dl_slots": 3, "nof_ul_slots": 1},
    "ues": [{"rnti": 0x4601, "mcs_table": "qam64", "mcs_index": 27,
             "nof_layers_dl": 2}],
    "run": {"nof_slots": 100, "seed": 0, "channel_profile": "none",
            "channel_sinr_db": 25.0},
}

# PyYAML's implicit resolvers (yaml/resolver.py), less the sexagesimal
# and timestamp forms, which raise.
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)"
                  r"|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_UNSUPPORTED = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*)")


def parse_scalar(text: str):
    """One plain or quoted YAML scalar, as ``yaml.safe_load`` reads it."""
    v = text.strip()
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
        return v[1:-1]
    if v[:1] in ("[", "{", "!", "&", "*", "|", ">", "%", "@", "`") \
            or _UNSUPPORTED.match(v):
        raise ValueError(f"unsupported YAML value {text!r} (a plain scalar "
                         "is expected)")
    if v in _NULL:
        return None
    if v in _BOOL:
        return _BOOL[v]
    if _INT.match(v):
        s = v.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if s != "0" and s.startswith("0"):
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(v):
        s = v.replace("_", "").lower()
        sign = -1.0 if s[0] == "-" else 1.0
        s = s.lstrip("+-")
        if s == ".inf":
            return sign * float("inf")
        if s == ".nan":
            return float("nan")
        return sign * float(s)
    return v


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError("PyYAML is needed to read a YAML config file or "
                           "dump one (-c / --dump-config); use --set "
                           "overrides without it") from e
    return yaml


def load(path: str | None = None, overrides: list | None = None) -> AppConfig:
    raw = copy.deepcopy(DEFAULTS)
    if path:
        with open(path) as f:
            user = _yaml().safe_load(f) or {}
        _deep_update(raw, user)
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        _set_dotted(raw, key.lstrip("-"), parse_scalar(val))
    c = raw["cell"]
    cell = CellConfig(
        nof_ports=int(c["nof_ports"]), nof_rb=int(c["nof_rb"]),
        dft_size=int(c["dft_size"]), numerology=int(c["numerology"]),
        cp=CyclicPrefix.NORMAL, center_freq_hz=float(c["center_freq_hz"]))
    t = raw["tdd"]
    tdd = TddPattern(periodicity_slots=int(t["periodicity_slots"]),
                     nof_dl_slots=int(t["nof_dl_slots"]),
                     nof_ul_slots=int(t["nof_ul_slots"]))
    ues = [TestUe(rnti=int(u["rnti"]), mcs_table=u.get("mcs_table", "qam64"),
                  mcs_index=int(u.get("mcs_index", 27)),
                  nof_layers_dl=int(u.get("nof_layers_dl", 1)),
                  nof_layers_ul=int(u.get("nof_layers_ul", 1)))
           for u in raw["ues"]]
    r = raw.get("run", {})
    return AppConfig(cell=cell, tdd=tdd, ues=ues,
                     phys_cell_id=int(raw.get("phys_cell_id", 1)),
                     nof_slots=int(r.get("nof_slots", 100)),
                     seed=int(r.get("seed", 0)),
                     channel_profile=str(r.get("channel_profile", "none")),
                     channel_sinr_db=float(r.get("channel_sinr_db", 25.0)),
                     trace_file=str(r.get("trace_file", "")),
                     mac=str(r.get("mac", "test")),
                     prach_period_slots=int(r.get("prach_period_slots", 0)),
                     resolve_lag=int(r.get("resolve_lag", 2)),
                     csi_period_slots=int(r.get("csi_period_slots", 20)))


def dump(cfg: AppConfig) -> str:
    """Round-trip config dump (gnb.cpp:307-309 analogue)."""
    return _yaml().safe_dump({
        "cell": {"nof_ports": cfg.cell.nof_ports, "nof_rb": cfg.cell.nof_rb,
                 "dft_size": cfg.cell.dft_size,
                 "numerology": cfg.cell.numerology,
                 "center_freq_hz": cfg.cell.center_freq_hz},
        "tdd": {"periodicity_slots": cfg.tdd.periodicity_slots,
                "nof_dl_slots": cfg.tdd.nof_dl_slots,
                "nof_ul_slots": cfg.tdd.nof_ul_slots},
        "ues": [{"rnti": u.rnti, "mcs_table": u.mcs_table,
                 "mcs_index": u.mcs_index} for u in cfg.ues],
        "run": {"nof_slots": cfg.nof_slots, "seed": cfg.seed,
                "channel_profile": cfg.channel_profile,
                "channel_sinr_db": cfg.channel_sinr_db,
                "csi_period_slots": cfg.csi_period_slots},
    })


def _deep_update(base: dict, upd: dict):
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v


def _set_dotted(d, dotted: str, value):
    keys = dotted.split(".")
    for k in keys[:-1]:
        if isinstance(d, list):
            d = d[int(k)]
        else:
            d = d.setdefault(k, {})
    if isinstance(d, list):
        d[int(keys[-1])] = value
    else:
        d[keys[-1]] = value
