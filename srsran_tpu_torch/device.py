"""Device policy: explicit devices, no global default, per-device constants.

Every entry point takes its device from the tensors it is given.  Host-built
constants (index plans, sequences, matrices) are uploaded once per
(function, arguments, device) and reused, so a steady-state slot makes no
host-to-device copy of its own.
"""

from __future__ import annotations

import collections
import dataclasses
import subprocess
from typing import Callable

import numpy as np
import torch


def require_cuda() -> torch.device:
    """The current CUDA device; raises when no GPU is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "srsran_tpu_torch: no CUDA device is visible (torch "
            f"{torch.__version__}, torch.version.cuda={torch.version.cuda}); "
            "the hand kernels need an NVIDIA GPU with sm_90a (Hopper)")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device) -> torch.device:
    """``device`` as a torch.device, a CUDA device with its index (the
    current one when the caller named none), so that devices compare."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def card_line() -> str:
    """The first GPU's name and power limit, as ``nvidia-smi`` prints them
    (a card may be set below its maximum power and then runs slower)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def is_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when all lie on
    the CPU; raises on a mix (a kernel never takes half its inputs from
    the host)."""
    if all(t.is_cuda for t in tensors):
        return True
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")


def stack_slots(outs: list):
    """Per-slot results of a plain twin run slot by slot (tensors, or
    tuples, dicts or dataclasses of them) stacked on a leading slot axis."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, dict):
        return {k: stack_slots([o[k] for o in outs]) for k in first}
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: stack_slots([getattr(o, f.name)
                                                   for o in outs])
                              for f in dataclasses.fields(first)})
    return tuple(stack_slots(list(z)) for z in zip(*outs))


def slot_of(t: torch.Tensor, b: int, ndim: int) -> torch.Tensor:
    """Slot ``b`` of a slot-context tensor whose own rank is ``ndim``: its
    row b where it carries a leading slot axis, else the shared tensor."""
    return t[b] if t.ndim > ndim else t


_CONSTS_MAX = 4096
_consts: collections.OrderedDict = collections.OrderedDict()


def i64(values: tuple) -> np.ndarray:
    """For :func:`const`: a tuple as an int64 array."""
    return np.asarray(values, dtype=np.int64)


def f32(values: tuple) -> np.ndarray:
    """For :func:`const`: a tuple as a float32 array."""
    return np.asarray(values, dtype=np.float32)


def const(make: Callable, *args, device: torch.device,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """``make(*args)`` (a host numpy array) as a tensor on ``device``,
    made and uploaded once per (make, args, dtype, device).

    ``make`` must be a deterministic function of its hashable args.
    The cache is bounded (least recently used entries go first).
    """
    key = (make.__module__, make.__qualname__, args, dtype,
           str(torch.device(device)))
    t = _consts.get(key)
    if t is None:
        arr = make(*args)
        t = torch.from_numpy(np.array(arr))
        if dtype is not None:
            t = t.to(dtype)
        t = t.to(device)
        _consts[key] = t
        if len(_consts) > _CONSTS_MAX:
            _consts.popitem(last=False)
    else:
        _consts.move_to_end(key)
    return t
