"""Baseband carrier-frequency-offset processor (K30).

Port of srsran_tpu/phy/lower/cfo.py (baseband_cfo_processor /
lower_phy_cfo_controller, lib/phy/lower/processors/
baseband_cfo_processor.h): scheduled CFO commands (value + drift,
effective from a given time) applied to baseband sample blocks as a
complex phase ramp.  The command queue and drift bookkeeping are host
Python, copied as they are -- including ``next_command`` resetting the
block's sample offset to 0 on every call (JAX cfo.py:50), so a caller that
calls it once per block restarts the phase at each block (ROADMAP §3).

:func:`apply_cfo` is the K30 wrapper: on CUDA tensors one launch of
csrc/lower_phy.cu (a thread per sample, theta = f32(2 pi c) f32(n +
offset) as JAX forms it, precise sincosf); on CPU tensors
:func:`apply_cfo_ref`, the plain twin (the complex product as separate
real operations, each rounded as the kernel rounds it).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ... import kernels
from ...device import is_cuda
from ...kernels import _build

KERNEL = kernels.register(kernels.Kernel(
    name="cfo_rotate", route="cuda",
    source="srsran_tpu_torch/csrc/lower_phy.cu",
    replaces="srsran_tpu/phy/lower/cfo.py:19"))


def _omega(cfo_norm: float) -> float:
    """f32(2 pi cfo_norm), the product taken in double and rounded once
    (JAX's ``2j * jnp.pi * cfo_norm`` is a Python complex)."""
    return float(np.float32(2.0 * math.pi * float(cfo_norm)))


def apply_cfo_ref(samples: torch.Tensor, cfo_norm: float,
                  sample_offset: int = 0) -> torch.Tensor:
    """Plain twin of :func:`apply_cfo`."""
    n = (torch.arange(samples.shape[-1], device=samples.device,
                      dtype=torch.int64) + int(sample_offset)).to(torch.float32)
    theta = _omega(cfo_norm) * n
    c, s = torch.cos(theta), torch.sin(theta)
    x = torch.view_as_real(samples)
    re, im = x[..., 0], x[..., 1]
    return torch.complex(re * c - im * s, re * s + im * c)


def apply_cfo(samples: torch.Tensor, cfo_norm: float,
              sample_offset: int = 0) -> torch.Tensor:
    """Rotate samples complex64 [..., T] by exp(+j 2 pi cfo_norm (n +
    offset)); cfo_norm = cfo_Hz / sample_rate."""
    if not is_cuda(samples):
        return apply_cfo_ref(samples, cfo_norm, sample_offset)
    if samples.dtype != torch.complex64 or samples.numel() == 0:
        raise ValueError(f"samples must be non-empty complex64, got "
                         f"{samples.dtype} {tuple(samples.shape)}")
    x = samples.contiguous()
    y = torch.empty_like(x)
    lib = _build.load()
    _build.check(lib.srsran_cfo(
        _build.ptr(x), x.numel(), x.shape[-1], _omega(cfo_norm),
        int(sample_offset), _build.ptr(y), _build.stream_of(x)), "cfo_rotate")
    KERNEL.count()
    return y


@dataclasses.dataclass
class CfoCommand:
    time_s: float            # absolute time the command takes effect
    cfo_hz: float
    cfo_drift_hz_s: float = 0.0


class CfoProcessor:
    """Host-side controller: command queue + per-block phase continuity."""

    def __init__(self, sample_rate_hz: float):
        self.srate = float(sample_rate_hz)
        self._queue: list = []
        self._cfo_hz = 0.0
        self._drift = 0.0
        self._cfo_start_s = 0.0
        self._sample_offset = 0

    def schedule(self, cmd: CfoCommand) -> bool:
        self._queue.append(cmd)
        return True

    def next_command(self, now_s: float) -> None:
        """Per-block update (baseband_cfo_processor::next_cfo_command)."""
        self._sample_offset = 0
        if self._queue and now_s >= self._queue[0].time_s:
            cmd = self._queue.pop(0)
            self._cfo_hz = cmd.cfo_hz
            self._drift = cmd.cfo_drift_hz_s
            self._cfo_start_s = cmd.time_s
        if self._drift:
            self._cfo_hz = (self._cfo_hz
                            + self._drift * (now_s - self._cfo_start_s))
            self._cfo_start_s = now_s

    @property
    def cfo_norm(self) -> float:
        return self._cfo_hz / self.srate

    def process(self, samples: torch.Tensor) -> torch.Tensor:
        """Apply the current CFO to one block, advancing the sample phase."""
        if self._cfo_hz == 0.0:
            self._sample_offset += samples.shape[-1]
            return samples
        out = apply_cfo(samples, self.cfo_norm, self._sample_offset)
        self._sample_offset += samples.shape[-1]
        return out
