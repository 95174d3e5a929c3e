"""Amplitude control: scaling / hard clipping before the DAC (K31).

Port of srsran_tpu/phy/lower/amplitude_control.py (amplitude_controller_
{clipping,scaling}_impl, lib/phy/lower/amplitude_controller/): a gain,
optionally a hard clip of the magnitude at a ceiling, and the metrics of
amplitude_controller_metrics over the whole array (all ports): average
and peak power in dB, the PAPR and the share of clipped samples.

:func:`clip` and :func:`scale` run K31 on CUDA tensors (csrc/lower_phy.cu:
one pass writes the samples and per-CTA partials, a one-CTA launch
finishes the four metrics); on CPU tensors :func:`clip_ref`, the plain
twin.  Peak and clipped share equal the twin's; the average power differs
only by its sum order.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import kernels
from ...device import is_cuda
from ...kernels import _build

KERNEL = kernels.register(kernels.Kernel(
    name="amplitude_control", route="cuda",
    source="srsran_tpu_torch/csrc/lower_phy.cu",
    replaces="srsran_tpu/phy/lower/amplitude_control.py:30"))

MAX_BLOCKS = 1024            # csrc/lower_phy.cu


@dataclasses.dataclass
class AmplitudeMetrics:
    avg_power_db: torch.Tensor
    peak_power_db: torch.Tensor
    papr_db: torch.Tensor
    clipped_ratio: torch.Tensor


def _ceiling(ceiling_dbfs: float, full_scale: float) -> float:
    return full_scale * 10.0 ** (ceiling_dbfs / 20.0)


def clip_ref(samples: torch.Tensor, gain_db: float = 0.0,
             ceiling_dbfs: float = 0.0, full_scale: float = 1.0) -> tuple:
    """Plain twin of K31 with :func:`clip`'s arguments (``ceiling_dbfs``
    +inf: no clip, :func:`scale`'s twin): gain, clip, metrics."""
    ceiling = _ceiling(ceiling_dbfs, full_scale)
    g = 10.0 ** (gain_db / 20.0)
    x = torch.view_as_real(samples) * g
    mag = torch.abs(torch.view_as_complex(x.contiguous()))
    over = mag > ceiling
    # true divisions (PyTorch takes ``scalar / tensor`` as a reciprocal
    # times the scalar, and a CUDA mean as a sum times 1 / n: other
    # roundings)
    r = torch.full_like(mag, ceiling) / torch.clamp(mag, min=1e-12)
    x = torch.where(over[..., None], x * r[..., None], x)
    out = torch.view_as_complex(x.contiguous())
    p = torch.abs(out) ** 2
    avg = torch.clamp(torch.mean(p), min=1e-15)
    peak = torch.clamp(torch.max(p), min=1e-15)
    return out, AmplitudeMetrics(
        avg_power_db=10 * torch.log10(avg),
        peak_power_db=10 * torch.log10(peak),
        papr_db=10 * torch.log10(peak / avg),
        clipped_ratio=over.to(torch.float32).sum() / torch.full_like(
            avg, over.numel()))


def _amplitude(samples: torch.Tensor, gain_db: float, ceiling_dbfs: float,
               full_scale: float) -> tuple:
    if not is_cuda(samples):
        return clip_ref(samples, gain_db, ceiling_dbfs, full_scale)
    if samples.dtype != torch.complex64 or samples.numel() == 0:
        raise ValueError(f"samples must be non-empty complex64, got "
                         f"{samples.dtype} {tuple(samples.shape)}")
    x = samples.contiguous()
    dev = x.device
    y = torch.empty_like(x)
    part_sum = torch.empty(MAX_BLOCKS, dtype=torch.float64, device=dev)
    part_peak = torch.empty(MAX_BLOCKS, dtype=torch.float32, device=dev)
    part_count = torch.empty(MAX_BLOCKS, dtype=torch.int32, device=dev)
    metrics = torch.empty(4, dtype=torch.float32, device=dev)
    lib = _build.load()
    _build.check(lib.srsran_amplitude(
        _build.ptr(x), x.numel(), 10.0 ** (gain_db / 20.0),
        _ceiling(ceiling_dbfs, full_scale),
        _build.ptr(y), _build.ptr(part_sum), _build.ptr(part_peak),
        _build.ptr(part_count), _build.ptr(metrics), _build.stream_of(x)),
        "amplitude_control")
    KERNEL.count()
    return y, AmplitudeMetrics(*metrics.unbind())


def scale(samples: torch.Tensor, gain_db: float = 0.0) -> tuple:
    """samples * 10^(gain_db / 20) and its metrics (clipped_ratio 0)."""
    return _amplitude(samples, gain_db, float("inf"), 1.0)


def clip(samples: torch.Tensor, gain_db: float = 0.0,
         ceiling_dbfs: float = 0.0, full_scale: float = 1.0) -> tuple:
    """Scale then hard-clip the magnitude at the ceiling."""
    return _amplitude(samples, gain_db, ceiling_dbfs, full_scale)
