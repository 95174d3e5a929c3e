"""Saturating int8 LLR type (the reference's log_likelihood_ratio).

Port of srsran_tpu/ops/llr.py: f32 LLRs quantize to int8 with the
reference's +-20 <-> +-120 mapping (round half to even, saturation at
+-127) and dequantize back; the decoders take f32, so an int8 path
dequantizes on entry (:func:`to_float`).

:func:`quantize` and :func:`dequantize` are the K35 wrappers: on CUDA
tensors one fused elementwise pass each (csrc/llr.cu), on CPU tensors
their twins :func:`quantize_ref` / :func:`dequantize_ref`.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..device import const, f32, is_cuda
from ..kernels import _build

QUANTIZE = kernels.register(kernels.Kernel(
    name="llr_quantize", route="cuda", source="srsran_tpu_torch/csrc/llr.cu",
    replaces="srsran_tpu/ops/llr.py:21"))
DEQUANTIZE = kernels.register(kernels.Kernel(
    name="llr_dequantize", route="cuda", source="srsran_tpu_torch/csrc/llr.cu",
    replaces="srsran_tpu/ops/llr.py:27"))

LLR_RANGE = 20.0
LLR_INT_MAX = 120  # +-120 used, +-127 reserved for saturation semantics
_SCALE = LLR_INT_MAX / LLR_RANGE


def quantize_ref(llrs: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`quantize`."""
    return torch.clamp(torch.round(llrs.to(torch.float32) * _SCALE),
                       -127, 127).to(torch.int8)


def dequantize_ref(llrs_i8: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`dequantize`.  The divisor is a device tensor:
    PyTorch turns division by a Python scalar into a multiply by its
    reciprocal, which rounds differently from the JAX package's division."""
    scale = const(f32, (_SCALE,), device=llrs_i8.device)[0]
    return llrs_i8.to(torch.float32) / scale


def quantize(llrs: torch.Tensor) -> torch.Tensor:
    """f32 [...] -> int8 [...] with the reference's +-20 range mapping."""
    if not is_cuda(llrs):
        return quantize_ref(llrs)
    if llrs.dtype != torch.float32:
        raise ValueError(f"llrs must be float32, got {llrs.dtype}")
    x = llrs.contiguous()
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        _build.check(_build.load().srsran_llr_quantize(
            _build.ptr(x), x.numel(), _SCALE, _build.ptr(out),
            _build.stream_of(x)), "llr_quantize")
        QUANTIZE.count()
    return out


def dequantize(llrs_i8: torch.Tensor) -> torch.Tensor:
    """int8 [...] -> f32 [...]."""
    if not is_cuda(llrs_i8):
        return dequantize_ref(llrs_i8)
    if llrs_i8.dtype != torch.int8:
        raise ValueError(f"llrs must be int8, got {llrs_i8.dtype}")
    q = llrs_i8.contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel():
        _build.check(_build.load().srsran_llr_dequantize(
            _build.ptr(q), q.numel(), _SCALE, _build.ptr(out),
            _build.stream_of(q)), "llr_dequantize")
        DEQUANTIZE.count()
    return out


def to_float(llrs: torch.Tensor) -> torch.Tensor:
    """Accept either representation: int8 dequantizes, any other type is
    cast to f32."""
    if llrs.dtype == torch.int8:
        return dequantize(llrs)
    return llrs.to(torch.float32)
