"""Saturating int8 LLR type (the reference's log_likelihood_ratio).

Port of srsran_tpu/ops/llr.py: f32 LLRs quantize to int8 with the
reference's +-20 <-> +-120 mapping (round half to even, saturation at
+-127) and dequantize back; the decoders take f32, so an int8 path
dequantizes on entry (:func:`to_float`).

:func:`quantize` and :func:`dequantize` are the K35 wrappers: on CUDA
tensors one fused elementwise pass each (csrc/llr.cu, 16 LLRs a thread),
launched through a plan cached per (entry point, LLR count, device)
(``kernels/_build.py::Launch``), so a call allocates its output and makes
one C call; on CPU tensors their twins :func:`quantize_ref` /
:func:`dequantize_ref`.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..device import const, f32
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
THREADS = 256                 # csrc/llr.cu NT
VEC = 16                      # csrc/llr.cu kVec: LLRs a thread
CTAS_PER_SM = 4               # the grid's cap: CTAs per SM of the card


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


def _llr_params(n: int, sms: int) -> _build.LlrParams:
    """K35's launch for n LLRs on a card of ``sms`` SMs: a thread per 16,
    at most CTAS_PER_SM CTAs an SM (the grid strides over the rest)."""
    if n < 1 or sms < 1:
        raise ValueError(f"K35 takes at least one LLR and one SM, got "
                         f"{n} and {sms}")
    blocks = min(CTAS_PER_SM * sms, max(1, -(-(n // VEC) // THREADS)))
    return _build.LlrParams(n, _SCALE, blocks)


@functools.lru_cache(maxsize=256)
def _llr_plan(entry: str, n: int, index: int) -> _build.Launch:
    """K35's launch of ``entry`` (the quantize's or the dequantize's, which
    fixes the input's dtype) for n LLRs on CUDA device ``index``."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _build.Launch(entry, index, _llr_params(n, sms))


def quantize(llrs: torch.Tensor) -> torch.Tensor:
    """f32 [...] -> int8 [...] with the reference's +-20 range mapping."""
    if not llrs.is_cuda:
        return quantize_ref(llrs)
    if llrs.dtype != torch.float32:
        raise ValueError(f"llrs must be float32, got {llrs.dtype}")
    x = llrs if llrs.is_contiguous() else llrs.contiguous()
    out = torch.empty_like(x, dtype=torch.int8)     # contiguous, as x
    n = x.numel()
    if n:
        _llr_plan("srsran_llr_quantize", n, x.get_device())(
            x.data_ptr(), out.data_ptr())
        QUANTIZE.count()
    return out


def dequantize(llrs_i8: torch.Tensor) -> torch.Tensor:
    """int8 [...] -> f32 [...]."""
    if not llrs_i8.is_cuda:
        return dequantize_ref(llrs_i8)
    if llrs_i8.dtype != torch.int8:
        raise ValueError(f"llrs must be int8, got {llrs_i8.dtype}")
    q = llrs_i8 if llrs_i8.is_contiguous() else llrs_i8.contiguous()
    out = torch.empty_like(q, dtype=torch.float32)  # contiguous, as q
    n = q.numel()
    if n:
        _llr_plan("srsran_llr_dequantize", n, q.get_device())(
            q.data_ptr(), out.data_ptr())
        DEQUANTIZE.count()
    return out


def to_float(llrs: torch.Tensor) -> torch.Tensor:
    """Accept either representation: int8 dequantizes, any other type is
    cast to f32."""
    if llrs.dtype == torch.int8:
        return dequantize(llrs)
    return llrs.to(torch.float32)
