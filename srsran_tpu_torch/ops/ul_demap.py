"""Fused PUSCH equalize -> max-log demap -> descramble (the K3 wrapper).

The JAX package runs these as three device functions over the gathered
data REs (srsran_tpu/phy/upper/pusch.py::_frontend_hop with
ops/equalizer.py::equalize, ops/modulation.py::demodulate and
ops/scrambling.py::descramble_llrs).  On CUDA tensors the port runs them
as one per-RE kernel, csrc/pusch_demap.cu; on CPU tensors it runs
:func:`equalize_demap_descramble_ref`, the plain twin composed of the
port's plain front end (:func:`gather_equalize`, which
``pusch._frontend_hop`` also runs), demodulate and descramble_llrs.  On the card the kernel is
memory-bound (per RE it reads P samples and P*L coefficients and writes
L*Qm LLRs, about 3.5 MB at the flagship); its design is in the .cu file.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build
from .equalizer import equalize
from .gold import gold_sequence
from .modulation import BITS_PER_SYMBOL, demodulate, pam_levels_scaled
from .scrambling import descramble_llrs

KERNEL = kernels.register(kernels.Kernel(
    name="pusch_demap", route="cuda",
    source="srsran_tpu_torch/csrc/pusch_demap.cu",
    replaces="srsran_tpu/ops/equalizer.py:55"))


def gather_re(grid: torch.Tensor, coeffs: torch.Tensor, sym_idx: torch.Tensor,
              sc_idx: torch.Tensor, sc_off: int):
    """Data-RE gather: y [RE, P] from the grid [P, S, K] and h [RE, P, L]
    from the estimate [P, L, T, Ka] (T == 1: time-constant)."""
    y = grid[:, sym_idx, sc_idx].T
    sc_rel = sc_idx - sc_off
    if coeffs.shape[2] == 1:
        h = coeffs[:, :, 0, sc_rel]
    else:
        h = coeffs[:, :, sym_idx, sc_rel]
    return y, h.permute(2, 0, 1)


def gather_equalize(grid, coeffs, sym_idx, sc_idx, sc_off, noise_var,
                    nof_layers, method: str = "zf"):
    """Plain front end over the data REs: gather, then equalize with one
    noise variance for every RE.  Returns (x [RE, L], out_nv [RE, L])."""
    y, h = gather_re(grid, coeffs, sym_idx, sc_idx, sc_off)
    return equalize(y, h, noise_var.expand(y.shape[:1]), nof_layers, method)


def equalize_demap_descramble_ref(grid, coeffs, sym_idx, sc_idx, sc_off,
                                  noise_var, c_init, modulation, nof_layers):
    """Plain twin of :func:`equalize_demap_descramble`."""
    x, out_nv = gather_equalize(grid, coeffs, sym_idx, sc_idx, sc_off,
                                noise_var, nof_layers)
    llr = demodulate(x.reshape(-1)[None], out_nv.reshape(-1)[None],
                     modulation)[0]
    return descramble_llrs(llr, c_init), x


def equalize_demap_descramble(grid: torch.Tensor, coeffs: torch.Tensor,
                              sym_idx: torch.Tensor, sc_idx: torch.Tensor,
                              sc_off: int, noise_var: torch.Tensor,
                              c_init: int, modulation: str, nof_layers: int):
    """Codeword LLRs of a PUSCH's data REs.

    grid complex64 [P, S, K]; coeffs complex64 [P, L, T, Ka] (Ka subcarriers
    from ``sc_off``); sym_idx / sc_idx int [RE] data-RE plan; noise_var f32
    scalar tensor (the mean estimator noise).  Returns (descrambled LLRs f32
    [RE*L*Qm] in codeword order, equalized symbols complex64 [RE, L]).
    """
    if not is_cuda(grid, coeffs, noise_var):
        return equalize_demap_descramble_ref(grid, coeffs, sym_idx, sc_idx,
                                             sc_off, noise_var, c_init,
                                             modulation, nof_layers)
    qm = BITS_PER_SYMBOL[modulation]
    if modulation not in ("qpsk", "qam16", "qam64", "qam256"):
        raise NotImplementedError(f"{modulation} demap on the card")
    if nof_layers not in (1, 2) or coeffs.shape[1] != nof_layers:
        raise ValueError(f"{nof_layers} layers vs coeffs {tuple(coeffs.shape)}")
    if grid.dtype != torch.complex64 or coeffs.dtype != torch.complex64:
        raise ValueError("grid and coeffs must be complex64")
    if noise_var.numel() != 1 or noise_var.dtype != torch.float32:
        raise ValueError("noise_var must be one float32 value")
    dev = grid.device
    lib = _build.load()
    p, s, k = grid.shape
    _, _, t, ka = coeffs.shape
    nre = sym_idx.shape[0]
    sym = sym_idx.to(torch.int32).contiguous()
    sc = sc_idx.to(torch.int32).contiguous()
    levels = const(pam_levels_scaled, modulation, device=dev)
    seq = gold_sequence(c_init, nre * nof_layers * qm, 0, device=dev)
    g = torch.view_as_real(grid.contiguous())
    h = torch.view_as_real(coeffs.contiguous())
    nv = noise_var.reshape(1).contiguous()
    llr = torch.empty(nre * nof_layers * qm, dtype=torch.float32, device=dev)
    x = torch.empty((nre, nof_layers), dtype=torch.complex64, device=dev)
    _build.check(lib.srsran_pusch_demap(
        _build.ptr(g), _build.ptr(h), _build.ptr(sym), _build.ptr(sc), nre,
        p, s, k, nof_layers, t, ka, sc_off, _build.ptr(nv), _build.ptr(levels),
        qm // 2, _build.ptr(seq), _build.ptr(llr), _build.ptr(x),
        _build.stream_of(grid)), "pusch_demap")
    KERNEL.count()
    return llr, x
