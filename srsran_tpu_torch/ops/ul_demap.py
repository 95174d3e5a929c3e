"""Fused PUSCH equalize -> max-log demap -> descramble (the K3 and K16
wrappers).

The JAX package runs these as three device functions over the gathered
data REs (srsran_tpu/phy/upper/pusch.py::_frontend_hop with
ops/equalizer.py::equalize, ops/modulation.py::demodulate and
ops/scrambling.py::descramble_llrs).  On CUDA tensors the port runs them
as one per-RE kernel: K3 (csrc/pusch_demap.cu) for ZF with 1-2 layers,
K16 (csrc/pusch_demap_lxn.cu) for MMSE and for 3-4 layers.  On CPU
tensors it runs :func:`equalize_demap_descramble_ref`, the plain twin of
both, composed of the port's plain front end (:func:`gather_equalize`,
which ``pusch._frontend_hop`` also runs), demodulate and descramble_llrs.
On the card both kernels are memory-bound (per RE they read P samples and
P*L coefficients and write L*Qm LLRs, 3.5-4.6 MB at the flagship shapes);
their designs are in the .cu files.

A leading slot axis on the grid, the coefficients and the noise variance
(the slot-batch mode) runs K3 once for every slot; K16 runs once per slot
(its batched form is still to come, ROADMAP §2 item 12), and the twin runs
slot by slot.  The RE plan and the Gold bits are shared.
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
KERNEL_LXN = kernels.register(kernels.Kernel(
    name="pusch_demap_lxn", route="cuda",
    source="srsran_tpu_torch/csrc/pusch_demap_lxn.cu",
    replaces="srsran_tpu/ops/equalizer.py:83"))
KERNEL_BATCH = kernels.batched(KERNEL)


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


def _per_slot(fn, grid, coeffs, sym_idx, sc_idx, sc_off, noise_var, *rest):
    """fn over each slot of a slot axis, its (llr, x) stacked."""
    outs = [fn(grid[b], coeffs[b], sym_idx, sc_idx, sc_off, noise_var[b],
               *rest) for b in range(grid.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def equalize_demap_descramble_ref(grid, coeffs, sym_idx, sc_idx, sc_off,
                                  noise_var, c_init, modulation, nof_layers,
                                  method: str = "zf"):
    """Plain twin of :func:`equalize_demap_descramble` and
    :func:`equalize_demap_descramble_lxn`."""
    if grid.ndim == 4:
        return _per_slot(equalize_demap_descramble_ref, grid, coeffs, sym_idx,
                         sc_idx, sc_off, noise_var, c_init, modulation,
                         nof_layers, method)
    x, out_nv = gather_equalize(grid, coeffs, sym_idx, sc_idx, sc_off,
                                noise_var, nof_layers, method)
    llr = demodulate(x.reshape(-1)[None], out_nv.reshape(-1)[None],
                     modulation)[0]
    return descramble_llrs(llr, c_init), x


def _check_args(grid, coeffs, noise_var, modulation, nof_layers):
    if modulation not in ("qpsk", "qam16", "qam64", "qam256"):
        raise NotImplementedError(f"{modulation} demap on the card")
    if not 1 <= nof_layers <= 4 or coeffs.shape[-3] != nof_layers:
        raise ValueError(f"{nof_layers} layers vs coeffs {tuple(coeffs.shape)}")
    if grid.dtype != torch.complex64 or coeffs.dtype != torch.complex64:
        raise ValueError("grid and coeffs must be complex64")
    lead = grid.shape[:-3]
    if (noise_var.shape not in (((lead[0],),) if lead else ((), (1,)))
            or noise_var.dtype != torch.float32 or coeffs.shape[:-4] != lead):
        raise ValueError(f"noise_var must be one float32 value per slot, "
                         f"got {tuple(noise_var.shape)} for grid "
                         f"{tuple(grid.shape)}")


def _launch(entry, extra: tuple, grid, coeffs, sym_idx, sc_idx, sc_off,
            noise_var, c_init, modulation, nof_layers, slots: tuple = ()):
    """Launch K3 or K16 (same inputs and outputs; K16 takes the method
    flag in ``extra``, K3 the slot count in ``slots``).  Returns (llr, x),
    with the grid's slot axis (K3 only) in front.  The RE plan is int32, as
    the PUSCH uploads it."""
    qm = BITS_PER_SYMBOL[modulation]
    dev = grid.device
    p, s, k = grid.shape[-3:]
    t, ka = coeffs.shape[-2:]
    nre = sym_idx.shape[0]
    if sym_idx.dtype != torch.int32 or sc_idx.dtype != torch.int32:
        raise ValueError("the RE plan must be int32")
    lead = tuple(grid.shape[:-3])
    levels = const(pam_levels_scaled, modulation, device=dev)
    seq = gold_sequence(c_init, nre * nof_layers * qm, 0, device=dev)
    g = torch.view_as_real(grid.contiguous())
    h = torch.view_as_real(coeffs.contiguous())
    nv = noise_var.reshape(-1).contiguous()
    llr = torch.empty(lead + (nre * nof_layers * qm,), dtype=torch.float32,
                      device=dev)
    x = torch.empty(lead + (nre, nof_layers), dtype=torch.complex64,
                    device=dev)
    _build.check(entry(
        _build.ptr(g), _build.ptr(h), _build.ptr(sym_idx.contiguous()),
        _build.ptr(sc_idx.contiguous()), nre, p, s, k, nof_layers, t, ka,
        sc_off, _build.ptr(nv), _build.ptr(levels), qm // 2, *extra,
        _build.ptr(seq), _build.ptr(llr), _build.ptr(x), *slots,
        _build.stream_of(grid)), entry.__name__)
    return llr, x


def equalize_demap_descramble(grid: torch.Tensor, coeffs: torch.Tensor,
                              sym_idx: torch.Tensor, sc_idx: torch.Tensor,
                              sc_off: int, noise_var: torch.Tensor,
                              c_init: int, modulation: str, nof_layers: int,
                              method: str = "zf"):
    """Codeword LLRs of a PUSCH's data REs.

    grid complex64 [P, S, K]; coeffs complex64 [P, L, T, Ka] (Ka subcarriers
    from ``sc_off``); sym_idx / sc_idx int32 [RE] data-RE plan (int on the
    CPU); noise_var f32 scalar tensor (the mean estimator noise); method
    "zf" or "mmse".  Returns (descrambled LLRs f32 [RE*L*Qm] in codeword
    order, equalized symbols complex64 [RE, L]).  With a slot axis -- grid
    [B, P, S, K], coeffs [B, P, L, T, Ka], noise_var [B] -- the outputs
    are [B, RE*L*Qm] and [B, RE, L].  On the card: K3 for ZF with 1-2
    layers (one launch for all slots), K16 otherwise.
    """
    args = (grid, coeffs, sym_idx, sc_idx, sc_off, noise_var, c_init,
            modulation, nof_layers)
    if not is_cuda(grid, coeffs, noise_var):
        return equalize_demap_descramble_ref(*args, method)
    if method == "zf" and nof_layers <= 2:
        _check_args(grid, coeffs, noise_var, modulation, nof_layers)
        slots = grid.shape[0] if grid.ndim == 4 else 1
        out = _launch(_build.load().srsran_pusch_demap, (), *args,
                      slots=(slots,))
        (KERNEL_BATCH if grid.ndim == 4 else KERNEL).count()
        return out
    if grid.ndim == 4:
        return _per_slot(equalize_demap_descramble_lxn, *args, method)
    return equalize_demap_descramble_lxn(*args, method)


def equalize_demap_descramble_lxn(grid: torch.Tensor, coeffs: torch.Tensor,
                                  sym_idx: torch.Tensor, sc_idx: torch.Tensor,
                                  sc_off: int, noise_var: torch.Tensor,
                                  c_init: int, modulation: str,
                                  nof_layers: int, method: str = "mmse"):
    """:func:`equalize_demap_descramble` through K16 for 1-4 layers, ZF or
    MMSE (the L x N solve of the JAX package's ``equalize``)."""
    args = (grid, coeffs, sym_idx, sc_idx, sc_off, noise_var, c_init,
            modulation, nof_layers)
    if not is_cuda(grid, coeffs, noise_var):
        return equalize_demap_descramble_ref(*args, method)
    if method not in ("zf", "mmse"):
        raise ValueError(f"equalizer {method!r}")
    _check_args(grid, coeffs, noise_var, modulation, nof_layers)
    if grid.ndim != 3:
        raise ValueError("K16 takes one slot's grid [P, S, K]")
    out = _launch(_build.load().srsran_pusch_demap_lxn,
                  (int(method == "mmse"),), *args)
    KERNEL_LXN.count()
    return out
