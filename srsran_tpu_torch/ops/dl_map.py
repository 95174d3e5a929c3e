"""PDSCH map: rate match -> scramble -> modulate -> layer map -> precode ->
grid add (the K6 wrapper), the DL counterpart of ops/ul_demap.py.

The JAX package runs these as separate device functions after the LDPC
encoder (srsran_tpu/phy/upper/pdsch.py::process with
ops/ldpc_rate_match.py::rate_match_batch, ops/scrambling.py::scramble_bits,
ops/modulation.py::modulate, ops/precoding.py::layer_map / precode and the
grid scatter-add).  On CUDA tensors the port runs them as one per-RE
kernel, csrc/pdsch_map.cu, reading the encoded codeblocks of K5
(ops/ldpc_encode.py::dlsch_encode); on CPU tensors it runs
:func:`pdsch_map_ref`, the plain twin composed of those plain ops.  On the
card the kernel is bound by the latency of its bit gathers (L*Qm per RE)
and the grid read-modify-write; its design is in the .cu file.

K22 is the same kernel with a table of per-PRG precoders (JAX
ops/precoding.py::precode_prg): each RE takes its PRG's matrix, the PRG
computed in the kernel from the RE's subcarrier.  It is counted apart
(``pdsch_map_prg``) so that a run shows the per-PRG form launched; in a
slot batch both forms count as ``pdsch_map_batch``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..device import const, is_cuda
from ..kernels import _build
from .gold import gold_sequence_np
from .ldpc_rate_match import _window_plan, rate_match_batch_ref
from .modulation import BITS_PER_SYMBOL, modulate, pam_levels_scaled
from .precoding import layer_map, precode, precode_prg
from .scrambling import scramble_bits

KERNEL = kernels.register(kernels.Kernel(
    name="pdsch_map", route="cuda",
    source="srsran_tpu_torch/csrc/pdsch_map.cu",
    replaces="srsran_tpu/ops/ldpc_rate_match.py:132"))
KERNEL_BATCH = kernels.batched(KERNEL)
KERNEL_PRG = kernels.register(kernels.Kernel(
    name="pdsch_map_prg", route="cuda",
    source="srsran_tpu_torch/csrc/pdsch_map.cu",
    replaces="srsran_tpu/ops/precoding.py:38"))

_MAX_LAYERS = 4


def pdsch_map_ref(grid, cbs, e_sizes, rv, modulation, base_graph, z, k_prime,
                  k, c_init, nof_layers, sym_idx, sc_idx, precoder,
                  prg_size: int = 0, rb_start: int = 0, n_ref: int = 0):
    """Plain twin of :func:`pdsch_map` (a slot axis runs slot by slot)."""
    if grid.ndim == 4:
        per_slot = precoder.ndim == (4 if prg_size else 3)
        for b in range(grid.shape[0]):
            pdsch_map_ref(grid[b], cbs[b], e_sizes, rv, modulation,
                          base_graph, z, k_prime, k, c_init, nof_layers,
                          sym_idx, sc_idx, precoder[b] if per_slot else precoder,
                          prg_size, rb_start, n_ref)
        return grid
    qm = BITS_PER_SYMBOL[modulation]
    codeword = rate_match_batch_ref(cbs, e_sizes, rv, qm, base_graph, z,
                                    k_prime, k, n_ref)                          # [G]
    scrambled = scramble_bits(codeword[None], c_init)
    symbols = modulate(scrambled, modulation)                     # [1, S]
    layers = layer_map(symbols[0], nof_layers)                    # [L, S/L]
    if prg_size:
        prg = prg_index_of_sc(sc_idx, rb_start, prg_size)
        grid[:, sym_idx, sc_idx] += precode_prg(layers, precoder, prg)
    else:
        grid[:, sym_idx, sc_idx] += precode(layers, precoder)     # [P, S/L]
    return grid


def prg_index_of_sc(sc, rb_start: int, prg_size: int):
    """Per-subcarrier PRG index (into the PDU's pm_indices), PRG boundaries
    aligned to CRB 0 (TS38.214 §5.1.2.3; JAX pdsch.py:191-195)."""
    return sc // 12 // prg_size - rb_start // prg_size


def _gold_words(c_init: int, length: int) -> np.ndarray:
    """Gold bits c(0 .. length) packed LSB first into int32 words."""
    bits = gold_sequence_np(c_init, length)
    packed = np.packbits(bits, bitorder="little")
    packed = np.concatenate([packed, np.zeros(-len(packed) % 4, np.uint8)])
    return packed.view("<u4").view(np.int32)


def _cb_bounds(e_sizes: tuple) -> np.ndarray:
    """int64 [C + 1]: each codeblock's first codeword bit, then G."""
    return np.concatenate([[0], np.cumsum(e_sizes)]).astype(np.int64)


def pdsch_map(grid: torch.Tensor, cbs: torch.Tensor, e_sizes, rv: int,
              modulation: str, base_graph: int, z: int, k_prime: int, k: int,
              c_init: int, nof_layers: int, sym_idx: torch.Tensor,
              sc_idx: torch.Tensor, precoder: torch.Tensor,
              prg_size: int = 0, rb_start: int = 0,
              n_ref: int = 0) -> torch.Tensor:
    """Add one codeword's PDSCH data REs to the grid (in place).

    grid complex64 [P, S, K]; cbs int8 [C, N] encoded codeblocks (2Z
    punctured bits dropped); e_sizes the C rate-matched lengths (multiples
    of nof_layers * Qm); sym_idx / sc_idx int [RE] data-RE plan; precoder
    complex64 [P, L] on the grid's device.  Returns the grid.  With a slot
    axis -- grid [B, P, S, K], cbs [B, C, N] -- one launch maps every slot
    (the RE plan shared; the precoder shared or one per slot, [B, ...]).

    Per-PRG precoding (K22): ``prg_size`` > 0 and ``precoder`` a table
    [G, P, L] of the allocation's PRGs, from the one holding PRB
    ``rb_start`` (the first allocated PRB); the caller checks that G
    covers the allocation.  ``n_ref`` > 0 cuts the circular buffer at
    min(n_ref, N) (limited-buffer rate matching).
    """
    if not is_cuda(grid, cbs, sym_idx, sc_idx, precoder):
        return pdsch_map_ref(grid, cbs, e_sizes, rv, modulation, base_graph,
                             z, k_prime, k, c_init, nof_layers, sym_idx,
                             sc_idx, precoder, prg_size, rb_start, n_ref)
    qm = BITS_PER_SYMBOL[modulation]
    if modulation not in ("qpsk", "qam16", "qam64", "qam256"):
        raise NotImplementedError(f"{modulation} PDSCH map on the card")
    e_sizes = tuple(int(e) for e in e_sizes)
    c, n = cbs.shape[-2:]
    lead = tuple(grid.shape[:-3])
    nre = sym_idx.shape[0]
    if not 1 <= nof_layers <= _MAX_LAYERS:
        raise ValueError(f"{nof_layers} layers (the kernel takes 1..4)")
    if (len(e_sizes) != c or any(e % (qm * nof_layers) for e in e_sizes)
            or sum(e_sizes) != nre * nof_layers * qm):
        raise ValueError(f"E sizes {e_sizes} vs C={c}, {nre} REs, "
                         f"{nof_layers} layers, Qm={qm}")
    if cbs.dtype != torch.int8 or grid.dtype != torch.complex64:
        raise ValueError("cbs must be int8 and the grid complex64")
    table = 1 if prg_size else 0              # the [G] axis of a PRG table
    w_lead = tuple(precoder.shape[:precoder.ndim - 2 - table])
    if (grid.ndim not in (3, 4) or tuple(cbs.shape[:-2]) != lead
            or precoder.shape[-2:] != (grid.shape[-3], nof_layers)
            or w_lead not in ((), lead) or prg_size < 0
            or precoder.ndim < 2 + table):
        raise ValueError(f"grid {tuple(grid.shape)} / precoder "
                         f"{tuple(precoder.shape)} vs {nof_layers} layers, "
                         f"PRG size {prg_size}")
    if (sym_idx.dtype != torch.int32 or sc_idx.dtype != torch.int32
            or not grid.is_contiguous()):
        raise ValueError("the RE plan must be int32 and the grid contiguous")
    fs, fe, n_nf, k0p = _window_plan(rv, base_graph, z, k_prime, k, n, n_ref)
    dev = grid.device
    lib = _build.load()
    bounds = const(_cb_bounds, e_sizes, device=dev)
    gold = const(_gold_words, int(c_init), sum(e_sizes), device=dev)
    levels = const(pam_levels_scaled, modulation, device=dev)
    cbs = cbs.contiguous()
    w = torch.view_as_real(precoder.to(torch.complex64).contiguous())
    w_stride = precoder[0].numel() if w_lead else 0     # complex per slot
    p, s, kk = grid.shape[-3:]
    _build.check(lib.srsran_pdsch_map(
        _build.ptr(cbs), n, _build.ptr(bounds), c, fs, fe, n_nf, k0p,
        _build.ptr(gold), _build.ptr(levels), qm, _build.ptr(sym_idx),
        _build.ptr(sc_idx), nre, nof_layers, _build.ptr(w), p, prg_size,
        rb_start // prg_size if prg_size else 0, w_stride,
        _build.ptr(torch.view_as_real(grid)), s, kk, lead[0] if lead else 1,
        _build.stream_of(grid)), "pdsch_map")
    # a slot batch counts as the batched K6 whichever its precoder
    (KERNEL_BATCH if lead else KERNEL_PRG if prg_size else KERNEL).count()
    return grid
