"""PDSCH map: rate match -> scramble -> modulate -> layer map -> precode ->
grid add (the K6 wrapper), the DL counterpart of ops/ul_demap.py.

The JAX package runs these as separate device functions after the LDPC
encoder (srsran_tpu/phy/upper/pdsch.py::process with
ops/ldpc_rate_match.py::rate_match_batch, ops/scrambling.py::scramble_bits,
ops/modulation.py::modulate, ops/precoding.py::layer_map / precode and the
grid scatter-add).  On CUDA tensors the port runs them as one kernel,
csrc/pdsch_map.cu, reading the encoded codeblocks of K5
(ops/ldpc_encode.py::dlsch_encode); on CPU tensors it runs
:func:`pdsch_map_ref`, the plain twin composed of those plain ops.  The
kernel takes tiles of one codeblock's REs, a CTA each, whose bit planes it
stages into shared memory as contiguous runs of the circular buffer; its
design is in the .cu file.  It launches through
``kernels/_build.py::Launch``: one plan per call signature
(:func:`_map_plan`, holding the parameters -- from :func:`_map_params`,
testable on the CPU: the codeblock sizes as two runs of equal E, the
tiles, the window and the level table by value -- and the codeword's Gold
bits packed 32 a word), so a call makes one ctypes call, the RE plan and
the precoder passed by pointer.

K22 is the same kernel with a table of per-PRG precoders (JAX
ops/precoding.py::precode_prg): each RE takes its PRG's matrix, the PRG
computed in the kernel from the RE's subcarrier.  It is counted apart
(``pdsch_map_prg``) so that a run shows the per-PRG form launched; in a
slot batch both forms count as ``pdsch_map_batch``.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import kernels
from ..device import is_cuda
from ..kernels import _build
from .gold import gold_words
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

MAP_THREADS = 128          # csrc/pdsch_map.cu kMapThreads: REs a tile
MAP_MAX_LAYERS = 4         # kMapMaxLayers
MAP_MAX_PORTS = 8          # kMapMaxPorts


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
    launch, counter = _map_plan(
        (grid.shape, cbs.shape, sym_idx.shape, sc_idx.shape, precoder.shape),
        (grid.dtype, cbs.dtype, sym_idx.dtype, sc_idx.dtype, precoder.dtype),
        tuple(e_sizes), rv, modulation, base_graph, z, k_prime, k, c_init,
        nof_layers, prg_size, rb_start, n_ref, grid.get_device())
    if launch is None:                  # no data RE: nothing to map
        return grid
    if not grid.is_contiguous():
        raise ValueError("the grid must be contiguous (K6 adds into it)")
    # the kernel's inputs held in locals until it is enqueued
    cw = cbs if cbs.is_contiguous() else cbs.contiguous()
    sym = sym_idx if sym_idx.is_contiguous() else sym_idx.contiguous()
    sc = sc_idx if sc_idx.is_contiguous() else sc_idx.contiguous()
    w = precoder if precoder.is_contiguous() else precoder.contiguous()
    launch(cw.data_ptr(), sym.data_ptr(), sc.data_ptr(), w.data_ptr(),
           grid.data_ptr())
    counter.count()
    return grid


def _two_runs(e_sizes: tuple) -> tuple:
    """(C0, E0, E1): the codeblock sizes as C0 blocks of E0 then C - C0 of
    E1, the form TS 38.212 §5.4.2.1 gives; raises on any other."""
    e0 = e_sizes[0]
    c0 = next((j for j, e in enumerate(e_sizes) if e != e0), len(e_sizes))
    e1 = e_sizes[c0] if c0 < len(e_sizes) else e0
    if any(e != e1 for e in e_sizes[c0:]):
        raise ValueError(f"E sizes {e_sizes}: K6 takes two runs of equal E "
                         f"(C0 codeblocks of E0, then E1), as TS 38.212 "
                         f"5.4.2.1 gives them")
    return c0, e0, e1


def _map_params(shapes: tuple, dtypes: tuple, e_sizes: tuple, rv: int,
                modulation: str, base_graph: int, z: int, k_prime: int,
                k: int, nof_layers: int, prg_size: int, rb_start: int,
                n_ref: int) -> _build.MapParams:
    """K6's (K22's) parameters for one call signature: the shapes and
    dtypes of (grid, cbs, sym_idx, sc_idx, precoder) and the codeword's
    scalars; raises on what the kernel does not take."""
    grid_s, cbs_s, sym_s, sc_s, w_s = shapes
    e_sizes = tuple(int(e) for e in e_sizes)
    if modulation not in ("qpsk", "qam16", "qam64", "qam256"):
        raise ValueError(f"{modulation} PDSCH map on the card: K6 takes "
                         f"QPSK to 256QAM")
    qm = BITS_PER_SYMBOL[modulation]
    if not 1 <= nof_layers <= MAP_MAX_LAYERS:
        raise ValueError(f"{nof_layers} layers (K6 takes 1..4)")
    if (dtypes[0] != torch.complex64 or dtypes[1] != torch.int8
            or dtypes[4] != torch.complex64):
        raise ValueError("cbs must be int8, the grid and the precoder "
                         "complex64")
    table = 1 if prg_size else 0              # the [G] axis of a PRG table
    lead = tuple(grid_s[:-3])
    w_lead = tuple(w_s[:len(w_s) - 2 - table])
    if (len(grid_s) not in (3, 4) or len(cbs_s) != len(lead) + 2
            or tuple(cbs_s[:-2]) != lead or len(w_s) < 2 + table
            or tuple(w_s[-2:]) != (grid_s[-3], nof_layers)
            or w_lead not in ((), lead) or prg_size < 0):
        raise ValueError(f"grid {tuple(grid_s)} / cbs {tuple(cbs_s)} / "
                         f"precoder {tuple(w_s)} vs {nof_layers} layers, "
                         f"PRG size {prg_size}")
    p, s, kk = grid_s[-3:]
    if p > MAP_MAX_PORTS:
        raise ValueError(f"{p} ports: K6 takes up to {MAP_MAX_PORTS}")
    nre = sym_s[0] if len(sym_s) == 1 else -1
    if (dtypes[2] != torch.int32 or dtypes[3] != torch.int32 or nre < 0
            or tuple(sc_s) != (nre,)):
        raise ValueError("the RE plan must be int32 [RE] twice")
    c, n = cbs_s[-2:]
    unit = nof_layers * qm
    if (c < 1 or len(e_sizes) != c
            or any(e % unit or e < 0 for e in e_sizes)
            or sum(e_sizes) != nre * unit):
        raise ValueError(f"E sizes {e_sizes} vs C={c}, {nre} REs, "
                         f"{nof_layers} layers, Qm={qm}")
    if nre * unit >= 1 << 31:
        raise ValueError(f"{nre * unit} codeword bits: K6 indexes them in "
                         f"32 bits")
    c0, e0, e1 = _two_runs(e_sizes)
    fs, fe, n_nf, k0p = _window_plan(rv, base_graph, z, k_prime, k, n, n_ref)
    n0, n1 = e0 // unit, e1 // unit
    tiles = max(1, -(-max(n0, n1) // MAP_THREADS))
    out = _build.MapParams(
        C=c, C0=c0, n0=n0, n1=n1, tiles=tiles,
        T=max(1, -(-max(n0, n1) // tiles)), N=n, fs=fs, gap=fe - fs,
        n_nf=n_nf, k0p=k0p, qm=qm, L=nof_layers, P=p, S=s, K=kk, nre=nre,
        prg_size=prg_size, prg_base=rb_start // prg_size if prg_size else 0,
        w_stride=math.prod(w_s[1:]) if w_lead else 0,
        nslots=lead[0] if lead else 1)
    levels = pam_levels_scaled(modulation)
    out.levels[:len(levels)] = levels.tolist()
    return out


@functools.lru_cache(maxsize=1024)
def _map_plan(shapes: tuple, dtypes: tuple, e_sizes: tuple, rv: int,
              modulation: str, base_graph: int, z: int, k_prime: int, k: int,
              c_init: int, nof_layers: int, prg_size: int, rb_start: int,
              n_ref: int, index: int) -> tuple:
    """K6's launch for one call signature on CUDA device ``index`` (its
    parameters and the codeword's packed Gold bits, held) and the launch
    count it adds to; (None, None) when the codeword has no bits."""
    p = _map_params(shapes, dtypes, e_sizes, rv, modulation, base_graph, z,
                    k_prime, k, nof_layers, prg_size, rb_start, n_ref)
    if p.nre == 0:
        return None, None
    words = torch.from_numpy(gold_words(c_init, p.nre * p.L * p.qm)).to(
        torch.device("cuda", index))
    counter = (KERNEL_BATCH if len(shapes[0]) == 4 else
               KERNEL_PRG if prg_size else KERNEL)
    return _build.Launch("srsran_pdsch_map", index, p, (words,)), counter
