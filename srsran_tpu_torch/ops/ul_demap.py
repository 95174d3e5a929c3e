"""Fused PUSCH equalize -> max-log demap -> descramble (the K3, K16 and
K18 wrappers).

The JAX package runs these as three device functions over the gathered
data REs (srsran_tpu/phy/upper/pusch.py::_frontend_hop with
ops/equalizer.py::equalize, ops/modulation.py::demodulate and
ops/scrambling.py::descramble_llrs).  On CUDA tensors the port runs them
as one per-RE kernel: K3 (csrc/pusch_demap.cu) for ZF with 1-2 layers,
K16 (csrc/pusch_demap_lxn.cu) for MMSE and for 3-4 layers, each for every
modulation the JAX demodulate takes (BPSK and pi/2-BPSK included).  On CPU
tensors it runs :func:`equalize_demap_descramble_ref`, the plain twin of
both, composed of the port's plain front end (:func:`gather_equalize`,
which ``pusch._frontend_hop`` also runs), demodulate and descramble_llrs.
On the card both kernels are memory-bound (per RE they read P samples and
P*L coefficients and write L*Qm LLRs, 3.5-4.6 MB at the flagship shapes);
both stage a CTA's LLRs and symbols in shared memory and store them as
16-byte vectors, each LLR's Gold sign from the call's Gold bits packed 32
a word (``gold.gold_words``, the Gold offset folded in); their designs are
in the .cu files.  Both launch through ``kernels/_build.py::Launch``: one
plan per call signature (:func:`_demap_plan` for K3, :func:`_lxn_plan` for
K16, holding the parameters -- from :func:`_lxn_params`, testable on
the CPU, the level table by value -- and the packed Gold bits; both
kernels take K16's struct, ``LxnParams``, K3 its ZF form); a
call allocates its two outputs and makes one ctypes call, the RE plan
passed by pointer (the caller's cached tensors).

A transform-precoded (DFT-s-OFDM) PUSCH adds an IDFT per data symbol
between the equalizer and the demap, and its noise averaged over each
symbol's block (srsran_tpu/phy/upper/pusch.py:277-285):
:func:`tp_equalize_demap_descramble` is the K18 wrapper
(csrc/dft_s_ofdm.cu), :func:`tp_equalize_demap_descramble_ref` its twin.
Both hops of a hopping PUSCH go through one K18 launch: the hops'
estimates sit side by side on the subcarrier axis and a per-RE column plan
picks each RE's.  K18 launches through ``kernels/_build.py::Launch``: one
plan per call signature (:func:`_tp_plan`; its parameters, testable on the
CPU, from :func:`_tp_params`), so a call checks contiguity, allocates its
outputs and makes one ctypes call.

A leading slot axis on the grid, the coefficients and the noise variance
(the slot-batch mode) runs K3, K16 and K18 once for all slots (each
kernel's ``_batch`` row counts it), and the twins run slot by slot.  The
RE plan (K18: with the block hops), the twiddles and the Gold bits are
shared.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..device import is_cuda, stack_slots
from ..kernels import _build
from .equalizer import equalize
from .gold import gold_sequence, gold_words
from .modulation import (BITS_PER_SYMBOL, _SCALE, demodulate,
                         pam_levels_scaled)
from .scrambling import descramble_llrs
from .transform_precode import deprecode, fft_plan, twiddle_table

KERNEL = kernels.register(kernels.Kernel(
    name="pusch_demap", route="cuda",
    source="srsran_tpu_torch/csrc/pusch_demap.cu",
    replaces="srsran_tpu/ops/equalizer.py:55"))
KERNEL_LXN = kernels.register(kernels.Kernel(
    name="pusch_demap_lxn", route="cuda",
    source="srsran_tpu_torch/csrc/pusch_demap_lxn.cu",
    replaces="srsran_tpu/ops/equalizer.py:83"))
KERNEL_BATCH = kernels.batched(KERNEL)
KERNEL_LXN_BATCH = kernels.batched(KERNEL_LXN)
KERNEL_TP = kernels.register(kernels.Kernel(
    name="pusch_tp_demap", route="cuda",
    source="srsran_tpu_torch/csrc/dft_s_ofdm.cu",
    replaces="srsran_tpu/ops/transform_precode.py:30"))
KERNEL_TP_BATCH = kernels.batched(KERNEL_TP)


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
                                  noise_var, c_init, modulation, nof_layers,
                                  method: str = "zf", advance: int = 0):
    """Plain twin of :func:`equalize_demap_descramble` and
    :func:`equalize_demap_descramble_lxn` (a slot axis runs slot by
    slot)."""
    if grid.ndim == 4:
        return stack_slots([equalize_demap_descramble_ref(
            grid[b], coeffs[b], sym_idx, sc_idx, sc_off, noise_var[b], c_init,
            modulation, nof_layers, method, advance)
            for b in range(grid.shape[0])])
    x, out_nv = gather_equalize(grid, coeffs, sym_idx, sc_idx, sc_off,
                                noise_var, nof_layers, method)
    llr = demodulate(x.reshape(-1)[None], out_nv.reshape(-1)[None],
                     modulation, advance // BITS_PER_SYMBOL[modulation])[0]
    return descramble_llrs(llr, c_init, advance), x


# The demap forms of K3, K16, K18 and K19 (csrc/pusch_demap.cuh; K16's own
# demap in csrc/pusch_demap_lxn.cu takes the same kinds).
DEMAP_KIND = {"bpsk": 0, "pi2bpsk": 1, "qpsk": 2, "qam16": 2, "qam64": 2,
              "qam256": 2}


def demap_scalars(modulation: str) -> tuple:
    """(kind, PAM half-order, host level table, 2 * scale) of a demap."""
    qm = BITS_PER_SYMBOL[modulation]
    kind = DEMAP_KIND[modulation]
    levels = pam_levels_scaled("qpsk" if kind < 2 else modulation)
    return (kind, max(qm // 2, 1), levels,
            float(np.float32(2.0 * _SCALE[modulation])))


def equalize_demap_descramble(grid: torch.Tensor, coeffs: torch.Tensor,
                              sym_idx: torch.Tensor, sc_idx: torch.Tensor,
                              sc_off: int, noise_var: torch.Tensor,
                              c_init: int, modulation: str, nof_layers: int,
                              method: str = "zf", advance: int = 0):
    """Codeword LLRs of a PUSCH's data REs.

    grid complex64 [P, S, K]; coeffs complex64 [P, L, T, Ka] (Ka subcarriers
    from ``sc_off``); sym_idx / sc_idx int32 [RE] data-RE plan (int on the
    CPU); noise_var f32 scalar tensor (the mean estimator noise); method
    "zf" or "mmse"; advance: the Gold offset in bits of the first LLR.
    Returns (descrambled LLRs f32 [RE*L*Qm] in codeword order, equalized
    symbols complex64 [RE, L]).  With a slot axis -- grid
    [B, P, S, K], coeffs [B, P, L, T, Ka], noise_var [B] -- the outputs
    are [B, RE*L*Qm] and [B, RE, L].  On the card: K3 for ZF with 1-2
    layers, K16 otherwise, either one launch for all slots.
    """
    if not is_cuda(grid, coeffs, noise_var):
        return equalize_demap_descramble_ref(
            grid, coeffs, sym_idx, sc_idx, sc_off, noise_var, c_init,
            modulation, nof_layers, method, advance)
    if method != "zf" or nof_layers > 2:
        return equalize_demap_descramble_lxn(
            grid, coeffs, sym_idx, sc_idx, sc_off, noise_var, c_init,
            modulation, nof_layers, method, advance)
    return _run(_demap_plan(*_plan_key(grid, coeffs, sym_idx, sc_idx,
                                       noise_var, sc_off, c_init, modulation,
                                       nof_layers, advance)),
                grid, coeffs, sym_idx, sc_idx, noise_var)


def _plan_key(grid, coeffs, sym_idx, sc_idx, noise_var, sc_off, c_init,
              modulation, nof_layers, advance) -> tuple:
    """The arguments of :func:`_demap_plan` for one call (without the
    equalizer; :func:`_lxn_plan` takes it before ``advance``)."""
    return ((grid.shape, coeffs.shape, sym_idx.shape, sc_idx.shape,
             noise_var.shape),
            (grid.dtype, coeffs.dtype, sym_idx.dtype, sc_idx.dtype,
             noise_var.dtype), int(sc_off), int(c_init), modulation,
            int(nof_layers), int(advance), grid.get_device())


def _with_gold(entry: str, p, shapes: tuple, c_init: int, advance: int,
               counters: tuple, index: int) -> tuple:
    """A K3 or K16 launch of parameters ``p`` with the packed Gold bits of
    its LLRs on CUDA device ``index`` (held), its outputs' shapes (LLRs,
    symbols) and the count it adds to (``counters``: one slot, a slot
    axis)."""
    qm = 1 if p.kind < 2 else 2 * p.half
    length = p.nre * p.L * qm
    words = torch.from_numpy(gold_words(c_init, length, advance)).to(
        torch.device("cuda", index))
    lead = tuple(shapes[0][:-3])
    return (_build.Launch(entry, index, p, (words,)), lead + (length,),
            lead + (p.nre, p.L), counters[1] if lead else counters[0])


@functools.lru_cache(maxsize=1024)
def _demap_plan(shapes: tuple, dtypes: tuple, sc_off: int, c_init: int,
                modulation: str, nof_layers: int, advance: int,
                index: int) -> tuple:
    """K3's launch for one call signature on CUDA device ``index``, its
    outputs' shapes and the launch count it adds to."""
    p = _lxn_params(shapes, dtypes, sc_off, modulation, nof_layers, "zf",
                    advance)
    return _with_gold("srsran_pusch_demap", p, shapes, c_init, advance,
                      (KERNEL, KERNEL_BATCH), index)


def _run(plan: tuple, grid, coeffs, sym_idx, sc_idx, noise_var) -> tuple:
    """One K3 or K16 launch through ``plan``: (LLRs, symbols)."""
    launch, llr_shape, x_shape, counter = plan
    if not (sym_idx.is_cuda and sc_idx.is_cuda):
        raise ValueError("the RE plan must lie on the grid's device")
    # the kernel's inputs held in locals until it is enqueued
    g = grid if grid.is_contiguous() else grid.contiguous()
    h = coeffs if coeffs.is_contiguous() else coeffs.contiguous()
    sym = sym_idx if sym_idx.is_contiguous() else sym_idx.contiguous()
    sc = sc_idx if sc_idx.is_contiguous() else sc_idx.contiguous()
    nv = noise_var if noise_var.is_contiguous() else noise_var.contiguous()
    llr = nv.new_empty(llr_shape)
    x = g.new_empty(x_shape)
    launch(g.data_ptr(), h.data_ptr(), sym.data_ptr(), sc.data_ptr(),
           nv.data_ptr(), llr.data_ptr(), x.data_ptr())
    counter.count()
    return llr, x


def _lxn_params(shapes: tuple, dtypes: tuple, sc_off: int, modulation: str,
                nof_layers: int, method: str,
                advance: int) -> _build.LxnParams:
    """K16's (and K3's) parameters for one call signature: the shapes and
    dtypes of (grid, coeffs, sym_idx, sc_idx, noise_var), the subcarrier
    offset of the coefficients, the modulation, the layers, the equalizer
    and the Gold offset; raises on what the kernel does not take."""
    grid_s, coeffs_s, sym_s, sc_s, nv_s = shapes
    if method not in ("zf", "mmse"):
        raise ValueError(f"equalizer {method!r}")
    if modulation not in DEMAP_KIND:
        raise ValueError(f"modulation {modulation!r}")
    if dtypes[0] != torch.complex64 or dtypes[1] != torch.complex64:
        raise ValueError("grid and coeffs must be complex64")
    if len(grid_s) not in (3, 4) or len(coeffs_s) != len(grid_s) + 1:
        raise ValueError(f"grid [(B,) P, S, K] and coeffs [(B,) P, L, T, "
                         f"Ka], got {tuple(grid_s)} and {tuple(coeffs_s)}")
    lead = tuple(grid_s[:-3])
    p, s, k = grid_s[-3:]
    if (not 1 <= nof_layers <= 4 or tuple(coeffs_s[:-3]) != lead + (p,)
            or coeffs_s[-3] != nof_layers):
        raise ValueError(f"{nof_layers} layers vs coeffs {tuple(coeffs_s)}")
    if (tuple(nv_s) not in (((lead[0],),) if lead else ((), (1,)))
            or dtypes[4] != torch.float32):
        raise ValueError(f"noise_var must be one float32 value per slot, "
                         f"got {tuple(nv_s)} for grid {tuple(grid_s)}")
    nre = sym_s[0] if len(sym_s) == 1 else -1
    if (dtypes[2] != torch.int32 or dtypes[3] != torch.int32 or nre < 1
            or tuple(sc_s) != (nre,)):
        raise ValueError("the RE plan must be int32 [RE] twice")
    qm = BITS_PER_SYMBOL[modulation]
    kind, half, levels, two_scale = demap_scalars(modulation)
    out = _build.LxnParams(
        nre=nre, P=p, S=s, K=k, L=nof_layers, T=coeffs_s[-2],
        Ka=coeffs_s[-1], sc_off=sc_off, kind=kind, half=half,
        rot0=(advance // qm) % 2, mmse=int(method == "mmse"),
        nslots=lead[0] if lead else 1, two_scale=two_scale)
    out.levels[:len(levels)] = levels.tolist()
    return out


@functools.lru_cache(maxsize=1024)
def _lxn_plan(shapes: tuple, dtypes: tuple, sc_off: int, c_init: int,
              modulation: str, nof_layers: int, method: str, advance: int,
              index: int) -> tuple:
    """K16's launch for one call signature on CUDA device ``index``, its
    outputs' shapes and the launch count it adds to."""
    p = _lxn_params(shapes, dtypes, sc_off, modulation, nof_layers, method,
                    advance)
    return _with_gold("srsran_pusch_demap_lxn", p, shapes, c_init, advance,
                      (KERNEL_LXN, KERNEL_LXN_BATCH), index)


def equalize_demap_descramble_lxn(grid: torch.Tensor, coeffs: torch.Tensor,
                                  sym_idx: torch.Tensor, sc_idx: torch.Tensor,
                                  sc_off: int, noise_var: torch.Tensor,
                                  c_init: int, modulation: str,
                                  nof_layers: int, method: str = "mmse",
                                  advance: int = 0):
    """:func:`equalize_demap_descramble` through K16 for 1-4 layers, ZF or
    MMSE (the L x N solve of the JAX package's ``equalize``): one launch
    through the cached plan of the call's signature (:func:`_lxn_plan`),
    the RE plan passed by pointer, as the caller's cached tensors."""
    if not (grid.is_cuda and coeffs.is_cuda and noise_var.is_cuda):
        is_cuda(grid, coeffs, noise_var)             # raises on a mix
        return equalize_demap_descramble_ref(
            grid, coeffs, sym_idx, sc_idx, sc_off, noise_var, c_init,
            modulation, nof_layers, method, advance)
    key = _plan_key(grid, coeffs, sym_idx, sc_idx, noise_var, sc_off, c_init,
                    modulation, nof_layers, advance)
    return _run(_lxn_plan(*key[:6], method, *key[6:]), grid, coeffs,
                sym_idx, sc_idx, noise_var)


# ------------------------------------------------- K18: DFT-s-OFDM PUSCH

def tp_equalize_demap_descramble_ref(grid, coeffs, plan, noise_var,
                                     block_hop, m_sc: int, c_init: int,
                                     modulation: str, method: str = "zf"):
    """Plain twin of :func:`tp_equalize_demap_descramble`: the JAX
    package's per-hop 1 x N equalizer, then per block of ``m_sc`` REs the
    unitary IDFT and the mean post-equalizer noise, then the demap over the
    whole codeword and the descramble (a slot axis runs slot by slot)."""
    if grid.ndim == 4:
        return stack_slots([tp_equalize_demap_descramble_ref(
            grid[b], coeffs[b], plan, noise_var[b], block_hop, m_sc, c_init,
            modulation, method) for b in range(grid.shape[0])])
    sym, sc, col = plan[0], plan[1], plan[2]
    y = grid[:, sym, sc].T                                   # [RE, P]
    h = coeffs[:, 0, 0, col] if coeffs.shape[2] == 1 else coeffs[:, 0, sym, col]
    nv = noise_var.mean(dim=-1)[block_hop].repeat_interleave(m_sc)
    x, out_nv = equalize(y, h.T[..., None], nv, 1, method)
    x = deprecode(x[:, 0].reshape(-1, m_sc)).reshape(-1, 1)
    out_nv = out_nv.reshape(-1, m_sc).mean(dim=-1, keepdim=True).expand(
        -1, m_sc).reshape(-1)
    llr = demodulate(x.reshape(-1)[None], out_nv[None], modulation)[0]
    return descramble_llrs(llr, c_init), x


def demap_threads(m: int) -> int:
    """K18's and K19's threads per CTA for an M-point block: one per point
    in whole warps, at most 512 (a CTA per symbol is bound by its SM's
    instruction rate past that: 1024 threads were no faster at M = 3240
    on the H100)."""
    return min(512, -(-m // 32) * 32)


def _tp_params(shapes: tuple, dtypes: tuple, m_sc: int, modulation: str,
               method: str) -> _build.TpDemapParams:
    """K18's parameters for one call signature: the shapes and dtypes of
    (grid, coeffs, plan, noise_var, block_hop), the block size, the
    modulation and the equalizer; raises on what the kernel does not
    take."""
    grid_s, coeffs_s, plan_s, noise_s, hop_s = shapes
    if method not in ("zf", "mmse"):
        raise ValueError(f"equalizer {method!r}")
    if modulation not in DEMAP_KIND:
        raise ValueError(f"modulation {modulation!r}")
    if dtypes[0] != torch.complex64 or dtypes[1] != torch.complex64:
        raise ValueError("grid and coeffs must be complex64")
    lead = tuple(grid_s[:-3])
    p, s, k = grid_s[-3:]
    if (len(grid_s) not in (3, 4) or len(coeffs_s) != len(lead) + 4
            or tuple(coeffs_s[:-2]) != lead + (p, 1)):
        raise ValueError(f"grid [(B,) P, S, K] and coeffs [(B,) P, 1, T, "
                         f"Ka], got {tuple(grid_s)} and {tuple(coeffs_s)}")
    nre = plan_s[-1]
    if (dtypes[2] != torch.int32 or tuple(plan_s) != (3, nre)
            or nre % m_sc or nre == 0 or dtypes[4] != torch.int32
            or tuple(hop_s) != (nre // m_sc,)):
        raise ValueError(f"plan must be int32 [3, RE] with RE a multiple of "
                         f"{m_sc}, block_hop int32 [RE / {m_sc}]")
    if (dtypes[3] != torch.float32 or len(noise_s) != len(lead) + 2
            or tuple(noise_s[:-2]) != lead or noise_s[-1] != p
            or not 0 < noise_s[-2] * p <= _build.DEMAP_MAX_NOISE):
        raise ValueError(f"noise_var must be float32 [(B,) H, {p}], H x P "
                         f"at most {_build.DEMAP_MAX_NOISE}")
    if m_sc % 4:
        raise ValueError(f"{m_sc} subcarriers per block: K18 takes a "
                         f"multiple of 4 (M = 12 n_RB)")
    kind, half, levels, two_scale = demap_scalars(modulation)
    out = _build.TpDemapParams(
        fft=fft_plan(m_sc), nslots=lead[0] if lead else 1,
        nblocks=nre // m_sc, nre=nre, P=p, S=s, K=k, T=coeffs_s[-2],
        Ka=coeffs_s[-1], H=noise_s[-2], mmse=int(method == "mmse"),
        kind=kind, half=half, threads=demap_threads(m_sc),
        two_scale=two_scale)
    out.levels[:len(levels)] = levels.tolist()
    return out


@functools.lru_cache(maxsize=1024)
def _tp_plan(shapes: tuple, dtypes: tuple, m_sc: int, c_init: int,
             modulation: str, method: str, index: int) -> tuple:
    """K18's launch for one call signature on CUDA device ``index`` and
    its outputs' shapes (LLRs, symbols)."""
    p = _tp_params(shapes, dtypes, m_sc, modulation, method)
    qm = BITS_PER_SYMBOL[modulation]
    seq = gold_sequence(c_init, p.nre * qm, 0,
                        device=torch.device("cuda", index))
    launch = _build.Launch("srsran_pusch_tp_demap", index, p,
                           (twiddle_table(m_sc, index), seq))
    lead = tuple(shapes[0][:-3])
    return launch, lead + (p.nre * qm,), lead + (p.nre, 1)


def tp_equalize_demap_descramble(grid: torch.Tensor, coeffs: torch.Tensor,
                                 plan: torch.Tensor, noise_var: torch.Tensor,
                                 block_hop: torch.Tensor, m_sc: int,
                                 c_init: int, modulation: str,
                                 method: str = "zf"):
    """Codeword LLRs of a transform-precoded single-layer PUSCH.

    grid complex64 [P, S, K]; coeffs complex64 [P, 1, T, Ka]: the hops'
    estimates concatenated on the subcarrier axis (T == 1: time-constant);
    plan int32 [3, RE]: each data RE's symbol, grid subcarrier and column
    of ``coeffs``, in codeword order, RE = blocks * m_sc (one block per
    data symbol); noise_var f32 [H, P]: each hop's estimator noise;
    block_hop int32 [blocks]: the hop of each block; method "zf" or "mmse".
    Returns (descrambled LLRs f32 [RE * Qm], the IDFT's symbols complex64
    [RE, 1]).  With a slot axis -- grid [B, P, S, K], coeffs [B, P, 1, T,
    Ka], noise_var [B, H, P] (the slot-batch mode) -- the outputs are
    [B, RE * Qm] and [B, RE, 1].  On the card: K18, one launch for all
    slots through the cached plan of the call's signature.
    """
    if not (grid.is_cuda and coeffs.is_cuda and plan.is_cuda
            and noise_var.is_cuda and block_hop.is_cuda):
        is_cuda(grid, coeffs, plan, noise_var, block_hop)  # raises on a mix
        return tp_equalize_demap_descramble_ref(
            grid, coeffs, plan, noise_var, block_hop, m_sc, c_init,
            modulation, method)
    launch, llr_shape, x_shape = _tp_plan(
        (grid.shape, coeffs.shape, plan.shape, noise_var.shape,
         block_hop.shape),
        (grid.dtype, coeffs.dtype, plan.dtype, noise_var.dtype,
         block_hop.dtype), m_sc, c_init, modulation, method,
        grid.get_device())
    # the kernel's inputs held in locals until it is enqueued
    g = grid if grid.is_contiguous() else grid.contiguous()
    h = coeffs if coeffs.is_contiguous() else coeffs.contiguous()
    re = plan if plan.is_contiguous() else plan.contiguous()
    nv = noise_var if noise_var.is_contiguous() else noise_var.contiguous()
    hop = block_hop if block_hop.is_contiguous() else block_hop.contiguous()
    llr = nv.new_empty(llr_shape)
    x = g.new_empty(x_shape)
    launch(g.data_ptr(), h.data_ptr(), re.data_ptr(), nv.data_ptr(),
           hop.data_ptr(), llr.data_ptr(), x.data_ptr())
    (KERNEL_TP_BATCH if len(llr_shape) == 2 else KERNEL_TP).count()
    return llr, x
