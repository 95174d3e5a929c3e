"""Block-floating-point IQ compression (O-RAN CUS §A.1.2), kernels K23/K24.

Port of srsran_tpu/ofh/compression.py: per PRB (12 complex REs = 24 real
values) scale float IQ to the int16 full range (+-1.0 is +-32767; beyond
it clips), find the shared block exponent that fits every value into a
signed ``width``-bit mantissa, shift, and emit (exponent, mantissas).  The
O-RAN U-plane payload of a PRB is 1 byte ``exp & 0x0F`` followed by the 24
mantissas MSB first as ``width``-bit two's-complement fields: 1 + 3 width
bytes (24 width is a multiple of 8, so no record has padding).

The JAX package computes (exp, mant) on the device and packs bits on the
host one at a time in Python (``pack_section``/``unpack_section``).  Here
the device does the bytes too:

- :func:`compress` is the K23 wrapper (csrc/bfp.cu): the grid to its
  payload records, contiguous per (port, symbol) row, so that a U-plane
  section of PRBs [p0, p0 + n) is the byte range [p0 R, (p0 + n) R) of its
  row (R = 1 + 3 width) and the host cuts sections without touching the
  device again; (exp, mant) too when asked;
- :func:`decompress_sections` is the K24 wrapper: the payloads of received
  sections (one byte buffer and a table of (byte offset, port, symbol,
  start PRB, nof PRB, width) rows) decoded and scattered into a complex64
  grid; :func:`bfp_decompress` is its (exp, mant) mode.

On CUDA tensors they launch the kernels, each through a plan per call
signature on ``kernels/_build.py::Launch`` (:func:`_compress_plan`,
:func:`_sections_plan` over the tiles of :func:`_tiles` in the structs of
:func:`_sections_params`, :func:`_expand_plan`); on CPU tensors they run
the plain twins ``*_ref``.  :func:`pack_section`/:func:`unpack_section`
stay host numpy functions with the JAX package's bytes, vectorised over
bits.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..device import is_cuda
from ..kernels import _build

KERNEL_COMPRESS = kernels.register(kernels.Kernel(
    name="bfp_compress", route="cuda", source="srsran_tpu_torch/csrc/bfp.cu",
    replaces="srsran_tpu/ofh/compression.py:26"))
KERNEL_DECOMPRESS = kernels.register(kernels.Kernel(
    name="bfp_decompress", route="cuda",
    source="srsran_tpu_torch/csrc/bfp.cu",
    replaces="srsran_tpu/ofh/compression.py:54"))

# int16 full scale of the reference's float -> fixed conversion.
FIXED_SCALE = 32767.0
#: Columns of a :func:`decompress_sections` table row.
TABLE_COLUMNS = ("offset", "port", "symbol", "start_prb", "nof_prb", "width")


def record_bytes(width: int) -> int:
    """Bytes of one PRB's payload record: the exponent byte, then 24
    ``width``-bit mantissas."""
    return 1 + 3 * width


def _check_width(width: int) -> None:
    if not 1 <= width <= 16:
        raise ValueError(f"BFP width {width}: 1..16 supported")


def _check_grid(iq: torch.Tensor) -> None:
    if iq.dtype != torch.complex64 or iq.ndim < 1 or iq.shape[-1] % 12:
        raise ValueError(f"iq {tuple(iq.shape)} {iq.dtype}: complex64 "
                         "[..., 12 nof_prb] expected")


def _bit_weights(width: int, device) -> torch.Tensor:
    return torch.tensor([1 << (width - 1 - b) for b in range(width)],
                        dtype=torch.int32, device=device)


def compress_ref(iq: torch.Tensor, width: int = 9, mantissas: bool = False):
    """Plain twin of :func:`compress`."""
    _check_grid(iq)
    _check_width(width)
    lead, nof_prb = iq.shape[:-1], iq.shape[-1] // 12
    x = torch.view_as_real(iq.contiguous()).reshape(*lead, nof_prb, 24)
    v = torch.round(x * FIXED_SCALE).clamp(-32768, 32767).to(torch.int32)
    m = v.abs().amax(dim=-1)
    # 32 - clz(m): the bits of the magnitude (0 for an all-zero PRB)
    powers = 1 << torch.arange(17, dtype=torch.int32, device=iq.device)
    nbits = (m[..., None] >= powers).sum(dim=-1, dtype=torch.int32)
    exp = (nbits - (width - 1)).clamp(min=0)
    hi = (1 << (width - 1)) - 1
    mant = (v >> exp[..., None]).clamp(-hi - 1, hi)
    fields = mant & ((1 << width) - 1)
    bits = (fields[..., None] >> torch.arange(
        width - 1, -1, -1, dtype=torch.int32, device=iq.device)) & 1
    bits = bits.reshape(*lead, nof_prb, 3 * width, 8)
    packed = (bits * _bit_weights(8, iq.device)).sum(dim=-1,
                                                      dtype=torch.int32)
    payload = torch.cat([(exp & 0x0F)[..., None], packed], dim=-1).to(
        torch.uint8)
    if mantissas:
        return exp.to(torch.uint8), mant, payload
    return None, None, payload


@functools.lru_cache(maxsize=64)
def _compress_plan(nblocks: int, width: int, index: int) -> _build.Launch:
    """K23's launch for ``nblocks`` PRBs at ``width`` on CUDA device
    ``index``."""
    return _build.Launch("srsran_bfp_compress", index,
                         _build.BfpCompressParams(nblocks=nblocks,
                                                  width=width))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels load and
    store 16-byte vectors): a copy only for a view that starts between."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() & 15 else t


def compress(iq: torch.Tensor, width: int = 9, mantissas: bool = False):
    """BFP-compress a grid.

    iq: complex64 [..., 12 nof_prb].  Returns (exp uint8 [..., P], mant
    int32 [..., P, 24], payload uint8 [..., P, 1 + 3 width]); exp and mant
    are None unless ``mantissas`` (the U-plane path needs the payload
    only).  K23 on CUDA tensors, :func:`compress_ref` on CPU tensors.
    """
    if not is_cuda(iq):
        return compress_ref(iq, width, mantissas)
    _check_grid(iq)
    _check_width(width)
    lead, nof_prb = iq.shape[:-1], iq.shape[-1] // 12
    nblocks = iq.numel() // 12
    if nblocks >= 1 << 31:
        raise ValueError(f"K23 takes fewer than 2^31 PRBs, got {nblocks}")
    dev = iq.device
    payload = torch.empty((*lead, nof_prb, record_bytes(width)),
                          dtype=torch.uint8, device=dev)
    exp = mant = None
    if mantissas:
        exp = torch.empty((*lead, nof_prb), dtype=torch.uint8, device=dev)
        mant = torch.empty((*lead, nof_prb, 24), dtype=torch.int32,
                           device=dev)
    if nblocks:
        iq = _aligned(iq)
        _compress_plan(nblocks, width, iq.get_device())(
            iq.data_ptr(), exp.data_ptr() if mantissas else 0,
            mant.data_ptr() if mantissas else 0, payload.data_ptr())
        KERNEL_COMPRESS.count()
    return exp, mant, payload


def bfp_compress(iq: torch.Tensor, width: int = 9):
    """The JAX package's contract: (exp uint8 [..., P], mant int32
    [..., P, 24]) with mantissas in [-2^(width-1), 2^(width-1) - 1]."""
    exp, mant, _ = compress(iq, width, mantissas=True)
    return exp, mant


def bfp_compress_packed(iq: torch.Tensor, width: int = 9) -> torch.Tensor:
    """The O-RAN payload of every PRB: uint8 [..., P, 1 + 3 width]."""
    return compress(iq, width)[2]


def _to_complex(values: torch.Tensor) -> torch.Tensor:
    """int32 [..., P, 24] (already shifted) -> complex64 [..., 12 P].

    The divisor is a 1-element tensor on the values' device: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which
    differs from IEEE division (the JAX package's, and K24's) in the last
    bit."""
    scale = torch.full((1,), FIXED_SCALE, dtype=torch.float32,
                       device=values.device)
    f = values.to(torch.float32) / scale
    f = f.reshape(*values.shape[:-2], values.shape[-2] * 12, 2)
    return torch.complex(f[..., 0], f[..., 1])


def bfp_decompress_ref(exp: torch.Tensor, mant: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`bfp_decompress`."""
    v = mant.to(torch.int32) << exp.to(torch.int32)[..., None]
    return _to_complex(v)


def _check_exp_mant(exp: torch.Tensor, mant: torch.Tensor) -> None:
    if mant.ndim < 2 or mant.shape[-1] != 24 or mant.shape[:-1] != exp.shape:
        raise ValueError(f"exp {tuple(exp.shape)}, mant {tuple(mant.shape)}: "
                         "[..., P] and [..., P, 24] expected")


@functools.lru_cache(maxsize=64)
def _expand_plan(nblocks: int, index: int) -> _build.Launch:
    """K24's (exp, mant) launch for ``nblocks`` PRBs on CUDA device
    ``index``."""
    return _build.Launch("srsran_bfp_decompress", index,
                         _build.BfpExpandParams(nblocks=nblocks))


def bfp_decompress(exp: torch.Tensor, mant: torch.Tensor) -> torch.Tensor:
    """The JAX package's contract: (exp [..., P], mant [..., P, 24]) ->
    complex64 [..., 12 P].  K24 in its (exp, mant) mode on CUDA tensors,
    :func:`bfp_decompress_ref` on CPU tensors."""
    _check_exp_mant(exp, mant)
    if not is_cuda(exp, mant):
        return bfp_decompress_ref(exp, mant)
    if exp.numel() >= 1 << 31:
        raise ValueError(f"K24 takes fewer than 2^31 PRBs, got {exp.numel()}")
    out = torch.empty((*exp.shape[:-1], exp.shape[-1] * 12),
                      dtype=torch.complex64, device=exp.device)
    if exp.numel():
        exp = exp.to(torch.uint8).contiguous()
        mant = _aligned(mant.to(torch.int32))
        _expand_plan(exp.numel(), exp.get_device())(
            exp.data_ptr(), mant.data_ptr(), out.data_ptr())
        KERNEL_DECOMPRESS.count()
    return out


def _check_sections(buf: torch.Tensor, table: torch.Tensor,
                    grid: torch.Tensor) -> None:
    if buf.dtype != torch.uint8 or buf.ndim != 1:
        raise ValueError(f"buf {tuple(buf.shape)} {buf.dtype}: uint8 [n] "
                         "expected")
    if (table.dtype != torch.int32 or table.ndim != 2
            or table.shape[1] != len(TABLE_COLUMNS)):
        raise ValueError(f"table {tuple(table.shape)} {table.dtype}: int32 "
                         f"[sections, {len(TABLE_COLUMNS)}] expected")
    if (grid.dtype != torch.complex64 or grid.ndim != 3
            or grid.shape[-1] % 12 or not grid.is_contiguous()):
        raise ValueError(f"grid {tuple(grid.shape)} {grid.dtype}: contiguous "
                         "complex64 [ports, symbols, 12 nof_prb] expected")


def section_table(rows) -> torch.Tensor:
    """int32 [sections, 6] from (offset, port, symbol, start PRB, nof PRB,
    width) tuples, on the CPU."""
    return torch.tensor(np.asarray(rows, dtype=np.int32).reshape(
        -1, len(TABLE_COLUMNS)))


def validate_table(table: np.ndarray, buf_len: int, grid_shape) -> None:
    """Raise unless every section lies inside the buffer and the grid, and
    no two sections write the same RE (the kernel's scatter has no order
    between sections)."""
    ports, nsym, nsc = grid_shape
    off, port, sym, p0, n, width = np.asarray(table, np.int64).reshape(
        -1, len(TABLE_COLUMNS)).T
    bad = ~((1 <= width) & (width <= 16) & (0 <= port) & (port < ports)
            & (0 <= sym) & (sym < nsym) & (0 <= p0) & (0 <= n)
            & (p0 + n <= nsc // 12) & (0 <= off)
            & (off + n * (1 + 3 * width) <= buf_len))
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(f"section {table[i].tolist()} (offset, port, symbol,"
                         f" start PRB, nof PRB, width) outside the buffer "
                         f"({buf_len} B) or the grid {tuple(grid_shape)}")
    # sorted by (port, symbol, start PRB), each section must end before
    # the next one of its (port, symbol) starts
    keep = n > 0
    row = (port * nsym + sym)[keep]
    order = np.lexsort((p0[keep], row))
    row, start, end = row[order], p0[keep][order], (p0 + n)[keep][order]
    if ((row[1:] == row[:-1]) & (start[1:] < end[:-1])).any():
        raise ValueError("sections overlap: two write the same PRB")


def decompress_sections_ref(buf: torch.Tensor, table: torch.Tensor,
                            grid: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`decompress_sections`."""
    _check_sections(buf, table, grid)
    rows = table.cpu().numpy()
    validate_table(rows, buf.numel(), tuple(grid.shape))
    flat = grid.view(-1)
    nsym, nsc = grid.shape[1], grid.shape[2]
    for width in sorted(set(rows[:, 5].tolist())):
        sel = rows[rows[:, 5] == width]
        r = record_bytes(width)
        prb = np.concatenate([np.arange(n) for n in sel[:, 4]]).astype(
            np.int64) if len(sel) else np.zeros(0, np.int64)
        rep = np.repeat(np.arange(len(sel)), sel[:, 4])
        if not len(prb):
            continue
        start = torch.from_numpy(sel[rep, 0].astype(np.int64) + prb * r)
        rec = buf[(start[:, None] + torch.arange(r)).to(buf.device)]
        exp, mant = _unpack_records(rec, width)
        vals = _to_complex(mant << exp[:, None]).reshape(-1, 12)
        dst = ((sel[rep, 1].astype(np.int64) * nsym + sel[rep, 2]) * nsc
               + (sel[rep, 3] + prb) * 12)
        idx = torch.from_numpy(dst[:, None] + np.arange(12)).to(grid.device)
        flat[idx.reshape(-1)] = vals.reshape(-1)
    return grid


def _unpack_records(rec: torch.Tensor, width: int):
    """uint8 [n, 1 + 3 width] -> (exp int32 [n], mant int32 [n, 24])."""
    exp = rec[:, 0].to(torch.int32) & 0x0F
    bits = (rec[:, 1:, None].to(torch.int32) >> torch.arange(
        7, -1, -1, dtype=torch.int32, device=rec.device)) & 1
    fields = (bits.reshape(-1, 24, width)
              * _bit_weights(width, rec.device)).sum(dim=-1, dtype=torch.int32)
    mant = torch.where(fields >= (1 << (width - 1)), fields - (1 << width),
                       fields)
    return exp, mant


def _tiles(rows: np.ndarray, grid_shape) -> np.ndarray:
    """K24's tiles of the sections ``rows`` (of :data:`TABLE_COLUMNS`), in
    table order: every section's PRBs in runs of at most
    ``BFP_TILE_PRBS``, int32 [tiles, 2] of csrc/bfp.cu's ``BfpTile`` --
    the run's first record's byte offset in the buffer, and its first PRB
    in the flat grid [ports x symbols x nof_prb] | (n - 1) << 22 | (width -
    1) << 27.  An empty section has no tile."""
    _, nsym, nsc = grid_shape
    off, port, sym, p0, n, width = np.asarray(rows, np.int64).reshape(
        -1, len(TABLE_COLUMNS)).T
    size = _build.BFP_TILE_PRBS
    count = -(-n // size)
    sec = np.repeat(np.arange(len(n)), count)
    first = size * (np.arange(len(sec))
                    - np.repeat(np.cumsum(count) - count, count))
    w = width[sec]
    start = off[sec] + first * (1 + 3 * w)
    prb = (port[sec] * nsym + sym[sec]) * (nsc // 12) + p0[sec] + first
    word = (prb | (np.minimum(size, n[sec] - first) - 1) << _build.BFP_PRB_BITS
            | (w - 1) << (_build.BFP_PRB_BITS + 5))
    return np.stack([start, word], axis=-1).astype(np.int32)


def _sections_params(rows: np.ndarray, buf_len: int, grid_shape) -> tuple:
    """K24's launch structs for a valid table: its tiles
    (:func:`_tiles`), ``BFP_MAX_TILES`` a launch.  Raises past the struct's
    fields: a grid of more than 2^22 PRBs, a buffer of 2^31 bytes or
    more."""
    ports, nsym, nsc = grid_shape
    if ports * nsym * (nsc // 12) > 1 << _build.BFP_PRB_BITS:
        raise ValueError(f"K24 takes grids of at most 2^{_build.BFP_PRB_BITS}"
                         f" PRBs, got {tuple(grid_shape)}")
    if buf_len >= 1 << 31:
        raise ValueError(f"K24 takes buffers under 2^31 bytes, got {buf_len}")
    tiles = _tiles(rows, grid_shape)
    params = []
    for a in range(0, len(tiles), _build.BFP_MAX_TILES):
        chunk = np.ascontiguousarray(tiles[a:a + _build.BFP_MAX_TILES])
        p = _build.BfpSectionsParams(ntiles=len(chunk), buf_len=buf_len)
        ctypes.memmove(ctypes.addressof(p.tiles), chunk.ctypes.data,
                       chunk.nbytes)
        params.append(p)
    return tuple(params)


@functools.lru_cache(maxsize=64)
def _sections_plan(rows: bytes, buf_len: int, grid_shape: tuple,
                   index: int) -> tuple:
    """K24's launches for one section table (its int32 bytes), buffer
    length and grid shape on CUDA device ``index``: the table is checked
    (:func:`validate_table`) once, when the plan is made."""
    table = np.frombuffer(rows, np.int32).reshape(-1, len(TABLE_COLUMNS))
    validate_table(table, buf_len, grid_shape)
    return tuple(_build.Launch("srsran_bfp_decompress_sections", index, p)
                 for p in _sections_params(table, buf_len, grid_shape))


def decompress_sections(buf: torch.Tensor, table: torch.Tensor,
                        grid: torch.Tensor) -> torch.Tensor:
    """Decode packed U-plane sections into ``grid``.

    buf: uint8 [n], the payloads of the received sections; table: int32
    [sections, 6] rows of :data:`TABLE_COLUMNS` (byte offset of the
    section's first record in ``buf``, port, symbol, start PRB, nof PRB,
    width); grid: complex64 [ports, symbols, 12 nof_prb], written in place
    at the sections' REs (others untouched) and returned.  Sections must
    not overlap.  K24 on CUDA tensors -- the table stays on the host (it
    is checked there, and its tiles ride in the launch's struct: one
    launch for every ``BFP_MAX_TILES`` tiles); the grid must be 16-byte
    aligned -- :func:`decompress_sections_ref` on CPU tensors.
    """
    if not is_cuda(buf, grid):
        return decompress_sections_ref(buf, table, grid)
    _check_sections(buf, table, grid)
    if grid.data_ptr() & 15:
        raise ValueError("K24 stores 16-byte vectors: the grid must be "
                         "16-byte aligned")
    rows = table.cpu().numpy().tobytes()
    for launch in _sections_plan(rows, buf.numel(), tuple(grid.shape),
                                 grid.get_device()):
        launch(buf.data_ptr(), grid.data_ptr())
        KERNEL_DECOMPRESS.count()
    return grid


# --------------------------------------------------------- host bit packing

def pack_section(exp: np.ndarray, mant: np.ndarray, width: int = 9) -> bytes:
    """One symbol's PRB run in the U-plane payload layout (per PRB: 1
    exponent byte, then 24 ``width``-bit mantissas MSB first), as the JAX
    package's per-bit loop writes it."""
    exp = np.asarray(exp, dtype=np.uint8)
    mant = np.asarray(mant, dtype=np.int64)
    nof_prb = exp.shape[0]
    fields = mant & ((1 << width) - 1)
    bits = (fields[..., None] >> np.arange(width - 1, -1, -1)) & 1
    mant_bytes = np.packbits(bits.astype(np.uint8).reshape(nof_prb, -1),
                             axis=-1)
    return np.concatenate([(exp & 0x0F)[:, None], mant_bytes],
                          axis=-1).tobytes()


def unpack_section(payload: bytes, nof_prb: int, width: int = 9):
    """Inverse of :func:`pack_section` -> (exp uint8 [P], mant int32
    [P, 24])."""
    if width < 1:
        # a udIqWidth of 0 (O-RAN's 16, as width 16 leaves the 4-bit
        # header field): the JAX package's parser fails on it the same way
        raise ValueError(f"BFP width {width} cannot be unpacked")
    r = record_bytes(width)
    recs = np.frombuffer(payload, np.uint8, count=nof_prb * r).reshape(
        nof_prb, r)
    bits = np.unpackbits(recs[:, 1:], axis=-1).reshape(nof_prb, 24, width)
    fields = bits.astype(np.int32) @ (1 << np.arange(width - 1, -1, -1,
                                                     dtype=np.int32))
    mant = np.where(fields >= (1 << (width - 1)), fields - (1 << width),
                    fields).astype(np.int32)
    return (recs[:, 0] & 0x0F).astype(np.uint8), mant
