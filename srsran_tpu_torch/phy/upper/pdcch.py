"""PDCCH processor: DCI polar chain + CORESET mapping (TS38.211 §7.3.2).

Port of srsran_tpu/phy/upper/pdcch.py (transmit side).  The whole §7.3 DCI
bit chain -- CRC24C with leading ones and RNTI masking, polar allocate /
encode / rate match, Gold scrambling -- is one host-built GF(2) affine map,
``encoded = payload @ M ^ const``.  On the card it runs with QPSK and the
patch add as K27 (ops/dl_control.py::control_map), the map stored by output
bit and bit-packed; the plain twin (:func:`process_ref`, the CPU path) is
a float32 product over 0/1 values reduced mod 2 (exact: every sum is at
most A <= 140), QPSK, and the dense [duration, CORESET width] patch of
QPSK symbols and DM-RS pilots added to port 0 of the grid.

The UE-side receiver (:func:`recover`, :func:`decode_dci`; only tests and
``chip_smoke.py`` call it, as in the JAX package): the candidate's data REs
demapped and descrambled by K28 (ops/dl_control.py::control_llrs), then
polar rate dematch, SC decode and the DCI's CRC check by K15
(ops/polar.py::decode), the check as a syndrome (:func:`dci_syndrome`).
The step-by-step encoder :func:`encode_dci` (CRC24C over 1^24 ++ a, the
RNTI mask, then the polar chain by K33) equals the fused map bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...ops.gf2 import gf2_matmul
from ...ran import polar_params
from ...device import const
from ...ops import dl_control
from ...ops import polar as polar_ops
from ...ops.crc import _remainder_matrix, _remainder_words, crc
from ...ops.gold import gold_sequence_np
from ...ops.modulation import modulate, qpsk_np

NOF_REG_PER_CCE = 6
DATA_RE_PER_REG = 9
BITS_PER_CCE = 2 * DATA_RE_PER_REG * NOF_REG_PER_CCE  # 108


@dataclasses.dataclass(frozen=True)
class CoresetConfig:
    """CORESET geometry (same fields and defaults as the JAX package's)."""

    rb_start: int
    nof_rb: int                # multiple of 6
    start_symbol: int
    duration: int              # 1..3 symbols
    interleaved: bool = False
    reg_bundle_size: int = 6
    interleaver_size: int = 2
    shift_index: int = 0


@dataclasses.dataclass(frozen=True)
class PdcchConfig:
    """One DCI candidate (same fields and defaults as the JAX package's)."""

    coreset: CoresetConfig
    rnti: int
    aggregation_level: int     # 1,2,4,8,16
    cce_index: int
    payload_bits: int          # A
    n_id: int = 0              # pdcch DMRS scrambling id (cell id)
    n_id_data: int = 0         # scrambling id for data
    n_rnti: int = 0            # scrambling rnti (UE-SS with C-RNTI else 0)
    slot_in_frame: int = 0


@functools.lru_cache(maxsize=None)
def _dci_code(k: int, e: int) -> polar_params.PolarCode:
    return polar_params.polar_code(k, e, nmax=9, ibil=False)


def _rnti_mask(rnti: int) -> np.ndarray:
    """The 16 bits that mask a DCI's last CRC bits, MSB first."""
    return np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.int8)


def encode_dci(payload: torch.Tensor, cfg: PdcchConfig) -> torch.Tensor:
    """TS38.212 §7.3: CRC24C over (1^24 ++ a), its last 16 bits masked by
    the RNTI, polar (K33) and rate matching: payload int8 [A] -> encoded
    bits int8 [E], on the device of ``payload``."""
    dev = payload.device
    e = BITS_PER_CCE * cfg.aggregation_level
    a = payload.shape[-1]
    pay = payload.to(torch.int8)[None]
    ext = torch.cat([torch.ones((1, 24), dtype=torch.int8, device=dev), pay],
                    dim=-1)
    c = crc(ext, "crc24C")                                   # [1, 24]
    c = torch.cat([c[:, :8], c[:, 8:] ^ const(_rnti_mask, cfg.rnti,
                                              device=dev)], dim=-1)
    return polar_ops.encode_chain(torch.cat([pay, c], dim=-1),
                                  _dci_code(a + 24, e))[0]


@functools.lru_cache(maxsize=None)
def _fused_dci_maps(a: int, e: int, rnti: int, n_rnti: int, n_id_data: int):
    """Host GF(2) affine map of the whole §7.3 DCI TX chain:
    (M [A, E] int8, const [E] int32) with encoded = payload @ M ^ const."""
    mc = _remainder_matrix("crc24C", 24 + a).astype(np.uint8)   # [24+A, 24]
    const_c = mc[:24].sum(axis=0) % 2                           # leading ones
    mask = np.zeros(24, dtype=np.uint8)
    mask[8:] = _rnti_mask(rnti)
    m_bits = np.concatenate([np.eye(a, dtype=np.uint8), mc[24:]], axis=1)
    const_bits = np.concatenate([np.zeros(a, dtype=np.uint8),
                                 (const_c ^ mask).astype(np.uint8)])
    m_enc = polar_ops.encode_matrix(_dci_code(a + 24, e))       # [A+24, E]
    m = gf2_matmul(m_bits, m_enc).astype(np.int8)               # [A, E]
    scr_cinit = ((n_rnti << 16) + n_id_data) % (1 << 31)
    const_word = (gf2_matmul(const_bits[None], m_enc)[0]
                  ^ gold_sequence_np(scr_cinit, e).astype(np.uint8))
    return m, const_word.astype(np.int32)


def _dci_map(i: int, *key) -> np.ndarray:
    """One of the :func:`_fused_dci_maps` (0: M, 1: const), for const()."""
    return _fused_dci_maps(*key)[i]


@functools.lru_cache(maxsize=None)
def _bundle_map(coreset: CoresetConfig) -> np.ndarray:
    """f(j): logical REG-bundle index -> physical bundle (TS38.211 §7.3.2.2)."""
    nof_reg = coreset.nof_rb * coreset.duration
    l = coreset.reg_bundle_size if coreset.interleaved else 6
    nof_bundles = nof_reg // l
    if not coreset.interleaved:
        return np.arange(nof_bundles, dtype=np.int64)
    r_depth = coreset.interleaver_size
    c_cols = nof_bundles // r_depth
    if c_cols * r_depth != nof_bundles:
        raise ValueError("CORESET size incompatible with interleaver depth")
    f = np.empty(nof_bundles, dtype=np.int64)
    for x in range(nof_bundles):
        c, r = divmod(x, r_depth)
        f[x] = (r * c_cols + c + coreset.shift_index) % nof_bundles
    return f


@functools.lru_cache(maxsize=None)
def _candidate_re_plan(coreset: CoresetConfig, cce_index: int,
                       aggregation_level: int):
    """(data_positions [Nd, 2], dmrs_positions [Np, 2], dmrs_prb [Np]) as
    (symbol, subcarrier); REG numbering is time-first (TS38.211 §7.3.2.2)."""
    l = coreset.reg_bundle_size if coreset.interleaved else 6
    fmap = _bundle_map(coreset)
    regs = []
    bundles_per_cce = 6 // l
    for cce in range(cce_index, cce_index + aggregation_level):
        for b in range(bundles_per_cce):
            phys = fmap[cce * bundles_per_cce + b]
            for r in range(l):
                regs.append(int(phys) * l + r)
    data, dmrs, dmrs_prb = [], [], []
    for reg in sorted(regs):
        rb = reg // coreset.duration
        l = coreset.start_symbol + reg % coreset.duration
        prb = coreset.rb_start + rb
        for sc in range(12):
            pos = (l, prb * 12 + sc)
            if sc % 4 == 1:
                dmrs.append(pos)
                dmrs_prb.append(prb)
            else:
                data.append(pos)
    return (np.array(data, dtype=np.int32), np.array(dmrs, dtype=np.int32),
            np.array(dmrs_prb, dtype=np.int32))


@functools.lru_cache(maxsize=None)
def _patch_plan(coreset: CoresetConfig, cce_index: int, aggregation_level: int):
    """The candidate's RE map as one dense-patch gather: (inv_idx
    [duration*width] int32 into concat([0], data_syms, pilots), l0, sc0,
    duration, width); index 0 is a hole."""
    data_pos, dmrs_pos, _ = _candidate_re_plan(coreset, cce_index,
                                               aggregation_level)
    width = coreset.nof_rb * 12
    l0 = coreset.start_symbol
    sc0 = coreset.rb_start * 12
    inv = np.zeros(coreset.duration * width, dtype=np.int32)
    for k, (l, sc) in enumerate(data_pos):
        inv[(l - l0) * width + (sc - sc0)] = 1 + k
    # pilots are emitted by _dmrs_values ordered by symbol then row order
    nd = len(data_pos)
    j = 0
    for l in sorted(set(dmrs_pos[:, 0].tolist())):
        for ll, sc in dmrs_pos[dmrs_pos[:, 0] == l]:
            inv[(ll - l0) * width + (sc - sc0)] = 1 + nd + j
            j += 1
    return inv, l0, sc0, coreset.duration, width


def _patch_index(coreset: CoresetConfig, cce_index: int,
                 aggregation_level: int) -> np.ndarray:
    return _patch_plan(coreset, cce_index, aggregation_level)[0].astype(np.int64)


def _c_init(cfg: PdcchConfig, slot_in_frame: int, l: int) -> int:
    return ((1 << 17) * (14 * slot_in_frame + l + 1) * (2 * cfg.n_id + 1)
            + 2 * cfg.n_id) % (1 << 31)


def dmrs_cinits_for(cfg: PdcchConfig,
                    slot_in_frame: int | None = None) -> np.ndarray:
    """Host-side per-CORESET-symbol DM-RS c_init (uint32 [duration])."""
    sif = cfg.slot_in_frame if slot_in_frame is None else slot_in_frame
    return np.array(
        [_c_init(cfg, sif, l)
         for l in range(cfg.coreset.start_symbol,
                        cfg.coreset.start_symbol + cfg.coreset.duration)],
        dtype=np.uint32)


def _values_np(cfg: PdcchConfig, c_init_of) -> np.ndarray:
    """QPSK pilots in candidate order; ``c_init_of(l)`` seeds symbol l's
    Gold sequence, advanced by 2*3*prb within the symbol."""
    _, dmrs_pos, dmrs_prb = _candidate_re_plan(
        cfg.coreset, cfg.cce_index, cfg.aggregation_level)
    out = []
    for l in sorted(set(dmrs_pos[:, 0].tolist())):
        prbs = dmrs_prb[dmrs_pos[:, 0] == l]
        pmin, pmax = int(prbs.min()), int(prbs.max())
        pilots = qpsk_np(gold_sequence_np(int(c_init_of(l)),
                                          2 * 3 * (pmax - pmin + 1),
                                          advance=2 * 3 * pmin))
        idx = []
        counters = {}
        for p in prbs:
            k = counters.get(p, 0)
            idx.append(3 * (p - pmin) + k)
            counters[p] = k + 1
        out.append(pilots[np.array(idx, dtype=np.int32)])
    return np.concatenate(out).astype(np.complex64)


@functools.lru_cache(maxsize=8192)
def dmrs_values_for(cfg: PdcchConfig,
                    slot_in_frame: int | None = None) -> np.ndarray:
    """Host-side DM-RS pilot VALUES in candidate order (complex64
    [n_dmrs]): the slot-context form of :func:`process`'s pilots."""
    sif = cfg.slot_in_frame if slot_in_frame is None else slot_in_frame
    return _values_np(cfg, lambda l: _c_init(cfg, sif, l))


@functools.lru_cache(maxsize=8192)
def _values_from_cinits(cfg: PdcchConfig, seeds: tuple) -> np.ndarray:
    start = cfg.coreset.start_symbol
    return _values_np(cfg, lambda l: seeds[l - start])


def _dmrs_values(cfg: PdcchConfig, cinits, device) -> torch.Tensor:
    """Pilots on ``device``: from the config (None), from host c_init seeds
    per CORESET symbol (they key the host cache, so a seed on the card
    raises), or the slot context's complex pilot VALUES as given."""
    if isinstance(cinits, torch.Tensor) and cinits.is_complex():
        return cinits
    if cinits is None:
        return const(dmrs_values_for, cfg, device=device)
    if isinstance(cinits, torch.Tensor):
        if cinits.device.type != "cpu":
            raise ValueError(
                "PDCCH DM-RS c_init seeds must stay on the host (got a "
                f"{cinits.device.type} tensor); pass pilot values to run "
                "from the device")
        cinits = cinits.numpy()
    seeds = tuple(int(c) for c in np.asarray(cinits).reshape(-1))
    return const(_values_from_cinits, cfg, seeds, device=device)


def _dci_rows(*key) -> np.ndarray:
    """K27's form of the fused map: M by output bit, 32 bits to a word."""
    return dl_control.pack_rows(_fused_dci_maps(*key)[0])


def _patch_index32(coreset: CoresetConfig, cce_index: int,
                   aggregation_level: int) -> np.ndarray:
    return _patch_plan(coreset, cce_index, aggregation_level)[0]


@functools.lru_cache(maxsize=1024)
def _static_item(cfg: PdcchConfig, amplitude: float, device) -> dict:
    """The fields of this DCI's K27 item that no slot changes, on
    ``device``: the map and the patch plan, made once."""
    e = BITS_PER_CCE * cfg.aggregation_level
    key = (cfg.payload_bits, e, cfg.rnti, cfg.n_rnti, cfg.n_id_data)
    _, l0, sc0, dur, width = _patch_plan(cfg.coreset, cfg.cce_index,
                                         cfg.aggregation_level)
    place = (cfg.coreset, cfg.cce_index, cfg.aggregation_level)
    return dict(rows=const(_dci_rows, *key, device=device),
                offset=const(_dci_map, 1, *key, device=device),
                index=const(_patch_index32, *place, device=device),
                base=None, l0=l0, sc0=sc0, h=dur, w=width, all_ports=False,
                nd=e // 2, amplitude=amplitude)


def control_item(grid: torch.Tensor, payload: torch.Tensor, cfg: PdcchConfig,
                 amplitude: float = 1.0,
                 dmrs_cinits=None) -> dl_control.ControlItem:
    """This DCI as one PDU of K27 (ops/dl_control.py::control_map)."""
    dev = grid.device
    return dl_control.ControlItem(
        **_static_item(cfg, float(amplitude), dev), bits=(payload,),
        pilots=_dmrs_values(cfg, dmrs_cinits, dev),
        ref=lambda g: process_ref(g, payload, cfg, amplitude, dmrs_cinits))


def process(grid: torch.Tensor, payload: torch.Tensor, cfg: PdcchConfig,
            amplitude: float = 1.0, dmrs_cinits=None) -> torch.Tensor:
    """Encode + modulate + map one DCI, added into port 0 of the grid
    [P, nsym, nsc] (in place; K27 on the card, :func:`process_ref` on the
    CPU).  payload: int [A] on the grid's device.  With a leading slot
    axis -- grid [B, P, nsym, nsc], payload [B, A], pilot values [B, n] or
    shared -- one launch maps the B slots."""
    return dl_control.control_map(
        grid, (control_item(grid, payload, cfg, amplitude, dmrs_cinits),))


def process_ref(grid: torch.Tensor, payload: torch.Tensor, cfg: PdcchConfig,
                amplitude: float = 1.0, dmrs_cinits=None) -> torch.Tensor:
    """Plain twin of K27 for one DCI: the GF(2) map as a float32 product
    over 0/1 values reduced mod 2 (exact: every sum is at most A <= 140),
    QPSK, and the dense [duration, CORESET width] patch added to port 0."""
    dev = grid.device
    lead = tuple(payload.shape[:-1])
    e = BITS_PER_CCE * cfg.aggregation_level
    key = (cfg.payload_bits, e, cfg.rnti, cfg.n_rnti, cfg.n_id_data)
    m = const(_dci_map, 0, *key, device=dev, dtype=torch.float32)
    offset = const(_dci_map, 1, *key, device=dev)
    acc = torch.matmul(payload.to(torch.float32), m)
    b = ((acc.to(torch.int32) + offset) & 1).to(torch.int8)
    syms = modulate(b, "qpsk") * amplitude
    pilots = _dmrs_values(cfg, dmrs_cinits, dev) * amplitude
    _, l0, sc0, dur, width = _patch_plan(cfg.coreset, cfg.cce_index,
                                         cfg.aggregation_level)
    inv = const(_patch_index, cfg.coreset, cfg.cce_index,
                cfg.aggregation_level, device=dev)
    values = torch.cat([syms.new_zeros(lead + (1,)), syms.to(torch.complex64),
                        pilots.to(torch.complex64).expand(
                            lead + pilots.shape[-1:])], dim=-1)
    grid[..., 0, l0:l0 + dur, sc0:sc0 + width] += values[..., inv].reshape(
        lead + (dur, width))
    return grid


# ------------------------------------------------------ receive (UE side)

@functools.lru_cache(maxsize=None)
def dci_syndrome(a: int, rnti: int) -> int:
    """The CRC24C remainder that the A + 24 decoded bits of a DCI for
    ``rnti`` have when its CRC matches: TS38.212 §7.3.2 checks CRC24C over
    24 leading ones and the decoded bits with the RNTI mask undone on the
    last 16 (JAX pdcch.py:97-100); the CRC is linear, so that check is
    the decoded bits' own remainder equal to the ones' remainder XOR the
    mask's."""
    k = a + 24
    ones = np.bitwise_xor.reduce(_remainder_words("crc24C", 24 + k)[:24])
    words = _remainder_words("crc24C", k)
    mask = np.bitwise_xor.reduce(words[k - 16:][_rnti_mask(rnti) == 1],
                                 initial=0)
    return int(ones) ^ int(mask)


def _candidate_re_offsets(coreset: CoresetConfig, cce_index: int,
                          aggregation_level: int, shape: tuple) -> np.ndarray:
    """int64 [E / 2]: the candidate's data REs on port 0 of a grid of
    ``shape`` [P, S, K], as flat offsets in the codeword's symbol order."""
    data_pos, _, _ = _candidate_re_plan(coreset, cce_index, aggregation_level)
    return data_pos[:, 0].astype(np.int64) * shape[-1] + data_pos[:, 1]


def rx_item(cfg: PdcchConfig, shape: tuple,
            noise_var: float = 0.01) -> dl_control.RxItem:
    """This DCI's codeword as K28 takes it, on port 0 of a [P, S, K] grid."""
    return dl_control.RxItem(
        _candidate_re_offsets,
        (cfg.coreset, cfg.cce_index, cfg.aggregation_level, tuple(shape)),
        float(noise_var), ((cfg.n_rnti << 16) + cfg.n_id_data) % (1 << 31))


def decode_dci(llrs: torch.Tensor, cfg: PdcchConfig) -> tuple:
    """Descrambled LLRs f32 [E] -> (payload int8 [A], crc_ok bool): polar
    rate dematch, SC decode and the DCI's CRC check, one K15 launch."""
    a = cfg.payload_bits
    code = _dci_code(a + 24, BITS_PER_CCE * cfg.aggregation_level)
    bits, ok = polar_ops.decode(llrs.reshape(1, -1), code, "crc24C",
                                dci_syndrome(a, cfg.rnti))
    return bits[0, :a], ok[0]


def recover(grid: torch.Tensor, cfg: PdcchConfig, noise_var: float = 0.01):
    """Loopback receive from a [P, S, K] grid assuming an ideal channel
    (tests / UE side): K28, then :func:`decode_dci`."""
    grid = grid.contiguous()
    llrs = dl_control.control_llrs(grid, (rx_item(cfg, grid.shape,
                                                  noise_var),))
    return decode_dci(llrs, cfg)
