"""SSB / PBCH transmit (TS38.211 §7.4, TS38.212 §7.1).

Port of srsran_tpu/phy/upper/ssb.py (transmit side).  The SS/PBCH block
(4 symbols x 240 subcarriers) is a host-constant base patch with PSS, SSS
and the PBCH DM-RS, plus the 432 PBCH QPSK symbols.  The whole PBCH bit
chain -- payload interleave, first scrambling, CRC24C, polar encode and
rate match, second scrambling -- is one host-built GF(2) affine map.  On
the card the map, QPSK and the patch add run as K27
(ops/dl_control.py::control_map); the plain twin (:func:`ssb_block_ref`,
the CPU path) is a float32 product over 0/1 values reduced mod 2 (exact:
every sum is at most 56).  The patch is added to every port of the grid.

The UE-side PBCH receiver (:func:`pbch_decode`, :func:`pbch_extract_mib`;
only tests and ``chip_smoke.py`` call it, as in the JAX package): the 432
data REs demapped and descrambled by K28 (ops/dl_control.py::
control_llrs), polar rate dematch, SC decode and the CRC24C check by K15
(ops/polar.py::decode), then the first descrambling and the MIB
de-interleave on the host, as in the JAX package.

The step-by-step chain of the JAX package (:func:`pbch_payload`,
:func:`pbch_encode`, :func:`pbch_modulate`, :func:`pbch_dmrs`), on the
device of the MIB bits: the payload interleave and first scrambling as
index and XOR ops, CRC24C, the polar chain by K33 (ops/polar.py::
encode_chain), the second scrambling and QPSK by the port's
``scramble_bits`` and ``modulate``.  It equals the fused map bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...ops.gf2 import gf2_matmul
from ...ran import polar_params
from ...device import const, i64
from ...ops import dl_control
from ...ops import polar as polar_ops
from ...ops.crc import _remainder_matrix, crc
from ...ops.gold import gold_sequence_np
from ...ops.modulation import modulate
from ...ops.scrambling import scramble_bits

SSB_NSYMB = 4
SSB_NSC = 240
PBCH_A = 32
PBCH_B = 56          # A + CRC24
PBCH_E = 864
PBCH_MBIT = 864      # data bits per PBCH
PBCH_NDATA = 432     # QPSK symbols

# TS38.212 Table 7.1.1-1: PBCH payload interleaver pattern G(j).
_G = [16, 23, 18, 17, 8, 30, 10, 6, 24, 7, 0, 5, 3, 2, 1, 4,
      9, 11, 12, 13, 14, 15, 19, 20, 21, 22, 25, 26, 27, 28, 29, 31]


@dataclasses.dataclass(frozen=True)
class SsbConfig:
    """Static SSB configuration (same fields and defaults as the JAX
    package's SsbConfig)."""

    phys_cell_id: int          # N_ID_cell
    ssb_idx: int               # block index (0..L_max-1)
    l_max: int                 # 4, 8 or 64
    hrf: bool = False          # half-radio-frame bit
    sfn: int = 0
    k_ssb: int = 0             # subcarrier offset (only bit 4 enters payload)
    beta_pss_db: float = 0.0   # PSS power offset (0 or 3 dB)
    first_symbol: int = 0
    first_subcarrier: int = 0


# ------------------------------------------------------------- PSS / SSS

@functools.lru_cache(maxsize=None)
def _mseq(taps: tuple, init: tuple, length: int = 127) -> np.ndarray:
    """Binary m-sequence x(n+7) = sum of x(n+t) for t in taps."""
    x = np.zeros(length + 7, dtype=np.uint8)
    for i, b in enumerate(init):
        x[i] = b
    for i in range(length):
        acc = 0
        for t in taps:
            acc ^= x[i + t]
        x[i + 7] = acc
    return x


def pss_sequence(n_id2: int) -> np.ndarray:
    """TS38.211 §7.4.2.2: d(n) = 1 - 2 x((n + 43 N_ID2) mod 127)."""
    x = _mseq((0, 4), (0, 1, 1, 0, 1, 1, 1))
    m = (np.arange(127) + 43 * n_id2) % 127
    return (1.0 - 2.0 * x[m]).astype(np.float32)


def sss_sequence(n_id1: int, n_id2: int) -> np.ndarray:
    """TS38.211 §7.4.2.3."""
    x0 = _mseq((0, 4), (1, 0, 0, 0, 0, 0, 0))
    x1 = _mseq((0, 1), (1, 0, 0, 0, 0, 0, 0))
    m0 = 15 * (n_id1 // 112) + 5 * n_id2
    m1 = n_id1 % 112
    n = np.arange(127)
    return ((1.0 - 2.0 * x0[(n + m0) % 127]) *
            (1.0 - 2.0 * x1[(n + m1) % 127])).astype(np.float32)


# ------------------------------------------------------------ PBCH coding

def _i_ssb_bar(cfg: SsbConfig) -> int:
    if cfg.l_max == 4:
        return (cfg.ssb_idx & 0b11) + (4 if cfg.hrf else 0)
    return cfg.ssb_idx & 0b111


@functools.lru_cache(maxsize=None)
def _payload_maps(sfn: int, hrf: bool, ssb_idx: int, l_max: int, k_ssb: int):
    """(mib_dest [24] scatter positions, static_bits [32] with timing bits)."""
    dest = np.zeros(24, dtype=np.int32)
    j_sfn, j_other = 0, 14
    for i in range(24):
        if 1 <= i < 7:                       # SFN payload bits
            dest[i] = _G[j_sfn]
            j_sfn += 1
        else:
            dest[i] = _G[j_other]
            j_other += 1
    static = np.zeros(PBCH_A, dtype=np.int8)
    for shift in (3, 2, 1, 0):               # 4th..1st LSB of SFN
        static[_G[j_sfn]] = (sfn >> shift) & 1
        j_sfn += 1
    static[_G[10]] = 1 if hrf else 0
    if l_max == 64:
        static[_G[11]] = (ssb_idx >> 5) & 1
        static[_G[12]] = (ssb_idx >> 4) & 1
        static[_G[13]] = (ssb_idx >> 3) & 1
    else:
        static[_G[11]] = (k_ssb >> 4) & 1
    return dest, static


def slot_ctx_for(cfg: SsbConfig, sfn: int | None = None,
                 hrf: bool | None = None):
    """Host-side slot-varying SSB inputs: (static_bits [32], scramble_mask
    [32]), the slot context that keeps the program independent of the SFN
    and half-frame."""
    sfn = cfg.sfn if sfn is None else sfn
    hrf = cfg.hrf if hrf is None else hrf
    _, static = _payload_maps(sfn, hrf, cfg.ssb_idx, cfg.l_max, cfg.k_ssb)
    mask = _scramble_mask(cfg.phys_cell_id, sfn, cfg.l_max)
    return static, mask


@functools.lru_cache(maxsize=None)
def _scramble_mask(phys_cell_id: int, sfn: int, l_max: int) -> np.ndarray:
    """The §7.1.2 scrambling bits s[32] (0 at pass-through positions)."""
    m = PBCH_A - 6 if l_max == 64 else PBCH_A - 3
    v = 2 * ((sfn >> 2) & 1) + ((sfn >> 1) & 1)
    seq = gold_sequence_np(phys_cell_id, PBCH_A, advance=m * v)
    sfn_2nd = _G[8]    # j_sfn order: G[6..9] = 4th..1st LSB of SFN
    sfn_3rd = _G[7]
    ssb_bits = {_G[11], _G[12], _G[13]} if l_max == 64 else set()
    mask = np.zeros(PBCH_A, dtype=np.int8)
    j = 0
    for i in range(PBCH_A):
        skip = i in ssb_bits or i == _G[10] or i == sfn_2nd or i == sfn_3rd
        if not skip:
            mask[i] = seq[j]
            j += 1
    return mask


@functools.lru_cache(maxsize=None)
def _pbch_code() -> polar_params.PolarCode:
    return polar_params.polar_code(PBCH_B, PBCH_E, nmax=9, ibil=False)


def _bits_on(x, device=None) -> torch.Tensor:
    """``x`` (bits: a tensor, numpy array or list) as int8, on ``device``
    or, for a tensor, on its own device."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    return t.to(device or t.device).to(torch.int8)


def pbch_payload(cfg: SsbConfig, mib24, static_bits=None) -> torch.Tensor:
    """TS38.212 §7.1.1: the 24 MIB bits and the 8 timing bits interleaved
    into a[32] (int8, on the device of ``mib24``); ``static_bits`` (the
    timing bits of :func:`slot_ctx_for`) replace the config's own."""
    mib = _bits_on(mib24)
    dest, static = _payload_maps(cfg.sfn, cfg.hrf, cfg.ssb_idx, cfg.l_max,
                                 cfg.k_ssb)
    a = _bits_on(static if static_bits is None else static_bits,
                 mib.device).clone()
    a[const(i64, tuple(int(d) for d in dest), device=mib.device)] = mib
    return a


def pbch_message(cfg: SsbConfig, mib24, slot_ctx=None) -> torch.Tensor:
    """The polar message int8 [1, 56] of the §7.1 chain: payload, first
    scrambling, CRC24C.  ``slot_ctx``: (static_bits, scramble_mask) of
    :func:`slot_ctx_for`."""
    static_bits, mask = slot_ctx if slot_ctx is not None else (None, None)
    a = pbch_payload(cfg, mib24, static_bits)
    if mask is None:
        mask = _scramble_mask(cfg.phys_cell_id, cfg.sfn, cfg.l_max)
    bits = (a ^ _bits_on(mask, a.device))[None]
    return torch.cat([bits, crc(bits, "crc24C")], dim=-1)


def pbch_encode(cfg: SsbConfig, mib24, slot_ctx=None) -> torch.Tensor:
    """The §7.1 chain -> rate-matched bits int8 [E = 864]: the message of
    :func:`pbch_message`, then polar (K33)."""
    return polar_ops.encode_chain(pbch_message(cfg, mib24, slot_ctx),
                                  _pbch_code())[0]


def pbch_modulate(encoded: torch.Tensor, cfg: SsbConfig) -> torch.Tensor:
    """TS38.211 §7.3.3: second scrambling + QPSK -> complex64 [432]."""
    v = cfg.ssb_idx & (0b11 if cfg.l_max == 4 else 0b111)
    b = scramble_bits(encoded[None], cfg.phys_cell_id,
                      advance=v * PBCH_MBIT)
    return modulate(b, "qpsk")[0]


def _dmrs_bits(cfg: SsbConfig) -> np.ndarray:
    ibar = _i_ssb_bar(cfg)
    nid = cfg.phys_cell_id
    c_init = ((1 << 11) * (ibar + 1) * (nid // 4 + 1)
              + (1 << 6) * (ibar + 1) + (nid % 4)) % (1 << 31)
    return gold_sequence_np(c_init, 2 * 144).astype(np.int8)


def pbch_dmrs(cfg: SsbConfig, device=None) -> torch.Tensor:
    """TS38.211 §7.4.1.4: the 144 QPSK pilots (complex64, on ``device``,
    the CPU by default)."""
    return modulate(const(_dmrs_bits, cfg, device=device or "cpu")[None],
                    "qpsk")[0]


@functools.lru_cache(maxsize=None)
def _fused_pbch_maps(cfg: SsbConfig):
    """Host GF(2) maps of the whole §7.1 PBCH chain: e[864] = mib @ M_mib
    ^ s @ M_apr ^ g, with s the slot timing bits XOR the first-scrambling
    mask.  Returns (M_mib [24, 864], M_apr [32, 864], g [864])."""
    dest, _ = _payload_maps(cfg.sfn, cfg.hrf, cfg.ssb_idx, cfg.l_max,
                            cfg.k_ssb)
    m_enc = polar_ops.encode_matrix(_pbch_code())                 # [56, 864]
    crc_m = _remainder_matrix("crc24C", PBCH_A).astype(np.uint8)  # [32, 24]
    m_c = np.concatenate([np.eye(PBCH_A, dtype=np.uint8), crc_m], axis=1)
    m_apr = gf2_matmul(m_c, m_enc).astype(np.uint8)               # [32, 864]
    scatter = np.zeros((24, PBCH_A), dtype=np.uint8)
    scatter[np.arange(24), dest] = 1
    m_mib = gf2_matmul(scatter, m_apr).astype(np.uint8)           # [24, 864]
    v = cfg.ssb_idx & (0b11 if cfg.l_max == 4 else 0b111)
    g = gold_sequence_np(cfg.phys_cell_id, PBCH_MBIT,
                         advance=v * PBCH_MBIT).astype(np.uint8)
    return m_mib, m_apr, g


def _pbch_operand(cfg: SsbConfig, which: str) -> np.ndarray:
    """Device operands of :func:`ssb_block`, for const(): "mib" M_mib;
    "full" [M_mib; M_apr] (slot-context form); "g" the second scrambling
    word; "static" the config's own timing bits mapped through M_apr, XOR g."""
    m_mib, m_apr, g = _fused_pbch_maps(cfg)
    if which == "mib":
        return m_mib
    if which == "full":
        return np.concatenate([m_mib, m_apr], axis=0)
    if which == "g":
        return g.astype(np.int32)
    _, static = _payload_maps(cfg.sfn, cfg.hrf, cfg.ssb_idx, cfg.l_max,
                              cfg.k_ssb)
    mask = _scramble_mask(cfg.phys_cell_id, cfg.sfn, cfg.l_max)
    s_np = static.astype(np.uint8) ^ mask.astype(np.uint8)
    word = ((s_np.astype(np.uint32) @ m_apr.astype(np.uint32)) & 1) ^ g
    return word.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ssb_base_patch(cfg: SsbConfig):
    """Host-constant [4, 240] patch with PSS/SSS/DM-RS prefilled, and the
    PBCH data RE positions (all static per SSB config)."""
    patch = np.zeros((SSB_NSYMB, SSB_NSC), dtype=np.complex64)
    beta_pss = 10.0 ** (cfg.beta_pss_db / 20.0)
    patch[0, 56:183] = pss_sequence(cfg.phys_cell_id % 3) * beta_pss
    patch[2, 56:183] = sss_sequence(cfg.phys_cell_id // 3,
                                    cfg.phys_cell_id % 3)
    dmrs_pos, data_pos = _ssb_re_maps(cfg.phys_cell_id % 4)
    b = _dmrs_bits(cfg).astype(np.float32)
    dm = ((1 - 2 * b[0::2]) + 1j * (1 - 2 * b[1::2])) / np.sqrt(2)
    patch[dmrs_pos[:, 0], dmrs_pos[:, 1]] = dm.astype(np.complex64)
    return patch, data_pos


def _base(cfg: SsbConfig) -> np.ndarray:
    return _ssb_base_patch(cfg)[0]


def _data_index(v: int) -> np.ndarray:
    """Flat [4 * 240] positions of the PBCH data REs (int64)."""
    data_pos = _ssb_re_maps(v)[1]
    return (data_pos[:, 0] * SSB_NSC + data_pos[:, 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _ssb_re_maps(v: int):
    """(dmrs_positions [144, 2], data_positions [432, 2]) as (symbol, sc)."""
    dmrs, data = [], []
    for l in (1, 2, 3):
        if l == 2:
            scs = list(range(0, 48)) + list(range(192, 240))
        else:
            scs = list(range(240))
        for sc in scs:
            if sc % 4 == v:
                dmrs.append((l, sc))
            else:
                data.append((l, sc))
    return (np.array(dmrs, dtype=np.int32), np.array(data, dtype=np.int32))


# ------------------------------------------------------------- SSB mapping

def _rows(cfg: SsbConfig, which: str) -> np.ndarray:
    """K27's form of M_mib ("mib") or [M_mib; M_apr] ("full"): by output
    bit, 32 bits to a word."""
    return dl_control.pack_rows(_pbch_operand(cfg, which))


def _patch_index(v: int) -> np.ndarray:
    """int32 [4 * 240]: 0 for a base-patch RE, 1 + k for PBCH data RE k."""
    idx = np.zeros(SSB_NSYMB * SSB_NSC, np.int32)
    idx[_data_index(v)] = 1 + np.arange(PBCH_NDATA, dtype=np.int32)
    return idx


@functools.lru_cache(maxsize=1024)
def _static_item(cfg: SsbConfig, form: str, at: tuple, device) -> dict:
    """The fields of this SSB's K27 item that no slot changes, on
    ``device``: the map of its ``form`` ("mib", or "full" with the slot
    context) and the patch plan, made once."""
    offset = "static" if form == "mib" else "g"
    return dict(rows=const(_rows, cfg, form, device=device),
                offset=const(_pbch_operand, cfg, offset, device=device),
                index=const(_patch_index, cfg.phys_cell_id % 4,
                            device=device),
                base=const(_base, cfg, device=device), l0=at[0], sc0=at[1],
                h=SSB_NSYMB, w=SSB_NSC, all_ports=True, nd=PBCH_NDATA,
                amplitude=1.0)


def control_item(grid: torch.Tensor, cfg: SsbConfig, mib24: torch.Tensor,
                 slot_ctx=None, at=None) -> dl_control.ControlItem:
    """This SSB as one PDU of K27 (ops/dl_control.py::control_map), its
    patch at (first symbol, first subcarrier), or at ``at``."""
    l0, k0 = at if at is not None else (cfg.first_symbol, cfg.first_subcarrier)
    return dl_control.ControlItem(
        **_static_item(cfg, "mib" if slot_ctx is None else "full", (l0, k0),
                       grid.device),
        bits=(mib24,) if slot_ctx is None else (mib24, *slot_ctx),
        pilots=None,
        ref=lambda g: _add_patch(g, ssb_block_ref(cfg, mib24, slot_ctx),
                                 l0, k0))


def ssb_block(cfg: SsbConfig, mib24: torch.Tensor,
              slot_ctx=None) -> torch.Tensor:
    """The dense [4, 240] SSB patch on ``mib24``'s device ([B, 4, 240]
    with a slot axis on mib24); on the card K27 adds it into zeros."""
    lead = tuple(mib24.shape[:-1])
    patch = torch.zeros(lead + (1, SSB_NSYMB, SSB_NSC), dtype=torch.complex64,
                        device=mib24.device)
    dl_control.control_map(patch, (control_item(patch, cfg, mib24, slot_ctx,
                                                at=(0, 0)),))
    return patch[..., 0, :, :]


def ssb_block_ref(cfg: SsbConfig, mib24: torch.Tensor,
                  slot_ctx=None) -> torch.Tensor:
    """Plain twin of K27 for one SSB: the dense [4, 240] patch.

    mib24: int [24].  slot_ctx: optional (static_bits [32], scramble_mask
    [32]) int tensors on the same device (:func:`slot_ctx_for`); without it
    the config's own SFN and half-frame are used.  With a leading slot axis
    (mib24 [B, 24], the context [B, 32] or shared) the patches are
    [B, 4, 240], from one GF(2) product.
    """
    dev = mib24.device
    lead = tuple(mib24.shape[:-1])
    if slot_ctx is None:
        m = const(_pbch_operand, cfg, "mib", device=dev, dtype=torch.float32)
        offset = const(_pbch_operand, cfg, "static", device=dev)
        acc = torch.matmul(mib24.to(torch.float32), m)
    else:
        static_t, mask_t = slot_ctx
        s = static_t.to(torch.int8) ^ mask_t.to(torch.int8)
        v = torch.cat([mib24.to(torch.int8), s.expand(lead + s.shape[-1:])],
                      dim=-1).to(torch.float32)                  # [..., 56]
        m = const(_pbch_operand, cfg, "full", device=dev, dtype=torch.float32)
        offset = const(_pbch_operand, cfg, "g", device=dev)
        acc = torch.matmul(v, m)
    bits = (acc.to(torch.int32) + offset) & 1
    re = 1.0 - 2.0 * bits[..., 0::2].to(torch.float32)
    im = 1.0 - 2.0 * bits[..., 1::2].to(torch.float32)
    data = torch.complex(re, im) * float(np.float32(1.0 / np.sqrt(2.0)))
    base = const(_base, cfg, device=dev)
    patch = base.expand(lead + base.shape).clone()
    idx = const(_data_index, cfg.phys_cell_id % 4, device=dev)
    patch.view(lead + (-1,))[..., idx] = data
    return patch


def _add_patch(grid: torch.Tensor, patch: torch.Tensor, l0: int,
               k0: int) -> torch.Tensor:
    if patch.ndim > 2:
        patch = patch.unsqueeze(-3)
    grid[..., l0:l0 + SSB_NSYMB, k0:k0 + SSB_NSC] += patch
    return grid


def map_ssb_to_grid(grid: torch.Tensor, cfg: SsbConfig, mib24: torch.Tensor,
                    slot_ctx=None) -> torch.Tensor:
    """Add the SSB patch to every port of a [P, nsymb, nsc] slot grid (in
    place; K27 on the card); with a slot axis on mib24 ([B, 24]), patch b
    goes to every port of grid [B, P, nsymb, nsc]'s slot b."""
    return dl_control.control_map(
        grid, (control_item(grid, cfg, mib24, slot_ctx),))


def map_ssb_to_grid_ref(grid: torch.Tensor, cfg: SsbConfig,
                        mib24: torch.Tensor, slot_ctx=None) -> torch.Tensor:
    """Plain twin of :func:`map_ssb_to_grid`."""
    return _add_patch(grid, ssb_block_ref(cfg, mib24, slot_ctx),
                      cfg.first_symbol, cfg.first_subcarrier)


# ----------------------------------------------------- PBCH receive (UE side)

def pbch_scramble_payload(a, cfg: SsbConfig, mask=None):
    """TS38.212 §7.1.2 first scrambling of the 32 payload bits (timing bits
    pass through); involutive.  Host numpy, as the JAX receiver runs it."""
    if mask is None:
        mask = _scramble_mask(cfg.phys_cell_id, cfg.sfn, cfg.l_max)
    return np.asarray(a).astype(np.int8) ^ np.asarray(mask).astype(np.int8)


def _pbch_re_offsets(v: int, shape: tuple, port: int, l0: int,
                     k0: int) -> np.ndarray:
    """int64 [432]: the PBCH data REs of an SSB at (l0, k0) on ``port`` of a
    grid of ``shape`` [P, S, K], as flat offsets in symbol order."""
    _, s_n, k_n = shape
    data_pos = _ssb_re_maps(v)[1]
    return ((port * s_n + l0 + data_pos[:, 0].astype(np.int64)) * k_n
            + k0 + data_pos[:, 1])


def rx_item(cfg: SsbConfig, shape: tuple, port: int = 0, at=None,
            noise_var: float = 0.01) -> dl_control.RxItem:
    """This SSB's PBCH codeword as K28 takes it: on ``port`` of a
    [P, S, K] grid, its patch at (first symbol, first subcarrier) or at
    ``at``, descrambled from the Gold sequence of the cell id advanced by
    v * 864 (JAX ssb.py:358-359)."""
    l0, k0 = at if at is not None else (cfg.first_symbol,
                                        cfg.first_subcarrier)
    v = cfg.ssb_idx & (0b11 if cfg.l_max == 4 else 0b111)
    return dl_control.RxItem(
        _pbch_re_offsets, (cfg.phys_cell_id % 4, tuple(shape), port, l0, k0),
        float(noise_var), cfg.phys_cell_id, v * PBCH_MBIT)


def pbch_decode_llrs(llrs: torch.Tensor, cfg: SsbConfig) -> tuple:
    """Descrambled PBCH LLRs f32 [864] -> (payload a int8 [32] on the host,
    crc_ok bool): K15, then the first descrambling on the host."""
    bits, ok = polar_ops.decode(llrs.reshape(1, -1), _pbch_code(), "crc24C")
    a_prime = bits[0, :PBCH_A].cpu().numpy()
    return torch.from_numpy(pbch_scramble_payload(a_prime, cfg)), ok[0]


def pbch_decode(patch: torch.Tensor, cfg: SsbConfig, noise_var: float = 0.01):
    """Closed-loop PBCH receiver from a received [4, 240] SSB patch
    (ideal channel; tests / UE side): K28, then :func:`pbch_decode_llrs`.
    Returns (payload a int8 [32], crc_ok bool)."""
    patch = patch.reshape(1, SSB_NSYMB, SSB_NSC).contiguous()
    llrs = dl_control.control_llrs(patch, (rx_item(
        cfg, tuple(patch.shape), at=(0, 0), noise_var=noise_var),))
    return pbch_decode_llrs(llrs, cfg)


def pbch_extract_mib(a, cfg: SsbConfig) -> np.ndarray:
    """Invert the §7.1.1 payload interleaver -> 24 MIB bits (host)."""
    a = np.asarray(a)
    dest, _ = _payload_maps(cfg.sfn, cfg.hrf, cfg.ssb_idx, cfg.l_max,
                            cfg.k_ssb)
    return a[dest].astype(np.int8)
