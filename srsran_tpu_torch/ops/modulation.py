"""Modulation mapper + max-log soft demapper (TS38.211 §5.1).

Port of srsran_tpu/ops/modulation.py: closed-form NR Gray constellations
for mapping and exact max-log per-axis LLRs for demapping.  LLR > 0 means
bit 0.  On the PUSCH receive path the demap is fused into the
ops/ul_demap.py kernel, which uses the same level table (:func:`pam_levels_scaled`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import const

BITS_PER_SYMBOL = {
    "pi2bpsk": 1, "bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6, "qam256": 8,
}

_SCALE = {"qpsk": 2 ** -0.5, "qam16": 10 ** -0.5, "qam64": 42 ** -0.5,
          "qam256": 170 ** -0.5, "bpsk": 2 ** -0.5, "pi2bpsk": 2 ** -0.5}


def _pam(bits: torch.Tensor, order: int) -> torch.Tensor:
    """Gray PAM amplitude from sign-bit-first NR bit groups [..., order]."""
    s = 1.0 - 2.0 * bits.to(torch.float32)
    if order == 1:
        return s[..., 0]
    if order == 2:
        return s[..., 0] * (2.0 - s[..., 1])
    if order == 3:
        return s[..., 0] * (4.0 - s[..., 1] * (2.0 - s[..., 2]))
    return s[..., 0] * (8.0 - s[..., 1] * (4.0 - s[..., 2] * (2.0 - s[..., 3])))


def modulate(bits: torch.Tensor, scheme: str) -> torch.Tensor:
    """Map bits to symbols.  bits int [..., E] -> complex64 [..., E/Qm]."""
    qm = BITS_PER_SYMBOL[scheme]
    scale = _SCALE[scheme]
    shape = bits.shape[:-1]
    e = bits.shape[-1]
    if e % qm:
        raise ValueError(f"{e} bits do not fill {scheme} symbols")
    if scheme in ("bpsk", "pi2bpsk"):
        s = 1.0 - 2.0 * bits.to(torch.float32)
        sym = scale * torch.complex(s, s)
        if scheme == "pi2bpsk":
            n = sym.shape[-1]
            odd = torch.arange(n, device=bits.device) % 2 == 1
            sym = torch.where(odd, sym * 1j, sym)
        return sym.to(torch.complex64)
    g = bits.reshape(shape + (e // qm, qm))
    half = qm // 2
    i_amp = _pam(g[..., 0::2], half)
    q_amp = _pam(g[..., 1::2], half)
    return (scale * torch.complex(i_amp, q_amp)).to(torch.complex64)


def qpsk_np(bits: np.ndarray) -> np.ndarray:
    """Host QPSK mapper (matches modulate(..., 'qpsk') exactly)."""
    b = np.asarray(bits).reshape(-1, 2).astype(np.float32)
    return (((1.0 - 2.0 * b[:, 0]) + 1j * (1.0 - 2.0 * b[:, 1]))
            * np.float32(2 ** -0.5)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _pam_levels(order: int):
    """All 2^order PAM amplitudes indexed by the bit-group value, plus the
    per-bit 0/1 masks.  Returns (levels [L], bit0_mask [order, L])."""
    levels = np.zeros(1 << order, dtype=np.float32)
    bitmask = np.zeros((order, 1 << order), dtype=bool)
    for v in range(1 << order):
        bits = [(v >> (order - 1 - i)) & 1 for i in range(order)]
        s = [1.0 - 2.0 * b for b in bits]
        if order == 1:
            a = s[0]
        elif order == 2:
            a = s[0] * (2 - s[1])
        elif order == 3:
            a = s[0] * (4 - s[1] * (2 - s[2]))
        else:
            a = s[0] * (8 - s[1] * (4 - s[2] * (2 - s[3])))
        levels[v] = a
        for i in range(order):
            bitmask[i, v] = bits[i] == 0
    return levels, bitmask


@functools.lru_cache(maxsize=None)
def pam_levels_scaled(scheme: str) -> np.ndarray:
    """float32 [2^(Qm/2)] per-axis levels of ``scheme`` (levels * scale,
    rounded as the JAX package rounds them)."""
    levels, _ = _pam_levels(BITS_PER_SYMBOL[scheme] // 2)
    return levels * _SCALE[scheme]


def _pam_mask0(order: int) -> np.ndarray:
    return _pam_levels(order)[1]


def _axis_llrs(y: torch.Tensor, order: int, scheme: str,
               noise_var: torch.Tensor) -> torch.Tensor:
    """Max-log LLRs for one real axis.  y [...] -> [..., order]."""
    lv = const(pam_levels_scaled, scheme, device=y.device)        # [L]
    d2 = (y[..., None] - lv) ** 2                                 # [..., L]
    big = 1e30
    m0 = const(_pam_mask0, order, device=y.device)                # [order, L]
    d2e = d2[..., None, :]
    d0 = torch.amin(torch.where(m0, d2e, big), dim=-1)            # [..., order]
    d1 = torch.amin(torch.where(~m0, d2e, big), dim=-1)
    return (d1 - d0) / torch.clamp_min(noise_var[..., None], 1e-12)


def demodulate(symbols: torch.Tensor, noise_var: torch.Tensor,
               scheme: str, first: int = 0) -> torch.Tensor:
    """Soft demap.  symbols complex [..., S], noise_var [..., S] ->
    llrs [..., S*Qm].  pi/2-BPSK derotates symbol n by -j for odd n, n
    counted along the last axis from ``first`` (the codeword index of the
    first symbol; the JAX package's convention counts from 0)."""
    qm = BITS_PER_SYMBOL[scheme]
    if scheme in ("bpsk", "pi2bpsk"):
        sym = symbols
        if scheme == "pi2bpsk":
            odd = (torch.arange(sym.shape[-1], device=sym.device)
                   + first) % 2 == 1
            sym = torch.where(odd, sym * -1j, sym)
        proj = (sym.real + sym.imag) * np.float32(2.0 * _SCALE[scheme])
        return 2.0 * proj / torch.clamp_min(noise_var, 1e-12)
    half = qm // 2
    li = _axis_llrs(symbols.real, half, scheme, noise_var)        # [..., S, half]
    lq = _axis_llrs(symbols.imag, half, scheme, noise_var)
    inter = torch.stack([li, lq], dim=-1)                         # [..., S, half, 2]
    return inter.reshape(symbols.shape[:-1] + (symbols.shape[-1] * qm,))
