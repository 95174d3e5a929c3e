"""Channel equalizer: ZF / MMSE for 1-4 layers x N rx ports.

Port of srsran_tpu/ops/equalizer.py (closed-form per-RE solves and a
batched L x L Gram solve, vectorized over all REs).  On the PUSCH receive
path the solves run inside the fused ops/ul_demap.py kernels (K3: ZF with
1-2 layers; K16: the rest); these are their plain forms.
"""

from __future__ import annotations

import torch


def _mean_nv(noise_var: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return noise_var.mean(dim=-1) if noise_var.ndim == y.ndim else noise_var


def equalize_zf_1xn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                    tx_scaling: float = 1.0):
    """1 layer, N ports.  y [..., P], h [..., P], noise_var [...] or [..., P].

    Returns (x_hat [...], eq_noise_var [...]).
    """
    nv = _mean_nv(noise_var, y)
    energy = torch.sum(h.abs() ** 2, dim=-1)
    corr = torch.sum(h.conj() * y, dim=-1)
    inv = 1.0 / torch.clamp_min(energy, 1e-12)
    x = corr * inv / tx_scaling
    out_nv = nv * inv / (tx_scaling ** 2)
    out_nv = torch.where(energy < 1e-12, 1e12, out_nv)
    return x.to(torch.complex64), out_nv.to(torch.float32)


def equalize_mmse_1xn(y: torch.Tensor, h: torch.Tensor,
                      noise_var: torch.Tensor, tx_scaling: float = 1.0):
    """MMSE, 1 layer, N ports.  y [..., P], h [..., P], noise_var [...] or
    [..., P].  Returns (x_hat [...], eq_noise_var [...])."""
    nv = _mean_nv(noise_var, y)
    energy = torch.sum(h.abs() ** 2, dim=-1)
    corr = torch.sum(h.conj() * y, dim=-1)
    denom = energy + nv / (tx_scaling ** 2)
    x = corr / torch.clamp_min(denom, 1e-12) / tx_scaling
    out_nv = (nv * energy / torch.clamp_min(denom, 1e-12) ** 2
              / (tx_scaling ** 2))
    out_nv = torch.where(energy < 1e-12, 1e12, out_nv)
    return x.to(torch.complex64), out_nv.to(torch.float32)


def equalize_zf_2xn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                    tx_scaling: float = 1.0):
    """2 layers, N ports.  y [..., P], h [..., P, 2], noise_var [...].

    Closed-form 2x2 Gram inverse.  Returns (x_hat [..., 2], nv [..., 2]).
    """
    nv = _mean_nv(noise_var, y)
    h0, h1 = h[..., 0], h[..., 1]
    a = torch.sum(h0.abs() ** 2, dim=-1)             # G00
    d = torch.sum(h1.abs() ** 2, dim=-1)             # G11
    b = torch.sum(h0.conj() * h1, dim=-1)            # G01
    det = a * d - b.abs() ** 2
    det = torch.where(det < 1e-12, 1e-12, det)
    z0 = torch.sum(h0.conj() * y, dim=-1)
    z1 = torch.sum(h1.conj() * y, dim=-1)
    x0 = (d * z0 - b * z1) / det / tx_scaling
    x1 = (a * z1 - b.conj() * z0) / det / tx_scaling
    nv0 = nv * d / det / (tx_scaling ** 2)
    nv1 = nv * a / det / (tx_scaling ** 2)
    x = torch.stack([x0, x1], dim=-1).to(torch.complex64)
    out_nv = torch.stack([nv0, nv1], dim=-1).to(torch.float32)
    return x, out_nv


def equalize_lxn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                 method: str = "zf", tx_scaling: float = 1.0):
    """L layers x N ports, ZF or MMSE, through batched Gram solves: every RE
    solves (H^H H + c I) x = H^H y with c = 1e-9 (ZF) or nv / beta^2
    (MMSE).  The output noise is nv [A^-1]_ll (ZF) or nv [A^-1 G A^-1]_ll
    (MMSE), 1e12 where that diagonal is not positive.

    y [..., P]; h [..., P, L]; noise_var [...] or [..., P].
    Returns (x [..., L], eq_noise_var [..., L]).
    """
    nv = _mean_nv(noise_var, y)
    nof_layers = h.shape[-1]
    gram = torch.einsum("...pl,...pm->...lm", h.conj(), h)
    z = torch.einsum("...pl,...p->...l", h.conj(), y)
    eye = torch.eye(nof_layers, dtype=gram.dtype, device=gram.device)
    if method == "mmse":
        ridge = (nv[..., None, None] / (tx_scaling ** 2)) * eye
    else:
        ridge = 1e-9 * eye
    a_inv = torch.linalg.inv(gram + ridge)
    x = torch.einsum("...lm,...m->...l", a_inv, z) / tx_scaling
    if method == "mmse":
        gi = torch.einsum("...lm,...mn,...nk->...lk", a_inv, gram, a_inv)
        diag_eff = torch.diagonal(gi, dim1=-2, dim2=-1).real
    else:
        diag_eff = torch.diagonal(a_inv, dim1=-2, dim2=-1).real
    out_nv = nv[..., None] * diag_eff / (tx_scaling ** 2)
    out_nv = torch.where(diag_eff <= 0, 1e12, out_nv)
    return x.to(torch.complex64), out_nv.to(torch.float32)


def equalize(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
             nof_layers: int, method: str = "zf", tx_scaling: float = 1.0):
    """Dispatch as the JAX package does: 1 layer ZF or MMSE 1xN; 2 layers
    ZF the closed form; 2 layers MMSE and 3-4 layers the L x N solve.

    y [..., P]; h [..., P, L]; returns (x [..., L], nv [..., L]).
    """
    if nof_layers == 1:
        fn = equalize_mmse_1xn if method == "mmse" else equalize_zf_1xn
        x, nv = fn(y, h[..., 0], noise_var, tx_scaling)
        return x[..., None], nv[..., None]
    if nof_layers == 2 and method == "zf":
        return equalize_zf_2xn(y, h, noise_var, tx_scaling)
    if 2 <= nof_layers <= 4:
        return equalize_lxn(y, h, noise_var, method, tx_scaling)
    raise NotImplementedError(f"{nof_layers}-layer equalization")
