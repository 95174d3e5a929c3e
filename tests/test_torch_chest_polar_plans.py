"""K8's and K15's host plans and numpy models of their kernels, on the CPU.

K8 (csrc/channel_estimate.cu): the TA as one (nfft / s)-point IDFT a row
-- the kernel's radix-4/2 Stockham modelled stage by stage on its plan --
against JAX ``_time_alignment`` (regular combs of stride 1, 2 and 4, comb
3, irregular type 0 combs); a numpy model of the whole kernel (LS values,
the CFO summed per CTA in the kernel's order and then over the ports in
rank order, the band coefficients, the stats, the TA over the ports)
against the twin ``estimate_from_grid_ref`` and JAX ``estimate``, within
the tolerances the GPU tests hold; the launch struct and its shared
memory.
K15 (csrc/polar_sc.cu): the step words and their round trip to the node
schedule, the CRC remainder table against JAX ``crc`` (crc6, crc11,
crc24C, and a DCI's syndrome), and a numpy model of the warp decoder
(register and shared levels, packed SAVE / COMB, the packed RATE_1
re-encode, the XOR-reduced CRC) against JAX ``sc_decode`` and the twin
``decode_ref``, bit for bit.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import channel_estimate as j_chest
from srsran_tpu.ops import crc as j_crc
from srsran_tpu.ops import polar as j_polar
from srsran_tpu.ran import polar_params as j_pp

from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import channel_estimate as chest
from srsran_tpu_torch.ops import polar
from srsran_tpu_torch.ops.crc import POLYS
from srsran_tpu_torch.phy.upper import pdcch
from srsran_tpu_torch.ran import polar_params as t_pp

torch.set_num_threads(2)

F32 = np.float32
NT = 512           # csrc/channel_estimate.cu kChestThreads


def _cgauss(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape)) / np.sqrt(2)
            ).astype(np.complex64)


# ------------------------------------------------------- K8 model pieces

def _mag2(x: np.ndarray) -> np.ndarray:
    """|x|^2 as the kernel and the twin take it: hypot, then squared."""
    m = np.hypot(x.real.astype(F32), x.imag.astype(F32)).astype(F32)
    return (m * m).astype(F32)


def _abs2(x: np.ndarray) -> np.ndarray:
    """|x|^2 as the kernel's statistics take it: x^2 + y^2."""
    return (x.real.astype(F32) * x.real.astype(F32)
            + x.imag.astype(F32) * x.imag.astype(F32)).astype(F32)


def _cta_sum(terms: np.ndarray):
    """The kernel's fixed-order CTA sum (cta_reduce) of one value a thread:
    row i of ``terms`` [n] or [n, m] is added, term by term, by thread i mod
    NT in row order; each warp's 32 partials meet in a shuffle-down tree,
    and the warps' sums (zeros past the last warp) in another."""
    terms = np.asarray(terms)
    part = np.zeros(NT, terms.dtype)
    for i in range(len(terms)):
        for v in np.atleast_1d(terms[i]):
            part[i % NT] = part[i % NT] + v

    def tree(v):
        v = v.copy()
        for o in (16, 8, 4, 2, 1):
            v[:32 - o] = v[:32 - o] + v[o:]
        return v[0]

    warps = np.zeros(32, terms.dtype)
    for w in range(NT // 32):
        warps[w] = tree(part[32 * w:32 * w + 32])
    return tree(warps)


def _dif(rows: np.ndarray) -> np.ndarray:
    """The kernel's TA transform of every row: the unscaled M-point IDFT as
    an in-place radix-4 decimation in frequency (a radix-2 stage last
    where log2 M is odd) in complex64, stage by stage on the host's
    twiddle tables, each position then read into its bin."""
    a = rows.astype(np.complex64).copy()
    m = a.shape[1]
    tw = chest._dif_twiddles(m)
    n, off = m, 0
    while n >= 4:
        q = n // 4
        w1, w2, w3 = (tw[off + i * q:off + (i + 1) * q] for i in range(3))
        x = a.reshape(a.shape[0], m // n, 4, q)
        xa, xb, xc, xd = (x[:, :, i].copy() for i in range(4))
        apc, amc = xa + xc, xa - xc
        bpd, bmd = xb + xd, xb - xd
        ibmd = (1j * bmd).astype(np.complex64)
        x[:, :, 0] = apc + bpd
        x[:, :, 1] = ((amc + ibmd) * w1).astype(np.complex64)
        x[:, :, 2] = ((apc - bpd) * w2).astype(np.complex64)
        x[:, :, 3] = ((amc - ibmd) * w3).astype(np.complex64)
        a = x.reshape(a.shape)
        off += 3 * q
        n = q
    if n == 2:
        x = a.reshape(a.shape[0], m // 2, 2)
        xa, xb = x[:, :, 0].copy(), x[:, :, 1].copy()
        x[:, :, 0], x[:, :, 1] = xa + xb, xa - xb
        a = x.reshape(a.shape)
    out = np.empty_like(a)
    out[:, chest._dif_bins(m)] = a
    return out


def test_dif_is_the_idft():
    """K8's transform (modelled) is the unscaled M-point IDFT, in natural
    bin order, at every size a TA row takes (M = 2 to 8192)."""
    rng = np.random.default_rng(3)
    for lg in range(1, 14):
        m = 1 << lg
        x = _cgauss(rng, (2, m))
        want = np.fft.ifft(x.astype(np.complex128), axis=-1) * m
        np.testing.assert_allclose(_dif(x), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def _ta_model(ls_avg: np.ndarray, p, ta_idx: np.ndarray,
              scs_hz: float) -> float:
    """The kernel's TA from ls_avg [P, L, K_sm]: each (port, layer) row
    packed at (ta_idx - ta_idx[0]) >> lg_s of M points and transformed;
    CTA r sums |.|^2 over rows r, r + C, ... in order, and rank 0 the
    CTAs' sums in rank order; the first maximum over the window."""
    n_p, n_l, _ = ls_avg.shape
    n_cta = p.P * p.G
    q = (ta_idx.astype(np.int64) - int(ta_idx[0])) >> p.lg_s
    rows = np.zeros((n_p * n_l, p.M), np.complex64)
    rows[:, q] = ls_avg.reshape(n_p * n_l, -1)
    h = _dif(rows)
    pw = np.zeros((n_cta, p.M), F32)
    for rho in range(n_p * n_l):
        pw[rho % n_cta] = pw[rho % n_cta] + _mag2(h[rho])
    m = np.arange(2 * p.maxd)
    n = np.where(m < p.maxd, m, p.nfft - 2 * p.maxd + m) & (p.M - 1)
    tot = np.zeros(len(m), F32)
    for r in range(n_cta):
        tot = tot + pw[r, n]
    idx = int(np.argmax(tot))
    delay = idx if idx < p.maxd else idx - 2 * p.maxd
    return float(F32(delay) / F32(p.span))


def _chunks(p) -> list:
    """The despread pilots [k_lo, k_hi) of each CTA (port, g) of a port."""
    return [(g * p.Ksm // p.G, (g + 1) * p.Ksm // p.G) for g in range(p.G)]


def _plan_parts(pilot_scs, first_sc, nsc, stride, cdm, shapes, symbols,
                nof_symbols=14, scs_hz=30e3, times=None, interp_idx=None,
                smoothing="filter"):
    """K8's tables and launch struct for one call, as the plan makes them
    (no card needed)."""
    key = chest._pilots_key(pilot_scs)
    ints, weights, k_sm = chest._chest_tables(key, first_sc, nsc, stride,
                                              smoothing, cdm)
    p = chest._chest_params(key, shapes, symbols, nsc, nof_symbols, scs_hz,
                            stride, 1.0, times, interp_idx, cdm,
                            weights.shape[1], chest._ta_shift(ints[-k_sm:]))
    return ints, weights, k_sm, p


# ----------------------------------------------- K8: the TA identity

def _irregular_scs(nrb_blocks, cdm_group=0) -> np.ndarray:
    """A type 0 allocation's DM-RS type 1 comb: PRB groups, 6 pilots a PRB
    at 2 i + cdm_group."""
    prbs = [b for lo, hi in nrb_blocks for b in range(lo, hi)]
    return np.asarray([12 * b + 2 * i + cdm_group for b in prbs
                       for i in range(6)], np.int64)


TA_CASES = {
    # name: (pilot subcarriers, nsc, stride, cdm, delay in samples)
    "stride1": (np.arange(48), 48, 1, False, 3.0),
    "stride1_neg": (np.arange(96), 96, 1, False, -5.0),
    "stride2": (2 * np.arange(144), 288, 2, False, 7.0),
    "stride2_neg": (2 * np.arange(72) + 1, 144, 2, False, -2.0),
    "stride4_cdm": (2 * np.arange(144), 288, 2, True, 4.0),
    "stride4_comb": (4 * np.arange(72) + 3, 288, 4, False, -6.0),
    "comb3": (3 * np.arange(8) + 1, 24, 3, False, 1.0),
    "comb3_wide": (3 * np.arange(64) + 1, 192, 3, False, -3.0),
    "type0_cdm": (_irregular_scs([(0, 4), (8, 12), (16, 20)]), 288, 2, True,
                  5.0),
    "type0": (_irregular_scs([(0, 2), (5, 9), (20, 24)], 1), 288, 2, False,
              -4.0),
}


@pytest.mark.parametrize("case", sorted(TA_CASES))
def test_ta_one_period_identity_matches_jax(case):
    """The kernel's TA -- one (nfft / s)-point transform a row, modelled
    stage by stage -- equals JAX ``_time_alignment`` on the nfft-point
    IDFT, for regular combs of stride 1, 2 and 4, comb 3 and irregular
    type 0 combs; the model's transform is the IDFT within float32."""
    scs, nsc, stride, cdm, delay = TA_CASES[case]
    rng = np.random.default_rng(len(case))
    n_k = len(scs)
    n_l, n_p = 2, 3
    shapes = ((n_p, 14, nsc), (n_l, 1, n_k))
    ints, _, k_sm, p = _plan_parts(scs, 0, nsc, stride, cdm, shapes, (2,))
    scs_sm = (scs[0::2] + scs[1::2]) // 2 if cdm else scs
    stride_sm = 2 * stride if cdm else stride
    np.testing.assert_array_equal(ints[-k_sm:], scs_sm)
    ramp = np.exp(-2j * np.pi * scs_sm * delay / p.nfft)
    ls_avg = (_cgauss(rng, (n_p, n_l, 1)) * ramp
              + _cgauss(rng, (n_p, n_l, k_sm), 0.1)).astype(np.complex64)
    want = float(j_chest._time_alignment(jnp.asarray(ls_avg), scs_sm, nsc,
                                         30e3, stride_sm))
    twin = float(chest._time_alignment(torch.as_tensor(ls_avg), scs_sm, nsc,
                                       30e3, stride_sm))
    got = _ta_model(ls_avg, p, ints[-k_sm:], 30e3)
    assert got == want == twin
    assert want != 0.0 or delay == 0.0
    # the transform is one period of the window (a power-of-two comb) or
    # nfft points (comb 3, odd offsets)
    period = stride_sm & -stride_sm
    assert p.M == p.nfft // min(period if case.startswith("stride") else
                                p.nfft // p.M, p.nfft // 2)


@pytest.mark.parametrize("nrb,stride,cdm,m", [(273, 2, False, 4096),
                                               (273, 2, True, 2048),
                                               (273, 4, False, 2048),
                                               (16, 1, False, 512),
                                               (16, 3, False, 512)])
def test_ta_transform_size(nrb, stride, cdm, m):
    """At 273 RB (nfft 8192) a row is 2048 points at the flagship's stride
    4 and 4096 at stride 2; the F3's stride 1 and the F2's comb 3 at 16 RB
    (nfft 512) take 512.  The window is the whole transform when the
    stride is a power of two."""
    nsc = 12 * nrb
    scs = stride * np.arange(nsc // stride)
    _, _, _, p = _plan_parts(scs, 0, nsc, stride, cdm,
                             ((4, 14, nsc), (2 if cdm else 1, 2, len(scs))),
                             (2, 11))
    assert (p.nfft >> p.lg_s, p.M) == (m, m)
    if stride != 3:
        assert 2 * p.maxd == p.M


def test_ta_transform_refuses_what_does_not_fit():
    """Every subcarrier a pilot over 273 RB (an 8192-point row beside 8
    CTAs' slices of 8192 bins) does not fit in a CTA's shared memory:
    the plan raises (no caller has such a comb; the F3/F4's is at most 16
    RB)."""
    scs = np.arange(3276)
    with pytest.raises(ValueError):
        _plan_parts(scs, 0, 3276, 1, False, ((4, 14, 3276), (1, 2, 3276)),
                    (2, 11))


# ------------------------------------------------ K8: the whole kernel

def _chest_model(grid, symbols, first_sc, expected, pilot_scs, nsc,
                 nof_symbols, scs_hz, stride=2, smoothing="filter",
                 beta_scaling=1.0, estimate_cfo=True,
                 dmrs_symbol_times_s=None, td_strategy="average",
                 dmrs_symbol_idx=None, cdm_pairs=False):
    """csrc/channel_estimate.cu in numpy on one slot: returns (coeffs,
    noise_var, rsrp, epre, snr, ta, cfo) in the kernel's orders."""
    n_p = grid.shape[0]
    n_l, n_s, n_k = expected.shape
    use_cfo = estimate_cfo and n_s >= 2 and dmrs_symbol_times_s is not None
    interp = (td_strategy == "interpolate" and dmrs_symbol_idx is not None
              and n_s >= 2)
    times = (tuple(float(t) for t in dmrs_symbol_times_s) if use_cfo
             else None)
    ints, weights, k_sm, p = _plan_parts(
        pilot_scs, first_sc, nsc, stride, cdm_pairs,
        (grid.shape, expected.shape), tuple(symbols), nof_symbols, scs_hz,
        times, tuple(int(i) for i in dmrs_symbol_idx) if interp else None,
        smoothing)
    p.beta, p.beta2 = beta_scaling, beta_scaling ** 2
    first, cols = ints[:nsc], ints[nsc:nsc + n_k]
    pidx, ta_idx = ints[nsc + n_k:nsc + 2 * n_k], ints[-k_sm:]
    rx = grid[:, list(symbols)][:, :, cols]                  # [P, S, K]
    ls1 = rx[:, None] * np.conj(expected)[None]
    ls1 = (ls1 / F32(p.beta2)).astype(np.complex64)          # [P, L, S, K]
    ls = (F32(0.5) * (ls1[..., 0::2] + ls1[..., 1::2])).astype(np.complex64) \
        if cdm_pairs else ls1
    cfo = F32(0.0)
    if use_cfo:
        acc = np.complex64(0)
        for port in range(n_p):
            # thread k adds its terms symbol by symbol, layer by layer; each
            # CTA (port, g) sums its chunk; the ranks in order
            prod = (ls[port, :, 1:] * np.conj(ls[port, :, :-1])).astype(
                np.complex64)                              # [L, S-1, K_sm]
            terms = np.zeros(k_sm, np.complex64)
            for s in range(n_s - 1):
                for layer in range(n_l):
                    terms = (terms + prod[layer, s]).astype(np.complex64)
            for lo, hi in _chunks(p):
                acc = np.complex64(acc + _cta_sum(terms[lo:hi]))
        cfo = F32(F32(np.arctan2(acc.imag, acc.real)) / F32(p.two_pi_dt))
        t = np.asarray(times, F32)
        ph = (F32(-6.2831855) * cfo * t).astype(F32)
        ls = (ls * (np.cos(ph) + 1j * np.sin(ph)).astype(np.complex64)[
            None, None, :, None]).astype(np.complex64)
    avg = np.zeros((n_p, n_l, k_sm), np.complex64)
    for s in range(n_s):
        avg = (avg + ls[:, :, s]).astype(np.complex64)
    avg = (avg / F32(n_s)).astype(np.complex64)

    def band(x, rows):                   # x [..., K_sm] -> [..., len(rows)]
        out = np.zeros(x.shape[:-1] + (len(rows),), np.complex64)
        for j in range(weights.shape[1]):
            out = (out + weights[rows, j] * x[..., first[rows] + j]).astype(
                np.complex64)
        return out

    n_all = np.arange(nsc)
    if interp:
        f_sym = band(ls, n_all)                              # [P, L, S, nsc]
        i0, w = chest._td_weights(dmrs_symbol_idx, nof_symbols)
        coeffs = (f_sym[:, :, i0] * (F32(1) - w)[:, None]
                  + f_sym[:, :, i0 + 1] * w[:, None]).astype(np.complex64)
    else:
        coeffs = band(avg, n_all)[:, :, None]
    filt = band(avg, pidx)                                   # [P, L, K]
    ph = np.zeros(n_s, F32) if not use_cfo else (
        F32(6.2831855) * cfo * np.asarray(times, F32)).astype(F32)
    rot = (np.cos(ph) + 1j * np.sin(ph)).astype(np.complex64)
    stats = []
    for port in range(n_p):
        r_terms = _abs2(filt[port].T)                        # [K, L]
        recon = np.zeros((n_k, n_s), np.complex64)
        for layer in range(n_l):
            t = (filt[port, layer][:, None] * expected[layer].T
                 * F32(p.beta)).astype(np.complex64)
            if use_cfo:
                t = (t * rot[None]).astype(np.complex64)
            recon = (recon + t).astype(np.complex64)
        x = rx[port].T                                       # [K, S]
        # EPRE: despread pilot k's thread, symbol by symbol, its pair
        pairs = _abs2(x).reshape(k_sm, -1, n_s).transpose(0, 2, 1)
        e_terms = np.zeros(k_sm, F32)
        for s in range(n_s):
            for j in range(pairs.shape[2]):
                e_terms = (e_terms + pairs[:, s, j]).astype(F32)
        nz_terms = _abs2((x - recon).astype(np.complex64))   # [K, S]
        per = n_k // k_sm
        # each CTA of the port sums its chunk; rank 0 the G sums in order
        e = r = nz = F32(0)
        for lo, hi in _chunks(p):
            e = F32(e + _cta_sum(e_terms[lo:hi]))
            r = F32(r + _cta_sum(r_terms[per * lo:per * hi]))
            nz = F32(nz + _cta_sum(nz_terms[per * lo:per * hi]))
        rsrp = F32(r / F32(n_l * n_k)) * F32(p.beta * p.beta)
        stats.append((e, F32(rsrp), nz))
    epre = np.asarray([s[0] / F32(n_s * n_k) for s in stats], F32)
    rsrp = np.asarray([s[1] for s in stats], F32)
    nv = np.asarray([s[2] / F32(n_s * n_k) for s in stats], F32)
    nv = np.maximum(nv, rsrp * F32(1e-6))
    snr = rsrp / np.maximum(nv, F32(1e-12))
    ta = _ta_model(avg, p, ta_idx, scs_hz)
    return coeffs, nv, rsrp, epre, snr, ta, float(cfo)


def _pusch_times(symbols):
    t = np.array([0.0714, 0.1428, 0.2142, 0.2857, 0.3571, 0.4285, 0.5,
                  0.5714, 0.6428, 0.7142, 0.7857, 0.8571, 0.9285, 0.98])
    return t[list(symbols)] * 1e-3


MODEL_CASES = {
    # name: (P, L, symbols, nrb, stride, cdm, td, cfo, delay)
    "pusch_2l_cdm": (4, 2, (2, 11), 24, 2, True, "average", True, 3.0),
    "pusch_2l_interp": (2, 2, (2, 7, 11), 12, 2, True, "interpolate", True,
                        -2.0),
    "pusch_1l": (4, 1, (2, 11), 20, 2, False, "average", True, 5.0),
    "srs_4p_comb4": (4, 4, (13,), 24, 4, False, "average", False, 2.0),
    "srs_2p_comb2": (2, 2, (12, 13), 16, 2, False, "average", False, -1.0),
    "f2_comb3": (4, 1, (11, 12), 2, 3, False, "average", False, 1.0),
    "f3_stride1": (2, 1, (3, 10), 4, 1, False, "average", False, 2.0),
    "type0_cdm": (4, 2, (2, 11), 24, 2, True, "average", True, 4.0),
    "type0_interp": (2, 2, (2, 11), 24, 2, True, "interpolate", True, -3.0),
}


def _model_case(case):
    n_p, n_l, symbols, nrb, stride, cdm, td, cfo, delay = MODEL_CASES[case]
    rng = np.random.default_rng(len(case) * 7)
    nsc = 12 * nrb
    if case.startswith("type0"):
        scs = _irregular_scs([(0, 4), (8, 14), (18, 24)])
    elif case.startswith("f2"):
        scs = 3 * np.arange(4 * nrb) + 1
    else:
        scs = stride * np.arange(nsc // stride) + (1 if case == "pusch_1l"
                                                   else 0)
    first_sc = 12
    nfft = 1 << int(np.ceil(np.log2(2 * nsc)))
    ramp = np.exp(-2j * np.pi * np.arange(nsc) * delay / nfft)
    h = _cgauss(rng, (n_p, n_l, 1)) * ramp                  # [P, L, nsc]
    expected = _cgauss(rng, (n_l, len(symbols), len(scs)))
    if cdm:                              # the fd-OCC cover on layer 1
        expected[1, :, 1::2] *= -1
    grid = _cgauss(rng, (n_p, 14, nsc + 24), 0.05)
    for i, s in enumerate(symbols):
        grid[:, s, first_sc + scs] += (h[:, :, scs] * expected[None, :, i]
                                       ).sum(axis=1)
    kw = dict(stride=stride, estimate_cfo=cfo,
              dmrs_symbol_times_s=_pusch_times(symbols) if cfo else None,
              td_strategy=td, dmrs_symbol_idx=np.asarray(symbols),
              cdm_pairs=cdm)
    return (grid.astype(np.complex64), tuple(symbols), first_sc, expected,
            scs, nsc, 14, 30e3), kw


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_chest_kernel_model_matches_twin_and_jax(case):
    """The numpy model of the one-launch kernel (its LS values, the CFO
    summed per CTA in its order and then over the ports in rank order, its
    band coefficients and stats, its TA over the ports) against the twin
    and JAX ``estimate``: the TA equal, the CFO within 1e-2 Hz, the rest
    within 1e-4 of the largest magnitude -- what the GPU tests hold."""
    args, kw = _model_case(case)
    grid, symbols, first_sc, expected, scs, nsc = args[:6]
    coeffs, nv, rsrp, epre, snr, ta, cfo = _chest_model(*args, **kw)
    twin = chest.estimate_from_grid_ref(
        torch.as_tensor(grid), symbols, first_sc, torch.as_tensor(expected),
        scs, nsc, 14, 30e3, **kw)
    rx = grid[:, list(symbols)][:, :, first_sc + scs]
    jax_est = j_chest.estimate(jnp.asarray(rx), jnp.asarray(expected), scs,
                               nsc, 14, 30e3, **kw)
    for ref in (twin, jax_est):
        assert ta == float(ref.time_alignment_s)
        assert abs(cfo - float(ref.cfo_hz)) < 1e-2
        _close(coeffs, np.asarray(ref.coeffs))
        for got, key in ((nv, "noise_var"), (rsrp, "rsrp"), (epre, "epre"),
                         (snr, "snr")):
            _close(got, np.asarray(getattr(ref, key)))
    assert ta != 0.0


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_chest_struct_fits_the_card(case):
    """The launch struct: its sizes, the cluster (G CTAs a port, at most 8
    in all) and its chunks, the dynamic shared memory, the window and the
    time span."""
    args, kw = _model_case(case)
    grid, symbols, first_sc, expected, scs, nsc = args[:6]
    n_p, n_l = grid.shape[0], expected.shape[0]
    interp = kw["td_strategy"] == "interpolate"
    _, weights, k_sm, p = _plan_parts(
        scs, first_sc, nsc, kw["stride"], kw["cdm_pairs"],
        (grid.shape, expected.shape), symbols, 14, 30e3, None,
        symbols if interp else None)
    assert (p.P, p.L, p.S, p.K, p.Ksm) == (n_p, n_l, len(symbols), len(scs),
                                           k_sm)
    assert p.nsym_out == (14 if interp else 1) and p.W == weights.shape[1]
    g, chunk = chest._chest_cluster(n_p, k_sm)
    assert (p.G, p.chunk) == (g, chunk) and p.P * p.G <= 8
    assert p.nfft == p.M << p.lg_s
    per_port = n_l * ((len(symbols) if interp else 0) + 1) * k_sm
    assert p.smem == (8 * (2 * p.M + per_port + n_l * len(symbols) * chunk
                           + 2 * len(symbols) * chunk)
                      + 4 * (p.M + n_p * g * -(-2 * p.maxd // (n_p * g))))
    assert p.smem <= chest.CHEST_SMEM
    assert p.span == np.float32(p.nfft * 30e3)
    assert ctypes.sizeof(p) < 4096          # a kernel parameter by value
    if interp:
        i0, w = chest._td_weights(symbols, 14)
        assert list(p.td_i0)[:14] == i0.tolist()
        assert np.allclose(list(p.td_w)[:14], w)


def test_chest_struct_refuses_what_the_kernel_does_not_take():
    scs = 2 * np.arange(24)
    with pytest.raises(ValueError):      # 9 rx ports: past a cluster
        _plan_parts(scs, 0, 48, 2, False, ((9, 14, 48), (1, 1, 24)), (2,))
    with pytest.raises(ValueError):      # 5 layers: past the kernel's 4
        _plan_parts(scs, 0, 48, 2, False, ((4, 14, 48), (5, 1, 24)), (2,))
    with pytest.raises(ValueError):      # pilots and expected disagree
        _plan_parts(scs, 0, 48, 2, False, ((4, 14, 48), (1, 1, 23)), (2,))
    with pytest.raises(ValueError):      # an odd count under fd-OCC
        _plan_parts(np.arange(5), 0, 48, 2, True, ((4, 14, 48), (2, 1, 5)),
                    (2,))
    with pytest.raises(ValueError):      # a slot axis on the pilots alone
        _plan_parts(scs, 0, 48, 2, False, ((4, 14, 48), (3, 1, 1, 24)), (2,))


def test_chest_struct_at_the_flagship():
    """The flagship PUSCH: 4 ports, 2 layers with fd-OCC over 269 RB: a
    cluster of 8 CTAs, 2 a port with 404 despread pilots each, a
    2048-point TA row, in about 90 KB a CTA."""
    scs = 2 * np.arange(6 * 269)
    _, w, k_sm, p = _plan_parts(scs, 0, 3228, 2, True,
                                ((4, 14, 3276), (2, 2, len(scs))), (2, 11),
                                times=(1e-4, 4e-4))
    assert (k_sm, w.shape[1], p.M, p.maxd) == (807, 8, 2048, 1024)
    assert (p.G, p.chunk) == (2, 404)
    assert p.smem < 90_000 and p.use_cfo == 1


# ------------------------------------------------ K15: the step words

def _jt_codes(k, e, n_pc=0, nmax=10, ibil=True):
    return (j_pp.polar_code(k, e, nmax=nmax, ibil=ibil, n_pc=n_pc),
            t_pp.polar_code(k, e, nmax=nmax, ibil=ibil, n_pc=n_pc))


POLAR_CODES = {
    # name: (K', E, n_pc, nmax, ibil, crc)
    "f2": (33, 64, 0, 10, True, "crc11"),
    "n32_pc": (18, 32, 3, 10, True, "crc6"),
    "shortened": (18, 40, 3, 10, True, "crc6"),
    "punctured": (40, 50, 0, 10, True, "crc11"),
    "repeated": (25, 300, 0, 10, True, "crc11"),
    "n512": (31, 600, 0, 10, True, "crc11"),
    "pbch": (56, 864, 0, 9, False, "crc24C"),
    "al16": (63, 1728, 0, 9, False, "crc24C"),
    "n1024": (111, 1000, 0, 10, True, "crc11"),
    "n1024_k200": (200, 1024, 0, 10, True, "crc11"),
}


_SAVE = 4      # the twin's row keeping the left child's bits


def _node_rows(fro: np.ndarray, lo: int, m: int, out: list) -> None:
    """Append the rows (op, log2 m, first u index) of the twin's recursion
    (``polar.sc_decode``) over the node of ``m`` positions from ``lo``:
    RATE_0 / RATE_1 leaves, F / G (the LLRs of the left / right child),
    SAVE (keep the left child's bits) and COMB (x from both children)."""
    f = fro[lo:lo + m]
    lg = int(m).bit_length() - 1
    if f.all() or not f.any():
        out.append((polar._OP_R0 if f.all() else polar._OP_R1, lg, lo))
        return
    h = m // 2
    out.append((polar._OP_F, lg, lo))
    _node_rows(fro, lo, h, out)
    out.append((_SAVE, lg, lo))
    out.append((polar._OP_G, lg, lo))
    _node_rows(fro, lo + h, h, out)
    out.append((polar._OP_COMB, lg, lo))


def _twin_rows(frozen: bytes) -> np.ndarray:
    """int32 [n_rows, 3]: the twin's recursion over this frozen mask."""
    fro = np.frombuffer(frozen, dtype=np.uint8).astype(bool)
    rows = []
    _node_rows(fro, 0, len(fro), rows)
    return np.asarray(rows, dtype=np.int32)


def _unwords(words: np.ndarray) -> np.ndarray:
    """The twin's rows back from K15's words: each G word a SAVE and a G
    row, each SUB word its node's rows."""
    out = []
    for w in np.asarray(words, np.int64):
        op, lg = int(w & 7), int(w >> polar._LG_SHIFT & 15)
        if op == polar._OP_SUB:
            lo = int(w >> polar._SUB_LO_SHIFT & 63) * polar.SUB_M
            fro = np.zeros(lo + polar.SUB_M, bool)
            fro[lo:] = (int(w >> polar._SUB_MASK_SHIFT)
                        >> np.arange(polar.SUB_M)) & 1
            _node_rows(fro, lo, polar.SUB_M, out)
            continue
        lo = int(w >> polar._LO_SHIFT)
        if op == polar._OP_G:
            out.append((_SAVE, lg, lo))
        out.append((op, lg, lo))
    return np.asarray(out, dtype=np.int32).reshape(-1, 3)


@pytest.mark.parametrize("name", sorted(POLAR_CODES))
def test_sc_words_round_trip(name):
    """One word a step (op | log2 m << 3 | first u << 7), SAVE folded into
    the G after it, a mixed node of 16 one SUB word with its frozen flags;
    the words give the node schedule back, row for row."""
    k, e, n_pc, nmax, ibil, _ = POLAR_CODES[name]
    _, code = _jt_codes(k, e, n_pc, nmax, ibil)
    frozen = np.asarray(code.frozen_mask, np.uint8).tobytes()
    prog = _twin_rows(frozen)
    words = polar._sc_words(frozen)
    assert words.dtype == np.uint32
    assert len(words) < len(prog) - int((prog[:, 0] == _SAVE).sum())
    np.testing.assert_array_equal(_unwords(words), prog)
    ops = words & 7
    assert set(ops.tolist()) <= {polar._OP_R0, polar._OP_R1, polar._OP_F,
                                 polar._OP_G, polar._OP_COMB, polar._OP_SUB}
    lg = (words >> 3) & 15
    sub = ops == polar._OP_SUB
    assert lg.min() >= 4 and np.all(lg[sub] == 4)     # no node below 16
    mask = words[sub] >> 13
    assert np.all((mask > 0) & (mask < 0xffff))        # mixed nodes only
    lo = words[~sub] >> 7
    assert lg.max() <= code.n and lo.max() < code.big_n
    assert np.all(lo % (1 << lg[~sub]) == 0)            # a node on its size


def test_sc_words_step_counts():
    """The steps the kernel walks: the F2's 121 rows in 13 words, the
    PBCH's 381 in 65, N = 1024 (K = 111, E = 1000) 591 in 113."""
    for name, rows, words in (("f2", 121, 13), ("pbch", 381, 65),
                              ("n1024", 591, 113)):
        k, e, n_pc, nmax, ibil, _ = POLAR_CODES[name]
        _, code = _jt_codes(k, e, n_pc, nmax, ibil)
        frozen = np.asarray(code.frozen_mask, np.uint8).tobytes()
        assert (len(_twin_rows(frozen)),
                len(polar._sc_words(frozen))) == (rows, words)


# ------------------------------------------------ K15: the CRC table

@pytest.mark.parametrize("crc_name,k", [("crc6", 18), ("crc6", 30),
                                        ("crc11", 33), ("crc11", 111),
                                        ("crc24C", 56), ("crc24C", 164)])
def test_crc_remainder_table_matches_jax(crc_name, k):
    """The XOR of the remainder words of the set bits is JAX ``crc`` of the
    K bits, as a word MSB first; 0 for a message with its own CRC."""
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (16, k)).astype(np.int8)
    length = POLYS[crc_name][0]
    bits[0, k - length:] = np.asarray(j_crc.crc(jnp.asarray(
        bits[0:1, :k - length]), crc_name))[0]
    words = _rem_words(k, crc_name)
    reg = np.bitwise_xor.reduce(np.where(bits == 1, words[None], 0), axis=1)
    want = np.asarray(j_crc.crc(jnp.asarray(bits), crc_name)).astype(
        np.int64) @ (1 << np.arange(length - 1, -1, -1))
    np.testing.assert_array_equal(reg, want)
    assert reg[0] == 0


def _table_key(k, crc_name):
    code = t_pp.polar_code(k, 4 * k, nmax=10, ibil=True)
    keys = polar._code_keys(code)
    return (*keys["tables"], *keys["readout"], crc_name)


def _rem_words(k, crc_name):
    """The remainder words as the kernel's table holds them (after the
    rate dematch's rounds and the read-out)."""
    key = _table_key(k, crc_name)
    table = polar._decode_table(*key)
    return table[-k:].view(np.uint32)


@pytest.mark.parametrize("rnti", [0x0001, 0x4601, 0xffff])
def test_crc_register_checks_a_dci(rnti):
    """A DCI's check (CRC24C over 24 ones and the decoded bits with the RNTI
    mask undone, JAX pdcch.py:97-100) is the register of its A + 24 bits
    equal to ``dci_syndrome``: true for its own RNTI, false for another."""
    a = 39
    rng = np.random.default_rng(rnti)
    payload = rng.integers(0, 2, a).astype(np.int8)
    ones = np.ones(24, np.int8)
    c = np.array(j_crc.crc(jnp.asarray(np.concatenate([ones, payload])[None]),
                           "crc24C"))[0]
    c[8:] ^= pdcch._rnti_mask(rnti)
    msg = np.concatenate([payload, c])
    words = _rem_words(a + 24, "crc24C")
    reg = int(np.bitwise_xor.reduce(words[msg == 1]))
    assert reg == pdcch.dci_syndrome(a, rnti)
    assert reg != pdcch.dci_syndrome(a, rnti ^ 0x10)
    unmasked = msg.copy()
    unmasked[a + 8:] ^= pdcch._rnti_mask(rnti)
    assert bool(np.asarray(j_crc.crc_check(jnp.asarray(
        np.concatenate([ones, unmasked])[None]), "crc24C"))[0])


# ------------------------------------------- K15: the warp decoder model

_FULL = 0xffffffff
_LANES = np.arange(32)


def _low(m):
    return _FULL if m >= 32 else (1 << m) - 1


def _butterfly_word(w, m):
    for half, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0f0f0f0f),
                       (8, 0x00ff00ff), (16, 0x0000ffff)):
        if m > half:
            w ^= (w >> half) & mask
    return w


def _ballot(pred) -> int:
    return int(np.sum(np.asarray(pred, np.uint64) << _LANES.astype(np.uint64)))


def _fnode(a, b):
    return (np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))
            ).astype(F32)


def _gnode(a, b, x):
    return (b + (F32(1) - F32(2) * np.asarray(x).astype(F32)) * a).astype(F32)


def _sc_small(v: np.ndarray, mask: int, m: int) -> tuple:
    """csrc/polar_sc.cu's sc_small: the node of m positions with LLRs v
    decided by the twin's recursion (mask bit i: position i frozen);
    returns its hard bits x and decided bits u as words."""
    full = (1 << m) - 1
    mask &= full
    if mask == full:
        return 0, 0
    if mask == 0:
        x = _ballot(np.concatenate([v < 0, np.zeros(32 - m, bool)]))
        return x, _butterfly_word(x, m)
    h = m // 2
    xl, ul = _sc_small(_fnode(v[:h], v[h:]), mask, h)
    bits = (xl >> np.arange(h)) & 1
    xr, ur = _sc_small(_gnode(v[:h], v[h:], bits), mask >> h, h)
    return (xl ^ xr) | (xr << h), ul | (ur << h)


def _warp_decode(llr: np.ndarray, code, crc_name: str, syndrome: int = 0):
    """csrc/polar_sc.cu's warp on one codeword, lane by lane: returns (the
    K message bits, the CRC flag)."""
    keys = polar._code_keys(code)
    table = polar._decode_table(*keys["tables"], *keys["readout"], crc_name)
    p = polar._decode_params(code, crc_name, syndrome, (1, code.e))
    n_big, e, k = code.big_n, code.e, code.k
    dem = table[:p.R * n_big].reshape(p.R, n_big)
    readout = table[p.R * n_big:p.R * n_big + k]
    rem = table[-k:].view(np.uint32)
    words = np.asarray(p.words[:p.nops], np.uint32)
    ls = np.zeros(2 * n_big, F32)
    for q in range(n_big):
        acc = F32(0)
        for j in range(p.R):
            if dem[j, q] >= 0:
                acc = F32(acc + llr[dem[j, q]])
        ls[q] = F32(1e4) if dem[0, q] == -2 else acc
    r = [np.zeros(32, F32) for _ in range(6)]
    xs = [0] * 6
    xw = [np.zeros(32, np.int64) for _ in range(11)]
    u = np.zeros(32, np.int64)
    if code.n == 5:
        r[5] = ls[:32].copy()
    for word in words:
        op, lg = int(word & 7), int(word >> 3 & 15)
        if op == polar._OP_SUB:                 # a node of 16, whole
            lo = int(word >> 7 & 63) * 16
            x, uu = _sc_small(r[4][:16].copy(), int(word >> 13), 16)
            xs[4] = x
            u[lo >> 5] |= uu << (lo & 31)
            continue
        lo = int(word >> 7)
        m, h = 1 << lg, 1 << lg >> 1
        lm, lh = 2 * n_big - 2 * m, 2 * n_big - m
        if lg <= 5:
            if op == polar._OP_R0:
                xs[lg] = 0
            elif op == polar._OP_R1:
                x = _ballot(r[lg] < 0) & _low(m)
                xs[lg] = x
                u[lo >> 5] |= _butterfly_word(x, m) << (lo & 31)
            elif op == polar._OP_COMB:
                rr = xs[lg - 1] & _low(h)
                xs[lg] = ((xs[lg] ^ rr) & _low(h)) | (rr << h)
            else:
                a, b = r[lg], r[lg][(_LANES + h) & 31]
                if op == polar._OP_F:
                    r[lg - 1] = _fnode(a, b)
                else:
                    xs[lg] = xs[lg - 1] & _low(h)
                    r[lg - 1] = _gnode(a, b, (xs[lg - 1] >> _LANES) & 1)
        else:
            hw = h >> 5 if lg >= 7 else 0
            if op == polar._OP_R0:
                xw[lg][:] = 0
            elif op == polar._OP_R1:
                nw = m >> 5
                x = np.zeros(32, np.int64)
                for kk in range(nw):
                    x[kk] = _ballot(ls[lm + 32 * kk + _LANES] < 0)
                xw[lg] = x.copy()
                v = np.asarray([_butterfly_word(int(w), 32) for w in x])
                s = 1
                while s < nw:
                    o = v[_LANES ^ s]
                    v = np.where(_LANES & s, v, v ^ o)
                    s <<= 1
                w0 = lo >> 5
                u[w0:w0 + nw] = v[:nw]
            elif op == polar._OP_COMB:
                if lg == 6:
                    xw[6][0] ^= xs[5]
                    xw[6][1] = xs[5]
                else:
                    rr = xw[lg - 1]
                    moved = rr[(_LANES - hw) & 31]
                    xw[lg] = np.where(_LANES < hw, xw[lg] ^ rr,
                                      np.where(_LANES < 2 * hw, moved,
                                               xw[lg]))
            elif lg == 6:
                a, b = ls[lm:lm + 32], ls[lm + 32:lm + 64]
                if op == polar._OP_F:
                    r[5] = _fnode(a, b)
                else:
                    xw[6][0] = xs[5]
                    r[5] = _gnode(a, b, (xs[5] >> _LANES) & 1)
            elif op == polar._OP_F:
                ls[lh:lh + h] = _fnode(ls[lm:lm + h], ls[lm + h:lm + m])
            else:
                left = xw[lg - 1].copy()
                xw[lg] = np.where(_LANES < hw, left, xw[lg])
                bit = (left[np.arange(h) >> 5] >> (np.arange(h) & 31)) & 1
                ls[lh:lh + h] = _gnode(ls[lm:lm + h], ls[lm + h:lm + m], bit)
    bits = ((u[readout >> 5] >> (readout & 31)) & 1).astype(np.int8)
    reg = int(np.bitwise_xor.reduce(rem[bits == 1], initial=0))
    return bits, reg == p.expect


@pytest.mark.parametrize("name", sorted(POLAR_CODES))
def test_warp_decoder_model_matches_jax_and_twin(name):
    """The numpy model of the warp decoder -- register levels with
    shuffles, packed SAVE / COMB, the packed RATE_1 re-encode, the
    XOR-reduced CRC -- gives JAX ``sc_decode``'s and the twin's bits and
    the twin's CRC flags, bit for bit: noisy codewords, exact zeros, an
    all-zero codeword and a flipped one."""
    k, e, n_pc, nmax, ibil, crc_name = POLAR_CODES[name]
    jcode, code = _jt_codes(k, e, n_pc, nmax, ibil)
    rng = np.random.default_rng(k * e)
    msg = rng.integers(0, 2, (4, k)).astype(np.int8)
    length = POLYS[crc_name][0]
    msg[:2, k - length:] = np.asarray(j_crc.crc(jnp.asarray(
        msg[:2, :k - length]), crc_name))
    x = polar.rate_match(polar.encode(polar.allocate(torch.as_tensor(msg),
                                                     code), code.n),
                         code).numpy()
    llr = ((1.0 - 2.0 * x) + 0.7 * rng.standard_normal(x.shape)).astype(F32)
    llr[1, ::5] = 0.0
    llr[2] = 0.0
    llr[3] = -llr[0]
    want = np.asarray(j_polar.sc_decode(j_polar.rate_dematch(
        jnp.asarray(llr), jcode), jcode))
    bits_ref, ok_ref = polar.decode_ref(torch.as_tensor(llr), code, crc_name)
    np.testing.assert_array_equal(bits_ref.numpy(), want)
    for b in range(4):
        bits, ok = _warp_decode(llr[b], code, crc_name)
        np.testing.assert_array_equal(bits, want[b])
        assert ok == bool(ok_ref[b])
    assert bool(ok_ref[2])                  # all-zero: a zero CRC


@pytest.mark.parametrize("rnti", [0x4601, 0x00c3])
def test_warp_decoder_model_checks_a_dci_syndrome(rnti):
    """An AL16 DCI for ``rnti`` decodes with the CRC flag set against its
    own syndrome and cleared against another RNTI's."""
    a = 39
    code = pdcch._dci_code(a + 24, 16 * pdcch.BITS_PER_CCE)
    rng = np.random.default_rng(rnti)
    payload = rng.integers(0, 2, a).astype(np.int8)
    c = np.array(j_crc.crc(jnp.asarray(np.concatenate(
        [np.ones(24, np.int8), payload])[None]), "crc24C"))[0]
    c[8:] ^= pdcch._rnti_mask(rnti)
    msg = torch.as_tensor(np.concatenate([payload, c])[None])
    x = polar.rate_match(polar.encode(polar.allocate(msg, code), code.n),
                         code).numpy()
    llr = ((1.0 - 2.0 * x[0]) + 0.5 * rng.standard_normal(x.shape[1])
           ).astype(F32)
    syn = pdcch.dci_syndrome(a, rnti)
    bits, ok = _warp_decode(llr, code, "crc24C", syn)
    np.testing.assert_array_equal(bits, msg[0].numpy())
    assert ok
    ref_bits, ref_ok = polar.decode_ref(torch.as_tensor(llr[None]), code,
                                        "crc24C", syn)
    assert bool(ref_ok[0]) and torch.equal(ref_bits[0], msg[0])
    _, bad = _warp_decode(llr, code, "crc24C",
                          pdcch.dci_syndrome(a, rnti ^ 0x0100))
    assert not bad


def test_decode_struct_and_table():
    """K15's struct and table: a warp a codeword, up to 4 a CTA over a
    slot batch; the expected register masked to the CRC; the schedule by
    value; the table's parts (the rate dematch's rounds against the index
    plans, the read-out, the remainder words)."""
    for k, e, n_pc in ((18, 40, 3), (25, 300, 0), (40, 50, 0)):
        code = t_pp.polar_code(k, e, nmax=10, ibil=True, n_pc=n_pc)
        p = polar._decode_params(code, "crc6", 0x1ff, (3, 5, e))
        assert (p.B, p.E, p.n, p.K, p.warps) == (15, e, code.n, k, 4)
        assert p.expect == 0x3f and p.R == -(-e // code.big_n)
        words = polar._sc_words(np.asarray(code.frozen_mask,
                                           np.uint8).tobytes())
        assert list(p.words[:p.nops]) == words.tolist()
        assert not any(p.words[p.nops:])
        keys = polar._code_keys(code)
        table = polar._decode_table(*keys["tables"], *keys["readout"], "crc6")
        n = code.big_n
        dem = table[:p.R * n].reshape(p.R, n)
        # every received LLR lands once, at the mother position of its
        # transmitted bit (the inverse interleaver folded in)
        plan = polar._rm_plan(n, e, code.mode)
        src = polar._dematch_tables(n, e, code.mode, code.ibil)[0, n:]
        got = sorted((int(dem[j, q]), q) for j in range(p.R)
                     for q in range(n) if dem[j, q] >= 0)
        assert got == sorted((int(src[i]), int(plan[i])) for i in range(e))
        short = polar._dematch_tables(n, e, code.mode, code.ibil)[1, :n]
        np.testing.assert_array_equal(dem[0] == -2, short == 1)
        np.testing.assert_array_equal(table[p.R * n:p.R * n + k],
                                      polar._readout(*keys["readout"]))
        assert len(table) == p.R * n + 2 * k
    assert polar._decode_params(code, "crc6", 0, (1, code.e)).warps == 1
    with pytest.raises(ValueError):
        polar._decode_params(code, "crc6", 0, (2, code.e + 1))
    assert ctypes.sizeof(_build.PolarDecodeParams) == 32 + 4 * 2048
