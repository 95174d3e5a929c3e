"""The host side of K18 and K19 (csrc/dft_s_ofdm.cu) on the CPU: the
mixed-radix IDFT plan, a plain PyTorch model of the kernels' Stockham
stages held to the JAX package's ``deprecode``, and the parameter structs
each wrapper builds for the cell edge's shapes.

The model (:func:`stockham_idft`) runs the stages of
``transform_precode.fft_plan`` with the kernel's index maps -- butterfly j
reads j + r M / R, twiddles element r by ``twiddles(M)[r k step]`` with k =
j mod span, writes (j - k) R + k + r span -- in complex64, so an index-map
error in any radix shows without a card.  Tolerance: 2e-5 of the largest
magnitude (float32 stages against the JAX complex64 matmul; both are
within ~1e-6 of the exact transform at M = 3240).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import transform_precode as j_tp

from srsran_tpu_torch import flagship
from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import transform_precode as t_tp
from srsran_tpu_torch.ops import ul_demap
from srsran_tpu_torch.ops.modulation import pam_levels_scaled
from srsran_tpu_torch.phy.upper import pucch, pusch

torch.set_num_threads(2)


def _smooth(n: int) -> bool:
    for f in (2, 3, 5):
        while n % f == 0:
            n //= f
    return n == 1


# Every DFT-s-OFDM size: M = 12 n_RB, n_RB = 2^a 3^b 5^c up to 273 RB.
LEGAL_M = tuple(12 * n for n in range(1, 274) if _smooth(n))


def test_legal_sizes():
    assert len(LEGAL_M) == 53 and LEGAL_M[0] == 12 and LEGAL_M[-1] == 3240


@pytest.mark.parametrize("m", LEGAL_M)
def test_fft_plan(m):
    """The radix plan: radices from {2, 3, 4, 5} multiplying to M, spans
    the running products, steps M / (span R), magic numbers whose 32-bit
    high product with every butterfly index j is j // span, within the
    struct's stages; 1 / sqrt(M) rounded once from float64."""
    radices = t_tp.fft_radices(m)
    assert set(radices) <= {2, 3, 4, 5} and int(np.prod(radices)) == m
    assert len(radices) <= _build.FFT_MAX_STAGES
    p = t_tp.fft_plan(m)
    assert (p.M, p.stages) == (m, len(radices))
    span = 1
    for s, r in enumerate(radices):
        assert (p.radix[s], p.span[s], p.step[s]) == (r, span, m // (span * r))
        j = np.arange(m // r, dtype=np.uint64)
        if span == 1:
            assert p.magic[s] == 0
        else:
            assert np.array_equal(
                (j * np.uint64(p.magic[s])) >> np.uint64(32),
                j // np.uint64(span))
        span *= r
    assert all(p.radix[s] == 0 for s in range(len(radices),
                                              _build.FFT_MAX_STAGES))
    assert p.scale == float(np.float32(1 / np.sqrt(np.float64(m))))


@pytest.mark.parametrize("n", [7, 14, 3276, 0])
def test_fft_plan_refuses_other_sizes(n):
    with pytest.raises(ValueError):
        t_tp.fft_plan(n)


def _idft_small(vals: list, tw: torch.Tensor, m: int) -> list:
    """R-point inverse DFT of ``vals`` with the roots from the table."""
    r_len = len(vals)
    return [sum(vals[r] * tw[(r * q % r_len) * (m // r_len)]
                for r in range(r_len)) for q in range(r_len)]


def stockham_idft(v: torch.Tensor) -> torch.Tensor:
    """The kernels' unitary IDFT over the last axis: the plan's Stockham
    stages on ping-pong arrays, then 1 / sqrt(M)."""
    m = v.shape[-1]
    p = t_tp.fft_plan(m)
    tw = torch.from_numpy(t_tp.twiddles(m))
    src = v
    for s in range(p.stages):
        r_len, span, step = p.radix[s], p.span[s], p.step[s]
        nb = m // r_len
        j = torch.arange(nb)
        k = j - ((j * p.magic[s]) >> 32) * span if span > 1 else 0 * j
        vals = [src[..., j + r * nb] * (tw[r * k * step] if r else 1)
                for r in range(r_len)]
        out = _idft_small(vals, tw, m)
        dst = torch.empty_like(src)
        d = (j - k) * r_len + k
        for r in range(r_len):
            dst[..., d + r * span] = out[r]
        src = dst
    return src * p.scale


@pytest.mark.parametrize("m", LEGAL_M)
def test_stockham_model_matches_jax_deprecode(m):
    rng = np.random.default_rng(m)
    y = ((rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m)))
         / np.sqrt(2)).astype(np.complex64)
    ref = np.asarray(j_tp.deprecode(jnp.asarray(y)))
    got = stockham_idft(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-5 * float(np.abs(ref).max()))


def test_twiddle_table_is_unscaled_roots():
    """The kernels' table: exp(2j pi m / M) in float64, rounded once."""
    m = 3240
    want = np.exp(2j * np.pi * np.arange(m) / m).astype(np.complex64)
    assert np.array_equal(t_tp.twiddles(m), want)


# ------------------------------------------- the parameter structs

_C64, _F32, _I32 = torch.complex64, torch.float32, torch.int32


def _tp_signature(cfg, nslots=None, ports=4, t=1):
    """K18's (shapes, dtypes) for ``cfg`` on the flagship grid."""
    key = pusch._tp_key(cfg)
    plan, hops = pusch.tp_plan(key, 0), pusch.tp_plan(key, 1)
    m = 12 * cfg.rb_count
    nhops = len(pusch.hop_configs(cfg))
    lead = () if nslots is None else (nslots,)
    shapes = (lead + (ports, 14, 3276), lead + (ports, 1, t, nhops * m),
              plan.shape, lead + (nhops, ports), hops.shape)
    return shapes, (_C64, _C64, _I32, _F32, _I32), plan, hops


@pytest.mark.parametrize("case", ["ue_c", "ue_c_batch", "widest", "m300",
                                  "m2916"])
def test_tp_params(case):
    """K18's struct as the wrapper builds it, field by field: UE C (72
    subcarriers, both hops, MMSE, QPSK), its batch of 4, the widest
    allocation (M = 3240) and the extra widths."""
    if case.startswith("ue_c"):
        cfg = flagship.EDGE.pusch_c
    elif case == "widest":
        cfg = flagship.widest_tp()
    else:
        cfg = dataclasses.replace(flagship.widest_tp(),
                                  rb_count=flagship.TP_EXTRA_RB[case])
    nslots = 4 if case == "ue_c_batch" else None
    shapes, dtypes, plan, hops = _tp_signature(cfg, nslots)
    m = 12 * cfg.rb_count
    p = ul_demap._tp_params(shapes, dtypes, m, cfg.modulation, cfg.equalizer)
    want = {"ue_c": (72, (4, 2, 3, 3)), "ue_c_batch": (72, (4, 2, 3, 3)),
            "widest": (3240, (4, 2, 3, 3, 3, 3, 5)),
            "m300": (300, (4, 3, 5, 5)),
            "m2916": (2916, (4, 3, 3, 3, 3, 3, 3))}[case]
    assert (p.fft.M, tuple(p.fft.radix[:p.fft.stages])) == want
    assert p.nslots == (nslots or 1)
    assert p.nre == plan.shape[1] and p.nblocks == p.nre // m == len(hops)
    assert (p.P, p.S, p.K, p.T) == (4, 14, 3276, 1)
    assert p.Ka == shapes[1][-1] and p.H == shapes[3][-2]
    assert p.H == (2 if case.startswith("ue_c") else 1)
    assert p.mmse == int(cfg.equalizer == "mmse") == 1
    assert (p.kind, p.half) == (2, 1)                 # QPSK
    assert p.threads == min(512, -(-m // 32) * 32)
    assert p.two_scale == float(np.float32(2 / np.sqrt(2)))
    lv = pam_levels_scaled("qpsk")
    assert list(p.levels[:2]) == lv.tolist() and not any(p.levels[2:])


@pytest.mark.parametrize("modulation,kind,half", [
    ("bpsk", 0, 1), ("pi2bpsk", 1, 1), ("qam16", 2, 2), ("qam64", 2, 3),
    ("qam256", 2, 4)])
def test_tp_params_modulations(modulation, kind, half):
    shapes, dtypes, _, _ = _tp_signature(flagship.EDGE.pusch_c)
    p = ul_demap._tp_params(shapes, dtypes, 72, modulation, "zf")
    assert (p.kind, p.half, p.mmse) == (kind, half, 0)
    lv = pam_levels_scaled("qpsk" if kind < 2 else modulation)
    assert list(p.levels[:len(lv)]) == lv.tolist()


@pytest.mark.parametrize("bad", ["dtype", "method", "plan", "noise",
                                 "size"])
def test_tp_params_refuse(bad):
    shapes, dtypes, _, _ = _tp_signature(flagship.EDGE.pusch_c)
    shapes, dtypes = list(shapes), list(dtypes)
    m, method = 72, "mmse"
    if bad == "dtype":
        dtypes[0] = torch.complex128
    elif bad == "method":
        method = "lmmse"
    elif bad == "plan":
        shapes[2] = (3, 865)
    elif bad == "noise":
        shapes[3] = (2, 2)
    else:
        m = 84                                   # 7 RB: not 2^a 3^b 5^c
        shapes[2], shapes[4] = (3, 84 * 12), (12,)
    with pytest.raises(ValueError):
        ul_demap._tp_params(tuple(shapes), tuple(dtypes), m, "qpsk", method)


@pytest.mark.parametrize("which", ["f3", "f4", "f3_batch"])
def test_f3_params(which):
    """K19's struct as the wrapper builds it, field by field: the cell
    edge's F3 (2 RB, pi/2-BPSK, 14 symbols) and F4 (1 RB, OCC 2 index 1,
    QPSK, 12 symbols), and the F3 with a slot axis of 4."""
    cfg = flagship.EDGE.f4 if which == "f4" else flagship.EDGE.f3
    m = 12 * cfg.nof_rb
    lead = (4,) if which == "f3_batch" else ()
    p = pucch._f3_params((lead + (4, 14, 3276), lead + (4, 1, 1, m),
                          lead + (4,)), (_C64, _C64, _F32), cfg)
    assert p.fft.M == m
    assert tuple(p.fft.radix[:p.fft.stages]) == ((4, 2, 3) if m == 24
                                                  else (4, 3))
    assert p.nslots == (4 if lead else 1)
    assert (p.P, p.S, p.K, p.sc0) == (4, 14, 3276, 12 * cfg.rb_start)
    syms = pucch._f3_data_symbols(cfg)
    assert p.n_data == len(syms) and list(p.data_syms[:len(syms)]) == \
        syms.tolist()
    assert not any(p.data_syms[len(syms):])
    assert p.occ_len == cfg.occ_length
    occ = pucch._f3_occ_conj(cfg.occ_length, cfg.occ_index)
    got = np.asarray(p.occ_conj[:2 * len(occ)], np.float32)
    assert np.array_equal(got[0::2] + 1j * got[1::2], occ)
    assert p.kind == (1 if cfg.pi2_bpsk else 2) and p.threads == 32
    row = m // cfg.occ_length * (1 if cfg.pi2_bpsk else 2)
    assert p.gold_stride == -(-row // 4) * 4
    assert p.two_scale == float(np.float32(2 / np.sqrt(2)))
    assert list(p.levels[:2]) == pam_levels_scaled("qpsk").tolist()


@pytest.mark.parametrize("which", ["f3", "f4"])
def test_f3_gold_rows(which):
    """K19's Gold table: data symbol i's row holds bits i row .. (i + 1) row
    of the PDU's sequence, zero-padded to a multiple of 4 bytes."""
    from srsran_tpu_torch.ops.gold import gold_sequence_np
    cfg = getattr(flagship.EDGE, which)
    rows = pucch._f3_gold_rows(cfg)
    n_data = len(pucch._f3_data_symbols(cfg))
    row = 12 * cfg.nof_rb // cfg.occ_length * (1 if cfg.pi2_bpsk else 2)
    assert rows.shape == (n_data, -(-row // 4) * 4) and rows.dtype == np.uint8
    seq = gold_sequence_np(pucch._f3_c_init(cfg), n_data * row)
    assert np.array_equal(rows[:, :row].reshape(-1), seq)
    assert not rows[:, row:].any()


def test_f3_params_refuse():
    cfg = flagship.EDGE.f3
    with pytest.raises(ValueError):
        pucch._f3_params(((4, 14, 3276), (4, 1, 1, 12), (4,)),
                         (_C64, _C64, _F32), cfg)      # coeffs of 1 RB
    with pytest.raises(ValueError):
        pucch._f3_params(((4, 14, 3276), (4, 1, 1, 24), (4,)),
                         (_C64, _C64, torch.float64), cfg)
