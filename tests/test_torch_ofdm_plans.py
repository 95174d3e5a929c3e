"""K4's and K7's host plans and a numpy model of their kernels, on the CPU.

The model follows the kernels (csrc/ofdm.cuh, ofdm_demod.cu, ofdm_mod.cu)
step by step from the plan's own tables: in the radix-16 form (N a power
of two from 128 to 4096) the stages of ``ofdm._fft_stages``, register m of
thread t holding point t + T m, each stage's twiddles read from
``ofdm._fft_table`` at ``_fft_offsets`` (conjugated for the forward
transform), the in-register radix-R DFT as radix-2 passes with their
digit reversal, and the stages meeting in the padded shared buffer (every
word written once); in the Stockham form (other 2^a 3^b 5^c) the plan of
``transform_precode.fft_plan`` on the table, the forward transform as
conj(IDFT(conj x)); then K4's window starts, used bins and ramp and K7's
bins and CP writes, from the launch struct.  The model is held against
``np.fft`` in float64 (within 2e-6 of the largest output, float32
rounding over up to 12 radix-2 levels) at N = 128 to 4096 and at Stockham
sizes, and against JAX ``ofdm.demodulate_slot`` / ``modulate_slot`` and
the port's twins on seeded numpy inputs (within 1e-5 of the largest
output: two float32 FFTs of different orders) over normal and extended
CP, numerology 0-2, ``slot_in_subframe`` 0 and 1 and window offsets 0
and the most; the struct against the C source; the sizes and shapes the
kernels refuse.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import ofdm as j_ofdm
from srsran_tpu.ran.cyclic_prefix import CyclicPrefix as JCp

from srsran_tpu_torch import convert
from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import ofdm
from srsran_tpu_torch.ops.transform_precode import fft_plan

torch.set_num_threads(2)

C64 = np.complex64
POW2 = (128, 256, 512, 1024, 2048, 4096)
STOCKHAM = (1536, 3072, 972, 1200, 60)


def _cgauss(rng, shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(C64)


def _pad(i):
    """csrc/ofdm.cuh pad: one shared word skipped every 16."""
    return i + (i >> 4)


def _rev(m: int, bits: int) -> int:
    return int(f"{m:0{bits}b}"[::-1], 2) if bits else 0


def _w16(inverse: bool) -> np.ndarray:
    """w_16^q, q < 8, float64 rounded once (csrc/ofdm.cuh cos16 / sin16)."""
    q = np.arange(8)
    return np.exp((2j if inverse else -2j) * np.pi * q / 16).astype(C64)


def _dft_registers(u: list, inverse: bool) -> list:
    """The kernels' R-point DFT of registers u (arrays over the threads):
    radix-2 passes of decimation in frequency, pass of half-size H
    twiddling by w_16^(j 8 / H), then the digit reversal by renaming."""
    r_pts = len(u)
    w = _w16(inverse)
    u = list(u)
    h = r_pts // 2
    while h >= 1:
        for b in range(0, r_pts, 2 * h):
            for j in range(h):
                a, c = u[b + j], u[b + j + h]
                u[b + j] = a + c
                u[b + j + h] = (a - c) * w[j * (8 // h)]
        h //= 2
    bits = r_pts.bit_length() - 1
    return [u[_rev(k, bits)] for k in range(r_pts)]


def _model_radix16(x: np.ndarray, n: int, inverse: bool) -> np.ndarray:
    """The radix-16 form's unnormalised DFT of x [..., N]."""
    table = ofdm._fft_table(n)
    stages, offs = ofdm._fft_stages(n), ofdm._fft_offsets(n)
    t_n = n // 16
    tid = np.arange(t_n)
    point = tid[None] + t_n * np.arange(16)[:, None]          # [16, T]
    v = [x[..., point[m]].astype(C64) for m in range(16)]
    span = 1
    for s, r_pts in enumerate(stages):
        g = 16 // r_pts
        for i in range(g):
            u = [v[i + r * g] for r in range(r_pts)]
            if s:
                k = (tid + i * t_n) & (span - 1)
                for r in range(1, r_pts):
                    w = table[offs[s - 1] + (r - 1) * span + k]
                    u[r] = u[r] * (w if inverse else np.conj(w))
            for r, y in enumerate(_dft_registers(u, inverse)):
                v[i + r * g] = y
        if s < len(stages) - 1:
            assert g == 1
            k = tid & (span - 1)
            d = (tid - k) * 16 + k
            words = np.stack([_pad(d + r * span) for r in range(16)])
            assert len(np.unique(words)) == n      # every word written once
            sh = np.full(x.shape[:-1] + (n + n // 16,), np.nan, C64)
            for r in range(16):
                sh[..., words[r]] = v[r]
            v = [sh[..., _pad(point[m])] for m in range(16)]
        span *= r_pts
    out = np.empty(x.shape, C64)
    for m in range(16):
        out[..., point[m]] = v[m]
    return out


def _model_stockham(x: np.ndarray, n: int, inverse: bool) -> np.ndarray:
    """The Stockham form's unnormalised DFT of x [..., N]: K18's stages on
    the table (the forward transform as conj(IDFT(conj x)))."""
    plan = ofdm._ofdm_params("mod", (1, 14, 1), 1, n, 0, ofdm.CyclicPrefix.
                             NORMAL, 0, 0.0, 1.0, 0).fft
    assert plan.scale == 1.0 and plan.M == n
    table = ofdm._fft_table(n)
    a = x.astype(C64) if inverse else np.conj(x).astype(C64)
    for s in range(plan.stages):
        r_pts, span, step = plan.radix[s], plan.span[s], plan.step[s]
        nb = n // r_pts
        j = np.arange(nb)
        k = j % span
        v = [a[..., j + r * nb] for r in range(r_pts)]
        for r in range(1, r_pts):
            v[r] = v[r] * table[r * k * step]
        q = np.arange(r_pts)
        m = np.exp(2j * np.pi * np.outer(q, q) / r_pts)
        y = np.einsum("qr,r...->q...", m, np.stack(v)).astype(C64)
        dst = np.empty_like(a)
        for r in range(r_pts):
            dst[..., (j - k) * r_pts + k + r * span] = y[r]
        a = dst
    return a if inverse else np.conj(a)


def _model_fft(x: np.ndarray, n: int, inverse: bool) -> np.ndarray:
    if ofdm._fft_form(n):
        return _model_radix16(x, n, inverse)
    return _model_stockham(x, n, inverse)


def _comp(p) -> np.ndarray:
    return np.asarray(p.comp[:2 * p.S], np.float32).view(C64)


def _used_bins(p):
    """(bins, their grid index) of the K used subcarriers."""
    b = np.arange(p.N)
    up, lo = p.K - p.half, p.N - p.half
    used = (b < up) | (b >= lo)
    return b[used], np.where(b < up, p.half + b, b - lo)[used]


def _model_demod(samples: np.ndarray, p) -> np.ndarray:
    """K4 on samples [rows, T] from its struct and table: grid [rows, S, K]."""
    n = p.N
    table = ofdm._fft_table(n, p.off)
    comp = _comp(p)
    bins, gidx = _used_bins(p)
    grid = np.full((p.rows, p.S, p.K), np.nan, C64)
    for s in range(p.S):
        x = samples[:, p.start[s]:p.start[s] + n]
        val = _model_fft(x, n, False)[:, bins]
        if p.off:
            val = val * table[p.ramp + bins]
        grid[:, s, gidx] = val * comp[s]
    assert not np.isnan(grid).any()
    return grid


def _model_mod(grid: np.ndarray, p) -> np.ndarray:
    """K7 on a grid [rows, S, K] from its struct and table: samples
    [rows, T], each symbol's body and then its CP from the same values."""
    n = p.N
    comp = _comp(p)
    bins, gidx = _used_bins(p)
    out = np.full((p.rows, p.T), np.nan, C64)
    for s in range(p.S):
        x = np.zeros((p.rows, n), C64)
        x[:, bins] = grid[:, s, gidx]
        y = _model_fft(x, n, True) * comp[s]
        c, base = p.cp[s], p.start[s]
        out[:, base + c:base + c + n] = y
        out[:, base:base + c] = y[:, n - c:]
    assert not np.isnan(out).any()
    return out


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# ------------------------------------------------------------ the FFT

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", POW2 + STOCKHAM)
def test_fft_model_matches_numpy(n, inverse):
    """The kernels' transform, modelled from the plan's tables, against
    np.fft in float64 (unnormalised both ways)."""
    x = _cgauss(np.random.default_rng(n), (3, n))
    want = (np.fft.ifft(x.astype(np.complex128)) * n if inverse
            else np.fft.fft(x.astype(np.complex128)))
    _close(_model_fft(x, n, inverse), want, 2e-6)


@pytest.mark.parametrize("n", POW2)
def test_fft_table(n):
    """The table: twiddles(n), then each later stage's [R - 1, L] entries
    w^(r k N / (L R)) taken from it, at the offsets the struct carries."""
    table = ofdm._fft_table(n)
    full = np.exp(2j * np.pi * np.arange(n) / n).astype(C64)
    np.testing.assert_array_equal(table[:n], full)
    stages, offs = ofdm._fft_stages(n), ofdm._fft_offsets(n)
    assert np.prod(stages) == n and all(r == 16 for r in stages[:-1])
    assert stages[-1] in (2, 4, 8, 16) and len(stages) <= _build.OFDM_MAX_STAGES
    span, end = 1, n
    for s, r in enumerate(stages):
        if s:
            assert offs[s - 1] == end
            for rr in range(1, r):
                k = np.arange(span)
                np.testing.assert_array_equal(
                    table[offs[s - 1] + (rr - 1) * span + k],
                    full[(rr * k * (n // (span * r))) % n])
            end += (r - 1) * span
        span *= r
    assert len(table) == end == ofdm._ramp_offset(n)


@pytest.mark.parametrize("n,offset", [(4096, 144), (512, 17), (1536, 54)])
def test_ramp_table(n, offset):
    """K4's ramp after the twiddles: bin b's entry (offset b mod N) of
    exp(2j pi m / N), the JAX ramp exp(2j pi offset kbin / N) but for the
    float64 phase's rounding."""
    table = ofdm._fft_table(n, offset)
    base = ofdm._ramp_offset(n)
    np.testing.assert_array_equal(table[:base], ofdm._fft_table(n))
    b = np.arange(n)
    np.testing.assert_array_equal(table[base:], table[(offset * b) % n])
    kbin = np.where(b < n // 2, b, b - n)
    _close(table[base:], np.exp(2j * np.pi * offset * kbin / n), 1e-6)


# --------------------------------------- the kernels' models against JAX

# (cp, numerology, N, K, slot_in_subframe)
CONFIGS = {
    "normal_mu1": (JCp.NORMAL, 1, 512, 300, 0),
    "normal_mu1_sis1": (JCp.NORMAL, 1, 512, 300, 1),
    "normal_mu0": (JCp.NORMAL, 0, 256, 180, 0),
    "normal_mu0_sis1": (JCp.NORMAL, 0, 256, 180, 1),
    "extended_mu2": (JCp.EXTENDED, 2, 512, 300, 0),
    "extended_mu0_sis1": (JCp.EXTENDED, 0, 256, 180, 1),
    "normal_128_odd": (JCp.NORMAL, 1, 128, 71, 0),
    "stockham_1536": (JCp.NORMAL, 1, 1536, 1200, 0),
    "stockham_extended_1536": (JCp.EXTENDED, 2, 1536, 1200, 1),
}


@pytest.mark.parametrize("offset", ["zero", "max"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_demod_model_matches_jax(name, offset):
    """K4's model on 2 rows of seeded samples against JAX demodulate_slot
    and the port's twin (center frequency 3.5 GHz, scale 0.7)."""
    cp, mu, n, k, sis = CONFIGS[name]
    off = ofdm.max_window_offset(n) if offset == "max" else 0
    t = int(ofdm._symbol_layout(convert.value(cp), mu, n, sis)[2])
    samples = _cgauss(np.random.default_rng(n + k + sis), (2, t))
    want = np.asarray(j_ofdm.demodulate_slot(
        jnp.asarray(samples), k, n, mu, cp, sis, 3.5e9, 0.7, off))
    p = ofdm._ofdm_params("demod", samples.shape, k, n, mu,
                          convert.value(cp), sis, 3.5e9, 0.7, off)
    _close(_model_demod(samples, p), want, 1e-5)
    twin = ofdm.demodulate_slot_ref(torch.from_numpy(samples), k, n, mu,
                                    convert.value(cp), sis, 3.5e9, 0.7, off)
    _close(twin.numpy(), want, 1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mod_model_matches_jax(name):
    """K7's model on a seeded 2-row grid against JAX modulate_slot and the
    port's twin (center frequency 3.5 GHz, scale 0.7)."""
    cp, mu, n, k, sis = CONFIGS[name]
    nsym = 14 if cp is JCp.NORMAL else 12
    grid = _cgauss(np.random.default_rng(n + k + 7 * sis), (2, nsym, k))
    want = np.asarray(j_ofdm.modulate_slot(
        jnp.asarray(grid), n, mu, cp, sis, 3.5e9, 0.7))
    p = ofdm._ofdm_params("mod", grid.shape, k, n, mu, convert.value(cp),
                          sis, 3.5e9, 0.7, 0)
    _close(_model_mod(grid, p), want, 1e-5)
    twin = ofdm.modulate_slot_ref(torch.from_numpy(grid), n, mu,
                                  convert.value(cp), sis, 3.5e9, 0.7)
    _close(twin.numpy(), want, 1e-5)


def test_round_trip_through_the_models():
    """K7's model then K4's at the flagship size (one port, N = 4096, K
    3276) gives the grid back."""
    cp = ofdm.CyclicPrefix.NORMAL
    grid = _cgauss(np.random.default_rng(24), (1, 14, 3276))
    tx = ofdm._ofdm_params("mod", grid.shape, 3276, 4096, 1, cp, 0, 3.5e9,
                           1.0, 0)
    samples = _model_mod(grid, tx)
    rx = ofdm._ofdm_params("demod", samples.shape, 3276, 4096, 1, cp, 0,
                           3.5e9, 1.0, 0)
    _close(_model_demod(samples, rx), grid, 1e-5)


# ------------------------------------------------------ the launch struct

def _c_struct_fields(src: str, struct: str) -> list:
    """The field names of a C struct in csrc, in order (arrays by name)."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / src).read_text())
    body = re.search(rf"struct {struct} {{(.*?)}};", text, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            _, rest = decl.split(None, 1)
            names += [re.sub(r"\[.*\]", "", v).strip()
                      for v in rest.split(",")]
    return names


def test_struct_matches_the_source():
    assert _c_struct_fields("ofdm.cuh", "OfdmParams") == [
        f for f, _ in _build.OfdmParams._fields_]
    text = (_build.CSRC / "ofdm.cuh").read_text()
    for name, value in (("kOfdmMaxSymbols", _build.OFDM_MAX_SYMBOLS),
                        ("kOfdmMaxStages", _build.OFDM_MAX_STAGES),
                        ("kOfdmMaxPoints", ofdm.OFDM_MAX_POINTS)):
        assert re.search(rf"constexpr int {name} = {value};", text)


@pytest.mark.parametrize("kind,shape,n,cp,off", [
    ("demod", (4, 61440), 4096, "normal", 0),
    ("demod", (4, 4, 61440), 4096, "normal", 144),
    ("mod", (4, 14, 3276), 4096, "normal", 0),
    ("mod", (4, 4, 14, 3276), 4096, "normal", 0),
    ("demod", (2, 15360), 1024, "normal", 0),
    ("mod", (2, 12, 600), 1024, "extended", 0),
    ("demod", (4, 23040), 1536, "normal", 54)])
def test_struct(kind, shape, n, cp, off):
    """The struct of a signature: rows B P, the form and its twiddles, the
    window starts (K4: data start less the offset) or CP starts and
    lengths (K7), comp times the scale over sqrt(N)."""
    cpv = ofdm.CyclicPrefix.NORMAL if cp == "normal" else \
        ofdm.CyclicPrefix.EXTENDED
    k = shape[-1] if kind == "mod" else 3276 * n // 4096
    p = ofdm._ofdm_params(kind, shape, k, n, 1, cpv, 0, 3.5e9, 0.5, off)
    lens, starts, total = ofdm._symbol_layout(cpv, 1, n, 0)
    lead = shape[:-1] if kind == "demod" else shape[:-2]
    assert p.rows == int(np.prod(lead)) and p.S == len(lens)
    assert (p.N, p.K, p.half, p.T) == (n, k, k // 2, total)
    assert p.off == (off if kind == "demod" else 0)
    assert p.ramp == (ofdm._ramp_offset(n) if p.off else 0)
    if n & (n - 1) == 0:
        assert p.form == n.bit_length() - 1
        offs = ofdm._fft_offsets(n)
        assert len(offs) == len(ofdm._fft_stages(n)) - 1
        assert tuple(p.tw_off[:len(offs)]) == offs
    else:
        ref = fft_plan(n)
        assert p.form == 0 and p.smem == 3 * n * 8 and p.fft.scale == 1.0
        assert (p.fft.M, p.fft.stages) == (n, ref.stages)
        assert list(p.fft.radix) == list(ref.radix)
    for s in range(p.S):
        if kind == "demod":
            assert p.start[s] == starts[s] - off and p.cp[s] == 0
        else:
            assert (p.start[s], p.cp[s]) == (starts[s] - lens[s], lens[s])
    comp = ofdm.phase_compensation(cpv, 1, n, 0, 3.5e9)
    if kind == "demod":
        comp = np.conj(comp)
    np.testing.assert_allclose(_comp(p), 0.5 * comp / np.sqrt(n),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n", [8192, 6144, 1792, 4097, 7, 1000 * 7])
def test_refuses_a_size(n):
    """K4 and K7 take N up to 4096 of the form 2^a 3^b 5^c; any other N
    raises a ValueError naming the limit (no fallback)."""
    for kind, shape in (("demod", (1, 100)), ("mod", (1, 14, 4))):
        with pytest.raises(ValueError, match="at most 4096 points"):
            ofdm._ofdm_params(kind, shape, 4, n, 0, ofdm.CyclicPrefix.NORMAL,
                              0, 0.0, 1.0, 0)


def test_twin_takes_any_size():
    """The twins still take a size the kernels refuse, on the CPU."""
    n, k = 1792, 600
    grid = torch.from_numpy(_cgauss(np.random.default_rng(5), (1, 14, k)))
    samples = ofdm.modulate_slot(grid, n, 0)
    back = ofdm.demodulate_slot(samples, k, n, 0)
    torch.testing.assert_close(back, grid, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,shape,k,off,match", [
    ("demod", (4, 61441), 3276, 0, "a slot of 61440"),
    ("demod", (61440,), 3276, 0, "a slot of 61440"),
    ("demod", (4, 61440), 3276, 145, r"outside \[0, 144\]"),
    ("demod", (4, 61440), 4097, 0, "do not fit"),
    ("mod", (4, 12, 3276), 3276, 0, "has no 14 symbols"),
    ("mod", (14, 3276), 3276, 0, r"\[\(B,\) P, 14, K\]")])
def test_refuses_a_shape(kind, shape, k, off, match):
    with pytest.raises(ValueError, match=match):
        ofdm._ofdm_params(kind, shape, k, 4096, 1, ofdm.CyclicPrefix.NORMAL,
                          0, 0.0, 1.0, off)


def test_wrappers_take_the_twin_on_the_cpu():
    """On CPU tensors the wrappers are the twins (no plan, no launch)."""
    ofdm._ofdm_plan.cache_clear()
    grid = torch.from_numpy(_cgauss(np.random.default_rng(9), (2, 14, 72)))
    samples = ofdm.modulate_slot(grid, 128, 1)
    torch.testing.assert_close(samples,
                               ofdm.modulate_slot_ref(grid, 128, 1))
    torch.testing.assert_close(ofdm.demodulate_slot(samples, 72, 128, 1),
                               ofdm.demodulate_slot_ref(samples, 72, 128, 1))
    assert ofdm._ofdm_plan.cache_info().currsize == 0
