"""K9's and K16's host plans and numpy models of their kernels, on the CPU.

K9 (csrc/prach_detect.cu): the plan's per-root preamble table against the
port's ``_geometry`` and ``_region_index`` and the JAX root walk (the
flagship B4, the gNB simulator's zcz 0, format 0 and a restricted set); a
numpy model of the kernel's N = V x 32 IDFT built from the plan's own
tables (the pruned input rows, the column twiddles, the twiddles of the
split, the 32-point stage's and its digit reversal) against
``np.fft.ifft`` for N = 256 to 4096; the model's power, summed in the
kernel's order (a warp's rows, the warps, the CTAs in rank order), and
its detection against JAX ``detect`` on seeded captures, the decisions
and the TA equal; the launch struct, its shared memory and the IDFT sizes
the kernel refuses.
K16 (csrc/pusch_demap_lxn.cu): a numpy model of the kernel's solve (A = L
D L^H with one reciprocal a pivot, forward and back substitution, the
noise diagonal a column at a time from G) against JAX ``equalize`` (the
L x N solve and the 1 x N closed forms) at 1-4 layers, ZF and MMSE, on
well-conditioned, near-singular and singular channels and the 1e12 rule,
within K16's tolerance; its launch struct for representative signatures.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import equalizer as j_eq
from srsran_tpu.ops import gold as j_gold
from srsran_tpu.phy.upper import prach as j_prach

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import gold, ul_demap
from srsran_tpu_torch.ops.modulation import BITS_PER_SYMBOL
from srsran_tpu_torch.phy.upper import prach, pusch

torch.set_num_threads(2)

C64 = np.complex64
F32 = np.float32
WARPS = 8          # csrc/prach_detect.cu kPrachThreads / 32

# ------------------------------------------------------------------ K9

K9_CONFIGS = {
    "flagship": j_prach.PrachConfig(format="B4", root_sequence_index=39,
                                    zero_correlation_zone=10,
                                    ra_scs_hz=30_000),
    "zcz0": j_prach.PrachConfig(format="B4", root_sequence_index=1,
                                zero_correlation_zone=0, ra_scs_hz=30_000),
    "format0": j_prach.PrachConfig(format="0", root_sequence_index=22,
                                   zero_correlation_zone=10),
    "restricted": j_prach.PrachConfig(format="0", root_sequence_index=22,
                                      zero_correlation_zone=5,
                                      restricted="type_a"),
}
# (ports, symbols, preamble sent, delay s)
K9_CAPTURES = {"flagship": (4, 12, 21, 2e-6), "zcz0": (4, 12, 5, 1e-6),
               "format0": (2, 1, 37, 5e-6), "restricted": (4, 1, 9, 3e-6)}


def _capture(name: str, seed: int) -> np.ndarray:
    """A seeded capture [P, S, L]: the preamble through a delay onto every
    port at gains 1.0 down to 0.7, complex noise of 0.05 a part."""
    cfg = convert.config(K9_CONFIGS[name])
    ports, symbols, pre, delay = K9_CAPTURES[name]
    rng = np.random.default_rng(seed)
    tx = prach.generate_np(cfg, pre)
    ramp = np.exp(-2j * np.pi * np.arange(cfg.l_ra) * cfg.scs_hz * delay)
    gains = np.linspace(1.0, 0.7, ports)[:, None, None]
    fd = gains * np.tile((tx * ramp)[None, None], (ports, symbols, 1))
    noise = rng.standard_normal(fd.shape) + 1j * rng.standard_normal(fd.shape)
    return (fd + 0.05 * noise).astype(C64)


def _packed(rx: np.ndarray, roots: np.ndarray, idft_size: int) -> np.ndarray:
    """The IDFT inputs [..., R, N] of a capture [..., L] (the twin's
    ``_pack`` of rx * conj(root))."""
    l_ra = roots.shape[-1]
    half = (l_ra + 1) // 2
    prod = rx[..., None, :] * np.conj(roots)
    buf = np.zeros(prod.shape[:-1] + (idft_size,), C64)
    buf[..., :half] = prod[..., :half]
    buf[..., idft_size - (l_ra - half):] = prod[..., half:]
    return buf


def _dif(y: np.ndarray, w32: np.ndarray) -> np.ndarray:
    """The kernel's M-point radix-2 decimation in frequency over the last
    axis (M = 8, 16, 32; natural order in, digit-reversed out), its
    twiddles w_{2S}^j = w_32^(16 j / S) from the table."""
    y = y.copy()
    m = y.shape[-1]
    s = m // 2
    while s >= 1:
        for base in range(0, m, 2 * s):
            for j in range(s):
                a, c = y[..., base + j].copy(), y[..., base + j + s].copy()
                y[..., base + j] = a + c
                y[..., base + j + s] = (a - c) * w32[j * (16 // s)]
        s //= 2
    return y


def _model_idft(x: np.ndarray, l_ra: int, idft_size: int) -> np.ndarray:
    """The kernel's unnormalised IDFT of rows x [..., N] from the plan's
    tables.  Lane t holds its column x[32 n1 + t], n1 < V (zeros outside
    the packed bins, never loaded).  V <= 32: the column's V-point
    decimation in frequency, register m holding output k1 = rev_V(m) (the
    five-bit table shifted); V > 32: a direct DFT over the plan's non-zero
    rows n1 only, 32 outputs k1 at a time.  Then the twiddle tw[k1, t],
    the 32-point stage over the lanes, and register m to output k1 + V
    rev5[m]."""
    tw, wv, w32, rev = prach._idft_tables(idft_size)
    v = idft_size // 32
    cols = x.reshape(x.shape[:-1] + (v, 32))
    out = np.zeros(x.shape, C64)
    if v <= 32:
        y = _dif(np.swapaxes(cols, -1, -2), w32)       # [..., t, m]
        k1 = rev[:v] >> (5 - int(np.log2(v)))
        a = np.zeros(x.shape[:-1] + (v, 32), C64)      # [..., k1, t]
        a[..., k1, :] = np.swapaxes(y, -1, -2)
        chunks = [(np.arange(v), a)]
    else:
        chunks = []
        for c in range(v // 32):
            k1 = c * 32 + np.arange(32)
            acc = np.zeros(x.shape[:-1] + (32, 32), C64)
            for n1 in prach._idft_rows(l_ra, idft_size):
                acc = acc + cols[..., n1, None, :] * wv[(n1 * k1) % v][:, None]
            chunks.append((k1, acc))
    for k1, a in chunks:
        z = _dif(a * tw[k1], w32)
        for m in range(32):
            out[..., k1 + v * rev[m]] = z[..., m]
    return out


@pytest.mark.parametrize("l_ra,idft_size", [
    (139, 256), (139, 512), (139, 1024), (139, 2048), (139, 4096),
    (839, 1024), (839, 2048), (839, 4096)])
def test_idft_model_matches_numpy(l_ra, idft_size):
    """The split is the N-point IDFT of the packed bins; the rows the plan
    leaves out of the direct DFT (N > 1024) hold zeros only."""
    rng = np.random.default_rng(idft_size + l_ra)
    roots = (rng.standard_normal((2, l_ra))
             + 1j * rng.standard_normal((2, l_ra))).astype(C64)
    rx = (rng.standard_normal((3, l_ra))
          + 1j * rng.standard_normal((3, l_ra))).astype(C64)
    x = _packed(rx, roots, idft_size)
    rows = prach._idft_rows(l_ra, idft_size)
    left = np.setdiff1d(np.arange(idft_size // 32), rows)
    assert not x.reshape(x.shape[:-1] + (-1, 32))[..., left, :].any()
    assert len(rows) <= 32
    ref = np.fft.ifft(x.astype(np.complex128), axis=-1) * idft_size
    got = _model_idft(x, l_ra, idft_size)
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()


def test_idft_tables():
    """The tables at N = 1024: tw[k1, t] = w_N^(t k1), wv = w_32^m, w32 the
    half circle of w_32, rev the five-bit reversal; 6 of 32 rows at L
    139 (bins [0, 70) and [955, 1024))."""
    tw, wv, w32, rev = prach._idft_tables(1024)
    assert tw.shape == (32, 32) and wv.shape == (32,) and w32.shape == (16,)
    np.testing.assert_allclose(tw[3, 5], np.exp(2j * np.pi * 15 / 1024),
                               atol=1e-7)
    np.testing.assert_allclose(w32, wv[:16], atol=0)
    assert sorted(rev.tolist()) == list(range(32))
    assert rev[1] == 16 and rev[3] == 24 and rev[31] == 31
    assert prach._idft_rows(139, 1024).tolist() == [0, 1, 2, 29, 30, 31]


@pytest.mark.parametrize("name", sorted(K9_CONFIGS))
def test_detect_roots_table(name):
    """The launched roots (root, first preamble, count) cover every
    preamble once, in order, each with its own root; the geometry is the
    JAX root walk's (root index, N - C_v N / L mod N), and the kernel's
    circular region index is ``_region_index``."""
    jcfg = K9_CONFIGS[name]
    cfg = convert.config(jcfg)
    n = 1024
    geom = prach._geometry(cfg, n)
    roots = prach._detect_roots(cfg, n)
    covered = []
    for root, first, count in roots.tolist():
        assert count >= 1
        assert (geom[first:first + count, 0] == root).all()
        covered += list(range(first, first + count))
    assert covered == list(range(cfg.nof_preambles))
    j_roots, j_pmap, _ = j_prach._root_set(jcfg)
    assert tuple(j_roots) == prach._root_set(cfg)[0]
    for p in range(cfg.nof_preambles):
        ri, cs = j_pmap[jcfg.start_preamble + p]
        assert tuple(geom[p]) == (ri, (n - (cs * n) // cfg.l_ra) % n)
    win, margin, search = prach._window(cfg, n)
    j = np.arange(win + 2 * margin)
    region = (geom[:, 1:2] - margin + j[None] + n) % n
    np.testing.assert_array_equal(region, prach._region_index(cfg, n))
    assert 1 <= search <= win and win + 2 * margin <= n
    if name == "flagship":
        assert roots[:, 2].tolist() == [7] * 9 + [1]
    if name == "zcz0":
        assert len(roots) == 64 and (roots[:, 2] == 1).all()


def _model_power(rx: np.ndarray, cfg, n: int) -> np.ndarray:
    """The kernel's power [R, N] of one slot's capture [P, S, L]: each
    row's IDFT by the model, |X|^2 summed over a warp's rows in order,
    the warps of a CTA in order, scaled by 1 / N, the CTAs in rank
    order."""
    rows = rx.shape[0] * rx.shape[1]
    c = prach._detect_params(cfg, rx.shape, n, 1.0).C
    x = _model_idft(_packed(rx.reshape(rows, -1), prach._root_fd(cfg), n),
                    cfg.l_ra, n)                              # [rows, R, N]
    p2 = (x.real * x.real + x.imag * x.imag).astype(F32)
    ctas = []
    for rank in range(c):
        warps = []
        for w in range(WARPS):
            acc = np.zeros(p2.shape[1:], F32)
            for q in range(rank * WARPS + w, rows, c * WARPS):
                acc = (acc + p2[q]).astype(F32)
            warps.append(acc)
        s = np.zeros(p2.shape[1:], F32)
        for acc in warps:
            s = (s + acc).astype(F32)
        ctas.append((s * F32(1.0 / n)).astype(F32))
    total = ctas[0]
    for s in ctas[1:]:
        total = (total + s).astype(F32)
    return total


def _warp_tree(parts: np.ndarray) -> F32:
    v = parts.astype(F32).copy()
    for o in (16, 8, 4, 2, 1):
        v[:32 - o] = (v[:32 - o] + v[o:]).astype(F32)
    return v[0]


def _model_detect(power: np.ndarray, cfg, n: int, threshold: float):
    """The leader CTA's detection on the model's power: per preamble the
    lane-strided region sum in a shuffle tree, the metric per bin, the
    first maximum, metric x win, TA and the decision."""
    win, margin, search = prach._window(cfg, n)
    geom = prach._geometry(cfg, n)
    metrics, tas = [], []
    for root, start in geom.tolist():
        region = power[root, (start - margin + np.arange(win + 2 * margin)
                              + n) % n]
        parts = np.zeros(32, F32)
        for j, v in enumerate(region):
            parts[j % 32] = F32(parts[j % 32] + v)
        ref = _warp_tree(parts)
        seg = power[root, (start + np.arange(search)) % n]
        m = (seg / np.maximum((ref - seg).astype(F32), F32(1e-12))).astype(
            F32)
        peak = int(np.argmax(m))
        metrics.append(F32(m[peak] * F32(win)))
        tas.append(F32(F32(peak) / F32(n * cfg.scs_hz)))
    metrics = np.asarray(metrics, F32)
    return metrics, np.asarray(tas, F32), metrics > F32(threshold)


@pytest.mark.parametrize("name", sorted(K9_CONFIGS))
def test_detect_model_matches_jax(name):
    """The model's power and detection against JAX ``detect`` on a seeded
    capture: the decisions and the TA equal, the metrics and the RSSI
    within 1e-4; the preamble sent is the one detected."""
    jcfg = K9_CONFIGS[name]
    cfg = convert.config(jcfg)
    rx = _capture(name, 5)
    thr = prach.calibrated_threshold(cfg, rx.shape[0])
    metrics, tas, det = _model_detect(_model_power(rx, cfg, 1024), cfg,
                                      1024, thr)
    ref = j_prach.detect(jnp.asarray(rx), jcfg)
    np.testing.assert_array_equal(det, np.asarray(ref.detected))
    assert np.flatnonzero(det).tolist() == [K9_CAPTURES[name][2]]
    np.testing.assert_array_equal(tas, np.asarray(ref.time_advance_s))
    r = np.asarray(ref.metrics)
    np.testing.assert_allclose(metrics, r, rtol=1e-4,
                               atol=1e-4 * np.abs(r).max())
    rssi = np.mean(np.hypot(rx.real, rx.imag).astype(F32) ** 2)
    np.testing.assert_allclose(rssi, float(ref.rssi), rtol=1e-5)


@pytest.mark.parametrize("idft_size", [128, 1000, 1536, 8192])
def test_detect_refuses_an_idft_size(idft_size):
    """K9 takes an IDFT of 256 to 4096 points, a power of two; it names
    the limit."""
    cfg = flagship.PRACH
    with pytest.raises(ValueError, match="256 to 4096"):
        prach._detect_params(cfg, (4, 12, 139), idft_size, 2.0)


def test_detect_refuses_a_short_idft_at_format0():
    cfg = convert.config(K9_CONFIGS["format0"])
    with pytest.raises(ValueError, match="holds L_RA = 839"):
        prach._detect_params(cfg, (2, 1, 839), 512, 2.0)
    prach._detect_params(cfg, (2, 1, 839), 1024, 2.0)


def test_detect_refuses_a_wrong_capture():
    with pytest.raises(ValueError, match=r"\[\(B,\) P, S, 139\]"):
        prach._detect_params(flagship.PRACH, (4, 12, 140), 1024, 2.0)


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


def test_detect_struct_matches_the_source():
    assert _c_struct_fields("prach_detect.cu", "PrachDetectParams") == [
        f for f, _ in _build.PrachDetectParams._fields_]


@pytest.mark.parametrize("name,shape", [
    ("flagship", (4, 12, 139)), ("flagship", (4, 4, 12, 139)),
    ("zcz0", (4, 12, 139)), ("format0", (2, 1, 839)),
    ("restricted", (8, 1, 839))])
def test_detect_struct(name, shape):
    """The struct of a signature: the cluster (a warp a row, at most 8
    CTAs), the pruned rows, the slot count, the offsets of the tables, and
    a shared memory that fits what the prepare call allows."""
    cfg = convert.config(K9_CONFIGS[name])
    p = prach._detect_params(cfg, shape, 1024, 3.0)
    rows = shape[-3] * shape[-2]
    assert p.rows == rows and p.nrx == rows * cfg.l_ra
    assert p.B == (shape[0] if len(shape) == 4 else 1)
    assert p.C in (1, 2, 4, 8) and p.C * WARPS < 2 * max(rows, WARPS)
    assert p.B * p.roots * p.C <= 132 or p.C == 1   # one wave
    rows_live = prach._idft_rows(cfg.l_ra, 1024)
    assert p.nz == len(rows_live)
    assert p.live & 0xFFFFFFFF == sum(1 << int(r) for r in rows_live)
    assert p.smem == prach._detect_smem(1024, cfg.l_ra, p.nz, p.C)
    assert p.smem <= prach.PRACH_SMEM <= 232448
    cplx, ints = prach._detect_tables(cfg, 1024)
    tw, wv, w32, rev = prach._idft_tables(1024)
    np.testing.assert_array_equal(cplx[p.off_tw:p.off_tw + 1024],
                                  tw.reshape(-1))
    np.testing.assert_array_equal(cplx[p.off_wv:p.off_wv + 32], wv)
    np.testing.assert_array_equal(cplx[p.off_w32:], w32)
    np.testing.assert_array_equal(ints[p.nz:p.nz + 32], rev)
    np.testing.assert_array_equal(
        ints[p.off_geom:p.off_range],
        prach._geometry(cfg, 1024).reshape(-1))
    assert len(ints) == p.off_range + 3 * p.roots
    assert p.threshold == pytest.approx(3.0)
    assert p.span == np.float32(1024 * cfg.scs_hz)
    if name == "flagship":
        assert (p.C, p.nz, p.roots, p.win, p.margin, p.search) == (
            8 if len(shape) == 3 else 2, 6, 10, 139, 34, 111)
        assert p.live & 0xFFFFFFFF == 0xE0000007   # the pruned form
    if name == "zcz0":          # 64 clusters of 2 CTAs: one wave of 128
        assert (p.C, p.roots) == (2, 64)


def test_detect_cluster_at_other_sizes():
    """A power of two of CTAs, at most 4 at N = 4096 (the leader's [C, N]
    powers), no more than one wave at one CTA an SM, every size within the
    prepared shared memory; the live-row masks of the register
    transforms."""
    for n in prach.IDFT_SIZES:
        for rows, want in ((1, 1), (12, 2), (48, 8), (96, 8)):
            c = prach._detect_cluster(rows, n, 1, 132)
            assert c == min(want, 8 if n <= 2048 else 4)
            assert prach._detect_smem(n, 839, 32, c) <= prach.PRACH_SMEM
    assert prach._detect_cluster(48, 1024, 40, 132) == 2
    assert prach.PRACH_SMEM <= 232448
    assert prach._live_rows(139, 1024) == 0xE0000007
    assert prach._live_rows(839, 1024) == (1 << 14) - 1 | ((1 << 14) - 1) << 18
    assert prach._live_rows(139, 2048) == 0


# ------------------------------------------------------------------ K16

def _cj(a):
    return np.conj(a).astype(C64)


def _lxn_model(y: np.ndarray, h: np.ndarray, nv: float, method: str):
    """The kernel's solve on REs y [RE, P], h [RE, P, L] (complex64
    arithmetic): G's upper triangle and z over the ports; one layer the
    closed forms; else A = G + c I = L D L^H with one reciprocal a pivot,
    x by substitution, the noise diagonal a column at a time."""
    nre, _, n_l = h.shape
    nv = F32(nv)
    one = F32(1.0)
    g = {(j, i): np.sum(_cj(h[:, :, j]) * h[:, :, i], axis=1).astype(C64)
         for j in range(n_l) for i in range(j, n_l)}
    z = [np.sum(_cj(h[:, :, l]) * y, axis=1).astype(C64) for l in range(n_l)]
    if n_l == 1:
        e = g[0, 0].real.astype(F32)
        if method == "mmse":
            inv = (one / np.maximum(e + nv, F32(1e-12))).astype(F32)
            nvs = np.where(e < 1e-12, F32(1e12), nv * e * inv * inv)
        else:
            inv = (one / np.maximum(e, F32(1e-12))).astype(F32)
            nvs = np.where(e < 1e-12, F32(1e12), nv * inv)
        return (z[0] * inv)[:, None].astype(C64), nvs[:, None].astype(F32)
    ridge = nv if method == "mmse" else F32(1e-9)
    d, rd, f = [], [], {}
    for j in range(n_l):
        dj = (g[j, j].real + ridge).astype(F32)
        for k in range(j):
            dj = (dj - (np.abs(f[j, k]) ** 2).astype(F32) * d[k]).astype(F32)
        d.append(np.maximum(dj, F32(1e-30)))
        rd.append((one / d[j]).astype(F32))
        for i in range(j + 1, n_l):
            v = _cj(g[j, i])
            for k in range(j):
                v = (v - f[i, k] * _cj(f[j, k]) * d[k]).astype(C64)
            f[i, j] = (v * rd[j]).astype(C64)
    u = []
    for i in range(n_l):
        v = z[i]
        for k in range(i):
            v = (v - f[i, k] * u[k]).astype(C64)
        u.append(v)
    x = [None] * n_l
    for i in reversed(range(n_l)):
        v = (u[i] * rd[i]).astype(C64)
        for k in range(i + 1, n_l):
            v = (v - _cj(f[k, i]) * x[k]).astype(C64)
        x[i] = v
    zero = np.zeros(nre, C64)
    nvs = []
    for l in range(n_l):
        w = [zero] * n_l
        w[l] = np.ones(nre, C64)
        for k in range(l + 1, n_l):
            v = zero
            for m in range(l, k):
                v = (v - f[k, m] * w[m]).astype(C64)
            w[k] = v
        if method == "mmse":
            c = [None] * n_l
            for i in reversed(range(n_l)):
                v = (w[i] * rd[i]).astype(C64) if i >= l else zero
                for k in range(i + 1, n_l):
                    v = (v - _cj(f[k, i]) * c[k]).astype(C64)
                c[i] = v
            diag = np.zeros(nre, F32)
            off = np.zeros(nre, F32)
            for m in range(n_l):
                diag = (diag + g[m, m].real * np.abs(c[m]) ** 2).astype(F32)
                for n in range(m + 1, n_l):
                    off = (off + (_cj(c[m]) * g[m, n] * c[n]).real).astype(
                        F32)
            diag = (diag + F32(2) * off).astype(F32)
        else:
            diag = np.zeros(nre, F32)
            for k in range(l, n_l):
                diag = (diag + (np.abs(w[k]) ** 2).astype(F32) * rd[k]
                        ).astype(F32)
        nvs.append(np.where(diag <= 0, F32(1e12), nv * diag).astype(F32))
    return np.stack(x, axis=1), np.stack(nvs, axis=1)


def _lxn_channel(rng, kind: str, n_l: int, nre: int = 240, ports: int = 4):
    """h [RE, P, L]: ``well`` I + 0.25 (N + jN); ``near`` U diag(s) V^H
    with random orthonormal U, V and singular values from 1 down to 0.05
    (a Gram whose condition number is 400); ``zero`` a quarter of the REs
    with no channel at all (the singular Gram: the 1e12 rule for one layer
    and for MMSE); ``rank`` (MMSE only) two equal layers."""
    def cn(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    h = np.eye(ports, n_l)[None] + 0.25 * cn(nre, ports, n_l)
    if kind == "near":
        u = np.linalg.qr(cn(nre, ports, n_l))[0]
        v = np.linalg.qr(cn(nre, n_l, n_l))[0]
        s = np.linspace(1.0, 0.05, n_l) if n_l > 1 else np.full(1, 0.05)
        h = u @ (s[:, None] * np.conj(np.swapaxes(v, -1, -2)))
    if kind == "zero":
        h[::4] = 0
    if kind == "rank":
        h[:, :, -1] = h[:, :, 0]
    return h.astype(C64)


# A rank-deficient ZF Gram has no answer to hold (both solves amplify
# rounding by 1e9 there); at 2 layers the zero channel is K3's on the
# PUSCH (the JAX closed form clamps the determinant where K16's solve
# regularises with 1e-9, so the two disagree on it; K16's 2-layer ZF is a
# route of the tests alone).
LXN_CASES = [(n_l, method, kind) for n_l in (1, 2, 3, 4)
             for method in ("zf", "mmse")
             for kind in ("well", "near", "zero", "rank")
             if not (kind == "rank" and (method == "zf" or n_l == 1))
             and not (kind == "zero" and method == "zf" and n_l == 2)]


@pytest.mark.parametrize("n_l,method,kind", LXN_CASES)
def test_lxn_solve_model_matches_jax(n_l, method, kind):
    """The model's x within 1e-4 of max|x| and the reciprocal of its noise
    (the LLRs' scale) within 1e-3 of its largest, the LLRs' tolerance, with
    the same 1e12 entries, against JAX ``equalize``, as
    the PUSCH dispatches it (the 1 x N closed forms, ZF's 2 x N, the L x N
    LU inverse)."""
    rng = np.random.default_rng(n_l * 100 + len(method) * 10 + len(kind))
    h = _lxn_channel(rng, kind, n_l)
    y = (rng.standard_normal(h.shape[:2])
         + 1j * rng.standard_normal(h.shape[:2])).astype(C64)
    nv = 0.05
    x, nvs = _lxn_model(y, h, nv, method)
    xr, nvr = j_eq.equalize(jnp.asarray(y), jnp.asarray(h),
                            jnp.full(h.shape[:1], nv, jnp.float32), n_l,
                            method)
    xr, nvr = np.asarray(xr), np.asarray(nvr)
    np.testing.assert_allclose(x, xr, rtol=1e-4,
                               atol=1e-4 * np.abs(xr).max())
    big = nvr >= 1e12
    np.testing.assert_array_equal(nvs >= 1e12, big)
    scale = 1 / nvr[~big]          # what the LLRs are multiplied by
    np.testing.assert_allclose(1 / nvs[~big], scale, rtol=1e-3,
                               atol=1e-3 * scale.max())
    if kind == "zero" and (n_l == 1 or method == "mmse"):
        assert big[::4].all() and not big[1::4].any()


@pytest.mark.parametrize("length,advance", [(1, 0), (31, 5), (32, 0),
                                            (1000, 643)])
def test_lxn_gold_words(length, advance):
    """K16's Gold bits packed 32 a word, LLR 32 w + b at bit b of word w,
    a spare zero word last; what the kernel reads through its 64-bit
    window is the twin's sequence."""
    words = gold.gold_words(77, length, advance).view(np.uint32)
    assert len(words) == -(-length // 32) + 1 and words[-1] == 0
    got = (words[np.arange(length) >> 5] >> (np.arange(length) & 31)) & 1
    want = np.asarray(j_gold.gold_sequence(77, length, advance))
    np.testing.assert_array_equal(got, want)
    pair = words[:-1].astype(np.uint64) | (words[1:].astype(np.uint64) << 32)
    for g in range(0, length, 7):
        w = int(pair[g >> 5] >> np.uint64(g & 31)) & 0xF
        assert [(w >> k) & 1 for k in range(min(4, length - g))] == list(
            want[g:g + 4])


@pytest.mark.parametrize("lead", [(), (4,)])
@pytest.mark.parametrize("modulation,n_l,method", [
    ("qam64", 4, "mmse"), ("qam16", 1, "mmse"), ("qam256", 3, "zf"),
    ("bpsk", 2, "mmse"), ("pi2bpsk", 1, "zf")])
def test_lxn_struct(lead, modulation, n_l, method):
    """K16's struct of a signature: the sizes, the slot count, the demap's
    kind, PAM order and levels, pi/2-BPSK's first parity from the Gold
    offset (in symbols), the equalizer."""
    c64, f32, i32 = torch.complex64, torch.float32, torch.int32
    nre = 2460
    shapes = (lead + (4, 14, 3276), lead + (4, n_l, 1, 2460), (nre,),
              (nre,), lead if lead else ())
    qm = BITS_PER_SYMBOL[modulation]
    p = ul_demap._lxn_params(shapes, (c64, c64, i32, i32, f32), 12,
                             modulation, n_l, method, 3 * qm)
    kind, half, levels, two_scale = ul_demap.demap_scalars(modulation)
    assert (p.nre, p.P, p.S, p.K, p.L, p.T, p.Ka, p.sc_off) == (
        nre, 4, 14, 3276, n_l, 1, 2460, 12)
    assert p.nslots == (lead[0] if lead else 1)
    assert (p.kind, p.half, p.mmse, p.rot0) == (
        kind, half, int(method == "mmse"), 1)
    assert p.two_scale == pytest.approx(two_scale)
    np.testing.assert_array_equal(np.asarray(p.levels[:len(levels)]),
                                  levels.astype(F32))


def test_lxn_struct_at_the_two_ue_slot():
    """UE A of the two-UE slot (4 layers MMSE QAM64, 27,060 REs) and the
    struct's field order against the C source."""
    cfg = flagship.MU.pusch_a
    sym, _ = pusch._plan(cfg, torch.device("cpu"))
    nre = sym.shape[0]
    assert nre == 27060
    c64, f32, i32 = torch.complex64, torch.float32, torch.int32
    p = ul_demap._lxn_params(
        ((4, 14, 3276), (4, 4, 1, 12 * cfg.rb_count), (nre,), (nre,), ()),
        (c64, c64, i32, i32, f32), cfg.rb_start * 12, cfg.modulation, 4,
        "mmse", 0)
    assert (p.L, p.mmse, p.half, p.nslots) == (4, 1, 3, 1)
    assert _c_struct_fields("pusch_demap.cuh", "LxnParams") == [
        f for f, _ in _build.LxnParams._fields_]


@pytest.mark.parametrize("change,match", [
    (lambda s, d: ((s[0], s[1][:-3] + (5,) + s[1][-2:]) + s[2:], d),
     "layers"),
    (lambda s, d: (s, (d[0], d[1], torch.int64) + d[3:]), "int32"),
    (lambda s, d: (s[:4] + ((2,),), d), "one float32 value"),
    (lambda s, d: ((s[0], s[1][1:]) + s[2:], d), "coeffs")])
def test_lxn_struct_refuses(change, match):
    c64, f32, i32 = torch.complex64, torch.float32, torch.int32
    shapes = ((4, 14, 288), (4, 4, 1, 288), (240,), (240,), ())
    dtypes = (c64, c64, i32, i32, f32)
    shapes, dtypes = change(shapes, dtypes)
    with pytest.raises(ValueError, match=match):
        ul_demap._lxn_params(shapes, dtypes, 0, "qam64", 4, "mmse", 0)
