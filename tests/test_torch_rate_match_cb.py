"""LDPC rate matching per codeblock on the CPU: the port's ``rate_match``
and ``rate_match_batch`` (K32's twin) and single-codeblock
``rate_dematch`` (K2's twin at one codeblock per row) against the JAX
package's ``ops/ldpc_rate_match.py``, and K32's index arithmetic replayed
in numpy.

Cases: rv 0-3 on both base graphs, filler bits, a limited buffer
(``n_ref``), and repetition up to 4 copies of a position.  Tolerances:
rate matching is bit-exact.  Dematching is bit-exact up to two copies of
a position; with three or more, JAX's scatter adds the copies in the
interleaved stream's order and the port (K2) in window order, so float32
sums may differ in their last bits: within 4 ulp of the sum of the
magnitudes (``_SUM_ATOL``), and the port equal to the window-order sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import ldpc_rate_match as j_rm

from srsran_tpu_torch.ops import ldpc_rate_match as t_rm

torch.set_num_threads(2)

# (name, base graph, Z, K', n_ref, E, Qm): K = 22Z (BG1) or 10Z (BG2)
CASES = [
    ("bg1_fillers", 1, 24, 500, 0, 1200, 2),
    ("bg1_short", 1, 8, 170, 0, 240, 6),
    ("bg2_repeat", 2, 16, 150, 0, 2400, 4),
    ("bg2_four_copies", 2, 8, 72, 0, 1536, 4),
    ("bg1_nref", 1, 24, 520, 1000, 2598, 6),
    ("bg2_nref_qam256", 2, 32, 310, 900, 1600, 8),
]
_SUM_ATOL = 4 * float(np.finfo(np.float32).eps)


def _geometry(bg, z, k_prime):
    k = (22 if bg == 1 else 10) * z
    n = (66 if bg == 1 else 50) * z
    return k, n


def _codewords(name, bg, z, b=3):
    _, n = _geometry(bg, z, 0)
    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.integers(0, 2, (b, n)).astype(np.int8)


def _copies(bg, z, k_prime, n_ref, e, rv):
    """The most copies of one buffer position in the E bits."""
    k, n = _geometry(bg, z, k_prime)
    fs, fe, n_nf, k0p = t_rm._window_plan(rv, bg, z, k_prime, k, n, n_ref)
    return -(-(k0p + e) // n_nf)


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rate_match_matches_jax(case, rv):
    name, bg, z, k_prime, n_ref, e, qm = case
    k, _ = _geometry(bg, z, k_prime)
    cw = _codewords(name, bg, z)
    ref = np.asarray(j_rm.rate_match(jnp.asarray(cw), e, rv, qm, bg, z,
                                     k_prime, k, n_ref))
    got = t_rm.rate_match(torch.as_tensor(cw), e, rv, qm, bg, z, k_prime, k,
                          n_ref).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rate_match_batch_matches_jax(case):
    """Codeblocks of two E sizes in one call, as a TB's are."""
    name, bg, z, k_prime, n_ref, e, qm = case
    k, _ = _geometry(bg, z, k_prime)
    cw = _codewords(name, bg, z, b=4)
    e_sizes = (e, e, e + qm, e + qm)
    ref = np.asarray(j_rm.rate_match_batch(jnp.asarray(cw), e_sizes, 2, qm,
                                           bg, z, k_prime, k, n_ref))
    got = t_rm.rate_match_batch(torch.as_tensor(cw), e_sizes, 2, qm, bg, z,
                                k_prime, k, n_ref).numpy()
    np.testing.assert_array_equal(got, ref)


def _replay_k32(cw, e_sizes, rv, qm, bg, z, k_prime, n_ref):
    """csrc/rate_match.cu in numpy from the parameters its cached plan
    passes (``_rate_match_params``): each codeblock's run of equal E, its
    first output bit, and each bit's window index in 32-bit arithmetic."""
    k, n = _geometry(bg, z, k_prime)
    p, g = t_rm._rate_match_params(tuple(e_sizes), rv, qm, bg, z, k_prime, k,
                                   n_ref, cw.shape, torch.int8)
    out = np.full(g, -1, np.int8)
    for c in range(p.C):
        r = 0
        while r < p.runs - 1 and c >= p.run_end[r]:
            r += 1
        first = p.run_end[r - 1] if r else 0
        e = p.run_e[r]
        i = np.arange(e, dtype=np.uint32)
        j = (i % p.qm) * np.uint32(e // p.qm) + i // p.qm
        q = (np.uint32(p.k0p) + j) % np.uint32(p.n_nf)
        q = np.where(q >= p.fs, q + (p.fe - p.fs), q)
        start = p.run_off[r] + (c - first) * e
        out[start:start + e] = cw[c, q]
    return out


@pytest.mark.parametrize("rv", [0, 3])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_k32_replay_matches_twin(case, rv):
    name, bg, z, k_prime, n_ref, e, qm = case
    k, n = _geometry(bg, z, k_prime)
    cw = _codewords(name, bg, z, b=5)
    e_sizes = (e, e + qm, e + qm, e, e)      # three runs of equal E
    got = _replay_k32(cw, e_sizes, rv, qm, bg, z, k_prime, n_ref)
    ref = t_rm.rate_match_batch_ref(torch.as_tensor(cw), e_sizes, rv, qm, bg,
                                    z, k_prime, k, n_ref).numpy()
    np.testing.assert_array_equal(got, ref)
    plan = t_rm.gather_index(e_sizes, rv, qm, bg, z, k_prime, k, n, n_ref)
    np.testing.assert_array_equal(got, cw.reshape(-1)[plan])


@pytest.mark.parametrize("rv,n_ref", [(0, 0), (1, 0), (2, 0), (3, 0),
                                      (0, 3 * 66 * 384 // 4)])
def test_k32_plan_of_chip_smoke_cases(rv, n_ref):
    """The cached plan's parameters for chip_smoke.py's K32 cases (the
    flagship PUSCH's 37 codeblocks of two E sizes at rv 0-3, one codeblock
    at n_ref = 3N/4): the window plan of ``_window_plan``, the E sizes and
    first output bits as runs, and the kernel's index replayed equal to
    the twin."""
    from srsran_tpu_torch import flagship
    from srsran_tpu_torch.phy.upper import pdsch
    seg = flagship.SEG
    e_sizes = pdsch.rate_match_sizes(flagship.UE)
    if n_ref:
        e_sizes = e_sizes[:1]
    bg, z, k_prime = seg.base_graph, seg.lifting_size, seg.cb_info_bits
    k, n = _geometry(bg, z, k_prime)
    assert (k, n) == (seg.full_block_bits, seg.codeword_bits)
    p, g = t_rm._rate_match_params(e_sizes, rv, 6, bg, z, k_prime, k, n_ref,
                                   (len(e_sizes), n), torch.int8)
    assert (p.fs, p.fe, p.n_nf, p.k0p) == t_rm._window_plan(
        rv, bg, z, k_prime, k, n, n_ref)
    assert (p.C, p.N, p.e_max, p.qm) == (len(e_sizes), n, max(e_sizes), 6)
    sizes = [p.run_e[r] for r in range(p.runs)
             for _ in range(p.run_end[r] - (p.run_end[r - 1] if r else 0))]
    assert tuple(sizes) == tuple(e_sizes) and g == sum(e_sizes)
    assert p.runs == len(set(e_sizes)) == (1 if n_ref else 2)
    assert [p.run_off[r] for r in range(p.runs)] == [
        sum(e_sizes[:(p.run_end[r - 1] if r else 0)]) for r in range(p.runs)]
    cw = np.random.default_rng(rv).integers(0, 2, (len(e_sizes), n)).astype(
        np.int8)
    np.testing.assert_array_equal(
        _replay_k32(cw, e_sizes, rv, 6, bg, z, k_prime, n_ref),
        t_rm.rate_match_batch_ref(torch.as_tensor(cw), e_sizes, rv, 6, bg, z,
                                  k_prime, k, n_ref).numpy())


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rate_dematch_matches_jax(case, rv):
    name, bg, z, k_prime, n_ref, e, qm = case
    k, n = _geometry(bg, z, k_prime)
    rng = np.random.default_rng(rv + sum(map(ord, name)))
    llr = rng.normal(scale=3.0, size=(2, e)).astype(np.float32)
    ref = np.asarray(j_rm.rate_dematch(jnp.asarray(llr), rv, qm, bg, z,
                                       k_prime, k, n, n_ref))
    got = t_rm.rate_dematch(torch.as_tensor(llr), rv, qm, bg, z, k_prime, k,
                            n, n_ref).numpy()
    if _copies(bg, z, k_prime, n_ref, e, rv) <= 2:
        np.testing.assert_array_equal(got, ref)
        return
    # three or more copies: the same sums in another order
    mag = np.asarray(j_rm.rate_dematch(jnp.asarray(np.abs(llr)), rv, qm, bg,
                                       z, k_prime, k, n, n_ref))
    assert np.all(np.abs(got - ref) <= _SUM_ATOL * mag)
    # and the port's are the window-order sums
    fs, fe, n_nf, k0p = t_rm._window_plan(rv, bg, z, k_prime, k, n, n_ref)
    sel = llr.reshape(2, e // qm, qm).transpose(0, 2, 1).reshape(2, e)
    reps = -(-(k0p + e) // n_nf)
    buf = np.zeros((2, reps * n_nf), np.float32)
    buf[:, k0p:k0p + e] = sel
    buf = buf.reshape(2, reps, n_nf)
    acc = buf[:, 0]
    for r in range(1, reps):
        acc = acc + buf[:, r]
    n_cb = n_nf + fe - fs
    np.testing.assert_array_equal(got[:, :fs], acc[:, :fs])
    np.testing.assert_array_equal(got[:, fe:n_cb], acc[:, fs:])


def test_a_case_repeats_three_or_more_times():
    reps = {c[0]: max(_copies(*c[1:6], rv) for rv in range(4)) for c in CASES}
    assert reps["bg2_four_copies"] >= 4 and reps["bg2_repeat"] >= 3, reps
