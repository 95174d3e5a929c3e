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
    """csrc/rate_match.cu's index per output bit (``gather_index``), in
    numpy."""
    k, n = _geometry(bg, z, k_prime)
    return cw.reshape(-1)[t_rm.gather_index(e_sizes, rv, qm, bg, z, k_prime,
                                            k, n, n_ref)]


@pytest.mark.parametrize("rv", [0, 3])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_k32_replay_matches_twin(case, rv):
    name, bg, z, k_prime, n_ref, e, qm = case
    k, _ = _geometry(bg, z, k_prime)
    cw = _codewords(name, bg, z, b=2)
    e_sizes = (e, e + qm)
    got = _replay_k32(cw, e_sizes, rv, qm, bg, z, k_prime, n_ref)
    ref = t_rm.rate_match_batch_ref(torch.as_tensor(cw), e_sizes, rv, qm, bg,
                                    z, k_prime, k, n_ref).numpy()
    np.testing.assert_array_equal(got, ref)


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
