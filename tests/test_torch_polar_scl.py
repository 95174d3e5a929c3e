"""CA-SCL polar list decoding on the CPU: the port's twin of K29
(``ops/polar_scl.py::scl_decode_ref``) against the JAX package's
``scl_decode``, and K29's own arithmetic -- its leaf-by-leaf schedule,
per-path level buffers, (metric, index) ranking and ping-pong path copies
-- replayed in numpy against the twin.

Inputs are made from numpy seeds.  Tolerance: none -- messages and ``ok``
flags are equal (the decoder's float operations are exact or one rounded
add each, in the same order).  The JAX decoder unrolls its tree per leaf
at trace time (seconds per call), so each JAX output is computed once per
module, at N <= 128; the PBCH-size case (N = 512) runs under ``-m slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import polar_scl as j_scl
from srsran_tpu.ran import polar_params as j_pp

from srsran_tpu_torch.ops import crc as t_crc
from srsran_tpu_torch.ops import polar as t_polar
from srsran_tpu_torch.ops import polar_scl as t_scl
from srsran_tpu_torch.ops.polar import _code_keys, _readout
from srsran_tpu_torch.ran import polar_params as t_pp

torch.set_num_threads(2)


def _codeword_llrs(code, msg, sigma, rng, zeros=0):
    """Mother-codeword LLRs of ``msg`` [B, K] after BPSK, AWGN of
    ``sigma`` and the port's rate dematch; every ``zeros``-th received
    LLR of row 0 set to exactly 0 (ties)."""
    x = t_polar.rate_match(t_polar.encode(t_polar.allocate(
        torch.as_tensor(msg), code), code.n), code).numpy()
    rx = ((1.0 - 2.0 * x) + sigma * rng.standard_normal(x.shape)).astype(
        np.float32)
    if zeros:
        rx[0, ::zeros] = 0.0
    return t_polar.rate_dematch(torch.as_tensor(rx), code).numpy()


def _with_crc(bits, name):
    return np.concatenate(
        [bits, t_crc.crc(torch.as_tensor(bits), name).numpy()], axis=1)


def _case(name):
    """(code args, list size, crc, LLRs [B, N])."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "n128_l8":          # no CRC, noisy, zero LLRs in row 0
        args, size, crc = (40, 100, 9, False, 0), 8, None
        msg = rng.integers(0, 2, (4, 40)).astype(np.int8)
        sigma, zeros = 0.9, 5
    elif name == "n128_l8_crc":    # CA-SCL: 34 bits + CRC6, at low SNR
        args, size, crc = (40, 110, 9, False, 0), 8, "crc6"
        msg = _with_crc(rng.integers(0, 2, (6, 34)).astype(np.int8), "crc6")
        sigma, zeros = 1.1, 0
    elif name == "n64_l4_pc":      # 3 PC bits, the UL channel interleaver
        args, size, crc = (18, 60, 10, True, 3), 4, None
        msg = rng.integers(0, 2, (4, 18)).astype(np.int8)
        sigma, zeros = 0.8, 7
    elif name == "n64_l1":         # L = 1, a CRC
        args, size, crc = (25, 64, 9, False, 0), 1, "crc11"
        msg = _with_crc(rng.integers(0, 2, (3, 14)).astype(np.int8), "crc11")
        sigma, zeros = 0.7, 0
    elif name == "n64_zeros":      # all-zero LLRs in row 1: every tie
        args, size, crc = (20, 64, 9, False, 0), 4, "crc6"
        msg = _with_crc(rng.integers(0, 2, (2, 14)).astype(np.int8), "crc6")
        sigma, zeros = 0.5, 2
    else:                          # "n512_pbch": the PBCH code, slow
        args, size, crc = (56, 864, 9, False, 0), 8, "crc24C"
        msg = _with_crc(rng.integers(0, 2, (3, 32)).astype(np.int8),
                        "crc24C")
        sigma, zeros = 1.3, 0
    code = t_pp.polar_code(*args[:4], n_pc=args[4])
    llr = _codeword_llrs(code, msg, sigma, rng, zeros)
    if name == "n64_zeros":
        llr[1] = 0.0
    return args, size, crc, llr


FAST = ["n128_l8", "n128_l8_crc", "n64_l4_pc", "n64_l1", "n64_zeros"]


@pytest.fixture(scope="module")
def jax_out():
    """Each fast case through the JAX decoder, once."""
    out = {}
    for name in FAST:
        args, size, crc, llr = _case(name)
        code = j_pp.polar_code(*args[:4], n_pc=args[4])
        msg, ok = j_scl.scl_decode(jnp.asarray(llr), code, list_size=size,
                                   crc_poly=crc)
        out[name] = (np.asarray(msg), np.asarray(ok))
    return out


@pytest.mark.parametrize("name", FAST)
def test_scl_twin_matches_jax(jax_out, name):
    args, size, crc, llr = _case(name)
    code = t_pp.polar_code(*args[:4], n_pc=args[4])
    msg, ok = t_scl.scl_decode(torch.as_tensor(llr), code, list_size=size,
                               crc_poly=crc)
    np.testing.assert_array_equal(msg.numpy(), jax_out[name][0])
    np.testing.assert_array_equal(ok.numpy(), jax_out[name][1])


@pytest.mark.slow
def test_scl_twin_matches_jax_pbch_size():
    args, size, crc, llr = _case("n512_pbch")
    j_msg, j_ok = j_scl.scl_decode(jnp.asarray(llr), j_pp.polar_code(
        *args[:4]), list_size=size, crc_poly=crc)
    msg, ok = t_scl.scl_decode(torch.as_tensor(llr),
                               t_pp.polar_code(*args[:4]), list_size=size,
                               crc_poly=crc)
    np.testing.assert_array_equal(msg.numpy(), np.asarray(j_msg))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))


# ------------------------------------------------- K29 replayed in numpy

def _replay_k29(llr: np.ndarray, code, size: int, crc):
    """csrc/polar_scl.cu step for step on float32 numpy arrays: per path
    an LLR and a partial-sum vector per tree level and the decided bits,
    in two buffer sets; warps meet at each information leaf."""
    big_n = code.big_n
    pc = t_scl._pcs(code)
    keys = _code_keys(code)
    prog = t_scl._scl_program(*keys["program"], pc)
    table = t_scl._pc_table(pc)
    readout = _readout(*keys["readout"])
    leaf = 2 * big_n - 2
    msgs, oks = [], []
    for row in llr.astype(np.float32):
        lf = np.zeros((2, size, 2 * big_n), np.float32)
        xs = np.zeros((2, size, 2 * big_n), np.uint8)
        us = np.zeros((2, size, big_n), np.uint8)
        lf[0, :, :big_n] = row
        pm = np.full(size, np.float32(1e30), np.float32)
        pm[0] = 0.0
        s = 0
        for op, a1, lo in prog:
            if op <= t_scl._OP_COMB:
                m = 1 << a1
                h = m // 2
                lm, lh = 2 * big_n - 2 * m, 2 * big_n - 2 * h
                L, X = lf[s], xs[s]
                if op == t_scl._OP_F:
                    a, b = L[:, lm:lm + h], L[:, lm + h:lm + m]
                    L[:, lh:lh + h] = (np.sign(a) * np.sign(b)
                                       * np.minimum(np.abs(a), np.abs(b)))
                elif op == t_scl._OP_G:
                    a, b = L[:, lm:lm + h], L[:, lm + h:lm + m]
                    L[:, lh:lh + h] = b + (np.float32(1.0) - np.float32(2.0)
                                           * X[:, lm:lm + h]) * a
                elif op == t_scl._OP_SAVE:
                    X[:, lm:lm + h] = X[:, lh:lh + h]
                else:
                    r = X[:, lh:lh + h].copy()
                    X[:, lm:lm + h] ^= r
                    X[:, lm + h:lm + m] = r
                continue
            v = lf[s, :, leaf]
            if op != t_scl._OP_INFO:
                bit = np.zeros(size, np.uint8)
                if op == t_scl._OP_PC:
                    srcs = table[table[a1]:table[a1 + 1]]
                    bit = (us[s][:, srcs].sum(axis=1) & 1).astype(np.uint8)
                mismatch = np.where(bit == 1, v > 0, v < 0)
                pm = pm + np.where(mismatch, np.abs(v), np.float32(0.0))
                xs[s, :, leaf] = bit
                us[s, :, lo] = bit
                continue
            zero = np.float32(0.0)
            cand = np.concatenate([pm + np.where(v < 0, np.abs(v), zero),
                                   pm + np.where(v > 0, np.abs(v), zero)])
            j = np.arange(2 * size)
            rank = ((cand[None, :] < cand[:, None])
                    | ((cand[None, :] == cand[:, None])
                       & (j[None, :] < j[:, None]))).sum(axis=1)
            take = np.argsort(rank)[:size]            # candidate of rank w
            src, bit = take % size, (take >= size).astype(np.uint8)
            pm = cand[take]
            lf[1 - s], xs[1 - s], us[1 - s] = lf[s][src], xs[s][src], us[s][src]
            s = 1 - s
            xs[s, :, leaf] = bit
            us[s, np.arange(size), lo] = bit
        u = us[s][:, readout]
        ok = np.ones(size, bool)
        if crc:
            ok = t_crc.crc_check(torch.as_tensor(u.astype(np.int8)),
                                 crc).numpy()
        sel = np.where(ok, pm, pm + np.float32(1e20)) if crc else pm
        best = int(np.argmin(sel))
        msgs.append(u[best].astype(np.int8))
        oks.append(bool(ok.any()) if crc else True)
    return np.stack(msgs), np.asarray(oks)


@pytest.mark.parametrize("name", FAST)
def test_k29_replay_matches_twin(name):
    args, size, crc, llr = _case(name)
    code = t_pp.polar_code(*args[:4], n_pc=args[4])
    msg, ok = _replay_k29(llr, code, size, crc)
    ref, ref_ok = t_scl.scl_decode_ref(torch.as_tensor(llr), code, size, crc)
    np.testing.assert_array_equal(msg, ref.numpy())
    np.testing.assert_array_equal(ok, ref_ok.numpy())


def test_scl_program_walks_every_leaf_once():
    """The schedule holds one leaf row per position in order, F/SAVE/G/COMB
    for every internal node, and the PC rows point at their sources."""
    code = t_pp.polar_code(18, 60, 10, True, n_pc=3)
    pc = t_scl._pcs(code)
    prog = t_scl._scl_program(*_code_keys(code)["program"], pc)
    leaves = prog[prog[:, 0] >= t_scl._OP_FROZEN]
    np.testing.assert_array_equal(leaves[:, 2], np.arange(code.big_n))
    for op in (t_scl._OP_F, t_scl._OP_G, t_scl._OP_SAVE, t_scl._OP_COMB):
        assert (prog[:, 0] == op).sum() == code.big_n - 1
    pcs = leaves[leaves[:, 0] == t_scl._OP_PC]
    assert sorted(pcs[:, 2].tolist()) == sorted(code.pc_set.tolist())
    table = t_scl._pc_table(pc)
    for j, (pos, src) in enumerate(pc):
        assert pcs[pcs[:, 1] == j][0, 2] == pos
        assert tuple(table[table[j]:table[j + 1]]) == src
    info = leaves[leaves[:, 0] == t_scl._OP_INFO][:, 2]
    np.testing.assert_array_equal(np.sort(info), np.sort(code.info_set))


# -------------------------------------------------- the port on its own

def test_scl_l1_equals_sc_decode():
    """L = 1 decides leaf by leaf as SC does; on LLRs without exact zeros
    its messages equal the port's ``sc_decode`` (Rate-0 / Rate-1 pruned)."""
    rng = np.random.default_rng(11)
    for k, e in ((40, 200), (56, 864), (100, 120)):
        code = t_pp.polar_code(k, e, 9, False)
        msg = rng.integers(0, 2, (6, k)).astype(np.int8)
        llr = _codeword_llrs(code, msg, 0.9, rng)
        if code.mode == "puncture":      # punctured positions are exact 0
            continue
        llr_t = torch.as_tensor(llr)
        scl, ok = t_scl.scl_decode(llr_t, code, list_size=1)
        assert bool(ok.all())
        np.testing.assert_array_equal(scl.numpy(),
                                      t_polar.sc_decode(llr_t, code).numpy())


def test_ca_scl_beats_sc_at_low_snr():
    """The JAX test's PBCH-like experiment (tests/test_polar_scl.py:28-54)
    on the port: CA-SCL8 errs on fewer than half the blocks SC errs on."""
    k_payload, n_blocks, sigma = 32, 32, 1.4
    code = t_pp.polar_code(k_payload + 24, 240, 9, False)
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 2, (n_blocks, k_payload)).astype(np.int8)
    llr = torch.as_tensor(_codeword_llrs(code, _with_crc(payload, "crc24C"),
                                         sigma, rng) * (2 / sigma ** 2))
    sc = t_polar.sc_decode(llr, code).numpy()
    scl, _ = t_scl.scl_decode(llr, code, list_size=8, crc_poly="crc24C")
    sc_err = int((sc[:, :k_payload] != payload).any(axis=1).sum())
    scl_err = int((scl.numpy()[:, :k_payload] != payload).any(axis=1).sum())
    assert sc_err >= 8, sc_err
    assert scl_err < sc_err // 2, (scl_err, sc_err)
