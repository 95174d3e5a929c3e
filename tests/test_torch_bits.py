"""Bit paths of the port against the JAX package, bit-exact.

CRC, Gold, scrambling, LDPC encode, rate match and dematch, the LDPC
decoder (hard bits and sweep counts on clean input and on noisy input that
runs all 6 sweeps) and the shared-channel decoder with HARQ combining.  The
codeblocks are those of the small PUSCH: BG1, Z=320, 4 CBs (TBS 26632 on
24 RB, 2-layer QAM64 at rate 0.7).  Inputs are made with numpy from seeds;
on the CPU every port wrapper runs its plain twin.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import crc as j_crc
from srsran_tpu.ops import gold as j_gold
from srsran_tpu.ops import ldpc_decode as j_dec
from srsran_tpu.ops import ldpc_encode as j_enc
from srsran_tpu.ops import ldpc_rate_match as j_rm
from srsran_tpu.ops import scrambling as j_scr
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import sch_decoder as j_sch
from srsran_tpu.ran.ldpc_params import segment_tb, select_base_graph
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc

from srsran_tpu_torch import convert
from srsran_tpu_torch.ops import crc as t_crc
from srsran_tpu_torch.ops import gold as t_gold
from srsran_tpu_torch.ops import ldpc_decode as t_dec
from srsran_tpu_torch.ops import ldpc_encode as t_enc
from srsran_tpu_torch.ops import ldpc_rate_match as t_rm
from srsran_tpu_torch.ops import scrambling as t_scr
from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
from srsran_tpu_torch.phy.upper import sch_decoder as t_sch

torch.set_num_threads(2)

TBS = tbs_calc(24, 14, 36, "qam64", 0.7, 2)
SEG = segment_tb(TBS, select_base_graph(TBS, 0.7))
QM, NL = 6, 2
UE = j_pdsch.PdschConfig(rnti=0x17, rb_start=0, rb_count=24, first_symbol=0,
                         nof_symbols=14, modulation="qam64",
                         target_code_rate=0.7, tbs=TBS, nof_layers=NL,
                         n_id=1, dmrs_symbols=(2, 7, 11))
G = j_pdsch.nof_data_re(UE) * QM * NL
E_SIZES = j_pdsch._cb_rate_match_sizes(G, SEG.nof_codeblocks, QM, NL)


def test_small_config_is_the_one_described():
    assert TBS == 26632
    assert (SEG.base_graph, SEG.lifting_size, SEG.nof_codeblocks) == (1, 320, 4)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("poly", ["crc24A", "crc24B", "crc24C", "crc16",
                                  "crc11", "crc6"])
def test_crc(poly):
    bits = np.random.default_rng(1).integers(0, 2, (3, 257)).astype(np.int8)
    a = np.asarray(j_crc.crc(jnp.asarray(bits), poly))
    b = t_crc.crc(_t(bits), poly).numpy()
    np.testing.assert_array_equal(a, b)
    good = np.concatenate([bits, a], axis=-1)
    bad = good.copy()
    bad[1, 5] ^= 1
    for msg in (good, bad):
        np.testing.assert_array_equal(
            np.asarray(j_crc.crc_check(jnp.asarray(msg), poly)),
            t_crc.crc_check(_t(msg), poly).numpy())


@pytest.mark.parametrize("c_init,length,advance", [
    ((0x17 << 15) + 1, G, 0), (1234567, 3228, 288), (7, 100, 0)])
def test_gold_sequence(c_init, length, advance):
    a = np.asarray(j_gold.gold_sequence(c_init, length, advance))
    b = t_gold.gold_sequence(c_init, length, advance, device="cpu").numpy()
    np.testing.assert_array_equal(a.astype(np.uint8), b)


def test_scrambling():
    rng = np.random.default_rng(2)
    c_init = (0x4601 << 15) + 3
    bits = rng.integers(0, 2, (2, 600)).astype(np.int8)
    np.testing.assert_array_equal(
        np.asarray(j_scr.scramble_bits(jnp.asarray(bits), c_init)),
        t_scr.scramble_bits(_t(bits), c_init).numpy())
    llrs = rng.standard_normal((2, 600)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(j_scr.descramble_llrs(jnp.asarray(llrs), c_init)),
        t_scr.descramble_llrs(_t(llrs), c_init).numpy())


@pytest.mark.parametrize("bg,z,batch", [(1, 320, 4), (2, 64, 3), (1, 24, 2)])
def test_ldpc_encode(bg, z, batch):
    kb = 22 if bg == 1 else 10
    bits = np.random.default_rng(bg * z).integers(0, 2, (batch, kb * z))
    bits = bits.astype(np.int8)
    a = np.asarray(j_enc.encode(jnp.asarray(bits), bg, z))
    b = t_enc.encode(_t(bits), bg, z).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
def test_rate_match(rv):
    n = SEG.codeword_bits
    cw = np.random.default_rng(rv).integers(0, 2, (SEG.nof_codeblocks, n))
    cw = cw.astype(np.int8)
    args = (E_SIZES, rv, QM, 1, SEG.lifting_size, SEG.cb_info_bits,
            SEG.full_block_bits)
    a = np.asarray(j_rm.rate_match_batch(jnp.asarray(cw), *args))
    b = t_rm.rate_match_batch(_t(cw), *args).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rv,with_soft", [(0, False), (0, True), (2, True),
                                          (3, False)])
def test_rate_dematch_combine(rv, with_soft):
    """K2's twin against the JAX dematch + soft add + 2Z zero prefix."""
    rng = np.random.default_rng(10 + rv)
    llr = rng.standard_normal(G).astype(np.float32)
    c, z, n = SEG.nof_codeblocks, SEG.lifting_size, SEG.codeword_bits
    soft = rng.standard_normal((c, n)).astype(np.float32) if with_soft else None
    args = (c, E_SIZES, rv, QM, 1, z, SEG.cb_info_bits, SEG.full_block_bits, n)
    buf = j_rm.rate_dematch_batch(jnp.asarray(llr), *args)
    if soft is not None:
        buf = buf + jnp.asarray(soft)
    full = jnp.concatenate([jnp.zeros((c, 2 * z), buf.dtype), buf], axis=-1)
    new_soft, t_full = t_rm.rate_dematch_combine(
        _t(llr), *args, None if soft is None else _t(soft))
    np.testing.assert_array_equal(np.asarray(buf), new_soft.numpy())
    np.testing.assert_array_equal(np.asarray(full), t_full.numpy())


def test_rate_dematch_repetition_sums():
    """A short buffer forces repetitions: sums agree to float rounding."""
    seg = segment_tb(200, 2)
    e = [1200]
    llr = np.random.default_rng(5).standard_normal(1200).astype(np.float32)
    args = (1, e, 0, 2, 2, seg.lifting_size, seg.cb_info_bits,
            seg.full_block_bits, seg.codeword_bits)
    a = np.asarray(j_rm.rate_dematch_batch(jnp.asarray(llr), *args))
    b, _ = t_rm.rate_dematch_combine(_t(llr), *args)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def codewords():
    """Rate-matched codeword bits of one random TB at rv 0 and rv 2, as the
    JAX transmitter makes them; the port's transmitter must agree."""
    payload = np.random.default_rng(42).integers(0, 2, TBS).astype(np.int8)
    out = {}
    for rv in (0, 2):
        cfg = dataclasses.replace(UE, rv=rv)
        cw, _ = j_pdsch.encode_transport_block(jnp.asarray(payload), cfg)
        cw_t, _ = t_pdsch.encode_transport_block(_t(payload),
                                                 convert.config(cfg))
        np.testing.assert_array_equal(np.asarray(cw), cw_t.numpy())
        out[rv] = np.asarray(cw)
    return payload, out


def test_transport_block_encode(codewords):
    assert codewords[1][0].shape == (G,)


def _noisy_llrs(bits, snr_db, seed):
    rng = np.random.default_rng(seed)
    sigma = 10 ** (-snr_db / 20)
    y = (1.0 - 2.0 * bits) + sigma * rng.standard_normal(bits.shape)
    return (2 * y / sigma ** 2).astype(np.float32)


def _decoder_input(cw, snr_db, seed):
    c, z = SEG.nof_codeblocks, SEG.lifting_size
    llr = _noisy_llrs(cw, snr_db, seed)
    buf = j_rm.rate_dematch_batch(jnp.asarray(llr), c, E_SIZES, 0, QM, 1, z,
                                  SEG.cb_info_bits, SEG.full_block_bits,
                                  SEG.codeword_bits)
    return np.asarray(jnp.concatenate(
        [jnp.zeros((c, 2 * z), jnp.float32), buf], axis=-1))


@pytest.mark.parametrize("snr_db,expect_iters", [(12.0, 1), (3.0, 6)])
def test_decode_early_stop(codewords, snr_db, expect_iters):
    _, cws = codewords
    full = _decoder_input(cws[0], snr_db, seed=int(snr_db))
    args = (1, SEG.lifting_size, 46, 6, 0.8, "crc24B", SEG.cb_info_bits)
    jb, _, ji = j_dec.decode_early_stop(jnp.asarray(full), *args)
    tb, _, ti = t_dec.decode_early_stop(_t(full), *args)
    assert int(ji) == int(ti) == expect_iters
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


def test_decode_fixed_iterations(codewords):
    _, cws = codewords
    full = _decoder_input(cws[0], 4.0, seed=4)
    jb, js = j_dec.decode(jnp.asarray(full), 1, SEG.lifting_size, 46, 3)
    tb, ts = t_dec.decode(_t(full), 1, SEG.lifting_size, 46, 3)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-3)


def _sch_both(llr, rv, soft):
    args = (SEG, E_SIZES, rv, QM, TBS)
    j = j_sch.decode(jnp.asarray(llr), *args,
                     soft_buffer=None if soft is None else jnp.asarray(soft))
    t = t_sch.decode(_t(llr), *args,
                     soft_buffer=None if soft is None else _t(soft))
    np.testing.assert_array_equal(np.asarray(j.tb_bits), t.tb_bits.numpy())
    assert bool(j.tb_crc_ok) == bool(t.tb_crc_ok)
    np.testing.assert_array_equal(np.asarray(j.cb_crc_ok), t.cb_crc_ok.numpy())
    assert int(j.nof_iterations) == int(t.nof_iterations)
    np.testing.assert_array_equal(np.asarray(j.new_soft), t.new_soft.numpy())
    return t


def test_sch_decode(codewords):
    payload, cws = codewords
    t = _sch_both(_noisy_llrs(cws[0], 8.0, seed=8), 0, None)
    assert bool(t.tb_crc_ok)
    np.testing.assert_array_equal(t.tb_bits.numpy(), payload)


def test_sch_decode_harq_rv0_then_rv2(codewords):
    """rv 0 alone fails at this SNR; rv 2 combined through the soft buffer
    decodes -- identically in both packages."""
    payload, cws = codewords
    c, n = SEG.nof_codeblocks, SEG.codeword_bits
    first = _sch_both(_noisy_llrs(cws[0], 1.0, seed=21), 0,
                      np.zeros((c, n), np.float32))
    assert not bool(first.tb_crc_ok)
    second = _sch_both(_noisy_llrs(cws[2], 1.0, seed=22), 2,
                       first.new_soft.numpy())
    assert bool(second.tb_crc_ok)
    np.testing.assert_array_equal(second.tb_bits.numpy(), payload)
