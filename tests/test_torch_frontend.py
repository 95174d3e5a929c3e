"""Symbol and float paths of the port against the JAX package.

OFDM samples and grids (odd slot and window offset included), modulation
and demapping, DM-RS pilots and mapping, the DM-RS channel estimate
(coefficients, noise, RSRP, SNR, EPRE, TA, CFO), the ZF equalizer, the EVM
and the PUSCH front end through descrambled LLRs.  Float paths hold
assert_close(rtol=1e-4, atol=1e-4*max|ref|), LLRs rtol=1e-3 with
atol=1e-3*max|ref|, TA exactly and CFO within 1 Hz.  On the CPU every port
wrapper runs its plain twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import equalizer as j_eq
from srsran_tpu.ops import evm as j_evm
from srsran_tpu.ops import modulation as j_mod
from srsran_tpu.ops import ofdm as j_ofdm
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pusch as j_pusch
from srsran_tpu.ran.cyclic_prefix import CyclicPrefix
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc

from srsran_tpu_torch import convert
from srsran_tpu_torch.ops import equalizer as t_eq
from srsran_tpu_torch.ops import evm as t_evm
from srsran_tpu_torch.ops import modulation as t_mod
from srsran_tpu_torch.ops import ofdm as t_ofdm
from srsran_tpu_torch.phy.upper import dmrs as t_dmrs
from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
from srsran_tpu_torch.phy.upper import pusch as t_pusch

torch.set_num_threads(2)

NSC = 24 * 12
TBS = tbs_calc(24, 14, 36, "qam64", 0.7, 2)
J_PUSCH = j_pusch.PuschConfig(rnti=0x17, rb_start=0, rb_count=24,
                              first_symbol=0, nof_symbols=14,
                              modulation="qam64", target_code_rate=0.7,
                              tbs=TBS, nof_layers=2, n_id=1,
                              dmrs_symbols=(2, 7, 11), slot_in_frame=5)


def _t(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, rtol=1e-4):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    atol = rtol * float(np.max(np.abs(ref)))
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _cgauss(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


@pytest.mark.parametrize("mu,n,sis,fc,offset,cp", [
    (1, 512, 0, 3.5e9, 0, CyclicPrefix.NORMAL),
    (1, 512, 1, 3.5e9, 0, CyclicPrefix.NORMAL),
    (1, 512, 1, 1.8e9, 8, CyclicPrefix.NORMAL),
    (0, 512, 0, 0.0, 4, CyclicPrefix.NORMAL),
    (2, 512, 0, 2.0e9, 0, CyclicPrefix.EXTENDED)])
def test_ofdm_modulate_demodulate(mu, n, sis, fc, offset, cp):
    rng = np.random.default_rng(mu * 10 + sis)
    nsym = 14 if cp is CyclicPrefix.NORMAL else 12
    grid = _cgauss(rng, (2, nsym, NSC))
    a = j_ofdm.modulate_slot(jnp.asarray(grid), n, mu, cp, sis, fc, 0.7)
    b = t_ofdm.modulate_slot(_t(grid), n, mu, convert.value(cp), sis, fc,
                             0.7)
    close(b, a)
    samples = np.asarray(a) + _cgauss(rng, a.shape, 0.01)
    ga = j_ofdm.demodulate_slot(jnp.asarray(samples), NSC, n, mu, cp, sis, fc,
                                1.3, offset)
    gb = t_ofdm.demodulate_slot(_t(samples), NSC, n, mu, convert.value(cp),
                                sis, fc, 1.3, offset)
    close(gb, ga)


@pytest.mark.parametrize("scheme", ["bpsk", "pi2bpsk", "qpsk", "qam16",
                                    "qam64", "qam256"])
def test_modulate(scheme):
    qm = j_mod.BITS_PER_SYMBOL[scheme]
    bits = np.random.default_rng(qm).integers(0, 2, (2, 48 * qm)).astype(np.int8)
    close(t_mod.modulate(_t(bits), scheme), j_mod.modulate(jnp.asarray(bits),
                                                           scheme))


@pytest.mark.parametrize("scheme", ["qpsk", "qam16", "qam64", "qam256"])
def test_demodulate(scheme):
    rng = np.random.default_rng(len(scheme))
    sym = _cgauss(rng, (3, 200))
    nv = rng.uniform(0.01, 0.5, (3, 200)).astype(np.float32)
    a = j_mod.demodulate(jnp.asarray(sym), jnp.asarray(nv), scheme)
    b = t_mod.demodulate(_t(sym), _t(nv), scheme)
    close(b, a, rtol=1e-3)


@pytest.mark.parametrize("scheme", ["qpsk", "qam16", "qam64", "qam256"])
def test_evm(scheme):
    sym = _cgauss(np.random.default_rng(7), (500,))
    llr = np.zeros(500 * j_mod.BITS_PER_SYMBOL[scheme], np.float32)
    close(t_evm.evm(_t(sym), _t(llr), scheme),
          j_evm.evm(jnp.asarray(sym), jnp.asarray(llr), scheme))


@pytest.mark.parametrize("nof_layers,ports", [(1, 4), (2, 4), (2, 2), (1, 1)])
def test_equalize_zf(nof_layers, ports):
    rng = np.random.default_rng(nof_layers * 7 + ports)
    y = _cgauss(rng, (300, ports))
    h = _cgauss(rng, (300, ports, nof_layers))
    nv = rng.uniform(0.001, 0.1, 300).astype(np.float32)
    xa, na = j_eq.equalize(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv),
                           nof_layers)
    xb, nb = t_eq.equalize(_t(y), _t(h), _t(nv), nof_layers)
    close(xb, xa)
    close(nb, na)


def test_equalize_unported_raises():
    y, h, nv = torch.zeros(4, 4), torch.zeros(4, 4, 3), torch.zeros(4)
    with pytest.raises(NotImplementedError):
        t_eq.equalize(y.to(torch.complex64), h.to(torch.complex64), nv, 3)
    with pytest.raises(NotImplementedError):
        t_eq.equalize(y.to(torch.complex64), h[..., :1].to(torch.complex64),
                      nv, 1, "mmse")


DMRS_KW = dict(rb_start=2, rb_count=20, symbols=(2, 7, 11), ports=(0, 1),
               scrambling_id=3, slot_in_frame=9)


@pytest.mark.parametrize("source", ["config", "c_inits", "values"])
@pytest.mark.parametrize("port", [0, 1])
def test_pilots_for_port(source, port):
    jc, tc = j_dmrs.DmrsConfig(**DMRS_KW), t_dmrs.DmrsConfig(**DMRS_KW)
    ci = {"config": None, "c_inits": j_dmrs.c_inits_for(jc),
          "values": j_dmrs.pilot_values_for(jc)}[source]
    a = j_dmrs.pilots_for_port(jc, port, None if ci is None else jnp.asarray(ci))
    b = t_dmrs.pilots_for_port(tc, port, None if ci is None else
                               (_t(ci) if source == "values" else ci),
                               device="cpu")
    close(b, a)


def test_dmrs_map_to_grid():
    jc, tc = j_dmrs.DmrsConfig(**DMRS_KW), t_dmrs.DmrsConfig(**DMRS_KW)
    w = np.array([[0.6, 0.2j], [0.1, 0.5], [0.3j, 0.0], [0.0, 0.4]],
                 np.complex64)
    a = j_dmrs.map_to_grid(jnp.zeros((4, 14, NSC), jnp.complex64), jc, w)
    b = t_dmrs.map_to_grid(torch.zeros((4, 14, NSC), dtype=torch.complex64),
                           tc, w)
    close(b, a)


def _rx_grid(cfg, seed, snr_db=30.0, cfo_hz=0.0, delay_s=0.0):
    """A received 4-port grid of the small PUSCH: the port's transmitter
    (2 layers), a flat 4x2 channel, a CFO as a per-symbol phase, a delay as
    a per-subcarrier phase, and AWGN; all drawn with numpy."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, cfg.tbs).astype(np.int8)
    ue = t_pdsch.PdschConfig(
        rnti=cfg.rnti, rb_start=cfg.rb_start, rb_count=cfg.rb_count,
        first_symbol=cfg.first_symbol, nof_symbols=cfg.nof_symbols,
        modulation=cfg.modulation, target_code_rate=cfg.target_code_rate,
        tbs=cfg.tbs, nof_layers=cfg.nof_layers, n_id=cfg.n_id,
        dmrs_symbols=cfg.dmrs_symbols, slot_in_frame=cfg.slot_in_frame)
    tx = t_pdsch.process(torch.zeros((2, 14, NSC), dtype=torch.complex64),
                         _t(payload), ue, precoding=np.eye(2, dtype=np.complex64))
    h = _cgauss(rng, (4, 2))
    rx = np.einsum("pl,lsk->psk", h, tx.numpy())
    t_sym = np.arange(14) * (2048 + 144) / (2048 * 15e3)
    k = np.arange(NSC)
    rx = rx * np.exp(2j * np.pi * cfo_hz * t_sym)[None, :, None]
    rx = rx * np.exp(-2j * np.pi * k * 15e3 * delay_s)[None, None, :]
    p = np.mean(np.abs(rx) ** 2)
    rx = rx + _cgauss(rng, rx.shape, np.sqrt(p * 10 ** (-snr_db / 10)))
    return rx.astype(np.complex64), payload


@pytest.fixture(scope="module")
def rx_case():
    return _rx_grid(J_PUSCH, seed=11, cfo_hz=40.0, delay_s=0.3e-6)


def _ctx(cfg):
    return j_dmrs.pilot_values_for(j_pusch.dmrs_config(cfg))


@pytest.mark.parametrize("td", ["average", "interpolate"])
def test_channel_estimate(rx_case, td):
    import dataclasses
    rx, _ = rx_case
    jcfg = dataclasses.replace(J_PUSCH, td_interpolation=td)
    pil = _ctx(jcfg)
    a = j_pusch.estimate_channel(jnp.asarray(rx), jcfg, jnp.asarray(pil))
    b = t_pusch.estimate_channel(_t(rx), convert.config(jcfg), _t(pil))
    close(b.coeffs, a.coeffs)
    for name in ("noise_var", "rsrp", "snr", "epre"):
        close(getattr(b, name), getattr(a, name))
    assert float(b.time_alignment_s) == float(a.time_alignment_s)
    assert float(a.time_alignment_s) != 0.0
    assert abs(float(b.cfo_hz) - float(a.cfo_hz)) < 1.0
    assert abs(float(a.cfo_hz)) > 1.0


def test_frontend_equalized_symbols(rx_case):
    rx, _ = rx_case
    pil = _ctx(J_PUSCH)
    xa, na, _ = j_pusch._frontend_hop(jnp.asarray(rx), J_PUSCH, jnp.asarray(pil))
    xb, nb, _ = t_pusch._frontend_hop(_t(rx), convert.config(J_PUSCH), _t(pil))
    close(xb, xa)
    close(nb, na)


def test_codeword_llrs(rx_case):
    rx, _ = rx_case
    pil = _ctx(J_PUSCH)
    la, _, ea = j_pusch.codeword_llrs(jnp.asarray(rx), J_PUSCH, jnp.asarray(pil))
    lb, _, eb = t_pusch.codeword_llrs(_t(rx), convert.config(J_PUSCH), _t(pil))
    close(lb, la, rtol=1e-3)
    close(eb, ea)


def test_pusch_process():
    rx, payload = _rx_grid(J_PUSCH, seed=12)
    pil = _ctx(J_PUSCH)
    a = j_pusch.process(jnp.asarray(rx), J_PUSCH, dmrs_cinits=jnp.asarray(pil))
    b = t_pusch.process(_t(rx), convert.config(J_PUSCH), dmrs_cinits=_t(pil))
    assert bool(a.tb_crc_ok) and bool(b.tb_crc_ok)
    np.testing.assert_array_equal(np.asarray(a.tb_bits), b.tb_bits.numpy())
    np.testing.assert_array_equal(b.tb_bits.numpy(), payload)
    np.testing.assert_array_equal(np.asarray(a.cb_crc_ok), b.cb_crc_ok.numpy())
    assert int(a.nof_iterations) == int(b.nof_iterations)


@pytest.mark.parametrize("change", [
    dict(second_hop_prb=4), dict(transform_precoding=True),
    dict(equalizer="mmse"), dict(nof_layers=3)])
def test_pusch_unported_options_raise(change):
    import dataclasses
    cfg = dataclasses.replace(convert.config(J_PUSCH), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_pusch.check_supported(cfg)
