"""The port's TDL channel emulator (K20's twin) against the JAX package's.

The port's ``channel.apply`` takes its draws explicitly; the JAX
``channel.run`` draws them from a PRNG key.  Each case rebuilds the JAX
draws from the same key (the split and ``fold_in`` sequence of
srsran_tpu/emulation/channel.py:73-95), hands them to the port, and holds
rx and H within 1e-5 of max|rx| and max|H| (float32 einsums summed in
another order).  ``run`` with a ``torch.Generator`` is checked for its
shapes, determinism and noise level (its draws differ from jax.random's
by construction).  K20 itself runs in tests/test_torch_kernels.py on a
GPU and in chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.emulation import channel as j_chan

from srsran_tpu_torch import convert
from srsran_tpu_torch.emulation import channel as t_chan

torch.set_num_threads(2)

NRB = 52
# Every (R, T) from {1, 2, 4} appears over the profiles.
PORTS = {"single-tap": [(1, 1), (2, 4)], "TDLA": [(4, 4), (1, 2)],
         "TDLB": [(2, 1), (4, 2)], "TDLC": [(1, 4), (2, 2)]}
CASES = [(profile, fading, cfo, rt)
         for profile, rts in PORTS.items()
         for fading, rt in zip(("rayleigh", "uniform-phase"), rts)
         for cfo in (0.0, 750.0)]


def _jax_draws(key, cfg):
    """The JAX function's gains and noise for ``key``, rebuilt."""
    kg, kp, kn = jax.random.split(key, 3)
    taps = len(j_chan.PROFILES[cfg.profile])
    shape = (cfg.nof_rx_ports, cfg.nof_tx_ports, taps)
    if cfg.fading == "rayleigh":
        g = (jax.random.normal(kg, shape) + 1j * jax.random.normal(kp, shape))
        g = g / np.sqrt(2)
    else:
        phase = jax.random.uniform(kg, shape, minval=0.0, maxval=2 * np.pi)
        g = jnp.exp(1j * phase)
    g = g * jnp.asarray(j_chan._amplitudes(cfg.profile))
    nshape = (cfg.nof_rx_ports, cfg.nof_symbols, cfg.nof_subc)
    noise = (jax.random.normal(kn, nshape)
             + 1j * jax.random.normal(jax.random.fold_in(kn, 1), nshape))
    return (np.asarray(g.astype(jnp.complex64)),
            np.asarray(noise.astype(jnp.complex64)))


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("profile,fading,cfo,rt", CASES)
def test_channel_apply_matches_jax(profile, fading, cfo, rt):
    r, t = rt
    cfg = j_chan.ChannelConfig(profile=profile, fading=fading, sinr_db=17.0,
                               cfo_hz=cfo, nof_tx_ports=t, nof_rx_ports=r,
                               nof_subc=12 * NRB, scs_hz=30_000)
    rng = np.random.default_rng(len(profile) + 7 * r + t)
    tx = ((rng.standard_normal((t, 14, 12 * NRB))
           + 1j * rng.standard_normal((t, 14, 12 * NRB))) / np.sqrt(2)
          ).astype(np.complex64)
    tx[:, :, :36] = 0                       # empty REs count in the power
    key = jax.random.PRNGKey(r * 10 + t)
    rx_ref, h_ref = j_chan.run(key, jnp.asarray(tx), cfg)
    gains, noise = _jax_draws(key, cfg)
    rx, h = t_chan.apply(torch.as_tensor(tx), convert.config(cfg),
                         torch.from_numpy(gains.copy()),
                         torch.from_numpy(noise.copy()))
    _close(h.numpy(), np.asarray(h_ref), 1e-5)
    _close(rx.numpy(), np.asarray(rx_ref), 1e-5)


def test_channel_tables_copy():
    for profile in j_chan.PROFILES:
        np.testing.assert_array_equal(t_chan._amplitudes(profile),
                                      j_chan._amplitudes(profile))
        np.testing.assert_array_equal(
            t_chan._steering(profile, 12 * NRB, 30_000),
            j_chan._steering(profile, 12 * NRB, 30_000))
    assert t_chan.PROFILES == j_chan.PROFILES


@pytest.mark.parametrize("fading", ["rayleigh", "uniform-phase"])
def test_channel_run_draws(fading):
    """run(): a seeded generator gives the same rx twice and another seed
    another; the noise it adds has the power the SINR asks for."""
    cfg = t_chan.ChannelConfig(profile="TDLA", fading=fading, sinr_db=10.0,
                               nof_tx_ports=2, nof_rx_ports=4,
                               nof_subc=12 * NRB)
    tx = torch.ones((2, 14, 12 * NRB), dtype=torch.complex64)

    def draw(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return t_chan.run(tx, cfg, gen)

    (rx1, h1), (rx2, _), (rx3, _) = draw(3), draw(3), draw(4)
    assert rx1.shape == (4, 14, 12 * NRB) and h1.shape == (4, 2, 12 * NRB)
    assert torch.equal(rx1, rx2) and not torch.equal(rx1, rx3)
    clean = torch.einsum("rtk,tsk->rsk", h1, tx)
    sig = float(torch.mean(clean.abs() ** 2))
    noise = float(torch.mean((rx1 - clean).abs() ** 2))
    assert abs(10 * np.log10(sig / noise) - 10.0) < 0.2


def test_channel_checks_shapes():
    cfg = t_chan.ChannelConfig(nof_tx_ports=2, nof_rx_ports=2,
                               nof_subc=12 * NRB)
    gains = torch.zeros((2, 2, 12), dtype=torch.complex64)
    noise = torch.zeros((2, 14, 12 * NRB), dtype=torch.complex64)
    with pytest.raises(ValueError):
        t_chan.apply(torch.zeros((1, 14, 12 * NRB), dtype=torch.complex64),
                     cfg, gains, noise)
