"""CFO rotation (K30's twin) and amplitude control (K31's twin) on the CPU
against the JAX package's ``phy/lower/cfo.py`` and
``phy/lower/amplitude_control.py``, and the JAX tests' CFO and clipping
cases on the port.

Inputs are made from numpy seeds.  Tolerances, all from float32 (values
of magnitude ~1-4): rotated samples within 1e-6 (JAX's and PyTorch's
sin/cos differ by an ulp or two); scaled samples equal; clipped samples
within 1e-6 (XLA's complex abs and PyTorch's differ by an ulp, so the
clip ratio may too); dB metrics within 1e-5 dB (sum order); the clipped
share within one sample over the count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.phy.lower import amplitude_control as j_amp
from srsran_tpu.phy.lower import cfo as j_cfo

from srsran_tpu_torch.phy.lower import amplitude_control as t_amp
from srsran_tpu_torch.phy.lower import cfo as t_cfo

torch.set_num_threads(2)

METRICS = ("avg_power_db", "peak_power_db", "papr_db", "clipped_ratio")


def _cgauss(rng, shape, scale=1.0):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape)) * scale
            ).astype(np.complex64)


@pytest.mark.parametrize("cfo_hz,offset", [
    (370.0, 0), (-1234.5, 7 * 61440), (5e4, 2 ** 24 + 5), (7.5e6, 2 ** 25)])
def test_apply_cfo_matches_jax(cfo_hz, offset):
    """Past 2^24 samples f32(n + offset) rounds in both."""
    x = _cgauss(np.random.default_rng(0), (3, 4096))
    c = cfo_hz / 30.72e6
    ref = np.asarray(j_cfo.apply_cfo(jnp.asarray(x), c, offset))
    got = t_cfo.apply_cfo(torch.as_tensor(x), c, offset).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _processor_run(mod, to_array, blocks, next_every_block: bool):
    p = mod.CfoProcessor(sample_rate_hz=30.72e6)
    p.schedule(mod.CfoCommand(time_s=1e-3, cfo_hz=900.0,
                              cfo_drift_hz_s=2e3))
    p.schedule(mod.CfoCommand(time_s=4e-3, cfo_hz=-300.0))
    out, states = [], []
    for i, blk in enumerate(blocks):
        if next_every_block or i % 4 == 0:
            p.next_command(now_s=i * 0.5e-3)
        out.append(np.asarray(p.process(to_array(blk))))
        states.append((p._cfo_hz, p._sample_offset, p.cfo_norm))
    return np.stack(out), states


@pytest.mark.parametrize("next_every_block", [True, False])
def test_cfo_processor_matches_jax(next_every_block):
    """One command with a drift, then another; ``next_command`` every
    block or every 4th: equal state, samples within 1e-6."""
    blocks = _cgauss(np.random.default_rng(1), (12, 2, 2048))
    ref, ref_states = _processor_run(j_cfo, jnp.asarray, blocks,
                                     next_every_block)
    got, states = _processor_run(t_cfo, torch.as_tensor, blocks,
                                 next_every_block)
    assert states == ref_states
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_next_command_restarts_the_phase():
    """``next_command`` sets the sample offset to 0 on every call (JAX
    cfo.py:50): a caller that calls it once per block restarts the phase
    ramp at each block, where calling it once keeps the phase continuous
    (ROADMAP §3).  The port copies this."""
    x = np.ones((1, 256), np.complex64)
    for mod, arr in ((j_cfo, jnp.asarray), (t_cfo, torch.as_tensor)):
        p = mod.CfoProcessor(sample_rate_hz=1e6)
        p.schedule(mod.CfoCommand(time_s=0.0, cfo_hz=1000.0))
        p.next_command(0.0)
        first = np.asarray(p.process(arr(x)))
        p.next_command(0.0)                       # no new command
        again = np.asarray(p.process(arr(x)))
        np.testing.assert_array_equal(again, first)   # restarted at n = 0
        cont = np.asarray(p.process(arr(x)))          # continuous
        np.testing.assert_allclose(
            cont[0, 0], np.exp(2j * np.pi * 1e-3 * 256), atol=1e-5)


def test_apply_cfo_rotates_and_is_invertible():
    """tests/test_cfo_rusage.py::test_apply_cfo_rotates_and_is_invertible
    on the port."""
    x = _cgauss(np.random.default_rng(0), (2, 1024))
    c = 370.0 / 30.72e6
    y = t_cfo.apply_cfo(torch.as_tensor(x), c).numpy()
    back = t_cfo.apply_cfo(torch.as_tensor(y), -c).numpy()
    np.testing.assert_allclose(back, x, atol=1e-4)
    ph = np.unwrap(np.angle(y[0] / x[0]))
    assert abs(np.polyfit(np.arange(1024), ph, 1)[0] - 2 * np.pi * c) < 1e-7


def test_cfo_processor_commands_drift_and_continuity():
    """tests/test_cfo_rusage.py's processor and drift cases on the port."""
    p = t_cfo.CfoProcessor(sample_rate_hz=30.72e6)
    p.schedule(t_cfo.CfoCommand(time_s=10.0, cfo_hz=500.0))
    p.next_command(now_s=5.0)
    x = torch.ones(256, dtype=torch.complex64)
    assert torch.equal(p.process(x), x)
    p.next_command(now_s=11.0)
    assert p.cfo_norm == 500.0 / 30.72e6
    y1, y2 = p.process(x).numpy(), p.process(x).numpy()
    np.testing.assert_allclose(y2[0] / y1[0],
                               np.exp(2j * np.pi * p.cfo_norm * 256),
                               atol=1e-5)
    d = t_cfo.CfoProcessor(sample_rate_hz=1e6)
    d.schedule(t_cfo.CfoCommand(time_s=0.0, cfo_hz=100.0, cfo_drift_hz_s=10.0))
    d.next_command(now_s=0.0)
    assert abs(d._cfo_hz - 100.0) < 1e-9
    d.next_command(now_s=2.0)
    assert abs(d._cfo_hz - 120.0) < 1e-9


def _hold_metrics(got, ref, n):
    for k in METRICS[:3]:
        assert abs(float(getattr(got, k)) - float(getattr(ref, k))) < 1e-5, k
    assert abs(float(got.clipped_ratio) - float(ref.clipped_ratio)) <= 1.0 / n


@pytest.mark.parametrize("gain_db,ceiling_dbfs,full_scale", [
    (0.0, 0.0, 1.0), (3.0, 2.0, 1.0), (-6.0, -10.0, 1.0), (0.0, -3.0, 2.0),
    (0.0, 9.5, 1.0)])
def test_clip_matches_jax(gain_db, ceiling_dbfs, full_scale):
    """Ceilings that clip 20-60% of the samples, and about 1%."""
    x = _cgauss(np.random.default_rng(2), (4, 3072))
    ref, ref_m = j_amp.clip(jnp.asarray(x), gain_db, ceiling_dbfs, full_scale)
    got, m = t_amp.clip(torch.as_tensor(x), gain_db, ceiling_dbfs, full_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    _hold_metrics(m, ref_m, x.size)


@pytest.mark.parametrize("gain_db", [0.0, -20.0, 7.3])
def test_scale_matches_jax(gain_db):
    x = _cgauss(np.random.default_rng(3), (2, 2048))
    ref, ref_m = j_amp.scale(jnp.asarray(x), gain_db)
    got, m = t_amp.scale(torch.as_tensor(x), gain_db)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _hold_metrics(m, ref_m, x.size)
    assert float(m.clipped_ratio) == 0.0


def test_amplitude_clipping():
    """tests/test_io_lower.py::test_amplitude_clipping on the port."""
    x = torch.as_tensor(_cgauss(np.random.default_rng(2), 2048))
    out, m = t_amp.clip(x, gain_db=0.0, ceiling_dbfs=0.0)
    assert float(out.abs().max()) <= 1.0 + 1e-5
    assert float(m.clipped_ratio) > 0.1
    _, m2 = t_amp.scale(x, gain_db=-20.0)
    assert abs(float(m2.avg_power_db) - (10 * np.log10(2) - 20)) < 0.5
