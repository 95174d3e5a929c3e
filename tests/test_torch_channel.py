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

K20's work split and sum order (csrc/tdl_channel.cu) as a numpy model
built from its launch struct alone (``channel._tdl_split`` /
``_tdl_params``): CTAs (run of 32 lanes, symbol group, rx port), a warp a
symbol, V subcarriers a lane; H formed in tap order and stored by symbol
group 0, rx mixed in TX port order; each thread's |rx|^2 in double, a
butterfly over the warp's lanes, a butterfly over the CTA's warps, then
over all partials lane l taking l, l + 32, ... in order and a butterfly,
lane 0's value.  The model covers every (r, s, k) once and H once, and is
held to the JAX ``run`` on the shared draws within the same 1e-5, for
every (R, T) and profile of ``PORTS`` and at the gNB simulator's 4 x 4
TDLA shape, K = 3,276.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.emulation import channel as j_chan

from srsran_tpu_torch import convert
from srsran_tpu_torch.emulation import channel as t_chan
from srsran_tpu_torch.kernels import _build

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


SMS = 132                   # an H100's SMs, as the plan reads them


def _tree(v: np.ndarray) -> np.ndarray:
    """A __shfl_xor_sync butterfly sum over the last axis (a power of
    two): lane 0's value, lane i adding lane i + m for m = n/2, ..., 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _k20_index(p):
    """Per (r, symbol group y, run x, warp w, lane l, subcarrier i of the
    lane) of K20's launch: (r, s, k, writes): the RE the thread stores."""
    r, y, x, w, lane, i = np.meshgrid(
        np.arange(p.R), np.arange(p.splits), np.arange(p.runs),
        np.arange(p.warps), np.arange(32), np.arange(p.V), indexing="ij")
    j = x * 32 + lane
    s = y * p.warps + w
    k = j * p.V + i
    return r, s, k, (j < p.lanes) & (s < p.S) & (k < p.K)


def _k20_model(tx, gains, noise, steer, rot, p):
    """(rx, H, partials): K20 on numpy inputs as its launch computes it."""
    r_n, t_n, s_n, k_n = p.R, p.T, p.S, p.K
    h = np.zeros((r_n, t_n, k_n), np.complex64)
    for d in range(p.D):                      # tap order, one a step
        h = (h + gains[:, :, d, None] * steer[None, None, d]).astype(
            np.complex64)
    y = np.zeros((r_n, s_n, k_n), np.complex64)
    for t in range(t_n):                      # TX port order
        y = (y + h[:, t, None, :] * tx[None, t]).astype(np.complex64)
    if p.use_rot:
        y = (y * rot[None, :, None]).astype(np.complex64)
    r, s, k, live = _k20_index(p)
    pw = np.where(live, y.real[r, np.minimum(s, s_n - 1),
                                np.minimum(k, k_n - 1)].astype(np.float64)
                  ** 2 + y.imag[r, np.minimum(s, s_n - 1),
                                np.minimum(k, k_n - 1)].astype(
                      np.float64) ** 2, 0.0)
    acc = np.zeros(pw.shape[:-1])
    for i in range(p.V):                      # a thread's subcarriers
        acc = acc + pw[..., i]
    warp = _tree(acc)                         # [R, splits, runs, warps]
    lanes = np.zeros(warp.shape[:-1] + (32,))
    lanes[..., :p.warps] = warp
    partials = _tree(lanes).reshape(-1)       # bid = (r splits + y) runs + x
    assert partials.size == p.nblocks
    per_lane = np.zeros(32)
    for base in range(0, p.nblocks, 32):
        chunk = partials[base:base + 32]
        per_lane[:chunk.size] = per_lane[:chunk.size] + chunk
    amp = np.float32(np.sqrt(_tree(per_lane) * p.scale))
    rx = (y.real + amp * noise.real).astype(np.float32) + 1j * (
        y.imag + amp * noise.imag).astype(np.float32)
    return rx.astype(np.complex64), h, partials


def _k20_params(cfg, vec=2, sms=SMS):
    r, t = cfg.nof_rx_ports, cfg.nof_tx_ports
    d, s, k = len(t_chan.PROFILES[cfg.profile]), cfg.nof_symbols, cfg.nof_subc
    splits, warps = t_chan._tdl_split(r, t, s, k, d, vec, sms)
    return t_chan._tdl_params(r, t, s, k, d, vec, splits, warps,
                              bool(cfg.cfo_hz), cfg.sinr_db)


def _model_vs_jax(cfg, seed, vec=2):
    r, t = cfg.nof_rx_ports, cfg.nof_tx_ports
    k = cfg.nof_subc
    rng = np.random.default_rng(seed)
    tx = ((rng.standard_normal((t, 14, k))
           + 1j * rng.standard_normal((t, 14, k))) / np.sqrt(2)
          ).astype(np.complex64)
    tx[:, :, :36] = 0
    key = jax.random.PRNGKey(seed)
    rx_ref, h_ref = j_chan.run(key, jnp.asarray(tx), cfg)
    gains, noise = _jax_draws(key, cfg)
    tcfg = convert.config(cfg)
    p = _k20_params(tcfg, vec)
    rx, h, _ = _k20_model(tx, gains, noise,
                          t_chan._steering(cfg.profile, k, cfg.scs_hz),
                          t_chan._rotation(float(cfg.cfo_hz), 14,
                                           cfg.scs_hz), p)
    _close(h, np.asarray(h_ref), 1e-5)
    _close(rx, np.asarray(rx_ref), 1e-5)
    return p


@pytest.mark.parametrize("profile,fading,cfo,rt", CASES)
def test_k20_model_matches_jax(profile, fading, cfo, rt):
    """K20's model on the JAX draws, every (R, T) and profile of PORTS."""
    r, t = rt
    cfg = j_chan.ChannelConfig(profile=profile, fading=fading, sinr_db=17.0,
                               cfo_hz=cfo, nof_tx_ports=t, nof_rx_ports=r,
                               nof_subc=12 * NRB, scs_hz=30_000)
    _model_vs_jax(cfg, len(profile) + 7 * r + t, vec=1 if cfo else 2)


def test_k20_model_matches_jax_at_the_gnb_shape():
    """The gNB simulator's 4 x 4 TDLA at 28 dB, K = 3,276: 416 CTAs of 7
    warps, each a symbol (the former kernel ran 52 CTAs)."""
    cfg = j_chan.ChannelConfig(profile="TDLA", sinr_db=28.0, nof_tx_ports=4,
                               nof_rx_ports=4, nof_subc=3276,
                               scs_hz=30_000)
    p = _model_vs_jax(cfg, 20)
    assert (p.runs, p.splits, p.warps, p.nblocks) == (52, 2, 7, 416)
    assert p.nblocks >= 2 * SMS


@pytest.mark.parametrize("r,t,k,d,vec", [
    (4, 4, 3276, 12, 2), (1, 4, 3276, 12, 2), (4, 4, 288, 12, 2),
    (2, 8, 624, 16, 2), (4, 2, 625, 12, 1), (16, 8, 3276, 16, 2),
    (1, 1, 12, 1, 1)])
def test_k20_split_covers_every_re_and_h_once(r, t, k, d, vec):
    """Every (r, s, k) is stored by one thread, every H[r, t, k] by one
    (symbol group 0, warp t mod warps); the CTA fits the kernel's caps."""
    p = t_chan._tdl_params(r, t, 14, k, d, vec,
                           *t_chan._tdl_split(r, t, 14, k, d, vec, SMS),
                           False, 20.0)
    rr, s, kk, live = _k20_index(p)
    cover = np.zeros((r, 14, k), int)
    np.add.at(cover, (rr[live], s[live], kk[live]), 1)
    assert (cover == 1).all()
    # H: CTAs of group 0, rows t = w, w + warps, ... of each warp
    hcover = np.zeros((r, t, k), int)
    for w in range(p.warps):
        for row in range(w, t, p.warps):
            sel = live[:, 0, :, 0] if p.S else None
            rr0, kk0 = rr[:, 0, :, 0][sel], kk[:, 0, :, 0][sel]
            np.add.at(hcover, (rr0, np.full_like(rr0, row), kk0), 1)
    assert (hcover == 1).all()
    assert p.warps <= _build.TDL_MAX_WARPS
    assert p.smem <= _build.TDL_MAX_SMEM
    assert p.splits * p.warps >= 14 > (p.splits - 1) * p.warps
    assert p.nblocks >= min(2 * SMS, p.runs * r * 14)


def test_k20_partials_sum_in_a_fixed_order():
    """The partials in the kernel's order give the same total run to run,
    and that total is the RE power sum (double) to 1e-12."""
    cfg = t_chan.ChannelConfig(profile="TDLB", sinr_db=10.0, nof_tx_ports=2,
                               nof_rx_ports=4, nof_subc=12 * NRB)
    rng = np.random.default_rng(5)
    tx = ((rng.standard_normal((2, 14, 12 * NRB)) + 1j) / 2).astype(
        np.complex64)
    gains = (rng.standard_normal((4, 2, 12)) + 0j).astype(np.complex64)
    noise = np.zeros((4, 14, 12 * NRB), np.complex64)
    p = _k20_params(cfg)
    steer = t_chan._steering("TDLB", 12 * NRB, 30_000)
    rot = t_chan._rotation(0.0, 14, 30_000)
    rx1, _, part1 = _k20_model(tx, gains, noise, steer, rot, p)
    rx2, _, part2 = _k20_model(tx, gains, noise, steer, rot, p)
    assert np.array_equal(part1, part2) and np.array_equal(rx1, rx2)
    power = (np.abs(rx1.astype(np.complex128)) ** 2).sum()
    assert abs(part1.sum() - power) <= 1e-12 * power


def test_k20_refusals_name_their_limit():
    """Past K20's caps the plan raises a ValueError naming them, before it
    touches a card: more than 8 TX ports or 16 taps, 2^31 elements in any
    array the kernel indexes (rx, and H when the symbols are fewer than
    the TX ports), another dtype, inputs on two devices."""
    cfg = t_chan.ChannelConfig(nof_tx_ports=9, nof_rx_ports=1,
                               nof_subc=12 * NRB)
    shapes = ((9, 14, 12 * NRB), (1, 9, 12), (1, 14, 12 * NRB))
    c64 = (torch.complex64,) * 3
    with pytest.raises(ValueError, match=r"9 TX ports / 12 taps \(K20 "
                       r"takes 8 / 16\)"):
        t_chan._tdl_plan(shapes, c64, (0, 0, 0), cfg, 2)
    big = t_chan.ChannelConfig(nof_tx_ports=1, nof_rx_ports=8,
                               nof_subc=1 << 25)
    with pytest.raises(ValueError, match="2\\^31 elements"):
        t_chan._tdl_plan(((1, 14, 1 << 25), (8, 1, 12), (8, 14, 1 << 25)),
                         c64, (0, 0, 0), big, 2)
    wide_h = t_chan.ChannelConfig(nof_tx_ports=8, nof_rx_ports=8,
                                  nof_symbols=2, nof_subc=1 << 26)
    with pytest.raises(ValueError, match="2\\^31 elements"):
        t_chan._tdl_plan(((8, 2, 1 << 26), (8, 8, 12), (8, 2, 1 << 26)),
                         c64, (0, 0, 0), wide_h, 2)
    with pytest.raises(ValueError, match="complex64"):
        t_chan._tdl_plan(((1, 14, 624), (1, 1, 12), (1, 14, 624)),
                         (torch.complex128,) + c64[1:], (0, 0, 0),
                         t_chan.ChannelConfig(nof_subc=624), 2)
    with pytest.raises(ValueError, match="CUDA devices"):
        t_chan._tdl_plan(((1, 14, 624), (1, 1, 12), (1, 14, 624)), c64,
                         (0, 1, 0), t_chan.ChannelConfig(nof_subc=624), 2)


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
