"""The port's lower PHY: the PRACH occasion demodulator (K21's twin) against
the JAX package's, and the baseband processor's four cases of
tests/test_baseband.py on the port's ``BasebandProcessor`` (on the CPU).

The demodulator is held within 1e-4 of max|out|: a float32 sum over N_u
samples in another order than XLA's.  K21 itself runs in
tests/test_torch_kernels.py on a GPU and in chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.phy.lower import prach_demod as j_demod

from srsran_tpu_torch.phy.lower import prach_demod as t_demod
from srsran_tpu_torch.phy.lower.baseband import (BasebandProcessor,
                                                 PrachOccasionRequest,
                                                 _PrachCollector)

torch.set_num_threads(2)

# (format, sample rate, start sample, frequency offset, RA SCS)
DEMOD_CASES = [
    ("B4", 512 * 30_000, 0, -(288 // 2) * 30_000, 30_000),   # the app's
    ("B4", 512 * 30_000, 37, 12 * 30_000 * 5, 30_000),       # positive
    ("A1", 256 * 15_000, 5, -3 * 15_000, 15_000),
    ("0", 1_920_000, 11, -20 * 1250, 0),                     # long format
    ("0", 1_920_000, 0, 700 * 1250, 0),                      # b0 + k > N_u
    ("B4", 512 * 30_000, 3, -30_000, 30_000),                # b0 = N_u - 1
    ("C2", 1024 * 30_000, 0, -500 * 30_000, 30_000),         # 4 reps
]


@pytest.mark.parametrize("fmt,fs,start,f_off,ra_scs", DEMOD_CASES)
def test_prach_demod_matches_jax(fmt, fs, start, f_off, ra_scs):
    l_ra, n_u, reps, _ = t_demod.geometry(fmt, fs, f_off, ra_scs)
    rng = np.random.default_rng(n_u + reps + start)
    x = (rng.standard_normal((2, start + reps * n_u + 9))
         + 1j * rng.standard_normal((2, start + reps * n_u + 9))
         ).astype(np.complex64)
    ref = np.asarray(j_demod.demodulate(jnp.asarray(x), fmt, fs, start,
                                        f_off, ra_scs_hz=ra_scs))
    got = t_demod.demodulate(torch.as_tensor(x), fmt, fs, start, f_off,
                             ra_scs_hz=ra_scs).numpy()
    assert got.shape == ref.shape == (2, reps, l_ra)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


def _replay_k21(x, p):
    """csrc/prach_demod.cu's arithmetic in numpy from the parameters its
    cached plan passes: per split of 32-sample blocks q, sum_l tw[b l]
    sum_q tw[32 b q] x[32 q + l] (every index exact mod N_u), times
    sqrt(N_u); the splits summed in order."""
    n_u, reps = p.n_u, p.reps
    tw = t_demod._twiddles(n_u)
    b = (p.b0 + np.arange(p.l_ra))[:, None] % n_u
    nblocks = -(-n_u // 32)
    win = np.zeros((p.ports, reps, nblocks * 32), np.complex64)
    win[..., :n_u] = x[:, p.start:p.start + reps * n_u].reshape(
        p.ports, reps, n_u)
    win = win.reshape(p.ports, reps, nblocks, 32)
    lane = tw[(b * np.arange(32)[None, :]) % n_u]             # [L_ra, 32]
    out = 0
    for s in range(p.splits):
        q = np.arange(s * p.split_blocks,
                      min(nblocks, (s + 1) * p.split_blocks))
        inner = np.einsum("kq,prql->prkl", tw[(b * 32 * q[None, :]) % n_u],
                          win[:, :, q])
        out = out + np.einsum("kl,prkl->prk", lane, inner) * np.float32(
            p.scale)
    return out


@pytest.mark.parametrize("ports", [4, 1])
@pytest.mark.parametrize("name", ["prach_demod", "prach_demod_n6144",
                                  "prach_demod_format0"])
def test_prach_demod_plan_of_chip_smoke_cases(name, ports):
    """The cached plan's parameters for chip_smoke.py's K21 cases (4 ports,
    and 1) on a 132-SM card: geometry's (L_ra, N_u, reps, b0), the window,
    the tiling and split-K; the kernel's factorization replayed from them
    within 1e-4 of max|out| of the twin."""
    from srsran_tpu_torch import flagship
    fmt, fs, start, f_off, fd, ra, length = flagship.PRACH_DEMOD_CASES[name]
    p = t_demod._demod_params(fmt, fs, start, f_off, fd, ra,
                              (ports, length), torch.complex64, 132)
    l_ra, n_u, reps, b0 = t_demod.geometry(fmt, fs, f_off, ra)
    assert (p.l_ra, p.n_u, p.reps, p.b0) == (l_ra, n_u, reps, b0)
    assert (p.ports, p.row_stride, p.start) == (ports, length, start)
    assert p.rt == min(4, 1 << (ports * reps).bit_length() - 1)
    assert abs(p.scale - np.sqrt(n_u)) <= 1e-6 * np.sqrt(n_u)
    nblocks = -(-n_u // 32)
    assert p.split_blocks % t_demod.KWARPS == 0
    assert (p.splits - 1) * p.split_blocks < nblocks <= (
        p.splits * p.split_blocks)
    tiles = -(-l_ra // t_demod.KBINS) * -(-ports * reps // p.rt)
    assert (p.splits > 1) == (tiles < 132)
    rng = np.random.default_rng(n_u + ports)
    x = (rng.standard_normal((ports, length))
         + 1j * rng.standard_normal((ports, length))).astype(np.complex64)
    ref = t_demod.demodulate_ref(torch.as_tensor(x), fmt, fs, start, f_off,
                                 fd, ra).numpy()
    np.testing.assert_allclose(_replay_k21(x, p), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("n_u,b0,l_ra", [(4096, 2458, 139), (24576, 23000, 839)])
def test_prach_demod_twiddles_match_bin_matrix(n_u, b0, l_ra):
    """K21's integer-indexed table gives the JAX bin matrix's entries:
    tw[((b0 + k) n) mod N_u] for every bin and sample."""
    tw = t_demod._twiddles(n_u)
    m = j_demod._bin_dft_matrix(n_u, b0, l_ra)
    k = np.arange(l_ra)[:, None]
    n = np.arange(n_u)[None, :]
    idx = ((b0 + k) % n_u * n) % n_u
    np.testing.assert_allclose(tw[idx], m, rtol=0, atol=2e-7)
    np.testing.assert_array_equal(t_demod._bin_dft_matrix(n_u, b0, l_ra), m)


def test_prach_demod_window_check():
    with pytest.raises(ValueError):
        t_demod.demodulate(torch.zeros((1, 100), dtype=torch.complex64),
                           "B4", 512 * 30_000, 0, 0.0, ra_scs_hz=30_000)


@pytest.mark.parametrize("fn", [t_demod.demodulate, t_demod.demodulate_ref])
def test_prach_demod_raises_on_fd_occasions(fn):
    """More than one frequency-domain occasion raises rather than
    returning one occasion (the JAX function ignores the argument)."""
    x = torch.zeros((1, 12 * 512), dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn(x, "B4", 512 * 30_000, 0, 0.0, 2, 30_000)


class RecordingRu:
    """A radio unit that records (timestamp, nof_samples) of every DL send
    and serves a deterministic UL ramp, so window placement is checkable
    (tests/test_baseband.py's, without the JAX package's RU base)."""

    def __init__(self, nof_ports, total):
        self.sent = []
        self.ul = (np.arange(total, dtype=np.float32)[None, :]
                   .repeat(nof_ports, 0).astype(np.complex64))
        self.pos = 0

    def start(self):
        pass

    def stop(self):
        pass

    def send_dl(self, samples, timestamp=0):
        self.sent.append((timestamp, samples.shape[-1]))

    def receive_ul(self, count):
        if self.pos + count > self.ul.shape[-1]:
            return None
        s = self.ul[:, self.pos:self.pos + count]
        ts, self.pos = self.pos, self.pos + count
        return s, ts


def test_tti_advance_and_timestamp_slaving():
    ru = RecordingRu(2, 200_000)
    ttis, rxs = [], []
    bb = BasebandProcessor(ru, nof_ports=2, dft_size=128, numerology=1,
                           tx_time_offset=256, nof_slot_tti_in_advance=2,
                           tti_notifier=ttis.append,
                           rx_notifier=lambda s, x, ts: rxs.append((s, ts)),
                           device="cpu")
    bb.start()
    assert ttis == [0, 1]          # primed n slots in advance at start
    for s in range(4):
        bb.push_dl(s, np.zeros((2, bb.slot_samples(s)), np.complex64))
    bb.run(4)
    assert ttis == [0, 1, 2, 3, 4, 5]
    assert [t for t, _ in ru.sent] == [r[1] + 256 for r in rxs]
    assert bb.metrics["tx_slots"] == 4 and bb.metrics["late_dl"] == 0


def test_late_dl_transmits_silence_and_counts():
    ru = RecordingRu(1, 50_000)
    bb = BasebandProcessor(ru, nof_ports=1, dft_size=128, numerology=0,
                           device="cpu")
    bb.start()
    bb.run(2)                      # nothing pushed
    assert bb.metrics["late_dl"] == 2
    assert bb.metrics["tx_slots"] == 2


def test_prach_window_straddles_slot_boundary():
    """A short-format window beginning near the end of slot 1 collects
    samples across the slot-2 boundary; its capture arrives demodulated,
    on the processor's device."""
    captured = []
    ru = RecordingRu(1, 400_000)
    bb = BasebandProcessor(ru, nof_ports=1, dft_size=128, numerology=1,
                           prach_notifier=lambda req, fd: captured.append(
                               (req, fd)), device="cpu")
    bb.start()
    nsamp = bb.slot_samples(1)
    req = PrachOccasionRequest(slot=1, start_sample=nsamp - 200, fmt="A1")
    assert req.window_samples(bb.sample_rate_hz) > 200    # must straddle
    bb.request_prach(req)
    for s in range(4):
        bb.push_dl(s, np.zeros((1, bb.slot_samples(s)), np.complex64))
    bb.run(4)
    assert [r for r, _ in captured] == [req]
    assert bb.metrics["prach_windows"] == 1
    fd = captured[0][1]
    assert isinstance(fd, torch.Tensor) and fd.shape == (1, 2, 139)


def test_prach_collector_grabs_exact_window():
    """The collected samples are exactly [abs_start, abs_start+needed) of
    the rx timeline, and the capture is the JAX demodulator's of them."""
    got = {}

    def note(req, fd):
        got["fd"] = fd

    req = PrachOccasionRequest(slot=0, start_sample=300, fmt="C0")
    col = _PrachCollector(req, abs_start=300, nof_ports=1,
                          sample_rate_hz=128 * 30_000, notifier=note)
    ramp = (np.arange(10_000, dtype=np.float32)[None]).astype(np.complex64)
    assert col.needed == 256                    # C0 @ 3.84 Msps: one 256 rep
    done = col.feed(ramp[:, :400], 0)           # covers [300, 556) partially
    assert not done and col.filled == 100
    done = col.feed(ramp[:, 400:2000], 400)
    assert done
    np.testing.assert_array_equal(col.buf[0].real,
                                  np.arange(300, 300 + col.needed))
    ref = np.asarray(j_demod.demodulate(jnp.asarray(col.buf), "C0",
                                        128 * 30_000, 0, 0.0))
    np.testing.assert_allclose(got["fd"].numpy(), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_baseband_runs_on_the_card_by_default(monkeypatch):
    """device=None means the current CUDA device: without one it raises,
    it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BasebandProcessor(RecordingRu(1, 10), nof_ports=1, dft_size=128,
                          numerology=0)
