"""The split-8 radio on the CPU: the port's sampio runtime (``io/``), its
radio units (``ru/units.py``) and its ``ssb_tx`` and ``rx_power`` apps,
against the JAX package's.

- Files: either package reads the other's, and the bytes are equal.
- The JAX tests' ring, file and radio-unit cases run on the port.
- The port builds its library under ``build/`` and writes no path under
  ``native/`` (the JAX loader rebuilds ``native/libsampio.so`` in place;
  its mtime is not checked here, another test worker may be at it).
- ``ssb_tx`` at 52 RB / 1024 FFT, one frame, on the CPU: its file within
  1e-6 of the JAX app's (run in a subprocess with ``JAX_PLATFORMS=cpu``;
  sample magnitudes up to ~1.4, sums in another order).
- ``rx_power``: its printed lines equal the JAX app's on that file.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_tpu.io import sampio as j_sampio
from srsran_tpu.ru import units as j_units

from srsran_tpu_torch.apps import rx_power, ssb_tx
from srsran_tpu_torch.io import sampio as t_sampio
from srsran_tpu_torch.ru import RuDummy, RuFile, RuRing

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _cgauss(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@pytest.mark.parametrize("writer,reader", [(t_sampio, j_sampio),
                                           (j_sampio, t_sampio)])
def test_files_cross_read(tmp_path, writer, reader):
    x = _cgauss(np.random.default_rng(4), (3, 500))
    path = str(tmp_path / "x.sio")
    w = writer.SampleFileWriter(path, 3, 122.88e6)
    w.write(x[:, :200])
    w.write(x[:, 200:])
    w.close()
    r = reader.SampleFileReader(path)
    assert (r.nof_channels, r.sample_rate) == (3, 122.88e6)
    np.testing.assert_array_equal(r.read(320), x[:, :320])
    np.testing.assert_array_equal(r.read(1000), x[:, 320:])
    assert r.read(10).shape == (3, 0)
    r.close()


def test_files_byte_equal(tmp_path):
    x = _cgauss(np.random.default_rng(5), (2, 333))
    paths = []
    for mod in (t_sampio, j_sampio):
        paths.append(tmp_path / f"{mod.__name__}.sio")
        w = mod.SampleFileWriter(str(paths[-1]), 2, 30.72e6)
        w.write(x)
        w.close()
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_library_lives_under_build():
    """The port loads its own build of native/sampio.cpp from build/, and
    its compile command writes nothing under native/."""
    lib = Path(t_sampio._load()._name).resolve()
    build = (REPO / "build").resolve()
    native = (REPO / "native").resolve()
    assert build in lib.parents and native not in lib.parents
    cmd = t_sampio.compile_command(t_sampio.library_path())
    out = Path(cmd[cmd.index("-o") + 1]).resolve()
    assert build in out.parents and native not in out.parents
    assert str(t_sampio.SOURCE) in cmd
    written = [a for a in cmd if a != str(t_sampio.SOURCE)]
    assert not any(str(native) in a for a in written)


# ----------------------------------- tests/test_io_lower.py on the port

def test_ring_roundtrip():
    ring = t_sampio.SampleRing(4096, 2)
    x = _cgauss(np.random.default_rng(0), (2, 1000))
    assert ring.write(x)
    data, ts = ring.read(1000)
    assert ts == 0
    np.testing.assert_array_equal(data, x)
    assert ring.write(x)
    assert ring.read(1000)[1] == 1000


def test_ring_wraparound_and_backpressure():
    ring = t_sampio.SampleRing(1024, 1)
    cap = ring.capacity
    assert ring.write(np.ones((1, cap), dtype=np.complex64))
    assert not ring.write(np.ones((1, 1), dtype=np.complex64))   # full
    ring.read(cap // 2)
    y = (np.arange(cap // 2, dtype=np.float32) + 1j).astype(np.complex64)[None]
    assert ring.write(y)                                          # wraps
    ring.read(cap // 2)
    data, _ = ring.read(cap // 2)
    np.testing.assert_array_equal(data, y)


def test_ring_threaded():
    ring = t_sampio.SampleRing(1 << 14, 1)
    total, blk, recv = 200, 512, []

    def producer():
        for i in range(total):
            x = np.full((1, blk), i + 1j * i, dtype=np.complex64)
            while not ring.write(x):
                pass

    def consumer():
        while len(recv) < total:
            out = ring.read(blk)
            if out is not None:
                recv.append(out[0][0, 0])

    threads = [threading.Thread(target=producer),
               threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    np.testing.assert_array_equal(
        np.asarray(recv), np.arange(total) + 1j * np.arange(total))


def test_file_roundtrip(tmp_path):
    path = str(tmp_path / "x.sio")
    x = _cgauss(np.random.default_rng(1), (2, 300))
    w = t_sampio.SampleFileWriter(path, 2, 61.44e6)
    w.write(x)
    w.close()
    r = t_sampio.SampleFileReader(path)
    assert r.nof_channels == 2 and abs(r.sample_rate - 61.44e6) < 1
    np.testing.assert_allclose(r.read(300), x)
    r.close()


# ------------------------------------------------------- radio units

def test_ru_dummy_loopback_with_channel():
    """tests/test_fapi_ru.py's RuDummy case, with a DL slot's samples and
    their timestamps, beside the JAX unit."""
    x = _cgauss(np.random.default_rng(6), (4, 6144))
    got = []
    for mod in (RuDummy, j_units.RuDummy):
        ru = mod(4, channel_fn=lambda s: 0.5 * s)
        ru.send_dl(x[:, :4096], 0)
        ru.send_dl(x[:, 4096:], 4096)
        got.append([ru.receive_ul(2048), ru.receive_ul(4096),
                    ru.receive_ul(1)])
    (a0, ts0), (a1, ts1), none = got[0]
    assert (ts0, ts1, none) == (0, 2048, None)
    np.testing.assert_allclose(np.concatenate([a0, a1], axis=1), 0.5 * x)
    for (a, ta), (b, tb) in zip(got[0][:2], got[1][:2]):
        assert ta == tb
        np.testing.assert_array_equal(a, b)


def test_ru_ring_round_trip():
    """Both rings of an RuRing: DL out to the peer, UL in from it, with
    the timestamps of the reads; overflow raises."""
    x = _cgauss(np.random.default_rng(7), (2, 3000))
    ru = RuRing(2, capacity=4096)
    ru.send_dl(x, 0)
    got, ts = ru.tx.read(3000)
    assert ts == 0
    np.testing.assert_array_equal(got, x)
    assert ru.rx.write(x[:, :1000]) and ru.rx.write(x[:, 1000:2000])
    assert ru.receive_ul(1500)[1] == 0 and ru.receive_ul(500)[1] == 1500
    assert ru.receive_ul(1) is None
    with pytest.raises(BufferError):
        ru.send_dl(np.zeros((2, 8192), np.complex64))


def test_ru_file_record_replay(tmp_path):
    """tests/test_fapi_ru.py's RuFile case; the JAX unit replays the
    port's recording."""
    p = str(tmp_path / "dl.sio")
    x = _cgauss(np.random.default_rng(0), (2, 64))
    ru = RuFile(2, 61.44e6, dl_path=p)
    ru.send_dl(x, 0)
    ru.stop()
    for mod in (RuFile, j_units.RuFile):
        rr = mod(2, 61.44e6, ul_path=p)
        out, ts = rr.receive_ul(64)
        assert ts == 0
        np.testing.assert_array_equal(out, x)
        assert rr.receive_ul(1) is None
        rr.stop()


# -------------------------------------------------------------- the apps

@pytest.fixture(scope="module")
def ssb_files(tmp_path_factory):
    """The JAX app's and the port's ssb_tx files (52 RB, 1024 FFT, one
    frame, PCI 500), with the JAX app's rx_power lines on its own file."""
    d = tmp_path_factory.mktemp("ssb")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jax_file, port_file = str(d / "jax.sio"), str(d / "port.sio")
    said = subprocess.run(
        [sys.executable, str(REPO / "apps" / "ssb_tx.py"), jax_file],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
        check=True).stdout.strip().splitlines()[-1]
    line = ssb_tx.run(port_file, device="cpu")
    power = subprocess.run(
        [sys.executable, str(REPO / "apps" / "rx_power.py"), jax_file],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        check=True).stdout.strip().splitlines()
    return dict(jax=jax_file, port=port_file, jax_line=said, port_line=line,
                power=power)


def test_ssb_tx_matches_jax_app(ssb_files):
    assert ssb_files["port_line"] == ssb_files["jax_line"].replace(
        ssb_files["jax"], ssb_files["port"])
    a = t_sampio.SampleFileReader(ssb_files["jax"])
    b = t_sampio.SampleFileReader(ssb_files["port"])
    assert (a.nof_channels, a.sample_rate) == (b.nof_channels, b.sample_rate)
    x, y = a.read(1 << 20), b.read(1 << 20)
    a.close()
    b.close()
    assert x.shape == y.shape == (1, 20 * 15360)
    assert np.abs(x).max() > 0.5
    np.testing.assert_allclose(y, x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fft,block", [(1024, 1 << 16), (256, 5000)])
def test_rx_power_matches_jax_app(ssb_files, fft, block):
    """The port's lines on the JAX app's file against the JAX app's (the
    second case with a block that leaves a short last segment)."""
    lines = rx_power.analyze(ssb_files["jax"], fft, block, device="cpu")
    if (fft, block) == (1024, 1 << 16):
        assert lines == ssb_files["power"]
    else:
        ref = subprocess.run(
            [sys.executable, str(REPO / "apps" / "rx_power.py"),
             ssb_files["jax"], "--fft", str(fft), "--block", str(block)],
            cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=300,
            check=True).stdout.strip().splitlines()
        assert lines == ref


def test_apps_need_the_card_by_default(tmp_path):
    """``main`` runs on the card: without one it raises before writing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssb_tx.main([str(tmp_path / "x.sio")])
    assert not (tmp_path / "x.sio").exists()
