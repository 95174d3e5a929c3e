"""rx_power -- baseband power analyzer (rx_power_analyzer.cpp analogue).

Port of apps/rx_power.py (the reference's apps/examples/radio/
rx_power_analyzer.cpp): reads a cf32 sample stream (a .sio file written by
``ru.RuFile`` or ``apps.ssb_tx``) and reports per-channel average power,
peak power, PAPR and the occupied share of a Welch power spectral density
(Hann window, 50% overlap), in dBFS -- the same command line and printed
lines as the JAX app.  The file is read on the host; each block's power
sums, peak and windowed FFTs run on the card (float64 sums, the PSD in
complex128 as numpy's is).

Usage: python -m srsran_tpu_torch.apps.rx_power capture.sio [--fft 1024]
           [--block 65536]
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from ..device import require_cuda
from ..io.sampio import SampleFileReader


def _segments(block: torch.Tensor, fft: int) -> torch.Tensor:
    """The JAX app's Welch segments of one block, [channels, segments,
    fft]: n_fit = len // (fft / 2) - 1 windows starting at s fft // 2,
    the loop stopping at the first that would run past the block
    (apps/rx_power.py:47-53)."""
    n = block.shape[-1]
    starts = []
    for s in range(max(n // (fft // 2) - 1, 0)):
        if s * fft // 2 + fft > n:
            break
        starts.append(s * fft // 2)
    idx = (torch.as_tensor(starts, dtype=torch.int64)[:, None]
           + torch.arange(fft)).to(block.device)
    return block[:, idx]


def analyze(path: str, fft: int = 1024, block: int = 1 << 16,
            device=None) -> list:
    """The app's printed lines for the capture at ``path``; ``device``: the
    card unless the caller names one.  Raises SystemExit on an empty file,
    as the JAX app does."""
    dev = require_cuda() if device is None else torch.device(device)
    rd = SampleFileReader(path)
    nch = rd.nof_channels
    total = torch.zeros(nch, dtype=torch.float64, device=dev)
    peak = torch.zeros(nch, dtype=torch.float64, device=dev)
    psd = torch.zeros((nch, fft), dtype=torch.float64, device=dev)
    win = torch.from_numpy(np.hanning(fft)).to(dev)
    count = nseg = 0
    try:
        while True:
            host = rd.read(block)
            if host.shape[-1] == 0:
                break
            x = torch.from_numpy(host).to(dev)
            p = x.abs() ** 2
            total += p.sum(dim=-1, dtype=torch.float64)
            peak = torch.maximum(peak, p.max(dim=-1).values.to(torch.float64))
            count += x.shape[-1]
            seg = _segments(x, fft)
            if seg.shape[1]:
                spec = torch.fft.fftshift(torch.fft.fft(
                    seg.to(torch.complex128) * win, dim=-1), dim=-1)
                psd += (spec.abs() ** 2).sum(dim=1)
                nseg += seg.shape[1]
    finally:
        rd.close()
    if count == 0:
        sys.exit("no samples")
    total, peak = total.cpu().numpy(), peak.cpu().numpy()
    lines = [f"{path}: {nch} channel(s), {count} samples @ "
             f"{rd.sample_rate:.0f} Sps"]
    for ch in range(nch):
        avg = total[ch] / count
        avg_db = 10 * math.log10(max(avg, 1e-30))
        peak_db = 10 * math.log10(max(peak[ch], 1e-30))
        lines.append(f"  ch{ch}: avg {avg_db:6.2f} dBFS   peak {peak_db:6.2f} "
                     f"dBFS   PAPR {peak_db - avg_db:5.2f} dB")
    if nseg:
        p = psd.cpu().numpy() / nseg
        occ = (p > p.max(axis=-1, keepdims=True) * 1e-3).mean(axis=-1)
        for ch in range(nch):
            lines.append(f"  ch{ch}: occupied bandwidth ~{occ[ch] * 100:.0f}% "
                         f"of fs")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("--fft", type=int, default=1024,
                    help="PSD FFT size (Welch, 50% overlap)")
    ap.add_argument("--block", type=int, default=1 << 16)
    args = ap.parse_args(argv)
    for line in analyze(args.input, args.fft, args.block,
                        device=require_cuda()):
        print(line, flush=True)


if __name__ == "__main__":
    main()
