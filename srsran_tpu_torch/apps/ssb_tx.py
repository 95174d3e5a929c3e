"""ssb_tx -- minimal SSB transmitter example (radio_ssb.cpp analogue).

Port of apps/ssb_tx.py (the reference's apps/examples/phy/radio_ssb.cpp):
a continuous stream of slots carrying SS/PBCH blocks, through the port's
``SlotConductor.process_dl`` on the card (K27 for the SSB, K7), written
as a cf32 file through the split-8 ``ru.RuFile``.  The same command line,
MIB draws (``np.random.default_rng(0)``, 24 bits per SSB slot) and printed
line as the JAX app.

Usage: python -m srsran_tpu_torch.apps.ssb_tx out.sio [--pci 500]
           [--frames 1] [--nof-rb 52] [--dft 1024]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..device import require_cuda
from ..fapi.conductor import SlotConductor
from ..fapi.messages import DlTtiRequest, TxDataRequest
from ..phy.slot_programs import CellConfig
from ..phy.upper.ssb import SsbConfig
from ..ran.slot_point import SlotPoint
from ..ru import RuFile

SLOTS_PER_FRAME = 20          # 10 ms frames at mu = 1


def ssb_config(slot: SlotPoint, cell: CellConfig, pci: int):
    """The SSB of ``slot`` (a burst in the first two slots of each frame),
    or None."""
    if slot.slot_index not in (0, 1):
        return None
    idx = slot.slot_index
    return SsbConfig(phys_cell_id=pci, ssb_idx=idx, l_max=8, sfn=slot.sfn,
                     first_symbol=2 if idx == 0 else 8,
                     first_subcarrier=(cell.nof_sc - 240) // 2)


def run(output: str, pci: int = 500, frames: int = 1, nof_rb: int = 52,
        dft: int = 1024, device=None) -> str:
    """Write ``frames`` frames of SSB slots to ``output``; returns the line
    the app prints.  ``device``: the card unless the caller names one."""
    cell = CellConfig(nof_ports=1, nof_rb=nof_rb, dft_size=dft, numerology=1)
    fs = dft * 30_000
    cond = SlotConductor(cell, device=require_cuda() if device is None
                         else device)
    ru = RuFile(1, fs, dl_path=output)
    rng = np.random.default_rng(0)
    ts = 0
    try:
        for count in range(frames * SLOTS_PER_FRAME):
            slot = SlotPoint(1, count)
            cfg = ssb_config(slot, cell, pci)
            pdus = (cfg,) if cfg is not None else ()
            mibs = ((rng.integers(0, 2, 24).astype(np.int8),)
                    if cfg is not None else ())
            samples, _ = cond.process_dl(DlTtiRequest(slot=slot, ssb=pdus),
                                         TxDataRequest(slot=slot,
                                                       ssb_mib=mibs),
                                         return_grid=False)
            ru.send_dl(samples.cpu().numpy(), ts)
            ts += samples.shape[-1]
    finally:
        ru.stop()
    return (f"wrote {ts} samples/port at {fs / 1e6:.2f} Msps (PCI {pci}) "
            f"to {output}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("--pci", type=int, default=500)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--nof-rb", type=int, default=52)
    ap.add_argument("--dft", type=int, default=1024)
    args = ap.parse_args(argv)
    print(run(args.output, args.pci, args.frames, args.nof_rb, args.dft,
              device=require_cuda()), flush=True)


if __name__ == "__main__":
    main()
