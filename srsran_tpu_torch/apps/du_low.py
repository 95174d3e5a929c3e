"""du_low -- standalone split-6 DU-low: upper PHY + FAPI over a socket.

Port of apps/du_low.py (the reference's apps/du_low, du_low.cpp): no MAC in
this process -- a remote MAC (any FapiClient, this package's or the JAX
package's: the wire is the same) drives the PHY with FAPI slot messages
over TCP.  UL antenna samples enter through rx_samples messages (the
RU-emulator path) in lieu of a radio.  The PHY runs on the card.

Usage:
  python -m srsran_tpu_torch.apps.du_low [-c config.yaml]
      [--set cell.nof_rb=52] [--port 9000]
"""

from __future__ import annotations

import argparse

from ..device import card_line, require_cuda
from ..fapi.transport import serve_phy
from ..utils import config as config_mod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--port", type=int, default=0,
                    help="FAPI TCP port (0 = ephemeral, printed on stdout)")
    args = ap.parse_args(argv)
    cfg = config_mod.load(args.config, args.set)
    device = require_cuda()
    print(f"du_low: cell {cfg.cell.nof_rb} RB mu={cfg.cell.numerology} "
          f"{cfg.cell.nof_ports} ports on {card_line()}", flush=True)

    def ready(port):
        print(f"du_low: FAPI listening on 127.0.0.1:{port}", flush=True)

    serve_phy(port=args.port, ready_cb=ready, device=device)
    print("du_low: client disconnected, exiting", flush=True)


if __name__ == "__main__":
    main()
