"""UL-SCH multiplex/demultiplex index plans (TS38.212 §6.2.7).

TPU-native replacement for ulsch_demultiplex_impl
(lib/phy/upper/channel_processors/pusch/ulsch_demultiplex_impl.cpp): the
reference streams codeword LLRs symbol-by-symbol into per-field decoder
buffers; here the placement walk runs ONCE on the host per static config,
yielding an int8 class map over codeword symbol positions (data / HARQ-ACK /
CSI1 / CSI2) — the device side is pure gathers.

Placement rules implemented:
- HARQ-ACK anchors at l1 = first symbol after the first DM-RS symbol
  (ulsch_demultiplex_impl.cpp:33-45); CSI anchors at l1_csi = first
  non-DM-RS symbol (:47-55);
- per symbol, UCI REs are spread with stride d = floor(M_data(l) / n_uci(l));
- O_ack <= 2 reserves REs (data is written there and punctured by ACK);
  O_ack > 2 rate-matches (data skips ACK REs);
- CSI1 never sits on reserved-ACK REs; CSI2/data fill around.

The port's own copy of srsran_tpu/ops/ulsch_demux.py (numpy only): the
port imports nothing of the JAX package.  tests/test_torch_host_plans.py
pins the copy to its original.  The device side is the K17 gather,
ops/uci_demux.py.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

DATA, ACK, CSI1, CSI2, RSVD = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class DemuxConfig:
    """Static geometry for the placement walk (per-layer RE counts)."""

    nof_symbols: int            # slot symbols in the allocation
    first_symbol: int
    re_per_symbol: tuple        # data-capable REs per allocation symbol
    dmrs_symbols: tuple         # absolute symbol indices carrying DM-RS
    qm: int
    nof_layers: int
    q_ack: int                  # ACK symbol budget (Q'_ack)
    q_csi1: int = 0
    q_csi2: int = 0
    ack_reserved: bool = False  # O_ack <= 2: puncture instead of rate-match


@functools.lru_cache(maxsize=None)
def build_class_map(cfg: DemuxConfig) -> np.ndarray:
    """int8 [total_symbols] per-modulation-symbol class (RE-granular plan).

    Position order matches the PUSCH mapping order: frequency-first within
    symbol, symbols ascending; one entry covers all layers x Qm bits of the
    RE (UCI always occupies whole REs across layers).
    """
    syms = list(range(cfg.first_symbol, cfg.first_symbol + cfg.nof_symbols))
    re_counts = {l: cfg.re_per_symbol[i] for i, l in enumerate(syms)}
    # anchors
    l1 = None
    for l in syms:
        if l in cfg.dmrs_symbols:
            l1 = next((x for x in syms if x > l and x not in cfg.dmrs_symbols),
                      None)
            break
    if l1 is None:
        l1 = syms[0]
    l1_csi = next((l for l in syms if l not in cfg.dmrs_symbols), syms[0])

    cls = {l: np.full(re_counts[l], DATA, dtype=np.int8) for l in syms}

    def place(budget: int, marker: int, anchor: int, avoid: tuple):
        remaining = budget
        for l in syms:
            if l < anchor or l in cfg.dmrs_symbols or remaining <= 0:
                continue
            free_idx = np.nonzero(np.isin(cls[l], [DATA]))[0]
            if marker == CSI1:
                free_idx = np.nonzero(~np.isin(cls[l], list(avoid) + [CSI1]))[0]
                free_idx = free_idx[cls[l][free_idx] == DATA]
            if len(free_idx) == 0:
                continue
            take = min(remaining, len(free_idx))
            d = max(1, len(free_idx) // take)
            chosen = free_idx[::d][:take]
            cls[l][chosen] = marker
            remaining -= len(chosen)
        return budget - remaining

    if cfg.ack_reserved:
        place(cfg.q_ack, RSVD, l1, ())
    else:
        place(cfg.q_ack, ACK, l1, ())
    place(cfg.q_csi1, CSI1, l1_csi, (RSVD, ACK))
    place(cfg.q_csi2, CSI2, l1_csi, ())
    return np.concatenate([cls[l] for l in syms])


def mux_codeword(cfg: DemuxConfig, data_bits: np.ndarray,
                 ack_bits: np.ndarray = None, csi1_bits: np.ndarray = None,
                 csi2_bits: np.ndarray = None) -> np.ndarray:
    """UE-side §6.2.7 multiplexing (for tests / UE emulation).

    All inputs are coded bit arrays; data fills DATA+RSVD positions, the
    punctured ACK then overwrites the RSVD REs.
    """
    f = field_positions(cfg)
    bpre = cfg.qm * cfg.nof_layers
    total = len(build_class_map(cfg))
    out = np.zeros((total, bpre), dtype=np.int8)
    out[f["data"]] = np.asarray(data_bits).reshape(-1, bpre)
    if csi1_bits is not None and len(f["csi1"]):
        out[f["csi1"]] = np.asarray(csi1_bits).reshape(-1, bpre)
    if csi2_bits is not None and len(f["csi2"]):
        out[f["csi2"]] = np.asarray(csi2_bits).reshape(-1, bpre)
    if ack_bits is not None:
        pos = f["ack_punct"] if len(f["ack_punct"]) else f["ack"]
        if len(pos):
            out[pos] = np.asarray(ack_bits).reshape(-1, bpre)
    return out.reshape(-1)


def placeholder_bit_classes(cfg: DemuxConfig, o_ack: int = 0,
                            o_csi1: int = 0) -> np.ndarray:
    """int8 [total_codeword_bits] class map: 0 normal, 1 'x', 2 'y'.

    TS38.212 §5.3.3.1/.2: 1- and 2-bit UCI encodings carry placeholder bits
    within each modulation symbol — bit 1 is 'y' (repeats the scrambling of
    bit 0) for 1-bit payloads, bits 2..Qm-1 are 'x' (not scrambled) for
    both.  Applies to HARQ-ACK and CSI part 1 like the reference
    (ulsch_demultiplex_impl.cpp:490-532).
    """
    f = field_positions(cfg)
    bpre = cfg.qm * cfg.nof_layers
    total = len(build_class_map(cfg)) * bpre
    cls = np.zeros(total, np.int8)
    if cfg.qm == 1:
        return cls

    def mark(pos_re: np.ndarray, o: int):
        if o == 0 or o > 2 or len(pos_re) == 0:
            return
        bit_idx = (pos_re[:, None].astype(np.int64) * bpre
                   + np.arange(bpre)).reshape(-1)
        per_sym = bit_idx.reshape(-1, cfg.qm)
        if o == 1:
            cls[per_sym[:, 1]] = 2          # y
        if cfg.qm > 2:
            cls[per_sym[:, 2:]] = 1         # x

    ack_pos = f["ack_punct"] if len(f["ack_punct"]) else f["ack"]
    mark(ack_pos, o_ack)
    mark(f["csi1"], o_csi1)
    return cls


def scramble_with_placeholders(bits: np.ndarray, seq: np.ndarray,
                               cls: np.ndarray) -> np.ndarray:
    """UE-side PUSCH scrambling honouring placeholders (TS38.211 §6.3.1.1):
    'x' bits keep c=0, 'y' bits reuse the previous bit's scrambling bit."""
    seq_mod = seq.astype(np.int8).copy()
    seq_mod[cls == 1] = 0
    y_idx = np.nonzero(cls == 2)[0]
    seq_mod[y_idx] = seq[y_idx - 1]
    return (bits.astype(np.int8) ^ seq_mod).astype(np.int8)


def field_positions(cfg: DemuxConfig):
    """dict field -> int32 array of RE positions in mapping order.

    'data' includes RSVD positions (punctured ACK rides on top of data);
    'ack_punct' gives the reserved positions for O_ack <= 2.
    """
    cmap = build_class_map(cfg)
    out = {
        "data": np.nonzero((cmap == DATA) | (cmap == RSVD))[0].astype(np.int32),
        "ack": np.nonzero(cmap == ACK)[0].astype(np.int32),
        "ack_punct": np.nonzero(cmap == RSVD)[0].astype(np.int32),
        "csi1": np.nonzero(cmap == CSI1)[0].astype(np.int32),
        "csi2": np.nonzero(cmap == CSI2)[0].astype(np.int32),
    }
    return out
