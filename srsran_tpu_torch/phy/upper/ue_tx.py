"""UE-side PUSCH transmit with UCI multiplexing (TS38.212 §6.2.7).

Port of srsran_tpu/phy/upper/ue_tx.py::pusch_transmit, the UE emulation
that closes the loop with the receive chain (phy/upper/pusch.py): the data
LDPC-coded and rate-matched around the UCI fields, HARQ-ACK and CSI encoded
into their §6.2.7 positions (the ops/ulsch_demux.py plan), scrambling that
honours the UCI placeholders, and type-1 DM-RS on port 0.  Single layer,
as in the JAX package.  Plain PyTorch and numpy on the caller's device;
on a CUDA device the encoder runs K5, as the DL chain does, and the rate
match of every codeblock K32 (``ldpc_rate_match.rate_match_batch``, one
launch for the TB where JAX rate-matches codeblock by codeblock,
ue_tx.py:76-78; the same bits).

Beyond the JAX function (whose package has no UE transmitter for them, its
tests build such grids by hand), the same codeword goes out with intra-slot
frequency hopping (each hop's data and DM-RS on its own PRBs, the DM-RS
Gold sequence of each hop advanced to its first PRB) and with transform
precoding (the unitary DFT of each data symbol's block, and the low-PAPR
DM-RS on comb 0), as tests/test_freq_hopping.py and
tests/test_ptrs_evm_tp.py build them.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import ldpc_encode, ldpc_rate_match, ulsch_demux
from ...ops.gold import gold_sequence_np
from ...ops.low_papr import base_sequence
from ...ops.modulation import BITS_PER_SYMBOL, modulate
from ...ops.transform_precode import precode
from . import pusch as pusch_mod
from . import uci as uci_codec
from .dmrs import DmrsConfig, _type1_sc_indices, map_to_grid
from .pdsch import (PdschConfig, _cb_rate_match_sizes, _data_re_plan,
                    encode_transport_block)


def _np(bits: torch.Tensor) -> np.ndarray:
    return bits.cpu().numpy().astype(np.int8)


def pusch_transmit(cfg: "pusch_mod.PuschConfig", payload, ack=None,
                   csi1=None, csi2=None, nof_sc: int | None = None, *,
                   device) -> torch.Tensor:
    """The UE's transmitted grid complex64 [1, 14, nof_sc] on ``device`` for
    one PUSCH PDU.

    payload: the TB bits; ack / csi1 / csi2: raw UCI bit arrays matching
    cfg.uci's o_* sizes (None when the PDU carries none).  The data codeword
    is rate-matched to the data field only, exactly inverse to the gNB
    demultiplexer.
    """
    qm = BITS_PER_SYMBOL[cfg.modulation]
    hops = pusch_mod.hop_configs(cfg)
    nof_sc = nof_sc or (max(h.rb_start for h in hops) + cfg.rb_count) * 12
    dcfg = pusch_mod.demux_plan(cfg)
    tb = torch.as_tensor(np.asarray(payload).astype(np.int8)).to(device)

    if dcfg is None:
        tx_cfg = PdschConfig(
            rnti=cfg.rnti, rb_start=cfg.rb_start, rb_count=cfg.rb_count,
            first_symbol=cfg.first_symbol, nof_symbols=cfg.nof_symbols,
            modulation=cfg.modulation,
            target_code_rate=cfg.target_code_rate, tbs=cfg.tbs,
            nof_layers=cfg.nof_layers, rv=cfg.rv, n_id=cfg.n_id,
            dmrs_symbols=cfg.dmrs_symbols, slot_in_frame=cfg.slot_in_frame)
        cw = _np(encode_transport_block(tb, tx_cfg)[0])
    else:
        f = ulsch_demux.field_positions(dcfg)
        bpre = qm * cfg.nof_layers
        seg = pusch_mod.segmentation(cfg)
        cbs = ldpc_encode.dlsch_encode(tb, seg.base_graph)
        e_sizes = _cb_rate_match_sizes(len(f["data"]) * bpre,
                                       seg.nof_codeblocks, qm, cfg.nof_layers)
        data_coded = _np(ldpc_rate_match.rate_match_batch(
            cbs, e_sizes, cfg.rv, qm, seg.base_graph, seg.lifting_size,
            seg.cb_info_bits, seg.full_block_bits))

        def coded(bits, n_re):
            if bits is None:
                return None
            t = torch.as_tensor(np.asarray(bits).astype(np.int8)).to(device)
            return _np(uci_codec.encode_uci(t, n_re * bpre, qm))

        ack_pos = f["ack_punct"] if len(f["ack_punct"]) else f["ack"]
        cw = ulsch_demux.mux_codeword(
            dcfg, data_coded, coded(ack, len(ack_pos)),
            coded(csi1, len(f["csi1"])), coded(csi2, len(f["csi2"])))

    seq = gold_sequence_np((cfg.rnti << 15) + cfg.n_id, len(cw))
    if dcfg is not None:
        cls = ulsch_demux.placeholder_bit_classes(
            dcfg, cfg.uci.o_ack, cfg.uci.o_csi1)
        scr = ulsch_demux.scramble_with_placeholders(cw, seq, cls)
    else:
        scr = (cw.astype(np.int8) ^ seq).astype(np.int8)
    syms = modulate(torch.as_tensor(scr[None]).to(device), cfg.modulation)[0]
    m = 12 * cfg.rb_count
    if cfg.transform_precoding:
        syms = precode(syms.reshape(-1, m)).reshape(-1)
    grid = torch.zeros((1, 14, nof_sc), dtype=torch.complex64, device=device)
    first = 0
    for h in hops:
        plan = _data_re_plan(h.rb_start, h.rb_count, h.first_symbol,
                             h.nof_symbols, h.dmrs_symbols, 2)
        grid[0, torch.as_tensor(plan[:, 0].astype(np.int64)).to(device),
             torch.as_tensor(plan[:, 1].astype(np.int64)).to(device)] = \
            syms[first:first + len(plan)]
        first += len(plan)
        if cfg.transform_precoding:
            seq = torch.as_tensor(base_sequence(cfg.dmrs_scrambling_id % 30,
                                                0, m // 2), device=device)
            sc = torch.as_tensor(_type1_sc_indices(h.rb_start, h.rb_count, 0)
                                 .astype(np.int64), device=device)
            for l in h.dmrs_symbols:
                grid[0, l, sc] = seq
            continue
        dmrs_cfg = DmrsConfig(rb_start=h.rb_start, rb_count=h.rb_count,
                              symbols=h.dmrs_symbols, ports=(0,),
                              scrambling_id=cfg.dmrs_scrambling_id,
                              n_scid=cfg.n_scid,
                              slot_in_frame=cfg.slot_in_frame)
        map_to_grid(grid, dmrs_cfg, np.eye(1, dtype=np.complex64))
    return grid
