"""Signal-chain ops on tensors: plain PyTorch, plus the hand-kernel wrappers
(UL: ``ofdm.demodulate_slot``, ``ul_demap.equalize_demap_descramble``,
``ldpc_rate_match.rate_dematch_combine``, ``ldpc_decode.decode_early_stop``;
DL: ``ldpc_encode.dlsch_encode``, ``dl_map.pdsch_map``,
``ofdm.modulate_slot``)."""
