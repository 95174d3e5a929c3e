"""3GPP-derived parameter math (host-side, pure Python/numpy).

The port's own copies of the ``srsran_tpu.ran`` modules it uses: cyclic
prefix lengths, LDPC segmentation, polar code construction, UCI-on-PUSCH
sizes, PRACH preamble parameters and the precoding configuration type.
"""
