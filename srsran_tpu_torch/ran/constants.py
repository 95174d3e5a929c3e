"""NR numerology constants (TS38.211).

Mirrors the capability envelope of the reference's include/srsran/ran/
(resource_block.h, frame_types.h): 12 subcarriers per RB, up to 275 RBs,
14 symbols per slot with normal CP.

The port's own copy of srsran_tpu/ran/constants.py:
the port imports nothing of the JAX package.  tests/test_torch_host_plans.py
pins the copy to its original.
"""

# Subcarriers per resource block (TS38.211 §4.4.4.1).
NRE = 12

# Maximum number of resource blocks in a carrier (TS38.101, 275 for FR1/FR2).
MAX_RB = 275

# OFDM symbols per slot, normal / extended cyclic prefix (TS38.211 §4.3.2).
NSYMB_PER_SLOT_NORMAL = 14
NSYMB_PER_SLOT_EXTENDED = 12

# Subframes per frame; slots per subframe = 2**numerology.
NOF_SUBFRAMES_PER_FRAME = 10
NOF_SFNS = 1024

# Maximum number of transmission layers (DL) supported, matching the
# reference capability envelope (CHANGELOG: "downlink MIMO up to 4 layers").
MAX_DL_LAYERS = 4
MAX_PORTS = 4

# LLR quantization range, matching the reference's log_likelihood_ratio
# (include/srsran/phy/upper/log_likelihood_ratio.h): int8 saturating at +-127
# with demodulator range limit +-20 before noise scaling.
LLR_MAX = 127
LLR_DEMOD_RANGE = 20.0


def sample_rate_for_dft(dft_size: int, scs_hz: int) -> float:
    """Sampling rate implied by a DFT size at a subcarrier spacing."""
    return float(dft_size * scs_hz)
