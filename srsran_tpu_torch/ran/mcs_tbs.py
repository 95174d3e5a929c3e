"""MCS tables and TBS determination (TS38.214 §5.1.3).

Analogue of the reference's lib/ran/pdsch/pdsch_mcs.cpp, lib/ran/pusch/ and
lib/ran/sch/ (sch_mcs, tbs_calculator): the three MCS index tables and the
full TS38.214 §5.1.3.2 transport-block-size algorithm, used by the host-side
scheduler / test-mode MAC to drive the PHY with spec-consistent PDUs.

The port's own copy of srsran_tpu/ran/mcs_tbs.py: the port imports nothing
of the JAX package.  tests/test_torch_host_plans.py pins the copy to its
original.
"""

from __future__ import annotations

import math

# TS38.214 Tables 5.1.3.1-1 (qam64), -2 (qam256), -3 (qam64LowSe):
# (modulation, target code rate x 1024).  Reserved entries (R=0) excluded.
MCS_TABLE_QAM64 = (
    ("qpsk", 120), ("qpsk", 157), ("qpsk", 193), ("qpsk", 251), ("qpsk", 308),
    ("qpsk", 379), ("qpsk", 449), ("qpsk", 526), ("qpsk", 602), ("qpsk", 679),
    ("qam16", 340), ("qam16", 378), ("qam16", 434), ("qam16", 490),
    ("qam16", 553), ("qam16", 616), ("qam16", 658),
    ("qam64", 438), ("qam64", 466), ("qam64", 517), ("qam64", 567),
    ("qam64", 616), ("qam64", 666), ("qam64", 719), ("qam64", 772),
    ("qam64", 822), ("qam64", 873), ("qam64", 910), ("qam64", 948),
)
MCS_TABLE_QAM256 = (
    ("qpsk", 120), ("qpsk", 193), ("qpsk", 308), ("qpsk", 449), ("qpsk", 602),
    ("qam16", 378), ("qam16", 434), ("qam16", 490), ("qam16", 553),
    ("qam16", 616), ("qam16", 658),
    ("qam64", 466), ("qam64", 517), ("qam64", 567), ("qam64", 616),
    ("qam64", 666), ("qam64", 719), ("qam64", 772), ("qam64", 822),
    ("qam64", 873),
    ("qam256", 682.5), ("qam256", 711), ("qam256", 754), ("qam256", 797),
    ("qam256", 841), ("qam256", 885), ("qam256", 916.5), ("qam256", 948),
)
MCS_TABLE_QAM64_LOW_SE = (
    ("qpsk", 30), ("qpsk", 40), ("qpsk", 50), ("qpsk", 64), ("qpsk", 78),
    ("qpsk", 99), ("qpsk", 120), ("qpsk", 157), ("qpsk", 193), ("qpsk", 251),
    ("qpsk", 308), ("qpsk", 379), ("qpsk", 449), ("qpsk", 526), ("qpsk", 602),
    ("qam16", 340), ("qam16", 378), ("qam16", 434), ("qam16", 490),
    ("qam16", 553), ("qam16", 616),
    ("qam64", 438), ("qam64", 466), ("qam64", 517), ("qam64", 567),
    ("qam64", 616), ("qam64", 666), ("qam64", 719), ("qam64", 772),
)

TABLES = {"qam64": MCS_TABLE_QAM64, "qam256": MCS_TABLE_QAM256,
          "qam64LowSe": MCS_TABLE_QAM64_LOW_SE}

QM = {"qpsk": 2, "qam16": 4, "qam64": 6, "qam256": 8}

# TS38.214 Table 5.1.3.2-1: TBS for N_info <= 3824.
TBS_TABLE_38214 = (
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144,
    152, 160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320,
    336, 352, 368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640,
    672, 704, 736, 768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160,
    1192, 1224, 1256, 1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736,
    1800, 1864, 1928, 2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536, 2600,
    2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496, 3624, 3752, 3824,
)


def mcs_config(table: str, index: int):
    """(modulation_name, target_code_rate float in [0,1])."""
    mod, r1024 = TABLES[table][index]
    return mod, r1024 / 1024.0


def nof_re_per_prb(nof_symbols: int, nof_dmrs_re_per_prb: int,
                   nof_oh_re: int = 0) -> int:
    """N'_RE per TS38.214 §5.1.3.2 step 1 (capped at 156 by the caller)."""
    return 12 * nof_symbols - nof_dmrs_re_per_prb - nof_oh_re


def tbs(nof_prb: int, nof_symbols: int, nof_dmrs_re_per_prb: int,
        modulation: str, code_rate: float, nof_layers: int,
        nof_oh_re: int = 0, tb_scaling: float = 1.0) -> int:
    """TS38.214 §5.1.3.2 TBS determination."""
    n_re_prime = nof_re_per_prb(nof_symbols, nof_dmrs_re_per_prb, nof_oh_re)
    n_re = min(156, n_re_prime) * nof_prb
    qm = QM[modulation]
    n_info = n_re * code_rate * qm * nof_layers * tb_scaling
    if n_info <= 3824:
        n = max(3, int(math.floor(math.log2(n_info))) - 6)
        n_info_prime = max(24, (1 << n) * (int(n_info) >> n))
        for t in TBS_TABLE_38214:
            if t >= n_info_prime:
                return t
        return TBS_TABLE_38214[-1]
    n = int(math.floor(math.log2(n_info - 24))) - 5
    n_info_prime = max(3840, (1 << n) * round((n_info - 24) / (1 << n)))
    if code_rate <= 0.25:
        c = math.ceil((n_info_prime + 24) / 3816)
        return 8 * c * math.ceil((n_info_prime + 24) / (8 * c)) - 24
    if n_info_prime > 8424:
        c = math.ceil((n_info_prime + 24) / 8424)
        return 8 * c * math.ceil((n_info_prime + 24) / (8 * c)) - 24
    return 8 * math.ceil((n_info_prime + 24) / 8) - 24
