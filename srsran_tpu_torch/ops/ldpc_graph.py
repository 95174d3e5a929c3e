"""LDPC Tanner-graph structures built from the TS38.212 base-graph tables.

Analogue of the reference's ldpc_graph_impl / ldpc_luts_impl
(lib/phy/upper/channel_coding/ldpc/ldpc_graph_impl.h), re-shaped for TPU: a
graph is a static Python object holding per-row (column, shift) edge lists —
compile-time constants baked into the unrolled encoder / layered-decoder
programs, so no device-side table lookups are needed.

The port's own copy of srsran_tpu/ops/ldpc_graph.py:
the port imports nothing of the JAX package.  tests/test_torch_host_plans.py
pins the copy to its original.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np

from ..ran.ldpc_params import lifting_set_index, BG1_KB, BG2_KB

_DATA = Path(__file__).resolve().parent.parent / "data" / "ldpc_bg_tables.npz"


@functools.lru_cache(maxsize=None)
def _tables():
    z = np.load(_DATA)
    return z["bg1"], z["bg2"]


@dataclasses.dataclass(frozen=True)
class LdpcGraph:
    """Lifted Tanner graph for one (base_graph, lifting_size)."""

    base_graph: int
    z: int
    nof_rows: int          # base check nodes (46 / 42)
    nof_cols: int          # base variable nodes (68 / 52)
    nof_info_cols: int     # Kb (22 / 10)
    # rows[r] = tuple of (col, shift) with shift already reduced mod Z.
    rows: tuple

    @property
    def nof_parity_cols(self) -> int:
        return self.nof_cols - self.nof_info_cols

    def row_cols(self, r: int):
        return [c for c, _ in self.rows[r]]

    def row_shift(self, r: int, col: int) -> int:
        for c, s in self.rows[r]:
            if c == col:
                return s
        raise KeyError((r, col))


@functools.lru_cache(maxsize=None)
def get_graph(base_graph: int, z: int) -> LdpcGraph:
    bg1, bg2 = _tables()
    tab = bg1 if base_graph == 1 else bg2
    mat = tab[lifting_set_index(z)]
    nof_rows, nof_cols = mat.shape
    rows = tuple(
        tuple((int(c), int(mat[r, c]) % z) for c in range(nof_cols) if mat[r, c] >= 0)
        for r in range(nof_rows)
    )
    return LdpcGraph(
        base_graph=base_graph,
        z=z,
        nof_rows=nof_rows,
        nof_cols=nof_cols,
        nof_info_cols=BG1_KB if base_graph == 1 else BG2_KB,
        rows=rows,
    )


def parity_check_np(graph: LdpcGraph, codeword: np.ndarray) -> np.ndarray:
    """Evaluate H @ c over GF(2) (host, for tests).

    codeword: [nof_cols * z] bits (full untransmitted codeword incl. the
    2Z punctured systematic bits).  Returns [nof_rows * z] syndrome bits.
    """
    z = graph.z
    c = codeword.reshape(graph.nof_cols, z)
    syn = np.zeros((graph.nof_rows, z), dtype=np.uint8)
    for r, row in enumerate(graph.rows):
        acc = np.zeros(z, dtype=np.uint8)
        for col, shift in row:
            acc ^= np.roll(c[col], -shift)
        syn[r] = acc
    return syn.reshape(-1)
