"""NR precoding codebooks + the FAPI precoding-matrix repository.

Host-side analogue of lib/ran/precoding/precoding_codebooks.cpp (matrix
construction per TS38.214 §5.2.2.2.1 Type-I single-panel, mode 1) and the
fapi_adaptor's precoding-matrix plumbing
(lib/fapi_adaptor/precoding_matrix_table_generator.cpp,
precoding_matrix_repository.cpp): FAPI PDUs carry small integer PM indices;
a per-port-count repository resolves them to [P, L] complex weight
matrices, which the DL chain applies per PRG (K22, ops/dl_map.pdsch_map).

The port's own copy of srsran_tpu/ran/precoding_codebooks.py: the port
imports nothing of the JAX package.  tests/test_torch_host_plans.py pins
the copy to its original.

Orientation: matrices are stored [nof_ports, nof_layers] so
``ports = W @ layers`` (the reference's precoding_weight_matrix is the
transpose, indexed (layer, port)).

Repository index layout (per nof_ports; documented contract, the analogue
of precoding_matrix_mapper_functions.h's offset scheme):
  1 port : 0 identity/single-port
  2 ports: 0 identity(2L)          1 omni one-layer
           2..5   1-layer codebooks 0..3 (TS38.214 Table 5.2.2.2.1-1)
           6..7   2-layer codebooks 0..1
  4 ports: 0 identity(4L)          1 omni one-layer
           2..33  1L type1 SP mode1: 2 + 4*i_1_1 + i_2   (i_1_1<8, i_2<4)
           34..65 2L: 34 + 4*i_1_1 + 2*i_1_3 + i_2       (i_1_3<2, i_2<2)
           66..81 3L: 66 + 2*i_1_1 + i_2                 (i_2<2)
           82..97 4L: 82 + 2*i_1_1 + i_2                 (i_2<2)
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# TS38.214 Table 5.2.2.2.1-2 for 4 ports: N1=2, N2=1, O1=4, O2=1.
_N1, _O1 = 2, 4
_NOF_BEAMS = _N1 * _O1          # 8 horizontal beams


# ------------------------------------------------------ matrix constructors

def make_single_port() -> np.ndarray:
    return np.ones((1, 1), dtype=np.complex64)


def make_one_layer_one_port(nof_ports: int, port: int) -> np.ndarray:
    """One layer on one selected port (SSB/PDCCH beams in the reference)."""
    m = np.zeros((nof_ports, 1), dtype=np.complex64)
    m[port, 0] = 1.0
    return m


def make_wideband_one_layer(nof_ports: int) -> np.ndarray:
    """Omnidirectional: one layer on all ports at 1/sqrt(P)."""
    return np.full((nof_ports, 1), 1.0 / np.sqrt(nof_ports),
                   dtype=np.complex64)


def make_identity(nof_streams: int) -> np.ndarray:
    """Identity mapping, power-normalized over layers."""
    return (np.eye(nof_streams, dtype=np.complex64)
            / np.float32(np.sqrt(nof_streams)))


def make_one_layer_two_ports(i_codebook: int) -> np.ndarray:
    """TS38.214 Table 5.2.2.2.1-1 W for 1 layer, 2 ports (4 entries)."""
    second = [1.0, 1.0j, -1.0, -1.0j][i_codebook]
    return (np.array([[1.0], [second]], dtype=np.complex64)
            / np.float32(np.sqrt(2.0)))


def make_two_layer_two_ports(i_codebook: int) -> np.ndarray:
    """2-layer 2-port codebooks (2 entries): columns are the layers."""
    if i_codebook == 0:
        m = np.array([[1.0, 1.0], [1.0, -1.0]])
    else:
        m = np.array([[1.0, 1.0], [1.0j, -1.0j]])
    return (m / 2.0).astype(np.complex64)


def _beam(phase_increment_rad: float, initial_phase_rad: float,
          scaling: float) -> np.ndarray:
    """N1=2 horizontal DFT beam coefficients."""
    return (scaling * np.exp(1j * (initial_phase_rad
                                   + phase_increment_rad
                                   * np.arange(_N1)))).astype(np.complex64)


def _layer_column(beam_az: int, pol_phase_rad: float,
                  scaling: float) -> np.ndarray:
    """One layer's 4-port column: the same horizontal beam on both
    polarizations, the second shifted by pol_phase_rad."""
    inc = 2.0 * np.pi * beam_az / _NOF_BEAMS
    return np.concatenate([_beam(inc, 0.0, scaling),
                           _beam(inc, pol_phase_rad, scaling)])


def make_one_layer_four_ports_type1_sp_mode1(i_1_1: int,
                                             i_2: int) -> np.ndarray:
    """1 layer, 4 ports, Type-I SP mode 1 (i_1_1 < 8 beams, i_2 < 4)."""
    assert 0 <= i_1_1 < _NOF_BEAMS and 0 <= i_2 < 4
    col = _layer_column(i_1_1, np.pi / 2 * i_2, 0.5)
    return col[:, None].astype(np.complex64)


def make_two_layer_four_ports_type1_sp_mode1(i_1_1: int, i_1_3: int,
                                             i_2: int) -> np.ndarray:
    """2 layers, 4 ports (i_1_3 selects the second beam offset k1)."""
    assert 0 <= i_1_1 < _NOF_BEAMS and 0 <= i_1_3 < 2 and 0 <= i_2 < 2
    scaling = 0.5 / np.sqrt(2.0)
    pol = np.pi / 2 * i_2
    k1 = 0 if i_1_3 == 0 else _O1          # TS38.214 Table 5.2.2.2.1-3
    l0 = _layer_column(i_1_1, pol, scaling)
    # layer 1: beam offset k1, second polarization shifted by an extra pi
    l1 = _layer_column(i_1_1 + k1, pol + np.pi, scaling)
    return np.stack([l0, l1], axis=1).astype(np.complex64)


def make_three_layer_four_ports_type1_sp(i_1_1: int, i_2: int) -> np.ndarray:
    """3 layers, 4 ports (k1 = O1 fixed, TS38.214 Table 5.2.2.2.1-4)."""
    assert 0 <= i_1_1 < _NOF_BEAMS and 0 <= i_2 < 2
    scaling = 1.0 / np.sqrt(12.0)
    pol = np.pi / 2 * i_2
    l0 = _layer_column(i_1_1, pol, scaling)
    l2 = _layer_column(i_1_1, pol + np.pi, scaling)
    l1 = _layer_column(i_1_1 + _O1, pol, scaling)
    return np.stack([l0, l1, l2], axis=1).astype(np.complex64)


def make_four_layer_four_ports_type1_sp(i_1_1: int, i_2: int) -> np.ndarray:
    """4 layers, 4 ports (k1 = O1 fixed)."""
    assert 0 <= i_1_1 < _NOF_BEAMS and 0 <= i_2 < 2
    scaling = 0.25
    pol = np.pi / 2 * i_2
    l0 = _layer_column(i_1_1, pol, scaling)
    l2 = _layer_column(i_1_1, pol + np.pi, scaling)
    l1 = _layer_column(i_1_1 + _O1, pol, scaling)
    l3 = _layer_column(i_1_1 + _O1, pol + np.pi, scaling)
    return np.stack([l0, l1, l2, l3], axis=1).astype(np.complex64)


# ------------------------------------------------------------- repository

@dataclasses.dataclass(frozen=True)
class PrecodingConfig:
    """FAPI Tx precoding PDU essentials (SCF-222 txPrecodingAndBeamforming:
    numPRGs, prgSize, PMidx per PRG).  Hashable; the conductor clears
    ``pm_indices`` from the jit key so one compiled slot program serves
    every PMI pattern with the same PRG structure.

    PRGs partition the carrier aligned to CRB 0 (TS38.214 §5.1.2.3):
    PRB p belongs to entry ``p // prg_size - rb_start // prg_size``.
    """

    prg_size: int                 # PRBs per precoding resource block group
    pm_indices: tuple             # per-PRG repository index (len = nof PRGs)


def nof_prgs(rb_start: int, rb_count: int, prg_size: int) -> int:
    """PRG count covering [rb_start, rb_start+rb_count) with CRB0-aligned
    PRG boundaries."""
    first = rb_start // prg_size
    last = (rb_start + rb_count - 1) // prg_size
    return last - first + 1


@functools.lru_cache(maxsize=8)
def repository(nof_ports: int) -> tuple:
    """All matrices for one port count, indexed per the module contract.

    Returns a tuple of np [P, L] arrays (index -> matrix); built once per
    port count like the reference's precoding_matrix_repository.
    """
    if nof_ports == 1:
        return (make_single_port(), make_one_layer_one_port(1, 0))
    if nof_ports == 2:
        return ((make_identity(2), make_wideband_one_layer(2))
                + tuple(make_one_layer_two_ports(i) for i in range(4))
                + tuple(make_two_layer_two_ports(i) for i in range(2)))
    if nof_ports == 4:
        out = [make_identity(4), make_wideband_one_layer(4)]
        for i11 in range(_NOF_BEAMS):
            for i2 in range(4):
                out.append(make_one_layer_four_ports_type1_sp_mode1(i11, i2))
        for i11 in range(_NOF_BEAMS):
            for i13 in range(2):
                for i2 in range(2):
                    out.append(
                        make_two_layer_four_ports_type1_sp_mode1(i11, i13, i2))
        for i11 in range(_NOF_BEAMS):
            for i2 in range(2):
                out.append(make_three_layer_four_ports_type1_sp(i11, i2))
        for i11 in range(_NOF_BEAMS):
            for i2 in range(2):
                out.append(make_four_layer_four_ports_type1_sp(i11, i2))
        return tuple(out)
    raise ValueError(f"no codebook repository for {nof_ports} ports")


def get_matrix(nof_ports: int, pm_index: int) -> np.ndarray:
    repo = repository(nof_ports)
    if not 0 <= pm_index < len(repo):
        raise IndexError(
            f"pm_index {pm_index} outside the {nof_ports}-port repository "
            f"(size {len(repo)})")
    return repo[pm_index]


def pmi_to_index(nof_ports: int, ri: int, i_1_1: int = 0, i_1_3: int = 0,
                 i_2: int = 0) -> int:
    """CSI-report PMI fields -> repository index (the bridge the
    fapi_adaptor's precoding_matrix_mapper provides from MAC PMI to PHY
    matrix; csi_report unpacking produces these fields)."""
    if nof_ports == 1:
        return 0
    if nof_ports == 2:
        # 2-port PMI: 2 bits (1L: codebook 0..3) or 1 bit (2L: 0..1);
        # the raw PMI value arrives in i_2 per csi_report convention.
        return (2 + i_2) if ri == 1 else (6 + i_2)
    if nof_ports == 4:
        if ri == 1:
            return 2 + 4 * i_1_1 + i_2
        if ri == 2:
            return 34 + 4 * i_1_1 + 2 * i_1_3 + i_2
        if ri == 3:
            return 66 + 2 * i_1_1 + i_2
        if ri == 4:
            return 82 + 2 * i_1_1 + i_2
    raise ValueError(f"pmi_to_index: nof_ports={nof_ports} ri={ri}")


def resolve_matrices(nof_ports: int, cfg: PrecodingConfig) -> np.ndarray:
    """PrecodingConfig -> stacked per-PRG matrices [G, P, L] complex64.

    All indices must resolve to the same layer count (one PDU = one layer
    mapping); raises otherwise.
    """
    mats = [get_matrix(nof_ports, i) for i in cfg.pm_indices]
    nl = {m.shape[1] for m in mats}
    if len(nl) != 1:
        raise ValueError(
            f"precoding pm_indices mix layer counts {sorted(nl)}")
    return np.stack(mats, axis=0).astype(np.complex64)
