"""Multi-cell slot programs on one device.

Port of srsran_tpu/parallel/mesh.py::multi_cell_dl_fn and multi_cell_ul_fn
(:47-71): the JAX functions are ``jax.vmap`` of the slot programs over a
leading cell axis, jitted with the cell axis sharded over a device mesh.
The port runs the slot programs with cells as the leading (slot) axis on
the one device their inputs lie on (one H100); there is no mesh, so
``make_mesh``, ``shard_cells``, ``single_cell_ul_time_sharded_fn``,
``parallel/multihost.py`` and ``parallel/seqpar.py`` are not ported
(ROADMAP §1, the do-not-port list).  The programs then launch the
PDSCH and PUSCH chains' kernels (K1-K8) and the UL receivers' (K9-K15)
once for all the cells.
"""

from __future__ import annotations

import functools

from ..phy.slot_programs import CellConfig, dl_slot_core, ul_slot_core


@functools.lru_cache(maxsize=64)
def multi_cell_dl_fn(cell: CellConfig, plan, nof_cells: int,
                     slot_in_subframe: int = 0):
    """The DL slot program over ``nof_cells`` cells of one plan.

    Returned fn(ssb_mib, pdcch_payloads, pdsch_payloads) -> (samples
    [cells, P, T], grid [cells, P, S, K]), every payload with a leading cell
    axis; the DM-RS and SSB context comes from the plan, as the JAX
    function computes it without a slot context.
    """
    core = dl_slot_core(cell, plan, slot_in_subframe)

    def run(ssb_mib, pdcch_payloads, pdsch_payloads):
        for x in (*ssb_mib, *pdcch_payloads, *pdsch_payloads):
            _check_cells(x, nof_cells)
        return core(ssb_mib, pdcch_payloads, pdsch_payloads)

    return run


@functools.lru_cache(maxsize=64)
def multi_cell_ul_fn(cell: CellConfig, plan, nof_cells: int,
                     slot_in_subframe: int = 0):
    """The UL slot program over ``nof_cells`` cells of one plan.

    Returned fn(samples [cells, P, T], prach_fd, soft_buffers) -> the UL
    program's dict with a leading cell axis on every value; prach_fd[i]
    [cells, P, S, L], soft_buffers[i] [cells, C, N].
    """
    core = ul_slot_core(cell, plan, slot_in_subframe)

    def run(samples, prach_fd, soft_buffers):
        for x in (samples, *prach_fd, *(soft_buffers or ())):
            _check_cells(x, nof_cells)
        return core(samples, prach_fd, soft_buffers)

    return run


def _check_cells(x, nof_cells: int) -> None:
    if x.shape[0] != nof_cells:
        raise ValueError(f"input {tuple(x.shape)} has no leading axis of "
                         f"{nof_cells} cells")
