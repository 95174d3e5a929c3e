"""The port's DL reference signals against the JAX package's, on the CPU.

NZP-CSI-RS (rows 1-18 at every density, on the sequence-values and the
c_init paths, and rows 6 and 11 through a precoding matrix), PT-RS (L 1/2/4,
K 2/4), PRS (combs 2/4/6/12) and the DL DM-RS map (1-4 layers: no matrix,
a matrix, per PRG) -- the plain twins of K25 and K26 -- each on a seeded
random grid; a PDSCH with PT-RS, a PRS-only and an empty DL_TTI through
both packages' conductors; and every CSI-RS, PRS and PT-RS validation
error of the JAX package raised by the port too.

Tolerances: PT-RS, PRS, the identity DM-RS map and the unprecoded CSI-RS
rows are bit-exact (the same additions in the same order); where a
complex weight multiplies (precoded CSI-RS, a DM-RS matrix), within 1e-6
of max|ref| (XLA's complex products round in another order than the
twins' one-by-one real operations).  Conductor grids and samples within
1e-5 of max|ref|.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.fapi import conductor as j_cond
from srsran_tpu.fapi import validators as j_val
from srsran_tpu.fapi.messages import DlTtiRequest, TxDataRequest
from srsran_tpu.phy.slot_programs import CellConfig
from srsran_tpu.phy.upper import csi_rs as j_csi
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import ptrs_prs as j_pp
from srsran_tpu.phy.upper.pdcch import CoresetConfig, PdcchConfig
from srsran_tpu.phy.upper.ssb import SsbConfig
from srsran_tpu.ran.slot_point import SlotPoint

from srsran_tpu_torch import convert
from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.fapi import messages as t_msgs
from srsran_tpu_torch.fapi import validators as t_val
from srsran_tpu_torch.phy.upper import csi_rs as t_csi
from srsran_tpu_torch.phy.upper import dmrs as t_dmrs
from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
from srsran_tpu_torch.phy.upper import ptrs_prs as t_pp

torch.set_num_threads(2)

P, NRB = 4, 52
K = 12 * NRB
CELL = CellConfig(nof_ports=P, nof_rb=NRB, dft_size=1024, numerology=1)


def _grid(seed, shape=(P, 14, K)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), err
    return err


def _t(cfg, mod):
    return getattr(mod, type(cfg).__name__)(**dataclasses.asdict(cfg))


# --------------------------------------------------------------- CSI-RS

def _csi_cfg(row, density):
    nk = j_csi._ROWS[row][2]
    k_ref = tuple(2 * i for i in range(nk)) if nk > 1 else (2,)
    return j_csi.CsiRsConfig(row=row, rb_start=3, rb_count=40, symbol=5,
                             symbol2=9, k_ref=k_ref, density=density,
                             scrambling_id=11, slot_in_frame=3, amplitude=0.9)


CSI_CASES = [(row, d) for row in range(1, 19) for d in j_csi._ROWS[row][3]]


@pytest.mark.parametrize("row,density", CSI_CASES)
def test_csi_rs_rows(row, density):
    """Every row and density on a 4-port grid, from the values (the
    conductor's slot context) and from the c_init seeds; rows with more
    CSI-RS ports than grid ports through a seeded matrix."""
    cfg = _csi_cfg(row, density)
    g = _grid(row)
    n = j_csi.nof_csi_rs_ports(row)
    prec = None
    if n > P:
        rng = np.random.default_rng(100 + row)
        prec = (rng.standard_normal((n, P))
                + 1j * rng.standard_normal((n, P))).astype(np.complex64)
    ref = np.asarray(j_csi.process(jnp.asarray(g), cfg, precoding=prec))
    tc = _t(cfg, t_csi)
    vals = torch.as_tensor(t_csi.seq_values_for(tc))
    np.testing.assert_array_equal(vals.numpy(), j_csi.seq_values_for(cfg))
    got = t_csi.process(torch.as_tensor(g.copy()), tc, vals, prec).numpy()
    seeds = torch.as_tensor(np.atleast_1d(t_csi.c_init_for(tc)).astype(
        np.int64))
    got_ci = t_csi.process(torch.as_tensor(g.copy()), tc, seeds, prec).numpy()
    np.testing.assert_array_equal(got_ci, got)
    if prec is None:
        np.testing.assert_array_equal(got, ref)
    else:
        _rel(got, ref, 1e-6)


@pytest.mark.parametrize("row", [6, 11])
def test_csi_rs_precoded_onto_fewer_ports(row):
    """tests/test_csi_rs_rows.py's case: 8 / 16 CSI-RS ports mapped onto 4
    (or 2) physical ports by a matrix whose entries repeat ports, so
    several CSI-RS ports add at one RE in the JAX order."""
    cfg = j_csi.CsiRsConfig(row=row, rb_start=0, rb_count=24, symbol=4,
                            k_ref=(0, 2, 4, 6), scrambling_id=3)
    n = j_csi.nof_csi_rs_ports(row)
    for phys in (4, 2):
        prec = np.zeros((n, phys), np.complex64)
        prec[np.arange(n), np.arange(n) % phys] = 0.5 + 0.25j
        prec[:, 0] += 0.125
        g = _grid(row + phys, (phys, 14, 24 * 12))
        ref = np.asarray(j_csi.process(jnp.asarray(g), cfg, precoding=prec))
        got = t_csi.process(torch.as_tensor(g.copy()), _t(cfg, t_csi),
                            precoding=prec).numpy()
        _rel(got, ref, 1e-6)
    with pytest.raises(ValueError, match="precoding"):
        t_csi.process(torch.zeros((4, 14, 24 * 12), dtype=torch.complex64),
                      _t(cfg, t_csi))


# ----------------------------------------------------------- PT-RS, PRS

@pytest.mark.parametrize("time_density", [1, 2, 4])
@pytest.mark.parametrize("freq_density", [2, 4])
def test_map_ptrs(time_density, freq_density):
    cfg = j_pp.PtrsConfig(rb_start=2, rb_count=45, first_symbol=1,
                          nof_symbols=12, dmrs_symbols=(2, 11),
                          time_density=time_density,
                          freq_density=freq_density, re_offset=3, port=1,
                          scrambling_id=5, n_scid=1, slot_in_frame=7,
                          amplitude=1.3)
    g = _grid(time_density * 10 + freq_density)
    ref = np.asarray(j_pp.map_ptrs(jnp.asarray(g), cfg))
    tc = _t(cfg, t_pp)
    np.testing.assert_array_equal(t_pp.ptrs_positions(tc),
                                  j_pp.ptrs_positions(cfg))
    got = t_pp.map_ptrs(torch.as_tensor(g.copy()), tc).numpy()
    np.testing.assert_array_equal(got, ref)
    vals = torch.as_tensor(t_pp.ptrs_values_for(tc))
    got_v = t_pp.map_ptrs(torch.as_tensor(g.copy()), tc, vals).numpy()
    np.testing.assert_array_equal(got_v, ref)


@pytest.mark.parametrize("comb", [2, 4, 6, 12])
def test_map_prs(comb):
    cfg = j_pp.PrsConfig(rb_start=2, rb_count=48, first_symbol=2,
                         nof_symbols=12 if comb == 12 else 4, comb_size=comb,
                         comb_offset=1, n_id_prs=1234, slot_in_frame=5,
                         amplitude=0.8)
    g = _grid(comb)
    ref = np.asarray(j_pp.map_prs(jnp.asarray(g), cfg))
    tc = _t(cfg, t_pp)
    got = t_pp.map_prs(torch.as_tensor(g.copy()), tc).numpy()
    np.testing.assert_array_equal(got, ref)
    seeds = torch.as_tensor(t_pp.prs_cinits_for(tc).astype(np.int64))
    got_ci = t_pp.map_prs(torch.as_tensor(g.copy()), tc, seeds).numpy()
    np.testing.assert_array_equal(got_ci, ref)


# ----------------------------------------------------------- DL DM-RS

@pytest.mark.parametrize("layers", [1, 2, 3, 4])
@pytest.mark.parametrize("precoder", ["none", "matrix", "prg"])
def test_dmrs_map_dl(layers, precoder):
    kw = dict(rb_start=3, rb_count=40, symbols=(2, 11),
              ports=tuple(range(layers)), scrambling_id=7, slot_in_frame=4)
    jc, tc = j_dmrs.DmrsConfig(**kw), t_dmrs.DmrsConfig(**kw)
    g = _grid(layers)
    rng = np.random.default_rng(layers)
    if precoder == "prg":
        w = (rng.standard_normal((11, P, layers))
             + 1j * rng.standard_normal((11, P, layers))).astype(np.complex64)
        ref = j_dmrs.map_to_grid(
            jnp.asarray(g), jc, None, None, prg_matrices=jnp.asarray(w),
            prg_of_sc=lambda sc: j_pdsch.prg_index_of_sc(sc, 3, 4))
        got = t_dmrs.map_to_grid(torch.as_tensor(g.copy()), tc, None, None,
                                 prg_matrices=torch.as_tensor(w), prg_size=4)
        _rel(got.numpy(), ref, 1e-6)
        return
    w = None
    if precoder == "matrix":
        w = (rng.standard_normal((P, layers))
             + 1j * rng.standard_normal((P, layers))).astype(np.complex64)
    ref = j_dmrs.map_to_grid(jnp.asarray(g), jc, w)
    got = t_dmrs.map_to_grid(torch.as_tensor(g.copy()), tc, w).numpy()
    if w is None:
        np.testing.assert_array_equal(got, np.asarray(ref))
    else:
        _rel(got, ref, 1e-6)


# ------------------------------------------------------ through conductors

SLOT = SlotPoint(1, 2)
PTRS = j_pdsch.PdschPtrs(time_density=1, freq_density=2, re_offset=0, port=0)
PDSCH_1L = j_pdsch.PdschConfig(
    rnti=0x55, rb_start=0, rb_count=48, first_symbol=0, nof_symbols=14,
    modulation="qam16", target_code_rate=0.5, tbs=3624, nof_layers=1, n_id=7,
    dmrs_symbols=(2, 11), slot_in_frame=SLOT.slot_index, ptrs=PTRS)
PDSCH_4L = j_pdsch.PdschConfig(
    rnti=0x56, rb_start=0, rb_count=52, first_symbol=1, nof_symbols=12,
    modulation="qam64", target_code_rate=0.6, tbs=20496, nof_layers=4,
    n_id=3, dmrs_symbols=(2, 11), slot_in_frame=SLOT.slot_index,
    ptrs=j_pdsch.PdschPtrs(time_density=2, freq_density=4, re_offset=5,
                           port=2))
PRS = j_pp.PrsConfig(rb_start=0, rb_count=24, first_symbol=2, nof_symbols=4,
                     comb_size=4, comb_offset=1, n_id_prs=321,
                     slot_in_frame=SLOT.slot_index)
CSI = j_csi.CsiRsConfig(row=4, rb_start=0, rb_count=52, symbol=13, k0=0,
                        scrambling_id=1, slot_in_frame=SLOT.slot_index)
SSB = SsbConfig(phys_cell_id=1, ssb_idx=0, l_max=8, first_symbol=2,
                first_subcarrier=48)
PDCCH = PdcchConfig(
    coreset=CoresetConfig(rb_start=0, nof_rb=24, start_symbol=0, duration=1),
    rnti=0x4601, aggregation_level=2, cce_index=0, payload_bits=40,
    n_id=1, n_id_data=1, slot_in_frame=SLOT.slot_index)


def _both(cell, dl, tx):
    """(JAX samples, grid), (port samples, grid) of one DL request."""
    js, jg = j_cond.SlotConductor(cell).process_dl(dl, tx)
    ts, tg = t_cond.SlotConductor(convert.config(cell), device="cpu"
                                  ).process_dl(convert.requests(dl),
                                               convert.requests(tx))
    return (np.asarray(js), np.asarray(jg)), (ts.numpy(), tg.numpy())


@pytest.mark.parametrize("case", ["round3_1layer", "4layer"])
def test_pdsch_with_ptrs_through_conductors(case):
    """tests/test_fapi_round3.py:75's PDSCH (2 ports, 1 layer) and a
    4-layer one (PT-RS on port 2, L 2, K 4): the data maps around the PT-RS
    REs as in the JAX package, and the grids and samples agree."""
    cfg, cell = ((PDSCH_1L, CellConfig(nof_ports=2, nof_rb=52, dft_size=1024,
                                       numerology=1))
                 if case == "round3_1layer" else (PDSCH_4L, CELL))
    assert t_pdsch.nof_data_re(convert.config(cfg)) == j_pdsch.nof_data_re(cfg)
    assert j_pdsch.nof_data_re(cfg) < j_pdsch.nof_data_re(
        dataclasses.replace(cfg, ptrs=None))
    payload = np.random.default_rng(7).integers(0, 2, cfg.tbs).astype(np.int8)
    dl = DlTtiRequest(slot=SLOT, pdsch=(cfg,))
    tx = TxDataRequest(slot=SLOT, pdsch_payloads=(payload,))
    (js, jg), (ts, tg) = _both(cell, dl, tx)
    _rel(tg, jg, 1e-5)
    _rel(ts, js, 1e-5)
    pos = t_pp.ptrs_positions(t_pdsch.ptrs_config(convert.config(cfg)))
    assert np.all(np.abs(tg[cfg.ptrs.port, pos[:, 0], pos[:, 1]]) > 0.1)


def test_full_dl_slot_through_conductors():
    """SSB, PDCCH, a 4-layer PDSCH with PT-RS, a 4-port CSI-RS and a PRS
    in one DL_TTI: one K27 and one K25 launch on the card."""
    rng = np.random.default_rng(11)
    dl = DlTtiRequest(slot=SLOT, ssb=(SSB,), pdcch=(PDCCH,),
                      pdsch=(PDSCH_4L,), csi_rs=(CSI,),
                      prs=(dataclasses.replace(PRS, rb_start=24),))
    tx = TxDataRequest(
        slot=SLOT, ssb_mib=(rng.integers(0, 2, 24).astype(np.int8),),
        pdcch_payloads=(rng.integers(0, 2, 40).astype(np.int8),),
        pdsch_payloads=(rng.integers(0, 2, PDSCH_4L.tbs).astype(np.int8),))
    (js, jg), (ts, tg) = _both(CELL, dl, tx)
    _rel(tg, jg, 1e-5)
    _rel(ts, js, 1e-5)


@pytest.mark.parametrize("kind", ["prs_only", "empty"])
def test_dl_tti_without_payloads(kind):
    """A DL_TTI with no SSB, PDCCH or PDSCH (repair of the DL program's
    device): the port's conductor returns the slot's samples, as the JAX
    conductor does -- the PRS slot's, or zeros."""
    dl = DlTtiRequest(slot=SLOT, prs=(PRS,) if kind == "prs_only" else ())
    tx = TxDataRequest(slot=SLOT)
    (js, jg), (ts, tg) = _both(CELL, dl, tx)
    assert ts.shape == js.shape and tg.shape == jg.shape
    if kind == "empty":
        assert not np.any(ts) and not np.any(js)
    else:
        assert np.count_nonzero(tg[0]) == 4 * 24 * 12 // 4
        np.testing.assert_array_equal(tg, jg)
        _rel(ts, js, 1e-5)


def _many_slot(kind):
    """A DL_TTI of a MAC with many UEs: "dcis" the SSB and 17 AL1 DCIs in
    a 48-RB, 2-symbol CORESET (more PDUs than one K27 launch takes; the
    last DCI shares the first one's CCE), "csi_rs" 33 one-port CSI-RS (row
    1, density 3; more than one K25 launch takes, PDUs 20 apart sharing
    their REs)."""
    rng = np.random.default_rng(17)
    if kind == "csi_rs":
        csi = tuple(j_csi.CsiRsConfig(
            row=1, rb_start=0, rb_count=52, symbol=4 + j % 10, k0=j % 4,
            scrambling_id=j, slot_in_frame=SLOT.slot_index)
            for j in range(33))
        return DlTtiRequest(slot=SLOT, csi_rs=csi), TxDataRequest(slot=SLOT)
    coreset = CoresetConfig(rb_start=0, nof_rb=48, start_symbol=0, duration=2)
    pdcchs = tuple(dataclasses.replace(
        PDCCH, coreset=coreset, aggregation_level=1, cce_index=j % 16,
        rnti=0x4601 + j) for j in range(17))
    dl = DlTtiRequest(slot=SLOT, ssb=(SSB,), pdcch=pdcchs)
    tx = TxDataRequest(
        slot=SLOT, ssb_mib=(rng.integers(0, 2, 24).astype(np.int8),),
        pdcch_payloads=tuple(rng.integers(0, 2, 40).astype(np.int8)
                             for _ in pdcchs))
    return dl, tx


@pytest.mark.parametrize("kind", ["dcis", "csi_rs"])
def test_many_pdus_through_conductors(kind):
    """More PDCCH and SSB PDUs than one K27 launch takes (17 DCIs and an
    SSB), or more RS PDUs than one K25 launch takes (33 CSI-RS), in one
    DL_TTI: the port's conductor serves the slot as the JAX one does
    (on the card each takes two launches; tests/test_torch_kernels.py)."""
    (js, jg), (ts, tg) = _both(CELL, *_many_slot(kind))
    _rel(tg, jg, 1e-5)
    _rel(ts, js, 1e-5)


# ------------------------------------------------------------- validation

def _bad_requests():
    ok_pdsch = dataclasses.replace(PDSCH_1L, ptrs=None)
    out = []
    for kw in (dict(row=19), dict(row=6), dict(rb_count=60),
               dict(k_ref=(0, 2)), dict(row=1, density="one"),
               dict(row=3, density="three"), dict(row=13, symbol2=-1)):
        out.append(dict(csi_rs=(dataclasses.replace(CSI, **kw),)))
    for kw in (dict(rb_count=60), dict(nof_symbols=3), dict(comb_size=3),
               dict(comb_offset=4), dict(n_id_prs=4096),
               dict(comb_size=12, rb_count=24, nof_symbols=12,
                    first_symbol=3),
               dict(first_symbol=12, nof_symbols=4)):
        out.append(dict(prs=(dataclasses.replace(PRS, **kw),)))
    for kw in (dict(time_density=3), dict(freq_density=1), dict(re_offset=12),
               dict(port=1)):
        out.append(dict(pdsch=(dataclasses.replace(
            ok_pdsch, ptrs=dataclasses.replace(PTRS, **kw)),)))
    out.append(dict(csi_rs=(CSI,), prs=(PRS,),
                    pdsch=(dataclasses.replace(PDSCH_1L),)))
    return out


@pytest.mark.parametrize("i", range(len(_bad_requests())))
def test_rs_validation_matches_jax(i):
    """Each JAX CSI-RS / PRS / PT-RS rule: the port raises where the JAX
    package raises, with the same message (the last case passes)."""
    kw = _bad_requests()[i]
    dl = DlTtiRequest(slot=SLOT, **kw)
    cell = CellConfig(nof_ports=P, nof_rb=NRB, dft_size=1024, numerology=1)
    try:
        j_val.validate_dl_tti(dl, cell)
        want = None
    except j_val.ValidationError as e:
        want = str(e)
    try:
        t_val.validate_dl_tti(convert.requests(dl), convert.config(cell))
        got = None
    except t_val.ValidationError as e:
        got = str(e)
    assert got == want
    assert (want is None) == (i == len(_bad_requests()) - 1)


def test_rs_only_slots_in_a_batch():
    """process_slot_batch of two PRS-only DL_TTIs (no payload carries the
    slot axis: the conductor names the batch size): each slot's samples
    equal process_slot's, and the two slots' PRS values differ."""
    cond = t_cond.SlotConductor(convert.config(CELL), device="cpu")
    slots, txs = [], []
    for count in (4, 6):
        slot = SlotPoint(1, count)
        dl = DlTtiRequest(slot=slot, prs=(dataclasses.replace(
            PRS, slot_in_frame=slot.slot_index),))
        slots.append((convert.requests(dl), t_msgs.UlTtiRequest(
            slot=convert.config(slot))))
        txs.append(convert.requests(TxDataRequest(slot=slot)))
    staged = cond.stage_payloads([(s[0], t) for s, t in zip(slots, txs)])
    rx = torch.zeros((2, P, CELL.slot_samples(0)), dtype=torch.complex64)
    tx_b, pend = cond.process_slot_batch(slots, staged, rx)
    assert tx_b.shape == (2, P, CELL.slot_samples(0))
    for b, (dl, ul) in enumerate(slots):
        tx, _ = cond.process_slot(dl, ul, staged, b, rx[b])
        np.testing.assert_array_equal(tx_b[b].numpy(), tx.numpy())
    assert not torch.equal(tx_b[0], tx_b[1])
    assert [r.slot.count for r in pend.resolve()] == [4, 6]
