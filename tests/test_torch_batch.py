"""The port's slot-batch mode and multi-cell programs against the JAX
package's, on the CPU.

``SlotConductor.process_slot_batch`` (the JAX conductor's ``jax.jit(
jax.vmap(...))`` over B same-phase slots) runs with the plain twins here, on
the small cell of tests/test_conductor_fast.py (2 ports, 24 RB, 512-point
FFT, 30 kHz) and its requests: PDCCH + 2-layer PDSCH down, PUSCH + PUCCH
F1 up.  Also: the port's batch against its own per-slot ``process_slot``,
the mixed-plan rejection, the bounded batch cache, the per-slot PRACH input,
``multi_cell_dl_fn`` / ``multi_cell_ul_fn`` against the JAX functions on a
one-device CPU mesh, and the LDPC twin's per-slot early stop against
``jax.vmap`` of the JAX decoder.

Tolerances: TB bits, CRC flags, UCI bits, detections and LDPC sweeps equal;
tx samples within rtol 1e-4 of max|ref|; packed scalars within 2e-4 (as
tests/test_conductor_fast.py holds the JAX batch to its per-slot path);
the multi-cell results within rtol 1e-4 (soft buffers and LLR-derived
values 1e-3, as tests/test_torch_conductor.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.fapi import conductor as j_cond
from srsran_tpu.fapi.messages import (DlTtiRequest, TxDataRequest,
                                      UlTtiRequest)
from srsran_tpu.ops import ldpc_decode as j_ldpc
from srsran_tpu.ops import ofdm as j_ofdm
from srsran_tpu.parallel import mesh as j_mesh
from srsran_tpu.phy.slot_programs import CellConfig
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import ssb as j_ssb
from srsran_tpu.phy.upper.pdcch import CoresetConfig, PdcchConfig
from srsran_tpu.phy.upper.pucch import PucchF1Config
from srsran_tpu.phy.upper.pusch import PuschConfig
from srsran_tpu.ran.ldpc_params import segment_tb, select_base_graph
from srsran_tpu.ran.slot_point import SlotPoint

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.fapi import messages as t_msgs
from srsran_tpu_torch.fapi.validators import ValidationError
from srsran_tpu_torch.ops import ldpc_decode as t_ldpc
from srsran_tpu_torch.ops import ldpc_encode as t_enc
from srsran_tpu_torch.parallel import mesh as t_mesh
from srsran_tpu_torch.phy import slot_programs as t_slots

torch.set_num_threads(2)

CELL = CellConfig(nof_ports=2, nof_rb=24, dft_size=512, numerology=1)
T_CELL = convert.config(CELL)
PDCCH = PdcchConfig(
    coreset=CoresetConfig(rb_start=0, nof_rb=24, start_symbol=0, duration=1),
    rnti=0x4601, aggregation_level=2, cce_index=0, payload_bits=40,
    n_id=1, n_id_data=1)
PDSCH = j_pdsch.PdschConfig(rnti=0x4601, rb_start=0, rb_count=24,
                            first_symbol=1, nof_symbols=12,
                            modulation="qam16", target_code_rate=0.5,
                            tbs=8192, nof_layers=2, n_id=1,
                            dmrs_symbols=(2, 11))
PUSCH = PuschConfig(rnti=0x17, rb_start=0, rb_count=24, first_symbol=0,
                    nof_symbols=14, modulation="qpsk", target_code_rate=0.5,
                    tbs=4096, nof_layers=1, n_id=1, dmrs_symbols=(2, 7, 11))
PUCCH = PucchF1Config(prb=0, start_symbol=0, nof_symbols=14,
                      initial_cyclic_shift=0, time_domain_occ=0, n_id=1)
RNG = np.random.default_rng(3)
SCH_BITS = RNG.integers(0, 2, PDSCH.tbs).astype(np.uint8)
DCI_BITS = RNG.integers(0, 2, 40).astype(np.uint8)
B = 3


def dl_req(i):
    s = SlotPoint(1, 2 * i)
    return DlTtiRequest(
        slot=s,
        pdcch=(dataclasses.replace(PDCCH, slot_in_frame=s.slot_index),),
        pdsch=(dataclasses.replace(PDSCH, slot_in_frame=s.slot_index),))


def ul_req(i, **extra):
    s = SlotPoint(1, 2 * i)
    return UlTtiRequest(
        slot=s,
        pusch=(dataclasses.replace(PUSCH, slot_in_frame=s.slot_index),),
        pucch_f1=(dataclasses.replace(PUCCH, slot=s.slot_index),), **extra)


def tx_req(i):
    return TxDataRequest(slot=SlotPoint(1, 2 * i),
                         pdsch_payloads=(np.packbits(SCH_BITS),),
                         pdcch_payloads=(np.packbits(DCI_BITS),))


def noise_rx(rng, n):
    """tests/test_conductor_fast.py's rx: 0.1 x complex Gaussian noise."""
    t = CELL.slot_samples(0)
    return [(0.1 * (rng.standard_normal((2, t))
                    + 1j * rng.standard_normal((2, t)))).astype(np.complex64)
            for _ in range(n)]


def ue_rx(k, tb, rng):
    """The PUSCH of slot point (1, 2k) sent by the JAX UE (the PDSCH chain
    on port 0 with the PUSCH's scrambling and DM-RS) through a 1x2 channel
    with noise at about 20 dB: it decodes."""
    ue = j_pdsch.PdschConfig(
        rnti=PUSCH.rnti, rb_start=0, rb_count=24, first_symbol=0,
        nof_symbols=14, modulation="qpsk", target_code_rate=0.5,
        tbs=PUSCH.tbs, nof_layers=1, n_id=1, dmrs_symbols=(2, 7, 11),
        slot_in_frame=(2 * k) % 20)
    grid = j_pdsch.process(jnp.zeros((1, 14, CELL.nof_sc), jnp.complex64),
                           jnp.asarray(tb), ue,
                           precoding=np.eye(1, dtype=np.complex64))
    t = np.asarray(j_ofdm.modulate_slot(grid, CELL.dft_size, CELL.numerology,
                                        center_freq_hz=CELL.center_freq_hz))
    rx = np.stack([0.9 * t[0], 0.7 * np.exp(0.5j) * t[0]])
    rx = rx + 0.1 / np.sqrt(2) * (rng.standard_normal(rx.shape)
                                  + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64)


def _port(reqs):
    return [(convert.requests(d), convert.requests(u)) for d, _, u in reqs]


def _stage(cond, reqs, port: bool):
    if port:
        return cond.stage_payloads([(convert.requests(d), convert.requests(t))
                                    for d, t, _ in reqs])
    return cond.stage_payloads([(d, t) for d, t, _ in reqs])


@pytest.fixture(scope="module", params=["noise", "decodable"])
def batch_run(request):
    """B slots through the JAX batch, the port's batch and the port's
    per-slot path: noise rx (tests/test_conductor_fast.py's) or UE rx that
    decodes."""
    rng = np.random.default_rng(9)
    reqs = [(dl_req(k), tx_req(k), ul_req(k)) for k in range(B)]
    if request.param == "noise":
        rxs, tbs = noise_rx(rng, B), None
    else:
        tbs = [rng.integers(0, 2, PUSCH.tbs).astype(np.int8) for _ in range(B)]
        rxs = [ue_rx(k, tb, rng) for k, tb in enumerate(tbs)]
    j_c = j_cond.SlotConductor(CELL)
    j_tx, j_p = j_c.process_slot_batch([(d, u) for d, _, u in reqs],
                                       _stage(j_c, reqs, False),
                                       jnp.stack([jnp.asarray(r) for r in rxs]))
    t_c = t_cond.SlotConductor(T_CELL, device="cpu")
    t_st = _stage(t_c, reqs, True)
    t_tx, t_p = t_c.process_slot_batch(
        _port(reqs), t_st, torch.as_tensor(np.stack(rxs)))
    per_slot = []
    for k, (d, u) in enumerate(_port(reqs)):
        tx, p = t_c.process_slot(d, u, t_st, k, torch.as_tensor(rxs[k]))
        per_slot.append((tx.numpy(), p.scalars.numpy(), p.resolve()))
    return dict(j_tx=np.asarray(j_tx), j_scalars=np.asarray(j_p.scalars),
                j_res=j_p.resolve(), t_tx=t_tx.numpy(),
                t_scalars=t_p.scalars.numpy(), t_res=t_p.resolve(),
                per_slot=per_slot, tbs=tbs, cond=t_c)


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_batch_tx_samples_match_jax(batch_run):
    assert batch_run["t_tx"].shape == batch_run["j_tx"].shape == (
        B, 2, CELL.slot_samples(0))
    _close(batch_run["t_tx"], batch_run["j_tx"], 1e-4)


def test_batch_scalars_match_jax(batch_run):
    got, ref = batch_run["t_scalars"], batch_run["j_scalars"]
    assert got.shape == ref.shape and got.shape[0] == B
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("k", range(B))
def test_batch_slot_results_match_jax(batch_run, k):
    """Each slot's indications: TB bits, CRC flags, F1 decisions and LDPC
    sweeps exact, the reports within rtol 1e-4."""
    ref, got = batch_run["j_res"][k], batch_run["t_res"][k]
    convert.slot_results(ref, got)
    assert got.slot == t_msgs.SlotPoint(1, 2 * k)
    if batch_run["tbs"] is not None:
        assert got.crc[0].tb_crc_ok
        np.testing.assert_array_equal(got.rx_data[0].payload,
                                      batch_run["tbs"][k])


@pytest.mark.parametrize("k", range(B))
def test_batch_equals_port_per_slot(batch_run, k):
    """The port's batch against its own process_slot, slot by slot."""
    tx, scalars, res = batch_run["per_slot"][k]
    _close(batch_run["t_tx"][k], tx, 1e-4)
    np.testing.assert_allclose(batch_run["t_scalars"][k], scalars,
                               rtol=2e-4, atol=2e-4)
    convert.slot_results(res, batch_run["t_res"][k])


def test_batch_phase_resolved_once(batch_run):
    c = batch_run["cond"]
    assert len(c._batch_phases) == 1 and len(c._slot_phases) == B


def test_batch_rejects_mixed_plans():
    """tests/test_conductor_fast.py:182-193: a batch whose slots' UL plans
    differ is refused (the JAX conductor asserts; the port raises its
    validation error)."""
    cond = t_cond.SlotConductor(T_CELL, device="cpu")
    reqs = [(dl_req(k), tx_req(k), ul_req(k)) for k in range(2)]
    st = _stage(cond, reqs, True)
    other = convert.requests(UlTtiRequest(slot=SlotPoint(1, 2), pusch=(
        dataclasses.replace(PUSCH, rb_count=12, tbs=2048),)))
    rx_b = torch.zeros((2, 2, CELL.slot_samples(0)), dtype=torch.complex64)
    with pytest.raises(ValidationError, match="normalized DL/UL plans"):
        cond.process_slot_batch([_port(reqs)[0], (_port(reqs)[1][0], other)],
                                st, rx_b)
    with pytest.raises(ValidationError, match="slot axis"):
        cond.process_slot_batch(_port(reqs), st, rx_b[:1])
    with pytest.raises(ValidationError):
        cond.process_slot_batch([], st, rx_b)


def test_batch_cache_is_bounded(monkeypatch):
    """One resolution per distinct batch; the cache keeps its size."""
    cond = t_cond.SlotConductor(T_CELL, device="cpu")
    calls = []
    real = cond._resolve_batch
    monkeypatch.setattr(cond, "_resolve_batch",
                        lambda *a: calls.append(1) or real(*a))
    cond._batch_phases.size = 2
    rx = torch.zeros((1, 2, CELL.slot_samples(0)), dtype=torch.complex64)
    for k in (0, 1, 0, 2):
        reqs = [(dl_req(k), tx_req(k), ul_req(k))]
        cond.process_slot_batch(_port(reqs), _stage(cond, reqs, True), rx)
    assert len(calls) == 3 and len(cond._batch_phases) == 2


def test_batch_prach_input_is_per_slot():
    """Port-only behaviour.  The JAX conductor feeds one PRACH capture to
    every slot of a batch (srsran_tpu/fapi/conductor.py:785, 805), so a
    preamble seen in one slot is reported in all B (ROADMAP §3).  The port
    takes one capture per slot ([B, P, S, L]): the slot whose capture holds
    preamble 21 reports it, the slot with noise alone reports nothing."""
    cond = t_cond.SlotConductor(T_CELL, device="cpu")
    reqs = [(dl_req(k), tx_req(k), ul_req(k)) for k in range(2)]
    port = [(d, dataclasses.replace(u, prach=(flagship.PRACH,)))
            for d, u in _port(reqs)]
    rng = np.random.default_rng(4)
    with_preamble = flagship.prach_capture(rng, nof_ports=2)
    noise = (0.05 * (rng.standard_normal(with_preamble.shape)
                     + 1j * rng.standard_normal(with_preamble.shape))
             ).astype(np.complex64)
    rx = torch.as_tensor(np.stack(noise_rx(rng, 2)))
    _, pend = cond.process_slot_batch(
        port, _stage(cond, reqs, True), rx,
        prach_fd=(torch.as_tensor(np.stack([with_preamble, noise])),))
    got = [[r.preamble_index for r in res.rach] for res in pend.resolve()]
    assert got == [[flagship.PRACH_PREAMBLE], []]


def test_batch_with_ssb_equals_per_slot():
    """A batch whose slots carry an SSB (each slot its own SFN bits and
    MIB) gives each slot's process_slot samples."""
    ssb = convert.config(j_ssb.SsbConfig(phys_cell_id=1, ssb_idx=0, l_max=8,
                                         sfn=0, first_symbol=2,
                                         first_subcarrier=24))
    cond = t_cond.SlotConductor(T_CELL, device="cpu")
    reqs = [(dl_req(k), tx_req(k), ul_req(k)) for k in range(2)]
    slots, staged_in = [], []
    for k, (d, u) in enumerate(_port(reqs)):
        d = dataclasses.replace(d, ssb=(dataclasses.replace(
            ssb, sfn=k + 1),))
        t = dataclasses.replace(convert.requests(reqs[k][1]), ssb_mib=(
            np.random.default_rng(k).integers(0, 2, 24).astype(np.uint8),))
        slots.append((d, u))
        staged_in.append((d, t))
    st = cond.stage_payloads(staged_in)
    rx = torch.as_tensor(np.stack(noise_rx(np.random.default_rng(6), 2)))
    tx_b, _ = cond.process_slot_batch(slots, st, rx)
    for k, (d, u) in enumerate(slots):
        tx, _ = cond.process_slot(d, u, st, k, rx[k])
        _close(tx_b[k].numpy(), tx.numpy(), 1e-6)
    assert not torch.allclose(tx_b[0], tx_b[1])


# ------------------------------------------------------------ multi-cell

CELLS = 2
MC_DL_PLAN = ((), (PDCCH,), (PDSCH,), ())
MC_UL_PLAN = ((PUSCH,), (), (PUCCH,), (), ())


def test_multi_cell_dl_matches_jax():
    rng = np.random.default_rng(21)
    dci = rng.integers(0, 2, (CELLS, 40)).astype(np.int8)
    sch = rng.integers(0, 2, (CELLS, PDSCH.tbs)).astype(np.int8)
    mesh = j_mesh.make_mesh(1)
    j_s, j_g = j_mesh.multi_cell_dl_fn(CELL, MC_DL_PLAN, CELLS, mesh)(
        (), (jnp.asarray(dci),), (jnp.asarray(sch),))
    t_s, t_g = t_mesh.multi_cell_dl_fn(T_CELL, convert.plan(MC_DL_PLAN),
                                       CELLS)(
        (), (torch.as_tensor(dci),), (torch.as_tensor(sch),))
    assert t_s.shape == (CELLS, 2, CELL.slot_samples(0))
    _close(t_s.numpy(), np.asarray(j_s), 1e-4)
    _close(t_g.numpy(), np.asarray(j_g), 1e-4)
    # each cell equals its single-cell program
    one = t_slots.dl_slot_fn(T_CELL, convert.plan(MC_DL_PLAN))
    for c in range(CELLS):
        s1, _ = one((), (torch.as_tensor(dci[c]),), (torch.as_tensor(sch[c]),))
        _close(t_s[c].numpy(), s1.numpy(), 1e-5)


def test_multi_cell_ul_matches_jax():
    rng = np.random.default_rng(22)
    tbs = [rng.integers(0, 2, PUSCH.tbs).astype(np.int8) for _ in range(CELLS)]
    rx = np.stack([ue_rx(0, tb, rng) for tb in tbs])
    seg = segment_tb(PUSCH.tbs, select_base_graph(PUSCH.tbs, 0.5))
    soft = np.zeros((CELLS, seg.nof_codeblocks, seg.codeword_bits),
                    np.float32)
    mesh = j_mesh.make_mesh(1)
    ref = j_mesh.multi_cell_ul_fn(CELL, MC_UL_PLAN, CELLS, mesh)(
        jnp.asarray(rx), (), (jnp.asarray(soft),))
    got = t_mesh.multi_cell_ul_fn(T_CELL, convert.plan(MC_UL_PLAN), CELLS)(
        torch.as_tensor(rx), (), (torch.as_tensor(soft),))
    exact = {"tb_bits", "tb_crc_ok", "nof_iterations", "ta_s", "detected",
             "harq_bits"}
    for kind in ("pusch", "pucch_f1"):
        assert len(got[kind]) == len(ref[kind]) == 1
        for key, want in ref[kind][0].items():
            a, b = got[kind][0][key].numpy(), np.asarray(want)
            assert a.shape == b.shape and a.shape[0] == CELLS, key
            if key in exact:
                np.testing.assert_array_equal(a, b, err_msg=key)
            elif key == "cfo_hz":
                np.testing.assert_allclose(a, b, atol=1.0)
            else:
                _close(a, b, 1e-3 if key in ("evm", "new_soft") else 1e-4)
    for c in range(CELLS):
        assert bool(got["pusch"][0]["tb_crc_ok"][c])
        np.testing.assert_array_equal(got["pusch"][0]["tb_bits"][c].numpy(),
                                      tbs[c])
    with pytest.raises(ValueError, match="cells"):
        t_mesh.multi_cell_ul_fn(T_CELL, convert.plan(MC_UL_PLAN), 3)(
            torch.as_tensor(rx), (), (torch.as_tensor(soft),))


# --------------------------------------------------- the K1 twin per slot

def test_ldpc_twin_stops_per_slot_as_jax_vmap():
    """decode_early_stop_ref with a slot axis: a clean slot (1 sweep) and a
    noisy slot (more sweeps) give each slot's bits, LLRs and sweep count of
    its separate run, as jax.vmap of the JAX decoder does."""
    seg = segment_tb(1800, 2)
    z, kp, k = seg.lifting_size, seg.cb_info_bits, seg.full_block_bits
    rng = np.random.default_rng(7)
    tb = torch.as_tensor(rng.integers(0, 2, 1800).astype(np.int8))
    cbs = t_enc.dlsch_encode_ref(tb, 2).numpy()              # [C, N]
    sign = 1.0 - 2.0 * cbs.astype(np.float32)
    slots = []
    for sigma in (0.05, 0.9):
        llr = 2 * (sign + sigma * rng.standard_normal(sign.shape)) / sigma ** 2
        llr[:, kp - 2 * z:k - 2 * z] = 1e4                  # fillers
        full = np.concatenate([np.zeros((cbs.shape[0], 2 * z)), llr], axis=1)
        slots.append(np.clip(full, -1e4, 1e4).astype(np.float32))
    llrs = np.stack(slots)                                   # [2, C, 2Z + N]
    args = (2, z, 42, 6, 0.8, "crc24B" if seg.cb_crc_bits else "crc16", kp)
    ref = jax.vmap(lambda x: j_ldpc.decode_early_stop(x, *args))(
        jnp.asarray(llrs))
    bits, soft, iters = t_ldpc.decode_early_stop_ref(torch.as_tensor(llrs),
                                                     *args)
    assert iters.tolist() == np.asarray(ref[2]).tolist()
    assert iters[0] == 1 and iters[1] > 1
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(soft.numpy(), np.asarray(ref[1]), rtol=1e-5,
                               atol=1e-3)
    for s in range(2):
        b1, s1, i1 = t_ldpc.decode_early_stop_ref(torch.as_tensor(llrs[s]),
                                                  *args)
        assert int(i1) == int(iters[s])
        assert torch.equal(b1, bits[s]) and torch.equal(s1, soft[s])


def test_stack_ctx_maps_only_what_differs():
    """stack_ctx: per-slot leaves stack on a new axis, shared leaves (the
    same tensor) stay once, None passes; slot_ctx slices a slot back."""
    shared = torch.ones(3)
    ctxs = [{"a": (torch.full((2,), float(i)), shared), "b": (None,)}
            for i in range(3)]
    ctx, axes = t_slots.stack_ctx(ctxs)
    assert axes == {"a": (0, None), "b": (None,)}
    assert ctx["a"][0].shape == (3, 2) and ctx["a"][1] is shared
    one = t_slots.slot_ctx(ctx, axes, 2)
    assert torch.equal(one["a"][0], ctxs[2]["a"][0]) and one["b"] == (None,)
    with pytest.raises(ValueError, match="structure"):
        t_slots.stack_ctx([{"a": (shared,)}, {"a": (shared, shared)}])
