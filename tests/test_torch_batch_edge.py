"""The cell-edge UL slot in the slot-batch mode, on the CPU.

``SlotConductor.process_slot_batch`` (B = 3) runs the cell-edge slot of
``flagship.EDGE`` cut to size (``SMALL_EDGE`` of
tests/test_torch_cell_edge.py: 2 ports, 52 RB, 1024-point FFT; UE A a
2-layer QAM64 PUSCH, UE C a DFT-s-OFDM QPSK PUSCH with intra-slot hopping
and 2 HARQ-ACK bits, a PUCCH F3 of 22 bits and an F4 of 8, beside a PUCCH
F1, a B4 PRACH and an SRS) with a PDCCH in the DL, each slot its own
payloads, UCI and samples.  On the card K18 (the DFT-s-OFDM PUSCH) and
K17 run once per batch and K19 (PUCCH F3/F4) once per PDU, after the
batched K8 at stride 1; here every wrapper runs its plain twin.

- Against the JAX package's ``process_slot_batch`` (``jax.vmap`` of the
  slot program), with one PRACH capture in every slot (the JAX conductor
  broadcasts one capture, ROADMAP §3).
- Against the port's own ``process_slot``, slot by slot, each slot its
  own capture.
- Each K18 / K19 wrapper (K18 also at the widest DFT-s-OFDM allocation of
  the cell), PUCCH F3/F4's receiver and UE C's PUSCH receiver with a slot
  axis against the same calls slot by slot.

Tolerances: bits, CRC and valid flags, detections equal; tx samples,
packed scalars and indications within rtol 1e-3 of the JAX batch (as
``test_edge_slot_through_the_conductors_matches_jax``) and within 2e-4 of
``process_slot`` (as ``test_edge_batch_equals_process_slot``); a slot
axis against its per-slot runs: decisions and bits equal, floats within
rtol 1e-6 of max|ref| (K14's twin is one product over all rows).  With
its own capture a slot must detect preamble 21; at 2 ports the detector
may report another preamble beside it (slot 1's capture gives 59 in the
batch, in ``process_slot`` and in the JAX package's detector alike).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.fapi import conductor as j_cond

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.ops import ofdm
from srsran_tpu_torch.phy.upper import pucch as t_pucch
from srsran_tpu_torch.phy.upper import pusch as t_pusch

from test_torch_batch_mu import _equal, _slot, _stack
from test_torch_batch_ul_mix import dl_req, tx_req
from test_torch_cell_edge import J_CELL, SMALL_EDGE, _ul_request

torch.set_num_threads(2)

B = 3


@pytest.fixture(scope="module")
def batch():
    """B cell-edge slots through the JAX batch (one shared PRACH capture),
    the port's batch on that capture in every slot, the port's batch on
    one capture per slot and the port's process_slot on each."""
    rng = np.random.default_rng(15)
    gen = torch.Generator()
    gen.manual_seed(15)
    slots = [flagship.edge_slot(k, rng, gen, "cpu", SMALL_EDGE)
             for k in range(B)]
    caps = np.stack([flagship.prach_capture(rng, nof_ports=2)
                     for _ in range(B)])
    reqs = [(dl_req(k), tx_req(k), _ul_request(k)) for k in range(B)]
    rx_b = np.stack([s["rx"].numpy() for s in slots])
    j_c = j_cond.SlotConductor(J_CELL)
    j_st = j_c.stage_payloads([(d, t) for d, t, _ in reqs])
    j_tx, j_p = j_c.process_slot_batch(
        [(d, u) for d, _, u in reqs], j_st, jnp.asarray(rx_b),
        prach_fd=(jnp.asarray(caps[0]),))
    t_c = t_cond.SlotConductor(convert.config(J_CELL), device="cpu")
    t_st = t_c.stage_payloads([(convert.requests(d), convert.requests(t))
                               for d, t, _ in reqs])
    pairs = [(convert.requests(d), convert.requests(u)) for d, _, u in reqs]
    rx_t = torch.as_tensor(rx_b)
    shared = torch.as_tensor(np.stack([caps[0]] * B))
    t_tx, p_shared = t_c.process_slot_batch(pairs, t_st, rx_t,
                                            prach_fd=(shared,))
    own = torch.as_tensor(caps)
    own_tx, p_own = t_c.process_slot_batch(pairs, t_st, rx_t,
                                           prach_fd=(own,))
    per_slot = []
    for k, (d, u) in enumerate(pairs):
        tx, p = t_c.process_slot(d, u, t_st, k, rx_t[k], prach_fd=(own[k],))
        per_slot.append((tx, p.scalars.numpy(), p.payload.numpy(),
                         p.resolve()))
    return dict(slots=slots, pairs=pairs, j_tx=np.asarray(j_tx),
                j_scalars=np.asarray(j_p.scalars), j_res=j_p.resolve(),
                t_tx=t_tx.numpy(), t_scalars=p_shared.scalars.numpy(),
                t_res=p_shared.resolve(), own_tx=own_tx,
                own_scalars=p_own.scalars.numpy(),
                own_payload=p_own.payload.numpy(), own_res=p_own.resolve(),
                per_slot=per_slot)


def test_requests_are_the_flagship_batch_cut_to_size(batch):
    """The port's requests of the batch are ``flagship.edge_ul_request`` on
    the reduced scenario."""
    for k, (_, ul) in enumerate(batch["pairs"]):
        assert ul == flagship.edge_ul_request(k, SMALL_EDGE)


def test_batch_tx_and_scalars_match_jax(batch):
    ref = batch["j_tx"]
    assert batch["t_tx"].shape == ref.shape
    np.testing.assert_allclose(batch["t_tx"], ref, rtol=1e-3,
                               atol=1e-3 * float(np.abs(ref).max()))
    got, ref = batch["t_scalars"], batch["j_scalars"]
    assert got.shape == ref.shape and got.shape[0] == B
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("k", range(B))
def test_batch_slot_matches_jax(batch, k):
    """Slot k's indications against the JAX batch's, and both TBs, UE C's
    HARQ-ACK, the F3 and F4 payloads and PRACH 21 as sent."""
    got = batch["t_res"][k]
    convert.slot_results(batch["j_res"][k], got, rtol=1e-3)
    flagship.check_edge_results(got, batch["slots"][k], f"batch slot {k}",
                                SMALL_EDGE)


@pytest.mark.parametrize("k", range(B))
def test_batch_equals_process_slot(batch, k):
    """Each slot's own PRACH capture: the batch equals process_slot on the
    same slot, and the slot reports preamble 21."""
    tx, scalars, payload, res = batch["per_slot"][k]
    torch.testing.assert_close(batch["own_tx"][k], tx, rtol=2e-4,
                               atol=2e-4 * float(tx.abs().max()))
    np.testing.assert_allclose(batch["own_scalars"][k], scalars, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(batch["own_payload"][k], payload)
    convert.slot_results(res, batch["own_res"][k], rtol=2e-4)
    assert flagship.PRACH_PREAMBLE in [
        r.preamble_index for r in batch["own_res"][k].rach]
    assert [c.tb_crc_ok for c in batch["own_res"][k].crc] == [True, True]


# ---------------------------------------- each wrapper with a slot axis

def _grids(slots):
    cell = SMALL_EDGE.cell
    return [ofdm.demodulate_slot_ref(s["rx"], cell.nof_sc, cell.dft_size,
                                     cell.numerology, cell.cp, 0,
                                     cell.center_freq_hz) for s in slots]


@pytest.fixture(scope="module")
def cases(batch):
    """name -> (function, per-slot argument tuples, the batch's arguments):
    K18 at UE C (both hops, MMSE) and at the widest allocation, K19 at the
    F3 and the F4 (``flagship.edge_kernel_cases`` on each slot's samples),
    PUCCH F3/F4's receiver with each slot's DM-RS values, and UE C's PUSCH
    receiver with each slot's pilots."""
    gen = torch.Generator()
    gen.manual_seed(2)
    slots = batch["slots"]
    per = [flagship.edge_kernel_cases(s, gen, SMALL_EDGE) for s in slots]
    out = {}
    for name in ("pusch_tp_demap", "pusch_tp_demap_widest", "pucch_f3_demap",
                 "pucch_f3_demap_f4"):
        fn, _, _ = per[0][name]
        args = [p[name][2] for p in per]
        out[name] = (fn, args, tuple(_stack(list(v)) for v in zip(*args)))
    grids = _grids(slots)
    for i, (name, cfg) in enumerate((("process_format3", SMALL_EDGE.f3),
                                     ("process_format4", SMALL_EDGE.f4))):
        values = [s["ctx"]["f3"][i] for s in slots]
        out[name] = (t_pucch.process_format3,
                     [(g, cfg, v) for g, v in zip(grids, values)],
                     (torch.stack(grids), cfg, torch.stack(values)))
    soft = flagship.edge_soft_buffers("cpu", SMALL_EDGE)[1]
    pilots = [s["ctx"]["pusch"][1] for s in slots]

    def ue_c(grid, soft_buffer, rows):
        return {f.name: getattr(res, f.name)
                for res in [t_pusch.process(grid, SMALL_EDGE.pusch_c,
                                            soft_buffer=soft_buffer,
                                            dmrs_cinits=rows)]
                for f in dataclasses.fields(res)
                if isinstance(getattr(res, f.name), torch.Tensor)}

    out["pusch_ue_c"] = (ue_c, [(g, soft, p) for g, p in zip(grids, pilots)],
                         (torch.stack(grids), torch.stack([soft] * B),
                          torch.stack(pilots)))
    return out


@pytest.mark.parametrize("name", ["pusch_tp_demap", "pusch_tp_demap_widest",
                                  "pucch_f3_demap", "pucch_f3_demap_f4",
                                  "process_format3", "process_format4",
                                  "pusch_ue_c"])
def test_slot_axis_equals_per_slot(cases, name):
    """The function on the B slots at once gives, in row b of every value,
    what it gives on slot b alone."""
    fn, per_slot, stacked = cases[name]
    got = fn(*stacked)
    for b, args in enumerate(per_slot):
        _equal(_slot(got, b), fn(*args))


def test_f3_f4_and_ue_c_decode_as_sent(cases, batch):
    """The batched F3/F4 receivers and UE C's PUSCH receive give every
    slot's payloads as sent."""
    for i, (name, key) in enumerate((("process_format3", "f3"),
                                     ("process_format4", "f4"))):
        fn, _, stacked = cases[name]
        res = fn(*stacked)
        for b, s in enumerate(batch["slots"]):
            assert bool(res["valid"][b])
            np.testing.assert_array_equal(res["uci_bits"][b].numpy(),
                                          s["uci"][key])
    fn, _, stacked = cases["pusch_ue_c"]
    res = fn(*stacked)
    for b, s in enumerate(batch["slots"]):
        assert bool(res["tb_crc_ok"][b])
        assert torch.equal(res["tb_bits"][b], s["tb_c"])
        np.testing.assert_array_equal(res["harq_ack_bits"][b].numpy(),
                                      s["uci"]["ack"])
