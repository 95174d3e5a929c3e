"""The two-UE UL slot in the slot-batch mode, on the CPU.

``SlotConductor.process_slot_batch`` (B = 3) runs the two-UE slot of
``flagship.MU`` cut to size (``SMALL_MU`` of tests/test_torch_pusch_mu.py:
4 ports, 36 RB, 512-point FFT; UE A a 4-layer QAM64 MMSE PUSCH on 24 RB,
UE B a 1-layer QAM16 MMSE PUSCH on 8 RB with 4 HARQ-ACK, 8 CSI part-1 and
24 part-2 bits, beside a PUCCH F1, a B4 PRACH and an SRS) with a PDCCH in
the DL.  Every slot has the same RI (a batch shares one normalized plan),
its own payloads, UCI and samples.  On the card K16 (the L x N equalizer)
runs once per PUSCH and K17 (the UL-SCH / UCI demultiplexer) once per
batch; here every wrapper runs its plain twin.

- Against the JAX package's ``process_slot_batch`` (``jax.vmap`` of the
  slot program), with one PRACH capture in every slot (the JAX conductor
  broadcasts one capture, ROADMAP §3).
- Against the port's own ``process_slot``, slot by slot, each slot its
  own capture.
- Each K16 / K17 wrapper, the UCI decode after K17 and the PUSCH receiver
  with a slot axis against the same calls slot by slot.

Tolerances: bits, CRC and valid flags, detections equal; tx samples,
packed scalars and indications within rtol 1e-3 of the JAX batch (as the
single two-UE slot through the conductors, tests/test_torch_pusch_mu.py)
and within 2e-4 of ``process_slot`` (as tests/test_torch_cell_edge.py);
a wrapper's slot axis against its per-slot runs: decisions and bits
equal, floats within rtol 1e-6 of max|ref| (the twins run slot by slot,
but K14's twin is one product over all rows, as in
tests/test_torch_batch_ul_mix.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.fapi import conductor as j_cond
from srsran_tpu.fapi.messages import UlTtiRequest
from srsran_tpu.ran.slot_point import SlotPoint

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.fapi import conductor as t_cond
from srsran_tpu_torch.ops import uci_demux, ul_demap
from srsran_tpu_torch.phy.upper import pusch as t_pusch

from test_torch_batch_ul_mix import dl_req, tx_req
from test_torch_pusch_mu import (J_CELL, J_F1, J_PRACH, J_SRS, J_UE_A,
                                 J_UE_B, SMALL_MU)

torch.set_num_threads(2)

B = 3
RI = 1


def j_ul_req(k):
    """Two-UE slot k's UL_TTI.request (slot point (1, 2k)) for the JAX
    conductor, UE B's part-2 size set from the batch's RI."""
    sp = SlotPoint(1, 2 * k)
    sl = sp.slot_index
    ue_b = dataclasses.replace(J_UE_B, uci=dataclasses.replace(
        J_UE_B.uci, o_csi2=flagship.CSI2_SIZES[RI]))
    return UlTtiRequest(
        slot=sp, pusch=tuple(dataclasses.replace(c, slot_in_frame=sl)
                             for c in (J_UE_A, ue_b)),
        pucch_f1=(dataclasses.replace(J_F1, slot=sl),),
        prach=(J_PRACH,), srs=(J_SRS,))


def _captures(rng):
    """One PRACH capture per slot (preamble 21, fresh noise), [B, 4, 12,
    139]."""
    return np.stack([flagship.prach_capture(rng) for _ in range(B)])


@pytest.fixture(scope="module")
def batch():
    """B two-UE slots through the JAX batch (one shared PRACH capture), the
    port's batch on that capture in every slot, the port's batch on one
    capture per slot and the port's process_slot on each."""
    rng = np.random.default_rng(14)
    gen = torch.Generator()
    gen.manual_seed(14)
    slots = [flagship.mu_slot(k, rng, gen, "cpu", SMALL_MU, RI)
             for k in range(B)]
    caps = _captures(rng)
    reqs = [(dl_req(k), tx_req(k), j_ul_req(k)) for k in range(B)]
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


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def test_requests_are_the_flagship_batch_cut_to_size(batch):
    """The port's requests of the batch are ``flagship.mu_ul_request`` on
    the reduced scenario at the batch's RI."""
    for k, (_, ul) in enumerate(batch["pairs"]):
        assert ul == flagship.mu_ul_request(k, RI, SMALL_MU)
        assert batch["slots"][k]["uci"]["ri"] == RI


def test_batch_tx_and_scalars_match_jax(batch):
    assert batch["t_tx"].shape == batch["j_tx"].shape
    _close(batch["t_tx"], batch["j_tx"], 1e-3)
    got, ref = batch["t_scalars"], batch["j_scalars"]
    assert got.shape == ref.shape and got.shape[0] == B
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("k", range(B))
def test_batch_slot_matches_jax(batch, k):
    """Slot k's indications against the JAX batch's, and both TBs, UE B's
    ACK, CSI1 and CSI2 and PRACH 21 as the UEs sent them."""
    got = batch["t_res"][k]
    convert.slot_results(batch["j_res"][k], got, rtol=1e-3)
    flagship.check_mu_results(got, batch["slots"][k], f"batch slot {k}")


@pytest.mark.parametrize("k", range(B))
def test_batch_equals_process_slot(batch, k):
    """Each slot's own PRACH capture: the batch equals process_slot on the
    same slot and holds every bit as sent."""
    tx, scalars, payload, res = batch["per_slot"][k]
    torch.testing.assert_close(batch["own_tx"][k], tx, rtol=2e-4,
                               atol=2e-4 * float(tx.abs().max()))
    np.testing.assert_allclose(batch["own_scalars"][k], scalars, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(batch["own_payload"][k], payload)
    convert.slot_results(res, batch["own_res"][k], rtol=2e-4)
    flagship.check_mu_results(batch["own_res"][k], batch["slots"][k],
                              f"own-capture batch slot {k}")


# ---------------------------------------- each wrapper with a slot axis

def _stack(vals):
    """One argument over the slots: stacked where the slots' tensors
    differ, else the shared value."""
    v0 = vals[0]
    if isinstance(v0, torch.Tensor) and any(v is not v0 for v in vals):
        return torch.stack(vals)
    return v0


@pytest.fixture(scope="module")
def cases(batch):
    """name -> (wrapper, per-slot argument tuples, the batch's arguments):
    K16 at UE A (4 layers MMSE) and UE B (1 layer MMSE), K17 and the UCI
    decode after it at UE B's codeword, from each slot's samples through
    the plain twins upstream (``flagship.mu_kernel_cases``)."""
    gen = torch.Generator()
    gen.manual_seed(1)
    per = [flagship.mu_kernel_cases(s, gen, SMALL_MU) for s in batch["slots"]]
    out = {}
    for name in ("pusch_demap_lxn", "pusch_demap_lxn_1l_mmse",
                 "ulsch_demux"):
        fn, _, _ = per[0][name]
        args = [p[name][2] for p in per]
        out[name] = (fn, args, tuple(_stack(list(v)) for v in zip(*args)))
    cfg_b = SMALL_MU.ue_b(RI)
    llrs = [a[0] for a in out["ulsch_demux"][1]]
    out["decode_uci_fields"] = (
        t_pusch.decode_uci_fields, [(x, cfg_b) for x in llrs],
        (torch.stack(llrs), cfg_b))
    return out


def _equal(got, ref):
    """Decisions and bits equal, floats within rtol 1e-6 of max|ref|."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _equal(got[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _equal(g, r)
    elif ref.is_floating_point() or ref.is_complex():
        assert got.shape == ref.shape and got.dtype == ref.dtype
        atol = 1e-6 * float(ref.abs().max()) if ref.numel() else 0.0
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=atol)
    else:
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert torch.equal(got, ref)


def _slot(obj, b):
    if isinstance(obj, dict):
        return {k: _slot(v, b) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return tuple(_slot(v, b) for v in obj)
    return obj[b]


@pytest.mark.parametrize("name", ["pusch_demap_lxn", "pusch_demap_lxn_1l_mmse",
                                  "ulsch_demux", "decode_uci_fields"])
def test_wrapper_slot_axis_equals_per_slot(cases, name):
    """The wrapper on the B slots at once gives, in row b of every value,
    what it gives on slot b alone."""
    fn, per_slot, stacked = cases[name]
    got = fn(*stacked)
    for b, args in enumerate(per_slot):
        _equal(_slot(got, b), fn(*args))


def test_k16_and_k17_wrappers_route_the_slot_axis(cases):
    """The wrappers K16 and K17 sit behind take the slot axis: K16's with
    the ZF flag off the K3 path, K17's fields as [B, n] rows of the sizes
    the plan gives."""
    fn, _, stacked = cases["pusch_demap_lxn"]
    assert fn is ul_demap.equalize_demap_descramble_lxn
    llr, x = ul_demap.equalize_demap_descramble(*stacked)
    assert llr.shape[0] == x.shape[0] == B
    _, _, (llrs, dcfg, o_ack, o_csi1, c_init) = cases["ulsch_demux"]
    fields = uci_demux.demux(llrs, dcfg, o_ack, o_csi1, c_init)
    assert [tuple(f.shape) for f in fields] == [
        (B, n) for n in uci_demux.field_sizes(dcfg)]


def test_pusch_receiver_slot_axis_equals_per_slot(batch):
    """UE B's whole PUSCH receive (K8, K16, K17, the UCI decodes, K2, K1)
    on the B slots' grids at once against each slot alone."""
    from srsran_tpu_torch.ops import ofdm
    cell = SMALL_MU.cell
    grids = [ofdm.demodulate_slot_ref(s["rx"], cell.nof_sc, cell.dft_size,
                                      cell.numerology, cell.cp, 0,
                                      cell.center_freq_hz)
             for s in batch["slots"]]
    cfg = SMALL_MU.ue_b(RI)
    pilots = [s["ctx"]["pusch"][1] for s in batch["slots"]]
    soft = flagship.mu_soft_buffers("cpu", SMALL_MU)[1]
    got = t_pusch.process(torch.stack(grids), cfg,
                          soft_buffer=torch.stack([soft] * B),
                          dmrs_cinits=torch.stack(pilots))
    for b in range(B):
        one = t_pusch.process(grids[b], cfg, soft_buffer=soft,
                              dmrs_cinits=pilots[b])
        for f in dataclasses.fields(one):
            ref = getattr(one, f.name)
            if isinstance(ref, torch.Tensor):
                _equal(getattr(got, f.name)[b], ref)
        assert bool(one.tb_crc_ok) and bool(one.csi2_valid)
