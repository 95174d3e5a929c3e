"""The DL slice of the port against the JAX package, on the CPU.

PDCCH (every aggregation level, CORESET durations 1-3, interleaved
CORESETs, DM-RS from the config, from pilot values and from c_inits), SSB
(several cells, L_max 4/8/64, SFN, half-frame and k_SSB, with and without
the slot context), the PDSCH (4 layers, 256QAM, DM-RS on symbols 2 and 11,
two CDM groups; a repetition case and rv 1-3 for the rate-match geometry),
OFDM modulation, and the DL slot programs on a small cell (4 ports, 24 RB,
512-point FFT) with the slot context of the JAX conductor's
``normalize_dl_plan``.  Inputs are made with numpy from seeds; on the CPU
every kernel wrapper runs its plain twin.  Tolerances: grids 1e-6 absolute
per op (the same float ops in the same order, up to the precoder's sum) and
1e-5 for the slot grid; samples rtol 1e-4 of max |ref| (the FFTs differ).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.fapi.conductor import normalize_dl_plan
from srsran_tpu.fapi.messages import DlTtiRequest
from srsran_tpu.ops import crc as j_crc
from srsran_tpu.ops import ldpc_encode as j_enc
from srsran_tpu.ops import ofdm as j_ofdm
from srsran_tpu.phy import slot_programs as j_slots
from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pdcch as j_pdcch
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import ssb as j_ssb
from srsran_tpu.ran.cyclic_prefix import CyclicPrefix
from srsran_tpu.ran.ldpc_params import segment_tb, select_base_graph
from srsran_tpu.ran.mcs_tbs import tbs as tbs_calc
from srsran_tpu.ran.slot_point import SlotPoint

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.ops import dl_map, ldpc_encode
from srsran_tpu_torch.ops import ofdm as t_ofdm
from srsran_tpu_torch.ops import gold
from srsran_tpu_torch.ops.gold import gold_sequence_np
from srsran_tpu_torch.phy import slot_programs as t_slots
from srsran_tpu_torch.phy.upper import pdcch as t_pdcch
from srsran_tpu_torch.phy.upper import pdsch as t_pdsch
from srsran_tpu_torch.phy.upper import ssb as t_ssb

torch.set_num_threads(2)


def _cgauss(rng, shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _close(port, ref, rtol=None, atol=None):
    ref = np.asarray(ref)
    if atol is None:
        atol = rtol * float(np.max(np.abs(ref)))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=atol)


# ------------------------------------------------------------------- PDCCH

# (aggregation level, duration, interleaved, REG bundle, interleaver depth,
# shift, first CCE) on a 96-RB CORESET from RB 6.
PDCCH_CASES = [
    (1, 1, False, 6, 2, 0, 5), (2, 2, False, 6, 2, 0, 6),
    (4, 3, False, 6, 2, 0, 8), (8, 1, False, 6, 2, 0, 8),
    (16, 1, False, 6, 2, 0, 0), (16, 3, False, 6, 2, 0, 16),
    (4, 1, True, 2, 6, 5, 4), (8, 2, True, 2, 2, 0, 16),
    (2, 3, True, 3, 3, 7, 10), (16, 2, True, 6, 2, 1, 16),
]


def _pdcch_cfg(case):
    al, dur, inter, bundle, depth, shift, cce = case
    coreset = j_pdcch.CoresetConfig(
        rb_start=6, nof_rb=96, start_symbol=1, duration=dur,
        interleaved=inter, reg_bundle_size=bundle, interleaver_size=depth,
        shift_index=shift)
    return j_pdcch.PdcchConfig(coreset=coreset, rnti=0x4601,
                               aggregation_level=al, cce_index=cce,
                               payload_bits=40 + al, n_id=7, n_id_data=5,
                               n_rnti=0x4601 if inter else 0,
                               slot_in_frame=3)


@pytest.mark.parametrize("ctx", ["config", "values", "c_inits"])
@pytest.mark.parametrize("case", PDCCH_CASES)
def test_pdcch_process(case, ctx):
    cfg = _pdcch_cfg(case)
    rng = np.random.default_rng(sum(case[:2]))
    payload = rng.integers(0, 2, cfg.payload_bits).astype(np.int8)
    grid = _cgauss(rng, (2, 14, 1320))
    if ctx == "config":
        j_ci = t_ci = None
    else:
        host = (j_pdcch.dmrs_values_for(cfg, 11) if ctx == "values"
                else j_pdcch.dmrs_cinits_for(cfg, 11))
        j_ci = jnp.asarray(host)
        t_ci = convert.slot_context({"pdcch": (host,)}, "cpu")["pdcch"][0]
    ref = j_pdcch.process(jnp.asarray(grid), jnp.asarray(payload), cfg,
                          dmrs_cinits=j_ci)
    out = t_pdcch.process(torch.as_tensor(grid.copy()),
                          torch.as_tensor(payload), convert.config(cfg),
                          dmrs_cinits=t_ci)
    _close(out, ref, atol=1e-6)


def test_pdcch_device_seeds_raise():
    cfg = convert.config(_pdcch_cfg(PDCCH_CASES[0]))
    seeds = torch.as_tensor(t_pdcch.dmrs_cinits_for(cfg).astype(np.int64))
    with pytest.raises(ValueError, match="host"):
        t_pdcch._dmrs_values(cfg, seeds.to("meta"), "meta")


# --------------------------------------------------------------------- SSB

# (pci, ssb_idx, l_max, sfn, hrf, k_ssb, beta_pss_db, first symbol, first sc)
SSB_CASES = [
    (1, 0, 8, 0, False, 0, 0.0, 2, 48), (503, 3, 4, 17, True, 16, 3.0, 8, 0),
    (77, 37, 64, 1023, False, 0, 0.0, 2, 12),
    (1006, 7, 8, 514, True, 23, 0.0, 9, 36),
]


@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("case", SSB_CASES)
def test_map_ssb_to_grid(case, with_ctx):
    pci, idx, l_max, sfn, hrf, k_ssb, beta, l0, k0 = case
    cfg = j_ssb.SsbConfig(phys_cell_id=pci, ssb_idx=idx, l_max=l_max, hrf=hrf,
                          sfn=sfn, k_ssb=k_ssb, beta_pss_db=beta,
                          first_symbol=l0, first_subcarrier=k0)
    rng = np.random.default_rng(pci)
    mib = rng.integers(0, 2, 24).astype(np.int8)
    grid = _cgauss(rng, (4, 14, 288))
    if with_ctx:
        host = j_ssb.slot_ctx_for(cfg, sfn=sfn + 5, hrf=not hrf)
        j_ctx = tuple(jnp.asarray(h) for h in host)
        t_ctx = convert.slot_context({"ssb": (host,)}, "cpu")["ssb"][0]
    else:
        j_ctx = t_ctx = None
    ref = j_ssb.map_ssb_to_grid(jnp.asarray(grid), cfg, jnp.asarray(mib), j_ctx)
    out = t_ssb.map_ssb_to_grid(torch.as_tensor(grid.copy()),
                                convert.config(cfg), torch.as_tensor(mib),
                                t_ctx)
    _close(out, ref, atol=1e-6)


# ------------------------------------------------------------------- PDSCH

def _j_pdsch(**kw):
    base = dict(rnti=0x4601, rb_start=0, rb_count=24, first_symbol=1,
                nof_symbols=12, modulation="qam256", target_code_rate=0.8,
                tbs=tbs_calc(24, 12, 24, "qam256", 0.8, 4), nof_layers=4,
                n_id=1, dmrs_symbols=(2, 11), slot_in_frame=5)
    base.update(kw)
    return j_pdsch.PdschConfig(**base)


PDSCH_CASES = {
    "4l_qam256": _j_pdsch(),
    "repetition": _j_pdsch(rb_start=10, rb_count=6, modulation="qpsk",
                           target_code_rate=0.1, tbs=296),
    "rv1": _j_pdsch(rv=1, modulation="qam64", nof_layers=2,
                    tbs=tbs_calc(24, 12, 24, "qam64", 0.5, 2)),
    "rv2": _j_pdsch(rv=2, tbs=tbs_calc(24, 12, 24, "qam256", 0.5, 4)),
    "rv3": _j_pdsch(rv=3, modulation="qam16", nof_layers=3,
                    tbs=tbs_calc(24, 12, 24, "qam16", 0.4, 3)),
}


def test_repetition_case_repeats():
    cfg = PDSCH_CASES["repetition"]
    seg = segment_tb(cfg.tbs, select_base_graph(cfg.tbs, cfg.target_code_rate))
    e = t_pdsch.rate_match_sizes(convert.config(cfg))
    assert min(e) > 2 * (seg.codeword_bits - seg.filler_bits)


@pytest.mark.parametrize("case", sorted(PDSCH_CASES))
def test_encode_transport_block(case):
    cfg = PDSCH_CASES[case]
    tb = np.random.default_rng(len(case)).integers(0, 2, cfg.tbs).astype(np.int8)
    ref, _ = j_pdsch.encode_transport_block(jnp.asarray(tb), cfg)
    out, _ = t_pdsch.encode_transport_block(torch.as_tensor(tb),
                                            convert.config(cfg))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", sorted(PDSCH_CASES))
def test_pdsch_process(case):
    """The whole PDSCH (K5 and K6 twins, DM-RS) into a grid that already
    holds other signals."""
    cfg = PDSCH_CASES[case]
    rng = np.random.default_rng(7 + len(case))
    tb = rng.integers(0, 2, cfg.tbs).astype(np.int8)
    grid = _cgauss(rng, (4, 14, 288))
    pilots = j_dmrs.pilot_values_for(j_pdsch.dmrs_config(cfg))
    ref = j_pdsch.process(jnp.asarray(grid), jnp.asarray(tb), cfg,
                          dmrs_cinits=jnp.asarray(pilots))
    out = t_pdsch.process(torch.as_tensor(grid.copy()), torch.as_tensor(tb),
                          convert.config(cfg),
                          dmrs_cinits=torch.as_tensor(pilots))
    _close(out, ref, atol=1e-6)


@pytest.mark.parametrize("tbs,rate", [(65576, 0.8), (3816, 0.3), (296, 0.1)])
def test_dlsch_encode_matches_jax(tbs, rate):
    """K5's twin: the JAX package's TB CRC, segmentation, CB CRC and
    encoder, without the 2Z punctured bits."""
    bg = select_base_graph(tbs, rate)
    seg = segment_tb(tbs, bg)
    tb = np.random.default_rng(tbs).integers(0, 2, tbs).astype(np.int8)
    poly = "crc24A" if seg.tb_crc_bits == 24 else "crc16"
    b = np.concatenate([tb, np.asarray(j_crc.crc(jnp.asarray(tb)[None],
                                                 poly))[0]])
    ppc = seg.cb_info_bits - seg.cb_crc_bits
    b = np.concatenate([b, np.zeros(ppc * seg.nof_codeblocks - len(b),
                                    np.int8)]).reshape(seg.nof_codeblocks, ppc)
    if seg.cb_crc_bits:
        b = np.concatenate([b, np.asarray(j_crc.crc(jnp.asarray(b),
                                                    "crc24B"))], axis=1)
    b = np.concatenate([b, np.zeros((seg.nof_codeblocks, seg.filler_bits),
                                    np.int8)], axis=1)
    ref = np.asarray(j_enc.encode(jnp.asarray(b), bg, seg.lifting_size))
    out = ldpc_encode.dlsch_encode(torch.as_tensor(tb), bg)
    np.testing.assert_array_equal(out.numpy(),
                                  ref[:, 2 * seg.lifting_size:])


def test_gold_words_pack_the_sequence():
    """K6's packed Gold words: bit g of the sequence is bit g % 32 of word
    g // 32."""
    words = gold.gold_words(0x4601 << 15 | 1, 1000).view(np.uint32)
    bits = (words[np.arange(1000) // 32] >> (np.arange(1000) % 32)) & 1
    np.testing.assert_array_equal(bits, gold_sequence_np(0x4601 << 15 | 1,
                                                         1000))


# -------------------------------------------------------------------- OFDM

@pytest.mark.parametrize("cp,mu,n,sis,fc,scale,lead", [
    (CyclicPrefix.NORMAL, 1, 512, 0, 3.5e9, 1.0, (4,)),
    (CyclicPrefix.NORMAL, 1, 512, 1, 3.5e9, 0.7, (2,)),
    (CyclicPrefix.NORMAL, 0, 256, 0, 1.8e9 + 7.5e3, 1.0, ()),
    (CyclicPrefix.EXTENDED, 2, 1024, 0, 0.0, 2.0, (2, 2)),
])
def test_modulate_slot_ref(cp, mu, n, sis, fc, scale, lead):
    nsym = 14 if cp is CyclicPrefix.NORMAL else 12
    grid = _cgauss(np.random.default_rng(n), lead + (nsym, 144))
    ref = j_ofdm.modulate_slot(jnp.asarray(grid), n, mu, cp, sis, fc, scale)
    out = t_ofdm.modulate_slot_ref(torch.as_tensor(grid), n, mu,
                                   convert.value(cp), sis, fc, scale)
    _close(out, ref, rtol=1e-4)


# ---------------------------------------------------------- the DL slot

J_CELL = j_slots.CellConfig(nof_ports=4, nof_rb=24, dft_size=512, numerology=1)
J_SSB = j_ssb.SsbConfig(phys_cell_id=1, ssb_idx=0, l_max=8, sfn=0,
                        first_symbol=2, first_subcarrier=24)
J_PDCCH = j_pdcch.PdcchConfig(
    coreset=j_pdcch.CoresetConfig(rb_start=0, nof_rb=24, start_symbol=0,
                                  duration=1),
    rnti=0x4601, aggregation_level=4, cce_index=0, payload_bits=60, n_id=1,
    n_id_data=1)
J_PDSCH = _j_pdsch(slot_in_frame=0)
# slot point -> with SSB; the odd slot runs the other CP layout.
SLOTS = {"ssb": (SlotPoint(1, 46), True), "plain": (SlotPoint(1, 48), False),
         "plain_odd": (SlotPoint(1, 47), False)}


def _request(slot, with_ssb):
    return DlTtiRequest(
        slot=slot,
        ssb=(dataclasses.replace(J_SSB, sfn=slot.sfn),) if with_ssb else (),
        pdcch=(dataclasses.replace(J_PDCCH, slot_in_frame=slot.slot_index),),
        pdsch=(dataclasses.replace(J_PDSCH, slot_in_frame=slot.slot_index),))


@pytest.fixture(scope="module", params=sorted(SLOTS))
def dl_slot(request):
    slot, with_ssb = SLOTS[request.param]
    plan, ctx = normalize_dl_plan(_request(slot, with_ssb))
    sis = slot.subframe_slot_index
    rng = np.random.default_rng(sis + 2 * with_ssb)
    mib = rng.integers(0, 2, 24).astype(np.int8)
    dci = rng.integers(0, 2, 60).astype(np.int8)
    tb = rng.integers(0, 2, J_PDSCH.tbs).astype(np.int8)
    j_args = ((jnp.asarray(mib),) if with_ssb else (), (jnp.asarray(dci),),
              (jnp.asarray(tb),), ctx)
    t_args = ((torch.as_tensor(mib),) if with_ssb else (),
              (torch.as_tensor(dci),), (torch.as_tensor(tb),),
              convert.slot_context(ctx, "cpu"))
    t_cell, t_plan = convert.config(J_CELL), convert.plan(plan)
    j_samples, j_grid = j_slots.dl_slot_fn(J_CELL, plan, sis)(*j_args)
    t_samples, t_grid = t_slots.dl_slot_fn(t_cell, t_plan, sis)(*t_args)
    return dict(
        j_samples=np.asarray(j_samples), j_grid=np.asarray(j_grid),
        j_only=np.asarray(j_slots.dl_slot_fn_samples(J_CELL, plan, sis)(*j_args)),
        t_samples=t_samples, t_grid=t_grid,
        t_only=t_slots.dl_slot_fn_samples(t_cell, t_plan, sis)(*t_args))


def test_dl_slot_grid(dl_slot):
    _close(dl_slot["t_grid"], dl_slot["j_grid"], atol=1e-5)


def test_dl_slot_samples(dl_slot):
    _close(dl_slot["t_samples"], dl_slot["j_samples"], rtol=1e-4)


def test_dl_slot_fn_samples(dl_slot):
    assert torch.equal(dl_slot["t_only"], dl_slot["t_samples"])
    _close(dl_slot["t_only"], dl_slot["j_only"], rtol=1e-4)


# ------------------------------------------------- the flagship DL slot

@pytest.mark.slow
def test_flagship_dl_slot_on_cpu_twins():
    """The flagship DL slot (273 RB, 4096-point FFT, TBS 835584) on the CPU
    twins: an SSB slot and a plain slot modulate to finite samples; the
    plain slot is received back with its TB CRC passing; the kernel cases
    the card compares give equal results here (both sides are twins)."""
    slots = flagship.make_dl_slots(2, np.random.default_rng(0), "cpu")
    outs = [flagship.dl_program(s["with_ssb"])(*s["args"]) for s in slots]
    for out in outs:
        assert out.shape == (4, 61440)
        assert bool(torch.isfinite(torch.view_as_real(out)).all())
    res = flagship.dl_loopback(outs[1])
    assert bool(res.tb_crc_ok)
    assert torch.equal(res.tb_bits, slots[1]["tb"])
    for fn, ref_fn, args in flagship.dl_kernel_cases(slots[0]).values():
        assert torch.equal(fn(*args), ref_fn(*args))
