"""The port's split-6 DU-low (fapi/transport.py, config_messages.py,
bufferer.py, apps/du_low.py) against the JAX package's, on the CPU.

The wire is the JAX package's: the port's codec writes the same bytes for
the same messages and results and decodes the JAX package's names onto its
own classes without importing the JAX package; the JAX FapiClient drives
the port's serve_phy (on the CPU twins) over TCP through the scenarios of
tests/test_split6.py and tests/test_fapi_config_plane.py, and gets the
SlotResults the JAX conductor gives for the same requests (bits, CRCs and
decisions exact, floats within rtol 1e-3 of the JAX conductor's, as
convert.slot_results compares them); the port's FapiClient drives the JAX
serve_phy.  CellManager and MessageBufferer follow the JAX ones message for
message.  Small cells (1 port, 12 or 24 RB), a few slots.
"""

import dataclasses
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_tpu.fapi import bufferer as j_buf
from srsran_tpu.fapi import config_messages as j_cm
from srsran_tpu.fapi import conductor as j_cond
from srsran_tpu.fapi import transport as j_tr
from srsran_tpu.fapi import messages as j_msgs
from srsran_tpu.fapi.messages import (DlTtiRequest, TxDataRequest,
                                      UlTtiRequest)
from srsran_tpu.phy.slot_programs import CellConfig
from srsran_tpu.phy.upper.csi_rs import CsiRsConfig
from srsran_tpu.phy.upper.pdcch import CoresetConfig, PdcchConfig
from srsran_tpu.phy.upper import pucch as j_pucch
from srsran_tpu.phy.upper.pdsch import PdschConfig, PdschPtrs
from srsran_tpu.phy.upper.prach import PrachConfig
from srsran_tpu.phy.upper.ptrs_prs import PrsConfig
from srsran_tpu.phy.upper.pusch import PuschConfig
from srsran_tpu.phy.upper.srs import SrsConfig
from srsran_tpu.phy.upper.ssb import SsbConfig
from srsran_tpu.ran.precoding_codebooks import PrecodingConfig
from srsran_tpu.ran.slot_point import SlotPoint
from srsran_tpu.ran.uci_on_pusch import UciOnPuschConfig

from srsran_tpu_torch import convert
from srsran_tpu_torch.apps import du_low
from srsran_tpu_torch.fapi import bufferer as t_buf
from srsran_tpu_torch.fapi import config_messages as t_cm
from srsran_tpu_torch.fapi import transport as t_tr

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def _cell(nof_rb=12):
    dft = 256 if nof_rb * 12 <= 256 else 512
    return CellConfig(nof_ports=1, nof_rb=nof_rb, dft_size=dft, numerology=1,
                      center_freq_hz=0.0)


def _pusch(nof_rb=12):
    tbs = 1320 if nof_rb == 12 else 2400
    return PuschConfig(rnti=0x11, rb_start=0, rb_count=nof_rb, first_symbol=0,
                       nof_symbols=14, modulation="qam16",
                       target_code_rate=0.5, tbs=tbs, nof_layers=1,
                       n_id=0, dmrs_symbols=(2, 7, 11))


def _pdsch(pu, **kw):
    return PdschConfig(rnti=pu.rnti, rb_start=0, rb_count=pu.rb_count,
                       first_symbol=0, nof_symbols=14, modulation="qam16",
                       target_code_rate=0.5, tbs=pu.tbs, nof_layers=1,
                       n_id=0, dmrs_symbols=(2, 7, 11), **kw)


def _dumps(wire) -> str:
    return json.dumps(wire)


# ------------------------------------------------------------------ codec

def _jax_messages():
    """JAX-side objects of every kind that crosses the wire."""
    slot = SlotPoint(1, 37)
    cell = CellConfig(nof_ports=2, nof_rb=24, dft_size=512, numerology=1)
    pdcch = PdcchConfig(coreset=CoresetConfig(rb_start=0, nof_rb=24,
                                              start_symbol=0, duration=1),
                        rnti=0x4601, aggregation_level=2, cce_index=0,
                        payload_bits=40, n_id=1, n_id_data=1)
    dl = DlTtiRequest(
        slot=slot, ssb=(SsbConfig(phys_cell_id=1, ssb_idx=0, l_max=8),),
        pdcch=(pdcch,),
        pdsch=(_pdsch(_pusch(24), ptrs=PdschPtrs(time_density=2)),),
        csi_rs=(CsiRsConfig(row=4, rb_start=0, rb_count=24, symbol=13),),
        prs=(PrsConfig(rb_start=0, rb_count=24, first_symbol=2, nof_symbols=4,
                       comb_size=4, comb_offset=1, n_id_prs=3),))
    tx = TxDataRequest(slot=slot, pdsch_payloads=(np.arange(8, dtype=np.uint8),),
                       pdcch_payloads=(np.ones(40, np.int8),),
                       ssb_mib=(np.zeros(24, np.int8),))
    ul = UlTtiRequest(slot=slot, pusch=(_pusch(),), pusch_harq=((3, True),))
    f3 = j_pucch.PucchF3Config(rb_start=4, nof_rb=2, start_symbol=0,
                               nof_symbols=10, rnti=0x31, n_id=17,
                               n_id_hopping=17, nof_uci_bits=16)
    ul_all = UlTtiRequest(
        slot=slot,
        pusch=(dataclasses.replace(_pusch(24), uci=UciOnPuschConfig(
            o_ack=2, o_csi1=6)),),
        pucch_f0=(j_pucch.PucchF0Config(
            prb=20, start_symbol=11, nof_symbols=2, initial_cyclic_shift=0,
            n_id=1, nof_harq_bits=2, sr_opportunity=True),),
        pucch_f1=(j_pucch.PucchF1Config(
            prb=0, start_symbol=0, nof_symbols=14, initial_cyclic_shift=0,
            time_domain_occ=0, n_id=1),),
        pucch_f2=(j_pucch.PucchF2Config(
            rb_start=21, nof_rb=1, start_symbol=11, nof_symbols=2, rnti=0x18,
            n_id=1, n_id0=1, nof_uci_bits=6),),
        pucch_f3=(f3,),
        pucch_f4=(dataclasses.replace(f3, nof_rb=1, occ_length=2,
                                      occ_index=1),),
        prach=(PrachConfig(format="B4", root_sequence_index=39,
                           zero_correlation_zone=10, ra_scs_hz=30_000),),
        srs=(SrsConfig(rb_start=20, rb_count=4, start_symbol=13,
                       nof_symbols=1, comb=2, comb_offset=0, cyclic_shift=0,
                       nof_ports=1, sequence_id=1, numerology=1, rnti=0x17),))
    precoded = DlTtiRequest(slot=slot, pdsch=(dataclasses.replace(
        _pdsch(_pusch(24)), nof_layers=2,
        precoding=PrecodingConfig(prg_size=4, pm_indices=(1,) * 6)),))
    f32 = np.float32
    results = j_msgs.SlotResults(
        slot=slot,
        crc=[j_msgs.CrcIndicationPdu(
            rnti=0x11, tb_crc_ok=True, timing_advance_s=1.5e-7, snr_db=22.5,
            rsrp=0.7, cfo_hz=12.0, evm=0.01, nof_ldpc_iterations=2.0,
            snr_port_db=np.array([21.0, 23.5], f32),
            rsrp_port=np.array([0.6, 0.8], f32),
            epre_port=np.array([0.7, 0.9], f32))],
        rx_data=[j_msgs.RxDataIndicationPdu(
            rnti=0x11, payload=np.array([1, 0, 1], np.uint8))],
        uci=[j_msgs.UciIndicationPdu(
            rnti=0x18, detected=True, harq_bits=np.array([1, 0], np.uint8),
            csi_bits=None, metric=3.5, sr_bit=1),
            j_msgs.UciIndicationPdu(
                rnti=0x11, detected=True, harq_bits=None,
                csi_bits=np.array([1, 1, 0], np.uint8), metric=1.0,
                csi2_bits=np.array([0, 1], np.uint8), source="pusch")],
        rach=[j_msgs.RachIndicationPreamble(preamble_index=21,
                                            timing_advance_s=2e-6,
                                            metric=8.25)],
        srs=[j_msgs.SrsIndicationPdu(
            rnti=0x17, timing_advance_s=0.0, snr_db=15.0,
            wideband_h=np.array([[1 + 2j], [0.5 - 1j]], np.complex64))])
    return [cell, dl, tx, ul, ul_all, precoded, results,
            j_cm.ParamRequest(), j_cm.ParamResponse(),
            j_cm.ConfigRequest(cell=cell), j_cm.ConfigResponse(
                error_code=j_cm.ErrorCode.MSG_INVALID_CONFIG,
                invalid_params=("cell.dft_size",)),
            j_cm.StartRequest(), j_cm.StopRequest(), j_cm.StopIndication(),
            j_cm.ErrorIndication(3, 7, "ul_tti", j_cm.ErrorCode.OUT_OF_SYNC,
                                 "late"),
            {"dl": dl, "tx": tx, "want_samples": True},
            np.arange(6, dtype=np.complex64), (1, 2.5, None, [True, "x"])]


def test_codec_roundtrip_messages():
    cell = convert.config(_cell())
    pu = convert.config(_pusch())
    ul = convert.requests(UlTtiRequest(slot=SlotPoint(1, 37), pusch=(_pusch(),),
                                       pusch_harq=((3, True),)))
    for obj in (cell, pu, ul, np.arange(6, dtype=np.complex64),
                {"a": (1, 2.5, None), "b": [True, "x"]}):
        back = t_tr.decode(t_tr.encode(obj))
        if isinstance(obj, np.ndarray):
            np.testing.assert_array_equal(back, obj)
        else:
            assert back == obj, (obj, back)
    t = torch.arange(4, dtype=torch.float32)
    np.testing.assert_array_equal(t_tr.decode(t_tr.encode(t)), t.numpy())


@pytest.mark.parametrize("i", range(len(_jax_messages())))
def test_codec_bytes_equal_jax(i):
    """The port decodes the JAX bytes onto its own classes and encodes
    them back to the same bytes; the JAX codec decodes the port's."""
    obj = _jax_messages()[i]
    wire = j_tr.encode(obj)
    port_obj = t_tr.decode(json.loads(_dumps(wire)))
    for node in _dataclasses(port_obj):
        assert type(node).__module__.startswith("srsran_tpu_torch."), node
    assert _dumps(t_tr.encode(port_obj)) == _dumps(wire)
    back = j_tr.decode(json.loads(_dumps(t_tr.encode(port_obj))))
    assert _dumps(j_tr.encode(back)) == _dumps(wire)


def _dataclasses(obj):
    if dataclasses.is_dataclass(obj):
        yield obj
        for f in dataclasses.fields(obj):
            yield from _dataclasses(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _dataclasses(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _dataclasses(x)


@pytest.mark.parametrize("spec", [
    "subprocess:Popen", "os:system", "srsran_tpu_torch.fapi.messages:SlotResults",
    "builtins:dict", "srsran_tpu.fapi.transport:FapiClient"])
def test_codec_refuses_foreign_classes(spec):
    with pytest.raises((ValueError, TypeError)):
        t_tr.decode({"__dc__": spec, "f": {}})


_DECODE_BLOCKED = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["srsran_tpu"] = None
from srsran_tpu_torch.fapi import transport
wire = json.loads(sys.stdin.read())
obj = transport.decode(wire)
assert type(obj).__module__ == "srsran_tpu_torch.fapi.messages", type(obj)
assert json.dumps(transport.encode(obj)) == json.dumps(wire)
assert not [m for m in sys.modules if m.startswith("srsran_tpu.")]
print(type(obj).__name__)
"""


def test_decode_with_jax_package_blocked():
    dl = _jax_messages()[1]
    proc = subprocess.run([sys.executable, "-c", _DECODE_BLOCKED], cwd=REPO,
                          input=_dumps(j_tr.encode(dl)), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "DlTtiRequest"


# ----------------------------------------------- config plane, bufferer

def _manager_script(cm):
    cell = _cell()
    seq = [cm.ParamRequest(), ("gate", "dl_tti", SlotPoint(1, 0)),
           cm.ConfigRequest(cell=CellConfig(nof_ports=1, nof_rb=100,
                                            dft_size=256, numerology=1)),
           cm.StartRequest(), cm.StopRequest(),
           cm.ConfigRequest(cell=cell), ("gate", "dl_tti", SlotPoint(1, 0)),
           cm.StartRequest(), ("gate", "ul_tti", SlotPoint(1, 100)),
           ("gate", "ul_tti", SlotPoint(1, 96)),
           ("gate", "ul_tti", SlotPoint(1, 90)),
           ("gate", "dl_tti", SlotPoint(1, 20479)),
           cm.ConfigRequest(cell=_cell(24)), cm.StartRequest(),
           cm.StopRequest(), cm.ConfigRequest(cell=_cell(24)),
           cm.StartRequest()]
    return seq


def test_cell_manager_matches_jax():
    """The same message sequence through both managers (with a stand-in
    conductor factory): the same replies, states and made conductors."""
    made = {"j": [], "t": []}
    jm = j_cm.CellManager(conductor_factory=lambda c: made["j"].append(c))
    tm = t_cm.CellManager(conductor_factory=lambda c: made["t"].append(c))
    for jmsg in _manager_script(j_cm):
        if isinstance(jmsg, tuple):
            _, mid, slot = jmsg
            jr = jm.gate_slot(mid, slot)
            tr = tm.gate_slot(mid, convert.config(slot))
        else:
            jr = jm.handle_config_msg(jmsg)
            tr = tm.handle_config_msg(t_tr.decode(json.loads(_dumps(
                j_tr.encode(jmsg)))))
        assert _dumps(t_tr.encode(tr)) == _dumps(j_tr.encode(jr)), jmsg
        assert tm.state.name == jm.state.name
    assert _dumps(t_tr.encode(made["t"])) == _dumps(j_tr.encode(made["j"]))
    assert len(made["t"]) == 2


def test_message_bufferer_matches_jax():
    jb, tb = j_buf.MessageBufferer(3), t_buf.MessageBufferer(3)
    events = [("tick", 10), ("push", "dl", 11), ("push", "ul", 13),
              ("push", "dl", 14), ("push", "ul", 9), ("tick", 11),
              ("push", "dl", 12), ("tick", 13), ("tick", 14),
              ("push", "dl", 20479), ("tick", 20479)]
    for ev in events:
        if ev[0] == "tick":
            a = jb.tick(SlotPoint(1, ev[1]))
            b = tb.tick(convert.config(SlotPoint(1, ev[1])))
            assert a == b, ev
        else:
            a = jb.push(ev[1], SlotPoint(1, ev[2]), ev[2])
            b = tb.push(ev[1], convert.config(SlotPoint(1, ev[2])), ev[2])
            assert a == b, ev
    assert [(e.slot.count, e.kind, e.delta) for e in tb.errors] == \
        [(e.slot.count, e.kind, e.delta) for e in jb.errors]
    assert len(tb.errors) >= 2


# ------------------------------------------------------------- transport

def _start(serve, **kw):
    box = {}
    ready = threading.Event()

    def cb(port):
        box["port"] = port
        ready.set()

    srv = threading.Thread(target=serve, kwargs=dict(ready_cb=cb, **kw),
                           daemon=True)
    srv.start()
    assert ready.wait(30.0)
    return srv, box["port"]


def _port_server():
    return _start(t_tr.serve_phy, device="cpu")


def _jax_reference(cell, slots):
    """The JAX conductor's SlotResults for (dl, tx, ul) slots, each UL fed
    the DL samples back (as the split-6 tests loop them)."""
    cond = j_cond.SlotConductor(cell)
    out = []
    for dl, tx, ul in slots:
        samples, _ = cond.process_dl(dl, tx)
        out.append(cond.process_ul(ul, samples).resolve())
    return out


def _loop_slots(nof_rb, counts, seed=2):
    pu = _pusch(nof_rb)
    tx_cfg = _pdsch(pu)
    payload = np.random.default_rng(seed).integers(0, 2, pu.tbs).astype(
        np.int8)
    slots = []
    for c in counts:
        slot = SlotPoint(1, c)
        slots.append((DlTtiRequest(slot=slot, pdsch=(tx_cfg,)),
                      TxDataRequest(slot=slot, pdsch_payloads=(payload,)),
                      UlTtiRequest(slot=slot, pusch=(pu,))))
    return slots, payload


def _run_slot(cli, dl, tx, ul):
    samples = cli.dl_tti(dl, tx, want_samples=True)
    if isinstance(samples, j_cm.ErrorIndication):
        return samples
    cli.rx_samples(samples)
    return cli.ul_tti(ul)


def test_jax_client_drives_port_server():
    """tests/test_split6.py's drive: config, a DL slot looped back as the
    UL, CRC ok with the exact payload -- and the SlotResults equal the JAX
    conductor's."""
    srv, port = _port_server()
    cli = j_tr.FapiClient("127.0.0.1", port)
    cli.configure(_cell())
    slots, payload = _loop_slots(12, [0, 2])
    got = [_run_slot(cli, *s) for s in slots]
    cli.stop()
    srv.join(30.0)
    for res, ref in zip(got, _jax_reference(_cell(), slots)):
        assert type(res).__module__ == "srsran_tpu.fapi.messages"
        assert res.crc[0].tb_crc_ok
        np.testing.assert_array_equal(res.rx_data[0].payload.astype(np.int8),
                                      payload)
        convert.slot_results(ref, res, rtol=1e-3)


def test_jax_client_pipelined_indications():
    """tests/test_split6.py's pipelined case: 5 non-blocking UL slots,
    resolved 2 behind the launch front and pushed; flush drains the
    tail."""
    srv, port = _port_server()
    cli = j_tr.FapiClient("127.0.0.1", port)
    cli.configure(_cell())
    slots, payload = _loop_slots(12, [2 * k for k in range(5)], seed=5)
    for dl, tx, ul in slots:
        cli.rx_samples(cli.dl_tti(dl, tx, want_samples=True))
        cli.ul_tti_nb(ul)
    results = cli.flush()
    cli.stop()
    srv.join(30.0)
    assert sorted(r.slot.count for r in results) == [2 * k for k in range(5)]
    for r in results:
        assert r.crc[0].tb_crc_ok
        np.testing.assert_array_equal(r.rx_data[0].payload.astype(np.int8),
                                      payload)


def test_jax_client_config_plane_reconfig_and_window():
    """tests/test_fapi_config_plane.py's drive of the port's server: param,
    config, start; a slot; a slot far behind the front (OUT_OF_SYNC); a
    bandwidth reconfiguration without a restart; a slot of the new cell."""
    srv, port = _port_server()
    cli = j_tr.FapiClient("127.0.0.1", port)
    p = cli.config_msg(j_cm.ParamRequest())
    assert isinstance(p, j_cm.ParamResponse) and p.max_dl_layers == 4
    r = cli.config_msg(j_cm.ConfigRequest(cell=_cell(12)))
    assert r.error_code is j_cm.ErrorCode.MSG_OK
    assert cli.config_msg(j_cm.StartRequest()) is None
    bad = cli.config_msg(j_cm.ConfigRequest(cell=_cell(24)))
    assert bad.error_code is j_cm.ErrorCode.MSG_INVALID_STATE
    slots, _ = _loop_slots(12, [50])
    ref = _jax_reference(_cell(12), slots)[0]
    convert.slot_results(ref, _run_slot(cli, *slots[0]), rtol=1e-3)
    late, _ = _loop_slots(12, [40])
    err = _run_slot(cli, *late[0])
    assert isinstance(err, j_cm.ErrorIndication)
    assert err.error_code is j_cm.ErrorCode.OUT_OF_SYNC
    assert (err.sfn, err.slot, err.message_id) == (2, 0, "dl_tti")
    cli.reconfigure(_cell(24))
    slots24, _ = _loop_slots(24, [60])
    res = _run_slot(cli, *slots24[0])
    assert res.crc[0].tb_crc_ok
    convert.slot_results(_jax_reference(_cell(24), slots24)[0], res,
                         rtol=1e-3)
    cli.stop()
    srv.join(30.0)


def test_jax_client_slot_before_config_yields_error_indication():
    srv, port = _port_server()
    cli = j_tr.FapiClient("127.0.0.1", port)
    slots, _ = _loop_slots(12, [0])
    res = _run_slot(cli, *slots[0])
    assert isinstance(res, j_cm.ErrorIndication)
    assert res.error_code is j_cm.ErrorCode.MSG_INVALID_STATE
    cli.stop()
    srv.join(30.0)


def test_port_client_drives_jax_server():
    """The port's FapiClient against the JAX package's serve_phy: the port's
    classes on the way out, the JAX server's results decoded as the port's
    SlotResults."""
    srv, port = _start(j_tr.serve_phy)
    cli = t_tr.FapiClient("127.0.0.1", port)
    assert cli.config_msg(t_cm.ConfigRequest(
        cell=convert.config(_cell()))).error_code is t_cm.ErrorCode.MSG_OK
    assert cli.config_msg(t_cm.StartRequest()) is None
    slots, payload = _loop_slots(12, [4])
    dl, tx, ul = (convert.requests(m) for m in slots[0])
    samples = cli.dl_tti(dl, tx, want_samples=True)
    cli.rx_samples(samples)
    res = cli.ul_tti(ul)
    cli.stop()
    srv.join(30.0)
    assert type(res).__module__ == "srsran_tpu_torch.fapi.messages"
    assert res.crc[0].tb_crc_ok
    np.testing.assert_array_equal(res.rx_data[0].payload.astype(np.int8),
                                  payload)


@pytest.mark.parametrize("modulation", ["bpsk", "pi2bpsk"])
def test_port_server_answers_bpsk_ul_tti(modulation):
    """A ul_tti whose PUSCH is BPSK or pi/2-BPSK without transform
    precoding (the JAX package decodes it; on the card the port's K3
    demaps it): the UE's samples sent by rx_samples, then the ul_tti, to
    the port's serve_phy through the JAX client.  CRC ok with the exact
    payload, the SlotResults equal the JAX conductor's, and the server
    then stops cleanly."""
    from srsran_tpu_torch.ops import ofdm
    from srsran_tpu_torch.phy.upper import ue_tx
    pu = dataclasses.replace(_pusch(), modulation=modulation, tbs=640)
    payload = np.random.default_rng(9).integers(0, 2, pu.tbs).astype(np.int8)
    grid = ue_tx.pusch_transmit(convert.config(pu), payload, nof_sc=144,
                                device="cpu")
    samples = ofdm.modulate_slot(grid, 256, 1).numpy()
    ul = UlTtiRequest(slot=SlotPoint(1, 2), pusch=(pu,))
    srv, port = _port_server()
    cli = j_tr.FapiClient("127.0.0.1", port)
    cli.configure(_cell())
    cli.rx_samples(samples)
    res = cli.ul_tti(ul)
    cli.stop()
    srv.join(30.0)
    assert not srv.is_alive()
    assert res.crc[0].tb_crc_ok
    np.testing.assert_array_equal(res.rx_data[0].payload.astype(np.int8),
                                  payload)
    ref = j_cond.SlotConductor(_cell()).process_ul(ul, samples).resolve()
    convert.slot_results(ref, res, rtol=1e-3)


def test_rx_samples_with_prach_captures():
    """This package's rx_samples form: the samples and the PRACH occasions'
    captures, moved to the conductor's device."""
    body = {"samples": np.ones((1, 8), np.complex64),
            "prach_fd": (np.zeros((1, 2, 3), np.complex64),)}
    samples, prach = t_tr._rx_body(t_tr.decode(json.loads(_dumps(
        t_tr.encode(body)))), torch.device("cpu"))
    assert samples.shape == (1, 8) and prach[0].shape == (1, 2, 3)
    samples, prach = t_tr._rx_body(np.ones((1, 8), np.complex64), "cpu")
    assert prach == ()


# ------------------------------------------------------------------- app

def test_du_low_main_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        du_low.main(["--port", "0", "--set", "cell.nof_rb=12"])


def test_serve_phy_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tr.serve_phy(port=0)
