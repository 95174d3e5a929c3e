"""The host side of K27 (csrc/dl_control_map.cu) and K35 (csrc/llr.cu) on
the CPU: K27's launch plan field by field, a numpy model of the kernel run
on that plan against the twins and the JAX package, the ballot pack of the
payload against ``pack_rows``, and K35's launch struct.

The model (:func:`emulate`) does what a K27 thread does with the plan's
tables -- its RE's entry, the payload words as the CTA's warps ballot
them (bit 32 w + j of the payload, the constant bit 1 at n0 + n1), popc
parity against the RE's interleaved rows, QPSK times the amplitude, the
values of every source in plan order on the ports each spans, then a
+0.0 where a PDU's rectangle has a hole -- in float32, so an error in the
plan shows without a card.  It is held bit for bit (``view(int32)``: -0.0
differs from +0.0) to the twins' dense adds.
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.phy.upper import pdcch as j_pdcch
from srsran_tpu.phy.upper import ssb as j_ssb

from srsran_tpu_torch import convert, flagship
from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import dl_control, llr
from srsran_tpu_torch.phy.upper import pdcch, ssb

torch.set_num_threads(2)

CPU = torch.device("cpu")
MAX = _build.CONTROL_MAX_PDUS


def _launches(grid, items):
    """[(host PDUs, the chunk's bits, its pilots, plan)] per launch."""
    lead = tuple(grid.shape[:-3])
    out = []
    for c in range(0, len(items), MAX):
        chunk = items[c:c + MAX]
        bits = [tuple(dl_control._int8_bits(t) for t in it.bits)
                for it in chunk]
        pilots = [it.pilots for it in chunk]
        pdus = [dl_control.host_pdu(it, b, p, lead)
                for it, b, p in zip(chunk, bits, pilots)]
        out.append((pdus, bits, pilots,
                    dl_control._control_params(pdus, tuple(grid.shape))))
    return out


def ballot_words(bits: np.ndarray, words: int) -> np.ndarray:
    """The payload words as a CTA's warps form them: warp w's lane j holds
    bit 32 w + j (0 past the bits), ``__ballot_sync`` sets bit j of the
    word from lane j."""
    lanes = np.zeros(32 * words, np.uint64)
    lanes[:bits.size] = bits & 1
    return np.array([int(np.sum(lanes[32 * w:32 * w + 32]
                                << np.arange(32, dtype=np.uint64)))
                     for w in range(words)], np.uint64)


def _payload(d, bits, s: int) -> np.ndarray:
    """Slot s's payload bits of one PDU with the constant bit after them."""
    def row(t):
        a = t.numpy()
        return a[s] if a.ndim > 1 else a
    v = row(bits[0]).astype(np.int64) & 1
    if d.n1:
        v = np.concatenate([v, (row(bits[1]) ^ row(bits[2])).astype(np.int64)
                            & 1])
    return np.concatenate([v, [1]])


def emulate(grid: torch.Tensor, items) -> torch.Tensor:
    """K27 on its plan, in numpy (see the module's docstring)."""
    g = grid.numpy().copy()
    f32 = np.float32
    for pdus, bits, pilots, (params, table, rows, consts, _) in \
            _launches(grid, items):
        a = params.args
        gv = g.reshape(a.nslots, a.P, a.S * a.K)
        for s in range(a.nslots):
            pay = {u: ballot_words(_payload(d, bits[u], s), a.pdu[u].words)
                   for u, d in enumerate(pdus)}

            def value(y, w):
                kind, u = y & 3, (y >> 2) & 15
                amp = f32(a.pdu[u].amplitude)
                if kind == dl_control.KIND_DATA:
                    nw = (y >> 8) & 15
                    r = rows[w:w + 2 * nw].astype(np.uint64)
                    b = [sum(bin(int(pay[u][i] & r[2 * i + q])).count("1")
                             for i in range(nw)) & 1 for q in (0, 1)]
                    qp = f32(a.qpsk)
                    return tuple(f32(-qp if x else qp) * amp for x in b)
                if kind == dl_control.KIND_PILOT:
                    p = pilots[u].numpy()
                    x = (p[s] if p.ndim > 1 else p)[w]
                    return f32(x.real) * amp, f32(x.imag) * amp
                return f32(consts[w].real), f32(consts[w].imag)

            for x, y, z, w in table[:a.nitems].astype(np.int64):
                more = table[a.nitems + (z >> 8):][:(z >> 3) & 31]
                srcs = [(y, w)] + [(int(m[1]), int(m[3])) for m in more]
                for p in range(a.P if z & 4 else 1):
                    re, im = f32(gv[s, p, x].real), f32(gv[s, p, x].imag)
                    for yy, ww in srcs:
                        if yy & 3 and ((yy >> 6) & 1 or p == 0):
                            vr, vi = value(yy, ww)
                            re, im = f32(re + vr), f32(im + vi)
                    if z & 2 or (z & 1 and p == 0):
                        re, im = f32(re + f32(0)), f32(im + f32(0))
                    gv[s, p, x] = np.complex64(complex(re, im))
    return torch.from_numpy(g)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(torch.view_as_real(a).view(torch.int32),
                       torch.view_as_real(b).view(torch.int32))


@pytest.fixture(scope="module")
def cases():
    return flagship.du_kernel_cases(np.random.default_rng(27), CPU)


K27_CASES = ["control_map", "control_map_al1", "control_map_al2",
             "control_map_al4", "control_map_al16", "control_map_ssb_static",
             "control_map_many", "control_map_overlap", "control_map_negzero"]


@pytest.mark.parametrize("name", K27_CASES + [
    n + "_b4" for n in K27_CASES if n != "control_map_negzero"])
def test_model_bit_exact_to_twins(cases, name):
    """The kernel's model on its plan equals the twins bit for bit: the
    flagship slot A, each aggregation level, the static SSB, the many-UE
    slot (two launches), overlapping PDCCHs, a grid of -0.0 (the holes'
    +0.0), and each with a slot axis of 4."""
    _, ref, (grid, inputs, items_fn) = cases[name]
    got = emulate(grid, items_fn(grid, inputs))
    assert _bits_equal(got, ref(grid, inputs, items_fn))


def test_negzero_needs_the_holes(cases):
    """On a grid of -0.0 the twins leave +0.0 under every hole of a patch
    rectangle: dropping the holes' zero (z bits 0-1) breaks bit-equality,
    so the -0.0 case pins the hole rule."""
    _, ref, (grid, inputs, items_fn) = cases["control_map_negzero"]
    items = items_fn(grid, inputs)
    want = ref(grid, inputs, items_fn)
    plan = _launches(grid, items)[0][3]
    holes = plan[1][:plan[0].args.nitems, 2] & 3
    assert holes.any()
    assert not _bits_equal(grid, want)          # the twins touched -0.0
    pos = plan[1][:plan[0].args.nitems, 0][holes != 0]
    flat = torch.view_as_real(want[0].reshape(-1)).view(torch.int32)
    assert (flat[pos] == 0).all()               # +0.0 under the holes


@pytest.mark.parametrize("name,launches", [
    ("control_map", 1), ("control_map_b4", 1), ("control_map_many", 2),
    ("control_map_overlap", 1)])
def test_control_params(cases, name, launches):
    """K27's plan field by field: every RE a PDU's rectangle covers is one
    item exactly once, each RE's sources are that PDU's patch entries in
    plan order, the tiles' masks name the PDUs whose payload they read,
    and every field fits its limit."""
    _, _, (grid, inputs, items_fn) = cases[name]
    items = items_fn(grid, inputs)
    plans = _launches(grid, items)
    assert len(plans) == launches
    *lead, P, S, K = grid.shape
    for c, (pdus, bits, pilots, plan) in enumerate(plans):
        params, table, rows, consts, tiles = plan
        a = params.args
        assert (a.npdus, a.nslots, a.P, a.S, a.K) == (
            len(pdus), lead[0] if lead else 1, P, S, K)
        assert a.grid_stride == P * S * K and a.qpsk == dl_control.QPSK
        assert a.ntiles == -(-a.nitems // dl_control.THREADS) == tiles.size
        assert ctypes.sizeof(_build.ControlArgs) < 4096   # kernel params
        main = table[:a.nitems]
        assert np.unique(main[:, 0]).size == a.nitems     # one item an RE
        want = {}                  # RE -> [(u, kind, arg, every port)]
        nptr = 0
        for u, d in enumerate(pdus):
            pd = a.pdu[u]
            assert pd.words == dl_control.row_words(d.n0 + d.n1)
            assert d.n0 + d.n1 < 32 * pd.words <= 32 * dl_control.MAX_WORDS
            assert (pd.n0, pd.n1) == (bits[u][0].shape[-1],
                                      bits[u][1].shape[-1] if d.n1 else 0)
            assert pd.amplitude == np.float32(d.amplitude)
            assert (pd.stride0, pd.stride1, pd.stride2,
                    pd.pilot_stride) == d.strides
            has = [True, d.n1 > 0, d.n1 > 0, pilots[u] is not None]
            assert list(params.ptr[u]) == [
                nptr + sum(has[:j]) if h else -1 for j, h in enumerate(has)]
            nptr += sum(has)
            idx = np.asarray(d.index).reshape(-1)
            base = (None if d.base is None
                    else np.asarray(d.base).reshape(-1))
            for r in range(d.h * d.w):
                re = (d.l0 + r // d.w) * K + d.sc0 + r % d.w
                i = int(idx[r])
                if i == 0 and (base is None or base[r] == 0):
                    src = (u, 0, 0)
                elif i == 0:
                    src = (u, dl_control.KIND_CONST, complex(base[r]))
                elif i <= d.nd:
                    src = (u, dl_control.KIND_DATA, i - 1)
                else:
                    src = (u, dl_control.KIND_PILOT, i - 1 - d.nd)
                want.setdefault(re, []).append(src + (d.all_ports,))
        assert set(want) == set(main[:, 0].tolist())      # every RE, once
        first_row = np.cumsum([0] + [
            max(2 * a.pdu[u].words, 4) * d.nd for u, d in enumerate(pdus)])
        for t, (x, y, z, w) in enumerate(main.astype(np.int64)):
            srcs = [(y, w)] if y & 3 else []
            srcs += [(int(m[1]), int(m[3])) for m in
                     table[a.nitems + (z >> 8):][:(z >> 3) & 31]]
            got = []
            for yy, ww in srcs:
                u, kind = (yy >> 2) & 15, yy & 3
                assert (yy >> 6) & 1 == pdus[u].all_ports
                assert (yy >> 8) & 15 == a.pdu[u].words
                if kind == dl_control.KIND_DATA:
                    step = max(2 * a.pdu[u].words, 4)
                    assert (ww - first_row[u]) % step == 0
                    arg = (ww - first_row[u]) // step
                    assert tiles[t // dl_control.THREADS] >> u & 1
                elif kind == dl_control.KIND_CONST:
                    arg = complex(consts[ww])
                else:
                    arg = ww
                got.append((u, kind, arg))
            assert got == [s[:3] for s in want[x] if s[1]]
            assert [g[0] for g in got] == sorted(g[0] for g in got)
            holes = [s for s in want[x] if not s[1]]
            assert z & 1 == any(not s[3] for s in holes)
            assert (z >> 1) & 1 == any(s[3] for s in holes)
            assert (z >> 2) & 1 == any(s[3] for s in want[x])
        assert (tiles >> len(pdus) == 0).all()
    if name == "control_map_overlap":                 # further sources
        params, table = plans[0][3][:2]
        assert (table[:params.args.nitems, 2] >> 3 & 31).any()


def test_control_params_refuse():
    """Payloads past 255 bits, a patch outside the grid and more PDUs than
    a launch takes are refused on the host."""
    grid = torch.zeros((4, 14, 576), dtype=torch.complex64)
    pay = torch.zeros(60, dtype=torch.int8)
    it = pdcch.control_item(grid, pay, flagship.PDCCH)
    d = dl_control.host_pdu(it, (pay,), it.pilots, ())
    with pytest.raises(ValueError):
        dl_control._control_params([d] * (MAX + 1), tuple(grid.shape))
    with pytest.raises(ValueError):
        dl_control._control_params([dataclasses.replace(d, sc0=100)],
                                   tuple(grid.shape))
    with pytest.raises(ValueError):
        dl_control.row_words(256)
    assert [dl_control.row_words(n) for n in (0, 31, 32, 63, 64, 100, 255)] \
        == [1, 1, 2, 2, 4, 4, 8]


@pytest.mark.parametrize("form", ["dci", "pbch_ctx", "pbch_static"])
def test_ballot_pack_rows(form):
    """The ballot's payload words against ``pack_rows`` and the row table:
    popc parity of the words with the constant bit and each RE's I and Q
    rows gives the twin's coded bits (payload @ M + offset mod 2)."""
    rng = np.random.default_rng(len(form))
    if form == "dci":
        cfg = flagship.PDCCH
        e = pdcch.BITS_PER_CCE * cfg.aggregation_level
        key = (cfg.payload_bits, e, cfg.rnti, cfg.n_rnti, cfg.n_id_data)
        m, offset = pdcch._dci_map(0, *key), pdcch._dci_map(1, *key)
    else:
        which = "full" if form == "pbch_ctx" else "mib"
        m = ssb._pbch_operand(flagship.SSB, which)
        offset = ssb._pbch_operand(flagship.SSB,
                                   "g" if form == "pbch_ctx" else "static")
    m = np.asarray(m, np.uint8)
    a = m.shape[0]
    rows = dl_control.pack_rows(m)
    assert np.array_equal(dl_control.unpack_rows(rows, a), m)
    table, words = dl_control.row_table(rows, np.asarray(offset), a)
    for _ in range(4):
        bits = rng.integers(0, 2, a)
        want = (bits @ m.astype(np.int64) + np.asarray(offset)) & 1
        pay = ballot_words(np.concatenate([bits, [1]]), words)
        assert np.array_equal(
            pay, np.packbits(np.concatenate(
                [bits, [1], np.zeros(32 * words - a - 1, np.int64)]).astype(
                    np.uint8), bitorder="little").view("<u4"))
        got = np.array([[sum(bin(int(pay[i]) & int(table[k, 2 * i + q]))
                             .count("1") for i in range(words)) & 1
                         for q in (0, 1)] for k in range(table.shape[0])])
        assert np.array_equal(got.reshape(-1), want)


def test_model_matches_jax():
    """Slot A's SSB (with its slot context) and AL8 PDCCH through the
    kernel's model and through the JAX package's map_ssb_to_grid and
    pdcch.process: within 1e-6 (float32 sums of the same values)."""
    j_ssb_cfg = j_ssb.SsbConfig(phys_cell_id=1, ssb_idx=0, l_max=8, sfn=3,
                                first_symbol=2, first_subcarrier=48)
    j_pdcch_cfg = j_pdcch.PdcchConfig(
        coreset=j_pdcch.CoresetConfig(rb_start=0, nof_rb=48, start_symbol=0,
                                      duration=1),
        rnti=0x4601, aggregation_level=8, cce_index=0, payload_bits=60,
        n_id=1, n_id_data=1, slot_in_frame=6)
    rng = np.random.default_rng(5)
    g = ((rng.normal(size=(4, 14, 576)) + 1j * rng.normal(size=(4, 14, 576)))
         * 0.1).astype(np.complex64)
    mib = rng.integers(0, 2, 24).astype(np.int8)
    dci = rng.integers(0, 2, 60).astype(np.int8)
    static, mask = j_ssb.slot_ctx_for(j_ssb_cfg, sfn=3, hrf=True)
    pil = j_pdcch.dmrs_values_for(j_pdcch_cfg, 6)
    want = j_ssb.map_ssb_to_grid(jnp.asarray(g), j_ssb_cfg, jnp.asarray(mib),
                                 (jnp.asarray(static), jnp.asarray(mask)))
    want = np.asarray(j_pdcch.process(want, jnp.asarray(dci), j_pdcch_cfg,
                                      dmrs_cinits=jnp.asarray(pil)))
    grid = torch.as_tensor(g)
    t_ctx = tuple(torch.as_tensor(np.asarray(x)) for x in (static, mask))
    items = (ssb.control_item(grid, convert.config(j_ssb_cfg),
                              torch.as_tensor(mib), t_ctx),
             pdcch.control_item(grid, torch.as_tensor(dci),
                                convert.config(j_pdcch_cfg),
                                dmrs_cinits=torch.as_tensor(np.asarray(pil))))
    np.testing.assert_allclose(emulate(grid, items).numpy(), want, rtol=0,
                               atol=1e-6)


def _sig(grid, items):
    return dl_control._call_inputs(grid, tuple(items))[0]


def test_items_cached_per_config():
    """``control_item`` builds an item's static fields once per (config,
    device): two calls share the tensors and K27's plan signature, and the
    signature differs with the configuration, the form and the
    amplitude."""
    grid = torch.zeros((4, 14, 576), dtype=torch.complex64)
    pay = torch.zeros(60, dtype=torch.int8)
    a = pdcch.control_item(grid, pay, flagship.PDCCH)
    b = pdcch.control_item(grid, pay + 1, flagship.PDCCH)
    assert a.rows is b.rows and a.index is b.index
    assert _sig(grid, [a]) == _sig(grid, [b])
    assert b.bits[0] is not a.bits[0]
    half = pdcch.control_item(grid, pay, flagship.PDCCH, 0.5)
    assert _sig(grid, [half]) != _sig(grid, [a])
    other = dataclasses.replace(flagship.PDCCH, cce_index=4,
                                aggregation_level=4)
    assert _sig(grid, [pdcch.control_item(grid, pay, other)]) != \
        _sig(grid, [a])
    mib = torch.zeros(24, dtype=torch.int8)
    s1 = ssb.control_item(grid, flagship.SSB, mib)
    ctx = tuple(torch.as_tensor(x) for x in ssb.slot_ctx_for(flagship.SSB))
    s2 = ssb.control_item(grid, flagship.SSB, mib, ctx)
    assert s1.base is s2.base
    assert len({_sig(grid, [s1]), _sig(grid, [s2]), _sig(grid, [a])}) == 3
    assert torch.equal(a.rows, torch.as_tensor(pdcch._dci_rows(
        60, 864, flagship.PDCCH.rnti, flagship.PDCCH.n_rnti,
        flagship.PDCCH.n_id_data)))


def _changed(it, field):
    """``it`` with one field K27's plan reads changed (a table to an equal
    copy: the signature names tables by identity)."""
    if field in ("rows", "offset", "index", "base"):
        return dataclasses.replace(it, **{field: getattr(it, field).clone()})
    if field == "bits":
        return dataclasses.replace(it, bits=(it.bits[0][:-1],))
    if field == "pilots":
        return dataclasses.replace(it, pilots=None)
    if field == "all_ports":
        return dataclasses.replace(it, all_ports=not it.all_ports)
    if field == "amplitude":
        return dataclasses.replace(it, amplitude=it.amplitude / 2)
    return dataclasses.replace(it, **{field: getattr(it, field) + 1})


@pytest.mark.parametrize("field", [
    "rows", "offset", "index", "base", "l0", "sc0", "h", "w", "all_ports",
    "nd", "amplitude", "bits", "pilots"])
def test_signature_names_what_the_plan_reads(field):
    """Every field of an item that K27's plan reads changes the call's
    signature, so two PDUs that differ in it never share a cached plan;
    the item's payload values and the other item do not."""
    grid = torch.zeros((4, 14, 576), dtype=torch.complex64)
    ctx = tuple(torch.as_tensor(x) for x in ssb.slot_ctx_for(flagship.SSB))
    s = ssb.control_item(grid, flagship.SSB,
                         torch.zeros(24, dtype=torch.int8), ctx)
    pil = torch.as_tensor(pdcch.dmrs_values_for(flagship.PDCCH))
    d = pdcch.control_item(grid, torch.zeros(60, dtype=torch.int8),
                           flagship.PDCCH, dmrs_cinits=pil)
    base = _sig(grid, [s, d])
    assert _sig(grid, [s, dataclasses.replace(
        d, bits=(d.bits[0] + 1,))]) == base
    if field != "base":
        assert _sig(grid, [s, _changed(d, field)]) != base
    if field not in ("pilots", "nd"):
        assert _sig(grid, [_changed(s, field), d]) != base


def test_signature_points_at_converted_inputs():
    """Payloads that are not int8 (int64, as ``pdcch.process`` takes them)
    and pilots with a stride of 2 go to K27 as converted copies: the
    call's pointers are those copies', which ``control_map`` holds until
    the launches are queued (were a copy freed sooner, the next PDU's copy
    could take its memory), and the signature is that of the copies."""
    grid = torch.zeros((4, 14, 576), dtype=torch.complex64)
    ctx = tuple(torch.as_tensor(x).to(torch.int64)
                for x in ssb.slot_ctx_for(flagship.SSB))
    pil = torch.as_tensor(pdcch.dmrs_values_for(flagship.PDCCH))
    wide = torch.stack([pil, pil], -1)[..., 0]
    items = (ssb.control_item(grid, flagship.SSB,
                              torch.ones(24, dtype=torch.int64), ctx),
             pdcch.control_item(grid, torch.ones(60, dtype=torch.int64),
                                flagship.PDCCH, dmrs_cinits=wide))
    sig, ptrs, inputs = dl_control._call_inputs(grid, items)
    held = [t for bits, p in inputs for t in (*bits, p) if t is not None]
    assert ptrs == [t.data_ptr() for t in held]
    assert all(t.dtype in (torch.int8, torch.complex64)
               and t.stride() == (1,) for t in held)
    own = [t for it in items for t in (*it.bits, it.pilots) if t is not None]
    assert not {t.data_ptr() for t in held} & {t.data_ptr() for t in own}
    narrow = tuple(dataclasses.replace(
        it, bits=tuple(b.to(torch.int8) for b in it.bits),
        pilots=None if it.pilots is None else it.pilots.contiguous())
        for it in items)
    assert _sig(grid, narrow) == sig
    assert torch.equal(inputs[1][1], pil)


@pytest.mark.parametrize("n,sms,blocks", [
    (1, 132, 1), (15, 132, 1), (16, 132, 1), (17, 132, 1), (4096, 132, 1),
    (4111, 132, 1), (4112, 132, 2), (426_096, 132, 105),
    (1 << 26, 132, 528), (426_096, 16, 64), (1 << 26, 1, 4)])
def test_llr_params(n, sms, blocks):
    """K35's launch struct: n, the scale 6 and a CTA per 4,096 LLRs (a
    thread per 16), at most CTAS_PER_SM an SM of the card (the grid
    strides past them)."""
    p = llr._llr_params(n, sms)
    assert (p.n, p.scale, p.blocks) == (n, 6.0, blocks)
    assert ctypes.sizeof(p) == 16
    assert flagship.pusch_llr_count() == 426_096


def test_llr_params_refuse():
    with pytest.raises(ValueError):
        llr._llr_params(0, 132)
    with pytest.raises(ValueError):
        llr._llr_params(16, 0)


def test_dequantize_warp_transpose():
    """K35's dequantize store map (csrc/llr.cu): store c of lane l writes
    float4 32 c + l of its warp's 128, whose four bytes lane 8 c + l / 4
    loaded as its word l mod 4 -- every LLR of the 512 once, in order."""
    chunk = np.arange(32 * llr.VEC)
    loaded = chunk.reshape(32, 4, 4)                 # lane, word, byte
    out = np.zeros((128, 4), np.int64)
    for c in range(4):
        for lane in range(32):
            out[32 * c + lane] = loaded[8 * c + lane // 4, lane % 4]
    assert np.array_equal(out.reshape(-1), chunk)
