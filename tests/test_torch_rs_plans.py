"""K11's and K26's host plans and numpy models of their kernels, on the
CPU.

K11 (csrc/srs_estimate.cu): a numpy model of the kernel built from its
launch struct and sequence table alone -- per (slot, rx port) W = 2^lw
warps of 32 lanes, lane r of warp w taking subcarriers 32 w + r + i 32 W
(i < J) at the closed-form column sc0 + comb k of symbols s0 .. s0 + S - 1;
the symbol sum, the ramp exp(j c ta k) with the phase rounded as the
kernel rounds it, the L correlations summed over a lane's subcarriers,
then over its warp by a butterfly, then over the port's warps in order;
wb = corr x (1 / (S K)), the residual's energy likewise, the quotient by
S dof, the floor and the SNR -- against JAX ``srs.estimate``'s
``noise_var`` and ``snr`` with JAX's own TA and RSRP fed in: combs 2 and 4,
1, 2 and 4 SRS ports, 1, 2 and 4 symbols, cyclic shifts, K = 24 to 1632
(1 to 8 warps a port), and a slot axis of 4 with per-slot TA and RSRP.
Relative 1e-4, as the GPU tests hold K11 to its twin (sums in another
order).
K26 (csrc/dl_rs_map.cu, ``dmrs_map_kernel``): a numpy model from its
launch struct, the PRB table, the pilots and the matrices -- a thread per
(slot, DM-RS symbol, PRB rank j, subcarrier pair q), its CDM groups and
pilot indices in closed form, its PRB prb0 + j or the table's, each port's
pair plus, layer after layer, W[p, l] x pilot (products and sums rounded
one by one in float32) -- against JAX ``dmrs.map_to_grid``: types 1 and
2, 1-4 layers with their port sets, 1-4 symbols, contiguous, RA type 0 and
interleaved PRB lists, no matrix, a [P, L] matrix and a PRG table, and a
slot axis with shared and per-slot pilots.  Bit-equal to JAX without a
matrix and with matrices whose products are exact (entries 0, +-1, +-j,
+-1/2 +- j/2: XLA's complex products then round as the twin's); with
random matrices bit-equal to the plain twin ``dmrs_map_ref`` and within
1e-6 of max|ref| of JAX (XLA's complex products round in another order,
as tests/test_torch_dl_rs.py holds the twin).  The pair layout reaches
every DM-RS RE of the layers' CDM groups exactly once.
K25 (csrc/dl_rs_map.cu, ``rs_map_kernel``): its 16-byte records
(``dl_rs.rs_records``) decode to ``rs_plan``'s (target, source, index,
weight) in the same per-target order, the targets sorted by descending
term count so that rank r covers a prefix of rank_n[r] targets, every
target reached once; and a numpy model of the kernel on the records and
its struct (``dl_rs._rs_params``) -- per slot and target the grid value
plus, rank by rank, value x weight, products and sums rounded one by one
in float32, one launch per 32 PDUs -- bit-equal to the plain twin
``rs_map_ref`` (which tests/test_torch_dl_rs.py holds to the JAX
``csi_rs.process``, ``map_ptrs`` and ``map_prs``) on DU-low slots A-D,
the 33-PDU case and targets of 1-3 terms at odd offsets, each with and
without a slot axis of 4.
The launch structs' fields and limits (K11, K20, K25, K26) against the C
sources, and the refusals.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.phy.upper import dmrs as j_dmrs
from srsran_tpu.phy.upper import pdsch as j_pdsch
from srsran_tpu.phy.upper import srs as j_srs

from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import dl_rs
from srsran_tpu_torch.phy.upper import dmrs as t_dmrs
from srsran_tpu_torch.phy.upper import srs as t_srs

torch.set_num_threads(2)

C64 = torch.complex64
F32 = np.float32
NSC = 3276                 # the flagship's subcarriers (273 RB)


def _c_struct_fields(src: str, struct: str) -> list:
    """The field names of a C struct in csrc, in order (arrays by name)."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / src).read_text())
    body = re.search(rf"struct {struct} {{(.*?)}};", text, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            _, rest = decl.split(None, 1)
            names += [re.sub(r"\[.*\]", "", v).strip()
                      for v in rest.split(",")]
    return names


def _c_constant(src: str, name: str) -> int:
    text = (_build.CSRC / src).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("src,struct,cls", [
    ("srs_estimate.cu", "SrsNoiseParams", _build.SrsNoiseParams),
    ("dl_rs_map.cu", "DmrsMapParams", _build.DmrsMapParams),
    ("dl_rs_map.cu", "RsMapParams", _build.RsMapParams),
    ("tdl_channel.cu", "TdlParams", _build.TdlParams)])
def test_structs_match_the_sources(src, struct, cls):
    assert _c_struct_fields(src, struct) == [f for f, _ in cls._fields_]


@pytest.mark.parametrize("src,name,value", [
    ("srs_estimate.cu", "kSrsMaxRxPorts", _build.SRS_MAX_RX_PORTS),
    ("srs_estimate.cu", "kSrsMaxLayers", _build.SRS_MAX_LAYERS),
    ("srs_estimate.cu", "kSrsMaxSymbols", _build.SRS_MAX_SYMBOLS),
    ("srs_estimate.cu", "kSrsMaxWarps", _build.SRS_MAX_WARPS),
    ("dl_rs_map.cu", "kMaxLayers", _build.DMRS_MAX_LAYERS),
    ("dl_rs_map.cu", "kMaxDmrsSymbols", _build.DMRS_MAX_SYMBOLS),
    ("dl_rs_map.cu", "kDmrsMaxPorts", _build.DMRS_MAX_PORTS),
    ("dl_rs_map.cu", "kMaxSources", _build.RS_MAX_SOURCES),
    ("dl_rs_map.cu", "kRsMaxRanks", _build.RS_MAX_RANKS),
    ("dl_rs_map.cu", "kRsIndexBits", _build.RS_INDEX_BITS),
    ("tdl_channel.cu", "kMaxTx", _build.TDL_MAX_TX),
    ("tdl_channel.cu", "kMaxTaps", _build.TDL_MAX_TAPS),
    ("tdl_channel.cu", "kTdlMaxWarps", _build.TDL_MAX_WARPS),
    ("tdl_channel.cu", "kTdlMaxSmem", _build.TDL_MAX_SMEM)])
def test_limits_match_the_sources(src, name, value):
    assert _c_constant(src, name) == value


def _cgauss(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale / np.sqrt(2)).astype(np.complex64)


def _tree(v: np.ndarray) -> np.ndarray:
    """A __shfl_xor_sync butterfly sum over the last axis (a power of
    two): lane i adds lane i + m for m = n/2, ..., 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = (v[..., :h] + v[..., h:]).astype(v.dtype)
    return v[..., 0]


# ------------------------------------------------------------------ K11

def _k11_model(grid: np.ndarray, ta: np.ndarray, rsrp: np.ndarray,
               seq: np.ndarray, p) -> tuple:
    """csrc/srs_estimate.cu on numpy from its SrsNoiseParams and sequence
    table [L, K]: (noise_var f32 [slots, P], snr f32 [slots, P]); ta one
    value a slot, rsrp [slots, P]."""
    grid = grid.reshape((p.slots, p.P, p.nsym, p.nsc))
    ta = np.asarray(ta, F32).reshape(p.slots)
    rsrp = np.asarray(rsrp, F32).reshape(p.slots, p.P)
    w_n, step = 1 << p.lw, 32 << p.lw
    # the subcarrier of lane (w, r) in round i, and whether it holds one
    k_of = ((np.arange(w_n)[:, None, None] * 32
             + np.arange(32)[None, :, None])
            + np.arange(p.J)[None, None, :] * step)               # [W, 32, J]
    live = k_of < p.K
    kc = np.minimum(k_of, p.K - 1)
    cols = p.sc0 + p.comb * kc
    nv = np.zeros((p.slots, p.P), F32)
    snr = np.zeros((p.slots, p.P), F32)
    for b in range(p.slots):
        cta = F32(F32(p.c) * ta[b])
        phase = (cta * kc.astype(F32)).astype(F32)
        ramp = np.exp(1j * phase.astype(np.float64)).astype(np.complex64)
        e = seq[:, kc]                                             # [L, ...]
        for port in range(p.P):
            rx = grid[b, port, p.s0:p.s0 + p.S][:, cols]           # [S, ...]
            acc = rx[0]
            for s in range(1, p.S):
                acc = (acc + rx[s]).astype(np.complex64)
            corr = np.zeros((p.L, w_n, 32), np.complex64)
            for i in range(p.J):
                t = (acc[..., i] * np.conj(e[..., i])) * ramp[..., i]
                corr += np.where(live[..., i], t, 0).astype(np.complex64)
            corr = _tree(corr)                                     # [L, W]
            tot = corr[:, 0]
            for w in range(1, w_n):
                tot = (tot + corr[:, w]).astype(np.complex64)
            wb = (tot * F32(p.inv_sk)).astype(np.complex64)
            recon = np.einsum("l,l...->...", wb, e * np.conj(ramp))
            d = (acc - F32(p.S) * recon).astype(np.complex64)
            e2 = np.where(live, d.real * d.real + d.imag * d.imag, 0)
            nz = _tree(e2.astype(F32).sum(-1).astype(F32))         # [W]
            nz = F32(np.sum(nz, dtype=F32))
            nv[b, port] = max(F32(nz / F32(p.sdof)),
                              F32(rsrp[b, port] * F32(1e-6)))
            snr[b, port] = rsrp[b, port] / max(nv[b, port], F32(1e-12))
    return nv, snr


def _srs_cfg(comb, ports, nsym, rb, cs, rb_start=None):
    return t_srs.SrsConfig(
        rb_start=273 - rb if rb_start is None else rb_start, rb_count=rb,
        start_symbol=14 - nsym, nof_symbols=nsym, comb=comb,
        comb_offset=comb - 1, cyclic_shift=cs, nof_ports=ports,
        sequence_id=11, numerology=1)


def _srs_grid(cfg, rng, snr_db=26.0):
    """One slot's 4-port grid: every SRS port through a random 4 x L
    channel, noise at ``snr_db`` a RE."""
    tx = t_srs.map_to_grid(torch.zeros((4, 14, NSC), dtype=C64), cfg).numpy()
    h = _cgauss(rng, (4, 4))
    sigma = 10 ** (-snr_db / 20)
    return (np.einsum("rp,psk->rsk", h, tx)
            + _cgauss(rng, tx.shape, sigma)).astype(np.complex64)


def _k11_check(grids: list, cfg):
    """The K11 model on the slots' grids (a slot axis when more than one)
    against JAX ``srs.estimate`` slot by slot, with JAX's TA and RSRP."""
    jcfg = j_srs.SrsConfig(**dataclasses.asdict(cfg))
    ests = [j_srs.estimate(jnp.asarray(g), jcfg) for g in grids]
    ta = np.array([float(e.time_alignment_s) for e in ests], F32)
    rsrp = np.stack([np.asarray(e.rsrp, F32) for e in ests])
    grid = np.stack(grids) if len(grids) > 1 else grids[0]
    lead = (len(grids),) if len(grids) > 1 else ()
    ta_t = torch.as_tensor(ta if lead else ta[0])
    rsrp_t = torch.as_tensor(rsrp if lead else rsrp[0])
    p = t_srs._noise_params((grid.shape, ta_t.shape, rsrp_t.shape),
                            (None, ta_t.stride(), rsrp_t.stride()), cfg)
    seq = t_srs._expected(cfg)[:, 0]
    nv, snr = _k11_model(grid, ta, rsrp, seq, p)
    for b, e in enumerate(ests):
        np.testing.assert_allclose(nv[b], np.asarray(e.noise_var), rtol=1e-4)
        np.testing.assert_allclose(snr[b], np.asarray(e.snr), rtol=1e-4)
    return p


@pytest.mark.parametrize("comb,ports,nsym,rb,cs,warps", [
    (2, 1, 1, 4, 0, 1), (4, 1, 2, 8, 5, 1), (2, 2, 1, 16, 3, 1),
    (4, 4, 1, 48, 7, 1), (2, 2, 2, 48, 6, 2), (4, 4, 4, 96, 11, 2),
    (2, 4, 2, 96, 1, 4), (4, 2, 4, 272, 2, 4), (2, 4, 4, 272, 3, 8)])
def test_srs_kernel_model_matches_jax(comb, ports, nsym, rb, cs, warps):
    """Combs 2 and 4, 1-4 SRS ports and symbols, cyclic shifts, K = 24 to
    1632 on 1 to 8 warps a rx port: the model's noise and SNR are JAX's."""
    cfg = _srs_cfg(comb, ports, nsym, rb, cs)
    p = _k11_check([_srs_grid(cfg, np.random.default_rng(rb + cs))], cfg)
    assert 1 << p.lw == warps and (p.J & (p.J - 1)) == 0
    assert 32 * warps * p.J >= cfg.seq_len > 16 * warps * p.J or p.J == 1
    assert p.ppc == (4 if warps == 1 else 1)


def test_srs_kernel_model_over_a_slot_axis():
    """Four slots, each its own channel, noise level and TA: per-slot TA
    and RSRP, the model's noise and SNR JAX's slot by slot."""
    cfg = _srs_cfg(2, 4, 2, 96, 5)
    rng = np.random.default_rng(4)
    grids = []
    for snr_db, delay in ((30.0, 0), (20.0, 3), (26.0, 7), (15.0, 12)):
        g = _srs_grid(cfg, rng, snr_db)
        # a delay of ``delay`` samples at 4096 points: a phase ramp
        ramp = np.exp(-2j * np.pi * delay * np.arange(NSC) / 4096)
        grids.append((g * ramp).astype(np.complex64))
    p = _k11_check(grids, cfg)
    assert p.slots == 4 and p.ta_stride == 1 and p.rsrp_stride == 4


def test_srs_closed_form_columns_and_strides():
    """The kernel's closed-form comb (sc0 + comb k, symbols from s0) is
    ``sc_indices`` and ``_symbols``; every symbol's sequences are the
    first's (the kernel's table); the TA's and RSRP's strides are read from
    K8's views."""
    for cfg in (_srs_cfg(2, 4, 4, 272, 3, 0), _srs_cfg(4, 2, 2, 48, 5),
                t_srs.SrsConfig(269, 4, 13, 1, 2, 0, 0, 1, 1, 1)):
        p = t_srs._noise_params(((4, 14, NSC), (), (4,)), (None, (), (1,)),
                                cfg)
        np.testing.assert_array_equal(
            p.sc0 + p.comb * np.arange(p.K), t_srs.sc_indices(cfg))
        assert tuple(range(p.s0, p.s0 + p.S)) == t_srs._symbols(cfg)
        exp = t_srs._expected(cfg)
        np.testing.assert_array_equal(exp, np.repeat(exp[:, :1], p.S, 1))
        assert (p.L, p.S, p.K) == (cfg.nof_ports, cfg.nof_symbols,
                                   cfg.seq_len)
        assert p.sdof == cfg.nof_symbols * max(cfg.seq_len - cfg.nof_ports, 1)
    stats = torch.zeros((4, 9))
    ta, rsrp = stats.select(-1, 7), stats[:, 1:5]
    p = t_srs._noise_params(((4, 4, 14, NSC), ta.shape, rsrp.shape),
                            (None, ta.stride(), rsrp.stride()),
                            _srs_cfg(2, 1, 1, 4, 0))
    assert (p.ta_stride, p.rsrp_stride) == (9, 9)


def _srs_refusal(rx=4, nsym_grid=14, nsc=NSC, slots=None, rsrp_ports=None,
                 **cfg_kw):
    kw = dict(comb=2, ports=1, nsym=1, rb=4, cs=0)
    kw.update(cfg_kw)
    cfg = _srs_cfg(**kw)
    lead = () if slots is None else (slots,)
    shapes = (lead + (rx, nsym_grid, nsc), lead,
              lead + (rx if rsrp_ports is None else rsrp_ports,))
    return lambda: t_srs._noise_params(shapes, (None, (), (1,)), cfg)


@pytest.mark.parametrize("change,match", [
    (dict(rx=17, rsrp_ports=17), "1 to 16"),
    (dict(rsrp_ports=3), "do not fit"),
    (dict(nsym=5), "1 to 4"),
    (dict(rb=342, rb_start=0, nsc=4200), "at most 2048"),
    (dict(rb=4, rb_start=272), "outside the grid"),
    (dict(nsym_grid=12), "outside the grid"),
    (dict(slots=12000), "2\\^31 elements")])
def test_srs_refusals_name_their_limit(change, match):
    _srs_refusal()()                    # the flagship SRS is taken
    with pytest.raises(ValueError, match=match):
        _srs_refusal(**change)()


# ------------------------------------------------------------------ K26

def _cmul32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a b with each product and sum rounded to float32 (the kernel's
    __fmul_rn / __fsub_rn / __fadd_rn, the twin's real operations)."""
    ar, ai = a.real.astype(F32), a.imag.astype(F32)
    br, bi = b.real.astype(F32), b.imag.astype(F32)
    re = (ar * br).astype(F32) - (ai * bi).astype(F32)
    im = (ar * bi).astype(F32) + (ai * br).astype(F32)
    return (re.astype(F32) + 1j * im.astype(F32)).astype(np.complex64)


def _k26_model(grid: np.ndarray, pilots: np.ndarray, w, prbs: np.ndarray,
               p, hits: list | None = None) -> np.ndarray:
    """csrc/dl_rs_map.cu's ``dmrs_map_kernel`` on numpy from its
    DmrsMapParams: the grid after the map; each thread's reached REs
    (slot, symbol, subcarrier) appended to ``hits``."""
    out = grid.copy().reshape((p.nslots, p.P, p.S, p.K))
    nsym = sum(1 for s in p.symbols if s >= 0)
    pil = pilots.reshape((-1, nsym, p.npil))
    t = np.arange(p.npairs)
    j, q = t // 6, t % 6
    if p.type2:
        g0 = np.where(q >= 3, q - 3, q)
        g1 = g0
        m0 = 4 * j + 2 * (q >= 3)
    else:
        g0, g1 = np.zeros_like(q), np.ones_like(q)
        m0 = 6 * j + q
    ports = [(p.ports >> (8 * l)) & 0xff for l in range(p.L)]
    groups = [pt >> 1 for pt in ports]
    any_ = np.zeros(p.npairs, bool)
    for g in groups:
        any_ |= (g0 == g) | (g1 == g)
    prb = p.prb0 + j if p.contiguous else prbs[j]
    for b in range(p.nslots):
        if p.wkind:
            wb = w.reshape((-1,) + w.shape[-3 if p.wkind == 2 else -2:])
            wb = wb[b if p.w_stride else 0]
            if p.wkind == 2:
                rows = (prb >> p.prg_shift if p.prg_shift >= 0
                        else prb // p.prg_size) - p.prg_base
                wt = wb[rows]                                  # [n, P, L]
            else:
                wt = np.broadcast_to(wb, (p.npairs,) + wb.shape)
        for si in range(nsym):
            pv = pil[b if p.pilot_stride else 0, si]
            pv0 = pv[m0]
            pv1 = pv[m0 + 1] if p.type2 else pv0
            k = 12 * prb + 2 * q
            sym = p.symbols[si]
            if hits is not None:
                for g_re, off in ((g0, 0), (g1, 1)):
                    sel = any_ & np.isin(g_re, groups)
                    hits += [(b, sym, int(x)) for x in k[sel] + off]
            for o in range(p.P):
                if not p.wkind and o >= p.L:
                    continue
                acc0 = out[b, o, sym, k]
                acc1 = out[b, o, sym, k + 1]
                for li, pt in enumerate(ports):
                    x0 = np.where((pt & 1) & (m0 & 1), -pv0, pv0)
                    x1 = np.where((pt & 1) & (p.type2 | (m0 & 1)), -pv1, pv1)
                    if p.wkind:
                        t0 = _cmul32(wt[:, o, li], x0)
                        t1 = _cmul32(wt[:, o, li], x1)
                    elif li == o:
                        t0, t1 = x0, x1
                    else:
                        continue
                    a0 = any_ & (g0 == pt >> 1)
                    a1 = any_ & (g1 == pt >> 1)
                    acc0 = np.where(a0, (acc0 + t0).astype(np.complex64),
                                    acc0)
                    acc1 = np.where(a1, (acc1 + t1).astype(np.complex64),
                                    acc1)
                out[b, o, sym, k] = np.where(any_, acc0, out[b, o, sym, k])
                out[b, o, sym, k + 1] = np.where(any_, acc1,
                                                 out[b, o, sym, k + 1])
    return out.reshape(grid.shape)


# DM-RS allocations: (type, ports, symbols, PRB list or None, rb_start,
# rb_count)
RA_TYPE0 = tuple(range(4, 20)) + tuple(range(36, 52)) + (60, 61, 62, 63)
INTERLEAVED = (1, 2, 5, 6, 9, 10, 13, 14, 33, 34, 37, 38, 41, 42)
K26_ALLOCS = {
    "t1_1l": (1, (0,), (2,), None, 3, 40),
    "t1_2l": (1, (0, 1), (2, 11), None, 0, 64),
    "t1_3l": (1, (0, 1, 2), (2, 5, 8), None, 10, 50),
    "t1_4l": (1, (0, 1, 2, 3), (2, 5, 8, 11), None, 0, 64),
    "t1_4l_type0": (1, (0, 1, 2, 3), (2, 11), RA_TYPE0, 4, 60),
    "t1_2l_interleaved": (1, (2, 3), (3,), INTERLEAVED, 1, 42),
    "t2_1l": (2, (4,), (2,), None, 5, 30),
    "t2_2l": (2, (2, 3), (2, 11), None, 0, 64),
    "t2_4l": (2, (0, 1, 4, 5), (2, 7, 11), None, 2, 48),
    "t2_4l_mixed": (2, (5, 0, 3, 2), (2, 5, 8, 11), None, 0, 64),
}
P = 4


def _dmrs_cfg(name, slot=4):
    kind, ports, symbols, prbs, rb_start, rb_count = K26_ALLOCS[name]
    return dict(rb_start=rb_start, rb_count=rb_count, symbols=symbols,
                ports=ports, scrambling_id=7, config_type=kind,
                slot_in_frame=slot, prbs=prbs)


def _exact_matrix(rng, shape):
    """Matrices whose products with any pilot are exact in float32."""
    vals = np.array([0, 1, -1, 1j, -1j, 0.5 + 0.5j, -0.5 + 0.5j, 0.5 - 0.5j],
                    np.complex64)
    return vals[rng.integers(0, len(vals), shape)]


def _k26_case(name, precoder, rng, exact, lead=(), per_slot=False):
    """(grid, pilots, w, ports, symbols, prbs, prg_size, type, the configs
    of each slot) for the numpy model, the twin and JAX."""
    kw = _dmrs_cfg(name)
    tcfgs = [t_dmrs.DmrsConfig(**dict(kw, slot_in_frame=(4 + 2 * b)
                                      if per_slot else 4))
             for b in range(lead[0] if lead else 1)]
    prbs = tcfgs[0].prb_list
    nl = len(kw["ports"])
    pil = np.stack([t_dmrs.pilot_values_for(c) for c in tcfgs])
    pil = pil if per_slot else pil[0]
    make = _exact_matrix if exact else _cgauss
    w, prg = None, 0
    if precoder == "matrix":
        w = make(rng, lead + (P, nl)) if per_slot else make(rng, (P, nl))
    elif precoder == "prg":
        prg = 4
        n_g = max(prbs) // prg - prbs[0] // prg + 1
        w = (make(rng, lead + (n_g, P, nl)) if per_slot
             else make(rng, (n_g, P, nl)))
    grid = _cgauss(rng, lead + (P, 14, 12 * 64))
    return (grid, pil, w, kw["ports"], kw["symbols"], prbs, prg,
            kw["config_type"], tcfgs)


def _k26_run(case):
    grid, pil, w, ports, symbols, prbs, prg, kind, _ = case
    shapes = (grid.shape, pil.shape, None if w is None else w.shape)
    p = dl_rs._dmrs_params(shapes, ports, symbols, prbs, prg, kind)
    hits = []
    out = _k26_model(grid, pil, w, dl_rs._prb_table(prbs), p, hits)
    return out, p, hits


def _jax_map(grid, cfg, w, prg):
    jcfg = j_dmrs.DmrsConfig(**dataclasses.asdict(cfg))
    if prg:
        base = cfg.prb_list[0]
        return np.asarray(j_dmrs.map_to_grid(
            jnp.asarray(grid), jcfg, None, None,
            prg_matrices=jnp.asarray(w),
            prg_of_sc=lambda sc: j_pdsch.prg_index_of_sc(sc, base, prg)))
    return np.asarray(j_dmrs.map_to_grid(
        jnp.asarray(grid), jcfg, None if w is None else np.asarray(w)))


@pytest.mark.parametrize("name", sorted(K26_ALLOCS))
@pytest.mark.parametrize("precoder", ["none", "matrix", "prg"])
def test_dmrs_kernel_model_matches_jax(name, precoder):
    """Each allocation with each precoder: the model is bit-equal to JAX
    ``map_to_grid`` (exact-product matrices) and to the twin."""
    rng = np.random.default_rng(len(name) + 7 * len(precoder))
    case = _k26_case(name, precoder, rng, exact=True)
    grid, pil, w, ports, symbols, prbs, prg, kind, cfgs = case
    out, p, _ = _k26_run(case)
    np.testing.assert_array_equal(out, _jax_map(grid, cfgs[0], w, prg))
    twin = dl_rs.dmrs_map_ref(
        torch.as_tensor(grid.copy()), torch.as_tensor(pil),
        None if w is None else torch.as_tensor(w), ports, symbols, prbs,
        prg, kind).numpy()
    np.testing.assert_array_equal(out, twin)
    assert p.contiguous == (cfgs[0].prbs is None)


@pytest.mark.parametrize("name", ["t1_4l", "t1_4l_type0", "t2_4l_mixed"])
@pytest.mark.parametrize("precoder", ["matrix", "prg"])
def test_dmrs_kernel_model_random_matrices(name, precoder):
    """Random matrices: the model bit-equal to the twin, within 1e-6 of
    max|ref| of JAX."""
    rng = np.random.default_rng(3 * len(name))
    case = _k26_case(name, precoder, rng, exact=False)
    grid, pil, w, ports, symbols, prbs, prg, kind, cfgs = case
    out, _, _ = _k26_run(case)
    twin = dl_rs.dmrs_map_ref(
        torch.as_tensor(grid.copy()), torch.as_tensor(pil),
        torch.as_tensor(w), ports, symbols, prbs, prg, kind).numpy()
    np.testing.assert_array_equal(out, twin)
    ref = _jax_map(grid, cfgs[0], w, prg)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("precoder", ["none", "matrix", "prg"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_dmrs_kernel_model_over_a_slot_axis(precoder, per_slot):
    """Three slots of type 0 PRBs, the pilots and matrices shared or one
    a slot (each slot its own slot number): JAX's map slot by slot."""
    rng = np.random.default_rng(11 + per_slot)
    case = _k26_case("t1_4l_type0", precoder, rng, exact=True, lead=(3,),
                     per_slot=per_slot)
    grid, pil, w, ports, symbols, prbs, prg, kind, cfgs = case
    out, p, _ = _k26_run(case)
    assert p.nslots == 3
    assert p.pilot_stride == (len(symbols) * pil.shape[-1] if per_slot else 0)
    for b, cfg in enumerate(cfgs):
        wb = w if w is None or not per_slot else w[b]
        np.testing.assert_array_equal(out[b], _jax_map(grid[b], cfg, wb, prg))


@pytest.mark.parametrize("name", sorted(K26_ALLOCS))
def test_dmrs_pairs_reach_every_re_once(name):
    """Every DM-RS RE of the layers' CDM groups on every DM-RS symbol is
    reached by exactly one thread's pair, and no other RE is."""
    rng = np.random.default_rng(1)
    case = _k26_case(name, "matrix", rng, exact=True)
    _, _, _, ports, symbols, prbs, _, kind, _ = case
    _, p, hits = _k26_run(case)
    want = sorted((0, s, int(k)) for s in symbols
                  for g in {q >> 1 for q in ports}
                  for k in dl_rs._comb(prbs, g, kind))
    assert sorted(hits) == want
    assert len(set(hits)) == len(hits)
    assert p.npairs == 6 * len(prbs) and p.npil == dl_rs.PILOTS_PER_PRB[
        kind] * len(prbs)


def test_dmrs_params_fields():
    """Ports byte-packed in layer order, the PRG shift for a power of two,
    the division for another size, -1 past the last symbol."""
    prbs = tuple(range(6, 30))
    p = dl_rs._dmrs_params(((2, 4, 14, 384), (2, 3, 6 * 24), (2, 5, 4, 3)),
                           (1, 0, 3), (2, 7, 11), prbs, 6, 1)
    assert p.ports == 1 | 0 << 8 | 3 << 16 and p.L == 3
    assert (p.prg_shift, p.prg_size, p.prg_base) == (-1, 6, 1)
    assert list(p.symbols) == [2, 7, 11, -1]
    assert (p.pilot_stride, p.w_stride, p.wkind) == (3 * 144, 5 * 4 * 3, 2)
    p = dl_rs._dmrs_params(((4, 14, 288), (2, 4 * 24), (4, 2)), (0, 1),
                           (2, 11), range(0, 24), 0, 2)
    assert (p.prg_shift, p.contiguous, p.type2, p.wkind) == (-1, 1, 1, 1)
    p = dl_rs._dmrs_params(((4, 14, 288), (1, 6 * 24), (6, 4, 1)), (0,),
                           (2,), range(0, 24), 4, 1)
    assert (p.prg_shift, p.w_stride) == (2, 0)


def _dmrs_refusal(p=4, k=288, nsym_grid=14, ports=(0, 1), symbols=(2, 11),
                  prbs=range(0, 24), w=None, prg=0, kind=1, lead=()):
    per_rb = dl_rs.PILOTS_PER_PRB.get(kind, 6)
    shapes = (lead + (p, nsym_grid, k), (len(symbols), per_rb * len(prbs)),
              w)
    return lambda: dl_rs._dmrs_params(shapes, ports, symbols, prbs, prg, kind)


@pytest.mark.parametrize("change,match", [
    (dict(k=291), "even count"),
    (dict(p=9, w=(9, 2)), "1 to 8"),
    (dict(ports=(0, 4)), "DM-RS ports"),
    (dict(kind=3), "configuration type 3"),
    (dict(symbols=(1, 2, 3, 4, 5)), "1..4"),
    (dict(p=1), "without a matrix"),
    (dict(w=(4, 3)), "DM-RS precoder"),
    (dict(w=(5, 4, 2), prg=4), "PRG table of 5"),
    (dict(prbs=range(20, 30)), "PRBs"),
    (dict(symbols=(2, 14)), "DM-RS map"),
    (dict(lead=(140000,)), "2\\^31 elements")])
def test_dmrs_refusals_name_their_limit(change, match):
    _dmrs_refusal()()                    # the unchanged call is taken
    with pytest.raises(ValueError, match=match):
        _dmrs_refusal(**change)()


def test_dmrs_plan_refuses_other_dtypes():
    with pytest.raises(ValueError, match="complex64"):
        dl_rs._dmrs_plan(((4, 14, 288), (2, 144), None),
                         (torch.complex128, C64), (0,), (2, 11),
                         range(0, 24), 0, 1, 0)


# ------------------------------------------------------------------ K25

RS_SHAPE = (4, 14, NSC)


def _rs_case(name: str, batch=None):
    """(items, values, grid) of a K25 case on the CPU: DU-low slot "A"-"D",
    "many" (33 CSI-RS) or "terms" (1-3 terms a target at odd offsets)."""
    from srsran_tpu_torch import flagship
    rng = np.random.default_rng(25)
    if name == "many":
        return flagship._many_rs_args(rng, "cpu", batch)
    if name == "terms":
        return flagship.rs_terms_args(rng, "cpu", batch)
    return flagship._du_slot_args("ABCD".index(name), rng, "cpu", batch)


RS_CASES = ["A", "B", "C", "D", "many", "terms"]


def _chunks(items):
    n = _build.RS_MAX_SOURCES
    return [items[c:c + n] for c in range(0, len(items), n)]


@pytest.mark.parametrize("name", RS_CASES)
def test_rs_records_decode_to_the_plan(name):
    """Each target's records, rank by rank, are rs_plan's terms of that
    target in order; the ranks cover prefixes of the targets sorted by
    descending term count; every target is reached once."""
    items, _, _ = _rs_case(name)
    for chunk in _chunks(items):
        plan = dl_rs.rs_plan(chunk, RS_SHAPE)
        rec = dl_rs.rs_records(chunk, RS_SHAPE)
        counts = np.diff(plan["start"])
        order, rank_n, r = rec["order"], rec["rank_n"], rec["records"]
        assert len(rank_n) == (counts.max() if counts.size else 0)
        assert r.shape == (plan["src"].size, 4)
        assert np.all(np.diff(counts[order]) <= 0)
        for q, n in enumerate(rank_n):
            assert n == int((counts > q).sum())
            assert np.all(counts[order[:n]] > q)
        base = np.concatenate([[0], np.cumsum(rank_n)])
        for q, n in enumerate(rank_n):
            rq = r[base[q]:base[q + 1]]
            j = plan["start"][order[:n]] + q
            np.testing.assert_array_equal(rq[:, 0], plan["tgt"][order[:n]])
            word = rq[:, 1].view(np.uint32)
            np.testing.assert_array_equal(word >> _build.RS_INDEX_BITS,
                                          plan["src"][j])
            np.testing.assert_array_equal(
                word & ((1 << _build.RS_INDEX_BITS) - 1), plan["idx"][j])
            np.testing.assert_array_equal(
                rq[:, 2:].copy().view(np.complex64)[:, 0], plan["w"][j])
        if rank_n:
            tgt0 = r[:rank_n[0], 0]
            assert np.unique(tgt0).size == tgt0.size == plan["tgt"].size
            assert set(tgt0.tolist()) == set(plan["tgt"].tolist())


def test_rs_records_of_the_du_slots():
    """The DU-low slots' targets have one term each (slot A 3,554, TRS +
    PT-RS 2,189, the PRS 9,792), the 33 CSI-RS case's first launch 6,552
    of one and 9,828 of two, its second 819 of one."""
    got = [dl_rs.rs_records(chunk, RS_SHAPE)["rank_n"]
           for name in ("A", "B", "C", "many")
           for chunk in _chunks(_rs_case(name)[0])]
    assert got == [(3554,), (2189,), (9792,), (16380, 9828), (819,)]


def _rs_model(grid: np.ndarray, items: tuple, values: list) -> np.ndarray:
    """K25 on numpy inputs from its records and struct: one launch per 32
    PDUs, per slot and target the grid value plus, rank by rank, the
    record's value x weight (products and sums rounded in float32)."""
    lead = tuple(grid.shape[:-3])
    nb = lead[0] if lead else 1
    g = grid.reshape(nb, -1).copy()
    n = _build.RS_MAX_SOURCES
    for c in range(0, len(items), n):
        chunk, vals = items[c:c + n], values[c:c + n]
        plan = dl_rs.rs_plan(chunk, RS_SHAPE)
        if not plan["tgt"].size:
            continue
        rec = dl_rs.rs_records(chunk, RS_SHAPE)
        strides = dl_rs._source_strides(tuple(v.shape for v in vals),
                                         plan["shapes"], lead)
        p = dl_rs._rs_params(rec, strides, grid.shape)
        assert (p.ntgt, p.nslots, p.grid_stride) == (
            rec["rank_n"][0], nb, int(np.prod(RS_SHAPE)))
        flat = np.concatenate([v.reshape(-1) for v in vals])
        vbase = np.concatenate([[0], np.cumsum([v.size for v in vals])])
        r = rec["records"]
        for b in range(nb):
            off = r[:p.ntgt, 0]
            acc_r = g[b, off].real.astype(F32)
            acc_i = g[b, off].imag.astype(F32)
            for q in range(p.nranks):
                rq = r[p.rank_base[q]:p.rank_base[q] + p.rank_n[q]]
                word = rq[:, 1].view(np.uint32)
                src = (word >> _build.RS_INDEX_BITS).astype(np.int64)
                idx = word & ((1 << _build.RS_INDEX_BITS) - 1)
                stride = np.array(list(p.stride))[src]
                v = flat[vbase[src] + b * stride + idx]
                wr, wi = rq[:, 2].view(F32), rq[:, 3].view(F32)
                vr, vi = v.real.astype(F32), v.imag.astype(F32)
                m = p.rank_n[q]
                acc_r[:m] = acc_r[:m] + (vr * wr - vi * wi)
                acc_i[:m] = acc_i[:m] + (vr * wi + vi * wr)
            out = np.empty(off.size, np.complex64)
            out.real, out.imag = acc_r, acc_i
            g[b, off] = out
    return g.reshape(grid.shape)


@pytest.mark.parametrize("name", RS_CASES)
@pytest.mark.parametrize("batch", [None, 4])
def test_rs_kernel_model_bit_equal_to_the_twin(name, batch):
    items, values, grid = _rs_case(name, batch)
    want = dl_rs.rs_map_ref(grid.clone(), items, values)
    got = _rs_model(grid.numpy(), items, [v.numpy() for v in values])
    assert np.array_equal(
        torch.view_as_real(want).numpy().view(np.int32).reshape(-1),
        got.view(np.float32).view(np.int32).reshape(-1))


def _one_term(k: int, idx: int) -> tuple:
    """K25 blocks: value ``idx`` at subcarrier ``k`` of port 0, symbol 0."""
    return (idx + 1,), ((0, 0, np.array([k]), np.array([idx]), 1.0),)


@pytest.mark.parametrize("items,shape,match", [
    (tuple((_one_term, (3, 0)) for _ in range(17)), RS_SHAPE,
     "17 terms \\(K25 takes 16, RS_MAX_RANKS\\)"),
    (((_one_term, (3, 1 << 27)),), RS_SHAPE,
     "index of 134217728 \\(K25 takes < 2\\^27, RS_INDEX_BITS\\)"),
    (((_one_term, (3, 0)),), (8, 14, 1 << 25), "2\\^31 elements")])
def test_rs_refusals_name_their_limit(items, shape, match):
    with pytest.raises(ValueError, match=match):
        dl_rs.rs_records(items, shape)


def test_rs_params_refuse_a_grid_of_2_31():
    items = ((_one_term, (3, 0)),)
    rec = dl_rs.rs_records(items, RS_SHAPE)
    dl_rs._rs_params(rec, (0,), (4,) + RS_SHAPE)
    with pytest.raises(ValueError, match="2\\^31 elements"):
        dl_rs._rs_params(rec, (0,), (12000,) + RS_SHAPE)


def test_rs_plan_refuses_other_dtypes_and_devices():
    items = ((_one_term, (3, 0)),)
    with pytest.raises(ValueError, match="complex64"):
        dl_rs._rs_plan(items, RS_SHAPE, (((1,), torch.complex128, 0),), 0)
    with pytest.raises(ValueError, match="CUDA devices"):
        dl_rs._rs_plan(items, RS_SHAPE, (((1,), C64, 1),), 0)
    with pytest.raises(ValueError, match="RS values"):
        dl_rs._rs_plan(items, RS_SHAPE, (((2,), C64, 0),), 0)
