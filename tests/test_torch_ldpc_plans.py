"""K1's and K5's host plans and numpy models of their kernels, on the CPU.

K1 (csrc/ldpc_decode.cu): the launch struct's edge tables by value (row
pointers, column times Z and shift per edge), its live columns and its
degree classes against the JAX package's base graphs, BG1 and BG2 at
several Z; a numpy model of the kernel on that struct (shared-memory live
columns, rows unrolled by degree, the compressed c2v, the first sweep
reading the input, the per-slot early stop by the last CTA to arrive)
against the twin, bit for bit, soft values and iteration counts included.
K5 (csrc/ldpc_encode.cu): its struct (edge words over packed columns, the
core schedule), its CRC word tables against the CRC of every word, and a
numpy model of the kernel (ballot packing, the CRCs as carry-less products
per word, the TB CRC's insertion, packed rotates and XORs, the unpack)
against JAX ``ldpc_encode.encode`` and the JAX CRCs at Z = 2, 15, 36, 208
and 384, and against the twin ``dlsch_encode_ref``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_tpu.ops import crc as j_crc
from srsran_tpu.ops import ldpc_encode as j_enc
from srsran_tpu.ops.ldpc_graph import get_graph as j_graph
from srsran_tpu.ran.ldpc_params import segment_tb as j_segment

from srsran_tpu_torch.kernels import _build
from srsran_tpu_torch.ops import ldpc_decode, ldpc_encode
from srsran_tpu_torch.ops.crc import POLYS, _remainder_words

torch.set_num_threads(2)

M32 = 0xffffffff


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("bg,z", [(1, 2), (1, 36), (1, 208), (1, 384),
                                  (2, 15), (2, 36), (2, 208), (2, 384)])
@pytest.mark.parametrize("layers", [4, 10, 0])
def test_decode_struct_describes_the_graph(bg, z, layers):
    """The struct's rows are the JAX graph's first rows, edge for edge."""
    g = j_graph(bg, z)
    nrows = layers or g.nof_rows
    p = ldpc_decode._decode_params(bg, z, layers, (3, g.nof_cols * z), 6,
                                   0.8, 100)
    assert (p.nrows, p.ncols, p.z, p.nb, p.nslots) == (nrows, g.nof_cols, z,
                                                       3, 1)
    assert p.threads % 32 == 0 and z <= p.threads < z + 32
    rows = []
    for r in range(nrows):
        edges = [tuple(e) for e in p.edge[p.row_ptr[r]:p.row_ptr[r + 1]]]
        assert all(off % 4 == 0 and wrap == z - off // 4 % z
                   for off, wrap in edges)
        rows.append([(off // 4 // z, off // 4 % z) for off, _ in edges])
    assert rows == [[(int(c), int(s)) for c, s in row]
                    for row in g.rows[:nrows]]
    touched = {c for row in rows for c, _ in row}
    assert p.live == max(g.nof_info_cols, max(touched) + 1)
    assert p.live == g.nof_info_cols + max(nrows, 4)
    # the kernel's row templates: degrees 1..19, in at most 46 rows
    assert {len(row) for row in rows} <= set(range(1, 20))
    assert nrows <= _build.LDPC_MAX_ROWS
    assert p.row_ptr[nrows] <= _build.LDPC_MAX_EDGES


@pytest.mark.parametrize("bg,z,layers", [(1, 384, 46), (1, 36, 10),
                                         (2, 208, 42), (2, 15, 4)])
def test_decode_barriers_between_disjoint_rows(bg, z, layers):
    """The struct's sync mask: between two barriers the rows of the JAX
    graph touch disjoint columns, a barrier follows the last row, and each
    barrier is needed (the next row shares a column with its group)."""
    g = j_graph(bg, z)
    n = g.nof_cols * z
    sync = ldpc_decode._decode_params(bg, z, layers, (2, n), 6, 0.8,
                                      0).sync
    rows = [{int(c) for c, _ in r} for r in g.rows[:layers]]
    assert sync >> (layers - 1) & 1 and sync < 1 << layers
    group = set()
    for r, cols in enumerate(rows):
        assert not group & cols
        group |= cols
        if sync >> r & 1:
            assert r + 1 == layers or rows[r + 1] & group
            group = set()


def test_decode_struct_slot_axis_and_refusals():
    p = ldpc_decode._decode_params(2, 36, 10, (4, 3, 52 * 36), 5, 0.75, 0)
    assert (p.nb, p.cbs_per_slot, p.nslots, p.sweeps, p.k_prime) == (
        12, 3, 4, 5, 0)
    assert p.scaling == np.float32(0.75)
    for shape, it in (((3, 52 * 36 + 1), 6), ((52 * 36,), 6),
                      ((3, 52 * 36), 0), ((0, 52 * 36), 6)):
        with pytest.raises(ValueError):
            ldpc_decode._decode_params(2, 36, 10, shape, it, 0.8, 0)


def _model_decode(llrs, bg, z, layers, max_iter, scaling, crc_poly, k_prime):
    """csrc/ldpc_decode.cu on its struct, in numpy float32: the sweeps as
    the C entry launches them, the CTAs of a sweep one after another, the
    messages as +-(0.8 * magnitude) and the minima by fmin/fmax, as the
    kernel computes them."""
    lead = llrs.shape[:-1]
    shape = lead if len(lead) == 2 else (1,) + lead
    x = llrs.reshape(shape[0] * shape[1], -1).astype(np.float32)
    p = ldpc_decode._decode_params(bg, z, layers, tuple(llrs.shape),
                                   max_iter, scaling,
                                   k_prime if crc_poly else 0)
    sc = np.float32(p.scaling)
    crc_rows = (_remainder_words(crc_poly, k_prime) if crc_poly else None)
    soft = np.empty_like(x)
    bits = np.empty(x.shape, dtype=np.int8)
    c2v = np.zeros((3, p.nb, p.nrows, z), dtype=np.float32)
    meta = np.zeros((p.nb, p.nrows, z), dtype=np.uint32)
    state = np.zeros((p.nslots, 2), dtype=np.int32)      # done, sweeps
    nlive = p.live * z
    j = np.arange(z)
    for sweep in range(p.sweeps):
        fails = np.zeros(p.nslots, dtype=np.int32)
        arrived = np.zeros(p.nslots, dtype=np.int32)
        for cb in range(p.nb):
            slot = cb // p.cbs_per_slot
            if state[slot, 0]:
                continue
            if sweep == 0:
                sh = x[cb, :nlive].copy()
                soft[cb, nlive:] = x[cb, nlive:]
                bits[cb, nlive:] = x[cb, nlive:] < 0
            else:
                sh = soft[cb, :nlive].copy()
            for r in range(p.nrows):
                edges = p.edge[p.row_ptr[r]:p.row_ptr[r + 1]]
                pos = [(off + 4 * j - np.where(j >= wrap, 4 * z, 0)) // 4
                       for off, wrap in edges]
                o1, o2 = c2v[0, cb, r], c2v[1, cb, r]
                om = meta[cb, r]
                oidx = om >> 24
                t = []
                for d, ps in enumerate(pos):
                    mag_o = np.where(oidx == d, o2, o1)
                    old = np.where((om >> d) & 1, -(sc * mag_o), sc * mag_o)
                    t.append(sh[ps] - old)
                m1 = np.full(z, np.inf, np.float32)
                m2 = np.full(z, np.inf, np.float32)
                idx = np.zeros(z, dtype=np.uint32)
                neg = np.zeros(z, dtype=np.uint32)
                for d, td in enumerate(t):       # first and second minimum
                    a = np.abs(td)
                    idx = np.where(a < m1, d, idx).astype(np.uint32)
                    m2 = np.fmin(m2, np.fmax(m1, a))
                    m1 = np.fmin(m1, a)
                    neg |= (td < 0).astype(np.uint32) << d
                mask = np.uint32((1 << len(pos)) - 1)
                odd = np.array([bin(v).count("1") & 1 for v in neg], bool)
                esgn = np.where(odd, ~neg, neg) & mask
                for d, (ps, td) in enumerate(zip(pos, t)):
                    mag = np.where(idx == d, m2, m1)
                    sh[ps] = td + np.where((esgn >> d) & 1, -(sc * mag),
                                           sc * mag)
                c2v[0, cb, r], c2v[1, cb, r] = m1, m2
                meta[cb, r] = idx << 24 | esgn
            soft[cb, :nlive] = sh
            bits[cb, :nlive] = sh < 0
            if p.k_prime:
                acc = np.bitwise_xor.reduce(
                    crc_rows[:p.k_prime][sh[:p.k_prime] < 0],
                    initial=np.uint32(0))
                fails[slot] += acc != 0
                arrived[slot] += 1
                if arrived[slot] == p.cbs_per_slot:     # the last CTA
                    state[slot, 1] += 1
                    state[slot, 0] = fails[slot] == 0
    shape_out = llrs.shape
    iters = state[:, 1] if len(lead) == 2 else state[0, 1]
    return (bits.reshape(shape_out), soft.reshape(shape_out), iters)


def _noisy_codewords(rng, bg, z, shape, snr_db):
    """BPSK LLRs of random codewords (the twin's encoder, CRC24B over the
    first k' bits) with the 2Z punctured bits at 0."""
    g = j_graph(bg, z)
    kb = g.nof_info_cols
    kp = kb * z - 8
    info = torch.as_tensor(rng.integers(0, 2, shape + (kb * z,)
                                        ).astype(np.int8)).reshape(-1, kb * z)
    info[:, kp:] = 0
    info[:, kp - 24:kp] = ldpc_encode.crc(info[:, :kp - 24], "crc24B")
    cw = ldpc_encode.encode(info, bg, z).numpy().reshape(shape + (-1,))
    sigma = 10 ** (-np.asarray(snr_db, dtype=np.float64) / 20)
    sigma = np.reshape(sigma, np.shape(sigma) + (1,) * (len(shape) + 1
                                                       - np.ndim(sigma)))
    llr = 2 * ((1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
               ) / sigma ** 2
    llr[..., :2 * z] = 0.0
    return llr.astype(np.float32), kp


@pytest.mark.parametrize("bg,z,layers,snr", [
    (2, 15, 10, 1.5), (2, 36, 0, 1.0), (1, 36, 10, 2.0), (1, 15, 0, 1.0)])
def test_decode_kernel_model_matches_the_twin(bg, z, layers, snr):
    """Soft values, hard bits and the sweep count bit for bit, with noise
    that takes several sweeps."""
    rng = np.random.default_rng(z + layers)
    llr, kp = _noisy_codewords(rng, bg, z, (3,), snr)
    args = (bg, z, layers, 6, 0.8, "crc24B", kp)
    bits, soft, it = _model_decode(llr, *args)
    rb, rs, rit = ldpc_decode.decode_early_stop_ref(torch.as_tensor(llr),
                                                    *args)
    np.testing.assert_array_equal(bits, rb.numpy())
    np.testing.assert_array_equal(soft.view(np.int32), rs.numpy().view(
        np.int32))
    assert int(it) == int(rit) and int(it) >= 2


def test_decode_kernel_model_stops_each_slot():
    """A slot axis: a clean slot stops after one sweep while a noisy one
    goes on; each slot as a run of its own."""
    rng = np.random.default_rng(7)
    llr, kp = _noisy_codewords(rng, 2, 36, (3, 2), [8.0, 1.0, 1.5])
    args = (2, 36, 10, 6, 0.8, "crc24B", kp)
    bits, soft, it = _model_decode(llr, *args)
    assert it.shape == (3,) and it[0] == 1 and it.max() > 1
    for s in range(3):
        rb, rs, rit = ldpc_decode.decode_early_stop_ref(
            torch.as_tensor(llr[s]), *args)
        np.testing.assert_array_equal(bits[s], rb.numpy())
        np.testing.assert_array_equal(soft[s].view(np.int32),
                                      rs.numpy().view(np.int32))
        assert it[s] == int(rit)


def test_decode_kernel_model_fixed_sweeps():
    """``decode`` (no CRC): every sweep runs."""
    rng = np.random.default_rng(3)
    llr, _ = _noisy_codewords(rng, 1, 15, (2,), 1.0)
    bits, soft, _ = _model_decode(llr, 1, 15, 12, 3, 0.8, None, 0)
    rb, rs = ldpc_decode.decode_ref(torch.as_tensor(llr), 1, 15, 12, 3, 0.8)
    np.testing.assert_array_equal(bits, rb.numpy())
    np.testing.assert_array_equal(soft.view(np.int32), rs.numpy().view(
        np.int32))


# ------------------------------------------------------------------ K5

# (TBS, base graph): Z = 2, 15, 36, 208 (one codeblock, CRC16), 208 (two
# codeblocks of BG2, CRC24A and CB CRC24B) and 384 (two codeblocks of BG1)
ENCODE_CASES = [(24, 1), (72, 2), (696, 1), (1912, 2), (3832, 2),
                (15424, 1)]


@pytest.mark.parametrize("tbs,bg", ENCODE_CASES)
def test_encode_struct(tbs, bg):
    seg = j_segment(tbs, bg)
    z = seg.lifting_size
    g = j_graph(bg, z)
    p = ldpc_encode._encode_params(tbs, bg, 3)
    nw = -(-z // 32)
    assert (p.z, p.nw, p.kb, p.ncols, p.nrows, p.ncb, p.nslots) == (
        z, nw, g.nof_info_cols, g.nof_cols, g.nof_rows, seg.nof_codeblocks,
        3)
    assert (p.tb_crc_len, p.cb_crc_len, p.ppc) == (
        seg.tb_crc_bits, seg.cb_crc_bits, seg.cb_info_bits - seg.cb_crc_bits)
    rows = [[((e & 0xffff) // (nw + 1), e >> 16)
             for e in p.edge[p.row_ptr[r]:p.row_ptr[r + 1]]]
            for r in range(g.nof_rows)]
    assert all((e & 0xffff) % (nw + 1) == 0
               for e in p.edge[:p.row_ptr[g.nof_rows]])
    assert rows == [[(int(c), int(s)) for c, s in row] for row in g.rows]
    assert list(p.core) == ldpc_encode._core_schedule(bg, z).tolist()
    length, poly = POLYS["crc24A" if seg.tb_crc_bits == 24 else "crc16"]
    assert p.tb_poly == poly | 1 << length
    assert p.cb_poly == POLYS["crc24B"][1] | 1 << 24


def _mulmod8(b, a, length, poly):
    r = 0
    for i in range(7, -1, -1):
        r <<= 1
        if r >> length & 1:
            r ^= poly
        if b >> i & 1:
            r ^= a
    return r


def _brev(v):
    return int(f"{v:032b}"[::-1], 2)


def _share(word, tab, length, poly):
    """csrc/ldpc_encode.cu crc_share(): four bytes, four table words."""
    p = _brev(word) >> (int(tab[0]) >> 24)
    a = [int(tab[0]) & 0xffffff] + [int(t) for t in tab[1:]]
    out = 0
    for k in range(4):
        out ^= _mulmod8(p >> 8 * k & 0xff, a[k], length, poly)
    return out


@pytest.mark.parametrize("poly,n", [("crc24B", 8357), ("crc24A", 100),
                                    ("crc16", 37), ("crc24B", 5)])
def test_crc_word_shares(poly, n):
    """Each word's share, XORed, is the CRC of the message, whatever the
    word's alignment: words of 32 bits at every start (the last one past
    the message) and words that start mid-way (the columns' wrap)."""
    rng = np.random.default_rng(n)
    length, g = POLYS[poly]
    bits = rng.integers(0, 2, n).astype(np.int8)
    want = int(np.bitwise_xor.reduce(_remainder_words(poly, n)[bits == 1],
                                     initial=np.uint32(0)))
    for step in (32, 13):
        starts = np.arange(0, n, step)
        tabs = ldpc_encode._word_shares(poly, n, starts)
        got = 0
        for s, tab in zip(starts, tabs):
            width = min(step, n - s)
            word = sum(int(bits[s + b]) << b for b in range(width))
            got ^= _share(word, tab, length, g | 1 << length)
        assert got == want
    assert not ldpc_encode._word_shares(poly, n, np.array([n, n + 40])).any()


def _rot(col, z, w, s):
    """csrc/ldpc_encode.cu rot(): word w of a packed column rotated by s
    (bit b is column bit (32 w + b + s) mod z)."""
    if z < 32:
        mask = (1 << z) - 1
        v = col[0] & mask
        return ((v >> s) | (v << (z - s))) & mask if s else v
    p0 = 32 * w + s
    if p0 >= z:
        p0 -= z
    q, r = p0 >> 5, p0 & 31
    v = ((col[q] | col[q + 1] << 32) >> r) & M32
    m = z - p0
    if m < 32:
        v = (v & ((1 << m) - 1)) | ((col[0] << m) & M32)
    return v


def _model_encode_columns(p, cols):
    """The kernel's encode on packed columns (lists of nw + 1 ints; the
    info columns filled): core sums, p0, the three steps, the extension
    rows, as csrc/ldpc_encode.cu orders them."""
    z, nw, kb = p.z, p.nw, p.kb
    ws = nw + 1

    def col_of(off):
        return cols[off // ws]

    cs = [[0] * ws for _ in range(4)]
    for r in range(4):
        for w in range(nw):
            a = 0
            for e in p.edge[p.row_ptr[r]:p.row_ptr[r + 1]]:
                if (e & 0xffff) < kb * ws:
                    a ^= _rot(col_of(e & 0xffff), z, w, e >> 16)
            cs[r][w] = a
    s0 = z - p.core[0] if p.core[0] else 0
    for w in range(nw):
        cols[kb][w] = (_rot(cs[0], z, w, s0) ^ _rot(cs[1], z, w, s0)
                       ^ _rot(cs[2], z, w, s0) ^ _rot(cs[3], z, w, s0))
    for st in range(3):
        step = p.core[1 + 9 * st:10 + 9 * st]
        r, target, nterms = step[0], step[1], step[2]
        for w in range(nw):
            a = cs[r][w]
            for t in range(nterms):
                a ^= _rot(cols[step[3 + 2 * t]], z, w, step[4 + 2 * t])
            cols[target][w] = a
    for r in range(4, p.nrows):
        for w in range(nw):
            a = 0
            for e in p.edge[p.row_ptr[r]:p.row_ptr[r + 1]]:
                if (e & 0xffff) < (kb + 4) * ws:
                    a ^= _rot(col_of(e & 0xffff), z, w, e >> 16)
            cols[kb + r][w] = a
    return cols


def _unpack(cols, z, first=0):
    return np.array([(cols[c][j >> 5] >> (j & 31)) & 1
                     for c in range(first, len(cols)) for j in range(z)],
                    dtype=np.int8)


def _pack(bits, z, nw):
    """Columns of z bits to words, 32 bits a word (as the ballots pack)."""
    cols = []
    for c in range(len(bits) // z):
        words = [0] * (nw + 1)
        for j in range(z):
            words[j >> 5] |= int(bits[c * z + j]) << (j & 31)
        cols.append(words)
    return cols


@pytest.mark.parametrize("tbs,bg", ENCODE_CASES)
def test_packed_encode_matches_jax(tbs, bg):
    """The packed rotate-and-XOR encoder on the struct against JAX
    ``ldpc_encode.encode``, on random codeblocks with fillers 0."""
    seg = j_segment(tbs, bg)
    z = seg.lifting_size
    p = ldpc_encode._encode_params(tbs, bg, 1)
    rng = np.random.default_rng(z)
    msg = rng.integers(0, 2, (2, p.kb * z)).astype(np.int8)
    msg[:, seg.cb_info_bits:] = 0
    want = np.asarray(j_enc.encode(jnp.asarray(msg), bg, z))
    for m, w in zip(msg, want):
        cols = _pack(m, z, p.nw) + [[0] * (p.nw + 1)
                                    for _ in range(p.ncols - p.kb)]
        np.testing.assert_array_equal(
            _unpack(_model_encode_columns(p, cols), z), w)


def _model_dlsch(tb, bg):
    """csrc/ldpc_encode.cu on its struct and tables, the CTAs in turn (the
    TB CRC's shares of every codeblock first, as the codeblocks holding
    TB CRC bits wait for them)."""
    p = ldpc_encode._encode_params(len(tb), bg, 1)
    cb_tab, tb_tab = ldpc_encode._crc_word_tables(len(tb), bg)
    z, nw, kb, ws = p.z, p.nw, p.kb, p.nw + 1
    ltb, tbp, cbp = p.tb_crc_len, p.tb_poly, p.cb_poly
    packed, cb_accs, tb_crc = [], [], 0
    for cb in range(p.ncb):
        cols = [[0] * ws for _ in range(p.ncols)]
        for c in range(kb):
            for w in range(nw):
                word = 0
                for lane in range(32):
                    j = 32 * w + lane
                    i = c * z + j
                    g = cb * p.ppc + i
                    if j < z and i < p.ppc and g < p.tbs:
                        word |= (int(tb[g]) & 1) << lane
                cols[c][w] = word
        cb_acc = 0
        for k in range(kb * nw):
            word = cols[k // nw][k % nw]
            if p.cb_crc_len:
                cb_acc ^= _share(word, cb_tab[k], 24, cbp)
            tb_crc ^= _share(word, tb_tab[cb * kb * nw + k], ltb, tbp)
        packed.append(cols)
        cb_accs.append(cb_acc)
    out = []
    for cb, (cols, cb_acc) in enumerate(zip(packed, cb_accs)):
        cb0 = cb * p.ppc
        for t in range(ltb):
            g = p.tbs + t
            if cb0 <= g < cb0 + p.ppc and (tb_crc >> (ltb - 1 - t)) & 1:
                i = g - cb0
                c, j = divmod(i, z)
                cols[c][j >> 5] |= 1 << (j & 31)
                if p.cb_crc_len:
                    cb_acc ^= _share(1 << (j & 31), cb_tab[c * nw + (j >> 5)],
                                     24, cbp)
        for t in range(p.cb_crc_len):
            if (cb_acc >> (23 - t)) & 1:
                c, j = divmod(p.ppc + t, z)
                cols[c][j >> 5] |= 1 << (j & 31)
        out.append(_unpack(_model_encode_columns(p, cols), z, first=2))
    return np.stack(out)


@pytest.mark.parametrize("tbs,bg", ENCODE_CASES)
def test_dlsch_kernel_model(tbs, bg):
    """The whole kernel modelled: against the twin, and against the JAX
    CRCs (TB CRC, CB CRC24B) and JAX ``encode`` of the segmented block."""
    tb = np.random.default_rng(tbs).integers(0, 2, tbs).astype(np.int8)
    got = _model_dlsch(tb, bg)
    np.testing.assert_array_equal(
        got, ldpc_encode.dlsch_encode_ref(torch.as_tensor(tb), bg).numpy())
    seg = j_segment(tbs, bg)
    b = jnp.concatenate([jnp.asarray(tb), j_crc.crc(
        jnp.asarray(tb)[None], "crc24A" if seg.tb_crc_bits == 24
        else "crc16")[0]])
    ppc = seg.cb_info_bits - seg.cb_crc_bits
    b = jnp.concatenate([b, jnp.zeros(ppc * seg.nof_codeblocks - b.shape[0],
                                      b.dtype)]).reshape(-1, ppc)
    if seg.cb_crc_bits:
        b = jnp.concatenate([b, j_crc.crc(b, "crc24B")], axis=-1)
    b = jnp.concatenate([b, jnp.zeros((b.shape[0], seg.full_block_bits
                                       - seg.cb_info_bits), b.dtype)], axis=-1)
    want = np.asarray(j_enc.encode(b, bg, seg.lifting_size))
    np.testing.assert_array_equal(got, want[:, 2 * seg.lifting_size:])
