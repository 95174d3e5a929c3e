"""PDSCH resource allocation: type 0/1 + VRB-to-PRB interleaved mapping.

Host-side analogue of lib/phy/upper/rb_allocation.cpp (make_type0 /
make_type1 / make_custom with an optional vrb_to_prb configuration) and
the TS38.211 §7.3.1.6 block interleaver
(include/srsran/ran/resource_allocation/vrb_to_prb.h).  Everything here
resolves to ONE sorted PRB index list on the host; the device-side index
plans (data REs, DM-RS combs, PRG indices) consume that list, in place
of the reference's mask-driven mappers.

The port's own copy of srsran_tpu/ran/rb_allocation.py, with its faults
(a guessed BWP size for interleaved allocations without one; unaligned
BWP starts rejected): the port imports nothing of the JAX package.
tests/test_torch_host_plans.py pins the copy to its original.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def vrb_to_prb_interleaved(bwp_start: int, bwp_size: int,
                           bundle_size: int = 2) -> tuple:
    """TS38.211 §7.3.1.6 interleaved VRB->PRB map over a BWP.

    Returns prb_of_vrb: tuple [bwp_size] — absolute PRB (CRB) index for
    each VRB 0..bwp_size-1.  Bundles of L RBs, block interleaver with
    R=2 rows, C = floor(N_bundle/R): bundle j = cR+r maps to f(j) = rC+c;
    the last bundle maps to itself.  Supported for L-aligned BWP starts
    (bwp_start % L == 0, every interleaved bundle full-size) — the
    common deployment; the reference's first/last short-bundle corner is
    rejected rather than silently mis-mapped.
    """
    l = bundle_size
    assert l in (2, 4), "bundle size must be 2 or 4 (interleaved_n2/n4)"
    assert bwp_start % l == 0, \
        "interleaved mapping supported for L-aligned BWP starts"
    n_bundle = -(-bwp_size // l)
    r = 2
    c = n_bundle // r
    f = np.arange(n_bundle)
    if n_bundle > 1:
        j = np.arange(n_bundle - 1)
        f[:n_bundle - 1] = (j % r) * c + j // r
        f[n_bundle - 1] = n_bundle - 1
    prb_of_vrb = np.zeros(bwp_size, dtype=np.int64)
    for jb in range(n_bundle):
        size = min(l, bwp_size - jb * l)
        for k in range(size):
            prb_of_vrb[jb * l + k] = bwp_start + f[jb] * l + k
    return tuple(int(p) for p in prb_of_vrb)


def allocated_prbs(rb_start: int, rb_count: int,
                   prbs: tuple | None = None,
                   interleaved: bool = False,
                   bwp_start: int = 0, bwp_size: int | None = None,
                   bundle_size: int = 2) -> np.ndarray:
    """Resolve a PDU's allocation to sorted PRB indices.

    prbs given  -> RA type 0 (explicit bitmap as index tuple), used as-is.
    interleaved -> RA type 1 VRBs [rb_start, rb_start+rb_count) through
                   the §7.3.1.6 interleaver over the BWP.
    otherwise   -> contiguous type-1 allocation.
    """
    if prbs is not None:
        return np.array(sorted(prbs), dtype=np.int64)
    if interleaved:
        size = bwp_size if bwp_size is not None else rb_start + rb_count
        m = vrb_to_prb_interleaved(bwp_start, size, bundle_size)
        return np.array(sorted(m[rb_start - bwp_start + i]
                               for i in range(rb_count)), dtype=np.int64)
    return np.arange(rb_start, rb_start + rb_count, dtype=np.int64)
