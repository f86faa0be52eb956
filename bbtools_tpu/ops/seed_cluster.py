"""Device seed expansion + diagonal clustering for BBMap.

The reference's quickMap seed walk (align2/BBIndex.findAdvanced :433:
per key fetch the Block site list, offset-shift, heap-merge, sweep-count
votes) ran as vectorized HOST numpy in rounds 1-2 (models/bbmap.py
candidates_for_batch) — the host half of config #3. This module moves
it on-device:

  1. per-key site counts: two gathers into the CSR `starts` plane
  2. ragged expansion to flat (site, owner) rows with a STATIC cap,
     built with the sorted-join trick: a (boundaries | slots) sort +
     cumsum replaces both scatter (the ~14M/s wall) and per-slot binary
     search
  3. site gather + diagonal shift
  4. cluster by (group, diag) with one packed single-operand sort;
     votes, spreads, and modal diagonals fall out of stable boundary
     partitions (the sort_reduce pattern) — no row gathers
  5. top-`max_sites` clusters per (read, strand) by votes with the host
     path's exact lexsort tie-breaks

Outputs equal models/bbmap.candidates_for_batch exactly (tested): same
values, same order. Overflow of the static site cap returns ok=False
and the caller falls back to the host path for that batch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_SENT = jnp.int64(0x7FFFFFFFFFFFFFFF)


def _ragged_src(cnt, t_cap: int):
    """src[t] = run index covering flat slot t, for run sizes cnt [N]
    (the inverse of np.repeat). Boundary rows (run ends) and slot rows
    sort together; a cumsum of boundary flags read at each slot row IS
    the run index."""
    cum = jnp.cumsum(cnt.astype(jnp.int64))
    bkeys = cum << 1  # boundary at run end, ties before the equal slot
    skeys = (jnp.arange(t_cap, dtype=jnp.int64) << 1) | 1
    sk = jnp.sort(jnp.concatenate([bkeys, skeys]))
    is_b = (sk & 1) == 0
    nb_before = jnp.cumsum(is_b.astype(jnp.int32))
    # un-sort the slot rows back to t order (slot positions are unique)
    slot_key = jnp.where(is_b, _SENT, sk >> 1)
    _, src = jax.lax.sort((slot_key, nb_before), num_keys=1)
    return src[:t_cap]


def _partition_front(flag, payload):
    """Stable partition: rows with flag=True first (in original order),
    carrying an int64 payload. Returns payload reordered."""
    n = flag.shape[0]
    key = ((~flag).astype(jnp.int64) << 32) | jnp.arange(n, dtype=jnp.int64)
    _, out = jax.lax.sort((key, payload), num_keys=1)
    return out


@partial(
    jax.jit,
    static_argnames=("B", "K", "t_cap", "c_cap", "max_sites", "bridge"),
)
def seed_candidates_jnp(
    fwd_keys, rkm_keys, valid0, valid1, offs,
    starts32, sites, B: int, K: int, t_cap: int, c_cap: int,
    max_sites: int, bridge: int,
):
    """Device candidates_for_batch; see module docstring.

    Returns (read i32, diag i64, strand i32, votes i64, spread i64,
    modal i64, n_out i32, ok bool, nclusters i32[B]) — fixed-cap
    [c_cap] arrays, rows >= n_out are padding; nclusters is the
    PRE-cap cluster census per read (both strands), feeding the
    CLEARZONE1e many-near-best-sites limit (BBMapThread.java:619-627,
    CLEARZONE_LIMIT1e) which needs the true site count, not the capped
    list length."""
    keys = jnp.stack([fwd_keys, rkm_keys])  # [2, B, K] i32
    valid = jnp.stack([valid0, valid1])
    flat_keys = keys.reshape(-1)
    flat_valid = valid.reshape(-1)
    flat_off = jnp.broadcast_to(
        offs.astype(jnp.int64)[None], (2, B, K)
    ).reshape(-1)
    nslots = flat_keys.shape[0]
    kk = jnp.clip(flat_keys, 0, starts32.shape[0] - 2)
    s0 = starts32[kk]
    s1 = starts32[kk + 1]
    cnt = jnp.where(flat_valid, s1 - s0, 0)
    total = cnt.sum()
    ok = total <= t_cap
    src = jnp.clip(_ragged_src(cnt, t_cap), 0, nslots - 1)
    t_iota = jnp.arange(t_cap, dtype=jnp.int64)
    live = t_iota < total
    cum_excl = (jnp.cumsum(cnt.astype(jnp.int64)) - cnt)[src]
    site_idx = s0[src].astype(jnp.int64) + (t_iota - cum_excl)
    site = sites[jnp.clip(site_idx, 0, sites.shape[0] - 1)]
    diag = site.astype(jnp.int64) - flat_off[src]
    strand = (src // (B * K)).astype(jnp.int64)
    read = ((src // K) % B).astype(jnp.int64)
    group = read * 2 + strand

    # ---- cluster: one packed sort by (group, diag) ----
    BIAS = jnp.int64(1) << 40
    packed = jnp.where(live, (group << 42) | (diag + BIAS), _SENT)
    sp = jnp.sort(packed)
    slive = sp != _SENT
    g = jnp.where(slive, sp >> 42, jnp.int64(-1))
    d = jnp.where(slive, (sp & ((jnp.int64(1) << 42) - 1)) - BIAS,
                  jnp.int64(0))
    prev_g = jnp.concatenate([jnp.full(1, -2, jnp.int64), g[:-1]])
    prev_d = jnp.concatenate([jnp.zeros(1, jnp.int64), d[:-1]])
    boundary = slive & ((g != prev_g) | (d - prev_d > bridge))
    n_clusters = boundary.sum().astype(jnp.int32)
    nvalid = slive.sum().astype(jnp.int32)
    iota32 = jnp.arange(t_cap, dtype=jnp.int32)

    # per-cluster planes (row c = cluster c, ascending group/diag):
    # start pos + start diag + group via boundary partition
    bpos = _partition_front(boundary, iota32.astype(jnp.int64))
    firsts = _partition_front(boundary, d)
    cgroup = _partition_front(boundary, g)
    nxt = jnp.concatenate([bpos[1:], jnp.zeros(1, jnp.int64)])
    clive = iota32 < n_clusters
    lastc = iota32 == n_clusters - 1
    votes = jnp.where(
        clive, jnp.where(lastc, nvalid.astype(jnp.int64), nxt) - bpos, 0
    )
    # end diag: the last live row of each cluster, gather-free
    next_b = jnp.concatenate([boundary[1:], jnp.ones(1, bool)])
    is_last = slive & (
        next_b | (jnp.arange(t_cap) == nvalid.astype(jnp.int64) - 1)
    )
    end_d = _partition_front(is_last, d)
    spread = jnp.where(clive, end_d - firsts, 0)

    # ---- modal diagonal: runs of equal (cluster, diag) ----
    cid = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    run_b = slive & (boundary | (d != prev_d))
    n_runs = run_b.sum().astype(jnp.int32)
    rpos = _partition_front(run_b, iota32.astype(jnp.int64))
    rcl = _partition_front(run_b, cid.astype(jnp.int64))
    rdg = _partition_front(run_b, d)
    rnxt = jnp.concatenate([rpos[1:], jnp.zeros(1, jnp.int64)])
    rlive = iota32 < n_runs
    rlast = iota32 == n_runs - 1
    rcount = jnp.where(
        rlive, jnp.where(rlast, nvalid.astype(jnp.int64), rnxt) - rpos, 0
    )
    # host: lexsort((-rcount, rcluster)) stable; first row per cluster
    # wins -> pack (cluster, count-desc, run index) and sort
    MAXC = jnp.int64(1) << 21
    rpack = jnp.where(
        rlive,
        (rcl << 43) | ((MAXC - rcount) << 22) | iota32.astype(jnp.int64),
        _SENT,
    )
    rsp, rdg_s = jax.lax.sort((rpack, rdg), num_keys=1)
    rcl_s = jnp.where(rsp != _SENT, rsp >> 43, jnp.int64(-1))
    firstrun = jnp.concatenate(
        [jnp.ones(1, bool), rcl_s[1:] != rcl_s[:-1]]
    ) & (rcl_s >= 0)
    modal = _partition_front(firstrun, rdg_s)  # row c = cluster c

    # ---- top max_sites per group by votes (lexsort semantics) ----
    MAXV = jnp.int64(1) << 29
    cpack = jnp.where(
        clive,
        (cgroup << 43)
        | ((MAXV - votes) << 14)
        | jnp.minimum(iota32, (1 << 14) - 1).astype(jnp.int64),
        _SENT,
    )
    csp, csel = jax.lax.sort(
        (cpack, iota32.astype(jnp.int64)), num_keys=1
    )
    cg_s = jnp.where(csp != _SENT, csp >> 43, jnp.int64(-1))
    gb = jnp.concatenate(
        [jnp.ones(1, bool), cg_s[1:] != cg_s[:-1]]
    ) & (cg_s >= 0)
    laststart = jax.lax.cummax(
        jnp.where(gb, iota32, jnp.int32(-1))
    )
    rank = iota32 - laststart
    keep = (cg_s >= 0) & (rank < max_sites)
    sel = jnp.clip(
        _partition_front(keep, csel)[:c_cap], 0, t_cap - 1
    )
    n_out = jnp.minimum(keep.sum(), c_cap).astype(jnp.int32)
    # pre-cap cluster census per read: csp is sorted with group in the
    # top bits (dead rows at the end), so per-read counts are two
    # binary searches on the group plane — no scatter
    cg_sorted = jnp.where(csp != _SENT, csp >> 43, jnp.int64(2 * B))
    qpts = jnp.arange(B + 1, dtype=jnp.int64) * 2
    bnds = jnp.searchsorted(cg_sorted, qpts)
    nclusters = jnp.diff(bnds).astype(jnp.int32)
    out_group = cgroup[sel]
    return (
        (out_group // 2).astype(jnp.int32),
        firsts[sel],
        (out_group & 1).astype(jnp.int32),
        votes[sel],
        spread[sel],
        modal[sel],
        n_out,
        ok,
        nclusters,
    )
