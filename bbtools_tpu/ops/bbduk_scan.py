"""Batched BBDuk k-mer scan kernels (device, jit-able).

The reference per-read loops (bbduk/BBDukProcessorS.java countSetKmers
:1534, ktrim :1993, ktrimTip :1835, and the short-kmer Scanning4/Scanning5
loops) become one batched pure function: [B, L] base codes in, per-read
decisions out. The early-exit in countSetKmers only affects which hit
credits the scaffold counter, so the batched version computes hit count
without early exit and separately selects the (maxBadKmers+1)-th hit's id —
identical observable behavior.

All kernels are shape-static given (L, config); jit once per length bucket.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from .kmer_index import BucketKmerIndex
from .kmers import length_mask, rolling_kmers_jnp

BIG = jnp.int32(999999999)


@dataclass(frozen=True)
class KScanConfig:
    k: int
    mink: int = 0  # 0 disables short kmers
    minlen2: int = 0  # defaults to k when 0
    mid_mask: int = -1
    restrict_left: int = 0
    restrict_right: int = 0
    qhdist: int = 0
    #: speed=0-16 sampling (BBDukIndexAndLoader.java:997): kmers with
    #: (key & MAX_LONG) % 17 < speed are ignored at scan time (the load
    #: side applies the same test in build_ref_keys)
    speed: int = 0
    qskip: int = 1  # look up every qskip-th query position only
    nb: int = 64  # bucket count of the BucketKmerIndex (static)
    packed: bool = False  # BucketKmerIndex key48|id16 single-plane layout
    rcomp: bool = True
    #: >1 when running under shard_map with the bucket table sharded by
    #: key % tp_shards over the 'tp' mesh axis: each device looks up its
    #: own shard and a psum combines (exactly one shard can hit) — the
    #: kmer%WAYS layout of kmer/KmerTableSet.java:273-285 across devices
    tp_shards: int = 0

    def resolved_minlen2(self) -> int:
        return self.minlen2 if self.minlen2 > 0 else self.k


def _lookup(cfg: KScanConfig, table, keys):
    keys_tbl, ids_tbl = table
    if cfg.tp_shards > 1:
        # sharded bucket table (inside shard_map): probe the local shard
        # for keys it owns; the psum IS the select — misses contribute 0
        # and exactly one shard can hit a given key
        part = BucketKmerIndex.lookup_jnp(keys_tbl, ids_tbl, cfg.nb, keys)
        mine = (keys % cfg.tp_shards) == jax.lax.axis_index("tp")
        return jax.lax.psum(jnp.where(mine, part, 0), "tp")
    if cfg.packed:
        return BucketKmerIndex.lookup_packed_jnp(keys_tbl, cfg.nb, keys)
    return BucketKmerIndex.lookup_jnp(keys_tbl, ids_tbl, cfg.nb, keys)


def _mutants_lookup_first(cfg: KScanConfig, table, fwd, klen, mm, lmask):
    """Look up ALL 4*klen single-sub mutants of fwd in one batched bucket
    lookup; return (hit_any, first_hit_id) in reference (j-major, i-minor)
    order. One lookup = 2 gathers regardless of the mutant count, so this
    costs the same gather budget as the exact lookup."""
    muts = []
    differs = []
    for j in range(4):
        for i in range(klen):
            clear = ~(jnp.int64(3) << (2 * i))
            temp = (fwd & clear) | (jnp.int64(j) << (2 * i))
            muts.append(temp)
            differs.append(temp != fwd)
    temp_all = jnp.stack(muts, axis=-1)  # [..., M] in (j, i) order
    diff_all = jnp.stack(differs, axis=-1)
    rtemp_all = _rc_jnp(temp_all, klen)
    mx_all = jnp.maximum(temp_all, rtemp_all) if cfg.rcomp else temp_all
    keys_all = (mx_all & mm) | jnp.int64(lmask)
    cand = _lookup(cfg, table, keys_all)  # one lookup: 2 gathers
    valid = (cand > 0) & diff_all
    first = jnp.argmax(valid, axis=-1)  # first hit in (j, i) order
    hit = valid.any(axis=-1)
    chosen = jnp.take_along_axis(cand, first[..., None], axis=-1)[..., 0]
    return hit, chosen


def _qhdist_rec(cfg: KScanConfig, table, fwd, klen, mm, lmask, depth):
    """getValue(kmer, qHDist=depth): exact lookup, then depth-first
    single-sub mutant retries in (symbol, position) order, first hit wins
    (BBDukIndexMod.getValue :461-478).

    depth==1 resolves all mutants in ONE batched lookup; depth>=2 wraps a
    lax.scan over the outer mutant axis (4*klen steps), each step running
    the depth-1 batched lookup on its mutant — memory stays at the
    depth-1 footprint while preserving exact DFS first-hit order."""
    rkm = _rc_jnp(fwd, klen)
    mx = jnp.maximum(fwd, rkm) if cfg.rcomp else fwd
    key = (mx & mm) | jnp.int64(lmask)
    out = _lookup(cfg, table, key)
    if depth <= 0:
        return out
    if depth == 1:
        hit, chosen = _mutants_lookup_first(cfg, table, fwd, klen, mm, lmask)
        return jnp.where((out < 1) & hit, chosen, out)

    def body(carry, m):
        j = m // klen
        i = m % klen
        clear = ~(jnp.int64(3) << (2 * i).astype(jnp.int64))
        temp = (fwd & clear) | (j.astype(jnp.int64) << (2 * i).astype(jnp.int64))
        differs = temp != fwd
        sub = _qhdist_rec(cfg, table, temp, klen, mm, lmask, depth - 1)
        carry = jnp.where((carry < 1) & differs & (sub > 0), sub, carry)
        return carry, None

    out, _ = jax.lax.scan(body, out, jnp.arange(4 * klen, dtype=jnp.int32))
    return out


def _lookup_qhdist(cfg: KScanConfig, table, fwd, rkm, klen, lmask):
    """getValue with qhdist mutation retries; see _qhdist_rec."""
    mm = jnp.int64(cfg.mid_mask if klen == cfg.k else -1)
    if cfg.qhdist <= 0:
        mx = jnp.maximum(fwd, rkm) if cfg.rcomp else fwd
        key = (mx & mm) | jnp.int64(lmask)
        return _lookup(cfg, table, key)
    return _qhdist_rec(cfg, table, fwd, klen, mm, lmask, cfg.qhdist)


def _rc_jnp(kmer, k: int):
    out = jnp.zeros_like(kmer)
    x = kmer
    for _ in range(k):
        out = (out << 2) | (3 - (x & 3))
        x = x >> 2
    return out


def _scan_bounds(cfg: KScanConfig, lengths):
    """start/stop per read (restrictLeft/Right, BBDukProcessorS:1543-1544)."""
    start = jnp.where(
        cfg.restrict_right < 1,
        jnp.zeros_like(lengths),
        jnp.maximum(0, lengths - cfg.restrict_right),
    )
    stop = jnp.where(
        cfg.restrict_left < 1,
        lengths,
        jnp.minimum(lengths, cfg.restrict_left),
    )
    return start, stop


@partial(jax.jit, static_argnames=("cfg",))
def kscan_full(cfg: KScanConfig, table, bases, lengths, bound_start=None,
               bound_stop=None):
    """Full-k scan shared by filter and trim modes.

    Returns dict with per-read:
      nhits      — number of eligible hit positions
      id0        — id of the first hit (scan order), 0 if none
      min_loc    — min(i - k + 1) over hits (BIG if none)
      max_loc    — max(i) over hits (-1 if none)
      id_at      — function input `credit_hit` selects which ordinal hit's
                   id to credit (filter mode passes maxBadKmers); returned
                   as ids_sorted-by-position array reduction
      hit_pos    — [B, L] bool eligible-hit mask (for covered-bases mode)
      ids_pos    — [B, L] int32 ids at hit positions
    """
    B, L = bases.shape
    fwd, rkm, runlen = rolling_kmers_jnp(bases, cfg.k)
    start, stop = _scan_bounds(cfg, lengths)
    if bound_start is not None:
        # per-read extra bounds (ktrimTips passes mid-based ranges,
        # BBDukProcessorS.ktrimTips :1813-1826)
        start = jnp.maximum(start, bound_start)
    if bound_stop is not None:
        stop = jnp.minimum(stop, bound_stop)
    i_idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    eligible = (
        (runlen >= cfg.resolved_minlen2())
        & (i_idx >= cfg.k - 1)
        & (i_idx >= start[:, None])
        & (i_idx < stop[:, None])
    )
    if cfg.qskip > 1:
        eligible &= (i_idx % cfg.qskip) == 0
    if cfg.speed > 0:
        mx = jnp.maximum(fwd, rkm) if cfg.rcomp else fwd
        key0 = (mx & jnp.int64(cfg.mid_mask)) | jnp.int64(length_mask(cfg.k))
        eligible &= (
            (key0 & jnp.int64(0x7FFFFFFFFFFFFFFF)) % jnp.int64(17)
        ) >= cfg.speed
    ids = _lookup_qhdist(cfg, table, fwd, rkm, cfg.k, length_mask(cfg.k))
    ids = jnp.where(eligible, ids, 0)
    hit = ids > 0
    nhits = hit.sum(axis=1, dtype=jnp.int32)
    # first/last hit and its id via compare-sum selects: row gathers
    # (ids[arange(B), pos]) run at the ~50M rows/s random-access wall,
    # a [B, L] masked reduce is pure elementwise work
    first_pos = jnp.min(jnp.where(hit, i_idx, BIG), axis=1)
    id0 = jnp.where(
        nhits > 0,
        jnp.sum(jnp.where(i_idx == first_pos[:, None], ids, 0), axis=1),
        0,
    )
    min_loc = jnp.where(
        nhits > 0, first_pos.astype(jnp.int32) - (cfg.k - 1), BIG
    )
    max_loc = jnp.max(jnp.where(hit, i_idx, -1), axis=1).astype(jnp.int32)
    return {
        "nhits": nhits,
        "id0": id0,
        "min_loc": min_loc,
        "max_loc": max_loc,
        "hit": hit,
        "ids": ids,
    }


@partial(jax.jit, static_argnames=("cfg",))
def credit_id(cfg: KScanConfig, ids, credit_ordinal):
    """Id of the (credit_ordinal+1)-th hit per read (0 if fewer hits).
    Used by filter mode: countSetKmers credits the hit at found==maxBadKmers
    (BBDukProcessorS.java:1580-1588)."""
    hit = ids > 0
    order = jnp.cumsum(hit, axis=1) - 1  # ordinal of each hit
    sel = hit & (order == credit_ordinal[:, None])
    # at most one position matches per row: compare-sum select (no gather)
    return jnp.sum(jnp.where(sel, ids, 0), axis=1)


@partial(jax.jit, static_argnames=("cfg", "left"))
def kscan_short(cfg: KScanConfig, table, bases, lengths, left: bool):
    if cfg.restrict_left < 1 and cfg.restrict_right < 1 and cfg.qhdist == 0:
        return _kscan_short_fast(cfg, table, bases, lengths, left)
    return _kscan_short_loop(cfg, table, bases, lengths, left)


def _kscan_short_fast(cfg: KScanConfig, table, bases, lengths, left: bool):
    """Gather-light short-kmer scan: prefix/suffix kmers of every length
    are bit-slices of the rolling registers (one take_along_axis for the
    read-end values; static columns for the read-start values)."""
    from .kmers import rolling_kmers_plain_jnp

    B, L = bases.shape
    k, mink = cfg.k, cfg.mink
    fwd, rkm, rkm_plain, runlen = rolling_kmers_plain_jnp(bases, k)
    keys_l, live_l, i_l = [], [], []
    if left:
        # prefix of length ln ends at static column ln-1:
        #   kmer  = fwd[:, ln-1] & ((1<<2ln)-1)   (register low bits)
        #   rkmer = rkm_plain[:, ln-1] >> 2(k-ln)
        for ln in range(mink, k + 1):
            col = ln - 1
            kmer = fwd[:, col] & jnp.int64((1 << (2 * ln)) - 1)
            rkmer = rkm_plain[:, col] >> (2 * (k - ln))
            mx = jnp.maximum(kmer, rkmer) if cfg.rcomp else kmer
            keys_l.append(mx | jnp.int64(length_mask(ln)))
            # loop bound: i < min(k, stop) with stop = length
            live_l.append(col < jnp.minimum(jnp.int32(k), lengths))
            i_l.append(jnp.full((B,), col, jnp.int32))
    else:
        # suffix of length ln ends at the read's last base; masked-sum
        # select instead of a row gather (gathers run at the
        # random-access wall, a [B, L] reduce is elementwise work)
        last = jnp.maximum(lengths - 1, 0)[:, None]
        pos_i = jnp.arange(L, dtype=jnp.int32)[None, :]
        at_last = pos_i == last
        f_end = jnp.sum(jnp.where(at_last, fwd, 0), axis=1)
        r_end = jnp.sum(jnp.where(at_last, rkm_plain, 0), axis=1)
        for ln in range(mink, k + 1):
            kmer = f_end & jnp.int64((1 << (2 * ln)) - 1)
            rkmer = r_end >> (2 * (k - ln))
            mx = jnp.maximum(kmer, rkmer) if cfg.rcomp else kmer
            keys_l.append(mx | jnp.int64(length_mask(ln)))
            # loop: i from stop-1 down, i > max(-1, stop-k); hit position
            # i = stop - ln
            i_pos = (lengths - ln).astype(jnp.int32)
            live_l.append(i_pos > jnp.maximum(-1, lengths - k) + 1 - 1)
            i_l.append(i_pos)
    # stack on axis 0: [n_lens, B], the layout the lookups consume
    keys = jnp.stack(keys_l, axis=0)
    live = jnp.stack(live_l, axis=0)
    pos = jnp.stack(i_l, axis=0)
    ids = jnp.where(live, _lookup(cfg, table, keys), 0)
    hit = ids > 0
    any_hit = hit.any(axis=0)
    first = jnp.argmax(hit, axis=0)
    ln_idx = jnp.arange(ids.shape[0], dtype=jnp.int32)[:, None]
    id0 = jnp.where(
        any_hit,
        jnp.sum(jnp.where(ln_idx == first[None, :], ids, 0), axis=0),
        0,
    )
    if left:
        loc = jnp.where(hit, pos, -1).max(axis=0)
    else:
        loc = jnp.where(hit, pos, BIG).min(axis=0)
    return any_hit, id0, loc


def _kscan_short_loop(cfg: KScanConfig, table, bases, lengths, left: bool):
    """Short-kmer end scan (Scanning4/Scanning5, BBDukProcessorS
    :2036-2106). Only meaningful when the full scan found nothing.

    Returns (any_hit, id0, loc) where loc is:
      left scan:  max hit index i (maxLoc candidate)
      right scan: min hit index i (minLoc candidate)
    Undefined bases contribute code 0 with no reset (matching the
    reference's short-kmer loops, which have no N handling).

    Candidate keys for every short length are collected first (cheap
    register arithmetic), then resolved with ONE batched table lookup —
    keeping the compiled probe chain short.
    """
    B, L = bases.shape
    codes = bases.astype(jnp.int32)
    code0 = jnp.where(codes < 4, codes, 0).astype(jnp.int64)
    comp0 = jnp.where(codes < 4, 3 - codes, 0).astype(jnp.int64)
    start, stop = _scan_bounds(cfg, lengths)
    k, mink = cfg.k, cfg.mink
    mask = jnp.int64((1 << (2 * k)) - 1)
    kmer = jnp.zeros(B, dtype=jnp.int64)
    rkmer = jnp.zeros(B, dtype=jnp.int64)
    keys_l: list = []  # per short length: canonical key [B]
    live_l: list = []  # per short length: in-bounds mask [B]
    i_l: list = []  # per short length: absolute position [B]
    # short-kmer scans route through the same batched-mutant lookup
    for step in range(k):
        if left:
            i = start + step
            ii = jnp.minimum(i, L - 1)[:, None].astype(jnp.int32)
            x = jnp.take_along_axis(code0, ii, axis=1)[:, 0]
            x2 = jnp.take_along_axis(comp0, ii, axis=1)[:, 0]
            kmer = ((kmer << 2) | x) & mask
            rkmer = rkmer | (x2 << (2 * step))
            # loop bound: i < min(k, stop)  (BBDukProcessorS:2041 lim)
            live = i < jnp.minimum(jnp.int32(k), stop)
        else:
            i = stop - 1 - step
            live = i >= jnp.maximum(-1, stop - k) + 1
            ii = jnp.clip(i, 0, L - 1)[:, None].astype(jnp.int32)
            x = jnp.take_along_axis(code0, ii, axis=1)[:, 0]
            x2 = jnp.take_along_axis(comp0, ii, axis=1)[:, 0]
            kmer_new = kmer | (x << (2 * step))
            rkmer_new = ((rkmer << 2) | x2) & mask
            kmer = jnp.where(live, kmer_new, kmer)
            rkmer = jnp.where(live, rkmer_new, rkmer)
        ln = step + 1
        if ln >= mink:
            if cfg.qhdist > 0:
                # one batched-mutant lookup per short length
                keys_l.append(
                    _lookup_qhdist(
                        cfg, table, kmer, rkmer, ln, length_mask(ln)
                    )
                )
            else:
                mx = jnp.maximum(kmer, rkmer) if cfg.rcomp else kmer
                keys_l.append(mx | jnp.int64(length_mask(ln)))
            live_l.append(live)
            i_l.append(i)
    keys = jnp.stack(keys_l, axis=1)  # [B, S]
    live = jnp.stack(live_l, axis=1)
    pos = jnp.stack(
        [jnp.broadcast_to(x, (B,)).astype(jnp.int32) for x in i_l], axis=1
    )
    if cfg.qhdist > 0:
        ids = jnp.where(live, keys, 0)  # keys already hold looked-up ids
    else:
        ids = jnp.where(live, _lookup(cfg, table, keys), 0)  # [B, S]
    hit = ids > 0
    any_hit = hit.any(axis=1)
    first = jnp.argmax(hit, axis=1)
    s_idx = jnp.arange(ids.shape[1], dtype=jnp.int32)[None, :]
    id0 = jnp.where(
        any_hit,
        jnp.sum(jnp.where(s_idx == first[:, None], ids, 0), axis=1),
        0,
    )
    if left:
        loc = jnp.where(hit, pos, -1).max(axis=1)
    else:
        loc = jnp.where(hit, pos, BIG).min(axis=1)
    return any_hit, id0, loc


@partial(jax.jit, static_argnames=("cfg", "short_left", "short_right"))
def kscan_combined(cfg: KScanConfig, table, bases, lengths,
                   short_left: bool, short_right: bool):
    """Full scan + requested short-end scans in ONE compiled dispatch.
    XLA shares the unpack/rolling-register work across the three scans;
    one device round-trip per batch instead of three."""
    out = kscan_full(cfg, table, bases, lengths)
    sl = (
        kscan_short(cfg, table, bases, lengths, True)
        if short_left
        else None
    )
    sr = (
        kscan_short(cfg, table, bases, lengths, False)
        if short_right
        else None
    )
    return out, sl, sr
