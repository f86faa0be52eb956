"""Sharded k-mer index + the multi-chip BBDuk step.

Device-native descendant of the reference's kmer%WAYS table sharding
(kmer/KmerTableSet.java:273-285, bbduk/BBDukIndexMod.java:506 routing):
keys route to shard `key % n_shards` at build; each device owns one shard
as an independent open-addressed table. At query time every device probes
its own shard with the (dp-replicated) query keys and the partial results
combine with a psum over the tp axis — a miss contributes 0 and exactly
one shard can hit, so the sum IS the select. No all-to-all of queries is
needed; the collective rides the device interconnect (NVLink).

The full step (scan + trim decision + stat reduction) is expressed with
shard_map over a (dp, tp) mesh so XLA sees the whole program and can fuse
the lookup chain with the rolling-kmer arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.bbduk_scan import KScanConfig
from ..ops.kmer_index import BucketKmerIndex
from ..ops.kmers import canonical_keys_jnp, rolling_kmers_jnp


@dataclass
class ShardedKmerIndex:
    """n_shards independent bucketed tables stacked on a leading axis."""

    keys: np.ndarray  # int64 [S, nb, BUCKET]
    ids: np.ndarray  # int32 [S, nb, BUCKET]
    nb: int
    n_shards: int

    @staticmethod
    def build(keys: np.ndarray, ids: np.ndarray, n_shards: int):
        from ..ops.kmer_index import _mix64

        parts = [
            ((keys % n_shards) == s).nonzero()[0] for s in range(n_shards)
        ]
        B = BucketKmerIndex.BUCKET
        nb = 64
        biggest = max((len(p) for p in parts), default=1)
        while nb * B * 0.5 < max(biggest, 1):
            nb *= 2
        while True:  # grow until every shard's buckets fit
            ok = True
            for p in parts:
                h = (_mix64(keys[p].astype(np.uint64)) & np.uint64(nb - 1)).astype(np.int64)
                if len(p) and np.bincount(h, minlength=nb).max() > B:
                    ok = False
                    break
            if ok or nb >= 1 << 28:
                break
            nb *= 2
        kt = np.full((n_shards, nb, B), -1, dtype=np.int64)
        it = np.zeros((n_shards, nb, B), dtype=np.int32)
        for s, p in enumerate(parts):
            if not len(p):
                continue
            h = (_mix64(keys[p].astype(np.uint64)) & np.uint64(nb - 1)).astype(np.int64)
            order = np.argsort(h, kind="stable")
            hs = h[order]
            slot = np.arange(len(p)) - np.searchsorted(hs, hs)
            kt[s, hs, slot] = keys[p][order]
            it[s, hs, slot] = ids[p][order]
        return ShardedKmerIndex(keys=kt, ids=it, nb=nb, n_shards=n_shards)


def make_sharded_kscan(mesh: Mesh, cfg: KScanConfig, sidx: ShardedKmerIndex,
                       short_left: bool, short_right: bool):
    """The PRODUCTION kscan_combined over a (dp, tp) mesh: reads are
    dp-sharded, the bucket table is tp-sharded by key % ntp
    (ShardedKmerIndex), and every lookup inside the scan combines with a
    psum over tp (KScanConfig.tp_shards routing in ops/bbduk_scan._lookup).
    Outputs are exactly kscan_combined's, so BBDuk's host-side trim/stat
    logic is unchanged and outputs stay byte-identical at any device
    count. This is the tool-level multi-device path: the kmer%WAYS design of
    kmer/KmerTableSet.java:273-285 across devices."""
    from functools import partial as _partial

    from jax import shard_map

    from ..ops.bbduk_scan import kscan_combined
    from dataclasses import replace

    n_tp = mesh.shape["tp"]
    assert n_tp == sidx.n_shards
    scfg = replace(cfg, tp_shards=n_tp, nb=sidx.nb, packed=False)

    def step(keys_tbl, ids_tbl, bases, lengths):
        table = (keys_tbl[0], ids_tbl[0])  # this device's shard
        return kscan_combined(scfg, table, bases, lengths,
                              short_left, short_right)

    smapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P("tp", None, None),
            P("tp", None, None),
            P("dp", None),
            P("dp"),
        ),
        out_specs=(
            {
                "nhits": P("dp"), "id0": P("dp"), "min_loc": P("dp"),
                "max_loc": P("dp"), "hit": P("dp", None),
                "ids": P("dp", None),
            },
            (P("dp"), P("dp"), P("dp")) if short_left else None,
            (P("dp"), P("dp"), P("dp")) if short_right else None,
        ),
        check_vma=False,
    )
    return jax.jit(smapped)


def sharded_bbduk_step(mesh: Mesh, cfg: KScanConfig, sidx: ShardedKmerIndex):
    """Build the jitted multi-chip BBDuk filter step.

    Returns fn(bases [B,L] u8, lengths [B] i32, table arrays) ->
    (nhits [B] i32, hit_histogram [256] i64) with bases/lengths sharded on
    dp, tables sharded on tp, outputs replicated (psum-reduced).
    """
    n_tp = mesh.shape["tp"]
    assert n_tp == sidx.n_shards

    def step(bases, lengths, keys_tbl, ids_tbl):
        # this device's shard: [1, nb, BUCKET] inside shard_map
        keys_tbl, ids_tbl = keys_tbl[0], ids_tbl[0]
        fwd, rkm, runlen = rolling_kmers_jnp(bases, cfg.k)
        keys = canonical_keys_jnp(fwd, rkm, cfg.k, cfg.mid_mask, cfg.rcomp)
        i_idx = jnp.arange(bases.shape[1], dtype=jnp.int32)[None, :]
        eligible = (
            (runlen >= cfg.resolved_minlen2())
            & (i_idx >= cfg.k - 1)
            & (i_idx < lengths[:, None])
        )
        mine = (keys % sidx.n_shards) == jax.lax.axis_index("tp")
        part = BucketKmerIndex.lookup_jnp(keys_tbl, ids_tbl, sidx.nb, keys)
        part = jnp.where(eligible & mine, part, 0)
        full = jax.lax.psum(part, "tp")  # exactly one shard hits
        nhits = (full > 0).sum(axis=1, dtype=jnp.int32)
        # compare-sum bincount: a [256, B] compare+reduce instead of a
        # scatter
        clipped = jnp.minimum(nhits, 255)
        hist = jnp.sum(
            clipped[None, :] == jnp.arange(256, dtype=jnp.int32)[:, None],
            axis=1, dtype=jnp.int32,
        )
        hist = jax.lax.psum(hist, "dp")  # dp-global histogram
        return nhits, hist

    from jax import shard_map

    smapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P("dp", None),
            P("dp"),
            P("tp", None, None),
            P("tp", None, None),
        ),
        out_specs=(P("dp"), P()),
        check_vma=False,
    )
    return jax.jit(smapped)
