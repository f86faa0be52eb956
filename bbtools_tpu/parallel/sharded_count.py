"""Multi-chip k-mer counting and alignment scoring.

Two more pipelines on the (dp, tp) mesh beyond the BBDuk filter step
(sharded_index.py):

- k-mer counting (kmercountexact / BBNorm / Tadpole load): read batches
  shard on dp; every device extracts + sort-reduces its own shard's
  canonical k-mers locally, and the per-device (values, counts) runs
  stream back stacked on the dp axis for the host spectrum merge — the
  identical merge the single-chip path already does across batches, so
  N devices look exactly like N extra batches. The count histogram is
  psum-merged on-device (KmerTableSet.java:273-285 thread-local tables +
  final merge, without the lock-striped WAYS tables).

- MSA site scoring (bbmap's hot stage): alignment tasks shard on dp;
  each device runs the ungapped scorer over its slice and the per-device
  best scores psum/stack back. Reference-block (tp) sharding is not
  needed here because the ref windows ship with the tasks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.kmer_count import batch_kmers_jnp, sort_reduce


def sharded_count_step(mesh: Mesh, k: int):
    """fn(bases [B,L] u8, lengths [B] i32) ->
    (values [B, n] i64, counts [B, n] i64, n_runs [B] i64, hist [64] i64)

    B must divide by mesh dp size; outputs are per-device runs stacked on
    dp (feed each row to KmerSpectrum.add_batch) plus a psum-merged
    occurrence histogram (counts clamped to 63).
    """
    n_dp = mesh.shape["dp"]

    def step(bases, lengths):
        keys = batch_kmers_jnp(bases, lengths, k)
        values, counts, n_runs = sort_reduce(keys)
        # compare-sum bincount (scatter-free; see sharded_index.py)
        clipped = jnp.minimum(counts, 63)
        hist = jnp.sum(
            (clipped[None, :] == jnp.arange(64, dtype=jnp.int64)[:, None])
            & (counts > 0)[None, :],
            axis=1, dtype=jnp.int64,
        )
        hist = jax.lax.psum(hist, "dp")
        return (
            values[None],
            counts[None],
            n_runs[None],
            hist,
        )

    from jax import shard_map

    smapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp")),
        out_specs=(P("dp", None), P("dp", None), P("dp"), P()),
        check_vma=False,
    )
    del n_dp
    return jax.jit(smapped)


def sharded_ungapped_score_step(mesh: Mesh, L: int, W: int):
    """fn(reads [T,L] u8, lens [T] i32, refs [T,W] u8, starts [T] i32) ->
    scores [T] i64, tasks sharded on dp."""
    from ..ops.score_ungapped import score_no_indels

    def step(reads, lens, refs, starts):
        return score_no_indels(
            L, reads, lens, refs, starts,
            jnp.full(reads.shape[0], W, jnp.int32),
        )

    from jax import shard_map

    smapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp"), P("dp", None), P("dp")),
        out_specs=P("dp"),
        check_vma=False,
    )
    return jax.jit(smapped)


def sharded_overlap_step(mesh: Mesh, m0: int, ni: int):
    """fn(a [B,L] u8, b_rc [B,L] u8, alens [B], blens [B]) ->
    (good [B,ni], bad [B,ni], olen [B,ni]) — the BBMerge insert scan
    (ops/overlap.overlap_counts_jnp) dp-sharded over pairs. Pairs are
    independent, so the shard_map needs no collectives; outputs are
    bit-identical to the single-device scan (tested via the production
    bbmerge tpshards= path)."""
    from ..ops.overlap import overlap_counts_jnp

    def step(a, b_rc, alens, blens):
        return overlap_counts_jnp(a, b_rc, alens, blens, m0, ni)

    from jax import shard_map

    smapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp", None), P("dp"), P("dp")),
        out_specs=(P("dp", None), P("dp", None), P("dp", None)),
        check_vma=False,
    )
    return jax.jit(smapped)


def shard_seed_index(starts: np.ndarray, sites: np.ndarray, n_shards: int,
                     max_hits: int):
    """Reference-block sharding of the BBMap CSR seed index: shard s owns
    keys with key % n_shards == s. Each shard's table is re-laid out as a
    FIXED-WIDTH [n_keys_local, max_hits] site matrix (pad -1) so the
    device lookup is a single row gather — the CSR's variable-length rows
    don't shard onto fixed-shape devices, the padded layout does.
    Returns (tables [S, nk_local, max_hits] int32, n_shards)."""
    import numpy as _np

    nk = len(starts) - 1
    nk_local = (nk + n_shards - 1) // n_shards
    tables = _np.full((n_shards, nk_local, max_hits), -1, _np.int32)
    counts = _np.diff(starts)
    for s in range(n_shards):
        keys = _np.arange(s, nk, n_shards)
        for li, key in enumerate(keys):
            c = min(int(counts[key]), max_hits)
            if c:
                tables[s, li, :c] = sites[starts[key] : starts[key] + c]
    return tables


def sharded_seed_expand_step(mesh: Mesh, n_shards: int):
    """fn(keys [B, K] i32, tables [S, nk_local, M] i32) ->
    sites [S, B, K, M] i32 (pad -1): each tp shard expands the query
    seed keys it owns; results stack on the shard axis (the
    reference-block parallel seed lookup, kmer/KmerTableSet WAYS
    layout over the BBIndex CSR)."""

    def step(keys, table):
        table = table[0]  # [nk_local, M]
        mine = (keys % n_shards) == jax.lax.axis_index("tp")
        local = keys // n_shards
        rows = table[jnp.clip(local, 0, table.shape[0] - 1)]  # [B, K, M]
        rows = jnp.where(mine[:, :, None], rows, jnp.int32(-1))
        return rows[None]

    from jax import shard_map

    smapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P("tp", None, None)),
        out_specs=P("tp", None, None, None),
        check_vma=False,
    )
    return jax.jit(smapped)


def make_sharded_fill_walk(mesh: Mesh, R: int, Cc: int):
    """Production multi-chip BBMap DP stage (bbmap tpshards=N): the banded
    fill (fillUnlimited semantics) PLUS the fused traceback walk, tasks
    sharded on dp. The reference parallelizes this per worker thread
    (align2/AbstractMapThread batch loop); here every device fills its
    slab of DP tasks and the walk ops ride back sharded. fn(reads [T,L]
    u8, lens [T] i32, refs [T,Cc] u8) -> (best_score, best_col,
    best_state, ops [T, R+Cc] u8, nsteps [T]). T must divide by the dp
    size.
    """
    from ..ops import msa as msa_mod
    from ..ops.msa_cuda import msa_fill_tb

    def step(reads, lens, refs):
        bs, bc, bst, planes = msa_fill_tb(R, Cc, reads, lens, refs)
        ops, nst = msa_mod.msa_walk(R, Cc, planes, lens, bc, bst)
        return bs, bc, bst, ops, nst

    from jax import shard_map

    return jax.jit(
        shard_map(
            step,
            mesh=mesh,
            in_specs=(P("dp", None), P("dp"), P("dp", None)),
            out_specs=(
                P("dp"), P("dp"), P("dp"), P("dp", None), P("dp"),
            ),
            check_vma=False,
        )
    )
