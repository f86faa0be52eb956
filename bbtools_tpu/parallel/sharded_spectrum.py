"""Hash-sharded device-resident k-mer spectrum over a dp mesh.

The reference scales its k-mer tables by hash-sharding: every thread
owns the kmers with `kmer % WAYS == way` and no locks are ever needed
(kmer/KmerTableSet.java:273-285). The device translation: every DEVICE on
the mesh owns `kmer % n_dp == d`. Each batch is data-parallel over
reads; extracted kmers are exchanged to their owner with ONE
`lax.all_to_all`, and each owner merges its received stream into its
device-resident sorted run array with the scatter-free sort-reduce
(ops/kmer_count._merge_spectra). The global histogram is a local
bincount + `psum` — no spectrum readback, identical bytes to the
single-device host spectrum (ops/kmer_count.KmerSpectrum).

Shapes are static: per-batch exchange capacity `cap_ex` per
(source, target) pair and per-device spectrum capacity `cap` carry
overflow flags; the host grows (doubles) and retries on overflow, the
role of the reference's resize schedule (kmer/ScheduleMaker.java:16).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.kmer_count import PAD, _merge_spectra, batch_kmers_jnp


@partial(jax.jit, static_argnames=("mesh", "k", "n", "cap_ex"))
def _sharded_add(bases, lengths, keys_c, counts_c, *, mesh, k, n, cap_ex):
    def step(bases_l, lengths_l, kc, cc):
        kc, cc = kc[0], cc[0]
        keys = batch_kmers_jnp(bases_l, lengths_l, k)
        M = keys.shape[0]
        # owner = kmer % n_dp; PADs sort to a virtual group n (never sent)
        owner = jnp.where(
            keys == PAD, jnp.int64(n), keys % jnp.int64(n)
        ).astype(jnp.int32)
        ow_s, key_s = jax.lax.sort((owner, keys), num_keys=2)
        tgt = jnp.arange(n, dtype=jnp.int32)
        starts = jnp.searchsorted(ow_s, tgt)
        ends = jnp.searchsorted(ow_s, tgt, side="right")
        lens = ends - starts
        ok_ex = (lens <= cap_ex).all()
        idx = starts[:, None] + jnp.arange(cap_ex, dtype=jnp.int32)[None, :]
        valid = jnp.arange(cap_ex, dtype=jnp.int32)[None, :] < lens[:, None]
        send = jnp.where(
            valid, key_s[jnp.clip(idx, 0, M - 1)], PAD
        )  # [n, cap_ex]
        recv = jax.lax.all_to_all(
            send, "dp", split_axis=0, concat_axis=0, tiled=True
        )  # [n, cap_ex]: shard d's kmers from every source
        nk, nc, n_runs = _merge_spectra(kc, cc, recv.reshape(-1))
        cap = kc.shape[0]
        ok = ok_ex & (n_runs <= cap)
        ok = jax.lax.pmin(ok.astype(jnp.int32), "dp")
        nmax = jax.lax.pmax(n_runs, "dp")
        return nk[None, :cap], nc[None, :cap], ok, nmax

    from jax import shard_map

    return shard_map(
        step,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp"), P(), P()),
    )(bases, lengths, keys_c, counts_c)


@partial(jax.jit, static_argnames=("mesh", "hist_max"))
def _sharded_hist(keys_c, counts_c, *, mesh, hist_max):
    def step(kc, cc):
        kc, cc = kc[0], cc[0]
        live = kc != PAD
        c = jnp.clip(jnp.where(live, cc, 0), 0, hist_max)
        h = jnp.zeros(hist_max + 1, jnp.int64).at[c].add(
            live.astype(jnp.int64)
        )
        h = h.at[0].set(0)
        return jax.lax.psum(h, "dp")[None]

    from jax import shard_map

    return shard_map(
        step, mesh=mesh, in_specs=(P("dp"), P("dp")),
        out_specs=P("dp"),
    )(keys_c, counts_c)[0]


class ShardedSpectrum:
    """KmerSpectrum-compatible facade over the mesh."""

    def __init__(self, mesh: Mesh, k: int, cap: int = 1 << 18):
        self.mesh = mesh
        self.k = k
        self.n_dp = int(mesh.shape["dp"])
        self.cap = cap
        self._alloc()
        self.n = 0

    def _alloc(self):
        sh = NamedSharding(self.mesh, P("dp"))
        self.keys = jax.device_put(
            jnp.full((self.n_dp, self.cap), PAD, jnp.int64), sh
        )
        self.counts = jax.device_put(
            jnp.zeros((self.n_dp, self.cap), jnp.int64), sh
        )

    def _grow(self):
        old_k = np.asarray(self.keys)
        old_c = np.asarray(self.counts)
        self.cap *= 2
        self._alloc()
        nk = np.full((self.n_dp, self.cap), PAD, np.int64)
        nc = np.zeros((self.n_dp, self.cap), np.int64)
        nk[:, : old_k.shape[1]] = old_k
        nc[:, : old_c.shape[1]] = old_c
        sh = NamedSharding(self.mesh, P("dp"))
        self.keys = jax.device_put(jnp.asarray(nk), sh)
        self.counts = jax.device_put(jnp.asarray(nc), sh)

    def add_batch(self, bases, lengths):
        bases = np.asarray(bases)
        lengths = np.asarray(lengths).astype(np.int32)
        B, L = bases.shape
        n = self.n_dp
        if B % n:
            padr = n - B % n
            bases = np.concatenate(
                [bases, np.full((padr, L), 4, bases.dtype)]
            )
            lengths = np.concatenate([lengths, np.zeros(padr, np.int32)])
        # worst realistic skew headroom: 2.5x the even share, min 512
        cap_ex = max(512, int(2.5 * (bases.shape[0] // n) * L / n))
        while True:
            nk, nc, ok, nmax = _sharded_add(
                jnp.asarray(bases), jnp.asarray(lengths),
                self.keys, self.counts,
                mesh=self.mesh, k=self.k, n=n, cap_ex=cap_ex,
            )
            if bool(ok):  # the only per-batch host pull (+ nmax)
                self.keys, self.counts = nk, nc
                self.n = int(nmax)
                return
            # overflow (exchange or spectrum capacity): the carry was NOT
            # donated, so the pre-merge state is intact — grow and retry
            # the same batch (ScheduleMaker resize role)
            del nk, nc
            cap_ex *= 2
            self._grow()

    def flush(self):
        return

    def histogram(self, hist_max: int) -> np.ndarray:
        return np.asarray(
            _sharded_hist(self.keys, self.counts, mesh=self.mesh,
                          hist_max=hist_max)
        )

    def spectrum(self):
        """One final readback; shards own disjoint keys, so a global
        sort of the concatenated live rows is the exact spectrum."""
        kk = np.asarray(self.keys).reshape(-1)
        cc = np.asarray(self.counts).reshape(-1)
        live = kk != PAD
        kk, cc = kk[live], cc[live]
        o = np.argsort(kk, kind="stable")
        return kk[o], cc[o]

    @property
    def host_keys(self):
        return self.spectrum()[0]

    @property
    def host_counts(self):
        return self.spectrum()[1]

    @property
    def n_unique(self):
        kk = np.asarray(self.keys)
        return int((kk != PAD).sum())
