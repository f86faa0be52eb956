"""Exact k-mer counting — device extraction + host-merged spectrum.

Device-native redesign of the counting half of kmer/KmerTableSet.java (the
LoadThread scan :397-484 + HashArray1D increment): instead of a mutable
hash table, each batch's canonical k-mers are sorted on device and reduced
to (unique, count) runs; batches merge into a global sorted spectrum on the
host. Sorting replaces atomics — deterministic, collision-free, and maps
onto the device's fast sort/reduce primitives (the same observation SURVEY.md
§7.3 makes: the reference's own BBMap Block index is the sorted design).

Canonicalization matches the loader exactly: kmer windows with len >= k
(no undefined base in window), key = max(kmer, rkmer) — note counting
tables use the PLAIN canonical kmer, no length-tag bit
(kmer/KmerTableSet.java uses toValue without masks).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .kmers import rolling_kmers_jnp, rolling_kmers_np

#: sentinel larger than any 62-bit kmer, sorts last
PAD = np.int64(0x7FFFFFFFFFFFFFFF)


def batch_kmers_jnp(bases, lengths, k: int):
    """Canonical kmers of all valid windows, padded with PAD. [B*L] i64."""
    fwd, rkm, runlen = rolling_kmers_jnp(bases, k)
    i_idx = jnp.arange(bases.shape[1], dtype=jnp.int32)[None, :]
    valid = (runlen >= k) & (i_idx < lengths[:, None])
    keys = jnp.maximum(fwd, rkm)
    keys = jnp.where(valid, keys, PAD)
    return keys.reshape(-1)


@jax.jit
def sort_reduce(keys):
    """Sort keys and reduce to run (values, counts, n_runs). Padded output
    arrays of the same length; rows >= n_runs are PAD/0.

    Compaction is a second STABLE sort that partitions run-boundary
    rows to the front (carrying the key and its position), not a
    scatter. Counts fall out of adjacent boundary positions."""
    s = jnp.sort(keys)
    n = s.shape[0]
    boundary = jnp.concatenate(
        [jnp.ones(1, bool), s[1:] != s[:-1]]
    ) & (s != PAD)
    n_runs = boundary.sum()
    n_valid = (s != PAD).sum()
    iota = jnp.arange(n, dtype=jnp.int32)
    # stable partition: boundaries first, in ascending-key order. The
    # boundary bit PACKS into the key (canonical k<=31 kmers use < 62
    # bits; PAD already has bit 62 set, and PAD rows are non-boundary)
    # so the partition is a 12-byte 2-operand sort instead of the
    # 16-byte 3-operand (nb, s, iota) — ~25% less sort-unit traffic on
    # the hot counting path.
    key2 = s | ((~boundary).astype(jnp.int64) << 62)
    k2s, pos = jax.lax.sort((key2, iota), num_keys=1, is_stable=True)
    values = k2s & ~(jnp.int64(1) << 62)
    nxt = jnp.concatenate([pos[1:], jnp.zeros(1, jnp.int32)])
    counts = jnp.where(
        iota < n_runs - 1,
        (nxt - pos).astype(jnp.int64),
        (n_valid - pos).astype(jnp.int64),
    )
    live = iota < n_runs
    return (
        jnp.where(live, values, PAD),
        jnp.where(live, counts, 0),
        n_runs,
    )


def count_batch(bases, lengths, k: int):
    """Counting for one batch -> host (values, counts) arrays.

    The device extracts the canonical k-mers; the sort-reduce runs on
    the host via np.unique, which measured faster end to end than a
    device-resident spectrum on the GPU and than the XLA sort on the
    CPU (PERF.md)."""
    keys = np.asarray(
        batch_kmers_jnp(jnp.asarray(bases), jnp.asarray(lengths), k)
    )
    keys = keys[keys != PAD]
    return np.unique(keys, return_counts=True)


@partial(jax.jit, static_argnames=())
def _merge_spectra(spec_keys, spec_counts, batch_keys):
    """Merge a device spectrum ([C] PAD-padded sorted keys + counts) with
    a raw batch key stream ([M], PAD-padded): one combined 2-op sort +
    run-sum via the cumsum-carry partition (the scatter-free pattern of
    sort_reduce, extended to SUM counts instead of counting members).
    Returns ([C+M] keys, counts, n_runs) — caller slices back to
    capacity.

    The raw keys enter the merge sort DIRECTLY with count 1 — a
    pre-reduce of the batch (round 3 design) bought nothing: static
    shapes mean the reduced run array is still M rows of concatenated
    input, so the per-batch sort_reduce (a 1-op M sort plus a 3-op M
    stable partition) was pure overhead on top of the same-size combined
    sort."""
    all_k = jnp.concatenate([spec_keys, batch_keys])
    all_c = jnp.concatenate([
        spec_counts,
        (batch_keys != PAD).astype(jnp.int64),
    ])
    s, c = jax.lax.sort((all_k, all_c), num_keys=1)
    n = s.shape[0]
    boundary = jnp.concatenate(
        [jnp.ones(1, bool), s[1:] != s[:-1]]
    ) & (s != PAD)
    n_runs = boundary.sum()
    total = c.sum()
    excl = jnp.cumsum(c) - c  # count-sum before this row
    iota = jnp.arange(n, dtype=jnp.int32)
    # boundary bit packed into the key (see sort_reduce): a 16-byte
    # 2-operand partition sort instead of 20-byte 3-operand
    key2 = s | ((~boundary).astype(jnp.int64) << 62)
    k2s, ex = jax.lax.sort((key2, excl), num_keys=1, is_stable=True)
    values = k2s & ~(jnp.int64(1) << 62)
    nxt = jnp.concatenate([ex[1:], jnp.zeros(1, jnp.int64)])
    counts = jnp.where(iota < n_runs - 1, nxt - ex, total - ex)
    live = iota < n_runs
    return (
        jnp.where(live, values, PAD),
        jnp.where(live, counts, 0),
        n_runs,
    )


class KmerSpectrum:
    """Host-side merged exact spectrum: sorted kmers + int64 counts."""

    def __init__(self, k: int):
        self.k = k
        self.keys = np.zeros(0, dtype=np.int64)
        self.counts = np.zeros(0, dtype=np.int64)
        self._pending: list[tuple[np.ndarray, np.ndarray]] = []
        self._pending_size = 0

    def add_batch(self, values: np.ndarray, counts: np.ndarray):
        self._pending.append((values, counts))
        self._pending_size += len(values)
        if self._pending_size > max(4 * len(self.keys), 1 << 22):
            self.flush()

    def flush(self):
        if not self._pending:
            return
        all_k = np.concatenate([self.keys] + [p[0] for p in self._pending])
        all_c = np.concatenate([self.counts] + [p[1] for p in self._pending])
        order = np.argsort(all_k, kind="stable")
        all_k = all_k[order]
        all_c = all_c[order]
        boundary = np.ones(len(all_k), dtype=bool)
        boundary[1:] = all_k[1:] != all_k[:-1]
        idx = np.cumsum(boundary) - 1
        self.keys = all_k[boundary]
        self.counts = np.zeros(len(self.keys), dtype=np.int64)
        np.add.at(self.counts, idx, all_c)
        self._pending = []
        self._pending_size = 0

    @property
    def n_unique(self) -> int:
        self.flush()
        return len(self.keys)

    def histogram(self, hist_max: int) -> np.ndarray:
        """hist[c] = number of distinct kmers with count c; counts > max
        accumulate in the last bin (HistogramMaker semantics)."""
        self.flush()
        h = np.zeros(hist_max + 1, dtype=np.int64)
        np.add.at(h, np.minimum(self.counts, hist_max), 1)
        h[0] = 0
        return h


def count_batch_np(bases, lengths, k: int):
    """Host oracle for tests."""
    fwd, rkm, runlen = rolling_kmers_np(bases, k)
    i_idx = np.arange(bases.shape[1])[None, :]
    valid = (runlen >= k) & (i_idx < lengths[:, None])
    keys = np.maximum(fwd, rkm)[valid]
    values, counts = np.unique(keys, return_counts=True)
    return values, counts.astype(np.int64)
