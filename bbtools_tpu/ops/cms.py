"""Count-min sketch k-mer counter — the KCountArray analog, on device.

Memory-bounded approximate counting (bloom/KCountArray7MTA.java:29: atomic
cell-packed counters with multiple hashes). Device layout: `hashes`
independent lanes of a power-of-2 `cells` array of int32 counters.

An increment batch pre-aggregates duplicate slots with a bitonic
sort + stable-partition (the same scatter-free compaction as
kmer_count.sort_reduce) and then issues ONE donated scatter-add of the
UNIQUE slots: on real sequencing data (coverage-fold duplicate kmers) the scatter
shrinks by the dup factor and dominates far less; worst-case unique
batches pay only the small sort overhead. A query is one gather + min
over lanes. The host wrapper keeps the table as a device array across
batches so counting streams never round-trip through host memory.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from .kmer_index import _mix64

_SALTS_NP = np.array(
    [0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9, 0x27D4EB2F165667C5],
    dtype=np.uint64,
)


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _slots_jnp(keys, hashes: int, cells: int):
    _, jnp = _jax()
    salts = jnp.asarray(_SALTS_NP[:hashes])
    q = keys.astype(jnp.uint64)[None, :] ^ salts[:, None]
    h = q
    h = h ^ (h >> jnp.uint64(30))
    h = h * jnp.uint64(0xBF58476D1CE4E5B9)
    h = h ^ (h >> jnp.uint64(27))
    h = h * jnp.uint64(0x94D049BB133111EB)
    h = h ^ (h >> jnp.uint64(31))
    return (h & jnp.uint64(cells - 1)).astype(jnp.int32)  # [H, n]


def make_cms_add(hashes: int, cells: int, max_count: int):
    jax, jnp = _jax()

    @partial(jax.jit, donate_argnums=0)
    def cms_add(table, keys):
        slots = _slots_jnp(keys, hashes, cells)  # [H, n]
        flat = (
            slots + (jnp.arange(hashes, dtype=jnp.int32) * cells)[:, None]
        ).reshape(-1)
        n = flat.shape[0]
        s = jnp.sort(flat)
        boundary = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
        n_runs = boundary.sum()
        iota = jnp.arange(n, dtype=jnp.int32)
        # stable partition: unique slots first, in ascending order
        _, uval, pos = jax.lax.sort(
            ((~boundary).astype(jnp.int32), s, iota), num_keys=1,
            is_stable=True,
        )
        nxt = jnp.concatenate([pos[1:], jnp.zeros(1, jnp.int32)])
        cnt = jnp.where(iota < n_runs - 1, nxt - pos, n - pos)
        live = iota < n_runs
        uval = jnp.where(live, uval, hashes * cells)  # OOB -> dropped
        cnt = jnp.where(live, cnt, 0)
        table = (
            table.reshape(-1).at[uval].add(cnt, mode="drop")
            .reshape(hashes, cells)
        )
        return jnp.minimum(table, max_count)

    return cms_add


def make_cms_query(hashes: int, cells: int):
    jax, jnp = _jax()

    @jax.jit
    def cms_query(table, keys):
        slots = _slots_jnp(keys, hashes, cells)  # [H, n]
        est = table[0, slots[0]]
        for h in range(1, hashes):
            est = jnp.minimum(est, table[h, slots[h]])
        return est

    return cms_query


class CountMinSketch:
    """Device-resident CMS. add()/query() take int64 key arrays (host or
    device); the table stays on device between calls."""

    def __init__(self, cells_per_hash: int = 1 << 22, hashes: int = 3,
                 max_count: int = 65535):
        assert cells_per_hash & (cells_per_hash - 1) == 0
        self.cells = cells_per_hash
        self.hashes = hashes
        self.max_count = max_count
        _, jnp = _jax()
        self.table = jnp.zeros((hashes, cells_per_hash), dtype=jnp.int32)
        self._add = make_cms_add(hashes, cells_per_hash, max_count)
        self._query = make_cms_query(hashes, cells_per_hash)

    def add(self, keys: np.ndarray):
        """Increment each key once per lane (saturating). Duplicate keys
        within the batch accumulate (scatter-add semantics)."""
        _, jnp = _jax()
        self.table = self._add(self.table, jnp.asarray(keys))

    def query(self, keys: np.ndarray) -> np.ndarray:
        _, jnp = _jax()
        return np.asarray(
            self._query(self.table, jnp.asarray(keys))
        ).astype(np.int64)

    def query_jnp(self, keys):
        """Device-to-device query (no host transfer)."""
        return self._query(self.table, keys)

    # --- host-side reference implementation (tests) ---
    def _slots_np(self, keys: np.ndarray) -> np.ndarray:
        out = np.empty((self.hashes, len(keys)), dtype=np.int64)
        for h in range(self.hashes):
            out[h] = (
                _mix64(keys.astype(np.uint64) ^ _SALTS_NP[h])
                & np.uint64(self.cells - 1)
            ).astype(np.int64)
        return out


class CMSTable:
    """count_of adapter so EccEngine/correctors can run over CMS counts
    (canonical int64 keys in, approximate counts out)."""

    def __init__(self, cms: CountMinSketch, k: int):
        self.cms = cms
        self.k = k
        self.mask = (1 << (2 * k)) - 1
        self.shift2 = 2 * (k - 1)

    def count_of(self, keys: np.ndarray) -> np.ndarray:
        return self.cms.query(np.asarray(keys, dtype=np.int64))
