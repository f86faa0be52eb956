"""Multi-host wiring: jax.distributed initialization + global mesh.

The reference's distributed story is MPI scaffolding that never shipped
(SURVEY.md §2.6). Here the design is jax-native: each host runs the same
program, `initialize()` joins the cluster (jax.distributed), and
`global_mesh()` lays a (dp, tp) mesh over ALL devices so the shard_map
pipelines in parallel/sharded_index.py run unchanged — XLA routes psum
over NVLink within a host and the network across hosts.

On a single host (this dev environment) `initialize()` is a no-op and
the mesh covers local devices, so every code path is exercised by the
virtual-device tests; multi-host runs only change the environment
variables, not the program.
"""

from __future__ import annotations

import os


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join a multi-host cluster. Arguments default from env
    (JAX_COORDINATOR, JAX_NUM_PROCESSES, JAX_PROCESS_ID); returns True
    if distributed mode was entered, False for single-host."""
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if not coordinator or num_processes <= 1:
        return False
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return True  # already joined (idempotent re-entry)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_sum_array(vec) -> "np.ndarray":
    """Sum an integer vector across ALL processes over the global mesh
    (psum-style: the dp axis spans processes, XLA routes the reduction
    over DCN). Every process returns the identical global numpy vector.
    Single-process: identity. This is the cross-host half of the
    kmer/VarMap merge pattern (SURVEY §5.8): per-host partial stats in,
    ONE global answer out."""
    import numpy as np

    import jax

    if jax.process_count() == 1:
        return np.asarray(vec)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = global_mesh()
    dp = mesh.devices.shape[0]
    v = np.asarray(vec, np.int64)
    rows_per_proc = dp // jax.process_count()
    local = np.zeros((rows_per_proc, v.shape[0]), np.int64)
    local[0] = v  # one real row per process, zero-padding the rest
    sh = NamedSharding(mesh, P("dp", None))
    g = jax.make_array_from_process_local_data(
        sh, local, (dp, local.shape[1])
    )
    out = jax.jit(
        lambda x: x.sum(0), out_shardings=NamedSharding(mesh, P())
    )(g)
    return np.asarray(jax.device_get(out))


_SPEC_SENT = (1 << 62) - 1


def merge_jit(mesh, n_payload: int = 1):
    """Replicated-output sort-reduce over a dp-sharded [dp, cap] keys
    plane plus n_payload count planes: ONE global sorted table from
    per-shard partials (XLA inserts the cross-shard all_gather). With
    n_payload=1 this is the k-mer spectrum merge; with more it is the
    VarMap-style multi-counter merge (var2/VarMap.java:278-298 — the
    same key-ownership reduce, every counter summed per key). Shared by
    the multi-process global_spectrum and the dryrun mesh pipelines."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    def merge(kg, *pgs):
        flat = jax.lax.sort(
            (kg.reshape(-1),) + tuple(p.reshape(-1) for p in pgs),
            num_keys=1,
        )
        ks = flat[0]
        boundary = jnp.concatenate(
            [jnp.ones(1, bool), ks[1:] != ks[:-1]]
        )
        seg = jnp.cumsum(boundary) - 1
        tots = tuple(
            jnp.zeros(ks.shape[0], p.dtype).at[seg].add(p)
            for p in flat[1:]
        )
        return (ks,) + tots + (boundary,)

    rep = NamedSharding(mesh, P())
    return jax.jit(
        merge, out_shardings=(rep,) * (n_payload + 2)
    )


def global_spectrum(keys, counts):
    """Merge per-process (kmer, count) spectra into ONE global spectrum,
    identical on every process: agree on a static cap (global max of
    local sizes), build a dp-sharded [dp, cap] global array, and run a
    replicated-output sort-reduce — the same kmer-ownership merge the
    reference's KmerTableSet does per-thread (KmerTableSet.java:273-285),
    lifted across hosts. Single-process: identity."""
    import numpy as np

    import jax

    keys = np.asarray(keys, np.int64)
    counts = np.asarray(counts, np.int64)
    if jax.process_count() == 1:
        return keys, counts
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = global_mesh()
    dp = mesh.devices.shape[0]
    # agree on the static cap via a global max (replicated scalar)
    rows_per_proc = dp // jax.process_count()
    sizes = np.full((rows_per_proc, 1), len(keys), np.int64)
    sh = NamedSharding(mesh, P("dp", None))
    g = jax.make_array_from_process_local_data(sh, sizes, (dp, 1))
    mx = int(jax.device_get(jax.jit(
        lambda x: x.max(), out_shardings=NamedSharding(mesh, P())
    )(g)))
    cap = 1 << max(8, (max(mx, 1) - 1).bit_length())
    pk = np.full((rows_per_proc, cap), _SPEC_SENT, np.int64)
    pc = np.zeros((rows_per_proc, cap), np.int64)
    pk[0, : len(keys)] = keys
    pc[0, : len(counts)] = counts
    gk = jax.make_array_from_process_local_data(sh, pk, (dp, cap))
    gc = jax.make_array_from_process_local_data(sh, pc, (dp, cap))

    ks, tot, boundary = jax.device_get(merge_jit(mesh)(gk, gc))
    # run totals were scatter-added at segment indices (front-compacted);
    # run keys sit at boundary positions. Sentinel pads sort to the end.
    bidx = np.flatnonzero(boundary)
    keys_u = ks[bidx]
    counts_u = tot[: len(bidx)]
    live = keys_u != _SPEC_SENT
    return keys_u[live], counts_u[live]


def global_mesh(tp: int | None = None):
    """(dp, tp) mesh over all devices (local + remote). tp defaults to
    the per-host device count so tensor-parallel collectives stay on NVLink
    and only the dp axis crosses the network."""
    import jax
    from jax.sharding import Mesh
    import numpy as np

    devs = np.array(jax.devices())
    n = len(devs)
    if tp is None:
        tp = max(1, jax.local_device_count())
    tp = min(tp, n)
    while n % tp:
        tp -= 1
    return Mesh(devs.reshape(n // tp, tp), ("dp", "tp"))
