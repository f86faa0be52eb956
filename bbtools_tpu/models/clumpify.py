"""Clumpify — k-mer-pivot read sorting for compression/locality
(clump/Clumpify.java:28, KmerComparator.java:23).

Reads sharing a pivot k-mer (the minimizer of hashed k-mers) sort
adjacently, which dramatically improves gzip ratios and enables optical/
PCR-duplicate marking. Device design: pivot hashing is a batched device
reduction (min over hashed window k-mers); ordering is one global argsort.
Optional dedupe=t removes exact duplicates within a clump.

`groups=N` enables the reference's EXTERNAL 2-pass shuffle
(Clumpify.java:88-97, KmerSplit -> KmerSort): pass 1 streams reads into N
temp partitions by pivot hash (memory = one batch), pass 2 sorts each
partition independently and concatenates — pivot-partitioning makes the
concatenation globally clump-ordered without a global sort.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..core.parser import tokenize
from ..io.fastq import FastqReader, encode_fastq
from ..io.readwrite import open_output
from ..ops.kmer_index import _mix64
from ..ops.kmers import rolling_kmers_np


def pivot_kmers(bases: np.ndarray, lengths: np.ndarray, k: int):
    """Per-read pivot: the minimum 64-bit-hashed canonical k-mer.

    Device path (rolling registers + mix + min-reduce on the device) for
    real batches; numpy fallback for tiny ones where dispatch overhead
    dominates. Both produce identical (pivot, position) pairs."""
    if bases.shape[0] * bases.shape[1] >= 1 << 16:
        piv, pos = _pivot_kmers_jnp(bases, lengths, k)
        return np.asarray(piv).astype(np.uint64), np.asarray(pos)
    return _pivot_kmers_np(bases, lengths, k)


def _pivot_kmers_np(bases, lengths, k: int):
    fwd, rkm, runlen = rolling_kmers_np(bases, k)
    valid = (runlen >= k) & (
        np.arange(bases.shape[1])[None, :] < lengths[:, None]
    )
    keys = np.maximum(fwd, rkm)
    h = _mix64(keys.astype(np.uint64))
    h = np.where(valid, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    piv = h.min(axis=1)
    pos = h.argmin(axis=1)
    return piv, pos


from functools import partial as _partial  # noqa: E402

import jax as _jax  # noqa: E402


@_partial(_jax.jit, static_argnames=("k",))
def _pivot_kmers_jnp(bases, lengths, k: int):
    import jax.numpy as jnp

    from ..ops.kmers import rolling_kmers_jnp

    fwd, rkm, runlen = rolling_kmers_jnp(jnp.asarray(bases), k)
    valid = (runlen >= k) & (
        jnp.arange(bases.shape[1], dtype=jnp.int32)[None, :]
        < jnp.asarray(lengths)[:, None]
    )
    keys = jnp.maximum(fwd, rkm).astype(jnp.uint64)
    h = keys
    h = h ^ (h >> jnp.uint64(30))
    h = h * jnp.uint64(0xBF58476D1CE4E5B9)
    h = h ^ (h >> jnp.uint64(27))
    h = h * jnp.uint64(0x94D049BB133111EB)
    h = h ^ (h >> jnp.uint64(31))
    h = jnp.where(valid, h, jnp.uint64(0xFFFFFFFFFFFFFFFF))
    return h.min(axis=1), h.argmin(axis=1)


def _coords(name: bytes):
    """(lane, tile, x, y) from an Illumina header, or None."""
    parts = name.split(b" ")[0].split(b":")
    if len(parts) >= 7:
        try:
            return (int(parts[3]), int(parts[4]), int(parts[5]),
                    int(parts[6]))
        except ValueError:
            return None
    return None


def _sort_and_write(records, fh, dedupe: bool, optical: bool = False,
                    dupedist: int = 40) -> int:
    """KmerComparator order: (pivot, position-in-read desc, sequence).

    optical=t restricts duplicate removal to reads whose flowcell
    coordinates are within `dupedist` on the same lane+tile (Clumpify's
    optical-duplicate mode, clump/Clump.java dist semantics)."""
    records.sort(key=lambda r: (r[0], -r[1], r[3]))
    dupes = 0
    prev_seq = None
    run = []  # coords of kept copies of the current identical sequence
    for piv, pos, name, seq, qual in records:
        if dedupe and seq == prev_seq:
            if not optical:
                dupes += 1
                continue
            c = _coords(name)
            near = c is not None and any(
                k is not None
                and k[0] == c[0]
                and k[1] == c[1]
                and (k[2] - c[2]) ** 2 + (k[3] - c[3]) ** 2
                <= dupedist * dupedist
                for k in run
            )
            if near:
                dupes += 1
                continue
        else:
            run = []
        fh.write(b"@%s\n%s\n+\n%s\n" % (name, seq, qual))
        prev_seq = seq
        run.append(_coords(name))
    return dupes


def _sort_and_write_paired(records, fh1, fh2, dedupe: bool,
                           optical: bool = False,
                           dupedist: int = 40) -> int:
    """Paired clump order: PAIRS sort by read-1's pivot and a duplicate
    requires BOTH mates to match the previous pair (Clumpify's paired
    mode, clump/Clump.java pair semantics)."""
    records.sort(key=lambda r: (r[0], -r[1], r[3], r[6]))
    dupes = 0
    prev = (None, None)
    run = []
    for piv, pos, n1, s1, q1, n2, s2, q2 in records:
        if dedupe and (s1, s2) == prev:
            if not optical:
                dupes += 2
                continue
            c = _coords(n1)
            near = c is not None and any(
                kk is not None and kk[0] == c[0] and kk[1] == c[1]
                and (kk[2] - c[2]) ** 2 + (kk[3] - c[3]) ** 2
                <= dupedist * dupedist
                for kk in run
            )
            if near:
                dupes += 2
                continue
        else:
            run = []
        fh1.write(b"@%s\n%s\n+\n%s\n" % (n1, s1, q1))
        fh2.write(b"@%s\n%s\n+\n%s\n" % (n2, s2, q2))
        prev = (s1, s2)
        run.append(_coords(n1))
    return dupes


def main(argv=None):
    import os
    import tempfile

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    in2 = a.get("in2")
    out1 = a.get("out", "out1")
    out2 = a.get("out2")
    k = a.get_int("k", default=31)
    dedupe = a.get_bool("dedupe", default=False)
    optical = a.get_bool("optical", "opticalonly", default=False)
    dupedist = a.get_int("dupedist", "dist", default=40)
    groups = a.get_int("groups", "g", default=1)
    t0 = time.time()
    dupes = 0
    n = 0
    reader = FastqReader(in1)
    if in2:
        # paired: pairs travel together, keyed on read 1's pivot
        records = []
        it2 = iter(FastqReader(in2))
        for b in reader:
            b2 = next(it2)
            piv, pos = pivot_kmers(b.bases, b.lengths.astype(np.int64), k)
            for i in range(b.n):
                records.append(
                    (int(piv[i]), int(pos[i]), b.ids[i], b.sequence(i),
                     b.quality_string(i), b2.ids[i], b2.sequence(i),
                     b2.quality_string(i))
                )
        n = 2 * len(records)
        with open_output(out1) as f1, open_output(out2) as f2:
            dupes = _sort_and_write_paired(
                records, f1, f2, dedupe, optical, dupedist
            )
    elif groups <= 1:
        records = []  # (pivot, pos, name, seq, qual)
        for b in reader:
            piv, pos = pivot_kmers(b.bases, b.lengths.astype(np.int64), k)
            for i in range(b.n):
                records.append(
                    (int(piv[i]), int(pos[i]), b.ids[i], b.sequence(i),
                     b.quality_string(i))
                )
        n = len(records)
        with open_output(out1) as fh:
            dupes = _sort_and_write(records, fh, dedupe, optical, dupedist)
    else:
        # pass 1 (KmerSplit): partition by pivot into temp files. The
        # partition key uses the TOP bits so groups are pivot-ordered and
        # per-group sorted outputs concatenate into a global clump order.
        with tempfile.TemporaryDirectory(prefix="clumpify_") as td:
            parts = [
                open(os.path.join(td, f"g{g}.fq"), "wb")
                for g in range(groups)
            ]
            for b in reader:
                piv, pos = pivot_kmers(b.bases, b.lengths.astype(np.int64), k)
                gid = (piv.astype(np.uint64) >> np.uint64(64 - 16)).astype(
                    np.int64
                ) * groups // (1 << 16)
                for g in range(groups):
                    rows = np.flatnonzero(gid == g)
                    if len(rows):
                        parts[g].write(encode_fastq(b, gid == g))
                n += b.n
            for fh in parts:
                fh.close()
            # pass 2 (KmerSort): sort each partition independently
            with open_output(out1) as fh:
                for g in range(groups):
                    records = []
                    for b in FastqReader(os.path.join(td, f"g{g}.fq")):
                        piv, pos = pivot_kmers(
                            b.bases, b.lengths.astype(np.int64), k
                        )
                        for i in range(b.n):
                            records.append(
                                (int(piv[i]), int(pos[i]), b.ids[i],
                                 b.sequence(i), b.quality_string(i))
                            )
                    dupes += _sort_and_write(
                        records, fh, dedupe, optical, dupedist
                    )
    print(f"Reads:               \t{n}", file=sys.stderr)
    if dedupe:
        print(f"Duplicates removed:  \t{dupes}", file=sys.stderr)
    print(f"Time:                \t{time.time()-t0:.3f} seconds.", file=sys.stderr)
    return n, dupes


if __name__ == "__main__":
    main()
