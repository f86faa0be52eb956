"""IndelFreeAligner — exhaustive substitution-only alignment (indelfree.sh,
ifa/IndelFreeAligner4.java).

Queries (spacers/primers/probes, held in memory) align to every position
of streamed reference sequences allowing up to `subs` substitutions and
NO indels; hits emit SAM records.

Device-native redesign: the reference builds multi-k seed indexes with
pigeonhole minimum-hit calculations (MinHitsCalculator) to prune the
O(Q*S) search for CPUs. On the device the search IS the fast path: sliding
windows of the reference (a strided view, no gather) compare against the
whole query panel in one [Q, S, L] masked-equality reduction —
exhaustive, branch-free, and exact, so no seed/prune machinery is needed.
Work is tiled over reference chunks with static shapes (jit once per
(panel, chunk) geometry).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..core.dna import encode
from ..core.parser import tokenize
from ..io.fasta import iter_fasta
from ..io.fileformat import Format, test_input
from ..io.readwrite import open_output

CHUNK = 1 << 16  # reference positions per device call


def _device_search(queries, qlens, ref_chunk, max_subs):
    """mismatches [Q, C] for every query at every chunk offset; positions
    where the query would overrun the chunk count as all-mismatch."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def fn(q, ql, rc):
        Q, L = q.shape
        C = rc.shape[0] - L  # valid window starts
        # windows via L static slices (no gather): win[:, i] = rc[d + i]
        i_idx = jnp.arange(L)
        # [C, L] strided windows from static slicing
        win = jnp.stack(
            [jax.lax.dynamic_slice(rc, (i,), (C,)) for i in range(L)],
            axis=1,
        )
        valid_q = i_idx[None, :] < ql[:, None]  # [Q, L]
        eq = q[:, None, :] == win[None, :, :]  # [Q, C, L]
        mism = (valid_q[:, None, :] & ~eq).sum(axis=2)
        return mism.astype(jnp.int32)

    return np.asarray(
        fn(
            __import__("jax").numpy.asarray(queries),
            __import__("jax").numpy.asarray(qlens),
            __import__("jax").numpy.asarray(ref_chunk),
        )
    )


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    ref = a.get("ref")
    out = a.get("out")
    max_subs = a.get_int("subs", "s", default=5)
    minid = a.get_float("minid", default=0.85)
    minqlen = a.get_int("minqlen", default=1)
    t0 = time.time()

    # load queries (+ reverse complements)
    names: list[bytes] = []
    seqs: list[np.ndarray] = []
    if test_input(in1).format is Format.FASTA:
        for rec in iter_fasta(in1):
            if len(rec.seq) >= minqlen:
                names.append(rec.name.split()[0])
                seqs.append(encode(rec.seq))
    else:
        from ..io.fastq import FastqReader

        for b in FastqReader(in1):
            for i in range(b.n):
                if int(b.lengths[i]) >= minqlen:
                    names.append(b.ids[i].split()[0])
                    seqs.append(b.bases[i, : int(b.lengths[i])].copy())
    nq = len(seqs)
    L = max((len(s) for s in seqs), default=1)
    Q = 2 * nq  # forward + rc rows
    queries = np.full((Q, L), 4, np.uint8)
    qlens = np.zeros(Q, np.int32)
    for i, s in enumerate(seqs):
        queries[2 * i, : len(s)] = s
        rc = np.where(s < 4, 3 - s, 4)[::-1]
        queries[2 * i + 1, : len(s)] = rc
        qlens[2 * i] = qlens[2 * i + 1] = len(s)
    # allowed subs per query: min(subs, qlen*(1-minid))
    allowed = np.minimum(
        max_subs, np.floor(qlens * (1.0 - minid)).astype(np.int32)
    ) if minid > 0 else np.full(Q, max_subs, np.int32)
    allowed = np.maximum(allowed, 0)

    n_hits = 0
    fh = open_output(out) if out else None
    scaf_names = []
    records = []
    for rec in iter_fasta(ref):
        scaf_names.append((rec.name.split()[0], len(rec.seq)))
        codes = encode(rec.seq)
        S = len(codes)
        for c0 in range(0, max(S - 1, 1), CHUNK):
            chunk = np.full(CHUNK + L, 4, np.uint8)
            seg = codes[c0 : c0 + CHUNK + L]
            chunk[: len(seg)] = seg
            mism = _device_search(queries, qlens, chunk, max_subs)
            hits = np.argwhere(mism <= allowed[:, None])
            for qi, off in hits:
                pos = c0 + int(off)
                if pos + int(qlens[qi]) > S:
                    continue
                strand = qi & 1
                name = names[qi // 2]
                nm = int(mism[qi, off])
                records.append(
                    (name, strand, scaf_names[-1][0], pos + 1,
                     int(qlens[qi]), nm, qi // 2)
                )
                n_hits += 1
    if fh is not None:
        fh.write(b"@HD\tVN:1.4\tSO:unsorted\n")
        for nm, ln in scaf_names:
            fh.write(b"@SQ\tSN:%s\tLN:%d\n" % (nm, ln))
        for name, strand, rname, pos, qlen, nm, qidx in records:
            s = seqs[qidx]
            if strand:
                s = np.where(s < 4, 3 - s, 4)[::-1]
            from ..core.dna import CODE_TO_BASE

            fh.write(
                b"%s\t%d\t%s\t%d\t%d\t%dM\t*\t0\t0\t%s\t*\tNM:i:%d\n"
                % (
                    name, 16 if strand else 0, rname, pos,
                    max(2, 40 - 4 * nm), qlen,
                    CODE_TO_BASE[np.minimum(s, 4)].tobytes(), nm,
                )
            )
        fh.close()
    print(f"Queries:             \t{nq}", file=sys.stderr)
    print(f"Hits:                \t{n_hits}", file=sys.stderr)
    print(f"Time:                \t{time.time()-t0:.3f} seconds.",
          file=sys.stderr)
    return records
