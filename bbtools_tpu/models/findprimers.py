"""FindPrimers (msa.sh) — best substitution-only alignment of a small
query panel against every read; SAM out (jgi/FindPrimers.java role).

The companion of cutprimers: `msa.sh in=reads ref=primer1.fa out=sam1`
produces the per-read primer sites cutprimers consumes. Search is the
same exhaustive window-compare as models/indelfree.py, batched over
reads: one [P, B, W] masked-equality reduction per read batch, best
offset per (read, primer) kept.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.dna import CODE_TO_BASE, encode
from ..core.parser import tokenize
from ..io.fasta import iter_fasta
from ..io.fastq import FastqReader
from ..io.readwrite import open_output


def best_sites(bases: np.ndarray, lengths: np.ndarray, primers: np.ndarray,
               plens: np.ndarray):
    """For each (read, primer): (best_offset, mismatches) over all
    offsets; positions past the read end count as mismatches."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def fn(b, ln, q, ql):
        B, L = b.shape
        P, Lp = q.shape
        C = L  # candidate offsets 0..L-1 (tail offsets valid-checked)
        win = jnp.stack(
            [
                jax.lax.dynamic_slice(
                    jnp.pad(b, ((0, 0), (0, Lp)), constant_values=9),
                    (0, i), (B, L),
                )
                for i in range(Lp)
            ],
            axis=2,
        )  # [B, C, Lp]: win[b, d, i] = base at d+i (9 past the pad)
        vq = jnp.arange(Lp)[None, :] < ql[:, None]  # [P, Lp]
        eq = q[:, None, None, :] == win[None, :, :, :]  # [P, B, C, Lp]
        mism = (vq[:, None, None, :] & ~eq).sum(axis=3)  # [P, B, C]
        # offsets where the primer overruns the read are invalid
        d_idx = jnp.arange(C)[None, None, :]
        ok = d_idx + ql[:, None, None] <= ln[None, :, None]
        mism = jnp.where(ok, mism, jnp.int32(1 << 20))
        best = jnp.argmin(mism, axis=2)  # [P, B]
        bm = jnp.take_along_axis(mism, best[:, :, None], 2)[:, :, 0]
        return best.astype(jnp.int32), bm.astype(jnp.int32)

    import jax.numpy as jnp

    off, mm = fn(
        jnp.asarray(bases), jnp.asarray(lengths),
        jnp.asarray(primers), jnp.asarray(plens),
    )
    return np.asarray(off), np.asarray(mm)


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out = a.get("out")
    rcomp = a.get_bool("rcomp", default=True)
    cutoff = a.get_float("cutoff", default=0.0)
    prims: list[tuple[bytes, np.ndarray]] = []
    for lit in (a.get("literal") or "").split(","):
        if lit:
            prims.append((lit.encode(), encode(lit.encode())))
    if a.get("ref"):
        for rec in iter_fasta(a.get("ref")):
            prims.append((rec.name.split()[0], encode(rec.seq)))
    if rcomp:
        prims += [
            (b"r_" + nm, np.where(s < 4, 3 - s, 4)[::-1].copy())
            for nm, s in prims
        ]
    P = len(prims)
    Lp = max(len(s) for _, s in prims)
    q = np.full((P, Lp), 4, np.uint8)
    ql = np.zeros(P, np.int32)
    for i, (_, s) in enumerate(prims):
        q[i, : len(s)] = s
        ql[i] = len(s)
    fh = open_output(out) if out else None
    n_out = 0
    first = True
    for b in FastqReader(in1):
        if fh is not None and first:
            fh.write(b"@HD\tVN:1.4\tSO:unsorted\n")
            first = False
            # reads are the reference sequences in this SAM convention
        off, mm = best_sites(b.bases, b.lengths, q, ql)
        for i in range(b.n):
            rid = b.ids[i].split()[0]
            if fh is not None:
                fh.write(b"@SQ\tSN:%s\tLN:%d\n" % (rid, int(b.lengths[i])))
        for p in range(P):
            for i in range(b.n):
                d = int(off[p, i])
                nm_count = int(mm[p, i])
                plen = int(ql[p])
                ident = 1.0 - nm_count / max(plen, 1)
                if nm_count >= (1 << 20) or ident < cutoff:
                    continue
                name, s = prims[p]
                if fh is not None:
                    fh.write(
                        b"%s\t0\t%s\t%d\t%d\t%dM\t*\t0\t0\t%s\t*\tNM:i:%d\n"
                        % (
                            name, b.ids[i].split()[0], d + 1,
                            max(2, 40 - 4 * nm_count), plen,
                            CODE_TO_BASE[np.minimum(s, 4)].tobytes(),
                            nm_count,
                        )
                    )
                n_out += 1
    if fh is not None:
        fh.close()
    print(f"Alignments:          \t{n_out}", file=sys.stderr)
    return n_out
