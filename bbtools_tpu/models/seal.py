"""Seal — multi-reference k-mer quantification/binning (jgi/Seal.java:59).

BBDuk with per-REFERENCE values. Unlike BBDuk's single-id tables, Seal
k-mers are MULTI-VALUED: a k-mer shared by several references credits all
of them (Seal.java keeps id lists per kmer). Here the per-kmer value is an
int32 COMBO id into a distinct-bitset table (W x 62-bit words per row,
OR-merged at build) — the one-gather bucket lookup stays unchanged for
ANY number of reference files, and per-ref votes are bit tests over the
scan plane (device-native: no lists, no extra gathers). Reads are attributed
per `ambig=` (first | all | toss | best; Seal.java:280-291). Outputs
per-ref read/base counts (refstats format) and optional per-ref FASTQs
(pattern out=%.fq).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..core.dna import encode
from ..core.parser import tokenize
from ..io.fasta import iter_fasta
from ..io.fastq import FastqReader, FastqWriter
from ..ops.bbduk_scan import KScanConfig, kscan_full
from ..ops.kmer_index import BucketKmerIndex, build_ref_keys


def main(argv=None):
    import jax.numpy as jnp

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    refs = a.get_list("ref")
    out_pattern = a.get("pattern", "basename")
    stats = a.get("stats", "refstats")
    k = a.get_int("k", default=31)
    mkh = a.get_int("minkmerhits", "mkh", default=1)
    ambig = (a.get("ambiguous", "ambig") or "first").lower()
    t0 = time.time()
    # one id per REFERENCE FILE (Seal's ref-level attribution); scaffolds
    # within a file share the id. Bitsets are W x 62-bit words; the
    # bucket index stores an int32 COMBO id into the distinct-bitset
    # table, so any number of reference files works (the sharing combos
    # are few even when refs are many).
    nref = len(refs)
    W = max(1, (nref + 61) // 62)
    all_keys = []
    all_rid = []
    names = []
    for rid, path in enumerate(refs, start=1):
        names.append(path.encode())
        scaffolds = [encode(rec.seq) for rec in iter_fasta(path)]
        rk, _ = build_ref_keys(scaffolds, k)
        # dedup inside one ref (same bit): harmless but shrinks the sort
        rk = np.unique(rk)
        all_keys.append(rk)
        all_rid.append(np.full(len(rk), rid, dtype=np.int64))
    keys = np.concatenate(all_keys)
    rids = np.concatenate(all_rid)
    order = np.argsort(keys, kind="stable")
    sk, sr = keys[order], rids[order]
    group_start = np.flatnonzero(
        np.concatenate([[True], sk[1:] != sk[:-1]])
    )
    rows = np.zeros((len(group_start), W), np.int64)
    for w in range(W):
        word_mask = np.where(
            (sr - 1) // 62 == w, np.int64(1) << ((sr - 1) % 62), np.int64(0)
        )
        rows[:, w] = np.bitwise_or.reduceat(word_mask, group_start)
    combos, inverse = np.unique(rows, axis=0, return_inverse=True)
    # combo id 0 = miss: prepend a zero row
    combo_table = np.vstack([np.zeros((1, W), np.int64), combos])
    idx = BucketKmerIndex.build(
        sk[group_start], (inverse + 1).astype(np.int32)
    )
    cfg = KScanConfig(k=k, nb=idx.nb)
    table = idx.device_arrays()
    read_counts = np.zeros(nref + 1, dtype=np.int64)
    base_counts = np.zeros(nref + 1, dtype=np.int64)
    writers = {}
    reader = FastqReader(in1)
    for b in reader:
        out = kscan_full(cfg, table, jnp.asarray(b.bases), jnp.asarray(b.lengths))
        ids_pos = np.asarray(out["ids"])  # [B, L] combo ids per position
        B = b.n
        # votes per ref per read: expand combo id -> bitset word, test bit
        votes = np.zeros((nref + 1, B), dtype=np.int64)
        for rid in range(1, nref + 1):
            w, bit = (rid - 1) // 62, (rid - 1) % 62
            bits = (combo_table[ids_pos, w] >> np.int64(bit)) & 1
            votes[rid] = bits.sum(axis=1)
        best_votes = votes[1:].max(axis=0)
        best = np.where(
            best_votes >= mkh, votes[1:].argmax(axis=0) + 1, 0
        )  # argmax = lowest rid on ties (AMBIG_FIRST)
        if ambig == "toss":
            n_top = (votes[1:] == best_votes[None, :]).sum(axis=0)
            best = np.where((n_top > 1) & (best > 0), 0, best)
        np.add.at(read_counts, best, 1)
        np.add.at(base_counts, best, b.lengths.astype(np.int64))
        credit = votes[1:] >= mkh if ambig == "all" else None
        if out_pattern:
            for rid in range(1, nref + 1):
                keep = (
                    credit[rid - 1] if credit is not None else best == rid
                )
                if not keep.any():
                    continue
                if rid not in writers:
                    stem = refs[rid - 1].rsplit("/", 1)[-1].split(".")[0]
                    writers[rid] = FastqWriter(out_pattern.replace("%", stem))
                writers[rid].add(b, keep)
    for w in writers.values():
        w.close()
    if stats:
        with open(stats, "w") as fh:
            fh.write("#name\treads\tbases\n")
            for rid in range(1, nref + 1):
                fh.write(
                    f"{refs[rid-1]}\t{read_counts[rid]}\t{base_counts[rid]}\n"
                )
            fh.write(f"*unmatched*\t{read_counts[0]}\t{base_counts[0]}\n")
    print(f"Reads:               \t{reader.reads_in}", file=sys.stderr)
    for rid in range(1, nref + 1):
        print(f"  {refs[rid-1]}:\t{read_counts[rid]} reads", file=sys.stderr)
    print(f"Unmatched:           \t{read_counts[0]} reads", file=sys.stderr)
    print(f"Time:                \t{time.time()-t0:.3f} seconds.", file=sys.stderr)
    return read_counts


if __name__ == "__main__":
    main()
