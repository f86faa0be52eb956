#!/usr/bin/env python3
"""A/B harness vs the Java reference — run on any host WITH a JVM.

This image ships no JVM (BASELINE.md), so bit-parity vs Java cannot be
asserted in CI here; this script is the portable harness for a
JVM-equipped host:

    python tools/java_ab.py --bbtools /path/to/bbmap \
        --repo /path/to/this/repo --workdir /tmp/ab

For each BASELINE config it synthesizes identical input, runs the Java
launcher and this framework's CLI with the same flags, and diffs the
outputs (byte-wise where the contract is bit parity, field-wise for
formats with cosmetic differences such as SAM @PG lines). Exit code 0 =
all comparisons pass.
"""

from __future__ import annotations

import argparse
import gzip
import os
import subprocess
import sys


CASES = [
    # (name, java launcher + args, our tool + args, outputs, compare mode)
    {
        "name": "bbduk_adapter_trim",
        "java": ["bbduk.sh", "in={in}", "out={out_java}", "ref=adapters",
                 "k=23", "mink=11", "hdist=1", "ktrim=r", "minlen=40",
                 "ordered=t"],
        "ours": ["bbduk", "in={in}", "out={out_ours}", "ref=adapters",
                 "k=23", "mink=11", "hdist=1", "ktrim=r", "minlen=40"],
        "compare": "bytes",
    },
    {
        "name": "kmercountexact_khist",
        "java": ["kmercountexact.sh", "in={in}", "khist={out_java}", "k=31"],
        "ours": ["kmercountexact", "in={in}", "khist={out_ours}", "k=31"],
        "compare": "table",
    },
    {
        "name": "bbmerge_ihist",
        "java": ["bbmerge.sh", "in1={in1}", "in2={in2}", "ihist={out_java}"],
        "ours": ["bbmerge", "in1={in1}", "in2={in2}", "ihist={out_ours}"],
        "compare": "table",
    },
    {
        "name": "bbmap_sam",
        "java": ["bbmap.sh", "ref={ref}", "in={in}", "out={out_java}",
                 "nodisk"],
        "ours": ["bbmap", "ref={ref}", "in={in}", "out={out_ours}",
                 "nodisk"],
        "compare": "sam",
    },
]


def synth_inputs(workdir: str, repo: str):
    sys.path.insert(0, repo)
    import numpy as np

    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads

    rng = np.random.default_rng(7)
    g = random_genome(200_000, seed=7)
    ref_fa = os.path.join(workdir, "ref.fa")
    write_fasta(ref_fa, g)
    ref = load_reference(ref_fa)
    reads = random_reads(ref, 5000, read_len=150, snp_rate=0.005, seed=8)
    in_fq = os.path.join(workdir, "reads.fq")
    write_reads(in_fq, reads)
    pairs = random_reads(ref, 3000, read_len=100, paired=True,
                         insert_range=(120, 260), snp_rate=0.002, seed=9)
    in1 = os.path.join(workdir, "r1.fq")
    in2 = os.path.join(workdir, "r2.fq")
    write_reads(in1, [p[0] for p in pairs])
    write_reads(in2, [p[1] for p in pairs])
    # adapter-contaminated reads for bbduk
    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(5000):
        L = int(rng.integers(90, 152))
        seq = ACGT[rng.integers(0, 4, L)].copy()
        if i % 3 == 0:
            p = int(rng.integers(40, L - 5))
            ins = np.frombuffer(adapter[: L - p], np.uint8)
            seq[p : p + len(ins)] = ins
        q = (33 + rng.integers(2, 40, L)).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes()))
    duk_fq = os.path.join(workdir, "duk.fq.gz")
    with gzip.open(duk_fq, "wb") as f:
        f.write(b"".join(recs))
    return {"in": duk_fq, "in1": in1, "in2": in2, "ref": ref_fa,
            "reads": in_fq}


def cmp_bytes(a, b):
    return open(a, "rb").read() == open(b, "rb").read()


def cmp_table(a, b):
    """Numeric-table comparison, ignoring comment formatting."""
    def rows(p):
        out = []
        for ln in open(p, "rb").read().splitlines():
            if ln.startswith(b"#") or not ln.strip():
                continue
            out.append(tuple(ln.split(b"\t")))
        return out

    return rows(a) == rows(b)


def cmp_sam(a, b):
    """Field-wise SAM compare ignoring header @PG/@HD and tag order."""
    def recs(p):
        out = []
        for ln in open(p, "rb").read().splitlines():
            if ln.startswith(b"@"):
                continue
            f = ln.split(b"\t")
            out.append((f[0], f[1], f[2], f[3], f[5]))
        return sorted(out)

    ra, rb = recs(a), recs(b)
    same = sum(1 for x, y in zip(ra, rb) if x == y)
    frac = same / max(len(ra), len(rb), 1)
    print(f"  sam agreement: {frac:.4f} ({same}/{max(len(ra), len(rb))})")
    return frac >= 0.97  # site-selection heuristics may differ on ties


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bbtools", required=True,
                    help="directory containing the Java launchers (*.sh)")
    ap.add_argument("--repo", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--workdir", default="/tmp/java_ab")
    args = ap.parse_args()
    os.makedirs(args.workdir, exist_ok=True)
    files = synth_inputs(args.workdir, args.repo)
    failures = []
    for case in CASES:
        name = case["name"]
        print(f"== {name}")
        subs = dict(files)
        subs["in"] = files["reads"] if name == "bbmap_sam" else files["in"]
        subs["out_java"] = os.path.join(args.workdir, name + ".java.out")
        subs["out_ours"] = os.path.join(args.workdir, name + ".ours.out")
        jcmd = [os.path.join(args.bbtools, case["java"][0])] + [
            t.format(**subs) for t in case["java"][1:]
        ]
        ocmd = [sys.executable, "-m", "bbtools_tpu"] + [
            t.format(**subs) for t in case["ours"]
        ]
        subprocess.run(jcmd, check=True)
        subprocess.run(
            ocmd, check=True,
            env={**os.environ, "PYTHONPATH": args.repo},
        )
        ok = {"bytes": cmp_bytes, "table": cmp_table, "sam": cmp_sam}[
            case["compare"]
        ](subs["out_java"], subs["out_ours"])
        print(f"  {'PASS' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
    if failures:
        print("FAILURES:", ", ".join(failures))
        return 1
    print("All A/B comparisons passed.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
