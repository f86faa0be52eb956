#!/usr/bin/env python3
"""Smoke test of bbtools_tpu on one NVIDIA GPU.

    python3 chip_smoke.py            # one GPU
    python3 chip_smoke.py --multi    # four GPUs: the sharded paths only

Phases, each of which must pass (none catches its own failure):

1. The device: JAX's default device must be a GPU. Prints its kind, the
   device count, and nvidia-smi's name and power limit.
2. The hand-written kernel: the CUDA MSA fill (ops/cuda/msa_fill.cu),
   compiled at bbmap's real widths, compared once with the XLA fill and
   the Python oracle, and timed against the XLA fill.
3. The six BASELINE pipelines through the CLI at E. coli scale (a
   5 Mbp genome), each graded against its truth, with reads/s.
4. The backend choices of core/backend.py, both sides of each timed on
   the phase-3 inputs.
5. Parity: the first 20,000 reads (8,000 pairs) of every input through
   the same six pipelines here and in a child process held to the CPU;
   every output file must be byte-identical. The child starts after the
   timed phases, so it shares the host with none of them.

With --multi only the sharded production paths run (bbduk, kmercountexact,
bbmap, bbmerge and tadpole over 4 devices), each compared byte for byte
with the same run on one device.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SEED = 11
GENOME_BP = 5_000_000  # E. coli K-12 is 4.64 Mbp
SNP_RATE = 0.001  # planted variants for callvariants
READ_LEN = 151
N_DUK = 400_000  # bbduk and kmercountexact reads
N_PAIRS = 200_000  # bbmerge pairs, inserts 180-280
N_MAP = 200_000  # bbmap reads with truth headers
TADPOLE_COVERAGE = 20
#: tadpole assembles 20x of the genome's first ASM_BP bases: its contig
#: walk runs on the host at ~0.7 s per kbp of genome, so the 5 Mbp genome
#: would take about an hour; this region runs three times (the full run,
#: the parity subset here and in the CPU child)
ASM_BP = 200_000
#: reads for the k-mer counting choices (both sides run twice)
CHOICE_READS = 100_000
SUBSET_READS = 20_000
SUBSET_PAIRS = 8_000
ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"  # TruSeq read-1 adapter
MSA_SHAPES = ((512, 151, 175), (512, 151, 2223))  # B, R, Cc
ORACLE_TASKS = 4  # per MSA shape: the pure-Python oracle is slow

# bars each full-size run must clear
MIN_STRICT = 0.97  # bbmap strict-correct (README)
MIN_MERGE_RATE = 0.95  # every pair overlaps by >= 22 bases
MIN_INSERT_CORRECT = 0.99
MIN_SNP_RECALL = 0.90  # ~6x coverage, every call
MIN_PASS_PRECISION = 0.95  # the calls that pass callvariants' filters
MIN_ASM_COVERED = 0.95  # share of the assembled region inside a contig


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _write_fastq(path, names, seqs, quals):
    """names: list[bytes]; seqs/quals: [n, L] uint8 ASCII."""
    with open(path, "wb") as fh:
        for i, nm in enumerate(names):
            fh.write(b"@" + nm + b"\n" + seqs[i].tobytes() + b"\n+\n"
                     + quals[i].tobytes() + b"\n")


def gen_inputs(d, genome_bp=GENOME_BP, n_duk=N_DUK, n_pairs=N_PAIRS,
               n_map=N_MAP, coverage=TADPOLE_COVERAGE, asm_bp=None,
               seed=SEED):
    """Every input of the six pipelines, from one seed:
    ref.fa (random genome), truth.vcf (SNPs planted in the sampled
    genome), reads.fq (bbduk/kmercountexact: 2 substitutions per read, a
    TruSeq adapter in every third), r1.fq/r2.fq (bbmerge pairs with
    inserts 180-280 in their names), map.fq (bbmap reads with truth
    headers, SNPs and indels), asm.fq (tadpole: `coverage`x of the first
    `asm_bp` bases, default all, both strands) and asm_ref.fa (those
    bases). Returns the number of reads with a planted adapter."""
    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.io.fasta import Reference, load_reference, write_fasta
    from bbtools_tpu.utils.synth import (
        mutate_genome, random_genome, random_reads, write_reads,
    )

    os.makedirs(d, exist_ok=True)
    L = READ_LEN
    rng = np.random.default_rng(seed)
    write_fasta(os.path.join(d, "ref.fa"),
                random_genome(genome_bp, n_scaffolds=1, seed=seed))
    ref = load_reference(os.path.join(d, "ref.fa"))
    (mut,), truth = mutate_genome(ref, sub_rate=SNP_RATE, seed=seed + 1)
    name = ref.names[0].split()[0].decode()
    with open(os.path.join(d, "truth.vcf"), "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for _, p, rc, ac in truth:
            fh.write(f"{name}\t{p + 1}\t.\t{'ACGT'[rc]}\t{'ACGT'[ac]}"
                     "\t.\t.\t.\n")
    G = len(mut)
    cols = np.arange(L)
    rows_of = lambda n: np.arange(n)[:, None]  # noqa: E731
    comp = np.array([3, 2, 1, 0, 4], np.uint8)

    # bbduk / kmercountexact
    starts = rng.integers(0, G - L, n_duk)
    seqs = mut[starts[:, None] + cols]
    pos = rng.integers(0, L, (n_duk, 2))
    seqs[rows_of(n_duk), pos] = (
        seqs[rows_of(n_duk), pos] + rng.integers(1, 4, (n_duk, 2))
    ) % 4
    seqs = CODE_TO_BASE[seqs]
    planted = np.arange(n_duk) % 3 == 0
    q = rng.integers(60, 140, n_duk)[:, None]
    ad = np.frombuffer(ADAPTER, np.uint8)
    m = planted[:, None] & (cols >= q) & (cols < q + len(ad))
    seqs[m] = ad[np.broadcast_to(cols - q, seqs.shape)[m]]
    _write_fastq(os.path.join(d, "reads.fq"),
                 [b"r%d" % i for i in range(n_duk)], seqs,
                 np.full((n_duk, L), ord("F"), np.uint8))

    # bbmerge pairs
    ins = rng.integers(180, 280, n_pairs)
    starts = rng.integers(0, G - 280, n_pairs)
    r1 = CODE_TO_BASE[mut[starts[:, None] + cols]]
    r2 = CODE_TO_BASE[comp[mut[(starts + ins - 1)[:, None] - cols]]]
    q1 = rng.integers(58, 72, (n_pairs, L)).astype(np.uint8)
    q2 = rng.integers(58, 72, (n_pairs, L)).astype(np.uint8)
    _write_fastq(os.path.join(d, "r1.fq"),
                 [b"p%d_insert%d /1" % (i, ins[i]) for i in range(n_pairs)],
                 r1, q1)
    _write_fastq(os.path.join(d, "r2.fq"),
                 [b"p%d_insert%d /2" % (i, ins[i]) for i in range(n_pairs)],
                 r2, q2)

    # bbmap: truth headers, sequencing errors, one indel in 1 read of 10
    mref = Reference(codes=mut, names=[ref.names[0]],
                     starts=np.zeros(1, np.int64),
                     lengths=np.array([G], np.int64))
    write_reads(os.path.join(d, "map.fq"), random_reads(
        mref, n_map, read_len=L, snp_rate=0.002, indel_rate=0.1,
        indel_range=(1, 8), seed=seed + 2,
    ))

    # tadpole: error-free reads of the sampled genome, both strands
    Ga = min(asm_bp or G, G)
    with open(os.path.join(d, "asm_ref.fa"), "wb") as fh:
        fh.write(b">asm\n" + CODE_TO_BASE[mut[:Ga]].tobytes() + b"\n")
    n_asm = coverage * Ga // L
    starts = rng.integers(0, Ga - L, n_asm)
    seqs = mut[starts[:, None] + cols]
    rev = rng.random(n_asm) < 0.5
    seqs[rev] = comp[seqs[rev, ::-1]]
    _write_fastq(os.path.join(d, "asm.fq"),
                 [b"a%d" % i for i in range(n_asm)], CODE_TO_BASE[seqs],
                 np.full((n_asm, L), ord("F"), np.uint8))
    return int(planted.sum())


def subset_inputs(src, dst, n_reads=SUBSET_READS, n_pairs=SUBSET_PAIRS):
    """The first n_reads reads (n_pairs pairs) of every input."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(src, "ref.fa"), dst)
    for name, n in (("reads.fq", n_reads), ("map.fq", n_reads),
                    ("asm.fq", n_reads), ("r1.fq", n_pairs),
                    ("r2.fq", n_pairs)):
        with open(os.path.join(src, name), "rb") as fi, \
                open(os.path.join(dst, name), "wb") as fo:
            for _ in range(4 * n):
                line = fi.readline()
                if not line:
                    break
                fo.write(line)


# ---------------------------------------------------------------------------
# pipelines and parity
# ---------------------------------------------------------------------------

PIPELINES = ("bbduk", "kmercountexact", "bbmerge", "bbmap", "callvariants",
             "tadpole")


def pipeline_argv(tool, ind, out, extra=()):
    j = os.path.join
    argv = {
        "bbduk": ["bbduk", f"in={j(ind, 'reads.fq')}",
                  f"out={j(out, 'bbduk.fq')}", "ref=adapters", "k=23",
                  "mink=11", "hdist=1", "ktrim=r", "minlen=40",
                  f"stats={j(out, 'bbduk_stats.txt')}"],
        "kmercountexact": ["kmercountexact", f"in={j(ind, 'reads.fq')}",
                           "k=31", f"khist={j(out, 'khist.txt')}",
                           f"peaks={j(out, 'peaks.txt')}"],
        "bbmerge": ["bbmerge", f"in1={j(ind, 'r1.fq')}",
                    f"in2={j(ind, 'r2.fq')}", f"out={j(out, 'merged.fq')}",
                    f"outu={j(out, 'unmerged.fq')}",
                    f"ihist={j(out, 'ihist.txt')}"],
        "bbmap": ["bbmap", f"ref={j(ind, 'ref.fa')}",
                  f"in={j(ind, 'map.fq')}", f"out={j(out, 'mapped.sam')}",
                  "nodisk=t"],
        "callvariants": ["callvariants", f"in={j(out, 'mapped.sam')}",
                         f"ref={j(ind, 'ref.fa')}",
                         f"vcf={j(out, 'vars.vcf')}"],
        "tadpole": ["tadpole", f"in={j(ind, 'asm.fq')}",
                    f"out={j(out, 'contigs.fa')}", "k=62"],
    }[tool]
    return argv + list(extra) + ["ow=t"]


def run_cli(argv, logpath):
    """One CLI run in this process, its chatter appended to logpath.
    Returns wall seconds; a non-zero tool exit raises."""
    from bbtools_tpu.cli import main as cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = cli(list(argv))
    dt = time.perf_counter() - t0
    with open(logpath, "a") as fh:
        fh.write(f"$ {' '.join(argv)}\n{buf.getvalue()}")
    if rc not in (0, None):
        raise RuntimeError(f"{argv[0]} exited {rc}; see {logpath}")
    return dt


def run_pipelines(ind, out):
    """The six pipelines over the inputs in `ind`; returns seconds each."""
    os.makedirs(out, exist_ok=True)
    logp = os.path.join(out, "..", os.path.basename(out) + ".log")
    return {t: run_cli(pipeline_argv(t, ind, out), logp) for t in PIPELINES}


def _normalize(rel: str, data: bytes) -> bytes:
    """Strip the fields that legitimately embed the output path."""
    if rel.endswith(".sam"):
        return b"\n".join(
            line for line in data.split(b"\n")
            if not line.startswith(b"@PG")
        )
    if rel.endswith((".txt", ".vcf")):
        return b"\n".join(
            line for line in data.split(b"\n")
            if not line.startswith((b"#File", b"##CL", b"##cmd"))
        )
    return data


def compare_trees(a: str, b: str) -> bool:
    """Per-file sha256 comparison of two output trees (inputs/ dirs
    excluded). Prints one line per file and a final PARITY_OK/FAIL."""
    def walk(root):
        out = {}
        for dirp, dirs, files in os.walk(root):
            dirs[:] = [x for x in dirs if x != "inputs"]
            for f in files:
                p = os.path.join(dirp, f)
                out[os.path.relpath(p, root)] = p
        return out

    fa, fb = walk(a), walk(b)
    ok = True
    for rel in sorted(set(fa) | set(fb)):
        if rel not in fa or rel not in fb:
            log(f"MISSING   {rel}  (only in {'B' if rel in fb else 'A'})")
            ok = False
            continue
        with open(fa[rel], "rb") as fh:
            da = _normalize(rel, fh.read())
        with open(fb[rel], "rb") as fh:
            db = _normalize(rel, fh.read())
        ha = hashlib.sha256(da).hexdigest()
        hb = hashlib.sha256(db).hexdigest()
        if ha == hb:
            log(f"OK   {ha[:16]}  {rel}")
        else:
            log(f"DIFF {ha[:16]} != {hb[:16]}  {rel}")
            ok = False
    log("PARITY_OK" if ok else "PARITY_FAIL")
    return ok


def start_cpu_child(ind, out):
    """The same pipelines in a child held to the CPU: it never opens the
    card, so this process stays the only one on it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
            " chip_smoke.run_pipelines(sys.argv[2], sys.argv[3])")
    logf = open(out + ".child.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, HERE, ind, out],
        env=env, stdout=logf, stderr=subprocess.STDOUT,
    )
    logf.close()
    return proc


# ---------------------------------------------------------------------------
# graders
# ---------------------------------------------------------------------------


def count_fastq(path):
    n = 0
    short = 0
    with open(path, "rb") as fh:
        for i, line in enumerate(fh):
            if i % 4 == 1:
                n += 1
                short += len(line) - 1 < READ_LEN
    return n, short


def grade_assembly(contigs_path, region_path):
    """Every contig must be an exact substring of the assembled region
    (or of its reverse complement): the reads carry no errors. Returns
    the share of the region inside some contig, and the contigs' total
    length over the region's."""
    from bbtools_tpu.io.fasta import iter_fasta

    (region,) = [r.seq for r in iter_fasta(region_path)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    covered = np.zeros(len(region), bool)
    total = 0
    for rec in iter_fasta(contigs_path):
        total += len(rec.seq)
        p = region.find(rec.seq)
        if p < 0:
            p = region.find(rec.seq[::-1].translate(comp))
        assert p >= 0, f"contig {rec.name!r} is not in the assembled region"
        covered[p : p + len(rec.seq)] = True
    return float(covered.mean()), total / len(region)


def grade_outputs(ind, out, n_planted, n_reads, n_pairs,
                  genome_bp=GENOME_BP):
    """Each full-size output against its truth; raises below a bar."""
    from bbtools_tpu.io.fasta import load_reference
    from bbtools_tpu.models.assemblystats import main as stats_main
    from bbtools_tpu.utils.graders import grade_sam
    from bbtools_tpu.utils.graders2 import grade_merged_main, grade_vcf

    res = {}
    kept, shortened = count_fastq(os.path.join(out, "bbduk.fq"))
    trimmed = n_reads - kept + shortened
    res["bbduk"] = f"trimmed {trimmed} reads, planted {n_planted}"
    assert trimmed >= n_planted, res["bbduk"]

    with open(os.path.join(out, "khist.txt")) as fh:
        hist = [ln.split() for ln in fh if ln[:1].isdigit()]
    distinct = sum(int(r[1]) for r in hist)
    res["kmercountexact"] = f"{distinct} distinct 31-mers"
    assert distinct > genome_bp // 2, res["kmercountexact"]

    with contextlib.redirect_stdout(io.StringIO()):
        correct, short, long_, _ = grade_merged_main(
            [f"in={os.path.join(out, 'merged.fq')}"]
        )
    merged = correct + short + long_
    res["bbmerge"] = (f"merged {merged / n_pairs:.4f} of pairs, insert "
                      f"correct {correct / max(merged, 1):.4f}")
    assert merged / n_pairs >= MIN_MERGE_RATE, res["bbmerge"]
    assert correct / max(merged, 1) >= MIN_INSERT_CORRECT, res["bbmerge"]

    names = load_reference(os.path.join(ind, "ref.fa")).names
    g = grade_sam(os.path.join(out, "mapped.sam"), names)
    strict = g.correct_strict / max(g.total, 1)
    res["bbmap"] = (f"strict-correct {strict:.4f} "
                    f"({g.correct_strict}/{g.total}), mapped {g.mapped}")
    assert strict >= MIN_STRICT, res["bbmap"]

    # the VCF holds every call with FILTER PASS or FAIL: grade all of
    # them for recall, and the passing ones for precision
    vcf = os.path.join(out, "vars.vcf")
    truth = os.path.join(ind, "truth.vcf")
    passing = out + ".pass.vcf"
    with open(vcf) as fi, open(passing, "w") as fo:
        fo.writelines(ln for ln in fi if ln.startswith("#")
                      or ln.split("\t")[6] == "PASS")
    v, vp = grade_vcf(vcf, truth), grade_vcf(passing, truth)
    res["callvariants"] = (
        f"SNP recall {v.recall:.4f} over all {v.tp + v.fp} calls; PASS "
        f"calls: recall {vp.recall:.4f} precision {vp.precision:.4f} "
        f"(tp {vp.tp} fp {vp.fp} fn {vp.fn})"
    )
    assert v.recall >= MIN_SNP_RECALL, res["callvariants"]
    assert vp.precision >= MIN_PASS_PRECISION, res["callvariants"]

    contigs = os.path.join(out, "contigs.fa")
    with contextlib.redirect_stdout(io.StringIO()):
        st = stats_main([f"in={contigs}"])
    covered, depth = grade_assembly(contigs,
                                    os.path.join(ind, "asm_ref.fa"))
    res["tadpole"] = (f"contigs {st['contigs']}, total {st['total']} bp, "
                      f"N50 {st['n50']} bp, every contig exact, "
                      f"{covered:.4f} of the region covered, contigs "
                      f"{depth:.2f}x its length")
    assert covered >= MIN_ASM_COVERED, res["tadpole"]
    return res


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _time(fn, reps=5):
    """Median wall seconds of fn() (which must block on its result)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_msa_kernel(card):
    """The CUDA fill against the XLA fill (bit-equal on every output),
    against the oracle on a few tasks, and timed against it."""
    import jax
    import jax.numpy as jnp

    from bbtools_tpu.ops import msa_cuda
    from bbtools_tpu.ops.msa_oracle import fill_unlimited

    rng = np.random.default_rng(SEED)
    for B, R, Cc in MSA_SHAPES:
        refs = rng.integers(0, 4, (B, Cc)).astype(np.uint8)
        lens = rng.integers(R - 20, R + 1, B).astype(np.int32)
        reads = np.full((B, R), 4, np.uint8)
        for b in range(B):
            off = int(rng.integers(0, Cc - R - 10))
            src = refs[b, off : off + lens[b] + 10].copy()
            if b % 4 == 1:
                src = np.delete(src, slice(40, 43))
            elif b % 4 == 2:
                src = np.insert(src, 50, [0, 1, 2])
            src = src[: lens[b]]
            m = rng.random(len(src)) < 0.03
            src[m] = (src[m] + 1) % 4
            reads[b, : lens[b]] = src
        args = (jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(refs))
        assert msa_cuda.use_kernel(R)
        kernel = jax.jit(
            lambda r, l, f: msa_cuda._fill_cuda(R, Cc, r, l, f)
        )
        xla = jax.jit(lambda r, l, f: msa_cuda._fill_xla(R, Cc, r, l, f))
        compiled = kernel.lower(*args).compile()
        log(f"msa_fill B={B} R={R} Cc={Cc} memory_analysis: "
            f"{compiled.memory_analysis()}")
        got = [np.asarray(x) for x in kernel(*args)]
        want = [np.asarray(x) for x in xla(*args)]
        for name, g, w in zip(("score", "col", "state", "planes"), got,
                              want):
            assert g.shape == w.shape and (g == w).all(), (
                f"CUDA fill differs from the XLA fill in {name}"
            )
        for b in range(ORACLE_TASKS):
            _, _, (_, ocol, ostate, oscore) = fill_unlimited(
                reads[b, : lens[b]], refs[b]
            )
            assert (got[0][b], got[1][b], got[2][b]) == (
                oscore, ocol, ostate
            ), f"CUDA fill differs from the oracle on task {b}"
        t_k = _time(lambda: jax.block_until_ready(kernel(*args)))
        t_x = _time(lambda: jax.block_until_ready(xla(*args)))
        cells = B * (R + 1) * (R + Cc - 1)
        log(f"msa_fill B={B} R={R} Cc={Cc}: CUDA {t_k * 1e3:.3f} ms, "
            f"XLA {t_x * 1e3:.3f} ms ({t_x / t_k:.1f}x), "
            f"{cells / t_k / 1e9:.2f} G cells/s [{card}]")


def phase_pipelines(ind, out, n_planted, card):
    secs = run_pipelines(ind, out)
    n_reads = N_DUK
    n_map = N_MAP
    with open(os.path.join(ind, "asm.fq"), "rb") as fh:
        n_asm = sum(1 for _ in fh) // 4
    units = {
        "bbduk": (n_reads, "reads"), "kmercountexact": (n_reads, "reads"),
        "bbmerge": (N_PAIRS, "pairs"), "bbmap": (n_map, "reads"),
        "callvariants": (n_map, "reads"), "tadpole": (n_asm, "reads"),
    }
    grades = grade_outputs(ind, out, n_planted, n_reads, N_PAIRS)
    for t in PIPELINES:
        n, unit = units[t]
        log(f"{t}: {n} {unit} in {secs[t]:.2f} s = {n / secs[t]:.0f} "
            f"{unit}/s [{card}]; {grades[t]}")


def phase_choices(ind, work, card):
    """Both sides of each GPU choice in core/backend.py that a pipeline
    runs (msa_kernel is phase 2's).

    - device_kmer62: kmercountexact k=62 on the first CHOICE_READS reads
      of reads.fq, each side run twice, the second (warm) run counting.
    - device_merge: bbmerge on the parity subset's SUBSET_PAIRS pairs (the
      host side would take minutes at full size)."""
    from bbtools_tpu.core import backend

    table = backend.choices()

    def verdict(name, t_on, t_off, what):
        log(f"choice {name}: on {t_on:.3f} s, off {t_off:.3f} s {what}; "
            f"{'on' if t_on < t_off else 'off'} measured faster, table "
            f"says {'on' if getattr(table, name) else 'off'} [{card}]")

    cut = os.path.join(work, "choices")
    subset_inputs(ind, cut, n_reads=CHOICE_READS, n_pairs=SUBSET_PAIRS)
    log(f"choices: k-mer counting on the first {CHOICE_READS} reads, "
        f"bbmerge on {SUBSET_PAIRS} pairs (cuts)")
    logp = os.path.join(work, "choices.log")

    def timed(argv, name, flag, reps):
        with backend.override(**{name: flag}):
            return [run_cli(argv, logp) for _ in range(reps)][-1]

    o = os.path.join(cut, "out")
    os.makedirs(o, exist_ok=True)
    cases = {
        "device_kmer62": (["kmercountexact", f"in={cut}/reads.fq", "k=62",
                           f"khist={o}/h62.txt", "ow=t"], 2),
        "device_merge": (["bbmerge", f"in1={cut}/r1.fq", f"in2={cut}/r2.fq",
                          f"out={o}/m.fq", "ow=t"], 1),
    }
    for name, (argv, reps) in cases.items():
        t_on = timed(argv, name, True, reps)
        t_off = timed(argv, name, False, reps)
        verdict(name, t_on, t_off, "(CLI wall)")


def multi_inputs(ind, genome_bp=500_000, n_reads=SUBSET_READS,
                 n_pairs=SUBSET_PAIRS, asm_bp=20_000):
    """--multi's inputs: the parity subset's read counts over a smaller
    genome, and 20x of asm_bp bases for tadpole (its host walk would
    otherwise run twice per device count)."""
    gen_inputs(ind, genome_bp=genome_bp, n_duk=n_reads, n_pairs=n_pairs,
               n_map=n_reads, asm_bp=asm_bp)


def phase_multi(work, card, n_dev=4, **sizes):
    """Each sharded production path over n_dev devices, byte-compared
    with the same run on one device."""
    import jax

    assert len(jax.devices()) >= n_dev, f"--multi needs {n_dev} devices"
    ind = os.path.join(work, "inputs")
    multi_inputs(ind, **sizes)
    runs = {
        "bbduk": ("bbduk", f"tpshards={n_dev}"),
        "kmercountexact": ("kmercountexact", f"shards={n_dev}"),
        "bbmap": ("bbmap", f"tpshards={n_dev}"),
        "bbmerge": ("bbmerge", f"tpshards={n_dev}"),
        # the sharded spectrum counts k<=31
        "tadpole": ("tadpole", f"shards={n_dev}"),
    }
    ok = True
    for name, (tool, flag) in runs.items():
        dirs = []
        for tag, extra in (("one", ()), ("many", (flag,))):
            out = os.path.join(work, name, tag)
            os.makedirs(out, exist_ok=True)
            argv = pipeline_argv(tool, ind, out, extra)
            if tool == "tadpole":
                argv = [a if a != "k=62" else "k=31" for a in argv]
            t = run_cli(argv, os.path.join(work, f"{name}.log"))
            log(f"{name} {tag} ({flag if extra else 'one device'}): "
                f"{t:.2f} s [{card}]")
            dirs.append(out)
        ok &= compare_trees(*dirs)
    assert ok, "a sharded run differs from its one-device run"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the sharded paths on four GPUs and nothing "
                         "else")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's default device is {dev.platform!r}, "
              "not a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import bbtools_tpu  # noqa: F401  (x64, compile cache)

    # one line per card, as nvidia-smi prints them; the first labels
    # every measurement
    smi = nvidia_smi()
    log(smi)
    card = smi.splitlines()[0]
    log(f"device: {dev.device_kind}, {len(jax.devices())} devices")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.multi:
            phase_multi(work, card)
        else:
            t0 = time.perf_counter()
            full = os.path.join(work, "full", "inputs")
            sub = os.path.join(work, "sub", "inputs")
            n_planted = gen_inputs(full, asm_bp=ASM_BP)
            log(f"cut: tadpole assembles {TADPOLE_COVERAGE}x of the first "
                f"{ASM_BP} bp, not of all {GENOME_BP} bp (host contig walk)")
            subset_inputs(full, sub)
            log(f"inputs: {time.perf_counter() - t0:.1f} s")
            phase_msa_kernel(card)
            log(f"phase 2 done: {time.perf_counter() - t0:.1f} s")
            phase_pipelines(full, os.path.join(work, "full", "gpu"),
                            n_planted, card)
            log(f"phase 3 done: {time.perf_counter() - t0:.1f} s")
            phase_choices(full, work, card)
            log(f"phase 4 done: {time.perf_counter() - t0:.1f} s")
            # the CPU child starts after every timed phase: the host
            # cores it takes would otherwise slow the host-bound pipelines
            child = start_cpu_child(sub, os.path.join(work, "sub", "cpu"))
            try:
                run_pipelines(sub, os.path.join(work, "sub", "gpu"))
                log(f"parity subset on the GPU done: "
                    f"{time.perf_counter() - t0:.1f} s")
                rc = child.wait(timeout=900)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
            if rc != 0:
                with open(os.path.join(work, "sub", "cpu.child.log")) as fh:
                    log(fh.read()[-4000:])
                raise RuntimeError(f"CPU child exited {rc}")
            assert compare_trees(os.path.join(work, "sub", "cpu"),
                                 os.path.join(work, "sub", "gpu")), (
                "GPU and CPU outputs differ on the parity subset"
            )
            log(f"total: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
