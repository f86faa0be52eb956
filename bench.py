"""Benchmark suite: the five BASELINE.json configs on one GPU.

Each device row times steady-state compute with block_until_ready (the
median of several calls after a warm-up call that compiles); host rows
use the wall clock. An end-to-end BBDuk row (gzipped FASTQ from disk ->
FastqReader -> device scan -> trimmed FASTQ out) is also reported. The
script refuses to run without a GPU and exits non-zero when a section
raises.

Baselines are the reference's OWN published numbers (no JVM in this
image; derivations recorded in BASELINE.md):
- 500 Mbp/s: documented per-stream input ceiling of the Java pipeline
  (docs/guides/DedupeGuide.txt:19) — an upper bound on any
  single-input-stream Java tool (BBDuk config #1), generous to Java.
- 42 Mbp/s mapping peak on 4 cores (docs/changelog.txt:4950), scaled
  linearly to 32 threads = 336 Mbp/s (again generous: BBMap scaling is
  sublinear past NUMA boundaries).

Prints ONE JSON line: the flagship metric (BBDuk device-compute bases/s)
with every other config's result in "extras". Sections run in priority
order under a wall budget (BENCH_BUDGET_S, default 540 s); a section that
would not fit is recorded as {"skipped": "budget"}. The JSON line is also
emitted by an atexit hook and a SIGTERM handler with whatever sections
have completed, and BENCH_PARTIAL.json beside this script is updated
after every section.
"""

import atexit
import json
import os
import signal
import sys
import time

import numpy as np

JAVA_STREAM_CEILING_BPS = 500e6  # DedupeGuide.txt:19 (see BASELINE.md)
JAVA_MAP_32T_BPS = 336e6  # changelog.txt:4950 scaled 4c -> 32t

READ_LEN = 151
BATCH = 32768
HERE = os.path.dirname(os.path.abspath(__file__))

BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "540"))
_T0 = time.monotonic()


def _remaining():
    return BUDGET_S - (time.monotonic() - _T0)


def _rng():
    return np.random.default_rng(42)


def make_reads(rng, batch=BATCH, L=READ_LEN, adapter=None):
    bases = rng.integers(0, 4, (batch, L)).astype(np.uint8)
    if adapter is not None:
        acodes = adapter
        n_pl = batch // 3
        pos = rng.integers(60, L - 10, n_pl)
        for r, p in zip(rng.choice(batch, n_pl, replace=False), pos):
            m = min(len(acodes), L - p)
            bases[r, p : p + m] = acodes[:m]
    lengths = np.full(batch, L, np.int32)
    return bases, lengths


def device_time(fn, warmup=1, iters=5):
    """Median wall seconds of fn() with its result ready on the device."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_transfer():
    """Host->device rate for a packed read batch over the host link."""
    import jax

    from bbtools_tpu.ops.encode import pack_bases_np

    rng = _rng()
    bases, lengths = make_reads(rng)
    packed, nmask = pack_bases_np(bases)
    nbytes = packed.nbytes + nmask.nbytes + lengths.nbytes
    dt = device_time(
        lambda: [jax.device_put(x) for x in (packed, nmask, lengths)]
    )
    return {"bytes_per_sec": nbytes / dt, "batch_bytes": nbytes}


def _bbduk_device_for_panel(scaffolds):
    """Build the production device step for a reference panel, with the
    packed bucket index models/bbduk.build_index builds; returns
    (step_fn, index_name, n_keys)."""
    import jax
    import jax.numpy as jnp

    from bbtools_tpu.ops.bbduk_scan import KScanConfig, kscan_combined
    from bbtools_tpu.ops.encode import unpack_bases_jnp
    from bbtools_tpu.ops.kmer_index import BucketKmerIndex, build_ref_keys

    k = 23
    keys, ids = build_ref_keys(scaffolds, k, mink=11, hdist=1)
    idx = BucketKmerIndex.build(keys, ids, pack=True)
    cfg = KScanConfig(k=k, mink=11, nb=idx.nb, packed=idx.packed)
    table = idx.device_arrays()

    @jax.jit
    def device_step(packed, nmask, lengths):
        bases = unpack_bases_jnp(packed, nmask, READ_LEN)
        out, _, shortR = kscan_combined(cfg, table, bases, lengths,
                                        False, True)
        keep_to = jnp.where(out["nhits"] > 0, out["min_loc"] - 1, lengths - 1)
        return out["nhits"], out["id0"], keep_to, shortR[0]

    return device_step, type(idx).__name__, len(keys)


def bench_bbduk_device():
    """Config #1: adapter scan k=23 mink=11 hdist=1 ktrim=r, device only —
    the production fused scan graph (full + short + verdict in one
    dispatch), at BOTH panel scales: one adapter and the full bundled
    adapters.fa."""
    import os

    import jax.numpy as jnp

    from bbtools_tpu.core.dna import encode
    from bbtools_tpu.io.fasta import iter_fasta
    from bbtools_tpu.ops.encode import pack_bases_np

    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    rng = _rng()
    bases, lengths = make_reads(rng, adapter=encode(adapter))
    packed, nmask = pack_bases_np(bases)
    dp, dn, dl = map(jnp.asarray, (packed, nmask, lengths))

    out = {}
    panels = {"1adapter": [encode(adapter)]}
    res = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "bbtools_tpu", "resources", "adapters.fa",
    )
    panels["adapters_fa"] = [encode(r.seq) for r in iter_fasta(res)]
    for name, scafs in panels.items():
        step_fn, idx_name, n_keys = _bbduk_device_for_panel(scafs)
        dt = device_time(lambda: step_fn(dp, dn, dl))
        out[name] = {
            "reads_per_sec": BATCH / dt,
            "bases_per_sec": BATCH * READ_LEN / dt,
            "index": idx_name,
            "n_keys": n_keys,
        }
    # headline = the full real panel (honest config)
    out["bases_per_sec"] = out["adapters_fa"]["bases_per_sec"]
    out["reads_per_sec"] = out["adapters_fa"]["reads_per_sec"]
    return out


def bench_bbduk_end_to_end(tmpdir):
    """Config #1 end-to-end: gzipped FASTQ on disk -> FastqReader (native
    codec) -> device scan/trim -> FASTQ out. Includes ALL host work:
    the user-visible rate."""
    import gzip
    import os

    from bbtools_tpu.cli import main as cli_main

    rng = _rng()
    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    n = 10000
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    total_bases = 0
    for i in range(n):
        L = int(rng.integers(90, 152))
        seq = ACGT[rng.integers(0, 4, L)].copy()
        if i % 3 == 0:
            p = int(rng.integers(40, L - 5))
            ins = np.frombuffer(adapter[: L - p], np.uint8)
            seq[p : p + len(ins)] = ins
        q = (33 + rng.integers(2, 40, L)).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes()))
        total_bases += L
    inp = os.path.join(tmpdir, "bench_in.fq.gz")
    outp = os.path.join(tmpdir, "bench_out.fq")
    with gzip.open(inp, "wb", compresslevel=2) as f:
        f.write(b"".join(recs))
    args = [
        "bbduk", f"in={inp}", f"out={outp}", "ref=adapters", "k=23",
        "mink=11", "hdist=1", "ktrim=r", "minlen=40", "overwrite=t",
    ]
    # ONE cold pass timed as-is (it compiles); a warm pass only if the
    # cold one stayed within a 60 s cap
    t0 = time.perf_counter()
    cli_main(args)
    dt_cold = time.perf_counter() - t0
    out = {
        "cold_reads_per_sec": n / dt_cold,
        "cold_wall_s": round(dt_cold, 1),
    }
    if dt_cold <= 60 and _remaining() > dt_cold + 20:
        os.remove(outp)
        t0 = time.perf_counter()
        cli_main(args)
        dt = time.perf_counter() - t0
        out["reads_per_sec"] = n / dt
        out["bases_per_sec"] = total_bases / dt
    else:
        out["note"] = "warm pass skipped: cold exceeded the 60 s cap"
    return out


def bench_kmercount():
    """Config #2: exact k=31 counting — device extraction and
    sort-reduce, and the spectrum read-back."""
    import jax.numpy as jnp

    from bbtools_tpu.ops.kmer_count import batch_kmers_jnp, sort_reduce

    rng = _rng()
    bases, lengths = make_reads(rng, batch=BATCH // 2)
    reads = BATCH // 2

    db, dl = jnp.asarray(bases), jnp.asarray(lengths)

    def dev_step():
        keys = batch_kmers_jnp(db, dl, 31)
        return sort_reduce(keys)

    dt_dev = device_time(dev_step)

    # spectrum read-back row: wall including the device->host transfer of
    # the counted spectrum (~16 MB)
    import jax

    @jax.jit
    def compute(db, dl):
        keys = batch_kmers_jnp(db, dl, 31)
        return sort_reduce(keys)

    def with_transfer():
        v, c, n = compute(db, dl)
        nn = int(n)
        np.asarray(v[:nn]), np.asarray(c[:nn])

    with_transfer()
    t0 = time.perf_counter()
    with_transfer()
    dt_all = time.perf_counter() - t0

    return {
        "reads_per_sec": reads / dt_dev,
        "bases_per_sec": reads * READ_LEN / dt_dev,
        "kmers_per_sec": reads * (READ_LEN - 30) / dt_dev,
        "with_spectrum_readback": {
            "reads_per_sec": reads / dt_all,
            "kmers_per_sec": reads * (READ_LEN - 30) / dt_all,
        },
    }


def bench_bbmerge():
    """Config #4: the PRODUCTION overlap pipeline — XLA insert scan +
    mateByOverlapRatio selection (prescan + main state machine as
    lax.scans)."""
    import jax
    import jax.numpy as jnp

    from bbtools_tpu.ops.overlap import (
        mate_by_overlap_ratio_jnp,
        overlap_counts_jnp,
    )

    rng = _rng()
    B = 8192
    a, alens = make_reads(rng, batch=B)
    b, blens = make_reads(rng, batch=B)
    n_inserts = 2 * READ_LEN - 2 * 24
    da, dbb = jnp.asarray(a), jnp.asarray(b)
    dal, dbl = jnp.asarray(alens), jnp.asarray(blens)
    mo0 = jnp.asarray(np.full(B, 7))
    mo = jnp.asarray(np.full(B, 24))

    @jax.jit
    def step_fn(da, dbb, dal, dbl):
        g, bad, ol = overlap_counts_jnp(da, dbb, dal, dbl, 24, n_inserts)
        return mate_by_overlap_ratio_jnp(
            g, bad, ol, dal, dbl, 24, mo0, mo, 24, 35,
            0.09, 0.1, 5.5, 0.55,
        )

    dt = device_time(lambda: step_fn(da, dbb, dal, dbl))
    return {
        "pairs_per_sec": B / dt,
        "bases_per_sec": B * 2 * READ_LEN / dt,
    }


def _contention_probe(iters: int = 2_000_000) -> float:
    """Fixed-work spin probe (ms). On a quiet machine this is stable
    run-to-run; inflation/variance across passes is direct evidence of
    sandbox CPU contention, recorded next to the rates it perturbs."""
    t0 = time.perf_counter()
    x = 0
    for i in range(iters):
        x += i & 7
    if x < 0:  # defeat DCE
        print(x)
    return (time.perf_counter() - t0) * 1e3


def bench_host_ingest():
    """Host FASTQ parse rate on a warm uncompressed file (the reference's
    500 Mbases/s per-stream ceiling is the bar): raw bytes -> padded SoA
    batches via the native MT codec + prefetch thread.

    Contention-robust protocol: 5 passes per mode,
    median AND best reported, with a fixed-work spin probe timed before
    every pass — if the row misses its bar, the probe series shows
    whether the machine or the code was slow."""
    import os
    import tempfile

    from bbtools_tpu.io.fastq import FastqReader

    rng = _rng()
    # ~66 MB: big enough to measure, small enough that the page cache
    # keeps it across passes (the 270 MB round-3 file was getting
    # partially evicted by the bench's own allocations, making the row
    # swing 226-588 Mb/s between runs)
    N_READS = 200_000
    path = os.path.join(tempfile.gettempdir(), "bench_ingest_sm.fq")
    if not os.path.exists(path) or os.path.getsize(path) < 60e6:
        ACGT = np.frombuffer(b"ACGT", np.uint8)
        with open(path, "wb") as f:
            parts = []
            for i in range(N_READS):
                seq = ACGT[rng.integers(0, 4, READ_LEN)].tobytes()
                parts.append(
                    b"@SRR1234.%d %d length=%d\n%s\n+\n%s\n"
                    % (i, i, READ_LEN, seq, b"F" * READ_LEN)
                )
                if len(parts) >= 20000:
                    f.write(b"".join(parts))
                    parts = []
            f.write(b"".join(parts))
    # two UNTIMED warmup passes: the first pass after other bench
    # sections measured as low as 29 Mb/s (codec threads + page/alloc
    # state cold) and was dragging the median far below steady state
    for _ in range(2):
        for b in FastqReader(path, batch_reads=8192):
            pass
    bw_buf = np.ones(64 << 20, np.uint8)
    bw_dst = np.empty_like(bw_buf)  # preallocated: measure copy BW,
    # not first-touch fault cost of a fresh allocation
    np.copyto(bw_dst, bw_buf)
    full_rates, count_rates, probes, bw_probes = [], [], [], []
    for rep in range(5):
        probes.append(round(_contention_probe(), 1))
        # DRAM-bandwidth probe: a CPU spin loop is register-bound and
        # blind to memory contention, which is what actually moves this
        # row; copy 64 MB and record GB/s
        t0 = time.perf_counter()
        np.copyto(bw_dst, bw_buf)
        bw_probes.append(
            round(len(bw_buf) / (time.perf_counter() - t0) / 1e9, 2)
        )
        with open(path, "rb") as f:  # re-warm page cache each pass
            while f.read(1 << 24):
                pass
        t0 = time.perf_counter()
        bases = 0
        for b in FastqReader(path, batch_reads=8192):
            bases += int(b.lengths.sum())
        full_rates.append(bases / (time.perf_counter() - t0))
        # compute-only readers (kmer counting etc.) skip the raw plane
        t0 = time.perf_counter()
        bases = 0
        for b in FastqReader(path, batch_reads=8192, with_ascii=False,
                             with_quals=False):
            bases += int(b.lengths.sum())
        count_rates.append(bases / (time.perf_counter() - t0))
    try:
        load1 = round(os.getloadavg()[0], 2)
    except OSError:
        load1 = None
    return {
        "bases_per_sec": float(np.median(full_rates)),
        "bases_per_sec_best": max(full_rates),
        "count_only_bases_per_sec": float(np.median(count_rates)),
        "count_only_bases_per_sec_best": max(count_rates),
        "passes": 5,
        "contention_probe_ms": probes,
        "membw_probe_gbps": bw_probes,
        "loadavg_1m": load1,
    }


def bench_bbmap_e2e(tmpdir):
    """Config #3 end-to-end: index an E. coli-scale genome, map reads
    through the production pipeline (seed -> cluster -> ungapped -> DP ->
    winner -> match string), wall-clock over the whole batch loop.
    Tracked against the 32-thread Java mapping figure (JAVA_MAP_32T_BPS);
    the device share is reported separately via the MSA row."""
    import os

    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models.bbmap import BBMap, BBMapConfig
    from bbtools_tpu.models.bbmap_index import SeedIndex
    from bbtools_tpu.utils.synth import random_genome, write_reads
    from bbtools_tpu.core.dna import CODE_TO_BASE

    rng = _rng()
    genome = random_genome(2_000_000, n_scaffolds=4, seed=11)
    ref_fa = os.path.join(tmpdir, "ref.fa")
    write_fasta(ref_fa, genome)
    ref = load_reference(ref_fa)
    t0 = time.perf_counter()
    idx = SeedIndex.build(ref, k=13)
    t_index = time.perf_counter() - t0
    n = 8192
    recs = []
    total_bases = 0
    for i in range(n):
        scaf = int(rng.integers(0, len(ref.lengths)))
        codes = ref.scaffold_codes(scaf)
        start = int(rng.integers(0, len(codes) - READ_LEN))
        r = codes[start : start + READ_LEN].copy()
        if i & 1:
            r = (3 - r[::-1]).astype(np.uint8)
        e = rng.random(READ_LEN) < 0.01
        r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
        recs.append((
            b"r%d" % i, CODE_TO_BASE[np.minimum(r, 4)].tobytes(),
            b"F" * READ_LEN,
        ))
        total_bases += READ_LEN
    reads_fq = os.path.join(tmpdir, "reads.fq")
    write_reads(reads_fq, recs)
    out_sam = os.path.join(tmpdir, "out.sam")
    cfg = BBMapConfig(in1=reads_fq, out=out_sam, batch_reads=4096)
    BBMap(cfg, index=idx).run()  # warm: compiles all window classes
    os.remove(out_sam)
    t0 = time.perf_counter()
    tool = BBMap(cfg, index=idx).run()
    dt = time.perf_counter() - t0
    out = {
        "reads_per_sec": n / dt,
        "bases_per_sec": total_bases / dt,
        "mapped_fraction": tool.reads_mapped / max(tool.reads_in, 1),
        "index_build_sec": round(t_index, 2),
        "vs_java_map_32t": round((total_bases / dt) / JAVA_MAP_32T_BPS, 4),
    }
    return out


def bench_bbmap_device_pipeline(tmpdir):
    """Config #3 architecture row: the PRODUCTION fused
    per-batch device phase — ungapped scoring + speculative DP +
    in-graph winner selection + winner walk-row gather, the exact graph
    map_batch dispatches ONCE per batch (ops/map_fused.fused_map_step,
    prepared by the production BBMap._fused_prep). The host stage (seed+cluster+prep) is wall-timed
    separately; production overlaps the two via the double-buffered
    prefetch, so the pipeline rate is the slower of the stages."""
    import jax
    import jax.numpy as jnp

    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models.bbmap import BBMap, BBMapConfig
    from bbtools_tpu.models.bbmap_index import SeedIndex
    from bbtools_tpu.ops.map_fused import fused_map_step
    from bbtools_tpu.utils.synth import random_genome

    rng = _rng()
    genome = random_genome(2_000_000, n_scaffolds=4, seed=11)
    ref_fa = os.path.join(tmpdir, "refdp.fa")
    write_fasta(ref_fa, genome)
    ref = load_reference(ref_fa)
    idx = SeedIndex.build(ref, k=13)
    tool = BBMap(BBMapConfig(), index=idx)
    B, L = 4096, READ_LEN
    bases = np.full((B, L), 4, np.uint8)
    lengths = np.full(B, L, np.int64)
    for i in range(B):
        scaf = int(rng.integers(0, len(ref.lengths)))
        codes = ref.scaffold_codes(scaf)
        p = int(rng.integers(0, len(codes) - L))
        r = codes[p : p + L].copy()
        if i & 1:
            r = (3 - r[::-1]).astype(np.uint8)
        e = rng.random(L) < 0.01
        r[e] = (r[e] + 1) % 4
        bases[i] = r

    def host_stage():
        cand = tool.candidates_for_batch(bases, lengths)
        t_read, t_diag, t_strand, t_votes, t_spread, t_anchor, _nc = cand
        task_reads, task_lens, refwins, _W = tool._build_tasks(
            bases, lengths, t_read, t_strand, t_anchor
        )
        return tool._fused_prep(
            B, L, t_read, t_votes, t_spread, t_anchor, t_diag,
            task_reads, task_lens, refwins,
        )

    t0 = time.perf_counter()
    prep = host_stage()
    prep = host_stage()
    t_host = (time.perf_counter() - t0) / 2
    # production runs the WHOLE host stage in the prefetch thread pool
    # (BBMap._prefetch_candidates, ordered, bounded in-flight); measure
    # its aggregate throughput the same way
    from concurrent.futures import ThreadPoolExecutor

    workers = max(1, min(4, (os.cpu_count() or 2) - 1))
    reps = 2 * workers
    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(lambda _i: host_stage(), range(reps)))
    t_host_pool = (time.perf_counter() - t0) / reps
    cls_shapes = prep["jit_args"][3]
    dt_dev = device_time(lambda: fused_map_step(*prep["jit_args"]))
    n_dp = sum(s[1] for s in cls_shapes)
    dt_pipe = max(dt_dev, t_host_pool)  # stages overlap via prefetch
    total_bases = B * L
    return {
        "device_reads_per_sec": B / dt_dev,
        "device_bases_per_sec": total_bases / dt_dev,
        "host_stage_reads_per_sec": B / t_host,
        "host_pool_reads_per_sec": B / t_host_pool,
        "host_pool_workers": workers,
        "pipeline_reads_per_sec": B / dt_pipe,
        "pipeline_bases_per_sec": total_bases / dt_pipe,
        "dp_alignments_per_batch": n_dp,
        "host_syncs_per_batch": 1,
        "vs_java_map_32t": round(
            (total_bases / dt_pipe) / JAVA_MAP_32T_BPS, 4
        ),
    }


def bench_bbmap_msa():
    """Config #3 hot loop: banded-window MSA fill with traceback planes
    (the per-site scoring kernel behind bbmap -> SAM; ops/msa_cuda.py)."""
    import jax.numpy as jnp

    from bbtools_tpu.ops.msa_cuda import msa_fill_tb

    rng = _rng()
    B = 512
    R = READ_LEN
    Cc = R + 2 * 12  # pad=12 window slack, as models/bbmap.py uses
    reads = rng.integers(0, 4, (B, R)).astype(np.uint8)
    read_lens = np.full(B, R, np.int32)
    refs = rng.integers(0, 4, (B, Cc)).astype(np.uint8)
    # plant near-matches so scores are realistic
    refs[:, 12 : 12 + R] = reads
    mut = rng.integers(0, R, (B, 3))
    for j in range(3):
        refs[np.arange(B), 12 + mut[:, j]] ^= 1
    cells = B * R * Cc

    args = tuple(map(jnp.asarray, (reads, read_lens, refs)))
    dt = device_time(lambda: msa_fill_tb(R, Cc, *args))
    return {
        "alignments_per_sec": B / dt,
        "cells_per_sec": cells / dt,
        "bases_per_sec": B * R / dt,
    }


def bench_tadpole_bigk():
    """Config #5 load phase: exact k=62 two-word counting — fused device
    extract+lex-sort+reduce (ops/kmers2.count_batchw_device)."""
    import jax.numpy as jnp

    from bbtools_tpu.ops.kmers2 import _count_batchw_jit

    rng = _rng()
    bases, lengths = make_reads(rng, batch=4096)
    fn = _count_batchw_jit(62)
    db = jnp.asarray(bases)
    dl = jnp.asarray(lengths)
    dt = device_time(lambda: fn(db, dl))
    return {"bases_per_sec": 4096 * READ_LEN / dt}


def _round_vals(d):
    return {
        k: (round(v, 4) if isinstance(v, float) else v) for k, v in d.items()
    }


_EXTRAS = {}
_EMITTED = False


def _snapshot():
    dev = _EXTRAS.get("bbduk_device", {})
    bps = dev.get("bases_per_sec", 0.0) if isinstance(dev, dict) else 0.0
    return {
        "metric": "bbduk_device_bases_per_sec_1gpu",
        "value": round(bps, 1),
        "unit": "bases/s",
        # the documented Java per-stream ceiling (500 Mbp/s,
        # DedupeGuide.txt:19) stands in for the unmeasurable 32T rate —
        # see BASELINE.md for the derivation
        "vs_baseline": round(bps / JAVA_STREAM_CEILING_BPS, 3),
        "extras": _EXTRAS,
    }


def _emit():
    global _EMITTED
    if _EMITTED:
        return
    _EMITTED = True
    print(json.dumps(_snapshot()), flush=True)


def _on_term(signum, frame):
    _EXTRAS["terminated_by_signal"] = signum
    _emit()
    os._exit(0)


def _write_partial():
    try:
        with open(os.path.join(HERE, "BENCH_PARTIAL.json"), "w") as f:
            json.dump(_snapshot(), f, indent=1)
    except OSError:
        pass


def main():
    sys.path.insert(0, HERE)
    import tempfile

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX's default device is {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 1
    import bbtools_tpu  # x64, compile cache, malloc tuning

    atexit.register(_emit)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_term)
    _EXTRAS.update(
        {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "timing": "block_until_ready median",
            "budget_s": BUDGET_S,
        }
    )

    td_ctx = tempfile.TemporaryDirectory()
    td = td_ctx.name

    # (name, fn, conservative cold-cache cost estimate in seconds), in
    # priority order: the flagship panel row, then khist, host ingest and
    # bbmap, then the rest
    sections = [
        ("bbduk_device", bench_bbduk_device, 150),
        ("kmercount_k31_device", bench_kmercount, 120),
        ("host_ingest", bench_host_ingest, 60),
        ("bbmap_device_pipeline", lambda: bench_bbmap_device_pipeline(td), 150),
        ("bbmap_end_to_end", lambda: bench_bbmap_e2e(td), 200),
        ("bbmerge_overlap_device", bench_bbmerge, 60),
        ("bbmap_msa_device", bench_bbmap_msa, 60),
        ("tadpole_k62", bench_tadpole_bigk, 50),
        ("transfer", bench_transfer, 30),
        ("bbduk_end_to_end", lambda: bench_bbduk_end_to_end(td), 90),
    ]
    # a warm compile cache shrinks every section; scale the cold
    # estimates down when it is populated
    try:
        cache_warm = len(os.listdir(bbtools_tpu.compile_cache_dir())) >= 10
    except OSError:
        cache_warm = False
    _EXTRAS["compile_cache_warm"] = cache_warm

    failed = []
    for name, fn, est in sections:
        if cache_warm:
            est = max(20, est // 5)
        rem = _remaining()
        if rem < min(est, 45):
            _EXTRAS[name] = {"skipped": "budget", "remaining_s": round(rem, 1)}
            _write_partial()
            continue
        t0 = time.monotonic()
        try:
            row = _round_vals(fn())
        except Exception as e:  # record, bench the rest, fail at the end
            row = {"error": f"{type(e).__name__}: {e}"[:300]}
            failed.append(name)
        row["elapsed_s"] = round(time.monotonic() - t0, 1)
        _EXTRAS[name] = row
        _write_partial()
        print(f"[bench] {name}: {row.get('elapsed_s')}s", file=sys.stderr)

    try:
        td_ctx.cleanup()
    except OSError:
        pass
    _emit()
    if failed:
        print(f"[bench] sections failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
