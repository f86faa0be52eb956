"""Quick wall-clock breakdown of the BBMap e2e path (run on GPU or CPU).

Usage: python tools/bbmap_profile.py   (from the checkout root)
"""
import os
import sys
import time
import tempfile

import numpy as np

from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.models.bbmap import BBMap, BBMapConfig
from bbtools_tpu.models.bbmap_index import SeedIndex
from bbtools_tpu.utils.synth import random_genome, write_reads
from bbtools_tpu.core.dna import CODE_TO_BASE

READ_LEN = 150


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    rng = np.random.default_rng(7)
    tmpdir = tempfile.mkdtemp()
    genome = random_genome(2_000_000, n_scaffolds=4, seed=11)
    ref_fa = os.path.join(tmpdir, "ref.fa")
    write_fasta(ref_fa, genome)
    ref = load_reference(ref_fa)
    idx = SeedIndex.build(ref, k=13)
    recs = []
    for i in range(n):
        scaf = int(rng.integers(0, len(ref.lengths)))
        codes = ref.scaffold_codes(scaf)
        start = int(rng.integers(0, len(codes) - READ_LEN))
        r = codes[start : start + READ_LEN].copy()
        if i & 1:
            r = (3 - r[::-1]).astype(np.uint8)
        e = rng.random(READ_LEN) < 0.01
        r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
        recs.append((b"r%d" % i, CODE_TO_BASE[np.minimum(r, 4)].tobytes(),
                     b"F" * READ_LEN))
    reads_fq = os.path.join(tmpdir, "reads.fq")
    write_reads(reads_fq, recs)
    out_sam = os.path.join(tmpdir, "out.sam")
    cfg = BBMapConfig(in1=reads_fq, out=out_sam, batch_reads=4096)
    BBMap(cfg, index=idx).run()  # warm
    os.remove(out_sam)

    # instrument: monkeypatch candidates_for_batch + map_batch
    import bbtools_tpu.models.bbmap as M
    t_cand = [0.0]
    t_map = [0.0]
    orig_c = M.BBMap.candidates_for_batch
    orig_m = M.BBMap.map_batch

    def timed_c(self, *a, **k):
        t0 = time.perf_counter()
        r = orig_c(self, *a, **k)
        t_cand[0] += time.perf_counter() - t0
        return r

    def timed_m(self, *a, **k):
        t0 = time.perf_counter()
        r = orig_m(self, *a, **k)
        t_map[0] += time.perf_counter() - t0
        return r

    M.BBMap.candidates_for_batch = timed_c
    M.BBMap.map_batch = timed_m
    t0 = time.perf_counter()
    tool = BBMap(cfg, index=idx).run()
    dt = time.perf_counter() - t0
    M.BBMap.candidates_for_batch = orig_c
    M.BBMap.map_batch = orig_m
    print(f"total        {dt:8.3f}s  {n/dt:10.0f} reads/s "
          f"{n*READ_LEN/dt/1e6:8.1f} Mb/s")
    print(f"  candidates {t_cand[0]:8.3f}s")
    print(f"  map_batch  {t_map[0]:8.3f}s (incl candidates)")
    print(f"  io+sam     {dt - t_map[0]:8.3f}s")
    print(f"mapped: {tool.reads_mapped}/{tool.reads_in}")


if __name__ == "__main__":
    main()
