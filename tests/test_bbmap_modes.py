"""BBMap mode fidelity: long indels via window classes, PacBio preset,
skimmer secondary sites, fastareadlen chunking, indel synth grading."""

import numpy as np
import pytest

from bbtools_tpu.core.dna import CODE_TO_BASE
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.models.bbmap import (
    BBMap,
    BBMapConfig,
    pacbio_preset,
    skimmer_preset,
)
from bbtools_tpu.models.bbmap_index import SeedIndex
from bbtools_tpu.utils.graders import grade_sam
from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads

rng = np.random.default_rng(99)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bbmap_modes")
    g = random_genome(120_000, n_scaffolds=1, seed=17)
    ref_fa = tmp / "ref.fa"
    write_fasta(str(ref_fa), g)
    ref = load_reference(str(ref_fa))
    idx = SeedIndex.build(ref, k=13)
    return tmp, ref, idx


def test_long_deletion_maps(genome):
    """A 200 bp deletion exceeds the old fixed pad=12 window; the spread-
    based window class must recover it with a D-run CIGAR at the exact
    leftmost position (maxindel=16000 semantics, BBMap.java)."""
    tmp, ref, idx = genome
    codes = ref.scaffold_codes(0)
    recs = []
    DEL = 200
    for i in range(24):
        start = 500 + i * 2000
        p = 60
        read = np.concatenate(
            [codes[start : start + p],
             codes[start + p + DEL : start + p + DEL + 60]]
        )
        recs.append(
            (b"r%d_scaf0_pos%d_strand0_insert0" % (i, start),
             CODE_TO_BASE[read].tobytes(), b"F" * len(read))
        )
    fq = tmp / "longdel.fq"
    write_reads(str(fq), recs)
    sam = tmp / "longdel.sam"
    BBMap(BBMapConfig(in1=str(fq), out=str(sam), batch_reads=32),
          index=idx).run()
    g = grade_sam(str(sam), ref.names)
    assert g.mapped >= 22, g.mapped
    assert g.correct_strict >= 0.9 * g.mapped, g.details[:4]
    text = sam.read_text()
    assert "%dD" % DEL in text, "expected a %dD cigar run" % DEL


def test_long_insertion_maps(genome):
    tmp, ref, idx = genome
    codes = ref.scaffold_codes(0)
    recs = []
    INS = 30
    novel = rng.integers(0, 4, INS).astype(np.uint8)
    for i in range(16):
        start = 700 + i * 2500
        read = np.concatenate(
            [codes[start : start + 60], novel, codes[start + 60 : start + 120]]
        )
        recs.append(
            (b"r%d_scaf0_pos%d_strand0_insert0" % (i, start),
             CODE_TO_BASE[read].tobytes(), b"F" * len(read))
        )
    fq = tmp / "longins.fq"
    write_reads(str(fq), recs)
    sam = tmp / "longins.sam"
    BBMap(BBMapConfig(in1=str(fq), out=str(sam), batch_reads=32),
          index=idx).run()
    g = grade_sam(str(sam), ref.names)
    assert g.mapped >= 14, g.mapped
    assert g.correct_strict >= 0.85 * g.mapped, g.details[:4]
    text = sam.read_text()
    assert "%dI" % INS in text or "%dS" % INS in text


def test_synth_indel_grading(genome):
    """SNP+indel synthetic reads grade
    >= 97% strict of mapped."""
    tmp, ref, idx = genome
    reads = random_reads(ref, 300, read_len=130, snp_rate=0.005,
                         indel_rate=0.4, indel_range=(1, 12), seed=5)
    fq = tmp / "synthindel.fq"
    write_reads(str(fq), reads)
    sam = tmp / "synthindel.sam"
    BBMap(BBMapConfig(in1=str(fq), out=str(sam), batch_reads=128),
          index=idx).run()
    g = grade_sam(str(sam), ref.names)
    assert g.mapped >= 294, g.mapped
    assert g.correct_strict >= 0.97 * g.mapped, (
        f"strict {g.correct_strict}/{g.mapped}: {g.details[:6]}"
    )


def test_pacbio_preset_long_reads(genome):
    """mapPacBio semantics: 2 kb reads with PacBio-like errors map as
    SINGLE records (no chunking at fastareadlen=6000), minratio=0.40."""
    tmp, ref, idx_illumina = genome
    codes = ref.scaffold_codes(0)
    L = 2000
    recs = []
    rng2 = np.random.default_rng(31)
    for i in range(6):
        start = 1000 + i * 15000
        read = codes[start : start + L].copy()
        # scattered subs at 4%
        m = rng2.random(L) < 0.04
        read[m] = (read[m] + rng2.integers(1, 4, int(m.sum()))) % 4
        # one mid-read 50bp deletion
        read = np.concatenate([read[:900], read[950:]])
        recs.append(
            (b"r%d_scaf0_pos%d_strand0_insert0" % (i, start),
             CODE_TO_BASE[read].tobytes(), b"F" * len(read))
        )
    fa = tmp / "pb.fa"
    with open(fa, "wb") as f:
        for nm, sq, _ in recs:
            f.write(b">" + nm + b"\n" + sq + b"\n")
    cfg = pacbio_preset(BBMapConfig())
    cfg.in1 = str(fa)
    sam_pb = tmp / "pb.sam"
    cfg.out = str(sam_pb)
    idx_pb = SeedIndex.build(ref, k=cfg.k)
    BBMap(cfg, index=idx_pb).run()
    g = grade_sam(str(sam_pb), ref.names, tolerance=20)
    assert g.mapped >= 5, g.mapped
    assert g.correct_loose >= 5, g.details[:4]
    body = [ln for ln in sam_pb.read_bytes().splitlines()
            if not ln.startswith(b"@")]
    assert len(body) == 6  # one record per read: NOT chunked

    # plain bbmap on the same FASTA chunks at fastareadlen=500:
    # different (but still correct) output shape — the distinguishing
    # behavior
    cfg2 = BBMapConfig(in1=str(fa), out=str(tmp / "ill.sam"),
                       batch_reads=64)
    BBMap(cfg2, index=idx_illumina).run()
    body2 = [ln for ln in (tmp / "ill.sam").read_bytes().splitlines()
             if not ln.startswith(b"@")]
    assert len(body2) >= 4 * 6  # ~1950/500 -> 4 chunks per read
    assert any(b"_chunk" in ln.split(b"\t")[0] for ln in body2)


def test_skimmer_secondary_sites(tmp_path):
    """Skimmer prints secondary alignments (0x100) for repeated loci."""
    rng2 = np.random.default_rng(13)
    seg = rng2.integers(0, 4, 3000).astype(np.uint8)
    filler = rng2.integers(0, 4, 5000).astype(np.uint8)
    genome_codes = np.concatenate([filler, seg, filler[::-1], seg, filler])
    fa = tmp_path / "dup.fa"
    write_fasta(str(fa), [(b"dup", CODE_TO_BASE[genome_codes].tobytes())])
    ref = load_reference(str(fa))
    recs = []
    for i in range(12):
        start = 5000 + 100 + i * 200  # inside first copy of seg
        read = genome_codes[start : start + 150]
        recs.append(
            (b"r%d_scaf0_pos%d_strand0_insert0" % (i, start),
             CODE_TO_BASE[read].tobytes(), b"F" * 150)
        )
    fq = tmp_path / "dup.fq"
    write_reads(str(fq), recs)
    cfg = skimmer_preset(BBMapConfig())
    cfg.in1 = str(fq)
    cfg.out = str(tmp_path / "skim.sam")
    idx = SeedIndex.build(ref, k=cfg.k)
    BBMap(cfg, index=idx).run()
    body = [ln for ln in (tmp_path / "skim.sam").read_bytes().splitlines()
            if not ln.startswith(b"@")]
    secondary = [ln for ln in body if int(ln.split(b"\t")[1]) & 0x100]
    primary = [ln for ln in body if not int(ln.split(b"\t")[1]) & 0x100]
    assert len(primary) == 12
    assert len(secondary) >= 10, len(secondary)  # second copy of seg
    # secondary records omit seq/qual per SAM convention
    f = secondary[0].split(b"\t")
    assert f[9] == b"*" and f[10] == b"*"


def test_bloom_prescreen(genome, tmp_path):
    """bloomfilter=t: foreign reads (no shared 31-mers) skip seeding and
    come out unmapped; genuine reads map identically to the non-bloom
    run."""
    tmp, ref, idx = genome
    rng2 = np.random.default_rng(3)
    codes = ref.scaffold_codes(0)
    recs = []
    for i in range(30):
        start = 100 + i * 900
        read = codes[start : start + 100]
        recs.append(
            (b"real%d_scaf0_pos%d_strand0_insert0" % (i, start),
             CODE_TO_BASE[read].tobytes(), b"F" * 100)
        )
    for i in range(30):
        recs.append(
            (b"junk%d_scaf0_pos0_strand0_insert0" % i,
             CODE_TO_BASE[rng2.integers(0, 4, 100).astype(np.uint8)].tobytes(),
             b"F" * 100)
        )
    fq = tmp_path / "bl.fq"
    write_reads(str(fq), recs)
    outs = {}
    for tag, bloom in (("off", False), ("on", True)):
        sam = tmp_path / f"bl_{tag}.sam"
        cfg = BBMapConfig(in1=str(fq), out=str(sam), batch_reads=64,
                          bloom_prescreen=bloom)
        tool = BBMap(cfg, index=idx)
        tool.run()
        body = [
            ln.split(b"\t")
            for ln in sam.read_bytes().splitlines()
            if ln and not ln.startswith(b"@")
        ]
        outs[tag] = {f[0]: (f[1], f[3]) for f in body}
        if bloom:
            assert tool.prescreened >= 30, tool.prescreened
    for name, rec in outs["off"].items():
        if name.startswith(b"real"):
            assert outs["on"][name] == rec  # identical mapping


def test_sam13_cigars(genome, tmp_path):
    from bbtools_tpu.io.sam import cigar14_to_13

    assert cigar14_to_13("5=1X4=1I3=1D2=") == "10M1I3M1D2M"
    assert cigar14_to_13("3S7=") == "3S7M"
    tmp, ref, idx = genome
    reads = random_reads(ref, 30, read_len=100, snp_rate=0.02, seed=9)
    fq = tmp_path / "s13.fq"
    write_reads(str(fq), reads)
    sam = tmp_path / "s13.sam"
    cfg = BBMapConfig(in1=str(fq), out=str(sam), batch_reads=32,
                      sam_version="1.3")
    BBMap(cfg, index=idx).run()
    body = [
        ln.split(b"\t")[5]
        for ln in sam.read_bytes().splitlines()
        if ln and not ln.startswith(b"@")
    ]
    assert all(b"=" not in c and b"X" not in c for c in body if c != b"*")
    assert any(b"M" in c for c in body)


def test_mhist_idhist(genome, tmp_path):
    tmp, ref, idx = genome
    reads = random_reads(ref, 60, read_len=100, snp_rate=0.03, seed=13)
    fq = tmp_path / "mh.fq"
    write_reads(str(fq), reads)
    cfg = BBMapConfig(
        in1=str(fq), out=str(tmp_path / "mh.sam"), batch_reads=64,
        mhist=str(tmp_path / "mhist.txt"), idhist=str(tmp_path / "id.txt"),
    )
    BBMap(cfg, index=idx).run()
    mh = (tmp_path / "mhist.txt").read_bytes().splitlines()
    assert mh[0].startswith(b"#BaseNum")
    assert len(mh) >= 100
    row = mh[50].split(b"\t")
    assert 0.9 < float(row[1]) <= 1.0  # ~97% match rate at 3% snps
    idh = (tmp_path / "id.txt").read_bytes().splitlines()
    counts = {int(r.split(b"\t")[0]): int(r.split(b"\t")[1])
              for r in idh[1:]}
    assert sum(counts.values()) == 60
    assert sum(c for i, c in counts.items() if i >= 90) >= 55


def test_bbmap_inline_coverage_matches_pileup(tmp_path):
    """covstats=/basecov=/covhist= emitted by the mapper itself
    (align2/AbstractMapper.printOutput -> CoveragePileup) must equal a
    separate pileup pass over the mapper's own SAM."""
    import numpy as np

    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models import pileup
    from bbtools_tpu.models.bbmap import BBMap, BBMapConfig, parse_args
    from bbtools_tpu.models.bbmap_index import SeedIndex
    from bbtools_tpu.utils.synth import random_genome, write_reads

    rng = np.random.default_rng(3)
    genome = random_genome(40_000, n_scaffolds=3, seed=8)
    write_fasta(str(tmp_path / "ref.fa"), genome)
    ref = load_reference(str(tmp_path / "ref.fa"))
    recs = []
    for i in range(600):
        s = int(rng.integers(0, 3))
        codes = ref.scaffold_codes(s)
        p = int(rng.integers(0, len(codes) - 100))
        r = codes[p : p + 100].copy()
        if i & 1:
            r = (3 - r[::-1]).astype(np.uint8)
        recs.append((b"r%d" % i, CODE_TO_BASE[np.minimum(r, 4)].tobytes(),
                     b"F" * 100))
    write_reads(str(tmp_path / "reads.fq"), recs)
    idx = SeedIndex.build(ref, k=13)
    cfg = parse_args([
        f"in={tmp_path}/reads.fq", f"out={tmp_path}/m.sam",
        f"ref={tmp_path}/ref.fa",
        f"covstats={tmp_path}/inline.covstats",
        f"basecov={tmp_path}/inline.basecov",
        f"covhist={tmp_path}/inline.covhist",
        f"bincov={tmp_path}/inline.bincov",
        "batchreads=256",
    ])
    BBMap(cfg, index=idx).run()
    pileup.main([
        f"in={tmp_path}/m.sam", f"ref={tmp_path}/ref.fa",
        f"out={tmp_path}/sep.covstats", f"basecov={tmp_path}/sep.basecov",
        f"covhist={tmp_path}/sep.covhist", f"bincov={tmp_path}/sep.bincov",
    ])
    for name in ("covstats", "basecov", "covhist", "bincov"):
        a = (tmp_path / f"inline.{name}").read_bytes()
        b = (tmp_path / f"sep.{name}").read_bytes()
        assert a == b, name
    assert b"Avg_fold" in (tmp_path / "inline.covstats").read_bytes()


def test_device_seed_cluster_equals_host(tmp_path):
    """ops/seed_cluster.seed_candidates_jnp == the host numpy
    candidates_for_batch: same values, same order (the
    device-ization of BBMap's host half)."""
    import jax.numpy as jnp
    import numpy as np

    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models.bbmap import BBMap, BBMapConfig
    from bbtools_tpu.models.bbmap_index import SeedIndex
    from bbtools_tpu.utils.synth import random_genome

    rng = np.random.default_rng(6)
    genome = random_genome(300_000, n_scaffolds=2, seed=14)
    write_fasta(str(tmp_path / "ref.fa"), genome)
    ref = load_reference(str(tmp_path / "ref.fa"))
    idx = SeedIndex.build(ref, k=13)
    tool = BBMap(BBMapConfig(), index=idx)
    B, L = 64, 151
    bases = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int64)
    for i in range(B):
        ln = int(rng.integers(60, L + 1))
        scaf = int(rng.integers(0, 2))
        codes = ref.scaffold_codes(scaf)
        p = int(rng.integers(0, len(codes) - ln))
        r = codes[p : p + ln].copy()
        if i & 1:
            r = (3 - r[::-1]).astype(np.uint8)
        e = rng.random(ln) < 0.02
        r[e] = (r[e] + 1) % 4
        if i % 7 == 0:
            r[ln // 2] = 4  # an N
        bases[i, :ln] = r
        lengths[i] = ln
    host = tool.candidates_for_batch(bases, lengths)  # platform=cpu -> host

    from bbtools_tpu.ops.seed_cluster import seed_candidates_jnp

    keys, vmask, offs, K = tool._seed_slots(bases, lengths)
    cfg = tool.cfg
    bridge = min(cfg.max_indel, cfg.window_extras[-1] - 2 * cfg.pad)
    t_cap = 1 << max(14, (4 * B * K).bit_length())
    c_cap = 2 * B * cfg.max_sites
    res = seed_candidates_jnp(
        jnp.asarray(keys[0].astype(np.int32)),
        jnp.asarray(keys[1].astype(np.int32)),
        jnp.asarray(vmask[0]), jnp.asarray(vmask[1]), jnp.asarray(offs),
        jnp.asarray(idx.starts.astype(np.int32)),
        jnp.asarray(idx.sites.astype(np.int32)),
        B, K, t_cap, c_cap, cfg.max_sites, int(bridge),
    )
    assert bool(res[7]), "t_cap overflow"
    n = int(res[6])
    dev = [np.asarray(x)[:n] for x in res[:6]]
    names = ("read", "diag", "strand", "votes", "spread", "modal")
    assert n == len(host[0]), (n, len(host[0]))
    for nm, h, dv in zip(names, host, dev):
        assert (h.astype(np.int64) == dv.astype(np.int64)).all(), nm
    # pre-cap cluster census (CLEARZONE_LIMIT1e input) matches too
    assert (
        host[6].astype(np.int64) == np.asarray(res[8]).astype(np.int64)
    ).all()


def test_bbmap_blacklist_routing(tmp_path):
    """align2/Blacklist: reads whose primary site lands on a blacklisted
    scaffold get NO SAM record and route to outb= instead."""
    import numpy as np

    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models.bbmap import BBMap, parse_args
    from bbtools_tpu.models.bbmap_index import SeedIndex
    from bbtools_tpu.utils.synth import random_genome, write_reads

    rng = np.random.default_rng(2)
    genome = random_genome(40_000, n_scaffolds=2, seed=5)
    write_fasta(str(tmp_path / "ref.fa"), genome)
    ref = load_reference(str(tmp_path / "ref.fa"))
    recs = []
    origins = []
    for i in range(200):
        s = i % 2
        codes = ref.scaffold_codes(s)
        p = int(rng.integers(0, len(codes) - 100))
        r = codes[p : p + 100]
        recs.append((b"r%d" % i, CODE_TO_BASE[np.minimum(r, 4)].tobytes(),
                     b"F" * 100))
        origins.append(s)
    write_reads(str(tmp_path / "reads.fq"), recs)
    blfile = tmp_path / "bl.txt"
    blfile.write_text(ref.names[1].split()[0].decode() + "\n")
    idx = SeedIndex.build(ref, k=13)
    cfg = parse_args([
        f"in={tmp_path}/reads.fq", f"out={tmp_path}/m.sam",
        f"blacklist={blfile}", f"outb={tmp_path}/black.fq",
        f"outm={tmp_path}/mapped.fq", "batchreads=64",
    ])
    BBMap(cfg, index=idx).run()
    sam = (tmp_path / "m.sam").read_bytes()
    blk_names = {b"r%d" % i for i, s in enumerate(origins) if s == 1}
    for nm in list(blk_names)[:10]:
        assert (nm + b"\t") not in sam, nm  # no SAM record
    kept = {l.split(b"\t")[0] for l in sam.splitlines()
            if not l.startswith(b"@")}
    assert len(kept) == 100  # scaffold-0 reads all present
    black = (tmp_path / "black.fq").read_bytes()
    n_black = black.count(b"@r")
    assert n_black == 100
    mapped = (tmp_path / "mapped.fq").read_bytes()
    assert not any((b"@" + nm + b"\n") in mapped for nm in blk_names)


def test_bbmap_giant_deletion_stitch(tmp_path):
    """GapTools role (align2/GapTools.java, BBIndex makeGappedSiteScore):
    reads spanning a deletion far larger than any DP window map as ONE
    two-anchor gapped site with an exact-length D run; intronlen=
    rewrites the run as N in the CIGAR."""
    import numpy as np

    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models.bbmap import BBMap, parse_args
    from bbtools_tpu.models.bbmap_index import SeedIndex
    from bbtools_tpu.utils.synth import random_genome, write_reads

    rng = np.random.default_rng(11)
    genome = random_genome(60_000, n_scaffolds=1, seed=21)
    write_fasta(str(tmp_path / "ref.fa"), genome)
    ref = load_reference(str(tmp_path / "ref.fa"))
    codes = ref.scaffold_codes(0)
    G = 8000  # deletion length: >> window bridge (~2k), <= maxindel
    recs = []
    for i in range(12):
        p = int(rng.integers(1000, 40_000))
        r = np.concatenate([codes[p : p + 75], codes[p + 75 + G : p + 150 + G]])
        recs.append((b"gd%d_%d" % (i, p),
                     CODE_TO_BASE[np.minimum(r, 4)].tobytes(), b"F" * 150))
    # plus plain reads: the stitch must not fire on them
    for i in range(12):
        p = int(rng.integers(1000, 40_000))
        r = codes[p : p + 150]
        recs.append((b"pl%d_%d" % (i, p),
                     CODE_TO_BASE[np.minimum(r, 4)].tobytes(), b"F" * 150))
    write_reads(str(tmp_path / "reads.fq"), recs)
    idx = SeedIndex.build(ref, k=13)
    cfg = parse_args([
        f"in={tmp_path}/reads.fq", f"out={tmp_path}/m.sam",
        "maxindel=16000",
    ])
    BBMap(cfg, index=idx).run()
    sam = [l.split(b"\t") for l in (tmp_path / "m.sam").read_bytes().splitlines()
           if l and not l.startswith(b"@")]
    rows = {r[0]: r for r in sam}
    n_gap = 0
    for name, row in rows.items():
        cig = row[5].decode()
        if name.startswith(b"gd"):
            if f"{G}D" in cig:
                n_gap += 1
                # position = planted start
                p = int(name.decode().split("_")[1])
                assert int(row[3]) == p + 1, (name, row[3])
        else:
            assert "D" not in cig or "8000D" not in cig
    assert n_gap >= 10, n_gap  # nearly all giant-del reads stitched
    # intronlen: the same run prints as N
    cfg2 = parse_args([
        f"in={tmp_path}/reads.fq", f"out={tmp_path}/n.sam",
        "maxindel=16000", "intronlen=1000",
    ])
    BBMap(cfg2, index=idx).run()
    nsam = (tmp_path / "n.sam").read_bytes()
    assert b"%dN" % G in nsam
    assert b"%dD" % G not in nsam


def test_gaptools_utils():
    """GapTools.java behavioral pins: fix_gaps normalization/merging,
    compressed length math."""
    from bbtools_tpu.ops.gaps import (
        GAPLEN, MINGAP, calc_gap_len, calc_gref_len, fix_gaps,
        gaps_to_string,
    )

    # basic normalization: bounds pinned, monotonic
    g = fix_gaps(100, 9000, [150, 500, 4000, 8000], MINGAP)
    assert g == [100, 500, 4000, 9000]
    # blocks closer than min_gap merge away -> ungapped -> None
    assert fix_gaps(100, 9000, [100, 5000, 5050, 9000], MINGAP) is None
    # out-of-range gap array
    assert fix_gaps(100, 200, [5000, 6000, 7000, 8000], MINGAP) is None
    assert gaps_to_string([1, 2, 3]) == "1~2~3"
    # compression math: short gaps literal, long gaps ~ GAPLEN:1
    assert calc_gap_len(0, MINGAP - 1) == MINGAP - 1
    big = calc_gap_len(0, 128 * 100 + 128)
    assert big < 128 * 100
    span = calc_gref_len(0, 20_000, [0, 1000, 15_000, 20_000])
    assert span < 20_001 - 10_000  # 14k gap compressed by ~128x


def test_bbmap_local_mode(tmp_path):
    """local=t (Read.toLocalAlignment role): reads whose ends diverge
    from the reference get soft-clipped ends instead of mismatch runs;
    POS moves past the clipped prefix."""
    import numpy as np

    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models.bbmap import BBMap, parse_args, to_local_match
    from bbtools_tpu.models.bbmap_index import SeedIndex
    from bbtools_tpu.utils.synth import random_genome, write_reads

    # unit: pure helper semantics
    m, shift = to_local_match(b"SSSS" + b"m" * 60 + b"SSS")
    assert m == b"CCCC" + b"m" * 60 + b"CCC"
    assert shift == 0  # prefix subs consume ref 1:1, C does too
    m2, _ = to_local_match(b"m" * 60)
    assert m2 == b"m" * 60  # clean alignments untouched

    rng = np.random.default_rng(17)
    genome = random_genome(30_000, n_scaffolds=1, seed=9)
    write_fasta(str(tmp_path / "ref.fa"), genome)
    ref = load_reference(str(tmp_path / "ref.fa"))
    codes = ref.scaffold_codes(0)
    recs = []
    for i in range(40):
        p = int(rng.integers(500, 25_000))
        r = codes[p : p + 120].copy()
        r[:15] = rng.integers(0, 4, 15)  # divergent 5' tail (adapter-ish)
        recs.append((b"lc%d_%d" % (i, p),
                     CODE_TO_BASE[np.minimum(r, 4)].tobytes(), b"F" * 120))
    write_reads(str(tmp_path / "reads.fq"), recs)
    idx = SeedIndex.build(ref, k=13)
    cfg = parse_args([f"in={tmp_path}/reads.fq", f"out={tmp_path}/l.sam",
                      "local=t"])
    BBMap(cfg, index=idx).run()
    sam = [l.split(b"\t") for l in
           (tmp_path / "l.sam").read_bytes().splitlines()
           if l and not l.startswith(b"@")]
    n_clip = 0
    for row in sam:
        cig = row[5].decode()
        if cig.startswith(("15S", "14S", "13S", "12S", "11S", "10S")):
            n_clip += 1
    assert n_clip >= 30, n_clip  # most divergent tails soft-clipped


def test_bbmap_ambig_random(tmp_path):
    """ambiguous=random: reads from a two-copy perfect repeat spread
    across BOTH copies (deterministic per seed) instead of always the
    lexicographically first site."""
    import numpy as np

    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models.bbmap import BBMap, parse_args
    from bbtools_tpu.models.bbmap_index import SeedIndex
    from bbtools_tpu.utils.synth import random_genome, write_reads

    rng = np.random.default_rng(23)
    g1 = random_genome(12_000, n_scaffolds=1, seed=31)
    # duplicate a 3kb block at two loci
    from bbtools_tpu.io.fasta import iter_fasta

    seq = g1[0][1]
    seq = seq[:2000] + seq[5000:8000] + seq[2000:]
    write_fasta(str(tmp_path / "ref.fa"), [(b"chr", seq)])
    ref = load_reference(str(tmp_path / "ref.fa"))
    codes = ref.scaffold_codes(0)
    recs = []
    for i in range(60):  # reads inside the duplicated block
        p = int(rng.integers(2100, 4800))
        r = codes[p : p + 100]
        recs.append((b"rp%d" % i,
                     CODE_TO_BASE[np.minimum(r, 4)].tobytes(), b"F" * 100))
    write_reads(str(tmp_path / "reads.fq"), recs)
    idx = SeedIndex.build(ref, k=13)
    cfg = parse_args([f"in={tmp_path}/reads.fq", f"out={tmp_path}/r.sam",
                      "ambig=random"])
    BBMap(cfg, index=idx).run()
    poss = [int(l.split(b"\t")[3]) for l in
            (tmp_path / "r.sam").read_bytes().splitlines()
            if l and not l.startswith(b"@") and not int(l.split(b"\t")[1]) & 4]
    lo = sum(1 for p in poss if p < 5100)
    hi = len(poss) - lo
    assert len(poss) >= 55
    assert lo >= 10 and hi >= 10, (lo, hi)  # spread over both copies


def test_bbmap_paired_site_selection(tmp_path):
    """pairSiteScoresFinal (AbstractMapThread:2284-2460): a read from a
    two-copy repeat is ambiguous alone, but its uniquely-mapped mate
    pulls it to the copy that forms a proper FR pair."""
    import numpy as np

    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models.bbmap import BBMap, parse_args
    from bbtools_tpu.models.bbmap_index import SeedIndex
    from bbtools_tpu.utils.synth import random_genome, write_reads

    rng = np.random.default_rng(41)
    base = random_genome(20_000, n_scaffolds=1, seed=77)[0][1]
    # copy the 2kb block at 3000..5000 to 12000 (perfect repeat)
    seq = base[:12_000] + base[3_000:5_000] + base[12_000:]
    write_fasta(str(tmp_path / "ref.fa"), [(b"chr", seq)])
    ref = load_reference(str(tmp_path / "ref.fa"))
    codes = ref.scaffold_codes(0)
    r1s, r2s = [], []
    for i in range(40):
        # r1 inside copy A of the repeat (positions 3000-4900)
        p1 = int(rng.integers(3_050, 4_800))
        f = codes[p1 : p1 + 100]
        # mate 250bp downstream ON THE UNIQUE side is impossible inside
        # the repeat for most p1; use insert 400 so r2 often leaves it
        p2 = p1 + 400
        rcv = codes[p2 : p2 + 100]
        rc = (3 - rcv[::-1]) % 4
        r1s.append((b"pp%d_%d" % (i, p1),
                    CODE_TO_BASE[np.minimum(f, 4)].tobytes(), b"F" * 100))
        r2s.append((b"pp%d_%d" % (i, p1),
                    CODE_TO_BASE[np.minimum(rc, 4)].tobytes(), b"F" * 100))
    write_reads(str(tmp_path / "r1.fq"), r1s)
    write_reads(str(tmp_path / "r2.fq"), r2s)
    idx = SeedIndex.build(ref, k=13)
    cfg = parse_args([
        f"in={tmp_path}/r1.fq", f"in2={tmp_path}/r2.fq",
        f"out={tmp_path}/p.sam",
    ])
    BBMap(cfg, index=idx).run()
    rows = [l.split(b"\t") for l in
            (tmp_path / "p.sam").read_bytes().splitlines()
            if l and not l.startswith(b"@")]
    ok = bad = 0
    for row in rows:
        flag = int(row[1])
        if flag & 0x4 or not flag & 0x40:  # read-1 records only
            continue
        want = int(row[0].split(b"_")[1]) + 1
        if int(row[3]) == want:
            ok += 1
        else:
            bad += 1
    assert ok + bad >= 38
    # without pairing, ~half would sit on the second copy (+9000);
    # paired selection places (nearly) all on the true copy
    assert bad <= 2, (ok, bad)
