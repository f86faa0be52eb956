import numpy as np
import pytest

import jax.numpy as jnp

from bbtools_tpu.io.batch import ReadBatch
from bbtools_tpu.models.bbmerge import BBMerge, BBMergeConfig, _rc_batch, _rev_quals
from bbtools_tpu.ops.join import join_reads_np
from bbtools_tpu.ops.overlap import (
    calc_min_overlap_by_entropy_np,
    incr_table,
    mate_by_overlap_ratio_np,
    overlap_counts_jnp,
)

rng = np.random.default_rng(77)
f32 = np.float32


def oracle_counts(a, b, insert):
    """Direct transliteration of the per-insert window scan
    (BBMergeOverlapper.java:428-446)."""
    alen, blen = len(a), len(b)
    istart = 0 if insert <= blen else insert - blen
    jstart = 0 if insert >= blen else blen - insert
    olen = min(alen - istart, blen - jstart, insert)
    good = bad = 0
    for t in range(olen):
        ca, cb = a[istart + t], b[jstart + t]
        if ca == cb:
            if ca < 4:
                good += 1
        else:
            bad += 1
    return good, bad, olen


def oracle_ratio_mode(a, b, mo0, mo, min_insert0, min_insert, max_ratio,
                      min_second, margin, offset, g_incr=0.95, b_incr=0.95):
    """Per-read transliteration of findBestRatio + mateByOverlapRatioJava."""
    alen, blen = len(a), len(b)
    min_len = min(alen, blen)
    mo_eff = max(4, mo0, mo)
    mo0_eff = sorted((4, mo0, mo_eff))[1]

    def fsum(incr, n):
        s = f32(0)
        for _ in range(n):
            s = f32(s + f32(incr))
        return s

    # prescan
    best = f32(f32(max_ratio) + f32(0.0001))
    halfmax = f32(f32(max_ratio) * f32(0.5))
    x = None
    for insert in range(alen + blen - mo_eff, min_insert - 1, -1):
        good_c, bad_c, olen = oracle_counts(a, b, insert)
        good, bad = fsum(g_incr, good_c), fsum(b_incr, bad_c)
        badlimit = f32(best * olen)
        if bad <= badlimit:
            if bad_c == 0 and good > mo0_eff and good < mo_eff:
                x = f32(100.0)
                break
            ratio = f32(f32(bad + f32(offset)) / olen)
            if ratio < best:
                best = ratio
                if good >= mo_eff and ratio < halfmax:
                    x = best
                    break
    if x is None:
        x = best
    if x > f32(max_ratio):
        return -1, min_len, False
    maxr = min(f32(max_ratio), x)
    margin2 = f32(f32(f32(margin) + f32(offset)) / min_len)
    best_insert, best_bad_int = -1, -1
    best_ratio = f32(1)
    second_ratio = f32(1)
    ambig = False
    for insert in range(alen + blen - mo0_eff, min_insert0 - 1, -1):
        good_c, bad_c, olen = oracle_counts(a, b, insert)
        good, bad = fsum(g_incr, good_c), fsum(b_incr, bad_c)
        badlimit = f32(
            f32(1.2) * f32(f32(f32(min(best_ratio, maxr)) * f32(margin)) * olen)
            + f32(1.0)
        )
        if bad <= badlimit:
            if bad_c == 0 and good > mo0_eff and good < mo_eff:
                return -1, best_bad_int, False
            ratio = f32(f32(bad + f32(offset)) / olen)
            if ratio < f32(best_ratio * f32(margin)):
                ambig = bool(f32(ratio * f32(margin)) >= best_ratio or good < mo_eff)
                if ratio < best_ratio:
                    second_ratio = best_ratio
                    best_insert = insert
                    best_bad_int = bad_c
                    best_ratio = ratio
                elif ratio < second_ratio:
                    second_ratio = ratio
                if (ambig and best_ratio < margin2) or second_ratio < f32(min_second):
                    return -1, best_bad_int, False
    if second_ratio < f32(min_second):
        ambig = True
    if not ambig and best_ratio > maxr:
        best_insert = -1
    return (
        -1 if best_insert < 0 else best_insert,
        best_bad_int,
        ambig and best_insert > -1,
    )


def make_pair(insert, alen, blen, err=0.0):
    """Synthesize a pair from a random molecule of `insert` bases."""
    mol = rng.integers(0, 4, max(insert, alen, blen)).astype(np.uint8)
    r1 = mol[:alen].copy()
    r2_fwd = mol[max(0, insert - blen) : insert].copy()
    # pad r2_fwd to blen if insert < blen
    if len(r2_fwd) < blen:
        r2_fwd = np.concatenate(
            [rng.integers(0, 4, blen - len(r2_fwd)).astype(np.uint8), r2_fwd]
        )
    # r2 as sequenced: reverse complement of the molecule's right end
    r2 = (3 - r2_fwd[::-1]).astype(np.uint8)
    for r in (r1, r2):
        e = rng.random(len(r)) < err
        r[e] = (r[e] + rng.integers(1, 4, e.sum())) % 4
    return r1, r2


def test_overlap_counts_vs_oracle():
    B = 16
    alen = blen = 60
    a = np.zeros((B, alen), np.uint8)
    b_rc = np.zeros((B, blen), np.uint8)
    inserts_true = rng.integers(40, 110, B)
    for i in range(B):
        r1, r2 = make_pair(int(inserts_true[i]), alen, blen, err=0.02)
        a[i] = r1
        b_rc[i] = (3 - r2[::-1]).astype(np.uint8)  # rc back to fwd orientation
    alens = np.full(B, alen, np.int64)
    blens = np.full(B, blen, np.int64)
    min_insert0 = 10
    D = alen + blen - min_insert0 + 1
    good, bad, olen = (
        np.asarray(x)
        for x in overlap_counts_jnp(
            jnp.asarray(a), jnp.asarray(b_rc), jnp.asarray(alens),
            jnp.asarray(blens), min_insert0, D,
        )
    )
    for i in range(B):
        for d in range(0, D, 7):
            insert = min_insert0 + d
            g, bd, ol = oracle_counts(a[i], b_rc[i], insert)
            assert (good[i, d], bad[i, d], olen[i, d]) == (g, bd, ol), (
                f"read {i} insert {insert}"
            )


def test_ratio_mode_vs_oracle():
    B = 48
    alen = blen = 70
    a = np.zeros((B, alen), np.uint8)
    b_rc = np.zeros((B, blen), np.uint8)
    for i in range(B):
        true_insert = int(rng.integers(50, 130))
        r1, r2 = make_pair(true_insert, alen, blen, err=0.01 * (i % 3))
        a[i] = r1
        b_rc[i] = (3 - r2[::-1]).astype(np.uint8)
    alens = np.full(B, alen, np.int64)
    blens = np.full(B, blen, np.int64)
    p = dict(mo0=5, mo=8, min_insert0=12, min_insert=15, max_ratio=0.09,
             min_second=0.1, margin=5.5, offset=0.55)
    D = alen + blen - p["min_insert0"] + 1
    good, bad, olen = (
        np.asarray(x)
        for x in overlap_counts_jnp(
            jnp.asarray(a), jnp.asarray(b_rc), jnp.asarray(alens),
            jnp.asarray(blens), p["min_insert0"], D,
        )
    )
    ins_v, bad_v, amb_v = mate_by_overlap_ratio_np(
        good, bad, olen, alens, blens, p["min_insert0"],
        p["mo0"], p["mo"], p["min_insert0"], p["min_insert"],
        p["max_ratio"], p["min_second"], p["margin"], p["offset"],
    )
    for i in range(B):
        oi, ob, oa = oracle_ratio_mode(
            a[i], b_rc[i], p["mo0"], p["mo"], p["min_insert0"],
            p["min_insert"], p["max_ratio"], p["min_second"], p["margin"],
            p["offset"],
        )
        assert ins_v[i] == oi, f"read {i}: {ins_v[i]} vs {oi}"
        assert amb_v[i] == oa, f"read {i} ambig"


def test_incr_table_matches_java_sum():
    t = incr_table(0.95, 100)
    s = f32(0)
    for c in range(100):
        assert t[c] == s
        s = f32(s + f32(0.95))


def test_join_reads():
    # overlapping join with one disagreement
    a = np.array([[0, 1, 2, 3, 0, 1]], np.uint8)
    aq = np.array([[30, 30, 30, 30, 20, 10]], np.uint8)
    b_rc = np.array([[2, 3, 1, 1, 3, 0]], np.uint8)
    bq = np.array([[5, 25, 30, 30, 30, 30]], np.uint8)
    # insert=8, alen=blen=6 -> overlap=4: positions 2..5 overlap b[0..3]
    bases, quals, lengths = join_reads_np(
        a, aq, np.array([6]), b_rc, bq, np.array([6]), np.array([8]), 8
    )
    assert lengths[0] == 8
    # pos2: agree (2), q=min(max(30,5)+min(30,5)//4, 50)=31
    assert bases[0, 2] == 2 and quals[0, 2] == 31
    # pos3: agree (3), q=min(30+25//4, 50)=36
    assert bases[0, 3] == 3 and quals[0, 3] == 36
    # pos4: a=0 q20 vs b=1 q30 -> b wins, q=10
    assert bases[0, 4] == 1 and quals[0, 4] == 10
    # pos5: agree (1), q=min(30+10//4, 50)=32
    assert bases[0, 5] == 1 and quals[0, 5] == 32
    # tail from b
    assert bases[0, 6] == 3 and bases[0, 7] == 0


def test_entropy_min_overlap():
    B = 4
    L = 50
    codes = np.zeros((B, L), np.uint8)
    codes[0] = rng.integers(0, 4, L)  # high entropy -> small result
    codes[1] = 0  # homopolymer -> low entropy -> large/never
    lengths = np.full(B, L, np.int64)
    res = calc_min_overlap_by_entropy_np(codes, lengths, 3, 39, from_tail=True)
    assert res[0] < L
    assert res[1] == L + 1 or res[1] > res[0]
    # oracle check for read 0 (tail scan)
    counts = np.zeros(64, np.int64)
    kmer = ln = ones = twos = 0
    want = L + 1
    for i in range(L):
        b = codes[0, L - 1 - i]
        ln += 1
        kmer = ((kmer << 2) | int(b)) & 63
        if ln >= 3:
            counts[kmer] += 1
            if counts[kmer] == 1:
                ones += 1
            elif counts[kmer] == 2:
                twos += 1
            if ones * 4 + twos >= 39:
                want = i
                break
    assert res[0] == want


def test_bbmerge_end_to_end(tmp_path):
    n = 400
    alen = blen = 90
    recs1, recs2 = [], []
    true_inserts = []
    for i in range(n):
        insert = int(rng.integers(100, 170))
        r1, r2 = make_pair(insert, alen, blen, err=0.002)
        true_inserts.append(insert)
        s1 = bytes(b"ACGT"[x] for x in r1)
        s2 = bytes(b"ACGT"[x] for x in r2)
        q = b"F" * alen
        recs1.append((b"r%d" % i, s1, q))
        recs2.append((b"r%d" % i, s2, q))
    for path, recs in ((tmp_path / "r1.fq", recs1), (tmp_path / "r2.fq", recs2)):
        with open(path, "wb") as fh:
            for nm, s, q in recs:
                fh.write(b"@" + nm + b"\n" + s + b"\n+\n" + q + b"\n")
    from bbtools_tpu.models.bbmerge import main

    tool = main(
        [
            f"in={tmp_path}/r1.fq",
            f"in2={tmp_path}/r2.fq",
            f"out={tmp_path}/merged.fq",
            f"outu={tmp_path}/u1.fq",
            f"ihist={tmp_path}/ihist.txt",
        ]
    )
    assert tool.pairs == n
    # most overlapping pairs should merge with the correct insert
    assert tool.merged > n * 0.8
    merged = (tmp_path / "merged.fq").read_bytes().splitlines()
    names = {merged[i * 4][1:]: len(merged[i * 4 + 1]) for i in range(len(merged) // 4)}
    correct = sum(
        1
        for i, ti in enumerate(true_inserts)
        if names.get(b"r%d" % i) == ti
    )
    assert correct > tool.merged * 0.97
    ihist = (tmp_path / "ihist.txt").read_text()
    assert "#InsertSize\tCount" in ihist


def test_extend2_merges_long_inserts(tmp_path):
    import numpy as np

    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.models.bbmerge import BBMerge, parse_args as bm_parse
    from bbtools_tpu.utils.synth import random_genome

    # inserts of 260 with 100bp reads: 60bp gap -> only extension can merge
    rng = np.random.default_rng(61)
    from bbtools_tpu.io.fasta import load_reference, write_fasta

    write_fasta(str(tmp_path / "g.fa"), random_genome(30_000, 1, seed=61))
    g = load_reference(str(tmp_path / "g.fa")).scaffold_codes(0)
    f1, f2 = open(tmp_path / "r1.fq", "wb"), open(tmp_path / "r2.fq", "wb")
    INSERT, RL = 260, 100
    for i in range(1200):
        s0 = int(rng.integers(0, len(g) - INSERT - 10))
        frag = g[s0 : s0 + INSERT]
        r1 = frag[:RL]
        r2 = np.where(frag[-RL:] < 4, 3 - frag[-RL:], 4)[::-1]
        f1.write(b"@p%d\n" % i + CODE_TO_BASE[r1].tobytes() + b"\n+\n" + b"F" * RL + b"\n")
        f2.write(b"@p%d\n" % i + CODE_TO_BASE[r2].tobytes() + b"\n+\n" + b"F" * RL + b"\n")
    f1.close()
    f2.close()
    out = tmp_path / "m.fq"
    cfg = bm_parse(
        [
            f"in={tmp_path/'r1.fq'}",
            f"in2={tmp_path/'r2.fq'}",
            f"out={out}",
            "extend2=60",
        ]
    )
    tool = BBMerge(cfg).run()
    assert tool.merged_by_extension >= 600, tool.merged_by_extension
    # merged reads reconstruct true inserts
    lines = out.read_bytes().splitlines()
    n_exact = 0
    for j in range(0, len(lines), 4):
        seq = lines[j + 1]
        if len(seq) == INSERT:
            n_exact += 1
    assert n_exact >= 0.9 * (len(lines) // 4), (n_exact, len(lines) // 4)


def test_bbmerge_interleaved_input(tmp_path):
    """Interleaved single-file input merges identically to two-file input."""
    import random

    from bbtools_tpu.models.bbmerge import BBMerge, parse_args

    random.seed(5)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    f1, f2, fi = tmp_path / "r1.fq", tmp_path / "r2.fq", tmp_path / "int.fq"
    with open(f1, "w") as a, open(f2, "w") as b, open(fi, "w") as c:
        for i in range(40):
            frag = "".join(random.choice("ACGT") for _ in range(150))
            r1 = frag[:100]
            r2 = "".join(comp[x] for x in reversed(frag[-100:]))
            a.write(f"@p{i} 1:N:0\n{r1}\n+\n{'F'*100}\n")
            b.write(f"@p{i} 2:N:0\n{r2}\n+\n{'F'*100}\n")
            c.write(f"@p{i} 1:N:0\n{r1}\n+\n{'F'*100}\n")
            c.write(f"@p{i} 2:N:0\n{r2}\n+\n{'F'*100}\n")
    out_a = tmp_path / "m_a.fq"
    out_b = tmp_path / "m_b.fq"
    BBMerge(parse_args([f"in1={f1}", f"in2={f2}", f"out={out_a}"])).run()
    BBMerge(parse_args([f"in={fi}", f"out={out_b}"])).run()
    da = open(out_a, "rb").read()
    db = open(out_b, "rb").read()
    assert da == db
    assert da.count(b"\n@") + 1 >= 35  # most pairs merged


def test_overlap_counts_vs_original_semantics():
    """The static-slice insert scan must equal the direct per-insert
    gather formulation (the original definition) bit-for-bit."""
    import numpy as np

    rng2 = np.random.default_rng(123)
    B, L = 64, 37
    a = rng2.integers(0, 5, (B, L)).astype(np.uint8)
    b = rng2.integers(0, 5, (B, L)).astype(np.uint8)
    alens = rng2.integers(15, L + 1, B).astype(np.int32)
    blens = rng2.integers(15, L + 1, B).astype(np.int32)
    min0, D = 5, 2 * L - 8
    got = [np.asarray(x) for x in overlap_counts_jnp(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(alens),
        jnp.asarray(blens), min0, D)]
    i_idx = np.arange(L)[None, :]
    for d in range(D):
        insert = min0 + d
        shift = insert - blens
        j = i_idx - shift[:, None]
        valid = (
            (i_idx < alens[:, None]) & (j >= 0) & (j < blens[:, None])
            & ((i_idx - np.maximum(0, shift)[:, None]) < insert)
        )
        bj = np.take_along_axis(b.astype(np.int32), np.clip(j, 0, L - 1), 1)
        match = valid & (a == bj)
        np.testing.assert_array_equal(got[0][:, d], (match & (a < 4)).sum(1))
        np.testing.assert_array_equal(got[1][:, d], (valid & (a != bj)).sum(1))
        np.testing.assert_array_equal(got[2][:, d], valid.sum(1))


@pytest.mark.parametrize("use_quality", [True, False])
def test_device_merge_equals_host_merge(tmp_path, use_quality):
    """The device graph that the GPU runs (insert scan, mate selection,
    entropy, efilter) writes the same merged reads and histogram as the
    host path, with and without quality-weighted scoring."""
    from bbtools_tpu.core import backend
    from bbtools_tpu.models.bbmerge import main as bbmerge_main

    rng2 = np.random.default_rng(5)
    genome = rng2.integers(0, 4, 4000)
    comp = np.array([3, 2, 1, 0])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(tmp_path / "r1.fq", "wb") as f1, open(tmp_path / "r2.fq", "wb") as f2:
        for i in range(300):
            p = int(rng2.integers(0, 3600))
            ins = genome[p : p + int(rng2.integers(120, 280))]
            r1 = acgt[ins[:151]].tobytes()
            r2 = acgt[comp[ins[::-1]][:151]].tobytes()
            q1 = bytes(rng2.integers(40, 74, len(r1)).astype(np.uint8))
            q2 = bytes(rng2.integers(40, 74, len(r2)).astype(np.uint8))
            f1.write(b"@p%d /1\n" % i + r1 + b"\n+\n" + q1 + b"\n")
            f2.write(b"@p%d /2\n" % i + r2 + b"\n+\n" + q2 + b"\n")
    outs = []
    for device in (False, True):
        d = tmp_path / str(device)
        d.mkdir()
        with backend.override(device_merge=device):
            bbmerge_main([
                f"in1={tmp_path / 'r1.fq'}", f"in2={tmp_path / 'r2.fq'}",
                f"out={d / 'm.fq'}", f"outu={d / 'u.fq'}",
                f"ihist={d / 'ihist.txt'}", f"usequality={use_quality}",
                "efilter=6", "ow=t",
            ])
        outs.append([(d / n).read_bytes() for n in ("m.fq", "u.fq", "ihist.txt")])
    assert outs[0][0]  # some pairs merged
    assert outs[0] == outs[1]


def test_right_justify_jnp_matches_np():
    import numpy as np

    from bbtools_tpu.ops.overlap import right_justify_jnp, right_justify_np

    rng = np.random.default_rng(31)
    B, L = 257, 151
    b = rng.integers(0, 5, (B, L)).astype(np.uint8)
    lens = rng.integers(1, L + 1, B).astype(np.int32)
    lens[0] = L
    import jax.numpy as jnp

    want = right_justify_np(b, lens, L)
    got = np.asarray(right_justify_jnp(jnp.asarray(b), jnp.asarray(lens), L))
    np.testing.assert_array_equal(got, want)


def test_mate_by_overlap_ratio_jnp_matches_np():
    """Device scan (mate_by_overlap_ratio_jnp) == host oracle, bitwise,
    incl. collect stats."""
    import numpy as np

    from bbtools_tpu.ops.overlap import (
        mate_by_overlap_ratio_jnp,
        mate_by_overlap_ratio_np,
    )

    rng = np.random.default_rng(17)
    B, D = 300, 170
    alens = rng.integers(60, 152, B)
    blens = rng.integers(60, 152, B)
    olen = np.minimum(
        np.minimum(alens[:, None], blens[:, None]),
        np.abs(np.arange(D)[None, :] - 90) + 5,
    ).astype(np.int64)
    good = (olen * rng.random((B, D)) * 0.98).astype(np.int64)
    bad = np.maximum(olen - good - rng.integers(0, 3, (B, D)), 0)
    # plant clean overlaps for a third of the reads
    sel = rng.integers(0, D, B // 3)
    rows = np.arange(B // 3)
    good[rows, sel] = olen[rows, sel]
    bad[rows, sel] = 0
    mo0 = rng.integers(3, 9, B)
    mo = rng.integers(10, 30, B)
    args = dict(
        min_insert0_col=26, min_overlap0=mo0, min_overlap=mo,
        min_insert0=26, min_insert=35, max_ratio=0.09,
        min_second_ratio=0.1, margin=5.5, offset=0.5,
    )
    for em, col in ((1.2, False), (4.0, True)):
        want = mate_by_overlap_ratio_np(
            good, bad, olen, alens, blens, extra_mult=em, collect=col,
            **args,
        )
        import jax.numpy as jnp

        got = mate_by_overlap_ratio_jnp(
            jnp.asarray(good.astype(np.int32)),
            jnp.asarray(bad.astype(np.int32)),
            jnp.asarray(olen.astype(np.int32)),
            jnp.asarray(alens), jnp.asarray(blens),
            extra_mult=em, collect=col, **args,
        )
        np.testing.assert_array_equal(np.asarray(got[0]), want[0])
        np.testing.assert_array_equal(np.asarray(got[1]), want[1])
        np.testing.assert_array_equal(np.asarray(got[2]), want[2])
        if col:
            for k in want[3]:
                np.testing.assert_array_equal(
                    np.asarray(got[3][k]), want[3][k], err_msg=k
                )


def test_efilter_pfilter_jnp_match_np():
    import numpy as np

    from bbtools_tpu.ops.overlap import (
        expected_mismatches_jnp,
        expected_mismatches_np,
        probability_jnp,
        probability_np,
    )

    rng = np.random.default_rng(23)
    B, L = 300, 151
    a = rng.integers(0, 5, (B, L)).astype(np.uint8)
    b = rng.integers(0, 5, (B, L)).astype(np.uint8)
    aq = rng.integers(0, 42, (B, L)).astype(np.uint8)
    bq = rng.integers(0, 42, (B, L)).astype(np.uint8)
    alens = rng.integers(60, L + 1, B)
    blens = rng.integers(60, L + 1, B)
    overlap = rng.integers(20, 280, B)
    import jax.numpy as jnp

    want = expected_mismatches_np(a, b, aq, bq, alens, blens, overlap)
    got = np.asarray(expected_mismatches_jnp(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(aq), jnp.asarray(bq),
        jnp.asarray(alens), jnp.asarray(blens), jnp.asarray(overlap),
    ))
    np.testing.assert_array_equal(got, want)

    want = probability_np(a, b, aq, bq, alens, blens, overlap)
    got = np.asarray(probability_jnp(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(aq), jnp.asarray(bq),
        jnp.asarray(alens), jnp.asarray(blens), jnp.asarray(overlap),
    ))
    # XLA flushes f32 subnormals to zero, so rows whose running product
    # underflowed diverge in value — but both land many orders below any
    # usable pfilter threshold, so no decision can differ
    diff = got != want
    assert (want[diff] < 1e-30).all() and (got[diff] < 1e-30).all()


def test_entropy_min_overlap_jnp_matches_np():
    import numpy as np

    from bbtools_tpu.ops.overlap import (
        calc_min_overlap_by_entropy_jnp,
        calc_min_overlap_by_entropy_np,
    )

    rng = np.random.default_rng(29)
    B, L = 200, 151
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.03] = 4
    codes[:40, 20:] = codes[:40, 19:20]  # low-entropy tails
    lens = rng.integers(10, L + 1, B).astype(np.int32)
    import jax.numpy as jnp

    for tail in (True, False):
        want = calc_min_overlap_by_entropy_np(codes, lens, 3, 39, tail)
        got = np.asarray(calc_min_overlap_by_entropy_jnp(
            jnp.asarray(codes), jnp.asarray(lens), 3, 39, tail
        ))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Quality-weighted overlap mode (mateByOverlapRatioJava_WithQualities)
# ---------------------------------------------------------------------------

from bbtools_tpu.ops.overlap import (  # noqa: E402
    PROB_CORRECT3,
    overlap_counts_quality_np,
)


def oracle_quality_counts(a, b, aq, bq, insert):
    """Transliteration of the quality inner loop
    (BBMergeOverlapper.java:229-242): x=aprob[i]*bprob[j]; match->good+=x,
    mismatch->bad+=x, badInt++; all float32, i ascending."""
    alen, blen = len(a), len(b)
    istart = 0 if insert <= blen else insert - blen
    jstart = 0 if insert >= blen else blen - insert
    olen = min(alen - istart, blen - jstart, insert)
    good = f32(0.0)
    bad = f32(0.0)
    bad_int = 0
    for t in range(olen):
        i, j = istart + t, jstart + t
        x = f32(PROB_CORRECT3[min(int(aq[i]), 69)]
                * PROB_CORRECT3[min(int(bq[j]), 69)])
        if a[i] == b[j]:
            good = f32(good + x)
        else:
            bad = f32(bad + x)
            bad_int += 1
    return good, bad, bad_int, olen


def oracle_quality_ratio_mode(a, b, aq, bq, mo0, mo, min_insert0,
                              min_insert, max_ratio, min_second, margin,
                              offset):
    """Per-read transliteration of findBestRatio_WithQualities (:642-693)
    + mateByOverlapRatioJava_WithQualities (:158-397)."""
    alen, blen = len(a), len(b)
    min_len = min(alen, blen)
    mo_eff = max(4, mo0, mo)
    mo0_eff = sorted((4, mo0, mo_eff))[1]
    # prescan
    best = f32(f32(max_ratio) + f32(0.0001))
    halfmax = f32(f32(max_ratio) * f32(0.5))
    x = None
    for insert in range(alen + blen - mo_eff, min_insert - 1, -1):
        good, bad, bad_c, olen = oracle_quality_counts(a, b, aq, bq, insert)
        badlimit = f32(best * olen)
        if bad <= badlimit:
            if bad == f32(0.0) and good > mo0_eff and good < mo_eff:
                x = f32(100.0)
                break
            ratio = f32(f32(bad + f32(offset)) / olen)
            if ratio < best:
                best = ratio
                if good >= mo_eff and ratio < halfmax:
                    x = best
                    break
    if x is None:
        x = best
    if x > f32(max_ratio):
        return -1, min_len, False
    maxr = min(f32(max_ratio), x)
    margin2 = f32(f32(f32(margin) + f32(offset)) / min_len)
    best_insert, best_bad_int = -1, -1
    best_ratio = f32(1)
    second_ratio = f32(1)
    ambig = False
    for insert in range(alen + blen - mo0_eff, min_insert0 - 1, -1):
        good, bad, bad_c, olen = oracle_quality_counts(a, b, aq, bq, insert)
        badlimit = f32(
            f32(1.2) * f32(f32(f32(min(best_ratio, maxr)) * f32(margin)) * olen)
            + f32(1.0)
        )
        if bad <= badlimit:
            if bad == f32(0.0) and good > mo0_eff and good < mo_eff:
                return -1, best_bad_int, False
            ratio = f32(f32(bad + f32(offset)) / olen)
            if ratio < f32(best_ratio * f32(margin)):
                ambig = bool(
                    f32(ratio * f32(margin)) >= best_ratio or good < mo_eff
                )
                if ratio < best_ratio:
                    second_ratio = best_ratio
                    best_insert = insert
                    best_bad_int = bad_c
                    best_ratio = ratio
                elif ratio < second_ratio:
                    second_ratio = ratio
                if (ambig and best_ratio < margin2) or second_ratio < f32(
                    min_second
                ):
                    return -1, best_bad_int, False
    if second_ratio < f32(min_second):
        ambig = True
    if not ambig and best_ratio > maxr:
        best_insert = -1
    return (
        -1 if best_insert < 0 else best_insert,
        best_bad_int,
        ambig and best_insert > -1,
    )


def _quality_pair_batch(B, alen, blen):
    a = np.zeros((B, alen), np.uint8)
    b_rc = np.zeros((B, blen), np.uint8)
    for i in range(B):
        true_insert = int(rng.integers(50, 130))
        r1, r2 = make_pair(true_insert, alen, blen, err=0.01 * (i % 4))
        a[i] = r1
        b_rc[i] = (3 - r2[::-1]).astype(np.uint8)
    # quality-varied: mix of high, low, and zero quals
    aq = rng.integers(0, 42, (B, alen)).astype(np.uint8)
    bq = rng.integers(0, 42, (B, blen)).astype(np.uint8)
    aq[:4] = 2  # near-zero-information rows
    return a, b_rc, aq, bq


def test_quality_counts_vs_oracle():
    B, alen, blen = 12, 60, 60
    a, b_rc, aq, bq = _quality_pair_batch(B, alen, blen)
    alens = np.full(B, alen, np.int64)
    blens = np.full(B, blen, np.int64)
    min_insert0 = 10
    D = alen + blen - min_insert0 + 1
    good, bad, bad_int, olen = overlap_counts_quality_np(
        a, b_rc, aq, bq, alens, blens, min_insert0, D
    )
    for i in range(B):
        for d in range(0, D, 5):
            insert = min_insert0 + d
            g, bd, bi, ol = oracle_quality_counts(
                a[i], b_rc[i], aq[i], bq[i], insert
            )
            assert good[i, d] == g, (i, insert)  # bit-exact f32
            assert bad[i, d] == bd, (i, insert)
            assert bad_int[i, d] == bi and olen[i, d] == ol


def test_quality_ratio_mode_vs_oracle():
    B, alen, blen = 48, 70, 70
    a, b_rc, aq, bq = _quality_pair_batch(B, alen, blen)
    alens = np.full(B, alen, np.int64)
    blens = np.full(B, blen, np.int64)
    p = dict(mo0=5, mo=8, min_insert0=12, min_insert=15, max_ratio=0.09,
             min_second=0.1, margin=5.5, offset=0.55)
    D = alen + blen - p["min_insert0"] + 1
    good_c, bad_c, olen = (
        np.asarray(x)
        for x in overlap_counts_jnp(
            jnp.asarray(a), jnp.asarray(b_rc), jnp.asarray(alens),
            jnp.asarray(blens), p["min_insert0"], D,
        )
    )
    good_f, bad_f, _bi, _ol = overlap_counts_quality_np(
        a, b_rc, aq, bq, alens, blens, p["min_insert0"], D
    )
    ins_v, bad_v, amb_v = mate_by_overlap_ratio_np(
        good_c, bad_c, olen, alens, blens, p["min_insert0"],
        p["mo0"], p["mo"], p["min_insert0"], p["min_insert"],
        p["max_ratio"], p["min_second"], p["margin"], p["offset"],
        good_f=good_f, bad_f=bad_f,
    )
    n_diff = 0
    ins_nq, _, _ = mate_by_overlap_ratio_np(
        good_c, bad_c, olen, alens, blens, p["min_insert0"],
        p["mo0"], p["mo"], p["min_insert0"], p["min_insert"],
        p["max_ratio"], p["min_second"], p["margin"], p["offset"],
    )
    for i in range(B):
        oi, ob, oa = oracle_quality_ratio_mode(
            a[i], b_rc[i], aq[i], bq[i], p["mo0"], p["mo"],
            p["min_insert0"], p["min_insert"], p["max_ratio"],
            p["min_second"], p["margin"], p["offset"],
        )
        assert ins_v[i] == oi, f"read {i}: {ins_v[i]} vs {oi}"
        assert amb_v[i] == oa, f"read {i} ambig"
        if ins_v[i] != ins_nq[i]:
            n_diff += 1
    # quality weighting must actually change decisions on this data
    assert n_diff > 0


def test_quality_mate_jnp_matches_np():
    from bbtools_tpu.ops.overlap import (
        mate_by_overlap_ratio_jnp,
        overlap_counts_quality_jnp,
    )

    B, alen, blen = 32, 64, 64
    a, b_rc, aq, bq = _quality_pair_batch(B, alen, blen)
    alens = np.full(B, alen, np.int64)
    blens = np.full(B, blen, np.int64)
    p = dict(mo0=5, mo=8, min_insert0=12, min_insert=15, max_ratio=0.09,
             min_second=0.1, margin=5.5, offset=0.55)
    D = alen + blen - p["min_insert0"] + 1
    good_c, bad_c, olen = (
        np.asarray(x)
        for x in overlap_counts_jnp(
            jnp.asarray(a), jnp.asarray(b_rc), jnp.asarray(alens),
            jnp.asarray(blens), p["min_insert0"], D,
        )
    )
    gf_np, bf_np, bi_np, ol_np = overlap_counts_quality_np(
        a, b_rc, aq, bq, alens, blens, p["min_insert0"], D
    )
    gf_j, bf_j, bi_j, ol_j = (
        np.asarray(x)
        for x in overlap_counts_quality_jnp(
            a, b_rc, aq, bq, alens, blens, p["min_insert0"], D
        )
    )
    assert (gf_np == gf_j).all() and (bf_np == bf_j).all()
    assert (bi_np == bi_j).all() and (ol_np == ol_j).all()
    args = (
        alens, blens, p["min_insert0"], p["mo0"], p["mo"],
        p["min_insert0"], p["min_insert"], p["max_ratio"],
        p["min_second"], p["margin"], p["offset"],
    )
    ins_np, bad_np_, amb_np = mate_by_overlap_ratio_np(
        good_c, bad_c, olen, *args, good_f=gf_np, bad_f=bf_np
    )
    ins_j, bad_j, amb_j = (
        np.asarray(x)
        for x in mate_by_overlap_ratio_jnp(
            jnp.asarray(good_c), jnp.asarray(bad_c), jnp.asarray(olen),
            *args, good_f=jnp.asarray(gf_np), bad_f=jnp.asarray(bf_np),
        )
    )
    assert (ins_np == ins_j).all()
    assert (bad_np_ == bad_j).all()
    assert (amb_np == amb_j).all()


def test_bbmerge_quality_mode_end_to_end(tmp_path):
    """usequality=t (default) vs ignorequality: same files, different
    merge decisions on quality-varied data; ihist reflects it."""
    from bbtools_tpu.models.bbmerge import BBMerge, parse_args

    B = 300
    alen = blen = 70
    CODE = "ACGT"
    r1p = tmp_path / "r1.fq"
    r2p = tmp_path / "r2.fq"
    rng2 = np.random.default_rng(5)
    with open(r1p, "w") as f1, open(r2p, "w") as f2:
        for i in range(B):
            insert = int(rng2.integers(60, 120))
            mol = rng2.integers(0, 4, max(insert, alen, blen))
            r1 = mol[:alen].copy()
            r2f = mol[max(0, insert - blen):insert]
            if len(r2f) < blen:
                r2f = np.concatenate(
                    [rng2.integers(0, 4, blen - len(r2f)), r2f]
                )
            r2 = (3 - r2f[::-1])
            q1 = rng2.integers(2, 41, alen)
            q2 = rng2.integers(2, 41, blen)
            # sprinkle errors at LOW-q positions: quality weighting should
            # forgive them, the unweighted mode counts them fully
            for r, q in ((r1, q1), (r2, q2)):
                low = np.flatnonzero(q <= 8)[:6]
                r[low] = (r[low] + 1) % 4
            s1 = "".join(CODE[c] for c in r1)
            s2 = "".join(CODE[c] for c in r2)
            f1.write(f"@p{i} /1\n{s1}\n+\n"
                     + "".join(chr(33 + int(q)) for q in q1) + "\n")
            f2.write(f"@p{i} /2\n{s2}\n+\n"
                     + "".join(chr(33 + int(q)) for q in q2) + "\n")

    outq = tmp_path / "mq.fq"
    outn = tmp_path / "mn.fq"
    BBMerge(parse_args([f"in={r1p}", f"in2={r2p}", f"out={outq}"])).run()
    BBMerge(parse_args(
        [f"in={r1p}", f"in2={r2p}", f"out={outn}", "ignorequality=t"]
    )).run()
    nq = sum(1 for line in open(outq) if line.startswith("@"))
    nn_ = sum(1 for line in open(outn) if line.startswith("@"))
    # quality mode merges MORE pairs here (low-q errors forgiven)
    assert nq > nn_, (nq, nn_)
