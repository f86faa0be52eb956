import numpy as np
import pytest

from bbtools_tpu.ops.kmer_count import (
    KmerSpectrum,
    count_batch,
    count_batch_np,
)

rng = np.random.default_rng(5)


def random_reads(n, L, n_prob=0.02):
    c = rng.integers(0, 4, (n, L)).astype(np.uint8)
    c[rng.random((n, L)) < n_prob] = 4
    return c


def test_count_batch_matches_oracle():
    k = 31
    bases = random_reads(32, 100)
    lengths = rng.integers(10, 101, 32).astype(np.int32)
    v, c = count_batch(bases, lengths, k)
    vn, cn = count_batch_np(bases, lengths, k)
    np.testing.assert_array_equal(v, vn)
    np.testing.assert_array_equal(c, cn)


@pytest.mark.parametrize("k", [5, 17, 31])
@pytest.mark.parametrize("n_prob", [0.0, 0.05])
def test_count_batch_across_k_and_n_rate(k, n_prob):
    """kmercountexact's k<=31 counting path (device extraction, host
    np.unique) equals the host oracle for short and full-width k, with
    and without undefined bases breaking the windows."""
    g = np.random.default_rng(k * 7 + int(n_prob * 100))
    bases = g.integers(0, 4, (48, 120)).astype(np.uint8)
    bases[g.random(bases.shape) < n_prob] = 4
    bases[::5] = bases[0]  # repeats: counts above 1
    lengths = g.integers(k - 1, 121, 48).astype(np.int32)
    v, c = count_batch(bases, lengths, k)
    vn, cn = count_batch_np(bases, lengths, k)
    np.testing.assert_array_equal(v, vn)
    np.testing.assert_array_equal(c, cn)


@pytest.mark.parametrize("hist_max", [1, 3, 100])
def test_spectrum_histogram_clamps_to_last_bin(hist_max):
    """KmerSpectrum.histogram: bin c counts distinct k-mers seen c times,
    counts past hist_max land in the last bin, bin 0 stays empty."""
    spec = KmerSpectrum(11)
    spec.add_batch(np.array([3, 5, 9], np.int64), np.array([1, 4, 2], np.int64))
    spec.add_batch(np.array([5, 7], np.int64), np.array([3, 1], np.int64))
    counts = {3: 1, 5: 7, 7: 1, 9: 2}
    want = np.zeros(hist_max + 1, np.int64)
    for c in counts.values():
        want[min(c, hist_max)] += 1
    want[0] = 0
    np.testing.assert_array_equal(spec.histogram(hist_max), want)


@pytest.mark.parametrize("n_reads", [0, 1, 64])
def test_sort_reduce_matches_unique(n_reads):
    """sort_reduce (the sharded spectrum's per-batch reduce) equals
    np.unique on the same keys, PAD rows excluded, including an all-PAD
    batch."""
    import jax.numpy as jnp

    from bbtools_tpu.ops.kmer_count import PAD, batch_kmers_jnp, sort_reduce

    g = np.random.default_rng(n_reads)
    bases = g.integers(0, 4, (max(n_reads, 1), 90)).astype(np.uint8)
    lengths = np.full(len(bases), 90 if n_reads else 0, np.int32)
    keys = batch_kmers_jnp(jnp.asarray(bases), jnp.asarray(lengths), 21)
    values, counts, n = sort_reduce(keys)
    n = int(n)
    hk = np.asarray(keys)
    wv, wc = np.unique(hk[hk != PAD], return_counts=True)
    assert n == len(wv)
    np.testing.assert_array_equal(np.asarray(values[:n]), wv)
    np.testing.assert_array_equal(np.asarray(counts[:n]), wc)
    assert (np.asarray(values[n:]) == PAD).all()
    assert (np.asarray(counts[n:]) == 0).all()


def test_spectrum_merge():
    k = 15
    spec = KmerSpectrum(k)
    all_v = []
    all_c = []
    for _ in range(5):
        bases = random_reads(16, 60)
        lengths = np.full(16, 60, np.int32)
        v, c = count_batch_np(bases, lengths, k)
        spec.add_batch(v, c)
        all_v.append(v)
        all_c.append(c)
    spec.flush()
    # oracle: merge dicts
    want: dict[int, int] = {}
    for v, c in zip(all_v, all_c):
        for kk, cc in zip(v, c):
            want[int(kk)] = want.get(int(kk), 0) + int(cc)
    assert spec.n_unique == len(want)
    got = dict(zip(spec.keys.tolist(), spec.counts.tolist()))
    assert got == want
    h = spec.histogram(100)
    assert h.sum() == len(want)
    assert int(h[1]) == sum(1 for x in want.values() if x == 1)


def test_kmercountexact_files(tmp_path):
    fin = tmp_path / "in.fq"
    seq = b"ACGTACGTTGCAGGTCAACGTTACGT"
    with open(fin, "wb") as fh:
        for i in range(10):  # same read 10x -> every kmer count=10
            fh.write(b"@r%d\n" % i + seq + b"\n+\n" + b"I" * len(seq) + b"\n")
    khist = tmp_path / "khist.txt"
    dump = tmp_path / "dump.fa"
    from bbtools_tpu.models.kmercountexact import main

    spec = main(
        [
            f"in={fin}",
            "k=15",
            f"khist={khist}",
            f"dump={dump}",
            "printzeros=f",
        ]
    )
    n_kmers = len(seq) - 15 + 1
    assert spec.n_unique == n_kmers
    lines = khist.read_bytes().splitlines()
    assert lines[0] == b"#Depth\tCount"
    assert lines[1] == b"10\t%d" % n_kmers
    dump_lines = dump.read_bytes().splitlines()
    assert len(dump_lines) == 2 * n_kmers
    assert dump_lines[0] == b">10"
    assert len(dump_lines[1]) == 15


def test_bigk_exact_spectrum():
    import numpy as np

    from bbtools_tpu.ops.kmers2 import (
        BigSpectrum,
        count_batch2_exact,
        rolling_kmers2_np,
        canonical_pair,
    )

    rng = np.random.default_rng(7)
    k = 45
    # one read repeated 3x plus a distinct read: repeat kmers count 3
    r1 = rng.integers(0, 4, 120).astype(np.uint8)
    r2 = rng.integers(0, 4, 120).astype(np.uint8)
    bases = np.stack([r1, r1, r1, r2])
    lens = np.full(4, 120, np.int64)
    hi, lo, c = count_batch2_exact(bases, lens, k)
    n_per_read = 120 - k + 1
    assert c.sum() == 4 * n_per_read
    assert sorted(set(c.tolist())) == [1, 3]
    assert (c == 3).sum() == n_per_read  # r1 kmers (assuming no overlap)

    spec = BigSpectrum(k)
    # two batches merge exactly
    spec.add_batch(*count_batch2_exact(bases[:2], lens[:2], k))
    spec.add_batch(*count_batch2_exact(bases[2:], lens[2:], k))
    spec.flush()
    assert spec.counts.sum() == 4 * n_per_read
    assert sorted(set(spec.counts.tolist())) == [1, 3]

    # exact lookup round trip
    got = spec.count_of(hi, lo)
    np.testing.assert_array_equal(got, c)
    # absent kmer -> 0
    assert spec.count_of(np.array([123456]), np.array([654321]))[0] == 0


def test_bigk_dump_text(tmp_path):
    import numpy as np

    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.models.kmercountexact import main as kce_main

    rng = np.random.default_rng(8)
    seq = CODE_TO_BASE[rng.integers(0, 4, 80)].tobytes()
    fin = tmp_path / "in.fq"
    fin.write_bytes(b"@r\n" + seq + b"\n+\n" + b"F" * 80 + b"\n")
    dump = tmp_path / "kmers.fa"
    kce_main([f"in={fin}", f"out={dump}", "k=40"])
    lines = dump.read_bytes().splitlines()
    assert len(lines) == 2 * (80 - 40 + 1)
    # each dumped kmer is 40bp and occurs in the read or its rc
    from bbtools_tpu.core.dna import reverse_complement

    rc = reverse_complement(seq)
    for j in range(1, len(lines), 2):
        km = lines[j]
        assert len(km) == 40
        assert km in seq or km in rc


def test_wordspectrum_k93_vs_bruteforce():
    import numpy as np

    from bbtools_tpu.ops.kmers2 import WordSpectrum, count_batchw_exact

    rng = np.random.default_rng(9)
    k = 93
    r1 = rng.integers(0, 4, 200).astype(np.uint8)
    r2 = rng.integers(0, 4, 200).astype(np.uint8)
    bases = np.stack([r1, r1, r2])
    lens = np.full(3, 200, np.int64)
    keys, c = count_batchw_exact(bases, lens, k)
    n_per = 200 - k + 1
    assert c.sum() == 3 * n_per
    assert (c == 2).sum() == n_per  # r1 kmers

    spec = WordSpectrum(k)
    spec.add_batch(*count_batchw_exact(bases[:1], lens[:1], k))
    spec.add_batch(*count_batchw_exact(bases[1:], lens[1:], k))
    spec.flush()
    np.testing.assert_array_equal(spec.count_of(keys), c)

    # brute-force cross-check of counts via python strings
    from collections import Counter

    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    cnt = Counter()
    for row in bases:
        s = list(map(int, row))
        for p in range(len(s) - k + 1):
            f = tuple(s[p : p + k])
            r = tuple(comp[x] for x in reversed(f))
            cnt[max(f, r)] += 1
    assert sorted(cnt.values()) == sorted(c.tolist())


def test_kce_dump_k93_roundtrip(tmp_path):
    import numpy as np

    from bbtools_tpu.core.dna import CODE_TO_BASE
    from bbtools_tpu.models.kmercountexact import main as kce_main

    rng = np.random.default_rng(10)
    codes = rng.integers(0, 4, 160)
    seq = CODE_TO_BASE[codes].tobytes()
    fin = tmp_path / "in.fq"
    fin.write_bytes(b"@r\n" + seq + b"\n+\n" + b"F" * 160 + b"\n")
    dump = tmp_path / "kmers.fa"
    k = 93
    kce_main([f"in={fin}", f"out={dump}", f"k={k}"])
    lines = dump.read_bytes().splitlines()
    assert len(lines) == 2 * (160 - k + 1)
    # every dumped kmer must be a substring of the read or its rc
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rc = seq.translate(comp)[::-1]
    for l in lines[1::2]:
        assert len(l) == k
        assert l in seq or l in rc


def test_native_radix_count_matches_numpy():
    import numpy as np

    from bbtools_tpu.native import radix_count_native, radix_count_w_native

    rng = np.random.default_rng(17)
    keys = rng.integers(0, 1 << 62, 200_000, dtype=np.int64)
    keys[::3] = keys[1::3][: len(keys[::3])][: len(keys[::3])]  # dupes
    res = radix_count_native(keys.copy())
    if res is None:
        import pytest

        pytest.skip("no native toolchain")
    vals, counts = res
    wv, wc = np.unique(keys.astype(np.uint64), return_counts=True)
    np.testing.assert_array_equal(vals, wv)
    np.testing.assert_array_equal(counts, wc)

    rows = rng.integers(0, 1 << 60, (50_000, 3), dtype=np.int64)
    rows[::2] = rows[1::2][: len(rows[::2])]
    res = radix_count_w_native(rows.copy())
    vals, counts = res
    order = np.lexsort(
        tuple(rows[:, w].astype(np.uint64) for w in range(2, -1, -1))
    )
    rs = rows[order].astype(np.uint64)
    new = np.concatenate([[True], (rs[1:] != rs[:-1]).any(axis=1)])
    starts = np.flatnonzero(new)
    wc = np.diff(np.append(starts, len(rs)))
    np.testing.assert_array_equal(vals, rs[starts])
    np.testing.assert_array_equal(counts, wc)
