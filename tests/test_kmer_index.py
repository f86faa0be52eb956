"""BucketKmerIndex, the one k-mer lookup table bbduk and seal use, against
brute force: host and device lookups, packed and unpacked layouts, over
random keys and over real panel expansions (hdist, short k-mers, middle
masks) queried with scan-shaped keys."""

import jax.numpy as jnp
import numpy as np
import pytest

from bbtools_tpu.ops.kmer_index import BucketKmerIndex, build_ref_keys
from bbtools_tpu.ops.kmers import length_mask, middle_mask, rc_kmer_np


def _mk_keys(rng, n, hi_bits=False, big_ids=False):
    # realistic kmer keys: 2k payload bits plus a length-tag bit well above
    # them (see ops/kmers.length_mask); hi_bits and big_ids force the
    # unpacked layout
    top = 62 if hi_bits else 44
    keys = rng.integers(0, 1 << top, size=4 * n, dtype=np.int64) | (
        np.int64(1) << top
    )
    keys = np.unique(keys)[:n]
    lo = 1 << 17 if big_ids else 1
    ids = rng.integers(lo, lo + 1000, size=len(keys), dtype=np.int32)
    return keys, ids


def _oracle(keys, ids, queries):
    """Exact sorted-table lookup: id or 0."""
    order = np.argsort(keys)
    sk, si = keys[order], ids[order]
    pos = np.clip(np.searchsorted(sk, queries), 0, len(sk) - 1)
    return np.where(sk[pos] == queries, si[pos], 0).astype(np.int32)


def _device_lookup(idx, q):
    kt, it = idx.device_arrays()
    if idx.packed:
        return np.asarray(BucketKmerIndex.lookup_packed_jnp(kt, idx.nb, q))
    return np.asarray(BucketKmerIndex.lookup_jnp(kt, it, idx.nb, q))


@pytest.mark.parametrize("hi_bits,big_ids", [(False, False), (True, True)])
def test_bucket_index_brute_force(hi_bits, big_ids):
    rng = np.random.default_rng(7)
    keys, ids = _mk_keys(rng, 3000, hi_bits, big_ids)
    idx = BucketKmerIndex.build(keys, ids, pack=True)
    assert idx.packed == (not hi_bits and not big_ids)
    # queries: half present, half absent
    absent = rng.integers(0, 1 << 62, size=3000, dtype=np.int64)
    q = np.concatenate([keys[::2], absent])
    rng.shuffle(q)
    want = _oracle(keys, ids, q)
    np.testing.assert_array_equal(idx.lookup_np(q), want)
    np.testing.assert_array_equal(_device_lookup(idx, q), want)
    # a 2-D query shape comes back in the same shape
    q2 = q.reshape(2, -1)
    np.testing.assert_array_equal(_device_lookup(idx, q2), want.reshape(2, -1))


def test_bucket_index_zero_query_is_miss():
    rng = np.random.default_rng(3)
    keys, ids = _mk_keys(rng, 100)
    for pack in (False, True):
        idx = BucketKmerIndex.build(keys, ids, pack=pack)
        q = np.zeros(8, dtype=np.int64)
        np.testing.assert_array_equal(idx.lookup_np(q), np.zeros(8, np.int32))
        np.testing.assert_array_equal(_device_lookup(idx, q),
                                      np.zeros(8, np.int32))


def _scan_queries(rng, k, mink, mid_mask, ref_kmers, n_random=400):
    """Query keys shaped exactly like the scan's: canonical, masked
    (full-k only), length-tagged. Includes exact ref keys, planted
    hdist-1/2 mutants, rc forms, and random keys, for every class."""
    qs = []

    def emit(vals, ln):
        vals = np.asarray(vals, np.int64) & np.int64((1 << (2 * ln)) - 1)
        mx = np.maximum(vals, rc_kmer_np(vals, ln))
        msk = np.int64(mid_mask) if ln == k else np.int64(-1)
        qs.append((mx & msk) | np.int64(length_mask(ln)))

    for ln in [k] + (list(range(mink, k)) if mink else []):
        base = ref_kmers & np.int64((1 << (2 * ln)) - 1)
        emit(base, ln)
        emit(rc_kmer_np(base, ln), ln)
        for _ in range(2):  # planted mutants at distance 1, then 2
            pos = rng.integers(0, ln, len(base))
            delta = rng.integers(1, 4, len(base)).astype(np.int64)
            base = base ^ (delta << (2 * pos))
            emit(base, ln)
        emit(rng.integers(0, 1 << (2 * ln), n_random, dtype=np.int64), ln)
    return np.concatenate(qs)


def _panel(rng, kind):
    r = lambda n: rng.integers(0, 4, n).astype(np.uint8)  # noqa: E731
    if kind == "overlapping":  # first insertion wins across scaffolds
        s0 = r(40)
        return [s0, np.concatenate([s0[5:25], r(30)])]
    if kind == "rc_duplicate":
        s0 = r(40)
        return [s0, (3 - s0)[::-1].copy()]
    return [r(60) for _ in range(3)]


@pytest.mark.parametrize(
    "kind,k,mink,hdist,hdist2,masked,ids",
    [
        ("random", 13, 0, 0, None, False, None),
        ("random", 13, 0, 1, None, False, None),
        ("random", 11, 0, 2, None, False, None),
        ("random", 13, 8, 1, 0, False, None),
        ("random", 11, 7, 1, 1, False, None),
        ("random", 13, 0, 0, None, True, None),
        ("random", 13, 0, 1, None, True, None),
        ("overlapping", 13, 0, 1, None, False, None),
        ("rc_duplicate", 13, 0, 0, None, False, None),
        ("random", 13, 0, 1, None, False, [7, 300, 65535]),
    ],
    ids=["exact", "hdist1", "hdist2", "shorts_hdist1", "shorts_hdist2_both",
         "masked_exact", "masked_hdist1", "first_insertion_wins",
         "rc_duplicate", "custom_ids"],
)
def test_bucket_index_serves_panel(kind, k, mink, hdist, hdist2, masked,
                                   ids):
    """Every expansion bbduk builds is served exactly by the bucket index
    in both layouts, for scan-shaped queries."""
    rng = np.random.default_rng(k * 100 + hdist * 10 + mink)
    scafs = _panel(rng, kind)
    mm = middle_mask(k, 2) if masked else -1
    keys, kids = build_ref_keys(scafs, k, mink=mink, hdist=hdist,
                                hdist2=hdist2, mid_mask=mm, ids=ids)
    ref_kmers = np.array(
        [int("".join(str(int(c)) for c in s[i : i + k]), 4)
         for s in scafs for i in range(len(s) - k + 1)], np.int64,
    )
    q = _scan_queries(rng, k, mink, mm, ref_kmers)
    want = _oracle(keys, kids, q)
    assert (want > 0).any() and (want == 0).any()
    for pack in (False, True):
        idx = BucketKmerIndex.build(keys, kids, pack=pack)
        np.testing.assert_array_equal(idx.lookup_np(q), want)
        np.testing.assert_array_equal(_device_lookup(idx, jnp.asarray(q)),
                                      want)


@pytest.mark.parametrize("ref", ["one_adapter", "adapters", "truseq",
                                 "nextera", "phix"])
def test_bbduk_serves_every_panel_from_bucket_index(tmp_path, ref):
    """bbduk indexes every panel, from one sequence to the bundled adapter
    sets and phiX, with the bucket index in the packed layout (k=23 keys
    fit 47 bits)."""
    from bbtools_tpu.models.bbduk import BBDuk, parse_args

    if ref == "one_adapter":
        p = tmp_path / "one.fa"
        p.write_bytes(b">a\nAGATCGGAAGAGCACACGTCTGAACTCCAGTCA\n")
        ref = str(p)
    duk = BBDuk(parse_args([f"ref={ref}", "k=23", "mink=11", "hdist=1",
                            "ktrim=r", "in=x.fq"]))
    assert isinstance(duk.index, BucketKmerIndex) and duk.index.packed
    assert duk.scan_cfg.packed and duk.scan_cfg.nb == duk.index.nb


@pytest.mark.parametrize("k,mink,hdist", [(23, 0, 0), (23, 11, 1),
                                         (13, 8, 1), (11, 0, 2)])
def test_kscan_packed_equals_unpacked(k, mink, hdist):
    """bbduk's fused scan decides the same with the packed one-gather
    layout as with the two-gather layout (full and both short ends)."""
    from bbtools_tpu.ops.bbduk_scan import KScanConfig, kscan_combined

    rng = np.random.default_rng(k + mink + hdist)
    scafs = [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(3)]
    keys, kids = build_ref_keys(scafs, k, mink=mink, hdist=hdist)
    bases = rng.integers(0, 4, (24, 100)).astype(np.uint8)
    for i in range(0, 24, 3):  # plant a panel piece, some with a sub
        s = scafs[i % 3][: 30].copy()
        s[i % 30] = (s[i % 30] + (i % 2)) % 4
        bases[i, 60:90] = s
    if mink:  # a panel prefix at the read's right end: a short k-mer hit
        bases[1, -mink - 2 :] = scafs[1][: mink + 2]
    lengths = np.full(24, 100, np.int32)
    outs = []
    for pack in (False, True):
        idx = BucketKmerIndex.build(keys, kids, pack=pack)
        assert idx.packed == pack
        cfg = KScanConfig(k=k, mink=mink, nb=idx.nb, packed=idx.packed)
        out, sl, sr = kscan_combined(
            cfg, idx.device_arrays(), jnp.asarray(bases),
            jnp.asarray(lengths), bool(mink), bool(mink),
        )
        outs.append((
            {n: np.asarray(v) for n, v in out.items()},
            None if sl is None else [np.asarray(x) for x in sl],
            None if sr is None else [np.asarray(x) for x in sr],
        ))
    (o0, l0, r0), (o1, l1, r1) = outs
    assert o0.keys() == o1.keys()
    for n in o0:
        np.testing.assert_array_equal(o0[n], o1[n], err_msg=n)
    assert o0["nhits"].sum() > 0
    for a, b in ((l0, l1), (r0, r1)):
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_bucket_packed_layout_matches_unpacked():
    rng = np.random.default_rng(42)
    keys = np.unique(
        rng.integers(0, 1 << 46, 8000, dtype=np.int64) | (np.int64(1) << 46)
    )[:5000]
    ids = rng.integers(1, 1 << 15, len(keys), dtype=np.int32)
    up = BucketKmerIndex.build(keys, ids)
    pk = BucketKmerIndex.build(keys, ids, pack=True)
    assert pk.packed and not up.packed
    q = np.concatenate(
        [keys[::2], rng.integers(0, 1 << 47, 4000, dtype=np.int64)]
    )
    rng.shuffle(q)
    want = up.lookup_np(q)
    np.testing.assert_array_equal(pk.lookup_np(q), want)
    pt, _ = pk.device_arrays()
    got = np.asarray(
        BucketKmerIndex.lookup_packed_jnp(pt, pk.nb, jnp.asarray(q))
    )
    np.testing.assert_array_equal(got, want)
