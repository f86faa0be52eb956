"""BBMerge overlap detection — batched counts on device, exact decision on host.

Faithful re-implementation of jgi/BBMergeOverlapper.java:
  mateByOverlapRatioJava (:368-505, the default non-quality ratio mode,
  gIncr=bIncr=0.95) + findBestRatio (:560-612 prescan), expectedMismatches
  (:1139-1176), probability (:1186-1230), calcMinOverlapByEntropy
  Head/Tail (:1303-1400), and the probCorrect4 lookup table (:1484) —
  tables copied verbatim per SURVEY.md Appendix A.3.

Key structural insight: the per-insert inner loops' early exits never
change observable results (bad only grows; rejects are reject either way),
so per-insert (good, bad) counts are computed batched on device in one
scan over inserts, and the sequential best/second/ambig state machine runs
on the host, vectorized across reads, with float32 ops in reference order.
Float parity note: with constant increments (0.95), the float32 sum is a
function of the count alone, reproduced via a cumulative-increment table.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MAX_READ = 1024

#: BBMergeOverlapper.probCorrect4 (:1484), copied verbatim
PROB_CORRECT4 = np.array(
    [0.0000, 0.2501, 0.3690, 0.4988, 0.6019, 0.6838, 0.7488, 0.8005, 0.8415,
     0.8741, 0.9000, 0.9206, 0.9369, 0.9499, 0.9602, 0.9684, 0.9749, 0.9800,
     0.9842, 0.9874, 0.9900, 0.9921, 0.9937, 0.9950, 0.9960, 0.9968, 0.9975,
     0.9980, 0.9984, 0.9987, 0.9990, 0.9992, 0.9994, 0.9995, 0.9996, 0.9997,
     0.9997, 0.9998, 0.9998, 0.9999] + [0.9999] * 20,
    dtype=np.float32,
)


#: BBMergeOverlapper.probCorrect3 (the quality-mode table, used by
#: mateByOverlapRatioJava_WithQualities :173-174), copied verbatim
PROB_CORRECT3 = np.array(
    [0.000, 0.251, 0.369, 0.499, 0.602, 0.684, 0.749, 0.800, 0.842, 0.874,
     0.900, 0.921, 0.937, 0.950, 0.960, 0.968, 0.975, 0.980, 0.984, 0.987,
     0.990, 0.992, 0.994, 0.995, 0.996, 0.997, 0.997, 0.998, 0.998, 0.999,
     0.999, 0.999, 0.999, 0.999] + [1.0] * 36,
    dtype=np.float32,
)


def _incr_table(incr: float, n: int) -> np.ndarray:
    """t[c] = float32 result of adding `incr` c times sequentially."""
    t = np.zeros(n + 1, dtype=np.float32)
    for i in range(1, n + 1):
        t[i] = np.float32(t[i - 1] + np.float32(incr))
    return t


_INCR_CACHE: dict[tuple[float, int], np.ndarray] = {}


def incr_table(incr: float, n: int = MAX_READ) -> np.ndarray:
    key = (incr, n)
    if key not in _INCR_CACHE:
        _INCR_CACHE[key] = _incr_table(incr, n)
    return _INCR_CACHE[key]


@partial(jax.jit, static_argnames=("n_inserts", "min_insert0"))
def overlap_counts_jnp(a, b_rc, alens, blens, min_insert0: int, n_inserts: int):
    """Per-insert overlap stats for a batch of pairs.

    a, b_rc: uint8 codes [B, L] (b already reverse-complemented).
    Returns (good [B,D], bad [B,D], olen [B,D]) int32 where column d is
    insert = min_insert0 + d. good counts matching non-N positions, bad
    counts mismatches (N vs base mismatches, N vs N matches-but-uncounted),
    olen is the overlapLength.

    Device-shaped: b_rc is RIGHT-JUSTIFIED once (the only gather), after
    which mate position j for insert `ins` sits at column i + L - ins for
    EVERY read — so the insert scan is pure static-window slices and
    masked reductions, no per-step gathers. (The reference's
    per-pair pointer walk, BBMergeOverlapper.mateByOverlapRatio, has no
    such shared-shift structure; this layout is what makes the insert
    loop vectorize.)
    """
    B, L = a.shape
    ai = a.astype(jnp.int32)
    i_idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    # right-justify: b_rj[:, L-1-t] = b_rc[:, blen-1-t]
    src = i_idx - (L - blens[:, None])
    b_rj = jnp.take_along_axis(
        b_rc.astype(jnp.int32), jnp.clip(src, 0, L - 1), axis=1
    )
    max_ins = min_insert0 + n_inserts - 1
    P = max(max_ins - L, 0) + 1  # left pad: largest insert's slice start
    R = max(L - min_insert0, 0) + 1  # right pad: smallest insert's tail
    b_pad = jnp.pad(b_rj, ((0, 0), (P, R)), constant_values=9)

    def step(_, d):
        ins = min_insert0 + d
        # b_rj column of read position i is i + L - ins (see docstring)
        bseg = jax.lax.dynamic_slice(
            b_pad, (jnp.int32(0), (jnp.int32(P + L) - ins).astype(jnp.int32)),
            (B, L),
        )
        valid = (i_idx < jnp.minimum(alens, ins)[:, None]) & (
            i_idx >= jnp.maximum(ins - blens, 0)[:, None]
        )
        match = valid & (ai == bseg)
        good = (match & (ai < 4)).sum(axis=1, dtype=jnp.int32)
        bad = (valid & (ai != bseg)).sum(axis=1, dtype=jnp.int32)
        olen = valid.sum(axis=1, dtype=jnp.int32)
        return None, (good, bad, olen)

    _, (good, bad, olen) = jax.lax.scan(
        step, None, jnp.arange(n_inserts, dtype=jnp.int32)
    )
    return (
        jnp.moveaxis(good, 0, 1),
        jnp.moveaxis(bad, 0, 1),
        jnp.moveaxis(olen, 0, 1),
    )


def right_justify_np(b_rc: np.ndarray, blens: np.ndarray, L: int) -> np.ndarray:
    """Host-side right-justification: b_rj[:, L-1-t] = b_rc[:, blen-1-t]
    (identical to the device formulation in overlap_counts_jnp). Done on
    the host so the device path never pays a per-element device gather."""
    b_rc = np.asarray(b_rc)
    blens = np.asarray(blens)
    if b_rc.shape[1] == L and (blens == L).all():
        return b_rc  # uniform full-length reads: already justified
    i_idx = np.arange(L, dtype=np.int32)[None, :]
    src = i_idx - (L - blens[:, None]).astype(np.int32)
    return np.take_along_axis(b_rc, np.clip(src, 0, L - 1), axis=1)


def right_justify_jnp(b_rc, blens, L: int):
    """Device right-justification via log-shifts: 8 static shifted
    selects instead of a per-element gather. Bit-equal to
    right_justify_np (leading columns replicate column 0, matching its
    clipped-source semantics)."""
    import jax.numpy as jnp

    s = (jnp.int32(L) - blens.astype(jnp.int32))[:, None]  # [B, 1]
    x = b_rc
    j = 0
    while (1 << j) <= L:
        sh = 1 << j
        shifted = jnp.pad(x[:, :-sh], ((0, 0), (sh, 0)))
        x = jnp.where(((s >> j) & 1) == 1, shifted, x)
        j += 1
    i_idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    return jnp.where(i_idx < s, b_rc[:, :1], x)


def overlap_counts_quality_np(
    a, b_rc, aq, bq_rev, alens, blens, min_insert0: int, n_inserts: int
):
    """Per-insert quality-weighted overlap sums, host oracle.

    Reference: mateByOverlapRatioJava_WithQualities inner loop
    (jgi/BBMergeOverlapper.java:229-242): x = aprob[i]*bprob[j];
    match -> good += x, mismatch -> bad += x (and badInt++), all in
    float32, i ascending. N==N counts as a (zero-weight) match; N vs
    base is a mismatch whose x carries the actual quals.

    Returns (good f32 [B,D], bad f32 [B,D], bad_int i32 [B,D],
    olen i32 [B,D]). Bit-exact f32: the i-ascending accumulation order
    is preserved by looping over i and adding a masked (0.0) term per
    step — adding +0.0f is an exact identity, so skipped positions
    change nothing.
    """
    f32 = np.float32
    a = np.asarray(a)
    b_rc = np.asarray(b_rc)
    alens = np.asarray(alens).astype(np.int64)
    blens = np.asarray(blens).astype(np.int64)
    B, L = a.shape
    aprob = PROB_CORRECT3[np.clip(np.asarray(aq), 0, 69)]
    bprob = PROB_CORRECT3[np.clip(np.asarray(bq_rev), 0, 69)]
    b_rj = right_justify_np(b_rc, blens, L)
    bprob_rj = right_justify_np(bprob, blens, L)
    max_ins = min_insert0 + n_inserts - 1
    P = max(max_ins - L, 0) + 1
    R = max(L - min_insert0, 0) + 1
    b_pad = np.pad(b_rj, ((0, 0), (P, R)), constant_values=9)
    p_pad = np.pad(bprob_rj, ((0, 0), (P, R)))
    ins = (min_insert0 + np.arange(n_inserts, dtype=np.int64))[None, :]
    good = np.zeros((B, n_inserts), np.float32)
    bad = np.zeros((B, n_inserts), np.float32)
    bad_int = np.zeros((B, n_inserts), np.int32)
    olen = np.zeros((B, n_inserts), np.int32)
    rows = np.arange(B)[:, None]
    for i in range(L):
        # mate column for insert `ins` at read position i (see
        # overlap_counts_jnp docstring): b_pad[P + L - ins + i]
        cols = P + L - ins + i
        cb = b_pad[rows, cols]  # [B, D]
        pb = p_pad[rows, cols]
        valid = (i < np.minimum(alens[:, None], ins)) & (
            i >= np.maximum(ins - blens[:, None], 0)
        )
        ca = a[:, i : i + 1]
        x = np.where(valid, aprob[:, i : i + 1] * pb, f32(0.0)).astype(
            np.float32
        )
        eq = ca == cb
        good = (good + np.where(eq, x, f32(0.0))).astype(np.float32)
        bad = (bad + np.where(eq, f32(0.0), x)).astype(np.float32)
        bad_int += (valid & ~eq).astype(np.int32)
        olen += valid.astype(np.int32)
    return good, bad, bad_int, olen


def overlap_counts_quality_jnp(
    a, b_rc, aq, bq_rev, alens, blens, min_insert0: int, n_inserts: int
):
    """Device mirror of overlap_counts_quality_np: lax.scan over read
    positions with [B, D] f32 carries keeps the reference's i-ascending
    float32 accumulation order; _mul_f32_once blocks FMA contraction of
    the aprob*bprob product into the running sum."""
    return _overlap_counts_quality(
        jnp.asarray(np.asarray(a)), jnp.asarray(np.asarray(b_rc)),
        jnp.asarray(np.asarray(aq)), jnp.asarray(np.asarray(bq_rev)),
        jnp.asarray(np.asarray(alens)), jnp.asarray(np.asarray(blens)),
        min_insert0, n_inserts,
    )


@partial(jax.jit, static_argnames=("m0", "ni"))
def _overlap_counts_quality(a, b_rc, aq, bq_rev, alens, blens, m0, ni):
    f32 = jnp.float32
    B, L = a.shape
    if True:
        pc3 = jnp.asarray(PROB_CORRECT3)
        aprob = pc3[jnp.clip(aq.astype(jnp.int32), 0, 69)]
        bprob = pc3[jnp.clip(bq_rev.astype(jnp.int32), 0, 69)]
        b_rj = right_justify_jnp(b_rc, blens, L)
        bprob_rj = right_justify_jnp(bprob, blens, L)
        max_ins = m0 + ni - 1
        P = max(max_ins - L, 0) + 1
        R = max(L - m0, 0) + 1
        b_pad = jnp.pad(b_rj, ((0, 0), (P, R)), constant_values=9)
        p_pad = jnp.pad(bprob_rj, ((0, 0), (P, R)))
        ins = (m0 + jnp.arange(ni, dtype=jnp.int32))[None, :]
        alens32 = alens.astype(jnp.int32)[:, None]
        blens32 = blens.astype(jnp.int32)[:, None]
        lo = jnp.maximum(ins - blens32, 0)
        hi = jnp.minimum(alens32, ins)

        def step(carry, i):
            good, bad, bad_int, olen = carry
            # columns P+L-ins+i for all inserts = one reversed slice
            seg = jax.lax.dynamic_slice(
                b_pad, (jnp.int32(0), (jnp.int32(P + L) - max_ins + i)),
                (B, ni),
            )[:, ::-1]
            pseg = jax.lax.dynamic_slice(
                p_pad, (jnp.int32(0), (jnp.int32(P + L) - max_ins + i)),
                (B, ni),
            )[:, ::-1]
            valid = (i < hi) & (i >= lo)
            pa = jax.lax.dynamic_slice(aprob, (jnp.int32(0), i), (B, 1))
            ca = jax.lax.dynamic_slice(a, (jnp.int32(0), i), (B, 1))
            x = jnp.where(valid, _mul_f32_once(pa, pseg), f32(0.0))
            eq = ca.astype(jnp.int32) == seg.astype(jnp.int32)
            good = good + jnp.where(eq, x, f32(0.0))
            bad = bad + jnp.where(eq, f32(0.0), x)
            bad_int = bad_int + (valid & ~eq).astype(jnp.int32)
            olen = olen + valid.astype(jnp.int32)
            return (good, bad, bad_int, olen), None

        init = (
            jnp.zeros((B, ni), f32), jnp.zeros((B, ni), f32),
            jnp.zeros((B, ni), jnp.int32), jnp.zeros((B, ni), jnp.int32),
        )
        (good, bad, bad_int, olen), _ = jax.lax.scan(
            step, init, jnp.arange(L, dtype=jnp.int32)
        )
        return good, bad, bad_int, olen


def find_best_ratio_np(
    good_c, bad_c, olen, alens, blens, min_insert0: int,
    min_overlap0, min_overlap, min_insert: int, max_ratio: float,
    offset: float, g_incr: float = 0.95, b_incr: float = 0.95,
    good_f=None, bad_f=None,
):
    """findBestRatio (non-quality) vectorized over reads.

    good_c/bad_c/olen: [B, D] int counts (column d -> insert min_insert0+d).
    min_overlap0/min_overlap may be per-read arrays. Returns float32 [B].

    With good_f/bad_f given ([B, D] float32 quality-weighted sums from
    overlap_counts_quality_np), this is findBestRatio_WithQualities
    (jgi/BBMergeOverlapper.java:642-693): g/b come from the planes and
    the bad==0 test is on the float32 sum (a mismatch pair with q=0
    weight keeps bad at exactly 0.0f, as in the reference).
    """
    f32 = np.float32
    B, D = good_c.shape
    gt = incr_table(g_incr)
    bt = incr_table(b_incr)
    best = np.full(B, f32(f32(max_ratio) + f32(0.0001)), dtype=np.float32)
    halfmax = f32(f32(max_ratio) * f32(0.5))
    returned = np.zeros(B, dtype=bool)
    result = np.zeros(B, dtype=np.float32)
    mo0 = np.broadcast_to(np.asarray(min_overlap0), (B,))
    mo = np.broadcast_to(np.asarray(min_overlap), (B,))
    largest = alens + blens - mo  # per-read loop start
    for insert in range(int(largest.max(initial=0)), min_insert - 1, -1):
        d = insert - min_insert0
        if d < 0 or d >= D:
            continue
        inrange = (insert <= largest) & ~returned
        if not inrange.any():
            continue
        if good_f is not None:
            g = good_f[:, d]
            b = bad_f[:, d]
            bad_zero = bad_f[:, d] == np.float32(0.0)
        else:
            g = gt[good_c[:, d]]
            b = bt[bad_c[:, d]]
            bad_zero = bad_c[:, d] == 0
        ol = olen[:, d].astype(np.float32)
        badlimit = best * ol  # f32*f32, extraBadlimit=0
        ok = inrange & (b <= badlimit)
        # bad==0 && good in (minOverlap0, minOverlap) -> return 100
        ret100 = ok & bad_zero & (g > mo0) & (g < mo)
        result[ret100] = f32(100.0)
        returned |= ret100
        ok &= ~ret100
        ratio = np.where(ol > 0, (b + f32(offset)) / np.maximum(ol, 1), f32(1))
        ratio = ratio.astype(np.float32)
        improve = ok & (ratio < best)
        best = np.where(improve, ratio, best)
        early = improve & (g >= mo) & (ratio < halfmax)
        result[early] = best[early]
        returned |= early
    result[~returned] = best[~returned]
    return result


def mate_by_overlap_ratio_np(
    good_c, bad_c, olen, alens, blens, min_insert0_col: int,
    min_overlap0, min_overlap, min_insert0: int, min_insert: int,
    max_ratio: float, min_second_ratio: float, margin: float,
    offset: float, g_incr: float = 0.95, b_incr: float = 0.95,
    extra_mult: float = 1.2, collect: bool = False,
    good_f=None, bad_f=None,
):
    """mateByOverlapRatioJava (:368-505) vectorized over reads.

    With good_f/bad_f given, this is mateByOverlapRatioJava_WithQualities
    (:158-397): g/b are the float32 prob-weighted sums, bad_c holds the
    integer mismatch count (badInt), and the zero-bad early return tests
    the float sum. Everything else (badlimit, margins, best/second state
    machine, early returns) is shared between the two reference methods
    line for line.

    Returns (best_insert [B] i32 with -1 for no solution, best_bad_int [B],
    ambig [B] bool). min_overlap0/min_overlap may be per-read arrays.

    `extra_mult` is the badlimit multiplier (1.2 normally; 4.0 in the
    reference's MAKE_VECTOR mode, BBMergeOverlapper.java:456). With
    `collect=True` a 4th return value carries the best/second-best
    candidate stats dict the BBMerge NN gate feeds from
    (BBMergeOverlapper.java:552-575 vector block).
    """
    f32 = np.float32
    B, D = good_c.shape
    mo0 = np.broadcast_to(np.asarray(min_overlap0), (B,)).astype(np.int64)
    mo = np.broadcast_to(np.asarray(min_overlap), (B,)).astype(np.int64)
    # minOverlap=max(4, minOverlap0, minOverlap); minOverlap0=mid(4, ...)
    mo_eff = np.maximum(4, np.maximum(mo0, mo))
    mo0_eff = np.sort(np.stack([np.full(B, 4), mo0, mo_eff]), axis=0)[1]
    min_len = np.minimum(alens, blens)
    # prescan
    x = find_best_ratio_np(
        good_c, bad_c, olen, alens, blens, min_insert0_col,
        mo0_eff, mo_eff, min_insert, max_ratio, offset, g_incr, b_incr,
        good_f=good_f, bad_f=bad_f,
    )
    no_sol = x > f32(max_ratio)
    maxr = np.minimum(f32(max_ratio), x).astype(np.float32)

    gt = incr_table(g_incr)
    bt = incr_table(b_incr)
    margin2 = ((f32(margin) + f32(offset)) / min_len.astype(np.float32)).astype(
        np.float32
    )
    best_insert = np.full(B, -1, np.int64)
    best_bad_int = np.full(B, -1, np.int64)
    best_ratio = np.ones(B, np.float32)
    second_ratio = np.ones(B, np.float32)
    ambig = np.zeros(B, dtype=bool)
    returned = no_sol.copy()  # early-outs freeze state
    ret_ambig = np.zeros(B, dtype=bool)
    extra_mult = f32(extra_mult)
    # collector state (Java inits, BBMergeOverlapper.java:441-453)
    best_overlap = np.full(B, -1, np.int64)
    best_bad_f = min_len.astype(np.float32)
    second_insert = np.zeros(B, np.int64)
    second_overlap = np.zeros(B, np.int64)
    second_bad_f = np.zeros(B, np.float32)
    second_bad_int = np.full(B, -1, np.int64)
    largest = alens + blens - mo0_eff
    for insert in range(int(largest.max(initial=0)), min_insert0 - 1, -1):
        d = insert - min_insert0_col
        if d < 0 or d >= D:
            continue
        inrange = (insert <= largest) & ~returned
        if not inrange.any():
            continue
        if good_f is not None:
            g = good_f[:, d]
            b = bad_f[:, d]
            bad_zero = bad_f[:, d] == f32(0.0)
        else:
            g = gt[good_c[:, d]]
            b = bt[bad_c[:, d]]
            bad_zero = bad_c[:, d] == 0
        ol = olen[:, d].astype(np.float32)
        badlimit = (
            extra_mult * (np.minimum(best_ratio, maxr) * f32(margin) * ol)
            + f32(1.0)
        ).astype(np.float32)
        ok = inrange & (b <= badlimit)
        # ambiguous early return: bad==0, minOverlap0 < good < minOverlap
        retA = ok & bad_zero & (g > mo0_eff) & (g < mo_eff)
        ret_ambig |= retA
        returned |= retA
        ok &= ~retA
        ratio = np.where(ol > 0, (b + f32(offset)) / np.maximum(ol, 1), f32(1))
        ratio = ratio.astype(np.float32)
        cand = ok & (ratio < best_ratio * f32(margin))
        new_ambig = (ratio * f32(margin) >= best_ratio) | (g < mo_eff)
        ambig = np.where(cand, new_ambig, ambig)
        improve = cand & (ratio < best_ratio)
        second = cand & ~improve & (ratio < second_ratio)
        # shift best -> second on improve
        second_ratio = np.where(improve, best_ratio, second_ratio)
        second_insert = np.where(improve, best_insert, second_insert)
        second_overlap = np.where(improve, best_overlap, second_overlap)
        second_bad_f = np.where(improve, best_bad_f, second_bad_f)
        second_bad_int = np.where(improve, best_bad_int, second_bad_int)
        best_insert = np.where(improve, insert, best_insert)
        best_bad_int = np.where(improve, bad_c[:, d], best_bad_int)
        best_ratio = np.where(improve, ratio, best_ratio)
        best_overlap = np.where(improve, olen[:, d], best_overlap)
        best_bad_f = np.where(improve, b, best_bad_f)
        second_ratio = np.where(second, ratio, second_ratio)
        second_insert = np.where(second, insert, second_insert)
        second_overlap = np.where(second, olen[:, d], second_overlap)
        second_bad_f = np.where(second, b, second_bad_f)
        second_bad_int = np.where(second, bad_c[:, d], second_bad_int)
        retB = cand & (
            (ambig & (best_ratio < margin2)) | (second_ratio < f32(min_second_ratio))
        )
        ret_ambig |= retB
        returned |= retB
    normal = ~returned
    ambig = np.where(normal, ambig | (second_ratio < f32(min_second_ratio)), ambig)
    # normal end: if !ambig && bestRatio>maxRatio -> no solution (:614)
    best_insert = np.where(
        normal & ~ambig & (best_ratio > maxr), -1, best_insert
    )
    out_insert = np.where(no_sol | ret_ambig, -1, best_insert)
    out_bad = np.where(no_sol, min_len, best_bad_int)
    # caller semantics (BBMerge findOverlap :1528): ambig counts only when
    # an insert was returned; early-ambig returns -1 with the flag set
    out_ambig = np.where(
        no_sol, False, np.where(ret_ambig, False, ambig & (out_insert > -1))
    )
    if collect:
        stats = {
            "best_insert": best_insert, "best_overlap": best_overlap,
            "best_bad": best_bad_f, "best_ratio": best_ratio,
            "best_bad_int": best_bad_int,
            "second_insert": second_insert, "second_overlap": second_overlap,
            "second_bad": second_bad_f, "second_ratio": second_ratio,
            "second_bad_int": second_bad_int,
        }
        return (
            out_insert.astype(np.int64), out_bad.astype(np.int64), out_ambig,
            stats,
        )
    return out_insert.astype(np.int64), out_bad.astype(np.int64), out_ambig


def expected_mismatches_np(a, b_rc, aq, bq, alens, blens, overlap):
    """expectedMismatches (:1139-1176) vectorized; overlap per read [B].

    Sequential float32 sum in i-ascending order (vectorized across reads).
    """
    f32 = np.float32
    B, L = a.shape
    istart = np.where(overlap <= blens, 0, overlap - blens)
    jstart = np.where(overlap <= alens, alens - overlap, 0)
    expected = np.zeros(B, dtype=np.float32)
    pc4 = PROB_CORRECT4
    max_steps = int(min(L, np.max(overlap - istart, initial=0)))
    for t in range(max_steps):
        i = istart + t
        j = jstart + t
        live = (i < overlap) & (i < alens) & (j < blens)
        ii = np.clip(i, 0, L - 1)
        jj = np.clip(j, 0, L - 1)
        rows = np.arange(B)
        ca = a[rows, ii]
        cb = b_rc[rows, jj]
        qa = np.minimum(aq[rows, ii], 59)
        qb = np.minimum(bq[rows, jj], 59)
        both_def = (ca < 4) & (cb < 4)
        prob_c = (pc4[qa] * pc4[qb]).astype(np.float32)
        prob_e = (f32(1) - prob_c).astype(np.float32)
        contrib = np.where(live & both_def, prob_e, f32(0))
        expected = (expected + contrib).astype(np.float32)
    return expected


def probability_np(a, b_rc, aq, bq, alens, blens, insert):
    """probability (:1186-1230): returns probActual/probCommon [B] f32."""
    f32 = np.float32
    B, L = a.shape
    istart = np.where(insert <= blens, 0, insert - blens)
    jstart = np.where(insert >= blens, 0, blens - insert)
    prob_actual = np.ones(B, dtype=np.float32)
    prob_common = np.ones(B, dtype=np.float32)
    pc4 = PROB_CORRECT4
    rows = np.arange(B)
    max_steps = int(min(L, np.max(insert - istart, initial=0)))
    for t in range(max_steps):
        i = istart + t
        j = jstart + t
        live = (i < insert) & (i < alens) & (j < blens)
        ii = np.clip(i, 0, L - 1)
        jj = np.clip(j, 0, L - 1)
        ca = a[rows, ii]
        cb = b_rc[rows, jj]
        qa = np.minimum(aq[rows, ii], 59)
        qb = np.minimum(bq[rows, jj], 59)
        both_def = (ca < 4) & (cb < 4)
        prob_c = (pc4[qa] * pc4[qb]).astype(np.float32)
        prob_m = (prob_c + (f32(1) - prob_c) * f32(0.25)).astype(np.float32)
        prob_e = (f32(1) - prob_m).astype(np.float32)
        upd = live & both_def
        pc = np.where(upd, np.maximum(prob_m, prob_e), f32(1))
        pa = np.where(upd, np.where(ca == cb, prob_m, prob_e), f32(1))
        prob_common = (prob_common * pc).astype(np.float32)
        prob_actual = (prob_actual * pa).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = prob_actual / prob_common
    return np.where(prob_common > 0, r, f32(1)).astype(np.float32)


def calc_min_overlap_by_entropy_np(codes, lengths, k: int, minscore: int,
                                   from_tail: bool):
    """calcMinOverlapByEntropyHead/Tail (:1303-1400) vectorized over reads.

    Scans 3-mers from one end; returns first index i where
    ones*4 + twos >= minscore, else length+1.
    """
    B, L = codes.shape
    space = 1 << (2 * k)
    mask = space - 1
    counts = np.zeros((B, space), dtype=np.int16)
    kmer = np.zeros(B, dtype=np.int64)
    ln = np.zeros(B, dtype=np.int64)
    ones = np.zeros(B, dtype=np.int64)
    twos = np.zeros(B, dtype=np.int64)
    result = lengths.astype(np.int64) + 1
    done = np.zeros(B, dtype=bool)
    rows = np.arange(B)
    for i in range(int(lengths.max(initial=0))):
        pos = (lengths - 1 - i) if from_tail else np.full(B, i)
        live = (i < lengths) & ~done
        pp = np.clip(pos, 0, L - 1)
        b = codes[rows, pp]
        defined = b < 4
        ln = np.where(live & defined, ln + 1, np.where(live, 0, ln))
        kmer = np.where(
            live & defined, ((kmer << 2) | np.where(defined, b, 0)) & mask,
            np.where(live, 0, kmer),
        )
        add = live & defined & (ln >= k)
        old = counts[rows, kmer]
        counts[rows, kmer] = np.where(add, old + 1, old)
        newc = counts[rows, kmer]
        ones = np.where(add & (newc == 1), ones + 1, ones)
        twos = np.where(add & (newc == 2), twos + 1, twos)
        hit = add & (ones * 4 + twos >= minscore)
        result = np.where(hit & ~done, i, result)
        done |= hit
    return result


def expected_tip_errors_np(bases, quals, lengths, max_bases):
    """Read.expectedTipErrors(false, maxBases) vectorized: sum of
    PROB_ERROR[q] over the LAST min(maxBases, len) defined bases
    (stream/Read.java:3004-3025; countUndefined=false)."""
    from ..core.qualtools import PROB_ERROR

    B, L = bases.shape
    if quals is None:
        return np.zeros(B, np.float32)
    lengths = np.asarray(lengths)
    mb = np.broadcast_to(np.asarray(max_bases), (B,))
    limit0 = np.minimum(np.maximum(mb, 1), lengths)
    lo = lengths - limit0  # sum i in [lo, len)
    i_idx = np.arange(L)[None, :]
    live = (i_idx >= lo[:, None]) & (i_idx < lengths[:, None]) & (bases < 4)
    pe = PROB_ERROR[np.minimum(quals, 127)]
    return np.where(live, pe, 0).astype(np.float32).sum(axis=1,
                                                        dtype=np.float32)


def bbmerge_nn_features(alens, blens, min_overlap, r1ee, r2ee, stats,
                        best_expected, probability):
    """The 23-float vector the BBMerge net gate consumes, in reference
    order (jgi/BBMerge.java:2440-2546 + BBMergeOverlapper.java:552-575;
    best/second Good stay at their ratio-mode inits so features 8/14/19
    are constants 0.2/0.2/0.0)."""
    f32 = np.float32
    B = len(alens)
    s = stats
    bo = s["best_overlap"].astype(np.float32)
    so = s["second_overlap"].astype(np.float32)
    bb = s["best_bad"].astype(np.float32)
    sb = s["second_bad"].astype(np.float32)
    bbi = s["best_bad_int"].astype(np.float32)
    sbi = s["second_bad_int"].astype(np.float32)
    feats = np.stack(
        [
            np.broadcast_to(np.asarray(min_overlap), (B,)) * f32(0.1),
            r1ee,
            r2ee,
            (alens - 100) * f32(0.01),
            (blens - 100) * f32(0.01),
            s["best_insert"] * f32(0.004),
            bo / (bo + f32(50)),
            (bb + 1) / (bb + 5),
            np.full(B, f32(0.2)),  # (bestGood+1)/(bestGood+5), good==0
            s["best_ratio"],
            (bbi + 1) / (bbi + 5),
            s["second_insert"] * f32(0.004),
            so / (so + f32(50)),
            (sb + 1) / (sb + 5),
            np.full(B, f32(0.2)),  # (secondBestGood+1)/(+5)
            s["second_ratio"],
            sbi / (sbi + 5),
            (s["second_ratio"] + 1) / (s["best_ratio"] + 1),
            sb / (bb + 8),
            np.zeros(B, np.float32),  # secondBestGood/(bestGood+8)
            bo + 1,  # placeholder, fixed below
            np.asarray(best_expected, np.float32),
            np.asarray(probability, np.float32),
        ],
        axis=1,
    ).astype(np.float32)
    feats[:, 20] = (bo + 1) / (so + bo + 1)
    return feats


# ---------------------------------------------------------------------------
# Device best-insert selection (mateByOverlapRatio as a lax.scan)
# ---------------------------------------------------------------------------


def _f32c(*vals):
    """Host-side f32 constant folding (mirrors the np oracle's rounding)."""
    out = np.float32(vals[0])
    for v in vals[1:]:
        out = np.float32(out + np.float32(v))
    return out


def mate_by_overlap_ratio_jnp(
    good_c, bad_c, olen, alens, blens, min_insert0_col: int,
    min_overlap0, min_overlap, min_insert0: int, min_insert: int,
    max_ratio: float, min_second_ratio: float, margin: float,
    offset: float, g_incr: float = 0.95, b_incr: float = 0.95,
    extra_mult: float = 1.2, collect: bool = False,
    good_f=None, bad_f=None,
):
    """Device mirror of mate_by_overlap_ratio_np: the per-insert host
    loop becomes a lax.scan over the (reversed) insert axis with [B]
    carries, and the bit-exact sequential-f32 increment tables resolve
    through one gather each. Identical results (same f32 op order).

    good_f/bad_f ([B, D] f32 planes from overlap_counts_quality_jnp)
    switch it to mateByOverlapRatioJava_WithQualities, exactly as in the
    np version."""
    import jax

    f32 = jnp.float32
    B0, D = good_c.shape
    # pad B to a multiple of 128 and fold [B] carries into [B/128, 128]
    # tiles
    Bp = ((B0 + 127) // 128) * 128
    pad = Bp - B0

    def padded(x, fill):
        x = jnp.asarray(x)
        return jnp.pad(x, (0, pad), constant_values=fill) if pad else x

    if pad:
        good_c = jnp.pad(good_c, ((0, pad), (0, 0)))
        bad_c = jnp.pad(bad_c, ((0, pad), (0, 0)))
        olen = jnp.pad(olen, ((0, pad), (0, 0)))
        if good_f is not None:
            good_f = jnp.pad(good_f, ((0, pad), (0, 0)))
            bad_f = jnp.pad(bad_f, ((0, pad), (0, 0)))
    alens = padded(alens, 1)
    blens = padded(blens, 1)
    min_overlap0 = (
        padded(min_overlap0, 4)
        if np.ndim(min_overlap0)
        else min_overlap0
    )
    min_overlap = (
        padded(min_overlap, 4) if np.ndim(min_overlap) else min_overlap
    )
    B = Bp
    gt = jnp.asarray(incr_table(g_incr))
    bt = jnp.asarray(incr_table(b_incr))
    mo0 = jnp.broadcast_to(jnp.asarray(min_overlap0), (B,)).astype(jnp.int64)
    mo = jnp.broadcast_to(jnp.asarray(min_overlap), (B,)).astype(jnp.int64)
    mo_eff = jnp.maximum(4, jnp.maximum(mo0, mo))
    mo0_eff = jnp.sort(
        jnp.stack([jnp.full((B,), 4, jnp.int64), mo0, mo_eff]), axis=0
    )[1]
    min_len = jnp.minimum(alens, blens)
    alens = jnp.asarray(alens)
    blens = jnp.asarray(blens)

    # fold reads into [B/128, 128] lane tiles for the scans
    R2 = B // 128

    def r2(x):
        return x.reshape(R2, 128)

    mo0_eff = r2(mo0_eff)
    mo_eff = r2(mo_eff)
    min_len = r2(min_len)
    alens = r2(alens)
    blens = r2(blens)

    # precompute f32 increments + transposed per-step rows (scan xs)
    if good_f is not None:
        g_all = good_f.astype(f32).T.reshape(D, R2, 128)
        b_all = bad_f.astype(f32).T.reshape(D, R2, 128)
        bz_all = (bad_f == f32(0.0)).T.reshape(D, R2, 128)
    else:
        g_all = jnp.take(gt, good_c).T.reshape(D, R2, 128)  # f32
        b_all = jnp.take(bt, bad_c).T.reshape(D, R2, 128)
        bz_all = (bad_c == 0).T.reshape(D, R2, 128)
    ol_all = olen.T.astype(f32).reshape(D, R2, 128)
    bad_all = bad_c.T.reshape(D, R2, 128)
    ds = jnp.arange(D - 1, -1, -1, dtype=jnp.int32)
    xs = (g_all[::-1], b_all[::-1], ol_all[::-1], bad_all[::-1],
          bz_all[::-1], ds)

    offset_f = np.float32(offset)
    max_ratio_f = np.float32(max_ratio)
    margin_f = np.float32(margin)

    # ---- prescan: findBestRatio ----
    best0 = jnp.full((R2, 128), _f32c(max_ratio, 0.0001), f32)
    halfmax = np.float32(np.float32(max_ratio_f) * np.float32(0.5))
    largest_pre = alens + blens - mo_eff

    def pre_step(carry, x):
        best, returned, result = carry
        g, b, ol, bad_d, bz, d = x
        insert = d.astype(jnp.int64) + min_insert0_col
        inrange = (
            (insert <= largest_pre) & (insert >= min_insert) & ~returned
        )
        badlimit = best * ol
        ok = inrange & (b <= badlimit)
        ret100 = ok & bz & (g > mo0_eff.astype(f32)) & (
            g < mo_eff.astype(f32)
        )
        result = jnp.where(ret100, f32(100.0), result)
        returned = returned | ret100
        ok = ok & ~ret100
        ratio = jnp.where(
            ol > 0, (b + offset_f) / jnp.maximum(ol, 1), f32(1)
        )
        improve = ok & (ratio < best)
        best = jnp.where(improve, ratio, best)
        early = improve & (g >= mo_eff.astype(f32)) & (ratio < halfmax)
        result = jnp.where(early, best, result)
        returned = returned | early
        return (best, returned, result), None

    init = (best0, jnp.zeros((R2, 128), bool), jnp.zeros((R2, 128), f32))
    (best_p, returned_p, result_p), _ = jax.lax.scan(pre_step, init, xs)
    x_pre = jnp.where(returned_p, result_p, best_p)

    no_sol = x_pre > max_ratio_f
    maxr = jnp.minimum(max_ratio_f, x_pre).astype(f32)
    margin2 = (
        (_f32c(margin, offset)) / min_len.astype(f32)
    ).astype(f32)
    extra_mult_f = np.float32(extra_mult)
    min_second_f = np.float32(min_second_ratio)
    largest = alens + blens - mo0_eff

    def step(carry, x):
        (best_insert, best_bad_int, best_ratio, second_ratio, ambig,
         returned, ret_ambig, best_overlap, best_bad_f, second_insert,
         second_overlap, second_bad_f, second_bad_int) = carry
        g, b, ol, bad_d, bz, d = x
        insert = d.astype(jnp.int64) + min_insert0_col
        inrange = (
            (insert <= largest) & (insert >= min_insert0) & ~returned
        )
        t2 = _mul_f32_once(
            _mul_f32_once(jnp.minimum(best_ratio, maxr), margin_f), ol
        )
        badlimit = (_mul_f32_once(jnp.float32(extra_mult_f), t2)
                    + f32(1.0)).astype(f32)
        ok = inrange & (b <= badlimit)
        retA = ok & bz & (g > mo0_eff.astype(f32)) & (
            g < mo_eff.astype(f32)
        )
        ret_ambig = ret_ambig | retA
        returned = returned | retA
        ok = ok & ~retA
        ratio = jnp.where(
            ol > 0, (b + offset_f) / jnp.maximum(ol, 1), f32(1)
        )
        cand = ok & (ratio < best_ratio * margin_f)
        new_ambig = (ratio * margin_f >= best_ratio) | (
            g < mo_eff.astype(f32)
        )
        ambig = jnp.where(cand, new_ambig, ambig)
        improve = cand & (ratio < best_ratio)
        second = cand & ~improve & (ratio < second_ratio)
        second_ratio0 = second_ratio
        second_ratio = jnp.where(improve, best_ratio, second_ratio)
        second_insert = jnp.where(improve, best_insert, second_insert)
        second_overlap = jnp.where(improve, best_overlap, second_overlap)
        second_bad_f = jnp.where(improve, best_bad_f, second_bad_f)
        second_bad_int = jnp.where(improve, best_bad_int, second_bad_int)
        best_insert = jnp.where(improve, insert, best_insert)
        best_bad_int = jnp.where(improve, bad_d.astype(jnp.int64),
                                 best_bad_int)
        best_ratio = jnp.where(improve, ratio, best_ratio)
        best_overlap = jnp.where(improve, ol.astype(jnp.int64),
                                 best_overlap)
        best_bad_f = jnp.where(improve, b, best_bad_f)
        second_ratio = jnp.where(second, ratio, second_ratio)
        second_insert = jnp.where(second, insert, second_insert)
        second_overlap = jnp.where(second, ol.astype(jnp.int64),
                                   second_overlap)
        second_bad_f = jnp.where(second, b, second_bad_f)
        second_bad_int = jnp.where(second, bad_d.astype(jnp.int64),
                                   second_bad_int)
        del second_ratio0
        retB = cand & (
            (ambig & (best_ratio < margin2))
            | (second_ratio < min_second_f)
        )
        ret_ambig = ret_ambig | retB
        returned = returned | retB
        return (best_insert, best_bad_int, best_ratio, second_ratio,
                ambig, returned, ret_ambig, best_overlap, best_bad_f,
                second_insert, second_overlap, second_bad_f,
                second_bad_int), None

    carry0 = (
        jnp.full((R2, 128), -1, jnp.int64),       # best_insert
        jnp.full((R2, 128), -1, jnp.int64),       # best_bad_int
        jnp.ones((R2, 128), f32),                 # best_ratio
        jnp.ones((R2, 128), f32),                 # second_ratio
        jnp.zeros((R2, 128), bool),               # ambig
        no_sol,                                   # returned
        jnp.zeros((R2, 128), bool),               # ret_ambig
        jnp.full((R2, 128), -1, jnp.int64),       # best_overlap
        min_len.astype(f32),                      # best_bad_f
        jnp.zeros((R2, 128), jnp.int64),          # second_insert
        jnp.zeros((R2, 128), jnp.int64),          # second_overlap
        jnp.zeros((R2, 128), f32),                # second_bad_f
        jnp.full((R2, 128), -1, jnp.int64),       # second_bad_int
    )
    (best_insert, best_bad_int, best_ratio, second_ratio, ambig,
     returned, ret_ambig, best_overlap, best_bad_f, second_insert,
     second_overlap, second_bad_f, second_bad_int), _ = jax.lax.scan(
        step, carry0, xs
    )
    normal = ~returned
    ambig = jnp.where(
        normal, ambig | (second_ratio < min_second_f), ambig
    )
    best_insert = jnp.where(
        normal & ~ambig & (best_ratio > maxr), -1, best_insert
    )
    out_insert = jnp.where(no_sol | ret_ambig, -1, best_insert)
    out_bad = jnp.where(no_sol, min_len, best_bad_int)
    out_ambig = jnp.where(
        no_sol, False, jnp.where(ret_ambig, False, ambig & (out_insert > -1))
    )
    def unfold(x):
        return x.reshape(-1)[:B0]

    out_insert, out_bad, out_ambig = map(
        unfold, (out_insert, out_bad, out_ambig)
    )
    if collect:
        stats = {
            "best_insert": best_insert, "best_overlap": best_overlap,
            "best_bad": best_bad_f, "best_ratio": best_ratio,
            "best_bad_int": best_bad_int,
            "second_insert": second_insert, "second_overlap": second_overlap,
            "second_bad": second_bad_f, "second_ratio": second_ratio,
            "second_bad_int": second_bad_int,
        }
        stats = {k: unfold(v) for k, v in stats.items()}
        return out_insert, out_bad, out_ambig, stats
    return out_insert, out_bad, out_ambig


def overlap_and_mate(a, b_rc, alens, blens, min_insert0_col: int,
                     n_inserts: int, min_overlap0, min_overlap,
                     min_insert0: int, min_insert: int, max_ratio: float,
                     min_second_ratio: float, margin: float, offset: float,
                     extra_mult: float = 1.2, collect: bool = False,
                     aq=None, bq_rev=None):
    """Fused device pipeline: insert-scan kernel + mate selection in ONE
    jit — only [B]-sized winner arrays return to the host (the [B, D]
    count matrices stay on device; pulling them cost ~27 MB/batch).

    With aq/bq_rev given (phred arrays; bq reversed to match b_rc) the
    quality-weighted mode runs (mateByOverlapRatioJava_WithQualities):
    the int mismatch counts still come from the fast insert-scan kernel
    (badInt), and the f32 prob-weighted good/bad planes come from the
    sequential-order quality scan."""
    import jax

    with_q = aq is not None

    @partial(
        jax.jit,
        static_argnames=(
            "m0c", "ni", "mi0", "mi", "maxr", "msr", "marg", "off",
            "em", "col",
        ),
    )
    def run(a, b_rc, alens, blens, mo0, mo, aqv, bqv, m0c, ni, mi0, mi,
            maxr, msr, marg, off, em, col):
        good, bad, ol = overlap_counts_jnp(a, b_rc, alens, blens, m0c, ni)
        good_f = bad_f = None
        if with_q:
            good_f, bad_f, _bad_int, _ol = _overlap_counts_quality(
                a, b_rc, aqv, bqv, alens, blens, m0c, ni
            )
        return mate_by_overlap_ratio_jnp(
            good, bad, ol, alens, blens, m0c, mo0, mo, mi0, mi,
            maxr, msr, marg, off, extra_mult=em, collect=col,
            good_f=good_f, bad_f=bad_f,
        )

    zq = np.zeros((1, 1), np.uint8)
    return run(
        jnp.asarray(np.asarray(a)), jnp.asarray(np.asarray(b_rc)),
        jnp.asarray(np.asarray(alens)), jnp.asarray(np.asarray(blens)),
        jnp.asarray(np.asarray(min_overlap0)),
        jnp.asarray(np.asarray(min_overlap)),
        jnp.asarray(np.asarray(aq if with_q else zq)),
        jnp.asarray(np.asarray(bq_rev if with_q else zq)),
        min_insert0_col, n_inserts, min_insert0, min_insert,
        float(max_ratio), float(min_second_ratio), float(margin),
        float(offset), float(extra_mult), bool(collect),
    )


# ---------------------------------------------------------------------------
# Device efilter/pfilter (expectedMismatches / probability as scans)
# ---------------------------------------------------------------------------


_F32_MAX = np.float32(3.4028235e38)


def _mul_f32_once(x, y):
    """Single-rounded f32 product immune to FMA contraction: XLA can
    fuse an f32 multiply into a neighboring add/sub with excess
    precision (observed on the CPU backend depending on how the
    platform was initialized), breaking bit-parity with the reference's
    JLS-mandated one-rounding-per-op floats; optimization_barrier and
    f64-roundtrip formulations both get simplified away. A minimum()
    against +MAX_FLOAT is the identity for every finite in-range
    product here but is opaque to the contraction pass (removing it
    would need range analysis XLA doesn't do)."""
    return jnp.minimum((x * y).astype(jnp.float32), _F32_MAX)


def _left_shift_rows(x, s, fill):
    """x'[:, t] = x[:, s[row] + t] via log-shifts (no gathers); columns
    past the end read `fill` (callers mask them)."""
    B, L = x.shape
    s = s.astype(jnp.int32)[:, None]
    j = 0
    while (1 << j) <= L:
        sh = 1 << j
        shifted = jnp.pad(
            x[:, sh:], ((0, 0), (0, sh)), constant_values=fill
        )
        x = jnp.where(((s >> j) & 1) == 1, shifted, x)
        j += 1
    return x


@jax.jit
def expected_mismatches_jnp(a, b_rc, aq, bq, alens, blens, overlap):
    """Device mirror of expected_mismatches_np: per-read alignment via
    log-shifts, bit-exact sequential f32 sum via a lax.scan over t (the
    np loop's t-order; full-length scan is exact because masked steps
    add +0.0f)."""
    f32 = jnp.float32
    B, L = a.shape
    overlap = jnp.asarray(overlap)
    alens = jnp.asarray(alens)
    blens = jnp.asarray(blens)
    istart = jnp.where(overlap <= blens, 0, overlap - blens)
    jstart = jnp.where(overlap <= alens, alens - overlap, 0)
    pc4 = jnp.asarray(PROB_CORRECT4)
    pa4 = jnp.take(pc4, jnp.minimum(aq.astype(jnp.int32), 59))
    pb4 = jnp.take(pc4, jnp.minimum(bq.astype(jnp.int32), 59))
    a2 = _left_shift_rows(a.astype(jnp.int32), istart, 4)
    b2 = _left_shift_rows(b_rc.astype(jnp.int32), jstart, 4)
    pa2 = _left_shift_rows(pa4, istart, 0.0)
    pb2 = _left_shift_rows(pb4, jstart, 0.0)
    t_idx = jnp.arange(L, dtype=jnp.int64)[None, :]
    i = istart[:, None] + t_idx
    jj = jstart[:, None] + t_idx
    live = (i < overlap[:, None]) & (i < alens[:, None]) & (
        jj < blens[:, None]
    )
    both_def = (a2 < 4) & (b2 < 4)
    prob_c = _mul_f32_once(pa2, pb2)
    prob_e = (f32(1) - prob_c).astype(f32)
    contrib = jnp.where(live & both_def, prob_e, f32(0))
    # sequential t-order sum, reads tiled [B/128, 128]
    Bp = ((B + 127) // 128) * 128
    if Bp != B:
        contrib = jnp.pad(contrib, ((0, Bp - B), (0, 0)))
    xs = contrib.T.reshape(L, Bp // 128, 128)

    def step(acc, c):
        return (acc + c).astype(f32), None

    acc0 = jnp.zeros((Bp // 128, 128), f32)
    acc, _ = jax.lax.scan(step, acc0, xs)
    return acc.reshape(-1)[:B]


@jax.jit
def probability_jnp(a, b_rc, aq, bq, alens, blens, insert):
    """Device mirror of probability_np (same structure as
    expected_mismatches_jnp; masked steps multiply by exact 1.0f).

    Equal to the host oracle except XLA's flush-to-zero of f32
    subnormals: probability products below ~1.2e-38 read 0.0 here where
    the oracle keeps denormal values. No pfilter decision can differ —
    thresholds are >= 1e-6-scale and both values sit on the same side.
    (The test asserts exact equality for normal values and
    flushed-zero for subnormal oracle values.)"""
    f32 = jnp.float32
    B, L = a.shape
    insert = jnp.asarray(insert)
    alens = jnp.asarray(alens)
    blens = jnp.asarray(blens)
    istart = jnp.where(insert <= blens, 0, insert - blens)
    jstart = jnp.where(insert >= blens, 0, blens - insert)
    pc4 = jnp.asarray(PROB_CORRECT4)
    pa4 = jnp.take(pc4, jnp.minimum(aq.astype(jnp.int32), 59))
    pb4 = jnp.take(pc4, jnp.minimum(bq.astype(jnp.int32), 59))
    a2 = _left_shift_rows(a.astype(jnp.int32), istart, 4)
    b2 = _left_shift_rows(b_rc.astype(jnp.int32), jstart, 4)
    pa2 = _left_shift_rows(pa4, istart, 0.0)
    pb2 = _left_shift_rows(pb4, jstart, 0.0)
    t_idx = jnp.arange(L, dtype=jnp.int64)[None, :]
    i = istart[:, None] + t_idx
    jj = jstart[:, None] + t_idx
    live = (i < insert[:, None]) & (i < alens[:, None]) & (
        jj < blens[:, None]
    )
    both_def = (a2 < 4) & (b2 < 4)
    prob_c = _mul_f32_once(pa2, pb2)
    # (1-pc)*0.25 is an exact power-of-two scale (no rounding), so the
    # prob_c + t1 add has only one contractible multiply -- make it the
    # exact-rounded form
    t1 = _mul_f32_once((f32(1) - prob_c).astype(f32), jnp.float32(0.25))
    prob_m = (prob_c + t1).astype(f32)
    prob_e = (f32(1) - prob_m).astype(f32)
    upd = live & both_def
    pc = jnp.where(upd, jnp.maximum(prob_m, prob_e), f32(1))
    pa = jnp.where(upd, jnp.where(a2 == b2, prob_m, prob_e), f32(1))
    Bp = ((B + 127) // 128) * 128
    if Bp != B:
        pc = jnp.pad(pc, ((0, Bp - B), (0, 0)), constant_values=1.0)
        pa = jnp.pad(pa, ((0, Bp - B), (0, 0)), constant_values=1.0)
    xs = (
        pc.T.reshape(L, Bp // 128, 128),
        pa.T.reshape(L, Bp // 128, 128),
    )

    def step(carry, x):
        common, actual = carry
        c, p = x
        return (
            (common * c).astype(f32),
            (actual * p).astype(f32),
        ), None

    ones = jnp.ones((Bp // 128, 128), f32)
    (common, actual), _ = jax.lax.scan(step, (ones, ones), xs)
    common = common.reshape(-1)[:B]
    actual = actual.reshape(-1)[:B]
    r = actual / common
    return jnp.where(common > 0, r, f32(1)).astype(f32)


@partial(jax.jit, static_argnames=("k", "minscore", "from_tail"))
def calc_min_overlap_by_entropy_jnp(codes, lengths, k: int, minscore: int,
                                    from_tail: bool):
    """Device mirror of calc_min_overlap_by_entropy_np: lax.scan over
    positions with a [B, 4^k] one-hot count carry (the np version
    scatters into per-read count tables; 4^3=64 lanes of compare-sum
    replace the row scatters). Integer state only — exact."""
    B, L = codes.shape
    space = 1 << (2 * k)
    mask = space - 1
    lengths = jnp.asarray(lengths).astype(jnp.int64)
    rng_iota = jnp.arange(space, dtype=jnp.int64)[None, :]

    def step(carry, i):
        counts, kmer, ln, ones, twos, result, done = carry
        pos = jnp.where(from_tail, lengths - 1 - i, i)
        live = (i < lengths) & ~done
        pp = jnp.clip(pos, 0, L - 1)
        # compare-sum column extract (no gather)
        col = jnp.sum(
            jnp.where(
                jnp.arange(L, dtype=jnp.int64)[None, :] == pp[:, None],
                codes.astype(jnp.int64), 0,
            ),
            axis=1,
        )
        defined = col < 4
        ln = jnp.where(live & defined, ln + 1, jnp.where(live, 0, ln))
        kmer = jnp.where(
            live & defined,
            ((kmer << 2) | jnp.where(defined, col, 0)) & mask,
            jnp.where(live, 0, kmer),
        )
        add = live & defined & (ln >= k)
        oh = rng_iota == kmer[:, None]  # [B, space]
        old = jnp.sum(jnp.where(oh, counts, 0), axis=1)
        counts = counts + jnp.where(oh & add[:, None], 1, 0)
        newc = old + 1
        ones = jnp.where(add & (newc == 1), ones + 1, ones)
        twos = jnp.where(add & (newc == 2), twos + 1, twos)
        hit = add & (ones * 4 + twos >= minscore)
        result = jnp.where(hit & ~done, i, result)
        done = done | hit
        return (counts, kmer, ln, ones, twos, result, done), None

    z = jnp.zeros((B,), jnp.int64)
    carry0 = (
        jnp.zeros((B, space), jnp.int32), z, z, z, z,
        lengths + 1, jnp.zeros((B,), bool),
    )
    (counts, kmer, ln, ones, twos, result, done), _ = jax.lax.scan(
        step, carry0, jnp.arange(L, dtype=jnp.int64)
    )
    return result
