"""Banded edit-distance kernels (BandedAligner analog).

Reference: align2/BandedAligner.java + BandedAlignerConcrete.java — one of
the four JNI hot loops (jni/BandedAlignerJNI.c) the reference ships native
kernels for (SURVEY.md §2.4). Semantics transcribed from
BandedAlignerConcrete.alignForward (:60-160):

  - swap query/ref when the query window is longer (:63-75)
  - band width = min(maxWidth, 2*maxEdits+1, 2*max(len)+2) | 1 (:80)
  - row 0 holds bare substitution scores across the window (no row
    offset — lateral shifts are charged at the end, :100-120)
  - inner cells: min(up+1, diag+mismatch, left+1); the last row and the
    last ref column force the diagonal move (:134-142)
  - early exit when a row's minimum exceeds maxEdits (:146)
  - penalizeOffCenter: cell at offset i from the band center is raised
    to at least i before the final min (:202, BandedAligner
    penalizeOffCenter)

Device design: the row loop is a lax.scan over min(qlen,rlen) steps; the
band (W lanes, W = 2*maxEdits+1, static) lives in registers; the
within-row left-dependency — a prefix min of (cand[j] - j) — is an
associative scan, so each row is O(log W) depth instead of W. Whole
batches of pairs run in parallel lanes; there are no gathers (the ref
window is a dynamic_slice per row).

The numpy transliteration (banded_edits_np) is the test oracle.
"""

from __future__ import annotations

import numpy as np

BIG = 99999999


def _mismatch(q, r, exact: bool) -> int:
    if q == r:
        return 0
    if not exact and (q >= 4 or r >= 4):
        return 0
    return 1


def banded_edits_np(
    query: np.ndarray,
    ref: np.ndarray,
    max_edits: int,
    exact: bool = True,
    max_width: int = 9,
) -> int:
    """alignForward on code arrays (0..3, >=4 undefined). Returns the
    final `edits` value (may exceed max_edits when the band broke)."""
    if len(query) > len(ref):
        return banded_edits_np(ref, query, max_edits, exact, max_width)
    width = min(max_width, 2 * max_edits + 1, 2 * max(len(query), len(ref)) + 2) | 1
    half = width // 2
    qlen, rlen = len(query), len(ref)
    ln = min(qlen, rlen)
    if ln < 1:
        return 0
    arr_prev = np.full(width + 2, BIG, dtype=np.int64)
    arr_cur = np.full(width + 2, BIG, dtype=np.int64)
    qloc, rsloc = 0, -half
    # first row
    edits = BIG
    q = query[qloc]
    col_start, col_lim = max(0, rsloc), min(rsloc + width, rlen)
    mloc = 1 + (col_start - rsloc)
    for col in range(col_start, col_lim):
        s = _mismatch(q, ref[col], exact)
        arr_cur[mloc] = s
        edits = min(edits, s)
        mloc += 1
    qloc += 1
    rsloc += 1
    row = 1
    while row < ln:
        arr_prev, arr_cur = arr_cur, arr_prev
        arr_cur[:] = BIG
        q = query[qloc]
        col_start, col_lim = max(0, rsloc), min(rsloc + width, rlen)
        edits = BIG
        mloc = 1 + (col_start - rsloc)
        force_diag = row == ln - 1
        for col in range(col_start, col_lim):
            up = arr_prev[mloc + 1] + 1
            diag = arr_prev[mloc] + _mismatch(q, ref[col], exact)
            left = arr_cur[mloc - 1] + 1
            s = diag if (force_diag or col == rlen - 1) else min(up, diag, left)
            arr_cur[mloc] = s
            edits = min(edits, s)
            mloc += 1
        row += 1
        qloc += 1
        rsloc += 1
        if edits > max_edits:
            break
    # penalizeOffCenter
    center = half + 1
    edits = arr_cur[center]
    for i in range(1, half + 1):
        arr_cur[center + i] = min(BIG, max(i, arr_cur[center + i]))
        edits = min(edits, arr_cur[center + i])
        arr_cur[center - i] = min(BIG, max(i, arr_cur[center - i]))
        edits = min(edits, arr_cur[center - i])
    return int(edits)


def banded_edits_jnp(query, qlen, ref, rlen, max_edits: int, exact: bool = True,
                     max_width: int = 9):
    """Batched device version: query/ref [B, L] code arrays, qlen/rlen
    [B]. Returns edits [B] (values > max_edits mean 'band exceeded').

    The per-task query/ref swap (reference :63) is applied by the caller
    via jnp.where on the inputs — see align_pairs_jnp.
    """
    import jax
    import jax.numpy as jnp

    B, L = query.shape
    Lmax = int(L)
    width = min(max_width, 2 * max_edits + 1, 2 * Lmax + 2) | 1
    half = width // 2

    qlen = qlen.astype(jnp.int32)
    rlen = rlen.astype(jnp.int32)
    ln = jnp.minimum(qlen, rlen)
    n_rows = Lmax

    # pad ref so the row-r window is refs_pad[:, r : r+width]
    pad = jnp.full((B, half), 99, dtype=query.dtype)
    tail = jnp.full((B, width), 99, dtype=query.dtype)
    refs_pad = jnp.concatenate([pad, ref, tail], axis=1)
    qpad = jnp.concatenate([query, jnp.full((B, 1), 99, query.dtype)], axis=1)

    offs = jnp.arange(width, dtype=jnp.int32)[None, :] - half  # col - row

    def mismatch(qc, rc):
        eq = qc == rc
        if exact:
            return jnp.where(eq, 0, 1).astype(jnp.int32)
        undef = (qc >= 4) | (rc >= 4)
        return jnp.where(eq | undef, 0, 1).astype(jnp.int32)

    def body(carry, r):
        band, edits, done = carry
        qc = jax.lax.dynamic_slice_in_dim(qpad, r, 1, axis=1)[:, 0]
        rwin = jax.lax.dynamic_slice_in_dim(refs_pad, r, width, axis=1)
        cols = offs + r  # ref column per lane
        in_ref = (cols >= 0) & (cols < rlen[:, None])
        mis = mismatch(qc[:, None], rwin)
        first = r == 0
        last_row = r == (ln - 1)
        last_col = cols == (rlen[:, None] - 1)

        up = jnp.concatenate(
            [band[:, 1:], jnp.full((B, 1), BIG, jnp.int32)], axis=1
        ) + 1
        diag = band + mis
        cand = jnp.minimum(up, diag)
        # left-dependency: cur[j] = min(cand[j], min_{i<j}(cur[i]+j-i));
        # closed form: prefix-min over (cand - j) then + j
        jidx = jnp.arange(width, dtype=jnp.int32)[None, :]
        shifted = cand - jidx
        pref = jax.lax.associative_scan(jnp.minimum, shifted, axis=1)
        relaxed = jnp.minimum(cand, pref + jidx)
        force = last_row[:, None] | last_col
        newband = jnp.where(force, diag, relaxed)
        newband = jnp.where(first, mis, newband)
        newband = jnp.where(in_ref, newband, BIG)
        newband = jnp.minimum(newband, BIG)

        row_min = jnp.min(newband, axis=1)
        active = (~done) & (r < ln)
        band = jnp.where(active[:, None], newband, band)
        edits = jnp.where(active, row_min, edits)
        done = done | (active & (row_min > max_edits)) | (r >= ln - 1)
        return (band, edits, done), None

    band0 = jnp.full((B, width), BIG, dtype=jnp.int32)
    edits0 = jnp.zeros(B, dtype=jnp.int32)
    done0 = ln < 1
    (band, edits, done), _ = jax.lax.scan(
        body, (band0, edits0, done0), jnp.arange(n_rows, dtype=jnp.int32)
    )
    # penalizeOffCenter on the final band
    i_off = jnp.abs(jnp.arange(width, dtype=jnp.int32) - half)[None, :]
    pen = jnp.minimum(BIG, jnp.maximum(i_off, band))
    final = jnp.min(pen, axis=1)
    return jnp.where(ln < 1, 0, final)


def align_pairs_jnp(a, alen, b, blen, max_edits: int, exact: bool = True,
                    max_width: int = 9):
    """Per-pair alignForward with the reference's swap rule (query is the
    shorter sequence)."""
    import jax.numpy as jnp

    swap = alen > blen
    q = jnp.where(swap[:, None], b, a)
    r = jnp.where(swap[:, None], a, b)
    ql = jnp.where(swap, blen, alen)
    rl = jnp.where(swap, alen, blen)
    return banded_edits_jnp(q, ql, r, rl, max_edits, exact, max_width)


def align_quadruple_np(a: np.ndarray, b: np.ndarray, max_edits: int,
                       exact: bool = True, max_width: int = 9) -> int:
    """alignQuadruple (:67-76): min(max(fwd, rev), max(fwdRC, revRC))."""
    fwd = banded_edits_np(a, b, max_edits, exact, max_width)
    rev = banded_edits_np(a[::-1], b[::-1], max_edits, exact, max_width)
    me2 = min(max_edits, max(fwd, rev))
    if me2 == 0:
        return 0
    arc = np.where(a < 4, 3 - a, a)[::-1]
    frc = banded_edits_np(arc, b, me2, exact, max_width)
    rrc = banded_edits_np(arc[::-1], b[::-1], me2, exact, max_width)
    return min(max(fwd, rev), max(frc, rrc))
