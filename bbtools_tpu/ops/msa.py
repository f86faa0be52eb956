"""Batched banded affine-gap DP — the MultiStateAligner11ts kernel, on the device.

Re-design of align2/MultiStateAligner11ts.fillLimitedX (:128-610) /
fillUnlimited (:643-860) as an anti-diagonal wavefront: MS depends on
(r-1,c-1), INS on (r-1,c), DEL on (r,c-1), so every dependency of diagonal
d lives on d-1 or d-2 and each diagonal computes as one vectorized step
(lax.scan over d, lanes over rows x batch).

Band-pruning equivalence: the reference tracks a live column range per row
(minGoodCol/maxGoodCol) and skips dead cells; a skipped or pruned cell is
observable only as `subfloor`, and any cell whose inputs are all subfloor
computes below its limit and becomes subfloor again — so computing every
cell with the exact per-cell limit tests (limit2/limit3) reproduces the
row-sequential banding bit-for-bit, without the sequential state. (The
explicit `bandwidth` flag is not yet wired; BBMap's default is unbanded.)

Scores are unshifted int32 (the Java packed score<<11 is shift-invariant
in all comparisons); times are separate int32 lanes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import msa_constants as C

NEG_BIG = np.int32(-(1 << 30))


def prepare_limits_np(read_codes, read_lens, ref_codes, ref_lens, min_score):
    """Host precompute of vertLimit/horizLimit/floor/subfloor (:204-230).

    read_codes [B, R], ref_codes [B, Cc]; min_score [B] already reduced by
    MIN_SCORE_ADJUST. Returns vert [B, R+1], horiz [B, Cc+1], floor [B],
    subfloor [B].
    """
    B, R = read_codes.shape
    Cc = ref_codes.shape[1]
    maxgain = (read_lens.astype(np.int64) - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
    floor = min_score.astype(np.int64) - maxgain
    subfloor = floor - 5 * C.POINTS_MATCH2
    vert = np.zeros((B, R + 1), dtype=np.int64)
    horiz = np.zeros((B, Cc + 1), dtype=np.int64)
    pos = np.arange(R)
    for arr, codes, lens in ((vert, read_codes, read_lens), (horiz, ref_codes, ref_lens)):
        n = codes.shape[1]
        defined = codes < 4
        # step at index i (contribution when moving from i+1 to i):
        nxt_defined = np.zeros_like(defined)
        nxt_defined[:, : n - 1] = defined[:, 1:]
        # cells at/after lens have no effect (we only read 0..lens)
        within = np.arange(n)[None, :] < lens[:, None]
        nxt_within = np.arange(n)[None, :] + 1 < lens[:, None]
        step = np.where(
            defined & within,
            np.where(nxt_defined & nxt_within, C.POINTS_MATCH2, C.POINTS_MATCH),
            0,  # NOCALL / NOREF
        ).astype(np.int64)
        # arr[i] = max(min_score - sum(step[i:lens]), floor) for i < lens
        sfx = np.cumsum(step[:, ::-1], axis=1)[:, ::-1]
        arr[:, :n] = np.maximum(min_score[:, None] - sfx, floor[:, None])
        arr[np.arange(B), lens] = min_score
    return vert, horiz, floor, subfloor


def col0_scores(R: int) -> np.ndarray:
    """Column-0 cumulative insertion penalties (ctor :91-101)."""
    col0 = np.zeros(R + 1, dtype=np.int64)
    for i in range(R + 1):
        prev = 0 if i < 2 else col0[i - 1]
        col0[i] = prev + C.POINTS_INS_ARRAY[min(i, 603)]
    return col0


def _sub_array_cost(streak):
    """POINTS_SUB_ARRAY[streak+1] as a where-chain (gather-free)."""
    i = streak + 1
    return jnp.where(
        i > C.LIMIT_FOR_COST_3,
        C.POINTS_SUB3,
        jnp.where(i > 1, C.POINTS_SUB2, C.POINTS_SUB),
    )


def _ins_array_cost(streak):
    i = streak + 1
    return jnp.where(
        i > C.LIMIT_FOR_COST_4,
        C.POINTS_INS4,
        jnp.where(
            i > C.LIMIT_FOR_COST_3,
            C.POINTS_INS3,
            jnp.where(i > 1, C.POINTS_INS2, C.POINTS_INS),
        ),
    )


def _del_ext_cost(streak):
    return jnp.where(
        streak == 0,
        C.POINTS_DEL,
        jnp.where(
            streak < C.LIMIT_FOR_COST_3,
            C.POINTS_DEL2,
            jnp.where(
                streak < C.LIMIT_FOR_COST_4,
                C.POINTS_DEL3,
                jnp.where(
                    streak < C.LIMIT_FOR_COST_5,
                    C.POINTS_DEL4,
                    jnp.where((streak & C.MASK5) == 0, C.POINTS_DEL5, 0),
                ),
            ),
        ),
    )


def _calc_del_score_jnp(length):
    score = jnp.where(length > 0, C.POINTS_DEL, 0)
    score = score + jnp.where(
        length > C.LIMIT_FOR_COST_5,
        ((length - C.LIMIT_FOR_COST_5 + C.MASK5) // C.TIMESLIP) * C.POINTS_DEL5,
        0,
    )
    l5 = jnp.minimum(length, C.LIMIT_FOR_COST_5)
    score = score + jnp.where(
        l5 > C.LIMIT_FOR_COST_4, (l5 - C.LIMIT_FOR_COST_4) * C.POINTS_DEL4, 0
    )
    l4 = jnp.minimum(l5, C.LIMIT_FOR_COST_4)
    score = score + jnp.where(
        l4 > C.LIMIT_FOR_COST_3, (l4 - C.LIMIT_FOR_COST_3) * C.POINTS_DEL3, 0
    )
    l3 = jnp.minimum(l4, C.LIMIT_FOR_COST_3)
    score = score + jnp.where(l3 > 1, (l3 - 1) * C.POINTS_DEL2, 0)
    return score


def _calc_ins_score_jnp(length, cum_ins):
    idx = jnp.clip(length, 0, 603)
    return jnp.where(length > 0, cum_ins[idx], 0)


@partial(jax.jit, static_argnames=("R", "Cc", "prune", "traceback"))
def msa_fill(
    R: int,
    Cc: int,
    prune: bool,
    traceback: bool,
    reads,  # uint8 [B, R]
    read_lens,  # int32 [B]
    refs,  # uint8 [B, Cc]
    ref_lens,  # int32 [B]
    vert,  # int32 [B, R+1]
    horiz,  # int32 [B, Cc+1]
    floor,  # int32 [B]
    subfloor,  # int32 [B]
):
    """Wavefront fill. Returns (max_score, max_col, max_state) per task
    (reference's {rows, maxCol, maxState, max} minus the redundant rows).

    With prune=False this is fillUnlimited (subfloor = -2*maxgain computed
    by the caller); with prune=True, fillLimitedX.
    """
    B = reads.shape[0]
    rr = jnp.arange(R + 1, dtype=jnp.int32)  # row index within a diagonal
    i32 = jnp.int32
    reads = reads.astype(i32)
    refs = refs.astype(i32)
    # per-row read bases (fixed over diagonals); index r -> read[r-1]
    call1 = jnp.concatenate([jnp.zeros((B, 1), i32) + 99, reads], axis=1)
    call0 = jnp.concatenate([jnp.zeros((B, 2), i32) + 98, reads[:, :-1]], axis=1)
    # padded ref for per-diagonal slicing: index p -> ref[p - (R+2)]
    PAD = R + 2
    refp = jnp.concatenate(
        [jnp.zeros((B, PAD), i32) + 97, refs, jnp.zeros((B, PAD), i32) + 97],
        axis=1,
    )
    horizp = jnp.concatenate(
        [
            jnp.zeros((B, PAD), i32) + (1 << 29),
            horiz.astype(i32),
            jnp.zeros((B, PAD), i32) + (1 << 29),
        ],
        axis=1,
    )
    col0 = jnp.asarray(col0_scores(R), dtype=i32)  # [R+1]
    rows_b = read_lens  # [B]
    cols_b = ref_lens
    B_I2 = rows_b - C.BARRIER_I1  # per task
    B_D2 = rows_b - C.BARRIER_D1
    B_I2b = cols_b - 1
    cum_ins = jnp.asarray(C.POINTS_INS_ARRAY_C, dtype=i32)

    def boundary(d):
        """Cell values on diagonal d for boundary rows (r=0 or c=0)."""
        c = d - rr[None, :]  # [1, R+1] broadcast with B
        s = jnp.where(rr[None, :] == 0, 0, col0[rr][None, :])
        # r==0 -> row0 (score 0); c==0 -> col0[r]; both only at d==0
        s = jnp.where(c == 0, col0[rr][None, :], jnp.where(rr[None, :] == 0, 0, NEG_BIG))
        return s

    def init_diag(d):
        # diagonal d cells: r in [0..R], c = d - r; only boundary cells set
        c = d - rr[None, :]
        is_b = (rr[None, :] == 0) | (c == 0)
        s = jnp.where(
            c == 0,
            jnp.broadcast_to(col0[rr][None, :], (B, R + 1)),
            jnp.where(rr[None, :] == 0, 0, NEG_BIG),
        )
        s = jnp.where(is_b, s, NEG_BIG).astype(i32)
        t = jnp.zeros((B, R + 1), i32)
        return s, t

    s0, t0 = init_diag(0)  # diagonal 0: only (0,0)
    s1, t1 = init_diag(1)  # diagonal 1: (0,1) and (1,0)
    # all three states share boundary values
    prev2 = (s0, t0, s0, t0, s0, t0)  # ms_s, ms_t, del_s, del_t, ins_s, ins_t
    prev1 = (s1, t1, s1, t1, s1, t1)

    def step(carry, d):
        (p1_ms_s, p1_ms_t, p1_del_s, p1_del_t, p1_ins_s, p1_ins_t), (
            p2_ms_s,
            p2_ms_t,
            p2_del_s,
            p2_del_t,
            p2_ins_s,
            p2_ins_t,
        ), best = carry
        c = d - rr[None, :]  # [1, R+1]
        cB = jnp.broadcast_to(c, (B, R + 1))
        # ref bases at c-1 / c-2 and horiz[c], via ONE dynamic slice each
        # plus static reversals (gather-free): with sl_j = refp[d + j],
        # row r needs ref[c-1] = refp[d - r - 1 + PAD] = sl_{R - r + 1}
        # (since d + (R - r + 1) = d - r - 1 + (R + 2) = d - r - 1 + PAD)
        d0 = jnp.int32(0)
        sl = jax.lax.dynamic_slice(refp, (d0, d), (B, R + 3))
        ref1 = sl[:, 1 : R + 2][:, ::-1]  # j = R-r+1 for r = 0..R
        ref0 = sl[:, 0 : R + 1][:, ::-1]  # j = R-r   (ref[c-2])
        hsl = jax.lax.dynamic_slice(horizp, (d0, d), (B, R + 3))
        hcol = hsl[:, 2 : R + 3][:, ::-1]  # j = R-r+2 -> horiz[c]
        in_range = (rr[None, :] >= 1) & (cB >= 1)
        match = (call1 == ref1) & (ref1 < 4)
        prev_match = (call0 == ref0) & (ref0 < 4)
        sf = subfloor[:, None]
        # --- MS ---
        s_diag = p2_ms_s
        s_del = p2_del_s
        s_ins = p2_ins_s
        streak = p2_ms_t
        # shift by one row: (r-1, c-1) has index r-1 in diag d-2
        s_diag = _shift_row(s_diag)
        s_del = _shift_row(s_del)
        s_ins = _shift_row(s_ins)
        streak = _shift_row(streak)
        m_sMS = jnp.where(
            match,
            s_diag + jnp.where(prev_match, C.POINTS_MATCH2, C.POINTS_MATCH),
            jnp.where(
                (ref1 < 4) & (call1 < 4),
                s_diag
                + jnp.where(
                    prev_match,
                    jnp.where(streak <= 1, C.POINTS_SUBR, C.POINTS_SUB),
                    _sub_array_cost(streak),
                ),
                s_diag + C.POINTS_NOCALL,
            ),
        )
        m_sD = s_del + jnp.where(match, C.POINTS_MATCH, C.POINTS_SUB)
        m_sI = s_ins + jnp.where(match, C.POINTS_MATCH, C.POINTS_SUB)
        pick_ms = (m_sMS >= m_sD) & (m_sMS >= m_sI)
        pick_d = ~pick_ms & (m_sD >= m_sI)
        ms_score = jnp.where(pick_ms, m_sMS, jnp.where(pick_d, m_sD, m_sI))
        ms_time = jnp.where(
            pick_ms,
            jnp.where(
                match,
                jnp.where(prev_match, streak + 1, 1),
                jnp.where(prev_match, 1, streak + 1),
            ),
            1,
        )
        # --- DEL ---  (r, c-1) = diag d-1 index r
        d_streak = p1_del_t
        d_sMS = p1_ms_s + C.POINTS_DEL
        d_sD = p1_del_s + _del_ext_cost(d_streak)
        refn = ref1 >= 4
        d_sMS = d_sMS + jnp.where(refn, C.POINTS_DEL_REF_N, 0)
        d_sD = d_sD + jnp.where(refn, C.POINTS_DEL_REF_N, 0)
        d_pick_ms = d_sMS >= d_sD
        del_score = jnp.where(d_pick_ms, d_sMS, d_sD)
        del_time = jnp.where(d_pick_ms, 1, d_streak + 1)
        # --- INS --- (r-1, c) = diag d-1 index r-1
        i_sMS = _shift_row(p1_ms_s) + C.POINTS_INS
        i_streak = _shift_row(p1_ins_t)
        i_sI = _shift_row(p1_ins_s) + _ins_array_cost(i_streak)
        i_pick_ms = i_sMS >= i_sI
        ins_score = jnp.where(i_pick_ms, i_sMS, i_sI)
        ins_time = jnp.where(i_pick_ms, 1, i_streak + 1)
        # --- gates and pruning ---
        rb = rr[None, :]
        del_barrier = (rb < C.BARRIER_D1) | (rb > B_D2[:, None])
        ins_barrier = ((rb < C.BARRIER_I1) & (cB > 1)) | (
            (rb > B_I2[:, None]) & (cB < B_I2b[:, None])
        )
        if prune:
            limit = jnp.maximum(vert, hcol)  # vert is [B, R+1] by row
            limit3 = jnp.maximum(
                floor[:, None],
                jnp.where(match, limit - C.POINTS_MATCH2, limit - C.POINTS_SUB3),
            )
            del_needed = jnp.maximum(0, rb - cB - 1)
            ins_needed = jnp.maximum(
                0, (rows_b[:, None] - rb) - (cols_b[:, None] - cB) - 1
            )
            del_pen = _calc_del_score_jnp(del_needed)
            ins_pen = _calc_ins_score_jnp(ins_needed, cum_ins)
            # MS gate + limit2
            ms_dead = (s_diag <= limit3) & (s_del <= limit3) & (s_ins <= limit3)
            ms_limit2 = jnp.where(
                del_needed > 0,
                limit - del_pen,
                jnp.where(ins_needed > 0, limit - ins_pen, limit),
            )
            ms_score = jnp.where(ms_dead | (ms_score < ms_limit2), sf, ms_score)
            ms_time = jnp.where(ms_dead, 0, ms_time)
            # DEL gate
            del_dead = ((p1_ms_s <= limit) & (p1_del_s <= limit)) | del_barrier
            del_limit2 = jnp.where(
                ins_needed > 0,
                limit - ins_pen,
                jnp.where(
                    del_needed > 0,
                    limit
                    - _calc_del_score_jnp(del_time + del_needed)
                    + _calc_del_score_jnp(del_time),
                    limit,
                ),
            )
            del_score = jnp.where(del_dead | (del_score < del_limit2), sf, del_score)
            del_time = jnp.where(del_dead, 0, del_time)
            # INS gate
            ins_dead = (
                (_shift_row(p1_ms_s) <= limit) & (_shift_row(p1_ins_s) <= limit)
            ) | ins_barrier
            ins_limit2 = jnp.where(
                del_needed > 0,
                limit - del_pen,
                jnp.where(
                    ins_needed > 0,
                    limit
                    - _calc_ins_score_jnp(ins_time + ins_needed, cum_ins)
                    + _calc_ins_score_jnp(ins_time, cum_ins),
                    limit,
                ),
            )
            ins_score = jnp.where(ins_dead | (ins_score < ins_limit2), sf, ins_score)
            ins_time = jnp.where(ins_dead, 0, ins_time)
        else:
            del_score = jnp.where(del_barrier, sf, del_score)
            del_time = jnp.where(del_barrier, 0, del_time)
            ins_score = jnp.where(ins_barrier, sf, ins_score)
            ins_time = jnp.where(ins_barrier, 0, ins_time)
        # clamp time
        over = ms_time > C.MAX_TIME
        ms_time = jnp.where(over, C.MAX_TIME - C.MASK5, ms_time)
        del_time = jnp.where(del_time > C.MAX_TIME, C.MAX_TIME - C.MASK5, del_time)
        ins_time = jnp.where(ins_time > C.MAX_TIME, C.MAX_TIME - C.MASK5, ins_time)
        # boundary/in-range resolution
        bnd_s = jnp.where(
            cB == 0,
            jnp.broadcast_to(col0[rr][None, :], (B, R + 1)),
            jnp.where(rb == 0, 0, NEG_BIG),
        ).astype(i32)
        use_bnd = ~in_range
        ms_score = jnp.where(use_bnd, bnd_s, ms_score).astype(i32)
        del_score = jnp.where(use_bnd, bnd_s, del_score).astype(i32)
        ins_score = jnp.where(use_bnd, bnd_s, ins_score).astype(i32)
        ms_time = jnp.where(use_bnd, 0, ms_time).astype(i32)
        del_time = jnp.where(use_bnd, 0, del_time).astype(i32)
        ins_time = jnp.where(use_bnd, 0, ins_time).astype(i32)
        # --- final-row extraction ---
        # task b's final row cell on this diagonal: r = rows[b], c = d - r
        fin_c = d - rows_b  # [B]
        valid_fin = (fin_c >= 1) & (fin_c <= cols_b)
        idx = rows_b[:, None].astype(i32)
        fs_all = (
            jnp.take_along_axis(ms_score, idx, axis=1)[:, 0],
            jnp.take_along_axis(del_score, idx, axis=1)[:, 0],
            jnp.take_along_axis(ins_score, idx, axis=1)[:, 0],
        )
        # track per-state best (score, col) with strict > so the smallest
        # col wins ties within a state; states combine at the end in
        # state-major order (reference's scan order, :847-856)
        new_best = []
        for state in range(3):
            bs, bc = best[state]
            fs = fs_all[state]
            cand = valid_fin & (fs > bs)
            new_best.append(
                (jnp.where(cand, fs, bs), jnp.where(cand, fin_c, bc))
            )
        new_best = tuple(new_best)
        new_prev1 = (ms_score, ms_time, del_score, del_time, ins_score, ins_time)
        if traceback:
            # predecessor-state plane: 2 bits per state (fill-time picks are
            # identical to traceback2's recompute, :1190-1244)
            ms_prev = jnp.where(pick_ms, 0, jnp.where(pick_d, 1, 2)).astype(jnp.uint8)
            del_prev = jnp.where(d_pick_ms, 0, 1).astype(jnp.uint8)
            ins_prev = jnp.where(i_pick_ms, 0, 2).astype(jnp.uint8)
            plane = ms_prev | (del_prev << 2) | (ins_prev << 4)
        else:
            plane = jnp.zeros((1,), jnp.uint8)  # dummy
        return ((new_prev1, (p1_ms_s, p1_ms_t, p1_del_s, p1_del_t, p1_ins_s, p1_ins_t), new_best), plane)

    best0 = tuple(
        (jnp.full(B, NEG_BIG, i32), jnp.full(B, -1, i32)) for _ in range(3)
    )
    carry = (prev1, prev2, best0)
    ds = jnp.arange(2, R + Cc + 1, dtype=i32)
    (final_prev1, _, best), planes = jax.lax.scan(step, carry, ds)
    # combine states in state-major order with strict > (reference order)
    bs, bc = best[0]
    bst = jnp.where(bc >= 0, 0, -1)
    for state in (1, 2):
        s, c2 = best[state]
        take = s > bs
        bs = jnp.where(take, s, bs)
        bc = jnp.where(take, c2, bc)
        bst = jnp.where(take, state, bst)
    if traceback:
        return bs, bc, bst, planes
    return bs, bc, bst


def _shift_row(x):
    """x[..., r] -> x[..., r-1] (index 0 filled with NEG_BIG-safe zeros)."""
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (1,), 0, x.dtype), x[..., :-1]], axis=-1
    )


def msa_fill_batch(reads, read_lens, refs, ref_lens, min_score, prune=True):
    """Host wrapper: prepares limits and calls the kernel.

    min_score: int array [B] (raw, before MIN_SCORE_ADJUST) for prune mode.
    Per-task dispatch to unlimited happens on the host (reference :137).
    Returns (max_score, max_col, max_state) numpy arrays; tasks where
    prune-mode found nothing get max_score < min_score (caller filters).
    """
    B, R = reads.shape
    Cc = refs.shape[1]
    if prune:
        ms = np.asarray(min_score, dtype=np.int64) - C.MIN_SCORE_ADJUST
    else:
        ms = np.zeros(B, dtype=np.int64)
    vert, horiz, floor, subfloor = prepare_limits_np(
        reads, read_lens, refs, ref_lens, ms
    )
    if not prune:
        maxgain = (read_lens.astype(np.int64) - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
        subfloor = -2 * maxgain
    out = msa_fill(
        R,
        Cc,
        prune,
        False,
        jnp.asarray(reads),
        jnp.asarray(read_lens.astype(np.int32)),
        jnp.asarray(refs),
        jnp.asarray(ref_lens.astype(np.int32)),
        jnp.asarray(vert.astype(np.int32)),
        jnp.asarray(horiz.astype(np.int32)),
        jnp.asarray(floor.astype(np.int32)),
        jnp.asarray(subfloor.astype(np.int32)),
    )
    return tuple(np.asarray(x) for x in out)


@partial(jax.jit, static_argnames=("R", "Cc"))
def msa_walk(R: int, Cc: int, planes, read_lens, max_col, max_state):
    """Device traceback walk (traceback2, :1167-1266).

    planes: uint8 [D, B, R+1] prevState planes from msa_fill(traceback=True)
    (D = R+Cc-1 diagonals, diagonal d=r+c stored at index d-2).
    Returns ops uint8 [B, R+Cc]: 1=diag, 2=del, 3=ins, 4=X-tail, 0=none,
    in WALK order (end of alignment first; caller reverses).
    """
    B = planes.shape[1]
    STEPS = R + Cc
    i32 = jnp.int32

    def step(carry, _):
        row, col, state, pos, done, ops_dummy = carry
        d = row + col
        # fetch this cell's prevState plane: planes[d-2, b, row]
        didx = jnp.clip(d - 2, 0, planes.shape[0] - 1)
        cell = planes[didx, jnp.arange(B), jnp.clip(row, 0, R)]
        prev_ms = (cell & 3).astype(i32)
        prev_del = ((cell >> 2) & 3).astype(i32)
        prev_ins = ((cell >> 4) & 3).astype(i32)
        active = ~done & (row > 0) & (col > 0)
        op = jnp.where(
            state == 0, 1, jnp.where(state == 1, 2, 3)
        ).astype(jnp.uint8)
        nxt_state = jnp.where(
            state == 0, prev_ms, jnp.where(state == 1, prev_del, prev_ins)
        )
        nrow = jnp.where(state == 1, row, row - 1)  # DEL keeps row
        ncol = jnp.where(state == 2, col, col - 1)  # INS keeps col
        # X tail: row>0 after col hit 0 (:1261-1272): emit X, row--, col--
        tail = ~done & ~active & (row > 0) & (col != row)
        op = jnp.where(tail, jnp.uint8(4), jnp.where(active, op, jnp.uint8(0)))
        emit = active | tail
        row = jnp.where(active, nrow, jnp.where(tail, row - 1, row))
        col = jnp.where(active, ncol, jnp.where(tail, col - 1, col))
        state = jnp.where(active, nxt_state, state)
        done = done | (~active & ~tail)
        pos_out = jnp.where(emit, pos, -1)
        pos = jnp.where(emit, pos + 1, pos)
        return (row, col, state, pos, done, ops_dummy), (op, pos_out)

    init = (
        read_lens.astype(i32),
        max_col.astype(i32),
        max_state.astype(i32),
        jnp.zeros(B, i32),
        jnp.zeros(B, bool),
        jnp.zeros(B, jnp.uint8),
    )
    (_, _, _, nsteps, _, _), (ops, positions) = jax.lax.scan(
        step, init, None, length=STEPS
    )
    return jnp.moveaxis(ops, 0, 1), nsteps  # [B, STEPS] walk-order


def match_strings_np(ops, nsteps, reads, read_lens, refs, ref_lens, max_col):
    """Render match strings from walk ops (host, vectorized over steps).

    Returns list[bytes] per task, in alignment (left-to-right) order, and
    the alignment's reference start column (0-based within the window).
    """
    ops = np.asarray(ops)
    nsteps = np.asarray(nsteps)
    B, S = ops.shape
    # reverse each walk into alignment order
    out = [bytearray() for _ in range(B)]
    row = read_lens.astype(np.int64).copy()
    col = np.asarray(max_col, dtype=np.int64).copy()
    chars = np.zeros((B, S), dtype=np.uint8)
    rows_at = np.zeros((B, S), dtype=np.int64)
    cols_at = np.zeros((B, S), dtype=np.int64)
    for sstep in range(S):
        o = ops[:, sstep]
        rows_at[:, sstep] = row
        cols_at[:, sstep] = col
        row = np.where((o == 1) | (o == 3) | (o == 4), row - 1, row)
        col = np.where((o == 1) | (o == 2) | (o == 4), col - 1, col)
    rowsB = np.arange(B)[:, None]
    rd = reads[rowsB, np.clip(rows_at - 1, 0, reads.shape[1] - 1)]
    rf = refs[rowsB, np.clip(cols_at - 1, 0, refs.shape[1] - 1)]
    eq = rd == rf
    # reference: c==r -> 'm' (including N==N); else undefined -> 'N',
    # else 'S' (traceback2 :1201-1214). Code-equality over ACGTN inputs
    # matches byte-equality.
    diag_char = np.where(
        eq, ord("m"), np.where((rd >= 4) | (rf >= 4), ord("N"), ord("S"))
    )
    ins_char = np.where(
        cols_at == 0, ord("X"),
        np.where(cols_at >= ref_lens[:, None] + 1, ord("Y"), ord("I")),
    )
    chars = np.where(
        ops == 1, diag_char,
        np.where(ops == 2, ord("D"),
                 np.where(ops == 3, ins_char,
                          np.where(ops == 4, ord("X"), 0))),
    ).astype(np.uint8)
    result = []
    for b in range(B):
        n = int(nsteps[b])
        result.append(bytes(chars[b, :n][::-1]))
    return result


def realign_batch(reads, read_lens, refs, ref_lens):
    """Full-alignment helper (the var2/Realigner use-case): glocal MSA of
    each read against its padded reference window, with traceback.

    Returns (match_strings list[bytes], start_cols int array, scores).
    start_col is the window column where the alignment begins.
    """
    import jax.numpy as jnp

    reads = np.asarray(reads, np.uint8)
    refs = np.asarray(refs, np.uint8)
    read_lens = np.asarray(read_lens, np.int32)
    ref_lens = np.asarray(ref_lens, np.int32)
    B, R = reads.shape
    Cc = refs.shape[1]
    ms = np.zeros(B, dtype=np.int64)
    vert, horiz, floor, subfloor = prepare_limits_np(
        reads, read_lens, refs, ref_lens, ms
    )
    maxgain = (read_lens.astype(np.int64) - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
    subfloor = -2 * maxgain
    score, max_col, max_state, planes = msa_fill(
        R, Cc, False, True,
        jnp.asarray(reads), jnp.asarray(read_lens),
        jnp.asarray(refs), jnp.asarray(ref_lens),
        jnp.asarray(vert), jnp.asarray(horiz),
        jnp.asarray(floor.astype(np.int32)),
        jnp.asarray(subfloor.astype(np.int32)),
    )
    ops, nsteps = msa_walk(
        R, Cc, planes, jnp.asarray(read_lens),
        jnp.asarray(max_col), jnp.asarray(max_state),
    )
    ops = np.asarray(ops)
    nsteps = np.asarray(nsteps)
    score = np.asarray(score)
    max_col = np.asarray(max_col)
    matches = match_strings_np(
        ops, nsteps, reads, read_lens, refs, ref_lens, max_col
    )
    start_cols = np.empty(B, dtype=np.int64)
    for b in range(B):
        m = matches[b]
        ndiag = sum(m.count(x) for x in (b"m", b"S", b"N", b"D"))
        start_cols[b] = int(max_col[b]) - ndiag
    return matches, start_cols, score
