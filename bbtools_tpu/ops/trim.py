"""Quality trimming — batched exact port of the reference semantics.

Replicates shared/TrimRead.java `testOptimal` (:348-400): a Kadane
maximum-subarray over delta = avgErrorRate - P_err(base), accumulated in
float32 with reset-to-0, tie-break preferring the longer run; the winning
run is kept and everything outside it trimmed. Reads with no positive run
trim everything (left=0, right=len).

Float32 accumulation order matters for bit-parity, so the device version is
a `lax.scan` along the read (batched over the read axis) rather than a
cumsum reformulation — the scan reproduces the sequential rounding exactly
and still vectorizes across the batch.

N semantics: a base takes nprob = max(min(avg*1.1, 1), 0.75) when the raw
byte is 'N' or q < 1 (TrimRead.java:364,377).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.qualtools import PROB_ERROR

NPROB = np.float32(0.75)


def _nprob(avg_error_rate: float) -> np.float32:
    return np.float32(max(min(np.float32(avg_error_rate) * np.float32(1.1), 1.0), NPROB))


def optimal_trim_np(
    quals: np.ndarray,
    lengths: np.ndarray,
    is_n: np.ndarray,
    avg_error_rate: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Host oracle; returns (left, right) trim counts per read.

    quals uint8 [B, L]; is_n bool [B, L] (raw byte == 'N'); lengths [B].
    """
    B, L = quals.shape
    avg = np.float32(avg_error_rate)
    nprob = _nprob(avg_error_rate)
    left = np.zeros(B, dtype=np.int32)
    right = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(lengths[b])
        score = np.float32(0)
        max_score = np.float32(0)
        count = 0
        max_count = -1
        max_loc = -1
        for i in range(n):
            q = quals[b, i]
            pe = nprob if (is_n[b, i] or q < 1) else PROB_ERROR[q]
            delta = np.float32(avg - pe)
            score = np.float32(score + delta)
            if score > 0:
                count += 1
                if score > max_score or (score == max_score and count > max_count):
                    max_score = score
                    max_count = count
                    max_loc = i
            else:
                score = np.float32(0)
                count = 0
        if max_score > 0:
            left[b] = max_loc - max_count + 1
            right[b] = n - max_loc - 1
        else:
            left[b] = 0
            right[b] = n
    return left, right


def optimal_trim_jnp(quals, lengths, is_n, avg_error_rate: float):
    """Device version: lax.scan over positions, batched over reads.

    Returns (left, right) int32 [B].
    """
    B, L = quals.shape
    avg = jnp.float32(np.float32(avg_error_rate))
    nprob = jnp.float32(_nprob(avg_error_rate))
    prob_err = jnp.asarray(PROB_ERROR)
    q = jnp.minimum(quals.astype(jnp.int32), 127)
    pe = jnp.where(is_n | (q < 1), nprob, prob_err[q])
    delta = (avg - pe).astype(jnp.float32)  # [B, L]
    active = jnp.arange(L)[None, :] < lengths[:, None]  # [B, L]

    def step(carry, xs):
        score, count, max_score, max_count, max_loc = carry
        d, act, i = xs
        new_score = (score + d).astype(jnp.float32)
        pos = new_score > 0
        new_count = jnp.where(pos, count + 1, 0)
        better = pos & (
            (new_score > max_score)
            | ((new_score == max_score) & (new_count > max_count))
        )
        ms = jnp.where(better, new_score, max_score)
        mc = jnp.where(better, new_count, max_count)
        ml = jnp.where(better, i, max_loc)
        new_score = jnp.where(pos, new_score, jnp.float32(0))
        # padding positions leave everything unchanged
        out = (
            jnp.where(act, new_score, score),
            jnp.where(act, new_count, count),
            jnp.where(act, ms, max_score),
            jnp.where(act, mc, max_count),
            jnp.where(act, ml, max_loc),
        )
        return out, None

    init = (
        jnp.zeros(B, jnp.float32),
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.float32),
        jnp.full(B, -1, jnp.int32),
        jnp.full(B, -1, jnp.int32),
    )
    xs = (
        jnp.moveaxis(delta, 1, 0),
        jnp.moveaxis(active, 1, 0),
        jnp.arange(L, dtype=jnp.int32),
    )
    (score, count, max_score, max_count, max_loc), _ = jax.lax.scan(
        step, init, xs
    )
    found = max_score > 0
    left = jnp.where(found, max_loc - max_count + 1, 0).astype(jnp.int32)
    right = jnp.where(found, lengths - max_loc - 1, lengths).astype(jnp.int32)
    return left, right


def force_trim_amounts(
    lengths: np.ndarray, ftl: int, ftr: int, ftr2: int, ftm: int
):
    """Force-trim left/right amounts (jgi/BBDuk force-trim flags).

    ftl: first kept index; ftr: last kept index (0 disables when <0);
    ftr2: trim this many from the right; ftm: trim right so len % ftm == 0.
    Returns (left_amount, right_amount) per read (numpy or jnp arrays).
    """
    xp = jnp if hasattr(lengths, "device") else np
    left = xp.zeros_like(lengths)
    right = xp.zeros_like(lengths)
    if ftl > 0:
        left = xp.full_like(lengths, ftl)
    if ftr >= 0:
        right = xp.maximum(right, lengths - 1 - ftr)
    if ftr2 > 0:
        right = xp.maximum(right, xp.full_like(lengths, ftr2))
    if ftm > 0:
        right = xp.maximum(right, lengths % ftm)
    right = xp.minimum(right, lengths)
    left = xp.minimum(left, lengths)
    return left, right


def apply_trim(batch, left: np.ndarray, right: np.ndarray):
    """Materialize per-read (left, right) trims on a host ReadBatch: shifts
    rows left and shrinks lengths. Returns a new ReadBatch (shared ids)."""
    from ..io.batch import ReadBatch

    B, L = batch.bases.shape
    left = np.asarray(left, dtype=np.int64)
    right = np.asarray(right, dtype=np.int64)
    new_len = np.maximum(batch.lengths - left - right, 0).astype(np.int32)
    idx = left[:, None] + np.arange(L, dtype=np.int64)[None, :]
    np.minimum(idx, L - 1, out=idx)
    rows = np.arange(B)[:, None]
    mask = np.arange(L)[None, :] >= new_len[:, None]
    bases = batch.bases[rows, idx]
    bases[mask] = 4
    quals = None
    if batch.quals is not None:
        quals = batch.quals[rows, idx]
        quals[mask] = 0
    ascii_b = None
    if batch.ascii_bases is not None:
        ascii_b = batch.ascii_bases[rows, idx]
        ascii_b[mask] = ord("N")
    return ReadBatch(
        bases=bases,
        quals=quals,
        lengths=new_len,
        ids=batch.ids,
        ordinal=batch.ordinal,
        numeric_id0=batch.numeric_id0,
        ascii_bases=ascii_b,
    )
