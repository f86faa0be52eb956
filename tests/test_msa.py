import numpy as np
import pytest

from bbtools_tpu.ops import msa_constants as C
from bbtools_tpu.ops.msa import msa_fill_batch
from bbtools_tpu.ops.msa_oracle import fill_limited, fill_unlimited

rng = np.random.default_rng(31337)


def make_task(R=40, pad_r=72, pad_c=112, sub=0.05, ins=0.0, dele=0.0, flank=8):
    """Read drawn from a ref window with mutations; returns padded arrays."""
    ref_len = R + 2 * flank
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    read = ref[flank : flank + R].copy()
    # substitutions
    m = rng.random(R) < sub
    read[m] = (read[m] + rng.integers(1, 4, m.sum())) % 4
    # single indel events
    if ins > 0 and rng.random() < ins * 10:
        p = int(rng.integers(5, R - 5))
        read = np.concatenate([read[:p], rng.integers(0, 4, 2).astype(np.uint8), read[p:]])[:R]
    if dele > 0 and rng.random() < dele * 10:
        p = int(rng.integers(5, R - 5))
        read = np.concatenate([read[:p], read[p + 2 :], rng.integers(0, 4, 2).astype(np.uint8)])[:R]
    reads = np.full(pad_r, 0, np.uint8)
    reads[:R] = read
    refs = np.full(pad_c, 0, np.uint8)
    refs[:ref_len] = ref
    return reads, R, refs, ref_len


class TestUnlimited:
    def test_vs_oracle_random(self):
        B = 12
        tasks = [
            make_task(R=30 + 2 * i, sub=0.02 * (i % 4), ins=0.02 * (i % 2), dele=0.02 * ((i // 2) % 2))
            for i in range(B)
        ]
        reads = np.stack([t[0] for t in tasks])
        rlens = np.array([t[1] for t in tasks], np.int32)
        refs = np.stack([t[2] for t in tasks])
        clens = np.array([t[3] for t in tasks], np.int32)
        ms, mc, mst = msa_fill_batch(
            reads, rlens, refs, clens, np.zeros(B, np.int64), prune=False
        )
        for b in range(B):
            _, _, res = (None, None, None)
            sc, tm, res = (
                *fill_unlimited(reads[b, : rlens[b]], refs[b, : clens[b]])[:2],
                fill_unlimited(reads[b, : rlens[b]], refs[b, : clens[b]])[2],
            )
            rows, ocol, ostate, oscore = res
            assert ms[b] == oscore, f"task {b}: {ms[b]} vs {oscore}"
            assert mc[b] == ocol, f"task {b} col: {mc[b]} vs {ocol}"
            assert mst[b] == ostate, f"task {b} state"

    def test_perfect_match_score(self):
        R = 50
        reads, rl, refs, cl = make_task(R=R, sub=0.0)
        ms, mc, mst = msa_fill_batch(
            reads[None], np.array([rl], np.int32), refs[None],
            np.array([cl], np.int32), np.zeros(1, np.int64), prune=False,
        )
        assert ms[0] == C.POINTS_MATCH + (R - 1) * C.POINTS_MATCH2
        assert mst[0] == C.MODE_MS

    def test_with_n_bases(self):
        reads, rl, refs, cl = make_task(R=40, sub=0.0)
        reads[5] = 4  # N in read
        refs[20] = 4  # N in ref
        ms, mc, mst = msa_fill_batch(
            reads[None], np.array([rl], np.int32), refs[None],
            np.array([cl], np.int32), np.zeros(1, np.int64), prune=False,
        )
        _, _, res = fill_unlimited(reads[:rl], refs[:cl])
        assert (ms[0], mc[0], mst[0]) == (res[3], res[1], res[2])


class TestLimited:
    @pytest.mark.parametrize("minratio", [0.4, 0.7])
    def test_vs_oracle(self, minratio):
        B = 10
        tasks = [
            make_task(R=60, pad_r=64, pad_c=96, sub=0.03 * (i % 3), ins=0.01 * (i % 2))
            for i in range(B)
        ]
        reads = np.stack([t[0] for t in tasks])
        rlens = np.array([t[1] for t in tasks], np.int32)
        refs = np.stack([t[2] for t in tasks])
        clens = np.array([t[3] for t in tasks], np.int32)
        maxscore = C.POINTS_MATCH + (rlens.astype(np.int64) - 1) * C.POINTS_MATCH2
        min_score = (maxscore * minratio).astype(np.int64)
        ms, mc, mst = msa_fill_batch(reads, rlens, refs, clens, min_score, prune=True)
        for b in range(B):
            sc, tm, res = fill_limited(
                reads[b, : rlens[b]], refs[b, : clens[b]], int(min_score[b])
            )
            if res is None:
                assert ms[b] < min_score[b] - C.MIN_SCORE_ADJUST, f"task {b}"
            else:
                rows, ocol, ostate, oscore = res
                assert ms[b] == oscore, f"task {b}: {ms[b]} vs {oscore}"
                assert mc[b] == ocol, f"task {b} col"
                assert mst[b] == ostate, f"task {b} state"

    def test_unlimited_vs_limited_consistency(self):
        """On an easy alignment, limited (high floor) and unlimited agree."""
        reads, rl, refs, cl = make_task(R=70, pad_r=72, pad_c=96, sub=0.02)
        # dispatch condition requires cols+rows>=90 and cols<=rows+... here
        # cols+rows = 156 >= 90, cols (86) <= rows+min(170, rows+20) ok
        min_score = np.array([int(0.6 * (C.POINTS_MATCH + (rl - 1) * C.POINTS_MATCH2))], np.int64)
        msl, mcl, mstl = msa_fill_batch(
            reads[None], np.array([rl], np.int32), refs[None],
            np.array([cl], np.int32), min_score, prune=True,
        )
        msu, mcu, mstu = msa_fill_batch(
            reads[None], np.array([rl], np.int32), refs[None],
            np.array([cl], np.int32), np.zeros(1, np.int64), prune=False,
        )
        if msl[0] >= min_score[0] - C.MIN_SCORE_ADJUST:
            assert msl[0] == msu[0]
            assert mcl[0] == mcu[0]


class TestTraceback:
    def test_walk_vs_oracle(self):
        import jax.numpy as jnp

        from bbtools_tpu.ops.msa import (
            match_strings_np,
            msa_fill,
            msa_walk,
            prepare_limits_np,
        )
        from bbtools_tpu.ops.msa_oracle import traceback as oracle_tb

        B = 10
        tasks = [
            make_task(R=40 + i, pad_r=56, pad_c=80, sub=0.04 * (i % 3),
                      ins=0.02 * (i % 2), dele=0.02 * ((i + 1) % 2))
            for i in range(B)
        ]
        reads = np.stack([t[0] for t in tasks])
        rlens = np.array([t[1] for t in tasks], np.int32)
        refs = np.stack([t[2] for t in tasks])
        clens = np.array([t[3] for t in tasks], np.int32)
        R, Cc = reads.shape[1], refs.shape[1]
        ms0 = np.zeros(B, np.int64)
        vert, horiz, floor, subfloor = prepare_limits_np(reads, rlens, refs, clens, ms0)
        maxgain = (rlens.astype(np.int64) - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
        bs, bc, bst, planes = msa_fill(
            R, Cc, False, True,
            jnp.asarray(reads), jnp.asarray(rlens), jnp.asarray(refs),
            jnp.asarray(clens), jnp.asarray(vert.astype(np.int32)),
            jnp.asarray(horiz.astype(np.int32)),
            jnp.asarray(floor.astype(np.int32)),
            jnp.asarray((-2 * maxgain).astype(np.int32)),
        )
        ops, nsteps = msa_walk(R, Cc, planes, jnp.asarray(rlens), bs if False else bc, bst)
        matches = match_strings_np(
            np.asarray(ops), np.asarray(nsteps), reads, rlens, refs, clens,
            np.asarray(bc),
        )
        for b in range(B):
            sc, tm, res = fill_unlimited(reads[b, : rlens[b]], refs[b, : clens[b]])
            rows, ocol, ostate, oscore = res
            want = oracle_tb(
                sc, tm, reads[b, : rlens[b]], refs[b, : clens[b]], rows, ocol, ostate
            )
            assert matches[b] == want, f"task {b}:\n{matches[b]}\n{want}"
            # sanity: ops consume the whole read
            ndiag = want.count(b"m") + want.count(b"S") + want.count(b"N")
            nins = want.count(b"I") + want.count(b"X") + want.count(b"Y")
            assert ndiag + nins == rlens[b]


def _dp_inputs(B, R, Cc, seed, n_rate=0.0, repeat=False):
    """Reads drawn from their windows with substitutions, indels and
    (optionally) N calls, lengths spread over [R//2, R]. With repeat the
    window's second half copies its first, so two columns tie."""
    g = np.random.default_rng(seed)
    refs = g.integers(0, 4, (B, Cc)).astype(np.uint8)
    if repeat:
        h = Cc // 2
        refs[:, h : 2 * h] = refs[:, :h]
    reads = np.full((B, R), 4, np.uint8)
    rlens = g.integers(R // 2, R + 1, B).astype(np.int32)
    for b in range(B):
        rl = int(rlens[b])
        src = list(refs[b, 3 : 3 + rl + 8])
        if b % 3 == 1:
            del src[rl // 2 : rl // 2 + 3]  # deletion in the read
        elif b % 3 == 2:
            src[rl // 3 : rl // 3] = [0, 1, 2]  # insertion in the read
        row = np.array(src[:rl], np.uint8)
        m = g.random(rl) < 0.06
        row[m] = (row[m] + g.integers(1, 4, m.sum())) % 4
        row[g.random(rl) < n_rate] = 4
        reads[b, :rl] = row
    refs[g.random((B, Cc)) < n_rate] = 4
    return reads, rlens, refs


def _xla_fill_tb(R, Cc, reads, rlens, refs):
    import jax.numpy as jnp

    from bbtools_tpu.ops import msa_constants as C
    from bbtools_tpu.ops.msa import msa_fill, prepare_limits_np

    B = len(rlens)
    clens = np.full(B, Cc, np.int32)
    vert, horiz, floor, _ = prepare_limits_np(
        reads, rlens, refs, clens, np.zeros(B, np.int64)
    )
    maxgain = (rlens.astype(np.int64) - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
    out = msa_fill(
        R, Cc, False, True,
        jnp.asarray(reads), jnp.asarray(rlens), jnp.asarray(refs),
        jnp.asarray(clens),
        jnp.asarray(vert.astype(np.int32)), jnp.asarray(horiz.astype(np.int32)),
        jnp.asarray(floor.astype(np.int32)),
        jnp.asarray((-2 * maxgain).astype(np.int32)),
    )
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("B,R,Cc", [(8, 48, 80), (5, 20, 60), (4, 151, 175)])
def test_msa_fill_tb_plane_layout_matches_fill(B, R, Cc):
    """The wrapper's in-graph limits, dtypes and plane layout reproduce
    msa_fill(prune=False, traceback=True) given host-prepared limits."""
    from bbtools_tpu.ops.msa_cuda import msa_fill_tb

    reads, rlens, refs = _dp_inputs(B, R, Cc, seed=B + R, n_rate=0.02)
    want = _xla_fill_tb(R, Cc, reads, rlens, refs)
    got = [np.asarray(x) for x in msa_fill_tb(R, Cc, reads, rlens, refs)]
    assert got[3].shape == (R + Cc - 1, B, R + 1) and got[3].dtype == np.uint8
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


@pytest.fixture(scope="module")
def msa_emu_lib(tmp_path_factory):
    """The CUDA kernel's own source compiled for the host against the
    warp emulation in tests/cuda_emu."""
    import ctypes
    import os
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    kdir = os.path.join(os.path.dirname(here), "bbtools_tpu", "ops", "cuda")
    so = str(tmp_path_factory.mktemp("emu") / "msa_emu.so")
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", "-I", kdir,
         "-I", os.path.join(here, "cuda_emu"),
         os.path.join(here, "cuda_emu", "msa_fill_emu.cpp"), "-o", so],
        check=True,
    )
    return ctypes.CDLL(so)


def _emu_fill(lib, R, Cc, reads, rlens, refs):
    import ctypes

    from bbtools_tpu.ops.msa import col0_scores

    B = len(rlens)
    reads = np.ascontiguousarray(reads, np.uint8)
    refs = np.ascontiguousarray(refs, np.uint8)
    rlens = np.ascontiguousarray(rlens, np.int32)
    clens = np.full(B, Cc, np.int32)
    col0 = np.ascontiguousarray(col0_scores(R), np.int32)
    s, c, st = (np.zeros(B, np.int32) for _ in range(3))
    planes = np.zeros((R + Cc - 1, B, R + 1), np.uint8)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    rc = lib.msa_fill_emulate(
        p(reads), p(rlens), p(refs), p(clens), p(col0),
        ctypes.c_int(B), ctypes.c_int(R), ctypes.c_int(Cc),
        p(s), p(c), p(st), p(planes),
    )
    assert rc == 0
    return [s, c, st, planes]


@pytest.mark.parametrize(
    "B,R,Cc,n_rate,repeat",
    [(4, 20, 40, 0.0, False), (6, 40, 72, 0.03, False),
     (9, 64, 70, 0.0, False), (3, 151, 175, 0.01, False),
     (5, 20, 64, 0.0, True)],
)
def test_cuda_msa_kernel_emulated_matches_fill(msa_emu_lib, B, R, Cc, n_rate,
                                               repeat):
    """ops/cuda/msa_fill.cuh, run over the host warp emulation, is
    bit-equal to the XLA fill on scores, columns, states and every plane
    byte — one, two, three and five rows per lane, B not a multiple of
    the four warps of a block, and tied final-row scores."""
    reads, rlens, refs = _dp_inputs(B, R, Cc, seed=R * Cc, n_rate=n_rate,
                                    repeat=repeat)
    want = _xla_fill_tb(R, Cc, reads, rlens, refs)
    got = _emu_fill(msa_emu_lib, R, Cc, reads, rlens, refs)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize(
    "platform,R,kernel",
    [("cpu", 151, False), ("gpu", 151, True), ("gpu", 255, True),
     ("gpu", 256, False)],
)
def test_msa_kernel_choice(monkeypatch, platform, R, kernel):
    """The CUDA fill runs on the GPU for reads up to 255 bases; longer
    reads and the CPU take the XLA scan."""
    from bbtools_tpu.core import backend
    from bbtools_tpu.ops import msa_cuda

    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert msa_cuda.use_kernel(R) is kernel


@pytest.mark.parametrize(
    "n,want",
    [(1, 8), (8, 8), (9, 32), (32, 32), (33, 64), (64, 64), (65, 128),
     (129, 256)],
)
def test_dp_bucket(n, want):
    from bbtools_tpu.ops.msa_cuda import dp_bucket

    assert dp_bucket(n) == want


@pytest.mark.gpu
@pytest.mark.parametrize("B,R,Cc", [(512, 151, 175), (64, 151, 2223)])
def test_cuda_msa_kernel_on_gpu(gpu, B, R, Cc):
    """The compiled kernel on the card is bit-equal to the XLA fill."""
    import jax

    from bbtools_tpu.ops import msa_cuda

    reads, rlens, refs = _dp_inputs(B, R, Cc, seed=B, n_rate=0.01)
    fill = jax.jit(lambda r, l, f: msa_cuda._fill_cuda(R, Cc, r, l, f))
    got = [np.asarray(x) for x in fill(reads, rlens, refs)]
    for w, g in zip(_xla_fill_tb(R, Cc, reads, rlens, refs), got):
        np.testing.assert_array_equal(w, g)
