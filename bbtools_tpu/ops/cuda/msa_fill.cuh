// Unpruned MultiStateAligner11ts fill with traceback planes, one warp per
// alignment: the CUDA twin of ops/msa.py msa_fill(prune=False,
// traceback=True), bit-equal to it on every output (scores, columns,
// states and every plane byte, boundary cells included).
//
// Wavefront: diagonal d holds cells (r, c = d - r), r = 0..R. MS reads
// (r-1) on d-2, INS reads (r-1) on d-1, DEL reads (r) on d-1. Lane l owns
// the RPL consecutive rows l*RPL .. l*RPL+RPL-1 and keeps diagonals d-1 and
// d-2 of those rows in registers, so the one-row shift is in-lane except
// for the first row, which comes from lane l-1 through __shfl_up_sync.
// The whole diagonal loop runs inside the kernel: one launch per batch.
//
// Rows are walked from the last to the first within a lane so each row can
// overwrite its own d-1/d-2 registers after reading row-1's old ones.
//
// This header holds only the kernel, so it can also be compiled by a host
// C++ compiler against a warp emulation (tests/cuda_emu).

#pragma once

#include <stdint.h>

namespace msa {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxRowsPerLane = 8;  // R + 1 <= 256

constexpr int NEG_BIG = -(1 << 30);
constexpr int POINTS_NOCALL = 0;
constexpr int POINTS_MATCH = 70;
constexpr int POINTS_MATCH2 = 100;
constexpr int POINTS_SUB = -127;
constexpr int POINTS_SUBR = -147;
constexpr int POINTS_SUB2 = -51;
constexpr int POINTS_SUB3 = -25;
constexpr int POINTS_INS = -395;
constexpr int POINTS_INS2 = -39;
constexpr int POINTS_INS3 = -23;
constexpr int POINTS_INS4 = -8;
constexpr int POINTS_DEL = -472;
constexpr int POINTS_DEL2 = -33;
constexpr int POINTS_DEL3 = -9;
constexpr int POINTS_DEL4 = -1;
constexpr int POINTS_DEL5 = -1;
constexpr int POINTS_DEL_REF_N = -10;
constexpr int MASK5 = 3;
constexpr int BARRIER_I1 = 2;
constexpr int BARRIER_D1 = 3;
constexpr int LIMIT_FOR_COST_3 = 5;
constexpr int LIMIT_FOR_COST_4 = 20;
constexpr int LIMIT_FOR_COST_5 = 80;
constexpr int MAX_TIME = (1 << 11) - 1;

__device__ __forceinline__ int sub_array_cost(int streak) {
  const int i = streak + 1;
  return i > LIMIT_FOR_COST_3 ? POINTS_SUB3 : (i > 1 ? POINTS_SUB2 : POINTS_SUB);
}

__device__ __forceinline__ int ins_array_cost(int streak) {
  const int i = streak + 1;
  return i > LIMIT_FOR_COST_4   ? POINTS_INS4
         : i > LIMIT_FOR_COST_3 ? POINTS_INS3
         : i > 1                ? POINTS_INS2
                                : POINTS_INS;
}

__device__ __forceinline__ int del_ext_cost(int streak) {
  return streak == 0                  ? POINTS_DEL
         : streak < LIMIT_FOR_COST_3  ? POINTS_DEL2
         : streak < LIMIT_FOR_COST_4  ? POINTS_DEL3
         : streak < LIMIT_FOR_COST_5  ? POINTS_DEL4
         : (streak & MASK5) == 0      ? POINTS_DEL5
                                      : 0;
}

__device__ __forceinline__ int clamp_time(int t) {
  return t > MAX_TIME ? MAX_TIME - MASK5 : t;
}

// reads [B, R] u8, read_lens [B], refs [B, Cc] u8, ref_lens [B],
// col0 [R + 1] (column-0 scores). Outputs: score/col/state [B] and
// planes [R + Cc - 1, B, R + 1] u8 (diagonal d at index d - 2).
template <int RPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
msa_fill_kernel(const uint8_t* __restrict__ reads,
                const int32_t* __restrict__ read_lens,
                const uint8_t* __restrict__ refs,
                const int32_t* __restrict__ ref_lens,
                const int32_t* __restrict__ col0, int B, int R, int Cc,
                int32_t* __restrict__ out_score, int32_t* __restrict__ out_col,
                int32_t* __restrict__ out_state, uint8_t* __restrict__ planes) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps only: b is uniform within a warp
  const int W = R + 1;
  const int rows = read_lens[b];
  const int cols = ref_lens[b];
  const int subfloor = -2 * ((rows - 1) * POINTS_MATCH2 + POINTS_MATCH);
  const uint8_t* rd = reads + (size_t)b * R;
  const uint8_t* rf = refs + (size_t)b * Cc;
  const int r0 = lane * RPL;

  int call1[RPL], call0[RPL], c0[RPL];
  // d-1 bank (all six planes) and d-2 bank (the four MS reads)
  int a_ms_s[RPL], a_ms_t[RPL], a_del_s[RPL], a_del_t[RPL], a_ins_s[RPL],
      a_ins_t[RPL];
  int b_ms_s[RPL], b_ms_t[RPL], b_del_s[RPL], b_ins_s[RPL];
  int ref_prev[RPL];  // ref1 of diagonal d-1 == ref0 of diagonal d
  int best_s[3] = {NEG_BIG, NEG_BIG, NEG_BIG};
  int best_c[3] = {-1, -1, -1};

#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = r0 + j;
    call1[j] = r == 0 ? 99 : (r - 1 < R ? (int)rd[r - 1] : 99);
    call0[j] = r < 2 ? 98 : (r - 2 < R ? (int)rd[r - 2] : 98);
    c0[j] = r < W ? col0[r] : 0;
    // diagonal 0: only (0,0) = col0[0]; diagonal 1: (0,1) = 0, (1,0) = col0[1]
    const int s0 = r == 0 ? c0[j] : NEG_BIG;
    const int s1 = r == 1 ? c0[j] : (r == 0 ? 0 : NEG_BIG);
    b_ms_s[j] = b_del_s[j] = b_ins_s[j] = s0;
    b_ms_t[j] = 0;
    a_ms_s[j] = a_del_s[j] = a_ins_s[j] = s1;
    a_ms_t[j] = a_del_t[j] = a_ins_t[j] = 0;
    const int i1 = 1 - r - 1;
    ref_prev[j] = (i1 >= 0 && i1 < Cc) ? (int)rf[i1] : 97;
  }

  for (int d = 2; d <= R + Cc; ++d) {
    // row r0 - 1 lives in the previous lane's last register (0 for row -1)
    int nb_ms_s = __shfl_up_sync(FULL, b_ms_s[RPL - 1], 1);
    int nb_ms_t = __shfl_up_sync(FULL, b_ms_t[RPL - 1], 1);
    int nb_del_s = __shfl_up_sync(FULL, b_del_s[RPL - 1], 1);
    int nb_ins_s = __shfl_up_sync(FULL, b_ins_s[RPL - 1], 1);
    int na_ms_s = __shfl_up_sync(FULL, a_ms_s[RPL - 1], 1);
    int na_ins_s = __shfl_up_sync(FULL, a_ins_s[RPL - 1], 1);
    int na_ins_t = __shfl_up_sync(FULL, a_ins_t[RPL - 1], 1);
    if (lane == 0) {
      nb_ms_s = nb_ms_t = nb_del_s = nb_ins_s = 0;
      na_ms_s = na_ins_s = na_ins_t = 0;
    }
    uint8_t* prow = planes + ((size_t)(d - 2) * B + b) * W;
#pragma unroll
    for (int j = RPL - 1; j >= 0; --j) {
      const int r = r0 + j;
      const int c = d - r;
      const int i1 = c - 1;
      const int ref1 = (i1 >= 0 && i1 < Cc) ? (int)rf[i1] : 97;
      const int ref0 = ref_prev[j];
      ref_prev[j] = ref1;
      const bool match = (call1[j] == ref1) && (ref1 < 4);
      const bool prev_match = (call0[j] == ref0) && (ref0 < 4);
      // --- MS from (r-1, c-1) on d-2 ---
      const int s_diag = j ? b_ms_s[j - 1] : nb_ms_s;
      const int s_del = j ? b_del_s[j - 1] : nb_del_s;
      const int s_ins = j ? b_ins_s[j - 1] : nb_ins_s;
      const int streak = j ? b_ms_t[j - 1] : nb_ms_t;
      int m_sMS;
      if (match) {
        m_sMS = s_diag + (prev_match ? POINTS_MATCH2 : POINTS_MATCH);
      } else if (ref1 < 4 && call1[j] < 4) {
        m_sMS = s_diag + (prev_match ? (streak <= 1 ? POINTS_SUBR : POINTS_SUB)
                                     : sub_array_cost(streak));
      } else {
        m_sMS = s_diag + POINTS_NOCALL;
      }
      const int m_sD = s_del + (match ? POINTS_MATCH : POINTS_SUB);
      const int m_sI = s_ins + (match ? POINTS_MATCH : POINTS_SUB);
      const bool pick_ms = (m_sMS >= m_sD) && (m_sMS >= m_sI);
      const bool pick_d = !pick_ms && (m_sD >= m_sI);
      int ms_score = pick_ms ? m_sMS : (pick_d ? m_sD : m_sI);
      int ms_time =
          pick_ms ? (match ? (prev_match ? streak + 1 : 1)
                           : (prev_match ? 1 : streak + 1))
                  : 1;
      // --- DEL from (r, c-1) on d-1 ---
      const int d_streak = a_del_t[j];
      const int refn = ref1 >= 4 ? POINTS_DEL_REF_N : 0;
      const int d_sMS = a_ms_s[j] + POINTS_DEL + refn;
      const int d_sD = a_del_s[j] + del_ext_cost(d_streak) + refn;
      const bool d_pick = d_sMS >= d_sD;
      int del_score = d_pick ? d_sMS : d_sD;
      int del_time = d_pick ? 1 : d_streak + 1;
      // --- INS from (r-1, c) on d-1 ---
      const int p_ms_s = j ? a_ms_s[j - 1] : na_ms_s;
      const int p_ins_s = j ? a_ins_s[j - 1] : na_ins_s;
      const int i_streak = j ? a_ins_t[j - 1] : na_ins_t;
      const int i_sMS = p_ms_s + POINTS_INS;
      const int i_sI = p_ins_s + ins_array_cost(i_streak);
      const bool i_pick = i_sMS >= i_sI;
      int ins_score = i_pick ? i_sMS : i_sI;
      int ins_time = i_pick ? 1 : i_streak + 1;
      if (r < W) {
        prow[r] = (uint8_t)((pick_ms ? 0 : (pick_d ? 1 : 2)) |
                            ((d_pick ? 0 : 1) << 2) | ((i_pick ? 0 : 2) << 4));
      }
      // --- barriers, time clamp, boundary cells ---
      if (r < BARRIER_D1 || r > rows - BARRIER_D1) {
        del_score = subfloor;
        del_time = 0;
      }
      if ((r < BARRIER_I1 && c > 1) || (r > rows - BARRIER_I1 && c < cols - 1)) {
        ins_score = subfloor;
        ins_time = 0;
      }
      ms_time = clamp_time(ms_time);
      del_time = clamp_time(del_time);
      ins_time = clamp_time(ins_time);
      if (!(r >= 1 && c >= 1)) {
        const int bnd = c == 0 ? c0[j] : (r == 0 ? 0 : NEG_BIG);
        ms_score = del_score = ins_score = bnd;
        ms_time = del_time = ins_time = 0;
      }
      // --- final-row candidates: strict > keeps the smallest column ---
      if (r == rows && c >= 1 && c <= cols) {
        if (ms_score > best_s[0]) { best_s[0] = ms_score; best_c[0] = c; }
        if (del_score > best_s[1]) { best_s[1] = del_score; best_c[1] = c; }
        if (ins_score > best_s[2]) { best_s[2] = ins_score; best_c[2] = c; }
      }
      b_ms_s[j] = a_ms_s[j];
      b_ms_t[j] = a_ms_t[j];
      b_del_s[j] = a_del_s[j];
      b_ins_s[j] = a_ins_s[j];
      a_ms_s[j] = ms_score;
      a_ms_t[j] = ms_time;
      a_del_s[j] = del_score;
      a_del_t[j] = del_time;
      a_ins_s[j] = ins_score;
      a_ins_t[j] = ins_time;
    }
  }

  // the lane that owns row `rows` holds the per-state bests
  const int owner = rows / RPL;
  int bs = __shfl_sync(FULL, best_s[0], owner);
  int bc = __shfl_sync(FULL, best_c[0], owner);
  int bst = bc >= 0 ? 0 : -1;
#pragma unroll
  for (int st = 1; st < 3; ++st) {
    const int s = __shfl_sync(FULL, best_s[st], owner);
    const int c = __shfl_sync(FULL, best_c[st], owner);
    if (s > bs) {
      bs = s;
      bc = c;
      bst = st;
    }
  }
  if (lane == 0) {
    out_score[b] = bs;
    out_col[b] = bc;
    out_state[b] = bst;
  }
}

}  // namespace msa
