// msa_fill_kernel built for the host over warp_emu.h (see test_msa.py).
#include "warp_emu.h"
#include "msa_fill.cuh"

template <int RPL>
static void run(const uint8_t* reads, const int32_t* read_lens,
                const uint8_t* refs, const int32_t* ref_lens,
                const int32_t* col0, int B, int R, int Cc, int32_t* s,
                int32_t* c, int32_t* st, uint8_t* planes) {
  const int blocks = (B + msa::kWarpsPerBlock - 1) / msa::kWarpsPerBlock;
  emu::launch(blocks, msa::kWarpsPerBlock, [&] {
    msa::msa_fill_kernel<RPL>(reads, read_lens, refs, ref_lens, col0, B, R,
                              Cc, s, c, st, planes);
  });
}

extern "C" int msa_fill_emulate(const uint8_t* reads, const int32_t* read_lens,
                                const uint8_t* refs, const int32_t* ref_lens,
                                const int32_t* col0, int B, int R, int Cc,
                                int32_t* s, int32_t* c, int32_t* st,
                                uint8_t* planes) {
  switch ((R + 1 + 31) / 32) {
    case 1: run<1>(reads, read_lens, refs, ref_lens, col0, B, R, Cc, s, c, st, planes); return 0;
    case 2: run<2>(reads, read_lens, refs, ref_lens, col0, B, R, Cc, s, c, st, planes); return 0;
    case 3: run<3>(reads, read_lens, refs, ref_lens, col0, B, R, Cc, s, c, st, planes); return 0;
    case 5: run<5>(reads, read_lens, refs, ref_lens, col0, B, R, Cc, s, c, st, planes); return 0;
    default: return 1;
  }
}
