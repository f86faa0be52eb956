// XLA FFI binding of the warp-per-alignment MSA fill (msa_fill.cuh).
// Built for sm_90a by ops/msa_cuda.py at first use.

#include <cuda_runtime.h>

#include <string>

#include "msa_fill.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

template <int RPL>
static void launch(cudaStream_t stream, const uint8_t* reads,
                   const int32_t* read_lens, const uint8_t* refs,
                   const int32_t* ref_lens, const int32_t* col0, int B, int R,
                   int Cc, int32_t* s, int32_t* c, int32_t* st,
                   uint8_t* planes) {
  const int blocks = (B + msa::kWarpsPerBlock - 1) / msa::kWarpsPerBlock;
  msa::msa_fill_kernel<RPL><<<blocks, 32 * msa::kWarpsPerBlock, 0, stream>>>(
      reads, read_lens, refs, ref_lens, col0, B, R, Cc, s, c, st, planes);
}

static ffi::Error MsaFillImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> reads,
                              ffi::Buffer<ffi::S32> read_lens,
                              ffi::Buffer<ffi::U8> refs,
                              ffi::Buffer<ffi::S32> ref_lens,
                              ffi::Buffer<ffi::S32> col0,
                              ffi::ResultBuffer<ffi::S32> score,
                              ffi::ResultBuffer<ffi::S32> col,
                              ffi::ResultBuffer<ffi::S32> state,
                              ffi::ResultBuffer<ffi::U8> planes) {
  const auto rd = reads.dimensions();
  const auto rf = refs.dimensions();
  if (rd.size() != 2 || rf.size() != 2 || rd[0] != rf[0]) {
    return ffi::Error::InvalidArgument("msa_fill: reads [B,R], refs [B,Cc]");
  }
  const int B = static_cast<int>(rd[0]);
  const int R = static_cast<int>(rd[1]);
  const int Cc = static_cast<int>(rf[1]);
  if (B == 0) return ffi::Error::Success();
  const int rpl = (R + 1 + 31) / 32;
  auto args = [&](auto f) {
    f(stream, reads.typed_data(), read_lens.typed_data(), refs.typed_data(),
      ref_lens.typed_data(), col0.typed_data(), B, R, Cc,
      score->typed_data(), col->typed_data(), state->typed_data(),
      planes->typed_data());
  };
  switch (rpl) {
    case 1: args(launch<1>); break;
    case 2: args(launch<2>); break;
    case 3: args(launch<3>); break;
    case 4: args(launch<4>); break;
    case 5: args(launch<5>); break;
    case 6: args(launch<6>); break;
    case 7: args(launch<7>); break;
    case 8: args(launch<8>); break;
    default:
      return ffi::Error::InvalidArgument(
          "msa_fill: read width " + std::to_string(R) + " exceeds 255");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("msa_fill launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(BbtMsaFill, MsaFillImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>());
