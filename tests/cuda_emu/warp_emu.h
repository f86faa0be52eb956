// Host emulation of the CUDA warp primitives the kernels in
// bbtools_tpu/ops/cuda use: each warp runs as 32 threads that meet at a
// barrier for every shuffle. Lets the CPU tests run a kernel's own source
// against the XLA reference where there is no GPU.
#pragma once

#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>

struct EmuDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local EmuDim3 threadIdx, blockIdx;

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  long long slot[32];
};
inline thread_local Warp* warp = nullptr;
inline thread_local int lane = 0;

template <class T>
T exchange(T v, int src, bool take) {
  warp->slot[lane] = static_cast<long long>(v);
  warp->bar.arrive_and_wait();
  const T r = take ? static_cast<T>(warp->slot[src]) : v;
  warp->bar.arrive_and_wait();
  return r;
}

// Runs kernel(args...) over `blocks` blocks of `warps` warps, one warp at
// a time.
template <class F>
void launch(int blocks, int warps, F kernel) {
  for (int bx = 0; bx < blocks; ++bx) {
    for (int w = 0; w < warps; ++w) {
      Warp wp;
      std::vector<std::thread> ts;
      for (int l = 0; l < 32; ++l) {
        ts.emplace_back([&, l] {
          warp = &wp;
          lane = l;
          threadIdx.x = w * 32 + l;
          blockIdx.x = bx;
          kernel();
        });
      }
      for (auto& t : ts) t.join();
    }
  }
}
}  // namespace emu

template <class T>
T __shfl_up_sync(unsigned, T v, int delta) {
  return emu::exchange(v, emu::lane - delta, emu::lane >= delta);
}

template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return emu::exchange(v, src, true);
}
