// Host emulation of the small subset of CUDA that nfmc_torch/csrc/*.cu use,
// so that the kernels compile as C++ with g++ and run on the CPU in
// tests/test_torch_kernels_host.py. A launch runs one std::thread per CUDA
// thread of a block, and these walk the blocks in turn; __syncwarp is a
// barrier of the warp's 32 threads, __syncthreads one of the block's, and a
// warp shuffle goes through a per-warp exchange array between two such
// barriers. Shared memory is one buffer, filled with garbage before each
// block starts. cp.async copies are synchronous. The device reports 2 SMs,
// and each launch's grid is logged (emu_grid_x).
//
// The test rewrites two spellings of a .cu source before compiling it:
// `extern __shared__ float smem[];` becomes a pointer to that buffer, and
// `kernel<<<grid, block, smem, stream>>>(args)` becomes
// `emu_launch(EmuCfg{grid, block, smem, stream}, kernel, args)`.
#pragma once
#include <math.h>
#include <stddef.h>
#include <string.h>

#include <algorithm>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaErrorInvalidConfiguration = 9
};
enum { cudaDevAttrMultiProcessorCount = 16 };

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __shared__ static  // blocks run one at a time
#define __ldg(p) (*(p))

inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline char* emu_smem = nullptr;
inline std::barrier<>* emu_warp_bar[64];
inline std::barrier<>* emu_block_bar = nullptr;
inline float emu_xchg[64][32];

inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_xchg[w][l] = v;
  __syncwarp();
  const float r = emu_xchg[w][l ^ off];
  __syncwarp();
  return r;
}
template <class A, class B>
inline auto min(A a, B b) {
  return a < b ? a : b;
}
template <class A, class B>
inline auto max(A a, B b) {
  return a > b ? a : b;
}
template <class F>
inline int cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline int cudaGetLastError() { return cudaSuccess; }
// cp.async as synchronous copies: a copy lands when it is issued, so
// committing and waiting are no-ops.
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) { memcpy(dst, src, n); }
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// A card of 2 SMs: launchers that size their blocks by the SM count reach
// their larger row tiles at a few hundred rows.
inline int cudaDeviceGetAttribute(int* value, int attr, int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? 2 : 0;
  return cudaSuccess;
}

// grid.x of each launch since the caller last set emu_launches to 0 (the
// first 16), for the tests to read the block counts a launcher chose.
extern "C" {
unsigned emu_grid_x[16];
int emu_launches = 0;
}

struct EmuCfg {
  dim3 grid;
  dim3 block;
  size_t smem;
  cudaStream_t stream;
};

template <class F, class... Args>
void emu_launch(EmuCfg c, F kernel, Args... args) {
  const unsigned nt = c.block.x;
  if (emu_launches < 16) emu_grid_x[emu_launches] = c.grid.x;
  ++emu_launches;
  std::vector<char> smem(c.smem + 16);
  emu_smem = smem.data();
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  for (unsigned w = 0; w < nt / 32; ++w) {
    bars.emplace_back(new std::barrier<>(32));
    emu_warp_bar[w] = bars.back().get();
  }
  std::barrier<> block_bar(nt);
  emu_block_bar = &block_bar;
  // one thread per CUDA thread for the whole launch; they walk the blocks
  // together, with a block barrier between blocks
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t, 0, 0);
      for (unsigned by = 0; by < c.grid.y; ++by)
        for (unsigned bx = 0; bx < c.grid.x; ++bx) {
          blockIdx = dim3(bx, by, 0);
          if (t == 0) std::fill(smem.begin(), smem.end(), 0x7f);
          block_bar.arrive_and_wait();
          kernel(args...);
          block_bar.arrive_and_wait();
        }
    });
  for (auto& t : threads) t.join();
}
