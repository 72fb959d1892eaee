// The spline coupling kernels' geometry on the block row-tile engine
// (coupling_tile.cuh), shared by spline.cu and spline_bwd.cu: the output
// layer's chunks of whole dims and the forward's schedule of products.
#pragma once
#include <cuda_runtime.h>

#include "coupling_common.cuh"
#include "coupling_tile.cuh"

namespace {

// Raw parameters a transformed dim, and the whole dims of an output chunk.
__host__ __device__ inline int spline_params(int lrs, int K) { return (lrs ? 4 : 3) * K - 1; }
__host__ __device__ inline int chunk_dims(int P) { return kChunkN / P; }
__host__ __device__ inline int spline_chunks(int l, int d, int P) {
  const int nd = chunk_dims(P);
  return (d - cond_size(l, d) + nd - 1) / nd;
}

// Output chunks whose splines a block of R rows runs at once: at R=8 one
// chunk holds only 40 (RQS) or 32 (LRS) spline evaluations for 256 threads,
// so eight chunks are produced into a group buffer (R x 8 x 128 floats)
// before their splines run together; from R=32 on a chunk fills the block.
__host__ __device__ constexpr int chunk_group(int rows) { return rows == 8 ? 8 : 1; }
__host__ __device__ inline size_t group_floats(int rows) {
  return chunk_group(rows) > 1 ? (size_t)rows * chunk_group(rows) * kChunkN : 0;
}

// Shared bytes of a spline kernel's block: the engine's layout
// (tile_shared_bytes) and the group buffer.
inline size_t spline_shared_bytes(int rows, int stages, int d, int H) {
  return tile_shared_bytes(rows, stages, d, H) + group_floats(rows) * sizeof(float);
}

// The weights of the forward's products, in the order of application: per
// layer W1 (da, H), W2 (H, H), then W3 one chunk of nd whole dims (nd P
// columns) at a time. spline_bwd.cu's recompute runs the same.
struct SplineForwardSchedule {
  const float* wts;
  int d, H, L, P, inverse;

  // Products of layer step (in the order of application) and of the stack.
  __host__ __device__ int count(int step) const {
    return 2 + spline_chunks(inverse ? L - 1 - step : step, d, P);
  }
  __host__ __device__ int total() const {
    int n = 0;
    for (int step = 0; step < L; ++step) n += count(step);
    return n;
  }
  __device__ Gemm operator()(int q) const {
    int step = 0;
    while (step + 1 < L && q >= count(step)) q -= count(step++);
    const int l = inverse ? L - 1 - step : step;
    const int da = cond_size(l, d), n_out = P * (d - da);
    const float* w1 = wts + layer_offset(l, d, H, P);
    const float* w2 = w1 + (size_t)da * H + H;
    if (q == 0) return Gemm{w1, da, H, false};
    if (q == 1) return Gemm{w2, H, H, false};
    const int c0 = (q - 2) * chunk_dims(P) * P;
    return Gemm{w2 + (size_t)H * H + H + c0, H, min(chunk_dims(P) * P, n_out - c0), false, n_out};
  }
};

}  // namespace
