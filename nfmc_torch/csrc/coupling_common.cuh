// Pieces shared by the RealNVP coupling kernels (coupling.cu, coupling_bwd.cu):
// the layer sizes, the canonical weight layout and the warp-level dense layer.
#pragma once
#include <cuda_runtime.h>

namespace {

// Layer l conditions on the dims i with (i + l) % 2 == 0.
__host__ __device__ __forceinline__ int cond_size(int l, int d) {
  return (l % 2 == 0) ? (d + 1) / 2 : d / 2;
}

// Offset of layer l's w1 in the canonical packed buffer: per layer w1 (da, H),
// b1 (H), w2 (H, H), b2 (H), w3 (H, 2 db), b3 (2 db), each row-major.
__host__ __device__ inline size_t layer_offset(int l, int d, int H) {
  size_t off = 0;
  for (int m = 0; m < l; ++m) {
    const size_t da = cond_size(m, d);
    const size_t db = d - da;
    off += da * H + H + (size_t)H * H + H + (size_t)H * 2 * db + 2 * db;
  }
  return off;
}

// out[r][j] = tanh(b[j] + sum_k in[r][start + k * step] * W[k][j]) for the
// warp's RPW rows; in and out rows are in shared memory.
template <int RPW>
__device__ void dense_tanh(const float* in_s, int in_stride, int start, int step,
                           int K, const float* __restrict__ W,
                           const float* __restrict__ b, float* out_s, int N,
                           int lane) {
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int j = j0 + lane;
    const bool ok = j < N;
    float acc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = ok ? __ldg(W + (size_t)k * N + j) : 0.f;
      const float* col = in_s + start + k * step;
#pragma unroll
      for (int i = 0; i < RPW; ++i) acc[i] = fmaf(col[i * in_stride], w, acc[i]);
    }
    if (ok) {
      const float bj = __ldg(b + j);
#pragma unroll
      for (int i = 0; i < RPW; ++i) out_s[i * N + j] = tanhf(acc[i] + bj);
    }
  }
}

}  // namespace
