// Pieces shared by the coupling kernels (coupling.cu, coupling_bwd.cu,
// spline.cu, spline_bwd.cu): the layer sizes, the canonical weight layout,
// the warp-level dense layer and the fixed-order weight-gradient tile.
#pragma once
#include <cuda_runtime.h>

namespace {

// Layer l conditions on the dims i with (i + l) % 2 == 0.
__host__ __device__ __forceinline__ int cond_size(int l, int d) {
  return (l % 2 == 0) ? (d + 1) / 2 : d / 2;
}

// Offset of layer l's w1 in the canonical packed buffer: per layer w1 (da, H),
// b1 (H), w2 (H, H), b2 (H), w3 (H, P db), b3 (P db), each row-major, with P
// conditioner outputs per transformed dim (2 for the affine coupling).
__host__ __device__ inline size_t layer_offset(int l, int d, int H, int P = 2) {
  size_t off = 0;
  for (int m = 0; m < l; ++m) {
    const size_t da = cond_size(m, d);
    const size_t db = d - da;
    off += da * H + H + (size_t)H * H + H + (size_t)H * P * db + P * db;
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

constexpr int kTile = 32;  // weight-gradient tile, both ways

// One kTile x kTile tile (k tile kt, n tile nt) of gw = A^T G, summed over
// the B rows in a fixed order: no atomics, so reruns are bit-identical.
// Column k of A is element a_off + k * a_step of each row (row stride lda);
// G is (B, N) row-major; gw is (K, N) row-major. The tiles with kt == 0 also
// write G's column sums into gb (the bias gradient). All 256 threads of the
// block call it.
__device__ void weight_grad_tile(const float* __restrict__ A, int lda, int a_off, int a_step,
                                 int K, const float* __restrict__ G, int N, long long B,
                                 float* __restrict__ gw, float* __restrict__ gb, int kt,
                                 int nt) {
  __shared__ float a_s[kTile][kTile + 1];
  __shared__ float g_s[kTile][kTile + 1];
  const int tx = threadIdx.x % 32;  // output column within the tile
  const int ty = threadIdx.x / 32;  // 4 output rows each: ty * 4 ... + 3
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float bacc = 0.f;
  for (long long r0 = 0; r0 < B; r0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += 256) {
      const int rr = e / kTile, cc = e % kTile;
      const long long r = r0 + rr;
      const int k = kt * kTile + cc;
      const int n = nt * kTile + cc;
      a_s[rr][cc] = (r < B && k < K) ? A[r * lda + a_off + (size_t)k * a_step] : 0.f;
      g_s[rr][cc] = (r < B && n < N) ? G[r * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kTile; ++rr) {
      const float g = g_s[rr][tx];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = fmaf(a_s[rr][ty * 4 + c], g, acc[c]);
      bacc += g;
    }
    __syncthreads();
  }
  const int n = nt * kTile + tx;
  if (n < N) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = kt * kTile + ty * 4 + c;
      if (k < K) gw[(size_t)k * N + n] = acc[c];
    }
    if (kt == 0 && ty == 0) gb[n] = bacc;
  }
}

// Tiles of a (K, N) weight gradient.
__host__ __device__ inline int n_tiles(int K, int N) {
  return ((K + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
}

}  // namespace
