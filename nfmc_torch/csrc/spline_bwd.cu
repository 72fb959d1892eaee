// The VJP of the spline coupling stack (spline.cu), forward or inverse
// direction, RQS or LRS, as two CUDA kernels.
//
// Replaces the Pallas TPU kernel
// nfmc_tpu/ops/experimental_spline_pallas.py::_kernel_bwd. Given x (B, d), the
// cotangents gy (B, d) of the output and gld (B,) of the log-det, it returns
// gx (B, d) and the gradients of all 6L weights summed over the batch, in the
// canonical packed layout of the weights (per layer w1, b1, w2, b2, w3, b3,
// row-major, W3's columns dim-major; see coupling_common.cuh).
//
// The TPU kernel transposes each layer with an in-kernel jax.vjp. Here the
// spline's VJP is written out by hand (spline_common.cuh::spline_vjp): for
// each transformed element, the cotangents of its input and of its P raw
// parameters, through the bin's knots, the running sums, the softmax floor,
// the softplus of the derivatives and, for LRS, the sigmoid of lambda. The
// log-det's cotangent gld reaches every layer unchanged (the total log-det is
// the sum of the layers'). Per layer, with g_raw the cotangent of the
// conditioner output:
//   g_a2 = (g_raw W3^T) (1 - h2^2)   g_a1 = (g_a2 W2^T) (1 - h1^2)
//   g_va += g_a1 W1^T
//   gW3 = h2^T g_raw, gW2 = h1^T g_a2, gW1 = va^T g_a1, gb = column sums.
//
// As in coupling_bwd.cu the work is split in two, so that the weight
// gradients are summed in a fixed order (no atomics: reruns are
// bit-identical):
//   1. spline_vjp_rows_kernel: each warp owns RPW rows for the whole stack.
//      It recomputes the forward pass, stashing each layer's input, h1, h2
//      and conditioner output in a device scratch buffer, then goes back
//      through the layers, overwriting each stashed conditioner output with
//      its cotangent g_raw and writing g_a2 and g_a1. Row-local work only.
//   2. spline_vjp_weights_kernel: each block computes a 32 x 32 tile of one
//      weight gradient as a sum over the batch rows in a fixed order
//      (coupling_common.cuh::weight_grad_tile).
// The scratch buffer holds, per row and layer, d + 4 H + P db floats: at
// d=100, H=128, L=4 that is 28.5 KB a row for RQS (P=23) and 34.6 KB for LRS
// (P=31), so 7.3 MB and 8.9 MB at the training batch of 256. The caller
// allocates it.
//
// What bounds it on an H100: FP32 arithmetic on paper (the forward's products
// three times over, W3 the widest), but at the training batch of 256 rows it
// is bound by latency: one warp walks each row through every layer serially,
// and only B / 8 blocks exist. Plain FP32 FMAs, accurate expf/logf/sqrtf (no
// fast-math), no tensor cores.
#include <cuda_runtime.h>

#include <algorithm>

#include "coupling_common.cuh"
#include "spline_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block can opt into

// Scratch layout: per layer l, six row-major (B, width) matrices:
//   0 x_in (d)   the layer's input      1 h1 (H)     2 h2 (H)
//   3 ga1 (H)    4 ga2 (H)   cotangents of the hidden pre-activations
//   5 raw (P db) the conditioner output, then its cotangent g_raw, in W3's
//                column order
__host__ __device__ inline int stash_width(int q, int l, int d, int H, int P) {
  return q == 0 ? d : q == 5 ? P * (d - cond_size(l, d)) : H;
}

__host__ __device__ inline size_t stash_offset(int l, int q, long long B, int d, int H, int P) {
  size_t off = 0;
  for (int m = 0; m < l; ++m) off += (size_t)B * (d + 4 * H + P * (d - cond_size(m, d)));
  for (int k = 0; k < q; ++k) off += (size_t)B * stash_width(k, l, d, H, P);
  return off;
}

template <bool LRS, int RPW>
__global__ void __launch_bounds__(kThreads)
spline_vjp_rows_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                       const float* __restrict__ gld, const float* __restrict__ wts,
                       float* __restrict__ gx, float* stash, int B, int d, int H, int L, int K,
                       float T, int inverse) {
  extern __shared__ float smem[];
  const int P = (LRS ? 4 : 3) * K - 1;
  const int n_raw = ((d + 1) / 2) * P;  // the widest conditioner output
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this warp's slice: RPW rows of state, h1, h2, the conditioner output and
  // the cotangent of the state
  float* x_s = smem + (size_t)warp * RPW * (2 * d + 2 * H + n_raw);
  float* h1_s = x_s + RPW * d;
  float* h2_s = h1_s + RPW * H;
  float* raw_s = h2_s + RPW * H;
  float* g_s = raw_s + RPW * n_raw;

  const long long row0 = ((long long)blockIdx.x * kWarps + warp) * RPW;
  if (row0 >= B) return;
  const int n_rows = (int)min((long long)RPW, (long long)B - row0);

  for (int e = lane; e < RPW * d; e += 32) {
    const bool in = e < n_rows * d;
    x_s[e] = in ? x[row0 * d + e] : 0.f;
    g_s[e] = in ? gy[row0 * d + e] : 0.f;
  }
  float gl[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) gl[i] = i < n_rows ? gld[row0 + i] : 0.f;
  __syncwarp();

  // ---- forward recompute, stashing what the backward and kernel 2 read ----
  for (int step = 0; step < L; ++step) {
    const int l = inverse ? L - 1 - step : step;
    const int parity = l % 2;
    const int da = cond_size(l, d);
    const int db = d - da;
    const int n_out = P * db;
    const float* w1 = wts + layer_offset(l, d, H, P);
    const float* b1 = w1 + (size_t)da * H;
    const float* w2 = b1 + H;
    const float* b2 = w2 + (size_t)H * H;
    const float* w3 = b2 + H;
    const float* b3 = w3 + (size_t)H * n_out;
    float* xin = stash + stash_offset(l, 0, B, d, H, P);
    float* h1g = stash + stash_offset(l, 1, B, d, H, P);
    float* h2g = stash + stash_offset(l, 2, B, d, H, P);
    float* rawg = stash + stash_offset(l, 5, B, d, H, P);

    for (int e = lane; e < n_rows * d; e += 32) xin[row0 * d + e] = x_s[e];
    dense_tanh<RPW>(x_s, d, parity, 2, da, w1, b1, h1_s, H, lane);
    __syncwarp();
    dense_tanh<RPW>(h1_s, H, 0, 1, H, w2, b2, h2_s, H, lane);
    __syncwarp();
    for (int e = lane; e < n_rows * H; e += 32) {
      h1g[row0 * H + e] = h1_s[e];
      h2g[row0 * H + e] = h2_s[e];
    }

    // raw = h2 W3 + b3, lanes on consecutive columns
    for (int c0 = 0; c0 < n_out; c0 += 32) {
      const int c = c0 + lane;
      const bool ok = c < n_out;
      float acc[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
      for (int k = 0; k < H; ++k) {
        const float w = ok ? __ldg(w3 + (size_t)k * n_out + c) : 0.f;
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i] = fmaf(h2_s[i * H + k], w, acc[i]);
      }
      if (ok) {
        const float bc = __ldg(b3 + c);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          raw_s[i * n_raw + c] = acc[i] + bc;
          if (i < n_rows) rawg[(row0 + i) * n_out + c] = acc[i] + bc;
        }
      }
    }
    __syncwarp();

    for (int j = lane; j < db; j += 32) {
      const int dim = 2 * j + 1 - parity;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        float* v = x_s + i * d + dim;
        if (i < n_rows && fabsf(*v) <= T)
          *v = spline_apply<LRS>(raw_s + i * n_raw + j * P, K, T, *v, inverse).x;
      }
    }
    __syncwarp();
  }

  // ---- backward, layers in the reverse order of application ----------------
  float* ga2_s = h1_s;  // the hidden activations are read from the stash now
  float* ga1_s = h2_s;
  for (int step = L - 1; step >= 0; --step) {
    const int l = inverse ? L - 1 - step : step;
    const int parity = l % 2;
    const int da = cond_size(l, d);
    const int db = d - da;
    const int n_out = P * db;
    const float* w1 = wts + layer_offset(l, d, H, P);
    const float* w2 = w1 + (size_t)da * H + H;
    const float* w3 = w2 + (size_t)H * H + H;
    const float* xin = stash + stash_offset(l, 0, B, d, H, P);
    const float* h1g = stash + stash_offset(l, 1, B, d, H, P);
    const float* h2g = stash + stash_offset(l, 2, B, d, H, P);
    float* ga1g = stash + stash_offset(l, 3, B, d, H, P);
    float* ga2g = stash + stash_offset(l, 4, B, d, H, P);
    float* rawg = stash + stash_offset(l, 5, B, d, H, P);

    for (int e = lane; e < RPW * n_out; e += 32) {
      const int i = e / n_out, c = e % n_out;
      raw_s[i * n_raw + c] = i < n_rows ? rawg[(row0 + i) * n_out + c] : 0.f;
    }
    __syncwarp();

    // through the spline of each transformed dim: its input's cotangent into
    // g_s, its parameters' over their raw values in raw_s; the tails are the
    // identity and give the parameters no gradient
    for (int j = lane; j < db; j += 32) {
      const int dim = 2 * j + 1 - parity;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        float* r = raw_s + i * n_raw + j * P;
        const float v = i < n_rows ? xin[(row0 + i) * d + dim] : 0.f;
        if (i < n_rows && fabsf(v) <= T) {
          g_s[i * d + dim] = spline_vjp<LRS>(r, K, T, v, inverse, g_s[i * d + dim], gl[i]);
        } else {
          for (int p = 0; p < P; ++p) r[p] = 0.f;
        }
      }
    }
    __syncwarp();
    for (int e = lane; e < n_rows * n_out; e += 32)
      rawg[row0 * n_out + e] = raw_s[(e / n_out) * n_raw + e % n_out];

    // g_a2 = (g_raw W3^T) (1 - h2^2); lane k reads row k of W3
    for (int k0 = 0; k0 < H; k0 += 32) {
      const int k = k0 + lane;
      if (k < H) {
        float acc[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
        for (int n = 0; n < n_out; ++n) {
          const float w = __ldg(w3 + (size_t)k * n_out + n);
#pragma unroll
          for (int i = 0; i < RPW; ++i) acc[i] = fmaf(raw_s[i * n_raw + n], w, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float v = 0.f;
          if (i < n_rows) {
            const float h = h2g[(row0 + i) * H + k];
            v = acc[i] * (1.f - h * h);
            ga2g[(row0 + i) * H + k] = v;
          }
          ga2_s[i * H + k] = v;
        }
      }
    }
    __syncwarp();

    // g_a1 = (g_a2 W2^T) (1 - h1^2)
    for (int k0 = 0; k0 < H; k0 += 32) {
      const int k = k0 + lane;
      if (k < H) {
        float acc[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
        for (int m = 0; m < H; ++m) {
          const float w = __ldg(w2 + (size_t)k * H + m);
#pragma unroll
          for (int i = 0; i < RPW; ++i) acc[i] = fmaf(ga2_s[i * H + m], w, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float v = 0.f;
          if (i < n_rows) {
            const float h = h1g[(row0 + i) * H + k];
            v = acc[i] * (1.f - h * h);
            ga1g[(row0 + i) * H + k] = v;
          }
          ga1_s[i * H + k] = v;
        }
      }
    }
    __syncwarp();

    // g_va = g_a1 W1^T, added into the conditioning dims parity + 2 m
    for (int m0 = 0; m0 < da; m0 += 32) {
      const int m = m0 + lane;
      if (m < da) {
        float acc[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
        for (int k = 0; k < H; ++k) {
          const float w = __ldg(w1 + (size_t)m * H + k);
#pragma unroll
          for (int i = 0; i < RPW; ++i) acc[i] = fmaf(ga1_s[i * H + k], w, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) g_s[i * d + parity + 2 * m] += acc[i];
      }
    }
    __syncwarp();
  }

  for (int e = lane; e < n_rows * d; e += 32) gx[row0 * d + e] = g_s[e];
}

// One tile of one weight gradient: grid.y = 3 L jobs (per layer W1, W2, W3
// with their biases), grid.x = tiles of the largest job.
__global__ void __launch_bounds__(256)
spline_vjp_weights_kernel(const float* __restrict__ stash, float* __restrict__ grads, int B,
                          int d, int H, int P) {
  const int l = blockIdx.y / 3;
  const int job = blockIdx.y % 3;
  const int da = cond_size(l, d);
  const int db = d - da;
  float* gw1 = grads + layer_offset(l, d, H, P);
  const float* A;
  const float* G;
  int lda, a_off = 0, a_step = 1, K, N;
  float* gw;
  if (job == 0) {  // W1: va^T g_a1, va the dims parity, parity + 2, ... of x_in
    A = stash + stash_offset(l, 0, B, d, H, P);
    lda = d;
    a_off = l % 2;
    a_step = 2;
    K = da;
    G = stash + stash_offset(l, 3, B, d, H, P);
    N = H;
    gw = gw1;
  } else if (job == 1) {  // W2: h1^T g_a2
    A = stash + stash_offset(l, 1, B, d, H, P);
    lda = H;
    K = H;
    G = stash + stash_offset(l, 4, B, d, H, P);
    N = H;
    gw = gw1 + (size_t)da * H + H;
  } else {  // W3: h2^T g_raw
    A = stash + stash_offset(l, 2, B, d, H, P);
    lda = H;
    K = H;
    G = stash + stash_offset(l, 5, B, d, H, P);
    N = P * db;
    gw = gw1 + (size_t)da * H + H + (size_t)H * H + H;
  }
  const int tiles_n = (N + kTile - 1) / kTile;
  if ((int)blockIdx.x >= n_tiles(K, N)) return;
  weight_grad_tile(A, lda, a_off, a_step, K, G, N, B, gw, gw + (size_t)K * N,
                   blockIdx.x / tiles_n, blockIdx.x % tiles_n);
}

template <bool LRS, int RPW>
int launch_rows(const float* x, const float* gy, const float* gld, const float* w, float* gx,
                float* stash, int B, int d, int H, int L, int K, float T, int inverse,
                cudaStream_t stream, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(spline_vjp_rows_kernel<LRS, RPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kWarps * RPW;
  const unsigned grid = (unsigned)((B + rows_per_block - 1) / rows_per_block);
  spline_vjp_rows_kernel<LRS, RPW><<<grid, kThreads, smem, stream>>>(
      x, gy, gld, w, gx, stash, B, d, H, L, K, T, inverse);
  return (int)cudaGetLastError();
}

template <bool LRS>
int dispatch_rows(const float* x, const float* gy, const float* gld, const float* w, float* gx,
                  float* stash, int B, int d, int H, int L, int K, float T, int inverse,
                  cudaStream_t s) {
  const int P = (LRS ? 4 : 3) * K - 1;
  const size_t per_row = (size_t)(2 * d + 2 * H + ((d + 1) / 2) * P) * sizeof(float);
  // as in the forward kernel: the most rows per warp whose shared memory fits
  // one block and that still gives the 132 SMs two blocks each
  auto fits = [&](int rpw) {
    return kWarps * rpw * per_row <= kMaxSharedBytes && (long long)B >= 2LL * 132 * kWarps * rpw;
  };
  if (fits(4))
    return launch_rows<LRS, 4>(x, gy, gld, w, gx, stash, B, d, H, L, K, T, inverse, s,
                               kWarps * 4 * per_row);
  if (fits(2))
    return launch_rows<LRS, 2>(x, gy, gld, w, gx, stash, B, d, H, L, K, T, inverse, s,
                               kWarps * 2 * per_row);
  if (kWarps * per_row <= kMaxSharedBytes)
    return launch_rows<LRS, 1>(x, gy, gld, w, gx, stash, B, d, H, L, K, T, inverse, s,
                               kWarps * per_row);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Floats of scratch the VJP needs for B rows, with P raw parameters per
// transformed dim.
extern "C" long long nfmc_spline_vjp_scratch_floats(int B, int d, int H, int L, int P) {
  return (long long)stash_offset(L, 0, B, d, H, P);
}

// Returns a cudaError_t: 0 when both launches were accepted. Launches on
// `stream` and neither synchronises nor allocates: `stash` holds
// nfmc_spline_vjp_scratch_floats(B, d, H, L, P) floats. lrs selects the
// spline kind.
extern "C" int nfmc_spline_stack_vjp(const void* x, const void* gy, const void* gld,
                                     const void* weights, void* gx, void* grads, void* stash,
                                     int B, int d, int H, int L, int n_bins, float tail_bound,
                                     int inverse, int lrs, void* stream) {
  if (B <= 0) return 0;
  if (d < 2 || H < 1 || L < 1 || n_bins < 1) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* gyf = static_cast<const float*>(gy);
  const float* gldf = static_cast<const float*>(gld);
  const float* wf = static_cast<const float*>(weights);
  float* gxf = static_cast<float*>(gx);
  float* st = static_cast<float*>(stash);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = lrs ? dispatch_rows<true>(xf, gyf, gldf, wf, gxf, st, B, d, H, L, n_bins,
                                            tail_bound, inverse, s)
                      : dispatch_rows<false>(xf, gyf, gldf, wf, gxf, st, B, d, H, L, n_bins,
                                             tail_bound, inverse, s);
  if (err != 0) return err;

  const int P = (lrs ? 4 : 3) * n_bins - 1;
  int max_tiles = 0;
  for (int l = 0; l < L; ++l) {
    const int da = cond_size(l, d), db = d - da;
    max_tiles = std::max({max_tiles, n_tiles(da, H), n_tiles(H, H), n_tiles(H, P * db)});
  }
  spline_vjp_weights_kernel<<<dim3(max_tiles, 3 * L), 256, 0, s>>>(
      st, static_cast<float*>(grads), B, d, H, P);
  return (int)cudaGetLastError();
}
