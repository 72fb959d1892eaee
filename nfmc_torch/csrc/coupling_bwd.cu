// The VJP of the RealNVP affine-coupling stack (coupling.cu), forward or
// inverse direction, as two CUDA kernels.
//
// Replaces the Pallas TPU kernel nfmc_tpu/ops/coupling_pallas.py::_kernel_bwd.
// Given x (B, d), the cotangents gy (B, d) of the output and gld (B,) of the
// log-det, it returns gx (B, d) and the gradients of all 6L weights summed
// over the batch, in the canonical packed layout of the weights (per layer
// w1, b1, w2, b2, w3, b3, row-major; see coupling_common.cuh).
//
// Per layer, with s = tanh(raw_ls / c), ls = c s, g_vbn the cotangent of the
// transformed half after the layer and vb the half before it:
//   forward: g_vb = g_vbn e^-ls, g_t = -g_vbn e^-ls, g_ls = -g_vbn vb_new - gld
//   inverse: g_vb = g_vbn e^ls,  g_t = g_vbn,        g_ls = g_vbn vb e^ls + gld
//   g_u = g_ls (1 - s^2)             g_raw = (g_t, g_u) per transformed dim
//   g_a2 = (g_raw W3^T) (1 - h2^2)   g_a1 = (g_a2 W2^T) (1 - h1^2)
//   g_va += g_a1 W1^T
//   gW3 = h2^T g_raw, gW2 = h1^T g_a2, gW1 = va^T g_a1, gb = column sums.
//
// The TPU kernel walks its grid in order and adds each row block's weight
// gradients into outputs it zeroes at the first block. Hopper blocks run
// concurrently, so the work is split in two:
//   1. coupling_vjp_rows_kernel: each warp owns RPW rows for the whole stack,
//      as the forward kernel does. It recomputes the forward pass, stashing
//      each layer's input, h1, h2 and (t, s) in a device scratch buffer, then
//      goes back through the layers and writes gx and each layer's g_raw,
//      g_a2 and g_a1 rows to the scratch buffer. Row-local work only.
//   2. coupling_vjp_weights_kernel: each block computes a 32 x 32 tile of one
//      weight gradient (and, in the tiles of the first row, its bias) as a
//      sum over the batch rows in a fixed order. No atomics: the gradients
//      are bit-identical from run to run.
// The scratch buffer holds about 13 KB a row at d=100, H=128, L=4 (6.7 MB at
// the training batch of 512); the caller allocates it.
//
// What bounds it on an H100: FP32 arithmetic on paper, about 3x the forward's
// 285 kFLOP a row, but at a training batch of a few hundred rows it is bound
// by latency: one warp walks each row through every layer serially. Plain
// FP32 FMAs, accurate tanhf/expf (no fast-math), no tensor cores.
#include <cuda_runtime.h>

#include <algorithm>

#include "coupling_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block can opt into

// Scratch layout: per layer l, seven row-major (B, width) matrices:
//   0 x_in (d)   the layer's input      1 h1 (H)     2 h2 (H)
//   3 ts (2 db)  (t_j, s_j) per transformed dim
//   4 ga1 (H)    5 ga2 (H)   cotangents of the hidden pre-activations
//   6 graw (2 db) cotangent of the conditioner output, in W3's column order
__host__ __device__ inline int stash_width(int q, int l, int d, int H) {
  const int db = d - cond_size(l, d);
  return q == 0 ? d : (q == 3 || q == 6) ? 2 * db : H;
}

__host__ __device__ inline size_t stash_offset(int l, int q, long long B, int d, int H) {
  size_t off = 0;
  for (int m = 0; m < l; ++m) off += (size_t)B * (d + 4 * H + 4 * (d - cond_size(m, d)));
  for (int k = 0; k < q; ++k) off += (size_t)B * stash_width(k, l, d, H);
  return off;
}

template <int RPW>
__global__ void __launch_bounds__(kThreads)
coupling_vjp_rows_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                         const float* __restrict__ gld, const float* __restrict__ wts,
                         float* __restrict__ gx, float* stash, int B, int d, int H,
                         int L, float clamp, int inverse) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this warp's slice: RPW rows of state (d + 1 wide, so that it can hold a
  // layer's g_raw of 2 db <= d + 1 in the backward), h1, h2 and the
  // cotangent of the state
  const int dp = d + 1;
  float* x_s = smem + (size_t)warp * RPW * (dp + 2 * H + d);
  float* h1_s = x_s + RPW * dp;
  float* h2_s = h1_s + RPW * H;
  float* g_s = h2_s + RPW * H;

  const long long row0 = ((long long)blockIdx.x * kWarps + warp) * RPW;
  if (row0 >= B) return;
  const int n_rows = (int)min((long long)RPW, (long long)B - row0);

  for (int e = lane; e < RPW * d; e += 32) {
    const int r = e / d, c = e % d;
    const bool in = e < n_rows * d;
    x_s[r * dp + c] = in ? x[row0 * d + e] : 0.f;
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
    const int n_out = 2 * db;
    const float* w1 = wts + layer_offset(l, d, H);
    const float* b1 = w1 + (size_t)da * H;
    const float* w2 = b1 + H;
    const float* b2 = w2 + (size_t)H * H;
    const float* w3 = b2 + H;
    const float* b3 = w3 + (size_t)H * n_out;
    float* xin = stash + stash_offset(l, 0, B, d, H);
    float* h1g = stash + stash_offset(l, 1, B, d, H);
    float* h2g = stash + stash_offset(l, 2, B, d, H);
    float* tsg = stash + stash_offset(l, 3, B, d, H);

    for (int e = lane; e < n_rows * d; e += 32) xin[row0 * d + e] = x_s[(e / d) * dp + e % d];
    dense_tanh<RPW>(x_s, dp, parity, 2, da, w1, b1, h1_s, H, lane);
    __syncwarp();
    dense_tanh<RPW>(h1_s, H, 0, 1, H, w2, b2, h2_s, H, lane);
    __syncwarp();
    for (int e = lane; e < n_rows * H; e += 32) {
      h1g[row0 * H + e] = h1_s[e];
      h2g[row0 * H + e] = h2_s[e];
    }

    for (int j0 = 0; j0 < db; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < db;
      float acc_t[RPW], acc_s[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) acc_t[i] = acc_s[i] = 0.f;
      for (int k = 0; k < H; ++k) {
        const float wt = ok ? __ldg(w3 + (size_t)k * n_out + 2 * j) : 0.f;
        const float ws = ok ? __ldg(w3 + (size_t)k * n_out + 2 * j + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float h = h2_s[i * H + k];
          acc_t[i] = fmaf(h, wt, acc_t[i]);
          acc_s[i] = fmaf(h, ws, acc_s[i]);
        }
      }
      if (ok) {
        const float bt = __ldg(b3 + 2 * j);
        const float bs = __ldg(b3 + 2 * j + 1);
        const int dim = 2 * j + 1 - parity;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float t = acc_t[i] + bt;
          const float s = tanhf((acc_s[i] + bs) / clamp);
          const float ls = clamp * s;
          float* v = x_s + i * dp + dim;
          *v = inverse ? *v * expf(ls) + t : (*v - t) * expf(-ls);
          if (i < n_rows) {
            tsg[(row0 + i) * n_out + 2 * j] = t;
            tsg[(row0 + i) * n_out + 2 * j + 1] = s;
          }
        }
      }
    }
    __syncwarp();
  }

  // ---- backward, layers in the reverse order of application ----------------
  float* graw_s = x_s;  // the state is not needed any more
  float* ga2_s = h1_s;
  float* ga1_s = h2_s;
  for (int step = L - 1; step >= 0; --step) {
    const int l = inverse ? L - 1 - step : step;
    const int parity = l % 2;
    const int da = cond_size(l, d);
    const int db = d - da;
    const int n_out = 2 * db;
    const float* w1 = wts + layer_offset(l, d, H);
    const float* w2 = w1 + (size_t)da * H + H;
    const float* w3 = w2 + (size_t)H * H + H;
    const float* xin = stash + stash_offset(l, 0, B, d, H);
    const float* h1g = stash + stash_offset(l, 1, B, d, H);
    const float* h2g = stash + stash_offset(l, 2, B, d, H);
    const float* tsg = stash + stash_offset(l, 3, B, d, H);
    float* ga1g = stash + stash_offset(l, 4, B, d, H);
    float* ga2g = stash + stash_offset(l, 5, B, d, H);
    float* grawg = stash + stash_offset(l, 6, B, d, H);

    // through the affine map and the soft clamp, per transformed dim
    for (int j0 = 0; j0 < db; j0 += 32) {
      const int j = j0 + lane;
      if (j < db) {
        const int dim = 2 * j + 1 - parity;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float g_t = 0.f, g_u = 0.f, g_vb = 0.f;
          if (i < n_rows) {
            const long long r = row0 + i;
            const float t = tsg[r * n_out + 2 * j];
            const float s = tsg[r * n_out + 2 * j + 1];
            const float ls = clamp * s;
            const float vb = xin[r * d + dim];
            const float g_vbn = g_s[i * d + dim];
            float g_ls;
            if (inverse) {
              const float e = expf(ls);
              g_t = g_vbn;
              g_ls = g_vbn * vb * e + gl[i];
              g_vb = g_vbn * e;
            } else {
              const float em = expf(-ls);
              const float vb_new = (vb - t) * em;
              g_vb = g_vbn * em;
              g_t = -g_vbn * em;
              g_ls = -g_vbn * vb_new - gl[i];
            }
            g_u = g_ls * (1.f - s * s);
            grawg[r * n_out + 2 * j] = g_t;
            grawg[r * n_out + 2 * j + 1] = g_u;
          }
          graw_s[i * dp + 2 * j] = g_t;
          graw_s[i * dp + 2 * j + 1] = g_u;
          g_s[i * d + dim] = g_vb;
        }
      }
    }
    __syncwarp();

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
          for (int i = 0; i < RPW; ++i) acc[i] = fmaf(graw_s[i * dp + n], w, acc[i]);
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
coupling_vjp_weights_kernel(const float* __restrict__ stash, float* __restrict__ grads,
                            int B, int d, int H) {
  const int l = blockIdx.y / 3;
  const int kind = blockIdx.y % 3;
  const int da = cond_size(l, d);
  const int db = d - da;
  float* gw1 = grads + layer_offset(l, d, H);
  const float* A;
  const float* G;
  int lda, a_off = 0, a_step = 1, K, N;
  float* gw;
  if (kind == 0) {  // W1: va^T g_a1, va the dims parity, parity + 2, ... of x_in
    A = stash + stash_offset(l, 0, B, d, H);
    lda = d;
    a_off = l % 2;
    a_step = 2;
    K = da;
    G = stash + stash_offset(l, 4, B, d, H);
    N = H;
    gw = gw1;
  } else if (kind == 1) {  // W2: h1^T g_a2
    A = stash + stash_offset(l, 1, B, d, H);
    lda = H;
    K = H;
    G = stash + stash_offset(l, 5, B, d, H);
    N = H;
    gw = gw1 + (size_t)da * H + H;
  } else {  // W3: h2^T g_raw
    A = stash + stash_offset(l, 2, B, d, H);
    lda = H;
    K = H;
    G = stash + stash_offset(l, 6, B, d, H);
    N = 2 * db;
    gw = gw1 + (size_t)da * H + H + (size_t)H * H + H;
  }
  const int tiles_n = (N + kTile - 1) / kTile;
  if ((int)blockIdx.x >= n_tiles(K, N)) return;
  weight_grad_tile(A, lda, a_off, a_step, K, G, N, B, gw, gw + (size_t)K * N,
                   blockIdx.x / tiles_n, blockIdx.x % tiles_n);
}

template <int RPW>
int launch_rows(const float* x, const float* gy, const float* gld, const float* w,
                float* gx, float* stash, int B, int d, int H, int L, float clamp,
                int inverse, cudaStream_t stream, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(coupling_vjp_rows_kernel<RPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kWarps * RPW;
  const unsigned grid = (unsigned)((B + rows_per_block - 1) / rows_per_block);
  coupling_vjp_rows_kernel<RPW><<<grid, kThreads, smem, stream>>>(
      x, gy, gld, w, gx, stash, B, d, H, L, clamp, inverse);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch the VJP needs for B rows.
extern "C" long long nfmc_coupling_vjp_scratch_floats(int B, int d, int H, int L) {
  return (long long)stash_offset(L, 0, B, d, H);
}

// Returns a cudaError_t: 0 when both launches were accepted. Launches on
// `stream` and neither synchronises nor allocates: `stash` holds
// nfmc_coupling_vjp_scratch_floats(B, d, H, L) floats.
extern "C" int nfmc_coupling_stack_vjp(const void* x, const void* gy, const void* gld,
                                       const void* weights, void* gx, void* grads,
                                       void* stash, int B, int d, int H, int L,
                                       float clamp, int inverse, void* stream) {
  if (B <= 0) return 0;
  if (d < 2 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* gyf = static_cast<const float*>(gy);
  const float* gldf = static_cast<const float*>(gld);
  const float* wf = static_cast<const float*>(weights);
  float* gxf = static_cast<float*>(gx);
  float* st = static_cast<float*>(stash);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t per_row = (size_t)(2 * d + 1 + 2 * H) * sizeof(float);
  // as in the forward kernel: the most rows per warp whose shared memory fits
  // one block and that still gives the 132 SMs two blocks each
  auto fits = [&](int rpw) {
    return kWarps * rpw * per_row <= kMaxSharedBytes &&
           (long long)B >= 2LL * 132 * kWarps * rpw;
  };
  int err;
  if (fits(4))
    err = launch_rows<4>(xf, gyf, gldf, wf, gxf, st, B, d, H, L, clamp, inverse, s, kWarps * 4 * per_row);
  else if (fits(2))
    err = launch_rows<2>(xf, gyf, gldf, wf, gxf, st, B, d, H, L, clamp, inverse, s, kWarps * 2 * per_row);
  else if (kWarps * per_row <= kMaxSharedBytes)
    err = launch_rows<1>(xf, gyf, gldf, wf, gxf, st, B, d, H, L, clamp, inverse, s, kWarps * per_row);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;

  int max_tiles = 0;
  for (int l = 0; l < L; ++l) {
    const int da = cond_size(l, d), db = d - da;
    max_tiles = std::max({max_tiles, n_tiles(da, H), n_tiles(H, H), n_tiles(H, 2 * db)});
  }
  coupling_vjp_weights_kernel<<<dim3(max_tiles, 3 * L), 256, 0, s>>>(
      st, static_cast<float*>(grads), B, d, H);
  return (int)cudaGetLastError();
}
