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
//   1. coupling_vjp_rows_kernel: a block owns R rows for the whole
//      stack. It recomputes the forward pass, stashing each layer's input,
//      h1, h2 and (t, s) in a device scratch buffer, then goes back through
//      the layers and writes gx and each layer's g_raw, g_a2 and g_a1 rows to
//      the scratch buffer. Row-local work only.
//   2. coupling_vjp_weights_kernel: each block computes a 32 x 32 tile of one
//      weight gradient (and, in the tiles of the first row, its bias) as a
//      sum over the batch rows in a fixed order. No atomics: the gradients
//      are bit-identical from run to run.
// The scratch buffer holds about 13 KB a row at d=100, H=128, L=4 (3.4 MB at
// the training batch of 256); the caller allocates it.
//
// What bounds it on an H100: FP32 arithmetic on paper, 3x the forward's
// 285 kFLOP a row (0.22 GFLOP, 3.3 us at the training batch of 256), but at
// a few hundred rows the time goes to latency: each of the 24 products of
// the rows kernel (6 a layer) waits for its weights from L2, one after the
// other.
//
// Design of the rows kernel (coupling_tile.cuh): the six row-local products
// of a layer (va W1, h1 W2, h2 W3 in the recompute; g_raw W3^T, g_a2 W2^T,
// g_a1 W1^T in the backward) are each an (R x K) . (K x N) tile product
// with the operand rows in shared memory. All 6 L products draw their
// weights from one stream of 64 x 128 slabs through a ring of three
// shared-memory stages, filled with cp.async two slabs ahead of the FMAs
// (the transposed products copy W along its rows, which are contiguous, and
// store the slab [n][k] with a row of 68 floats: conflict-free float4 reads
// along k). Each thread sums an 8 x 4 register tile; below R=64 the warps
// of a row group split k and sum their partials in a fixed order. One
// buffer holds the state in the recompute and its cotangent after it
// (R x perm_width(d), the [even | odd] layout); two activation buffers
// (R x max(H, 128)) hold h1 and h2, a chunk of the conditioner output, and
// in the backward a chunk of g_raw, g_a2 and g_a1. The recompute's output
// layer is applied 128 columns at a time, as in coupling.cu, and the
// backward's W3^T takes g_raw 128 columns at a time, each chunk's product
// added to the sum of those before it in order (one product where
// 2 db <= 128, as at d=100). Shared memory as coupling.cu's
// (coupling_tile.cuh::tile_shared_bytes): 147 KB a block at R=8, 194 KB at
// R=64 for d=100, H=128; a tile of 8 rows fits up to d = 2649 at H=128 with
// a ring of 3 stages, 3737 with 2. R
// as in coupling.cu: the training batch of 256 takes R=8, 32 blocks. The
// weights kernel (2. above) takes about a tenth of the time at B=256
// (chip_smoke.py phase 3b prints the split).
// Plain FP32 FMAs, accurate tanhf/expf (no fast-math), no tensor cores.
#include <cuda_runtime.h>

#include <algorithm>

#include "coupling_common.cuh"
#include "coupling_tile.cuh"

namespace {

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

// Column chunks of layer l's conditioner output (2 db columns): 128 columns
// (64 transformed dims) each. The recompute applies them one at a time, and
// the backward's W3^T takes g_raw one chunk at a time.
__host__ __device__ inline int out_chunks(int l, int d) {
  return (2 * (d - cond_size(l, d)) + kChunkN - 1) / kChunkN;
}

// One block an SM, as in coupling.cu: up to 255 registers a thread.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
coupling_vjp_rows_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                         const float* __restrict__ gld, const float* __restrict__ wts,
                         float* __restrict__ gx, float* stash, int B, int d, int H,
                         int L, float clamp, int inverse, int stages) {
  extern __shared__ float smem[];
  const int xs = perm_width(d), aw = act_width(H), odd = perm_slot(1, d);
  float* x_s = smem;           // R x xs: the state, [even | odd]; after the
                               // recompute, its cotangent
  float* ha = x_s + R * xs;    // R x aw: h1, a chunk of the raw output; a chunk of g_raw, g_a1
  float* hb = ha + R * aw;     // R x aw: h2; g_a2
  float* gl = hb + R * aw;     // R: the log-det cotangent
  const int bw = bias_floats(H);
  float* bias_s = gl + R;      // 2 x bw: the hidden biases of this layer and the next
  float* red = bias_s + 2 * bw;  // split-k partial tiles
  // the recompute's W1, W2, W3 per layer in the order of application, then
  // per layer in the reverse order the backward's W3^T (one product a
  // 128-column chunk of g_raw), W2^T, W1^T
  auto sched = [=](int q) {
    int step, kind;  // 0, 1, 2: W1, W2, W3; 3 + c: W3^T chunk c; then W2^T, W1^T
    if (q < 3 * L) {
      step = q / 3;
      kind = q % 3;
    } else {
      q -= 3 * L;
      for (step = L - 1; step > 0; --step) {
        const int n = out_chunks(inverse ? L - 1 - step : step, d) + 2;
        if (q < n) break;
        q -= n;
      }
      kind = 3 + q;
    }
    const int l = inverse ? L - 1 - step : step;
    const int da = cond_size(l, d);
    const float* w1 = wts + layer_offset(l, d, H);
    const float* w2 = w1 + (size_t)da * H + H;
    const float* w3 = w2 + (size_t)H * H + H;
    const int db2 = 2 * (d - da), nch = out_chunks(l, d);
    if (kind == 0) return Gemm{w1, da, H, false};
    if (kind == 1) return Gemm{w2, H, H, false};
    if (kind == 2) return Gemm{w3, H, db2, false};
    if (kind < 3 + nch) {
      const int c0 = (kind - 3) * kChunkN;
      return Gemm{w3 + c0, min(kChunkN, db2 - c0), H, true, db2};
    }
    if (kind == 3 + nch) return Gemm{w2, H, H, true};
    return Gemm{w1, H, da, true};
  };
  int n_gemms = 3 * L;
  for (int l = 0; l < L; ++l) n_gemms += out_chunks(l, d) + 2;
  auto biases = [&](int step) {  // of recompute layer step, into buffer step % 2
    const int l = inverse ? L - 1 - step : step;
    copy_biases(wts + layer_offset(l, d, H), cond_size(l, d), H, bias_s + (step % 2) * bw);
  };
  WeightStream<decltype(sched)> ws{red + red_floats(R), sched, n_gemms, stages};
  biases(0);
  ws.start();

  const long long row0 = (long long)blockIdx.x * R;
  const int n_rows = (int)min((long long)R, (long long)B - row0);
  for (int e = threadIdx.x; e < R * (xs + 2 * aw + 1); e += kThreads) smem[e] = 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * d; e += kThreads)
    x_s[(e / d) * xs + perm_slot(e % d, d)] = x[row0 * d + e];
  if (threadIdx.x < n_rows) gl[threadIdx.x] = gld[row0 + threadIdx.x];

  // ---- forward recompute, stashing what the backward and kernel 2 read ----
  for (int step = 0; step < L; ++step) {
    const int l = inverse ? L - 1 - step : step;
    const int parity = l % 2;
    const int da = cond_size(l, d);
    const int db = d - da;
    const int n_out = 2 * db;
    const float* b1 = bias_s + (step % 2) * bw;
    const float* b2 = b1 + round4(H);
    const float* b3 = wts + layer_offset(l, d, H) + (size_t)(da + H + 2) * H + (size_t)H * n_out;
    float* xin = stash + stash_offset(l, 0, B, d, H);
    float* h1g = stash + stash_offset(l, 1, B, d, H);
    float* h2g = stash + stash_offset(l, 2, B, d, H);
    float* tsg = stash + stash_offset(l, 3, B, d, H);
    float* vb_s = x_s + (parity ? 0 : odd);  // transformed dim j at slot j

    __syncthreads();
    if (step + 1 < L) biases(step + 1);
    for (int e = threadIdx.x; e < n_rows * d; e += kThreads)
      xin[row0 * d + e] = x_s[(e / d) * xs + perm_slot(e % d, d)];
    tile_gemm<R>(ws, x_s + (parity ? odd : 0), xs, red, [&](int r, int n, float v) {
      const float h = tanhf(v + b1[n]);
      ha[r * aw + n] = h;
      if (r < n_rows) h1g[(row0 + r) * H + n] = h;
    });
    tile_gemm<R>(ws, ha, aw, red, [&](int r, int n, float v) {
      const float h = tanhf(v + b2[n]);
      hb[r * aw + n] = h;
      if (r < n_rows) h2g[(row0 + r) * H + n] = h;
    });
    // the conditioner output 128 columns a chunk, as in coupling.cu: the
    // affine update of transformed dim j, stashing (t_j, s_j)
    tile_gemm<R>(
        ws, hb, aw, red,
        [&](int r, int n, float v) { ha[r * aw + n % kChunkN] = v + __ldg(b3 + n); },
        [&](int n0) {
          const int j0 = n0 / 2, nj = min(kChunkN / 2, db - j0);
          for (int e = threadIdx.x; e < R * nj; e += kThreads) {
            const int r = e / nj, jj = e % nj, j = j0 + jj;
            const float t = ha[r * aw + 2 * jj];
            const float s = tanhf(ha[r * aw + 2 * jj + 1] / clamp);
            const float ls = clamp * s;
            float* v = vb_s + r * xs + j;
            *v = inverse ? *v * expf(ls) + t : (*v - t) * expf(-ls);
            if (r < n_rows) {
              tsg[(row0 + r) * n_out + 2 * j] = t;
              tsg[(row0 + r) * n_out + 2 * j + 1] = s;
            }
          }
        });
  }

  // the state is not needed any more: its buffer takes the cotangent
  for (int e = threadIdx.x; e < R * xs; e += kThreads) x_s[e] = 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * d; e += kThreads)
    x_s[(e / d) * xs + perm_slot(e % d, d)] = gy[row0 * d + e];

  // ---- backward, layers in the reverse order of application ----------------
  for (int step = L - 1; step >= 0; --step) {
    const int l = inverse ? L - 1 - step : step;
    const int parity = l % 2;
    const int da = cond_size(l, d);
    const int db = d - da;
    const int n_out = 2 * db;
    const int nch = out_chunks(l, d);
    const float* xin = stash + stash_offset(l, 0, B, d, H);
    const float* h1g = stash + stash_offset(l, 1, B, d, H);
    const float* h2g = stash + stash_offset(l, 2, B, d, H);
    const float* tsg = stash + stash_offset(l, 3, B, d, H);
    float* ga1g = stash + stash_offset(l, 4, B, d, H);
    float* ga2g = stash + stash_offset(l, 5, B, d, H);
    float* grawg = stash + stash_offset(l, 6, B, d, H);
    float* gvb_s = x_s + (parity ? 0 : odd);  // the transformed half's cotangent
    float* gva_s = x_s + (parity ? odd : 0);  // the conditioning half's

    for (int c = 0; c < nch; ++c) {
      // through the affine map and the soft clamp, per (row, transformed dim)
      // of the chunk: g_raw into ha; rows past B get a zero g_raw
      const int j0 = c * (kChunkN / 2), nj = min(kChunkN / 2, db - j0);
      __syncthreads();
      for (int e = threadIdx.x; e < R * nj; e += kThreads) {
        const int r = e / nj, jj = e % nj, j = j0 + jj;
        float g_t = 0.f, g_u = 0.f;
        if (r < n_rows) {
          const long long row = row0 + r;
          const float t = tsg[row * n_out + 2 * j];
          const float s = tsg[row * n_out + 2 * j + 1];
          const float ls = clamp * s;
          const float vb = xin[row * d + 2 * j + 1 - parity];
          const float g_vbn = gvb_s[r * xs + j];
          float g_ls, g_vb;
          if (inverse) {
            const float ex = expf(ls);
            g_t = g_vbn;
            g_ls = g_vbn * vb * ex + gl[r];
            g_vb = g_vbn * ex;
          } else {
            const float em = expf(-ls);
            const float vb_new = (vb - t) * em;
            g_vb = g_vbn * em;
            g_t = -g_vbn * em;
            g_ls = -g_vbn * vb_new - gl[r];
          }
          g_u = g_ls * (1.f - s * s);
          grawg[row * n_out + 2 * j] = g_t;
          grawg[row * n_out + 2 * j + 1] = g_u;
          gvb_s[r * xs + j] = g_vb;
        }
        ha[r * aw + 2 * jj] = g_t;
        ha[r * aw + 2 * jj + 1] = g_u;
      }
      // g_a2 = (g_raw W3^T) (1 - h2^2): each chunk's product added to the
      // chunks' before it, in order; the last one applies the factor
      tile_gemm<R>(ws, ha, aw, red, [&](int r, int n, float v) {
        float g = c == 0 ? v : hb[r * aw + n] + v;
        if (c == nch - 1) {
          float sum = g;
          g = 0.f;
          if (r < n_rows) {
            const float h = h2g[(row0 + r) * H + n];
            g = sum * (1.f - h * h);
            ga2g[(row0 + r) * H + n] = g;
          }
        }
        hb[r * aw + n] = g;
      });
    }
    // g_a1 = (g_a2 W2^T) (1 - h1^2)
    tile_gemm<R>(ws, hb, aw, red, [&](int r, int n, float v) {
      float g = 0.f;
      if (r < n_rows) {
        const float h = h1g[(row0 + r) * H + n];
        g = v * (1.f - h * h);
        ga1g[(row0 + r) * H + n] = g;
      }
      ha[r * aw + n] = g;
    });
    // g_va = g_a1 W1^T, added into the conditioning half
    tile_gemm<R>(ws, ha, aw, red, [&](int r, int m, float v) { gva_s[r * xs + m] += v; });
  }

  for (int e = threadIdx.x; e < n_rows * d; e += kThreads)
    gx[row0 * d + e] = x_s[(e / d) * xs + perm_slot(e % d, d)];
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

template <int R>
int launch_rows(const float* x, const float* gy, const float* gld, const float* w,
                float* gx, float* stash, int B, int d, int H, int L, float clamp,
                int inverse, int stages, cudaStream_t stream) {
  const size_t smem = tile_shared_bytes(R, stages, d, H);
  const cudaError_t err = cudaFuncSetAttribute(
      coupling_vjp_rows_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((B + R - 1) / R);
  coupling_vjp_rows_kernel<R><<<grid, kThreads, smem, stream>>>(
      x, gy, gld, w, gx, stash, B, d, H, L, clamp, inverse, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch the VJP needs for B rows.
extern "C" long long nfmc_coupling_vjp_scratch_floats(int B, int d, int H, int L) {
  return (long long)stash_offset(L, 0, B, d, H);
}

// Shared bytes a block of the rows kernel's smallest tile (8 rows, a ring
// of 2 stages) needs: above 232448 the launcher refuses with
// kErrTileTooLarge.
extern "C" long long nfmc_coupling_vjp_tile_bytes(int d, int H) {
  return (long long)tile_shared_bytes(8, 2, d, H);
}

// Returns a cudaError_t: 0 when both launches were accepted,
// kErrTileTooLarge (cudaErrorInvalidConfiguration) without a launch when no
// row tile fits a block. Launches on `stream` and neither synchronises nor
// allocates: `stash` holds nfmc_coupling_vjp_scratch_floats(B, d, H, L)
// floats.
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
  int n_sm = 0;
  const cudaError_t cerr = sm_count(&n_sm);
  if (cerr != cudaSuccess) return (int)cerr;
  int err;
  const TileConfig t = row_tile(
      B, n_sm, [&](int rows, int stages) { return tile_shared_bytes(rows, stages, d, H); });
  switch (t.rows) {
    case 64:
      err = launch_rows<64>(xf, gyf, gldf, wf, gxf, st, B, d, H, L, clamp, inverse, t.stages, s);
      break;
    case 32:
      err = launch_rows<32>(xf, gyf, gldf, wf, gxf, st, B, d, H, L, clamp, inverse, t.stages, s);
      break;
    case 8:
      err = launch_rows<8>(xf, gyf, gldf, wf, gxf, st, B, d, H, L, clamp, inverse, t.stages, s);
      break;
    default: return kErrTileTooLarge;
  }
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
