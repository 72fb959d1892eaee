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
//   1. spline_vjp_rows_kernel: a block owns R = 8 rows for the whole
//      stack, on the block row-tile engine of spline.cu (coupling_tile.cuh).
//      It recomputes the forward pass, stashing each layer's input, h1, h2
//      and conditioner output in a device scratch buffer, then goes back
//      through the layers, overwriting each stashed conditioner output with
//      its cotangent g_raw and writing g_a2 and g_a1. Row-local work only.
//   2. spline_vjp_weights_kernel: each block computes a 32 x 32 tile of one
//      weight gradient as a sum over the batch rows in a fixed order
//      (coupling_common.cuh::weight_grad_tile), in the canonical layout. It
//      took 1.4% of the VJP at B=256 when the rows kernel had one warp a row
//      (scripts/coupling_kernels_ab.py), and ~4% now: it stays as it was.
// The scratch buffer holds, per row and layer, d + 4 H + P db floats: at
// d=100, H=128, L=4 that is 28.5 KB a row for RQS (P=23) and 34.6 KB for LRS
// (P=31), so 7.3 MB and 8.9 MB at the training batch of 256. The caller
// allocates it.
//
// What bounds it on an H100: FP32 arithmetic on paper (the forward's products
// three times over, W3 the widest), but at the training batch of 256 rows
// the time goes to latency, as in the forward.
//
// Design of the rows kernel: the recompute is spline.cu's, W3 one chunk of
// nd = floor(128 / P) whole dims at a time (eight chunks a group at R=8).
// The backward takes each layer's chunks in the same layout: a group's raw
// values come back from the stash into the group buffer, one thread a
// (row, dim) runs spline_vjp on them (g_raw in place of the raw values, the
// input's cotangent into the state's), the g_raw goes to the stash for
// kernel 2, and
// g_a2 = (g_raw W3^T) (1 - h2^2) is a product whose reduction dim is W3's
// columns, taken one chunk at a time: each chunk's product (W3^T's block of
// columns, Gemm::ld) is added to the sum of the chunks before it in order,
// the last applying the factor. Then g_a1 = (g_a2 W2^T) (1 - h1^2) and
// g_va += g_a1 W1^T are the engine's transposed products. One buffer holds
// the state in the recompute and its cotangent after it, so shared memory
// is spline.cu's, its group buffer too: a tile of 8 rows fits up to
// d = 1625 at H=128 with a ring of 3 stages and 2713 with 2. Plain FP32
// FMAs, accurate expf/logf/sqrtf (no fast-math), no tensor cores.
#include <cuda_runtime.h>

#include <algorithm>

#include "coupling_common.cuh"
#include "coupling_tile.cuh"
#include "spline_common.cuh"
#include "spline_tile.cuh"

namespace {

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

// The rows kernel's products: the recompute's (SplineForwardSchedule), then
// per layer in the reverse order of application W3^T one chunk of g_raw
// (nd whole dims) at a time, W2^T and W1^T.
struct SplineBackwardSchedule {
  SplineForwardSchedule fwd;

  __host__ __device__ int total() const { return 2 * fwd.total(); }
  __device__ Gemm operator()(int q) const {
    const int n_fwd = fwd.total();
    if (q < n_fwd) return fwd(q);
    q -= n_fwd;
    const int d = fwd.d, H = fwd.H, L = fwd.L, P = fwd.P;
    int step = L - 1;
    while (step > 0 && q >= fwd.count(step)) q -= fwd.count(step--);
    const int l = fwd.inverse ? L - 1 - step : step;
    const int da = cond_size(l, d), n_out = P * (d - da), nch = fwd.count(step) - 2;
    const float* w1 = fwd.wts + layer_offset(l, d, H, P);
    const float* w2 = w1 + (size_t)da * H + H;
    if (q < nch) {
      const int c0 = q * chunk_dims(P) * P;
      return Gemm{w2 + (size_t)H * H + H + c0, min(chunk_dims(P) * P, n_out - c0), H, true, n_out};
    }
    if (q == nch) return Gemm{w2, H, H, true};
    return Gemm{w1, H, da, true};
  }
};

// One block an SM: up to 255 registers a thread, as in coupling.cu.
template <bool LRS, int R>
__global__ void __launch_bounds__(kThreads, 1)
spline_vjp_rows_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                       const float* __restrict__ gld, const float* __restrict__ wts,
                       float* __restrict__ gx, float* stash, int B, int d, int H, int L, int K,
                       float T, int inverse, int stages) {
  extern __shared__ float smem[];
  const int P = spline_params(LRS, K), nd = chunk_dims(P);
  const int xs = perm_width(d), aw = act_width(H), odd = perm_slot(1, d);
  float* x_s = smem;           // R x xs: the state, [even | odd]; after the
                               // recompute, its cotangent
  float* ha = x_s + R * xs;    // R x aw: h1; g_a1
  float* hb = ha + R * aw;     // R x aw: h2; g_a2
  float* gl = hb + R * aw;     // R: the log-det cotangent
  const int bw = bias_floats(H);
  float* bias_s = gl + R;      // 2 x bw: the hidden biases of this layer and the next
  float* red = bias_s + 2 * bw;  // split-k partial tiles
  constexpr int G = chunk_group(R);
  float* grp = red + red_floats(R);  // R x G x 128 (G > 1): a group of chunks' raw values
  float* raw_s = G > 1 ? grp : ha;   // where the raw values land, rows rs floats apart
  const int rs = G > 1 ? G * kChunkN : aw;
  const SplineBackwardSchedule sched{{wts, d, H, L, P, inverse}};
  auto biases = [&](int step) {  // of recompute layer step, into buffer step % 2
    const int l = inverse ? L - 1 - step : step;
    copy_biases(wts + layer_offset(l, d, H, P), cond_size(l, d), H, bias_s + (step % 2) * bw);
  };
  WeightStream<SplineBackwardSchedule> ws{grp + group_floats(R), sched, sched.total(), stages};
  biases(0);
  ws.start();

  const long long row0 = (long long)blockIdx.x * R;
  const int n_rows = (int)min((long long)R, (long long)B - row0);
  for (int e = threadIdx.x; e < R * (xs + 2 * aw + 1); e += kThreads) smem[e] = 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * d; e += kThreads)
    x_s[(e / d) * xs + perm_slot(e % d, d)] = x[row0 * d + e];
  if (threadIdx.x < n_rows) gl[threadIdx.x] = gld[row0 + threadIdx.x];
  // the group buffer is the W3^T products' left operand: its columns past a
  // chunk's must be finite
  for (int e = threadIdx.x; e < (int)group_floats(R); e += kThreads) grp[e] = 0.f;
  // dim jj of a group: its raw values in chunk jj / nd, at (jj % nd) P
  auto raw_of = [&](int r, int jj) { return raw_s + r * rs + (jj / nd) * kChunkN + (jj % nd) * P; };

  // ---- forward recompute, stashing what the backward and kernel 2 read ----
  for (int step = 0; step < L; ++step) {
    const int l = inverse ? L - 1 - step : step;
    const int parity = l % 2;
    const int da = cond_size(l, d);
    const int db = d - da;
    const int n_out = P * db;
    const float* b1 = bias_s + (step % 2) * bw;
    const float* b2 = b1 + round4(H);
    const float* b3 = wts + layer_offset(l, d, H, P) + (size_t)(da + H + 2) * H + (size_t)H * n_out;
    float* xin = stash + stash_offset(l, 0, B, d, H, P);
    float* h1g = stash + stash_offset(l, 1, B, d, H, P);
    float* h2g = stash + stash_offset(l, 2, B, d, H, P);
    float* rawg = stash + stash_offset(l, 5, B, d, H, P);
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
    // the conditioner output one chunk of whole dims at a time, as in
    // spline.cu, stashed for the backward; then each (row, dim)'s spline
    for (int j0 = 0; j0 < db; j0 += G * nd) {
      const int nj = min(G * nd, db - j0);
      for (int g = 0; g * nd < nj; ++g)
        tile_gemm<R>(ws, hb, aw, red, [&](int r, int n, float v) {
          const size_t col = (size_t)(j0 + g * nd) * P + n;
          const float raw = v + __ldg(b3 + col);
          raw_s[r * rs + g * kChunkN + n] = raw;
          if (r < n_rows) rawg[(row0 + r) * n_out + col] = raw;
        });
      for (int e = threadIdx.x; e < R * nj; e += kThreads) {
        const int r = e / nj, jj = e % nj;
        float* v = vb_s + r * xs + j0 + jj;
        if (r < n_rows && fabsf(*v) <= T) *v = spline_apply<LRS>(raw_of(r, jj), K, T, *v, inverse).x;
      }
    }
  }

  // the state is not needed any more: its buffer takes the cotangent
  __syncthreads();
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
    const int n_out = P * db;
    const float* xin = stash + stash_offset(l, 0, B, d, H, P);
    const float* h1g = stash + stash_offset(l, 1, B, d, H, P);
    const float* h2g = stash + stash_offset(l, 2, B, d, H, P);
    float* ga1g = stash + stash_offset(l, 3, B, d, H, P);
    float* ga2g = stash + stash_offset(l, 4, B, d, H, P);
    float* rawg = stash + stash_offset(l, 5, B, d, H, P);
    float* gvb_s = x_s + (parity ? 0 : odd);  // the transformed half's cotangent
    float* gva_s = x_s + (parity ? odd : 0);  // the conditioning half's

    for (int j0 = 0; j0 < db; j0 += G * nd) {
      const int nj = min(G * nd, db - j0);
      // the group's raw values from the stash (rows past B: zeros)
      __syncthreads();
      for (int e = threadIdx.x; e < R * nj * P; e += kThreads) {
        const int r = e / (nj * P), jj = e % (nj * P) / P, p = e % P;
        raw_of(r, jj)[p] = r < n_rows ? rawg[(row0 + r) * n_out + (size_t)(j0 + jj) * P + p] : 0.f;
      }
      __syncthreads();
      // through the spline of each (row, dim): its input's cotangent into
      // the state's cotangent, its parameters' over their raw values; the
      // tails are the identity and give the parameters no gradient
      for (int e = threadIdx.x; e < R * nj; e += kThreads) {
        const int r = e / nj, jj = e % nj, j = j0 + jj;
        float* raw = raw_of(r, jj);
        const float v = r < n_rows ? xin[(row0 + r) * d + 2 * j + 1 - parity] : 0.f;
        if (r < n_rows && fabsf(v) <= T) {
          gvb_s[r * xs + j] = spline_vjp<LRS>(raw, K, T, v, inverse, gvb_s[r * xs + j], gl[r]);
        } else {
          for (int p = 0; p < P; ++p) raw[p] = 0.f;
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n_rows * nj * P; e += kThreads) {
        const int r = e / (nj * P), jj = e % (nj * P) / P, p = e % P;
        rawg[(row0 + r) * n_out + (size_t)(j0 + jj) * P + p] = raw_of(r, jj)[p];
      }
      // g_a2 = (g_raw W3^T) (1 - h2^2): each chunk's product added to the
      // chunks' before it, in order; the layer's last one applies the factor
      for (int g = 0; g * nd < nj; ++g) {
        const bool first = j0 == 0 && g == 0, last = j0 + (g + 1) * nd >= db;
        tile_gemm<R>(ws, raw_s + g * kChunkN, rs, red, [&](int r, int n, float v) {
          float sum = first ? v : hb[r * aw + n] + v;
          if (last) {
            float ga2 = 0.f;
            if (r < n_rows) {
              const float h = h2g[(row0 + r) * H + n];
              ga2 = sum * (1.f - h * h);
              ga2g[(row0 + r) * H + n] = ga2;
            }
            sum = ga2;
          }
          hb[r * aw + n] = sum;
        });
      }
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

template <bool LRS, int R>
int launch_rows(const float* x, const float* gy, const float* gld, const float* w, float* gx,
                float* stash, int B, int d, int H, int L, int K, float T, int inverse,
                int stages, cudaStream_t stream) {
  const size_t smem = spline_shared_bytes(R, stages, d, H);
  const cudaError_t err = cudaFuncSetAttribute(
      spline_vjp_rows_kernel<LRS, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((B + R - 1) / R);
  spline_vjp_rows_kernel<LRS, R><<<grid, kThreads, smem, stream>>>(
      x, gy, gld, w, gx, stash, B, d, H, L, K, T, inverse, stages);
  return (int)cudaGetLastError();
}

// Only R=8 is instantiated: the paths' backward batches (a fit's 256 rows,
// a MALA step's 100) take it, and so would any batch up to 8 x the SM count
// under row_tile's rule; larger batches run more blocks of 8 rows.
template <bool LRS>
int dispatch_rows(const float* x, const float* gy, const float* gld, const float* w, float* gx,
                  float* stash, int B, int d, int H, int L, int K, float T, int inverse,
                  cudaStream_t s) {
  int n_sm = 0;
  const cudaError_t err = sm_count(&n_sm);
  if (err != cudaSuccess) return (int)err;
  const TileConfig t = row_tile(
      B, n_sm, [&](int rows, int stages) { return spline_shared_bytes(rows, stages, d, H); }, 8);
  switch (t.rows) {
    case 8:
      return launch_rows<LRS, 8>(x, gy, gld, w, gx, stash, B, d, H, L, K, T, inverse, t.stages, s);
  }
  return kErrTileTooLarge;
}

}  // namespace

// Floats of scratch the VJP needs for B rows, with P raw parameters per
// transformed dim.
extern "C" long long nfmc_spline_vjp_scratch_floats(int B, int d, int H, int L, int P) {
  return (long long)stash_offset(L, 0, B, d, H, P);
}

// Shared bytes a block of the rows kernel's smallest tile (8 rows, a ring
// of 2 stages) needs: above 232448 the launcher refuses with
// kErrTileTooLarge.
extern "C" long long nfmc_spline_vjp_tile_bytes(int d, int H) {
  return (long long)spline_shared_bytes(8, 2, d, H);
}

// Returns a cudaError_t: 0 when both launches were accepted;
// kErrTileTooLarge (cudaErrorInvalidConfiguration) without a launch when no
// row tile fits a block; cudaErrorInvalidValue when P > 128 (as spline.cu).
// Launches on `stream` and neither synchronises nor allocates: `stash`
// holds nfmc_spline_vjp_scratch_floats(B, d, H, L, P) floats. lrs selects
// the spline kind.
extern "C" int nfmc_spline_stack_vjp(const void* x, const void* gy, const void* gld,
                                     const void* weights, void* gx, void* grads, void* stash,
                                     int B, int d, int H, int L, int n_bins, float tail_bound,
                                     int inverse, int lrs, void* stream) {
  if (B <= 0) return 0;
  if (d < 2 || H < 1 || L < 1 || n_bins < 1 || spline_params(lrs, n_bins) > kChunkN)
    return (int)cudaErrorInvalidValue;
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

  const int P = spline_params(lrs, n_bins);
  int max_tiles = 0;
  for (int l = 0; l < L; ++l) {
    const int da = cond_size(l, d), db = d - da;
    max_tiles = std::max({max_tiles, n_tiles(da, H), n_tiles(H, H), n_tiles(H, P * db)});
  }
  spline_vjp_weights_kernel<<<dim3(max_tiles, 3 * L), 256, 0, s>>>(
      st, static_cast<float*>(grads), B, d, H, P);
  return (int)cudaGetLastError();
}
