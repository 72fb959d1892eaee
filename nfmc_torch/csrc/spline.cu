// Spline coupling stack, forward or inverse, as one CUDA kernel: each layer
// applies an elementwise rational-quadratic (RQS) or linear-rational (LRS)
// spline to the transformed half.
//
// Replaces the Pallas TPU kernel
// nfmc_tpu/ops/experimental_spline_pallas.py::_kernel. For each row of x
// (B, d) it runs all L coupling layers. Layer l conditions on the dims i with
// (i + l) % 2 == 0 and transforms the others:
//
//   h1  = tanh(va . W1 + b1)       va: (da,)   W1: (da, H)
//   h2  = tanh(h1 . W2 + b2)       W2: (H, H)
//   raw = h2 . W3 + b3             W3: (H, P db), columns dim-major (j P + p)
//   transformed dim j (at 2 j + 1 - l % 2): v = spline(v; raw[j P .. j P + P-1])
//   forward: layers 0 .. L-1, ld += log dv'/dv; inverse: L-1 .. 0, the inverse
//   spline, ld -= log dv/dv'
//
// P = 3K - 1 (RQS) or 4K - 1 (LRS) raw parameters per dim, K bins; the spline
// itself is in spline_common.cuh. The weights arrive as one contiguous f32
// buffer in the canonical layout of the parameter pytree (coupling_common.cuh).
// The TPU kernel's packed [even | odd] event layout and param-major W3 exist
// only because Mosaic has no strided gather; here nothing is permuted.
//
// What bounds it on an H100: FP32 arithmetic. A row costs
// 2 (da H + H H + P db H) FLOP per layer plus the splines, 1.36 MFLOP (RQS)
// or 1.77 MFLOP (LRS) at d=100, H=128, L=4, K=8, against 804 bytes of input
// and output; W3 is 87% (RQS) or 90% (LRS) of the products. At one jump's 100 rows the launch
// latency dominates. Design: as coupling.cu, every warp owns RPW rows for the
// whole stack, with the rows' state, both hidden activations and the
// conditioner output in shared memory (no device-memory traffic between
// layers, no block-wide barrier). The output layer is computed with lanes on
// consecutive columns (coalesced W3 reads; the 2.7 MB (RQS) or 3.6 MB (LRS)
// of weights at L=4 stay in L2); then each lane takes one transformed dim and
// reads its P parameters from shared memory (P is odd at K=8: no bank
// conflicts). Plain FP32 FMAs, accurate expf/logf/sqrtf (no fast-math), no
// tensor cores.
#include <cuda_runtime.h>

#include "coupling_common.cuh"
#include "spline_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block can opt into

template <bool LRS, int RPW>
__global__ void __launch_bounds__(kThreads)
spline_stack_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                    float* __restrict__ y, float* __restrict__ ld_out, int B, int d, int H,
                    int L, int K, float T, int inverse) {
  extern __shared__ float smem[];
  const int P = (LRS ? 4 : 3) * K - 1;
  const int n_raw = ((d + 1) / 2) * P;  // the widest conditioner output
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this warp's slice of shared memory: RPW rows of state, h1, h2 and raw
  float* x_s = smem + (size_t)warp * RPW * (d + 2 * H + n_raw);
  float* h1_s = x_s + RPW * d;
  float* h2_s = h1_s + RPW * H;
  float* raw_s = h2_s + RPW * H;

  const long long row0 = ((long long)blockIdx.x * kWarps + warp) * RPW;
  if (row0 >= B) return;
  const int n_rows = (int)min((long long)RPW, (long long)B - row0);

  const float* xg = x + row0 * d;
  for (int e = lane; e < RPW * d; e += 32) x_s[e] = e < n_rows * d ? xg[e] : 0.f;
  __syncwarp();

  float ld[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) ld[i] = 0.f;

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

    dense_tanh<RPW>(x_s, d, parity, 2, da, w1, b1, h1_s, H, lane);
    __syncwarp();
    dense_tanh<RPW>(h1_s, H, 0, 1, H, w2, b2, h2_s, H, lane);
    __syncwarp();

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
        for (int i = 0; i < RPW; ++i) raw_s[i * n_raw + c] = acc[i] + bc;
      }
    }
    __syncwarp();

    // the spline of transformed dim j; the writes touch no conditioning dim
    for (int j = lane; j < db; j += 32) {
      const int dim = 2 * j + 1 - parity;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        float* v = x_s + i * d + dim;
        if (i < n_rows && fabsf(*v) <= T) {
          const float2 o = spline_apply<LRS>(raw_s + i * n_raw + j * P, K, T, *v, inverse);
          *v = o.x;
          ld[i] += o.y;
        }
      }
    }
    __syncwarp();
  }

  float* yg = y + row0 * d;
  for (int e = lane; e < n_rows * d; e += 32) yg[e] = x_s[e];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    float v = ld[i];
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && i < n_rows) ld_out[row0 + i] = v;
  }
}

template <bool LRS, int RPW>
int launch(const float* x, const float* w, float* y, float* ld, int B, int d, int H, int L,
           int K, float T, int inverse, cudaStream_t stream, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(spline_stack_kernel<LRS, RPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kWarps * RPW;
  const unsigned grid = (unsigned)((B + rows_per_block - 1) / rows_per_block);
  spline_stack_kernel<LRS, RPW><<<grid, kThreads, smem, stream>>>(x, w, y, ld, B, d, H, L, K,
                                                                  T, inverse);
  return (int)cudaGetLastError();
}

template <bool LRS>
int dispatch(const float* x, const float* w, float* y, float* ld, int B, int d, int H, int L,
             int K, float T, int inverse, cudaStream_t s) {
  const int P = (LRS ? 4 : 3) * K - 1;
  const size_t per_row = (size_t)(d + 2 * H + ((d + 1) / 2) * P) * sizeof(float);
  // as in coupling.cu: the most rows per warp whose shared memory fits one
  // block and that still gives the 132 SMs two blocks each
  auto fits = [&](int rpw) {
    return kWarps * rpw * per_row <= kMaxSharedBytes && (long long)B >= 2LL * 132 * kWarps * rpw;
  };
  if (fits(4)) return launch<LRS, 4>(x, w, y, ld, B, d, H, L, K, T, inverse, s, kWarps * 4 * per_row);
  if (fits(2)) return launch<LRS, 2>(x, w, y, ld, B, d, H, L, K, T, inverse, s, kWarps * 2 * per_row);
  if (kWarps * per_row <= kMaxSharedBytes)
    return launch<LRS, 1>(x, w, y, ld, B, d, H, L, K, T, inverse, s, kWarps * per_row);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. Launches on `stream`
// and neither synchronises nor allocates. lrs selects the spline kind.
extern "C" int nfmc_spline_stack(const void* x, const void* weights, void* y, void* ld, int B,
                                 int d, int H, int L, int n_bins, float tail_bound, int inverse,
                                 int lrs, void* stream) {
  if (B <= 0) return 0;
  if (d < 2 || H < 1 || L < 1 || n_bins < 1) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(weights);
  float* yf = static_cast<float*>(y);
  float* lf = static_cast<float*>(ld);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lrs ? dispatch<true>(xf, wf, yf, lf, B, d, H, L, n_bins, tail_bound, inverse, s)
             : dispatch<false>(xf, wf, yf, lf, B, d, H, L, n_bins, tail_bound, inverse, s);
}
