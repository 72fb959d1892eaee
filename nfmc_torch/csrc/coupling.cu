// RealNVP affine-coupling stack, forward or inverse, as one CUDA kernel.
//
// Replaces the Pallas TPU kernel nfmc_tpu/ops/coupling_pallas.py::_kernel.
// For each row of x (B, d) it runs all L coupling layers. Layer l conditions
// on the dimensions i with (i + l) % 2 == 0 and transforms the others:
//
//   h1  = tanh(va . W1 + b1)          va: (da,)   W1: (da, H)
//   h2  = tanh(h1 . W2 + b2)          W2: (H, H)
//   raw = h2 . W3 + b3                W3: (H, 2 db), columns (shift_j, raw_ls_j)
//   t = raw[2j], ls = c tanh(raw[2j+1] / c)
//   forward: vb = (vb - t) exp(-ls), ld -= sum ls    (layers 0 .. L-1)
//   inverse: vb = vb exp(ls) + t,    ld += sum ls    (layers L-1 .. 0)
//
// The weights arrive as one contiguous f32 buffer in the canonical layout of
// the parameter pytree: per layer w1, b1, w2, b2, w3, b3, each row-major.
// The TPU kernel's packed [even | odd] event layout and de-interleaved W3
// exist only because Mosaic has no strided gather; here the conditioning
// half is read with stride 2 from shared memory and W3's (shift, log-scale)
// columns are read in pairs, so the caller permutes nothing.
//
// What bounds it on an H100: FP32 arithmetic. A row costs
// 2 (da H + H H + 2 db H) FLOP per layer, ~285 kFLOP at d=100, H=128, L=4,
// against 804 bytes of input and output, so at the hoisted batch of
// 218,400 rows it is ~62 GFLOP against ~175 MB. At one jump's 100 rows the
// launch latency dominates. Design: every warp owns RPW rows for the whole
// stack, keeping the rows' state and both hidden activations in shared
// memory (no device-memory traffic between layers, no block-wide barrier),
// and each lane accumulates RPW rows of one output column in registers, so
// one weight load (from L1/L2: the ~575 KB of weights stay in L2) feeds RPW
// FMAs and the activation reads are shared-memory broadcasts. Plain FP32
// FMAs, accurate tanhf/expf (no fast-math), no tensor cores.
#include <cuda_runtime.h>

#include "coupling_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block can opt into

template <int RPW>
__global__ void __launch_bounds__(kThreads)
coupling_stack_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                      float* __restrict__ y, float* __restrict__ ld_out, int B,
                      int d, int H, int L, float clamp, int inverse) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this warp's slice of shared memory: RPW rows of state, h1 and h2
  float* x_s = smem + (size_t)warp * RPW * (d + 2 * H);
  float* h1_s = x_s + RPW * d;
  float* h2_s = h1_s + RPW * H;

  const long long row0 = ((long long)blockIdx.x * kWarps + warp) * RPW;
  if (row0 >= B) return;
  const int n_rows = (int)min((long long)RPW, (long long)B - row0);

  // the warp's rows are contiguous in x: a coalesced copy, zero-padded
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
    const float* w1 = wts + layer_offset(l, d, H);
    const float* b1 = w1 + (size_t)da * H;
    const float* w2 = b1 + H;
    const float* b2 = w2 + (size_t)H * H;
    const float* w3 = b2 + H;
    const float* b3 = w3 + (size_t)H * 2 * db;

    // conditioning dims are parity, parity + 2, ...: stride 2 in x_s
    dense_tanh<RPW>(x_s, d, parity, 2, da, w1, b1, h1_s, H, lane);
    __syncwarp();
    dense_tanh<RPW>(h1_s, H, 0, 1, H, w2, b2, h2_s, H, lane);
    __syncwarp();

    // output layer fused with the affine update of transformed dim j,
    // which sits at 2 j + 1 - parity; the writes touch no conditioning dim
    const int n_out = 2 * db;
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
          const float ls = clamp * tanhf((acc_s[i] + bs) / clamp);
          float* v = x_s + i * d + dim;
          if (inverse) {
            *v = *v * expf(ls) + t;
            ld[i] += ls;
          } else {
            *v = (*v - t) * expf(-ls);
            ld[i] -= ls;
          }
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

template <int RPW>
int launch(const float* x, const float* w, float* y, float* ld, int B, int d,
           int H, int L, float clamp, int inverse, cudaStream_t stream,
           size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      coupling_stack_kernel<RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kWarps * RPW;
  const unsigned grid = (unsigned)((B + rows_per_block - 1) / rows_per_block);
  coupling_stack_kernel<RPW><<<grid, kThreads, smem, stream>>>(
      x, w, y, ld, B, d, H, L, clamp, inverse);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. Launches on `stream`
// and neither synchronises nor allocates.
extern "C" int nfmc_coupling_stack(const void* x, const void* weights, void* y,
                                   void* ld, int B, int d, int H, int L,
                                   float clamp, int inverse, void* stream) {
  if (B <= 0) return 0;
  if (d < 2 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(weights);
  float* yf = static_cast<float*>(y);
  float* lf = static_cast<float*>(ld);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t per_row = (size_t)(d + 2 * H) * sizeof(float);
  // The most rows per warp (more reuse of each weight load) whose shared
  // memory fits one block and that still gives the 132 SMs two blocks each;
  // a small batch (one jump's 100 rows) takes one row per warp instead.
  auto fits = [&](int rpw) {
    return kWarps * rpw * per_row <= kMaxSharedBytes &&
           (long long)B >= 2LL * 132 * kWarps * rpw;
  };
  if (fits(8))
    return launch<8>(xf, wf, yf, lf, B, d, H, L, clamp, inverse, s, kWarps * 8 * per_row);
  if (fits(4))
    return launch<4>(xf, wf, yf, lf, B, d, H, L, clamp, inverse, s, kWarps * 4 * per_row);
  if (fits(2))
    return launch<2>(xf, wf, yf, lf, B, d, H, L, clamp, inverse, s, kWarps * 2 * per_row);
  if (kWarps * per_row <= kMaxSharedBytes)
    return launch<1>(xf, wf, yf, lf, B, d, H, L, clamp, inverse, s, kWarps * per_row);
  return (int)cudaErrorInvalidValue;
}
