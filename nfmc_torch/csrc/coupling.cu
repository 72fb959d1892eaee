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
// The TPU kernel takes its input in a packed [even | odd] event layout and
// W3 de-interleaved, permuted by the caller, because Mosaic has no strided
// gather; here the kernel lays each row out as [even | odd] in shared
// memory as it loads it, and reads W3's (shift, log-scale) columns in
// pairs, so the caller permutes nothing.
//
// What bounds it on an H100. A row costs 2 (da H + H H + 2 db H) FLOP a
// layer, ~285 kFLOP at d=100, H=128, L=4, against 804 bytes of input and
// output: FP32 arithmetic on paper (62 GFLOP, 0.93 ms, at the hoisted
// 218,400 rows). At the path's small batches (100 rows a jump, 256 a fit
// step, 3000 a validation) the bound is 0.4-13 us and the time goes to
// latency: each product of a layer waits for its weights (~575 KB for the
// stack, resident in L2) and the layers run one after another.
//
// Design (coupling_tile.cuh): a block of 256 threads owns R rows (8, 32
// or 64) for the whole stack. The rows' state (R x perm_width(d), in the
// [even | odd] layout, so a layer's conditioning half is the left operand
// of W1 as it stands) and two activation buffers (R x max(H, 128) each)
// stay in shared memory, and each of the three products of a layer is an
// (R x K) . (K x N) tile product. The weights stream through a ring of
// three 64 x 128 shared-memory slabs (34 KB each) with cp.async, two slabs
// ahead of the FMAs and across products and layers, so no FMA waits on an
// L2 load of its own; the next layer's hidden biases come the same way (the
// output layer's are read from L2 in its epilogue). Each
// thread sums an 8-row x 4-column register tile: per 4 k it reads 12 float4
// from shared memory for 128 FMAs. Below R=64 the 64 / R warps of a row
// group split each slab's k, and their partial tiles are summed in a fixed
// order. The output layer's raw values go to an activation buffer 128
// columns (64 transformed dims) at a time; after each chunk a pass over
// (row, dim) applies the shift and clamped log-scale, and one warp a row
// adds the chunk's log-scales to the row's log-det, in a fixed order.
// Shared memory a block (coupling_tile.cuh::tile_shared_bytes):
// (R (perm_width(d) + 2 max(H, 128) + 1) + 4 round4(H) + 64 * 128 (split-k,
// R < 64) + S * 128 * 68) * 4 bytes with a ring of S = 3 stages: 147 KB at
// R=8, 194 KB at R=64 for d=100, H=128, so one block an SM. A tile of 8 rows
// fits up to d = 2649 at H=128 with 3 stages; wider stacks run a ring of 2
// stages, up to d = 3737 (H=128), 2777 (H=512) or 1497 (H=1024). R is
// 8 or 32, the smaller whose blocks all run at once, else 64: on the
// H100's 132 SMs, B=100 and 256 take R=8 (13 and 32 blocks), B=3000 R=32
// (94 blocks), B=218,400 R=64 (3413 blocks, where arithmetic, not latency,
// sets the pace). Plain FP32 FMAs, accurate tanhf/expf (no fast-math), no
// tensor cores.
#include <cuda_runtime.h>

#include "coupling_common.cuh"
#include "coupling_tile.cuh"

namespace {

// One block an SM (its shared memory sees to that), so ptxas may give a
// thread up to 255 registers; without the hint it held the kernel to 128 and
// spilled.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
coupling_stack_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                      float* __restrict__ y, float* __restrict__ ld_out, int B, int d, int H,
                      int L, float clamp, int inverse, int stages) {
  extern __shared__ float smem[];
  const int xs = perm_width(d), aw = act_width(H), odd = perm_slot(1, d);
  float* x_s = smem;          // R x xs: the rows' state, [even | odd]
  float* ha = x_s + R * xs;   // R x aw: h1, then a chunk of the raw output
  float* hb = ha + R * aw;    // R x aw: h2
  float* ld_s = hb + R * aw;  // R: the log-dets
  const int bw = bias_floats(H);
  float* bias_s = ld_s + R;   // 2 x bw: the hidden biases of this layer and the next
  float* red = bias_s + 2 * bw;  // split-k partial tiles
  // per layer in the order of application: W1 (da, H), W2 (H, H), W3 (H, 2 db)
  auto sched = [=](int q) {
    const int l = inverse ? L - 1 - q / 3 : q / 3;
    const int da = cond_size(l, d);
    const float* w1 = wts + layer_offset(l, d, H);
    const float* w2 = w1 + (size_t)da * H + H;
    if (q % 3 == 0) return Gemm{w1, da, H, false};
    if (q % 3 == 1) return Gemm{w2, H, H, false};
    return Gemm{w2 + (size_t)H * H + H, H, 2 * (d - da), false};
  };
  auto biases = [&](int step) {  // of layer step, into buffer step % 2
    const int l = inverse ? L - 1 - step : step;
    copy_biases(wts + layer_offset(l, d, H), cond_size(l, d), H, bias_s + (step % 2) * bw);
  };
  WeightStream<decltype(sched)> ws{red + red_floats(R), sched, 3 * L, stages};
  biases(0);
  ws.start();

  const long long row0 = (long long)blockIdx.x * R;
  const int n_rows = (int)min((long long)R, (long long)B - row0);
  // zero the padding (rows past B, the halves' padding), then copy the
  // block's rows, which are contiguous in x
  for (int e = threadIdx.x; e < R * (xs + 2 * aw + 1); e += kThreads) smem[e] = 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * d; e += kThreads)
    x_s[(e / d) * xs + perm_slot(e % d, d)] = x[row0 * d + e];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int step = 0; step < L; ++step) {
    const int l = inverse ? L - 1 - step : step;
    const int parity = l % 2;
    const int da = cond_size(l, d);
    const int db = d - da;
    const float* b1 = bias_s + (step % 2) * bw;
    const float* b2 = b1 + round4(H);
    const float* b3 = wts + layer_offset(l, d, H) + (size_t)(da + H + 2) * H + (size_t)H * 2 * db;
    float* vb_s = x_s + (parity ? 0 : odd);  // transformed dim j at slot j

    __syncthreads();
    if (step + 1 < L) biases(step + 1);
    tile_gemm<R>(ws, x_s + (parity ? odd : 0), xs, red,
                 [&](int r, int n, float v) { ha[r * aw + n] = tanhf(v + b1[n]); });
    tile_gemm<R>(ws, ha, aw, red, [&](int r, int n, float v) { hb[r * aw + n] = tanhf(v + b2[n]); });
    // the conditioner output, 128 columns (64 transformed dims) a chunk, each
    // applied before the next: transformed dim j from its (shift, raw
    // log-scale) pair; the log-scale replaces the raw value, and each row's
    // log-det gains the chunk's sum
    tile_gemm<R>(
        ws, hb, aw, red,
        [&](int r, int n, float v) { ha[r * aw + n % kChunkN] = v + __ldg(b3 + n); },
        [&](int n0) {
          const int j0 = n0 / 2, nj = min(kChunkN / 2, db - j0);
          for (int e = threadIdx.x; e < R * nj; e += kThreads) {
            const int r = e / nj, jj = e % nj;
            float* raw = ha + r * aw + 2 * jj;
            const float ls = clamp * tanhf(raw[1] / clamp);
            float* v = vb_s + r * xs + j0 + jj;
            *v = inverse ? *v * expf(ls) + raw[0] : (*v - raw[0]) * expf(-ls);
            raw[1] = ls;
          }
          __syncthreads();
          for (int r = warp; r < R; r += kThreads / 32) {
            float sum = 0.f;
            for (int jj = lane; jj < nj; jj += 32) sum += ha[r * aw + 2 * jj + 1];
            for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (lane == 0) ld_s[r] += inverse ? sum : -sum;
          }
        });
  }

  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * d; e += kThreads)
    y[row0 * d + e] = x_s[(e / d) * xs + perm_slot(e % d, d)];
  if (threadIdx.x < n_rows) ld_out[row0 + threadIdx.x] = ld_s[threadIdx.x];
}

template <int R>
int launch(const float* x, const float* w, float* y, float* ld, int B, int d, int H, int L,
           float clamp, int inverse, int stages, cudaStream_t stream) {
  const size_t smem = tile_shared_bytes(R, stages, d, H);
  const cudaError_t err = cudaFuncSetAttribute(
      coupling_stack_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((B + R - 1) / R);
  coupling_stack_kernel<R><<<grid, kThreads, smem, stream>>>(
      x, w, y, ld, B, d, H, L, clamp, inverse, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared bytes a block of the smallest tile (8 rows, a ring of 2 stages)
// needs: above 232448 the launcher refuses with kErrTileTooLarge.
extern "C" long long nfmc_coupling_tile_bytes(int d, int H) {
  return (long long)tile_shared_bytes(8, 2, d, H);
}

// Returns a cudaError_t: 0 when the launch was accepted, kErrTileTooLarge
// (cudaErrorInvalidConfiguration) without a launch when no row tile fits a
// block. Launches on `stream` and neither synchronises nor allocates.
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
  int n_sm = 0;
  const cudaError_t err = sm_count(&n_sm);
  if (err != cudaSuccess) return (int)err;
  const TileConfig t = row_tile(
      B, n_sm, [&](int rows, int stages) { return tile_shared_bytes(rows, stages, d, H); });
  switch (t.rows) {
    case 64: return launch<64>(xf, wf, yf, lf, B, d, H, L, clamp, inverse, t.stages, s);
    case 32: return launch<32>(xf, wf, yf, lf, B, d, H, L, clamp, inverse, t.stages, s);
    case 8: return launch<8>(xf, wf, yf, lf, B, d, H, L, clamp, inverse, t.stages, s);
  }
  return kErrTileTooLarge;
}
