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
// only because Mosaic has no strided gather; here the kernel lays each row
// out as [even | odd] in shared memory as it loads it, and the caller
// permutes nothing.
//
// What bounds it on an H100: FP32 arithmetic on paper. A row costs
// 2 (da H + H H + P db H) FLOP per layer plus the splines, 1.36 MFLOP (RQS)
// or 1.77 MFLOP (LRS) at d=100, H=128, L=4, K=8, against 804 bytes of input
// and output; W3 is 87% (RQS) or 90% (LRS) of the products. At one jump's
// 100 rows the time goes to latency: the products of a layer wait for their
// weights (2.7 MB (RQS) or 3.6 MB (LRS) at L=4, resident in L2) and for one
// another, and the splines for their raw values.
//
// Design: the block row-tile engine of coupling.cu (coupling_tile.cuh). A
// block of 256 threads owns R rows (8, 32 or 64) for the whole stack, the
// rows' state in shared memory in the [even | odd] layout, so a layer's
// conditioning half is W1's operand in place; W1 and W2 are tile products
// with their slabs streamed through the cp.async ring. The output layer is
// P db columns wide (1150 for RQS, 1550 for LRS at d=100) and a spline dim
// needs all P of its raw values at once, so it is applied one chunk of
// nd = floor(128 / P) whole dims at a time (5 dims, 115 of 128 columns for
// RQS at K=8; 4 dims, 124 columns for LRS): chunk c is a product of its own
// with the columns c nd P .. of W3 (Gemm::ld, no copy of W3 in another
// layout; the slab's columns past the chunk are zero, which costs 10% (RQS)
// or 3% (LRS) more W3 FMAs), its raw values land in an activation buffer,
// and one thread a (row, dim) of the chunk runs spline_apply on them before
// the next chunk is produced. At R=8 a chunk has only 40 (RQS) or 32 (LRS)
// spline evaluations for 256 threads, so eight chunks are produced into a
// group buffer (32 KB) before their splines run together: a spline's
// latency (microseconds for one thread) is paid once for eight chunks.
// Each row's log-det is summed over its dims and layers in order. The
// inverse runs the same code with the layers reversed. Shared memory a
// block: coupling.cu's (coupling_tile.cuh::tile_shared_bytes) and, at R=8,
// the group buffer (spline_tile.cuh::spline_shared_bytes): a row needs
// perm_width(d) + 2 max(H, 128) + 1 floats whatever P is, so a tile of 8
// rows fits up to d = 1625 at H=128 with a ring of 3 stages and 2713 with
// 2; wider stacks are refused before the launch (nfmc_spline_tile_bytes).
// Plain FP32 FMAs, accurate expf/logf/sqrtf (no fast-math), no tensor
// cores.
#include <cuda_runtime.h>

#include "coupling_common.cuh"
#include "coupling_tile.cuh"
#include "spline_common.cuh"
#include "spline_tile.cuh"

namespace {

// One block an SM (its shared memory sees to that): up to 255 registers a
// thread, as in coupling.cu.
template <bool LRS, int R>
__global__ void __launch_bounds__(kThreads, 1)
spline_stack_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                    float* __restrict__ y, float* __restrict__ ld_out, int B, int d, int H,
                    int L, int K, float T, int inverse, int stages) {
  extern __shared__ float smem[];
  const int P = spline_params(LRS, K), nd = chunk_dims(P);
  const int xs = perm_width(d), aw = act_width(H), odd = perm_slot(1, d);
  float* x_s = smem;          // R x xs: the rows' state, [even | odd]
  float* ha = x_s + R * xs;   // R x aw: h1, then (R > 8) a chunk of the raw output
  float* hb = ha + R * aw;    // R x aw: h2
  float* ld_s = hb + R * aw;  // R: the log-dets
  const int bw = bias_floats(H);
  float* bias_s = ld_s + R;   // 2 x bw: the hidden biases of this layer and the next
  float* red = bias_s + 2 * bw;  // split-k partial tiles
  constexpr int G = chunk_group(R);
  float* grp = red + red_floats(R);  // R x G x 128 (G > 1): a group of chunks' raw values
  float* raw_s = G > 1 ? grp : ha;   // where the raw values land, rows rs floats apart
  const int rs = G > 1 ? G * kChunkN : aw;
  const SplineForwardSchedule sched{wts, d, H, L, P, inverse};
  auto biases = [&](int step) {  // of layer step, into buffer step % 2
    const int l = inverse ? L - 1 - step : step;
    copy_biases(wts + layer_offset(l, d, H, P), cond_size(l, d), H, bias_s + (step % 2) * bw);
  };
  WeightStream<SplineForwardSchedule> ws{grp + group_floats(R), sched, sched.total(), stages};
  biases(0);
  ws.start();

  const long long row0 = (long long)blockIdx.x * R;
  const int n_rows = (int)min((long long)R, (long long)B - row0);
  for (int e = threadIdx.x; e < R * (xs + 2 * aw + 1); e += kThreads) smem[e] = 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * d; e += kThreads)
    x_s[(e / d) * xs + perm_slot(e % d, d)] = x[row0 * d + e];
  for (int e = threadIdx.x; e < (int)group_floats(R); e += kThreads) grp[e] = 0.f;
  // dim jj of a group: its raw values in chunk jj / nd, at (jj % nd) P
  auto raw_of = [&](int r, int jj) { return raw_s + r * rs + (jj / nd) * kChunkN + (jj % nd) * P; };

  for (int step = 0; step < L; ++step) {
    const int l = inverse ? L - 1 - step : step;
    const int parity = l % 2;
    const int da = cond_size(l, d);
    const int db = d - da;
    const float* b1 = bias_s + (step % 2) * bw;
    const float* b2 = b1 + round4(H);
    const float* b3 = wts + layer_offset(l, d, H, P) + (size_t)(da + H + 2) * H + (size_t)H * P * db;
    float* vb_s = x_s + (parity ? 0 : odd);  // transformed dim j at slot j

    __syncthreads();
    if (step + 1 < L) biases(step + 1);
    tile_gemm<R>(ws, x_s + (parity ? odd : 0), xs, red,
                 [&](int r, int n, float v) { ha[r * aw + n] = tanhf(v + b1[n]); });
    tile_gemm<R>(ws, ha, aw, red, [&](int r, int n, float v) { hb[r * aw + n] = tanhf(v + b2[n]); });
    for (int j0 = 0; j0 < db; j0 += G * nd) {
      const int nj = min(G * nd, db - j0);
      // the raw values of dims j0 .. j0 + nj - 1, dim-major, a chunk of nd
      // dims a product
      for (int g = 0; g * nd < nj; ++g)
        tile_gemm<R>(ws, hb, aw, red, [&](int r, int n, float v) {
          raw_s[r * rs + g * kChunkN + n] = v + __ldg(b3 + (size_t)(j0 + g * nd) * P + n);
        });
      // the spline of each (row, dim); its log-det replaces the dim's first
      // raw value, which no other thread reads
      for (int e = threadIdx.x; e < R * nj; e += kThreads) {
        const int r = e / nj, jj = e % nj;
        float* raw = raw_of(r, jj);
        float* v = vb_s + r * xs + j0 + jj;
        float ld = 0.f;
        if (r < n_rows && fabsf(*v) <= T) {
          const float2 o = spline_apply<LRS>(raw, K, T, *v, inverse);
          *v = o.x;
          ld = o.y;
        }
        raw[0] = ld;
      }
      __syncthreads();
      if (threadIdx.x < R) {
        float sum = ld_s[threadIdx.x];
        for (int jj = 0; jj < nj; ++jj) sum += *raw_of(threadIdx.x, jj);
        ld_s[threadIdx.x] = sum;
      }
    }
  }

  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * d; e += kThreads)
    y[row0 * d + e] = x_s[(e / d) * xs + perm_slot(e % d, d)];
  if (threadIdx.x < n_rows) ld_out[row0 + threadIdx.x] = ld_s[threadIdx.x];
}

template <bool LRS, int R>
int launch(const float* x, const float* w, float* y, float* ld, int B, int d, int H, int L, int K,
           float T, int inverse, int stages, cudaStream_t stream) {
  const size_t smem = spline_shared_bytes(R, stages, d, H);
  const cudaError_t err = cudaFuncSetAttribute(
      spline_stack_kernel<LRS, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((B + R - 1) / R);
  spline_stack_kernel<LRS, R><<<grid, kThreads, smem, stream>>>(
      x, w, y, ld, B, d, H, L, K, T, inverse, stages);
  return (int)cudaGetLastError();
}

template <bool LRS>
int dispatch(const float* x, const float* w, float* y, float* ld, int B, int d, int H, int L,
             int K, float T, int inverse, cudaStream_t s) {
  int n_sm = 0;
  const cudaError_t err = sm_count(&n_sm);
  if (err != cudaSuccess) return (int)err;
  const TileConfig t = row_tile(
      B, n_sm, [&](int rows, int stages) { return spline_shared_bytes(rows, stages, d, H); });
  switch (t.rows) {
    case 64: return launch<LRS, 64>(x, w, y, ld, B, d, H, L, K, T, inverse, t.stages, s);
    case 32: return launch<LRS, 32>(x, w, y, ld, B, d, H, L, K, T, inverse, t.stages, s);
    case 8: return launch<LRS, 8>(x, w, y, ld, B, d, H, L, K, T, inverse, t.stages, s);
  }
  return kErrTileTooLarge;
}

}  // namespace

// Shared bytes a block of the smallest tile (8 rows, a ring of 2 stages)
// needs: above 232448 the launcher refuses with kErrTileTooLarge.
extern "C" long long nfmc_spline_tile_bytes(int d, int H) {
  return (long long)spline_shared_bytes(8, 2, d, H);
}

// Returns a cudaError_t: 0 when the launch was accepted; kErrTileTooLarge
// (cudaErrorInvalidConfiguration) without a launch when no row tile fits a
// block; cudaErrorInvalidValue when a dim's P raw values exceed an output
// chunk (P > 128: K > 43 for RQS, K > 32 for LRS). Launches on `stream` and
// neither synchronises nor allocates. lrs selects the spline kind.
extern "C" int nfmc_spline_stack(const void* x, const void* weights, void* y, void* ld, int B,
                                 int d, int H, int L, int n_bins, float tail_bound, int inverse,
                                 int lrs, void* stream) {
  if (B <= 0) return 0;
  if (d < 2 || H < 1 || L < 1 || n_bins < 1 || spline_params(lrs, n_bins) > kChunkN)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(weights);
  float* yf = static_cast<float*>(y);
  float* lf = static_cast<float*>(ld);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lrs ? dispatch<true>(xf, wf, yf, lf, B, d, H, L, n_bins, tail_bound, inverse, s)
             : dispatch<false>(xf, wf, yf, lf, B, d, H, L, n_bins, tail_bound, inverse, s);
}
