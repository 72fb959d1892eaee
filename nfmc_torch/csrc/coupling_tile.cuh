// The block row-tile engine of the RealNVP kernels (coupling.cu,
// coupling_bwd.cu): a block of 256 threads owns R rows (8, 32 or 64) and
// computes each row-local product of the stack as an (R x K) . (K x N) tile
// product, the left operand in shared memory.
//
// State layout. A row's d values sit in shared memory as [even dims | odd
// dims], each half padded to a multiple of 4 floats (perm_slot), so a
// layer's conditioning half is a contiguous, aligned left operand and its
// transformed dim j is slot j of the other half: no buffer holds a copy of
// either, and the activation buffers are max(H, 128) floats wide whatever
// d is. The output layer's 2 db raw values are produced 128 columns at a
// time into an activation buffer, and the affine update consumes each
// chunk before the next (tile_gemm's chunk_end).
//
// Weights. The products a kernel runs, and so the weight slabs it reads,
// follow a fixed schedule (per layer W1, W2, W3, and in the backward W3^T,
// W2^T, W1^T), so one stream serves them all: slabs of kSlabK = 64 rows of
// the reduction dim by kChunkN = 128 output columns are copied from device
// memory (L2) into a ring of kStages = 3 shared-memory stages (34 KB each)
// with cp.async (16-byte copies where W is aligned), kStages - 1 slabs ahead
// of the FMAs, across product and layer boundaries. A slab costs one block
// barrier. Where a tile of 8 rows does not fit a block with 3 stages (wide
// stacks), the launchers run a ring of 2 stages, one slab ahead
// (row_tile). A product may take a block of columns of a wider matrix
// (Gemm::ld, the row stride of W): the output layer's columns one chunk at
// a time, each chunk a product of its own. A product whose reduction dim
// is the output layer's (the backward's W3^T) then runs one chunk of its
// left operand at a time, each chunk's epilogue adding into the sum of the
// chunks before it, in the chunks' order.
//   normal      out[r][n] = sum_k A[r][k] W[k][n],  W (K, N) row-major;
//               stored [k][n], a row of 128 floats;
//   transposed  out[r][n] = sum_k A[r][k] W[n][k],  W (N, K) row-major
//               (the backward's products with W^T); copied along k, which
//               is contiguous in device memory, and stored [n][k] with a
//               row of 68 floats (16-byte aligned, and 8 consecutive rows
//               cover the 32 banks, so a lane's float4 read along k is
//               conflict-free).
//
// Register tile. Each thread sums 8 rows x 4 columns in registers: per 4 k
// it reads 8 float4 of activations (its rows) and 4 float4 of weights for
// 128 FMAs, 0.375 floats from shared memory an FMA (a warp-wide float4
// broadcast still returns 16 bytes to every lane). A block of R rows has
// R / 8 row groups of warps, and the 64 / R warps of a group split each
// slab's k among them (R=8: 8 warps of 8 k each; R=64: one warp, 64 k);
// their partial tiles are summed through shared memory in a fixed order
// (no atomics). Lane c takes the columns 4c .. 4c + 3 of a normal slab
// (one float4 a k) and c, c + 32, c + 64, c + 96 of a transposed one.
#pragma once
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;                       // 8 warps
constexpr int kSlabK = 64;                          // reduction rows a slab
constexpr int kChunkN = 128;                        // output columns a slab
constexpr int kTStride = kSlabK + 4;                // row of a transposed slab
constexpr int kStageFloats = kChunkN * kTStride;    // 8704 (a normal slab: 8192)
constexpr int kStages = 3;                          // ring depth (2 for wide stacks)
constexpr int kRedFloats = 64 * kChunkN;            // split-k partial tiles
constexpr size_t kMaxSharedBytes = 232448;          // 227 KB a block can opt into
// What a launcher returns, before launching, when not even a tile of 8 rows
// fits a block's shared memory: a code of its own, which the wrappers turn
// into an error naming the bytes (nfmc_coupling_tile_bytes).
constexpr int kErrTileTooLarge = cudaErrorInvalidConfiguration;

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// One product's weights: W (K, N) row-major, or (N, K) when trans, each row
// ld floats apart (0: dense, N or K); a block of columns of a wider matrix
// has the wider matrix's row stride.
struct Gemm {
  const float* W;
  int K, N;
  bool trans;
  int ld = 0;
  __host__ __device__ int stride() const { return ld ? ld : (trans ? K : N); }
};

// Copy slab (k0, n0) of g into a stage; elements outside (K, N) are zeroed.
__device__ __forceinline__ void copy_slab(const Gemm& g, int k0, int n0, float* stage) {
  const size_t ld = g.stride();
  const bool vec = reinterpret_cast<size_t>(g.W) % 16 == 0 && ld % 4 == 0 &&
                   (g.trans ? g.K : g.N) % 4 == 0;
  if (vec) {
    for (int e = threadIdx.x; e < kSlabK * kChunkN / 4; e += kThreads) {
      const int kk = g.trans ? (e % (kSlabK / 4)) * 4 : e / (kChunkN / 4);
      const int nn = g.trans ? e / (kSlabK / 4) : (e % (kChunkN / 4)) * 4;
      const int k = k0 + kk, n = n0 + nn;
      float* dst = stage + (g.trans ? nn * kTStride + kk : kk * kChunkN + nn);
      if (k < g.K && n < g.N)
        __pipeline_memcpy_async(dst, g.W + (g.trans ? n * ld + k : k * ld + n), 16);
      else
        *reinterpret_cast<float4*>(dst) = float4{0.f, 0.f, 0.f, 0.f};
    }
  } else {
    for (int e = threadIdx.x; e < kSlabK * kChunkN; e += kThreads) {
      const int kk = g.trans ? e % kSlabK : e / kChunkN;
      const int nn = g.trans ? e / kSlabK : e % kChunkN;
      const int k = k0 + kk, n = n0 + nn;
      float* dst = stage + (g.trans ? nn * kTStride + kk : kk * kChunkN + nn);
      if (k < g.K && n < g.N)
        __pipeline_memcpy_async(dst, g.W + (g.trans ? n * ld + k : k * ld + n), 4);
      else
        *dst = 0.f;
    }
  }
}

// The block's stream of weight slabs: sched(q) is the q-th product of the
// kernel (q < n_gemms). Every thread of the block holds the same state.
template <class Schedule>
struct WeightStream {
  float* ring;  // stages * kStageFloats floats of shared memory, 16-byte aligned
  Schedule sched;
  int n_gemms;
  int stages;  // 3, or 2 (wide stacks)
  int q = -1;  // the product being issued, its geometry and next slab
  Gemm cur{nullptr, 0, 0, false};
  int k_slabs = 0, kt = 0, nt = 0;
  int issue_slot = 0, read_slot = 0;  // the ring's stages to fill and to read next
  int gemms_consumed = 0;

  // Issue the next slab, if any, as one cp.async group (an empty group
  // after the last, so that the groups stay counted).
  __device__ __forceinline__ void issue() {
    if (kt == k_slabs) {  // on to the next column chunk, or product
      kt = 0;
      if (++nt * kChunkN >= cur.N && q < n_gemms) {
        nt = 0;
        if (++q < n_gemms) {
          cur = sched(q);
          k_slabs = (cur.K + kSlabK - 1) / kSlabK;
        }
      }
    }
    if (q < n_gemms) {
      copy_slab(cur, kt * kSlabK, nt * kChunkN, ring + issue_slot * kStageFloats);
      ++kt;
    }
    __pipeline_commit();
    issue_slot = issue_slot + 1 == stages ? 0 : issue_slot + 1;
  }

  __device__ __forceinline__ void start() {
    for (int s = 0; s < stages - 1; ++s) issue();
  }

  // The stage holding the next slab, once every thread's copies of it have
  // landed; refills the stage consumed before it, which every thread has
  // finished reading by the barrier.
  __device__ __forceinline__ const float* next() {
    if (stages == 3)
      __pipeline_wait_prior(1);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
    const float* stage = ring + read_slot * kStageFloats;
    read_slot = read_slot + 1 == stages ? 0 : read_slot + 1;
    issue();
    return stage;
  }
};

// acc += A[8 rows][0 .. kn) . slab[kk .. kk + kn) (kn a multiple of 4; the
// slab's rows past K are 0 and A's columns past K finite). a: the thread's
// first row at the slab's first k of the warp; kk: that k within the slab.
template <bool TRANS>
__device__ __forceinline__ void slab_fma(float (&acc)[8][4], const float* a, int lda, int kn,
                                         const float* stage, int kk) {
  const int c = threadIdx.x % 32;
  for (int k = 0; k < kn; k += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * lda + k);
    float w[4][4];  // [k][column]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = TRANS
          ? *reinterpret_cast<const float4*>(stage + (c + 32 * j) * kTStride + kk + k)
          : *reinterpret_cast<const float4*>(stage + (kk + k + j) * kChunkN + 4 * c);
      // transposed: v holds 4 k of column j; normal: 4 columns of k j
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (TRANS)
          w[q][j] = e[q];
        else
          w[j][q] = e[q];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a4[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[q], w[q][j], acc[i][j]);
    }
  }
}

struct NoChunkEnd {
  __device__ void operator()(int) const {}
};

// The block's product with the stream's next weights: a_s the left operand
// (R rows of stride lda, a multiple of 4, in shared memory, 16-byte
// aligned; its columns K .. round4(K) finite); red: kRedFloats of shared
// memory for the split-k partial tiles (unused at R=64). Calls epi(r, n, v)
// for every output element, column chunk by column chunk (n0 = 0, 128,
// ...); after each chunk's epi a block barrier and chunk_end(n0), if given,
// before the next chunk's epi writes. Ends in a block barrier, so that
// every write is visible to the whole block on return. Every thread of the
// block calls it.
template <int R, class Stream, class Epi, class ChunkEnd = NoChunkEnd>
__device__ __forceinline__ void tile_gemm(Stream& ws, const float* a_s, int lda, float* red,
                                          Epi epi, ChunkEnd chunk_end = {}) {
  constexpr int KW = 64 / R;  // warps splitting k
  constexpr int RW = 8 / KW;  // row groups
  constexpr int KC = kSlabK / KW;
  const Gemm g = ws.sched(ws.gemms_consumed++);
  const int w = threadIdx.x / 32, c = threadIdx.x % 32;
  const int kw = w / RW, r0 = (w % RW) * 8;
  const float* a = a_s + r0 * lda + kw * KC;
  const int ks = (g.K + kSlabK - 1) / kSlabK;
  for (int n0 = 0; n0 < g.N; n0 += kChunkN) {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < ks; ++s) {
      const float* stage = ws.next();
      const int kn = min(KC, max(0, round4(g.K - s * kSlabK - kw * KC)));
      if (g.trans)
        slab_fma<true>(acc, a + s * kSlabK, lda, kn, stage, kw * KC);
      else
        slab_fma<false>(acc, a + s * kSlabK, lda, kn, stage, kw * KC);
    }
    const auto col = [&](int j) { return g.trans ? c + 32 * j : 4 * c + j; };
    if constexpr (KW == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + col(j) < g.N) epi(r0 + i, n0 + col(j), acc[i][j]);
    } else {
      float* mine = red + (kw * R + r0) * kChunkN;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mine[i * kChunkN + col(j)] = acc[i][j];
      __syncthreads();
      for (int e = threadIdx.x; e < R * kChunkN; e += kThreads) {
        float v = red[e];
#pragma unroll
        for (int p = 1; p < KW; ++p) v += red[p * R * kChunkN + e];
        const int n = n0 + e % kChunkN;
        if (n < g.N) epi(e / kChunkN, n, v);
      }
    }
    if constexpr (!std::is_same_v<ChunkEnd, NoChunkEnd>) {
      __syncthreads();  // the next chunk's epi waits on the stream's barrier
      chunk_end(n0);
    }
  }
  __syncthreads();
}

// Floats of a layer's hidden biases in shared memory (b1, b2, each from a
// 16-byte boundary); the output layer's b3 is read from device memory (L2)
// in its epilogue, so that its width does not cost shared memory.
__host__ __device__ inline int bias_floats(int H) { return 2 * round4(H); }

// Copy the hidden biases of the layer at weights w1 (da x H) into dst with
// cp.async. They join the next cp.async group the stream commits, which
// has landed once the stream has consumed stages - 1 more slabs: before
// the epilogue of the next layer's first product when they are issued at
// the start of a layer for the next one.
__device__ __forceinline__ void copy_biases(const float* w1, int da, int H, float* dst) {
  const float* b1 = w1 + (size_t)da * H;
  const float* b2 = b1 + H + (size_t)H * H;
  for (int e = threadIdx.x; e < H; e += kThreads) {
    __pipeline_memcpy_async(dst + e, b1 + e, 4);
    __pipeline_memcpy_async(dst + round4(H) + e, b2 + e, 4);
  }
}

// Width of the activation buffers: H, or one column chunk of the output
// layer's raw values if wider.
__host__ __device__ inline int act_width(int H) { return round4(H) > kChunkN ? round4(H) : kChunkN; }

// Floats of a row's state in the [even | odd] layout, and the slot of dim i;
// the odd half starts at perm_slot(1, d).
__host__ __device__ inline int perm_width(int d) { return round4((d + 1) / 2) + round4(d / 2); }
__host__ __device__ __forceinline__ int perm_slot(int i, int d) {
  return (i % 2 == 0) ? i / 2 : round4((d + 1) / 2) + i / 2;
}

// Shared floats of the split-k partial tiles a block of R rows needs.
__host__ __device__ inline size_t red_floats(int rows) { return rows < 64 ? kRedFloats : 0; }

// Shared bytes of a block of `rows` rows with a ring of `stages` stages, in
// the layout every kernel on this engine keeps: per row the state
// (perm_width(d): the rows' values, or after a backward's recompute their
// cotangents), two activation buffers (act_width(H)) and one float (the
// log-det, or its cotangent); two layers' hidden biases; the split-k
// partial tiles; the ring.
inline size_t tile_shared_bytes(int rows, int stages, int d, int H) {
  return ((size_t)rows * (perm_width(d) + 2 * act_width(H) + 1) + 2 * bias_floats(H) +
          red_floats(rows) + (size_t)stages * kStageFloats) * sizeof(float);
}

// A launch's row tile and ring depth.
struct TileConfig {
  int rows, stages;
};

// The tile of a block for B rows on a card of n_sm SMs: 8 or 32 rows, the
// smaller whose blocks all run at once, one an SM (the fewer rows a block,
// the shorter its chain of products), else the largest up to max_rows (64:
// the most FMAs for each weight read); only tiles whose shared memory with
// a ring of kStages stages (bytes(rows, stages)) fits a block. Where none
// fits, 8 rows with a ring of 2 stages, if that fits. rows = 0 if nothing
// fits.
template <class Bytes>
TileConfig row_tile(long long B, int n_sm, Bytes bytes, int max_rows = 64) {
  constexpr int kTiles[] = {8, 32, 64};
  TileConfig fit{0, kStages};
  for (const int rows : kTiles) {
    if (rows > max_rows || bytes(rows, kStages) > kMaxSharedBytes) continue;
    fit.rows = rows;
    if ((B + rows - 1) / rows <= n_sm) return fit;
  }
  if (fit.rows == 0 && bytes(8, 2) <= kMaxSharedBytes) fit = TileConfig{8, 2};
  return fit;
}

// The SM count of the current device.
inline cudaError_t sm_count(int* n_sm) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace
