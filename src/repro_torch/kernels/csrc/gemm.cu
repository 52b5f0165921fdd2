// Tiled GEMMs for Hopper: the port of the matmul and gated-MLP Pallas
// kernels.
//
// Replaces (src/repro/kernels/):
//   matmul.py:_mm_kernel          -> gemm_kernel<T, T>, gemv_kernel,
//                                    wgmma_kernel     (repro_gemm, out_f32=0)
//   mlp_matmul.py:_split_mm_kernel -> the same three, f32 out (out_f32=1)
//   mlp_matmul.py:_fused_kernel   -> gated_kernel, gated_wgmma_kernel
//                                    (repro_gemm_gated)
//   mlp_matmul.py:_stream_kernel  -> stream_kernel, stream_gemv_kernel
//                                    (repro_gemm_stream)
//
// The GEMM table (GEMM_TILES below, kernels/matmul.py GEMM_TILES on the
// Python side) holds three families of tiles; the H100 analysis ranks
// them together and the pick is what launches.
//
// SIMT tiles (gemm_kernel).  One block per BM x BN output tile; the
// Pallas grid's sequential K axis becomes a loop inside the block.  Each
// K step stages an A tile (BM x BK, stored transposed) and a B tile
// (BK x BN) in shared memory; each of the (BM/TM)*(BN/TN) threads keeps
// a TM x TN micro-tile of f32 accumulators in registers, reading its A
// and B fragments interleaved (thread t owns columns t, t+BN/TN, ...) so
// a warp reads consecutive shared-memory words.  Edges are masked (zero
// loads, guarded stores), so no shape has to divide a tile.  Bound on
// the H100 by the FP32 FMA rate of the CUDA cores (67 TFLOP/s, not the
// 989 of the tensor cores); loads and FMAs do not overlap.  They are
// the route for f32 products of any size.
//
// Decode family: split-K GEMV tiles (gemv_kernel, f32 and bf16).  At
// small M the product reads the (K, N) weight once and is bound by
// device memory; N/BN column blocks alone would fill a tenth of the 132
// SMs, so the K axis is cut into SPLIT slices (grid (N/BN, SPLIT,
// M/BM)).  Each lane owns 16 contiguous bytes of a B row (8 bf16 or 4
// f32 columns, one 16-byte load), so a warp reads 512 contiguous bytes
// of each row; the 8 warps of a block take interleaved 8-row chunks of
// the slice, so a lane has 8 loads (128 bytes) in flight and a block
// 32 KB; the chunk's 8 values of each of A's BM rows come as broadcast
// 16-byte loads; each lane keeps BM x (8 or 4) f32 accumulators.  The
// warps' sums meet in shared memory in warp order.  A ragged N, or a B
// whose rows are not 16-byte aligned, takes a scalar path per lane (A
// likewise), and a slice's ragged last chunk a row at a time.
//
// Prefill family: TMA + wgmma tiles (wgmma_kernel, bf16 only).  A 128 x
// BN output tile per block, 3 warpgroups: warpgroup 0's first thread
// keeps a ring of STAGES shared-memory stages filled with TMA loads (A
// 128 x 64, K-major; B 64 x BN read in place from the row-major (K, N)
// weight as 64-column boxes, N-major; 128-byte swizzle), guarded by a
// full and an empty mbarrier per stage; warpgroups 1 and 2 each run
// wgmma m64nBNk16 over their 64 rows (B through the transpose bit) and
// store the masked result.  TMA zero-fills out-of-range rows and
// columns, so only K % 8 == 0 and N % 8 == 0 (16-byte row pitches) and
// 16-byte-aligned bases are required.  Bound by the tensor cores at
// large M and by the weight read at small M.  Left for later: a
// persistent grid, clusters with TMA multicast, overlapping one
// k-block's MMAs with the next's wait.
//
// Split-K (both new families, SPLIT > 1): each K slice writes f32
// partials to a caller-allocated workspace [SPLIT, M, N], and
// splitk_reduce_kernel sums them in slice order and stores in the
// output type, so results are bitwise repeatable.  Such a tile is two
// launches of the library per call (the Python wrapper still counts
// one call).
//
// The gated MLP, act(X.Wg) * (X.Wu), has two tables of its own (GATED_*
// and STREAM_* below, kernels/mlp_matmul.py on the Python side), each a
// SIMT family and a Hopper family:
//
// Tiled regime (prefill): TMA + wgmma gated tiles (gated_wgmma_kernel,
// bf16 only).  wgmma_kernel's shape with two weights: each stage of the
// TMA ring holds one X box (128 x 64, K-major) and a Wg and a Wu box
// (64 x BN each, read N-major in place), so X is staged once for both
// products; each consumer warpgroup runs two wgmma chains per k-block,
// gate and up, on the same A descriptor into two f32 accumulators (BN
// registers a thread), and waits for k-block i - 1's MMAs (wait_group 1)
// while k-block i's run before it frees i - 1's stage.  The epilogue
// applies the activation to the gate sum in registers, multiplies by the
// up sum and stores bf16 pairs: no f32 (M x F) array, no combine launch.
// No split-K: the activation needs the whole sum.  Row tiles are the
// grid's fast axis, so the blocks that share a weight tile run together.
// Bound by the weight read (302 MB at gemma-7b) and, at M = 256, nearly
// as much by the tensor cores.
//
// Small-M regime (decode): a whole-D gated GEMV (stream_gemv_kernel,
// f32 and bf16).  The reference's _stream_kernel keeps whole-D panels
// resident; 2 x D x BN weights do not fit 227 KB here at BN > 18, so
// only X's whole-D panel (BM x D) is staged, by one bulk asynchronous
// copy issued before the first weight loads; Wg and Wu are streamed
// from device memory once, with read-once loads (not kept in L1).  A
// block owns BN columns and the whole of D: warps 0-3 read W_gate and
// warps 4-7 W_up; each lane owns 16 bytes (8 bf16 or 4 f32 columns) of a
// row of its warp's weight, BN / 8 (or / 4) lanes span a row, and the
// lanes and 4 warps of a half take ROWS-row chunks of D in turn, every
// row of a chunk in flight before its first use.  A lane that read both
// weights would keep 2 x BM x 8 accumulators, which at BM = 4 leaves 128
// registers room for 4 rows in flight (32 KB a block); one weight a lane
// halves them, and 16 rows (64 KB a block, two blocks an SM) fit.
// Partial sums meet in a fixed butterfly across a warp's lanes and then
// in warp order in shared memory, so two calls give the same bits; the
// activation and product are applied once, at the single flush, where
// the two halves' sums meet.  One launch per call: no
// split-K workspace, no reduce.  M > BM takes a grid axis over row
// blocks (the slowest axis), each re-reading the weights.  A ragged F,
// unaligned weights or a D that is not a whole number of chunks go
// through masked scalar loads, an X panel that is not 16-byte aligned
// through an ordinary copy.  Bound by the weight read.
#include "common.cuh"
#include "hopper.cuh"

#include <algorithm>

// The GEMM table: the SIMT rows, then the GEMV rows, then the wgmma
// rows, indices running on.  The Python side's tile table
// (repro_torch/kernels/matmul.py GEMM_TILES) must list the same rows in
// the same order; tests/test_torch_cuda.py checks it.
// SIMT: (index, BM, BN, BK, TM, TN) -- 256 threads each.
#define GEMM_TILES(X)            \
  X(0, 16, 64, 32, 1, 4)         \
  X(1, 32, 64, 32, 2, 4)         \
  X(2, 64, 64, 16, 4, 4)         \
  X(3, 128, 64, 16, 8, 4)        \
  X(4, 64, 128, 16, 4, 8)        \
  X(5, 128, 128, 16, 8, 8)       \
  X(6, 16, 32, 64, 1, 2)         \
  X(7, 16, 16, 64, 1, 1)

// Split-K GEMV: (index, BM, SPLIT).  256 threads; a block spans 256 bf16
// or 128 f32 columns and reads 8-row chunks of K.
#define GEMV_TILES(X)            \
  X(8, 4, 1)                     \
  X(9, 4, 8)                     \
  X(10, 4, 16)                   \
  X(11, 4, 32)

// TMA + wgmma, bf16: (index, BN, STAGES, SPLIT).  BM 128, BK 64, 384
// threads.
#define WGMMA_TILES(X)           \
  X(12, 128, 4, 1)               \
  X(13, 128, 4, 2)               \
  X(14, 128, 4, 4)               \
  X(15, 256, 4, 1)               \
  X(16, 256, 4, 2)               \
  X(17, 256, 4, 5)

enum GemmFamily { FAMILY_SIMT = 0, FAMILY_GEMV = 1, FAMILY_WGMMA = 2 };
constexpr int GEMV_WARPS = 8;
// K rows of a GEMV chunk: a lane's loads in flight (16 bytes each)
template <typename T> struct GemvRows { static constexpr int value = 8; };
template <> struct GemvRows<bf16> { static constexpr int value = 16; };
constexpr int WG_BM = 128, WG_BK = 64, WG_THREADS = 384;

// The gated table (mlp_matmul.py GATED_TILES, same order): the SIMT
// rows, two accumulators per thread (index, BM, BN, BK, TM, TN); then
// the TMA + wgmma rows (index, BN, STAGES): BM 128, BK 64, 384 threads;
// the deeper ring first, which wins where the analysis ties two rows.
#define GATED_TILES(X)           \
  X(0, 16, 64, 32, 1, 4)         \
  X(1, 32, 64, 32, 2, 4)         \
  X(2, 64, 64, 16, 4, 4)         \
  X(3, 128, 64, 16, 8, 4)        \
  X(4, 64, 128, 16, 4, 8)        \
  X(5, 16, 32, 64, 1, 2)         \
  X(6, 16, 16, 64, 1, 1)
#define GATED_WGMMA_TILES(X)     \
  X(7, 64, 4)                    \
  X(8, 64, 3)                    \
  X(9, 128, 4)                   \
  X(10, 128, 3)

// The stream table (mlp_matmul.py STREAM_TILES, same order): the SIMT
// rows (index, BM, BN, TM, TN); then the whole-D gated GEMV rows
// (index, BM, BN, ROWS): BN columns a block, ROWS rows of a lane's
// weight in flight per lane, 256 threads, 128 registers a thread.
#define STREAM_TILES(X)          \
  X(0, 4, 4, 1, 1)               \
  X(1, 8, 8, 1, 1)               \
  X(2, 16, 16, 1, 1)             \
  X(3, 32, 32, 2, 2)
#define STREAM_GEMV_TILES(X)     \
  X(4, 1, 64, 16)                \
  X(5, 1, 128, 16)               \
  X(6, 4, 64, 16)                \
  X(7, 4, 128, 16)               \
  X(8, 8, 64, 8)                 \
  X(9, 8, 128, 8)
constexpr int SG_WARPS = 8;

template <typename T, typename OutT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            OutT* __restrict__ C, int M, int N, int K) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  __shared__ T As[BK][BM];
  __shared__ T Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK, gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[(size_t)gr * K + gc] : from_f<T>(0.f);
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int r = e / BN, c = e % BN, gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? B[(size_t)gr * N + gc] : from_f<T>(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = to_f(As[kk][ty + i * TY]);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = to_f(Bs[kk][tx + j * TX]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c < N) C[(size_t)r * N + c] = from_f<OutT>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gated_kernel(const T* __restrict__ X, const T* __restrict__ G,
             const T* __restrict__ U, T* __restrict__ O, int M, int N,
             int K, int act) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  __shared__ T Xs[BK][BM];
  __shared__ T Gs[BK][BN];
  __shared__ T Us[BK][BN];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float ag[TM][TN], au[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) ag[i][j] = au[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK, gr = row0 + r, gc = k0 + c;
      Xs[c][r] = (gr < M && gc < K) ? X[(size_t)gr * K + gc] : from_f<T>(0.f);
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int r = e / BN, c = e % BN, gr = k0 + r, gc = col0 + c;
      const bool ok = gr < K && gc < N;
      Gs[r][c] = ok ? G[(size_t)gr * N + gc] : from_f<T>(0.f);
      Us[r][c] = ok ? U[(size_t)gr * N + gc] : from_f<T>(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], g[TN], u[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = to_f(Xs[kk][ty + i * TY]);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        g[j] = to_f(Gs[kk][tx + j * TX]);
        u[j] = to_f(Us[kk][tx + j * TX]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          ag[i][j] = fmaf(a[i], g[j], ag[i][j]);
          au[i][j] = fmaf(a[i], u[j], au[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c < N)
        O[(size_t)r * N + c] = from_f<T>(apply_act(ag[i][j], act) * au[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
stream_kernel(const T* __restrict__ X, const T* __restrict__ G,
              const T* __restrict__ U, T* __restrict__ O, int M, int N,
              int D, int act) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);  // [BM][D]
  T* Gs = Xs + BM * D;                      // [D][BN]
  T* Us = Gs + D * BN;                      // [D][BN]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  for (int e = tid; e < BM * D; e += NT) {
    const int r = e / D, c = e % D, gr = row0 + r;
    Xs[e] = gr < M ? X[(size_t)gr * D + c] : from_f<T>(0.f);
  }
  for (int e = tid; e < D * BN; e += NT) {
    const int r = e / BN, c = e % BN, gc = col0 + c;
    const bool ok = gc < N;
    Gs[e] = ok ? G[(size_t)r * N + gc] : from_f<T>(0.f);
    Us[e] = ok ? U[(size_t)r * N + gc] : from_f<T>(0.f);
  }
  __syncthreads();
  float ag[TM][TN], au[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) ag[i][j] = au[i][j] = 0.f;
  for (int k = 0; k < D; ++k) {
    float a[TM], g[TN], u[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = to_f(Xs[(ty + i * TY) * D + k]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      g[j] = to_f(Gs[k * BN + tx + j * TX]);
      u[j] = to_f(Us[k * BN + tx + j * TX]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        ag[i][j] = fmaf(a[i], g[j], ag[i][j]);
        au[i][j] = fmaf(a[i], u[j], au[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c < N)
        O[(size_t)r * N + c] = from_f<T>(apply_act(ag[i][j], act) * au[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Decode family: split-K GEMV
// ---------------------------------------------------------------------------

// One lane's VecWidth<T> columns of one B row, widened to f32: a 16-byte
// load where ``vec``, else masked scalar loads.
template <typename T>
__device__ __forceinline__ void gemv_row(const T* __restrict__ row, int c0,
                                         int N, bool vec, float* b) {
  constexpr int V = VecWidth<T>::value;
  if (vec) {
    load16<T>(row + c0, b);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) b[j] = c0 + j < N ? to_f(row[c0 + j]) : 0.f;
  }
}

// The raw 16-byte words of one aligned chunk: R B rows at the lane's
// columns, and R values of each of A's BM rows (zero past M).
template <typename T, int BM, int R, int AQ>
__device__ __forceinline__ void gemv_load(const T* __restrict__ B,
                                          const T* __restrict__ a0, int N,
                                          int K, int c0, int k, int rows,
                                          uint4* rb, uint4 (*ra)[AQ]) {
  constexpr int V = VecWidth<T>::value;
#pragma unroll
  for (int r = 0; r < R; ++r)
    rb[r] = __ldg(reinterpret_cast<const uint4*>(B + (size_t)(k + r) * N + c0));
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int q = 0; q < AQ; ++q)
      ra[m][q] = m < rows ? __ldg(reinterpret_cast<const uint4*>(
                                a0 + (size_t)m * K + k + q * V))
                          : make_uint4(0, 0, 0, 0);
}

// C[slice] (M x N) = A[:, slice] . B[slice, :] for the K slice
// blockIdx.y of gridDim.y (slices are whole chunks of GemvRows<T> rows); OutT
// is f32 when the slices go to the split-K workspace.  Warp w takes the
// chunks w, w + GEMV_WARPS, ... of the slice.
template <typename T, typename OutT, int BM>
__global__ void __launch_bounds__(GEMV_WARPS * 32, 2)
gemv_kernel(const T* __restrict__ A, const T* __restrict__ B,
            OutT* __restrict__ C, int M, int N, int K, int vec_b,
            int vec_a) {
  constexpr int V = VecWidth<T>::value, BN = 32 * V;
  constexpr int W = GEMV_WARPS, R = GemvRows<T>::value, AQ = R / V;
  __shared__ float red[BM][BN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * BN + lane * V;
  const int row0 = blockIdx.z * BM;
  const int rows = min(BM, M - row0);
  const int kc = ((K + gridDim.y - 1) / gridDim.y + R - 1) / R * R;
  const int kb = min(K, (int)blockIdx.y * kc), ke = min(K, kb + kc);
  const bool vec = vec_b && c0 + V <= N, fast = vec && vec_a;
  const T* __restrict__ a0 = A + (size_t)row0 * K;
  float acc[BM][V];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.f;
  int k = kb + R * warp;
  if (fast) {
    // the aligned path: the chunk's R B rows and R values of each of
    // A's rows are loaded raw (16-byte words) before the first use, so
    // they are in flight together
    for (; k + R <= ke; k += R * W) {
      uint4 rb[R], ra[BM][AQ];
      gemv_load<T, BM, R, AQ>(B, a0, N, K, c0, k, rows, rb, ra);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float b[V];
        unpack16<T>(rb[r], b);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float a = to_f(reinterpret_cast<const T*>(ra[m])[r]);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[m][j] = fmaf(a, b[j], acc[m][j]);
        }
      }
    }
  }
  // ragged or unaligned lanes, and a slice's ragged last chunk: a row
  // at a time
  for (; k < ke; k += R * W) {
    const int kend = min(k + R, ke);
    for (int kk = k; kk < kend; ++kk) {
      float b[V];
      gemv_row<T>(B + (size_t)kk * N, c0, N, vec, b);
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        if (m < rows) {
          const float a = to_f(a0[(size_t)m * K + kk]);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[m][j] = fmaf(a, b[j], acc[m][j]);
        }
      }
    }
  }
  // the warps' sums, added in warp order
  for (int w = 0; w < W; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < V; ++j)
          red[m][lane * V + j] =
              w == 0 ? acc[m][j] : red[m][lane * V + j] + acc[m][j];
    }
    __syncthreads();
  }
  OutT* __restrict__ out = C + (size_t)blockIdx.y * M * N;
  for (int e = threadIdx.x; e < BM * BN; e += W * 32) {
    const int m = e / BN, c = blockIdx.x * BN + e % BN;
    if (m < rows && c < N)
      out[(size_t)(row0 + m) * N + c] = from_f<OutT>(red[m][e % BN]);
  }
}

// C = sum over the split slices of the f32 workspace, in slice order.
template <typename OutT>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, OutT* __restrict__ C,
                     size_t mn, int split) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * 256) {
    float acc = ws[i];
    for (int p = 1; p < split; ++p) acc += ws[(size_t)p * mn + i];
    C[i] = from_f<OutT>(acc);
  }
}

// ---------------------------------------------------------------------------
// Small-M gated MLP: whole-D gated GEMV
// ---------------------------------------------------------------------------

// O[rows, BN columns] = act(X.G) * (X.U) over the whole of D for the
// column block blockIdx.x and the row block blockIdx.y.  Warps 0-3 read
// W_gate, warps 4-7 W_up; a lane's ROWS rows of its weight are in flight
// before the first use.  Shared memory: X's panel [BM][dp] (dp = D
// rounded up to 16 elements) and the warps' sums [2][BM][BN] f32.
// ``vec_w``: both weights 16-byte aligned with 16-byte row pitches;
// ``bulk_x``: X's rows may be bulk-copied.
template <typename T, int BM, int BN, int ROWS>
__global__ void __launch_bounds__(SG_WARPS * 32, 2)
stream_gemv_kernel(const T* __restrict__ X, const T* __restrict__ G,
                   const T* __restrict__ U, T* __restrict__ O, int M, int N,
                   int D, int act, int vec_w, int bulk_x) {
  constexpr int V = VecWidth<T>::value, LR = BN / V, RW = 32 / LR;
  constexpr int W = SG_WARPS, WH = W / 2, R = ROWS;
  static_assert(BN % V == 0 && 32 % LR == 0 && LR <= 32,
                "a row's lanes must divide a warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ alignas(8) uint64_t xbar;
  const int dp = (D + 15) & ~15;
  T* xs = reinterpret_cast<T*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + (size_t)BM * dp * sizeof(T));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = warp / WH, wi = warp % WH;   // 0: W_gate, 1: W_up
  const T* __restrict__ B = half ? U : G;
  const int cg = lane % LR, rs = lane / LR;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int rows = min(BM, M - row0);
  const int c0 = col0 + cg * V;
  const bool vec = vec_w && c0 + V <= N;
  const uint32_t bar = smem_u32(&xbar);
  // X's panel: one bulk copy per row, issued before any weight load
  if (bulk_x) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_init_fence();
      mbar_expect_tx(bar, rows * D * (int)sizeof(T));
      for (int m = 0; m < rows; ++m)
        bulk_load(smem_u32(xs + (size_t)m * dp), X + (size_t)(row0 + m) * D,
                  D * (int)sizeof(T), bar);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += W * 32)
      xs[(size_t)(e / D) * dp + e % D] = X[(size_t)row0 * D + e];
  }
  for (int e = rows * dp + threadIdx.x; e < BM * dp; e += W * 32)
    xs[e] = from_f<T>(0.f);                // rows past M
  __syncthreads();
  bool x_ready = !bulk_x;
  float acc[BM][V];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.f;
  // chunk c is rows [c R, c R + R) of D; thread (wi, rs) of a half takes
  // chunks wi * RW + rs, then WH * RW further on
  const int nfull = D / R, nchunk = (D + R - 1) / R;
  for (int c = wi * RW + rs; c < nchunk; c += WH * RW) {
    const int k0 = c * R;
    if (vec && c < nfull) {
      uint4 wv[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        wv[r] = ld_stream16(B + (size_t)(k0 + r) * N + c0);
      if (!x_ready) { mbar_wait(bar, 0); x_ready = true; }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float b[V];
        unpack16<T>(wv[r], b);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float a = to_f(xs[m * dp + k0 + r]);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[m][j] = fmaf(a, b[j], acc[m][j]);
        }
      }
    } else {
      // ragged or unaligned columns, or D's ragged last chunk: a row at
      // a time
      if (!x_ready) { mbar_wait(bar, 0); x_ready = true; }
      const int kend = min(k0 + R, D);
      for (int k = k0; k < kend; ++k) {
        float b[V];
        gemv_row<T>(B + (size_t)k * N, c0, N, vec, b);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float a = to_f(xs[m * dp + k]);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[m][j] = fmaf(a, b[j], acc[m][j]);
        }
      }
    }
  }
  // no thread leaves while the panel's copy may still be landing
  if (!x_ready) mbar_wait(bar, 0);
  // the lanes of a column group, in a fixed butterfly
#pragma unroll
  for (int o = LR; o < 32; o <<= 1)
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], o);
  // then each half's warps, in warp order: red[0] the gate sums, red[1]
  // the up sums
  float* mine = red + half * BM * BN;
  for (int w = 0; w < WH; ++w) {
    if (wi == w && rs == 0) {
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int e = m * BN + cg * V + j;
          mine[e] = w == 0 ? acc[m][j] : mine[e] + acc[m][j];
        }
    }
    __syncthreads();
  }
  // the single flush: activation and gating in f32, one rounding
  for (int e = threadIdx.x; e < BM * BN; e += W * 32) {
    const int m = e / BN, c = col0 + e % BN;
    if (m < rows && c < N)
      O[(size_t)(row0 + m) * N + c] =
          from_f<T>(apply_act(red[e], act) * red[BM * BN + e]);
  }
}

// ---------------------------------------------------------------------------
// Prefill family: TMA + wgmma (bf16)
// ---------------------------------------------------------------------------

// A stage of the TMA ring: one A box and BN / 64 boxes of each of
// WEIGHTS B operands (2 for the gated tiles' W_gate and W_up).
template <int BN, int STAGES, int WEIGHTS = 1>
struct WgmmaLayout {
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;   // 16 KB
  static constexpr int B_BOX = WG_BK * 64 * 2;        // one 64-column box
  static constexpr int B_BYTES = WG_BK * BN * 2;      // one operand's boxes
  static constexpr int STAGE = A_BYTES + WEIGHTS * B_BYTES;
  // the stages, their 2 * STAGES mbarriers, and room to align the ring
  // to the 1024 bytes of the 128-byte swizzle's atom
  static constexpr int SMEM = STAGES * STAGE + 16 * STAGES + 1024;
};

template <typename OutT, int BN, int STAGES>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
             const __grid_constant__ CUtensorMap tma_b,
             OutT* __restrict__ C, int M, int N, int K) {
  using L = WgmmaLayout<BN, STAGES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * L::STAGE;   // full[s] at +8s
  const uint32_t empty = full + 8 * STAGES;         // empty[s] at +8s
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * WG_BM;
  const int kt = (K + WG_BK - 1) / WG_BK;
  const int per = (kt + gridDim.z - 1) / gridDim.z;
  const int t0 = blockIdx.z * per;
  const int nk = max(0, min(kt, t0 + per) - t0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG_THREADS - 128);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t sa = ring + s * L::STAGE, sb = sa + L::A_BYTES;
        const int k0 = (t0 + i) * WG_BK;
        mbar_expect_tx(full + 8 * s, L::STAGE);
        tma_load_2d(sa, &tma_a, full + 8 * s, k0, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(sb + j * L::B_BOX, &tma_b, full + 8 * s, n0 + 64 * j, k0);
      }
    }
    return;
  }
  // consumers: warpgroup c = 1, 2 owns rows m0 + 64 (c - 1) ...
  const int c = wg - 1;
  const bool live = m0 + 64 * c < M;      // uniform over the warpgroup
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs<BN / 2>(acc);
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    if (live) {
      const uint32_t sa = ring + s * L::STAGE + c * 64 * 128;
      const uint32_t sb = ring + s * L::STAGE + L::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        // A: K-major rows of 128 bytes, 8-row atoms 1024 bytes apart;
        // B: N-major, 64-column boxes L::B_BOX apart (leading offset),
        // 8-row groups 1024 bytes apart (stride offset)
        wgmma_bf16<BN>(acc, desc_sw128(sa + 32 * kk, 16, 1024),
                       desc_sw128(sb + 2048 * kk, L::B_BOX, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BN / 2>(acc);
    }
    mbar_arrive(empty + 8 * s);
  }
  if (!live) return;
  const int t = threadIdx.x - 128 * wg, w = t / 32, l = t % 32;
  const int r = m0 + 64 * c + 16 * w + l / 4;
  OutT* __restrict__ out = C + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (l % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row < M) {
        if (col < N) out[(size_t)row * N + col] = from_f<OutT>(acc[4 * j + 2 * h]);
        if (col + 1 < N)
          out[(size_t)row * N + col + 1] = from_f<OutT>(acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// O (M x N, bf16) = act(X . G) * (X . U) for the 128 x BN tile
// (blockIdx.x, blockIdx.y): wgmma_kernel's ring and warpgroups with two
// weights and two accumulators.
template <int BN, int STAGES>
__global__ void __launch_bounds__(WG_THREADS, 1)
gated_wgmma_kernel(const __grid_constant__ CUtensorMap tma_x,
                   const __grid_constant__ CUtensorMap tma_g,
                   const __grid_constant__ CUtensorMap tma_u,
                   bf16* __restrict__ O, int M, int N, int K, int act) {
  using L = WgmmaLayout<BN, STAGES, 2>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * L::STAGE;   // full[s] at +8s
  const uint32_t empty = full + 8 * STAGES;         // empty[s] at +8s
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * BN;
  const int nk = (K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG_THREADS - 128);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full, X once for both weights
    if (threadIdx.x == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t sa = ring + s * L::STAGE, sg = sa + L::A_BYTES;
        const uint32_t su = sg + L::B_BYTES;
        const int k0 = i * WG_BK;
        mbar_expect_tx(full + 8 * s, L::STAGE);
        tma_load_2d(sa, &tma_x, full + 8 * s, k0, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          tma_load_2d(sg + j * L::B_BOX, &tma_g, full + 8 * s, n0 + 64 * j, k0);
          tma_load_2d(su + j * L::B_BOX, &tma_u, full + 8 * s, n0 + 64 * j, k0);
        }
      }
    }
    return;
  }
  // consumers: warpgroup c = 1, 2 owns rows m0 + 64 (c - 1) ...
  const int c = wg - 1;
  if (m0 + 64 * c >= M) {
    // rows all past M: hand each stage back unread
    for (int i = 0; i < nk; ++i) {
      mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
      mbar_arrive(empty + 8 * (i % STAGES));
    }
    return;
  }
  float ag[BN / 2], au[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) ag[i] = au[i] = 0.f;
  fence_regs<BN / 2>(ag);
  fence_regs<BN / 2>(au);
  // k-block i's two chains, committed as one group; no branch the
  // compiler sees while the previous group is in flight
  auto issue = [&](int i) {
    const int s = i % STAGES;
    mbar_wait_spin(full + 8 * s, (i / STAGES) & 1);
    const uint32_t sa = ring + s * L::STAGE + c * 64 * 128;
    const uint32_t sg = ring + s * L::STAGE + L::A_BYTES;
    const uint32_t su = sg + L::B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // one A descriptor for both chains (wgmma_kernel's layouts)
      const uint64_t da = desc_sw128(sa + 32 * kk, 16, 1024);
      wgmma_bf16<BN>(ag, da, desc_sw128(sg + 2048 * kk, L::B_BOX, 1024));
      wgmma_bf16<BN>(au, da, desc_sw128(su + 2048 * kk, L::B_BOX, 1024));
    }
    wgmma_commit();
  };
  issue(0);
  for (int i = 1; i < nk; ++i) {
    issue(i);
    // k-block i - 1's MMAs are done once at most k-block i's are
    // pending: its stage goes back to the producer while they run
    wgmma_wait<1>();
    fence_regs<BN / 2>(ag);
    fence_regs<BN / 2>(au);
    mbar_arrive(empty + 8 * ((i - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(ag);
  fence_regs<BN / 2>(au);
  const int t = threadIdx.x - 128 * wg, w = t / 32, l = t % 32;
  const int r = m0 + 64 * c + 16 * w + l / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    // N % 8 == 0 and col is even: col < N holds col + 1 < N
    const int col = n0 + 8 * j + 2 * (l % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h, q = 4 * j + 2 * h;
      if (row < M && col < N)
        *reinterpret_cast<__nv_bfloat162*>(O + (size_t)row * N + col) =
            __floats2bfloat162_rn(apply_act(ag[q], act) * au[q],
                                  apply_act(ag[q + 1], act) * au[q + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: one switch per kernel over the compiled instantiations.
// ---------------------------------------------------------------------------

template <typename T, typename OutT, int BM, int BN, int BK, int TM, int TN>
static int launch_gemm(const void* A, const void* B, void* C, int M, int N,
                       int K, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T, OutT, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(
      (const T*)A, (const T*)B, (OutT*)C, M, N, K);
  return (int)cudaGetLastError();
}

// The split-K epilogue: sum ``split`` f32 slices of M x N into C.
template <typename OutT>
static int launch_reduce(const void* ws, void* C, int M, int N, int split,
                         cudaStream_t s) {
  const size_t mn = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((mn + 255) / 256, 132 * 16);
  splitk_reduce_kernel<OutT><<<blocks, 256, 0, s>>>((const float*)ws,
                                                    (OutT*)C, mn, split);
  return (int)cudaGetLastError();
}

// SPLIT == 1 stores C directly; SPLIT > 1 writes f32 slices to ``ws``
// ([split, M, N]) and reduces them into C.
template <typename T, typename OutT, int BM>
static int launch_gemv(const void* A, const void* B, void* C, void* ws,
                       int M, int N, int K, int split, cudaStream_t s) {
  constexpr int V = VecWidth<T>::value, BN = 32 * V;
  if (split < 1 || split > 65535 || (M + BM - 1) / BM > 65535 ||
      (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vec_b = aligned16(B) && N % V == 0;
  const int vec_a = aligned16(A) && K % V == 0;
  dim3 grid((N + BN - 1) / BN, split, (M + BM - 1) / BM);
  if (split == 1) {
    gemv_kernel<T, OutT, BM><<<grid, GEMV_WARPS * 32, 0, s>>>(
        (const T*)A, (const T*)B, (OutT*)C, M, N, K, vec_b, vec_a);
    return (int)cudaGetLastError();
  }
  gemv_kernel<T, float, BM><<<grid, GEMV_WARPS * 32, 0, s>>>(
      (const T*)A, (const T*)B, (float*)ws, M, N, K, vec_b, vec_a);
  const int e = (int)cudaGetLastError();
  return e ? e : launch_reduce<OutT>(ws, C, M, N, split, s);
}

// A bf16 row-major (outer x inner) matrix as 128-byte-swizzled boxes of
// box_outer x box_inner; rows past the matrix are zero-filled.
static int encode_bf16_2d(CUtensorMap* map, const void* base, int inner,
                          int outer, int box_inner, int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename OutT, int BN, int STAGES>
static int launch_wgmma_kernel(const CUtensorMap& ta, const CUtensorMap& tb,
                               void* C, int M, int N, int K, int split,
                               cudaStream_t s) {
  static int configured = 0;
  constexpr int smem = WgmmaLayout<BN, STAGES>::SMEM;
  cudaError_t e = allow_smem(wgmma_kernel<OutT, BN, STAGES>, smem,
                             &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BN - 1) / BN, (M + WG_BM - 1) / WG_BM, split);
  wgmma_kernel<OutT, BN, STAGES><<<grid, WG_THREADS, smem, s>>>(
      ta, tb, (OutT*)C, M, N, K);
  return (int)cudaGetLastError();
}

template <typename OutT, int BN, int STAGES>
static int launch_wgmma(const void* A, const void* B, void* C, void* ws,
                        int M, int N, int K, int split, cudaStream_t s) {
  if (K % 8 || N % 8 || !aligned16(A) || !aligned16(B) || split < 1 ||
      split > 65535 || (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int e = encode_bf16_2d(&ta, A, K, M, WG_BK, WG_BM);
  if (!e) e = encode_bf16_2d(&tb, B, N, K, 64, WG_BK);
  if (e) return e;
  if (split == 1)
    return launch_wgmma_kernel<OutT, BN, STAGES>(ta, tb, C, M, N, K, 1, s);
  e = launch_wgmma_kernel<float, BN, STAGES>(ta, tb, ws, M, N, K, split, s);
  return e ? e : launch_reduce<OutT>(ws, C, M, N, split, s);
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
static int launch_gated(const void* X, const void* G, const void* U, void* O,
                        int M, int N, int K, int act, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gated_kernel<T, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(
      (const T*)X, (const T*)G, (const T*)U, (T*)O, M, N, K, act);
  return (int)cudaGetLastError();
}

template <int BN, int STAGES>
static int launch_gated_wgmma(const void* X, const void* G, const void* U,
                              void* O, int M, int N, int K, int act,
                              cudaStream_t s) {
  if (M < 1 || K < 8 || K % 8 || N % 8 || !aligned16(X) || !aligned16(G) ||
      !aligned16(U) || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tg, tu;
  int e = encode_bf16_2d(&tx, X, K, M, WG_BK, WG_BM);
  if (!e) e = encode_bf16_2d(&tg, G, N, K, 64, WG_BK);
  if (!e) e = encode_bf16_2d(&tu, U, N, K, 64, WG_BK);
  if (e) return e;
  static int configured = 0;
  constexpr int smem = WgmmaLayout<BN, STAGES, 2>::SMEM;
  cudaError_t err = allow_smem(gated_wgmma_kernel<BN, STAGES>, smem,
                               &configured);
  if (err != cudaSuccess) return (int)err;
  // row tiles on the fast axis: the blocks that read one weight tile
  // run side by side
  dim3 grid((M + WG_BM - 1) / WG_BM, (N + BN - 1) / BN);
  gated_wgmma_kernel<BN, STAGES><<<grid, WG_THREADS, smem, s>>>(
      tx, tg, tu, (bf16*)O, M, N, K, act);
  return (int)cudaGetLastError();
}

// Dynamic shared bytes of a stream GEMV row: X's panel, then the warps'
// f32 sums.
template <typename T, int BM, int BN>
static size_t stream_gemv_smem(int D) {
  return (size_t)BM * ((D + 15) & ~15) * sizeof(T) + 2 * BM * BN * 4;
}

template <typename T, int BM, int BN, int ROWS>
static int launch_stream_gemv(const void* X, const void* G, const void* U,
                              void* O, int M, int N, int D, int act,
                              cudaStream_t s) {
  constexpr int V = VecWidth<T>::value;
  const size_t smem = stream_gemv_smem<T, BM, BN>(D);
  // the panel and the sums, with the static barrier, within 227 KB
  if (M < 1 || N < 1 || D < 1 || (M + BM - 1) / BM > 65535 ||
      smem + 16 > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  static int configured = 0;
  cudaError_t e = allow_smem(stream_gemv_kernel<T, BM, BN, ROWS>, (int)smem,
                             &configured);
  if (e != cudaSuccess) return (int)e;
  const int vec_w = aligned16(G) && aligned16(U) && N % V == 0;
  const int bulk_x = aligned16(X) && (D * (int)sizeof(T)) % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  stream_gemv_kernel<T, BM, BN, ROWS><<<grid, SG_WARPS * 32, smem, s>>>(
      (const T*)X, (const T*)G, (const T*)U, (T*)O, M, N, D, act, vec_w,
      bulk_x);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BN, int TM, int TN>
static int launch_stream(const void* X, const void* G, const void* U,
                         void* O, int M, int N, int D, int act,
                         cudaStream_t s) {
  static int configured = 0;
  const int smem = (BM * D + 2 * D * BN) * (int)sizeof(T);
  cudaError_t e = allow_smem(stream_kernel<T, BM, BN, TM, TN>, smem,
                             &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  stream_kernel<T, BM, BN, TM, TN><<<grid, (BM / TM) * (BN / TN), smem, s>>>(
      (const T*)X, (const T*)G, (const T*)U, (T*)O, M, N, D, act);
  return (int)cudaGetLastError();
}

extern "C" {

// C = A (M x K) . B (K x N), row-major, f32 accumulation; stored in the
// input type, or in f32 when out_f32 (the split MLP's passes).
// dtype: 0 float32, 1 bfloat16.  ``ws`` is the split-K workspace of a
// tile whose SPLIT > 1 (f32, SPLIT * M * N), else unused.
int repro_gemm(int tile, int dtype, int out_f32, const void* A,
               const void* B, void* C, void* ws, int M, int N, int K,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define GEMM_CASE(i, BM, BN, BK, TM, TN)                                     \
  case i:                                                                    \
    if (dtype == 0)                                                          \
      return launch_gemm<float, float, BM, BN, BK, TM, TN>(A, B, C, M, N, K, s); \
    if (out_f32)                                                             \
      return launch_gemm<bf16, float, BM, BN, BK, TM, TN>(A, B, C, M, N, K, s);  \
    return launch_gemm<bf16, bf16, BM, BN, BK, TM, TN>(A, B, C, M, N, K, s);
#define GEMV_CASE(i, BM, SPLIT)                                              \
  case i:                                                                    \
    if (dtype == 0)                                                          \
      return launch_gemv<float, float, BM>(A, B, C, ws, M, N, K, SPLIT, s);  \
    if (out_f32)                                                             \
      return launch_gemv<bf16, float, BM>(A, B, C, ws, M, N, K, SPLIT, s);   \
    return launch_gemv<bf16, bf16, BM>(A, B, C, ws, M, N, K, SPLIT, s);
#define WGMMA_CASE(i, BN, STAGES, SPLIT)                                     \
  case i:                                                                    \
    if (dtype == 0) return (int)cudaErrorInvalidValue; /* bf16 only */       \
    if (out_f32)                                                             \
      return launch_wgmma<float, BN, STAGES>(A, B, C, ws, M, N, K, SPLIT, s); \
    return launch_wgmma<bf16, BN, STAGES>(A, B, C, ws, M, N, K, SPLIT, s);
  switch (tile) {
    GEMM_TILES(GEMM_CASE)
    GEMV_TILES(GEMV_CASE)
    WGMMA_TILES(WGMMA_CASE)
    default: break;
  }
#undef GEMM_CASE
#undef GEMV_CASE
#undef WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}

// C (M x N) = the sum of ws's ``split`` f32 slices [split, M, N] in
// slice order, stored in f32 (out_dtype 0) or bf16 (1): the split-K
// tiles' second launch, exported to be checked and timed on its own.
int repro_splitk_reduce(int out_dtype, const void* ws, void* C, int M,
                        int N, int split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (split < 1) return (int)cudaErrorInvalidValue;
  return out_dtype == 0 ? launch_reduce<float>(ws, C, M, N, split, s)
                        : launch_reduce<bf16>(ws, C, M, N, split, s);
}

// O = act(X . G) * (X . U); X (M x K), G/U (K x N).  act: 0 silu,
// 1 gelu (tanh), 2 relu.
int repro_gemm_gated(int tile, int dtype, int act, const void* X,
                     const void* G, const void* U, void* O, int M, int N,
                     int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define GATED_CASE(i, BM, BN, BK, TM, TN)                                     \
  case i:                                                                     \
    if (dtype == 0)                                                           \
      return launch_gated<float, BM, BN, BK, TM, TN>(X, G, U, O, M, N, K, act, s); \
    return launch_gated<bf16, BM, BN, BK, TM, TN>(X, G, U, O, M, N, K, act, s);
#define GATED_WGMMA_CASE(i, BN, STAGES)                                       \
  case i:                                                                     \
    if (dtype == 0) return (int)cudaErrorInvalidValue; /* bf16 only */        \
    return launch_gated_wgmma<BN, STAGES>(X, G, U, O, M, N, K, act, s);
  switch (tile) {
    GATED_TILES(GATED_CASE)
    GATED_WGMMA_TILES(GATED_WGMMA_CASE)
    default: break;
  }
#undef GATED_CASE
#undef GATED_WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}

// The gated product over the whole of D per block (no K loop across
// blocks): the SIMT rows keep whole-D panels of all three operands
// resident, the GEMV rows X's panel only.
int repro_gemm_stream(int tile, int dtype, int act, const void* X,
                      const void* G, const void* U, void* O, int M, int N,
                      int D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define STREAM_CASE(i, BM, BN, TM, TN)                                       \
  case i:                                                                    \
    if (dtype == 0)                                                          \
      return launch_stream<float, BM, BN, TM, TN>(X, G, U, O, M, N, D, act, s); \
    return launch_stream<bf16, BM, BN, TM, TN>(X, G, U, O, M, N, D, act, s);
#define STREAM_GEMV_CASE(i, BM, BN, R)                                       \
  case i:                                                                    \
    if (dtype == 0)                                                          \
      return launch_stream_gemv<float, BM, BN, R>(X, G, U, O, M, N, D, act, s); \
    return launch_stream_gemv<bf16, BM, BN, R>(X, G, U, O, M, N, D, act, s);
  switch (tile) {
    STREAM_TILES(STREAM_CASE)
    STREAM_GEMV_TILES(STREAM_GEMV_CASE)
    default: break;
  }
#undef STREAM_CASE
#undef STREAM_GEMV_CASE
  return (int)cudaErrorInvalidValue;
}

int repro_gemm_attrs(int kind, int tile, int dtype, int* regs, int* smem,
                     int* max_threads) {
#define GEMM_ATTR(i, BM, BN, BK, TM, TN)                                     \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(gemm_kernel<float, float, BM, BN, BK, TM, TN>, regs, smem, max_threads) \
        : kernel_attrs(gemm_kernel<bf16, bf16, BM, BN, BK, TM, TN>, regs, smem, max_threads);
#define GATED_ATTR(i, BM, BN, BK, TM, TN)                                    \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(gated_kernel<float, BM, BN, BK, TM, TN>, regs, smem, max_threads) \
        : kernel_attrs(gated_kernel<bf16, BM, BN, BK, TM, TN>, regs, smem, max_threads);
#define STREAM_ATTR(i, BM, BN, TM, TN)                                       \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(stream_kernel<float, BM, BN, TM, TN>, regs, smem, max_threads) \
        : kernel_attrs(stream_kernel<bf16, BM, BN, TM, TN>, regs, smem, max_threads);
#define GEMV_ATTR(i, BM, SPLIT)                                              \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(gemv_kernel<float, float, BM>, regs, smem, max_threads) \
        : kernel_attrs(gemv_kernel<bf16, bf16, BM>, regs, smem, max_threads);
#define WGMMA_ATTR(i, BN, STAGES, SPLIT)                                     \
  case i:                                                                    \
    if (dtype == 0) return (int)cudaErrorInvalidValue; /* bf16 only */       \
    return kernel_attrs(wgmma_kernel<bf16, BN, STAGES>, regs, smem, max_threads);
#define GATED_WGMMA_ATTR(i, BN, STAGES)                                      \
  case i:                                                                    \
    if (dtype == 0) return (int)cudaErrorInvalidValue; /* bf16 only */       \
    return kernel_attrs(gated_wgmma_kernel<BN, STAGES>, regs, smem, max_threads);
#define STREAM_GEMV_ATTR(i, BM, BN, R)                                       \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(stream_gemv_kernel<float, BM, BN, R>, regs, smem, max_threads) \
        : kernel_attrs(stream_gemv_kernel<bf16, BM, BN, R>, regs, smem, max_threads);
  if (kind == KIND_GEMM) {
    switch (tile) {
      GEMM_TILES(GEMM_ATTR)
      GEMV_TILES(GEMV_ATTR)
      WGMMA_TILES(WGMMA_ATTR)
      default: break;
    }
  } else if (kind == KIND_GATED) {
    switch (tile) {
      GATED_TILES(GATED_ATTR)
      GATED_WGMMA_TILES(GATED_WGMMA_ATTR)
      default: break;
    }
  } else if (kind == KIND_STREAM) {
    switch (tile) {
      STREAM_TILES(STREAM_ATTR)
      STREAM_GEMV_TILES(STREAM_GEMV_ATTR)
      default: break;
    }
  }
#undef GEMM_ATTR
#undef GATED_ATTR
#undef STREAM_ATTR
#undef GEMV_ATTR
#undef WGMMA_ATTR
#undef GATED_WGMMA_ATTR
#undef STREAM_GEMV_ATTR
  return (int)cudaErrorInvalidValue;
}

// out[0..8] = BM, BN, BK, TM, TN, threads, family, stages, split (see
// REPRO_TILE_INFO_INTS), for the GEMM, gated and stream tables alike.
// GEMV rows of the GEMM table: BN and TN in bf16 columns (f32 blocks
// span half), BK the K rows a block reads per step, stages the rows in
// flight per lane.  Stream rows: BK 0 (the whole of D in one block);
// GEMV rows: TM = BM, TN a lane's 8 bf16 columns (4 in f32), stages the
// rows of both weights in flight per lane.
int repro_gemm_tile_info(int kind, int tile, int* out) {
#define GEMM_INFO(i, BM, BN, BK, TM, TN)                                     \
  case i: out[0] = BM; out[1] = BN; out[2] = BK; out[3] = TM; out[4] = TN;  \
    out[5] = (BM / TM) * (BN / TN);                                          \
    out[6] = FAMILY_SIMT; out[7] = 1; out[8] = 1; return 0;
#define GEMV_INFO(i, BM, SPLIT)                                              \
  case i: out[0] = BM; out[1] = 256; out[2] = GEMV_WARPS * GemvRows<bf16>::value; \
    out[3] = BM; out[4] = 8; out[5] = GEMV_WARPS * 32; out[6] = FAMILY_GEMV; \
    out[7] = GemvRows<bf16>::value; out[8] = SPLIT; return 0;
#define WGMMA_INFO(i, BN, STAGES, SPLIT)                                     \
  case i: out[0] = WG_BM; out[1] = BN; out[2] = WG_BK; out[3] = 64;          \
    out[4] = BN; out[5] = WG_THREADS; out[6] = FAMILY_WGMMA;                 \
    out[7] = STAGES; out[8] = SPLIT; return 0;
#define GATED_WGMMA_INFO(i, BN, STAGES) WGMMA_INFO(i, BN, STAGES, 1)
#define STREAM_INFO(i, BM, BN, TM, TN)                                       \
  case i: out[0] = BM; out[1] = BN; out[2] = 0; out[3] = TM; out[4] = TN;   \
    out[5] = (BM / TM) * (BN / TN);                                          \
    out[6] = FAMILY_SIMT; out[7] = 1; out[8] = 1; return 0;
#define STREAM_GEMV_INFO(i, BM, BN, R)                                       \
  case i: out[0] = BM; out[1] = BN; out[2] = 0; out[3] = BM; out[4] = 8;    \
    out[5] = SG_WARPS * 32; out[6] = FAMILY_GEMV; out[7] = R; out[8] = 1;    \
    return 0;
  if (kind == KIND_GEMM) {
    switch (tile) {
      GEMM_TILES(GEMM_INFO)
      GEMV_TILES(GEMV_INFO)
      WGMMA_TILES(WGMMA_INFO)
      default: break;
    }
  } else if (kind == KIND_GATED) {
    switch (tile) {
      GATED_TILES(GEMM_INFO)
      GATED_WGMMA_TILES(GATED_WGMMA_INFO)
      default: break;
    }
  } else if (kind == KIND_STREAM) {
    switch (tile) {
      STREAM_TILES(STREAM_INFO)
      STREAM_GEMV_TILES(STREAM_GEMV_INFO)
      default: break;
    }
  }
#undef GEMM_INFO
#undef GEMV_INFO
#undef WGMMA_INFO
#undef GATED_WGMMA_INFO
#undef STREAM_INFO
#undef STREAM_GEMV_INFO
  return -1;
}

}  // extern "C"
