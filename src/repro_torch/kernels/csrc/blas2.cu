// Matrix-vector kernels for Hopper: the port of the paper's Table IV
// BLAS-2 Pallas kernels (matVec2D, atax, BiCG).
//
// Replaces (src/repro/kernels/):
//   matvec.py:_mv_kernel            -> matvec_kernel       (repro_matvec)
//   atax.py:_atax_kernel_rowsweep   -> atax_kernel or atax_ring_kernel,
//                                      + colsum_kernel (repro_atax)
//   bicg.py:_bicg_kernel            -> bicg_kernel + colsum_kernel (repro_bicg)
//
// What bounds them on the H100: bytes.  Each reads the M x N matrix A
// once (M*N*bytes: 268 MB at 8192^2 f32, 0.080 ms at 3.35 TB/s) and does
// 2 or 4 FLOPs per element, far below the 67 TFLOP/s FP32 rate.  So the
// designs aim at streaming A with 16-byte loads, many loads in flight
// per SM, and nothing else of size M*N.
//
// matvec.  A block owns ROWS whole rows, WPR warps per row: each lane
// walks its row in 16-byte vectors (4 f32 or 8 bf16), accumulates in
// f32, a butterfly of shuffles sums the warp, and with WPR > 1 the
// warps of a row add their sums through shared memory.  The TPU grid's
// sequential column axis becomes the loop inside the row, so no sum
// crosses blocks.  x (N elements) is re-read by every row, from L1/L2.
//
// atax (y = A^T (A x)) and BiCG (q = A p, s = A^T r).  A block of
// THREADS threads walks stripes of ROWS rows (stripe s, s + grid, ...):
// every thread owns the same columns of every row (16-byte vectors
// j = tid, tid + THREADS, ...), and keeps the A^T part of its columns in
// a block-private f32 row ys[N] of shared memory (no other thread
// touches those words, so no atomics and no barrier guard them).
//   * BiCG reads each element of A once: q's dot products and s's
//     column sums take the same loaded vector.  q_i is a block-wide
//     reduction per row (shuffles, then the warps' sums in order).
//   * atax needs t_i = A_i . x before A_i^T t_i.  Its table holds two
//     families (ATAX_TILES: the sweep rows, then the ring rows):
//     - sweep rows (atax_kernel, BLAS2_TILES' instantiations): a stripe
//       is read twice: pass 1 reduces t (cast to the input type before
//       the second product, as the TPU kernel does at atax.py:43), pass
//       2 adds A_i^T t_i.  The second read comes from L2 while the
//       stripes in flight across the card (blocks x ROWS x N x bytes)
//       fit it; the analysis charges a second pass over A from device
//       memory when they do not.  Loads and FMAs overlap only across
//       warps.  Any N, any alignment (scalar loads where 16-byte ones
//       do not fit).
//     - ring rows (atax_ring_kernel; N * bytes a multiple of 16, N at
//       most RING_MAX_N, two stripes within 227 KB, 16-byte-aligned A
//       and x): A is read from device memory exactly once, whatever
//       the L2 holds.  One block per SM (or as many as the ring lets
//       the occupancy calculator fit) walks stripes b, b + grid, ...; a
//       ring of S stripe buffers in shared memory (as many as fit 227
//       KB, at most RING_STAGES: 3 at 8192 f32 columns, 7 at 8192
//       bf16) is filled by 1-D bulk copies, one per stripe (its rows
//       are contiguous in A), that thread 0 issues and whose bytes
//       complete on the stage's mbarrier, so S - 1 stripes are in
//       flight while the block computes on one.  A thread holds its
//       RING_MAX_N / THREADS columns of x and of its f32 partial y in
//       registers.  Pass 1 reads the thread's columns of the stage
//       once, into f32 registers, for its dot products; one block barrier per
//       stripe publishes the warps' sums (every warp then adds them in
//       one fixed butterfly, lane w taking warp w's, from a buffer of
//       two halves taken by stripe parity) and tells thread 0 that the
//       stage is read, which it refills with the stripe S ahead; pass 2
//       adds A_i^T t_i from the columns pass 1 kept.  Bound: A's bytes
//       plus the workspace's (below), 0.0426 ms at 8192^2 bf16; shared
//       memory moves A's bytes twice (the copy in, one read), about a
//       fifth of its rate.
// The grid is persistent: one wave of blocks (as many as the
// occupancy calculator fits, at most one per stripe).  Each block writes
// its f32 partial row of the A^T sum into a workspace (grid x N f32) that
// the wrapper allocates, and colsum_kernel adds the rows in block order:
// no float atomics, so two runs give bitwise the same result.  The
// workspace costs 2 x grid x N x 4 bytes of traffic beside A (8.7 MB at
// N = 8192 on a ring row's grid of 132).  The C side keeps each
// instantiation's wave (blocks per SM x SMs) per device and N, so a
// launch does not ask the runtime for occupancy again.
//
// Left on the table: BiCG's stripe double-buffering (its loads and FMAs
// overlap only across warps); the ring rows' workspace could shrink to
// a cluster's rows by summing ys in DSMEM; a ring row's registers are
// sized for its widest N (RING_MAX_N columns), so narrower rows leave
// most threads' columns idle; rows past RING_MAX_N columns take the
// sweep rows.
#include "common.cuh"
#include "hopper.cuh"

#include <mutex>

// (index, ROWS, WPR) -- threads = 32 * ROWS * WPR.  Must match
// repro_torch/kernels/matvec.py MATVEC_TILES.
#define MATVEC_TILES(X)                                                    \
  X(0, 1, 1) X(1, 2, 1) X(2, 4, 1) X(3, 8, 1) X(4, 16, 1) X(5, 32, 1)      \
  X(6, 1, 4) X(7, 1, 8) X(8, 2, 8) X(9, 4, 8)

// (index, THREADS, ROWS).  Must match repro_torch/kernels/atax.py
// BLAS2_TILES (BiCG's table, and the sweep rows of atax's).
#define BLAS2_TILES(X)                                                     \
  X(0, 32, 1) X(1, 64, 1) X(2, 128, 1) X(3, 128, 4) X(4, 256, 1)           \
  X(5, 256, 2) X(6, 256, 4) X(7, 512, 1) X(8, 512, 2) X(9, 1024, 1)

// atax's table is BLAS2_TILES (the sweep rows, indices 0-9), then its
// ring rows: (index, THREADS, ROWS).  Must match
// repro_torch/kernels/atax.py ATAX_TILES.  Where the analysis ties
// rows, the first wins: two-row stripes of 512 threads first.
#define ATAX_RING_TILES(X)                                                 \
  X(10, 512, 2) X(11, 512, 1) X(12, 1024, 2) X(13, 1024, 1)

// A ring holds as many stripes as fit a block's shared memory, at most
// RING_STAGES; a row takes N up to RING_MAX_N columns, a thread holding
// RING_MAX_N / THREADS of them (of x, of y and of each stripe row) in
// registers.  Must match kernels/atax.py.
constexpr int RING_STAGES = 16;
constexpr int RING_MAX_N = 8192;

enum AtaxFamily { ATAX_SWEEP = 0, ATAX_RING = 1 };

// Threads of the column-sum launch: 16 warps, 32 columns per block.
#define COLSUM_WARPS 16

// ---------------------------------------------------------------------------
// matvec
// ---------------------------------------------------------------------------

template <typename T, int ROWS, int WPR>
__global__ void __launch_bounds__(32 * ROWS * WPR)
matvec_kernel(const T* __restrict__ A, const T* __restrict__ x,
              T* __restrict__ y, int M, int N, int vec) {
  constexpr int V = VecWidth<T>::value, S = 32 * WPR;
  __shared__ float part[ROWS * WPR];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / WPR, w = warp % WPR;
  const int row = blockIdx.x * ROWS + r;
  const int t = w * 32 + lane;
  float acc = 0.f;
  if (row < M) {
    const T* a = A + (size_t)row * N;
    if (vec) {
      const int nv = N / V;
#pragma unroll 4
      for (int c = t; c < nv; c += S) {
        float av[V], xv[V];
        load16(a + (size_t)c * V, av);
        load16(x + (size_t)c * V, xv);
#pragma unroll
        for (int j = 0; j < V; ++j) acc = fmaf(av[j], xv[j], acc);
      }
    } else {
      for (int c = t; c < N; c += S) acc = fmaf(to_f(a[c]), to_f(x[c]), acc);
    }
  }
  acc = warp_sum(acc);
  if (WPR == 1) {
    if (lane == 0 && row < M) y[row] = from_f<T>(acc);
    return;
  }
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (w == 0 && lane == 0 && row < M) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < WPR; ++i) s += part[r * WPR + i];
    y[row] = from_f<T>(s);
  }
}

// ---------------------------------------------------------------------------
// atax / BiCG: helpers over a thread's own columns of ys
// ---------------------------------------------------------------------------

// ys[base .. base+V) += add[0 .. V), as 16-byte shared-memory accesses.
template <int V>
__device__ __forceinline__ void ys_add(float* ys, int base,
                                       const float* add) {
  float4* p = reinterpret_cast<float4*>(ys + base);
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
    float4 v = p[k];
    v.x += add[4 * k]; v.y += add[4 * k + 1];
    v.z += add[4 * k + 2]; v.w += add[4 * k + 3];
    p[k] = v;
  }
}

// Zero this thread's columns of ys (units: V-vectors when vec, else
// single columns).
template <int V, int THREADS>
__device__ __forceinline__ void ys_zero(float* ys, int N, int vec) {
  if (vec) {
    for (int c = threadIdx.x; c < N / V; c += THREADS) {
      float4* p = reinterpret_cast<float4*>(ys + c * V);
#pragma unroll
      for (int k = 0; k < V / 4; ++k) p[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int c = threadIdx.x; c < N; c += THREADS) ys[c] = 0.f;
  }
}

// Copy this thread's columns of ys into the block's workspace row.
template <int V, int THREADS>
__device__ __forceinline__ void ys_store(const float* ys, float* ws, int N,
                                         int vec) {
  float* w = ws + (size_t)blockIdx.x * N;
  if (vec) {
    for (int c = threadIdx.x; c < N / V; c += THREADS) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k)
        reinterpret_cast<float4*>(w + c * V)[k] =
            reinterpret_cast<const float4*>(ys + c * V)[k];
    }
  } else {
    for (int c = threadIdx.x; c < N; c += THREADS) w[c] = ys[c];
  }
}

// Block-wide sums of acc[0 .. ROWS): warp shuffles, then the warps'
// sums in warp order by thread r for row r.  red is [THREADS/32][ROWS].
template <int THREADS, int ROWS>
__device__ __forceinline__ void block_rows_sum(const float* acc, float* red,
                                               float* out) {
  constexpr int NW = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) red[warp * ROWS + r] = v;
  }
  __syncthreads();
  if (threadIdx.x < ROWS) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w * ROWS + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// atax
// ---------------------------------------------------------------------------

template <typename T, int THREADS, int ROWS>
__global__ void __launch_bounds__(THREADS)
atax_kernel(const T* __restrict__ A, const T* __restrict__ x,
            float* __restrict__ ws, int M, int N, int vec) {
  constexpr int V = VecWidth<T>::value;
  extern __shared__ __align__(16) float ys[];
  __shared__ float red[(THREADS / 32) * ROWS];
  __shared__ float ts[ROWS];
  const int tid = threadIdx.x;
  ys_zero<V, THREADS>(ys, N, vec);
  const int stripes = (M + ROWS - 1) / ROWS;
  for (int st = blockIdx.x; st < stripes; st += gridDim.x) {
    const int row0 = st * ROWS;
    const int nr = min(ROWS, M - row0);
    // pass 1: t = A_stripe . x
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    if (vec) {
      for (int c = tid; c < N / V; c += THREADS) {
        float xv[V];
        load16(x + (size_t)c * V, xv);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nr) {
            float av[V];
            load16(A + (size_t)(row0 + r) * N + (size_t)c * V, av);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[r] = fmaf(av[j], xv[j], acc[r]);
          }
        }
      }
    } else {
      for (int c = tid; c < N; c += THREADS) {
        const float xc = to_f(x[c]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < nr)
            acc[r] = fmaf(to_f(A[(size_t)(row0 + r) * N + c]), xc, acc[r]);
      }
    }
    block_rows_sum<THREADS, ROWS>(acc, red, ts);
    // the TPU kernel rounds t to the input type before A^T t; rows past
    // M add nothing
    float tr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      tr[r] = r < nr ? to_f(from_f<T>(ts[r])) : 0.f;
    // pass 2: ys += A_stripe^T . t (the stripe again, from L2)
    if (vec) {
      for (int c = tid; c < N / V; c += THREADS) {
        float add[V];
#pragma unroll
        for (int j = 0; j < V; ++j) add[j] = 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nr) {
            float av[V];
            load16(A + (size_t)(row0 + r) * N + (size_t)c * V, av);
#pragma unroll
            for (int j = 0; j < V; ++j) add[j] = fmaf(av[j], tr[r], add[j]);
          }
        }
        ys_add<V>(ys, c * V, add);
      }
    } else {
      for (int c = tid; c < N; c += THREADS) {
        float add = 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < nr)
            add = fmaf(to_f(A[(size_t)(row0 + r) * N + c]), tr[r], add);
        ys[c] += add;
      }
    }
  }
  ys_store<V, THREADS>(ys, ws, N, vec);
}

// ---------------------------------------------------------------------------
// atax, ring rows
// ---------------------------------------------------------------------------

// Static shared memory of a ring instantiation beside its S stripe
// buffers: the warps' sums, two halves, and a full barrier per stage.
template <int THREADS, int ROWS>
struct AtaxRingShared {
  alignas(16) float red[2][ROWS][THREADS / 32];
  uint64_t full[RING_STAGES];
};

// y's partial sums of one block over its stripes, through a ring of S
// (2 <= S <= RING_STAGES) stripe buffers in dynamic shared memory.  A
// thread owns COLS = RING_MAX_N / THREADS columns of every row: its
// vectors j = tid + k * THREADS, k < COLS / V.
template <typename T, int THREADS, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
atax_ring_kernel(const T* __restrict__ A, const T* __restrict__ x,
                 float* __restrict__ ws, int M, int N, int S) {
  constexpr int COLS = RING_MAX_N / THREADS;
  constexpr int V = VecWidth<T>::value, NW = THREADS / 32, VPT = COLS / V;
  static_assert(COLS * THREADS == RING_MAX_N && COLS % 8 == 0 && NW <= 32,
                "whole vectors of both types");
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ AtaxRingShared<THREADS, ROWS> sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nv = N / V;                       // 16-byte vectors a row
  const int row_bytes = N * (int)sizeof(T);   // a multiple of 16
  const int stage = ROWS * row_bytes;
  const int stripes = (M + ROWS - 1) / ROWS;
  // this block's stripes: blockIdx.x, blockIdx.x + grid, ...
  const int mine = stripes > (int)blockIdx.x
      ? (stripes - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const uint32_t ring0 = smem_u32(ring);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&sh.full[s]), 1);
    mbar_init_fence();
  }
  __syncthreads();
  // local stripe i into stage i % S: its rows are contiguous in A, one
  // bulk copy
  auto issue = [&](int i) {
    const int row0 = ((int)blockIdx.x + i * (int)gridDim.x) * ROWS;
    const int nr = min(ROWS, M - row0);
    const uint32_t bar = smem_u32(&sh.full[i % S]);
    mbar_expect_tx(bar, nr * row_bytes);
    bulk_load(ring0 + (i % S) * stage, A + (size_t)row0 * N, nr * row_bytes,
              bar);
  };
  if (tid == 0)
    for (int i = 0; i < min(S, mine); ++i) issue(i);
  // the thread's columns of x and of its partial y, in f32
  float xr[VPT][V], ys[VPT][V];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = tid + k * THREADS;
    if (j < nv) load16(x + (size_t)j * V, xr[k]);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (j >= nv) xr[k][v] = 0.f;
      ys[k][v] = 0.f;
    }
  }
  for (int i = 0; i < mine; ++i) {
    const int row0 = ((int)blockIdx.x + i * (int)gridDim.x) * ROWS;
    const int nr = min(ROWS, M - row0);
    mbar_wait(smem_u32(&sh.full[i % S]), (i / S) & 1);
    const unsigned char* st = ring + (i % S) * stage;
    // pass 1: the thread's columns of the stripe, read from the stage
    // once and kept in f32 for pass 2, and its part of t = A_stripe . x
    float af[VPT][ROWS][V];
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = tid + k * THREADS;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (j < nv && r < nr) {
          unpack16<T>(*reinterpret_cast<const uint4*>(
              st + r * row_bytes + j * 16), af[k][r]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) af[k][r][v] = 0.f;
        }
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[r] = fmaf(af[k][r][v], xr[k][v], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float w = warp_sum(acc[r]);
      if (lane == 0) sh.red[i & 1][r][warp] = w;
    }
    // the warps' sums are in, and every thread has read stripe i's
    // stage: it takes the stripe S ahead
    __syncthreads();
    if (tid == 0 && i + S < mine) issue(i + S);
    // t: lane w takes warp w's sum and a fixed butterfly adds them, the
    // same in every warp; rounded to the input type as the TPU kernel
    // rounds it; rows past M add nothing
    float t[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s = warp_sum(lane < NW ? sh.red[i & 1][r][lane] : 0.f);
      t[r] = r < nr ? to_f(from_f<T>(s)) : 0.f;
    }
    // pass 2: ys += A_stripe^T . t, from the columns pass 1 kept
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          ys[k][v] = fmaf(af[k][r][v], t[r], ys[k][v]);
      }
    }
  }
  float* w = ws + (size_t)blockIdx.x * N;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = tid + k * THREADS;
    if (j < nv) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        reinterpret_cast<float4*>(w + (size_t)j * V)[q] = make_float4(
            ys[k][4 * q], ys[k][4 * q + 1], ys[k][4 * q + 2],
            ys[k][4 * q + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// BiCG
// ---------------------------------------------------------------------------

template <typename T, int THREADS, int ROWS>
__global__ void __launch_bounds__(THREADS)
bicg_kernel(const T* __restrict__ A, const T* __restrict__ p,
            const T* __restrict__ rv, T* __restrict__ q,
            float* __restrict__ ws, int M, int N, int vec) {
  constexpr int V = VecWidth<T>::value;
  extern __shared__ __align__(16) float ys[];
  __shared__ float red[(THREADS / 32) * ROWS];
  __shared__ float qs[ROWS];
  const int tid = threadIdx.x;
  ys_zero<V, THREADS>(ys, N, vec);
  const int stripes = (M + ROWS - 1) / ROWS;
  for (int st = blockIdx.x; st < stripes; st += gridDim.x) {
    const int row0 = st * ROWS;
    const int nr = min(ROWS, M - row0);
    float acc[ROWS], rr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      acc[r] = 0.f;
      rr[r] = r < nr ? to_f(rv[row0 + r]) : 0.f;
    }
    if (vec) {
      for (int c = tid; c < N / V; c += THREADS) {
        float pv[V], add[V];
        load16(p + (size_t)c * V, pv);
#pragma unroll
        for (int j = 0; j < V; ++j) add[j] = 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nr) {
            float av[V];
            load16(A + (size_t)(row0 + r) * N + (size_t)c * V, av);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              acc[r] = fmaf(av[j], pv[j], acc[r]);
              add[j] = fmaf(av[j], rr[r], add[j]);
            }
          }
        }
        ys_add<V>(ys, c * V, add);
      }
    } else {
      for (int c = tid; c < N; c += THREADS) {
        const float pc = to_f(p[c]);
        float add = 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nr) {
            const float a = to_f(A[(size_t)(row0 + r) * N + c]);
            acc[r] = fmaf(a, pc, acc[r]);
            add = fmaf(a, rr[r], add);
          }
        }
        ys[c] += add;
      }
    }
    block_rows_sum<THREADS, ROWS>(acc, red, qs);
    if (tid < nr) q[row0 + tid] = from_f<T>(qs[tid]);
  }
  ys_store<V, THREADS>(ys, ws, N, vec);
}

// ---------------------------------------------------------------------------
// the workspace's column sums, in block order
// ---------------------------------------------------------------------------

// Block: COLSUM_WARPS warps over 32 columns; warp w adds rows
// w, w + COLSUM_WARPS, ... of the workspace, then warp 0 adds the warps'
// sums in warp order.  The order depends only on G and N.
template <typename T>
__global__ void __launch_bounds__(32 * COLSUM_WARPS)
colsum_kernel(const float* __restrict__ ws, T* __restrict__ y, int G,
              int N) {
  __shared__ float part[COLSUM_WARPS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < N) {
#pragma unroll 4
    for (int b = warp; b < G; b += COLSUM_WARPS)
      s += ws[(size_t)b * N + col];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < N) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < COLSUM_WARPS; ++w) t += part[w][lane];
    y[col] = from_f<T>(t);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
static int vec_ok(const void* a, const void* b, int N) {
  return (N % VecWidth<T>::value == 0) && aligned16(a) && aligned16(b);
}

template <typename T, int ROWS, int WPR>
static int launch_matvec(const void* A, const void* x, void* y, int M,
                         int N, cudaStream_t s) {
  const int grid = (M + ROWS - 1) / ROWS;
  matvec_kernel<T, ROWS, WPR><<<grid, 32 * ROWS * WPR, 0, s>>>(
      (const T*)A, (const T*)x, (T*)y, M, N, vec_ok<T>(A, x, N));
  return (int)cudaGetLastError();
}

// The waves of one atax/BiCG instantiation, kept per (device, N): the
// runtime is asked once, and a launch reads its grid from here.
struct WaveCache {
  static constexpr int SLOTS = 32;
  std::mutex mu;
  int used = 0;
  int dev[SLOTS], n[SLOTS], wave[SLOTS];
};

// The persistent grid of one atax/BiCG instantiation at M x N: one wave
// of the blocks the occupancy calculator fits per SM at ``smem`` bytes
// of dynamic shared memory (asked of the runtime at the first launch at
// N on the device, then read from ``cache``), at most one block per
// stripe.
template <typename K>
static int cached_grid(K kernel, int threads, int rows, int smem, int M,
                       int N, WaveCache* cache, int* configured, int* grid) {
  int dev = 0, wave = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  {
    std::lock_guard<std::mutex> hold(cache->mu);
    int i = 0;
    while (i < cache->used && !(cache->dev[i] == dev && cache->n[i] == N)) ++i;
    if (i < cache->used) {
      wave = cache->wave[i];
    } else {
      e = allow_smem(kernel, smem, configured);
      if (e != cudaSuccess) return (int)e;
      int per_sm = 0, sms = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
      if (e != cudaSuccess) return (int)e;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
      wave = per_sm * sms;
      if (cache->used < WaveCache::SLOTS) {
        cache->dev[i] = dev;
        cache->n[i] = N;
        cache->wave[i] = wave;
        ++cache->used;
      }
    }
  }
  const int stripes = (M + rows - 1) / rows;
  *grid = wave < stripes ? wave : stripes;
  return 0;
}

template <typename T>
static int launch_colsum(const float* ws, void* y, int G, int N,
                         cudaStream_t s) {
  colsum_kernel<T><<<(N + 31) / 32, 32 * COLSUM_WARPS, 0, s>>>(
      ws, (T*)y, G, N);
  return (int)cudaGetLastError();
}

template <typename T, int THREADS, int ROWS>
static int atax_grid(int M, int N, int* grid) {
  static int configured = 0;
  static WaveCache cache;
  return cached_grid(atax_kernel<T, THREADS, ROWS>, THREADS, ROWS, N * 4, M,
                     N, &cache, &configured, grid);
}

// The stages of a ring instantiation at N columns of T: as many
// stripes as fit a block's 227 KB beside the static shared memory, at
// most RING_STAGES; 0 where it does not take N (rows not a whole number
// of 16-byte vectors, more than RING_MAX_N columns, fewer than two
// stages).  Its dynamic bytes in *smem.
template <typename T, int THREADS, int ROWS>
static int ring_stages(int N, int* smem) {
  constexpr long long room =
      232448 - (long long)sizeof(AtaxRingShared<THREADS, ROWS>);
  const long long stage = (long long)ROWS * N * sizeof(T);
  if (N <= 0 || (N * (long long)sizeof(T)) % 16 != 0 || N > RING_MAX_N)
    return 0;
  const long long fit = room / stage;
  const int S = (int)(fit < RING_STAGES ? fit : RING_STAGES);
  if (S < 2) return 0;
  *smem = (int)(S * stage);
  return S;
}

template <typename T, int THREADS, int ROWS>
static int atax_ring_grid(int M, int N, int* grid) {
  static int configured = 0;
  static WaveCache cache;
  int smem = 0;
  if (ring_stages<T, THREADS, ROWS>(N, &smem) == 0)
    return (int)cudaErrorInvalidValue;
  return cached_grid(atax_ring_kernel<T, THREADS, ROWS>,
                     THREADS, ROWS, smem, M, N, &cache, &configured, grid);
}

template <typename T, int THREADS, int ROWS>
static int bicg_grid(int M, int N, int* grid) {
  static int configured = 0;
  static WaveCache cache;
  return cached_grid(bicg_kernel<T, THREADS, ROWS>, THREADS, ROWS, N * 4, M,
                     N, &cache, &configured, grid);
}

template <typename T, int THREADS, int ROWS>
static int launch_atax(const void* A, const void* x, void* y, void* ws,
                       int G, int M, int N, cudaStream_t s) {
  int cap = 0;
  int rc = atax_grid<T, THREADS, ROWS>(M, N, &cap);
  if (rc != 0) return rc;
  if (G < 1 || G > cap) return (int)cudaErrorInvalidValue;
  atax_kernel<T, THREADS, ROWS><<<G, THREADS, N * 4, s>>>(
      (const T*)A, (const T*)x, (float*)ws, M, N, vec_ok<T>(A, x, N));
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_colsum<T>((const float*)ws, y, G, N, s);
}

template <typename T, int THREADS, int ROWS>
static int launch_atax_ring(const void* A, const void* x, void* y, void* ws,
                            int G, int M, int N, cudaStream_t s) {
  int cap = 0, smem = 0;
  int rc = atax_ring_grid<T, THREADS, ROWS>(M, N, &cap);
  if (rc != 0) return rc;
  if (G < 1 || G > cap || !aligned16(A) || !aligned16(x))
    return (int)cudaErrorInvalidValue;
  const int S = ring_stages<T, THREADS, ROWS>(N, &smem);
  atax_ring_kernel<T, THREADS, ROWS><<<G, THREADS, smem, s>>>(
      (const T*)A, (const T*)x, (float*)ws, M, N, S);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_colsum<T>((const float*)ws, y, G, N, s);
}

template <typename T, int THREADS, int ROWS>
static int launch_bicg(const void* A, const void* p, const void* r, void* q,
                       void* sv, void* ws, int G, int M, int N,
                       cudaStream_t s) {
  int cap = 0;
  int rc = bicg_grid<T, THREADS, ROWS>(M, N, &cap);
  if (rc != 0) return rc;
  if (G < 1 || G > cap) return (int)cudaErrorInvalidValue;
  bicg_kernel<T, THREADS, ROWS><<<G, THREADS, N * 4, s>>>(
      (const T*)A, (const T*)p, (const T*)r, (T*)q, (float*)ws, M, N,
      vec_ok<T>(A, p, N));
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_colsum<T>((const float*)ws, sv, G, N, s);
}

extern "C" {

// y = A x; A (M x N) row-major, x (N), y (M).
int repro_matvec(int tile, int dtype, const void* A, const void* x, void* y,
                 int M, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MV_CASE(i, ROWS, WPR)                                               \
  case i:                                                                   \
    return dtype == 0 ? launch_matvec<float, ROWS, WPR>(A, x, y, M, N, s)   \
                      : launch_matvec<bf16, ROWS, WPR>(A, x, y, M, N, s);
  switch (tile) { MATVEC_TILES(MV_CASE) default: break; }
#undef MV_CASE
  return (int)cudaErrorInvalidValue;
}

// The persistent grid (workspace rows) of one atax (kind 7: ATAX_TILES)
// or BiCG (kind 8: BLAS2_TILES) instantiation at M x N on the current
// device.
int repro_blas2_grid(int kind, int tile, int dtype, int M, int N,
                     int* grid) {
#define ATAX_GRID(i, THREADS, ROWS)                                         \
  case i:                                                                   \
    return dtype == 0 ? atax_grid<float, THREADS, ROWS>(M, N, grid)         \
                      : atax_grid<bf16, THREADS, ROWS>(M, N, grid);
#define ATAX_RING_GRID(i, THREADS, ROWS)                                    \
  case i:                                                                   \
    return dtype == 0 ? atax_ring_grid<float, THREADS, ROWS>(M, N, grid)    \
                      : atax_ring_grid<bf16, THREADS, ROWS>(M, N, grid);
#define BICG_GRID(i, THREADS, ROWS)                                         \
  case i:                                                                   \
    return dtype == 0 ? bicg_grid<float, THREADS, ROWS>(M, N, grid)         \
                      : bicg_grid<bf16, THREADS, ROWS>(M, N, grid);
  if (kind == KIND_ATAX) {
    switch (tile) {
      BLAS2_TILES(ATAX_GRID)
      ATAX_RING_TILES(ATAX_RING_GRID)
      default: break;
    }
  } else if (kind == KIND_BICG) {
    switch (tile) { BLAS2_TILES(BICG_GRID) default: break; }
  }
#undef ATAX_GRID
#undef ATAX_RING_GRID
#undef BICG_GRID
  return (int)cudaErrorInvalidValue;
}

// y = A^T (A x) with t = A x rounded to the input type; ws holds
// G x N floats (G from repro_blas2_grid).  Two launches on `stream`.
int repro_atax(int tile, int dtype, const void* A, const void* x, void* y,
               void* ws, int G, int M, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define ATAX_CASE(i, THREADS, ROWS)                                         \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? launch_atax<float, THREADS, ROWS>(A, x, y, ws, G, M, N, s)        \
        : launch_atax<bf16, THREADS, ROWS>(A, x, y, ws, G, M, N, s);
#define ATAX_RING_CASE(i, THREADS, ROWS)                                    \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? launch_atax_ring<float, THREADS, ROWS>(A, x, y, ws, G, M, N, s)   \
        : launch_atax_ring<bf16, THREADS, ROWS>(A, x, y, ws, G, M, N, s);
  switch (tile) {
    BLAS2_TILES(ATAX_CASE)
    ATAX_RING_TILES(ATAX_RING_CASE)
    default: break;
  }
#undef ATAX_CASE
#undef ATAX_RING_CASE
  return (int)cudaErrorInvalidValue;
}

// q = A p, s = A^T r; ws holds G x N floats.  Two launches on `stream`.
int repro_bicg(int tile, int dtype, const void* A, const void* p,
               const void* r, void* q, void* sv, void* ws, int G, int M,
               int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define BICG_CASE(i, THREADS, ROWS)                                         \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? launch_bicg<float, THREADS, ROWS>(A, p, r, q, sv, ws, G, M, N, s) \
        : launch_bicg<bf16, THREADS, ROWS>(A, p, r, q, sv, ws, G, M, N, s);
  switch (tile) { BLAS2_TILES(BICG_CASE) default: break; }
#undef BICG_CASE
  return (int)cudaErrorInvalidValue;
}

int repro_blas2_attrs(int kind, int tile, int dtype, int* regs, int* smem,
                      int* max_threads) {
#define MV_ATTR(i, ROWS, WPR)                                               \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? kernel_attrs(matvec_kernel<float, ROWS, WPR>, regs, smem, max_threads) \
        : kernel_attrs(matvec_kernel<bf16, ROWS, WPR>, regs, smem, max_threads);
#define ATAX_ATTR(i, THREADS, ROWS)                                         \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? kernel_attrs(atax_kernel<float, THREADS, ROWS>, regs, smem, max_threads) \
        : kernel_attrs(atax_kernel<bf16, THREADS, ROWS>, regs, smem, max_threads);
#define ATAX_RING_ATTR(i, THREADS, ROWS)                                    \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? kernel_attrs(atax_ring_kernel<float, THREADS, ROWS>, regs, smem,  \
                       max_threads)                                         \
        : kernel_attrs(atax_ring_kernel<bf16, THREADS, ROWS>, regs, smem,   \
                       max_threads);
#define BICG_ATTR(i, THREADS, ROWS)                                         \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? kernel_attrs(bicg_kernel<float, THREADS, ROWS>, regs, smem, max_threads) \
        : kernel_attrs(bicg_kernel<bf16, THREADS, ROWS>, regs, smem, max_threads);
  if (kind == KIND_MATVEC) {
    switch (tile) { MATVEC_TILES(MV_ATTR) default: break; }
  } else if (kind == KIND_ATAX) {
    switch (tile) {
      BLAS2_TILES(ATAX_ATTR)
      ATAX_RING_TILES(ATAX_RING_ATTR)
      default: break;
    }
  } else if (kind == KIND_BICG) {
    switch (tile) { BLAS2_TILES(BICG_ATTR) default: break; }
  }
#undef MV_ATTR
#undef ATAX_ATTR
#undef ATAX_RING_ATTR
#undef BICG_ATTR
  return (int)cudaErrorInvalidValue;
}

// matvec: out[0] = ROWS, out[1] = WPR; atax/BiCG: out[0] = THREADS,
// out[1] = ROWS, and atax's out[2] = family (0 for the sweep rows);
// out[5] = threads.
int repro_blas2_tile_info(int kind, int tile, int* out) {
#define MV_INFO(i, ROWS, WPR)                                               \
  case i: out[0] = ROWS; out[1] = WPR; out[2] = out[3] = out[4] = 0;        \
    out[5] = 32 * ROWS * WPR; return 0;
#define B2_INFO(i, THREADS, ROWS)                                           \
  case i: out[0] = THREADS; out[1] = ROWS; out[2] = out[3] = out[4] = 0;    \
    out[5] = THREADS; return 0;
#define RING_INFO(i, THREADS, ROWS)                                         \
  case i: out[0] = THREADS; out[1] = ROWS; out[2] = ATAX_RING;              \
    out[3] = out[4] = 0; out[5] = THREADS; return 0;
  if (kind == KIND_MATVEC) {
    switch (tile) { MATVEC_TILES(MV_INFO) default: break; }
  } else if (kind == KIND_ATAX) {
    switch (tile) {
      BLAS2_TILES(B2_INFO)
      ATAX_RING_TILES(RING_INFO)
      default: break;
    }
  } else if (kind == KIND_BICG) {
    switch (tile) { BLAS2_TILES(B2_INFO) default: break; }
  }
#undef MV_INFO
#undef B2_INFO
#undef RING_INFO
  return -1;
}

}  // extern "C"
