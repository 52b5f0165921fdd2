// Matrix-vector kernels for Hopper: the port of the paper's Table IV
// BLAS-2 Pallas kernels (matVec2D, atax, BiCG).
//
// Replaces (src/repro/kernels/):
//   matvec.py:_mv_kernel            -> matvec_kernel       (repro_matvec)
//   atax.py:_atax_kernel_rowsweep   -> atax_kernel + colsum_kernel (repro_atax)
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
//   * atax needs t_i = A_i . x before A_i^T t_i, so a stripe is read
//     twice: pass 1 reduces t (cast to the input type before the second
//     product, as the TPU kernel does at atax.py:43), pass 2 adds
//     A_i^T t_i.  The second read comes from L2 while the stripes in
//     flight across the card (blocks x ROWS x N x bytes) fit it; the
//     analysis charges a second pass over A from device memory when
//     they do not.
// The grid is persistent: one wave of blocks (as many as the
// occupancy calculator fits, at most one per stripe).  Each block writes
// its ys row into a workspace (grid x N f32) that the wrapper allocates,
// and colsum_kernel adds the rows in block order: no float atomics, so
// two runs give bitwise the same result.  The workspace costs
// 2 x grid x N x 4 bytes of traffic beside A.
//
// Left on the table: cp.async/TMA double-buffering of the stripe (loads
// and FMAs overlap only across warps here), holding the atax stripe in
// shared memory so A is read from device memory exactly once, and a
// smaller workspace (thread block clusters could sum ys rows in DSMEM).
#include "common.cuh"

// (index, ROWS, WPR) -- threads = 32 * ROWS * WPR.  Must match
// repro_torch/kernels/matvec.py MATVEC_TILES.
#define MATVEC_TILES(X)                                                    \
  X(0, 1, 1) X(1, 2, 1) X(2, 4, 1) X(3, 8, 1) X(4, 16, 1) X(5, 32, 1)      \
  X(6, 1, 4) X(7, 1, 8) X(8, 2, 8) X(9, 4, 8)

// (index, THREADS, ROWS).  Must match repro_torch/kernels/atax.py
// BLAS2_TILES (atax and BiCG share the table).
#define BLAS2_TILES(X)                                                     \
  X(0, 32, 1) X(1, 64, 1) X(2, 128, 1) X(3, 128, 4) X(4, 256, 1)           \
  X(5, 256, 2) X(6, 256, 4) X(7, 512, 1) X(8, 512, 2) X(9, 1024, 1)

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

// The persistent grid of one atax/BiCG instantiation: one wave of the
// blocks the occupancy calculator fits per SM (ys takes N*4 bytes of
// dynamic shared memory), at most one block per stripe.
template <typename K>
static int persistent_grid(K kernel, int threads, int rows, int M, int N,
                           int* configured, int* grid) {
  const int smem = N * 4;
  cudaError_t e = allow_smem(kernel, smem, configured);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int stripes = (M + rows - 1) / rows;
  *grid = per_sm * sms < stripes ? per_sm * sms : stripes;
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
  return persistent_grid(atax_kernel<T, THREADS, ROWS>, THREADS, ROWS, M, N,
                         &configured, grid);
}

template <typename T, int THREADS, int ROWS>
static int bicg_grid(int M, int N, int* grid) {
  static int configured = 0;
  return persistent_grid(bicg_kernel<T, THREADS, ROWS>, THREADS, ROWS, M, N,
                         &configured, grid);
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

// The persistent grid (workspace rows) of one atax (kind 7) or BiCG
// (kind 8) instantiation at M x N on the current device.
int repro_blas2_grid(int kind, int tile, int dtype, int M, int N,
                     int* grid) {
#define GRID_CASE(i, THREADS, ROWS)                                         \
  case i:                                                                   \
    if (kind == KIND_ATAX)                                                  \
      return dtype == 0 ? atax_grid<float, THREADS, ROWS>(M, N, grid)       \
                        : atax_grid<bf16, THREADS, ROWS>(M, N, grid);       \
    return dtype == 0 ? bicg_grid<float, THREADS, ROWS>(M, N, grid)         \
                      : bicg_grid<bf16, THREADS, ROWS>(M, N, grid);
  if (kind != KIND_ATAX && kind != KIND_BICG)
    return (int)cudaErrorInvalidValue;
  switch (tile) { BLAS2_TILES(GRID_CASE) default: break; }
#undef GRID_CASE
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
  switch (tile) { BLAS2_TILES(ATAX_CASE) default: break; }
#undef ATAX_CASE
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
#define BICG_ATTR(i, THREADS, ROWS)                                         \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? kernel_attrs(bicg_kernel<float, THREADS, ROWS>, regs, smem, max_threads) \
        : kernel_attrs(bicg_kernel<bf16, THREADS, ROWS>, regs, smem, max_threads);
  if (kind == KIND_MATVEC) {
    switch (tile) { MATVEC_TILES(MV_ATTR) default: break; }
  } else if (kind == KIND_ATAX) {
    switch (tile) { BLAS2_TILES(ATAX_ATTR) default: break; }
  } else if (kind == KIND_BICG) {
    switch (tile) { BLAS2_TILES(BICG_ATTR) default: break; }
  }
#undef MV_ATTR
#undef ATAX_ATTR
#undef BICG_ATTR
  return (int)cudaErrorInvalidValue;
}

// matvec: out[0] = ROWS, out[1] = WPR; atax/BiCG: out[0] = THREADS,
// out[1] = ROWS; out[5] = threads.
int repro_blas2_tile_info(int kind, int tile, int* out) {
#define MV_INFO(i, ROWS, WPR)                                               \
  case i: out[0] = ROWS; out[1] = WPR; out[2] = out[3] = out[4] = 0;        \
    out[5] = 32 * ROWS * WPR; return 0;
#define B2_INFO(i, THREADS, ROWS)                                           \
  case i: out[0] = THREADS; out[1] = ROWS; out[2] = out[3] = out[4] = 0;    \
    out[5] = THREADS; return 0;
  if (kind == KIND_MATVEC) {
    switch (tile) { MATVEC_TILES(MV_INFO) default: break; }
  } else if (kind == KIND_ATAX || kind == KIND_BICG) {
    switch (tile) { BLAS2_TILES(B2_INFO) default: break; }
  }
#undef MV_INFO
#undef B2_INFO
  return -1;
}

}  // extern "C"
