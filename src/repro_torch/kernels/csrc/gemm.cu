// Tiled GEMMs for Hopper: the port of the matmul and gated-MLP Pallas
// kernels.
//
// Replaces (src/repro/kernels/):
//   matmul.py:_mm_kernel          -> gemm_kernel<T, T>     (repro_gemm, out_f32=0)
//   mlp_matmul.py:_split_mm_kernel -> gemm_kernel<T, float> (repro_gemm, out_f32=1)
//   mlp_matmul.py:_fused_kernel   -> gated_kernel          (repro_gemm_gated)
//   mlp_matmul.py:_stream_kernel  -> stream_kernel         (repro_gemm_stream)
//
// Design.  One block per BM x BN output tile; the Pallas grid's
// sequential K axis becomes a loop inside the block.  Each K step
// stages an A tile (BM x BK, stored transposed) and a B tile (BK x BN)
// in shared memory; each of the (BM/TM)*(BN/TN) threads keeps a TM x TN
// micro-tile of f32 accumulators in registers, reading its A and B
// fragments interleaved (thread t owns columns t, t+BN/TN, ...) so a
// warp reads consecutive shared-memory words.  Edges are masked (zero
// loads, guarded stores), so no shape has to divide a tile: decode
// runs M = batch rows, far below any BM.  The gated kernel keeps a
// second B operand and accumulator and applies act(g) * u at the
// store; the stream kernel stages whole-D panels (no K loop) in
// dynamic shared memory, so it fits only where BM*D + 2*D*BN elements
// fit the 227 KB a block may opt in to.
//
// What bounds it on the H100: at the serve shapes, prefill (M = 256
// tokens) is FP32-FMA bound on the CUDA cores (the bf16 inputs are
// widened; 67 TFLOP/s, not the 989 of the tensor cores), decode (M = 4)
// is bound by reading the weight matrix once from HBM.  Left on the
// table by this simple design: wgmma tensor-core MMA, TMA/cp.async
// multi-stage pipelining (loads and FMAs do not overlap here), 16-byte
// vector loads, and split-K for decode, whose N/BN blocks under-fill
// 132 SMs when N is small.
#include "common.cuh"

// (index, BM, BN, BK, TM, TN) -- 256 threads each.  The Python side's
// tile table (repro_torch/kernels/matmul.py GEMM_TILES) must list the
// same rows in the same order; chip_smoke.py checks it.
#define GEMM_TILES(X)            \
  X(0, 16, 64, 32, 1, 4)         \
  X(1, 32, 64, 32, 2, 4)         \
  X(2, 64, 64, 16, 4, 4)         \
  X(3, 128, 64, 16, 8, 4)        \
  X(4, 64, 128, 16, 4, 8)        \
  X(5, 128, 128, 16, 8, 8)       \
  X(6, 16, 32, 64, 1, 2)         \
  X(7, 16, 16, 64, 1, 1)

// Gated tiles (mlp_matmul.py GATED_TILES): two accumulators per thread.
#define GATED_TILES(X)           \
  X(0, 16, 64, 32, 1, 4)         \
  X(1, 32, 64, 32, 2, 4)         \
  X(2, 64, 64, 16, 4, 4)         \
  X(3, 128, 64, 16, 8, 4)        \
  X(4, 64, 128, 16, 4, 8)        \
  X(5, 16, 32, 64, 1, 2)         \
  X(6, 16, 16, 64, 1, 1)

// Stream tiles (mlp_matmul.py STREAM_TILES): (index, BM, BN, TM, TN).
#define STREAM_TILES(X)          \
  X(0, 4, 4, 1, 1)               \
  X(1, 8, 8, 1, 1)               \
  X(2, 16, 16, 1, 1)             \
  X(3, 32, 32, 2, 2)

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

template <typename T, int BM, int BN, int BK, int TM, int TN>
static int launch_gated(const void* X, const void* G, const void* U, void* O,
                        int M, int N, int K, int act, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gated_kernel<T, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(
      (const T*)X, (const T*)G, (const T*)U, (T*)O, M, N, K, act);
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
// dtype: 0 float32, 1 bfloat16.
int repro_gemm(int tile, int dtype, int out_f32, const void* A,
               const void* B, void* C, int M, int N, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define GEMM_CASE(i, BM, BN, BK, TM, TN)                                     \
  case i:                                                                    \
    if (dtype == 0)                                                          \
      return launch_gemm<float, float, BM, BN, BK, TM, TN>(A, B, C, M, N, K, s); \
    if (out_f32)                                                             \
      return launch_gemm<bf16, float, BM, BN, BK, TM, TN>(A, B, C, M, N, K, s);  \
    return launch_gemm<bf16, bf16, BM, BN, BK, TM, TN>(A, B, C, M, N, K, s);
  switch (tile) { GEMM_TILES(GEMM_CASE) default: break; }
#undef GEMM_CASE
  return (int)cudaErrorInvalidValue;
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
  switch (tile) { GATED_TILES(GATED_CASE) default: break; }
#undef GATED_CASE
  return (int)cudaErrorInvalidValue;
}

// The gated product with whole-D panels resident (no K loop).
int repro_gemm_stream(int tile, int dtype, int act, const void* X,
                      const void* G, const void* U, void* O, int M, int N,
                      int D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define STREAM_CASE(i, BM, BN, TM, TN)                                       \
  case i:                                                                    \
    if (dtype == 0)                                                          \
      return launch_stream<float, BM, BN, TM, TN>(X, G, U, O, M, N, D, act, s); \
    return launch_stream<bf16, BM, BN, TM, TN>(X, G, U, O, M, N, D, act, s);
  switch (tile) { STREAM_TILES(STREAM_CASE) default: break; }
#undef STREAM_CASE
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
  if (kind == KIND_GEMM) {
    switch (tile) { GEMM_TILES(GEMM_ATTR) default: break; }
  } else if (kind == KIND_GATED) {
    switch (tile) { GATED_TILES(GATED_ATTR) default: break; }
  } else if (kind == KIND_STREAM) {
    switch (tile) { STREAM_TILES(STREAM_ATTR) default: break; }
  }
#undef GEMM_ATTR
#undef GATED_ATTR
#undef STREAM_ATTR
  return (int)cudaErrorInvalidValue;
}

// out[0..5] = BM, BN, BK (0 for stream), TM, TN, threads.
int repro_gemm_tile_info(int kind, int tile, int* out) {
#define GEMM_INFO(i, BM, BN, BK, TM, TN)                                     \
  case i: out[0] = BM; out[1] = BN; out[2] = BK; out[3] = TM; out[4] = TN;  \
    out[5] = (BM / TM) * (BN / TN); return 0;
#define STREAM_INFO(i, BM, BN, TM, TN)                                       \
  case i: out[0] = BM; out[1] = BN; out[2] = 0; out[3] = TM; out[4] = TN;   \
    out[5] = (BM / TM) * (BN / TN); return 0;
  if (kind == KIND_GEMM) {
    switch (tile) { GEMM_TILES(GEMM_INFO) default: break; }
  } else if (kind == KIND_GATED) {
    switch (tile) { GATED_TILES(GEMM_INFO) default: break; }
  } else if (kind == KIND_STREAM) {
    switch (tile) { STREAM_TILES(STREAM_INFO) default: break; }
  }
#undef GEMM_INFO
#undef STREAM_INFO
  return -1;
}

}  // extern "C"
