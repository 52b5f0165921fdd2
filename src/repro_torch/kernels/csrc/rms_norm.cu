// RMSNorm for Hopper: the port of the rms_norm Pallas kernel.
//
// Replaces src/repro/kernels/rms_norm.py:_rms_kernel with three families
// of one table (RMS_TILES, RMS_VEC_TILES, then RMS_CLUSTER_TILES,
// indices running on; kernels/rms_norm.py RMS_TILES on the Python side),
// ranked together by the H100 analysis:
//
// Warp-per-row rows (rms_kernel, any D).  One warp per row, ROWS rows
// (warps) per block: each lane sums x^2 in f32 over a strided slice of
// the row, a butterfly of warp shuffles completes the sum, and the
// lanes write x * rsqrt(mean(x^2) + eps) * w in the input type.  No
// shared memory, no block-wide barrier.  2-byte scalar loads and a
// second pass that re-reads x (from L1/L2); at M = 4 the whole launch is
// one block on one SM.  They stay the route for ragged rows (D not a
// multiple of a 16-byte vector).
//
// Row-in-register rows (rms_vec_kernel; D a multiple of 16 / elem_bytes
// and D <= THREADS * VMAX * 16 / elem_bytes).  One block of THREADS
// threads per row, so M = 4 spreads over 4 SMs and M = 256 over 256
// blocks.  Every thread issues all its 16-byte loads of x (up to VMAX)
// before using any and keeps them in registers; warp shuffles and one
// pass over the warps' partial sums in shared memory, in warp order
// (two calls give the same bits), make the row's sum; then the row is
// scaled from the registers -- no second read of x -- with the f32
// weight read by 16-byte loads (from L2 after the first block), and
// written with 16-byte stores.
//
// Cluster rows (rms_cluster_kernel; D a multiple of 16 / elem_bytes and
// D <= C * THREADS * VMAX * 16 / elem_bytes): rows too long for one
// block's registers, or too few to fill the card.  A row is cut into C
// slices of whole vectors, one per block of a thread-block cluster (C =
// 2, 4 or 8, within the portable cluster size), so M = 4 rows of 24576
// spread over 4 C SMs.  Each block holds its slice in registers as the
// vector rows do and puts the slice's sum of x^2 in its shared memory;
// after a cluster barrier every block reads the C sums through
// distributed shared memory in rank order (every block, and every call,
// gets the same bits), then scales its slice from registers.  A second
// cluster barrier, split into an arrive after the reads and a wait
// before the block exits, keeps each block's sum alive until all have
// read it.  Per row: one read and one write of x, one launch.
//
// The weight arrives as f32 (the model keeps norm gains in f32 and the
// wrapper widens any other type).  What bounds it on the H100: bytes --
// one read and one write of x (2 * M * D elements) at 3.35 TB/s; the
// arithmetic (4 FLOPs and part of one rsqrt per element) is far below
// the FP32 rate.  At the serve's decode shape (4 x 3072 bf16, 48 KB) the
// bound is 0.02 us and the launch's latency is what remains: one round
// trip to device memory for x, one to L2 for w, and the block barrier.
// Left for later: fusing the norm into its neighbours (the residual add
// before it, the projection after it), which is where its bytes and its
// launch would go.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// Warp per row: (index, ROWS) -- threads = 32 * ROWS.
#define RMS_TILES(X) X(0, 1) X(1, 2) X(2, 4) X(3, 8) X(4, 16)

// Row in registers: (index, THREADS).  The H100 analysis prices the
// three alike where the row's latency bounds them, and the first wins a
// tie: widest first, the order the card measures them in (more threads
// a row, fewer vectors a thread).
#define RMS_VEC_TILES(X) X(5, 256) X(6, 128) X(7, 64)

// Row over a cluster: (index, C, THREADS) -- C blocks of THREADS threads
// a row.  Where the analysis ties them (a row whose bytes all fit in
// flight), the first wins: the most blocks a row first.
#define RMS_CLUSTER_TILES(X)                                               \
  X(8, 8, 128) X(9, 8, 256) X(10, 4, 256) X(11, 4, 128) X(12, 2, 256)

enum RmsFamily { RMS_SIMT = 0, RMS_VEC = 1, RMS_CLUSTER = 2 };
// 16-byte vectors of x a thread of the vector and cluster rows holds
constexpr int RMS_VMAX = 8;

template <typename T, int ROWS>
__global__ void __launch_bounds__(32 * ROWS)
rms_kernel(const T* __restrict__ x, const float* __restrict__ w,
           T* __restrict__ y, int M, int D, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + warp;
  if (row >= M) return;  // whole warp leaves together: one row per warp
  const T* xr = x + (size_t)row * D;
  T* yr = y + (size_t)row * D;
  float ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = to_f(xr[c]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)D + eps);
  for (int c = lane; c < D; c += 32) yr[c] = from_f<T>(to_f(xr[c]) * r * w[c]);
}

// The vectors v0 + threadIdx.x + k * NT < v1 of a row (k < RMS_VMAX),
// every load issued before any is used, kept in ``raw``; returns this
// thread's sum of their squares.
template <typename T, int NT>
__device__ __forceinline__ float load_slice(const uint4* __restrict__ xr,
                                            int v0, int v1, uint4* raw) {
  constexpr int VW = VecWidth<T>::value;
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < RMS_VMAX; ++k)
    if (v0 + tid + k * NT < v1) raw[k] = __ldg(xr + v0 + tid + k * NT);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < RMS_VMAX; ++k) {
    if (v0 + tid + k * NT < v1) {
      float f[VW];
      unpack16<T>(raw[k], f);
#pragma unroll
      for (int i = 0; i < VW; ++i) ss = fmaf(f[i], f[i], ss);
    }
  }
  return ss;
}

// The block's total of ``ss`` in every thread: warp shuffles, then the
// warps' sums in warp order from shared memory (the same bits on every
// call).
template <int NT>
__device__ __forceinline__ float block_sum(float ss, float* part) {
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) tot += part[i];  // fixed order
  return tot;
}

// y = x * r * w over the vectors `load_slice` holds, 16-byte stores.
template <typename T, int NT>
__device__ __forceinline__ void scale_slice(const uint4* raw,
                                            const float* __restrict__ w,
                                            uint4* __restrict__ yr, int v0,
                                            int v1, float r) {
  constexpr int VW = VecWidth<T>::value;
#pragma unroll
  for (int k = 0; k < RMS_VMAX; ++k) {
    const int v = v0 + threadIdx.x + k * NT;
    if (v < v1) {
      float f[VW];
      unpack16<T>(raw[k], f);
#pragma unroll
      for (int i = 0; i < VW; i += 4) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(w + v * VW + i));
        f[i] = f[i] * r * wv.x;
        f[i + 1] = f[i + 1] * r * wv.y;
        f[i + 2] = f[i + 2] * r * wv.z;
        f[i + 3] = f[i + 3] * r * wv.w;
      }
      yr[v] = pack16<T>(f);
    }
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(NT)
rms_vec_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int D, float eps) {
  __shared__ float part[NT / 32];
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * D);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)blockIdx.x * D);
  const int nv = D / VecWidth<T>::value;  // 16-byte vectors in the row
  uint4 raw[RMS_VMAX];
  const float tot = block_sum<NT>(load_slice<T, NT>(xr, 0, nv, raw), part);
  scale_slice<T, NT>(raw, w, yr, 0, nv, rsqrtf(tot / (float)D + eps));
}

// The second cluster barrier, split: arrive once this block has read
// the others' shared memory, wait before it exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int C, int NT>
__global__ void __launch_bounds__(NT)
rms_cluster_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ y, int D, float eps) {
  __shared__ float part[NT / 32];
  __shared__ float slice_ss;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t row = blockIdx.x / C;
  const int nv = D / VecWidth<T>::value;
  const int per = (nv + C - 1) / C;       // whole vectors a slice
  const int v0 = min(rank * per, nv), v1 = min(v0 + per, nv);
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  uint4* yr = reinterpret_cast<uint4*>(y + row * D);
  uint4 raw[RMS_VMAX];
  const float ss = block_sum<NT>(load_slice<T, NT>(xr, v0, v1, raw), part);
  if (threadIdx.x == 0) slice_ss = ss;
  cluster.sync();                        // every slice's sum is written
  float tot = 0.f;
#pragma unroll
  for (int r = 0; r < C; ++r)            // rank order: the same bits
    tot += *cluster.map_shared_rank(&slice_ss, r);
  cluster_arrive();
  scale_slice<T, NT>(raw, w, yr, v0, v1, rsqrtf(tot / (float)D + eps));
  cluster_wait();
}

template <typename T, int ROWS>
static int launch_rms(const void* x, const void* w, void* y, int M, int D,
                      float eps, cudaStream_t s) {
  const int grid = (M + ROWS - 1) / ROWS;
  rms_kernel<T, ROWS><<<grid, 32 * ROWS, 0, s>>>(
      (const T*)x, (const float*)w, (T*)y, M, D, eps);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
static int launch_rms_vec(const void* x, const void* w, void* y, int M,
                          int D, float eps, cudaStream_t s) {
  constexpr int VW = VecWidth<T>::value;
  if (D % VW != 0 || D > NT * RMS_VMAX * VW || !aligned16(x)
      || !aligned16(w) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  rms_vec_kernel<T, NT><<<M, NT, 0, s>>>((const T*)x, (const float*)w,
                                         (T*)y, D, eps);
  return (int)cudaGetLastError();
}

template <typename T, int C, int NT>
static int launch_rms_cluster(const void* x, const void* w, void* y, int M,
                              int D, float eps, cudaStream_t s) {
  constexpr int VW = VecWidth<T>::value;
  if (D % VW != 0 || D > C * NT * RMS_VMAX * VW || M > 0x7fffffff / C
      || !aligned16(x) || !aligned16(w) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M * C);
  cfg.blockDim = dim3(NT);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, rms_cluster_kernel<T, C, NT>, (const T*)x, (const float*)w,
      (T*)y, D, eps);
  if (e != cudaSuccess) {
    cudaGetLastError();  // leave the refusal to this call alone
    return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// y = x * rsqrt(mean(x^2, -1) + eps) * w over the rows of x (M x D).
int repro_rms_norm(int tile, int dtype, const void* x, const void* w,
                   void* y, int M, int D, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define RMS_CASE(i, ROWS)                                                  \
  case i:                                                                  \
    return dtype == 0 ? launch_rms<float, ROWS>(x, w, y, M, D, eps, s)     \
                      : launch_rms<bf16, ROWS>(x, w, y, M, D, eps, s);
#define RMS_VEC_CASE(i, NT)                                                \
  case i:                                                                  \
    return dtype == 0 ? launch_rms_vec<float, NT>(x, w, y, M, D, eps, s)   \
                      : launch_rms_vec<bf16, NT>(x, w, y, M, D, eps, s);
#define RMS_CLUSTER_CASE(i, C, NT)                                         \
  case i:                                                                  \
    return dtype == 0                                                      \
        ? launch_rms_cluster<float, C, NT>(x, w, y, M, D, eps, s)          \
        : launch_rms_cluster<bf16, C, NT>(x, w, y, M, D, eps, s);
  switch (tile) {
    RMS_TILES(RMS_CASE)
    RMS_VEC_TILES(RMS_VEC_CASE)
    RMS_CLUSTER_TILES(RMS_CLUSTER_CASE)
    default: break;
  }
#undef RMS_CASE
#undef RMS_VEC_CASE
#undef RMS_CLUSTER_CASE
  return (int)cudaErrorInvalidValue;
}

int repro_rms_attrs(int tile, int dtype, int* regs, int* smem,
                    int* max_threads) {
#define RMS_ATTR(i, ROWS)                                                   \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? kernel_attrs(rms_kernel<float, ROWS>, regs, smem, max_threads)    \
        : kernel_attrs(rms_kernel<bf16, ROWS>, regs, smem, max_threads);
#define RMS_VEC_ATTR(i, NT)                                                 \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? kernel_attrs(rms_vec_kernel<float, NT>, regs, smem, max_threads)  \
        : kernel_attrs(rms_vec_kernel<bf16, NT>, regs, smem, max_threads);
#define RMS_CLUSTER_ATTR(i, C, NT)                                          \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? kernel_attrs(rms_cluster_kernel<float, C, NT>, regs, smem,        \
                       max_threads)                                         \
        : kernel_attrs(rms_cluster_kernel<bf16, C, NT>, regs, smem,         \
                       max_threads);
  switch (tile) {
    RMS_TILES(RMS_ATTR)
    RMS_VEC_TILES(RMS_VEC_ATTR)
    RMS_CLUSTER_TILES(RMS_CLUSTER_ATTR)
    default: break;
  }
#undef RMS_ATTR
#undef RMS_VEC_ATTR
#undef RMS_CLUSTER_ATTR
  return (int)cudaErrorInvalidValue;
}

// out[0] = rows per block, out[1] = family, out[2] = VMAX (vector and
// cluster rows; 0 for warp-per-row rows), out[3] = blocks a row (C of a
// cluster row, else 1), out[5] = threads.
int repro_rms_tile_info(int tile, int* out) {
#define RMS_INFO(i, ROWS)                                                   \
  case i: out[0] = ROWS; out[1] = RMS_SIMT; out[2] = out[4] = 0;            \
    out[3] = 1; out[5] = 32 * ROWS; return 0;
#define RMS_VEC_INFO(i, NT)                                                 \
  case i: out[0] = 1; out[1] = RMS_VEC; out[2] = RMS_VMAX; out[3] = 1;      \
    out[4] = 0; out[5] = NT; return 0;
#define RMS_CLUSTER_INFO(i, C, NT)                                          \
  case i: out[0] = 1; out[1] = RMS_CLUSTER; out[2] = RMS_VMAX; out[3] = C;  \
    out[4] = 0; out[5] = NT; return 0;
  switch (tile) {
    RMS_TILES(RMS_INFO)
    RMS_VEC_TILES(RMS_VEC_INFO)
    RMS_CLUSTER_TILES(RMS_CLUSTER_INFO)
    default: break;
  }
#undef RMS_INFO
#undef RMS_VEC_INFO
#undef RMS_CLUSTER_INFO
  return -1;
}

}  // extern "C"
