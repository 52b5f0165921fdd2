// RMSNorm for Hopper: the port of the rms_norm Pallas kernel.
//
// Replaces src/repro/kernels/rms_norm.py:_rms_kernel with two families
// of one table (RMS_TILES, then RMS_VEC_TILES, indices running on;
// kernels/rms_norm.py RMS_TILES on the Python side), ranked together by
// the H100 analysis:
//
// Warp-per-row rows (rms_kernel, any D).  One warp per row, ROWS rows
// (warps) per block: each lane sums x^2 in f32 over a strided slice of
// the row, a butterfly of warp shuffles completes the sum, and the
// lanes write x * rsqrt(mean(x^2) + eps) * w in the input type.  No
// shared memory, no block-wide barrier.  2-byte scalar loads and a
// second pass that re-reads x (from L1/L2); at M = 4 the whole launch is
// one block on one SM.  They stay the route for ragged rows (D not a
// multiple of a 16-byte vector) and rows too long for the vector rows.
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

// Warp per row: (index, ROWS) -- threads = 32 * ROWS.
#define RMS_TILES(X) X(0, 1) X(1, 2) X(2, 4) X(3, 8) X(4, 16)

// Row in registers: (index, THREADS).  The H100 analysis prices the
// three alike where the row's latency bounds them, and the first wins a
// tie: widest first, the order the card measures them in (more threads
// a row, fewer vectors a thread).
#define RMS_VEC_TILES(X) X(5, 256) X(6, 128) X(7, 64)

enum RmsFamily { RMS_SIMT = 0, RMS_VEC = 1 };
// 16-byte vectors of x a thread of the vector rows holds
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

// One 16-byte vector of T widened to f32, and back (round to nearest).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& v, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void unpack16<bf16>(const uint4& v, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* in);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float* in) {
  return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                    __float_as_uint(in[2]), __float_as_uint(in[3]));
}
template <>
__device__ __forceinline__ uint4 pack16<bf16>(const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  return v;
}

template <typename T, int NT>
__global__ void __launch_bounds__(NT)
rms_vec_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int D, float eps) {
  constexpr int VW = VecWidth<T>::value;
  __shared__ float part[NT / 32];
  const int tid = threadIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * D);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)blockIdx.x * D);
  const int nv = D / VW;                // 16-byte vectors in the row
  uint4 raw[RMS_VMAX];
#pragma unroll
  for (int k = 0; k < RMS_VMAX; ++k)    // every load issued before use
    if (tid + k * NT < nv) raw[k] = __ldg(xr + tid + k * NT);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < RMS_VMAX; ++k) {
    if (tid + k * NT < nv) {
      float f[VW];
      unpack16<T>(raw[k], f);
#pragma unroll
      for (int i = 0; i < VW; ++i) ss = fmaf(f[i], f[i], ss);
    }
  }
  ss = warp_sum(ss);
  if (tid % 32 == 0) part[tid / 32] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) tot += part[i];  // fixed order
  const float r = rsqrtf(tot / (float)D + eps);
#pragma unroll
  for (int k = 0; k < RMS_VMAX; ++k) {
    const int v = tid + k * NT;
    if (v < nv) {
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
  switch (tile) {
    RMS_TILES(RMS_CASE)
    RMS_VEC_TILES(RMS_VEC_CASE)
    default: break;
  }
#undef RMS_CASE
#undef RMS_VEC_CASE
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
  switch (tile) {
    RMS_TILES(RMS_ATTR)
    RMS_VEC_TILES(RMS_VEC_ATTR)
    default: break;
  }
#undef RMS_ATTR
#undef RMS_VEC_ATTR
  return (int)cudaErrorInvalidValue;
}

// out[0] = rows per block, out[1] = family, out[2] = VMAX (vector rows;
// 0 for warp-per-row rows), out[5] = threads.
int repro_rms_tile_info(int tile, int* out) {
#define RMS_INFO(i, ROWS)                                                   \
  case i: out[0] = ROWS; out[1] = RMS_SIMT; out[2] = out[3] = out[4] = 0;   \
    out[5] = 32 * ROWS; return 0;
#define RMS_VEC_INFO(i, NT)                                                 \
  case i: out[0] = 1; out[1] = RMS_VEC; out[2] = RMS_VMAX;                  \
    out[3] = out[4] = 0; out[5] = NT; return 0;
  switch (tile) {
    RMS_TILES(RMS_INFO)
    RMS_VEC_TILES(RMS_VEC_INFO)
    default: break;
  }
#undef RMS_INFO
#undef RMS_VEC_INFO
  return -1;
}

}  // extern "C"
