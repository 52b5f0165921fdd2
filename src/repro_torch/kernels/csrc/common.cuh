// Shared device helpers for the port's Hopper kernels.
//
// Every kernel computes in f32 whatever the element type (float or
// bf16), converts on load and rounds to nearest even on store — the
// float discipline of the Pallas kernels they replace.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Ints one repro_tile_info call may write (the GEMM table's rows are the
// widest: BM, BN, BK, TM, TN, threads, family, stages, split); callers
// pass a buffer of this many.
#define REPRO_TILE_INFO_INTS 9

// Kernel kinds of the C interface (repro_kernel_attrs / repro_tile_*).
enum ReproKind {
  KIND_GEMM = 0, KIND_GATED = 1, KIND_STREAM = 2, KIND_RMS = 3,
  KIND_FLASH = 4, KIND_BLOCKED = 5, KIND_MATVEC = 6, KIND_ATAX = 7,
  KIND_BICG = 8, KIND_JACOBI = 9
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Gate activations of the gated MLP, in f32: 0 silu, 1 gelu (tanh
// approximation, as jax.nn.gelu(approximate=True)), 2 relu.
__device__ __forceinline__ float apply_act(float x, int act) {
  if (act == 0) return x / (1.0f + expf(-x));
  if (act == 1) {
    const float k = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
  }
  return fmaxf(x, 0.0f);
}

// Opt in to more than 48 KB of dynamic shared memory, once per kernel.
template <typename K>
static cudaError_t allow_smem(K kernel, int bytes, int* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *configured = bytes;
  // the caller returns e: clear it from the runtime's last error, or the
  // next launch checked anywhere in the process (the libraries share
  // one runtime) would report it as its own
  else cudaGetLastError();
  return e;
}

// Registers, static shared bytes and max threads of one compiled kernel.
template <typename K>
static int kernel_attrs(K kernel, int* regs, int* smem, int* max_threads) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *smem = (int)a.sharedSizeBytes;
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

// 16-byte loads through the read-only path: VecWidth<T>::value elements
// of T per load, widened to f32.  The pointer must be 16-byte aligned.
template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int value = 4; };
template <> struct VecWidth<bf16> { static constexpr int value = 8; };

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out);
template <>
__device__ __forceinline__ void load16<float>(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load16<bf16>(const bf16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
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

// Sum over the 32 lanes of a warp (fixed butterfly order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The C interface's error string.  Every shared library the port builds
// (the kernel library and each extension of `_cuda.load_extension`)
// exports it once, so a wrapper can name the error its own library's
// launch returned.
#define REPRO_EXPORT_ERROR_STRING                                           \
  extern "C" const char* repro_error_string(int err) {                      \
    return cudaGetErrorString((cudaError_t)err);                            \
  }
