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

// Kernel kinds of the C interface (repro_kernel_attrs / repro_tile_*).
enum ReproKind {
  KIND_GEMM = 0, KIND_GATED = 1, KIND_STREAM = 2, KIND_RMS = 3,
  KIND_FLASH = 4, KIND_BLOCKED = 5
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
