// saxpy2d for Hopper: y = 2 * a + b, the bring-your-own-kernel
// example's CUDA body, built on its own by `_cuda.load_extension` from
// repro_torch/examples/custom_kernel.py.
//
// Replaces examples/custom_kernel.py:_saxpy_kernel.
//
// Computed in f32 and rounded once to the input type (for f32,
// 2 * a is exact, so the fused multiply-add equals PyTorch's two
// rounded ops bit for bit).
//
// What bounds it on the H100: bytes — a and b read once, y written once
// (3 * M * N * bytes: 805 MB at 8192^2 f32, 0.240 ms at 3.35 TB/s).
//
// Design.  The operands are contiguous, so the kernel sees one flat
// array: a grid-stride pass in which each of TPB threads loads V
// 16-byte vectors of a and of b (4 f32 or 8 bf16 each; neighbouring
// threads on neighbouring vectors) before it computes any, so 2V loads
// are in flight per thread.  The elements past the last whole vector —
// and every element when a pointer is not 16-byte aligned (a view at an
// odd offset) — take a scalar loop.
#include "common.cuh"

// (index, threads per block TPB, 16-byte vectors per thread V).  Must
// match repro_torch/examples/custom_kernel.py SAXPY_TILES.
#define SAXPY_TILES(X)                                                     \
  X(0, 128, 1) X(1, 256, 1) X(2, 512, 1) X(3, 1024, 1) X(4, 128, 2)        \
  X(5, 256, 2) X(6, 512, 2) X(7, 128, 4) X(8, 256, 4) X(9, 1024, 4)

template <typename T>
__device__ __forceinline__ uint4 saxpy16(uint4 va, uint4 vb) {
  constexpr int W = 16 / sizeof(T);
  const T* pa = reinterpret_cast<const T*>(&va);
  const T* pb = reinterpret_cast<const T*>(&vb);
  uint4 vo;
  T* po = reinterpret_cast<T*>(&vo);
#pragma unroll
  for (int k = 0; k < W; ++k) po[k] = from_f<T>(2.0f * to_f(pa[k]) + to_f(pb[k]));
  return vo;
}

template <typename T, int TPB, int V>
__global__ void __launch_bounds__(TPB)
saxpy_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ o, long long n, long long nvec) {
  constexpr int W = 16 / sizeof(T);
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4* o4 = reinterpret_cast<uint4*>(o);
  const long long stride = (long long)gridDim.x * TPB * V;
  for (long long base = (long long)blockIdx.x * TPB * V + threadIdx.x;
       base < nvec; base += stride) {
    uint4 va[V], vb[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = base + (long long)j * TPB;
      if (i < nvec) {
        va[j] = __ldg(a4 + i);
        vb[j] = __ldg(b4 + i);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = base + (long long)j * TPB;
      if (i < nvec) o4[i] = saxpy16<T>(va[j], vb[j]);
    }
  }
  // the tail past the last whole vector (all of it when nvec == 0)
  for (long long i = nvec * W + (long long)blockIdx.x * TPB + threadIdx.x;
       i < n; i += (long long)gridDim.x * TPB) {
    o[i] = from_f<T>(2.0f * to_f(a[i]) + to_f(b[i]));
  }
}

template <typename T, int TPB, int V>
static int launch_saxpy(const void* a, const void* b, void* o, long long n,
                        cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  const long long nvec =
      (aligned16(a) && aligned16(b) && aligned16(o)) ? n / W : 0;
  const long long work = nvec > 0 ? nvec : n;
  long long blocks = (work + (long long)TPB * V - 1) / ((long long)TPB * V);
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  if (blocks < 1) blocks = 1;
  saxpy_kernel<T, TPB, V><<<(unsigned)blocks, TPB, 0, s>>>(
      (const T*)a, (const T*)b, (T*)o, n, nvec);
  return (int)cudaGetLastError();
}

extern "C" {

// o = 2 * a + b over n contiguous elements.
int saxpy2d_launch(int tile, int dtype, const void* a, const void* b,
                   void* o, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SX_CASE(i, TPB, V)                                                   \
  case i:                                                                    \
    return dtype == 0 ? launch_saxpy<float, TPB, V>(a, b, o, n, s)           \
                      : launch_saxpy<bf16, TPB, V>(a, b, o, n, s);
  switch (tile) { SAXPY_TILES(SX_CASE) default: break; }
#undef SX_CASE
  return (int)cudaErrorInvalidValue;
}

// numRegs / static shared bytes / max threads of one instantiation.
int saxpy2d_attrs(int tile, int dtype, int* regs, int* smem,
                  int* max_threads) {
#define SX_ATTR(i, TPB, V)                                                   \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(saxpy_kernel<float, TPB, V>, regs, smem, max_threads) \
        : kernel_attrs(saxpy_kernel<bf16, TPB, V>, regs, smem, max_threads);
  switch (tile) { SAXPY_TILES(SX_ATTR) default: break; }
#undef SX_ATTR
  return (int)cudaErrorInvalidValue;
}

// out[0..1] = TPB, V; -1 past the table.
int saxpy2d_tile_info(int tile, int* out) {
#define SX_INFO(i, TPB, V)                                                   \
  case i: out[0] = TPB; out[1] = V; return 0;
  switch (tile) { SAXPY_TILES(SX_INFO) default: break; }
#undef SX_INFO
  return -1;
}

}  // extern "C"

REPRO_EXPORT_ERROR_STRING
