// RMSNorm for Hopper: the port of the rms_norm Pallas kernel.
//
// Replaces src/repro/kernels/rms_norm.py:_rms_kernel.
//
// Design.  One warp per row, ROWS rows (warps) per block: each lane
// sums x^2 in f32 over a strided slice of the row, a butterfly of warp
// shuffles completes the sum, and the lanes write
// x * rsqrt(mean(x^2) + eps) * w in the input type.  No shared memory,
// no block-wide barrier.  The weight arrives as f32 (the model keeps
// norm gains in f32 and the wrapper widens any other type).
//
// What bounds it on the H100: bytes — one read and one write of x
// (2 * M * D elements) at 3.35 TB/s; the arithmetic (4 FLOPs and part
// of one rsqrt per element) is far below the FP32 rate.  Left on the
// table: 16-byte vector loads and keeping the row in registers between
// the two passes (the second pass re-reads x, from L1/L2 at these row
// lengths).
#include "common.cuh"

// (index, ROWS) -- threads = 32 * ROWS.  Must match
// repro_torch/kernels/rms_norm.py RMS_TILES.
#define RMS_TILES(X) X(0, 1) X(1, 2) X(2, 4) X(3, 8) X(4, 16)

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

template <typename T, int ROWS>
static int launch_rms(const void* x, const void* w, void* y, int M, int D,
                      float eps, cudaStream_t s) {
  const int grid = (M + ROWS - 1) / ROWS;
  rms_kernel<T, ROWS><<<grid, 32 * ROWS, 0, s>>>(
      (const T*)x, (const float*)w, (T*)y, M, D, eps);
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
  switch (tile) { RMS_TILES(RMS_CASE) default: break; }
#undef RMS_CASE
  return (int)cudaErrorInvalidValue;
}

int repro_rms_attrs(int tile, int dtype, int* regs, int* smem,
                    int* max_threads) {
#define RMS_ATTR(i, ROWS)                                                   \
  case i:                                                                   \
    return dtype == 0                                                       \
        ? kernel_attrs(rms_kernel<float, ROWS>, regs, smem, max_threads)    \
        : kernel_attrs(rms_kernel<bf16, ROWS>, regs, smem, max_threads);
  switch (tile) { RMS_TILES(RMS_ATTR) default: break; }
#undef RMS_ATTR
  return (int)cudaErrorInvalidValue;
}

// out[0] = ROWS, out[5] = threads.
int repro_rms_tile_info(int tile, int* out) {
#define RMS_INFO(i, ROWS)                                                   \
  case i: out[0] = ROWS; out[1] = out[2] = out[3] = out[4] = 0;             \
    out[5] = 32 * ROWS; return 0;
  switch (tile) { RMS_TILES(RMS_INFO) default: break; }
#undef RMS_INFO
  return -1;
}

}  // extern "C"
