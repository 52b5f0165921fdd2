// 5-point 2-D Jacobi sweep for Hopper: the port of the reference's
// stencil2d Pallas kernel (B9), built on its own as an extension
// (`_cuda.load_extension`), not as part of the kernel library.
//
// Replaces src/repro/kernels/stencil2d.py:_stencil_kernel.
//
// out = c0 * u + c1 * (the 4 edge neighbours) in f32 on the interior;
// every cell on the edge of the grid passes through unchanged; the
// result is stored in the input type.
//
// What bounds it on the H100: bytes — u read once and out written once
// (2 * Y * X * bytes: 537 MB at 8192^2 f32, 0.160 ms at 3.35 TB/s);
// 6 FLOPs per point are far below the FP32 rate.
//
// Design.  A block of BX x BY threads owns BX columns; each row of BY
// threads (whole warps, BX is a multiple of 32) marches down its own
// run of R rows (the TPU kernel's `by`-row blocks with clamped halo
// blocks become this march).  Column blocks are the grid's fastest
// dimension, so the blocks resident at one time read whole rows, not
// narrow column strips at the row pitch.  Each thread keeps the rows
// above, at and below its cell in registers, so every row is read once
// by the run;
// the loads of the row after next, and of the next row's lane-edge
// neighbours, are issued before the current row's arithmetic.  West
// and east come from the neighbouring lanes by warp shuffles; lanes 0
// and 31 read the one cell beyond their warp directly (an L1/L2 hit: a
// neighbouring warp reads it as its own).  A run reads one row above
// and two below its R rows: R trades that halo against the number of
// warps in flight.  No shared memory, no barrier.
//
// Left on the table: 16-byte loads along x (one column per thread
// here), and TMA loads of whole row tiles.
#include "common.cuh"

// (index, BX, BY, R) -- threads = BX * BY.  Must match
// repro_torch/kernels/stencil2d.py STENCIL_TILES.
#define STENCIL_TILES(X)                                                   \
  X(0, 32, 1, 16) X(1, 32, 4, 16) X(2, 64, 2, 32) X(3, 128, 1, 64)         \
  X(4, 128, 2, 16) X(5, 256, 1, 32) X(6, 128, 4, 16) X(7, 256, 2, 16)      \
  X(8, 512, 1, 8) X(9, 128, 8, 8) X(10, 32, 32, 4)

template <typename T>
__device__ __forceinline__ float at(const T* __restrict__ u, int y, int x,
                                    int Y, int X) {
  return (y >= 0 && y < Y && x >= 0 && x < X)
      ? to_f(u[(size_t)y * X + x]) : 0.f;
}

template <typename T, int BX, int BY, int R>
__global__ void __launch_bounds__(BX * BY)
stencil_kernel(const T* __restrict__ u, T* __restrict__ out, int Y, int X,
               float c0, float c1) {
  const int tx = threadIdx.x % BX, ty = threadIdx.x / BX;
  const int lane = threadIdx.x & 31;
  const int gx = blockIdx.x * BX + tx;
  const int y0 = (blockIdx.y * BY + ty) * R;
  if (y0 >= Y) return;  // warp-uniform: a warp lies within one ty row
  const int y1 = min(y0 + R, Y);
  // lane 0 needs the cell west of its warp, lane 31 the one east of it
  const int xe = lane == 0 ? gx - 1 : (lane == 31 ? gx + 1 : -1);
  float up = at(u, y0 - 1, gx, Y, X);
  float cur = at(u, y0, gx, Y, X);
  float dn = at(u, y0 + 1, gx, Y, X);
  float edge = at(u, y0, xe, Y, X);
  for (int y = y0; y < y1; ++y) {
    const float dn2 = at(u, y + 2, gx, Y, X);
    const float edge1 = at(u, y + 1, xe, Y, X);
    float west = __shfl_up_sync(0xffffffffu, cur, 1);
    float east = __shfl_down_sync(0xffffffffu, cur, 1);
    if (lane == 0) west = edge;
    if (lane == 31) east = edge;
    if (gx < X) {
      float r = cur;
      if (y > 0 && y < Y - 1 && gx > 0 && gx < X - 1) {
        // the reference's order: ((up + down) + west) + east
        r = c0 * cur + c1 * (((up + dn) + west) + east);
      }
      out[(size_t)y * X + gx] = from_f<T>(r);
    }
    up = cur;
    cur = dn;
    dn = dn2;
    edge = edge1;
  }
}

template <typename T, int BX, int BY, int R>
static int launch_stencil(const void* u, void* o, int Y, int X, float c0,
                          float c1, cudaStream_t s) {
  const dim3 grid((X + BX - 1) / BX, (Y + BY * R - 1) / (BY * R));
  stencil_kernel<T, BX, BY, R><<<grid, BX * BY, 0, s>>>(
      (const T*)u, (T*)o, Y, X, c0, c1);
  return (int)cudaGetLastError();
}

extern "C" {

// One sweep of u (Y x X, contiguous) into o.
int stencil2d_launch(int tile, int dtype, const void* u, void* o, int Y,
                     int X, float c0, float c1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define ST_CASE(i, BX, BY, R)                                                \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? launch_stencil<float, BX, BY, R>(u, o, Y, X, c0, c1, s)            \
        : launch_stencil<bf16, BX, BY, R>(u, o, Y, X, c0, c1, s);
  switch (tile) { STENCIL_TILES(ST_CASE) default: break; }
#undef ST_CASE
  return (int)cudaErrorInvalidValue;
}

// numRegs / static shared bytes / max threads of one instantiation.
int stencil2d_attrs(int tile, int dtype, int* regs, int* smem,
                    int* max_threads) {
#define ST_ATTR(i, BX, BY, R)                                                \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(stencil_kernel<float, BX, BY, R>, regs, smem,         \
                       max_threads)                                          \
        : kernel_attrs(stencil_kernel<bf16, BX, BY, R>, regs, smem,          \
                       max_threads);
  switch (tile) { STENCIL_TILES(ST_ATTR) default: break; }
#undef ST_ATTR
  return (int)cudaErrorInvalidValue;
}

// out[0..2] = BX, BY, R; -1 past the table.
int stencil2d_tile_info(int tile, int* out) {
#define ST_INFO(i, BX, BY, R)                                                \
  case i: out[0] = BX; out[1] = BY; out[2] = R; return 0;
  switch (tile) { STENCIL_TILES(ST_INFO) default: break; }
#undef ST_INFO
  return -1;
}

}  // extern "C"

REPRO_EXPORT_ERROR_STRING
