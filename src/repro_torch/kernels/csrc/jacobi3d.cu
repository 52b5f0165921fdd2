// 7-point 3-D Jacobi sweep for Hopper: the port of the paper's ex14FJ
// Pallas kernel.
//
// Replaces src/repro/kernels/jacobi3d.py:_jacobi_kernel.
//
// out = c0 * u + c1 * (the 6 face neighbours) in f32 on the interior;
// every cell on a face of the volume passes through unchanged; the
// result is stored in the input type.
//
// What bounds it on the H100: bytes — u read once and out written once
// (2 * Z * Y * X * bytes: 134 MB at 256^3 f32, 0.040 ms at 3.35 TB/s);
// 8 FLOPs per point are far below the FP32 rate.
//
// Design.  A block of BX x BY threads owns a (y, x) tile and marches
// along z over ZB planes (the TPU kernel's bz-plane blocks with clamped
// halo planes become this march).  Each thread keeps the planes below,
// at and above its cell in registers, so the z-neighbours are read
// once; the current plane is staged with a one-cell halo in shared
// memory, from which the four in-plane neighbours are read.  The halo
// cells and the staged centre come from L1/L2 (a neighbour tile, or the
// register load of the previous step, read them from device memory).
// Each block reads one plane below and one above its ZB planes: ZB
// trades that halo against the number of blocks.
//
// Left on the table: 16-byte loads along x, and TMA/cp.async loads of
// the next plane overlapping the current plane's arithmetic.
#include "common.cuh"

// (index, BX, BY, ZB) -- threads = BX * BY.  Must match
// repro_torch/kernels/jacobi3d.py JACOBI_TILES.
#define JACOBI_TILES(X)                                                    \
  X(0, 32, 1, 32) X(1, 32, 2, 32) X(2, 32, 4, 16) X(3, 32, 8, 16)          \
  X(4, 64, 4, 16) X(5, 32, 16, 16) X(6, 64, 8, 16) X(7, 32, 32, 16)        \
  X(8, 64, 16, 16) X(9, 32, 8, 64)

template <typename T, int BX, int BY, int ZB>
__global__ void __launch_bounds__(BX * BY)
jacobi_kernel(const T* __restrict__ u, T* __restrict__ out, int Z, int Y,
              int X, float c0, float c1) {
  __shared__ float tile[BY + 2][BX + 2];
  const int tx = threadIdx.x % BX, ty = threadIdx.x / BX;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int gx = x0 + tx, gy = y0 + ty;
  const int z0 = blockIdx.z * ZB;
  const int z1 = min(z0 + ZB, Z);
  const bool in = gx < X && gy < Y;
  const size_t plane = (size_t)Y * X;
  const size_t idx = (size_t)gy * X + gx;
  float below = 0.f, center = 0.f, above = 0.f;
  if (in) {
    if (z0 > 0) below = to_f(u[(size_t)(z0 - 1) * plane + idx]);
    center = to_f(u[(size_t)z0 * plane + idx]);
  }
  for (int z = z0; z < z1; ++z) {
    if (in && z + 1 < Z) above = to_f(u[(size_t)(z + 1) * plane + idx]);
    __syncthreads();  // the previous plane's reads of `tile` are done
    for (int e = threadIdx.x; e < (BY + 2) * (BX + 2); e += BX * BY) {
      const int ly = e / (BX + 2), lx = e % (BX + 2);
      const int yy = y0 + ly - 1, xx = x0 + lx - 1;
      tile[ly][lx] = (yy >= 0 && yy < Y && xx >= 0 && xx < X)
          ? to_f(u[(size_t)z * plane + (size_t)yy * X + xx]) : 0.f;
    }
    __syncthreads();
    if (in) {
      const bool interior = z > 0 && z < Z - 1 && gy > 0 && gy < Y - 1 &&
                            gx > 0 && gx < X - 1;
      float r = center;
      if (interior) {
        // the oracle's order: z-1, z+1, y-1, y+1, x-1, x+1
        const float s = below + above + tile[ty][tx + 1] +
                        tile[ty + 2][tx + 1] + tile[ty + 1][tx] +
                        tile[ty + 1][tx + 2];
        r = c0 * center + c1 * s;
      }
      out[(size_t)z * plane + idx] = from_f<T>(r);
    }
    below = center;
    center = above;
  }
}

template <typename T, int BX, int BY, int ZB>
static int launch_jacobi(const void* u, void* o, int Z, int Y, int X,
                         float c0, float c1, cudaStream_t s) {
  const dim3 grid((X + BX - 1) / BX, (Y + BY - 1) / BY, (Z + ZB - 1) / ZB);
  jacobi_kernel<T, BX, BY, ZB><<<grid, BX * BY, 0, s>>>(
      (const T*)u, (T*)o, Z, Y, X, c0, c1);
  return (int)cudaGetLastError();
}

extern "C" {

// One Jacobi sweep of u (Z x Y x X, contiguous) into o.
int repro_jacobi3d(int tile, int dtype, const void* u, void* o, int Z, int Y,
                   int X, float c0, float c1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define JAC_CASE(i, BX, BY, ZB)                                              \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? launch_jacobi<float, BX, BY, ZB>(u, o, Z, Y, X, c0, c1, s)         \
        : launch_jacobi<bf16, BX, BY, ZB>(u, o, Z, Y, X, c0, c1, s);
  switch (tile) { JACOBI_TILES(JAC_CASE) default: break; }
#undef JAC_CASE
  return (int)cudaErrorInvalidValue;
}

int repro_jacobi_attrs(int tile, int dtype, int* regs, int* smem,
                       int* max_threads) {
#define JAC_ATTR(i, BX, BY, ZB)                                              \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(jacobi_kernel<float, BX, BY, ZB>, regs, smem, max_threads) \
        : kernel_attrs(jacobi_kernel<bf16, BX, BY, ZB>, regs, smem, max_threads);
  switch (tile) { JACOBI_TILES(JAC_ATTR) default: break; }
#undef JAC_ATTR
  return (int)cudaErrorInvalidValue;
}

// out[0..2] = BX, BY, ZB; out[5] = threads.
int repro_jacobi_tile_info(int tile, int* out) {
#define JAC_INFO(i, BX, BY, ZB)                                              \
  case i: out[0] = BX; out[1] = BY; out[2] = ZB; out[3] = out[4] = 0;        \
    out[5] = BX * BY; return 0;
  switch (tile) { JACOBI_TILES(JAC_INFO) default: break; }
#undef JAC_INFO
  return -1;
}

}  // extern "C"
