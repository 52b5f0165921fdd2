// 7-point 3-D Jacobi sweep for Hopper: the port of the paper's ex14FJ
// Pallas kernel.
//
// Replaces src/repro/kernels/jacobi3d.py:_jacobi_kernel with two
// families of one table (JACOBI_TILES, then JACOBI_RING_TILES, indices
// running on; kernels/jacobi3d.py JACOBI_TILES on the Python side),
// ranked together by the H100 analysis.
//
// out = c0 * u + c1 * (the 6 face neighbours) in f32 on the interior;
// every cell on a face of the volume passes through unchanged; the
// result is stored in the input type.
//
// What bounds it on the H100: bytes — u read once and out written once
// (2 * Z * Y * X * bytes: 134 MB at 256^3 f32, 0.040 ms at 3.35 TB/s);
// 8 FLOPs per point are far below the FP32 rate.  Reaching the bytes
// rate takes ~64 KB in flight per SM (Little's law at the loaded
// latency, HopperSpec.latency_bytes).
//
// Plane rows (jacobi_kernel, any shape).  A block of BX x BY threads
// owns a (y, x) tile and marches along z over ZB planes (the TPU
// kernel's bz-plane blocks with clamped halo planes become this march).
// Each thread keeps the planes below, at and above its cell in
// registers, so the z-neighbours are read once; the current plane is
// staged with a one-cell halo in shared memory, from which the four
// in-plane neighbours are read.  Each plane comes through the memory
// system twice (the scalar load of "above", then the halo fill behind
// two block barriers), with one plane in flight a block.  They stay the
// route for X that is not a whole number of 16-byte rows.
//
// Ring rows (jacobi_ring_kernel; X a multiple of 16 / elem_bytes).  A
// block owns a (BY x BX) output tile over ZB planes and keeps a ring of
// S input planes in shared memory, each staged once: a TMA 3-D box of
// (BY + 2) rows x (BX plus a 16-byte halo each side) at signed
// coordinates, zeros outside the volume, completing on the stage's
// mbarrier.  One thread issues the loads.  A thread computes 16 /
// elem_bytes consecutive x points and carries its points of planes z - 1
// and z in registers from the planes before, so output plane z reads
// the ring's planes z (the y and x neighbours: two 16-byte loads and two
// scalars) and z + 1 (one 16-byte load); it stores its points as one
// 16-byte vector.  Per plane a thread waits once on the next plane's
// barrier, and one block barrier releases the slot of plane z for the
// load S planes ahead, so S - 1 planes are in flight while the block
// waits.  Each block reads one plane below and one above its ZB planes
// (clamped into the volume at its ends: a clamped plane only feeds
// boundary cells) and the halo columns and rows from L2.
#include "common.cuh"
#include "hopper.cuh"

// Plane rows: (index, BX, BY, ZB) -- threads = BX * BY.  Must match
// repro_torch/kernels/jacobi3d.py JACOBI_TILES.
#define JACOBI_TILES(X)                                                    \
  X(0, 32, 1, 32) X(1, 32, 2, 32) X(2, 32, 4, 16) X(3, 32, 8, 16)          \
  X(4, 64, 4, 16) X(5, 32, 16, 16) X(6, 64, 8, 16) X(7, 32, 32, 16)        \
  X(8, 64, 16, 16) X(9, 32, 8, 64)

// Ring rows: (index, BX, BY, ZB, S) -- BX in elements, threads = BX /
// (16 / elem_bytes) * BY, S stages.  Where the analysis ties them (the
// same planes read and enough bytes in flight), the first wins: the
// longest TMA rows first.
#define JACOBI_RING_TILES(X)                                               \
  X(10, 128, 8, 32, 6) X(11, 64, 8, 32, 8) X(12, 128, 8, 16, 4)            \
  X(13, 64, 8, 16, 4) X(14, 64, 16, 16, 4) X(15, 128, 16, 16, 4)

enum JacobiFamily { JACOBI_PLANE = 0, JACOBI_RING = 1 };

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

// One ring stage: a TMA box of ROWS rows of W elements, 128-byte
// aligned; the thread layout over the output tile.
template <typename T, int BX, int BY>
struct RingLayout {
  static constexpr int VW = VecWidth<T>::value;   // 16 bytes: the halo
  static constexpr int W = BX + 2 * VW;           // staged row, elements
  static constexpr int ROWS = BY + 2;
  static constexpr int BOX = W * ROWS * (int)sizeof(T);
  static constexpr int STAGE = (BOX + 127) / 128 * 128;
  static constexpr int TX = BX / VW;              // threads across x
  static constexpr int THREADS = TX * BY;
  static_assert(BX % VW == 0 && W <= 256, "a TMA box row is <= 256");
};

template <typename T, int BX, int BY, int ZB, int S>
__global__ void __launch_bounds__(RingLayout<T, BX, BY>::THREADS)
jacobi_ring_kernel(const __grid_constant__ CUtensorMap map,
                   T* __restrict__ out, int Z, int Y, int X, float c0,
                   float c1) {
  using L = RingLayout<T, BX, BY>;
  constexpr int VW = L::VW;
  static_assert(S >= 3, "planes z and z + 1 are staged, more in flight");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + S * L::STAGE;      // S mbarriers
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int z0 = blockIdx.z * ZB;
  const int nz = min(ZB, Z - z0);
  const int nin = nz + 2;          // planes z0 - 1 .. z0 + nz of u
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // plane j of the block is u's plane z0 - 1 + j, clamped into the
  // volume (a clamped plane feeds only boundary cells)
  const CUtensorMap* tmap = &map;
  auto issue = [=](int j) {
    const uint32_t bar = full + 8 * (j % S);
    mbar_expect_tx(bar, L::BOX);
    tma_load_3d(ring + (j % S) * L::STAGE, tmap, bar, x0 - VW, y0 - 1,
                min(max(z0 - 1 + j, 0), Z - 1));
  };
  if (threadIdx.x == 0)
    for (int j = 0; j < min(S, nin); ++j) issue(j);
  const int gx = x0 + tx * VW, gy = y0 + ty;
  const bool live = gx < X && gy < Y;    // X % VW == 0: whole vectors
  const int c = (ty + 1) * L::W + VW + tx * VW;   // first point's cell
  auto stage = [&](int j) {
    return reinterpret_cast<const T*>(smem + (j % S) * L::STAGE);
  };
  // the thread's points in planes z - 1 and z, carried in registers
  float zm[VW], cen[VW];
  mbar_wait(full, 0);
  mbar_wait(full + 8, 0);
  unpack16<T>(*reinterpret_cast<const uint4*>(stage(0) + c), zm);
  unpack16<T>(*reinterpret_cast<const uint4*>(stage(1) + c), cen);
  for (int k = 0; k < nz; ++k) {
    mbar_wait(full + 8 * ((k + 2) % S), ((k + 2) / S) & 1);
    const T* mid = stage(k + 1);
    float zp[VW], ym[VW], yp[VW], r[VW];
    unpack16<T>(*reinterpret_cast<const uint4*>(stage(k + 2) + c), zp);
    if (live) {
      unpack16<T>(*reinterpret_cast<const uint4*>(mid + c - L::W), ym);
      unpack16<T>(*reinterpret_cast<const uint4*>(mid + c + L::W), yp);
      const float left = to_f(mid[c - 1]), right = to_f(mid[c + VW]);
      const int z = z0 + k;
      const bool zy = z > 0 && z < Z - 1 && gy > 0 && gy < Y - 1;
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        const float xm = i == 0 ? left : cen[i - 1];
        const float xp = i == VW - 1 ? right : cen[i + 1];
        // the oracle's order: z-1, z+1, y-1, y+1, x-1, x+1; c1 * s
        // rounded before the sum, as the plain version rounds it
        const float s = zm[i] + zp[i] + ym[i] + yp[i] + xm + xp;
        r[i] = zy && gx + i > 0 && gx + i < X - 1
            ? __fmaf_rn(c0, cen[i], __fmul_rn(c1, s)) : cen[i];
      }
      *reinterpret_cast<uint4*>(out + ((size_t)z * Y + gy) * X + gx) =
          pack16<T>(r);
    }
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      zm[i] = cen[i];
      cen[i] = zp[i];
    }
    // planes up to k + 1 are read for the last time: their slots take
    // the planes S ahead
    __syncthreads();
    if (threadIdx.x == 0) {
      if (k == 0 && S < nin) issue(S);
      if (k + 1 + S < nin) issue(k + 1 + S);
    }
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

// u (Z x Y x X) as a rank-3 tensor map of (BY + 2) x W x 1 boxes; zeros
// outside the volume.
template <typename T, int BX, int BY>
static int encode_volume(CUtensorMap* map, const void* u, int Z, int Y,
                         int X) {
  using L = RingLayout<T, BX, BY>;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)X, (cuuint64_t)Y, (cuuint64_t)Z};
  const cuuint64_t strides[2] = {(cuuint64_t)X * sizeof(T),
                                 (cuuint64_t)X * Y * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)L::W, (cuuint32_t)L::ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        3, const_cast<void*>(u), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int BX, int BY, int ZB, int S>
static int launch_jacobi_ring(const void* u, void* o, int Z, int Y, int X,
                              float c0, float c1, cudaStream_t s) {
  using L = RingLayout<T, BX, BY>;
  static int configured = 0;
  constexpr int smem = S * L::STAGE + 8 * S;
  if (X % L::VW != 0 || !aligned16(u) || !aligned16(o) ||
      (Z + ZB - 1) / ZB > 65535 || (Y + BY - 1) / BY > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int e = encode_volume<T, BX, BY>(&map, u, Z, Y, X);
  if (e) return e;
  cudaError_t a = allow_smem(jacobi_ring_kernel<T, BX, BY, ZB, S>, smem,
                             &configured);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((X + BX - 1) / BX, (Y + BY - 1) / BY, (Z + ZB - 1) / ZB);
  jacobi_ring_kernel<T, BX, BY, ZB, S><<<grid, L::THREADS, smem, s>>>(
      map, (T*)o, Z, Y, X, c0, c1);
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
#define JAC_RING_CASE(i, BX, BY, ZB, S)                                      \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? launch_jacobi_ring<float, BX, BY, ZB, S>(u, o, Z, Y, X, c0, c1, s) \
        : launch_jacobi_ring<bf16, BX, BY, ZB, S>(u, o, Z, Y, X, c0, c1, s);
  switch (tile) {
    JACOBI_TILES(JAC_CASE)
    JACOBI_RING_TILES(JAC_RING_CASE)
    default: break;
  }
#undef JAC_CASE
#undef JAC_RING_CASE
  return (int)cudaErrorInvalidValue;
}

int repro_jacobi_attrs(int tile, int dtype, int* regs, int* smem,
                       int* max_threads) {
#define JAC_ATTR(i, BX, BY, ZB)                                              \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(jacobi_kernel<float, BX, BY, ZB>, regs, smem, max_threads) \
        : kernel_attrs(jacobi_kernel<bf16, BX, BY, ZB>, regs, smem, max_threads);
#define JAC_RING_ATTR(i, BX, BY, ZB, S)                                      \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(jacobi_ring_kernel<float, BX, BY, ZB, S>, regs, smem, \
                       max_threads)                                          \
        : kernel_attrs(jacobi_ring_kernel<bf16, BX, BY, ZB, S>, regs, smem,  \
                       max_threads);
  switch (tile) {
    JACOBI_TILES(JAC_ATTR)
    JACOBI_RING_TILES(JAC_RING_ATTR)
    default: break;
  }
#undef JAC_ATTR
#undef JAC_RING_ATTR
  return (int)cudaErrorInvalidValue;
}

// out[0..2] = BX, BY, ZB; out[3] = family; out[4] = stages (ring rows;
// 0 for plane rows); out[5] = threads (a ring row's for float32; half
// that for bfloat16, whose 16-byte vectors hold twice the points).
int repro_jacobi_tile_info(int tile, int* out) {
#define JAC_INFO(i, BX, BY, ZB)                                              \
  case i: out[0] = BX; out[1] = BY; out[2] = ZB; out[3] = JACOBI_PLANE;      \
    out[4] = 0; out[5] = BX * BY; return 0;
#define JAC_RING_INFO(i, BX, BY, ZB, S)                                      \
  case i: out[0] = BX; out[1] = BY; out[2] = ZB; out[3] = JACOBI_RING;       \
    out[4] = S; out[5] = RingLayout<float, BX, BY>::THREADS; return 0;
  switch (tile) {
    JACOBI_TILES(JAC_INFO)
    JACOBI_RING_TILES(JAC_RING_INFO)
    default: break;
  }
#undef JAC_INFO
#undef JAC_RING_INFO
  return -1;
}

}  // extern "C"
