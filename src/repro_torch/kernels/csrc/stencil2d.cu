// 5-point 2-D Jacobi sweep for Hopper: the port of the reference's
// stencil2d Pallas kernel (B9), built on its own as an extension
// (`_cuda.load_extension`), not as part of the kernel library.
//
// Replaces src/repro/kernels/stencil2d.py:_stencil_kernel with two
// families of one table (STENCIL_TILES, then STENCIL_RING_TILES, indices
// running on; kernels/stencil2d.py STENCIL_TILES on the Python side),
// ranked together by the H100 analysis.
//
// out = c0 * u + c1 * (the 4 edge neighbours) in f32 on the interior;
// every cell on the edge of the grid passes through unchanged; the
// result is stored in the input type.
//
// What bounds it on the H100: bytes — u read once and out written once
// (2 * Y * X * bytes: 537 MB at 8192^2 f32, 0.160 ms at 3.35 TB/s);
// 6 FLOPs per point are far below the FP32 rate.  Reaching the bytes
// rate takes ~64 KB in flight per SM (Little's law at the loaded
// latency, HopperSpec.latency_bytes).
//
// March rows (stencil_kernel, any shape).  A block of BX x BY threads
// owns BX columns; each row of BY threads (whole warps, BX is a
// multiple of 32) marches down its own run of R rows (the TPU kernel's
// `by`-row blocks with clamped halo blocks become this march).  Column
// blocks are the grid's fastest dimension, so the blocks resident at
// one time read whole rows, not narrow column strips at the row pitch.
// Each thread keeps the rows above, at and below its cell in registers,
// so every row is read once by the run; the loads of the row after
// next, and of the next row's lane-edge neighbours, are issued before
// the current row's arithmetic.  West and east come from the
// neighbouring lanes by warp shuffles; lanes 0 and 31 read the one cell
// beyond their warp directly (an L1/L2 hit: a neighbouring warp reads it
// as its own).  A run reads one row above and two below its R rows.  No
// shared memory, no barrier.  A thread loads 2 or 4 bytes at a time and
// waits on the row below its cell with the row after next issued: two
// rows of its elements in flight, a few hundred bytes a block, so the
// march rows are bound by latency, not bytes (bfloat16 took 93 % of
// float32's time for half its bytes).  They stay the route for X that
// is not a whole number of 16-byte rows.
//
// Ring rows (stencil_ring_kernel; X a multiple of 16 / elem_bytes and
// 16-byte-aligned bases).  A block owns BX columns over a run of R rows
// and keeps a ring of S stages in dynamic shared memory.  Stage q is a
// TMA 2-D box of RB rows x (BX plus a 16-byte halo each side) at the
// signed coordinates (x0 - VW, y0 - 1 + q * RB), zeros outside the
// grid, completing on its stage's mbarrier: the stages tile the rows
// y0 - 1 .. y0 + R that the run needs, each staged once (a run at the
// grid's bottom stops at its last row, so no box lies wholly outside).
// One thread issues the loads.  A block has BX / VW x RB threads; at
// step j row group ty computes the VW consecutive points of output row
// y0 - 2 + j * RB + ty, whose row below is in stage j and whose centre
// and row above are in stage j or, across the boundary, j - 1: a step
// pins two stages.  A thread reads its three rows as 16-byte shared
// loads and the cells west and east of its vector as two scalars, adds
// in the march rows' order ((up + down) + west) + east, and stores its
// points as one 16-byte vector.  After step j one block barrier
// releases stage j - 1's slot to the load S stages ahead, so S - 1
// stages (4-44 KB a block, by row and type) are in flight while the
// block waits for its next stage: the queue Little's law asks for, in
// place of the march rows' few hundred bytes.
#include "common.cuh"
#include "hopper.cuh"

// March rows: (index, BX, BY, R) -- threads = BX * BY.  Must match
// repro_torch/kernels/stencil2d.py STENCIL_TILES.
#define STENCIL_TILES(X)                                                   \
  X(0, 32, 1, 16) X(1, 32, 4, 16) X(2, 64, 2, 32) X(3, 128, 1, 64)         \
  X(4, 128, 2, 16) X(5, 256, 1, 32) X(6, 128, 4, 16) X(7, 256, 2, 16)      \
  X(8, 512, 1, 8) X(9, 128, 8, 8) X(10, 32, 32, 4)

// Ring rows: (index, BX, RB, R, S) -- BX in elements, RB rows a stage,
// R rows a run (R + 2 a whole number of stages, so a run stages no row
// beyond its two halo rows), S stages; threads = BX / (16 / elem_bytes)
// * RB.  Where the analysis ties them, the first wins: the deeper rings
// first.  Longer runs (R = 254) and eight stages ran slower on the card:
// a block that lives a third of the sweep leaves a tail.
#define STENCIL_RING_TILES(X)                                              \
  X(11, 128, 16, 126, 6) X(12, 128, 8, 62, 6) X(13, 64, 16, 126, 6)        \
  X(14, 64, 8, 62, 4)

enum StencilFamily { STENCIL_MARCH = 0, STENCIL_RING = 1 };

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

// One ring stage: a TMA box of RB rows of W elements, 128-byte aligned;
// the thread layout over a step's RB output rows.
template <typename T, int BX, int RB>
struct StencilRing {
  static constexpr int VW = VecWidth<T>::value;   // 16 bytes: the halo
  static constexpr int W = BX + 2 * VW;           // staged row, elements
  static constexpr int BOX = W * RB * (int)sizeof(T);
  static constexpr int STAGE = (BOX + 127) / 128 * 128;
  static constexpr int TX = BX / VW;              // threads across x
  static constexpr int THREADS = TX * RB;
  static_assert(BX % VW == 0 && W <= 256 && RB <= 256,
                "a TMA box side is <= 256");
  static_assert(RB >= 4, "step 0's row groups reach output row y0");
};

template <typename T, int BX, int RB, int R, int S>
__global__ void __launch_bounds__(StencilRing<T, BX, RB>::THREADS)
stencil_ring_kernel(const __grid_constant__ CUtensorMap map,
                    T* __restrict__ out, int Y, int X, float c0, float c1) {
  using L = StencilRing<T, BX, RB>;
  constexpr int VW = L::VW;
  static_assert(S >= 3, "two stages pinned, one more in flight");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + S * L::STAGE;      // S mbarriers
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * R;
  const int ny = min(R, Y - y0);
  // local row q of the block is u's row y0 - 1 + q; the row below the
  // run is staged only where the grid has it, so no stage lies wholly
  // outside the grid
  const int nin = y0 + ny < Y ? ny + 2 : ny + 1;
  const int nst = (nin + RB - 1) / RB;            // stages loaded
  const int steps = (ny + 1 + RB) / RB;           // cover local rows 1..ny
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const CUtensorMap* tmap = &map;
  auto issue = [=](int q) {
    const uint32_t bar = full + 8 * (q % S);
    mbar_expect_tx(bar, L::BOX);
    tma_load_2d(ring + (q % S) * L::STAGE, tmap, bar, x0 - VW,
                y0 - 1 + q * RB);
  };
  if (threadIdx.x == 0)
    for (int q = 0; q < min(S, nst); ++q) issue(q);
  const int gx = x0 + tx * VW;
  const bool live = gx < X;                // X % VW == 0: whole vectors
  // element offset of local row q's first point of this thread
  auto row = [&](int q) {
    return reinterpret_cast<const T*>(smem + ((q / RB) % S) * L::STAGE) +
           (q % RB) * L::W + VW + tx * VW;
  };
  for (int j = 0; j < steps; ++j) {
    if (j < nst) mbar_wait(full + 8 * (j % S), (j / S) & 1);
    const int i = j * RB - 1 + ty;         // local row of the centre
    if (live && i >= 1 && i <= ny) {
      const int y = y0 - 1 + i;
      const T* cp = row(i);
      float cen[VW], r[VW];
      unpack16<T>(*reinterpret_cast<const uint4*>(cp), cen);
      if (y > 0 && y < Y - 1) {            // rows y - 1 and y + 1 staged
        float up[VW], dn[VW];
        unpack16<T>(*reinterpret_cast<const uint4*>(row(i - 1)), up);
        unpack16<T>(*reinterpret_cast<const uint4*>(row(i + 1)), dn);
        const float left = to_f(cp[-1]), right = to_f(cp[VW]);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float west = e == 0 ? left : cen[e - 1];
          const float east = e == VW - 1 ? right : cen[e + 1];
          // the plain version's roundings: each product, then the sum
          const float s = ((up[e] + dn[e]) + west) + east;
          r[e] = gx + e > 0 && gx + e < X - 1
              ? __fadd_rn(__fmul_rn(c0, cen[e]), __fmul_rn(c1, s)) : cen[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) r[e] = cen[e];
      }
      *reinterpret_cast<uint4*>(out + (size_t)y * X + gx) = pack16<T>(r);
    }
    // stage j - 1 is read for the last time: its slot takes the stage S
    // ahead
    __syncthreads();
    if (threadIdx.x == 0 && j >= 1 && j - 1 + S < nst) issue(j - 1 + S);
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

// u (Y x X) as a rank-2 tensor map of RB x W boxes; zeros outside the
// grid.
template <typename T, int BX, int RB>
static int encode_grid(CUtensorMap* map, const void* u, int Y, int X) {
  using L = StencilRing<T, BX, RB>;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)X, (cuuint64_t)Y};
  const cuuint64_t strides[1] = {(cuuint64_t)X * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)L::W, (cuuint32_t)RB};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(u), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int BX, int RB, int R, int S>
static int launch_stencil_ring(const void* u, void* o, int Y, int X,
                               float c0, float c1, cudaStream_t s) {
  using L = StencilRing<T, BX, RB>;
  static int configured = 0;
  constexpr int smem = S * L::STAGE + 8 * S;
  if (X % L::VW != 0 || !aligned16(u) || !aligned16(o) ||
      (Y + R - 1) / R > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int e = encode_grid<T, BX, RB>(&map, u, Y, X);
  if (e) return e;
  cudaError_t a = allow_smem(stencil_ring_kernel<T, BX, RB, R, S>, smem,
                             &configured);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((X + BX - 1) / BX, (Y + R - 1) / R);
  stencil_ring_kernel<T, BX, RB, R, S><<<grid, L::THREADS, smem, s>>>(
      map, (T*)o, Y, X, c0, c1);
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
#define ST_RING_CASE(i, BX, RB, R, S)                                        \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? launch_stencil_ring<float, BX, RB, R, S>(u, o, Y, X, c0, c1, s)    \
        : launch_stencil_ring<bf16, BX, RB, R, S>(u, o, Y, X, c0, c1, s);
  switch (tile) {
    STENCIL_TILES(ST_CASE)
    STENCIL_RING_TILES(ST_RING_CASE)
    default: break;
  }
#undef ST_CASE
#undef ST_RING_CASE
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
#define ST_RING_ATTR(i, BX, RB, R, S)                                        \
  case i:                                                                    \
    return dtype == 0                                                        \
        ? kernel_attrs(stencil_ring_kernel<float, BX, RB, R, S>, regs, smem, \
                       max_threads)                                          \
        : kernel_attrs(stencil_ring_kernel<bf16, BX, RB, R, S>, regs, smem,  \
                       max_threads);
  switch (tile) {
    STENCIL_TILES(ST_ATTR)
    STENCIL_RING_TILES(ST_RING_ATTR)
    default: break;
  }
#undef ST_ATTR
#undef ST_RING_ATTR
  return (int)cudaErrorInvalidValue;
}

// out[0..2] = BX, BY (march) or RB (ring), R; out[3] = family; out[4] =
// stages (0 for march rows); out[5] = threads (a ring row's for
// float32; half that for bfloat16, whose 16-byte vectors hold twice the
// points); -1 past the table.
int stencil2d_tile_info(int tile, int* out) {
#define ST_INFO(i, BX, BY, R)                                                \
  case i: out[0] = BX; out[1] = BY; out[2] = R; out[3] = STENCIL_MARCH;      \
    out[4] = 0; out[5] = BX * BY; return 0;
#define ST_RING_INFO(i, BX, RB, R, S)                                        \
  case i: out[0] = BX; out[1] = RB; out[2] = R; out[3] = STENCIL_RING;       \
    out[4] = S; out[5] = StencilRing<float, BX, RB>::THREADS; return 0;
  switch (tile) {
    STENCIL_TILES(ST_INFO)
    STENCIL_RING_TILES(ST_RING_INFO)
    default: break;
  }
#undef ST_INFO
#undef ST_RING_INFO
  return -1;
}

}  // extern "C"

REPRO_EXPORT_ERROR_STRING
