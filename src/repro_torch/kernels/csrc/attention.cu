// Causal / bidirectional attention for Hopper: the port of the two
// flash_attention Pallas variants.
//
// Replaces (src/repro/kernels/flash_attention.py):
//   _flash_kernel   -> flash_kernel (SIMT rows), flash_mma_kernel
//                      (tensor-core rows, bf16)          (repro_flash)
//   _blocked_kernel -> blocked_kernel                    (repro_blocked)
//
// Semantics are the Pallas kernels' exactly: q, k, v widened to f32;
// s = (q . k) * scale with scale = 1/sqrt(d); the causal mask is
// top-left aligned (row >= col) with fill -1e30; P.V in f32; the
// denominator is clamped at 1e-30.
//
// The flash table (FLASH_TILES, then FLASH_MMA_TILES, indices running
// on; kernels/flash_attention.py FLASH_TILES on the Python side) holds
// two families; the H100 analysis ranks them with the blocked rows and
// the pick is what launches.
//
// SIMT rows (flash_kernel, f32 and bf16): one block per (b*h, BQ query
// rows).  The Pallas grid's sequential KV axis is a loop over BKV-row
// K/V tiles staged in shared memory; per-row running max m, denominator
// l and the f32 accumulator acc[BQ][d] stay in shared memory.  Logits:
// one thread per (row, col) dot product over d, K rows padded by one
// 32-bit word so a warp's consecutive columns hit distinct banks.
// Softmax update: one warp per row with shuffle reductions.  P.V: one
// thread per (row, feature).  Bound by the FP32 CUDA cores (4 * skv * d
// FLOPs per query row, 67 TFLOP/s) with no overlap of loads and math;
// they stay the route for float32 (full f32 products) and for head
// widths the MMA rows refuse.
//
// Tensor-core rows (flash_mma_kernel, bf16 only; d % 16 == 0, d <= 256):
// FlashAttention-2's shape on mma.sync.m16n8k16 (bf16 in, f32
// accumulate).  Each 16 query rows belong to DS warps, a block of BQ
// rows holds DS * BQ / 16 warps: at the serve shape (b*h = 64, sq = 64)
// BQ = 16 gives 256 blocks, where wgmma's 64-row minimum would give 64
// -- so warp MMAs, not wgmma.  Q is staged once per block and K/V tiles
// of BKV rows go through a two-stage shared-memory ring by 16-byte
// cp.async (one stage when one tile covers skv), the next tile's copy
// issued before this tile's math; rows are padded by 16 bytes so
// ldmatrix's eight row addresses hit distinct bank groups.  S = Q K^T
// stays in registers (Q and K fragments by ldmatrix; each of a group's
// DS warps computes the group's S itself); the online softmax runs on
// the accumulator fragments (row max and sum by shuffles within each
// quad, O rescaled by exp(m_prev - m_new) in registers); P is re-packed
// from S's registers as A fragments and V comes by ldmatrix.trans, so P
// never touches shared memory.  A warp keeps its 1/DS of O (16 x d f32:
// 128 / DS registers a thread at d = 256) in registers; the epilogue
// divides by max(l, 1e-30), stages the group's rows in its own Q rows
// and writes them with 16-byte stores.  Precision: q.k^T of bf16 inputs
// is exact products in f32 sums; the Pallas kernel keeps P in f32, so P
// is split into hi = bf16(P) and lo = bf16(P - hi) and both MMAs go into
// the same accumulator (about 2^-17 relative, where bf16(P) alone would
// be 2^-9).  A group whose rows lie past sq, or (causal) wholly above a
// tile, skips that tile's math.
// What bounds it at the serve shape: neither the 8 MB of q, k, v, o
// (2.5 us at 3.35 TB/s) nor the card's tensor rate, but each warp's own
// chain of dependent ldmatrix and MMA steps (on an H100 SXM at 700 W a
// warp reached about one MMA every 64 cycles): at 4 x 16 x 64 x 256 the
// best row with one warp per 16 rows (DS = 1) took 17 us, with two (DS
// = 2: the QK^T done twice, each warp half of P.V) 12 us, with four 10
// us.  So the table holds DS = 2 and 4 rows, and DS = 1 only in 64-row
// blocks (fewest blocks per head, for long sequences).  Left for
// later: sharing S between a group's warps instead of recomputing it,
// warp specialisation, more than one KV stage in flight.
//
// Under the causal mask, KV tiles wholly above the diagonal are skipped
// by both families -- they would add exp(-1e30 - m) = 0 and rescale by
// exp(0) = 1, so skipping them is exact.
//
// blocked: one block per (b*h, BQ rows) with the whole K and V of that
// head resident in shared memory and one stable softmax pass, as the
// dense Pallas variant; it fits only while 2 * skv * d elements plus the
// (BQ x skv) f32 logits fit the 227 KB a block may opt in to.  FP32
// CUDA cores, as the SIMT flash rows.
#include "common.cuh"
#include "hopper.cuh"

// The flash table: the SIMT rows, then the tensor-core rows, indices
// running on.  kernels/flash_attention.py FLASH_TILES must list the same
// rows in the same order (tests/test_torch_cuda.py checks it).
// SIMT: (index, BQ, BKV, threads).
#define FLASH_TILES(X)           \
  X(0, 16, 32, 128)              \
  X(1, 16, 64, 128)              \
  X(2, 32, 32, 256)              \
  X(3, 32, 64, 256)              \
  X(4, 64, 64, 256)

// Tensor-core, bf16: (index, BQ, BKV, warps, DS) -- DS warps share
// each 16 query rows, each taking 1/DS of the features: warps =
// DS * BQ / 16.
#define FLASH_MMA_TILES(X)       \
  X(5, 64, 32, 4, 1)             \
  X(6, 64, 64, 4, 1)             \
  X(7, 16, 32, 2, 2)             \
  X(8, 16, 64, 2, 2)             \
  X(9, 32, 64, 4, 2)             \
  X(10, 64, 64, 8, 2)            \
  X(11, 16, 64, 4, 4)            \
  X(12, 32, 64, 8, 4)

enum FlashFamily { FLASH_SIMT = 0, FLASH_MMA = 1 };
// widest head the MMA rows take (O's registers are sized for it), and
// the bf16 elements each shared-memory row is padded by (16 bytes)
constexpr int MMA_DMAX = 256;
constexpr int MMA_PAD = 8;

// (index, BQ, threads) -- must match flash_attention.py BLOCKED_TILES.
#define BLOCKED_TILES(X)         \
  X(0, 8, 128)                   \
  X(1, 16, 128)                  \
  X(2, 32, 256)                  \
  X(3, 64, 256)

// K rows are padded by one 32-bit word (bank-conflict-free logits).
template <typename T> __host__ __device__ constexpr int kpad() {
  return 4 / (int)sizeof(T);
}

template <typename T, int BQ, int BKV>
static int flash_smem_bytes(int D) {
  return 4 * (2 * BQ * D + BQ * BKV + 3 * BQ)
      + (int)sizeof(T) * (BKV * (D + kpad<T>()) + BKV * D);
}

// Q tile, then one or two stages of (K tile, V tile), rows padded.
static int flash_mma_smem_bytes(int BQ, int BKV, int SKV, int D) {
  const int stages = SKV > BKV ? 2 : 1;
  return 2 * (D + MMA_PAD) * (BQ + stages * 2 * BKV);
}

template <typename T, int BQ>
static int blocked_smem_bytes(int SKV, int D) {
  return 4 * (BQ * D + BQ * SKV + BQ)
      + (int)sizeof(T) * (SKV * (D + kpad<T>()) + SKV * D);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int BQ, int BKV, int NT>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
             const T* __restrict__ V, T* __restrict__ O, int SQ, int SKV,
             int D, int causal, float scale) {
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDK = D + kpad<T>();
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][D]
  float* acc = Qs + BQ * D;                         // [BQ][D]
  float* S = acc + BQ * D;                          // [BQ][BKV]
  float* m = S + BQ * BKV;                          // [BQ]
  float* l = m + BQ;                                // [BQ]
  float* al = l + BQ;                               // [BQ]
  T* Ks = reinterpret_cast<T*>(al + BQ);            // [BKV][LDK]
  T* Vs = Ks + BKV * LDK;                           // [BKV][D]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const size_t g = blockIdx.y;
  const T* Qg = Q + g * SQ * D;
  const T* Kg = K + g * SKV * D;
  const T* Vg = V + g * SKV * D;
  T* Og = O + g * SQ * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    Qs[e] = q0 + r < SQ ? to_f(Qg[(size_t)(q0 + r) * D + c]) : 0.f;
    acc[e] = 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m[r] = -1e30f;
    l[r] = 0.f;
  }
  int n_kv = (SKV + BKV - 1) / BKV;
  if (causal) {
    // tiles starting past the block's last row are fully masked
    const int last_row = min(q0 + BQ, SQ) - 1;
    n_kv = min(n_kv, last_row / BKV + 1);
  }
  __syncthreads();

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BKV;
    const int kn = min(BKV, SKV - k0);
    for (int e = tid; e < BKV * D; e += NT) {
      const int r = e / D, c = e % D;
      const bool ok = r < kn;
      Ks[r * LDK + c] = ok ? Kg[(size_t)(k0 + r) * D + c] : from_f<T>(0.f);
      Vs[e] = ok ? Vg[(size_t)(k0 + r) * D + c] : from_f<T>(0.f);
    }
    __syncthreads();
    for (int e = tid; e < BQ * BKV; e += NT) {
      const int i = e / BKV, j = e % BKV;
      const float* qi = Qs + i * D;
      const T* kj = Ks + j * LDK;
      float s = 0.f;
      for (int c = 0; c < D; ++c) s = fmaf(qi[c], to_f(kj[c]), s);
      s *= scale;
      if (causal && q0 + i < k0 + j) s = -1e30f;
      S[e] = s;
    }
    __syncthreads();
    for (int i = warp; i < BQ; i += NW) {
      float* si = S + i * BKV;
      float mc = -INFINITY;
      for (int j = lane; j < kn; j += 32) mc = fmaxf(mc, si[j]);
      mc = warp_max(mc);
      const float mp = m[i];
      const float mn = fmaxf(mp, mc);
      float sum = 0.f;
      for (int j = lane; j < BKV; j += 32) {
        const float p = j < kn ? expf(si[j] - mn) : 0.f;
        si[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(mp - mn);
        al[i] = a;
        l[i] = l[i] * a + sum;
        m[i] = mn;
      }
    }
    __syncthreads();
    for (int e = tid; e < BQ * D; e += NT) {
      const int i = e / D, c = e % D;
      const float* pi = S + i * BKV;
      float o = 0.f;
      for (int j = 0; j < kn; ++j) o = fmaf(pi[j], to_f(Vs[j * D + c]), o);
      acc[e] = acc[e] * al[i] + o;
    }
    __syncthreads();
  }
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D;
    if (q0 + r < SQ)
      Og[(size_t)(q0 + r) * D + e % D] = from_f<T>(acc[e] / fmaxf(l[r], 1e-30f));
  }
}

template <int BQ, int BKV, int NW, int DS>
__global__ void __launch_bounds__(32 * NW, 1)
flash_mma_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                 const bf16* __restrict__ V, bf16* __restrict__ O, int SQ,
                 int SKV, int D, int causal, float scale) {
  static_assert(BQ * DS == 16 * NW, "DS warps per 16 query rows");
  static_assert(BKV % 16 == 0, "KV tiles of whole 16-row MMA steps");
  constexpr int NT = 32 * NW;
  constexpr int NS = BKV / 8;          // S fragments (8 columns) a warp
  constexpr int NP = MMA_DMAX / 16 / DS;  // 16-feature O steps a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = D + MMA_PAD;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* KVs = Qs + BQ * LD;                       // stages x (K, V) [BKV][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q4 = lane & 3;
  // warp w: 16-row group w / DS; of the features, the 16-wide steps
  // dh, dh + DS, ... with dh = w % DS (each warp of a group computes
  // the group's S itself)
  const int rg = warp / DS, dh = warp % DS;
  const int q0 = blockIdx.x * BQ;
  const int wq0 = q0 + 16 * rg;         // the warp's first query row
  const size_t bh = blockIdx.y;
  const bf16* Qg = Q + bh * SQ * D;
  const bf16* Kg = K + bh * SKV * D;
  const bf16* Vg = V + bh * SKV * D;
  bf16* Og = O + bh * SQ * D;
  const int chunks = D / 8;             // 16-byte chunks of a row
  const int nd16 = D / 16;

  int n_kv = (SKV + BKV - 1) / BKV;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, SQ) - 1) / BKV + 1);

  // Q, then each K/V tile (one cp.async group), rows past sq or skv as
  // zeros
  for (int e = tid; e < BQ * chunks; e += NT) {
    const int r = e / chunks, c = e % chunks;
    const bool ok = q0 + r < SQ;
    cp_async16(smem_u32(Qs + r * LD + 8 * c),
               Qg + (ok ? (size_t)(q0 + r) * D + 8 * c : 0), ok ? 16 : 0);
  }
  auto stage = [&](int t) { return KVs + (t & 1) * 2 * BKV * LD; };
  auto load_kv = [&](int t) {
    bf16* Ks = stage(t);
    bf16* Vs = Ks + BKV * LD;
    const int k0 = t * BKV;
    for (int e = tid; e < BKV * chunks; e += NT) {
      const int r = e / chunks, c = e % chunks;
      const bool ok = k0 + r < SKV;
      const size_t off = ok ? (size_t)(k0 + r) * D + 8 * c : 0;
      cp_async16(smem_u32(Ks + r * LD + 8 * c), Kg + off, ok ? 16 : 0);
      cp_async16(smem_u32(Vs + r * LD + 8 * c), Vg + off, ok ? 16 : 0);
    }
  };
  load_kv(0);
  cp_async_commit();

  float o[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};
  const int lrow = lane & 7, mi = lane >> 3;

  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {                 // next tile in flight first
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BKV;
    const bf16* Ks = stage(t);
    const bf16* Vs = Ks + BKV * LD;
    if (wq0 < SQ && (!causal || wq0 + 15 >= k0)) {
      // S = Q K^T: 16 x BKV f32 in registers
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int kk = 0; kk < nd16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(Qs + (16 * rg + (lane & 15)) * LD
                                + 16 * kk + 8 * (lane >> 4)));
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_u32(Ks + (16 * jp + lrow + 8 * (mi >> 1)) * LD
                                  + 16 * kk + 8 * (mi & 1)));
          mma_bf16_16816(s[2 * jp], a, b[0], b[1]);
          mma_bf16_16816(s[2 * jp + 1], a, b[2], b[3]);
        }
      }
      // scale and mask; this thread's rows are g and g + 8
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * q4 + (e & 1);
          const int row = wq0 + g + 8 * (e >> 1);
          float v = s[j][e] * scale;
          if (col >= SKV) v = -INFINITY;        // past skv: weight 0
          else if (causal && row < col) v = -1e30f;
          s[j][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mn = fmaxf(m_r[h], mx[h]);
        alpha[h] = expf(m_r[h] - mn);
        m_r[h] = mn;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m_r[e >> 1]);
          s[j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l_r[h] = l_r[h] * alpha[h] + sum[h];
      }
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }
      // O += P V, P = hi + lo from S's registers, V by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16x2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16x2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int dp = dh + DS * i;   // this warp's 16-feature step
          if (dp < nd16) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, smem_u32(
                Vs + (16 * kk + lrow + 8 * (mi & 1)) * LD + 16 * dp
                + 8 * (mi >> 1)));
            mma_bf16_16816(o[2 * i], hi, b[0], b[1]);
            mma_bf16_16816(o[2 * i], lo, b[0], b[1]);
            mma_bf16_16816(o[2 * i + 1], hi, b[2], b[3]);
            mma_bf16_16816(o[2 * i + 1], lo, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();                    // the stage is free to refill
  }
  // epilogue: the group's 16 rows through its own Q rows (every warp is
  // past its last read of Q), 16-byte stores
  bf16* Os = Qs + 16 * rg * LD;
  if (wq0 < SQ) {
    const float d0 = fmaxf(l_r[0], 1e-30f), d1 = fmaxf(l_r[1], 1e-30f);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int dp = dh + DS * i;
      if (dp < nd16) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * dp + 8 * h + 2 * q4;
          *reinterpret_cast<__nv_bfloat162*>(Os + g * LD + c) =
              __floats2bfloat162_rn(o[2 * i + h][0] / d0,
                                    o[2 * i + h][1] / d0);
          *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * LD + c) =
              __floats2bfloat162_rn(o[2 * i + h][2] / d1,
                                    o[2 * i + h][3] / d1);
        }
      }
    }
  }
  if (DS > 1) __syncthreads();          // a group's warps share its rows
  else __syncwarp();
  if (wq0 >= SQ) return;
  for (int r = dh; r < 16 && wq0 + r < SQ; r += DS)
    for (int c = lane; c < chunks; c += 32)
      *reinterpret_cast<uint4*>(Og + (size_t)(wq0 + r) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + 8 * c);
}

template <typename T, int BQ, int NT>
__global__ void __launch_bounds__(NT)
blocked_kernel(const T* __restrict__ Q, const T* __restrict__ K,
               const T* __restrict__ V, T* __restrict__ O, int SQ, int SKV,
               int D, int causal, float scale) {
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDK = D + kpad<T>();
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][D]
  float* S = Qs + BQ * D;                           // [BQ][SKV]
  float* den = S + BQ * SKV;                        // [BQ]
  T* Ks = reinterpret_cast<T*>(den + BQ);           // [SKV][LDK]
  T* Vs = Ks + SKV * LDK;                           // [SKV][D]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const size_t g = blockIdx.y;
  const T* Qg = Q + g * SQ * D;
  const T* Kg = K + g * SKV * D;
  const T* Vg = V + g * SKV * D;
  T* Og = O + g * SQ * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    Qs[e] = q0 + r < SQ ? to_f(Qg[(size_t)(q0 + r) * D + c]) : 0.f;
  }
  for (int e = tid; e < SKV * D; e += NT) {
    const int r = e / D, c = e % D;
    Ks[r * LDK + c] = Kg[e];
    Vs[e] = Vg[e];
  }
  __syncthreads();
  for (int e = tid; e < BQ * SKV; e += NT) {
    const int i = e / SKV, j = e % SKV;
    const float* qi = Qs + i * D;
    const T* kj = Ks + j * LDK;
    float s = 0.f;
    for (int c = 0; c < D; ++c) s = fmaf(qi[c], to_f(kj[c]), s);
    s *= scale;
    if (causal && q0 + i < j) s = -1e30f;
    S[e] = s;
  }
  __syncthreads();
  for (int i = warp; i < BQ; i += NW) {
    float* si = S + i * SKV;
    float mx = -INFINITY;
    for (int j = lane; j < SKV; j += 32) mx = fmaxf(mx, si[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < SKV; j += 32) {
      const float p = expf(si[j] - mx);
      si[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) den[i] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < BQ * D; e += NT) {
    const int i = e / D, c = e % D;
    if (q0 + i >= SQ) continue;
    const float* pi = S + i * SKV;
    float o = 0.f;
    for (int j = 0; j < SKV; ++j) o = fmaf(pi[j], to_f(Vs[j * D + c]), o);
    Og[(size_t)(q0 + i) * D + c] = from_f<T>(o / den[i]);
  }
}

template <typename T, int BQ, int BKV, int NT>
static int launch_flash(const void* q, const void* k, const void* v, void* o,
                        int BH, int SQ, int SKV, int D, int causal,
                        float scale, cudaStream_t s) {
  static int configured = 0;
  const int smem = flash_smem_bytes<T, BQ, BKV>(D);
  cudaError_t e = allow_smem(flash_kernel<T, BQ, BKV, NT>, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((SQ + BQ - 1) / BQ, BH);
  flash_kernel<T, BQ, BKV, NT><<<grid, NT, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, SQ, SKV, D, causal, scale);
  return (int)cudaGetLastError();
}

template <int BQ, int BKV, int NW, int DS>
static int launch_flash_mma(const void* q, const void* k, const void* v,
                            void* o, int BH, int SQ, int SKV, int D,
                            int causal, float scale, cudaStream_t s) {
  static int configured = 0;
  if (D % 16 != 0 || D > MMA_DMAX) return (int)cudaErrorInvalidValue;
  const int smem = flash_mma_smem_bytes(BQ, BKV, SKV, D);
  cudaError_t e = allow_smem(flash_mma_kernel<BQ, BKV, NW, DS>, smem,
                             &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((SQ + BQ - 1) / BQ, BH);
  flash_mma_kernel<BQ, BKV, NW, DS><<<grid, 32 * NW, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, SQ, SKV, D,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int BQ, int NT>
static int launch_blocked(const void* q, const void* k, const void* v,
                          void* o, int BH, int SQ, int SKV, int D,
                          int causal, float scale, cudaStream_t s) {
  static int configured = 0;
  const int smem = blocked_smem_bytes<T, BQ>(SKV, D);
  cudaError_t e = allow_smem(blocked_kernel<T, BQ, NT>, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((SQ + BQ - 1) / BQ, BH);
  blocked_kernel<T, BQ, NT><<<grid, NT, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, SQ, SKV, D, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" {

// q (BH x SQ x D), k/v (BH x SKV x D) -> o (BH x SQ x D), contiguous.
int repro_flash(int tile, int dtype, int causal, const void* q,
                const void* k, const void* v, void* o, int BH, int SQ,
                int SKV, int D, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(i, BQ, BKV, NT)                                             \
  case i:                                                                      \
    return dtype == 0                                                          \
        ? launch_flash<float, BQ, BKV, NT>(q, k, v, o, BH, SQ, SKV, D, causal, scale, s) \
        : launch_flash<bf16, BQ, BKV, NT>(q, k, v, o, BH, SQ, SKV, D, causal, scale, s);
#define FLASH_MMA_CASE(i, BQ, BKV, NW, DS)                                     \
  case i:                                                                      \
    return dtype == 1                                                          \
        ? launch_flash_mma<BQ, BKV, NW, DS>(q, k, v, o, BH, SQ, SKV, D, causal, scale, s) \
        : (int)cudaErrorInvalidValue;
  switch (tile) {
    FLASH_TILES(FLASH_CASE)
    FLASH_MMA_TILES(FLASH_MMA_CASE)
    default: break;
  }
#undef FLASH_CASE
#undef FLASH_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

int repro_blocked(int tile, int dtype, int causal, const void* q,
                  const void* k, const void* v, void* o, int BH, int SQ,
                  int SKV, int D, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define BLOCKED_CASE(i, BQ, NT)                                                \
  case i:                                                                      \
    return dtype == 0                                                          \
        ? launch_blocked<float, BQ, NT>(q, k, v, o, BH, SQ, SKV, D, causal, scale, s) \
        : launch_blocked<bf16, BQ, NT>(q, k, v, o, BH, SQ, SKV, D, causal, scale, s);
  switch (tile) { BLOCKED_TILES(BLOCKED_CASE) default: break; }
#undef BLOCKED_CASE
  return (int)cudaErrorInvalidValue;
}

int repro_attn_attrs(int kind, int tile, int dtype, int* regs, int* smem,
                     int* max_threads) {
#define FLASH_ATTR(i, BQ, BKV, NT)                                              \
  case i:                                                                       \
    return dtype == 0                                                           \
        ? kernel_attrs(flash_kernel<float, BQ, BKV, NT>, regs, smem, max_threads) \
        : kernel_attrs(flash_kernel<bf16, BQ, BKV, NT>, regs, smem, max_threads);
#define BLOCKED_ATTR(i, BQ, NT)                                                 \
  case i:                                                                       \
    return dtype == 0                                                           \
        ? kernel_attrs(blocked_kernel<float, BQ, NT>, regs, smem, max_threads)   \
        : kernel_attrs(blocked_kernel<bf16, BQ, NT>, regs, smem, max_threads);
#define FLASH_MMA_ATTR(i, BQ, BKV, NW, DS)                                      \
  case i:                                                                       \
    return dtype == 1                                                           \
        ? kernel_attrs(flash_mma_kernel<BQ, BKV, NW, DS>, regs, smem, max_threads) \
        : (int)cudaErrorInvalidValue;
  if (kind == KIND_FLASH) {
    switch (tile) {
      FLASH_TILES(FLASH_ATTR)
      FLASH_MMA_TILES(FLASH_MMA_ATTR)
      default: break;
    }
  } else if (kind == KIND_BLOCKED) {
    switch (tile) { BLOCKED_TILES(BLOCKED_ATTR) default: break; }
  }
#undef FLASH_ATTR
#undef FLASH_MMA_ATTR
#undef BLOCKED_ATTR
  return (int)cudaErrorInvalidValue;
}

// flash: out = BQ, BKV, 0, 0, 0, threads, family; blocked: BQ, 0, 0, 0,
// 0, threads, 0.
int repro_attn_tile_info(int kind, int tile, int* out) {
#define FLASH_INFO(i, BQ, BKV, NT)                                              \
  case i: out[0] = BQ; out[1] = BKV; out[2] = out[3] = out[4] = 0;              \
    out[5] = NT; out[6] = FLASH_SIMT; return 0;
#define FLASH_MMA_INFO(i, BQ, BKV, NW, DS)                                      \
  case i: out[0] = BQ; out[1] = BKV; out[2] = out[3] = out[4] = 0;              \
    out[5] = 32 * NW; out[6] = FLASH_MMA; return 0;
#define BLOCKED_INFO(i, BQ, NT)                                                 \
  case i: out[0] = BQ; out[1] = out[2] = out[3] = out[4] = 0; out[5] = NT;      \
    out[6] = 0; return 0;
  if (kind == KIND_FLASH) {
    switch (tile) {
      FLASH_TILES(FLASH_INFO)
      FLASH_MMA_TILES(FLASH_MMA_INFO)
      default: break;
    }
  } else if (kind == KIND_BLOCKED) {
    switch (tile) { BLOCKED_TILES(BLOCKED_INFO) default: break; }
  }
#undef FLASH_INFO
#undef FLASH_MMA_INFO
#undef BLOCKED_INFO
  return -1;
}

}  // extern "C"
