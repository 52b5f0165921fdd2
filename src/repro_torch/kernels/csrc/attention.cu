// Causal / bidirectional attention for Hopper: the port of the two
// flash_attention Pallas variants.
//
// Replaces (src/repro/kernels/flash_attention.py):
//   _flash_kernel   -> flash_kernel (SIMT rows), flash_mma_kernel
//                      (tensor-core rows, bf16), flash_tf32_kernel
//                      (tensor-core rows, f32 as 3xTF32) (repro_flash)
//   _blocked_kernel -> blocked_kernel (SIMT rows), blocked_tc_kernel
//                      (tensor-core rows, bf16 and f32) (repro_blocked)
//
// Semantics are the Pallas kernels' exactly: q, k, v widened to f32;
// s = (q . k) * scale with scale = 1/sqrt(d); the causal mask is
// top-left aligned (row >= col) with fill -1e30; P.V in f32; the
// denominator is clamped at 1e-30.
//
// The flash table (FLASH_TILES, FLASH_MMA_TILES, FLASH_TF32_TILES,
// indices running on; kernels/flash_attention.py FLASH_TILES on the
// Python side) holds three families, the blocked table (BLOCKED_TILES,
// BLOCKED_TC_TILES) two; the H100 analysis ranks all of them together
// and the pick is what launches.
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
// they stay the route for head widths the tensor-core rows refuse.
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
// Tensor-core rows in f32 (flash_tf32_kernel; d % 8 == 0, d <= 256):
// the same body (flash_tc) on mma.sync m16n8k8 tf32 in 3xTF32, the MMA
// step of TcStep<float> below: each operand split hi + lo in registers
// as it is loaded (never stored twice in shared memory), three MMAs a
// product, P.V over kv in a permuted order so P stays in S's registers
// and V comes by 32-bit loads (ldmatrix.trans moves 16-bit elements
// only).  About 2^-21 relative, inside the f32 tolerance of 2e-4 where
// plain TF32 (2^-11) is not.  What bounds it is the same warp chain,
// with three m16n8k8 MMAs where bf16 issues one m16n8k16 for Q.K^T (six
// times the MMAs) and three for two in P.V.  With every warp of a group
// computing all of S, Q.K^T was about 4/5 of a warp's MMAs at 4 x 16 x
// 64 x 256 (25.7 us at best on an H100 SXM at 700 W, against SDPA's
// 17.1); so in f32 (TcStep::SHARE_S) the group's DS warps deal S's
// 16-column pairs among themselves and meet in a [BQ][BKV + 8] f32
// tile in shared memory, one __syncthreads a tile, each then reading
// the whole S back into registers for the online softmax and its P.V.
// f32 doubles the shared bytes of a stage, so at d = 256 two stages fit
// only at BKV = 32.
//
// Under the causal mask, KV tiles wholly above the diagonal are skipped
// by every family -- they would add exp(-1e30 - m) = 0 and rescale by
// exp(0) = 1, so skipping them is exact.
//
// blocked: one block per (b*h, BQ rows) with the whole K and V of that
// head resident in shared memory and one stable softmax pass, as the
// dense Pallas variant; it fits only while K, V, Q and the (BQ x skv)
// f32 logits fit the 227 KB a block may opt in to.  SIMT rows
// (blocked_kernel) on the FP32 CUDA cores, as the SIMT flash rows;
// tensor-core rows (blocked_tc_kernel, noted at the kernel) compute S
// and P.V with the same TcStep as the flash rows, bf16 or 3xTF32, and
// keep the logits block in shared memory.  At d = 256 bf16 skv = 64 and
// 128 fit and 256 does not; in f32 skv = 64 fits and 128 does not.
#include "common.cuh"
#include "hopper.cuh"

// The flash table: the SIMT rows, then the bf16 tensor-core rows, then
// the tf32 ones, indices running on.  kernels/flash_attention.py
// FLASH_TILES must list the same rows in the same order
// (tests/test_torch_attn_norm.py and tests/test_torch_cuda.py check it).
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

// Tensor-core, f32 as 3xTF32: the same fields.  At d = 256 one f32
// stage of a 64-row K/V tile is 2 x 64 x 260 x 4 = 133 KB, so BKV = 64
// rows fit only while one tile covers skv (one stage); with two stages
// d = 256 caps BKV at 32.
#define FLASH_TF32_TILES(X)      \
  X(13, 64, 32, 4, 1)            \
  X(14, 16, 32, 2, 2)            \
  X(15, 16, 64, 2, 2)            \
  X(16, 32, 32, 4, 2)            \
  X(17, 16, 32, 4, 4)            \
  X(18, 16, 64, 4, 4)            \
  X(19, 32, 32, 8, 4)            \
  X(20, 32, 64, 8, 4)

enum FlashFamily { FLASH_SIMT = 0, FLASH_MMA = 1, FLASH_TF32 = 2 };
// widest head the tensor-core rows take (O's registers are sized for
// it), and the KV rows of one cp.async group of the blocked rows
constexpr int MMA_DMAX = 256;
constexpr int BLOCKED_KT = 64;

// The blocked table: the SIMT rows, then the tensor-core rows, indices
// running on -- must match flash_attention.py BLOCKED_TILES.
// SIMT: (index, BQ, threads).
#define BLOCKED_TILES(X)         \
  X(0, 8, 128)                   \
  X(1, 16, 128)                  \
  X(2, 32, 256)                  \
  X(3, 64, 256)

// Tensor-core (bf16 m16n8k16, f32 3xTF32): (index, BQ, warps), DS =
// 16 warps / BQ warps per 16 query rows.
#define BLOCKED_TC_TILES(X)      \
  X(4, 16, 2)                    \
  X(5, 16, 4)                    \
  X(6, 32, 4)                    \
  X(7, 32, 8)                    \
  X(8, 64, 4)                    \
  X(9, 64, 8)

enum BlockedFamily { BLOCKED_SIMT = 0, BLOCKED_TC = 1 };

// K rows are padded by one 32-bit word (bank-conflict-free logits).
template <typename T> __host__ __device__ constexpr int kpad() {
  return 4 / (int)sizeof(T);
}

template <typename T, int BQ, int BKV>
static int flash_smem_bytes(int D) {
  return 4 * (2 * BQ * D + BQ * BKV + 3 * BQ)
      + (int)sizeof(T) * (BKV * (D + kpad<T>()) + BKV * D);
}

// Q tile, then one or two stages of (K tile, V tile), rows padded by
// 16 bytes, ``eb`` bytes an element; then, where the group's warps
// share S, the f32 S tile [BQ][BKV + 8].
static int flash_tc_smem_bytes(int eb, int BQ, int BKV, int SKV, int D,
                               bool share_s) {
  const int stages = SKV > BKV ? 2 : 1;
  return eb * (D + 16 / eb) * (BQ + stages * 2 * BKV)
      + (share_s ? 4 * BQ * (BKV + 8) : 0);
}

// Q tile, the whole K and V (skv rounded up to 16 rows), rows padded by
// 16 bytes; the f32 logits block [BQ][skv16 + 8] and the denominators.
static int blocked_tc_smem_bytes(int eb, int BQ, int SKV, int D) {
  const int skvp = (SKV + 15) / 16 * 16;
  return eb * (D + 16 / eb) * (BQ + 2 * skvp) + 4 * (BQ * (skvp + 8) + BQ);
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

// ---------------------------------------------------------------------------
// The warp-level MMA step, by element type: the one piece of tensor-core
// arithmetic the flash rows (bf16 and tf32) and the blocked rows share.
// Q and K fragments come by ldmatrix for both types: a 16-row x 32-byte
// block is a 16 x 16 bf16 or a 16 x 8 f32 A fragment, and an 8 x 8 b16
// matrix is 8 x 4 32-bit words, so the addressing is the same in bytes.
// P arrives as f32 in the accumulator layout (this thread: rows g, g+8,
// columns 2q, 2q+1 of each 8 columns) and is split hi + lo.
// ---------------------------------------------------------------------------
template <typename T> struct TcStep;

// bf16: mma.sync m16n8k16; q.k^T of bf16 inputs is exact products in
// f32 sums, P = hi + lo in two MMAs (about 2^-17 relative).
template <> struct TcStep<bf16> {
  static constexpr int KS = 16;   // features of one Q.K^T step
  static constexpr int PS = 16;   // kv rows of one P.V step
  static constexpr int FS = 16;   // features of one P.V step (2 n8 tiles)
  static constexpr int TAKE = 16; // head widths taken: multiples of this
  // whether the flash rows' DS warps of a group share its S through
  // shared memory (each computing 1/DS of the columns) instead of each
  // computing all of it in registers
  static constexpr bool SHARE_S = false;
  struct A { uint32_t x[4]; };
  __device__ static void load_a(A& a, uint32_t addr) { ldmatrix_x4(a.x, addr); }
  // s0, s1 (kv columns 0-7, 8-15 of a 16-column pair) += A . K^T, the K
  // pair's fragments from ``baddr``
  __device__ static void qk(float* s0, float* s1, const A& a,
                            uint32_t baddr) {
    uint32_t b[4];
    ldmatrix_x4(b, baddr);
    mma_bf16_16816(s0, a.x, b[0], b[1]);
    mma_bf16_16816(s1, a.x, b[2], b[3]);
  }
  // p: 16 x PS of P (two n8 tiles, 8 floats) -> hi, lo A fragments
  __device__ static void split_p(const float* p, uint32_t* hi,
                                 uint32_t* lo) {
    split_bf16x2(p[0], p[1], hi[0], lo[0]);
    split_bf16x2(p[2], p[3], hi[1], lo[1]);
    split_bf16x2(p[4], p[5], hi[2], lo[2]);
    split_bf16x2(p[6], p[7], hi[3], lo[3]);
  }
  // o (FS / 8 n8 tiles) += P . V[kv0 .. +PS][f0 .. +FS], ``v`` at
  // (kv0, f0): V by ldmatrix.trans
  __device__ static void pv(float (*o)[4], const uint32_t* hi,
                            const uint32_t* lo, const bf16* v, int ld,
                            int lane) {
    const int lrow = lane & 7, mi = lane >> 3;
    uint32_t b[4];
    ldmatrix_x4_trans(b, smem_u32(v + (lrow + 8 * (mi & 1)) * ld
                                  + 8 * (mi >> 1)));
    mma_bf16_16816(o[0], hi, b[0], b[1]);
    mma_bf16_16816(o[0], lo, b[0], b[1]);
    mma_bf16_16816(o[1], hi, b[2], b[3]);
    mma_bf16_16816(o[1], lo, b[2], b[3]);
  }
};

// f32: 3xTF32 on mma.sync m16n8k8.  Every operand is split in registers
// as it is loaded (split_tf32) and each product is lo.hi + hi.lo + hi.hi
// into one f32 accumulator (about 2^-21 relative, where plain tf32 is
// 2^-11); the two 8-column tiles of a pair alternate so that no MMA
// waits on the one before it.  P.V runs over kv in the permuted order
// (k slot q <-> column 2q, slot q + 4 <-> column 2q + 1 of each 8), so
// P's A fragment is the accumulator's own registers; V's B fragment is
// then rows 2q and 2q + 1, column g: two 32-bit loads, since
// ldmatrix.trans moves 16-bit elements only.  Rows padded by 4 words
// put rows 2q (q = 0..3) 8 banks apart, so the 32 lanes hit 32 banks.
template <> struct TcStep<float> {
  static constexpr int KS = 8;
  static constexpr int PS = 8;
  static constexpr int FS = 8;
  static constexpr int TAKE = 8;
  static constexpr bool SHARE_S = true;
  struct A { uint32_t hi[4], lo[4]; };
  __device__ static void load_a(A& a, uint32_t addr) {
    uint32_t r[4];
    ldmatrix_x4(r, addr);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), a.hi[i], a.lo[i]);
  }
  __device__ static void qk(float* s0, float* s1, const A& a,
                            uint32_t baddr) {
    uint32_t b[4], bh[4], bl[4];
    ldmatrix_x4(b, baddr);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(b[i]), bh[i], bl[i]);
    mma_tf32_1688(s0, a.lo, bh[0], bh[1]);
    mma_tf32_1688(s1, a.lo, bh[2], bh[3]);
    mma_tf32_1688(s0, a.hi, bl[0], bl[1]);
    mma_tf32_1688(s1, a.hi, bl[2], bl[3]);
    mma_tf32_1688(s0, a.hi, bh[0], bh[1]);
    mma_tf32_1688(s1, a.hi, bh[2], bh[3]);
  }
  // p: 16 x 8 of P (4 floats) -> A fragments in the permuted order
  __device__ static void split_p(const float* p, uint32_t* hi,
                                 uint32_t* lo) {
    split_tf32(p[0], hi[0], lo[0]);
    split_tf32(p[2], hi[1], lo[1]);
    split_tf32(p[1], hi[2], lo[2]);
    split_tf32(p[3], hi[3], lo[3]);
  }
  __device__ static void pv(float (*o)[4], const uint32_t* hi,
                            const uint32_t* lo, const float* v, int ld,
                            int lane) {
    const int g = lane >> 2, q4 = lane & 3;
    uint32_t bh[2], bl[2];
    split_tf32(v[2 * q4 * ld + g], bh[0], bl[0]);
    split_tf32(v[(2 * q4 + 1) * ld + g], bh[1], bl[1]);
    mma_tf32_1688(o[0], lo, bh[0], bh[1]);
    mma_tf32_1688(o[0], hi, bl[0], bl[1]);
    mma_tf32_1688(o[0], hi, bh[0], bh[1]);
  }
};

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// The flash tensor-core rows' body for either element type (the bf16
// flash_mma_kernel and the f32 flash_tf32_kernel below are this body).
template <typename T, int BQ, int BKV, int NW, int DS>
__device__ __forceinline__ void
flash_tc(const T* __restrict__ Q, const T* __restrict__ K,
         const T* __restrict__ V, T* __restrict__ O, int SQ, int SKV, int D,
         int causal, float scale) {
  using M = TcStep<T>;
  static_assert(BQ * DS == 16 * NW, "DS warps per 16 query rows");
  static_assert(BKV % 16 == 0, "KV tiles of whole 16-column pairs");
  constexpr int NT = 32 * NW;
  constexpr int NS = BKV / 8;             // S fragments (8 columns) a warp
  constexpr int NF = M::FS / 8;           // n8 tiles of one P.V step
  constexpr int NP = MMA_DMAX / M::FS / DS;  // P.V feature steps a warp
  constexpr int VE = 16 / (int)sizeof(T);   // elements of 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = D + VE;                  // rows padded by 16 bytes
  constexpr int LDSS = BKV + 8;           // shared S rows (float2 banks)
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* KVs = Qs + BQ * LD;                    // stages x (K, V) [BKV][LD]
  // with M::SHARE_S, the group's S tile after the stages: [BQ][LDSS]
  float* Ss = reinterpret_cast<float*>(KVs + (SKV > BKV ? 2 : 1) * 2 * BKV
                                       * LD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q4 = lane & 3;
  // warp w: 16-row group w / DS; of the features, the FS-wide steps
  // dh, dh + DS, ... with dh = w % DS (each warp of a group computes
  // the group's S itself, or with M::SHARE_S its 1/DS of S's columns)
  const int rg = warp / DS, dh = warp % DS;
  const int q0 = blockIdx.x * BQ;
  const int wq0 = q0 + 16 * rg;         // the warp's first query row
  const size_t bh = blockIdx.y;
  const T* Qg = Q + bh * SQ * D;
  const T* Kg = K + bh * SKV * D;
  const T* Vg = V + bh * SKV * D;
  T* Og = O + bh * SQ * D;
  const int chunks = D / VE;            // 16-byte chunks of a row
  const int nfs = D / M::FS;

  int n_kv = (SKV + BKV - 1) / BKV;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, SQ) - 1) / BKV + 1);

  // Q, then each K/V tile (one cp.async group), rows past sq or skv as
  // zeros
  for (int e = tid; e < BQ * chunks; e += NT) {
    const int r = e / chunks, c = e % chunks;
    const bool ok = q0 + r < SQ;
    cp_async16(smem_u32(Qs + r * LD + VE * c),
               Qg + (ok ? (size_t)(q0 + r) * D + VE * c : 0), ok ? 16 : 0);
  }
  auto stage = [&](int t) { return KVs + (t & 1) * 2 * BKV * LD; };
  auto load_kv = [&](int t) {
    T* Ks = stage(t);
    T* Vs = Ks + BKV * LD;
    const int k0 = t * BKV;
    for (int e = tid; e < BKV * chunks; e += NT) {
      const int r = e / chunks, c = e % chunks;
      const bool ok = k0 + r < SKV;
      const size_t off = ok ? (size_t)(k0 + r) * D + VE * c : 0;
      cp_async16(smem_u32(Ks + r * LD + VE * c), Kg + off, ok ? 16 : 0);
      cp_async16(smem_u32(Vs + r * LD + VE * c), Vg + off, ok ? 16 : 0);
    }
  };
  load_kv(0);
  cp_async_commit();

  float o[NP * NF][4];
#pragma unroll
  for (int n = 0; n < NP * NF; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
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
    const T* Ks = stage(t);
    const T* Vs = Ks + BKV * LD;
    const bool live = wq0 < SQ && (!causal || wq0 + 15 >= k0);
    // S = Q K^T: 16 x BKV f32 in registers
    float s[NS][4];
    if constexpr (M::SHARE_S) {
      // the group's 16-column pairs dealt round robin to its DS warps,
      // through the group's rows of the shared S tile
      constexpr int NPW = (NS / 2 + DS - 1) / DS;
      if (live) {
        float sp[2 * NPW][4];
#pragma unroll
        for (int j = 0; j < 2 * NPW; ++j) sp[j][0] = sp[j][1] = sp[j][2] = sp[j][3] = 0.f;
        for (int kk = 0; kk < D / M::KS; ++kk) {
          typename M::A a;
          M::load_a(a, smem_u32(Qs + (16 * rg + (lane & 15)) * LD
                                + M::KS * kk + (M::KS / 2) * (lane >> 4)));
#pragma unroll
          for (int u = 0; u < NPW; ++u) {
            const int jp = dh + DS * u;
            if (jp < NS / 2)
              M::qk(sp[2 * u], sp[2 * u + 1], a,
                    smem_u32(Ks + (16 * jp + lrow + 8 * (mi >> 1)) * LD
                             + M::KS * kk + (M::KS / 2) * (mi & 1)));
          }
        }
#pragma unroll
        for (int u = 0; u < NPW; ++u) {
          const int jp = dh + DS * u;
          if (jp < NS / 2) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float* r = Ss + (16 * rg + g) * LDSS + 16 * jp + 8 * h + 2 * q4;
              *reinterpret_cast<float2*>(r) =
                  make_float2(sp[2 * u + h][0], sp[2 * u + h][1]);
              *reinterpret_cast<float2*>(r + 8 * LDSS) =
                  make_float2(sp[2 * u + h][2], sp[2 * u + h][3]);
            }
          }
        }
      }
      __syncthreads();
      if (live) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float* r = Ss + (16 * rg + g) * LDSS + 8 * j + 2 * q4;
          const float2 x = *reinterpret_cast<const float2*>(r);
          const float2 y = *reinterpret_cast<const float2*>(r + 8 * LDSS);
          s[j][0] = x.x; s[j][1] = x.y; s[j][2] = y.x; s[j][3] = y.y;
        }
      }
    } else if (live) {
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int kk = 0; kk < D / M::KS; ++kk) {
        typename M::A a;
        M::load_a(a, smem_u32(Qs + (16 * rg + (lane & 15)) * LD
                              + M::KS * kk + (M::KS / 2) * (lane >> 4)));
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp)
          M::qk(s[2 * jp], s[2 * jp + 1], a,
                smem_u32(Ks + (16 * jp + lrow + 8 * (mi >> 1)) * LD
                         + M::KS * kk + (M::KS / 2) * (mi & 1)));
      }
    }
    if (live) {
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
      for (int n = 0; n < NP * NF; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }
      // O += P V, P = hi + lo from S's registers
#pragma unroll
      for (int kk = 0; kk < BKV / M::PS; ++kk) {
        uint32_t hi[4], lo[4];
        M::split_p(&s[(M::PS / 8) * kk][0], hi, lo);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int dp = dh + DS * i;   // this warp's feature step
          if (dp < nfs)
            M::pv(o + NF * i, hi, lo, Vs + M::PS * kk * LD + M::FS * dp, LD,
                  lane);
        }
      }
    }
    __syncthreads();                    // the stage is free to refill
  }
  // epilogue: the group's 16 rows through its own Q rows (every warp is
  // past its last read of Q), 16-byte stores
  T* Os = Qs + 16 * rg * LD;
  if (wq0 < SQ) {
    const float d0 = fmaxf(l_r[0], 1e-30f), d1 = fmaxf(l_r[1], 1e-30f);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int dp = dh + DS * i;
      if (dp < nfs) {
#pragma unroll
        for (int h = 0; h < NF; ++h) {
          const int c = M::FS * dp + 8 * h + 2 * q4;
          store2(Os + g * LD + c, o[NF * i + h][0] / d0,
                 o[NF * i + h][1] / d0);
          store2(Os + (g + 8) * LD + c, o[NF * i + h][2] / d1,
                 o[NF * i + h][3] / d1);
        }
      }
    }
  }
  if (DS > 1) __syncthreads();          // a group's warps share its rows
  else __syncwarp();
  if (wq0 >= SQ) return;
  for (int r = dh; r < 16 && wq0 + r < SQ; r += DS)
    for (int c = lane; c < chunks; c += 32)
      *reinterpret_cast<uint4*>(Og + (size_t)(wq0 + r) * D + VE * c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + VE * c);
}

template <int BQ, int BKV, int NW, int DS>
__global__ void __launch_bounds__(32 * NW, 1)
flash_mma_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                 const bf16* __restrict__ V, bf16* __restrict__ O, int SQ,
                 int SKV, int D, int causal, float scale) {
  flash_tc<bf16, BQ, BKV, NW, DS>(Q, K, V, O, SQ, SKV, D, causal, scale);
}

template <int BQ, int BKV, int NW, int DS>
__global__ void __launch_bounds__(32 * NW, 1)
flash_tf32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                  const float* __restrict__ V, float* __restrict__ O, int SQ,
                  int SKV, int D, int causal, float scale) {
  flash_tc<float, BQ, BKV, NW, DS>(Q, K, V, O, SQ, SKV, D, causal, scale);
}

// The blocked tensor-core rows: one block per (b*h, BQ query rows) with
// the whole K and V of the head (up to the block's last row, causal)
// resident in shared memory, DS = 16 NW / BQ warps per 16 query rows.
// K arrives by 16-byte cp.async in groups of KT rows, V as one last
// group, so the first tile's S starts while the rest is in flight.  S =
// Q K^T runs by MMA, the group's 16-column pairs dealt round robin to
// its DS warps, into an f32 logits block [BQ][LDS] in shared memory
// (the Pallas scratch; LDS = skv rounded to 16, plus 8 words, so the
// float2 stores and loads of a fragment's rows hit distinct banks).
// Then one stable pass a row: the max over the row's unmasked columns,
// exp, the sum clamped at 1e-30; masked columns (col > row) and columns
// past skv become P = 0, which is exp(-1e30 - max) exactly.  P.V runs by
// MMA with each warp on its 1/DS of the features, P re-read from the
// block and split hi + lo.  A group skips the KV columns wholly above
// its last row.
template <typename T, int BQ, int NW>
__global__ void __launch_bounds__(32 * NW, 1)
blocked_tc_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                  const T* __restrict__ V, T* __restrict__ O, int SQ,
                  int SKV, int D, int causal, float scale) {
  using M = TcStep<T>;
  constexpr int DS = 16 * NW / BQ;
  static_assert(DS * BQ == 16 * NW && DS >= 1 && DS <= 4,
                "1, 2 or 4 warps per 16 query rows");
  constexpr int NT = 32 * NW;
  constexpr int NPW = BLOCKED_KT / 16 / DS;  // S pairs a warp, per group
  constexpr int NF = M::FS / 8;
  constexpr int NP = MMA_DMAX / M::FS / DS;
  constexpr int VE = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = D + VE;
  const int SKVP = (SKV + 15) / 16 * 16;
  const int LDS = SKVP + 8;
  T* Qs = reinterpret_cast<T*>(smem_raw);          // [BQ][LD]
  T* Ks = Qs + BQ * LD;                             // [SKVP][LD]
  T* Vs = Ks + SKVP * LD;                           // [SKVP][LD]
  float* S = reinterpret_cast<float*>(Vs + SKVP * LD);  // [BQ][LDS]
  float* den = S + BQ * LDS;                        // [BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q4 = lane & 3;
  const int rg = warp / DS, dh = warp % DS;
  const int q0 = blockIdx.x * BQ;
  const int wq0 = q0 + 16 * rg;
  const size_t bh = blockIdx.y;
  const T* Qg = Q + bh * SQ * D;
  const T* Kg = K + bh * SKV * D;
  const T* Vg = V + bh * SKV * D;
  T* Og = O + bh * SQ * D;
  const int chunks = D / VE;
  const int nfs = D / M::FS;
  // the KV rows the block reads, and the group's own
  const int kv_end = causal ? min(SKVP, (min(q0 + BQ, SQ) + 15) / 16 * 16)
                            : SKVP;
  const int kv_g = causal ? min(SKVP, wq0 + 16) : SKVP;
  const int nk = (kv_end + BLOCKED_KT - 1) / BLOCKED_KT;

  for (int e = tid; e < BQ * chunks; e += NT) {
    const int r = e / chunks, c = e % chunks;
    const bool ok = q0 + r < SQ;
    cp_async16(smem_u32(Qs + r * LD + VE * c),
               Qg + (ok ? (size_t)(q0 + r) * D + VE * c : 0), ok ? 16 : 0);
  }
  auto load_rows = [&](T* dst, const T* src, int r0, int r1) {
    for (int e = tid; e < (r1 - r0) * chunks; e += NT) {
      const int r = r0 + e / chunks, c = e % chunks;
      const bool ok = r < SKV;
      cp_async16(smem_u32(dst + r * LD + VE * c),
                 src + (ok ? (size_t)r * D + VE * c : 0), ok ? 16 : 0);
    }
  };
  for (int t = 0; t < nk; ++t) {        // group t: K rows of tile t (+ Q)
    load_rows(Ks, Kg, t * BLOCKED_KT, min(kv_end, (t + 1) * BLOCKED_KT));
    cp_async_commit();
  }
  load_rows(Vs, Vg, 0, kv_end);         // the last group: V
  cp_async_commit();

  const int lrow = lane & 7, mi = lane >> 3;
  for (int t = 0; t < nk; ++t) {
    cp_async_wait_upto(nk - t);         // K tile t has landed
    __syncthreads();
    const int p0 = t * (BLOCKED_KT / 16) + dh;  // this warp's first pair
    if (wq0 < SQ && 16 * p0 < kv_g) {
      float s[2 * NPW][4];
#pragma unroll
      for (int j = 0; j < 2 * NPW; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int kk = 0; kk < D / M::KS; ++kk) {
        typename M::A a;
        M::load_a(a, smem_u32(Qs + (16 * rg + (lane & 15)) * LD
                              + M::KS * kk + (M::KS / 2) * (lane >> 4)));
#pragma unroll
        for (int u = 0; u < NPW; ++u) {
          const int jp = p0 + DS * u;
          if (16 * jp < kv_g)
            M::qk(s[2 * u], s[2 * u + 1], a,
                  smem_u32(Ks + (16 * jp + lrow + 8 * (mi >> 1)) * LD
                           + M::KS * kk + (M::KS / 2) * (mi & 1)));
        }
      }
#pragma unroll
      for (int u = 0; u < NPW; ++u) {
        const int jp = p0 + DS * u;
        if (16 * jp < kv_g) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* row = S + (16 * rg + g) * LDS + 16 * jp + 8 * h + 2 * q4;
            *reinterpret_cast<float2*>(row) =
                make_float2(s[2 * u + h][0] * scale, s[2 * u + h][1] * scale);
            *reinterpret_cast<float2*>(row + 8 * LDS) =
                make_float2(s[2 * u + h][2] * scale, s[2 * u + h][3] * scale);
          }
        }
      }
    }
  }
  cp_async_wait<0>();                   // V
  __syncthreads();
  // one stable softmax pass a row, a warp a row
  for (int i = warp; i < BQ; i += NW) {
    const int row = q0 + i;
    if (row >= SQ) break;
    const int ncol = causal ? min(SKV, row + 1) : SKV;
    const int ext = causal ? min(SKVP, (row | 15) + 1) : SKVP;
    float* si = S + i * LDS;
    float mx = -INFINITY;
    for (int j = lane; j < ncol; j += 32) mx = fmaxf(mx, si[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < ext; j += 32) {
      const float p = j < ncol ? expf(si[j] - mx) : 0.f;
      si[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) den[i] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  T* Os = Qs + 16 * rg * LD;            // Q is no longer read
  if (wq0 < SQ) {
    float o[NP * NF][4];
#pragma unroll
    for (int n = 0; n < NP * NF; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    const float* s0 = S + (16 * rg + g) * LDS + 2 * q4;
    for (int kv0 = 0; kv0 < kv_g; kv0 += M::PS) {
      float p[M::PS / 2];
#pragma unroll
      for (int n = 0; n < M::PS / 8; ++n) {
        const float2 a = *reinterpret_cast<const float2*>(s0 + kv0 + 8 * n);
        const float2 b = *reinterpret_cast<const float2*>(s0 + 8 * LDS + kv0
                                                          + 8 * n);
        p[4 * n] = a.x; p[4 * n + 1] = a.y;
        p[4 * n + 2] = b.x; p[4 * n + 3] = b.y;
      }
      uint32_t hi[4], lo[4];
      M::split_p(p, hi, lo);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int dp = dh + DS * i;
        if (dp < nfs)
          M::pv(o + NF * i, hi, lo, Vs + kv0 * LD + M::FS * dp, LD, lane);
      }
    }
    const float d0 = den[16 * rg + g], d1 = den[16 * rg + g + 8];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int dp = dh + DS * i;
      if (dp < nfs) {
#pragma unroll
        for (int h = 0; h < NF; ++h) {
          const int c = M::FS * dp + 8 * h + 2 * q4;
          store2(Os + g * LD + c, o[NF * i + h][0] / d0,
                 o[NF * i + h][1] / d0);
          store2(Os + (g + 8) * LD + c, o[NF * i + h][2] / d1,
                 o[NF * i + h][3] / d1);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < BQ * chunks; e += NT) {
    const int r = e / chunks, c = e % chunks;
    if (q0 + r < SQ)
      *reinterpret_cast<uint4*>(Og + (size_t)(q0 + r) * D + VE * c) =
          *reinterpret_cast<const uint4*>(Qs + r * LD + VE * c);
  }
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

// The tensor-core rows take a head of whole MMA steps up to MMA_DMAX
// (the wrappers refuse the rest before launch).
template <typename T>
static bool tc_takes(int D) {
  return D % TcStep<T>::TAKE == 0 && D <= MMA_DMAX;
}

// The flash tensor-core kernel of an element type.
template <int BQ, int BKV, int NW, int DS>
static auto flash_tc_kernel(bf16*) { return flash_mma_kernel<BQ, BKV, NW, DS>; }
template <int BQ, int BKV, int NW, int DS>
static auto flash_tc_kernel(float*) { return flash_tf32_kernel<BQ, BKV, NW, DS>; }

template <typename T, int BQ, int BKV, int NW, int DS>
static int launch_flash_tc(const void* q, const void* k, const void* v,
                           void* o, int BH, int SQ, int SKV, int D,
                           int causal, float scale, cudaStream_t s) {
  static int configured = 0;
  if (!tc_takes<T>(D)) return (int)cudaErrorInvalidValue;
  const auto kernel = flash_tc_kernel<BQ, BKV, NW, DS>((T*)nullptr);
  const int smem = flash_tc_smem_bytes(sizeof(T), BQ, BKV, SKV, D,
                                       TcStep<T>::SHARE_S);
  cudaError_t e = allow_smem(kernel, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((SQ + BQ - 1) / BQ, BH);
  kernel<<<grid, 32 * NW, smem, s>>>((const T*)q, (const T*)k, (const T*)v,
                                     (T*)o, SQ, SKV, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int BQ, int NW>
static int launch_blocked_tc(const void* q, const void* k, const void* v,
                             void* o, int BH, int SQ, int SKV, int D,
                             int causal, float scale, cudaStream_t s) {
  static int configured = 0;
  if (!tc_takes<T>(D)) return (int)cudaErrorInvalidValue;
  const int smem = blocked_tc_smem_bytes(sizeof(T), BQ, SKV, D);
  cudaError_t e = allow_smem(blocked_tc_kernel<T, BQ, NW>, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((SQ + BQ - 1) / BQ, BH);
  blocked_tc_kernel<T, BQ, NW><<<grid, 32 * NW, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, SQ, SKV, D, causal, scale);
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
        ? launch_flash_tc<bf16, BQ, BKV, NW, DS>(q, k, v, o, BH, SQ, SKV, D, causal, scale, s) \
        : (int)cudaErrorInvalidValue;
#define FLASH_TF32_CASE(i, BQ, BKV, NW, DS)                                    \
  case i:                                                                      \
    return dtype == 0                                                          \
        ? launch_flash_tc<float, BQ, BKV, NW, DS>(q, k, v, o, BH, SQ, SKV, D, causal, scale, s) \
        : (int)cudaErrorInvalidValue;
  switch (tile) {
    FLASH_TILES(FLASH_CASE)
    FLASH_MMA_TILES(FLASH_MMA_CASE)
    FLASH_TF32_TILES(FLASH_TF32_CASE)
    default: break;
  }
#undef FLASH_CASE
#undef FLASH_MMA_CASE
#undef FLASH_TF32_CASE
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
#define BLOCKED_TC_CASE(i, BQ, NW)                                             \
  case i:                                                                      \
    return dtype == 0                                                          \
        ? launch_blocked_tc<float, BQ, NW>(q, k, v, o, BH, SQ, SKV, D, causal, scale, s) \
        : launch_blocked_tc<bf16, BQ, NW>(q, k, v, o, BH, SQ, SKV, D, causal, scale, s);
  switch (tile) {
    BLOCKED_TILES(BLOCKED_CASE)
    BLOCKED_TC_TILES(BLOCKED_TC_CASE)
    default: break;
  }
#undef BLOCKED_CASE
#undef BLOCKED_TC_CASE
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
#define BLOCKED_TC_ATTR(i, BQ, NW)                                              \
  case i:                                                                       \
    return dtype == 0                                                           \
        ? kernel_attrs(blocked_tc_kernel<float, BQ, NW>, regs, smem, max_threads) \
        : kernel_attrs(blocked_tc_kernel<bf16, BQ, NW>, regs, smem, max_threads);
#define FLASH_MMA_ATTR(i, BQ, BKV, NW, DS)                                      \
  case i:                                                                       \
    return dtype == 1                                                           \
        ? kernel_attrs(flash_mma_kernel<BQ, BKV, NW, DS>, regs, smem, max_threads) \
        : (int)cudaErrorInvalidValue;
#define FLASH_TF32_ATTR(i, BQ, BKV, NW, DS)                                     \
  case i:                                                                       \
    return dtype == 0                                                           \
        ? kernel_attrs(flash_tf32_kernel<BQ, BKV, NW, DS>, regs, smem, max_threads) \
        : (int)cudaErrorInvalidValue;
  if (kind == KIND_FLASH) {
    switch (tile) {
      FLASH_TILES(FLASH_ATTR)
      FLASH_MMA_TILES(FLASH_MMA_ATTR)
      FLASH_TF32_TILES(FLASH_TF32_ATTR)
      default: break;
    }
  } else if (kind == KIND_BLOCKED) {
    switch (tile) {
      BLOCKED_TILES(BLOCKED_ATTR)
      BLOCKED_TC_TILES(BLOCKED_TC_ATTR)
      default: break;
    }
  }
#undef FLASH_ATTR
#undef FLASH_MMA_ATTR
#undef FLASH_TF32_ATTR
#undef BLOCKED_ATTR
#undef BLOCKED_TC_ATTR
  return (int)cudaErrorInvalidValue;
}

// flash: out = BQ, BKV, 0, 0, 0, threads, family; blocked: BQ, 0, 0, 0,
// 0, threads, family.
int repro_attn_tile_info(int kind, int tile, int* out) {
#define FLASH_INFO(i, BQ, BKV, NT)                                              \
  case i: out[0] = BQ; out[1] = BKV; out[2] = out[3] = out[4] = 0;              \
    out[5] = NT; out[6] = FLASH_SIMT; return 0;
#define FLASH_MMA_INFO(i, BQ, BKV, NW, DS)                                      \
  case i: out[0] = BQ; out[1] = BKV; out[2] = out[3] = out[4] = 0;              \
    out[5] = 32 * NW; out[6] = FLASH_MMA; return 0;
#define FLASH_TF32_INFO(i, BQ, BKV, NW, DS)                                     \
  case i: out[0] = BQ; out[1] = BKV; out[2] = out[3] = out[4] = 0;              \
    out[5] = 32 * NW; out[6] = FLASH_TF32; return 0;
#define BLOCKED_INFO(i, BQ, NT)                                                 \
  case i: out[0] = BQ; out[1] = out[2] = out[3] = out[4] = 0; out[5] = NT;      \
    out[6] = BLOCKED_SIMT; return 0;
#define BLOCKED_TC_INFO(i, BQ, NW)                                              \
  case i: out[0] = BQ; out[1] = out[2] = out[3] = out[4] = 0;                   \
    out[5] = 32 * NW; out[6] = BLOCKED_TC; return 0;
  if (kind == KIND_FLASH) {
    switch (tile) {
      FLASH_TILES(FLASH_INFO)
      FLASH_MMA_TILES(FLASH_MMA_INFO)
      FLASH_TF32_TILES(FLASH_TF32_INFO)
      default: break;
    }
  } else if (kind == KIND_BLOCKED) {
    switch (tile) {
      BLOCKED_TILES(BLOCKED_INFO)
      BLOCKED_TC_TILES(BLOCKED_TC_INFO)
      default: break;
    }
  }
#undef FLASH_INFO
#undef FLASH_MMA_INFO
#undef FLASH_TF32_INFO
#undef BLOCKED_INFO
#undef BLOCKED_TC_INFO
  return -1;
}

}  // extern "C"
