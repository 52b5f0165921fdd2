// Causal / bidirectional attention for Hopper: the port of the two
// flash_attention Pallas variants.
//
// Replaces (src/repro/kernels/flash_attention.py):
//   _flash_kernel   -> flash_kernel   (repro_flash)
//   _blocked_kernel -> blocked_kernel (repro_blocked)
//
// Semantics are the Pallas kernels' exactly: q, k, v widened to f32;
// s = (q . k) * scale with scale = 1/sqrt(d); the causal mask is
// top-left aligned (row >= col) with fill -1e30; P.V in f32; the
// denominator is clamped at 1e-30.
//
// flash: one block per (b*h, BQ query rows).  The Pallas grid's
// sequential KV axis is a loop over BKV-row K/V tiles staged in shared
// memory; per-row running max m, denominator l and the f32 accumulator
// acc[BQ][d] stay in shared memory (d = 256 for gemma: acc does not fit
// a few registers per thread).  Logits: one thread per (row, col) dot
// product over d, K rows padded by one 32-bit word so a warp's
// consecutive columns hit distinct banks.  Softmax update: one warp per
// row with shuffle reductions.  P.V: one thread per (row, feature).
// Under the causal mask, KV tiles wholly above the diagonal are
// skipped — they would add exp(-1e30 - m) = 0 and rescale by
// exp(0) = 1, so skipping them is exact.
//
// blocked: one block per (b*h, BQ rows) with the whole K and V of that
// head resident in shared memory and one stable softmax pass, as the
// dense Pallas variant; it fits only while 2 * skv * d elements plus the
// (BQ x skv) f32 logits fit the 227 KB a block may opt in to.
//
// What bounds it on the H100 at the serve shapes (prefill, skv = 64,
// d = 256): operations — 4 * skv * d FLOPs per query row against
// reading q, k, v once; all of it on the FP32 CUDA cores.  Left on the
// table: tensor-core MMA for QK^T and PV, register-resident
// accumulators split across warps, and overlapping the next K/V tile's
// load with this tile's math.
#include "common.cuh"

// (index, BQ, BKV, threads) -- must match flash_attention.py FLASH_TILES.
#define FLASH_TILES(X)           \
  X(0, 16, 32, 128)              \
  X(1, 16, 64, 128)              \
  X(2, 32, 32, 256)              \
  X(3, 32, 64, 256)              \
  X(4, 64, 64, 256)

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
  switch (tile) { FLASH_TILES(FLASH_CASE) default: break; }
#undef FLASH_CASE
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
  if (kind == KIND_FLASH) {
    switch (tile) { FLASH_TILES(FLASH_ATTR) default: break; }
  } else if (kind == KIND_BLOCKED) {
    switch (tile) { BLOCKED_TILES(BLOCKED_ATTR) default: break; }
  }
#undef FLASH_ATTR
#undef BLOCKED_ATTR
  return (int)cudaErrorInvalidValue;
}

// flash: out = BQ, BKV, 0, 0, 0, threads; blocked: BQ, 0, 0, 0, 0, threads.
int repro_attn_tile_info(int kind, int tile, int* out) {
#define FLASH_INFO(i, BQ, BKV, NT)                                              \
  case i: out[0] = BQ; out[1] = BKV; out[2] = out[3] = out[4] = 0;              \
    out[5] = NT; return 0;
#define BLOCKED_INFO(i, BQ, NT)                                                 \
  case i: out[0] = BQ; out[1] = out[2] = out[3] = out[4] = 0; out[5] = NT;      \
    return 0;
  if (kind == KIND_FLASH) {
    switch (tile) { FLASH_TILES(FLASH_INFO) default: break; }
  } else if (kind == KIND_BLOCKED) {
    switch (tile) { BLOCKED_TILES(BLOCKED_INFO) default: break; }
  }
#undef FLASH_INFO
#undef BLOCKED_INFO
  return -1;
}

}  // extern "C"
