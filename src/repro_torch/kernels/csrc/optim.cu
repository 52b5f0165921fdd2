// AdamW's update and its global gradient norm, one pass per leaf.
//
// No Pallas kernel corresponds: the reference's training step is
// `jax.jit(make_train_step(...), donate_argnums=(0, 1))`
// (src/repro/launch/train.py), so XLA fuses `adamw_update`'s per-leaf
// `upd` (src/repro/optim/adamw.py) into one loop that writes parameters
// and moments in place, and its norm into one reduction per leaf.
// Eager PyTorch makes about ten passes a leaf with leaf-sized f32
// temporaries; these two kernels make the compiled step's passes.
//
// * sumsq_kernel (+ sumsq_final_kernel): one leaf's f32 sum of
//   squares.  Each thread reads 16-byte vectors on a grid stride (one
//   accumulator per vector lane), a block sums its threads by a fixed
//   butterfly and its warps in order, and one block then sums the
//   blocks' partials the same way: the grid depends on the leaf's size
//   alone, so a run repeats bit for bit.  4 (f32) or 2 (bf16) bytes an
//   element, read once.
// * adamw_kernel: p, g, m, v read once, p, m, v written in place, four
//   elements a thread a stride (16-byte vectors for f32, 8-byte for
//   bf16); clip, lr and the two bias corrections are read from device
//   memory, so the host never waits for the norm.  Each operation
//   rounds as the eager version's op does (optim/adamw.py
//   `leaf_update_plain`): `_rn` intrinsics keep nvcc from contracting a
//   product and a sum that eager PyTorch rounds apart, and the one
//   place eager PyTorch's own kernel contracts (`add_(pf, alpha=wd)`,
//   `a + b * alpha`) is an fma here too.  28 bytes an f32 element.
//
// Both are bound by device memory: every byte is touched once and the
// arithmetic is a few operations an element.
#include "common.cuh"

constexpr int OPT_THREADS = 256;
constexpr int SUMSQ_FINAL_THREADS = 1024;  // the most partials there are

// A block's sum of one float per thread: lanes by warp_sum's butterfly,
// then the warps in order by warp 0.  Valid in thread 0.
static __device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int warps = blockDim.x >> 5;
  v = 0.0f;
  if (warp == 0) {
    v = lane < warps ? warp_sums[lane] : 0.0f;
    v = warp_sum(v);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(OPT_THREADS)
sumsq_kernel(const T* __restrict__ x, float* __restrict__ partials,
             long long n, long long nvec) {
  __shared__ float warp_sums[OPT_THREADS / 32];
  constexpr int V = VecWidth<T>::value;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = t; i < nvec; i += stride) {
    float f[V];
    load16<T>(x + i * V, f);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = __fmaf_rn(f[k], f[k], acc[k]);
  }
  for (long long i = nvec * V + t; i < n; i += stride) {
    const float f = to_f<T>(x[i]);
    acc[0] = __fmaf_rn(f, f, acc[0]);
  }
  float s = acc[0];
#pragma unroll
  for (int k = 1; k < V; ++k) s += acc[k];
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(SUMSQ_FINAL_THREADS)
sumsq_final_kernel(const float* __restrict__ partials, int blocks,
                   float* __restrict__ out) {
  __shared__ float warp_sums[SUMSQ_FINAL_THREADS / 32];
  const float v = (int)threadIdx.x < blocks ? partials[threadIdx.x] : 0.0f;
  const float s = block_sum(v, warp_sums);
  if (threadIdx.x == 0) out[0] = s;
}

struct AdamW {
  float clip, lr, bc1, bc2;        // from device memory
  float b1, omb1, b2, omb2, eps, wd;

  // One element, in the eager version's order and roundings:
  // g' = g clip; m = b1 m + (1-b1) g'; v = b2 v + (1-b2) g' g';
  // step = (m / bc1) / (sqrt(v / bc2) + eps); p = p - lr (step + wd p)
  __device__ __forceinline__ void operator()(float& p, float g, float& m,
                                             float& v) const {
    const float gc = __fmul_rn(g, clip);
    m = __fadd_rn(__fmul_rn(m, b1), __fmul_rn(gc, omb1));
    v = __fadd_rn(__fmul_rn(v, b2), __fmul_rn(__fmul_rn(gc, omb2), gc));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps);
    float step = __fdiv_rn(__fdiv_rn(m, bc1), den);
    step = __fmaf_rn(p, wd, step);  // eager add_(pf, alpha=wd) contracts
    p = __fsub_rn(p, __fmul_rn(lr, step));
  }
};

// Four elements of T from / to memory, as f32.
template <typename T> struct Quad;
template <> struct Quad<float> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Quad<bf16> {
  static __device__ __forceinline__ void load(const bf16* p, float* o) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  static __device__ __forceinline__ void store(bf16* p, const float* o) {
    uint2 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    h[0] = __floats2bfloat162_rn(o[0], o[1]);
    h[1] = __floats2bfloat162_rn(o[2], o[3]);
    *reinterpret_cast<uint2*>(p) = v;
  }
};

template <typename TP, typename TG>
__global__ void __launch_bounds__(OPT_THREADS)
adamw_kernel(TP* __restrict__ p, const TG* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v,
             const float* __restrict__ scal, long long n, long long nquad,
             float b1, float omb1, float b2, float omb2, float eps,
             float wd) {
  const AdamW op{scal[0], scal[1], scal[2], scal[3],
                 b1, omb1, b2, omb2, eps, wd};
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = t; i < nquad; i += stride) {
    float pf[4], gf[4], mf[4], vf[4];
    Quad<TP>::load(p + 4 * i, pf);
    Quad<TG>::load(g + 4 * i, gf);
    Quad<float>::load(m + 4 * i, mf);
    Quad<float>::load(v + 4 * i, vf);
#pragma unroll
    for (int k = 0; k < 4; ++k) op(pf[k], gf[k], mf[k], vf[k]);
    Quad<TP>::store(p + 4 * i, pf);
    Quad<float>::store(m + 4 * i, mf);
    Quad<float>::store(v + 4 * i, vf);
  }
  for (long long i = nquad * 4 + t; i < n; i += stride) {
    float pf = to_f<TP>(p[i]), mf = m[i], vf = v[i];
    op(pf, to_f<TG>(g[i]), mf, vf);
    p[i] = from_f<TP>(pf);
    m[i] = mf;
    v[i] = vf;
  }
}

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <typename TP, typename TG>
static int launch_adamw(void* p, const void* g, void* m, void* v,
                        const void* scal, long long n, long long nquad,
                        float b1, float omb1, float b2, float omb2,
                        float eps, float wd, cudaStream_t stream) {
  const long long work = nquad > 0 ? nquad : n;
  const long long most = (long long)sm_count() * (2048 / OPT_THREADS);
  long long blocks = (work + OPT_THREADS - 1) / OPT_THREADS;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  adamw_kernel<TP, TG><<<(unsigned)blocks, OPT_THREADS, 0, stream>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(scal), n, nquad, b1, omb1, b2, omb2, eps,
      wd);
  return (int)cudaGetLastError();
}

extern "C" {

// out[0] = sum of x[i]^2 in f32 over n elements of x (dtype 0 f32, 1
// bf16); `partials` holds `capacity` floats, at least
// SUMSQ_FINAL_THREADS (1024); the blocks, 32 elements a thread at least
// and at most 1024, are a function of n alone, so the sum's order is
// too; the first nvec 16-byte vectors are read as vectors (0 when x is
// not 16-byte aligned), the rest element by element.
int repro_sumsq(int dtype, const void* x, void* partials, int capacity,
                void* out, long long n, long long nvec, void* stream) {
  if (capacity < SUMSQ_FINAL_THREADS) return (int)cudaErrorInvalidValue;
  long long want = (n + OPT_THREADS * 32 - 1) / (OPT_THREADS * 32);
  const int blocks = (int)(want < 1 ? 1
                           : want > SUMSQ_FINAL_THREADS ? SUMSQ_FINAL_THREADS
                                                        : want);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (dtype == 0)
    sumsq_kernel<float><<<blocks, OPT_THREADS, 0, s>>>(
        static_cast<const float*>(x), part, n, nvec);
  else if (dtype == 1)
    sumsq_kernel<bf16><<<blocks, OPT_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), part, n, nvec);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sumsq_final_kernel<<<1, SUMSQ_FINAL_THREADS, 0, s>>>(
      part, blocks, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// One AdamW step of n elements in place: p (dtype p_dtype) and the f32
// moments m, v, from the gradient g (dtype g_dtype); scal = [clip, lr,
// bc1, bc2] in f32 on the device; the first nquad groups of four as
// vectors (0 when a pointer is not aligned to four elements).
int repro_adamw(int p_dtype, int g_dtype, void* p, const void* g, void* m,
                void* v, const void* scal, long long n, long long nquad,
                float b1, float omb1, float b2, float omb2, float eps,
                float wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = p_dtype * 2 + g_dtype;
  switch (key) {
    case 0: return launch_adamw<float, float>(p, g, m, v, scal, n, nquad, b1,
                                              omb1, b2, omb2, eps, wd, s);
    case 1: return launch_adamw<float, bf16>(p, g, m, v, scal, n, nquad, b1,
                                             omb1, b2, omb2, eps, wd, s);
    case 2: return launch_adamw<bf16, float>(p, g, m, v, scal, n, nquad, b1,
                                             omb1, b2, omb2, eps, wd, s);
    case 3: return launch_adamw<bf16, bf16>(p, g, m, v, scal, n, nquad, b1,
                                            omb1, b2, omb2, eps, wd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
