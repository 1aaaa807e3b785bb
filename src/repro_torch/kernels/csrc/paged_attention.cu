// Single-token decode attention against a block-paged KV pool, for sm_90a.
//
// Replaces: repro/kernels/paged_attention.py::_paged_kernel (Pallas, TPU).
// Computes what it computes: for each sequence b and kv head h, the G query
// rows of that head attend over the keys at positions 0..ctx[b] (inclusive),
// found through block_tables[b, j] -> page, with an optional sliding window
// and logit softcap; online softmax in f32, output acc / max(l, 1e-30) in
// q's dtype.  Whole pages past ctx or outside the window are skipped.
//
// What bounds it on this card: bytes.  Each (b, h) reads its live pages of
// k and v once (2 * ceil((ctx+1)/bs) * bs * d * 2 bytes in bf16) and does
// only ~4*G*d flops per key: about 2 flops per byte, far below the ridge.
//
// Design: one block of 128 threads per (sequence, kv head), serving all G
// query rows, so each page is read once per head and not once per q head.
// The TPU reached the page through scalar-prefetched tables in the index
// map; here the block's threads read tables[b, j] themselves.  Per page,
// each warp takes keys t = warp, warp+4, ...: its lanes split d, reduce the
// G dot products with shuffles, and write masked scores to shared memory;
// G threads then update the running max and sum, and every thread rescales
// its G*d/128 accumulator elements and adds p * v with coalesced reads of
// the v rows.  The engine launches once per member (the K member pools are
// separate tensors), so a decode tick makes K launches per layer.
// Done slots read only the sink page 0 (ctx 0, tables row of zeros), as in
// the reference engine; nothing is written here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;
constexpr int MAX_BS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_fwd(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
          const int* __restrict__ tables, const int* __restrict__ ctx_lens, T* __restrict__ o,
          int Hkv, int G, int bs, int M, int window, float softcap, float scale) {
  constexpr int PER_LANE = D / 32;
  constexpr int R = MAX_G * D / THREADS;  // accumulator slots per thread
  __shared__ float qs[MAX_G][D];
  __shared__ float sc[MAX_G][MAX_BS];
  __shared__ float m_s[MAX_G], l_s[MAX_G], corr_s[MAX_G];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ctx = ctx_lens[b];
  const T* qb = q + ((size_t)b * Hkv + h) * G * D;

  for (int i = tid; i < G * D; i += THREADS) qs[i / D][i % D] = to_f32(qb[i]) * scale;
  if (tid < G) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  __syncthreads();

  const int j_last = min(ctx / bs, M - 1);
  for (int j = 0; j <= j_last; ++j) {
    if (window > 0 && j * bs + bs - 1 < ctx - window + 1) continue;  // uniform over the block
    const size_t page = (size_t)tables[(size_t)b * M + j];
    for (int t = warp; t < bs; t += WARPS) {
      const T* kr = kp + ((page * bs + t) * Hkv + h) * D;
      float kv[PER_LANE];
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) kv[e] = to_f32(kr[lane + 32 * e]);
      const int kpos = j * bs + t;
      const bool valid = kpos <= ctx && (window <= 0 || ctx - kpos < window);
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < PER_LANE; ++e) dot = fmaf(qs[g][lane + 32 * e], kv[e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (lane == 0) {
          if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
          sc[g][t] = valid ? dot : -INFINITY;
        }
      }
    }
    __syncthreads();
    if (tid < G) {
      const int g = tid;
      float tmax = -INFINITY;
      for (int t = 0; t < bs; ++t) tmax = fmaxf(tmax, sc[g][t]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float s = sc[g][t];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        sc[g][t] = p;
        sum += p;
      }
      const float corr = expf(m_old - m_new);
      corr_s[g] = corr;
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = tid + THREADS * r;
      if (e < G * D) {
        const int g = e / D, c = e % D;
        float a = acc[r] * corr_s[g];
        const T* vc = vp + (page * bs * Hkv + h) * D + c;
        for (int t = 0; t < bs; ++t) a = fmaf(sc[g][t], to_f32(vc[(size_t)t * Hkv * D]), a);
        acc[r] = a;
      }
    }
    __syncthreads();  // sc is rewritten by the next page
  }

  T* ob = o + ((size_t)b * Hkv + h) * G * D;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = tid + THREADS * r;
    if (e < G * D) store(ob + e, acc[r] / fmaxf(l_s[e / D], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* tables, const int* ctx,
           void* o, int B, int Hkv, int G, int bs, int M, int window, float softcap,
           float scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  paged_fwd<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      ctx, static_cast<T*>(o), Hkv, G, bs, M, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_fwd(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* ctx, void* o, int B, int Hkv,
                                   int G, int D, int bs, int M, int is_bf16, int window,
                                   float softcap, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > MAX_G || bs < 1 || bs > MAX_BS || M < 1)
    return (int)cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(ctx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, kp, vp, tab, cl, o, B, Hkv, G, bs, M, window, softcap, scale, st)
                   : launch<float, 128>(q, kp, vp, tab, cl, o, B, Hkv, G, bs, M, window, softcap, scale, st);
  if (D == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, kp, vp, tab, cl, o, B, Hkv, G, bs, M, window, softcap, scale, st)
                   : launch<float, 64>(q, kp, vp, tab, cl, o, B, Hkv, G, bs, M, window, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
