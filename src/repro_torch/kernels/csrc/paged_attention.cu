// Single-token decode attention against a block-paged KV pool, for sm_90a.
//
// Replaces: repro/kernels/paged_attention.py::_paged_kernel (Pallas, TPU).
// Computes what it computes: for each sequence b and kv head h, the G query
// rows of that head attend over the keys at positions 0..ctx[b] (inclusive),
// found through block_tables[b, j] -> page, with an optional sliding window
// and logit softcap; online softmax in f32, output acc / max(l, 1e-30) in
// q's dtype.  Whole pages past ctx or outside the window are skipped.
//
// What bounds it on this card: on paper, bytes.  Each (b, h) reads its live
// pages of k and v once (2 * ceil((ctx+1)/bs) * bs * d * 2 bytes in bf16) and
// does only ~4*G*d flops per key: about 2 flops per byte, far below the
// ridge.  At the serving path's shapes (8 slots x 8 kv heads, ctx <= 160,
// 16-key pages) that is ~0.8 us of traffic, so a launch is bound by latency:
// how many dependent memory round trips and reductions lie between its first
// load and its last store.
//
// Design: one block of WARPS warps per (sequence, kv head), serving all G
// query rows, so each page is read once per kv head and not once per q head.
// The pages are split over the warps (page j goes to warp j mod WARPS), and
// each warp runs its own online softmax in registers: there is no block
// barrier until the one combine at the end.  Inside a warp, a key row is
// read as 16-byte vectors, LPK lanes to a row (16 lanes for a bf16 row of
// d = 128), so one warp load covers KPI = 32 / LPK keys; each lane group of
// LPK lanes takes its own keys and keeps its own (m, l) and its G x (16-byte)
// slice of the accumulators.  A chunk is U keys per lane group (8 for G <= 2,
// 4 for G <= 4, else 2, as registers allow): their k and v vectors are loaded
// together, the chunk after it is loaded before this one is reduced, the G
// dot products reduce with shuffles within the lane group, the chunk's max
// updates (m, l) once, and p * v accumulates into the lane's own channels.  Keys outside [window start, ctx] and past the page
// are not loaded (their p is exactly 0 and their v reads as 0).  Each warp
// reads its own entries of the block's table row, 32 pages to a load, and
// passes them lane to lane with shuffles; the first such load is issued
// before ctx is read, so the two overlap.  At the end the lane groups merge
// with shuffles, the warps through shared memory.  The context is not split
// across blocks: at ctx <= 160 a block's 8 warps see at most 2 pages each.
// The engine launches once per member (the K member pools are separate
// tensors), so a decode tick makes K launches per layer.  Done slots read
// only the sink page 0 (ctx 0, tables row of zeros), as in the reference
// engine; nothing is written here.  f32 and bf16 share the template; G is a
// template parameter (1..8) so that q and the accumulators live in registers.
// Pointers must be 16-byte aligned; the entry returns
// cudaErrorMisalignedAddress otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_G = 8;
constexpr int MAX_BS = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// the 16 bytes of r as 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
paged_fwd(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
          const int* __restrict__ tables, const int* __restrict__ ctx_lens, T* __restrict__ o,
          int Hkv, int bs, int M, int window, float softcap, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int LPK = D / VEC;         // lanes per key row
  constexpr int KPI = 32 / LPK;        // keys per warp load
  constexpr int U = G <= 2 ? 8 : G <= 4 ? 4 : 2;  // keys per lane group per chunk
  constexpr int KPC = KPI * U;         // keys per warp per chunk
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "head dim");
  __shared__ float m_s[WARPS][G], l_s[WARPS][G];
  __shared__ __align__(16) float acc_s[WARPS][G][D];
  __shared__ float f_s[WARPS][G], inv_s[G];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPK;  // which 16 bytes of a row
  const int grp = lane / LPK;  // which key of a warp load
  const int* tab = tables + (size_t)b * M;
  // this warp's pages are j = warp + WARPS * i; lane i holds the table entry
  // of page i mod 32 of the block of 32 that tab_blk names.  The first block is
  // read before ctx is known, so the two loads overlap.
  int tab_blk = 0;
  int tab_reg = warp + WARPS * lane < M ? tab[warp + WARPS * lane] : 0;
  const int ctx = ctx_lens[b];
  const int j_first = window > 0 ? max(0, ctx - window + 1) / bs : 0;
  const int j_last = min(ctx / bs, M - 1);
  const int i_first = j_first > warp ? (j_first - warp + WARPS - 1) / WARPS : 0;
  const int i_end = j_last >= warp ? (j_last - warp) / WARPS + 1 : 0;
  const int per_page = (bs + KPC - 1) / KPC;
  const int n_chunks = max(0, i_end - i_first) * per_page;

  float qf[G][VEC];
  {
    const T* qb = q + ((size_t)b * Hkv + h) * G * D + sub * VEC;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      unpack(*reinterpret_cast<const uint4*>(qb + g * D), qf[g]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[g][e] *= scale;
    }
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // key u of chunk c for this lane: its offset t in page i of this warp, and
  // whether it is read (inside [window start, ctx] and the page)
  auto key_of = [&](int c, int u, int& i, int& t) {
    const int ci = c / per_page;
    i = i_first + ci;
    t = grp + KPI * (u + U * (c - ci * per_page));
    const int kpos = (warp + WARPS * i) * bs + t;
    return t < bs && kpos <= ctx && (window <= 0 || ctx - kpos < window);
  };
  auto load = [&](int c, uint4 (&kr)[U], uint4 (&vr)[U]) {
    const int i = i_first + c / per_page;
    if (i >> 5 != tab_blk) {  // warp-uniform: the next 32 pages' table entries
      tab_blk = i >> 5;
      const int j = warp + WARPS * (32 * tab_blk + lane);
      tab_reg = j < M ? tab[j] : 0;
    }
    const size_t page = (size_t)__shfl_sync(FULL, tab_reg, i & 31);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int iu, t;
      if (key_of(c, u, iu, t)) {
        const size_t off = ((page * bs + t) * Hkv + h) * D + sub * VEC;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kp + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vp + off));
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  uint4 kc[U], vc[U], kn[U], vn[U];
  if (n_chunks > 0) load(0, kc, vc);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load(c + 1, kn, vn);  // in flight while chunk c is reduced
    float s[U][G];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int i, t;
      live[u] = key_of(c, u, i, t);
      float kf[VEC];
      unpack(kc[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qf[g][e], kf[e], dot);
        s[u][g] = dot;
      }
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) s[u][g] += __shfl_xor_sync(FULL, s[u][g], off);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = s[u][g];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = live[u] ? x : -INFINITY;
        s[u][g] = x;
        cmax = fmaxf(cmax, x);
      }
      const float m_new = fmaxf(m[g], cmax);
      const float corr = expf(m[g] - m_new);
      m[g] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = s[u][g] == -INFINITY ? 0.f : expf(s[u][g] - m_new);
        s[u][g] = p;
        sum += p;
      }
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      unpack(vc[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kn[u];
      vc[u] = vn[u];
    }
  }

  // merge the warp's lane groups (they hold the same channels of other keys)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], off);
      const float lo = __shfl_xor_sync(FULL, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(FULL, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
    }
  }
  // then the warps, through shared memory
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(&acc_s[warp][g][sub * VEC + e]) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][g]);
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(m_s[w][g] - mx);
      f_s[w][g] = f;
      lt += l_s[w][g] * f;
    }
    inv_s[g] = 1.f / fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  T* ob = o + ((size_t)b * Hkv + h) * G * D;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, c = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = fmaf(acc_s[w][g][c], f_s[w][g], a);
    store(ob + i, a * inv_s[g]);
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* kp, const void* vp, const int* tables, const int* ctx,
           void* o, int B, int Hkv, int bs, int M, int window, float softcap, float scale,
           cudaStream_t stream) {
  dim3 grid(Hkv, B);
  paged_fwd<T, D, G><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      ctx, static_cast<T*>(o), Hkv, bs, M, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(int G, const void* q, const void* kp, const void* vp, const int* tables,
             const int* ctx, void* o, int B, int Hkv, int bs, int M, int window, float softcap,
             float scale, cudaStream_t st) {
  switch (G) {
#define PAGED_G(n) \
  case n: return launch<T, D, n>(q, kp, vp, tables, ctx, o, B, Hkv, bs, M, window, softcap, scale, st);
    PAGED_G(1) PAGED_G(2) PAGED_G(3) PAGED_G(4) PAGED_G(5) PAGED_G(6) PAGED_G(7) PAGED_G(8)
#undef PAGED_G
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_attention_fwd(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* ctx, void* o, int B, int Hkv,
                                   int G, int D, int bs, int M, int is_bf16, int window,
                                   float softcap, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > MAX_G || bs < 1 || bs > MAX_BS || M < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kp) |
       reinterpret_cast<uintptr_t>(vp)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int* tab = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(ctx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return is_bf16 ? launch_g<__nv_bfloat16, 128>(G, q, kp, vp, tab, cl, o, B, Hkv, bs, M, window, softcap, scale, st)
                   : launch_g<float, 128>(G, q, kp, vp, tab, cl, o, B, Hkv, bs, M, window, softcap, scale, st);
  if (D == 64)
    return is_bf16 ? launch_g<__nv_bfloat16, 64>(G, q, kp, vp, tab, cl, o, B, Hkv, bs, M, window, softcap, scale, st)
                   : launch_g<float, 64>(G, q, kp, vp, tab, cl, o, B, Hkv, bs, M, window, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
