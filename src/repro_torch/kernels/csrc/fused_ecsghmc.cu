// Fused EC-SGHMC chain updates (paper Eq. 6), one leaf per launch, for sm_90a.
//
// Replaces: repro/kernels/fused_ecsghmc.py::_kernel (Pallas, TPU), line 54,
// and, with PRECOND, ::_precond_kernel (line 156).
// Computes, for every element of a (K, N) leaf (K chains of N elements):
//   theta' = theta + eps_minv * p
//   p'     = decay * p - eps * g - coupling * (theta - c~) + sigma_p * n
// or, preconditioned, with a per-element diagonal m = M^-1 of shape (K, N):
//   theta' = theta + (eps * m) * p
//   p'     = (1 - ef * m) * p - eps * g - coupling * (theta - c~) + sigma_p * n
// with n = Box-Muller(bits1, bits2) and c~ the stale center, which has no
// chain axis (N elements).  f32 or bf16 state; g and m are f32; arithmetic
// in f32.  bf16 stores go through stochastic rounding with the bits b1^b2
// (theta') and 0x9E3779B9^b1^b2 (p') when it is on, else round to nearest.
//
// What bounds it on this card: bytes.  Per chain element it reads theta, p
// and g (and m) and writes theta' and p' (20 B in f32, 24 B with m); c~
// adds 4 B per element of one chain, because each thread reads its c~ once
// and applies it to all K chains.  About 10 flops and two transcendentals
// per element: far below the ridge.  At qwen3-0.6b, K = 4, one step moves
// 50.1 GB (59.6 GB preconditioned), 14.9 ms (17.8 ms) at 3.35 TB/s.
//
// Design: a grid-stride loop over groups of 4 consecutive elements of one
// chain (16-byte loads of f32 state, 8-byte of bf16) when N % 4 == 0 and
// every pointer is 16-byte aligned, else over single elements; either way
// a thread walks the K chains of its group, so nothing is padded and the
// ragged tail needs no copy.  The scalars come in as arguments.  Noise
// has two modes: parity mode reads bits1/bits2 (flat, the leaf's element
// order); production mode makes them here with Philox-4x32-10, key
// (seed lo, seed hi), counter (element / 2, leaf, step lo, step hi), words
// (0, 1) for even elements and (2, 3) for odd ones, the counterpart of the
// TPU's pltpu.prng_random_bits.  The element is the GLOBAL index
// (chain_offset + k) * N + j: a rank that holds chains chain_offset ..
// chain_offset + K - 1 of a run split over ranks draws exactly those
// chains' noise of the unsplit run (chain_offset 0).  Both updates draw
// the same noise for the same (seed, leaf, step), so at m == 1 they are
// bitwise equal.  The update
// uses __fmul_rn/__fadd_rn/__fsub_rn so that nvcc does not contract it into
// FMAs: it rounds exactly as PyTorch's eager ops round the plain version,
// and logf/cosf/sqrtf are the functions PyTorch's CUDA log/cos/sqrt call.
// p may alias p_out (an in-place update): each element is read before it
// is written, by the same thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr unsigned PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr unsigned SR_SALT = 0x9E3779B9u;
constexpr float TWO_PI = 6.28318530717958647692f;  // f32(2 pi), as the reference rounds it

// eps_minv and decay serve the scalar-mass update, ef (= eps * V) the
// preconditioned one; the rest serve both.
struct Scalars {
  float eps_minv, decay, eps, coupling, sigma_p, ef;
};

// theta' and p' of one element; m is M^-1 when PRECOND, else unused.
template <bool PRECOND>
__device__ __forceinline__ void eq6(float t, float pp, float gg, float c, float m, float n,
                                    const Scalars& s, float& t_new, float& p_new) {
  const float drift = PRECOND ? __fmul_rn(s.eps, m) : s.eps_minv;
  const float decay = PRECOND ? __fsub_rn(1.0f, __fmul_rn(s.ef, m)) : s.decay;
  t_new = __fadd_rn(t, __fmul_rn(drift, pp));
  float x = __fsub_rn(__fmul_rn(decay, pp), __fmul_rn(s.eps, gg));
  x = __fsub_rn(x, __fmul_rn(s.coupling, __fsub_rn(t, c)));
  p_new = __fadd_rn(x, __fmul_rn(s.sigma_p, n));
}

__device__ __forceinline__ uint4 philox(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const unsigned hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return c;
}

__device__ __forceinline__ float unit(unsigned b) {
  return __fadd_rn(__fmul_rn((float)(b >> 8), 5.9604644775390625e-08f), 2.98023223876953125e-08f);
}

__device__ __forceinline__ float box_muller(unsigned b1, unsigned b2) {
  const float r = sqrtf(__fmul_rn(-2.0f, logf(unit(b1))));
  return __fmul_rn(r, cosf(__fmul_rn(TWO_PI, unit(b2))));
}

__device__ __forceinline__ float load(const float* x, int64_t i) { return x[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* x, int64_t i) { return __bfloat162float(x[i]); }

__device__ __forceinline__ void store(float* x, int64_t i, float v, unsigned) { x[i] = v; }
template <bool SR>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* x, int64_t i, float v, unsigned bits) {
  if (SR) {
    const unsigned u = (__float_as_uint(v) + (bits & 0xFFFFu)) >> 16;
    x[i] = __ushort_as_bfloat16((unsigned short)u);
  } else {
    x[i] = __float2bfloat16(v);
  }
}

// One element of one chain: e is its flat index in the leaf, c its c~.
template <typename T, bool PRECOND, bool SR>
__device__ __forceinline__ void update_one(const T* theta, const T* p, const float* g,
                                           const float* minv, float c, T* theta_out, T* p_out,
                                           int64_t e, unsigned b1, unsigned b2,
                                           const Scalars& s) {
  const float t = load(theta, e), pp = load(p, e), gg = g[e];
  float t_new, p_new;
  eq6<PRECOND>(t, pp, gg, c, PRECOND ? minv[e] : 0.0f, box_muller(b1, b2), s, t_new, p_new);
  if constexpr (sizeof(T) == 4) {
    store(theta_out, e, t_new, 0u);
    store(p_out, e, p_new, 0u);
  } else {
    const unsigned sr = b1 ^ b2;
    store_bf16<SR>(theta_out, e, t_new, sr);
    store_bf16<SR>(p_out, e, p_new, SR_SALT ^ sr);
  }
}

// e: the element's index in the leaf (parity mode's bits); ge: its global
// index, the Philox counter.
template <bool PHILOX>
__device__ __forceinline__ void bits_of(const unsigned* bits1, const unsigned* bits2, int64_t e,
                                        int64_t ge, unsigned k0, unsigned k1, unsigned leaf,
                                        uint64_t step, unsigned& b1, unsigned& b2) {
  if (PHILOX) {
    const uint4 r = philox(make_uint4((unsigned)(ge >> 1), leaf, (unsigned)step,
                                      (unsigned)(step >> 32)), k0, k1);
    if (ge & 1) { b1 = r.z; b2 = r.w; } else { b1 = r.x; b2 = r.y; }
  } else {
    b1 = bits1[e];
    b2 = bits2[e];
  }
}

// Single-element path: any N, any alignment.
template <typename T, bool PRECOND, bool PHILOX, bool SR>
__global__ void __launch_bounds__(THREADS)
ec_update_scalar(const T* __restrict__ theta, const T* p, const float* __restrict__ g,
                 const float* __restrict__ minv, const T* __restrict__ c,
                 const unsigned* __restrict__ bits1,
                 const unsigned* __restrict__ bits2, T* __restrict__ theta_out, T* p_out,
                 int64_t K, int64_t N, int64_t ebase, unsigned k0, unsigned k1, unsigned leaf,
                 uint64_t step, Scalars s) {
  for (int64_t j = blockIdx.x * (int64_t)THREADS + threadIdx.x; j < N;
       j += (int64_t)gridDim.x * THREADS) {
    const float cj = load(c, j);
    for (int64_t k = 0; k < K; ++k) {
      const int64_t e = k * N + j;
      unsigned b1, b2;
      bits_of<PHILOX>(bits1, bits2, e, ebase + e, k0, k1, leaf, step, b1, b2);
      update_one<T, PRECOND, SR>(theta, p, g, minv, cj, theta_out, p_out, e, b1, b2, s);
    }
  }
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };  // 4 bf16

__device__ __forceinline__ void unpack(const float4& v, float out[4]) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint2& v, float out[4]) {
  out[0] = __uint_as_float(v.x << 16);
  out[1] = __uint_as_float(v.x & 0xFFFF0000u);
  out[2] = __uint_as_float(v.y << 16);
  out[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

__device__ __forceinline__ unsigned bf16_bits(float v, unsigned bits, bool sr) {
  if (sr) return (__float_as_uint(v) + (bits & 0xFFFFu)) >> 16;
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(v));
}

// Four-element path: N % 4 == 0 and 16-byte aligned pointers, so a group
// of 4 never straddles two chains and every vector access is aligned.
template <typename T, bool PRECOND, bool PHILOX, bool SR>
__global__ void __launch_bounds__(THREADS)
ec_update_vec(const T* __restrict__ theta, const T* p, const float* __restrict__ g,
              const float* __restrict__ minv, const T* __restrict__ c,
              const unsigned* __restrict__ bits1,
              const unsigned* __restrict__ bits2, T* __restrict__ theta_out, T* p_out, int64_t K,
              int64_t N, int64_t ebase, unsigned k0, unsigned k1, unsigned leaf, uint64_t step,
              Scalars s) {
  using V = typename Vec4<T>::type;
  const int64_t groups = N / 4;
  for (int64_t q = blockIdx.x * (int64_t)THREADS + threadIdx.x; q < groups;
       q += (int64_t)gridDim.x * THREADS) {
    float cv[4];
    unpack(__ldg(reinterpret_cast<const V*>(c) + q), cv);
    for (int64_t k = 0; k < K; ++k) {
      const int64_t e0 = k * N + 4 * q;
      float tv[4], pv[4], gv[4], mv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      unpack(__ldg(reinterpret_cast<const V*>(theta + e0)), tv);
      unpack(*reinterpret_cast<const V*>(p + e0), pv);
      unpack(__ldg(reinterpret_cast<const float4*>(g + e0)), gv);
      if (PRECOND) unpack(__ldg(reinterpret_cast<const float4*>(minv + e0)), mv);
      unsigned b1[4], b2[4];
      if (PHILOX) {
        // ebase = chain_offset * N is a multiple of 4, so ge0 is even
        const int64_t ge0 = ebase + e0;
        const uint4 r0 = philox(make_uint4((unsigned)(ge0 >> 1), leaf, (unsigned)step,
                                           (unsigned)(step >> 32)), k0, k1);
        const uint4 r1 = philox(make_uint4((unsigned)(ge0 >> 1) + 1u, leaf, (unsigned)step,
                                           (unsigned)(step >> 32)), k0, k1);
        b1[0] = r0.x; b2[0] = r0.y; b1[1] = r0.z; b2[1] = r0.w;
        b1[2] = r1.x; b2[2] = r1.y; b1[3] = r1.z; b2[3] = r1.w;
      } else {
        const uint4 x1 = __ldg(reinterpret_cast<const uint4*>(bits1 + e0));
        const uint4 x2 = __ldg(reinterpret_cast<const uint4*>(bits2 + e0));
        b1[0] = x1.x; b1[1] = x1.y; b1[2] = x1.z; b1[3] = x1.w;
        b2[0] = x2.x; b2[1] = x2.y; b2[2] = x2.z; b2[3] = x2.w;
      }
      float tn[4], pn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        eq6<PRECOND>(tv[i], pv[i], gv[i], cv[i], mv[i], box_muller(b1[i], b2[i]), s, tn[i], pn[i]);
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(theta_out + e0) = make_float4(tn[0], tn[1], tn[2], tn[3]);
        *reinterpret_cast<float4*>(p_out + e0) = make_float4(pn[0], pn[1], pn[2], pn[3]);
      } else {
        unsigned th[4], ph[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned sr = b1[i] ^ b2[i];
          th[i] = bf16_bits(tn[i], sr, SR);
          ph[i] = bf16_bits(pn[i], SR_SALT ^ sr, SR);
        }
        *reinterpret_cast<uint2*>(theta_out + e0) = make_uint2(th[0] | (th[1] << 16), th[2] | (th[3] << 16));
        *reinterpret_cast<uint2*>(p_out + e0) = make_uint2(ph[0] | (ph[1] << 16), ph[2] | (ph[3] << 16));
      }
    }
  }
}

template <typename T, bool PRECOND, bool PHILOX, bool SR>
int launch(const void* theta, const void* p, const float* g, const float* minv, const void* c,
           const unsigned* b1, const unsigned* b2, void* theta_out, void* p_out, int64_t K,
           int64_t N, int64_t chain_offset, bool vec, uint64_t seed, unsigned leaf,
           uint64_t step, Scalars s, cudaStream_t st) {
  const int64_t items = vec ? N / 4 : N;
  const int64_t want = (items + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  const unsigned k0 = (unsigned)seed, k1 = (unsigned)(seed >> 32);
  const int64_t ebase = chain_offset * N;
  if (vec) {
    ec_update_vec<T, PRECOND, PHILOX, SR><<<blocks, THREADS, 0, st>>>(
        (const T*)theta, (const T*)p, g, minv, (const T*)c, b1, b2, (T*)theta_out, (T*)p_out, K, N,
        ebase, k0, k1, leaf, step, s);
  } else {
    ec_update_scalar<T, PRECOND, PHILOX, SR><<<blocks, THREADS, 0, st>>>(
        (const T*)theta, (const T*)p, g, minv, (const T*)c, b1, b2, (T*)theta_out, (T*)p_out, K, N,
        ebase, k0, k1, leaf, step, s);
  }
  return (int)cudaGetLastError();
}

// Picks the instantiation for the dtype, the noise mode and the rounding.
template <bool PRECOND>
int dispatch(const void* theta, const void* p, const float* g, const float* minv, const void* c,
             const unsigned* bits1, const unsigned* bits2, void* theta_out, void* p_out,
             long long K, long long N, long long chain_offset, int is_bf16,
             int stochastic_round, int vec, unsigned long long seed, unsigned leaf,
             unsigned long long step, Scalars s, void* stream) {
  if (K < 1 || N < 1 || chain_offset < 0) return (int)cudaErrorInvalidValue;
  if (PRECOND && minv == nullptr) return (int)cudaErrorInvalidValue;
  const bool philox_mode = bits1 == nullptr;
  if (!philox_mode && bits2 == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool sr = stochastic_round != 0;
#define EC_LAUNCH(T, PH, SRV)                                                                   \
  launch<T, PRECOND, PH, SRV>(theta, p, g, minv, c, bits1, bits2, theta_out, p_out, K, N,       \
                              chain_offset, vec != 0, seed, leaf, step, s, st)
  if (!is_bf16) return philox_mode ? EC_LAUNCH(float, true, false) : EC_LAUNCH(float, false, false);
  if (philox_mode) return sr ? EC_LAUNCH(__nv_bfloat16, true, true) : EC_LAUNCH(__nv_bfloat16, true, false);
  return sr ? EC_LAUNCH(__nv_bfloat16, false, true) : EC_LAUNCH(__nv_bfloat16, false, false);
#undef EC_LAUNCH
}

}  // namespace

// chain_offset: the global index of the leaf's first chain (0 unless the
// chains are split over ranks).
extern "C" int fused_ec_update(const void* theta, const void* p, const float* g, const void* c,
                               const unsigned* bits1, const unsigned* bits2, void* theta_out,
                               void* p_out, long long K, long long N, long long chain_offset,
                               int is_bf16, int stochastic_round, int vec,
                               unsigned long long seed, unsigned leaf, unsigned long long step,
                               float eps_minv, float decay, float eps, float coupling,
                               float sigma_p, void* stream) {
  const Scalars s{eps_minv, decay, eps, coupling, sigma_p, 0.0f};
  return dispatch<false>(theta, p, g, nullptr, c, bits1, bits2, theta_out, p_out, K, N,
                         chain_offset, is_bf16, stochastic_round, vec, seed, leaf, step, s,
                         stream);
}

// minv: (K, N) f32, the per-chain diagonal M^-1.
extern "C" int fused_precond_ec_update(const void* theta, const void* p, const float* g,
                                       const float* minv, const void* c, const unsigned* bits1,
                                       const unsigned* bits2, void* theta_out, void* p_out,
                                       long long K, long long N, int is_bf16,
                                       int stochastic_round, int vec, unsigned long long seed,
                                       unsigned leaf, unsigned long long step, float eps,
                                       float ef, float coupling, float sigma_p, void* stream) {
  const Scalars s{0.0f, 0.0f, eps, coupling, sigma_p, ef};
  return dispatch<true>(theta, p, g, minv, c, bits1, bits2, theta_out, p_out, K, N, 0, is_bf16,
                        stochastic_round, vec, seed, leaf, step, s, stream);
}
