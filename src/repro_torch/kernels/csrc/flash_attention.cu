// Causal blocked (flash) attention forward for sm_90a.
//
// Replaces: repro/kernels/flash_attention.py::_flash_kernel (Pallas, TPU).
// Computes what it computes: softmax(q k^T * scale [softcap] [causal/window
// mask]) v with the online-softmax recurrence in f32, GQA through the kv head
// h / G, output in q's dtype, acc / max(l, 1e-30).
//
// What bounds it on this card: at the serving path's prefill shapes (S =
// 64..128, causal, d = 128 or 256) the work is a few MFLOP per head on a few
// hundred KB, so the least time is ~0.5 us; what a launch costs is set by
// latency (the first K/V tile's trip from memory, the chain of dependent
// products per tile) and by how many SMs the grid reaches.
//
// Two kernels, chosen by dtype in flash_attention_fwd:
//
// bf16 (the serving path): the products run on the tensor cores.  A block
// serves 32 query rows of one q head, so the grid is (ceil(S/32), Hq, B): 64
// blocks at qwen3 S = 128, 40 at recurrentgemma.  Q and 64-key K/V tiles move
// as bf16 with 16-byte cp.async into shared memory rows padded by 16 bytes,
// so the eight rows an ldmatrix reads fall in distinct banks; K/V tiles sit
// in a two-stage ring, and tile t+1 loads while tile t is multiplied.  The
// block's four warps are two groups of 16 query rows times two halves of
// each key tile: a launch's time is the longest chain of dependent products
// in one warp, and the last q tile at S = 128 sees two key tiles, so halving
// the keys per warp halves that chain (two warps over whole tiles took 7.6 us
// at d = 128 and 11.9 us at d = 256, S = 128, on an H100).
// Each warp runs QK^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate) with Q
// and K fragments from ldmatrix, a k-step's fragments loaded together before
// its products; the 16 x 32 score fragment stays in registers, where it is
// scaled, softcapped, masked and exponentiated; rounded to bf16 it is PV's A
// operand as it lies (the m16n8 accumulator layout is the m16k16 operand
// layout), and V's fragments come from ldmatrix.trans.  P never goes to
// shared memory, and no operand is staged in f32.  The scale multiplies the
// f32 scores rather than q: q * scale rounded to bf16 would add a rounding
// the reference (f32 q * scale) does not have.  Rounding P to bf16 adds error
// of order 2^-9 relative to |o|.  At the end the two key halves of each row
// group merge their (m, l, acc) through shared memory.  Causal and window
// limits skip whole key tiles; the diagonal tile and a window edge are masked
// per element, so masked scores give exactly 0.  Rows and keys past S are
// zero-filled on load, masked, and not stored.  The output goes back through
// each warp's own Q rows in shared memory, so the stores are 16 bytes a lane.
// At D = 256 a thread holds 128 f32 accumulators and 16 scores; Q stays in
// shared memory and is re-read by ldmatrix per key tile rather than held in
// 64 more registers.  Shared memory: Q plus two K/V stages, 78,336 B at D =
// 128 and 152,064 B at D = 256, through the dynamic-shared-memory opt-in.
// wgmma (64 rows per warpgroup) and TMA are for long prompts: at S <= 128 a
// 64-row tile would halve the grid again, and the products are not the
// limit.
//
// f32 (the SMOKE configs, held against the CPU at 1e-4): the CUDA-core
// kernel of the first port, unchanged; TF32 tensor cores would not hold that
// tolerance.  One block per (b, q head, 64-row q tile) with f32 tiles in
// shared memory (row stride d+1), four threads per query row, scores and PV
// as scalar FMAs.  At D = 256 its four tiles take 213,760 bytes.
//
// Head dims: D = 64, 128 and 256 are instantiated (smaller heads are
// zero-padded by the wrapper).  Pointers must be 16-byte aligned (cp.async,
// vector stores); the entry returns cudaErrorMisalignedAddress otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// --- f32: the CUDA-core kernel -----------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 per query row
constexpr int COLS_PER_THREAD = BK / 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Hq, int Hkv, int S, int causal, int window,
          float softcap, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 4;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // BQ x DP, pre-scaled
  float* ks = qs + BQ * DP;      // BK x DP
  float* vs = ks + BK * DP;      // BK x D
  float* ps = vs + BK * D;       // BQ x (BK + 1) probabilities

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qg = q + ((size_t)b * Hq + h) * S * D;
  const T* kg = k + ((size_t)b * Hkv + hk) * S * D;
  const T* vg = v + ((size_t)b * Hkv + hk) * S * D;
  T* og = o + ((size_t)b * Hq + h) * S * D;

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int part = tid & 3;
  const int qpos = q0 + row;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int p = q0 + r;
    qs[r * DP + c] = p < S ? to_f32(qg[(size_t)p * D + c]) * scale : 0.f;
  }

  float acc[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) acc[j] = 0.f;
  float m_i = NEG_INF, l_i = 0.f;

  // whole k tiles outside the causal/window band are skipped
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int kt = (k_begin / BK) * BK; kt < k_end; kt += BK) {
    __syncthreads();  // previous tile fully consumed (and qs written)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int p = kt + r;
      const bool in = p < S;
      ks[r * DP + c] = in ? to_f32(kg[(size_t)p * D + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(vg[(size_t)p * D + c]) : 0.f;
    }
    __syncthreads();

    float s[COLS_PER_THREAD];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD; ++j) {
      const int c = j * 4 + part;  // interleaved: lanes of a row hit distinct rows of ks
      const float* qr = qs + row * DP;
      const float* kr = ks + c * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) dot = fmaf(qr[e], kr[e], dot);
      if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
      const int kpos = kt + c;
      bool valid = kpos < S;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && (qpos - kpos) < window;
      s[j] = valid ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_i, tile_max);
    const float corr = expf(m_i - m_new);
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
      ps[row * (BK + 1) + j * 4 + part] = p;
      rsum += p;
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
    l_i = l_i * corr + rsum;
    m_i = m_new;
    __syncwarp();  // the row's four threads share a warp

#pragma unroll
    for (int j = 0; j < DC; ++j) acc[j] *= corr;
    const float* pr = ps + row * (BK + 1);
    for (int c = 0; c < BK; ++c) {
      const float p = pr[c];
      const float* vr = vs + c * D + part;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[j] = fmaf(p, vr[4 * j], acc[j]);
    }
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* orow = og + (size_t)qpos * D + part;
#pragma unroll
    for (int j = 0; j < DC; ++j) store(orow + 4 * j, acc[j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
           int S, int causal, int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, S, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}


// --- bf16: the tensor-core kernel --------------------------------------------

namespace tc {

constexpr int THREADS = 128;  // 4 warps: 2 groups of 16 query rows x 2 halves of each key tile
constexpr int BQ = 32;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int BKW = BK / 2;   // keys per warp per tile
constexpr int PAD = 8;        // bf16 elements of row padding (16 bytes)

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * (D + PAD);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + rows) of a (S, D) bf16 matrix into shared rows of D + PAD;
// rows at or past S are zero-filled
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const int p = row0 + r;
    const bool in = p < S;
    cp_async16(smem_addr(dst + r * (D + PAD) + c * 8), src + (size_t)(in ? p : 0) * D + c * 8,
               in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Hq,
               int Hkv, int S, int causal, int window, float softcap, float scale) {
  constexpr int RS = D + PAD;  // shared row stride, elements
  constexpr int CH = D / 8;
  constexpr int NT = BKW / 8;  // m16n8 score tiles per warp per key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x RS
  __nv_bfloat16* ks = qs + BQ * RS;                                // 2 stages x BK x RS
  __nv_bfloat16* vs = ks + 2 * BK * RS;                            // 2 stages x BK x RS

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const __nv_bfloat16* qg = q + ((size_t)b * Hq + h) * S * D;
  const __nv_bfloat16* kg = k + ((size_t)b * Hkv + hk) * S * D;
  const __nv_bfloat16* vg = v + ((size_t)b * Hkv + hk) * S * D;
  __nv_bfloat16* og = o + ((size_t)b * Hq + h) * S * D;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp & 1) * 16;            // the warp's first query row in the block
  const int kw = (warp >> 1) * BKW;          // and its first key in each tile
  const int row_lo = q0 + r0 + (lane >> 2);  // query position of accumulator elements 0, 1
  const int row_hi = row_lo + 8;             // and of elements 2, 3

  // whole key tiles outside the causal/window band are skipped
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_begin / BK;
  const int n_tiles = (k_end + BK - 1) / BK - t_first;

  // groups in flight: {Q, K_0}, {V_0}, then {K_t+1}, {V_t+1} while tile t runs
  load_rows<D>(qs, qg, q0, BQ, S);
  load_rows<D>(ks, kg, t_first * BK, BK, S);
  cp_commit();
  load_rows<D>(vs, vg, t_first * BK, BK, S);
  cp_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = (t_first + it) * BK;
    const __nv_bfloat16* kst = ks + (it & 1) * BK * RS + kw * RS;  // the warp's keys
    const __nv_bfloat16* vst = vs + (it & 1) * BK * RS + kw * RS;
    const bool more = it + 1 < n_tiles;
    if (more) {  // the other stage was released by the barrier that ended tile it-1
      load_rows<D>(ks + ((it + 1) & 1) * BK * RS, kg, kt + BK, BK, S);
      cp_commit();
      load_rows<D>(vs + ((it + 1) & 1) * BK * RS, vg, kt + BK, BK, S);
      cp_commit();
      cp_wait<3>();
    } else {
      cp_wait<1>();
    }
    __syncthreads();  // K_t (and Q) in shared memory

    // S = Q K^T: 16 rows x BKW keys per warp; each k-step's fragments are
    // loaded together before its products
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk[NT / 2][4];
      ldsm_x4(a, smem_addr(qs + (r0 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_x4(bk[np], smem_addr(kst + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        mma(s[2 * np], a, bk[np][0], bk[np][1]);
        mma(s[2 * np + 1], a, bk[np][2], bk[np][3]);
      }
    }

    // scale, softcap, mask; online softmax over the warp's keys in registers.
    // Each row's scores lie on the four lanes of a quad.
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kt + kw + n * 8 + (lane & 3) * 2 + (e & 1);
        const int qpos = e < 2 ? row_lo : row_hi;
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool valid = kpos < S;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && (qpos - kpos) < window;
        x = valid ? x : -INFINITY;
        s[n][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = __expf(m_lo - mn_lo), corr_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
    uint32_t pa[NT / 2][4];  // P as bf16 A fragments of PV, one per 16 keys
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        p[e] = x == -INFINITY ? 0.f : __expf(x - (e < 2 ? mn_lo : mn_hi));
      }
      sum_lo += p[0] + p[1];
      sum_hi += p[2] + p[3];
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr_lo;
      acc[n][1] *= corr_lo;
      acc[n][2] *= corr_hi;
      acc[n][3] *= corr_hi;
    }

    if (more) cp_wait<2>(); else cp_wait<0>();
    __syncthreads();  // V_t in shared memory

    // O += P V: V's B fragments through ldmatrix.trans, four at a time
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int d0 = 0; d0 < D / 16; d0 += 4) {
        uint32_t bv[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ldsm_x4_trans(bv[j], smem_addr(vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                         (d0 + j) * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(acc[2 * (d0 + j)], pa[kk], bv[j][0], bv[j][1]);
          mma(acc[2 * (d0 + j) + 1], pa[kk], bv[j][2], bv[j][3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  // the two key halves merge: warps 2, 3 hand (m, l, acc) to warps 0, 1 of the
  // same rows through the K stages, which are free now; a fragment element
  // keeps its lane, so each lane moves 16 bytes per m16n8 tile
  float4* cacc = reinterpret_cast<float4*>(ks) + (warp & 1) * (D / 8) * 32 + lane;
  float4* cml = reinterpret_cast<float4*>(ks) + 2 * (D / 8) * 32 + (warp & 1) * 32 + lane;
  if (warp >= 2) {
    *cml = make_float4(m_lo, m_hi, l_lo, l_hi);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      cacc[n * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  }
  __syncthreads();
  if (warp >= 2) return;
  {
    const float4 ml = *cml;
    const float mn_lo = fmaxf(m_lo, ml.x), mn_hi = fmaxf(m_hi, ml.y);
    const float a_lo = __expf(m_lo - mn_lo), b_lo = __expf(ml.x - mn_lo);
    const float a_hi = __expf(m_hi - mn_hi), b_hi = __expf(ml.y - mn_hi);
    l_lo = l_lo * a_lo + ml.z * b_lo;
    l_hi = l_hi * a_hi + ml.w * b_hi;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float4 c = cacc[n * 32];
      acc[n][0] = acc[n][0] * a_lo + c.x * b_lo;
      acc[n][1] = acc[n][1] * a_lo + c.y * b_lo;
      acc[n][2] = acc[n][2] * a_hi + c.z * b_hi;
      acc[n][3] = acc[n][3] * a_hi + c.w * b_hi;
    }
  }

  // the warp's 16 output rows go through its own Q rows (no longer read), then
  // out with 16-byte stores; rows past S are not stored
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* ow = qs + r0 * RS;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(ow + (lane >> 2) * RS + c) =
        pack_bf16(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(ow + ((lane >> 2) + 8) * RS + c) =
        pack_bf16(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    const int p = q0 + r0 + r;
    if (p < S)
      *reinterpret_cast<uint4*>(og + (size_t)p * D + c * 8) =
          *reinterpret_cast<const uint4*>(ow + r * RS + c * 8);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S,
           int causal, int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_bf16<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq, Hkv, S, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Hq, int Hkv, int S, int D, int is_bf16,
                                   int causal, int window, float softcap, float scale,
                                   void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || S < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return is_bf16 ? tc::launch<128>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st)
                   : launch<float, 128>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st);
  if (D == 64)
    return is_bf16 ? tc::launch<64>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st)
                   : launch<float, 64>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st);
  if (D == 256)
    return is_bf16 ? tc::launch<256>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st)
                   : launch<float, 256>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
