// Causal blocked (flash) attention forward for sm_90a.
//
// Replaces: repro/kernels/flash_attention.py::_flash_kernel (Pallas, TPU).
// Computes what it computes: softmax(q k^T * scale [softcap] [causal/window
// mask]) v with the online-softmax recurrence in f32, GQA through the kv head
// h / G, output in q's dtype, acc / max(l, 1e-30).
//
// What bounds it on this card: at prefill shapes (S = 64..128, d = 128,
// Hq = 16) the work is ~4*S^2*d*Hq flops on ~4*S*d*Hq*2 bytes, i.e. about S
// flops per byte; against the H100's ~295 flops/byte ridge that is bytes-
// bound on paper, but this simple kernel runs its products on the CUDA cores
// in f32 (no wgmma), so in practice it is bound by f32 FMA throughput and by
// launch overhead at these small grids.
//
// Design: one block per (b, q head, 64-row q tile); the TPU's sequential k
// grid axis becomes a loop inside the block over 64-row k/v tiles held in
// shared memory (f32, row stride d+1 so the score loop is bank-conflict
// free).  Four threads share a query row: each computes 16 of the tile's 64
// scores and owns d/4 accumulator columns in registers; the row max/sum are
// reduced with warp shuffles.  Causal and sliding-window limits skip whole k
// tiles, as the Pallas kernel's pl.when does.  Masked scores contribute
// exactly 0.  Tensor cores, TMA and pipelining are left for later work.
//
// Head dims: D = 64, 128 and 256 are instantiated (smaller heads are
// zero-padded by the wrapper).  At D = 256 (recurrentgemma-2b) the four
// shared tiles take 4 * (64*257 + 64*257 + 64*256 + 64*65) = 213,760 bytes,
// under the 232,448-byte opt-in, so one block runs per SM, and each thread
// holds 64 f32 accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 per query row
constexpr int COLS_PER_THREAD = BK / 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Hq, int Hkv, int S, int D, int is_bf16,
                                   int causal, int window, float softcap, float scale,
                                   void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st)
                   : launch<float, 128>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st);
  if (D == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st)
                   : launch<float, 64>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st);
  if (D == 256)
    return is_bf16 ? launch<__nv_bfloat16, 256>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st)
                   : launch<float, 256>(q, k, v, o, B, Hq, Hkv, S, causal, window, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
