// Bayesian-model-averaging mixture + token selection over K members, for sm_90a.
//
// Replaces: repro/kernels/bma_select.py::_bma_select_kernel (Pallas, TPU).
// Computes what it computes, per slot s:
//   lp_k   = log_softmax(logits[k, s, :])                     (f32)
//   "probs":    mix = logsumexp_k(lp_k) - log K
//   "logprobs": mix = log_softmax(mean_k lp_k)
//   logp[s, :] = mix
//   greedy (T <= 0):  tok = first argmax of mix
//   else:  sel = mix / T; with top_k, sel < (k-th largest sel, duplicates
//          counted) -> -inf, ties at the threshold kept; tok = first
//          argmax of sel + gumbel[s, :] (the caller's draw).
//
// What bounds it on this card: bytes.  It reads K*V logits and V Gumbel
// values and writes V log-probs per slot, with a few flops per element.
//
// Design: a row is K*V*4 bytes (2.4 MB for qwen3's V = 151936 at K = 4), ten
// times a block's 227 KB of shared memory, so the Pallas kernel's one tile
// per slot cannot carry over; and one block per slot would leave most of
// the 132 SMs idle at 8 slots.  V is split into chunks of `chunk` elements,
// one block per (chunk, slot), over passes that exchange small partials
// through a scratch buffer (each cross-chunk reduction is done in a fixed
// order, so every block of a slot sees the same bits):
//   1. member_stats: per (slot, chunk, member) max and sum-exp;
//   2. mixture: reduce to logZ_k, write the mixture row ("logprobs": the
//      unnormalised mean, plus its per-chunk max and sum-exp);
//   3. normalize ("logprobs" only): subtract the row's logsumexp;
//   4. topk_threshold (T > 0 and top_k > 0): one block per slot finds the
//      k-th largest sel by a 4-pass, 8-bit radix select over the
//      order-preserving uint32 image of the float, which counts duplicates
//      exactly;
//   5. select_partial: per (slot, chunk) max of the selection value and its
//      first index;
//   6. select_final: reduce the chunk candidates to the first argmax.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int SELECT_THREADS = 1024;
constexpr int MAX_K = 16;

// online (max, sum-exp) pair merge; an empty side has m = -inf, l = 0
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    l = l2;
    return;
  }
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// block-wide merge of per-thread (m, l); the result is valid in thread 0
__device__ void block_merge(float& m, float& l) {
  __shared__ float sm[32], sl[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  __syncthreads();
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = sm[0];
    l = sl[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) merge(m, l, sm[w], sl[w]);
  }
}

// (value, index) argmax merge: larger value wins, equal values take the
// smaller index; index -1 marks an empty side
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (i2 < 0) return;
  if (i < 0 || v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ void block_argmax(float& v, int& i) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    better(v, i, v2, i2);
  }
  __syncthreads();
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    v = sv[0];
    i = si[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) better(v, i, sv[w], si[w]);
  }
}

__device__ __forceinline__ unsigned f2key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// pass 1: stats[(s*C + c)*K + k] = (max, sum-exp) of logits[k, s, chunk c]
__global__ void member_stats(const float* __restrict__ logits, float* __restrict__ stats, int K,
                             int S, int V, int chunk) {
  const int c = blockIdx.x, s = blockIdx.y, C = gridDim.x;
  const int v0 = c * chunk, v1 = min(V, v0 + chunk);
  for (int k = 0; k < K; ++k) {
    const float* row = logits + ((size_t)k * S + s) * V;
    float m = -INFINITY, l = 0.f;
    for (int v = v0 + threadIdx.x; v < v1; v += blockDim.x) merge(m, l, row[v], 1.f);
    block_merge(m, l);
    if (threadIdx.x == 0) {
      float* out = stats + (((size_t)s * C + c) * K + k) * 2;
      out[0] = m;
      out[1] = l;
    }
    __syncthreads();
  }
}

// pass 2: the mixture row; for "logprobs" also the chunk's (max, sum-exp)
__global__ void mixture(const float* __restrict__ logits, const float* __restrict__ stats,
                        float* __restrict__ logp, float* __restrict__ row_stats, int K, int S,
                        int V, int chunk, int mode_logprobs) {
  __shared__ float logz[MAX_K];
  const int c = blockIdx.x, s = blockIdx.y, C = gridDim.x;
  if (threadIdx.x < K) {
    const int k = threadIdx.x;
    float m = -INFINITY, l = 0.f;
    for (int cc = 0; cc < C; ++cc) {
      const float* st = stats + (((size_t)s * C + cc) * K + k) * 2;
      merge(m, l, st[0], st[1]);
    }
    logz[k] = m + logf(l);
  }
  __syncthreads();
  const int v0 = c * chunk, v1 = min(V, v0 + chunk);
  const float logk = logf((float)K);
  float rm = -INFINITY, rl = 0.f;
  for (int v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
    float out;
    if (mode_logprobs) {
      float sum = 0.f;
      for (int k = 0; k < K; ++k) sum += logits[((size_t)k * S + s) * V + v] - logz[k];
      out = sum / (float)K;
      merge(rm, rl, out, 1.f);
    } else {
      float mk = -INFINITY;
      for (int k = 0; k < K; ++k) mk = fmaxf(mk, logits[((size_t)k * S + s) * V + v] - logz[k]);
      float se = 0.f;
      for (int k = 0; k < K; ++k) se += expf(logits[((size_t)k * S + s) * V + v] - logz[k] - mk);
      out = mk + logf(se) - logk;
    }
    logp[(size_t)s * V + v] = out;
  }
  if (mode_logprobs) {
    block_merge(rm, rl);
    if (threadIdx.x == 0) {
      row_stats[((size_t)s * C + c) * 2] = rm;
      row_stats[((size_t)s * C + c) * 2 + 1] = rl;
    }
  }
}

// pass 3 ("logprobs"): logp -= logsumexp of the row
__global__ void normalize(float* __restrict__ logp, const float* __restrict__ row_stats, int V,
                          int chunk) {
  __shared__ float lse;
  const int c = blockIdx.x, s = blockIdx.y, C = gridDim.x;
  if (threadIdx.x == 0) {
    float m = -INFINITY, l = 0.f;
    for (int cc = 0; cc < C; ++cc)
      merge(m, l, row_stats[((size_t)s * C + cc) * 2], row_stats[((size_t)s * C + cc) * 2 + 1]);
    lse = m + logf(l);
  }
  __syncthreads();
  const int v0 = c * chunk, v1 = min(V, v0 + chunk);
  for (int v = v0 + threadIdx.x; v < v1; v += blockDim.x) logp[(size_t)s * V + v] -= lse;
}

// pass 4: thresh[s] = the top_k-th largest of logp[s, :] / T, duplicates counted
__global__ void topk_threshold(const float* __restrict__ logp, float* __restrict__ thresh, int V,
                               float temperature, int top_k) {
  __shared__ unsigned hist[256];
  __shared__ unsigned prefix, mask;
  __shared__ int remaining;
  const int s = blockIdx.x;
  const float* row = logp + (size_t)s * V;
  if (threadIdx.x == 0) {
    prefix = 0u;
    mask = 0u;
    remaining = min(top_k, V);
  }
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
    const unsigned pf = prefix, mk = mask;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      const unsigned key = f2key(row[v] / temperature);
      if ((key & mk) == pf) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int k = remaining;
      int digit = 0;
      for (int d = 255; d >= 0; --d) {
        if ((int)hist[d] >= k) {
          digit = d;
          break;
        }
        k -= (int)hist[d];
      }
      remaining = k;
      prefix = pf | ((unsigned)digit << shift);
      mask = mk | (255u << shift);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) thresh[s] = key2f(prefix);
}

// pass 5: per-(slot, chunk) max of the selection value and its first index
__global__ void select_partial(const float* __restrict__ logp, const float* __restrict__ gumbel,
                               const float* __restrict__ thresh, float* __restrict__ cand_v,
                               int* __restrict__ cand_i, int V, int chunk, float temperature,
                               int top_k) {
  const int c = blockIdx.x, s = blockIdx.y, C = gridDim.x;
  const int v0 = c * chunk, v1 = min(V, v0 + chunk);
  const bool sample = temperature > 0.f;
  const float th = (sample && top_k > 0) ? thresh[s] : -INFINITY;
  float best = -INFINITY;
  int idx = -1;
  for (int v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
    float x = logp[(size_t)s * V + v];
    if (sample) {
      x = x / temperature;
      if (x < th) x = -INFINITY;
      x = x + gumbel[(size_t)s * V + v];
    }
    better(best, idx, x, v);
  }
  block_argmax(best, idx);
  if (threadIdx.x == 0) {
    cand_v[(size_t)s * C + c] = best;
    cand_i[(size_t)s * C + c] = idx;
  }
}

// pass 6: one warp per slot reduces the chunk candidates in index order
__global__ void select_final(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                             int* __restrict__ tok, int C) {
  const int s = blockIdx.x;
  float best = -INFINITY;
  int idx = -1;
  for (int c = threadIdx.x; c < C; c += 32)
    better(best, idx, cand_v[(size_t)s * C + c], cand_i[(size_t)s * C + c]);
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
    better(best, idx, v2, i2);
  }
  if (threadIdx.x == 0) tok[s] = idx < 0 ? 0 : idx;
}

}  // namespace

// scratch layout (floats): stats S*C*K*2 | row_stats S*C*2 | cand_v S*C | thresh S
extern "C" int bma_select_fwd(const float* logits, const float* gumbel, float* logp, int* tok,
                              float* scratch, int* iscratch, int K, int S, int V, int chunk,
                              int mode_logprobs, float temperature, int top_k, void* stream) {
  if (K < 1 || K > MAX_K || S < 1 || V < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  if (temperature > 0.f && gumbel == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = (V + chunk - 1) / chunk;
  float* stats = scratch;
  float* row_stats = stats + (size_t)S * C * K * 2;
  float* cand_v = row_stats + (size_t)S * C * 2;
  float* thresh = cand_v + (size_t)S * C;
  const dim3 grid(C, S);
  member_stats<<<grid, THREADS, 0, st>>>(logits, stats, K, S, V, chunk);
  mixture<<<grid, THREADS, 0, st>>>(logits, stats, logp, row_stats, K, S, V, chunk, mode_logprobs);
  if (mode_logprobs) normalize<<<grid, THREADS, 0, st>>>(logp, row_stats, V, chunk);
  if (temperature > 0.f && top_k > 0)
    topk_threshold<<<S, SELECT_THREADS, 0, st>>>(logp, thresh, V, temperature, top_k);
  select_partial<<<grid, THREADS, 0, st>>>(logp, gumbel, thresh, cand_v, iscratch, V, chunk,
                                           temperature, top_k);
  select_final<<<S, 32, 0, st>>>(cand_v, iscratch, tok, C);
  return (int)cudaGetLastError();
}
