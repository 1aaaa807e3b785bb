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
// values and writes V log-probs per slot, with a few flops per element
// (7.3 us at qwen3's V = 151936, K = 4, S = 8).
//
// Design.  V is cut into chunks of CHUNK = 2048 elements; one block of 256
// threads takes one (chunk, slot) and stages its K x CHUNK tile of logits
// into shared memory with cp.async copies (16 bytes each where the rows are
// aligned), so a block holds few registers and five or more blocks share an
// SM: the 600 blocks of qwen3's call are resident at once.  The row-wide
// reductions cross blocks, so a call is two to six launches; stream order
// is the grid-wide barrier.  (A cooperative launch whose grid.sync keeps the
// tile on chip between the two passes fits at qwen3's V, not at V = 256000,
// whose tiles are 32.8 MB against 30 MB of shared memory on the card.  Built
// and measured on the H100, it was no faster in "probs" and barely faster in
// "logprobs": every block then waits at the barrier for the slowest.)
//   1. bma_stats: per (slot, chunk) and member, max then sum-exp over the
//      tile (one expf per element, the members reduced together);
//      "logprobs" instead the (max, sum-exp) of the member mean, since
//      log_softmax(mean_k lp_k) = mean_k l_k - logsumexp(mean_k l_k).
//   2. bma_mix: every block reduces its slot's partials in one fixed order
//      (so all blocks of a slot hold the same bits; their loads go out
//      ahead of the tile's), stages its tile again (the first launch left
//      the logits in the 50 MB L2), writes the mixture row and, from the
//      same values:
//        ARGMAX (greedy, or T > 0 without top-k): the chunk's first argmax
//          of mix (or of mix / T + gumbel), published and counted in before
//          the block's logp stores; the last block of the slot to count in
//          (an integer counter) picks the token;
//        TOPK (0 < top_k <= KCAP): the largest key of sel = mix / T in each
//          warp's 256 elements;
//        RADIX (top_k > KCAP): the chunk's histogram of the first radix
//          digit of sel; the last block picks the digit.
//   3. bma_radix (RADIX only, three launches): the next radix digit over
//      every chunk, the chunks' histograms merged by the last block.
//   4. bma_pick (top_k > 0).  TOPK: every block takes a lower bound L of the
//      row's threshold, the k-th largest chunk maximum of sel (k chunks
//      each hold a value >= L), or of the warp maxima where there are fewer
//      than k chunks, and appends its elements with sel > L (key,
//      sel + gumbel, index) to the slot's candidate list, about k of them,
//      plus, per warp holding elements at L, the one of them with the best
//      sel + gumbel (they all share sel); only these read their Gumbel
//      value.  The last block takes the row's threshold as the k-th
//      largest entry above L if there are k, else L (exact, duplicates
//      counted: every value above the threshold is listed, and at least k
//      values are >= L), and the first argmax of sel + gumbel among entries
//      at or above it.  If the list overflows (the top values crowded into
//      a few chunks), the last block selects over the whole row instead.
//      RADIX: mask below the threshold, add the Gumbel row, first argmax per
//      chunk; the last block picks the token.
// The per-element exponentials and logarithms use the hardware's approximate
// __expf / __logf (one MUFU op each, where expf takes several instructions
// more): the arguments are shifted to <= 0 first, so their relative error
// stays near 1e-6 against the 1e-4 check, and a "probs" call is then
// measurably shorter on the H100.
// Every cross-block reduction runs in a fixed order or is independent of
// order (integer counts, a max with ties to the smaller index); the only
// atomics are integer counters and list positions.  A k-th largest of at
// most 256 keys is one counting pass; above that, a radix select whose
// histograms are private per warp in shared memory, one atomic per group
// of lanes with equal bins (__match_any_sync), merged in a fixed order:
// values crowded into one binade do not serialize on one bin.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 2048;  // vocabulary elements per block: 256 threads x 2 x float4
constexpr int PER = 8;       // elements per thread
constexpr int MAX_K = 16;
constexpr int KG = 4;        // members whose chunk statistics are reduced together
constexpr int KCAP = 128;    // largest top_k of the candidate scheme
constexpr int BINS = 256;    // radix digit of 8 bits
constexpr int LIST = 4096;   // candidates per slot in global memory
constexpr int SLIST = 2048;  // candidates the last block holds in shared memory
constexpr int STATS_SMEM = 4096;  // chunk statistics (words) staged beside the mixture's tile

enum Sel { ARGMAX = 0, TOPK = 1, RADIX = 2 };

static_assert(CHUNK == THREADS * PER, "a chunk is one element set per thread");
static_assert(BINS == THREADS, "one bin per thread in the digit pick");

// element e of this thread's 8, as an offset inside the chunk: two float4s,
// at 4t and CHUNK/2 + 4t, so a warp's accesses are 512 contiguous bytes
__device__ __forceinline__ int elem_off(int e) {
  return (e >> 2) * (CHUNK / 2) + 4 * (int)threadIdx.x + (e & 3);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Issue the copies of logits[k, s, v0 .. v0 + CHUNK) for every member into
// tile[k][CHUNK]; elements past V are left unwritten (the readers mask
// them).  VEC: V % 4 == 0 and 16-byte aligned rows, so a float4 lies wholly
// inside or outside the row.
template <bool VEC>
__device__ __forceinline__ void stage_tile(float* tile, const float* __restrict__ logits, int K,
                                           int S, int s, int V, int v0) {
  for (int k = 0; k < K; ++k) {
    const float* row = logits + ((size_t)k * S + s) * V + v0;
    float* dst = tile + k * CHUNK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = elem_off(4 * h);
      if (VEC) {
        if (v0 + o < V) cp_async16(dst + o, row + o);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (v0 + o + j < V) cp_async4(dst + o + j, row + o + j);
      }
    }
  }
}

// this thread's 8 elements of tile row k (-inf past V)
__device__ __forceinline__ void read8(const float* trow, int n, float (&x)[PER]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = elem_off(4 * h);
    const float4 q = *reinterpret_cast<const float4*>(trow + o);
    x[4 * h] = o < n ? q.x : -INFINITY;
    x[4 * h + 1] = o + 1 < n ? q.y : -INFINITY;
    x[4 * h + 2] = o + 2 < n ? q.z : -INFINITY;
    x[4 * h + 3] = o + 3 < n ? q.w : -INFINITY;
  }
}

// this thread's 8 elements of row[v0 ..) from global memory (-inf past V)
template <bool VEC>
__device__ __forceinline__ void load8(const float* __restrict__ row, int v0, int V, float (&x)[PER]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = v0 + elem_off(4 * h);
    if (VEC) {
      float4 q = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (v < V) q = __ldg(reinterpret_cast<const float4*>(row + v));
      x[4 * h] = q.x;
      x[4 * h + 1] = q.y;
      x[4 * h + 2] = q.z;
      x[4 * h + 3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[4 * h + j] = v + j < V ? __ldg(row + v + j) : -INFINITY;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(float* __restrict__ row, int v0, int V, const float (&x)[PER]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = v0 + elem_off(4 * h);
    if (VEC) {
      if (v < V)
        *reinterpret_cast<float4*>(row + v) =
            make_float4(x[4 * h], x[4 * h + 1], x[4 * h + 2], x[4 * h + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v + j < V) row[v + j] = x[4 * h + j];
    }
  }
}

// N values reduced over the block, the result in every thread.  The xor
// butterfly gives every lane the same bits (a + b == b + a, max is exact),
// and the warps' partials are combined in warp order.
template <int N, bool MAX>
__device__ __forceinline__ void block_reduce(float (&v)[N], float* sred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float o = __shfl_xor_sync(0xffffffffu, v[i], off);
      v[i] = MAX ? fmaxf(v[i], o) : v[i] + o;
    }
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) sred[warp * N + i] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = sred[i];
    for (int w = 1; w < WARPS; ++w) v[i] = MAX ? fmaxf(v[i], sred[w * N + i]) : v[i] + sred[w * N + i];
  }
  __syncthreads();
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

// block-wide argmax; the result is valid in thread 0
__device__ void block_argmax(float& v, int& i) {
  __shared__ float sv[WARPS];
  __shared__ int si[WARPS];
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
    for (int w = 1; w < WARPS; ++w) better(v, i, sv[w], si[w]);
  }
}

// order-preserving image of a float as an unsigned key (larger float, larger key)
__device__ __forceinline__ unsigned f2key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// True in every thread of the one block of this slot that finishes last.
// A thread that wrote results for the last block fences them (`wrote`)
// before the count; the last block reads them with __ldcg, past L1.
__device__ bool arrive_last(unsigned* counter, int nblocks, bool wrote) {
  __shared__ bool last;
  if (wrote) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == (unsigned)(nblocks - 1);
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Radix-select scratch in shared memory.
struct RadixSmem {
  unsigned whist[WARPS][BINS];  // per-warp histograms
  unsigned wsum[WARPS];
  unsigned digit;
  int rem;
};

// The histogram, over keys fetch(i), i < n, whose bits under `mask` equal
// `prefix`, of the digit at `shift`.  Returns bin threadIdx.x's count.
template <typename Fetch>
__device__ unsigned block_hist(Fetch fetch, int n, unsigned prefix, unsigned mask, int shift,
                               RadixSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) (&sm.whist[0][0])[i] = 0u;
  __syncthreads();
  // the same trip count in every thread (whole warps for __match_any_sync);
  // keys fetched HB at a time, so that a fetch from global memory overlaps
  // the next ones
  constexpr int HB = 8;
  for (int base = 0; base < n; base += HB * THREADS) {
    const int i0 = base + (int)threadIdx.x;
    unsigned key[HB];
#pragma unroll
    for (int j = 0; j < HB; ++j) key[j] = i0 + j * THREADS < n ? fetch(i0 + j * THREADS) : 0u;
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      const bool ok = i0 + j * THREADS < n && (key[j] & mask) == prefix;
      const unsigned bin = ok ? (key[j] >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(&sm.whist[warp][bin], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  unsigned cnt = 0;
  for (int w = 0; w < WARPS; ++w) cnt += sm.whist[w][threadIdx.x];
  __syncthreads();
  return cnt;
}

// Given bin threadIdx.x's count, the digit d whose keys hold the rem-th
// largest: suffix(d) >= rem > suffix(d + 1).  Returns (digit, rem -
// suffix(d + 1)) in every thread.
__device__ void pick_digit(unsigned cnt, int rem, RadixSmem& sm, unsigned& digit, int& rem_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned suf = cnt;  // suffix sum within the warp: lanes >= this one
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_down_sync(0xffffffffu, suf, off);
    if (lane + off < 32) suf += y;
  }
  if (lane == 0) sm.wsum[warp] = suf;
  if (threadIdx.x == 0) {
    sm.digit = 0u;
    sm.rem = rem;
  }
  __syncthreads();
  for (int w = warp + 1; w < WARPS; ++w) suf += sm.wsum[w];
  const unsigned above = suf - cnt;  // suffix(d + 1)
  if (suf >= (unsigned)rem && above < (unsigned)rem) {
    sm.digit = threadIdx.x;
    sm.rem = rem - (int)above;
  }
  __syncthreads();
  digit = sm.digit;
  rem_out = sm.rem;
  __syncthreads();
}

// The k-th largest (1 <= k <= n) of the keys fetch(i), i < n, duplicates
// counted: four 8-bit radix passes.  The same in every thread.
template <typename Fetch>
__device__ unsigned block_kth_largest(Fetch fetch, int n, int k, RadixSmem& sm) {
  unsigned prefix = 0u, mask = 0u;
  int rem = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    const unsigned cnt = block_hist(fetch, n, prefix, mask, shift, sm);
    unsigned d;
    pick_digit(cnt, rem, sm, d, rem);
    prefix |= d << shift;
    mask |= 255u << shift;
  }
  return prefix;
}

// The k-th largest (1 <= k <= n) of keys[0 .. n), n <= THREADS, in shared
// memory: thread i counts the keys above and at its own; the key with
// fewer than k above and at least k at or above is the answer.  One pass of
// n broadcast reads, where the radix select makes four histogram passes.
__device__ unsigned block_kth_small(const unsigned* keys, int n, int k) {
  __shared__ unsigned res;
  if ((int)threadIdx.x < n) {
    const unsigned me = keys[threadIdx.x];
    int gt = 0, ge = 0;
    for (int j = 0; j < n; ++j) {
      const unsigned o = keys[j];
      gt += o > me;
      ge += o >= me;
    }
    if (gt < k && k <= ge) res = me;  // every thread that writes holds the same key
  }
  __syncthreads();
  const unsigned r = res;
  __syncthreads();
  return r;
}

// The scratch buffer, in 4-byte words, per call: see scratch_words.
struct Scratch {
  float* stats;       // [S][C][2K] (max, sum-exp) per member, or of the mean
  float* cand_v;      // [S][C] chunk argmax value
  int* cand_i;        // [S][C] chunk argmax index
  unsigned* wmax;     // [S][C][WARPS] largest sel key of each warp's elements
  unsigned* hist;     // [S][C][BINS] radix histograms
  unsigned* lkey;     // [S][LIST] candidate keys
  float* lval;        // [S][LIST] candidate sel + gumbel
  int* lidx;          // [S][LIST] candidate indices
  unsigned* state;    // [S][4] radix prefix, mask, remaining (one word unused)
  float* thresh;      // [S] top-k threshold of sel (RADIX)
  unsigned* counter;  // [S] blocks of the slot done in this launch
  unsigned* nlist;    // [S] candidates appended
};

__host__ __device__ inline long long scratch_words(int K, int S, int C) {
  return (long long)S * C * (2 * K + 2 + WARPS + BINS) + (long long)S * (3 * LIST + 7);
}

__host__ __device__ inline Scratch carve(void* base, int K, int S, int C) {
  Scratch sc;
  unsigned* w = static_cast<unsigned*>(base);
  const long long sc_ = (long long)S * C;
  sc.stats = reinterpret_cast<float*>(w);
  w += sc_ * 2 * K;
  sc.cand_v = reinterpret_cast<float*>(w);
  w += sc_;
  sc.cand_i = reinterpret_cast<int*>(w);
  w += sc_;
  sc.wmax = w;
  w += sc_ * WARPS;
  sc.hist = w;
  w += sc_ * BINS;
  sc.lkey = w;
  w += (long long)S * LIST;
  sc.lval = reinterpret_cast<float*>(w);
  w += (long long)S * LIST;
  sc.lidx = reinterpret_cast<int*>(w);
  w += (long long)S * LIST;
  sc.state = w;
  w += 4LL * S;
  sc.thresh = reinterpret_cast<float*>(w);
  w += S;
  sc.counter = w;
  w += S;
  sc.nlist = w;
  return sc;
}

// ---------------------------------------------------------------------------
// 1. per (slot, chunk): member (max, sum-exp), or those of the member mean
// ---------------------------------------------------------------------------

// KT > 0: the member count, fixed at compile time (the main path's K = 4),
// so the member loops unroll; KT = 0: any K up to MAX_K.
template <bool VEC, bool LOGPROBS, int KT>
__global__ void __launch_bounds__(THREADS)
bma_stats(const float* __restrict__ logits, Scratch sc, int K_, int S, int V) {
  extern __shared__ __align__(16) float tile[];  // [K][CHUNK]
  __shared__ float sred[WARPS * KG];
  const int K = KT > 0 ? KT : K_;
  const int c = blockIdx.x, s = blockIdx.y, C = gridDim.x, v0 = c * CHUNK;
  const int n = min(CHUNK, V - v0);
  if (c == 0 && threadIdx.x == 0) {
    sc.counter[s] = 0u;
    sc.nlist[s] = 0u;
  }
  stage_tile<VEC>(tile, logits, K, S, s, V, v0);
  cp_async_wait_all();
  __syncthreads();
  float* out = sc.stats + ((size_t)s * C + c) * 2 * K;
  if (LOGPROBS) {
    float w[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) w[e] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x[PER];
      read8(tile + k * CHUNK, n, x);
#pragma unroll
      for (int e = 0; e < PER; ++e) w[e] += x[e];
    }
    float m[1] = {-INFINITY};
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      w[e] = w[e] / (float)K;
      m[0] = fmaxf(m[0], w[e]);
    }
    block_reduce<1, true>(m, sred);
    float l[1] = {0.f};
#pragma unroll
    for (int e = 0; e < PER; ++e) l[0] += w[e] == -INFINITY ? 0.f : __expf(w[e] - m[0]);
    block_reduce<1, false>(l, sred);
    if (threadIdx.x == 0) {
      out[0] = m[0];
      out[1] = l[0];
    }
    return;
  }
  // members in groups of KG, each group's maxima and then sums reduced together
  for (int k0 = 0; k0 < K; k0 += KG) {
    float m[KG], l[KG];
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      m[j] = -INFINITY;
      if (k0 + j < K) {
        float x[PER];
        read8(tile + (k0 + j) * CHUNK, n, x);
#pragma unroll
        for (int e = 0; e < PER; ++e) m[j] = fmaxf(m[j], x[e]);
      }
    }
    block_reduce<KG, true>(m, sred);
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      l[j] = 0.f;
      if (k0 + j < K) {
        float x[PER];
        read8(tile + (k0 + j) * CHUNK, n, x);
#pragma unroll
        for (int e = 0; e < PER; ++e) l[j] += x[e] == -INFINITY ? 0.f : __expf(x[e] - m[j]);
      }
    }
    block_reduce<KG, false>(l, sred);
    if (threadIdx.x == 0)
#pragma unroll
      for (int j = 0; j < KG; ++j)  // constant indices keep m and l in registers
        if (k0 + j < K) {
          out[2 * (k0 + j)] = m[j];
          out[2 * (k0 + j) + 1] = l[j];
        }
  }
}

// logsumexp over the C chunk partials (m, l) at stride `stride` in src:
// one warp, lanes over chunks, a fixed order; the same bits in every block
// that calls it on the same data
__device__ float warp_lse(const float* src, int C, int stride) {
  float M = -INFINITY;
  for (int c = threadIdx.x & 31; c < C; c += 32) M = fmaxf(M, src[(size_t)c * stride]);
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (M == -INFINITY) return -INFINITY;
  float l = 0.f;
  for (int c = threadIdx.x & 31; c < C; c += 32) {
    const float m = src[(size_t)c * stride];
    if (m != -INFINITY) l += src[(size_t)c * stride + 1] * expf(m - M);
  }
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  return M + logf(l);
}

// Thread 0 publishes the block's chunk argmax and counts the block in; the
// fence waits on those two words only if the thread has stored nothing else
// yet.  Returns, in thread 0, whether this is the slot's last block.
__device__ bool publish_argmax(const Scratch& sc, int s, int C, int c, float best, int idx) {
  sc.cand_v[(size_t)s * C + c] = best;
  sc.cand_i[(size_t)s * C + c] = idx;
  __threadfence();
  return atomicAdd(sc.counter + s, 1u) == (unsigned)(C - 1);
}

// Warp 0 of the slot's last block: the first argmax over the chunk
// candidates (in any order: ties go to the smaller index), then the token.
// `last` is valid in lane 0; the other warps need not wait.
__device__ void finish_argmax(const Scratch& sc, int s, int C, int* tok, bool last) {
  if (threadIdx.x >= 32 || !__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  float best = -INFINITY;
  int idx = -1;
  for (int c = threadIdx.x; c < C; c += 32)
    better(best, idx, __ldcg(sc.cand_v + (size_t)s * C + c), __ldcg(sc.cand_i + (size_t)s * C + c));
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
    better(best, idx, v2, i2);
  }
  if (threadIdx.x == 0) {
    tok[s] = idx < 0 ? 0 : idx;
    sc.counter[s] = 0u;
  }
}

// The last block of a slot: merge the chunks' histograms in chunk order and
// pick the digit at `shift`; after the last digit, write the threshold.
__device__ void merge_digit(const Scratch& sc, int s, int C, int shift, unsigned prefix,
                            unsigned mask, int rem, RadixSmem& rs) {
  unsigned cnt = 0;
  for (int c = 0; c < C; ++c) cnt += __ldcg(sc.hist + ((size_t)s * C + c) * BINS + threadIdx.x);
  unsigned d;
  pick_digit(cnt, rem, rs, d, rem);
  if (threadIdx.x == 0) {
    prefix |= d << shift;
    mask |= 255u << shift;
    sc.state[4 * s] = prefix;
    sc.state[4 * s + 1] = mask;
    sc.state[4 * s + 2] = (unsigned)rem;
    if (shift == 0) sc.thresh[s] = key2f(prefix);
    sc.counter[s] = 0u;
  }
}

// ---------------------------------------------------------------------------
// 2. the mixture row, and the first selection step from the same values
// ---------------------------------------------------------------------------

template <bool VEC, bool LOGPROBS, int SEL, int KT>
__global__ void __launch_bounds__(THREADS)
bma_mix(const float* __restrict__ logits, const float* __restrict__ gumbel, float* __restrict__ logp,
        int* __restrict__ tok, Scratch sc, int K_, int S, int V, float temperature, int top_k) {
  extern __shared__ __align__(16) float tile[];  // [K][CHUNK]
  __shared__ float slogz[MAX_K];
  const int K = KT > 0 ? KT : K_;
  const int c = blockIdx.x, s = blockIdx.y, C = gridDim.x, v0 = c * CHUNK;
  const int n = min(CHUNK, V - v0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the slot's chunk statistics come in with the tile (into shared memory
  // behind it, if they fit), then reduce to logZ_k or the mean's logsumexp
  const int nst = C * 2 * K;
  const float* st = sc.stats + (size_t)s * nst;
  if (nst <= STATS_SMEM) {
    float* sst = tile + K * CHUNK;
    for (int i = threadIdx.x; i < nst; i += THREADS) cp_async4(sst + i, st + i);
    st = sst;
  }
  stage_tile<VEC>(tile, logits, K, S, s, V, v0);
  cp_async_wait_all();
  __syncthreads();
  for (int k = warp; k < (LOGPROBS ? 1 : K); k += WARPS) {
    const float lz = warp_lse(st + 2 * k, C, 2 * K);
    if (lane == 0) slogz[k] = lz;
  }
  __syncthreads();

  float out[PER];
  if (LOGPROBS) {
#pragma unroll
    for (int e = 0; e < PER; ++e) out[e] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x[PER];
      read8(tile + k * CHUNK, n, x);
#pragma unroll
      for (int e = 0; e < PER; ++e) out[e] += x[e];
    }
    const float lse = slogz[0];
#pragma unroll
    for (int e = 0; e < PER; ++e) out[e] = out[e] / (float)K - lse;
  } else {
    // logsumexp over the members of lp_k = l_k - logZ_k, shifted by their max
    float mk[PER], se[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      mk[e] = -INFINITY;
      se[e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x[PER];
      read8(tile + k * CHUNK, n, x);
      const float lz = slogz[k];
#pragma unroll
      for (int e = 0; e < PER; ++e) mk[e] = fmaxf(mk[e], x[e] - lz);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x[PER];
      read8(tile + k * CHUNK, n, x);
      const float lz = slogz[k];
#pragma unroll
      for (int e = 0; e < PER; ++e) se[e] += __expf(x[e] - lz - mk[e]);  // NaN only where mk = -inf
    }
    const float logk = logf((float)K);
#pragma unroll
    for (int e = 0; e < PER; ++e)
      out[e] = mk[e] == -INFINITY ? -INFINITY : mk[e] + __logf(se[e]) - logk;
  }
  if (SEL == ARGMAX) {
    const bool sample = temperature > 0.f;
    float g[PER];
    if (sample) load8<VEC>(gumbel + (size_t)s * V, v0, V, g);
    float best = -INFINITY;
    int idx = -1;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int o = elem_off(e);
      if (o < n) better(best, idx, sample ? out[e] / temperature + g[e] : out[e], v0 + o);
    }
    block_argmax(best, idx);
    // the chunk's result goes out before thread 0's own logp stores, the
    // other warps' stores meanwhile; only warp 0 waits for the count
    const bool last = threadIdx.x == 0 && publish_argmax(sc, s, C, c, best, idx);
    store8<VEC>(logp + (size_t)s * V, v0, V, out);
    finish_argmax(sc, s, C, tok, last);
    return;
  }

  store8<VEC>(logp + (size_t)s * V, v0, V, out);
  unsigned keys[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) keys[e] = elem_off(e) < n ? f2key(out[e] / temperature) : 0u;

  if (SEL == RADIX) {  // this launch takes the first of four digits
    __shared__ RadixSmem rs;
    const int k_eff = min(top_k, V);
    __syncthreads();   // every thread is done with the tile: reuse it for the keys
    unsigned* skey = reinterpret_cast<unsigned*>(tile);
#pragma unroll
    for (int e = 0; e < PER; ++e) skey[elem_off(e)] = keys[e];
    __syncthreads();
    const unsigned cnt = block_hist([&](int i) { return skey[i]; }, n, 0u, 0u, 24, rs);
    sc.hist[((size_t)s * C + c) * BINS + threadIdx.x] = cnt;
    if (arrive_last(sc.counter + s, C, true)) merge_digit(sc, s, C, 24, 0u, 0u, k_eff, rs);
    return;
  }

  // TOPK: each warp's largest key of sel; the pick pass takes its bound from them
  unsigned wm = 0u;
#pragma unroll
  for (int e = 0; e < PER; ++e) wm = max(wm, keys[e]);
  wm = __reduce_max_sync(0xffffffffu, wm);
  if (lane == 0) sc.wmax[((size_t)s * C + c) * WARPS + warp] = wm;
}

// ---------------------------------------------------------------------------
// 3. (RADIX) the next radix digit of sel over the whole row
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
bma_radix(const float* __restrict__ logp, Scratch sc, int V, float temperature, int shift) {
  __shared__ unsigned skey[CHUNK];
  __shared__ RadixSmem rs;
  const int c = blockIdx.x, s = blockIdx.y, C = gridDim.x, v0 = c * CHUNK;
  const unsigned prefix = sc.state[4 * s], mask = sc.state[4 * s + 1];
  const int rem = (int)sc.state[4 * s + 2];
  float x[PER];
  load8<VEC>(logp + (size_t)s * V, v0, V, x);
#pragma unroll
  for (int e = 0; e < PER; ++e) skey[elem_off(e)] = f2key(x[e] / temperature);
  __syncthreads();
  const int n = min(CHUNK, V - v0);
  const unsigned cnt = block_hist([&](int i) { return skey[i]; }, n, prefix, mask, shift, rs);
  sc.hist[((size_t)s * C + c) * BINS + threadIdx.x] = cnt;
  if (arrive_last(sc.counter + s, C, true)) merge_digit(sc, s, C, shift, prefix, mask, rem, rs);
}

// ---------------------------------------------------------------------------
// 4. (top_k > 0) mask below the threshold, add the Gumbel row, first argmax
// ---------------------------------------------------------------------------

// The last block of a TOPK slot whose candidates overflowed: the threshold
// and the token over the whole row (slow; only rows of wide ties get here).
template <bool VEC>
__device__ void pick_whole_row(const float* __restrict__ logp, const float* __restrict__ gumbel,
                               int* tok, int s, int V, float temperature, int k_eff, RadixSmem& rs) {
  const float* row = logp + (size_t)s * V;
  const unsigned th = block_kth_largest([&](int i) { return f2key(row[i] / temperature); }, V,
                                        k_eff, rs);
  float best = -INFINITY;
  int idx = -1;
#pragma unroll 8
  for (int i = threadIdx.x; i < V; i += THREADS) {
    const float v = row[i] / temperature;
    if (f2key(v) >= th) better(best, idx, v + gumbel[(size_t)s * V + i], i);
  }
  block_argmax(best, idx);
  if (threadIdx.x == 0) tok[s] = idx < 0 ? 0 : idx;
}

template <bool VEC, int SEL>
__global__ void __launch_bounds__(THREADS)
bma_pick(const float* __restrict__ logp, const float* __restrict__ gumbel, int* __restrict__ tok,
         Scratch sc, int V, float temperature, int top_k) {
  const int c = blockIdx.x, s = blockIdx.y, C = gridDim.x, v0 = c * CHUNK;
  const int n = min(CHUNK, V - v0);
  float x[PER];
  load8<VEC>(logp + (size_t)s * V, v0, V, x);
  if (SEL == RADIX) {
    float g[PER];
    load8<VEC>(gumbel + (size_t)s * V, v0, V, g);
    const float th = sc.thresh[s];
    float best = -INFINITY;
    int idx = -1;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int o = elem_off(e);
      float v = x[e] / temperature;
      if (v < th) v = -INFINITY;
      if (o < n) better(best, idx, v + g[e], v0 + o);
    }
    block_argmax(best, idx);
    finish_argmax(sc, s, C, tok, threadIdx.x == 0 && publish_argmax(sc, s, C, c, best, idx));
    return;
  }
  // TOPK: the bound L, the k-th largest chunk maximum of sel (k chunks hold a
  // value >= L, so the row's threshold is >= L), or of the warp maxima where
  // there are fewer than k chunks, or none.  Every block computes it from the
  // same keys, so all hold the same L.
  __shared__ unsigned skey[SLIST];
  __shared__ float sval[SLIST];
  __shared__ int sidx[SLIST];
  __shared__ RadixSmem rs;
  const int k_eff = min(top_k, V);
  const unsigned* wmax = sc.wmax + (size_t)s * C * WARPS;
  const int nb = C >= k_eff ? C : (C * WARPS >= k_eff ? C * WARPS : 0);
  for (int i = threadIdx.x; i < nb; i += THREADS) {
    unsigned key;
    if (nb == C) {
      key = 0u;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) key = max(key, wmax[(size_t)i * WARPS + w]);
    } else {
      key = wmax[i];
    }
    if (nb <= SLIST) skey[i] = key;
  }
  __syncthreads();
  unsigned L = 0u;
  if (nb > 0 && nb <= THREADS)
    L = block_kth_small(skey, nb, k_eff);
  else if (nb > 0 && nb <= SLIST)
    L = block_kth_largest([&](int i) { return skey[i]; }, nb, k_eff, rs);
  else if (nb > 0)
    L = block_kth_largest([&](int i) { return wmax[i]; }, nb, k_eff, rs);

  // append every element with key > L to the slot's list (positions in any
  // order: what the last block computes from the list does not depend on
  // it), one atomic per warp that has any; of the elements with key == L,
  // which all hold the same sel, only each warp's best sel + gumbel: if the
  // threshold is L they are all kept, and the token is the best of them, so
  // a row of wide ties at L appends one entry per warp
  const int lane = threadIdx.x & 31;
  unsigned keys[PER];
  int mine = 0;
  bool at_l = false;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    keys[e] = f2key(x[e] / temperature);
    mine += elem_off(e) < n && keys[e] > L;
    at_l |= elem_off(e) < n && keys[e] == L;
  }
  int before = mine;  // inclusive prefix over the warp's lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, before, off);
    if (lane >= off) before += y;
  }
  const int total = __shfl_sync(0xffffffffu, before, 31);
  unsigned base = 0;
  if (lane == 31 && total > 0) base = atomicAdd(sc.nlist + s, (unsigned)total);
  unsigned pos = __shfl_sync(0xffffffffu, base, 31) + (unsigned)(before - mine);
  bool wrote = false;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int o = elem_off(e);
    if (o < n && keys[e] > L) {
      if (pos < (unsigned)LIST) {
        const float v = x[e] / temperature;
        sc.lkey[(size_t)s * LIST + pos] = keys[e];
        sc.lval[(size_t)s * LIST + pos] = v + __ldg(gumbel + (size_t)s * V + v0 + o);
        sc.lidx[(size_t)s * LIST + pos] = v0 + o;
        wrote = true;
      }
      ++pos;
    }
  }
  if (__any_sync(0xffffffffu, at_l)) {  // warp-uniform: some element of the warp sits at L
    float tb = -INFINITY;
    int ti = -1;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int o = elem_off(e);
      if (o < n && keys[e] == L)
        better(tb, ti, x[e] / temperature + __ldg(gumbel + (size_t)s * V + v0 + o), v0 + o);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, tb, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, ti, off);
      better(tb, ti, v2, i2);
    }
    if (lane == 0) {
      const unsigned q = atomicAdd(sc.nlist + s, 1u);
      if (q < (unsigned)LIST) {
        sc.lkey[(size_t)s * LIST + q] = L;
        sc.lval[(size_t)s * LIST + q] = tb;
        sc.lidx[(size_t)s * LIST + q] = ti;
        wrote = true;
      }
    }
  }
  if (!arrive_last(sc.counter + s, C, wrote)) return;

  // the last block: the threshold is the k-th largest of the entries above L
  // where there are k of them, else L (at least k values are >= L); the
  // token is the first argmax of sel + gumbel among entries at or above it
  const unsigned m = __ldcg(sc.nlist + s);
  if (m > (unsigned)SLIST) {
    pick_whole_row<VEC>(logp, gumbel, tok, s, V, temperature, k_eff, rs);
  } else {
    for (int i = threadIdx.x; i < (int)m; i += THREADS) {
      skey[i] = __ldcg(sc.lkey + (size_t)s * LIST + i);
      sval[i] = __ldcg(sc.lval + (size_t)s * LIST + i);
      sidx[i] = __ldcg(sc.lidx + (size_t)s * LIST + i);
    }
    __syncthreads();
    // the entries at L rank below every entry above it, so over all entries
    // the k-th largest is the k-th of those above L when there are k of them
    int above = 0;
    for (int b = 0; b < (int)m; b += THREADS)
      above += __syncthreads_count(b + (int)threadIdx.x < (int)m && skey[b + threadIdx.x] > L);
    unsigned th = L;
    if (above >= k_eff)
      th = (int)m <= THREADS ? block_kth_small(skey, (int)m, k_eff)
                             : block_kth_largest([&](int i) { return skey[i]; }, (int)m, k_eff, rs);
    float best = -INFINITY;
    int idx = -1;
    for (int i = threadIdx.x; i < (int)m; i += THREADS)
      if (skey[i] >= th) better(best, idx, sval[i], sidx[i]);
    block_argmax(best, idx);
    if (threadIdx.x == 0) tok[s] = idx < 0 ? 0 : idx;
  }
  if (threadIdx.x == 0) {
    sc.counter[s] = 0u;
    sc.nlist[s] = 0u;
  }
}

// Let the kernel take `smem` bytes of dynamic shared memory: K x 8 KB of
// tile (and the mixture's chunk statistics), past the 48 KB default from
// K = 6 on.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool VEC, bool LOGPROBS, int SEL, int KT>
int launch_mix(const float* logits, const float* gumbel, float* logp, int* tok, Scratch sc, int K,
               int S, int V, float temperature, int top_k, dim3 grid, size_t smem, cudaStream_t st) {
  const cudaError_t e = allow_smem(bma_mix<VEC, LOGPROBS, SEL, KT>, smem);
  if (e != cudaSuccess) return (int)e;
  bma_mix<VEC, LOGPROBS, SEL, KT><<<grid, THREADS, smem, st>>>(logits, gumbel, logp, tok, sc, K, S,
                                                               V, temperature, top_k);
  return (int)cudaGetLastError();
}

template <bool VEC, bool LOGPROBS, int KT>
int run_k(const float* logits, const float* gumbel, float* logp, int* tok, Scratch sc, int K, int S,
          int V, float temperature, int top_k, cudaStream_t st) {
  const int C = (V + CHUNK - 1) / CHUNK;
  const dim3 grid(C, S);
  const size_t smem = (size_t)K * CHUNK * sizeof(float);
  const int nst = C * 2 * K;
  const size_t smem_mix = smem + (nst <= STATS_SMEM ? (size_t)nst * sizeof(float) : 0);
  cudaError_t e = allow_smem(bma_stats<VEC, LOGPROBS, KT>, smem);
  if (e != cudaSuccess) return (int)e;
  bma_stats<VEC, LOGPROBS, KT><<<grid, THREADS, smem, st>>>(logits, sc, K, S, V);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int sel = temperature > 0.f && top_k > 0 ? (top_k > KCAP ? RADIX : TOPK) : ARGMAX;
  int rc;
  if (sel == ARGMAX)
    rc = launch_mix<VEC, LOGPROBS, ARGMAX, KT>(logits, gumbel, logp, tok, sc, K, S, V,
                                               temperature, top_k, grid, smem_mix, st);
  else if (sel == TOPK)
    rc = launch_mix<VEC, LOGPROBS, TOPK, KT>(logits, gumbel, logp, tok, sc, K, S, V, temperature,
                                             top_k, grid, smem_mix, st);
  else
    rc = launch_mix<VEC, LOGPROBS, RADIX, KT>(logits, gumbel, logp, tok, sc, K, S, V,
                                              temperature, top_k, grid, smem_mix, st);
  if (rc != 0 || sel == ARGMAX) return rc;
  if (sel == RADIX) {
    for (int shift = 16; shift >= 0; shift -= 8)
      bma_radix<VEC><<<grid, THREADS, 0, st>>>(logp, sc, V, temperature, shift);
    bma_pick<VEC, RADIX><<<grid, THREADS, 0, st>>>(logp, gumbel, tok, sc, V, temperature, top_k);
  } else {
    bma_pick<VEC, TOPK><<<grid, THREADS, 0, st>>>(logp, gumbel, tok, sc, V, temperature, top_k);
  }
  return (int)cudaGetLastError();
}

template <bool VEC, bool LOGPROBS>
int run_mode(const float* logits, const float* gumbel, float* logp, int* tok, Scratch sc, int K,
             int S, int V, float temperature, int top_k, cudaStream_t st) {
  return K == 4 ? run_k<VEC, LOGPROBS, 4>(logits, gumbel, logp, tok, sc, K, S, V, temperature, top_k, st)
                : run_k<VEC, LOGPROBS, 0>(logits, gumbel, logp, tok, sc, K, S, V, temperature, top_k, st);
}

template <bool VEC>
int run(const float* logits, const float* gumbel, float* logp, int* tok, Scratch sc, int K, int S,
        int V, int mode_logprobs, float temperature, int top_k, cudaStream_t st) {
  return mode_logprobs
             ? run_mode<VEC, true>(logits, gumbel, logp, tok, sc, K, S, V, temperature, top_k, st)
             : run_mode<VEC, false>(logits, gumbel, logp, tok, sc, K, S, V, temperature, top_k, st);
}

}  // namespace

// scratch: at least scratch_words(K, S, C) 4-byte words, allocated by the
// wrapper (kernels/bma_select.py::scratch_words computes the same count)
extern "C" int bma_select_fwd(const float* logits, const float* gumbel, float* logp, int* tok,
                              void* scratch, long long scratch_len, int K, int S, int V,
                              int mode_logprobs, float temperature, int top_k, void* stream) {
  if (K < 1 || K > MAX_K || S < 1 || S > 65535 || V < 1 || top_k < 0)
    return (int)cudaErrorInvalidValue;
  if (temperature > 0.f && gumbel == nullptr) return (int)cudaErrorInvalidValue;
  const int C = (V + CHUNK - 1) / CHUNK;
  if (scratch_len < scratch_words(K, S, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch sc = carve(scratch, K, S, C);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = V % 4 == 0 && aligned(logits) && aligned(logp) &&
                   (gumbel == nullptr || aligned(gumbel));
  return vec ? run<true>(logits, gumbel, logp, tok, sc, K, S, V, mode_logprobs, temperature, top_k, st)
             : run<false>(logits, gumbel, logp, tok, sc, K, S, V, mode_logprobs, temperature, top_k, st);
}
