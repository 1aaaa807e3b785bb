// RG-LRU linear recurrence for sm_90a: h_t = a_t * h_{t-1} + x_t per channel.
//
// Replaces: repro/kernels/rglru.py::_rglru_kernel (Pallas, TPU).  Computes
// what it computes: the scan over the sequence axis of (B, S, R) inputs, in
// f32 whatever the input type, with an optional (B, R) carry h0 before step
// 0, output (B, S, R) f32.  Unlike the Pallas kernel it takes any S (no
// S % block_s == 0) and any R.
//
// What bounds it on this card: bytes.  a and x are read once and h written
// once, 12 bytes per element in f32 (8 in bf16), one multiply and one add per
// element, so the least time is (bytes / 3.35 TB/s).  The recurrence itself
// is a dependent multiply-then-add chain of ~8 cycles per step, while one
// step's bytes across R = 2560 channels take ~17 cycles at 3.35 TB/s: a strictly
// sequential scan per channel can reach the byte bound if enough loads are in
// flight, so the TPU kernel's chunked superposition (h = local scan +
// cumprod(a) * carry), which would change the rounding, is not needed.
//
// Design: one warp per block owns a strip of STRIP = 16 channels of one batch
// row (160 blocks at B = 1, R = 2560), so each time step's strip segment is
// 64 bytes in f32 (two 32-byte sectors) or 32 in bf16.  The warp stages tiles
// of [TILE steps x STRIP channels] of a and x into a ring of STAGES tiles in
// shared memory with 16-byte cp.async copies (cache-global, with an L2
// prefetch of 256 bytes, so a row's neighbouring strips come in one DRAM
// burst), keeping STAGES - 1 tiles in flight: 28 KB a block in f32, ~4.6 MB
// across the card at B = 1.  Lanes 0..15 each run one channel's recurrence
// out of shared memory, in the same order as the plain version:
// __fadd_rn(__fmul_rn(a, h), x), never contracted into an FMA, so the result
// equals the plain PyTorch version bit for bit.  h is stored straight from
// the lanes, 16 consecutive floats per step (coalesced).
//
// The backward (rglru_scan_bwd) replaces no Pallas kernel: the reference's
// gradient of the scan is XLA's autodiff of jax.lax.associative_scan.  It is
// the same recurrence run backwards in time, g_t = dh_t + a_{t+1} * g_{t+1},
// with dx_t = g_t, da_t = g_t * h_{t-1} (h_{-1} = h0 or 0) and dh0 = a_0 * g_0,
// in the plain version's order (ref.rglru_scan_bwd), so it too is bitwise.
// Bound: bytes.  a, dh and the forward's h are read once and da and dx
// written once, 20 bytes per element in f32.  The design is the forward's
// with time reversed: one warp per 16-channel strip, a ring of cp.async
// tiles of a, h and dh (three streams: BWD_STAGES = 6 tiles of 6 KB, 36 KB
// a block, under the 48 KB static limit), staged from the last tile to the
// first.  A lane keeps a_{t+1} and g_{t+1} in registers from the step
// before, and writes da_{t+1} = g_{t+1} * h_t at step t, when it reads h_t,
// so every stream is read at the tile's own steps and no tile needs a
// neighbour's row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 16;  // channels per block (lanes 0..15 scan)
constexpr int TILE = 32;   // time steps per staged tile
constexpr int STAGES = 8;  // tiles in the ring; STAGES - 1 in flight
constexpr int UNROLL = 8;  // steps read from shared memory ahead of the chain

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// VEC: a and x are staged with 16-byte copies, lane l copying piece l % PPR
// of rows l / PPR + j * RPP of a tile; its source pointers are set up once,
// so a copy costs one address add and staging does not crowd the warp's
// instruction stream.  Otherwise (R not a multiple of 16 / sizeof(T), or an
// unaligned pointer) the tiles are staged with plain loads.
template <typename T, bool VEC>
__global__ void __launch_bounds__(32)
rglru_scan(const T* __restrict__ a, const T* __restrict__ x, const float* __restrict__ h0,
           float* __restrict__ out, long long S, int R) {
  constexpr int EPP = 16 / (int)sizeof(T);  // elements per 16-byte piece
  constexpr int PPR = STRIP / EPP;          // pieces per row
  constexpr int RPP = 32 / PPR;             // rows one warp-wide pass of copies covers
  __shared__ __align__(16) T sa[STAGES * TILE * STRIP];
  __shared__ __align__(16) T sx[STAGES * TILE * STRIP];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * STRIP, nch = min(STRIP, R - r0);
  const size_t base = (size_t)blockIdx.y * (size_t)S * R + r0;
  const long long ntiles = (S + TILE - 1) / TILE;
  const int prow = lane / PPR, pcol = (lane % PPR) * EPP;  // this lane's piece
  const bool live = pcol < nch;  // nch is a multiple of EPP when VEC
  const T* ga = a + base + (size_t)prow * R + pcol;
  const T* gx = x + base + (size_t)prow * R + pcol;
  const size_t pass = (size_t)RPP * R;
  auto stage = [&](long long t, int slot) {  // steps [t * TILE, (t + 1) * TILE) into a ring slot
    const long long t0 = t * TILE;
    const int steps = (int)min((long long)TILE, S - t0);
    T* da = sa + slot * TILE * STRIP;
    T* dx = sx + slot * TILE * STRIP;
    if (VEC) {
      if (!live) return;
      const T* pa = ga + (size_t)t0 * R;
      const T* px = gx + (size_t)t0 * R;
#pragma unroll
      for (int j = 0; j < TILE / RPP; ++j)
        if (prow + j * RPP < steps) {
          cp_async16(da + (prow + j * RPP) * STRIP + pcol, pa + j * pass);
          cp_async16(dx + (prow + j * RPP) * STRIP + pcol, px + j * pass);
        }
    } else {
      for (int q = lane; q < steps * STRIP; q += 32) {
        const int i = q / STRIP, c = q % STRIP;
        if (c < nch) {
          const size_t o = base + (size_t)(t0 + i) * R + c;
          da[i * STRIP + c] = a[o];
          dx[i * STRIP + c] = x[o];
        }
      }
    }
  };
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < ntiles) stage(p, p);
    cp_async_commit();
  }
  const bool mine = lane < nch;
  float h = (mine && h0 != nullptr) ? h0[(size_t)blockIdx.y * R + r0 + lane] : 0.f;
  // Full tiles in a loop with no other path in it: with the partial tile's
  // loop beside it, the compiler kept fewer shared-memory reads ahead of
  // the chain (70 registers against 144) and a long scan ran markedly
  // slower on the H100.
  const long long nfull = S / TILE;
  for (long long tile = 0; tile < ntiles; ++tile) {
    // tile's copies (this lane's) are done; the warp barrier makes every
    // lane's visible and ends the reads of the slot the next copy reuses
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    const long long next = tile + STAGES - 1;
    if (next < ntiles) stage(next, (int)(next % STAGES));
    cp_async_commit();
    if (!mine || tile == nfull) continue;
    const int slot = (int)(tile % STAGES);
    const T* A = sa + slot * TILE * STRIP + lane;
    const T* X = sx + slot * TILE * STRIP + lane;
    float* o = out + base + (size_t)tile * TILE * R + lane;
#pragma unroll
    for (int i = 0; i < TILE; i += UNROLL) {
      float av[UNROLL], xv[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        av[j] = to_f32(A[(i + j) * STRIP]);
        xv[j] = to_f32(X[(i + j) * STRIP]);
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        h = __fadd_rn(__fmul_rn(av[j], h), xv[j]);
        o[(size_t)(i + j) * R] = h;
      }
    }
  }
  if (mine && nfull < ntiles) {  // the last, partial tile: its copies were waited for above
    const T* A = sa + (int)(nfull % STAGES) * TILE * STRIP + lane;
    const T* X = sx + (int)(nfull % STAGES) * TILE * STRIP + lane;
    float* o = out + base + (size_t)nfull * TILE * R + lane;
    const int steps = (int)(S - nfull * TILE);
    for (int i = 0; i < steps; ++i) {
      h = __fadd_rn(__fmul_rn(to_f32(A[i * STRIP]), h), to_f32(X[i * STRIP]));
      o[(size_t)i * R] = h;
    }
  }
}

template <typename T>
int launch(const void* a, const void* x, const float* h0, float* out, int B, long long S, int R,
           cudaStream_t stream) {
  const dim3 grid((R + STRIP - 1) / STRIP, B);
  const bool vec = R % (16 / (int)sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const T* at = static_cast<const T*>(a);
  const T* xt = static_cast<const T*>(x);
  const auto kern = vec ? rglru_scan<T, true> : rglru_scan<T, false>;
  kern<<<grid, 32, 0, stream>>>(at, xt, h0, out, S, R);
  return (int)cudaGetLastError();
}

constexpr int BWD_STAGES = 6;  // the backward stages three streams

// The backward kernel, f32 only (the wrapper casts a and dh).  VEC as in
// the forward: 16-byte cp.async copies when R % 4 == 0 and every pointer is
// 16-byte aligned, else plain loads.
template <bool VEC>
__global__ void __launch_bounds__(32)
rglru_scan_grad(const float* __restrict__ a, const float* __restrict__ h,
                const float* __restrict__ dh, const float* __restrict__ h0,
                float* __restrict__ da, float* __restrict__ dx, float* __restrict__ dh0,
                long long S, int R) {
  constexpr int EPP = 4, PPR = STRIP / EPP, RPP = 32 / PPR;
  constexpr int TS = TILE * STRIP;
  __shared__ __align__(16) float sa[BWD_STAGES * TS];
  __shared__ __align__(16) float sh[BWD_STAGES * TS];
  __shared__ __align__(16) float sd[BWD_STAGES * TS];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * STRIP, nch = min(STRIP, R - r0);
  const size_t base = (size_t)blockIdx.y * (size_t)S * R + r0;
  const long long ntiles = (S + TILE - 1) / TILE;
  const int prow = lane / PPR, pcol = (lane % PPR) * EPP;
  const bool live = pcol < nch;
  const size_t off = base + (size_t)prow * R + pcol;
  const size_t pass = (size_t)RPP * R;
  // the q-th tile in processing order is tile ntiles - 1 - q in time
  auto stage = [&](long long q, int slot) {
    const long long t0 = (ntiles - 1 - q) * TILE;
    const int steps = (int)min((long long)TILE, S - t0);
    float* ta = sa + slot * TS;
    float* th = sh + slot * TS;
    float* td = sd + slot * TS;
    if (VEC) {
      if (!live) return;
      const size_t o = off + (size_t)t0 * R;
#pragma unroll
      for (int j = 0; j < TILE / RPP; ++j)
        if (prow + j * RPP < steps) {
          const int so = (prow + j * RPP) * STRIP + pcol;
          cp_async16(ta + so, a + o + j * pass);
          cp_async16(th + so, h + o + j * pass);
          cp_async16(td + so, dh + o + j * pass);
        }
    } else {
      for (int e = lane; e < steps * STRIP; e += 32) {
        const int i = e / STRIP, c = e % STRIP;
        if (c < nch) {
          const size_t o = base + (size_t)(t0 + i) * R + c;
          ta[i * STRIP + c] = a[o];
          th[i * STRIP + c] = h[o];
          td[i * STRIP + c] = dh[o];
        }
      }
    }
  };
#pragma unroll
  for (int p = 0; p < BWD_STAGES - 1; ++p) {
    if (p < ntiles) stage(p, p);
    cp_async_commit();
  }
  const bool mine = lane < nch;
  // g = -0 and a_{t+1} = 0 before the last step make its g exactly dh_{S-1}
  // (-0 + v == v for every v, -0 included)
  float g = -0.f, an = 0.f;
  float* pda = da + base + lane;
  float* pdx = dx + base + lane;
  for (long long q = 0; q < ntiles; ++q) {
    cp_async_wait<BWD_STAGES - 2>();
    __syncwarp();
    const long long next = q + BWD_STAGES - 1;
    if (next < ntiles) stage(next, (int)(next % BWD_STAGES));
    cp_async_commit();
    if (!mine) continue;
    const int slot = (int)(q % BWD_STAGES);
    const float* A = sa + slot * TS + lane;
    const float* H = sh + slot * TS + lane;
    const float* D = sd + slot * TS + lane;
    const long long t0 = (ntiles - 1 - q) * TILE;
    if (q == 0) {  // the last tile in time, maybe partial: no da_S to write
      const int steps = (int)(S - t0);
      for (int i = steps - 1; i >= 0; --i) {
        const long long t = t0 + i;
        if (t + 1 < S) pda[(size_t)(t + 1) * R] = __fmul_rn(g, H[i * STRIP]);
        g = __fadd_rn(__fmul_rn(an, g), D[i * STRIP]);
        pdx[(size_t)t * R] = g;
        an = A[i * STRIP];
      }
      continue;
    }
#pragma unroll
    for (int i = TILE - UNROLL; i >= 0; i -= UNROLL) {
      float av[UNROLL], hv[UNROLL], dv[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        av[j] = A[(i + j) * STRIP];
        hv[j] = H[(i + j) * STRIP];
        dv[j] = D[(i + j) * STRIP];
      }
#pragma unroll
      for (int j = UNROLL - 1; j >= 0; --j) {
        const size_t o = (size_t)(t0 + i + j) * R;
        pda[o + R] = __fmul_rn(g, hv[j]);
        g = __fadd_rn(__fmul_rn(an, g), dv[j]);
        pdx[o] = g;
        an = av[j];
      }
    }
  }
  if (mine) {
    const size_t hr = (size_t)blockIdx.y * R + r0 + lane;
    pda[0] = __fmul_rn(g, h0 != nullptr ? h0[hr] : 0.f);
    if (dh0 != nullptr) dh0[hr] = __fmul_rn(an, g);
  }
}

}  // namespace

extern "C" int rglru_scan_fwd(const void* a, const void* x, const void* h0, void* out, int B,
                              long long S, int R, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h0);
  float* o = static_cast<float*>(out);
  return is_bf16 ? launch<__nv_bfloat16>(a, x, h, o, B, S, R, st)
                 : launch<float>(a, x, h, o, B, S, R, st);
}

extern "C" int rglru_scan_bwd(const void* a, const void* h, const void* dh, const void* h0,
                              void* da, void* dx, void* dh0, int B, long long S, int R,
                              void* stream) {
  if (B < 1 || B > 65535 || S < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + STRIP - 1) / STRIP, B);
  const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dh) % 16 == 0;
  const auto kern = vec ? rglru_scan_grad<true> : rglru_scan_grad<false>;
  kern<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h), static_cast<const float*>(dh),
      static_cast<const float*>(h0), static_cast<float*>(da), static_cast<float*>(dx),
      static_cast<float*>(dh0), S, R);
  return (int)cudaGetLastError();
}
