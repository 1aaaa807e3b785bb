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
// element, so the least time is (bytes / 3.35 TB/s).
//
// Design, the simplest correct one: one thread per (b, r) channel walks the
// whole sequence, so the carry never leaves a register (the TPU kernel's
// block-to-block carry in VMEM scratch becomes the thread's loop).
// Consecutive threads take consecutive r, so each time step's loads and
// stores are coalesced.  The loads of a and x do not depend on h, so the loop
// reads UNROLL steps ahead before it updates, keeping that many loads in
// flight per thread.  The update is __fadd_rn(__fmul_rn(a, h), x): a multiply
// and an add, never contracted into an FMA, which equals the plain PyTorch
// version bit for bit.  Weak where B*R is small: at B = 1, R = 2560 only 20
// blocks of 128 threads run and the card's bandwidth is mostly idle; the TPU
// kernel's chunked superposition (h = local scan + cumprod(a) * carry) would
// fill it, and is left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan(const T* __restrict__ a, const T* __restrict__ x, const float* __restrict__ h0,
           float* __restrict__ out, long long S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const size_t base = (size_t)blockIdx.y * (size_t)S * R + r;
  float h = h0 != nullptr ? h0[(size_t)blockIdx.y * R + r] : 0.f;
  long long t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], xv[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const size_t o = base + (size_t)(t + i) * R;
      av[i] = to_f32(a[o]);
      xv[i] = to_f32(x[o]);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), xv[i]);
      out[base + (size_t)(t + i) * R] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t o = base + (size_t)t * R;
    h = __fadd_rn(__fmul_rn(to_f32(a[o]), h), to_f32(x[o]));
    out[o] = h;
  }
}

template <typename T>
int launch(const void* a, const void* x, const float* h0, float* out, int B, long long S, int R,
           cudaStream_t stream) {
  dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_scan<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(a), static_cast<const T*>(x),
                                              h0, out, S, R);
  return (int)cudaGetLastError();
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
