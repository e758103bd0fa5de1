// Shared device helpers for the smoltts kernels: Philox4x32-10 counter-based
// random numbers, the Gumbel transform, dtype loads, and block-wide
// reductions (max, sum, argmax with ties to the lowest index).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace smoltts {

// ---- Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC'11). Key = 64-bit seed, counter = 4 words chosen by the caller.
struct U4 { uint32_t x, y, z, w; };

__device__ __forceinline__ U4 philox4x32_10(U4 ctr, uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = U4{hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0};
    k0 += W0;
    k1 += W1;
  }
  return ctr;
}

// The one word-to-Gumbel mapping of the repo: the top 23 bits of a Philox
// word at their bin centre, u = (k + 0.5) * 2^-23. Every such u is exact in
// f32 and lies inside (0, 1), so the noise is always finite (with 24 bits the
// `+ 0.5` of the last bin rounds u to 1 and gives +inf). Accurate `logf`.
__device__ __forceinline__ float gumbel_word(uint32_t w) {
  const float u = ((float)(w >> 9) + 0.5f) * (1.0f / 8388608.0f);
  return -logf(-logf(u));
}

// Standard Gumbel noise for element `col` of stream (a, b), from the first
// word of one Philox call. `seed` holds {seed, offset} as two int64 on the
// device.
__device__ __forceinline__ float gumbel(const long long* seed, uint32_t col, uint32_t a,
                                        uint32_t b) {
  const unsigned long long s = (unsigned long long)seed[0];
  const unsigned long long off = (unsigned long long)seed[1];
  U4 c{col, a, b, (uint32_t)off};
  U4 r = philox4x32_10(c, (uint32_t)s, (uint32_t)(s >> 32));
  return gumbel_word(r.x);
}

// ---- dtype helpers
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to the compute dtype and back (the cast at a matmul input).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// ---- block reductions (blockDim.x a multiple of 32, at most 1024)
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// `scratch` holds 32 floats.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[wid] = v;
  __syncthreads();
  v = lane < nw ? scratch[lane] : -INFINITY;
  return warp_max(v);
}
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[wid] = v;
  __syncthreads();
  v = lane < nw ? scratch[lane] : 0.f;
  return warp_sum(v);
}

// (value, index) pair that wins: larger value, then lower index. NaN never wins
// over a number.
__device__ __forceinline__ void arg_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i) || (v != v && v2 == v2)) {
    v = v2;
    i = i2;
  }
}
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    arg_better(v, i, v2, i2);
  }
}
// `sv` holds 32 floats, `si` 32 ints. Every thread gets the winning index.
__device__ __forceinline__ int block_argmax(float v, int i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  warp_argmax(v, i);
  __syncthreads();
  if (lane == 0) {
    sv[wid] = v;
    si[wid] = i;
  }
  __syncthreads();
  if (lane < nw) {
    v = sv[lane];
    i = si[lane];
  } else {
    v = -INFINITY;
    i = 0x7fffffff;
  }
  warp_argmax(v, i);
  return i;
}

}  // namespace smoltts
