// Single-query GQA decode attention over a split KV cache: a frozen history
// (int8 with per-vector k/v scales, or the compute dtype) plus a ring tail in
// the compute dtype.
//
// Replaces the Pallas kernel smoltts_tpu/ops/attention.py::_decode_attn_kernel
// (launched by decode_attention_pallas) and covers the tailed kv8 contract the
// JAX main path computes with XLA (decode_attention_tailed): history
// positions [0, min(flushed[b], lim)) plus tail columns whose tail_pos lies
// in [flushed[b], pos[b]]. Keys dequantize through the logits, values through
// the probabilities. The contiguous form is the same kernel with W = 0 and
// flushed = pos + 1.
//
// Bound on an H100: bytes. At B=64, 4 kv heads, hd 64, lim 256, W 128, kv8,
// one call reads 4.2 MB of history (k, v, scales) and 4.2 MB of bf16 tail:
// ~2.5 us at 3.35 TB/s; the arithmetic (2 * 12 heads * 64 * 384 FMAs per row)
// is negligible.
// Design: one 256-thread block per (kv head, row). The 3 query heads of the
// group are loaded once into shared memory. Pass 1: one thread per cache
// position computes the group's logits with 16-byte loads of its key row and
// keeps them in shared memory (lim + W floats per head, so no online
// rescaling is needed). Block reductions give max and sum per head. Pass 2:
// threads own one head-dim column each and walk a quarter of the positions,
// reading value rows coalesced; partial sums meet in shared memory. All
// arithmetic is f32; the output is rounded once to the compute dtype.
#include "common.cuh"

using namespace smoltts;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 8;
constexpr int kMaxHd = 128;

// Load n (= hd) elements of a row into f32 registers, 16 bytes at a time.
template <typename E>
__device__ __forceinline__ float dot_row(const E* __restrict__ row, const float* q, int hd) {
  float acc = 0.f;
  constexpr int per = 16 / sizeof(E);
  for (int d0 = 0; d0 < hd; d0 += per) {
    uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
    const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
    for (int j = 0; j < per; ++j) acc += q[d0 + j] * to_f(e[j]);
  }
  return acc;
}

template <typename T, typename HT, bool KV8>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const HT* __restrict__ k_hist,
                   const HT* __restrict__ v_hist, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, long long hsb, long long hsh, long long ssb,
                   long long ssh, const T* __restrict__ k_tail, const T* __restrict__ v_tail,
                   const int* __restrict__ pos, const int* __restrict__ flushed,
                   const int* __restrict__ tail_pos, T* __restrict__ out, int H, int n_kv, int hd,
                   int lim, int W) {
  extern __shared__ float lg[];  // [G][lim + W] logits, then probabilities
  __shared__ float qs[kMaxGroup][kMaxHd];
  __shared__ float red[32];
  __shared__ float part_acc[4][kMaxGroup][kMaxHd / 2 + 1];  // 4 = kThreads / min hd

  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / n_kv;
  const int stride = lim + W;
  const float scale = rsqrtf((float)hd);
  const int p_b = pos[b], f_b = flushed[b];
  const int n_h = max(0, min(f_b, lim));

  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    int g = i / hd, d = i % hd;
    qs[g][d] = to_f(q[((long long)b * H + h * G + g) * hd + d]);
  }
  __syncthreads();

  const HT* kh = k_hist + b * hsb + h * hsh;
  const HT* vh = v_hist + b * hsb + h * hsh;
  const float* ksc = KV8 ? k_scale + b * ssb + h * ssh : nullptr;
  const float* vsc = KV8 ? v_scale + b * ssb + h * ssh : nullptr;
  const T* kt = k_tail + ((long long)b * n_kv + h) * W * hd;
  const T* vt = v_tail + ((long long)b * n_kv + h) * W * hd;
  const int* tp = tail_pos + (long long)b * W;

  // Pass 1: logits.
  for (int s = threadIdx.x; s < n_h + W; s += blockDim.x) {
    if (s < n_h) {
      const HT* row = kh + (long long)s * hd;
      for (int g = 0; g < G; ++g) {
        float l = dot_row(row, qs[g], hd) * scale;
        if (KV8) l *= ksc[s];
        lg[g * stride + s] = l;
      }
    } else {
      const int w = s - n_h;
      const int t = tp[w];
      const bool ok = t >= 0 && t >= f_b && t <= p_b;
      const T* row = kt + (long long)w * hd;
      for (int g = 0; g < G; ++g)
        lg[g * stride + s] = ok ? dot_row(row, qs[g], hd) * scale : -INFINITY;
    }
  }
  __syncthreads();

  // Softmax per head (f32).
  for (int g = 0; g < G; ++g) {
    float m = -INFINITY;
    for (int s = threadIdx.x; s < n_h + W; s += blockDim.x) m = fmaxf(m, lg[g * stride + s]);
    m = block_max(m, red);
    float sum = 0.f;
    for (int s = threadIdx.x; s < n_h + W; s += blockDim.x) {
      float e = lg[g * stride + s] == -INFINITY ? 0.f : expf(lg[g * stride + s] - m);
      lg[g * stride + s] = e;
      sum += e;
    }
    sum = block_sum(sum, red);
    for (int s = threadIdx.x; s < n_h + W; s += blockDim.x) {
      float p = lg[g * stride + s] / sum;
      if (KV8 && s < n_h) p *= vsc[s];
      lg[g * stride + s] = p;
    }
    __syncthreads();
  }

  // Pass 2: out[g][d] = sum_s p[g][s] * v[s][d].
  const int nparts = blockDim.x / hd;  // hd divides blockDim (checked on the host)
  const int d = threadIdx.x % hd, part = threadIdx.x / hd;
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  if (part < nparts) {
    for (int s = part; s < n_h + W; s += nparts) {
      float v;
      if (s < n_h) {
        v = to_f(vh[(long long)s * hd + d]);
      } else {
        v = to_f(vt[(long long)(s - n_h) * hd + d]);
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] += lg[g * stride + s] * v;
    }
  }
  // Combine the parts: two halves of hd at a time to bound shared memory.
  for (int half = 0; half < hd; half += kMaxHd / 2) {
    const bool mine = part < nparts && d >= half && d < half + kMaxHd / 2;
    if (mine && part > 0)
      for (int g = 0; g < G; ++g) part_acc[part][g][d - half] = acc[g];
    __syncthreads();
    if (mine && part == 0) {
      for (int g = 0; g < G; ++g) {
        float a = acc[g];
        for (int pp = 1; pp < nparts; ++pp) a += part_acc[pp][g][d - half];
        out[((long long)b * H + h * G + g) * hd + d] = from_f<T>(a);
      }
    }
    __syncthreads();
  }
}

template <typename T, typename HT, bool KV8>
int launch(const void* q, const void* kh, const void* vh, const float* ks, const float* vs,
           long long hsb, long long hsh, long long ssb, long long ssh, const void* kt,
           const void* vt, const int* pos, const int* flushed, const int* tail_pos, void* out,
           int B, int H, int n_kv, int hd, int lim, int W, cudaStream_t stream) {
  const int G = H / n_kv;
  const size_t smem = (size_t)G * (lim + W) * sizeof(float);
  auto kern = decode_attn_kernel<T, HT, KV8>;
  if (smem + 16 * 1024 > 48 * 1024) {  // static shared memory is ~12.5 KB
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_kv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const HT*)kh, (const HT*)vh, ks, vs, hsb, hsh, ssb, ssh, (const T*)kt,
      (const T*)vt, pos, flushed, tail_pos, (T*)out, H, n_kv, hd, lim, W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, tail, out). hist: 0 = same as dtype, 1 = int8
// with f32 scales.
extern "C" int smoltts_decode_attention(const void* q, const void* k_hist, const void* v_hist,
                                        const float* k_scale, const float* v_scale,
                                        long long hsb, long long hsh, long long ssb,
                                        long long ssh, const void* k_tail, const void* v_tail,
                                        const int* pos, const int* flushed, const int* tail_pos,
                                        void* out, int B, int H, int n_kv, int hd, int lim,
                                        int W, int dtype, int hist, cudaStream_t stream) {
  (void)cudaGetLastError();
  if (H % n_kv != 0 || H / n_kv > kMaxGroup || hd > kMaxHd || kThreads % hd != 0 ||
      kThreads / hd > 4 || hd % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
#define SMOLTTS_ATTN_ARGS                                                                   \
  q, k_hist, v_hist, k_scale, v_scale, hsb, hsh, ssb, ssh, k_tail, v_tail, pos, flushed, \
      tail_pos, out, B, H, n_kv, hd, lim, W, stream
  if (dtype == 1 && hist == 1) return launch<__nv_bfloat16, int8_t, true>(SMOLTTS_ATTN_ARGS);
  if (dtype == 1 && hist == 0) return launch<__nv_bfloat16, __nv_bfloat16, false>(SMOLTTS_ATTN_ARGS);
  if (dtype == 0 && hist == 1) return launch<float, int8_t, true>(SMOLTTS_ATTN_ARGS);
  if (dtype == 0 && hist == 0) return launch<float, float, false>(SMOLTTS_ATTN_ARGS);
#undef SMOLTTS_ATTN_ARGS
  return (int)cudaErrorInvalidValue;
}
