// Slow-token sampler (K3): the whole slow-token site of a frame in one launch.
//
// Replaces the Pallas kernel smoltts_tpu/ops/sampling.py::_sample_kernel
// (launched by sample_categorical_pallas) and, around it, the rest of the
// site in smoltts_tpu/lm/decode.py::_frame_from_hidden: the cast to f32, the
// optional constrain_logits_to_audio, sample_token (temperature, min-p and
// categorical, or argmax at temperature 0) and where(finished, im_end, .).
// Per row: l = the logits (f32 or bf16), -inf outside {im_end} U [sem_lo,
// sem_hi] when the window is on; greedy: argmax(l); else s = l / T (IEEE
// division, as the JAX code), keep s >= max(s) + log(min_p), and take
// argmax(s + Gumbel). Ties go to the lowest index, NaN never wins, a row
// with no candidate gives 0, and a finished row gives im_end.
//
// Noise: Philox4x32-10 keyed by the seed, counter {col / 4, row, "SAMP",
// offset}; word col % 4 is column col's draw, so one call serves four
// columns and is skipped when none of them survives min-p. u = (top 23 bits
// + 0.5) / 2^23 lies strictly inside (0, 1). Both logs are the accurate
// logf: the draws that win have u near 1, where log(u) ~ 1e-7 and __logf's
// absolute error (~2^-21) would distort them.
//
// Bound on an H100: bytes. A [64, 2368] bf16 read is 303 KB, 0.09 us at
// 3.35 TB/s, far below one launch, so the kernel is bound by latency and the
// design targets latency and launches: one block per row reads its row once,
// each thread issuing all of its 16-byte loads before using any (the values
// stay in registers; rows too long for them take a chunked two-pass loop,
// rows that are not 16-byte aligned a scalar one); the min-p max is taken on
// the raw logits (division by T > 0 is monotone), so no division runs on a
// column that l * (1/T) rules out; survivors are walked by bit mask, so a
// warp pays for the most survivor groups any of its lanes holds; one block
// max and one argmax reduction over packed (score, column) keys, two
// barriers in all.
#include "common.cuh"

// Threads per block (one block per row): 320, ten warps, holds the 296
// 16-byte vectors of a 2368-column bf16 row one per thread (f32: two).
// scripts/torch_k3_threads.py measured it faster than 128, 256 and 512 on
// the H100 at B = 1 and 64, f32 and bf16, greedy and sampled (PERF.md).
#ifndef SMOLTTS_K3_THREADS
#define SMOLTTS_K3_THREADS 320
#endif

using namespace smoltts;

namespace {

constexpr uint32_t kSamplerStream = 0x53414D50u;  // "SAMP"
constexpr int kThreads = SMOLTTS_K3_THREADS;
constexpr int kWarps = kThreads / 32;
// 16-byte vectors a thread keeps in registers: a 2368-column row takes one
// (bf16) or two (f32); longer rows are walked in chunks of two.
constexpr int kMaxVectors = 2;
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block size");

struct Params {
  const void* logits;
  long long ld;  // row stride in elements
  int V;
  float temp;  // <= 0: greedy
  float log_min_p;
  int use_min_p;
  int use_window, sem_lo, sem_hi, im_end;
  const unsigned char* finished;  // [B] bool or null
  const long long* seed;          // {seed, offset}; read only when sampling
  int* out;
};

// (score, column) as one 64-bit key whose unsigned order is the argmax
// order: the larger score, then the lower column. NaN gives 0, which every
// candidate beats; -0 counts as +0 (they tie, as in torch.argmax).
__device__ __forceinline__ unsigned long long arg_key(float v, int c) {
  const uint32_t u = __float_as_uint(v + 0.0f);
  const uint32_t ord = u ^ ((uint32_t)((int32_t)u >> 31) | 0x80000000u);
  return v == v ? ((unsigned long long)ord << 32) | (uint32_t)~c : 0ull;
}

__device__ __forceinline__ unsigned long long max_key(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

template <typename T> __device__ __forceinline__ void unpack(const uint4& r, float* x);
template <> __device__ __forceinline__ void unpack<float>(const uint4& r, float* x) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r, float* x) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// Column of a thread's i-th value in the chunk that starts at `base`: its
// k-th vector of E columns is vector threadIdx.x + k * kThreads.
template <int E> __device__ __forceinline__ int col_of(int base, int i) {
  return base + (threadIdx.x + (i / E) * kThreads) * E + i % E;
}

// Load one chunk of the row (VPT vectors a thread, all loads issued before
// any value is used), apply the window in place, and return the thread's
// largest logit. Columns past V read as -inf.
template <typename T, int VPT, bool VEC>
__device__ __forceinline__ float load_logits(const T* __restrict__ lrow, int base, const Params& p,
                                             float (&x)[VPT * (16 / sizeof(T))]) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = col_of<E>(base, k * E);
    if (VEC && c + E <= p.V) {
      unpack<T>(__ldg(reinterpret_cast<const uint4*>(lrow + c)), x + k * E);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) x[k * E + j] = c + j < p.V ? to_f(lrow[c + j]) : -INFINITY;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < VPT * E; ++i) {
    const int c = col_of<E>(base, i);
    if (p.use_window && c != p.im_end && (c < p.sem_lo || c > p.sem_hi)) x[i] = -INFINITY;
    m = fmaxf(m, x[i]);
  }
  return m;
}

// Fold the chunk's candidates (s = l / T >= thr) into `best`: a finite
// score gets its Gumbel draw, one Philox call per group of four columns that
// holds one; a -inf score can only win a row without a finite one. l * (1/T)
// lies within 3 ulp of s, so a column it puts clearly below thr is out; the
// others ("maybe") get the IEEE division, one group at a time, so that the
// division, Philox and the logs each appear once in the code (a tiny kernel
// pays for its instruction fetches) and never see -inf (the division's slow
// path).
template <int E, int N>
__device__ __forceinline__ void noisy_argmax(const float (&x)[N], int base, const Params& p,
                                             float rcp, float thr, uint32_t row, uint32_t k0,
                                             uint32_t k1, uint32_t off, unsigned long long& best) {
  static_assert(N <= 32 && N % 4 == 0, "one bit per value, whole groups");
  uint32_t maybe = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = col_of<E>(base, i);
    if (c >= p.V) continue;
    if (x[i] > -INFINITY) {
      const float a = x[i] * rcp;
      if (!(a < thr - (fabsf(a) * 0x1p-21f + 1e-37f))) maybe |= 1u << i;
    } else if (thr == -INFINITY) {
      best = max_key(best, arg_key(x[i], c));  // -inf (NaN gives no key)
    }
  }
  while (maybe) {
    const int q = (__ffs((int)maybe) - 1) >> 2;  // the group of four holding the lowest one
    uint32_t group = (maybe >> (4 * q)) & 0xFu;
    maybe &= ~(0xFu << (4 * q));
    float sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      if (h == q) {
        sq[0] = x[4 * h];
        sq[1] = x[4 * h + 1];
        sq[2] = x[4 * h + 2];
        sq[3] = x[4 * h + 3];
      }
    }
    uint32_t live = 0;
    for (uint32_t g = group; g; g &= g - 1) {
      const int j = __ffs((int)g) - 1;
      const float s = __fdiv_rn(j == 0 ? sq[0] : j == 1 ? sq[1] : j == 2 ? sq[2] : sq[3], p.temp);
      if (s >= thr) live |= 1u << j;
#pragma unroll
      for (int h = 0; h < 4; ++h) sq[h] = h == j ? s : sq[h];
    }
    if (!live) continue;
    const int c0 = col_of<E>(base, 4 * q);
    const U4 r = philox4x32_10(U4{(uint32_t)c0 >> 2, row, kSamplerStream, off}, k0, k1);
    for (; live; live &= live - 1) {
      const int j = __ffs((int)live) - 1;
      const uint32_t w = j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
      const float s = j == 0 ? sq[0] : j == 1 ? sq[1] : j == 2 ? sq[2] : sq[3];
      best = max_key(best, arg_key(s + gumbel_word(w), c0 + j));
    }
  }
}

// One block per row. RESIDENT: the row fits in VPT vectors a thread and is
// read once; otherwise the row is walked in chunks of that size, once for
// the min-p max and once for the argmax.
template <typename T, int VPT, bool VEC, bool RESIDENT>
__global__ void __launch_bounds__(kThreads) sample_tokens_kernel(const Params p) {
  constexpr int E = 16 / sizeof(T);
  constexpr int N = VPT * E;
  constexpr int kChunk = kThreads * N;
  __shared__ float s_max[kWarps];
  __shared__ unsigned long long s_key[kWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const uint32_t row = blockIdx.x;
  const T* __restrict__ lrow = static_cast<const T*>(p.logits) + (long long)row * p.ld;
  const bool greedy = !(p.temp > 0.f);
  // the scalar loads go out with the row's; nothing waits on them until the end
  const bool fin = p.finished != nullptr && p.finished[row];
  uint32_t k0 = 0, k1 = 0, off = 0;
  if (!greedy) {
    const unsigned long long seed = (unsigned long long)p.seed[0];
    k0 = (uint32_t)seed;
    k1 = (uint32_t)(seed >> 32);
    off = (uint32_t)p.seed[1];
  }
  float x[N];
  float m = RESIDENT ? load_logits<T, VPT, VEC>(lrow, 0, p, x) : -INFINITY;
  float thr = -INFINITY;
  if (!greedy && p.use_min_p) {
    if (!RESIDENT) {
      for (int base = 0; base < p.V; base += kChunk)
        m = fmaxf(m, load_logits<T, VPT, VEC>(lrow, base, p, x));
    }
    m = warp_max(m);
    if (lane == 0) s_max[wid] = m;
    __syncthreads();
    m = s_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_max[w]);
    // correctly rounded division by T > 0 is monotone: max(l / T) = max(l) / T
    thr = __fdiv_rn(m, p.temp) + p.log_min_p;
  }
  const float rcp = greedy ? 0.f : 1.0f / p.temp;
  unsigned long long best = 0;
  for (int base = 0; base < (RESIDENT ? 1 : p.V); base += kChunk) {
    if (!RESIDENT) load_logits<T, VPT, VEC>(lrow, base, p, x);
    if (greedy) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int c = col_of<E>(base, i);
        if (c < p.V) best = max_key(best, arg_key(x[i], c));
      }
    } else {
      noisy_argmax<E, N>(x, base, p, rcp, thr, row, k0, k1, off, best);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = max_key(best, __shfl_xor_sync(0xffffffffu, best, o));
  if (lane == 0) s_key[wid] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) best = max_key(best, s_key[w]);
    p.out[row] = fin ? p.im_end : best ? (int)~(uint32_t)best : 0;
  }
}

template <typename T> void launch(const Params& p, int B, bool vec, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int vectors = (p.V + kThreads * E - 1) / (kThreads * E);  // per thread
  const dim3 grid(B), block(kThreads);
  if (!vec) {
    sample_tokens_kernel<T, kMaxVectors, false, false><<<grid, block, 0, stream>>>(p);
  } else if (vectors <= 1) {
    sample_tokens_kernel<T, 1, true, true><<<grid, block, 0, stream>>>(p);
  } else if (vectors == 2) {
    sample_tokens_kernel<T, 2, true, true><<<grid, block, 0, stream>>>(p);
  } else {
    sample_tokens_kernel<T, kMaxVectors, true, false><<<grid, block, 0, stream>>>(p);
  }
}

}  // namespace

// logits [B, V] f32 (dtype 0) or bf16 (dtype 1) with unit column stride and
// row stride `ld` elements; out [B] int32. Rows that are 16-byte aligned take
// vector loads, others scalar ones.
extern "C" int smoltts_sample_tokens(const void* logits, int dtype, int B, int V, long long ld,
                                     float temp, float log_min_p, int use_min_p, int use_window,
                                     int sem_lo, int sem_hi, int im_end_id,
                                     const unsigned char* finished, const long long* seed, int* out,
                                     cudaStream_t stream) {
  (void)cudaGetLastError();
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const Params p{logits, ld, V, temp, log_min_p, use_min_p, use_window, sem_lo, sem_hi,
                 im_end_id, finished, seed, out};
  const long long esz = dtype == 1 ? 2 : 4;
  const bool vec = reinterpret_cast<uintptr_t>(logits) % 16 == 0 && (B == 1 || (ld * esz) % 16 == 0);
  if (dtype == 1) {
    launch<__nv_bfloat16>(p, B, vec, stream);
  } else {
    launch<float>(p, B, vec, stream);
  }
  return (int)cudaGetLastError();
}
