// Fast (depth) transformer micro-loop: one frame's codebook levels for B rows.
//
// Replaces the Pallas kernel smoltts_tpu/ops/fast_loop.py::_kernel (launched
// by fused_fast_micro_loop). For each level i: L fast layers (RMSNorm -> int8
// wqkv -> traditional RoPE at position i -> GQA attention over levels 0..i ->
// int8 wo -> RMSNorm -> SwiGLU with int8 w1/w3/w2), then fast_norm, the int8
// depthwise head slice i, argmax or temperature + min-p + Gumbel-max, and the
// re-embedding of the code from the depthwise table at offset i * CB.
//
// Numerics follow the Pallas kernel: activations stay f32 between stages;
// every matmul input is rounded to the compute dtype (bf16 or f32), int8
// weights convert exactly, products accumulate in f32 and the per-channel
// scale multiplies the f32 result; RMSNorm is f32; min-p keeps
// l >= max + log(min_p); Gumbel noise is Philox keyed by (seed, offset) with
// counter (column, row, level); argmax ties go to the lowest index.
//
// Bound on an H100: bytes. Each level streams the whole int8 trunk (at 150M:
// 4 layers x 8.65 MB = 34.6 MB) plus one 1.6 MB head slice, for all B rows at
// once: ~290 MB per frame, ~87 us at 3.35 TB/s; the work is ~37 GFLOP per
// frame at B=64. The Pallas design kept ~75 MB resident in VMEM; an SM has
// 227 KB of shared memory, so this port keeps the math and drops the layout.
// Design: a fixed sequence of small kernels per frame, issued by one host
// call on the caller's stream (at 150M, B=64: 11 per layer + 4 per level + 1
// = 385). Each GEMM block owns a 64-row x 32-column output tile of one
// projection and a slice of K, so every weight byte is read once per level
// for all rows; K is split until the product fills one wave of the 132 SMs,
// and a second kernel sums the slices in a fixed order (deterministic) and
// applies the epilogue. The gate and up halves of w13 are read side by side
// and leave as silu(gate) * up. Residual adds fuse into the wo / w2
// epilogues. Activations ([B, <= 3072] f32) and
// the per-level K/V cache ([L, n, B, KV*hd] f32) live in global scratch that
// stays in L2. Attention over <= 8 levels runs one block per (kv head, row);
// sampling and the re-embedding run one block per row. The 0/1 structure
// matmuls and the one-hot re-embed of the Pallas kernel were for Mosaic and
// have no counterpart here. Products run on the CUDA cores in f32
// (tensor-core tiles are later work).
#include <algorithm>

#include "common.cuh"

using namespace smoltts;

// Mirrored field for field by smoltts_torch/ops/fast_loop.py::_FastLoopArgs.
struct FastLoopArgs {
  int B, D, H, KV, hd, F, CB, L, n;
  int cdt;  // compute dtype: 0 f32, 1 bf16 (also the dtype of `hidden`)
  int et;   // dtype of the norm weights and the embedding table: 0 f32, 1 bf16
  int greedy, use_min_p, ld13;
  float eps, temp, log_min_p;
  const void* hidden;  // [B, D]
  const int8_t* wqkv;
  const float* wqkv_s;  // [L, D, D + 2 KV hd], [L, 1, .]
  const int8_t* wo;
  const float* wo_s;  // [L, D, D]
  const int8_t* w1;
  const float* w1_s;  // [L, D, ld13] (first F columns used)
  const int8_t* w3;
  const float* w3_s;
  const int8_t* w2;
  const float* w2_s;  // [L, F, D]
  const void* anorm;  // [L, D]
  const void* fnorm;  // [L, D]
  const void* fast_norm;  // [D]
  const void* wte;  // [(n - 1) CB, D]
  const int8_t* head;
  const float* head_s;  // [n, D, CB], [n, 1, CB]
  const float* cos;
  const float* sin;  // [n, hd / 2] (bf16-rounded values)
  const long long* seed;  // {seed, offset}
  float* h;       // [B, D]
  float* hn;      // [B, D]
  float* qkv;     // [B, D + 2 KV hd]
  float* att;     // [B, D]
  float* act;     // [B, F]
  float* kc;      // [L, n, B, KV hd]
  float* vc;
  float* logits;  // [B, CB]
  int* codes;     // [B, n]
  float* part;    // split-K partial sums, smoltts_fast_loop_part_floats() of them
};

namespace {

constexpr int kThreads = 256;
constexpr int TM = 64, TN = 32, TK = 32;

template <typename CDT>
__global__ void init_h(const CDT* __restrict__ hidden, float* __restrict__ h, int total) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) h[i] = to_f(hidden[i]);
}

template <typename ET>
__global__ void rmsnorm_kernel(const float* __restrict__ x, const ET* __restrict__ w,
                               float* __restrict__ out, int D, float eps) {
  __shared__ float red[32];
  const float* xr = x + (long long)blockIdx.x * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) ss += xr[d] * xr[d];
  ss = block_sum(ss, red);
  const float r = rsqrtf(ss / (float)D + eps);
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    out[(long long)blockIdx.x * D + d] = xr[d] * r * to_f(w[d]);
}

// y[M, N] = (round_cdt(x[M, K]) @ w[K, N(ldw)]) * s[N] (+ resid), or with DUAL
// silu(x @ w * s) * (x @ w2 * s2). `resid` may alias `y`: each element is read
// and written by the same thread. Split-K: block z covers K rows
// [z * kchunk, (z + 1) * kchunk) and, when `part` is given, stores its raw
// sums there ([ksplit][M][N], then the DUAL half) for splitk_epilogue.
template <typename CDT, bool DUAL, bool RESID>
__global__ void __launch_bounds__(kThreads)
gemm_i8(const float* __restrict__ x, int M, int K, const int8_t* __restrict__ w,
        const float* __restrict__ s, const int8_t* __restrict__ w2, const float* __restrict__ s2,
        int ldw, int N, float* y, const float* resid, int kchunk, float* __restrict__ part) {
  __shared__ float xs[TK][TM + 1];
  __shared__ float wa[TK][TN];
  __shared__ float wb[DUAL ? TK : 1][TN];
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int tx = t % 16, ty = t / 16;
  float acc[4][2] = {};
  float acc2[4][2] = {};
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);

  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    {
      const int kk = t % TK, k = k0 + kk;
#pragma unroll
      for (int j = 0; j < TM / 8; ++j) {
        const int r = t / TK + 8 * j, row = m0 + r;
        xs[kk][r] = (row < M && k < kend) ? round_to<CDT>(x[(long long)row * K + k]) : 0.f;
      }
    }
    {
      const int kk = t / 8, c = (t % 8) * 4, k = k0 + kk;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + c + e;
        const bool ok = k < kend && col < N;
        wa[kk][c + e] = ok ? (float)w[(long long)k * ldw + col] : 0.f;
        if constexpr (DUAL) wb[kk][c + e] = ok ? (float)w2[(long long)k * ldw + col] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[2];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = xs[kk][ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 2; ++c) b[c] = wa[kk][tx * 2 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[r][c] += a[r] * b[c];
      if constexpr (DUAL) {
#pragma unroll
        for (int c = 0; c < 2; ++c) b[c] = wb[kk][tx * 2 + c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) acc2[r][c] += a[r] * b[c];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty * 4 + r;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n0 + tx * 2 + c;
      if (row >= M || col >= N) continue;
      const long long o = (long long)row * N + col;
      if (part != nullptr) {
        const long long plane = (long long)M * N;
        part[blockIdx.z * plane + o] = acc[r][c];
        if constexpr (DUAL) part[(gridDim.z + blockIdx.z) * plane + o] = acc2[r][c];
        continue;
      }
      float v = acc[r][c] * s[col];
      if constexpr (DUAL) {
        const float u = acc2[r][c] * s2[col];
        v = v * (1.f / (1.f + expf(-v))) * u;
      }
      if constexpr (RESID) v = resid[o] + v;
      y[o] = v;
    }
  }
}

// Sum the split-K partials in a fixed order (deterministic), then the epilogue
// of gemm_i8.
template <bool DUAL, bool RESID>
__global__ void splitk_epilogue(const float* __restrict__ part, int ksplit, int M, int N,
                                const float* __restrict__ s, const float* __restrict__ s2,
                                float* y, const float* resid) {
  const long long plane = (long long)M * N;
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= plane) return;
  const int col = (int)(o % N);
  float a = 0.f;
  for (int z = 0; z < ksplit; ++z) a += part[z * plane + o];
  float v = a * s[col];
  if constexpr (DUAL) {
    float b = 0.f;
    for (int z = 0; z < ksplit; ++z) b += part[(ksplit + z) * plane + o];
    const float u = b * s2[col];
    v = v * (1.f / (1.f + expf(-v))) * u;
  }
  if constexpr (RESID) v = resid[o] + v;
  y[o] = v;
}

// One block per (kv head, row): RoPE on q and k at position i, cache the
// level's k/v, attend over levels 0..i for the group's query heads.
__global__ void fast_attn(const float* __restrict__ qkv, float* __restrict__ kc,
                          float* __restrict__ vc, float* __restrict__ att,
                          const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                          int B, int D, int H, int KV, int hd, int n, int l, int i) {
  __shared__ float qs[8][128];
  __shared__ float sc[8][8];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV, half = hd / 2, KVhd = KV * hd, Nq = D + 2 * KVhd;
  const float* row = qkv + (long long)b * Nq;
  const float* c_i = cos_t + i * half;
  const float* s_i = sin_t + i * half;
  const long long here = ((long long)(l * n + i) * B + b) * KVhd + kvh * hd;

  for (int p = threadIdx.x; p < half; p += blockDim.x) {
    const float k0 = row[D + kvh * hd + 2 * p], k1 = row[D + kvh * hd + 2 * p + 1];
    kc[here + 2 * p] = k0 * c_i[p] - k1 * s_i[p];
    kc[here + 2 * p + 1] = k1 * c_i[p] + k0 * s_i[p];
  }
  for (int d = threadIdx.x; d < hd; d += blockDim.x) vc[here + d] = row[D + KVhd + kvh * hd + d];
  for (int idx = threadIdx.x; idx < G * half; idx += blockDim.x) {
    const int g = idx / half, p = idx % half, qh = kvh * G + g;
    const float q0 = row[qh * hd + 2 * p], q1 = row[qh * hd + 2 * p + 1];
    qs[g][2 * p] = q0 * c_i[p] - q1 * s_i[p];
    qs[g][2 * p + 1] = q1 * c_i[p] + q0 * s_i[p];
  }
  __syncthreads();

  const float scale = rsqrtf((float)hd);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  for (int pair = warp; pair < G * (i + 1); pair += nw) {
    const int g = pair / (i + 1), j = pair % (i + 1);
    const float* kj = kc + ((long long)(l * n + j) * B + b) * KVhd + kvh * hd;
    float part = 0.f;
    for (int d = lane; d < hd; d += 32) part += qs[g][d] * kj[d];
    part = warp_sum(part);
    if (lane == 0) sc[g][j] = part * scale;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float m = sc[g][0];
    for (int j = 1; j <= i; ++j) m = fmaxf(m, sc[g][j]);
    float e[8], denom = 0.f;
    for (int j = 0; j <= i; ++j) {
      e[j] = expf(sc[g][j] - m);
      denom += e[j];
    }
    for (int j = 0; j <= i; ++j) sc[g][j] = e[j] / denom;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x) {
    const int g = idx / hd, d = idx % hd;
    float a = 0.f;
    for (int j = 0; j <= i; ++j)
      a += sc[g][j] * vc[((long long)(l * n + j) * B + b) * KVhd + kvh * hd + d];
    att[(long long)b * D + (kvh * G + g) * hd + d] = a;
  }
}

// One block per row: pick level i's code, then load the next level's input.
template <typename ET>
__global__ void fast_sample(const float* __restrict__ logits, int CB, int* __restrict__ codes,
                           int n, int i, int greedy, float temp, float log_min_p, int use_min_p,
                           const long long* seed, const ET* __restrict__ wte,
                           float* __restrict__ h, int D) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int b = blockIdx.x;
  const float* l = logits + (long long)b * CB;
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  if (greedy) {
    for (int c = threadIdx.x; c < CB; c += blockDim.x) arg_better(best, best_i, l[c], c);
  } else {
    float thr = -INFINITY;
    if (use_min_p) {
      float m = -INFINITY;
      for (int c = threadIdx.x; c < CB; c += blockDim.x) m = fmaxf(m, l[c] / temp);
      thr = block_max(m, sv) + log_min_p;
    }
    for (int c = threadIdx.x; c < CB; c += blockDim.x) {
      const float sc = l[c] / temp;
      if (use_min_p && !(sc >= thr)) continue;
      arg_better(best, best_i, sc + gumbel(seed, (uint32_t)c, (uint32_t)b, (uint32_t)i), c);
    }
  }
  int code = block_argmax(best, best_i, sv, si);
  if (code == 0x7fffffff) code = 0;
  if (threadIdx.x == 0) codes[(long long)b * n + i] = code;
  if (i + 1 < n) {
    const ET* row = wte + ((long long)code + (long long)i * CB) * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) h[(long long)b * D + d] = to_f(row[d]);
  }
}

constexpr int kTargetBlocks = 132;  // one wave on an H100's SMs
constexpr int kMaxSplit = 8;

// K splits for an [M, N] x K product: enough blocks for one wave, at least
// 4 K tiles per block.
inline int ksplit_for(int M, int N, int K) {
  const int tiles = ((N + TN - 1) / TN) * ((M + TM - 1) / TM);
  int ks = (kTargetBlocks + tiles - 1) / tiles;
  ks = std::min(ks, std::max(1, K / (4 * TK)));
  return std::max(1, std::min(ks, kMaxSplit));
}

template <typename CDT, bool DUAL, bool RESID>
void gemm(const float* x, int M, int K, const int8_t* w, const float* s, const int8_t* w2,
          const float* s2, int ldw, int N, float* y, const float* resid, float* part,
          cudaStream_t st) {
  const int ks = ksplit_for(M, N, K);
  const int kchunk = ((K + ks - 1) / ks + TK - 1) / TK * TK;
  const int nz = (K + kchunk - 1) / kchunk;
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, nz);
  gemm_i8<CDT, DUAL, RESID><<<grid, kThreads, 0, st>>>(x, M, K, w, s, w2, s2, ldw, N, y, resid,
                                                       kchunk, nz > 1 ? part : nullptr);
  if (nz > 1) {
    const long long total = (long long)M * N;
    splitk_epilogue<DUAL, RESID><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        part, nz, M, N, s, s2, y, resid);
  }
}

template <typename CDT, typename ET>
int run(const FastLoopArgs& a, cudaStream_t st) {
  const int B = a.B, D = a.D, F = a.F, CB = a.CB, Nq = a.D + 2 * a.KV * a.hd;
  const ET* anorm = (const ET*)a.anorm;
  const ET* fnorm = (const ET*)a.fnorm;
  init_h<CDT><<<(B * D + kThreads - 1) / kThreads, kThreads, 0, st>>>((const CDT*)a.hidden, a.h,
                                                                     B * D);
  for (int i = 0; i < a.n; ++i) {
    for (int l = 0; l < a.L; ++l) {
      rmsnorm_kernel<ET><<<B, kThreads, 0, st>>>(a.h, anorm + (long long)l * D, a.hn, D, a.eps);
      gemm<CDT, false, false>(a.hn, B, D, a.wqkv + (long long)l * D * Nq,
                              a.wqkv_s + (long long)l * Nq, nullptr, nullptr, Nq, Nq, a.qkv,
                              nullptr, a.part, st);
      fast_attn<<<dim3(a.KV, B), kThreads, 0, st>>>(a.qkv, a.kc, a.vc, a.att, a.cos, a.sin, B, D,
                                                    a.H, a.KV, a.hd, a.n, l, i);
      gemm<CDT, false, true>(a.att, B, D, a.wo + (long long)l * D * D, a.wo_s + (long long)l * D,
                             nullptr, nullptr, D, D, a.h, a.h, a.part, st);
      rmsnorm_kernel<ET><<<B, kThreads, 0, st>>>(a.h, fnorm + (long long)l * D, a.hn, D, a.eps);
      gemm<CDT, true, false>(a.hn, B, D, a.w1 + (long long)l * D * a.ld13,
                             a.w1_s + (long long)l * a.ld13, a.w3 + (long long)l * D * a.ld13,
                             a.w3_s + (long long)l * a.ld13, a.ld13, F, a.act, nullptr, a.part,
                             st);
      gemm<CDT, false, true>(a.act, B, F, a.w2 + (long long)l * F * D, a.w2_s + (long long)l * D,
                             nullptr, nullptr, D, D, a.h, a.h, a.part, st);
    }
    rmsnorm_kernel<ET><<<B, kThreads, 0, st>>>(a.h, (const ET*)a.fast_norm, a.hn, D, a.eps);
    gemm<CDT, false, false>(a.hn, B, D, a.head + (long long)i * D * CB,
                            a.head_s + (long long)i * CB, nullptr, nullptr, CB, CB, a.logits,
                            nullptr, a.part, st);
    fast_sample<ET><<<B, kThreads, 0, st>>>(a.logits, CB, a.codes, a.n, i, a.greedy, a.temp,
                                            a.log_min_p, a.use_min_p, a.seed, (const ET*)a.wte,
                                            a.h, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of split-K scratch the frame needs (the largest split product).
extern "C" long long smoltts_fast_loop_part_floats(int B, int D, int F, int CB, int Nq) {
  auto need = [&](int N, int K, int halves) -> long long {
    const int ks = ksplit_for(B, N, K);
    const int kchunk = ((K + ks - 1) / ks + TK - 1) / TK * TK;
    const int nz = (K + kchunk - 1) / kchunk;
    return nz > 1 ? (long long)halves * nz * B * N : 0;
  };
  long long m = need(Nq, D, 1);
  m = std::max(m, need(D, D, 1));
  m = std::max(m, need(F, D, 2));
  m = std::max(m, need(D, F, 1));
  m = std::max(m, need(CB, D, 1));
  return m;
}

extern "C" int smoltts_fast_loop(const FastLoopArgs* a, cudaStream_t stream) {
  (void)cudaGetLastError();
  const int G = a->KV > 0 ? a->H / a->KV : 0;
  if (a->KV <= 0 || a->H % a->KV != 0 || G > 8 || a->hd > 128 || a->hd % 2 != 0 || a->n > 8 ||
      a->n < 1)
    return (int)cudaErrorInvalidValue;
  if (a->B == 0) return 0;
  if (a->cdt == 1 && a->et == 1) return run<__nv_bfloat16, __nv_bfloat16>(*a, stream);
  if (a->cdt == 1 && a->et == 0) return run<__nv_bfloat16, float>(*a, stream);
  if (a->cdt == 0 && a->et == 1) return run<float, __nv_bfloat16>(*a, stream);
  if (a->cdt == 0 && a->et == 0) return run<float, float>(*a, stream);
  return (int)cudaErrorInvalidValue;
}
