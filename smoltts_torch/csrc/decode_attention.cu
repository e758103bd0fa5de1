// Single-query GQA decode attention over a split KV cache: a frozen history
// (int8 with per-vector k/v scales, or the compute dtype) plus a ring tail in
// the compute dtype; and, at the end of the file, the split route for any
// head_dim, which also serves f32 compute over a bf16 tail and history.
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
// one call reads ~7.8 MB (int8 history with its scales, the valid bf16 tail
// rows): ~2.3 us at 3.35 TB/s; with G <= 8 query heads per kv head there are
// ~2G operations per byte, far below the tensor cores' ridge, so the kernel
// runs on the CUDA cores. At these sizes the bytes are few and the chain of
// dependent loads is what takes the time, so the design cuts the chain:
// - Flash-decoding split. The valid positions of one (row, kv head) are cut
//   into equal contiguous chunks, one per warp of a 256-thread block and,
//   where B x n_kv blocks would leave the card idle (small B, long attend
//   buckets), over up to 8 blocks of one thread-block cluster. Each warp
//   computes all G query heads of the group over its chunk.
// - Tiles of 32 rows, all loads of a tile in flight before any use. Logits:
//   lane r takes row r whole, its key row in 16-byte loads (int8 converts to
//   f32 by a byte permute and one subtraction), q broadcast from shared
//   memory prescaled to log2 units; no shuffles sum a row, and each lane
//   computes one exp2 per head. Values: a lane owns 8 head dims, so one load
//   instruction covers 4 (hd 64) or 2 (hd 128) consecutive rows, 16 bytes a
//   lane of a bf16 row and 8 of an int8 row; the probabilities pass through
//   shared memory. History and tail rows share the layout, so one
//   accumulator serves both.
// - Each warp keeps an online softmax in f32 registers: a running max
//   (warp-uniform) and sum per head, the accumulator rescaled when the max
//   grows. There is no logits buffer and no block-wide reduction per head.
// - Only valid rows are read: warp 0 first compacts the tail columns whose
//   tail_pos lies in [flushed, pos] (one ballot per 32 columns) into
//   dynamic shared memory sized by the tail (4 bytes a column, up to kMaxW
//   columns); history rows at or past min(flushed, lim) are never touched.
// - A group of more than GM query heads is cut into tiles of GM heads, one
//   block (or cluster) per tile over the same K/V rows.
// - The warps' partial (max, sum, acc[G][hd]) meet in shared memory in warp
//   order, and the cluster's blocks through distributed shared memory in
//   rank order, so the result is deterministic.
// The host picks the split from B, n_kv, the group tiles, lim + W, the SM
// count and each variant's occupancy, all queried once at load
// (smoltts_decode_attention_setup); nothing is set per call. All arithmetic
// is f32; the output is rounded once to the compute dtype. Head dims 32, 64
// and 128 take this kernel; any other head_dim, a tail above kMaxW columns,
// and f32 compute over a bf16 cache take decode_attn_split_kernel at the end
// of the file.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace smoltts;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDims = 8;        // head dims a lane owns
constexpr int kMaxW = 32768;    // tail columns (compacted in dynamic shared memory)
constexpr int kMaxSplits = 8;   // blocks per (row, kv head): a portable cluster
constexpr int kMinRows = 16;    // a warp's least share of positions after a split
constexpr int kMaxHd = 8192;    // head_dim of the split route (q of one head in shared memory)

int g_sms = 0;          // SM count, set by smoltts_decode_attention_setup
int g_occ[2][2][3][2];  // resident blocks per SM: [dtype][hist][hd 64/128/32][group > 3]

// 8 consecutive elements of a row as loaded: 8 bytes of int8, 16 of bf16, 32
// of f32.
template <typename E>
struct Raw {
  uint32_t w[2 * sizeof(E)];
};

template <typename E>
__device__ __forceinline__ void load_raw(Raw<E>& r, const E* p) {
  if constexpr (sizeof(E) == 1) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < (int)sizeof(E) / 2; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      r.w[4 * i] = v.x;
      r.w[4 * i + 1] = v.y;
      r.w[4 * i + 2] = v.z;
      r.w[4 * i + 3] = v.w;
    }
  }
}

// The elements of n words as f32: int8 v becomes the float 2^23 + (v + 128),
// built from its bits, minus 2^23 + 128, which gives v exactly; bf16 is the
// upper half of an f32.
template <typename E, int N>
__device__ __forceinline__ void words_to_f(const uint32_t* w, float* f) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(E) == 1) {
      const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        f[4 * i + k] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + k)) - 8388736.f;
    } else if constexpr (sizeof(E) == 2) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

template <typename E>
__device__ __forceinline__ void to_f8(const Raw<E>& r, float (&f)[kDims]) {
  words_to_f<E, 2 * sizeof(E)>(r.w, f);
}

// One warp over rows [i0, i1) of one source: the history (SCALED with kv8)
// or the tail (INDIRECT: row i is column cols[i]), 32 rows a tile. Logits:
// lane r takes row r of the tile whole (its key row in 16-byte loads, q
// broadcast from shared memory, prescaled to log2 units), so no shuffles sum
// them and each lane computes one exp per head. Values: a lane owns 8 head
// dims of RPW rows per load (the accumulator layout), the probabilities come
// through shared memory. All loads of a tile are in flight before any use.
// Updates the warp's online softmax state (m, l) and the lane's accumulator.
template <typename E, bool SCALED, bool INDIRECT, int HD, int GM>
__device__ __forceinline__ void attend(const E* __restrict__ kb, const E* __restrict__ vb,
                                       const float* __restrict__ ksc,
                                       const float* __restrict__ vsc, const int* cols, int i0,
                                       int i1, int G, const float* qs, float* pw, float (&m)[GM],
                                       float (&l)[GM], float (&acc)[GM][kDims]) {
  constexpr int EPC = 16 / sizeof(E);  // elements per 16-byte chunk
  constexpr int NC = HD / EPC;         // chunks per key row
  constexpr int KB = NC < 8 ? NC : 8;  // key chunks in flight
  constexpr int LPR = HD / kDims, RPW = 32 / LPR, NV = 32 / RPW;  // value loads per lane
  constexpr int VMAX = 16 / (int)sizeof(E);
  constexpr int VB = NV < VMAX ? NV : VMAX;  // value loads in flight
  constexpr int PG = GM <= 4 ? 4 : 8;
  const int lane = threadIdx.x & 31, grp = lane / LPR, sub = lane % LPR;
  for (int t0 = i0; t0 < i1; t0 += 32) {
    const bool ok = t0 + lane < i1;
    const long long r = ok ? (INDIRECT ? cols[t0 + lane] : t0 + lane) : 0;
    const E* krow = kb + r * HD;
    uint4 kc[KB];
    Raw<E> vr[VB];
    auto load_k = [&](int c0) {
#pragma unroll
      for (int k = 0; k < KB; ++k)
        kc[k] = ok ? __ldg(reinterpret_cast<const uint4*>(krow + (c0 + k) * EPC))
                   : make_uint4(0u, 0u, 0u, 0u);
    };
    auto load_v = [&](int u0) {
#pragma unroll
      for (int u = 0; u < VB; ++u) {
        const int j = t0 + (u0 + u) * RPW + grp;
        if (j < i1) {
          const long long rv = INDIRECT ? cols[j] : j;
          load_raw(vr[u], vb + rv * HD + sub * kDims);
        } else {
          vr[u] = Raw<E>{};
        }
      }
    };
    load_k(0);
    load_v(0);
    float ks = 1.f, vs = 1.f;
    if (SCALED && ok) {
      ks = __ldg(ksc + r);
      vs = __ldg(vsc + r);
    }
    float dot[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) dot[g] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < NC; c0 += KB) {
      if (c0 > 0) load_k(c0);
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const uint32_t w4[4] = {kc[k].x, kc[k].y, kc[k].z, kc[k].w};
        float f[EPC];
        words_to_f<E, 4>(w4, f);
        const float4* q4 = reinterpret_cast<const float4*>(qs) + (c0 + k) * EPC / 4;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int j = 0; j < EPC / 4; ++j) {
            const float4 qv = q4[g * HD / 4 + j];
            dot[g] = fmaf(qv.x, f[4 * j], dot[g]);
            dot[g] = fmaf(qv.y, f[4 * j + 1], dot[g]);
            dot[g] = fmaf(qv.z, f[4 * j + 2], dot[g]);
            dot[g] = fmaf(qv.w, f[4 * j + 3], dot[g]);
          }
        }
      }
    }
    // Online softmax over the tile, per head (the max is warp-wide).
    float pv[PG];
#pragma unroll
    for (int g = 0; g < PG; ++g) pv[g] = 0.f;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float x = ok ? dot[g] * ks : -INFINITY;
      const float mn = fmaxf(m[g], warp_max(x));
      const float alpha = mn == -INFINITY ? 1.f : exp2f(m[g] - mn);
      const float p = x == -INFINITY ? 0.f : exp2f(x - mn);
      m[g] = mn;
      l[g] = l[g] * alpha + p;  // this lane's rows; summed over the warp at the end
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[g][j] *= alpha;
      pv[g] = p * vs;
    }
#pragma unroll
    for (int g = 0; g < PG; g += 4)
      *reinterpret_cast<float4*>(pw + lane * PG + g) = make_float4(pv[g], pv[g + 1], pv[g + 2], pv[g + 3]);
    __syncwarp();
#pragma unroll
    for (int u0 = 0; u0 < NV; u0 += VB) {
      if (u0 > 0) load_v(u0);
#pragma unroll
      for (int u = 0; u < VB; ++u) {
        float vf[kDims], pp[PG];
        to_f8(vr[u], vf);
        const float* prow = pw + ((u0 + u) * RPW + grp) * PG;
#pragma unroll
        for (int g = 0; g < PG; g += 4) {
          const float4 t = *reinterpret_cast<const float4*>(prow + g);
          pp[g] = t.x;
          pp[g + 1] = t.y;
          pp[g + 2] = t.z;
          pp[g + 3] = t.w;
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int j = 0; j < kDims; ++j) acc[g][j] = fmaf(pp[g], vf[j], acc[g][j]);
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }
}

// Grid (splits, n_kv * group tiles, B); a cluster is the `splits` blocks of
// one (row, kv head, group tile).
template <typename T, typename HT, bool KV8, int HD, int GM>
__global__ void __launch_bounds__(kThreads, GM <= 4 ? 2 : 1)
decode_attn_kernel(const T* __restrict__ q, const HT* __restrict__ k_hist,
                   const HT* __restrict__ v_hist, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, long long hsb, long long hsh, long long ssb,
                   long long ssh, const T* __restrict__ k_tail, const T* __restrict__ v_tail,
                   const int* __restrict__ pos, const int* __restrict__ flushed,
                   const int* __restrict__ tail_pos, T* __restrict__ out, int H, int n_kv,
                   int lim, int W) {
  constexpr int LPR = HD / kDims, PG = GM <= 4 ? 4 : 8;
  extern __shared__ int cols[];  // [W]: the valid tail columns, compacted
  __shared__ int n_tail;
  // q and the tiles' probabilities while the warps attend, then the warps'
  // partial accumulators.
  __shared__ union {
    struct {
      alignas(16) float q[GM][HD];
      alignas(16) float p[kWarps][32][PG];
    } a;
    alignas(16) float acc[kWarps][GM][HD];
  } sm;
  __shared__ float part_m[kWarps][GM], part_l[kWarps][GM];
  __shared__ float blk_m[GM], blk_l[GM];
  __shared__ float blk_acc[GM][HD];

  const int split = blockIdx.x, splits = gridDim.x, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sub = lane % LPR;
  // This block's group tile: query heads [g0, g0 + G) of kv head h.
  const int G_all = H / n_kv, tiles = (G_all + GM - 1) / GM;
  const int h = blockIdx.y / tiles, g0 = (blockIdx.y % tiles) * GM, G = min(GM, G_all - g0);
  const int p_b = __ldg(pos + b), f_b = __ldg(flushed + b);
  const int n_h = max(0, min(f_b, lim));

  // The valid tail columns, in column order.
  if (warp == 0) {
    const int* tp = tail_pos + (long long)b * W;
    int cnt = 0;
    for (int c0 = 0; c0 < W; c0 += 128) {
      int t[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + 32 * k + lane;
        t[k] = c < W ? __ldg(tp + c) : -1;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool ok = t[k] >= 0 && t[k] >= f_b && t[k] <= p_b;
        const unsigned mask = __ballot_sync(0xffffffffu, ok);
        if (ok) cols[cnt + __popc(mask & ((1u << lane) - 1u))] = c0 + 32 * k + lane;
        cnt += __popc(mask);
      }
    }
    if (lane == 0) n_tail = cnt;
  }

  // q in log2 units: scaled by hd^-0.5 and log2(e), so exp2 gives the softmax.
  const float qscale = 1.4426950408889634f / sqrtf((float)HD);
  const T* qb = q + ((long long)b * H + h * G_all + g0) * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) sm.a.q[i / HD][i % HD] = to_f(qb[i]) * qscale;
  float m[GM], l[GM], acc[GM][kDims];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[g][j] = 0.f;
  }
  __syncthreads();

  // This warp's chunk [i0, i1) of the n valid positions: history rows first,
  // then the compacted tail.
  const int n = n_h + n_tail, nw = splits * kWarps, wg = split * kWarps + warp;
  const int i0 = (int)((long long)wg * n / nw), i1 = (int)((long long)(wg + 1) * n / nw);
  const long long hoff = b * hsb + h * hsh, soff = b * ssb + h * ssh;
  float* pw = &sm.a.p[warp][0][0];
  attend<HT, KV8, false, HD, GM>(k_hist + hoff, v_hist + hoff, KV8 ? k_scale + soff : nullptr,
                                 KV8 ? v_scale + soff : nullptr, nullptr, i0, min(i1, n_h), G,
                                 &sm.a.q[0][0], pw, m, l, acc);
  const long long toff = ((long long)b * n_kv + h) * W * HD;
  attend<T, false, true, HD, GM>(k_tail + toff, v_tail + toff, nullptr, nullptr, cols,
                                 max(i0, n_h) - n_h, i1 - n_h, G, &sm.a.q[0][0], pw, m, l, acc);

  // The warp's partial (fixed shuffle trees): l over all lanes (one row
  // each), acc over the row groups.
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    l[g] = warp_sum(l[g]);
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
  }
  __syncthreads();  // every warp is done with q and p
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    if (lane < LPR) {
      float4* dst = reinterpret_cast<float4*>(&sm.acc[warp][g][sub * kDims]);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
    if (lane == 0) {
      part_m[warp][g] = m[g];
      part_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  // The block's partial: the warps in order.
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, part_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float s = part_m[w][g] == -INFINITY ? 0.f : exp2f(part_m[w][g] - M);
      L = fmaf(part_l[w][g], s, L);
      A = fmaf(sm.acc[w][g][d], s, A);
    }
    if (splits == 1) {
      out[((long long)b * H + h * G_all + g0 + g) * HD + d] = from_f<T>(A / L);
    } else {
      blk_acc[g][d] = A;
      if (d == 0) {
        blk_m[g] = M;
        blk_l[g] = L;
      }
    }
  }
  if (splits == 1) return;

  // The cluster's blocks in rank order, through distributed shared memory;
  // block r writes the outputs r, r + splits, ... (in units of the block).
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  for (int idx = rank * kThreads + threadIdx.x; idx < G * HD; idx += splits * kThreads) {
    const int g = idx / HD, d = idx % HD;
    float M = -INFINITY;
    for (int r = 0; r < splits; ++r) M = fmaxf(M, *cluster.map_shared_rank(&blk_m[g], r));
    float L = 0.f, A = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float mr = *cluster.map_shared_rank(&blk_m[g], r);
      const float s = mr == -INFINITY ? 0.f : exp2f(mr - M);
      L = fmaf(*cluster.map_shared_rank(&blk_l[g], r), s, L);
      A = fmaf(*cluster.map_shared_rank(&blk_acc[g][d], r), s, A);
    }
    out[((long long)b * H + h * G_all + g0 + g) * HD + d] = from_f<T>(A / L);
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

struct Call {
  const void *q, *k_hist, *v_hist;
  const float *k_scale, *v_scale;
  long long hsb, hsh, ssb, ssh;
  const void *k_tail, *v_tail;
  const int *pos, *flushed, *tail_pos;
  void* out;
  int B, H, n_kv, hd, lim, W;
  cudaStream_t stream;
};

// Blocks per (row, kv head, group tile): doubled while the grid stays within
// one wave of resident blocks and every warp keeps at least kMinRows of
// lim + W.
int choose_splits(int pairs, int rows, int resident) {
  int s = 1;
  while (s < kMaxSplits && 2LL * pairs * s <= resident && rows >= 2 * s * kWarps * kMinRows)
    s *= 2;
  return s;
}

// With c == nullptr: query the variant's occupancy into *occ (setup).
template <typename T, typename HT, bool KV8, int HD, int GM>
int launch(const Call* c, int* occ) {
  const auto kern = decode_attn_kernel<T, HT, KV8, HD, GM>;
  if (c == nullptr) {  // setup: room for kMaxW compacted columns, and the occupancy
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kMaxW * (int)sizeof(int));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, kThreads, 0);
  }
  const int tiles = (c->H / c->n_kv + GM - 1) / GM;
  const int splits = choose_splits(c->B * c->n_kv * tiles, c->lim + c->W, g_sms * *occ);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, c->n_kv * tiles, c->B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)c->W * sizeof(int);
  cfg.stream = c->stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // an unsplit call is a plain launch
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const T*)c->q, (const HT*)c->k_hist, (const HT*)c->v_hist, c->k_scale,
      c->v_scale, c->hsb, c->hsh, c->ssb, c->ssh, (const T*)c->k_tail, (const T*)c->v_tail, c->pos,
      c->flushed, c->tail_pos, (T*)c->out, c->H, c->n_kv, c->lim, c->W);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// hd 32 has one variant (tiles of 8 heads); 64 and 128 one for groups of at
// most 3 (the main path's 12/4) and one for tiles of 8.
template <typename T, typename HT, bool KV8, int DT, int HI>
int by_shape(const Call* c, int hd, int G) {
  int(&occ)[3][2] = g_occ[DT][HI];
  if (hd == 32) return launch<T, HT, KV8, 32, 8>(c, &occ[2][1]);
  if (hd == 64)
    return G <= 3 ? launch<T, HT, KV8, 64, 3>(c, &occ[0][0]) : launch<T, HT, KV8, 64, 8>(c, &occ[0][1]);
  return G <= 3 ? launch<T, HT, KV8, 128, 3>(c, &occ[1][0]) : launch<T, HT, KV8, 128, 8>(c, &occ[1][1]);
}

// ---- The split route: any head_dim, tails above kMaxW columns, and f32
// compute over a bf16 cache (the blocking generator's attention). The
// positions of one (row, kv head, group tile) are split over the warps of a
// block and the blocks of a cluster, as above, and each warp computes every
// head of the tile over its chunk, so K and V are read once per group. Two
// passes over the chunk:
// 1. Statistics: an online max and sum per head (lane r takes row r of a
//    tile of 32, its key row in 16-byte loads where the row's bytes allow
//    it, else element loads; q prescaled in shared memory). The warps' and
//    then the cluster ranks' (max, sum) pairs meet in a fixed order, so
//    every block holds the same final pair before pass 2.
// 2. Products: each warp recomputes its logits once (the same code, so the
//    same bits) and forms the normalized probabilities, the history's times
//    v_scale with kv8, the tail's rounded to bf16 where the plain version
//    rounds them (f32 compute over a bf16 tail). A lane owns 8 head dims of
//    a row, as in the tuned value layout; the history and the tail sum into
//    separate f32 accumulators, combined over warps and then ranks in a
//    fixed order, and the tail's sum is rounded to bf16 once, after the
//    combine, before it joins the history's: the plain version's roundings,
//    as the JAX package computes them, so a greedy f32 run keeps the plain
//    path's codes. A one-pass online softmax never holds a normalized
//    probability to round, hence the two passes.
// The key rows come back for pass 2 from L2 (a (row, kv head) of the
// blocking generator's shape is ~0.5 MB), so DRAM bytes stay near one read
// of K and of V. Bound: bytes, as above (~2 MB at the blocking generator's
// shape, under 1 us at 3.35 TB/s); at B=1 the chain of dependent loads and
// the cluster's syncs set the time. Valid tail columns are compacted in
// dynamic shared memory up to kMaxW columns; a longer tail is masked column
// by column. History rows at or past min(flushed, lim) are never read.
// head_dim is a run-time value; past kSlab the products run in slabs of
// kSlab dims, each recomputing the logits.
constexpr int kSplitGroup = 4;       // query heads of one block (a group tile)
constexpr int kSplitQBytes = 32768;  // shared memory for q of one group tile
constexpr int kSlab = 128;           // head dims one products pass covers

int g_split_occ[8];  // resident blocks per SM of each split variant, by hist * 2 + dtype

template <typename E>
__device__ __forceinline__ float load_elem(const E* p) {
  if constexpr (sizeof(E) == 1) return (float)__ldg(reinterpret_cast<const signed char*>(p));
  else if constexpr (sizeof(E) == 2)
    return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  else return __ldg(reinterpret_cast<const float*>(p));
}

// The logits (log2 units) of the warp's tile [t0, t0 + 32) of rows [., i1):
// lane r takes row t0 + r. Row i is column cols[i] of the source if cols is
// given, else i; with tp given, a column counts only if its tail position
// lies in [lo, hi]. Returns whether the lane's row counts; x is -inf where
// it does not, and r is the row's index in the source.
template <typename E, bool SCALED>
__device__ __forceinline__ bool split_logits(const E* __restrict__ kb,
                                             const float* __restrict__ ksc, const int* cols,
                                             const int* __restrict__ tp, int lo, int hi, int t0,
                                             int i1, int G, int hd, bool vec, const float* qs,
                                             float (&x)[kSplitGroup], long long& r) {
  constexpr int GM = kSplitGroup;
  const int i = t0 + (threadIdx.x & 31);
  bool ok = i < i1;
  r = 0;
  if (ok) {
    r = cols ? cols[i] : i;
    if (tp) {
      const int t = __ldg(tp + r);
      ok = t >= 0 && t >= lo && t <= hi;
    }
  }
  float dot[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) dot[g] = 0.f;
  if (ok) {
    const E* krow = kb + r * hd;
    if (vec) {  // 16-byte chunks, four in flight; the same summation order as below
      constexpr int EPC = 16 / sizeof(E);
      const int nc = hd / EPC;
      for (int c0 = 0; c0 < nc; c0 += 4) {
        uint4 kc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c0 + k < nc) kc[k] = __ldg(reinterpret_cast<const uint4*>(krow) + c0 + k);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c0 + k >= nc) break;
          const uint32_t w4[4] = {kc[k].x, kc[k].y, kc[k].z, kc[k].w};
          float f[EPC];
          words_to_f<E, 4>(w4, f);
          const int d0 = (c0 + k) * EPC;
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g >= G) break;
            const float4* q4 = reinterpret_cast<const float4*>(qs + g * hd + d0);
#pragma unroll
            for (int j = 0; j < EPC / 4; ++j) {
              const float4 qv = q4[j];
              dot[g] = fmaf(qv.x, f[4 * j], dot[g]);
              dot[g] = fmaf(qv.y, f[4 * j + 1], dot[g]);
              dot[g] = fmaf(qv.z, f[4 * j + 2], dot[g]);
              dot[g] = fmaf(qv.w, f[4 * j + 3], dot[g]);
            }
          }
        }
      }
    } else {
      for (int d = 0; d < hd; ++d) {
        const float kf = load_elem(krow + d);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          dot[g] = fmaf(qs[g * hd + d], kf, dot[g]);
        }
      }
    }
  }
  const float ks = SCALED && ok ? __ldg(ksc + r) : 1.f;
#pragma unroll
  for (int g = 0; g < GM; ++g) x[g] = ok ? (SCALED ? __fmul_rn(dot[g], ks) : dot[g]) : -INFINITY;
  return ok;
}

// Pass 1 over rows [i0, i1) of one source: the warp's online max (warp-wide)
// and the lane's sum of exponentials per head.
template <typename E, bool SCALED>
__device__ __forceinline__ void split_stats(const E* __restrict__ kb,
                                            const float* __restrict__ ksc, const int* cols,
                                            const int* __restrict__ tp, int lo, int hi, int i0,
                                            int i1, int G, int hd, bool vec, const float* qs,
                                            float (&m)[kSplitGroup], float (&l)[kSplitGroup]) {
  for (int t0 = i0; t0 < i1; t0 += 32) {
    float x[kSplitGroup];
    long long r;
    split_logits<E, SCALED>(kb, ksc, cols, tp, lo, hi, t0, i1, G, hd, vec, qs, x, r);
#pragma unroll
    for (int g = 0; g < kSplitGroup; ++g) {
      if (g >= G) break;
      const float mn = fmaxf(m[g], warp_max(x[g]));
      const float alpha = mn == -INFINITY ? 1.f : exp2f(m[g] - mn);
      l[g] = l[g] * alpha + (x[g] == -INFINITY ? 0.f : exp2f(x[g] - mn));
      m[g] = mn;
    }
  }
}

// 8 elements of a value row from p on (nd of them inside the row): one
// vector load where the row allows it (nd >= 8 then), else element loads.
template <typename E>
__device__ __forceinline__ void load_vals(const E* p, bool vec, int nd, float (&f)[kDims]) {
  if (vec) {
    Raw<E> raw;
    load_raw(raw, p);
    to_f8(raw, f);
  } else {
#pragma unroll
    for (int j = 0; j < kDims; ++j) f[j] = j < nd ? load_elem(p + j) : 0.f;
  }
}

// Pass 2 over rows [i0, i1) of one source, head dims [d0, d0 + 8 * lpr):
// the normalized probabilities exp2(x - M) / L (times the value scale with
// SCALED, rounded to bf16 with ROUNDP) through shared memory, times the
// values. A lane owns 8 dims of every 32 / lpr-th row; acc[g][j] sums them.
template <typename E, bool SCALED, bool ROUNDP>
__device__ __forceinline__ void split_products(
    const E* __restrict__ kb, const E* __restrict__ vb, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* cols, const int* __restrict__ tp, int lo, int hi,
    int i0, int i1, int G, int hd, bool vec, const float* qs, const float (&M)[kSplitGroup],
    const float (&L)[kSplitGroup], float* pw, int d0, int lpr, float (&acc)[kSplitGroup][kDims]) {
  constexpr int GM = kSplitGroup;
  const int lane = threadIdx.x & 31, rpw = 32 / lpr, grp = lane / lpr;
  const int d = d0 + (lane % lpr) * kDims, nd = hd - d;
  for (int t0 = i0; t0 < i1; t0 += 32) {
    float x[GM];
    long long r;
    const bool ok =
        split_logits<E, SCALED>(kb, ksc, cols, tp, lo, hi, t0, i1, G, hd, vec, qs, x, r);
    const unsigned okm = __ballot_sync(0xffffffffu, ok);
    const float vs = SCALED && ok ? __ldg(vsc + r) : 1.f;
    float p[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float e = ok && g < G ? exp2f(x[g] - M[g]) / L[g] : 0.f;
      if (SCALED) e *= vs;
      if (ROUNDP) e = round_to<__nv_bfloat16>(e);
      p[g] = e;
    }
    *reinterpret_cast<float4*>(pw + lane * GM) = make_float4(p[0], p[1], p[2], p[3]);
    __syncwarp();
    for (int u0 = 0; u0 < lpr; u0 += 4) {
      float vf[4][kDims];
      bool use[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = (u0 + u) * rpw + grp;
        use[u] = u0 + u < lpr && nd > 0 && ((okm >> jj) & 1u);
        if (use[u]) {
          const long long rv = cols ? cols[t0 + jj] : t0 + jj;
          load_vals(vb + rv * hd + d, vec, nd, vf[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!use[u]) continue;
        const float4 pp = *reinterpret_cast<const float4*>(pw + ((u0 + u) * rpw + grp) * GM);
        const float pg[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int j = 0; j < kDims; ++j) acc[g][j] = fmaf(pg[g], vf[u][j], acc[g][j]);
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }
}

// Grid (splits, n_kv * group tiles, B); a cluster is the `splits` blocks of
// one (row, kv head, group tile). T: q and out; HT: the history (T, int8
// with scales, or bf16 under f32); TT: the tail (T, or bf16 under f32).
// Dynamic shared memory: q of the tile [gt][hd] in f32, then the compacted
// tail columns (W of them, when `compact`).
template <typename T, typename HT, typename TT>
__global__ void __launch_bounds__(kThreads)
decode_attn_split_kernel(const T* __restrict__ q, const HT* __restrict__ k_hist,
                         const HT* __restrict__ v_hist, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, long long hsb, long long hsh,
                         long long ssb, long long ssh, const TT* __restrict__ k_tail,
                         const TT* __restrict__ v_tail, const int* __restrict__ pos,
                         const int* __restrict__ flushed, const int* __restrict__ tail_pos,
                         T* __restrict__ out, int H, int n_kv, int hd, int lim, int W, int gt,
                         bool compact, bool vec_h, bool vec_t) {
  constexpr bool KV8 = sizeof(HT) == 1;
  constexpr bool ROUND = sizeof(T) == 4 && sizeof(TT) == 2;  // f32 over a bf16 tail
  constexpr int GM = kSplitGroup;
  extern __shared__ float4 dyn[];
  float* qs = reinterpret_cast<float*>(dyn);
  int* cols = reinterpret_cast<int*>(qs + ((gt * hd + 3) & ~3));
  __shared__ int n_tail;
  __shared__ alignas(16) float pw[kWarps][32][GM];
  __shared__ float part[ROUND ? 2 : 1][kWarps][GM][kSlab];  // the warps' sums, history then tail
  __shared__ float blk[ROUND ? 2 : 1][GM][kSlab];           // the block's, for the cluster
  __shared__ float part_m[kWarps][GM], part_l[kWarps][GM];
  __shared__ float blk_m[GM], blk_l[GM], fin_m[GM], fin_l[GM];

  const int split = blockIdx.x, splits = gridDim.x, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G_all = H / n_kv, tiles = (G_all + gt - 1) / gt;
  const int h = blockIdx.y / tiles, g0 = (blockIdx.y % tiles) * gt, G = min(gt, G_all - g0);
  const int p_b = __ldg(pos + b), f_b = __ldg(flushed + b);
  const int n_h = max(0, min(f_b, lim));
  const int* tp = tail_pos + (long long)b * W;

  if (compact) {  // the valid tail columns, in column order (as the tuned kernel)
    if (warp == 0) {
      int cnt = 0;
      for (int c0 = 0; c0 < W; c0 += 128) {
        int t[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = c0 + 32 * k + lane;
          t[k] = c < W ? __ldg(tp + c) : -1;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = t[k] >= 0 && t[k] >= f_b && t[k] <= p_b;
          const unsigned mask = __ballot_sync(0xffffffffu, ok);
          if (ok) cols[cnt + __popc(mask & ((1u << lane) - 1u))] = c0 + 32 * k + lane;
          cnt += __popc(mask);
        }
      }
      if (lane == 0) n_tail = cnt;
    }
  } else if (threadIdx.x == 0) {
    n_tail = W;  // every column, masked one by one
  }
  // q in log2 units: scaled by hd^-0.5 and log2(e), so exp2 gives the softmax.
  const float qscale = (float)(1.4426950408889634 / sqrt((double)hd));
  const T* qb = q + ((long long)b * H + h * G_all + g0) * hd;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) qs[i] = to_f(qb[i]) * qscale;
  __syncthreads();

  // This warp's chunk [i0, i1) of the n positions: history rows first, then
  // the tail (compacted, or every column with its mask).
  const int n = n_h + n_tail, nw = splits * kWarps, wg = split * kWarps + warp;
  const int i0 = (int)((long long)wg * n / nw), i1 = (int)((long long)(wg + 1) * n / nw);
  const int h0 = i0, h1 = min(i1, n_h), t0 = max(i0, n_h) - n_h, t1 = i1 - n_h;
  const long long hoff = b * hsb + h * hsh, soff = b * ssb + h * ssh;
  const long long toff = ((long long)b * n_kv + h) * W * hd;
  const HT *kh = k_hist + hoff, *vh = v_hist + hoff;
  const TT *kt = k_tail + toff, *vt = v_tail + toff;
  const float* ksc = KV8 ? k_scale + soff : nullptr;
  const float* vsc = KV8 ? v_scale + soff : nullptr;
  const int* tcols = compact ? cols : nullptr;
  const int* tmask = compact ? nullptr : tp;
  cg::cluster_group cluster = cg::this_cluster();

  // Pass 1, then the statistics: warps in order, then ranks in order.
  float m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  split_stats<HT, KV8>(kh, ksc, nullptr, nullptr, 0, 0, h0, h1, G, hd, vec_h, qs, m, l);
  split_stats<TT, false>(kt, nullptr, tcols, tmask, f_b, p_b, t0, t1, G, hd, vec_t, qs, m, l);
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    l[g] = warp_sum(l[g]);
    if (lane == 0) {
      part_m[warp][g] = m[g];
      part_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float Mb = -INFINITY, Lb = 0.f;
    for (int w = 0; w < kWarps; ++w) Mb = fmaxf(Mb, part_m[w][g]);
    for (int w = 0; w < kWarps; ++w)
      Lb = fmaf(part_l[w][g], part_m[w][g] == -INFINITY ? 0.f : exp2f(part_m[w][g] - Mb), Lb);
    (splits == 1 ? fin_m : blk_m)[g] = Mb;
    (splits == 1 ? fin_l : blk_l)[g] = Lb;
  }
  if (splits > 1) {
    cluster.sync();
    if (threadIdx.x < G) {  // every rank's pair loaded at once, then combined in rank order
      const int g = threadIdx.x;
      float mr[kMaxSplits], lr[kMaxSplits], Mc = -INFINITY, Lc = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        mr[r] = r < splits ? *cluster.map_shared_rank(&blk_m[g], r) : -INFINITY;
        lr[r] = r < splits ? *cluster.map_shared_rank(&blk_l[g], r) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) Mc = fmaxf(Mc, mr[r]);
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        if (r < splits) Lc = fmaf(lr[r], mr[r] == -INFINITY ? 0.f : exp2f(mr[r] - Mc), Lc);
      fin_m[g] = Mc;
      fin_l[g] = Lc;
    }
  }
  __syncthreads();
  float M[GM], L[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    M[g] = g < G ? fin_m[g] : 0.f;
    L[g] = g < G ? fin_l[g] : 1.f;
  }

  // Pass 2, slab by slab: lpr lanes (a power of two) cover a row's slab.
  int lpr = 1;
  while (lpr * kDims < kSlab && lpr * kDims < hd) lpr *= 2;
  const int sw = lpr * kDims, sub = lane % lpr;
  const int rank = splits > 1 ? (int)cluster.block_rank() : 0;
  for (int d0 = 0; d0 < hd; d0 += sw) {
    float acc_h[GM][kDims], acc_t[GM][kDims];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc_h[g][j] = acc_t[g][j] = 0.f;
    float* pwarp = &pw[warp][0][0];
    split_products<HT, KV8, false>(kh, vh, ksc, vsc, nullptr, nullptr, 0, 0, h0, h1, G, hd, vec_h,
                                   qs, M, L, pwarp, d0, lpr, acc_h);
    split_products<TT, false, ROUND>(kt, vt, nullptr, nullptr, tcols, tmask, f_b, p_b, t0, t1, G,
                                     hd, vec_t, qs, M, L, pwarp, d0, lpr, ROUND ? acc_t : acc_h);
    // The warp's sums (fixed shuffle trees over the row groups), then the
    // block's: the warps in order.
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        for (int o = lpr; o < 32; o <<= 1) {
          acc_h[g][j] += __shfl_xor_sync(0xffffffffu, acc_h[g][j], o);
          if (ROUND) acc_t[g][j] += __shfl_xor_sync(0xffffffffu, acc_t[g][j], o);
        }
        if (lane < lpr) {
          part[0][warp][g][sub * kDims + j] = acc_h[g][j];
          if (ROUND) part[ROUND ? 1 : 0][warp][g][sub * kDims + j] = acc_t[g][j];
        }
      }
    }
    __syncthreads();
    // history + bf16(tail), rounded once to T
    auto result = [](float a_h, float a_t) {
      return from_f<T>(ROUND ? a_h + round_to<__nv_bfloat16>(a_t) : a_h);
    };
    T* ob = out + ((long long)b * H + h * G_all + g0) * hd + d0;
    for (int idx = threadIdx.x; idx < G * sw; idx += kThreads) {
      const int g = idx / sw, dd = idx % sw;
      float a_h = 0.f, a_t = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        a_h += part[0][w][g][dd];
        if (ROUND) a_t += part[ROUND ? 1 : 0][w][g][dd];
      }
      if (splits == 1) {
        if (d0 + dd < hd) ob[g * hd + dd] = result(a_h, a_t);
      } else {
        blk[0][g][dd] = a_h;
        if (ROUND) blk[ROUND ? 1 : 0][g][dd] = a_t;
      }
    }
    if (splits > 1) {  // the cluster's blocks in rank order, through distributed shared memory
      cluster.sync();
      for (int idx = rank * kThreads + threadIdx.x; idx < G * sw; idx += splits * kThreads) {
        const int g = idx / sw, dd = idx % sw;
        float ah[kMaxSplits], at[kMaxSplits], a_h = 0.f, a_t = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxSplits; ++r) {  // every rank's sums loaded at once
          ah[r] = r < splits ? *cluster.map_shared_rank(&blk[0][g][dd], r) : 0.f;
          at[r] = ROUND && r < splits ? *cluster.map_shared_rank(&blk[ROUND ? 1 : 0][g][dd], r) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kMaxSplits; ++r) {
          if (r >= splits) break;
          a_h += ah[r];
          a_t += at[r];
        }
        if (d0 + dd < hd) ob[g * hd + dd] = result(a_h, a_t);
      }
      cluster.sync();  // no block rewrites or leaves while another still reads its sums
    } else {
      __syncthreads();  // part is rewritten by the next slab
    }
  }
}

struct SplitCall {
  int gt, tiles, splits;
  bool compact, vec_h, vec_t;
  size_t smem;
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// With c == nullptr: room for q and kMaxW compacted columns, and the
// variant's occupancy into *occ (setup).
template <typename T, typename HT, typename TT>
int launch_split(const Call* c, int* occ) {
  const auto kern = decode_attn_split_kernel<T, HT, TT>;
  if (c == nullptr) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSplitQBytes + kMaxW * (int)sizeof(int));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, kThreads, 0);
  }
  const int hd = c->hd, G_all = c->H / c->n_kv;
  const int gt = min(min(G_all, kSplitGroup), max(1, kSplitQBytes / (4 * hd)));
  const int tiles = (G_all + gt - 1) / gt;
  const int splits = choose_splits(c->B * c->n_kv * tiles, c->lim + c->W, g_sms * *occ);
  const bool compact = c->W <= kMaxW;
  // 16-byte loads where every row of a source starts on 16 bytes and holds
  // whole 8-element groups
  const long long eh = sizeof(HT), et = sizeof(TT);
  const bool vec_h = hd % 8 == 0 && hd * eh % 16 == 0 && c->hsb * eh % 16 == 0 &&
                     c->hsh * eh % 16 == 0 && aligned16(c->k_hist) && aligned16(c->v_hist);
  const bool vec_t =
      hd % 8 == 0 && hd * et % 16 == 0 && aligned16(c->k_tail) && aligned16(c->v_tail);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, c->n_kv * tiles, c->B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      (size_t)((gt * hd + 3) & ~3) * sizeof(float) + (compact ? (size_t)c->W * sizeof(int) : 0);
  cfg.stream = c->stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const T*)c->q, (const HT*)c->k_hist, (const HT*)c->v_hist, c->k_scale,
      c->v_scale, c->hsb, c->hsh, c->ssb, c->ssh, (const TT*)c->k_tail, (const TT*)c->v_tail,
      c->pos, c->flushed, c->tail_pos, (T*)c->out, c->H, c->n_kv, hd, c->lim, c->W, gt, compact,
      vec_h, vec_t);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// dtype: 0 f32, 1 bf16 (q, out); hist as smoltts_decode_attention takes it.
int split_route(const Call* c, int dtype, int hist) {
  using bf16 = __nv_bfloat16;
  int* occ = &g_split_occ[hist * 2 + dtype];
  switch (hist * 2 + dtype) {
    case 0: return launch_split<float, float, float>(c, occ);
    case 1: return launch_split<bf16, bf16, bf16>(c, occ);
    case 2: return launch_split<float, int8_t, float>(c, occ);
    case 3: return launch_split<bf16, int8_t, bf16>(c, occ);
    case 4: return launch_split<float, bf16, bf16>(c, occ);
    case 6: return launch_split<float, int8_t, bf16>(c, occ);
  }
  return (int)cudaErrorInvalidValue;
}

// The tuned kernel for head dims 32, 64 and 128 over a history of the
// compute dtype or int8 and a tail of at most kMaxW columns; the split
// route for the rest (kernel_plan in ops/attention.py holds the same rule).
int dispatch(const Call* c, int dtype, int hist, int hd, int G) {
  using bf16 = __nv_bfloat16;
  if (dtype < 0 || dtype > 1 || hist < 0 || hist > 3 || (hist >= 2 && dtype != 0))
    return (int)cudaErrorInvalidValue;
  if (hist <= 1 && (hd == 32 || hd == 64 || hd == 128) && (c == nullptr || c->W <= kMaxW)) {
    if (dtype == 1 && hist == 1) return by_shape<bf16, int8_t, true, 1, 1>(c, hd, G);
    if (dtype == 1 && hist == 0) return by_shape<bf16, bf16, false, 1, 0>(c, hd, G);
    if (dtype == 0 && hist == 1) return by_shape<float, int8_t, true, 0, 1>(c, hd, G);
    return by_shape<float, float, false, 0, 0>(c, hd, G);
  }
  return split_route(c, dtype, hist);
}

}  // namespace

// The SM count and every variant's resident blocks per SM, queried once when
// the library is loaded; the split of each call is chosen from them.
extern "C" int smoltts_decode_attention_setup() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  static const int kHds[3] = {64, 128, 32};
  for (int v = 0; v < 24; ++v) {  // (dtype, hist, group) by bits, then hd
    const int r = dispatch(nullptr, v & 1, (v >> 1) & 1, kHds[v >> 3], v & 4 ? 8 : 3);
    if (r != 0) return r;
  }
  for (int v = 0; v < 8; ++v) {  // the split variants, by hist * 2 + dtype
    if (v == 5 || v == 7) continue;  // bf16 compute over a bf16 history takes hist 0
    const int r = split_route(nullptr, v & 1, v >> 1);
    if (r != 0) return r;
  }
  return 0;
}

// dtype: 0 = f32, 1 = bf16 (q, tail, out). hist: 0 = same as dtype, 1 = int8
// with f32 scales; under f32 compute also 2 = bf16 history and tail, 3 = int8
// history and a bf16 tail (the split route, rounding as the plain version).
// Any B, H, n_kv with n_kv dividing H, head_dim up to kMaxHd, and any tail
// length.
extern "C" int smoltts_decode_attention(const void* q, const void* k_hist, const void* v_hist,
                                        const float* k_scale, const float* v_scale,
                                        long long hsb, long long hsh, long long ssb,
                                        long long ssh, const void* k_tail, const void* v_tail,
                                        const int* pos, const int* flushed, const int* tail_pos,
                                        void* out, int B, int H, int n_kv, int hd, int lim,
                                        int W, int dtype, int hist, cudaStream_t stream) {
  (void)cudaGetLastError();
  if (n_kv <= 0 || H <= 0 || H % n_kv != 0 || hd <= 0 || hd > kMaxHd || W < 0 || lim < 0 ||
      B < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (g_sms == 0) return (int)cudaErrorInitializationError;  // setup not run
  if (B == 0) return 0;
  const Call c{q,   k_hist,  v_hist,   k_scale, v_scale, hsb, hsh, ssb, ssh, k_tail, v_tail,
               pos, flushed, tail_pos, out,     B,       H,   n_kv, hd, lim, W,    stream};
  return dispatch(&c, dtype, hist, hd, H / n_kv);
}
