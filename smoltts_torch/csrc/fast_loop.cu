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
// counter (column, row, level); argmax ties go to the lowest index. One
// difference: the Pallas kernel also rounds k, v and the RoPE partner of q
// and k to the compute dtype (its 0/1 structure matmuls run in that dtype,
// smoltts_tpu/ops/fast_loop.py:144, 154-157); this port keeps them in f32.
//
// Bound on an H100, as chip_smoke.py computes it at 150M, B=64: operations,
// 0.0375 ms (37.0 GFLOP per frame at 989 TFLOP/s bf16, against 48.2 MB of
// weights read once, 0.0144 ms at 3.35 TB/s). That is the least time. A
// design that re-reads the int8 trunk from device memory at every level
// moves ~290 MB per frame (~87 us); the trunk (34.6 MB) fits the 50 MB L2.
// What the card actually spends is latency: each product is a chain of
// dependent global round trips and barriers, against well under 1 us of
// tensor-core work (PERF.md has the measured breakdown).
//
// Design: a fixed sequence of kernels per frame, issued by one host call on
// the caller's stream: one init, then per level 5 per layer (qkv, attention,
// wo, w13, w2) and 2 more (head, sample): 177 at 150M (was 385). What was
// folded, and why this path:
// - each RMSNorm is folded into the GEMM that consumes it. The producer of
//   h (the wo / w2 epilogue, the init and the sample kernels) leaves per-row
//   sums of squares per 128-column tile (`ssq`); the consumer's prologue sums
//   those in a fixed order and scales its staged activations. Recomputing
//   the norm in every consumer block would re-read the whole [B, D] row
//   block from L2 once per block (~24 MB per product at 150M).
// - split-K is reduced inside the GEMM, deterministically, through shared
//   memory: the K slices of one output tile run as one thread-block cluster;
//   each block leaves its f32 sums in its own shared memory, and after a
//   cluster barrier block z sums rows [z * 64 / ks, (z + 1) * 64 / ks) of the
//   tile over all slices in slice order (distributed shared memory reads) and
//   runs the epilogue on them. No partial sums go to global memory, and there
//   are no counters, fences or atomics. A first version reduced through L2 (a
//   per-tile arrival counter, the last block summing the slices); on the
//   H100 that chain (store, fence, atomic, the last block's reads) was a
//   large share of every product, which the cluster exchange removes.
// - the split is the most slices (a power of two up to 16, each of at least
//   2 K steps) for which every tile's cluster is resident at once, asked of
//   cudaOccupancyMaxActiveClusters once at load: a second wave costs a whole
//   product's latency again.
// - kernels launch with programmatic dependent launch: each GEMM prefetches
//   its first weight stages and its scales (constants) while the previous
//   kernel finishes, then waits (griddepcontrol.wait) before it touches
//   anything an earlier kernel wrote.
// - the attention output and the SwiGLU output are written in the compute
//   dtype (their consumers round them to it anyway), so wo and w2 stage their
//   activations with cp.async straight into shared memory.
// - attention stays its own kernel (one block per (kv head, row)): folding it
//   into the wo prologue would repeat it in every wo column tile, and the qkv
//   tiles split a head's q, k and v. A persistent kernel with grid barriers
//   would take the count to ~1; a CUDA graph of the whole step (which also
//   removes the host's launch time) is the next step.
// GEMM tiles: a block owns 64 rows x 128 columns of one projection (of both
// halves of w13) and a K slice. int8 weights move into shared memory by
// 16-byte cp.async in a ring of 4 stages of 32 K rows, swizzled in 16-byte
// chunks so the fragment loads hit 32 distinct banks. The activation tile is
// staged once per block (in panels of 512 K for bf16, 256 for f32) in the
// compute dtype, rounded as above, with the norm applied. Epilogues run on
// the f32 sums: the per-column scale, silu(gate) * up for w13, the residual
// add (and the row sums of squares) for wo and w2.
// bf16 products run on the tensor cores as mma.sync.m16n8k16 bf16 x bf16 ->
// f32, chosen over wgmma because a block's work is tiny (3-12 K steps; the
// product is latency-bound, not issue-bound) and because mma.sync lets the
// int8 -> bf16 conversion happen in registers on the way to the fragments:
// wgmma reads B from shared memory, which would need a second, converted
// copy of every weight tile. Fragment layout: the reduction order inside a
// k16 step is free, so logical k (2t, 2t+1, 2t+8, 2t+9) of thread t maps to
// the physical rows 4t..4t+3; the output columns of the four n8 tiles of a
// warp interleave (fragment column x of tile j is column 4x + j). A thread
// then loads four 32-bit words (rows 4t..4t+3, columns 4g..4g+3), transposes
// the 4x4 bytes with byte permutes and converts them into the B fragments of
// all four n8 tiles; its A fragments are one 8-byte load per 8 rows.
// The f32 compute dtype keeps exact f32 FMAs on the CUDA cores (no TF32),
// with the same staging, split-K and epilogues: it is the exactness
// yardstick (chip_smoke.py phases 3 and 6), never the main path.
// Kernel attributes (dynamic shared memory above 48 KB, the carveout,
// clusters of 16) are set once at load (smoltts_fast_loop_setup), never
// inside the launch sequence.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

using namespace smoltts;
namespace cg = cooperative_groups;

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
  float* ssq;     // [ceil(D / 128), B] sums of squares of h per 128-column tile
  float* qkv;     // [B, D + 2 KV hd]
  void* att;      // [B, D] compute dtype (the wo input, rounded as wo would)
  void* act;      // [B, F] compute dtype (the w2 input)
  float* kc;      // [L, n, B, KV hd]
  float* vc;
  float* logits;  // [B, CB]
  int* codes;     // [B, n]
};

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N, 32 x 32 each
constexpr int BM = 64, BN = 128, BK = 32, STAGES = 4;
constexpr int kAcc = 32;  // f32 sums per thread and weight matrix (64 x 128 / 256)
constexpr int kMaxSplit = 16;  // K slices (a power of two): the largest cluster an H100 takes
constexpr int kSplits = 5;     // cluster sizes 1, 2, 4, 8, 16
constexpr int TPITCH = BN + 4;      // f32 row pitch of the exchanged sum tile

// Activation panel in shared memory: KA columns of the compute dtype, rows
// padded so the fragment loads of 4 consecutive rows fall on distinct banks.
template <typename CDT> struct Panel;
template <> struct Panel<__nv_bfloat16> { static constexpr int KA = 512, PITCH = KA + 16; };
template <> struct Panel<float> { static constexpr int KA = 256, PITCH = KA + 4; };

// Dynamic shared memory: the weight ring and the activation panel, which after
// the main loop hold the block's f32 sums ([NW][BM][TPITCH]) for its cluster,
// then the row rsqrt.
template <typename CDT, bool DUAL>
__host__ __device__ constexpr int sums_offset() {  // = the [BM] row rsqrt after them
  return STAGES * (DUAL ? 2 : 1) * BK * BN + BM * Panel<CDT>::PITCH * (int)sizeof(CDT) >
                 (DUAL ? 2 : 1) * BM * TPITCH * 4
             ? STAGES * (DUAL ? 2 : 1) * BK * BN + BM * Panel<CDT>::PITCH * (int)sizeof(CDT)
             : (DUAL ? 2 : 1) * BM * TPITCH * 4;
}
template <typename CDT, bool DUAL>
__host__ __device__ constexpr int smem_bytes() {
  return sums_offset<CDT, DUAL>() + BM * 4;
}

struct GemmArgs {
  const void* x;  // [M, K] activations: f32 with NORM, else already the compute dtype
  int M, K;
  const float* ssq;  // NORM: [nt, M] row sums of squares of x per 128 columns
  const void* nw;    // NORM: norm weight [K]
  int nt;
  float eps;
  const int8_t* w;
  const float* s;  // [K, ldw] int8, [N] scale
  const int8_t* w2;
  const float* s2;  // DUAL: the up half
  int ldw, N;
  void* y;         // [M, N]: the compute dtype for DUAL, else f32; RESID: y += product
  float* ssq_out;  // RESID: [ceil(N / 128), M] row sums of squares of the new y
  int kchunk, ks;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Programmatic dependent launch: a kernel may start while the previous one
// in the stream finishes; it reads nothing that an earlier kernel writes, and
// writes nothing, before wait_prior(). allow_next() lets the next kernel start.
__device__ __forceinline__ void wait_prior() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void allow_next() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// 16 bytes at `p` in the shared memory of cluster block `rank`.
__device__ __forceinline__ float4 ld_cluster(const float* p, int rank) {
  uint32_t a = (uint32_t)__cvta_generic_to_shared(p), r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(r)
               : "memory");
  return v;
}

// Two int8 (bytes `lo`, `lo + 1` of w) -> bf16x2, exact.
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w, int lo) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)(signed char)(w >> (8 * lo)),
                                                 (float)(signed char)(w >> (8 * lo + 8)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// q[r] holds bytes (row r, columns 0..3); afterwards q[c] holds (rows 0..3, column c).
__device__ __forceinline__ void transpose4x4(uint32_t (&q)[4]) {
  const uint32_t a = __byte_perm(q[0], q[1], 0x5140), b = __byte_perm(q[0], q[1], 0x7362);
  const uint32_t c = __byte_perm(q[2], q[3], 0x5140), d = __byte_perm(q[2], q[3], 0x7362);
  q[0] = __byte_perm(a, c, 0x5410);
  q[1] = __byte_perm(a, c, 0x7632);
  q[2] = __byte_perm(b, d, 0x5410);
  q[3] = __byte_perm(b, d, 0x7632);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// Four values to 16 (f32) or 8 (bf16, rounded) aligned bytes.
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// 16-byte chunk swizzle of a weight tile row (rows of 128 bytes = 8 chunks).
__device__ __forceinline__ int swz(int row) { return ((row >> 2) & 3) << 1; }

// Tile-local (row, column) of sum e of this thread.
template <typename CDT> __device__ __forceinline__ int row_of(int e);
template <typename CDT> __device__ __forceinline__ int col_of(int e);
template <> __device__ __forceinline__ int row_of<__nv_bfloat16>(int e) {
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) >> 2;
  return wm * 32 + (e >> 4) * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
}
template <> __device__ __forceinline__ int col_of<__nv_bfloat16>(int e) {
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) & 3;
  return wn * 32 + (lane & 3) * 8 + (e & 1) * 4 + ((e >> 2) & 3);
}
template <> __device__ __forceinline__ int row_of<float>(int e) {
  return (threadIdx.x >> 4) * 4 + (e >> 3);
}
template <> __device__ __forceinline__ int col_of<float>(int e) {
  return (threadIdx.x & 15) * 8 + (e & 7);
}
// Sum j of this thread's q-th run of four adjacent columns (q < kAcc / 4):
// in the mma layout the four n8 tiles of one fragment element.
template <typename CDT> __device__ __forceinline__ int quad(int q, int j) {
  return std::is_same<CDT, float>::value ? 4 * q + j : (q >> 2) * 16 + 4 * j + (q & 3);
}

// One BK step on the tensor cores: acc[m][(mi * 4 + nj) * 4 + c].
template <int NW>
__device__ __forceinline__ void step_mma(const __nv_bfloat16* As, const unsigned char* Ws, int kl,
                                         float (&acc)[NW][kAcc]) {
  constexpr int PITCH = Panel<__nv_bfloat16>::PITCH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int s = 0; s < BK / 16; ++s) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r0 = wm * 32 + mi * 16 + g;
      const uint2 lo = *reinterpret_cast<const uint2*>(As + r0 * PITCH + kl + s * 16 + 4 * t);
      const uint2 hi = *reinterpret_cast<const uint2*>(As + (r0 + 8) * PITCH + kl + s * 16 + 4 * t);
      a[mi][0] = lo.x;
      a[mi][2] = lo.y;
      a[mi][1] = hi.x;
      a[mi][3] = hi.y;
    }
#pragma unroll
    for (int m = 0; m < NW; ++m) {
      const unsigned char* W = Ws + m * BK * BN;
      uint32_t q[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = s * 16 + 4 * t + r;
        q[r] = *reinterpret_cast<const uint32_t*>(
            W + row * BN + (((2 * wn + (g >> 2)) ^ swz(row)) << 4) + 4 * (g & 3));
      }
      transpose4x4(q);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const uint32_t b0 = i8x2_bf16x2(q[nj], 0), b1 = i8x2_bf16x2(q[nj], 2);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(&acc[m][(mi * 4 + nj) * 4], a[mi], b0, b1);
      }
    }
  }
}

// One BK step of exact f32 FMAs: acc[m][r * 8 + c] for rows 4 ty + r, columns 8 tx + c.
template <int NW>
__device__ __forceinline__ void step_fma(const float* As, const unsigned char* Ws, int kl,
                                         float (&acc)[NW][kAcc]) {
  constexpr int PITCH = Panel<float>::PITCH;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = As[(ty * 4 + r) * PITCH + kl + kk];
#pragma unroll
    for (int m = 0; m < NW; ++m) {
      const uint2 wv = *reinterpret_cast<const uint2*>(
          Ws + m * BK * BN + kk * BN + (((tx >> 1) ^ swz(kk)) << 4) + 8 * (tx & 1));
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float b = (float)(signed char)((c < 4 ? wv.x : wv.y) >> (8 * (c & 3)));
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[m][r * 8 + c] = fmaf(a[r], b, acc[m][r * 8 + c]);
      }
    }
  }
}

// y[M, N] = (round_cdt(xn[M, K]) @ w[K, N(ldw)]) * s[N] (+ y), or with DUAL
// silu(xn @ w * s) * (xn @ w2 * s2); xn = NORM ? rmsnorm(x) * nw : x.
// Grid (N tiles, M tiles, K slices), launched as clusters of the ks slices
// of one tile: block z covers K rows [z * kchunk, min(K, (z + 1) * kchunk)),
// then, after a cluster barrier, sums rows [z * BM / ks, (z + 1) * BM / ks)
// of the tile over all slices in slice order, reading the other blocks'
// shared memory, and runs the epilogue on them.
template <typename CDT, typename ET, bool NORM, bool DUAL, bool RESID>
__global__ void __launch_bounds__(kThreads) gemm_i8(GemmArgs a) {
  constexpr int NW = DUAL ? 2 : 1;
  constexpr int KA = Panel<CDT>::KA, PITCH = Panel<CDT>::PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scale[NW][BN];  // the tile's per-column scales
  unsigned char* Ws = smem;  // [STAGES][NW][BK][BN] int8, chunk-swizzled rows
  CDT* As = reinterpret_cast<CDT*>(smem + STAGES * NW * BK * BN);  // [BM][PITCH]
  float* rs = reinterpret_cast<float*>(smem + sums_offset<CDT, DUAL>());  // [BM] row rsqrt

  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int M = a.M, K = a.K, N = a.N;
  const int kbeg = z * a.kchunk, kend = min(K, kbeg + a.kchunk);
  const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;  // 0 for an empty last slice
  const int ks = a.ks, R = BM / ks;  // this block's epilogue rows: [z * R, (z + 1) * R)

  auto load_w = [&](int kt) {
    if (kt < nk) {
#pragma unroll
      for (int j = 0; j < BK * (BN / 16) / kThreads; ++j) {  // 16-byte chunks
        const int idx = j * kThreads + tid, row = idx >> 3, ch = idx & 7;
        const int k = kbeg + kt * BK + row, col = n0 + ch * 16;
        const bool ok = k < kend && col < N;
        const long long off = ok ? (long long)k * a.ldw + col : 0;
        unsigned char* dst = Ws + (kt % STAGES) * NW * BK * BN + row * BN + ((ch ^ swz(row)) << 4);
        cp_async16(dst, a.w + off, ok ? 16 : 0);
        if constexpr (DUAL) cp_async16(dst + BK * BN, a.w2 + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // Activations [m0, m0 + BM) x [kbeg + p0, kbeg + p0 + KA) into the panel
  // in the compute dtype, zero past M and kend. Without NORM they already
  // are the compute dtype: 16-byte asynchronous copies. With NORM they are
  // f32 h, normed and rounded here; the loads go out 8 float4 per thread at
  // a time before any is used, and the first batch's overlap the row norms'.
  auto stage_a = [&](int p0) {
    const int kw = min(KA, kend - kbeg - p0);
    if constexpr (!NORM) {
      constexpr int PER = 16 / (int)sizeof(CDT);
      const int chunks = (kw + BK - 1) / BK * BK / PER;
      for (int idx = tid; idx < BM * chunks; idx += kThreads) {
        const int r = idx / chunks, c = (idx - r * chunks) * PER;
        const bool ok = m0 + r < M && c < kw;
        const CDT* src = reinterpret_cast<const CDT*>(a.x) +
                         (ok ? (long long)(m0 + r) * K + kbeg + p0 + c : 0);
        cp_async16(As + r * PITCH + c, src, ok ? 16 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      const float* x = reinterpret_cast<const float*>(a.x);
      const ET* nw = reinterpret_cast<const ET*>(a.nw) + kbeg + p0;
      const int q4 = (kw + BK - 1) / BK * BK / 4;  // float4 columns of the panel
      const int items = BM * q4;
      for (int i0 = 0; i0 < items; i0 += 8 * kThreads) {
        float4 v[8], w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int idx = i0 + j * kThreads + tid, r = idx / q4, c = (idx - r * q4) * 4;
          v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (idx < items && m0 + r < M && c < kw) {
            v[j] = *reinterpret_cast<const float4*>(x + (long long)(m0 + r) * K + kbeg + p0 + c);
            w[j] = load4(nw + c);
          }
        }
        if (p0 == 0 && i0 == 0) {
          if (tid < BM) {
            const int row = m0 + tid;
            float q = 0.f;
            if (row < M) {
              float part[16];
#pragma unroll
              for (int j = 0; j < 16; ++j) part[j] = j < a.nt ? a.ssq[(long long)j * M + row] : 0.f;
              float ss = 0.f;
#pragma unroll
              for (int j = 0; j < 16; ++j)
                if (j < a.nt) ss += part[j];
              for (int j = 16; j < a.nt; ++j) ss += a.ssq[(long long)j * M + row];
              q = rsqrtf(ss / (float)K + a.eps);
            }
            rs[tid] = q;
          }
          __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int idx = i0 + j * kThreads + tid, r = idx / q4, c = (idx - r * q4) * 4;
          if (idx >= items) break;
          if (m0 + r < M && c < kw) {
            const float q = rs[r];
            v[j] = make_float4(v[j].x * q * w[j].x, v[j].y * q * w[j].y, v[j].z * q * w[j].z,
                               v[j].w * q * w[j].w);
          }
          store4(As + r * PITCH + c, v[j]);
        }
      }
    }
  };

  // Before the previous kernel has finished: prefetch the first weight
  // stages and the scales (constant), nothing else.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_w(s);
  for (int c = tid; c < NW * BN; c += kThreads) {
    const int m = c / BN, col = n0 + c % BN;
    scale[m][c % BN] = col < N ? (m == 0 ? a.s : a.s2)[col] : 0.f;
  }
  wait_prior();
  allow_next();
  // The residual rows of this block's epilogue (written by earlier kernels).
  float4 res[RESID ? 8 : 1];
  if constexpr (RESID) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = j * kThreads + tid, row = m0 + z * R + q / 32, col = n0 + (q % 32) * 4;
      res[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < R * (BN / 4) && row < M && col < N)
        res[j] = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(a.y) +
                                                  (long long)row * N + col);
    }
  }
  if (nk > 0) stage_a(0);

  float acc[NW][kAcc];
#pragma unroll
  for (int m = 0; m < NW; ++m)
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[m][e] = 0.f;

  constexpr int PSTEPS = KA / BK;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt > 0 && kt % PSTEPS == 0) {
      __syncthreads();
      stage_a(kt * BK);
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_w(kt + STAGES - 1);
    const unsigned char* W = Ws + (kt % STAGES) * NW * BK * BN;
    const int kl = (kt % PSTEPS) * BK;
    if constexpr (std::is_same<CDT, float>::value) step_fma<NW>(As, W, kl, acc);
    else step_mma<NW>(As, W, kl, acc);
  }

  // Exchange the slices' sums through the cluster's shared memory.
  cp_async_wait<0>();
  __syncthreads();
  float* T = reinterpret_cast<float*>(smem);  // [NW][BM][TPITCH], over the ring and the panel
#pragma unroll
  for (int m = 0; m < NW; ++m)
#pragma unroll
    for (int q = 0; q < kAcc / 4; ++q) {
      const int e = quad<CDT>(q, 0);
      store4(T + (m * BM + row_of<CDT>(e)) * TPITCH + col_of<CDT>(e),
             make_float4(acc[m][e], acc[m][quad<CDT>(q, 1)], acc[m][quad<CDT>(q, 2)],
                         acc[m][quad<CDT>(q, 3)]));
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();

  // Epilogue on rows [z * R, (z + 1) * R): one warp per row and pass, 4
  // columns per lane. RESID also leaves each row's sum of squares for the
  // next norm (one warp's fixed shuffle tree over the tile's 128 columns).
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = j * kThreads + tid, rl = z * R + q / 32, c = (q % 32) * 4;
    if (q >= R * (BN / 4)) break;  // whole warps drop out together
    const int row = m0 + rl, col = n0 + c;
    float4 t[NW];
#pragma unroll
    for (int m = 0; m < NW; ++m) {
      float4 u[kMaxSplit];  // every slice's loads in flight, then the sum in slice order
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        if (r < ks)
          u[r] = ld_cluster(T + (m * BM + rl) * TPITCH + c, r);
      t[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        if (r < ks) {
          t[m].x += u[r].x;
          t[m].y += u[r].y;
          t[m].z += u[r].z;
          t[m].w += u[r].w;
        }
    }
    float4 v = make_float4(t[0].x * scale[0][c], t[0].y * scale[0][c + 1],
                           t[0].z * scale[0][c + 2], t[0].w * scale[0][c + 3]);
    if constexpr (DUAL) {
      const float4 u = make_float4(t[1].x * scale[1][c], t[1].y * scale[1][c + 1],
                                   t[1].z * scale[1][c + 2], t[1].w * scale[1][c + 3]);
      v.x = v.x * (1.f / (1.f + expf(-v.x))) * u.x;
      v.y = v.y * (1.f / (1.f + expf(-v.y))) * u.y;
      v.z = v.z * (1.f / (1.f + expf(-v.z))) * u.z;
      v.w = v.w * (1.f / (1.f + expf(-v.w))) * u.w;
    }
    if constexpr (RESID) {
      v.x = res[j].x + v.x;
      v.y = res[j].y + v.y;
      v.z = res[j].z + v.z;
      v.w = res[j].w + v.w;
    }
    const bool ok = row < M && col < N;
    if (ok) {
      if constexpr (DUAL) store4(reinterpret_cast<CDT*>(a.y) + (long long)row * N + col, v);
      else store4(reinterpret_cast<float*>(a.y) + (long long)row * N + col, v);
    }
    if constexpr (RESID) {
      const float sq = warp_sum(ok ? v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w : 0.f);
      if (lane == 0 && row < M) a.ssq_out[(long long)blockIdx.x * M + row] = sq;
    }
  }
  cluster.sync();  // the other blocks have finished reading this block's sums
}

// Sums of squares of one row of h per 128-column tile, in a fixed order.
__device__ void row_ssq(const float* hr, int D, float* ssq, int B, int b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int j = warp; j * BN < D; j += nw) {
    float acc = 0.f;
    for (int c = j * BN + lane; c < min(D, (j + 1) * BN); c += 32) acc += hr[c] * hr[c];
    acc = warp_sum(acc);
    if (lane == 0) ssq[(long long)j * B + b] = acc;
  }
}

// One block per row: h = hidden and its sums of squares.
template <typename CDT>
__global__ void init_h(const CDT* __restrict__ hidden, float* __restrict__ h, float* ssq, int B,
                       int D) {
  const int b = blockIdx.x;
  wait_prior();
  allow_next();
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    h[(long long)b * D + d] = to_f(hidden[(long long)b * D + d]);
  __syncthreads();
  row_ssq(h + (long long)b * D, D, ssq, B, b);
}

// One block per (kv head, row): RoPE on q and k at position i, cache the
// level's k/v, attend over levels 0..i for the group's query heads; the
// output is rounded to the compute dtype, as the wo product would round it.
template <typename CDT>
__global__ void fast_attn(const float* __restrict__ qkv, float* __restrict__ kc,
                          float* __restrict__ vc, CDT* __restrict__ att,
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
  wait_prior();
  allow_next();

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
    att[(long long)b * D + (kvh * G + g) * hd + d] = from_f<CDT>(a);
  }
}

// One block per row: pick level i's code, then load the next level's input
// and its sums of squares.
template <typename ET>
__global__ void fast_sample(const float* __restrict__ logits, int CB, int* __restrict__ codes,
                            int B, int n, int i, int greedy, float temp, float log_min_p,
                            int use_min_p, const long long* seed, const ET* __restrict__ wte,
                            float* __restrict__ h, float* ssq, int D) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int b = blockIdx.x;
  const float* l = logits + (long long)b * CB;
  wait_prior();
  allow_next();
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
    __syncthreads();
    row_ssq(h + (long long)b * D, D, ssq, B, b);
  }
}

// How many clusters of 1, 2, 4, 8 and 16 blocks of a GEMM variant the card
// keeps resident at once (cudaOccupancyMaxActiveClusters, asked once at load).
template <typename CDT, typename ET, bool NORM, bool DUAL, bool RESID>
struct Resident {
  static int clusters[kSplits];
};
template <typename CDT, typename ET, bool NORM, bool DUAL, bool RESID>
int Resident<CDT, ET, NORM, DUAL, RESID>::clusters[kSplits] = {};

struct Plan {
  int tn, tm, ks, kchunk;
};

// Tiles and K slices for an [M, N] x K product: the most slices (a power of
// two, each of at least 2 K steps) for which every tile's cluster is resident
// at once, so the product runs in one wave. The last slice may be short or
// empty. Beyond one wave (large M) there is no split.
inline Plan plan_for(int M, int N, int K, const int* resident) {
  Plan p;
  p.tn = (N + BN - 1) / BN;
  p.tm = (M + BM - 1) / BM;
  p.ks = 1;
  for (int i = 1; i < kSplits && K >= 4 * BK * p.ks && p.tn * p.tm <= resident[i]; ++i) p.ks *= 2;
  p.kchunk = ((K + p.ks - 1) / p.ks + BK - 1) / BK * BK;
  return p;
}

// Launch with programmatic stream serialization (see wait_prior) and, for a
// GEMM, clusters of `cluster_z` blocks along z; keeps the first error.
template <typename... Params, typename... Args>
void launch(cudaError_t& err, void (*kernel)(Params...), dim3 grid, int smem, cudaStream_t st,
            int cluster_z, Args... args) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = cluster_z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = cluster_z > 0 ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err == cudaSuccess) err = e;
}

template <typename CDT, typename ET, bool NORM, bool DUAL, bool RESID>
void gemm(cudaError_t& err, GemmArgs g, cudaStream_t st) {
  const Plan p = plan_for(g.M, g.N, g.K, Resident<CDT, ET, NORM, DUAL, RESID>::clusters);
  g.kchunk = p.kchunk;
  g.ks = p.ks;
  launch(err, gemm_i8<CDT, ET, NORM, DUAL, RESID>, dim3(p.tn, p.tm, p.ks),
         smem_bytes<CDT, DUAL>(), st, p.ks, g);
}

template <typename CDT, typename ET>
int run(const FastLoopArgs& a, cudaStream_t st) {
  const int B = a.B, D = a.D, F = a.F, CB = a.CB, Nq = a.D + 2 * a.KV * a.hd;
  const int nt = (D + BN - 1) / BN;
  const ET* anorm = (const ET*)a.anorm;
  const ET* fnorm = (const ET*)a.fnorm;
  cudaError_t err = cudaSuccess;
  launch(err, init_h<CDT>, dim3(B), 0, st, 0, (const CDT*)a.hidden, a.h, a.ssq, B, D);
  GemmArgs g{};
  g.M = B;
  g.nt = nt;
  g.eps = a.eps;
  g.ssq = a.ssq;
  g.ssq_out = a.ssq;
  auto product = [&](const void* x, int K, const void* nw, const int8_t* w, const float* s,
                     const int8_t* w2, const float* s2, int ldw, int N, void* y) {
    g.x = x;
    g.K = K;
    g.nw = nw;
    g.w = w;
    g.s = s;
    g.w2 = w2;
    g.s2 = s2;
    g.ldw = ldw;
    g.N = N;
    g.y = y;
    return g;
  };
  for (int i = 0; i < a.n; ++i) {
    for (int l = 0; l < a.L; ++l) {
      gemm<CDT, ET, true, false, false>(
          err, product(a.h, D, anorm + (long long)l * D, a.wqkv + (long long)l * D * Nq,
                  a.wqkv_s + (long long)l * Nq, nullptr, nullptr, Nq, Nq, a.qkv), st);
      launch(err, fast_attn<CDT>, dim3(a.KV, B), 0, st, 0, (const float*)a.qkv, a.kc, a.vc,
             (CDT*)a.att, a.cos, a.sin, B, D, a.H, a.KV, a.hd, a.n, l, i);
      gemm<CDT, float, false, false, true>(
          err, product(a.att, D, nullptr, a.wo + (long long)l * D * D, a.wo_s + (long long)l * D,
                  nullptr, nullptr, D, D, a.h), st);
      gemm<CDT, ET, true, true, false>(
          err, product(a.h, D, fnorm + (long long)l * D, a.w1 + (long long)l * D * a.ld13,
                  a.w1_s + (long long)l * a.ld13, a.w3 + (long long)l * D * a.ld13,
                  a.w3_s + (long long)l * a.ld13, a.ld13, F, a.act), st);
      gemm<CDT, float, false, false, true>(
          err, product(a.act, F, nullptr, a.w2 + (long long)l * F * D, a.w2_s + (long long)l * D,
                  nullptr, nullptr, D, D, a.h), st);
    }
    gemm<CDT, ET, true, false, false>(
        err, product(a.h, D, a.fast_norm, a.head + (long long)i * D * CB, a.head_s + (long long)i * CB,
                nullptr, nullptr, CB, CB, a.logits), st);
    launch(err, fast_sample<ET>, dim3(B), 0, st, 0, (const float*)a.logits, CB, a.codes, B, a.n, i,
           a.greedy, a.temp, a.log_min_p, a.use_min_p, a.seed, (const ET*)a.wte, a.h, a.ssq, D);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Dynamic shared memory above 48 KB, the whole carveout as shared memory,
// clusters of up to 16 blocks, and how many of them stay resident.
template <typename CDT, typename ET, bool NORM, bool DUAL, bool RESID>
int allow_smem() {
  const auto k = gemm_i8<CDT, ET, NORM, DUAL, RESID>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes<CDT, DUAL>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int i = 0; i < kSplits && e == cudaSuccess; ++i) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1 << i;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, 1 << i);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_bytes<CDT, DUAL>();
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&Resident<CDT, ET, NORM, DUAL, RESID>::clusters[i], k, &cfg);
  }
  return (int)e;
}

template <typename CDT>
int allow_smem_cdt() {
  const int codes[] = {
      allow_smem<CDT, __nv_bfloat16, true, false, false>(),
      allow_smem<CDT, __nv_bfloat16, true, true, false>(),
      allow_smem<CDT, float, true, false, false>(),
      allow_smem<CDT, float, true, true, false>(),
      allow_smem<CDT, float, false, false, true>(),
  };
  for (int c : codes)
    if (c != 0) return c;
  return 0;
}

}  // namespace

// Set up every GEMM variant (see allow_smem). Called once when the library is
// loaded, outside any launch sequence.
extern "C" int smoltts_fast_loop_setup() {
  const int c = allow_smem_cdt<__nv_bfloat16>();
  return c != 0 ? c : allow_smem_cdt<float>();
}

extern "C" int smoltts_fast_loop(const FastLoopArgs* a, cudaStream_t stream) {
  (void)cudaGetLastError();
  const int G = a->KV > 0 ? a->H / a->KV : 0;
  if (a->KV <= 0 || a->H % a->KV != 0 || G > 8 || a->hd > 128 || a->hd % 2 != 0 || a->n > 8 ||
      a->n < 1)
    return (int)cudaErrorInvalidValue;
  // 16-byte weight chunks and 4-float activation loads: every width and
  // every weight base (w3 is an offset into w13) 16-byte aligned.
  const int Nq = a->D + 2 * a->KV * a->hd;
  for (int v : {a->D, a->F, a->CB, Nq, a->ld13})
    if (v % 16 != 0) return (int)cudaErrorInvalidValue;
  for (const void* p : {(const void*)a->wqkv, (const void*)a->wo, (const void*)a->w1,
                        (const void*)a->w3, (const void*)a->w2, (const void*)a->head})
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorInvalidValue;
  if (a->B == 0) return 0;
  if (a->cdt == 1 && a->et == 1) return run<__nv_bfloat16, __nv_bfloat16>(*a, stream);
  if (a->cdt == 1 && a->et == 0) return run<__nv_bfloat16, float>(*a, stream);
  if (a->cdt == 0 && a->et == 1) return run<float, __nv_bfloat16>(*a, stream);
  if (a->cdt == 0 && a->et == 0) return run<float, float>(*a, stream);
  return (int)cudaErrorInvalidValue;
}
