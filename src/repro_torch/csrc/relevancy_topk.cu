// Fused relevancy scoring + per-block exact top-c, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/relevancy_topk.py, relevancy_topk_candidates
// (Pallas body `_kernel`, :32-48), and inside it the bitonic network of
// src/repro/kernels/bitonic.py (`bitonic_topk`, :70), which becomes the
// rank merges of topk.cuh.
//
// What bounds it on this card: per (b, block) the kernel reads block x dk
// keys once and does 2 x Hq x dk FLOP per key. On the DSA main path
// (llama3.2-1b, 4 slots, an 8192-token view cut into 16-token pages) that is
// 4 x 512 x 128 bf16 keys (0.5 MB) and 34 MFLOP: under a microsecond of
// either against the card's peaks. What it pays for is latency: the launch,
// the loads, and the top-c of a 512-key block with c = 512.
//
// Design: a block of the reference's grid (one (j, b)) runs as a cluster of
// n_cta CTAs (`kernels/relevancy_topk.py` `split_plan`; grid.x = nb x n_cta,
// B on grid.y), so 4 blocks fill 32 SMs, not 4. Each CTA scores one
// contiguous chunk of block / n_cta keys into shared memory. Its q and its
// live keys, 64 at a time, are staged in shared memory as they are, rows
// padded by 16 bytes, by 16-byte cp.async copies that are all in flight
// before the first is waited on, so the CTA pays one load latency, not one
// a row. Then:
//  * bf16 with dk % 16 == 0 (DSA's indexer, Seer's gate): on the tensor
//    cores, mma.sync m16n8k16 bf16 with fp32 accumulation. Each warp takes
//    16-key tiles and multiplies each by every 8-head slice of q, four
//    slices at a time on one load of the tile's fragment (the row pad puts
//    a fragment's 8 rows on distinct banks); heads past Hq (Seer's one
//    head fills a slice of 8) are zero rows of q with zero weight, so they
//    add exact zeros. relu(.) * w is summed over heads in the accumulator
//    registers and over the 4 lanes of a row by two shuffles, one fp32
//    score per key. bf16 products are exact in fp32, so only the order of
//    the sums differs from the plain version's fp32 einsum;
//  * otherwise (fp32, the kernel-vs-plain comparison at fp32): on the CUDA
//    cores, no TF32: a warp a key, lanes split dk, and one shuffle tree per
//    head gives the head's dot.
// Keys at or past valid_len score -inf unread. The chunk's scores then go
// through topk.cuh: ranks counted within 128-key segments (or, for c <= 16,
// per-warp register lists merged by shuffles), a rank merge of those runs
// in shared memory, and a rank merge of the CTAs' runs through distributed
// shared memory, each pair written once to its place among the block's c.
// The scores never leave the chip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "topk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 64;   // keys staged at once: 4 tensor-core tiles of 16
constexpr int kSlices = 4;   // 8-head slices of q multiplied at once

struct Args {
  const void* q;
  const void* keys;
  const float* w;
  float* out_vals;
  int* out_idx;
  int Hq, dk, S, block, c, valid_len, n_cta, vec;
};

// Heads rounded up to a slice of 8: the rows of q and w in shared memory.
__host__ __device__ __forceinline__ int padded_heads(int Hq) { return (Hq + 7) & ~7; }

// Row stride, in elements, of q and the keys in shared memory: dk padded by
// 16 bytes, so 16-byte copies stay aligned and a tensor-core fragment's 8
// rows fall on distinct banks.
__host__ __device__ __forceinline__ int row_stride(int dk, int elt) { return dk + 16 / elt; }

// Offsets (in 4-byte words) of the kernel's dynamic shared memory.
struct Layout {
  int sc, seg, ov, oi, gather, ws, qs, ks, words;
  __host__ __device__ Layout(int chunk, int run, int n_cta, int Hq, int dk, int elt) {
    sc = 0;                                         // [chunk] scores
    seg = sc + chunk;                               // the warps' runs
    ov = seg + topk::seg_run_words(chunk, kThreads);          // [run] the CTA's run
    oi = ov + run;
    gather = oi + run;                              // [2][n_cta][run] peers' runs
    ws = gather + (n_cta > 1 ? 2 * n_cta * run : 0);
    const int row_bytes = row_stride(dk, elt) * elt;
    const int hp = padded_heads(Hq);
    qs = (ws + hp + 3) & ~3;                        // [hp][stride], 16-byte aligned
    ks = qs + (hp * row_bytes + 15) / 16 * 4;       // [kBatch][stride]
    words = ks + (kBatch * row_bytes + 15) / 16 * 4;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copy n rows of dk elements (global stride dk) into shared memory rows of
// `stride` elements: 16-byte cp.async copies, all in flight at once, where
// the rows allow (vec), else plain loads. The caller waits and syncs.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int n, int dk, int stride,
                                           bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int per_row = dk / kPer;
    for (int e = threadIdx.x; e < n * per_row; e += blockDim.x) {
      const int r = e / per_row, v = e - r * per_row;
      cp_async16(dst + r * stride + v * kPer, src + (size_t)r * dk + v * kPer);
    }
  } else {
    for (int e = threadIdx.x; e < n * dk; e += blockDim.x) {
      const int r = e / dk, d = e - r * dk;
      dst[r * stride + d] = src[(size_t)r * dk + d];
    }
  }
}

// relu(q_h . k) * w_h summed over heads for the staged keys ks[0, n) on the
// tensor cores: each warp takes 16-key tiles; a tile times every 8-head
// slice of q by mma.sync m16n8k16; the relu * w terms summed in the
// accumulators' registers and over a row's 4 lanes by two shuffles.
// sc[r] = the score of staged key r, for r < n_live; n <= kBatch.
__device__ void scores_tensor_cores(const Args& a, const __nv_bfloat16* qs,
                                    const __nv_bfloat16* ks, const float* ws, int n_live,
                                    float* sc) {
  const int n_slices = padded_heads(a.Hq) / 8, dk = a.dk, stride = row_stride(dk, 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int r0 = warp * 16; r0 < n_live; r0 += kWarps * 16) {
    const __nv_bfloat16* a_lo = ks + (r0 + g) * stride + 2 * t;
    const __nv_bfloat16* a_hi = a_lo + 8 * stride;
    float lo = 0.f, hi = 0.f;                 // rows r0 + g and r0 + g + 8
    // kSlices 8-head slices at a time: their accumulation chains are
    // independent, and each A fragment is loaded once for all of them
    for (int n0 = 0; n0 < n_slices; n0 += kSlices) {
      float acc[kSlices][4] = {};
      for (int kk = 0; kk < dk; kk += 16) {
        const uint32_t a0 = lds32(a_lo + kk), a1 = lds32(a_hi + kk);
        const uint32_t a2 = lds32(a_lo + kk + 8), a3 = lds32(a_hi + kk + 8);
#pragma unroll
        for (int u = 0; u < kSlices; ++u) {
          if (n0 + u < n_slices) {
            const __nv_bfloat16* bq = qs + ((n0 + u) * 8 + g) * stride + 2 * t + kk;
            mma_bf16_16816(acc[u], a0, a1, a2, a3, lds32(bq), lds32(bq + 8));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSlices; ++u) {
        if (n0 + u < n_slices) {
          const int h = (n0 + u) * 8 + 2 * t;
          lo += ws[h] * fmaxf(acc[u][0], 0.f) + ws[h + 1] * fmaxf(acc[u][1], 0.f);
          hi += ws[h] * fmaxf(acc[u][2], 0.f) + ws[h + 1] * fmaxf(acc[u][3], 0.f);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      lo += __shfl_xor_sync(0xffffffffu, lo, off);
      hi += __shfl_xor_sync(0xffffffffu, hi, off);
    }
    // rows at or past n_live hold stale data: their scores are not written
    if (t == 0 && r0 + g < n_live) sc[r0 + g] = lo;
    if (t == 0 && r0 + g + 8 < n_live) sc[r0 + g + 8] = hi;
  }
}

// The same on the CUDA cores, fp32 throughout: a warp a key, lanes split
// dk, one shuffle tree a head.
template <typename T>
__device__ void scores_cuda_cores(const Args& a, const T* qs, const T* ks, const float* ws,
                                  int n_live, float* sc) {
  const int Hq = a.Hq, dk = a.dk, stride = row_stride(dk, sizeof(T));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < n_live; s += kWarps) {
    const T* kr = ks + s * stride;
    float score = 0.f;
    for (int h = 0; h < Hq; ++h) {
      const T* qh = qs + h * stride;
      float p = 0.f;
      for (int d = lane; d < dk; d += 32) p = fmaf(to_f32(qh[d]), to_f32(kr[d]), p);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      score += ws[h] * fmaxf(p, 0.f);
    }
    if (lane == 0) sc[s] = score;
  }
}

template <typename T, bool kTensorCores>
__global__ void __launch_bounds__(kThreads) relevancy_topk_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int n_cta = a.n_cta, chunk = a.block / n_cta;
  const int run = a.c < chunk ? a.c : chunk;
  const Layout L(chunk, run, n_cta, a.Hq, a.dk, sizeof(T));
  const int j = blockIdx.x / n_cta, b = blockIdx.y, nb = gridDim.x / n_cta;
  const int off = (blockIdx.x % n_cta) * chunk;   // the chunk, within the block
  const int key0 = j * a.block + off;
  const int stride = row_stride(a.dk, sizeof(T));
  float* sc = smem + L.sc;
  float* ws = smem + L.ws;
  T* qs = reinterpret_cast<T*>(smem + L.qs);
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  const T* keys = static_cast<const T*>(a.keys) + ((size_t)b * a.S + key0) * a.dk;
  int live = a.valid_len - key0;                  // keys of the chunk that score
  live = live < 0 ? 0 : (live > chunk ? chunk : live);

  // w and q, heads past Hq zero up to a slice of 8
  const int hp = padded_heads(a.Hq);
  for (int h = threadIdx.x; h < hp; h += blockDim.x)
    ws[h] = h < a.Hq ? a.w[(size_t)b * a.Hq + h] : 0.f;
  for (int e = threadIdx.x; e < (hp - a.Hq) * stride; e += blockDim.x)
    qs[a.Hq * stride + e] = T(0.f);
  if (live > 0)
    stage_rows(qs, static_cast<const T*>(a.q) + (size_t)b * a.Hq * a.dk, a.Hq, a.dk, stride,
               a.vec);
  // keys in batches of kBatch, each staged whole (with q, the first time)
  // before it is scored; keys at or past valid_len are neither loaded nor
  // scored
  for (int r0 = 0; r0 < live; r0 += kBatch) {
    const int n = live - r0 < kBatch ? live - r0 : kBatch;
    stage_rows(ks, keys + (size_t)r0 * a.dk, n, a.dk, stride, a.vec);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if constexpr (kTensorCores)
      scores_tensor_cores(a, qs, ks, ws, n, sc + r0);
    else
      scores_cuda_cores<T>(a, qs, ks, ws, n, sc + r0);
    __syncthreads();                          // the batch buffer is refilled next
  }
  for (int s = live + threadIdx.x; s < chunk; s += blockDim.x) sc[s] = topk::neg_inf();
  __syncthreads();
  float* ov = smem + L.ov;
  int* oi = reinterpret_cast<int*>(smem + L.oi);
  topk::cta_top_run(sc, chunk, off, a.c, smem + L.seg, ov, oi);
  const size_t o = ((size_t)b * nb + j) * a.c;
  topk::cluster_top_write(ov, oi, run, a.c, smem + L.gather, a.out_vals + o, a.out_idx + o,
                          j * a.block);
}

template <typename T, bool kTensorCores>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int chunk = a.block / a.n_cta;
  const Layout L(chunk, a.c < chunk ? a.c : chunk, a.n_cta, a.Hq, a.dk, sizeof(T));
  return topk::launch_clusters(relevancy_topk_kernel<T, kTensorCores>, a, a.S / a.block, B,
                               a.n_cta, kThreads, sizeof(float) * (size_t)L.words, stream);
}

}  // namespace

// q [B,Hq,dk], keys [B,S,dk] (both fp32, or both bf16 when is_bf16), w [B,Hq]
// fp32 -> vals [B,S/block,c] fp32, idx [B,S/block,c] int32. block is a power
// of two dividing S; c <= block; keys at or past valid_len score -inf. Each
// block runs as a cluster of n_cta CTAs (a power of two dividing block, at
// most 8, the portable limit). tensor_cores takes the mma.sync route (bf16,
// dk % 16 == 0, q and keys 16-byte aligned). Returns a CUDA error code
// after the launch, or topk::kNoClusterFits.
extern "C" int relevancy_topk_candidates_cuda(const void* q, const void* keys,
                                              const void* w, void* vals, void* idx,
                                              int B, int Hq, int dk, int S, int block,
                                              int c, int valid_len, int is_bf16,
                                              int tensor_cores, int n_cta, void* stream) {
  if (n_cta < 1 || n_cta > 8 || (n_cta & (n_cta - 1)) || block % n_cta || c < 1 || c > block ||
      (tensor_cores && !(is_bf16 && dk % 16 == 0)))
    return (int)cudaErrorInvalidValue;
  const size_t row_bytes = (size_t)dk * (is_bf16 ? 2 : 4);
  const int vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const Args a{q, keys, static_cast<const float*>(w), static_cast<float*>(vals),
               static_cast<int*>(idx), Hq, dk, S, block, c, valid_len, n_cta, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) return launch<__nv_bfloat16, true>(a, B, st);
  if (is_bf16) return launch<__nv_bfloat16, false>(a, B, st);
  return launch<float, false>(a, B, st);
}

extern "C" const char* repro_cuda_error_string(int err) { return topk::error_string(err); }
