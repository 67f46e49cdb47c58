// Fused BM25 scoring + per-block exact top-c, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bm25_topk.py, bm25_topk_candidates (:47; Pallas
// body `_kernel`, :27-40), with the bitonic network of
// src/repro/kernels/bitonic.py inside it (topk.cuh).
//
// Computes, per (row b, block j of `block` docs), the BM25 score of every doc
//   score_d = sum_t idf_t * tf_dt (k1 + 1) / (tf_dt + k1 (1 - b + b dl_d / avgdl))
// over the query's gathered term panel tf [B, D, T]; docs at or past the
// live count nd (a runtime value: the corpus grows between queries; nd <= 0
// means D) score -inf. The block's top c (score descending, index ascending)
// leave the kernel as (value, global index) pairs.
//
// What bounds it on this card: it reads the panel and the doc lengths once,
// (T + 1) x 4 bytes per doc, and does about 5 T + 5 operations per doc. On
// the serving path (one query, 262,144 docs, 8 terms) that is 9.44 MB,
// 2.8 us at 3.35 TB/s, against 11 MFLOP, 0.17 us at 67 TFLOP/s:
// bytes-bound.
//
// Design: one CTA per (block, b) of 512 threads; the query's idf row is
// staged in shared memory and each thread scores docs s, s + 512, ... in the
// reference's fp32 order (denominator, then the quotient, then the dot with
// idf; no contraction into FMAs except the accumulation) into shared
// memory. Only one CTA per SM is busy (64 blocks at the serving shape), so
// the scoring loops over docs and terms are unrolled by 4: up to 16 loads
// in flight per thread hide the memory latency that a term-at-a-time loop
// waits on. The top-c selection keeps the reference's strict order (score
// descending, index ascending, `goes_before`) and takes one of two routes:
//  * c <= 16 (the serving path's c = 4): each thread keeps a running top-C
//    (C = 4, 8 or 16, a power of two >= c) of its docs' scores in
//    registers, by insertion with compile-time indices; the 512 lists are
//    then merged pairwise in shared memory in log2(512) = 9 rounds, each
//    merge the bitonic top-C of two sorted lists (elementwise best of one
//    list and the other reversed, then a half-cleaner cascade);
//  * larger c: the block's (score, index) pairs are sorted in shared memory
//    by the full bitonic network, log2(block) (log2(block) + 1) / 2 stages
//    behind a barrier each, and the first c are written.
#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRegC = 16;                  // largest c of the register route
constexpr int kSentinel = 0x7fffffff;        // index of an empty list entry

struct Args {
  const float* tf;
  const float* dl;
  const float* idf;
  const int* nd_dev;
  float* out_vals;
  int* out_idx;
  int D, T, block, c, nd;
  float k1, b, avgdl;
};

// Stage the row's idf in shared memory; the live count (nd <= 0 means D).
__device__ __forceinline__ int prologue(const Args& a, float* idf_s) {
  for (int t = threadIdx.x; t < a.T; t += blockDim.x)
    idf_s[t] = a.idf[(size_t)blockIdx.y * a.T + t];
  const int nd = a.nd_dev != nullptr ? *a.nd_dev : a.nd;
  __syncthreads();
  return nd > 0 ? nd : a.D;
}

// BM25 score of doc s of this CTA's block, -inf at or past the live count.
__device__ __forceinline__ float score_doc(const Args& a, const float* idf_s, int nd, int s) {
  const int j = blockIdx.x;
  if (j * a.block + s >= nd) return __int_as_float(0xff800000);
  const size_t d = (size_t)blockIdx.y * a.D + (size_t)j * a.block + s;
  // k1 * (1 - b + b * dl / avgdl), in the reference's order
  const float norm =
      __fmul_rn(a.k1, __fadd_rn(1.f - a.b, __fdiv_rn(__fmul_rn(a.b, a.dl[d]), a.avgdl)));
  const float kp1 = a.k1 + 1.f;
  const float* tfr = a.tf + d * a.T;
  float acc = 0.f;
#pragma unroll 4
  for (int t = 0; t < a.T; ++t) {
    const float x = tfr[t];
    acc = __fmaf_rn(idf_s[t], __fdiv_rn(__fmul_rn(x, kp1), __fadd_rn(x, norm)), acc);
  }
  return acc;
}

__device__ __forceinline__ void write_out(const Args& a, int t, float v, int s) {
  const size_t o = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * a.c;
  a.out_vals[o + t] = v;
  a.out_idx[o + t] = blockIdx.x * a.block + s;
}

// Swap entries (p, q) of a list so that the better one is at p.
template <int C>
__device__ __forceinline__ void order_pair(float (&v)[C], int (&ix)[C], int p, int q) {
  if (goes_before(v[q], ix[q], v[p], ix[p])) {
    const float tv = v[p];
    const int ti = ix[p];
    v[p] = v[q];
    ix[p] = ix[q];
    v[q] = tv;
    ix[q] = ti;
  }
}

// Score the block's docs into sc[0, block).
__device__ __forceinline__ void score_block(const Args& a, const float* idf_s, int nd,
                                            float* sc) {
#pragma unroll 4
  for (int s = threadIdx.x; s < a.block; s += kThreads) sc[s] = score_doc(a, idf_s, nd, s);
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(kThreads) bm25_topk_reg_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* lv = smem;                                          // [kThreads][C]
  int* li = reinterpret_cast<int*>(lv + kThreads * C);       // [kThreads][C]
  float* sc = reinterpret_cast<float*>(li + kThreads * C);   // [block]
  float* idf_s = sc + a.block;                               // [T]
  const int nd = prologue(a, idf_s);
  score_block(a, idf_s, nd, sc);

  // this thread's running top-C, sorted: insertion with static indices
  float v[C];
  int ix[C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    v[r] = __int_as_float(0xff800000);
    ix[r] = kSentinel;
  }
  for (int s = threadIdx.x; s < a.block; s += kThreads) {
    const float x = sc[s];
    if (!goes_before(x, s, v[C - 1], ix[C - 1])) continue;
    bool placed = false;
#pragma unroll
    for (int p = C - 1; p > 0; --p) {
      if (!placed) {
        if (goes_before(x, s, v[p - 1], ix[p - 1])) {
          v[p] = v[p - 1];
          ix[p] = ix[p - 1];
        } else {
          v[p] = x;
          ix[p] = s;
          placed = true;
        }
      }
    }
    if (!placed) {
      v[0] = x;
      ix[0] = s;
    }
  }

  // pairwise merges: in the round of stride h, thread t (a multiple of 2h)
  // takes the top C of its list and thread t + h's
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < C; ++r) {
    lv[t * C + r] = v[r];
    li[t * C + r] = ix[r];
  }
  for (int h = 1; h < kThreads; h <<= 1) {
    __syncthreads();
    if ((t & (2 * h - 1)) != 0) continue;
    const int q = (t + h) * C;
    // elementwise best of this list and the partner's reversed: a bitonic
    // sequence holding the top C of the two
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const float pv = lv[q + C - 1 - r];
      const int pi = li[q + C - 1 - r];
      if (goes_before(pv, pi, v[r], ix[r])) {
        v[r] = pv;
        ix[r] = pi;
      }
    }
#pragma unroll
    for (int jj = C / 2; jj > 0; jj >>= 1) {
#pragma unroll
      for (int r = 0; r < C; ++r)
        if ((r & jj) == 0) order_pair(v, ix, r, r + jj);
    }
#pragma unroll
    for (int r = 0; r < C; ++r) {
      lv[t * C + r] = v[r];
      li[t * C + r] = ix[r];
    }
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < C; ++r)
      if (r < a.c) write_out(a, r, v[r], ix[r]);
  }
}

__global__ void __launch_bounds__(kThreads) bm25_topk_sort_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;                                        // [block]
  int* ix = reinterpret_cast<int*>(sc + a.block);          // [block]
  float* idf_s = reinterpret_cast<float*>(ix + a.block);   // [T]
  const int nd = prologue(a, idf_s);
  for (int s = threadIdx.x; s < a.block; s += kThreads) ix[s] = s;
  score_block(a, idf_s, nd, sc);
  bitonic_sort_desc(sc, ix, a.block);
  for (int t = threadIdx.x; t < a.c; t += kThreads) write_out(a, t, sc[t], ix[t]);
}

template <typename K>
int launch(K kernel, const Args& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.D / a.block, B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// tf [B,D,T], doc_len [B,D], idf [B,T], all fp32 -> vals [B,D/block,c] fp32,
// idx [B,D/block,c] int32. block is a power of two dividing D; c <= block.
// The live count is *nd_dev when nd_dev is not null, else nd; a value <= 0
// means D. Returns cudaGetLastError() after the launch.
extern "C" int bm25_topk_candidates_cuda(const void* tf, const void* doc_len, const void* idf,
                                         const void* nd_dev, void* vals, void* idx, int B,
                                         int D, int T, int block, int c, int nd, float k1,
                                         float b, float avgdl, void* stream) {
  const Args a{static_cast<const float*>(tf), static_cast<const float*>(doc_len),
               static_cast<const float*>(idf), static_cast<const int*>(nd_dev),
               static_cast<float*>(vals), static_cast<int*>(idx), D, T, block, c, nd, k1, b,
               avgdl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t pair = sizeof(float) + sizeof(int);
  // scores of the block, then the idf row
  const size_t base = sizeof(float) * ((size_t)block + T);
  if (c <= 4) return launch(bm25_topk_reg_kernel<4>, a, B, pair * kThreads * 4 + base, st);
  if (c <= 8) return launch(bm25_topk_reg_kernel<8>, a, B, pair * kThreads * 8 + base, st);
  if (c <= kMaxRegC)
    return launch(bm25_topk_reg_kernel<kMaxRegC>, a, B, pair * kThreads * kMaxRegC + base, st);
  // the block's indices, then its scores and the idf row
  return launch(bm25_topk_sort_kernel, a, B, sizeof(int) * (size_t)block + base, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
