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
// What bounds it on this card: it reads the live docs' panel rows and
// lengths once, (T + 1) x 4 bytes a doc, and does about 5 T + 5 operations
// a doc. On the serving path (one query, 250,000 live docs of 262,144, 8
// terms) that is 9.0 MB, 2.7 us at 3.35 TB/s, against 11 MFLOP, 0.17 us at
// 67 TFLOP/s: bytes-bound.
//
// Design: a block of the reference's grid (one (j, b)) runs as a cluster of
// n_cta CTAs of 512 threads (`kernels/bm25_topk.py` `split_plan`; grid.x =
// nb x n_cta, B on grid.y): 128 CTAs at the serving shape instead of 64, 32
// at Fig. 10's instead of 4. Each CTA takes one contiguous chunk of
// block / n_cta docs. One thread loads the chunk's live rows of the panel
// and their lengths with bulk asynchronous copies (cp.async.bulk, the 1-D
// form of TMA) into shared memory, in four pieces completed on four
// mbarriers, so the whole slab (72 KB at the serving shape) is in flight at
// once and a thread scores a doc as soon as the doc's piece lands; a chunk
// larger than the slab buffer goes in turns. Docs at or past nd are
// neither loaded nor scored (a piece rounds up to whole 16-byte runs, 4
// docs). Where the chunk is under 4 docs the threads copy the slab
// themselves. Each thread scores docs s, s + 512, ... from shared memory
// in the reference's fp32 order (denominator, then the quotient, then the
// dot with idf; no contraction into FMAs but the accumulation). The
// chunk's scores then go through topk.cuh for every c: for c <= 16 (the
// serving path's c = 4) each thread's top C in registers, merged over its
// warp and then over the warps by shuffles; else ranks counted within
// 128-doc segments (Fig. 10's c = 64) and those runs merged by rank in
// shared memory; then a rank merge of the CTAs' runs through distributed
// shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "topk.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSlabBytes = 96 * 1024;   // the slab buffer's capacity
constexpr int kPieces = 4;              // copies a turn, each on its own mbarrier

struct Args {
  const float* tf;
  const float* dl;
  const float* idf;
  const int* nd_dev;
  float* out_vals;
  int* out_idx;
  int D, T, block, c, nd, n_cta, cap, bulk;
  float k1, b, avgdl;
};

// Offsets (in 4-byte words) of the kernel's dynamic shared memory.
struct Layout {
  int bar, tf, dl, idf, sc, seg, ov, oi, gather, words;
  __host__ __device__ Layout(int chunk, int run, int n_cta, int T, int cap) {
    bar = 0;                                        // [kPieces] mbarriers, 8 bytes each
    tf = 2 * kPieces;                               // [cap][T] slab, 16-byte aligned
    dl = tf + cap * T;                              // [cap]
    idf = dl + cap;                                 // [T]
    sc = idf + T;                                   // [chunk] scores
    seg = sc + chunk;                               // the warps' runs
    ov = seg + topk::seg_run_words(chunk, kThreads);          // [run] the CTA's run
    oi = ov + run;
    gather = oi + run;                              // [2][n_cta][run] peers' runs
    words = gather + (n_cta > 1 ? 2 * n_cta * run : 0);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One term's tf (k1 + 1) / (tf + norm), correctly rounded. A zero tf gives
// +0 (norm > 0) without the division: IEEE division of a zero dividend
// leaves the fast path of __fdiv_rn for its slow one, and half of a
// query's terms are absent from a typical doc.
__device__ __forceinline__ float term(float x, float kp1, float norm) {
  return x == 0.f ? 0.f : __fdiv_rn(__fmul_rn(x, kp1), __fadd_rn(x, norm));
}

// BM25 score of one doc from its panel row and length, in the reference's
// order.
__device__ __forceinline__ float score_doc(const Args& a, const float* idf_s, const float* row,
                                           float len) {
  // k1 * (1 - b + b * dl / avgdl), in the reference's order
  const float norm =
      __fmul_rn(a.k1, __fadd_rn(1.f - a.b, __fdiv_rn(__fmul_rn(a.b, len), a.avgdl)));
  const float kp1 = a.k1 + 1.f;
  float acc = 0.f;
  int t = 0;
  if ((a.T & 3) == 0) {
    for (; t < a.T; t += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + t);
      acc = __fmaf_rn(idf_s[t], term(x.x, kp1, norm), acc);
      acc = __fmaf_rn(idf_s[t + 1], term(x.y, kp1, norm), acc);
      acc = __fmaf_rn(idf_s[t + 2], term(x.z, kp1, norm), acc);
      acc = __fmaf_rn(idf_s[t + 3], term(x.w, kp1, norm), acc);
    }
  }
  for (; t < a.T; ++t) acc = __fmaf_rn(idf_s[t], term(row[t], kp1, norm), acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads) bm25_topk_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int n_cta = a.n_cta, chunk = a.block / n_cta;
  const int run = a.c < chunk ? a.c : chunk;
  const Layout L(chunk, run, n_cta, a.T, a.cap);
  const int j = blockIdx.x / n_cta, b = blockIdx.y, nb = gridDim.x / n_cta;
  const int off = (blockIdx.x % n_cta) * chunk;   // the chunk, within the block
  const int doc0 = j * a.block + off;
  float* tf_s = smem + L.tf;
  float* dl_s = smem + L.dl;
  float* idf_s = smem + L.idf;
  float* sc = smem + L.sc;
  const uint32_t bar0 = smem_u32(smem + L.bar);

  int nd = a.nd_dev != nullptr ? *a.nd_dev : a.nd;
  nd = nd > 0 ? nd : a.D;
  int live = nd - doc0;
  live = live < 0 ? 0 : (live > chunk ? chunk : live);
  for (int t = threadIdx.x; t < a.T; t += blockDim.x) idf_s[t] = a.idf[(size_t)b * a.T + t];
  if (threadIdx.x == 0 && a.bulk) {
    for (int k = 0; k < kPieces; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * k) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const float* tf_row = a.tf + ((size_t)b * a.D + doc0) * a.T;
  const float* dl_row = a.dl + (size_t)b * a.D + doc0;
  uint32_t phase = 0;
  for (int p0 = 0; p0 < live; p0 += a.cap) {
    const int n = live - p0 < a.cap ? live - p0 : a.cap;
    // kPieces pieces of whole 16-byte runs (multiples of 4 docs); the last
    // rounded up to 4 docs stays inside the chunk (chunk and cap are
    // multiples of 4)
    const int piece = ((n + kPieces - 1) / kPieces + 3) & ~3;
    if (a.bulk) {
      if (threadIdx.x == 0) {
        // the slab was read through the generic proxy in the last turn
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int k = 0; k * piece < n; ++k) {
          const int lo = k * piece, m = n - lo < piece ? (n - lo + 3) & ~3 : piece;
          const uint32_t tf_bytes = (uint32_t)m * a.T * 4, dl_bytes = (uint32_t)m * 4;
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                           bar0 + 8 * k),
                       "r"(tf_bytes + dl_bytes)
                       : "memory");
          bulk_load(tf_s + (size_t)lo * a.T, tf_row + (size_t)(p0 + lo) * a.T, tf_bytes,
                    bar0 + 8 * k);
          bulk_load(dl_s + lo, dl_row + p0 + lo, dl_bytes, bar0 + 8 * k);
        }
      }
    } else {
      for (int e = threadIdx.x; e < n * a.T; e += blockDim.x) tf_s[e] = tf_row[(size_t)p0 * a.T + e];
      for (int e = threadIdx.x; e < n; e += blockDim.x) dl_s[e] = dl_row[p0 + e];
      __syncthreads();
    }
    // each doc is scored as soon as its piece has landed, while the later
    // pieces land
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      if (a.bulk) mbar_wait(bar0 + 8 * (s / piece), phase);
      sc[p0 + s] = score_doc(a, idf_s, tf_s + s * a.T, dl_s[s]);
    }
    phase ^= 1;
    __syncthreads();                          // before the next turn refills the slab
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

}  // namespace

// tf [B,D,T], doc_len [B,D], idf [B,T], all fp32 -> vals [B,D/block,c] fp32,
// idx [B,D/block,c] int32. block is a power of two dividing D; c <= block.
// The live count is *nd_dev when nd_dev is not null, else nd; a value <= 0
// means D. Each block runs as a cluster of n_cta CTAs (a power of two
// dividing block, at most 8, the portable limit). Returns a CUDA error code
// after the launch, or topk::kNoClusterFits.
extern "C" int bm25_topk_candidates_cuda(const void* tf, const void* doc_len, const void* idf,
                                         const void* nd_dev, void* vals, void* idx, int B,
                                         int D, int T, int block, int c, int nd, float k1,
                                         float b, float avgdl, int n_cta, void* stream) {
  if (n_cta < 1 || n_cta > 8 || (n_cta & (n_cta - 1)) || block % n_cta || c < 1 || c > block ||
      T < 1)
    return (int)cudaErrorInvalidValue;
  const int chunk = block / n_cta;
  // the slab buffer: the whole chunk where it fits, else a power of two
  int cap = chunk;
  while (cap > 4 && (size_t)cap * (T + 1) * 4 > kSlabBytes) cap >>= 1;
  const int bulk = chunk % 4 == 0 && cap % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(tf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(doc_len) % 16 == 0;
  const Args a{static_cast<const float*>(tf), static_cast<const float*>(doc_len),
               static_cast<const float*>(idf), static_cast<const int*>(nd_dev),
               static_cast<float*>(vals), static_cast<int*>(idx), D, T, block, c, nd, n_cta,
               cap, bulk, k1, b, avgdl};
  const Layout L(chunk, c < chunk ? c : chunk, n_cta, T, cap);
  return topk::launch_clusters(bm25_topk_kernel, a, D / block, B, n_cta, kThreads,
                               sizeof(float) * (size_t)L.words, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int err) { return topk::error_string(err); }
