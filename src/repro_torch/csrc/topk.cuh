// The exact per-block top-c of the candidate kernels (relevancy_topk.cu,
// bm25_topk.cu), for a block of the reference's grid that runs as a
// thread-block cluster of N CTAs, each CTA holding the scores of one
// contiguous chunk of the block in shared memory.
//
// Replaces: src/repro/kernels/bitonic.py, `bitonic_sort_desc` (:41) and
// `bitonic_topk` (:70), the compare-exchange network inside the Pallas
// kernels of relevancy_topk.py and bm25_topk.py.
//
// The order is the reference's: score descending, then index ascending
// (`goes_before`), a strict total order over distinct indices. Every level
// places a pair by its rank, the number of pairs that go before it, so the
// places are a permutation and the result is the full sort's prefix, ties
// included. No level has a barrier per compare stage:
//  1. the CTA's run (`cta_top_run`), by one of two routes:
//     * c <= kMaxRegC and a chunk longer than a segment (BM25's serving
//       c = 4 over 2048 docs): each thread keeps the top C (C = 4, 8 or 16,
//       a power of two >= c) of its scores in registers, sorted by
//       insertion; the 32 lists of a warp are merged in 5 rounds of
//       __shfl_xor_sync exchanges (the elementwise best of a list and its
//       partner's reversed, then a half-cleaner cascade: a bitonic merge in
//       registers), and the warps' lists the same way by one warp
//       (`register_run`);
//     * otherwise, segments of kSeg = 128 scores: each score's rank in its
//       segment is counted against the segment's other scores, by up to 4
//       lanes a score (the lanes of a warp read the same scores at a time:
//       shared-memory broadcasts), and
//       the scores ranked below min(c, segment) form the segment's run; the
//       runs are merged by rank: a pair's place is its index in its own run
//       plus, for every other run, the number of that run's pairs that go
//       before it (`count_before_runs`, binary lifting over up to eight runs
//       at once), and a pair whose place is below min(c, chunk) writes
//       itself there;
//  2. the same rank merge across the cluster (`cluster_top_write`): after a
//     cluster.sync() each CTA copies the peers' runs out of their shared
//     memory (distributed shared memory, cluster.map_shared_rank), arrives
//     on the cluster barrier, ranks its own run against the copies and
//     writes the pairs whose place is below c to the output, and waits on
//     the barrier before it exits, so no CTA's shared memory goes while a
//     peer still reads it.
// Register lists start as empty pairs (-inf, kEmptyIdx), which go after
// every real pair, -inf included; the register route runs only where the
// chunk holds more than c scores, so an empty pair never reaches a run.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

namespace topk {

namespace cg = cooperative_groups;

constexpr int kSeg = 128;              // scores ranked against each other
constexpr int kMaxRegC = 16;           // largest c of the register route
constexpr int kEmptyIdx = 0x7fffffff;  // index of a padding pair

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// True when pair (ka, ia) sorts before (kb, ib): key descending, then index
// ascending. A strict total order over distinct indices.
__device__ __forceinline__ bool goes_before(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Pairs that go before (v, i) in runs r0 .. r0 + K - 1 (< n_runs, but
// `skip`), found by binary lifting over all K at once without branches, so
// K independent chains of shared-memory loads are in flight.
template <int K>
__device__ __forceinline__ int count_before_k(const float* rv, const int* ri, int r0, int n_runs,
                                              int stride, int top, int skip, float v, int i) {
  int pos[K], lim[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = r0 + k;
    pos[k] = 0;
    lim[k] = r < n_runs && r != skip ? stride : 0;
  }
#pragma unroll 1
  for (int step = top; step > 0; step >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int cand = pos[k] + step;
      const bool ok = cand <= lim[k];
      const int e = ok ? (r0 + k) * stride + cand - 1 : 0;
      const float x = rv[e];
      const int xi = ri[e];
      const bool before = (x > v) | ((x == v) & (xi < i));
      pos[k] = ok & before ? cand : pos[k];
    }
  }
  int total = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) total += pos[k];
  return total;
}

// Pairs that go before (v, i) in the sorted runs r = 0 .. n_runs - 1 but
// `skip`, each of `stride` pairs, run r at (rv, ri) + r * stride.
__device__ __forceinline__ int count_before_runs(const float* rv, const int* ri, int n_runs,
                                                 int stride, int skip, float v, int i) {
  const int top = 1 << (31 - __clz(stride));   // largest power of two <= stride
  if (n_runs <= 2) return count_before_k<2>(rv, ri, 0, n_runs, stride, top, skip, v, i);
  if (n_runs <= 4) return count_before_k<4>(rv, ri, 0, n_runs, stride, top, skip, v, i);
  int total = 0;
  for (int r0 = 0; r0 < n_runs; r0 += 8)
    total += count_before_k<8>(rv, ri, r0, n_runs, stride, top, skip, v, i);
  return total;
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

// Merge the sorted top-C lists of the lanes of a warp in `rounds` rounds of
// shuffles (lanes l and l ^ m, m = 1, 2, ..., 2^(rounds - 1)): the
// elementwise best of a list and its partner's reversed is a bitonic
// sequence holding the top C of the two, and the half-cleaners sort it.
// Every lane ends with the top C of its group of 2^rounds lanes.
template <int C>
__device__ __forceinline__ void merge_lists(float (&v)[C], int (&ix)[C], int rounds) {
  for (int m = 1; m < (1 << rounds); m <<= 1) {
    float pv[C];
    int pi[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      pv[r] = __shfl_xor_sync(0xffffffffu, v[C - 1 - r], m);
      pi[r] = __shfl_xor_sync(0xffffffffu, ix[C - 1 - r], m);
    }
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (goes_before(pv[r], pi[r], v[r], ix[r])) {
        v[r] = pv[r];
        ix[r] = pi[r];
      }
    }
#pragma unroll
    for (int j = C / 2; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < C; ++r)
        if ((r & j) == 0) order_pair(v, ix, r, r + j);
    }
  }
}

// The register route (c <= C <= kMaxRegC, n > c): each thread's top C of
// scores sc[s], s = threadIdx.x, threadIdx.x + blockDim.x, ... < n (index
// base + s) by insertion; each warp's 32 lists merged by shuffles; the
// warps' lists (through lists_v / lists_i, C a warp) merged the same way by
// warp 0, whose lane 0 writes the top c to (ov, oi). Ends behind a
// __syncthreads().
template <int C>
__device__ inline void register_run(const float* sc, int n, int base, int c, float* lists_v,
                                    int* lists_i, float* ov, int* oi) {
  float v[C];
  int ix[C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    v[r] = neg_inf();
    ix[r] = kEmptyIdx;
  }
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const float x = sc[s];
    const int xi = base + s;
    if (!goes_before(x, xi, v[C - 1], ix[C - 1])) continue;
    // insertion with static indices: shift the worse entries down one
    bool placed = false;
#pragma unroll
    for (int p = C - 1; p > 0; --p) {
      if (!placed) {
        if (goes_before(x, xi, v[p - 1], ix[p - 1])) {
          v[p] = v[p - 1];
          ix[p] = ix[p - 1];
        } else {
          v[p] = x;
          ix[p] = xi;
          placed = true;
        }
      }
    }
    if (!placed) {
      v[0] = x;
      ix[0] = xi;
    }
  }
  merge_lists<C>(v, ix, 5);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < C; ++r) {
      lists_v[warp * C + r] = v[r];
      lists_i[warp * C + r] = ix[r];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < C; ++r) {
      v[r] = lane < n_warps ? lists_v[lane * C + r] : neg_inf();
      ix[r] = lane < n_warps ? lists_i[lane * C + r] : kEmptyIdx;
    }
    merge_lists<C>(v, ix, 31 - __clz(n_warps));
    // n > c real scores: the first c pairs are real
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < C; ++r) {
        if (r < c) {
          ov[r] = v[r];
          oi[r] = ix[r];
        }
      }
    }
  }
  __syncthreads();
}

// Shared memory (in 4-byte words) that `cta_top_run` needs for a chunk of n
// scores in a CTA of `threads` threads: the segments' runs, or the warps'
// register lists.
__host__ __device__ __forceinline__ int seg_run_words(int n, int threads) {
  const int lists = (threads / 32) * kMaxRegC;
  return 2 * (n > lists ? n : lists);
}

// The CTA's sorted run (ov, oi)[0, min(c, n)) of its n scores sc[0, n) (n a
// power of two), score s carrying index base + s. seg_buf holds
// seg_run_words(n, blockDim.x) words. Every thread of the CTA calls it; it
// ends behind a __syncthreads().
__device__ inline void cta_top_run(const float* sc, int n, int base, int c, float* seg_buf,
                                   float* ov, int* oi) {
  const int keep = c < n ? c : n;
  float* sv = seg_buf;
  int* si = reinterpret_cast<int*>(seg_buf + seg_run_words(n, blockDim.x) / 2);
  if (c <= kMaxRegC && n > kSeg) {
    if (c <= 4)
      register_run<4>(sc, n, base, c, sv, si, ov, oi);
    else if (c <= 8)
      register_run<8>(sc, n, base, c, sv, si, ov, oi);
    else
      register_run<kMaxRegC>(sc, n, base, c, sv, si, ov, oi);
    return;
  }
  // segments: each score's rank among its segment's scores
  const int seg_len = n < kSeg ? n : kSeg;
  const int lr = c < seg_len ? c : seg_len;   // pairs a segment keeps
  float* rv = n <= kSeg ? ov : sv;            // one segment: its run is the CTA's
  int* ri = n <= kSeg ? oi : si;
  // tpe (1, 2 or 4) neighbouring lanes count for one score, a share each
  int tpe = blockDim.x / n;
  tpe = tpe >= 4 ? 4 : (tpe >= 2 ? 2 : 1);
  const int part = threadIdx.x % tpe, per_pass = blockDim.x / tpe;
  for (int s0 = 0; s0 < n; s0 += per_pass) {
    const int s = s0 + threadIdx.x / tpe;
    const bool real = s < n;
    const float x = real ? sc[s] : 0.f;
    const int seg0 = s - s % seg_len;
    int rank = 0;
    if (real) {
#pragma unroll 8
      for (int t = seg0 + part; t < seg0 + seg_len; t += tpe) {
        const float y = sc[t];
        rank += (int)((y > x) | ((y == x) & (t < s)));
      }
    }
    for (int m = 1; m < tpe; m <<= 1) rank += __shfl_xor_sync(0xffffffffu, rank, m);
    if (real && part == 0 && rank < lr) {
      rv[seg0 / seg_len * lr + rank] = x;
      ri[seg0 / seg_len * lr + rank] = base + s;
    }
  }
  __syncthreads();
  const int n_runs = n / seg_len;
  if (n_runs == 1) return;
  // the segments' runs merged by rank
  for (int e = threadIdx.x; e < n_runs * lr; e += blockDim.x) {
    const int r = e / lr, t = e - r * lr;
    const float v = sv[e];
    const int i = si[e];
    const int rank = t + count_before_runs(sv, si, n_runs, lr, r, v, i);
    if (rank < keep) {
      ov[rank] = v;
      oi[rank] = i;
    }
  }
  __syncthreads();
}

// Merge the cluster's runs (every CTA's (ov, oi)[0, run), at the same
// shared-memory offsets in each) by rank and write the block's top c:
// out_vals[t], out_idx[t] = idx_base + index. gather holds 2 x n_cta x run
// words (unused when the cluster is one CTA). Every thread of every CTA of
// the cluster calls it; no CTA reads a peer's shared memory after it.
__device__ inline void cluster_top_write(const float* ov, const int* oi, int run, int c,
                                         float* gather, float* out_vals, int* out_idx,
                                         int idx_base) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  if (n_cta == 1) {
    for (int t = threadIdx.x; t < c; t += blockDim.x) {
      out_vals[t] = ov[t];
      out_idx[t] = idx_base + oi[t];
    }
    return;
  }
  const int me = static_cast<int>(cluster.block_rank());
  float* gv = gather;
  int* gi = reinterpret_cast<int*>(gather + n_cta * run);
  cluster.sync();   // every run is written and visible to the cluster
  // kGather remote loads in flight a thread before the first is stored
  constexpr int kGather = 4;
  const int total = n_cta * run;
  for (int e0 = threadIdx.x; e0 < total; e0 += kGather * blockDim.x) {
    float v[kGather];
    int ix[kGather];
#pragma unroll
    for (int k = 0; k < kGather; ++k) {
      const int e = e0 + k * blockDim.x, p = e / run;
      if (e < total && p != me) {
        v[k] = cluster.map_shared_rank(const_cast<float*>(ov), p)[e - p * run];
        ix[k] = cluster.map_shared_rank(const_cast<int*>(oi), p)[e - p * run];
      }
    }
#pragma unroll
    for (int k = 0; k < kGather; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e < total && e / run != me) {
        gv[e] = v[k];
        gi[e] = ix[k];
      }
    }
  }
  // this CTA reads no peer's shared memory past here: say so now, rank, and
  // wait for the peers to say the same before exiting
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();                    // the gathered runs are complete
  for (int t = threadIdx.x; t < run; t += blockDim.x) {
    const float v = ov[t];
    const int i = oi[t];
    const int rank = t + count_before_runs(gv, gi, n_cta, run, me, v, i);
    if (rank < c) {
      out_vals[rank] = v;
      out_idx[rank] = idx_base + i;
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Launch `kernel` on a grid of (n_blocks x n_cta, rows) CTAs in clusters of
// n_cta along x (no cluster when n_cta is 1), with `smem` bytes of dynamic
// shared memory. Returns a CUDA error code, or kNoClusterFits when no
// cluster of this shape fits on the card (cudaOccupancyMaxActiveClusters
// gives 0).
constexpr int kNoClusterFits = -1;

template <typename K, typename A>
int launch_clusters(K kernel, const A& args, int n_blocks, int rows, int n_cta, int threads,
                    size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks * n_cta, rows);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = n_cta > 1 ? 1 : 0;   // one CTA a block needs no cluster
  if (n_cta > 1) {
    // cached per (kernel, cluster size, shared memory): a host query per
    // call would add to a host-bound decode step. ctypes releases the GIL,
    // so two host threads may launch at once.
    struct Fit {
      const void* fn;
      int n_cta;
      size_t smem;
    };
    static Fit fits[32];
    static int n_fits = 0;
    static std::mutex lock;
    std::lock_guard<std::mutex> hold(lock);
    bool known = false;
    for (int f = 0; f < n_fits; ++f)
      known |= fits[f].fn == (const void*)kernel && fits[f].n_cta == n_cta &&
               fits[f].smem == smem;
    if (!known) {
      int n_active = 0;
      err = cudaOccupancyMaxActiveClusters(&n_active, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (n_active == 0) return kNoClusterFits;
      if (n_fits < 32) fits[n_fits++] = Fit{(const void*)kernel, n_cta, smem};
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

inline const char* error_string(int err) {
  if (err == kNoClusterFits)
    return "no thread-block cluster of this size and shared memory fits on the card "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace topk
