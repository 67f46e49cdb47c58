// The strict (score descending, index ascending) compare rule and the bitonic
// sort of (score, index) pairs in shared memory, shared by the per-block top-c
// kernels (relevancy_topk.cu, bm25_topk.cu).
//
// Replaces: src/repro/kernels/bitonic.py, `bitonic_sort_desc` (:41) and
// `bitonic_topk` (:70), the compare-exchange network inside the Pallas
// kernels of relevancy_topk.py and bm25_topk.py.
#pragma once

#include <cuda_runtime.h>

// True when pair (ka, ia) sorts before (kb, ib): key descending, then index
// ascending. A strict total order over distinct indices.
__device__ __forceinline__ bool goes_before(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Sort n (a power of two) pairs in shared memory, descending. Runs with
// (i & k) == 0 sort descending, the others ascending, so every merge sees a
// bitonic sequence; the last stage (k == n) is one descending run.
__device__ inline void bitonic_sort_desc(float* keys, int* vals, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const float ki = keys[i], kp = keys[p];
          const int vi = vals[i], vp = vals[p];
          const bool desc = (i & k) == 0;
          const bool swap = desc ? goes_before(kp, vp, ki, vi) : goes_before(ki, vi, kp, vp);
          if (swap) {
            keys[i] = kp;
            keys[p] = ki;
            vals[i] = vp;
            vals[p] = vi;
          }
        }
      }
      __syncthreads();
    }
  }
}
