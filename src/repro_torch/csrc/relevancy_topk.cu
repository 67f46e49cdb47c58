// Fused relevancy scoring + per-block exact top-c, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/relevancy_topk.py, relevancy_topk_candidates
// (Pallas body `_kernel`, :32-48), and inside it the bitonic network of
// src/repro/kernels/bitonic.py (`bitonic_sort_desc`, :41), which becomes the
// __device__ function `bitonic_sort_desc` of topk.cuh.
//
// What bounds it on this card: per (b, block) the kernel reads block x dk
// keys once and does 2 x Hq x dk FLOP per key. On the DSA main path
// (llama3.2-1b, 4 slots, an 8192-token view cut into 16-token pages) that is
// 4 x 512 x 128 bf16 keys (0.5 MB) and 34 MFLOP of fp32 on CUDA cores: under
// a microsecond of either against the card's peaks. What it pays for is the
// launch and the serial work of one CTA per (b, block): with nb = 1 only B
// SMs are busy, each doing the block's Hq x dk products and a log^2 sort
// network over the block.
//
// Design: one CTA per (block, b). q (as fp32, each row padded by one float so
// lanes reading different heads hit different banks) and w are staged in
// shared memory. Each warp scores kKeysPerPass keys per pass: the keys are
// staged transposed, [dk][kKeysPerPass], so one q load and two float4
// broadcasts feed kKeysPerPass FMAs; lane l owns heads l, l+32, ...; the
// per-head relu(q.k) * w terms are summed in registers and then across the
// warp with shuffles. Scores past valid_len are -inf. The block's
// (score, index) pairs never leave shared memory: they are sorted there by
// the bitonic network with the reference's strict compare rule (score
// descending, index ascending) and only the top c pairs are written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerPass = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
relevancy_topk_kernel(const T* __restrict__ q, const T* __restrict__ keys,
                      const float* __restrict__ w, float* __restrict__ out_vals,
                      int* __restrict__ out_idx, int Hq, int dk, int S, int block,
                      int c, int valid_len) {
  extern __shared__ __align__(16) float smem[];
  const int j = blockIdx.x, b = blockIdx.y, nb = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dkp = dk + 1;
  float* ks = smem;                                // [kWarps][dk][kKeysPerPass]
  float* qs = ks + kWarps * dk * kKeysPerPass;     // [Hq][dk + 1]
  float* ws = qs + Hq * dkp;                       // [Hq]
  float* sc = ws + Hq;                             // [block]
  int* ix = reinterpret_cast<int*>(sc + block);    // [block]

  for (int e = threadIdx.x; e < Hq * dk; e += blockDim.x)
    qs[(e / dk) * dkp + e % dk] = to_f32(q[(size_t)b * Hq * dk + e]);
  for (int e = threadIdx.x; e < Hq; e += blockDim.x) ws[e] = w[(size_t)b * Hq + e];
  __syncthreads();

  const T* kblk = keys + ((size_t)b * S + (size_t)j * block) * dk;
  float* kw = ks + warp * dk * kKeysPerPass;
  const float neg_inf = __int_as_float(0xff800000);
  for (int s0 = warp * kKeysPerPass; s0 < block; s0 += kWarps * kKeysPerPass) {
    for (int kk = 0; kk < kKeysPerPass; ++kk) {
      const bool in = s0 + kk < block;
      const T* src = kblk + (size_t)(s0 + kk) * dk;
      for (int d = lane; d < dk; d += 32) kw[d * kKeysPerPass + kk] = in ? to_f32(src[d]) : 0.f;
    }
    __syncwarp();
    float part[kKeysPerPass];
#pragma unroll
    for (int kk = 0; kk < kKeysPerPass; ++kk) part[kk] = 0.f;
    for (int h = lane; h < Hq; h += 32) {
      float dot[kKeysPerPass];
#pragma unroll
      for (int kk = 0; kk < kKeysPerPass; ++kk) dot[kk] = 0.f;
      const float* qh = qs + h * dkp;
      for (int d = 0; d < dk; ++d) {
        const float qv = qh[d];
        const float4 a = *reinterpret_cast<const float4*>(kw + d * kKeysPerPass);
        const float4 e4 = *reinterpret_cast<const float4*>(kw + d * kKeysPerPass + 4);
        dot[0] += qv * a.x;
        dot[1] += qv * a.y;
        dot[2] += qv * a.z;
        dot[3] += qv * a.w;
        dot[4] += qv * e4.x;
        dot[5] += qv * e4.y;
        dot[6] += qv * e4.z;
        dot[7] += qv * e4.w;
      }
      const float wh = ws[h];
#pragma unroll
      for (int kk = 0; kk < kKeysPerPass; ++kk) part[kk] += wh * fmaxf(dot[kk], 0.f);
    }
#pragma unroll
    for (int kk = 0; kk < kKeysPerPass; ++kk)
      for (int off = 16; off > 0; off >>= 1)
        part[kk] += __shfl_xor_sync(0xffffffffu, part[kk], off);
    if (lane == 0) {
#pragma unroll
      for (int kk = 0; kk < kKeysPerPass; ++kk) {
        const int s = s0 + kk;
        if (s < block) {
          sc[s] = (j * block + s < valid_len) ? part[kk] : neg_inf;
          ix[s] = s;
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  bitonic_sort_desc(sc, ix, block);

  const size_t o = ((size_t)b * nb + j) * c;
  for (int t = threadIdx.x; t < c; t += blockDim.x) {
    out_vals[o + t] = sc[t];
    out_idx[o + t] = j * block + ix[t];
  }
}

template <typename T>
int launch(const void* q, const void* keys, const void* w, void* vals, void* idx,
           int B, int Hq, int dk, int S, int block, int c, int valid_len,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kWarps * dk * kKeysPerPass + (size_t)Hq * (dk + 1) + Hq) +
      (sizeof(float) + sizeof(int)) * (size_t)block;
  cudaError_t err = cudaFuncSetAttribute(
      relevancy_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / block, B);
  relevancy_topk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(keys), static_cast<const float*>(w),
      static_cast<float*>(vals), static_cast<int*>(idx), Hq, dk, S, block, c, valid_len);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Hq,dk], keys [B,S,dk] (both fp32, or both bf16 when is_bf16), w [B,Hq]
// fp32 -> vals [B,S/block,c] fp32, idx [B,S/block,c] int32. block is a power
// of two dividing S; c <= block. Returns cudaGetLastError() after the launch.
extern "C" int relevancy_topk_candidates_cuda(const void* q, const void* keys,
                                              const void* w, void* vals, void* idx,
                                              int B, int Hq, int dk, int S, int block,
                                              int c, int valid_len, int is_bf16,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, keys, w, vals, idx, B, Hq, dk, S, block, c, valid_len, st);
  return launch<float>(q, keys, w, vals, idx, B, Hq, dk, S, block, c, valid_len, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
