// Page-wise channel min / max of a key cache (LServe's prepare stage), for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/page_pool.py, page_minmax (Pallas body
// `_kernel`, :92-95; wrapper :99-120).
//
// What bounds it on this card: bytes. It reads every key once and writes two
// fp32 vectors per page, with one compare per element read. On the LServe
// path (llama3.2-1b, 4 slots, an 8192-token view, KV 8, dh 64, 64-token
// pages) that is 33.5 MB of bf16 keys in and 2.1 MB out: about 10.6 us at
// 3.35 TB/s, against 33.5 M compares.
//
// Design: one CTA per (page, slot, chunk of channels). A row of the page
// holds C = KV x dh channels; threads take vectors of VEC channels side by
// side (16-byte loads: 8 bf16 or 4 fp32), so a warp reads 512 contiguous
// bytes of a row, and a CTA takes up to 256 vectors of the row: a wider row
// is cut into chunks over the grid's third axis (zamba2's C = 32 x 112 in
// fp32: 4 chunks), so a few long pages still fill the SMs. When a row has
// fewer vectors than the CTA has threads, the spare threads take every
// R-th row of the page, so all 256 threads load. Each thread
// keeps a running min and max of its channels in registers over its rows;
// the R partial results meet in shared memory and one thread per channel
// folds them and writes the page's min and max. The compare propagates NaN
// as torch.amin / amax do; min and max of values cast exactly to fp32 are
// exact, so the kernel equals the plain version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float take_min(float a, float v) { return (v < a || v != v) ? v : a; }
__device__ __forceinline__ float take_max(float a, float v) { return (v > a || v != v) ? v : a; }

// VEC consecutive elements of T at p, as fp32
template <typename T, int VEC>
struct Load;

template <>
struct Load<float, 1> {
  __device__ static void run(const float* p, float* o) { o[0] = p[0]; }
};
template <>
struct Load<__nv_bfloat16, 1> {
  __device__ static void run(const __nv_bfloat16* p, float* o) { o[0] = __bfloat162float(p[0]); }
};
template <>
struct Load<float, 4> {
  __device__ static void run(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};
template <>
struct Load<__nv_bfloat16, 8> {
  __device__ static void run(const __nv_bfloat16* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
page_minmax_kernel(const T* __restrict__ k, float* __restrict__ out_min,
                   float* __restrict__ out_max, int S, int C, int ps) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.x, b = blockIdx.y, n_pages = gridDim.x;
  const int G = C / VEC;                 // vectors per row
  const int Gc = min(G, kThreads);       // vectors per chunk
  const int g0 = blockIdx.z * Gc;        // this CTA's chunk
  const int R = kThreads / Gc;           // rows walked side by side
  const int t = threadIdx.x;
  const int r0 = t / Gc, gi = t % Gc;
  const bool active = t < R * Gc;
  float* smin = smem;                    // [R][Gc][VEC]
  float* smax = smin + R * Gc * VEC;
  const T* page = k + ((size_t)b * S + (size_t)p * ps) * C;
  const size_t o = ((size_t)b * n_pages + p) * C;
  const float inf = __int_as_float(0x7f800000);

  const int g = g0 + gi;
  float mn[VEC], mx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mn[i] = inf;
    mx[i] = -inf;
  }
  if (active && g < G) {
#pragma unroll 4
    for (int r = r0; r < ps; r += R) {
      float v[VEC];
      Load<T, VEC>::run(page + (size_t)r * C + (size_t)g * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        mn[i] = take_min(mn[i], v[i]);
        mx[i] = take_max(mx[i], v[i]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      smin[(r0 * Gc + gi) * VEC + i] = mn[i];
      smax[(r0 * Gc + gi) * VEC + i] = mx[i];
    }
  }
  __syncthreads();
  const int n_out = min(Gc, G - g0) * VEC;
  for (int e = t; e < n_out; e += kThreads) {
    float a = smin[e], z = smax[e];
    for (int r = 1; r < R; ++r) {
      a = take_min(a, smin[r * Gc * VEC + e]);
      z = take_max(z, smax[r * Gc * VEC + e]);
    }
    out_min[o + (size_t)g0 * VEC + e] = a;
    out_max[o + (size_t)g0 * VEC + e] = z;
  }
}

template <typename T, int VEC>
int launch(const void* k, void* mn, void* mx, int B, int S, int C, int ps,
           cudaStream_t stream) {
  const int G = C / VEC;
  const int Gc = min(G, kThreads);
  const int R = kThreads / Gc;
  const size_t smem = sizeof(float) * 2 * (size_t)R * Gc * VEC;
  const dim3 grid(S / ps, B, (G + Gc - 1) / Gc);
  page_minmax_kernel<T, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(k), static_cast<float*>(mn), static_cast<float*>(mx), S, C, ps);
  return (int)cudaGetLastError();
}

}  // namespace

// k [B,S,C] (C = KV x dh; fp32, or bf16 when is_bf16) -> min, max
// [B,S/ps,C] fp32. S % ps == 0. wide != 0 takes 16-byte loads (8 bf16 / 4
// fp32): C must be a multiple of that and k 16-byte aligned, else the call
// returns cudaErrorInvalidValue. Returns cudaGetLastError() after the
// launch.
extern "C" int page_minmax_cuda(const void* k, void* mn, void* mx, int B, int S, int C, int ps,
                                int is_bf16, int wide, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per16 = is_bf16 ? 8 : 4;
  if (wide && (C % per16 || reinterpret_cast<uintptr_t>(k) % 16)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return wide ? launch<__nv_bfloat16, 8>(k, mn, mx, B, S, C, ps, st)
                : launch<__nv_bfloat16, 1>(k, mn, mx, B, S, C, ps, st);
  return wide ? launch<float, 4>(k, mn, mx, B, S, C, ps, st)
              : launch<float, 1>(k, mn, mx, B, S, C, ps, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
