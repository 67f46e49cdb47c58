// Paged sparse decode attention (one query per slot over selected KV pages),
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sparse_decode_attention.py,
// paged_decode_attention (Pallas body `_kernel`, :24-60; wrapper :66-121).
//
// What bounds it on this card: bytes. Each (slot, kv head) reads the K and V
// rows of its n_sel selected pages once and does 4 x G x dh FLOP per token
// read. On the DSA main path (llama3.2-1b: KV = 8, G = 4, dh = 64; 128
// selected 16-token pages per slot, 4 slots) that is 16.8 MB of bf16 K/V, a
// bound of about 5 us at 3.35 TB/s, against 34 MFLOP.
//
// Design: one CTA per (kv head, slot); the G query heads that share the kv
// head ride in the same CTA, so each K/V row is read from device memory once
// for all of them (the reference packs G heads per program the same way). The
// CTA walks the selected tokens in tiles of kTile: it stages their K (rows
// padded by one float against bank conflicts) and V in shared memory as fp32,
// scores all G x kTile pairs, and folds the tile into an fp32 online softmax
// (running max m, sum l, accumulator acc in shared memory). The masks follow
// the reference exactly: a page id < 0 loads page 0 and is masked, a token at
// or past `length` is masked, both to -1e30 (so a row with no valid token
// averages v over the loaded tokens, as the reference does); positions past
// the end of the selection get no weight at all. out = acc / max(l, 1e-30)
// and lse = m + log(max(l, 1e-30)). This first version loads synchronously;
// it leaves splitting the pages across CTAs (to fill all SMs at small batch)
// and asynchronous copies to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ page_ids,
                    const int* __restrict__ length, float* __restrict__ out,
                    float* __restrict__ lse, int S, int KV, int G, int dh, int ps,
                    int n_sel, float sqrt_dh) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dhp = dh + 1;
  float* qs = smem;                 // [G][dh], divided by sqrt(dh)
  float* ks = qs + G * dh;          // [kTile][dh + 1]
  float* vs = ks + kTile * dhp;     // [kTile][dh]
  float* pr = vs + kTile * dh;      // [G][kTile]: scores, then probabilities
  float* acc = pr + G * kTile;      // [G][dh]
  float* m = acc + G * dh;          // [G] running max
  float* l = m + G;                 // [G] running sum
  float* corr = l + G;              // [G] rescale of this tile
  int* pages = reinterpret_cast<int*>(corr + G);  // [n_sel]

  const int len = length[b];
  const size_t tok_stride = (size_t)KV * dh;
  const T* kb = k + (size_t)b * S * tok_stride + (size_t)h * dh;
  const T* vb = v + (size_t)b * S * tok_stride + (size_t)h * dh;
  const size_t qo = ((size_t)b * KV + h) * G * dh;
  for (int e = threadIdx.x; e < G * dh; e += blockDim.x) {
    qs[e] = to_f32(q[qo + e]) / sqrt_dh;
    acc[e] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m[g] = kMasked;
    l[g] = 0.f;
  }
  for (int e = threadIdx.x; e < n_sel; e += blockDim.x) pages[e] = page_ids[(size_t)b * n_sel + e];
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  const int n_tok = n_sel * ps;
  for (int t0 = 0; t0 < n_tok; t0 += kTile) {
    const int nt = min(kTile, n_tok - t0);
    // one warp per token row: the row's address is worked out once, and
    // the lanes read its dh channels side by side
    for (int tt = warp; tt < nt; tt += kWarps) {
      const int t = t0 + tt;
      const size_t row = ((size_t)max(pages[t / ps], 0) * ps + t % ps) * tok_stride;
      for (int d = lane; d < dh; d += 32) {
        ks[tt * dhp + d] = to_f32(kb[row + d]);
        vs[tt * dh + d] = to_f32(vb[row + d]);
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < G * kTile; e += blockDim.x) {
      const int g = e / kTile, tt = e % kTile, t = t0 + tt;
      float s = neg_inf;  // past the selection: weight exactly 0
      if (tt < nt) {
        const int pid = pages[t / ps];
        if (pid >= 0 && pid * ps + t % ps < len) {
          const float* qg = qs + g * dh;
          const float* kr = ks + tt * dhp;
          s = 0.f;
          for (int d = 0; d < dh; ++d) s += qg[d] * kr[d];
        } else {
          s = kMasked;
        }
      }
      pr[e] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pg = pr + g * kTile;
      float mx = neg_inf;
      for (int tt = lane; tt < kTile; tt += 32) mx = fmaxf(mx, pg[tt]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      float sum = 0.f;
      for (int tt = lane; tt < kTile; tt += 32) {
        const float p = expf(pg[tt] - m_new);
        pg[tt] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = expf(m[g] - m_new);
        corr[g] = c;
        l[g] = l[g] * c + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < G * dh; e += blockDim.x) {
      const int g = e / dh, d = e % dh;
      const float* pg = pr + g * kTile;
      float a = acc[e] * corr[g];
      for (int tt = 0; tt < nt; ++tt) a += pg[tt] * vs[tt * dh + d];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < G * dh; e += blockDim.x)
    out[qo + e] = acc[e] / fmaxf(l[e / dh], 1e-30f);
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    lse[((size_t)b * KV + h) * G + g] = m[g] + logf(fmaxf(l[g], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* page_ids,
           const void* length, void* out, void* lse, int B, int S, int KV, int G,
           int dh, int ps, int n_sel, float sqrt_dh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * G * dh + (size_t)kTile * (2 * dh + 1) +
                                       (size_t)G * kTile + 3 * (size_t)G) +
                      sizeof(int) * (size_t)n_sel;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KV, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(page_ids), static_cast<const int*>(length),
      static_cast<float*>(out), static_cast<float*>(lse), S, KV, G, dh, ps, n_sel, sqrt_dh);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,KV*G,dh]; k/v [B,S,KV,dh] (all fp32, or all bf16 when is_bf16);
// page_ids [B,n_sel] int32 (-1 = hole); length [B] int32
// -> out [B,KV*G,dh] fp32, lse [B,KV*G] fp32. Returns cudaGetLastError().
extern "C" int paged_decode_attention_cuda(const void* q, const void* k, const void* v,
                                           const void* page_ids, const void* length,
                                           void* out, void* lse, int B, int S, int KV,
                                           int G, int dh, int ps, int n_sel, float sqrt_dh,
                                           int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, page_ids, length, out, lse, B, S, KV, G, dh, ps,
                                 n_sel, sqrt_dh, st);
  return launch<float>(q, k, v, page_ids, length, out, lse, B, S, KV, G, dh, ps, n_sel,
                       sqrt_dh, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
