// Causal flash attention (FlashAttention-2 forward: fp32 online softmax, GQA,
// optional sliding window), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (Pallas body
// `_kernel`, :21-66; wrapper :70-112). It computes the same function as the
// reference's XLA `attention_full` (src/repro/models/attention.py:113), so the
// port routes its own `attention_full` here on the card: the training forward
// (and its remat recompute) and the serving engine's bucketed prefill.
//
// What bounds it on this card: operations. Each (query row, key) pair the
// causal band keeps costs 4 x dh FLOP (a q.k dot and a p.v update) per query
// head, so the work is 4 x B x H x dh x pairs, with pairs = S(S+1)/2 causal,
// or the banded count under a window; the bytes are q, k, v and out, each
// touched once. On the training shape (llama3.2-1b: B 4, S 2048, H 32, KV 8,
// dh 64, bf16) that is 68.7 GFLOP against 83.9 MB: about 70 us at the
// tensor cores' 989 TFLOP/s bf16 peak, against 25 us for the bytes.
//
// Design (a simple first version): one CTA of 256 threads per (64-row query
// tile, head, batch); the TPU's sequential kv grid axis becomes a loop inside
// the CTA over 64-key tiles, from the tile holding the window's first key (0
// without a window) to the diagonal tile, so tiles past the diagonal or
// wholly before the window are never read. Query tiles are issued longest
// first. The query tile (scaled by 1/sqrt(dh) in fp32, as the reference
// does) and each K / V tile are staged in shared memory as fp32; rows at or
// past S are zero-filled and masked (kpos >= S), never padded by a copy, and
// output rows >= S are never written. Head h reads kv head h / G. Each thread
// owns 4 query rows x 4 key columns of the score tile and 4 rows x dh/16
// output channels: it computes its scores with fp32 FMAs, masks them to
// -1e30 (causal, window, kpos >= S, as the reference), and the 16 threads of
// a row (one half-warp) reduce the row max and sum with shuffles. P stays
// fp32 into the P.V product, and fp32 inputs never pass through TF32: every
// product is an fp32 FMA on the CUDA cores. The running m, l and acc are
// fp32; out = acc / max(l, 1e-30), written in the inputs' dtype. The tensor
// cores (wgmma), TMA and asynchronous copies are left to a later change: this
// version runs at the CUDA cores' fp32 rate at best (67 TFLOP/s).
//
// The JAX package has no backward kernel for this function (XLA
// differentiates `attention_full` outside any Pallas kernel), so neither does
// the port: `FlashAttention.backward` (kernels/flash_attention.py) recomputes
// attention in plain torch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr float kMasked = -1e30f;

// four consecutive elements at p (16-byte aligned fp32, 8-byte aligned bf16)
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Rows r0 .. r0+63 of one head (row stride `stride_s` elements) into the
// fp32 tile `tile` (row stride `ld` floats), times `scale`; rows >= S zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, long long stride_s, int r0,
                                          int S, float scale, float* tile, int ld) {
  constexpr int V = DH / 4;  // 4-element vectors per row
#pragma unroll
  for (int it = 0; it < kBQ * V / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = e / V, c = (e % V) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) load4(x + (long long)(r0 + r) * stride_s + c, f);
    *reinterpret_cast<float4*>(tile + r * ld + c) =
        make_float4(f[0] * scale, f[1] * scale, f[2] * scale, f[3] * scale);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int G, int window,
                       float scale, long long qsb, long long qss, long long qsh, long long ksb,
                       long long kss, long long ksh, long long vsb, long long vss,
                       long long vsh, long long osb, long long oss, long long osh) {
  constexpr int LQ = DH + 4;        // padded rows: conflict-free float4 reads
  constexpr int LP = kBK + 4;
  constexpr int OC = DH / 16;       // output channels per thread
  // channels a thread reads as one vector: 4 (dh 64, 128), 2 (dh 32), 1
  // (dh 112: 7 channels, each thread's a stride of 16 apart)
  constexpr int CW = OC % 4 == 0 ? 4 : OC % 2 == 0 ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [kBQ][LQ], pre-scaled
  float* Ks = Qs + kBQ * LQ;        // [kBK][LQ]
  float* Vs = Ks + kBK * LQ;        // [kBK][DH]
  float* Ps = Vs + kBK * DH;        // [kBQ][LP]: this tile's probabilities

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest query tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  load_tile<T, DH>(q + b * qsb + h * qsh, qss, q0, S, scale, Qs, LQ);

  float acc[4][OC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < OC; ++e) acc[i][e] = 0.f;
  }
  const int last = min(q0 + kBQ, S) - 1;          // the diagonal
  const int first = window ? max(0, q0 - window + 1) : 0;

  for (int k0 = (first / kBK) * kBK; k0 <= last; k0 += kBK) {
    __syncthreads();  // the previous tile's K / V reads are done
    load_tile<T, DH>(kb, kss, k0, S, 1.f, Ks, LQ);
    load_tile<T, DH>(vb, vss, k0, S, 1.f, Vs, DH);
    __syncthreads();

    // scores: rows ty*4 + i, key columns tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, c[j].x, t);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          t = fmaf(a[i].w, c[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, then the online softmax; a row's 16 threads share one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < S && kp <= qp && (window == 0 || qp - kp < window);
        s[i][j] = ok ? s[i][j] : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < OC; ++e) acc[i][e] *= corr;
    }
    __syncwarp();  // a row of Ps is written and read by one half-warp

    // acc += P . V: channels (e / CW) * 16 * CW + tx * CW + e % CW
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * LP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vr = Vs + (kk + t) * DH + tx * CW;
        float vv[OC];
#pragma unroll
        for (int e = 0; e < OC; e += CW) {
          if constexpr (CW == 4) {
            const float4 w = *reinterpret_cast<const float4*>(vr + (e / CW) * 16 * CW);
            vv[e] = w.x;
            vv[e + 1] = w.y;
            vv[e + 2] = w.z;
            vv[e + 3] = w.w;
          } else if constexpr (CW == 2) {
            const float2 w = *reinterpret_cast<const float2*>(vr + (e / CW) * 16 * CW);
            vv[e] = w.x;
            vv[e + 1] = w.y;
          } else {
            vv[e] = vr[e * 16];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pt = t == 0 ? p[i].x : t == 1 ? p[i].y : t == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int e = 0; e < OC; ++e) acc[i][e] = fmaf(pt, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + b * osb + qp * oss + h * osh + tx * CW;
#pragma unroll
    for (int e = 0; e < OC; ++e) store1(o + (e / CW) * 16 * CW + e % CW, acc[i][e] / den);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int G,
           int window, float scale, const long long* st, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * (DH + 4) + (size_t)kBK * DH +
                                           (size_t)kBQ * (kBK + 4));
  auto kern = flash_attention_kernel<T, DH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, G, window, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int G,
             int dh, int window, float scale, const long long* st, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, G, window, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, G, window, scale, st, stream);
    case 112: return launch<T, 112>(q, k, v, out, B, S, H, G, window, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, G, window, scale, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,S,H,dh]; k/v [B,S,H/G,dh] (all fp32, or all bf16 when is_bf16) ->
// out [B,S,H,dh] in the same dtype. strides: 12 element strides, (batch,
// seq, head) of q, k, v and out in turn; the channel stride is 1, and every
// stride and base pointer is a multiple of 4 elements (16 bytes fp32, 8
// bytes bf16). dh is 32, 64, 112 or 128 (else cudaErrorInvalidValue). window 0:
// causal only. scale: 1/sqrt(dh). Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention_cuda(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int H, int G, int dh, int window,
                                    float scale, int is_bf16, const long long* strides,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, G, dh, window, scale, strides, st);
  return dispatch<float>(q, k, v, out, B, S, H, G, dh, window, scale, strides, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
