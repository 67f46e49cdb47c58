// Paged sparse decode attention (one query per slot over selected KV pages),
// for Hopper (sm_90a): the selection split across SMs, asynchronous loads.
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
// Design.
// - Split: each (slot, kv head)'s selection is cut into n_split runs of
//   `pps` whole pages (the last run may be shorter); one CTA per (split,
//   kv head x head group, slot), so B x KV x n_split CTAs fill the 132 SMs
//   (kernels/sparse_decode_attention.py `split_plan` picks pps). A CTA keeps
//   up to kGT query heads of its kv head together, so each K/V row is read
//   from device memory once for all of them (G > kGT: one CTA per group of
//   kGT heads, each reading the rows).
// - Loads: tiles of kT tokens come in through a ring of kStages stages with
//   cp.async in 16-byte vectors, each row at the address the page table
//   gives (a page id < 0 reads page 0, as the reference).
// - Compute: fp32 FMAs from bf16 or fp32 (the kernel is bytes-bound, no
//   tensor cores). LPR lanes share a token row (one 16-byte chunk each); a
//   warp holds 32 / LPR such lane groups, and each group runs its own fp32
//   online softmax (m, l, acc per head) over every (32 / LPR x warps)-th
//   token of the split, so no block-wide reduction runs per tile.
// - Masks as the reference: page id < 0, or a token at or past `length`,
//   scores -1e30 (a slot with no valid token thus averages v over every
//   token it loaded); a position past the end of the split gets weight
//   exactly 0.
// - Partials: the CTA folds its lane groups into one (m, l, unnormalised
//   acc) per head, in a fixed order, and writes it to fp32 scratch. A second
//   kernel, launched by the same C entry point, folds the splits, in split
//   order: M = max m_i, L = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M)
//   / max(L, 1e-30), lse = M + log(max(L, 1e-30)). No atomics: a run repeats
//   bit for bit.
// - Why not merge per-split (out, lse) pairs with lse_merge: when a slot has
//   no valid token, every split's lse rounds to the same -1e30 whatever its
//   token count, so such a merge weights the split means equally, where the
//   reference averages v over all loaded tokens. Folding (m, l, acc) keeps
//   the counts in l, and is exact there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGT = 4;             // query heads per CTA
constexpr int kStages = 4;
constexpr int kTileBytes = 8192;   // K (and V) bytes of one stage
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes -> VEC floats
__device__ __forceinline__ void to_f32(const uint4& u, const float*, float* o) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void to_f32(const uint4& u, const __nv_bfloat16*, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// T: element type; LPR: lanes per token row (a power of two >= the row's
// 16-byte chunks, dh x sizeof(T) / 16)
template <typename T, int LPR>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ page_ids, const int* __restrict__ length,
                    float* __restrict__ part_ml, float* __restrict__ part_acc, int S, int KV,
                    int G, int dh, int ps, int n_sel, int pps, int n_split, float sqrt_dh) {
  constexpr int VEC = 16 / sizeof(T);      // channels per lane
  constexpr int RPW = 32 / LPR;            // token rows per warp pass
  constexpr int NSTREAM = kWarps * RPW;    // online-softmax lane groups
  constexpr int ROWB = LPR * 16;           // bytes of a token row in smem
  constexpr int kT = kTileBytes / ROWB;    // tokens per tile (2 per group)
  extern __shared__ __align__(16) uint8_t smem[];
  int* spages = reinterpret_cast<int*>(smem + kStages * 2 * kTileBytes);

  const int split = blockIdx.x, n_hg = (G + kGT - 1) / kGT;
  const int h = blockIdx.y / n_hg, g0 = (blockIdx.y % n_hg) * kGT;
  const int ng = min(kGT, G - g0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = lane % LPR, n_chunk = dh * (int)sizeof(T) / 16;
  const int stream = warp * RPW + lane / LPR;
  const int p_begin = split * pps, p_end = min(n_sel, p_begin + pps);
  const int n_tok = (p_end - p_begin) * ps;
  const int n_tiles = (n_tok + kT - 1) / kT;
  const int len = length[b];
  const size_t tok_stride = (size_t)KV * dh;
  const T* kb = k + (size_t)b * S * tok_stride + (size_t)h * dh;
  const T* vb = v + (size_t)b * S * tok_stride + (size_t)h * dh;

  for (int i = threadIdx.x; i < p_end - p_begin; i += kThreads)
    spages[i] = page_ids[(size_t)b * n_sel + p_begin + i];
  __syncthreads();

  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  auto load_tile = [&](int tile, int stage) {
    const uint32_t sk = ring + stage * 2 * kTileBytes, sv = sk + kTileBytes;
#pragma unroll
    for (int it = 0; it < kTileBytes / 16 / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int r = e / LPR, c = e % LPR;
      const int t = tile * kT + r;  // token within the split
      if (c < n_chunk && t < n_tok) {
        const size_t row = ((size_t)max(spages[t / ps], 0) * ps + t % ps) * tok_stride;
        const size_t off = row * sizeof(T) + (size_t)c * 16;
        cp_async16(sk + r * ROWB + c * 16, reinterpret_cast<const uint8_t*>(kb) + off);
        cp_async16(sv + r * ROWB + c * 16, reinterpret_cast<const uint8_t*>(vb) + off);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i, i);
    cp_async_commit();
  }

  // this lane's chunk of each head's query, divided by sqrt(dh)
  float qv[kGT][VEC], acc[kGT][VEC], m[kGT], l[kGT];
  const bool has_chunk = chunk < n_chunk;
#pragma unroll
  for (int g = 0; g < kGT; ++g) {
    m[g] = neg_inf();
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[g][e] = 0.f;
      const int d = chunk * VEC + e;
      qv[g][e] = (g < ng && has_chunk)
                     ? load_f32(q + ((size_t)b * KV * G + (size_t)h * G + g0 + g) * dh + d) / sqrt_dh
                     : 0.f;
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed for every thread; stage (i - 1) is free
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    const uint8_t* sk = smem + (i % kStages) * 2 * kTileBytes;
    const uint8_t* sv = sk + kTileBytes;

    // this group's two tokens of the tile: rows stream and stream + NSTREAM
    float s[2][kGT], vf[2][VEC];
    bool live[2];
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      const int r = stream + tt * NSTREAM;
      const int t = i * kT + r;
      live[tt] = t < n_tok;
      float kf[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = vf[tt][e] = 0.f;
      if (live[tt] && has_chunk) {
        to_f32(*reinterpret_cast<const uint4*>(sk + r * ROWB + chunk * 16), (const T*)nullptr, kf);
        to_f32(*reinterpret_cast<const uint4*>(sv + r * ROWB + chunk * 16), (const T*)nullptr,
               vf[tt]);
      }
#pragma unroll
      for (int g = 0; g < kGT; ++g) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) p = fmaf(qv[g][e], kf[e], p);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        s[tt][g] = p;
      }
      bool valid = false;
      if (live[tt]) {
        const int pid = spages[t / ps];
        valid = pid >= 0 && pid * ps + t % ps < len;
      }
#pragma unroll
      for (int g = 0; g < kGT; ++g)
        s[tt][g] = !live[tt] ? neg_inf() : valid ? s[tt][g] : kMasked;
    }
#pragma unroll
    for (int g = 0; g < kGT; ++g) {
      if (g >= ng) break;
      const float m_new = fmaxf(m[g], fmaxf(s[0][g], s[1][g]));
      if (m_new == neg_inf()) continue;  // nothing live yet
      const float corr = m[g] == m_new ? 1.f : expf(m[g] - m_new);
      const float p0 = live[0] ? expf(s[0][g] - m_new) : 0.f;
      const float p1 = live[1] ? expf(s[1][g] - m_new) : 0.f;
      l[g] = l[g] * corr + p0 + p1;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] = fmaf(p1, vf[1][e], fmaf(p0, vf[0][e], acc[g][e] * corr));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it now holds the lane groups' partials

  // [NSTREAM][kGT] (m, l), then [NSTREAM][kGT][dh] acc, then [kGT][NSTREAM]
  // weights e^(m_i - M)
  float* sm_ml = reinterpret_cast<float*>(smem);
  float* sm_acc = sm_ml + NSTREAM * kGT * 2;
  float* sm_w = sm_acc + NSTREAM * kGT * dh;
  if (chunk == 0) {
#pragma unroll
    for (int g = 0; g < kGT; ++g) {
      sm_ml[(stream * kGT + g) * 2] = m[g];
      sm_ml[(stream * kGT + g) * 2 + 1] = l[g];
    }
  }
  if (has_chunk) {
#pragma unroll
    for (int g = 0; g < kGT; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[(stream * kGT + g) * dh + chunk * VEC + e] = acc[g][e];
  }
  __syncthreads();

  // warp g folds head g's (m, l) over the lane groups
  const size_t hq0 = (size_t)b * KV * G + (size_t)h * G + g0;
  if (warp < ng) {
    const int g = warp;
    float M = neg_inf();
    for (int i = 0; i < NSTREAM; ++i) M = fmaxf(M, sm_ml[(i * kGT + g) * 2]);
    float L = 0.f;
    for (int i = lane; i < NSTREAM; i += 32) {
      const float mi = sm_ml[(i * kGT + g) * 2];
      const float wi = mi == neg_inf() ? 0.f : expf(mi - M);
      sm_w[g * NSTREAM + i] = wi;
    }
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < NSTREAM; ++i) L += sm_ml[(i * kGT + g) * 2 + 1] * sm_w[g * NSTREAM + i];
      float* ml = part_ml + ((hq0 + g) * n_split + split) * 2;
      ml[0] = M;
      ml[1] = L;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ng * dh; e += kThreads) {
    const int g = e / dh, d = e % dh;
    float a = 0.f;
    for (int i = 0; i < NSTREAM; ++i) a = fmaf(sm_acc[(i * kGT + g) * dh + d], sm_w[g * NSTREAM + i], a);
    part_acc[((hq0 + g) * n_split + split) * dh + d] = a;
  }
}

// fold the splits of one (slot, query head): blockIdx.x = b * Hq + hq
__global__ void __launch_bounds__(128)
paged_decode_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                            float* __restrict__ out, float* __restrict__ lse, int dh, int n_split) {
  const size_t row = blockIdx.x;
  const float* ml = part_ml + row * n_split * 2;
  float M = neg_inf();
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, ml[2 * i]);
  float L = 0.f;
  for (int i = 0; i < n_split; ++i)
    if (ml[2 * i] != neg_inf()) L += ml[2 * i + 1] * expf(ml[2 * i] - M);
  const float den = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n_split; ++i)
      if (ml[2 * i] != neg_inf()) a += part_acc[(row * n_split + i) * dh + d] * expf(ml[2 * i] - M);
    out[row * dh + d] = a / den;
  }
  if (threadIdx.x == 0) lse[row] = M == neg_inf() ? kMasked : M + logf(den);
}

template <typename T, int LPR>
int launch_split(const void* q, const void* k, const void* v, const void* page_ids,
                 const void* length, float* part_ml, float* part_acc, int B, int S, int KV, int G,
                 int dh, int ps, int n_sel, int pps, int n_split, float sqrt_dh,
                 cudaStream_t stream) {
  const size_t smem = (size_t)kStages * 2 * kTileBytes + sizeof(int) * (size_t)pps;
  auto kern = paged_decode_kernel<T, LPR>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_split, KV * ((G + kGT - 1) / kGT), B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(page_ids), static_cast<const int*>(length), part_ml, part_acc, S,
      KV, G, dh, ps, n_sel, pps, n_split, sqrt_dh);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* page_ids,
             const void* length, float* part_ml, float* part_acc, int B, int S, int KV, int G,
             int dh, int ps, int n_sel, int pps, int n_split, float sqrt_dh, cudaStream_t stream) {
  const int chunks = dh * (int)sizeof(T) / 16;
#define REPRO_LPR(N)                                                                          \
  if (chunks <= N)                                                                            \
    return launch_split<T, N>(q, k, v, page_ids, length, part_ml, part_acc, B, S, KV, G, dh, \
                              ps, n_sel, pps, n_split, sqrt_dh, stream);
  REPRO_LPR(1)
  REPRO_LPR(2)
  REPRO_LPR(4)
  REPRO_LPR(8)
  REPRO_LPR(16)
  REPRO_LPR(32)
#undef REPRO_LPR
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B,KV*G,dh]; k/v [B,S,KV,dh] (all fp32, or all bf16 when is_bf16; dh x
// the element size a multiple of 16 bytes, at most 512; 16-byte-aligned
// bases); page_ids [B,n_sel] int32 (-1 = hole); length [B] int32;
// part_ml [B,KV*G,n_split,2] and part_acc [B,KV*G,n_split,dh] fp32 scratch;
// split i covers pages [i*pps, min(n_sel, (i+1)*pps)), n_split =
// ceil(n_sel / pps) >= 1 -> out [B,KV*G,dh] fp32, lse [B,KV*G] fp32. Launches
// the split kernel, then the combine. Returns cudaGetLastError().
extern "C" int paged_decode_attention_cuda(const void* q, const void* k, const void* v,
                                           const void* page_ids, const void* length,
                                           void* part_ml, void* part_acc, void* out, void* lse,
                                           int B, int S, int KV, int G, int dh, int ps,
                                           int n_sel, int pps, int n_split, float sqrt_dh,
                                           int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dh * (is_bf16 ? 2 : 4)) % 16 || n_split < 1 || pps < 1) return (int)cudaErrorInvalidValue;
  float* ml = static_cast<float*>(part_ml);
  float* pa = static_cast<float*>(part_acc);
  const int err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, page_ids, length, ml, pa, B, S, KV, G, dh, ps,
                                        n_sel, pps, n_split, sqrt_dh, st)
              : dispatch<float>(q, k, v, page_ids, length, ml, pa, B, S, KV, G, dh, ps, n_sel,
                                pps, n_split, sqrt_dh, st);
  if (err) return err;
  paged_decode_combine_kernel<<<B * KV * G, 128, 0, st>>>(
      ml, pa, static_cast<float*>(out), static_cast<float*>(lse), dh, n_split);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
