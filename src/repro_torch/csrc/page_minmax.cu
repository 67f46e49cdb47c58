// Page-wise channel min / max of a key cache (LServe's prepare stage), for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/page_pool.py, page_minmax (Pallas body
// `_kernel`, :92-95; wrapper :99-120).
//
// What bounds it on this card: bytes. It reads every key once and writes two
// fp32 vectors per page, with one compare per element read. At 3.35 TB/s:
// LServe's main path (llama3.2-1b, k [4,8192,8,64] bf16, 64-token pages)
// reads 33.5 MB and writes 2.1 MB, 10.6 us; a decode-split shard of it
// ([2,8192,8,64]) 16.8 + 1.0 MB, 5.3 us; the hybrid's fp32 shard
// ([2,2048,32,112], C = 3584) 58.7 + 1.8 MB, 18.1 us.
//
// Design (the bulk route). A tile is one (slot, page, piece of a row): the
// whole row when it holds at most 256 16-byte vectors (512 bf16 channels:
// the tile is the page's contiguous 64 KB), else one of equal pieces of at
// most 256 vectors (3584 fp32 channels: 4 pieces of 3.5 KB, no ragged
// remainder). kernels/page_pool.py's `minmax_plan` sizes the tiles, the ring
// and the grid from the shape and the card's SM count. A persistent grid
// walks tiles blockIdx.x, += gridDim.x, so the CTAs' tile counts differ by
// at most one: one CTA an SM, or two where every tile fits in two CTAs an
// SM (the split shard: 256 tiles, all asked for at once). Warp 0 fills a
// ring of stages in dynamic shared memory with cp.async.bulk copies, each
// stage completing on its own mbarrier: a band of whole rows is contiguous
// and takes one copy, so 192 KB an SM is in flight from the start; a band
// of a piece takes one copy a row, through 2 stages of up to 64 KB (more
// copies in flight slowed these strided reads on the H100). A page taller
// than a stage holds streams in bands. Every thread folds the stage from
// shared memory (consecutive threads on consecutive 16-byte vectors, so no
// bank conflicts; when a piece has fewer vectors than the CTA threads, the
// spare threads take every R-th row), and warp 0 refills the stage with
// the band `stages` ahead as soon as every thread has folded it. bf16 folds
// as packed pairs with __hmin2_nan / __hmax2_nan, exact and NaN-propagating,
// widened to fp32 at the store; fp32 with take_min / take_max, which pass
// NaN through as torch.amin / amax do (fminf would drop it). The R row
// partials meet in shared memory and one thread per 16-byte vector writes
// the page's fp32 min and max. Min and max of values cast exactly to fp32
// are exact, so the kernel equals the plain version bit for bit.
//
// The scalar route (C x elem not a multiple of 16 bytes, or k unaligned):
// one CTA per (page, slot, chunk of up to 256 channels), one element a load.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float take_min(float a, float v) { return (v < a || v != v) ? v : a; }
__device__ __forceinline__ float take_max(float a, float v) { return (v > a || v != v) ? v : a; }

// ---------------------------------------------------------------------------
// scalar route
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
page_minmax_scalar(const T* __restrict__ k, float* __restrict__ out_min,
                   float* __restrict__ out_max, int S, int C, int ps) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.x, b = blockIdx.y, n_pages = gridDim.x;
  const int Gc = min(C, kThreads);       // channels per chunk
  const int c0 = blockIdx.z * Gc;        // this CTA's chunk
  const int R = kThreads / Gc;           // rows walked side by side
  const int t = threadIdx.x;
  const int r0 = t / Gc, gi = t % Gc;
  const bool active = t < R * Gc;
  float* smin = smem;                    // [R][Gc]
  float* smax = smin + R * Gc;
  const T* page = k + ((size_t)b * S + (size_t)p * ps) * C;
  const size_t o = ((size_t)b * n_pages + p) * C;
  const float inf = __int_as_float(0x7f800000);

  const int c = c0 + gi;
  float mn = inf, mx = -inf;
  if (active && c < C) {
#pragma unroll 4
    for (int r = r0; r < ps; r += R) {
      const float v = to_float(page[(size_t)r * C + c]);
      mn = take_min(mn, v);
      mx = take_max(mx, v);
    }
  }
  if (active) {
    smin[r0 * Gc + gi] = mn;
    smax[r0 * Gc + gi] = mx;
  }
  __syncthreads();
  const int n_out = min(Gc, C - c0);
  for (int e = t; e < n_out; e += kThreads) {
    float a = smin[e], z = smax[e];
    for (int r = 1; r < R; ++r) {
      a = take_min(a, smin[r * Gc + e]);
      z = take_max(z, smax[r * Gc + e]);
    }
    out_min[o + c0 + e] = a;
    out_max[o + c0 + e] = z;
  }
}

template <typename T>
int launch_scalar(const void* k, void* mn, void* mx, int B, int S, int C, int ps,
                  cudaStream_t stream) {
  const int Gc = min(C, kThreads);
  const int R = kThreads / Gc;
  const size_t smem = sizeof(float) * 2 * (size_t)R * Gc;
  const dim3 grid(S / ps, B, (C + Gc - 1) / Gc);
  page_minmax_scalar<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(k), static_cast<float*>(mn), static_cast<float*>(mx), S, C, ps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bulk route
// ---------------------------------------------------------------------------

// The tiling, as kernels/page_pool.py's minmax_plan computes it.
struct Plan {
  int W;       // 16-byte vectors in a piece; a row's last piece may be narrower
  int pieces;  // pieces in a row
  int rows;    // rows in a band; a page's last band may be shorter
  int bands;   // bands in a page
  int stages;  // ring stages of rows x W vectors
  int tiles;   // B x pages x pieces
};

// Dynamic shared memory, in 16-byte vectors: the ring [stages][rows x W],
// the (min, max) partials of two tiles in turn [2][2][kThreads], then one
// 8-byte mbarrier per stage.
__host__ __device__ inline size_t ring_vectors(const Plan& p) {
  return (size_t)p.stages * p.rows * p.W;
}
__host__ __device__ inline size_t smem_bytes(const Plan& p) {
  return 16 * (ring_vectors(p) + 4 * kThreads) + 8 * (size_t)p.stages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

// Min and max over the 32-bit lanes of a 16-byte vector of T.
template <typename T>
struct Lanes;

template <>
struct Lanes<float> {
  static constexpr uint32_t kPosInf = 0x7f800000u, kNegInf = 0xff800000u;
  __device__ static uint32_t lo(uint32_t a, uint32_t v) {
    return __float_as_uint(take_min(__uint_as_float(a), __uint_as_float(v)));
  }
  __device__ static uint32_t hi(uint32_t a, uint32_t v) {
    return __float_as_uint(take_max(__uint_as_float(a), __uint_as_float(v)));
  }
  // the vector's 4 channels as fp32
  __device__ static void store(float* o, const uint4& v) {
    *reinterpret_cast<float4*>(o) = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                                __uint_as_float(v.z), __uint_as_float(v.w));
  }
};

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr uint32_t kPosInf = 0x7f807f80u, kNegInf = 0xff80ff80u;
  __device__ static __nv_bfloat162 pair(const uint32_t& a) {
    return *reinterpret_cast<const __nv_bfloat162*>(&a);
  }
  __device__ static uint32_t bits(const __nv_bfloat162& h) {
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint32_t lo(uint32_t a, uint32_t v) {
    return bits(__hmin2_nan(pair(a), pair(v)));
  }
  __device__ static uint32_t hi(uint32_t a, uint32_t v) {
    return bits(__hmax2_nan(pair(a), pair(v)));
  }
  // the vector's 8 channels as fp32: a bf16's bits are the top half of its fp32's
  __device__ static void store(float* o, const uint4& v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      reinterpret_cast<float4*>(o)[i] =
          make_float4(__uint_as_float(w[2 * i] << 16), __uint_as_float(w[2 * i] & 0xffff0000u),
                      __uint_as_float(w[2 * i + 1] << 16),
                      __uint_as_float(w[2 * i + 1] & 0xffff0000u));
  }
};

template <typename L>
__device__ __forceinline__ void fold_lo(uint4& a, const uint4& v) {
  a = make_uint4(L::lo(a.x, v.x), L::lo(a.y, v.y), L::lo(a.z, v.z), L::lo(a.w, v.w));
}
template <typename L>
__device__ __forceinline__ void fold_hi(uint4& a, const uint4& v) {
  a = make_uint4(L::hi(a.x, v.x), L::hi(a.y, v.y), L::hi(a.z, v.z), L::hi(a.w, v.w));
}

// One band of one of this CTA's tiles: the CTA streams its tiles' bands,
// u = (its k-th tile) x bands + band, through the ring.
struct Unit {
  int tile_k;   // the tile's ordinal among this CTA's
  int band;
  int bp;       // slot x pages + page
  int g0, w;    // the piece: its first vector in the row, its vectors
  int nr;       // the band's rows
  size_t row0;  // the band's first row of k, as [B x S] rows
};

__device__ __forceinline__ Unit unit_of(const Plan& p, int G, int ps, int u) {
  Unit x;
  x.tile_k = u / p.bands;
  x.band = u % p.bands;
  const int tile = blockIdx.x + x.tile_k * gridDim.x;
  x.bp = tile / p.pieces;
  x.g0 = (tile % p.pieces) * p.W;
  x.w = min(p.W, G - x.g0);
  const int r = x.band * p.rows;
  x.nr = min(p.rows, ps - r);
  x.row0 = (size_t)x.bp * ps + r;
  return x;
}

// Warp 0: copy unit u into its stage. A band of whole rows is contiguous
// and goes in one copy; a band of pieces in one copy per row, the lanes
// taking rows in turn.
template <typename T>
__device__ __forceinline__ void issue(const T* k, uint4* ring, uint32_t bar0, int C, int ps,
                                      const Plan& p, int G, int u) {
  const Unit x = unit_of(p, G, ps, u);
  const int s = u % p.stages, lane = threadIdx.x;
  const uint32_t bar = bar0 + 8 * s;
  uint4* dst = ring + (size_t)s * p.rows * p.W;
  const T* src = k + x.row0 * C + (size_t)x.g0 * (16 / sizeof(T));
  // the stage was last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"((uint32_t)(x.nr * x.w * 16))
                 : "memory");
  __syncwarp();
  if (x.w == G) {
    if (lane == 0) bulk_load(dst, src, (uint32_t)(x.nr * x.w * 16), bar);
  } else {
    for (int r = lane; r < x.nr; r += 32)
      bulk_load(dst + (size_t)r * x.w, src + (size_t)r * C, (uint32_t)(x.w * 16), bar);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
page_minmax_bulk(const T* __restrict__ k, float* __restrict__ out_min,
                 float* __restrict__ out_max, int C, int ps, Plan p) {
  using L = Lanes<T>;
  constexpr int VEC = 16 / sizeof(T);    // channels in a vector
  extern __shared__ __align__(128) uint4 smem_v[];
  uint4* ring = smem_v;
  uint4* part = ring + ring_vectors(p);
  const uint32_t bar0 = smem_u32(part + 4 * kThreads);
  const int G = C / VEC;                 // vectors in a row
  const int t = threadIdx.x;
  // gridDim.x <= tiles: every CTA has at least one
  const int n_units = ((p.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * p.bands;

  if (t == 0) {
    for (int s = 0; s < p.stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t < 32)
    for (int u = 0; u < p.stages && u < n_units; ++u) issue(k, ring, bar0, C, ps, p, G, u);

  uint4 mn = make_uint4(0, 0, 0, 0), mx = mn;
  for (int u = 0; u < n_units; ++u) {
    const Unit x = unit_of(p, G, ps, u);
    const int s = u % p.stages;
    const int R = kThreads / x.w, r0 = t / x.w, g = t % x.w;
    if (x.band == 0) {
      mn = make_uint4(L::kPosInf, L::kPosInf, L::kPosInf, L::kPosInf);
      mx = make_uint4(L::kNegInf, L::kNegInf, L::kNegInf, L::kNegInf);
    }
    mbar_wait(bar0 + 8 * s, (u / p.stages) & 1);
    const uint4* st = ring + (size_t)s * p.rows * p.W;
    if (r0 < R) {
#pragma unroll 4
      for (int r = r0; r < x.nr; r += R) {
        const uint4 v = st[r * x.w + g];
        fold_lo<L>(mn, v);
        fold_hi<L>(mx, v);
      }
    }
    // the partials of this CTA's tiles alternate between two buffers: the
    // barrier below separates a tile's reads of one from the next writes
    const bool last = x.band == p.bands - 1;
    uint4* pmin = part + (x.tile_k & 1) * 2 * kThreads;
    uint4* pmax = pmin + kThreads;
    if (last && r0 < R) {
      pmin[t] = mn;
      pmax[t] = mx;
    }
    __syncthreads();   // every thread has folded stage s
    if (t < 32 && u + p.stages < n_units) issue(k, ring, bar0, C, ps, p, G, u + p.stages);
    if (last && t < x.w) {
      uint4 a = pmin[t], z = pmax[t];
      for (int r = 1; r < R; ++r) {
        fold_lo<L>(a, pmin[r * x.w + t]);
        fold_hi<L>(z, pmax[r * x.w + t]);
      }
      const size_t o = (size_t)x.bp * C + (size_t)(x.g0 + t) * VEC;
      L::store(out_min + o, a);
      L::store(out_max + o, z);
    }
  }
}

template <typename T>
int launch_bulk(const void* k, void* mn, void* mx, int B, int S, int C, int ps, int W, int rows,
                int stages, int grid, int smem, cudaStream_t stream) {
  const int G = C / (16 / (int)sizeof(T));
  if (W < 1 || W > G || W > kThreads || rows < 1 || rows > ps || stages < 1)
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.W = W;
  p.pieces = (G + W - 1) / W;
  p.rows = rows;
  p.bands = (ps + rows - 1) / rows;
  p.stages = stages;
  p.tiles = B * (S / ps) * p.pieces;
  if (grid < 1 || grid > p.tiles || (size_t)smem != smem_bytes(p))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(page_minmax_bulk<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  page_minmax_bulk<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(k), static_cast<float*>(mn), static_cast<float*>(mx), C, ps, p);
  return (int)cudaGetLastError();
}

}  // namespace

// k [B,S,C] (C = KV x dh; fp32, or bf16 when is_bf16) -> min, max
// [B,S/ps,C] fp32. S % ps == 0. W > 0 takes the bulk route with the plan
// (W, rows, stages, grid, smem) of kernels/page_pool.py's minmax_plan: C x
// elem must be a multiple of 16 bytes and k 16-byte aligned, and the plan
// must be whole, else the call returns cudaErrorInvalidValue. W == 0 takes
// the scalar route. Returns cudaGetLastError() after the launch.
extern "C" int page_minmax_cuda(const void* k, void* mn, void* mx, int B, int S, int C, int ps,
                                int is_bf16, int W, int rows, int stages, int grid, int smem,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W == 0)
    return is_bf16 ? launch_scalar<__nv_bfloat16>(k, mn, mx, B, S, C, ps, st)
                   : launch_scalar<float>(k, mn, mx, B, S, C, ps, st);
  const int per16 = is_bf16 ? 8 : 4;
  if (C % per16 || reinterpret_cast<uintptr_t>(k) % 16) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch_bulk<__nv_bfloat16>(k, mn, mx, B, S, C, ps, W, rows, stages, grid,
                                               smem, st)
                 : launch_bulk<float>(k, mn, mx, B, S, C, ps, W, rows, stages, grid, smem, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
