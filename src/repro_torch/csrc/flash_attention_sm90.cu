// Causal flash attention for bf16 on Hopper's tensor cores (sm_90a): the
// FlashAttention-3 shape of the forward, with TMA loads and wgmma.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (Pallas body
// `_kernel`, :21-66; wrapper :70-112), for bf16 inputs at head dim 64, 112
// and 128 (the training, bucketed-prefill and mixtral shapes; zamba2's shared
// block). fp32 inputs and other head dims take the CUDA-core kernel of
// flash_attention.cu, the exact route; kernels/flash_attention.py `_route`
// chooses by dtype and head dim only.
//
// What bounds it on this card: operations. Each (query, key) pair the causal
// band keeps costs 4 x dh FLOP per query head (training shape: 68.7 GFLOP
// against 83.9 MB, 70 us at the 989 TFLOP/s bf16 peak, 25 us for the bytes).
//
// Design. One CTA per (query tile, head, batch), query tiles issued longest
// first: kNWG consumer warpgroups of 64 query rows each (3 at dh 64, a
// 192-row tile; 2 at dh 112 and 128) and one producer warp.
// - Loads: the producer warp's lane 0 issues TMA copies
//   (cp.async.bulk.tensor, 4-d tensor maps over [B, S, heads, dh] read
//   through the inputs' strides) into shared memory with the 128-byte
//   swizzle: the Q tile once, then K and V tiles of 64 keys through a ring of
//   kStages = 3 stages. A stage's `full` mbarrier counts the TMA bytes; its
//   `empty` mbarrier counts the consumer warps' releases. Rows at or past S
//   come in as zeros (TMA fills out-of-bounds rows) and are masked.
// - dh 112 is no multiple of the 64-channel swizzle row: the tensor maps keep
//   the channel extent at 112 and each tile is two 64-channel boxes, the
//   second filled with zeros past channel 112 by TMA (no copy, no extra HBM
//   bytes). Q.K^T runs 7 k16 steps, P.V is one wgmma of N = 112 a k16 step,
//   and the store writes the 112 channels.
// - S = Q.K^T: wgmma m64n64k16, bf16 -> fp32, Q and K K-major from swizzled
//   shared memory. Products of bf16 values are exact in fp32, so only the
//   order of the sum differs from the fp32 reference. 1/sqrt(dh) is applied
//   to the fp32 scores (2^-3 at dh 64: exact).
// - Masks as the reference and flash_attention.cu: causal, window, kpos >= S
//   give -1e30; tiles past a warpgroup's diagonal or wholly before its window
//   are skipped (the CTA loads the union of its warpgroups' tiles). A tile
//   wholly below every row's diagonal and inside every row's window skips
//   the mask and folds the scale into the exponent's FMA.
// - Online softmax in fp32 registers (a row lives in one quad of lanes),
//   overlapped with the tensor cores: S(i) = Q.K(i)^T is issued, then
//   P.V(i - 1), and the softmax of S(i) runs while P.V(i - 1) does.
// - P.V: P stays in registers as the wgmma A operand (the accumulator
//   fragment of S is the A fragment of P, as FA3 uses it). To keep P.V
//   fp32-accurate, P is split into a bf16 high part and a bf16 low part
//   (P_hi = bf16(P), P_lo = bf16(P - P_hi)): both go through wgmma m64nDHk16
//   with V read transposed (MN-major) from shared memory, into one fp32
//   accumulator. That is a third more tensor-core work and keeps P to ~16
//   bits. out = acc / max(l, 1e-30), written as bf16; rows >= S never.
// Traps:
// - TMA needs a 16-byte-aligned base and 16-byte multiples for every stride
//   but the channel one; the wrapper copies an input that breaks this.
// - cuTensorMapEncodeTiled is a driver-API function; it is looked up with
//   dlopen/dlsym in libcuda.so.1 (loaded already by the CUDA runtime), so the
//   build links nothing extra.
// - wgmma exists only for sm_90a (NVCC_FLAGS in kernels/_build.py).
// - ptxas serialises wgmma (C7520, C7515) under a branch it cannot prove
//   warp-uniform, or where a path it cannot rule out writes an accumulator
//   in flight: the warp and warpgroup indices come through __shfl_sync, and
//   the pipelined loop has no branch around a wgmma in flight.
// - Registers: at dh 128 a consumer thread holds S (32 fp32), P_hi and P_lo
//   (16 + 16 packed pairs) and the output accumulator (64 fp32): 166
//   registers, no spills, with 288 threads a CTA; dh 112 holds 8 fewer
//   accumulator registers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSubBytes = 128;  // one swizzle row: 64 bf16 channels
// error codes beyond the CUDA runtime's
constexpr int kErrNoEncode = 100000;   // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 100001;     // + CUresult: the encode refused

// kBN keys per tile; kNWG consumer warpgroups of 64 query rows each (the
// CTA's query tile is 64 x kNWG rows): three at dh 64, which ran faster
// than two at the training shape on the H100; two at dh 128, where a third
// would leave fewer registers than a consumer thread holds. 128-key tiles
// spilled registers and ran slower. dh 112 takes dh 128's tiles, the
// channels past 112 zero in shared memory.
template <int DH>
struct Cfg {
  static constexpr int kBN = 64;
  static constexpr int kNWG = DH == 64 ? 3 : 2;
  static constexpr int kBM = 64 * kNWG;
  static constexpr int kThreads = kNWG * 128 + 32;       // + one producer warp
  static constexpr int kSub = (DH + 63) / 64;           // 64-channel sub-tiles
  static constexpr int kNPV = DH;                       // P.V's wgmma N
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kBM * kSub * kSubBytes;   // [kSub][kBM][64]
  static constexpr int kKVBytes = kBN * kSub * kSubBytes;  // [kSub][kBN][64]
  static constexpr int kStageBytes = 2 * kKVBytes;       // K then V
  // barriers in the first 1 KB, tiles 1024-byte aligned after it
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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
// TMA: the box at element coordinates (c0 channel, c1 head, c2 row, c3
// batch) of a 4-d tensor map into shared memory; completes bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1):
// start address >> 4, leading byte offset >> 4 at bit 16, stride byte
// offset >> 4 at bit 32. K-major (Q, K): 8-row groups 1024 bytes apart, the
// leading offset unused (1). MN-major (V read transposed): 8-key groups
// 1024 bytes apart, 64-channel atoms `lbo` bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs), B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_m64n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (bf16 pairs), B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_m64n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 112] += A[64 x 16] . B[16 x 112], A from registers (bf16 pairs), B
// MN-major (transposed) in shared memory: one whole 64-channel atom and 48
// channels of the next
__device__ __forceinline__ void wgmma_rs_m64n112(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 64 || N == 112 || N == 128, "P.V takes N = 64, 112 or 128");
  if constexpr (N == 64)
    wgmma_rs_m64n64(d, a, db);
  else if constexpr (N == 112)
    wgmma_rs_m64n112(d, a, db);
  else
    wgmma_rs_m64n128(d, a, db);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                            int S, int G, int window, float scale, long long osb, long long oss,
                            long long osh) {
  using C = Cfg<DH>;
  constexpr int kBM = C::kBM, kBN = C::kBN, kStages = C::kStages, kNS = kBN / 2;
  static_assert(kBN == 64, "S = Q.K^T is one m64n64 wgmma per 16 channels");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base;                 // Q landed
  const uint32_t bar_full = base + 8;          // [kStages]: K and V landed
  const uint32_t bar_empty = base + 8 + 8 * kStages;  // [kStages]: released
  const uint32_t sQ = base + 1024;
  const uint32_t sKV = sQ + C::kQBytes;        // stage s: K at s * kStageBytes, V after

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest query tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int q0 = qt * kBM;
  const int last = min(q0 + kBM, S) - 1;       // the CTA's diagonal
  const int kt0 = window ? (max(0, q0 - window + 1) / kBN) * kBN : 0;
  const int n_tiles = (last - kt0) / kBN + 1;
  // warp and warpgroup indices through a shuffle, so ptxas sees them
  // warp-uniform and keeps the wgmma under their branches asynchronous
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, C::kNWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::kNWG * 4) {
    // producer: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
      for (int sub = 0; sub < C::kSub; ++sub)
        tma_load_4d(sQ + sub * kBM * kSubBytes, &tq, bar_q, sub * 64, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * st;
        const uint32_t sK = sKV + st * C::kStageBytes, sV = sK + C::kKVBytes;
        mbar_expect_tx(full, C::kStageBytes);
        const int k0 = kt0 + i * kBN;
        for (int sub = 0; sub < C::kSub; ++sub) {
          tma_load_4d(sK + sub * kBN * kSubBytes, &tk, full, sub * 64, kvh, k0, b);
          tma_load_4d(sV + sub * kBN * kSubBytes, &tv, full, sub * 64, kvh, k0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup w: query rows row0 .. row0 + 63
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), wq = warp % 4;
  const int row0 = q0 + w * 64;
  const bool active = row0 < S;
  const int wlast = min(row0 + 63, S - 1);
  // this thread's two rows (accumulator fragment rows r and r + 8)
  const int r_lo = row0 + wq * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  constexpr int kAcc = C::kNPV / 2;            // output accumulator registers
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  // The tiles this warpgroup needs form one run [ia, ib] of the CTA's. The
  // loop over them overlaps the softmax of tile i with the P.V product of
  // tile i - 1 (FA3's intra-warpgroup pipelining): P.V(i - 1) is issued
  // right after S(i) = Q.K(i)^T and waited for once the softmax of S(i) is
  // done; then acc is rescaled and P(i) packed. A stage is released when
  // its P.V has completed. No branch encloses a wgmma in flight, so ptxas
  // keeps them asynchronous.
  int ia = n_tiles, ib = -1;
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = kt0 + i * kBN;
    if (active && k0 <= wlast && (window == 0 || k0 + kBN - 1 > row0 - window)) {
      ia = min(ia, i);
      ib = i;
    }
  }
  uint32_t p_hi[kNS / 2], p_lo[kNS / 2];
  float s[kNS];
  auto wait_full = [&](int i) { mbar_wait(bar_full + 8 * (i % kStages), (i / kStages) & 1); };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (i % kStages));
  };
  auto issue_qk = [&](int i) {
    const uint32_t sK = sKV + (i % kStages) * C::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t qa = sQ + (kk / 4) * kBM * kSubBytes + w * 64 * kSubBytes + (kk % 4) * 32;
      const uint32_t ka = sK + (kk / 4) * kBN * kSubBytes + (kk % 4) * 32;
      wgmma_ss_m64n64(s, sw128_desc(qa, 16), sw128_desc(ka, 16), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int i) {
    const uint32_t sV = sKV + (i % kStages) * C::kStageBytes + C::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t vd = sw128_desc(sV + kk * 16 * kSubBytes, kBN * kSubBytes);
      wgmma_rs<C::kNPV>(acc, p_hi + 4 * kk, vd);
      wgmma_rs<C::kNPV>(acc, p_lo + 4 * kk, vd);
    }
    wgmma_commit();
  };
  // masked online softmax of S(i) in place: s becomes P, m and l advance,
  // corr gets each row's rescale of acc
  auto softmax = [&](int i, float* corr) {
    const int k0 = kt0 + i * kBN;
    // s[4j + 2rr + e]: row r_lo + 8 rr, key k0 + 8 j + c2 + e. A tile
    // below every row's diagonal, inside every row's window and before S
    // needs no mask.
    const bool interior = k0 + kBN - 1 <= row0 && k0 + kBN - 1 < S &&
                          (window == 0 || row0 + 63 - k0 < window);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qp = r_lo + 8 * rr;
      float m_new, sum = 0.f;
      if (interior) {
        float mx = s[2 * rr];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new = fmaxf(m[rr], mx * scale);   // scale > 0: max commutes with it
        const float off = -m_new * kLog2e;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(s[4 * j + 2 * rr + e], scale_log2, off));
            s[4 * j + 2 * rr + e] = p;
            sum += p;
          }
      } else {
        float mx = m[rr];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * j + c2 + e;
            const bool ok = kp < S && kp <= qp && (window == 0 || qp - kp < window);
            const float x = ok ? s[4 * j + 2 * rr + e] * scale : kMasked;
            s[4 * j + 2 * rr + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        m_new = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // (x - m_new) is exactly 0 where both are the mask value
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2((s[4 * j + 2 * rr + e] - m_new) * kLog2e);
            s[4 * j + 2 * rr + e] = p;
            sum += p;
          }
      }
      corr[rr] = ex2((m[rr] - m_new) * kLog2e);
      m[rr] = m_new;
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[rr] = l[rr] * corr[rr] + sum;
    }
  };
  // acc *= corr, then P as the A operand, split into bf16 high and low
  // parts: for 16-key slice kk the A fragment is s[8kk .. 8kk + 7] in pairs
  auto rescale_pack = [&](const float* corr) {
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        acc[4 * j + 2 * rr] *= corr[rr];
        acc[4 * j + 2 * rr + 1] *= corr[rr];
      }
#pragma unroll
    for (int t = 0; t < kNS / 2; ++t) {
      const float x = s[2 * t], y = s[2 * t + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[t] = pack_bf16(hi);
      p_lo[t] = pack_bf16(__floats2bfloat162_rn(x - hf.x, y - hf.y));
    }
  };

  for (int i = 0; i < min(ia, n_tiles); ++i) {  // before the run
    wait_full(i);
    release(i);
  }
  if (ia <= ib) {
    float corr[2];
    wait_full(ia);
    fence_regs<kNS>(s);
    wgmma_fence();
    issue_qk(ia);
    wgmma_wait<0>();
    fence_regs<kNS>(s);
    softmax(ia, corr);
    rescale_pack(corr);
    for (int i = ia + 1; i <= ib; ++i) {
      wait_full(i);
      fence_regs<kNS>(s);
      fence_regs<kAcc>(acc);
      wgmma_fence();
      issue_qk(i);
      issue_pv(i - 1);
      wgmma_wait<1>();  // S(i) is ready; P.V(i - 1) may still run
      fence_regs<kNS>(s);
      softmax(i, corr);
      wgmma_wait<0>();  // P.V(i - 1) has landed in acc
      fence_regs<kAcc>(acc);
      release(i - 1);
      rescale_pack(corr);
    }
    fence_regs<kAcc>(acc);
    wgmma_fence();
    issue_pv(ib);
    wgmma_wait<0>();
    fence_regs<kAcc>(acc);
    release(ib);
  }
  for (int i = ib + 1; i < n_tiles; ++i) {  // after the run
    if (i < ia) continue;
    wait_full(i);
    release(i);
  }

  if (!active) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = r_lo + 8 * rr;
    if (qp >= S) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    __nv_bfloat16* o = out + b * osb + qp * oss + h * osh + c2;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * rr] / den, acc[4 * j + 2 * rr + 1] / den);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a 4-d map over x [B, S, n_heads, DH] (element strides st: batch, seq,
// head; channels contiguous), boxes of 64 channels x 1 head x `rows` rows;
// channels at or past dh (dh 112's second box) come in as zeros
int make_map(CUtensorMap* map, const void* x, int B, int S, int n_heads, int dh,
             const long long* st, int rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return kErrNoEncode;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)n_heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int G,
           int window, float scale, const long long* st, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, B, S, H, DH, st, C::kBM);
  if (!err) err = make_map(&mk, k, B, S, H / G, DH, st + 3, C::kBN);
  if (!err) err = make_map(&mv, v, B, S, H / G, DH, st + 6, C::kBN);
  if (err) return err;
  auto kern = flash_attention_sm90_kernel<DH>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + C::kBM - 1) / C::kBM, H, B);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(out),
                                                  S, G, window, scale, st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,S,H,dh]; k/v [B,S,H/G,dh], all bf16 -> out [B,S,H,dh] bf16. strides:
// 12 element strides, (batch, seq, head) of q, k, v and out in turn; the
// channel stride is 1; the bases and every stride of q, k and v are
// multiples of 16 bytes (TMA), out's strides even. dh is 64, 112 or 128 (else
// cudaErrorInvalidValue). window 0: causal only. scale: 1/sqrt(dh). Returns
// cudaGetLastError() after the launch, or a code >= 100000 when a tensor map
// could not be made.
extern "C" int flash_attention_sm90_cuda(const void* q, const void* k, const void* v, void* out,
                                         int B, int S, int H, int G, int dh, int window,
                                         float scale, const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64: return launch<64>(q, k, v, out, B, S, H, G, window, scale, strides, st);
    case 112: return launch<112>(q, k, v, out, B, S, H, G, window, scale, strides, st);
    case 128: return launch<128>(q, k, v, out, B, S, H, G, window, scale, strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  static char msg[96];
  if (err == kErrNoEncode) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err >= kErrEncode) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed: CUresult %d", err - kErrEncode);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
