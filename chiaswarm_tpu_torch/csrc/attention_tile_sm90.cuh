// The tensor-core attention tile shared by kernels B1 (flash_attention.cu),
// B2 (ring_flash_hop.cu) and B3 (ring_flash_fused.cu) of the PyTorch/CUDA
// port, for Hopper (sm_90a), bf16 and fp16 with head dims 32, 40, 64, 80,
// 128 and 160 (B2 and B3 instantiate it from 40 up; 32 is B1's, for
// AudioLDM's UNet).
//
// One warpgroup (128 threads) owns 64 query rows of one (batch, head) and
// advances their running-softmax state (m, l, acc) over a run of K/V, in the
// recurrence of chiaswarm_tpu/ops/flash_attention.py::
// online_softmax_block_update:
// - S = Q K^T by wgmma m64nBNk16 with an fp32 accumulator: Q from registers
//   (the A operand), the K tile from shared memory (B, K-major). D = 40 is
//   padded to 48 with zero columns in Q's registers and in the K tile.
// - Key columns past kv_len get the reference's finite -1e30 before the row
//   max; K/V rows past kv_len are zero-filled (0 x garbage can be NaN).
// - m' = max(m, rowmax), alpha = exp(m - m'), p = exp(s - m'), all in fp32
//   registers; l is summed from the fp32 p.
// - O += P V by a second wgmma m64nDk16: p rounded to q's 16-bit type in
//   registers as the A operand (for 16-bit types the accumulator layout of S
//   is the A-fragment layout of P, so no data moves), the V tile from shared
//   memory (B, MN-major: the contraction runs over keys), N = D.
// A block is kWarpgroups warpgroups (128 query rows) sharing each K/V tile.
// K/V tiles of BN keys stream through a three-stage ring in dynamic shared
// memory, filled by cp.async.cg (16-byte chunks through L2 only, so a tile
// may read slots that other blocks of the same launch wrote), in the
// no-swizzle core-matrix layout wgmma reads: a core matrix is 8 rows of 16
// bytes, 128 contiguous bytes; key group g (8 keys) and 16-byte chunk c of
// the padded head dim sit at byte (g * kChunks + c) * 128. The same layout
// serves K (core matrices adjacent along K are chunks: LBO = 128 B, SBO =
// kChunks * 128 B) and V (adjacent along K are key groups: LBO = kChunks *
// 128 B, SBO = 128 B).
//
// Tile i's P V is issued together with tile i + 1's Q K^T, and the softmax
// of tile i + 1 runs while P V is on the tensor cores (FlashAttention-3's
// overlap within a warpgroup); no TMA, no warp specialisation. The
// exponentials (one per logit, on the SFU) and the two products bound it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace attn_sm90 {

constexpr float kNegInf = -1e30f;  // finite: true -inf breaks exp() on masked rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarpgroup = 128;  // threads of one warpgroup
constexpr int kRows = 64;        // query rows of one warpgroup
// Warpgroups of a block: two share every K/V tile between 128 query rows,
// halving the K/V traffic from L2 (measured on an H100 at the serve shapes:
// faster than one warpgroup a block at both, PERF.md)
constexpr int kWarpgroups = 2;
constexpr int kBlockThreads = kWarpgroups * kWarpgroup;
constexpr int kBlockRows = kWarpgroups * kRows;

template <int D>
struct Shape {
  static_assert(D % 8 == 0 && D <= 256, "head dim must be whole 16-byte chunks");
  static constexpr int kDp = (D + 15) / 16 * 16;  // Q K^T contraction, whole k16 steps
  static constexpr int kChunks = kDp / 8;         // 16-byte chunks of a padded K/V row
  static constexpr int kLoadChunks = D / 8;       // chunks read from memory
  // keys of one K/V tile; at D = 40 a 64-key tile keeps the block within
  // 128 registers a thread, so two blocks share an SM (measured on an H100:
  // faster than one block of 128-key tiles for both kernels, PERF.md). D =
  // 32 (AudioLDM: 2,560 tokens, 4 heads, so only 160 blocks at batch 2)
  // takes the same tile, so every block of such a grid is resident at once
  static constexpr int kBN = D <= 40 ? 64 : (D <= 80 ? 128 : 64);
  static constexpr int kMinBlocks = D <= 40 ? 2 : 1;  // blocks an SM must hold
  static constexpr int kTileBytes = kBN * kDp * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K tile, then V tile
  static constexpr int kStages = 3;  // tile i's V, tile i + 1's K, tile i + 2 landing
  static constexpr int kSmemBytes = kStages * kStageBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor, no swizzle: start address, leading and
// stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// 16 bytes global -> shared through L2; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups of the warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, A (4 registers of two 16-bit values each) from registers,
// B from shared memory through desc_b, fp32 accumulator d (N / 2 registers
// a thread); scale_d = 0 overwrites d, 1 adds to it; kTransB = 1 reads B
// MN-major. Inline PTX takes literal operand lists, so each shape is
// written out.
template <typename T, int N>
struct WgmmaRS;

template <>
struct WgmmaRS<__nv_bfloat16, 32> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__nv_bfloat16, 40> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[20], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19"
        "}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__nv_bfloat16, 64> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__nv_bfloat16, 80> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__nv_bfloat16, 128> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__nv_bfloat16, 160> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[80], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1, %86;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__half, 32> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__half, 40> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[20], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19"
        "}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__half, 64> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__half, 80> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__half, 128> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct WgmmaRS<__half, 160> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[80], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1, %86;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
};

// The running state of one warpgroup's 64 query rows. Thread t of the
// warpgroup holds rows r = 16 * (t / 32) + (t % 32) / 4 and r + 8, and in
// every 8-column block j of an accumulator the columns 8j + 2 (t % 4) and
// + 1: element 4j + e sits at row r + 8 (e / 2), column 8j + 2 (t % 4) +
// e % 2 (the wgmma accumulator layout).
template <typename T, int D>
struct Tile {
  using Sh = Shape<D>;
  static constexpr int kQk = Sh::kDp / 16;   // k16 steps of Q K^T
  static constexpr int kPv = Sh::kBN / 16;   // k16 steps of P V
  uint32_t q[kQk][4];  // Q as wgmma A fragments
  float o[D / 2];      // acc
  float m[2];          // running max of rows r and r + 8, in logits
  float l[2];          // this thread's part of the running denominator

  __device__ __forceinline__ static int row() {
    const int t = threadIdx.x % kWarpgroup;
    return 16 * (t / 32) + (t % 32) / 4;
  }
  __device__ __forceinline__ static int col() { return 2 * (threadIdx.x % 4); }

  // Q rows 0..valid of this warpgroup from q0 (row stride q_sl, D
  // contiguous); rows past valid and columns past D are zero.
  __device__ __forceinline__ void load_q(const T* q0, int64_t q_sl, int valid) {
    const int r = row(), c = col();
#pragma unroll
    for (int t = 0; t < kQk; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = r + 8 * (i & 1);
        const int cc = 16 * t + 8 * (i >> 1) + c;
        q[t][i] = (rr < valid && cc < D)
                      ? *reinterpret_cast<const uint32_t*>(q0 + rr * q_sl + cc)
                      : 0u;
      }
    }
  }

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // The state of rows 0..valid: m and l per row (row strides m_sl, l_sl),
  // acc rows of D floats (row stride a_sl, rows on 8 bytes). kL2 reads
  // through L2 only, for a workspace that other blocks of the same launch
  // wrote (B3's); B2's state rows belong to its block alone, so plain loads.
  template <bool kL2>
  __device__ __forceinline__ void load_state(const float* m0, int64_t m_sl, const float* l0,
                                             int64_t l_sl, const float* acc0, int64_t a_sl,
                                             int valid) {
    init();
    const int r = row(), c = col();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      if (rr >= valid) continue;
      m[h] = kL2 ? __ldcg(m0 + rr * m_sl) : m0[rr * m_sl];
      if (c == 0) l[h] = kL2 ? __ldcg(l0 + rr * l_sl) : l0[rr * l_sl];  // one part per row
      const float2* a = reinterpret_cast<const float2*>(acc0 + rr * a_sl + c);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 v = kL2 ? __ldcg(a + 4 * j) : a[4 * j];
        o[4 * j + 2 * h] = v.x;
        o[4 * j + 2 * h + 1] = v.y;
      }
    }
  }

  // the whole running denominator of each row, in every thread of its quad
  __device__ __forceinline__ void row_sums(float (&sum)[2]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = l[h];
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
  }

  // The state of rows 0..valid back, in load_state's layout.
  __device__ __forceinline__ void store_state(float* m0, int64_t m_sl, float* l0, int64_t l_sl,
                                              float* acc0, int64_t a_sl, int valid) const {
    float sum[2];
    row_sums(sum);
    const int r = row(), c = col();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      if (rr >= valid) continue;
      if (c == 0) {
        m0[rr * m_sl] = m[h];
        l0[rr * l_sl] = sum[h];
      }
      float2* a = reinterpret_cast<float2*>(acc0 + rr * a_sl + c);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        a[4 * j] = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
  }

  // acc / l in T to rows 0..valid of o0 (row stride o_sl, D contiguous)
  __device__ __forceinline__ void store_out(T* o0, int64_t o_sl, int valid) const {
    float sum[2];
    row_sums(sum);
    const int r = row(), c = col();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      if (rr >= valid) continue;
      const float inv = 1.f / sum[h];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(o0 + rr * o_sl + 8 * j + c) =
            pack2<T>(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }

  float s[Sh::kBN / 2];    // S of the tile in flight, then its logits and p
  uint32_t pa[kPv][4];     // P of the tile whose P V is issued next

  // S = Q K^T over the K tile at shared address k_tile (core-matrix layout),
  // issued as one wgmma group; wgmma_wait before reading s.
  __device__ __forceinline__ void issue_qk(uint32_t k_tile) {
    constexpr uint32_t kRowBytes = Sh::kChunks * 128;  // one key group of 8 rows
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kQk; ++t)
      WgmmaRS<T, Sh::kBN>::template run<0>(
          s, q[t], smem_desc(k_tile + 256 * t, 128, kRowBytes), t > 0);
    wgmma_commit();
  }

  // O += P V over the V tile at v_tile, P from pa, issued as one wgmma
  // group: pa and o stay untouched until it completes. The caller fences o
  // before the stage's first wgmma: no other instruction may touch an
  // accumulator while a wgmma of the stage is in flight, or ptxas
  // serialises the stage.
  __device__ __forceinline__ void issue_pv(uint32_t v_tile) {
    constexpr uint32_t kRowBytes = Sh::kChunks * 128;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kPv; ++t)
      WgmmaRS<T, D>::template run<1>(o, pa[t],
                                     smem_desc(v_tile + 2 * kRowBytes * t, kRowBytes, 128), 1);
    wgmma_commit();
  }

  // The softmax update of the tile whose S is in s (keys kv0.. of kv_len):
  // mask, row max, m' and alpha, p = exp(s - m') into p_next (rounded to T)
  // and l = alpha l + sum(p) from the fp32 p. Returns alpha through `alpha`
  // for the rescale of o, which waits until no P V is in flight.
  __device__ __forceinline__ void softmax(int kv0, int kv_len, float scale,
                                          uint32_t (&p_next)[kPv][4], float (&alpha)[2]) {
    constexpr int kBN = Sh::kBN;
    fence_operands(s);
    const int c = col();
    const bool ragged = kv0 + kBN > kv_len;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale;
        if (ragged && kv0 + 8 * j + c + (e & 1) >= kv_len) x = kNegInf;
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_next = fmaxf(m[h], mx[h]);
      alpha[h] = ex2((m[h] - m_next) * kLog2e);  // rescale of the old partials
      shift[h] = -m_next * kLog2e;
      m[h] = m_next;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[4 * j + e], kLog2e, shift[e >> 1]));
        s[4 * j + e] = p;
        l[e >> 1] += p;  // the fp32 p, before rounding
      }
    }
#pragma unroll
    for (int t = 0; t < kPv; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p_next[t][i] = pack2<T>(s[8 * t + 2 * i], s[8 * t + 2 * i + 1]);
    }
  }

  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
    }
  }
};

// The K/V of one block streamed through the three-stage ring in shared
// memory: key s at k + s * k_ss and v + s * v_ss (D contiguous, rows on 16
// bytes), keys 0..kv_len. start() issues the first two tiles' loads, so a
// caller can load Q and its state while they land; run() advances every
// warpgroup's tile (its own 64 rows) over all keys. Every thread of the
// block calls both. smem: Shape<D>::kSmemBytes of dynamic shared memory.
template <typename T, int D>
struct KVRing {
  using Sh = Shape<D>;
  static constexpr int kBN = Sh::kBN;
  const T* k;
  const T* v;
  int64_t k_ss, v_ss;
  int kv_len;
  unsigned char* smem;

  // tile it's loads into `stage`, one cp.async group (empty past the last
  // tile, so every step waits on the same group count)
  __device__ __forceinline__ void load(int it, int stage) const {
    if (it * kBN >= kv_len) {
      cp_async_commit();
      return;
    }
    const uint32_t k_dst = smem_u32(smem) + stage * Sh::kStageBytes;
    const uint32_t v_dst = k_dst + Sh::kTileBytes;
    const int kv0 = it * kBN;
    for (int idx = threadIdx.x; idx < kBN * Sh::kLoadChunks; idx += blockDim.x) {
      const int n = idx % kBN;  // consecutive threads fill one core matrix
      const int c = idx / kBN;
      const uint32_t off = ((n >> 3) * Sh::kChunks + c) * 128 + (n & 7) * 16;
      const bool in = kv0 + n < kv_len;
      const int64_t key = in ? kv0 + n : 0;
      cp_async16(k_dst + off, k + key * k_ss + 8 * c, in ? 16 : 0);
      cp_async16(v_dst + off, v + key * v_ss + 8 * c, in ? 16 : 0);
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void start() const {
    if constexpr (Sh::kChunks != Sh::kLoadChunks) {
      // the pad chunks of both K tiles stay zero: Q's pad columns are
      // zero, and 0 x garbage can be NaN
      constexpr int kPad = Sh::kChunks - Sh::kLoadChunks;
      for (int idx = threadIdx.x; idx < Sh::kStages * kBN * kPad; idx += blockDim.x) {
        const int stage = idx / (kBN * kPad);
        const int rest = idx - stage * kBN * kPad;
        const int n = rest % kBN;
        const int c = Sh::kLoadChunks + rest / kBN;
        *reinterpret_cast<uint4*>(smem + stage * Sh::kStageBytes +
                                  ((n >> 3) * Sh::kChunks + c) * 128 + (n & 7) * 16) =
            make_uint4(0, 0, 0, 0);
      }
    }
    load(0, 0);
    load(1, 1);
  }

  // Tile i's P V overlaps tile i + 1's Q K^T and softmax: while the tensor
  // cores run P V, the softmax of the next tile runs on the other units;
  // o is rescaled once P V has completed. The loop body always issues both
  // products and the last tile's P V comes after it, so ptxas sees a fixed
  // number of wgmma groups at every wait (a conditional issue makes it
  // serialise every wgmma of the kernel).
  __device__ __forceinline__ void run(Tile<T, D>& tile, float scale) const {
    const uint32_t base = smem_u32(smem);
    const int n_tiles = (kv_len + kBN - 1) / kBN;
    float alpha[2];
    landed();
    tile.issue_qk(base);
    wgmma_wait<0>();
    tile.softmax(0, kv_len, scale, tile.pa, alpha);
    tile.rescale(alpha);  // o is zero, or the carried state of B2 or B3
    int stage = 0;        // tile it's stage
    for (int it = 0; it + 1 < n_tiles; ++it) {
      const int next = stage == Sh::kStages - 1 ? 0 : stage + 1;
      const int after = next == Sh::kStages - 1 ? 0 : next + 1;
      load(it + 2, after);     // the stage tile it - 1 freed
      fence_operands(tile.o);  // the rescale of o is done before any wgmma
      landed();
      tile.issue_qk(base + next * Sh::kStageBytes);
      tile.issue_pv(base + stage * Sh::kStageBytes + Sh::kTileBytes);
      wgmma_wait<1>();  // Q K^T of tile it + 1 done, P V of tile it in flight
      uint32_t p_next[Tile<T, D>::kPv][4];
      tile.softmax((it + 1) * kBN, kv_len, scale, p_next, alpha);
      wgmma_wait<0>();
      fence_operands(tile.o);
      fence_operands(tile.pa);  // P V read pa until here: p_next is elsewhere
      tile.rescale(alpha);
#pragma unroll
      for (int t = 0; t < Tile<T, D>::kPv; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) tile.pa[t][i] = p_next[t][i];
      }
      __syncthreads();  // every warpgroup is done with tile it's stage
      stage = next;
    }
    fence_operands(tile.o);
    tile.issue_pv(base + stage * Sh::kStageBytes + Sh::kTileBytes);  // the last tile
    wgmma_wait<0>();
    fence_operands(tile.o);
  }

  // all but the newest cp.async group have landed, for every warpgroup
  __device__ __forceinline__ void landed() const {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
  }
};

}  // namespace attn_sm90
