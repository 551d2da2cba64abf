// The running-softmax sweep of one query row over one K/V block, shared by
// the two ring kernels of the PyTorch/CUDA port: B2 (ring_flash_hop.cu, one
// hop per launch) and B3 (ring_flash_fused.cu, every hop of a ring in one
// launch).
//
// A thread block owns kQueries query rows of one (batch, head); TPQ threads
// share a row, each owning interleaved float2 chunks of D, and their partial
// dot products meet by warp shuffles. K/V stream through shared memory in
// fp32 tiles of BKV keys. The row's q, accumulator slice and running max and
// denominator stay in fp32 registers for the whole block. TPQ = 4 for
// D <= 160 (B1's mapping); TPQ = 16 for the VAE's D = 512, where four
// threads would need 128 accumulator registers each and spill. BKV keeps the
// two fp32 tiles within the 48 KB of static shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace ring_flash {

constexpr float kNegInf = -1e30f;  // finite: true -inf breaks exp() on masked rows
constexpr int kThreads = 256;

template <int D>
struct Tiling {
  static constexpr int TPQ = D <= 160 ? 4 : 16;  // threads per query row
  static constexpr int BKV = D <= 80 ? 64 : (D <= 160 ? 32 : 8);
  static constexpr int kQueries = kThreads / TPQ;  // query rows per block
  static constexpr int kChunks = D / (2 * TPQ);    // float2 chunks per thread
  static constexpr int kOwn = 2 * kChunks;         // elements of D per thread
  static_assert(D % (2 * TPQ) == 0, "head dim must split into float2 chunks");
  static_assert(32 % TPQ == 0, "the threads of one query must share a warp");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// An element read through L2 only (ld.global.cg): for data that other
// blocks of the same launch wrote, which a stale L1 line could hide.
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __half ldcg(const __half* p) {
  return __ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ __nv_bfloat16 ldcg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// An element in fp32; kL2 reads it through L2 only.
template <bool kL2, typename T>
__device__ __forceinline__ float load(const T* p) {
  return to_f32(kL2 ? ldcg(p) : *p);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The recurrence of this thread's query row over keys 0..kv_len of one K/V
// block (key s at k_base + s * k_ss, D contiguous), starting from the state
// (m, l, acc) and leaving the updated state there:
//   logits = q k^T * scale, m' = max(m, rowmax), alpha = exp(m - m'),
//   p = exp(logits - m') in fp32, l' = alpha l + sum(p), acc' = alpha acc + p v.
// Every thread of the block must call it with the same block (it holds
// __syncthreads); a thread of an out-of-range row runs it with q = 0.
template <bool kL2, typename T, int D>
__device__ __forceinline__ void sweep(const T* k_base, int64_t k_ss, const T* v_base,
                                      int64_t v_ss, int kv_len, float scale,
                                      const float (&q_r)[Tiling<D>::kOwn],
                                      float (&acc)[Tiling<D>::kOwn], float& m, float& l,
                                      float (*k_tile)[D], float (*v_tile)[D]) {
  using Tl = Tiling<D>;
  constexpr int TPQ = Tl::TPQ;
  constexpr int BKV = Tl::BKV;
  const int tid = threadIdx.x;
  const int part = tid % TPQ;
  for (int kv0 = 0; kv0 < kv_len; kv0 += BKV) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BKV * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int s = kv0 + j;
      float kval = 0.f, vval = 0.f;  // zero tail: 0 * garbage could be NaN
      if (s < kv_len) {
        kval = load<kL2>(k_base + static_cast<int64_t>(s) * k_ss + d);
        vval = load<kL2>(v_base + static_cast<int64_t>(s) * v_ss + d);
      }
      k_tile[j][d] = kval;
      v_tile[j][d] = vval;
    }
    __syncthreads();

    float s_r[BKV];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < Tl::kChunks; ++c) {
        const float2 kk = *reinterpret_cast<const float2*>(&k_tile[j][2 * TPQ * c + 2 * part]);
        dot = fmaf(q_r[2 * c], kk.x, dot);
        dot = fmaf(q_r[2 * c + 1], kk.y, dot);
      }
#pragma unroll
      for (int off = 1; off < TPQ; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float logit = (kv0 + j < kv_len) ? dot * scale : kNegInf;
      s_r[j] = logit;
      m_cur = fmaxf(m_cur, logit);
    }

    const float m_next = fmaxf(m, m_cur);
    const float alpha = __expf(m - m_next);  // rescale of the old partials
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      s_r[j] = __expf(s_r[j] - m_next);
      tile_sum += s_r[j];
    }
    l = alpha * l + tile_sum;
#pragma unroll
    for (int i = 0; i < Tl::kOwn; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float pj = s_r[j];
#pragma unroll
      for (int c = 0; c < Tl::kChunks; ++c) {
        const float2 vv = *reinterpret_cast<const float2*>(&v_tile[j][2 * TPQ * c + 2 * part]);
        acc[2 * c] = fmaf(pj, vv.x, acc[2 * c]);
        acc[2 * c + 1] = fmaf(pj, vv.y, acc[2 * c + 1]);
      }
    }
    m = m_next;
  }
}

}  // namespace ring_flash
