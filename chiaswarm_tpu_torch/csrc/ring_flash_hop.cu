// One hop of ring-flash attention for Hopper (sm_90a), kernel B2 of the
// PyTorch/CUDA port.
//
// Replaces: chiaswarm_tpu/ops/ring_flash_attention.py::_hop_kernel (the
// Pallas TPU kernel that _ring_flash_scan runs once per ring hop). It
// computes the same function: B1's blockwise running-softmax recurrence over
// one K/V shard, with the running state carried in and out instead of
// initialised and normalised. For every query row:
//   logits = q k^T * scale (fp32), m' = max(m, rowmax), alpha = exp(m - m'),
//   p = exp(logits - m'), l' = alpha * l + sum(p), acc' = alpha * acc + p v.
// Queries are (B, L, H, D) and keys/values (B, S, H, D) in fp32, fp16 or
// bf16; m and l are (B, H, L) fp32 and acc is (B, L, H, D) fp32. The state is
// updated IN PLACE: each block reads the state of its own query rows before
// its first tile and writes it after its last, and no other block touches
// those rows.
//
// What bounds it on this card: at the 1024-token shards of the SD1.5 serve
// path the byte floor (the fp32 state read and written every hop: 5.2 MB at
// (2, 1024, 8, 40) against 3.9 MB of bf16 q/k/v) and the tensor-core floor
// are within 4% of each other; at the 256-token shards (D = 80) the bytes
// are four times the operations' floor, and the grid is small (2 query
// tiles x 16 batch*heads), so the latency of one block sets the time.
//
// Two routes, chosen by dtype and head dim, as in B3:
// - bf16 and fp16 with D <= 160 (the serve path) run the wgmma tile of
//   attention_tile_sm90.cuh: one block of two warpgroups per (batch*head,
//   128-query tile), Q K^T and P V as wgmma with fp32 accumulators, p
//   rounded to the input type for P V only and l summed from the fp32 p,
//   K/V through the three-stage cp.async ring. The block loads its rows'
//   state into the accumulator layout (plain loads: no other block writes
//   those rows), runs the ring over the hop's K/V shard, and stores the
//   state back, so the state crosses device memory once in and once out.
// - fp32 and the VAE's D = 512 keep the CUDA-core sweep of
//   ring_flash_common.cuh with the reference's fp32 p: fp32 tiles in shared
//   memory, the row's q, acc slice, m and l in fp32 registers, TPQ threads
//   per row. D = 512 needs a tile that splits D across warpgroups (64 rows
//   x 512 fp32 of acc is 256 registers a thread in one warpgroup).
// Query shards are slices along L of a (B, L, H, D) tensor, so the strides
// of every tensor are read directly; only the last dim must be contiguous,
// and on the tensor-core route q/k/v rows start on 16 bytes and acc rows on
// 8 (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile_sm90.cuh"
#include "ring_flash_common.cuh"

namespace {

using ring_flash::kNegInf;
using ring_flash::kThreads;
using ring_flash::Tiling;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* m;
  float* l;
  float* acc;
  int batch, q_len, kv_len, heads;
  // element strides; q/k/v/acc as (batch, seq, head), m/l as (batch, head, seq)
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t m_sb, m_sh, m_sl;
  int64_t l_sb, l_sh, l_sl;
  int64_t a_sb, a_sl, a_sh;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) ring_hop_kernel(const Params p) {
  using Tl = Tiling<D>;
  __shared__ __align__(16) float k_tile[Tl::BKV][D];
  __shared__ __align__(16) float v_tile[Tl::BKV][D];

  const int part = threadIdx.x % Tl::TPQ;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int qi = blockIdx.x * Tl::kQueries + threadIdx.x / Tl::TPQ;
  const bool q_valid = qi < p.q_len;
  const int64_t row = q_valid ? qi : 0;

  const T* q_row = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + row * p.q_sl;
  float* acc_row = p.acc + b * p.a_sb + h * p.a_sh + row * p.a_sl;
  float* m_at = p.m + b * p.m_sb + h * p.m_sh + row * p.m_sl;
  float* l_at = p.l + b * p.l_sb + h * p.l_sh + row * p.l_sl;

  // the carried state, read once; an out-of-range row runs as an empty one
  float q_r[Tl::kOwn];
  float acc[Tl::kOwn];
#pragma unroll
  for (int c = 0; c < Tl::kChunks; ++c) {
    const int d = 2 * Tl::TPQ * c + 2 * part;
    q_r[2 * c] = q_valid ? ring_flash::load<false>(q_row + d) : 0.f;
    q_r[2 * c + 1] = q_valid ? ring_flash::load<false>(q_row + d + 1) : 0.f;
    acc[2 * c] = q_valid ? acc_row[d] : 0.f;
    acc[2 * c + 1] = q_valid ? acc_row[d + 1] : 0.f;
  }
  float m = q_valid ? *m_at : kNegInf;  // running max
  float l = q_valid ? *l_at : 0.f;      // running denominator

  ring_flash::sweep<false, T, D>(
      static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh, p.k_ss,
      static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh, p.v_ss, p.kv_len, p.scale,
      q_r, acc, m, l, k_tile, v_tile);

  if (q_valid) {
#pragma unroll
    for (int c = 0; c < Tl::kChunks; ++c) {
      const int d = 2 * Tl::TPQ * c + 2 * part;
      acc_row[d] = acc[2 * c];
      acc_row[d + 1] = acc[2 * c + 1];
    }
    if (part == 0) {
      *m_at = m;
      *l_at = l;
    }
  }
}

template <typename T, int D>
int launch_sweep(const Params& p, cudaStream_t stream) {
  constexpr int kQueries = Tiling<D>::kQueries;
  const dim3 grid((p.q_len + kQueries - 1) / kQueries, p.batch * p.heads);
  ring_hop_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: warpgroup g of block (x, bh) owns query rows
// 128 x + 64 g .. + 64 of (batch, head) bh and their state.
template <typename T, int D>
__global__ void __launch_bounds__(attn_sm90::kBlockThreads, attn_sm90::Shape<D>::kMinBlocks)
    ring_hop_tc_kernel(const Params p) {
  using namespace attn_sm90;
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int64_t row0 = blockIdx.x * kBlockRows + threadIdx.x / kWarpgroup * kRows;
  const int valid = p.q_len - static_cast<int>(row0);
  const KVRing<T, D> ring{static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh,
                          static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh,
                          p.k_ss, p.v_ss, p.kv_len, smem};
  ring.start();  // the first K/V tile lands while Q and the state load
  float* m0 = p.m + b * p.m_sb + h * p.m_sh + row0 * p.m_sl;
  float* l0 = p.l + b * p.l_sb + h * p.l_sh + row0 * p.l_sl;
  float* acc0 = p.acc + b * p.a_sb + h * p.a_sh + row0 * p.a_sl;
  Tile<T, D> tile;
  tile.load_q(static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + row0 * p.q_sl, p.q_sl,
              valid);
  tile.template load_state<false>(m0, p.m_sl, l0, p.l_sl, acc0, p.a_sl, valid);
  ring.run(tile, p.scale);
  tile.store_state(m0, p.m_sl, l0, p.l_sl, acc0, p.a_sl, valid);
}

template <typename T, int D>
int launch_tc(const Params& p, cudaStream_t stream) {
  using attn_sm90::kBlockRows;
  constexpr int kSmem = attn_sm90::Shape<D>::kSmemBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      ring_hop_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.q_len + kBlockRows - 1) / kBlockRows, p.batch * p.heads);
  ring_hop_tc_kernel<T, D><<<grid, attn_sm90::kBlockThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 and fp16 with D <= 160: the tensor cores; fp32 and D = 512: the sweep
template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2 && D <= 160) {
    return launch_tc<T, D>(p, stream);
  } else {
    return launch_sweep<T, D>(p, stream);
  }
}

template <typename T>
int dispatch_head_dim(int head_dim, const Params& p, cudaStream_t stream) {
  switch (head_dim) {
    case 40: return launch<T, 40>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 160: return launch<T, 160>(p, stream);
    case 512: return launch<T, 512>(p, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, k, v; the state is fp32).
// strides: 18 element strides in order q, k, v as (batch, seq, head), m, l
// as (batch, head, seq), acc as (batch, seq, head).
// Returns 0, cudaGetLastError() after the launch, or -1 for an unsupported
// dtype or head dim (the Python wrapper checks both before calling).
extern "C" int chiaswarm_ring_flash_hop(const void* q, const void* k, const void* v,
                                        float* m, float* l, float* acc, int dtype,
                                        int batch, int q_len, int kv_len, int heads,
                                        int head_dim, const int64_t* strides, float scale,
                                        void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.m = m;
  p.l = l;
  p.acc = acc;
  p.batch = batch;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.heads = heads;
  p.q_sb = strides[0];
  p.q_sl = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.m_sb = strides[9];
  p.m_sh = strides[10];
  p.m_sl = strides[11];
  p.l_sb = strides[12];
  p.l_sh = strides[13];
  p.l_sl = strides[14];
  p.a_sb = strides[15];
  p.a_sl = strides[16];
  p.a_sh = strides[17];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_head_dim<float>(head_dim, p, s);
    case 1: return dispatch_head_dim<__half>(head_dim, p, s);
    case 2: return dispatch_head_dim<__nv_bfloat16>(head_dim, p, s);
    default: return -1;
  }
}
