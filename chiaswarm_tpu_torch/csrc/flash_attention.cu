// Blockwise (flash) attention forward for Hopper (sm_90a), kernel B1 of the
// PyTorch/CUDA port.
//
// Replaces: chiaswarm_tpu/ops/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel) and its recurrence online_softmax_block_update. It computes
// the same function: non-causal softmax(Q K^T * scale) V over
// (B, L, H, D) queries and (B, S, H, D) keys/values, with fp32 logits and an
// fp32 running max, denominator and accumulator; key columns past the true
// length are masked with the finite -1e30 the reference uses; the output is
// cast back to the input type.
//
// What bounds it on this card: at the UNet's shapes (L = S = 1024 or 4096,
// D = 40 or 80) attention is bound by operations, not bytes. 4*B*H*L*S*D
// FLOPs against 4*B*L*H*D elements moved puts it far above the H100's
// ~295 FLOP/byte ridge, so the floor is the tensor-core rate.
//
// Two routes, chosen by dtype:
// - bf16 and fp16 (the serve path) run on the tensor cores: the wgmma tile
//   of attention_tile_sm90.cuh (Q K^T and P V as wgmma with fp32
//   accumulators, p rounded to the input type for P V only, l summed from
//   the fp32 p; K/V through a three-stage cp.async ring in shared memory;
//   one tile's P V overlaps the next tile's Q K^T and softmax). A block is
//   two warpgroups, each owning 64 query rows of one (batch*head); they
//   share every K/V tile.
// - fp32 keeps the sweep on the CUDA cores: each thread block owns one
//   (batch*head, 64-query) tile; K/V stream through shared memory in fp32
//   tiles while each query's running state stays in fp32 registers; four
//   threads share a query, each owning a quarter of D (interleaved float2
//   chunks), their partial dot products meeting through warp shuffles. The
//   fp32 products keep the reference's arithmetic exactly (no bf16 p).
// Head dims 32 (AudioLDM's UNet: Q K^T only two k16 steps deep, P V at N =
// 32, 64-byte rows of four 16-byte chunks), 40, 64, 80, 128 and 160.
// There is no padding of D to 128 lanes or of the sequence to the block:
// those were TPU tiling needs. The strides of the (B, L, H, D) tensors are
// read directly; only the head dimension must be contiguous, and on the
// tensor-core route rows must start on 16 bytes (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // finite: true -inf breaks exp() on masked rows
constexpr int kQueriesPerBlock = 64;
constexpr int kThreadsPerQuery = 4;
constexpr int kThreads = kQueriesPerBlock * kThreadsPerQuery;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int batch, q_len, kv_len, heads;
  // element strides of the batch, sequence and head axes (head dim is 1)
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_sl, o_sh;
  float scale;
};

template <int D, int BKV>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  static_assert(D % 8 == 0, "head dim must split into float2 chunks over 4 threads");
  constexpr int kChunks = D / 8;  // float2 chunks owned by each thread
  constexpr int kOwn = 2 * kChunks;

  __shared__ __align__(16) float k_tile[BKV][D];
  __shared__ __align__(16) float v_tile[BKV][D];

  const int tid = threadIdx.x;
  const int part = tid & (kThreadsPerQuery - 1);
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int qi = blockIdx.x * kQueriesPerBlock + (tid >> 2);
  const bool q_valid = qi < p.q_len;

  const float* q_row = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                   static_cast<int64_t>(q_valid ? qi : 0) * p.q_sl;
  const float* k_base = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v_base = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float q_r[kOwn];
  float acc[kOwn];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d = 8 * c + 2 * part;
    q_r[2 * c] = q_valid ? q_row[d] : 0.f;
    q_r[2 * c + 1] = q_valid ? q_row[d + 1] : 0.f;
    acc[2 * c] = 0.f;
    acc[2 * c + 1] = 0.f;
  }
  float m = kNegInf;  // running max
  float l = 0.f;      // running denominator

  for (int kv0 = 0; kv0 < p.kv_len; kv0 += BKV) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BKV * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int s = kv0 + j;
      float kval = 0.f, vval = 0.f;  // zero tail: 0 * garbage could be NaN
      if (s < p.kv_len) {
        kval = k_base[static_cast<int64_t>(s) * p.k_ss + d];
        vval = v_base[static_cast<int64_t>(s) * p.v_ss + d];
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
      for (int c = 0; c < kChunks; ++c) {
        const float2 kk = *reinterpret_cast<const float2*>(&k_tile[j][8 * c + 2 * part]);
        dot = fmaf(q_r[2 * c], kk.x, dot);
        dot = fmaf(q_r[2 * c + 1], kk.y, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const float logit = (kv0 + j < p.kv_len) ? dot * p.scale : kNegInf;
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
    for (int i = 0; i < kOwn; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float pj = s_r[j];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float2 vv = *reinterpret_cast<const float2*>(&v_tile[j][8 * c + 2 * part]);
        acc[2 * c] = fmaf(pj, vv.x, acc[2 * c]);
        acc[2 * c + 1] = fmaf(pj, vv.y, acc[2 * c + 1]);
      }
    }
    m = m_next;
  }

  if (q_valid) {
    float* o_row = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
               static_cast<int64_t>(qi) * p.o_sl;
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = 8 * c + 2 * part;
      o_row[d] = acc[2 * c] * inv;
      o_row[d + 1] = acc[2 * c + 1] * inv;
    }
  }
}

template <int D>
int launch_sweep(const Params& p, cudaStream_t stream) {
  // KV tile depth: two fp32 tiles of BKV x D must fit the 48 KB of static
  // shared memory a block may use without opting in to more
  constexpr int BKV = D <= 80 ? 64 : 32;
  const dim3 grid((p.q_len + kQueriesPerBlock - 1) / kQueriesPerBlock,
                  p.batch * p.heads);
  flash_fwd_kernel<D, BKV><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: warpgroup g of block (x, bh) owns query rows
// 128 x + 64 g .. + 64 of (batch, head) bh.
template <typename T, int D>
__global__ void __launch_bounds__(attn_sm90::kBlockThreads, attn_sm90::Shape<D>::kMinBlocks)
    flash_fwd_tc_kernel(const Params p) {
  using namespace attn_sm90;
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int row0 = blockIdx.x * kBlockRows + threadIdx.x / kWarpgroup * kRows;
  const int valid = p.q_len - row0;
  const T* q0 = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                static_cast<int64_t>(row0) * p.q_sl;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o0 = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + static_cast<int64_t>(row0) * p.o_sl;
  const KVRing<T, D> ring{k, v, p.k_ss, p.v_ss, p.kv_len, smem};
  ring.start();  // the first K/V tile lands while Q loads
  Tile<T, D> tile;
  tile.load_q(q0, p.q_sl, valid);
  tile.init();
  ring.run(tile, p.scale);
  tile.store_out(o0, p.o_sl, valid);
}

template <typename T, int D>
int launch_tc(const Params& p, cudaStream_t stream) {
  using attn_sm90::kBlockRows;
  constexpr int kSmem = attn_sm90::Shape<D>::kSmemBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.q_len + kBlockRows - 1) / kBlockRows, p.batch * p.heads);
  flash_fwd_tc_kernel<T, D><<<grid, attn_sm90::kBlockThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// fp32: the sweep; bf16 and fp16: the tensor cores
template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    return launch_sweep<D>(p, stream);
  } else {
    return launch_tc<T, D>(p, stream);
  }
}

template <typename T>
int dispatch_head_dim(int head_dim, const Params& p, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, stream);
    case 40: return launch<T, 40>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 160: return launch<T, 160>(p, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// strides: 12 element strides, (batch, seq, head) for q, k, v, o in order.
// Returns 0, cudaGetLastError() after the launch, or -1 for an unsupported
// dtype or head dim (the Python wrapper checks both before calling).
extern "C" int chiaswarm_flash_attention_fwd(const void* q, const void* k, const void* v,
                                             void* o, int dtype, int batch, int q_len,
                                             int kv_len, int heads, int head_dim,
                                             const int64_t* strides, float scale,
                                             void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  p.o_sb = strides[9];
  p.o_sl = strides[10];
  p.o_sh = strides[11];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_head_dim<float>(head_dim, p, s);
    case 1: return dispatch_head_dim<__half>(head_dim, p, s);
    case 2: return dispatch_head_dim<__nv_bfloat16>(head_dim, p, s);
    default: return -1;
  }
}
