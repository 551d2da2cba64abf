// Every hop of a ring-flash attention in one launch, for Hopper (sm_90a):
// kernel B3 of the PyTorch/CUDA port.
//
// Replaces: chiaswarm_tpu/ops/ring_flash_attention.py::_fused_kernel (the
// Pallas TPU kernel _ring_flash_fused runs once per chip). On the TPU each
// chip runs all n hops of its query shard in one kernel: per hop it starts a
// remote DMA of its current K/V slot into the right neighbour's other slot,
// runs the flash update on the current slot, and waits on DMA semaphores; a
// capacity semaphore from the receiver guards a slot against being
// overwritten while it is read. This kernel computes the same function (B2's
// recurrence, state carried over n hops, then acc / l in q's type) for every
// shard of a ring whose shards share one card, in one launch: q (B, L, H, D)
// and k/v (B, S, H, D) whole, shard i holding rows [i L/n, (i+1) L/n).
//
// The TPU design, mapped onto one card:
// - K/V travel around the ring through double-buffered slots in device
//   memory, two per shard and (batch, head). At hop h shard i reads the
//   block that started on shard i - h: the caller's k/v at hop 0, its slot
//   h % 2 after. While it computes hop h it copies that block into slot
//   (h + 1) % 2 of shard i + 1, as the TPU sends its slot to the neighbour.
// - Semaphores become counters in global memory: filled[i][bh][h] counts the
//   slices of the block shard i reads at hop h that have landed; done[i][bh][h]
//   counts the query tiles of shard i that finished hop h (the slot is free
//   again, and their state is written).
// - The TPU's grid is sequential per chip; here a work unit is one (hop,
//   shard, batch*head, query tile), one thread block each. A block takes its
//   unit from a ticket counter, hop-major, so every unit waits only on units
//   with smaller tickets, which blocks that already run hold: the launch
//   cannot deadlock whatever the grid and however many blocks fit on the
//   card. A wait that outlasts ten seconds traps instead of hanging.
// - Between hops a unit's running (m, l, acc) lives in a device-memory
//   workspace (the TPU keeps it in VMEM scratch across its hop sweep).
//
// What bounds it on this card: the same bytes as B2 (the state crosses
// device memory once in and once out per hop, and each K/V block is copied
// n - 1 times), less the n^2 - 1 launches and the copies the host issues
// for the scan drive. The products run on the fp32 CUDA cores through the
// shared sweep (ring_flash_common.cuh); tensor cores, keeping the state in
// registers across hops, and peer stores for a ring over distinct cards are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_flash_common.cuh"

namespace {

using ring_flash::kNegInf;
using ring_flash::kThreads;
using ring_flash::Tiling;

constexpr uint64_t kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  void* k_slots;  // [shards][2][batch*heads][kv_len][D], q's type
  void* v_slots;
  float* m;       // [shards][batch*heads][q_len]
  float* l;
  float* acc;     // [shards][batch*heads][q_len][D]
  int* flags;     // ticket, filled[shards][batch*heads][shards], done[...]; zeroed
  int batch, heads, shards, q_len, kv_len, tiles;  // q_len, kv_len: per shard
  // element strides of q, k, v, out as (batch, seq, head)
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_sl, o_sh;
  float scale;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The block waits until *flag reaches target: one thread spins, then the
// block goes on together.
__device__ void wait_for(const int* flag, int target) {
  if (threadIdx.x == 0) {
    const uint64_t t0 = global_ns();
    while (load_acquire(flag) < target) {
      __nanosleep(64);
      if (global_ns() - t0 > kWaitLimitNs) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Adds one to *flag once every thread of the block has written its part.
__device__ void signal(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, 1);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) ring_fused_kernel(const Params p) {
  using Tl = Tiling<D>;
  __shared__ __align__(16) float k_tile[Tl::BKV][D];
  __shared__ __align__(16) float v_tile[Tl::BKV][D];
  __shared__ int ticket;

  if (threadIdx.x == 0) ticket = atomicAdd(p.flags, 1);
  __syncthreads();
  const int n = p.shards;
  const int bhs = p.batch * p.heads;
  const int per_shard = bhs * p.tiles;
  int u = ticket;
  const int hop = u / (n * per_shard);
  u -= hop * n * per_shard;
  const int shard = u / per_shard;
  u -= shard * per_shard;
  const int bh = u / p.tiles;
  const int tile = u - bh * p.tiles;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int right = shard + 1 == n ? 0 : shard + 1;

  int* filled = p.flags + 1;
  int* done = filled + n * bhs * n;
  auto counter = [&](int* base, int s, int at_hop) {
    return base + (static_cast<int64_t>(s) * bhs + bh) * n + at_hop;
  };
  const int64_t block_elems = static_cast<int64_t>(p.kv_len) * D;
  auto slot = [&](void* base, int s, int which) {
    return static_cast<T*>(base) + ((static_cast<int64_t>(s) * 2 + which) * bhs + bh) * block_elems;
  };

  // this hop's K/V block: the caller's tensors at hop 0, a slot after
  const T* k_src;
  const T* v_src;
  int64_t k_ss = D, v_ss = D;
  if (hop == 0) {
    const int64_t first = static_cast<int64_t>(shard) * p.kv_len;
    k_src = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + first * p.k_ss;
    v_src = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + first * p.v_ss;
    k_ss = p.k_ss;
    v_ss = p.v_ss;
  } else {
    k_src = slot(p.k_slots, shard, hop & 1);
    v_src = slot(p.v_slots, shard, hop & 1);
    wait_for(counter(filled, shard, hop), p.tiles);    // the block has landed
    wait_for(counter(done, shard, hop - 1), p.tiles);  // our rows' state is written
  }

  // send this tile's slice of the block on to the right neighbour's slot
  // for hop + 1, once the neighbour is done reading that slot (hop - 1)
  if (hop + 1 < n) {
    if (hop >= 2) wait_for(counter(done, right, hop - 1), p.tiles);
    T* k_dst = slot(p.k_slots, right, (hop + 1) & 1);
    T* v_dst = slot(p.v_slots, right, (hop + 1) & 1);
    const int rows = (p.kv_len + p.tiles - 1) / p.tiles;
    const int r0 = min(p.kv_len, tile * rows);
    const int r1 = min(p.kv_len, r0 + rows);
    for (int idx = threadIdx.x; idx < (r1 - r0) * D; idx += kThreads) {
      const int64_t r = r0 + idx / D;
      const int d = idx % D;
      k_dst[r * D + d] = ring_flash::ldcg(k_src + r * k_ss + d);
      v_dst[r * D + d] = ring_flash::ldcg(v_src + r * v_ss + d);
    }
    signal(counter(filled, right, hop + 1));
  }

  const int part = threadIdx.x % Tl::TPQ;
  const int qi = tile * Tl::kQueries + threadIdx.x / Tl::TPQ;
  const bool q_valid = qi < p.q_len;
  const int64_t row = q_valid ? qi : 0;
  const int64_t seq_row = static_cast<int64_t>(shard) * p.q_len + row;
  const int64_t state_row = (static_cast<int64_t>(shard) * bhs + bh) * p.q_len + row;
  const T* q_row = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + seq_row * p.q_sl;
  float* acc_row = p.acc + state_row * D;
  const bool carried = q_valid && hop > 0;

  float q_r[Tl::kOwn];
  float acc[Tl::kOwn];
#pragma unroll
  for (int c = 0; c < Tl::kChunks; ++c) {
    const int d = 2 * Tl::TPQ * c + 2 * part;
    q_r[2 * c] = q_valid ? ring_flash::load<false>(q_row + d) : 0.f;
    q_r[2 * c + 1] = q_valid ? ring_flash::load<false>(q_row + d + 1) : 0.f;
    acc[2 * c] = carried ? __ldcg(acc_row + d) : 0.f;
    acc[2 * c + 1] = carried ? __ldcg(acc_row + d + 1) : 0.f;
  }
  float m = carried ? __ldcg(p.m + state_row) : kNegInf;  // running max
  float l = carried ? __ldcg(p.l + state_row) : 0.f;      // running denominator

  ring_flash::sweep<true, T, D>(k_src, k_ss, v_src, v_ss, p.kv_len, p.scale, q_r, acc, m, l,
                                k_tile, v_tile);

  if (q_valid) {
    if (hop + 1 == n) {
      T* o_row = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh + seq_row * p.o_sl;
      const float inv = 1.f / l;
#pragma unroll
      for (int c = 0; c < Tl::kChunks; ++c) {
        const int d = 2 * Tl::TPQ * c + 2 * part;
        o_row[d] = ring_flash::from_f32<T>(acc[2 * c] * inv);
        o_row[d + 1] = ring_flash::from_f32<T>(acc[2 * c + 1] * inv);
      }
    } else {
#pragma unroll
      for (int c = 0; c < Tl::kChunks; ++c) {
        const int d = 2 * Tl::TPQ * c + 2 * part;
        acc_row[d] = acc[2 * c];
        acc_row[d + 1] = acc[2 * c + 1];
      }
      if (part == 0) {
        p.m[state_row] = m;
        p.l[state_row] = l;
      }
    }
  }
  if (hop + 1 < n) signal(counter(done, shard, hop));
}

template <typename T, int D>
int launch(Params p, cudaStream_t stream) {
  constexpr int kQueries = Tiling<D>::kQueries;
  p.tiles = (p.q_len + kQueries - 1) / kQueries;
  const int64_t units =
      static_cast<int64_t>(p.shards) * p.shards * p.batch * p.heads * p.tiles;
  if (units > 0x7fffffff) return -2;
  ring_fused_kernel<T, D><<<static_cast<unsigned>(units), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, k, v, out and the slots;
// the state is fp32). q_len and kv_len are per shard. strides: 12 element
// strides in order q, k, v, out as (batch, seq, head). flags must hold
// 1 + 2 * shards * batch * heads * shards zeroed ints. Returns 0,
// cudaGetLastError() after the launch, -1 for an unsupported dtype or head
// dim, -2 for a grid past 2^31 - 1 blocks (the wrapper checks all three).
extern "C" int chiaswarm_ring_flash_fused(const void* q, const void* k, const void* v, void* out,
                                          void* k_slots, void* v_slots, float* m, float* l,
                                          float* acc, int* flags, int dtype, int batch,
                                          int heads, int shards, int q_len, int kv_len,
                                          int head_dim, const int64_t* strides, float scale,
                                          void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.k_slots = k_slots;
  p.v_slots = v_slots;
  p.m = m;
  p.l = l;
  p.acc = acc;
  p.flags = flags;
  p.batch = batch;
  p.heads = heads;
  p.shards = shards;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.tiles = 0;
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
