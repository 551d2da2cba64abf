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
// for the scan drive; at the serve shapes the products dominate, so the
// floor is the tensor-core rate.
//
// The unit's body, two routes: bf16 and fp16 with D <= 160 (the serve path)
// run the wgmma tile of attention_tile_sm90.cuh over the hop's K/V block
// (two warpgroups a unit, 64 query rows each; the carried state is
// loaded into the accumulator layout before the tile and stored after, K/V
// read with cp.async.cg, so slots other blocks wrote are read through L2
// and never through the async proxy); fp32 and the VAE's D = 512 keep the
// CUDA-core sweep of ring_flash_common.cuh. Keeping the state in registers
// across hops and peer stores for a ring over distinct cards are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile_sm90.cuh"
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

// filled[s][bh][hop]: slices of the block shard s reads at hop that landed
__device__ __forceinline__ int* filled_at(const Params& p, int s, int bh, int hop) {
  const int bhs = p.batch * p.heads;
  return p.flags + 1 + (static_cast<int64_t>(s) * bhs + bh) * p.shards + hop;
}

// done[s][bh][hop]: query tiles of shard s that finished hop
__device__ __forceinline__ int* done_at(const Params& p, int s, int bh, int hop) {
  const int bhs = p.batch * p.heads;
  return p.flags + 1 + (static_cast<int64_t>(p.shards + s) * bhs + bh) * p.shards + hop;
}

// slot `which` (0 or 1) of shard s's K or V slots for (batch*head) bh
template <typename T, int D>
__device__ __forceinline__ T* slot_at(const Params& p, void* base, int s, int which, int bh) {
  const int bhs = p.batch * p.heads;
  return static_cast<T*>(base) +
         ((static_cast<int64_t>(s) * 2 + which) * bhs + bh) * static_cast<int64_t>(p.kv_len) * D;
}

// One work unit: (hop, shard, batch*head, query tile of `rows` rows), and
// the K/V block it reads at this hop.
template <typename T>
struct Unit {
  int hop, shard, bh, tile, b, h;
  const T* k_src;
  const T* v_src;
  int64_t k_ss, v_ss;
};

// Decodes the block's ticket into its unit and waits until the unit's K/V
// block has landed and its rows' state from the hop before is written.
// Every thread of the block calls it.
template <typename T, int D>
__device__ Unit<T> take_unit(const Params& p, int ticket) {
  const int n = p.shards;
  const int bhs = p.batch * p.heads;
  const int per_shard = bhs * p.tiles;
  Unit<T> u;
  int rest = ticket;
  u.hop = rest / (n * per_shard);
  rest -= u.hop * n * per_shard;
  u.shard = rest / per_shard;
  rest -= u.shard * per_shard;
  u.bh = rest / p.tiles;
  u.tile = rest - u.bh * p.tiles;
  u.b = u.bh / p.heads;
  u.h = u.bh - u.b * p.heads;
  const int hop = u.hop, shard = u.shard, bh = u.bh;

  // this hop's K/V block: the caller's tensors at hop 0, a slot after
  u.k_ss = D;
  u.v_ss = D;
  if (hop == 0) {
    const int64_t first = static_cast<int64_t>(shard) * p.kv_len;
    u.k_src = static_cast<const T*>(p.k) + u.b * p.k_sb + u.h * p.k_sh + first * p.k_ss;
    u.v_src = static_cast<const T*>(p.v) + u.b * p.v_sb + u.h * p.v_sh + first * p.v_ss;
    u.k_ss = p.k_ss;
    u.v_ss = p.v_ss;
  } else {
    u.k_src = slot_at<T, D>(p, p.k_slots, shard, hop & 1, bh);
    u.v_src = slot_at<T, D>(p, p.v_slots, shard, hop & 1, bh);
    wait_for(filled_at(p, shard, bh, hop), p.tiles);    // the block has landed
    wait_for(done_at(p, shard, bh, hop - 1), p.tiles);  // our rows' state is written
  }
  return u;
}

// Sends the unit's slice of its K/V block on to the right neighbour's slot
// for hop + 1, once the neighbour is done reading that slot (hop - 1):
// element by element or, with kVector, in 16-byte chunks. Every thread of
// the block calls it.
template <typename T, int D, bool kVector>
__device__ void pass_on(const Params& p, const Unit<T>& u) {
  const int hop = u.hop, bh = u.bh;
  const int right = u.shard + 1 == p.shards ? 0 : u.shard + 1;
  if (hop + 1 < p.shards) {
    if (hop >= 2) wait_for(done_at(p, right, bh, hop - 1), p.tiles);
    T* k_dst = slot_at<T, D>(p, p.k_slots, right, (hop + 1) & 1, bh);
    T* v_dst = slot_at<T, D>(p, p.v_slots, right, (hop + 1) & 1, bh);
    const int rows = (p.kv_len + p.tiles - 1) / p.tiles;
    const int r0 = min(p.kv_len, u.tile * rows);
    const int r1 = min(p.kv_len, r0 + rows);
    if constexpr (kVector) {
      // 16-byte chunks (rows start on 16 bytes on this route), kBatch
      // loads in flight before their stores
      constexpr int kRowVecs = D * sizeof(T) / 16;
      constexpr int kBatch = 4;
      const int n_vecs = (r1 - r0) * kRowVecs;
      for (int base = threadIdx.x; base < n_vecs; base += kBatch * blockDim.x) {
        uint4 kb[kBatch], vb[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int idx = base + i * blockDim.x;
          if (idx < n_vecs) {
            const int64_t r = r0 + idx / kRowVecs;
            const int c = idx % kRowVecs;
            kb[i] = __ldcg(reinterpret_cast<const uint4*>(u.k_src + r * u.k_ss) + c);
            vb[i] = __ldcg(reinterpret_cast<const uint4*>(u.v_src + r * u.v_ss) + c);
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int idx = base + i * blockDim.x;
          if (idx < n_vecs) {
            const int64_t r = r0 + idx / kRowVecs;
            const int c = idx % kRowVecs;
            reinterpret_cast<uint4*>(k_dst + r * D)[c] = kb[i];
            reinterpret_cast<uint4*>(v_dst + r * D)[c] = vb[i];
          }
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < (r1 - r0) * D; idx += blockDim.x) {
        const int64_t r = r0 + idx / D;
        const int d = idx % D;
        k_dst[r * D + d] = ring_flash::ldcg(u.k_src + r * u.k_ss + d);
        v_dst[r * D + d] = ring_flash::ldcg(u.v_src + r * u.v_ss + d);
      }
    }
    signal(filled_at(p, right, bh, hop + 1));
  }
}

// Marks the unit's hop done for its (shard, batch*head): its slot may be
// refilled, and its rows' state is written.
__device__ __forceinline__ void end_unit(const Params& p, int hop, int shard, int bh) {
  if (hop + 1 < p.shards) signal(done_at(p, shard, bh, hop));
}

// The CUDA-core route (fp32, and D = 512): Tiling<D>::kQueries query rows a
// unit, kThreads threads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) ring_fused_kernel(const Params p) {
  using Tl = Tiling<D>;
  __shared__ __align__(16) float k_tile[Tl::BKV][D];
  __shared__ __align__(16) float v_tile[Tl::BKV][D];
  __shared__ int ticket;

  if (threadIdx.x == 0) ticket = atomicAdd(p.flags, 1);
  __syncthreads();
  const Unit<T> u = take_unit<T, D>(p, ticket);
  pass_on<T, D, false>(p, u);
  const int bhs = p.batch * p.heads;

  const int part = threadIdx.x % Tl::TPQ;
  const int qi = u.tile * Tl::kQueries + threadIdx.x / Tl::TPQ;
  const bool q_valid = qi < p.q_len;
  const int64_t row = q_valid ? qi : 0;
  const int64_t seq_row = static_cast<int64_t>(u.shard) * p.q_len + row;
  const int64_t state_row = (static_cast<int64_t>(u.shard) * bhs + u.bh) * p.q_len + row;
  const T* q_row = static_cast<const T*>(p.q) + u.b * p.q_sb + u.h * p.q_sh + seq_row * p.q_sl;
  float* acc_row = p.acc + state_row * D;
  const bool carried = q_valid && u.hop > 0;

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

  ring_flash::sweep<true, T, D>(u.k_src, u.k_ss, u.v_src, u.v_ss, p.kv_len, p.scale, q_r, acc, m,
                                l, k_tile, v_tile);

  if (q_valid) {
    if (u.hop + 1 == p.shards) {
      T* o_row = static_cast<T*>(p.out) + u.b * p.o_sb + u.h * p.o_sh + seq_row * p.o_sl;
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
  end_unit(p, u.hop, u.shard, u.bh);
}

// The tensor-core route (bf16, fp16, D <= 160): a unit is two warpgroups,
// 64 query rows each, p.tiles units of 128 rows a shard.
template <typename T, int D>
__global__ void __launch_bounds__(attn_sm90::kBlockThreads, attn_sm90::Shape<D>::kMinBlocks)
    ring_fused_tc_kernel(const Params p) {
  using namespace attn_sm90;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int ticket;

  if (threadIdx.x == 0) ticket = atomicAdd(p.flags, 1);
  __syncthreads();
  const Unit<T> u = take_unit<T, D>(p, ticket);
  const KVRing<T, D> ring{u.k_src, u.v_src, u.k_ss, u.v_ss, p.kv_len, smem};
  ring.start();  // the first K/V tile lands while the slice and state move
  pass_on<T, D, true>(p, u);
  const int bhs = p.batch * p.heads;
  const int row0 = u.tile * kBlockRows + threadIdx.x / kWarpgroup * kRows;  // in the shard
  const int valid = p.q_len - row0;
  const int64_t seq0 = static_cast<int64_t>(u.shard) * p.q_len + row0;
  const int64_t state0 = (static_cast<int64_t>(u.shard) * bhs + u.bh) * p.q_len + row0;

  Tile<T, D> tile;
  tile.load_q(static_cast<const T*>(p.q) + u.b * p.q_sb + u.h * p.q_sh + seq0 * p.q_sl, p.q_sl,
              valid);
  if (u.hop > 0) {
    tile.template load_state<true>(p.m + state0, 1, p.l + state0, 1, p.acc + state0 * D, D,
                                   valid);
  } else {
    tile.init();
  }
  ring.run(tile, p.scale);
  if (u.hop + 1 == p.shards) {
    tile.store_out(static_cast<T*>(p.out) + u.b * p.o_sb + u.h * p.o_sh + seq0 * p.o_sl, p.o_sl,
                   valid);
  } else {
    tile.store_state(p.m + state0, 1, p.l + state0, 1, p.acc + state0 * D, D, valid);
  }
  end_unit(p, u.hop, u.shard, u.bh);
}

// the grid: one block per unit, every hop of every shard
int launch_grid(Params& p, int rows_per_tile, unsigned& units) {
  p.tiles = (p.q_len + rows_per_tile - 1) / rows_per_tile;
  const int64_t n =
      static_cast<int64_t>(p.shards) * p.shards * p.batch * p.heads * p.tiles;
  if (n > 0x7fffffff) return -2;
  units = static_cast<unsigned>(n);
  return 0;
}

template <typename T, int D>
int launch_sweep(Params p, cudaStream_t stream) {
  unsigned units;
  if (const int rc = launch_grid(p, Tiling<D>::kQueries, units)) return rc;
  ring_fused_kernel<T, D><<<units, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_tc(Params p, cudaStream_t stream) {
  constexpr int kSmem = attn_sm90::Shape<D>::kSmemBytes;
  unsigned units;
  if (const int rc = launch_grid(p, attn_sm90::kBlockRows, units)) return rc;
  const cudaError_t attr = cudaFuncSetAttribute(
      ring_fused_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ring_fused_tc_kernel<T, D><<<units, attn_sm90::kBlockThreads, kSmem, stream>>>(p);
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
