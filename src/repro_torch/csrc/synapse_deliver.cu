// Delivery of a window's received events through a sparse synapse store
// into the delay rings, in event order, for Hopper (sm_90a).
//
// No TPU kernel: the reference simulator delivers through a dense (N, N)
// weight matrix (src/repro/snn/simulator.py:_apply_events, a gather of a
// weight row per event slot and an einsum).  At the microcircuit's full
// scale that matrix is 23.8 GB; the sparse store of
// repro_torch/snn/network.py:SynapseStore is 2.3 GB, and a window needs
// only the live events' synapses (~0.7 M adds, ~5.5 MB of store).
//
// What it computes (repro_torch/kernels/synapse_deliver.py, the plain
// version: synapse_deliver_plain).  For each destination shard s, the
// received events words[s, src, k] (src the sending shard, k the bucket
// slot) are taken in order, row-major over (src, k), live ones only
// (k < counts[s, src]).  An event's source is g = src * per + address(w)
// (the source address layout); its slot in the ring is
// (t + max(slack, 0)) % ring_len, slack the signed 15-bit distance from
// t to its timestamp; an event with slack < 0 is a deadline miss of s.
// Each synapse (target x, weight) of (s, g) adds its weight, as one f32
// add, into ring_inh if g is inhibitory, else ring_exc, at [slot, s, x].
// Every (target, slot) sees its adds in that event order, so the result
// is a fixed sequence of f32 additions, bit for bit the plain version's.
// An address at or past per carries no synapse.  The synapses delivered
// are added into a one-element counter.  The window's step t comes by
// value or, for a caller that keeps its step count on the card (the
// simulator's window loop, replayed as a CUDA graph), through a device
// pointer to an int32, read by each block before its walk.
//
// Bound on an H100 (3.35 TB/s): bytes, ~0.7 M synapses x 8 B + the
// event words, ~1.7 us a window.  In fact latency-bound: the adds into
// one (target, slot) form a chain in event order.  Measured on an H100 at
// full scale: 65-75 us a window, of which the ordered walk takes ~30 and
// staging the touched rows in and out ~15.
//
// Design: one block per (target tile, destination shard); the order of
// the float adds is decided by the block's walk over the events, never by
// atomics.  Per chunk of kEvents slots (the whole window up to 1,024
// slots), the block (a) reads each slot once, the slots dealt to the
// threads in turn so that the live ones, which fill the front of each
// source's row, spread over the block: its miss, its ring row (slot,
// exc|inh) and its list, narrowed to the tile by two binary searches (a
// list is sorted by target), a thread's searches stepped together; then
// stages the touched rows of the tile in shared memory; (b) compacts the
// events with synapses in the tile, in order, with the prefix sums of
// their counts; (c) copies their synapses, kPairs at a time, into shared
// memory with independent loads; (d) walks them in order, each event's
// synapses added by the threads in parallel (one event has at most one
// synapse per target), a barrier between events; (e) writes the staged
// rows back.  A window of more slots than a chunk is scanned for its
// misses and rows first.  Integer atomics only count misses, mark rows
// and add to the counter.  The tile's width is chosen at launch so that
// the grid fills the SMs once at two blocks an SM (at most kDynBytes of
// staged rows and ~29 KB of tables a block, the carveout at its most
// shared memory): 33 tiles of 293 neurons a shard at full scale.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEvents = 1024;       // event slots a chunk (4 a thread)
constexpr int kPer = kEvents / kThreads;
constexpr int kPairs = 2048;        // synapses staged a pass
constexpr int kMaxRows = 128;       // 2 x ring_len
constexpr int kDynBytes = 80 * 1024;  // staged ring rows at most
constexpr int kTsBits = 15;
constexpr uint32_t kTsMask = (1u << kTsBits) - 1;
constexpr uint32_t kAddrMask = (1u << 14) - 1;

struct Args {
  const uint32_t* words;     // (S, S_src, C) received [dst, src, slot]
  const int32_t* counts;     // (S, S_src), strides count_s, count_src
  const int64_t* row_ptr;    // (S, S_src * per + 1)
  const int32_t* targets;    // (n_syn,) target id on the shard
  const float* weights;      // (n_syn,)
  const uint8_t* inh_src;    // (S_src * per,) inhibitory source
  float* ring_exc;           // (L, S, per)
  float* ring_inh;           // (L, S, per)
  int32_t* miss;             // (S,)
  unsigned long long* count; // (1,)
  const int32_t* t_at;       // the step on the device, or null: t
  int n_shards, n_src, capacity, per, ring_len, tile;
  int64_t t, count_s, count_src;
};

__device__ __forceinline__ int slack_of(uint32_t w, int64_t t) {
  const int d = static_cast<int>((w - static_cast<uint32_t>(t)) & kTsMask);
  return d > static_cast<int>(kTsMask >> 1) ? d - static_cast<int>(kTsMask)
                                                  - 1
                                            : d;
}

__device__ __forceinline__ int compact_row(const uint32_t* used, int r) {
  int c = 0;
  for (int i = 0; i < (r >> 5); ++i) c += __popc(used[i]);
  return c + __popc(used[r >> 5] & ((1u << (r & 31)) - 1u));
}

// One event slot of a destination shard, read for the walk.
struct Slot {
  int64_t lo, hi;        // its list, then its synapses in the tile
  int row;               // ring row: slot, or ring_len + slot if inhibitory
  bool live;
};

// Narrow each live slot's [lo, hi) to its synapses with a target in
// [a, b): the first index >= a and the first >= b of each sorted list,
// all 2 N binary searches stepped together so their loads overlap.
template <int N>
__device__ __forceinline__ void bounds(const int32_t* tg, Slot* e, int a,
                                       int b) {
  int64_t la[N], ha[N], lb[N], hb[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    la[j] = lb[j] = e[j].lo;
    ha[j] = hb[j] = e[j].live ? e[j].hi : e[j].lo;
  }
  bool busy = true;
  while (busy) {
    busy = false;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (la[j] < ha[j]) {
        const int64_t m = (la[j] + ha[j]) >> 1;
        if (tg[m] < a) la[j] = m + 1; else ha[j] = m;
      }
      if (lb[j] < hb[j]) {
        const int64_t m = (lb[j] + hb[j]) >> 1;
        if (tg[m] < b) lb[j] = m + 1; else hb[j] = m;
      }
      busy |= la[j] < ha[j] || lb[j] < hb[j];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    e[j].lo = la[j];
    e[j].hi = lb[j];
  }
}

__device__ __forceinline__ float* ring_at(const Args& a, int r, int s,
                                          int x) {
  float* ring = r < a.ring_len ? a.ring_exc : a.ring_inh;
  const int slot = r < a.ring_len ? r : r - a.ring_len;
  return ring + (static_cast<int64_t>(slot) * a.n_shards + s) * a.per + x;
}

__global__ void __launch_bounds__(kThreads, 2)
synapse_deliver_kernel(const Args a) {
  extern __shared__ float acc[];                  // (rows used, tile)
  __shared__ uint32_t used[kMaxRows / 32];
  __shared__ int row_of[kMaxRows];
  __shared__ int n_used, n_miss;
  __shared__ int64_t lv_start[kEvents];         // by event with synapses
  __shared__ int lv_off[kEvents + 1];           //   in the tile, in order
  __shared__ int lv_row[kEvents];
  __shared__ uint16_t pair_x[kPairs];
  __shared__ float pair_w[kPairs];
  __shared__ int warp_n[kThreads / 32], warp_f[kThreads / 32];

  const int s = blockIdx.y;
  const int tile = a.tile;
  const int tile_lo = blockIdx.x * tile;
  const int tile_hi = min(tile_lo + tile, a.per);
  const int width = tile_hi - tile_lo;
  const int L = a.ring_len;
  const int C = a.capacity;
  const int n_slots = a.n_src * C;
  const int64_t n_src_ids = static_cast<int64_t>(a.n_src) * a.per;
  const uint32_t* words = a.words + static_cast<int64_t>(s) * n_slots;
  const int32_t* counts = a.counts + s * a.count_s;
  const int64_t* row_ptr = a.row_ptr + s * (n_src_ids + 1);
  const int tid = threadIdx.x;
  const int64_t t = a.t_at ? static_cast<int64_t>(*a.t_at) : a.t;
  // a window of at most kEvents slots is read once: the rows it touches
  // and its misses come out of the walk's own reads; a longer one is
  // scanned for them first
  const bool one_pass = n_slots <= kEvents;

  if (tid < kMaxRows / 32) used[tid] = 0;
  if (tid == 0) n_miss = 0;
  __syncthreads();

  auto read_slot = [&](int p, bool mark) -> Slot {
    Slot e{0, 0, 0, false};
    const int src = p / C;
    if (p - src * C >= counts[src * a.count_src]) return e;
    const uint32_t w = words[p];
    const int slack = slack_of(w, t);
    const int addr = static_cast<int>((w >> kTsBits) & kAddrMask);
    const int64_t g = static_cast<int64_t>(src) * a.per + addr;
    const bool has = addr < a.per;
    e.row = static_cast<int>((t + max(slack, 0)) % L) +
            (has && a.inh_src[g] ? L : 0);
    if (mark) {
      if (blockIdx.x == 0 && slack < 0) atomicAdd(&n_miss, 1);
      atomicOr(&used[e.row >> 5], 1u << (e.row & 31));
    }
    if (has) {
      e.lo = row_ptr[g];
      e.hi = row_ptr[g + 1];
      e.live = true;
    }
    return e;
  };
  // the touched rows of the tile into shared memory, once `used` is whole
  auto stage = [&]() {
    if (blockIdx.x == 0 && tid == 0) a.miss[s] = n_miss;
    if (tid < 2 * L && ((used[tid >> 5] >> (tid & 31)) & 1u))
      row_of[compact_row(used, tid)] = tid;
    if (tid == 0) n_used = compact_row(used, kMaxRows - 1) +
                           static_cast<int>(used[kMaxRows / 32 - 1] >> 31);
    __syncthreads();
#pragma unroll 8
    for (int i = tid; i < n_used * tile; i += kThreads) {
      const int c = i / tile, x = i - c * tile;
      if (x < width) acc[i] = *ring_at(a, row_of[c], s, tile_lo + x);
    }
  };

  if (!one_pass) {
    for (int p = tid; p < n_slots; p += kThreads) read_slot(p, true);
    __syncthreads();
    stage();
  }

  unsigned long long delivered = 0;
  for (int p0 = 0; p0 < n_slots; p0 += kEvents) {
    __syncthreads();
    // (a) a thread's kPer slots, dealt in turn (the live ones fill the
    // front of each source's row), their bounds in the tile searched
    // together
    Slot e[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = p0 + j * kThreads + tid;
      e[j] = p < n_slots ? read_slot(p, one_pass) : Slot{0, 0, 0, false};
    }
    bounds<kPer>(a.targets, e, tile_lo, tile_hi);
    if (one_pass) {
      __syncthreads();
      stage();
    }
    // (b) the slots with synapses in the tile, compacted in order, with
    // the offsets of their synapses: a block scan per j
    int run_n = 0, run_f = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = static_cast<int>(e[j].hi - e[j].lo), f = n > 0;
      const int lane = tid & 31, warp = tid >> 5;
      int inc_n = n, inc_f = f;
      for (int off = 1; off < 32; off <<= 1) {
        const int vn = __shfl_up_sync(0xFFFFFFFFu, inc_n, off);
        const int vf = __shfl_up_sync(0xFFFFFFFFu, inc_f, off);
        if (lane >= off) {
          inc_n += vn;
          inc_f += vf;
        }
      }
      if (lane == 31) {
        warp_n[warp] = inc_n;
        warp_f[warp] = inc_f;
      }
      __syncthreads();
      int base_n = run_n + inc_n - n, base_f = run_f + inc_f - f;
      for (int k = 0; k < kThreads / 32; ++k) {
        if (k < warp) {
          base_n += warp_n[k];
          base_f += warp_f[k];
        }
        run_n += warp_n[k];
        run_f += warp_f[k];
      }
      if (f) {
        lv_start[base_f] = e[j].lo;
        lv_off[base_f] = base_n;
        lv_row[base_f] = compact_row(used, e[j].row);
      }
      __syncthreads();
    }
    const int total = run_n, live = run_f;
    if (tid == 0) lv_off[live] = total;
    delivered += total;
    __syncthreads();

    // (c) the synapses, kPairs at a time, then (d) the walk in order
    for (int m0 = 0; m0 < total; m0 += kPairs) {
      const int m1 = min(m0 + kPairs, total);
#pragma unroll 4
      for (int q = m0 + tid; q < m1; q += kThreads) {
        int lo = 0, hi = live;              // last event with lv_off <= q
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (lv_off[mid] <= q) lo = mid; else hi = mid;
        }
        const int64_t j = lv_start[lo] + (q - lv_off[lo]);
        pair_x[q - m0] = static_cast<uint16_t>(a.targets[j] - tile_lo);
        pair_w[q - m0] = a.weights[j];
      }
      __syncthreads();
      int k = 0, hi = live;                 // the event holding m0
      while (hi - k > 1) {
        const int mid = (k + hi) >> 1;
        if (lv_off[mid] <= m0) k = mid; else hi = mid;
      }
      for (; k < live && lv_off[k] < m1; ++k) {
        const int q0 = max(lv_off[k], m0), q1 = min(lv_off[k + 1], m1);
        float* row = acc + lv_row[k] * tile;
        for (int q = q0 + tid; q < q1; q += kThreads)
          row[pair_x[q - m0]] += pair_w[q - m0];
        __syncthreads();
      }
    }
  }

  // (e) the touched rows back
  __syncthreads();
#pragma unroll 8
  for (int i = tid; i < n_used * tile; i += kThreads) {
    const int c = i / tile, x = i - c * tile;
    if (x < width) *ring_at(a, row_of[c], s, tile_lo + x) = acc[i];
  }
  if (tid == 0 && delivered) atomicAdd(a.count, delivered);
}

}  // namespace

extern "C" int repro_synapse_deliver(
    const void* words, const void* counts, const void* row_ptr,
    const void* targets, const void* weights, const void* inh_src,
    void* ring_exc, void* ring_inh, void* miss, void* count, int n_shards,
    int n_src, int capacity, int per, int ring_len, int64_t t,
    const void* t_at, int64_t count_s, int64_t count_src, void* stream) {
  if (n_shards == 0 || per == 0) return 0;
  if (ring_len < 1 || 2 * ring_len > kMaxRows || capacity < 1 ||
      per > static_cast<int>(kAddrMask) + 1 || t < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(synapse_deliver_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kDynBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          synapse_deliver_kernel,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) {
      sms = 0;
      return static_cast<int>(err);
    }
  }
  // tiles no wider than kDynBytes of staged rows allows, and at least as
  // many as fill the SMs once at two blocks each
  const int widest = kDynBytes / (2 * ring_len * static_cast<int>(
                                      sizeof(float)));
  const int fill = max(2 * sms / n_shards, 1);
  const int tiles = min(max((per + widest - 1) / widest, fill), per);
  const int tile = (per + tiles - 1) / tiles;
  const size_t smem = static_cast<size_t>(2 * ring_len) * tile *
                      sizeof(float);
  Args a;
  a.words = static_cast<const uint32_t*>(words);
  a.counts = static_cast<const int32_t*>(counts);
  a.row_ptr = static_cast<const int64_t*>(row_ptr);
  a.targets = static_cast<const int32_t*>(targets);
  a.weights = static_cast<const float*>(weights);
  a.inh_src = static_cast<const uint8_t*>(inh_src);
  a.ring_exc = static_cast<float*>(ring_exc);
  a.ring_inh = static_cast<float*>(ring_inh);
  a.miss = static_cast<int32_t*>(miss);
  a.count = static_cast<unsigned long long*>(count);
  a.t_at = static_cast<const int32_t*>(t_at);
  a.n_shards = n_shards;
  a.n_src = n_src;
  a.capacity = capacity;
  a.per = per;
  a.ring_len = ring_len;
  a.tile = tile;
  a.t = t;
  a.count_s = count_s;
  a.count_src = count_src;
  const dim3 grid((per + tile - 1) / tile, n_shards);
  synapse_deliver_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
