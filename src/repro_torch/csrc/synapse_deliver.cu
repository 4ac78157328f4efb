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
//
// Multapses (a list that repeats a target, each synapse its own entry, in
// the order drawn): the kMultapse instance adds a run of equal targets of
// one event in one thread, in order, where the plain instance gives each
// synapse its own thread; a store without multapses keeps the plain
// instance, unchanged.
//
// The plastic form (NEST's stdp_pl_synapse_hom, Morrison, Aertsen &
// Diesmann 2007; the plain version is
// repro_torch/kernels/synapse_deliver.py:stdp_deliver_plain): after the
// static walk, three launches deliver the plastic lists, whose weights are
// simulation state.
//   plan (one block a shard): the plastic events in order (live, not
//   missed, with a plastic list on the shard), their pairs' offsets, the
//   spike's step t_spike = arrival - d (d the dendritic delay), and the
//   source's trace K+ and last spike t_last as each event finds them: the
//   first event of a source walks its later ones, updating K+ = K+
//   tab_plus[t_spike - t_last] + 1 and t_last = t_spike, and writes the
//   final pair back.
//   update (a grid over the pairs): each synapse of a source's first event
//   runs the rule for that event and each later one in order, from the
//   target's post-spike archive: facilitation by each post spike t_k in
//   (t_last - d, t_spike - d], oldest first, w += lambda w^mu K+
//   tab_plus[t_k + d - t_last]; depression by K- of the newest post spike
//   strictly before t_spike - d, w = max(0, w - lambda alpha w K-
//   tab_minus[t_spike - d - t_k]); the value after each event is the one
//   that event adds, kept in a scratch row of pairs.  w^mu is the double
//   pow rounded to float, the rest float ops in the plain version's order
//   (no contraction).  A walk that reaches past the archive's oldest kept
//   entry counts history_short.
//   deliver (stdp_deliver_kernel): the walk above, each pair's value read
//   from the scratch row.
// Counters a shard: updates, facilitation terms, depressions clipped at 0,
// history_short, archive entries read.
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
  // the plastic walk: each live slot's first pair in its shard's row of
  // vals, (S, n_src * capacity); vals (S, vals_stride)
  const int32_t* pv_off;
  const float* vals;
  int64_t vals_stride;
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

template <bool kMultapse, bool kVals>
__device__ __forceinline__ void deliver_walk(const Args& a) {
  extern __shared__ float acc[];                  // (rows used, tile)
  __shared__ uint32_t used[kMaxRows / 32];
  __shared__ int row_of[kMaxRows];
  __shared__ int n_used, n_miss;
  __shared__ int64_t lv_start[kEvents];         // by event with synapses
  __shared__ int lv_off[kEvents + 1];           //   in the tile, in order
  __shared__ int lv_row[kEvents];
  __shared__ int64_t lv_vbase[kVals ? kEvents : 1];  // vals index - entry
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
    // a missed event reaches no plastic synapse
    const bool has = addr < a.per && (!kVals || slack >= 0);
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
        if constexpr (kVals) {
          const int p = p0 + j * kThreads + tid;
          const int64_t g = static_cast<int64_t>(p / C) * a.per +
                            ((words[p] >> kTsBits) & kAddrMask);
          lv_vbase[base_f] = s * a.vals_stride + a.pv_off[s * n_slots + p] -
                             row_ptr[g];
        }
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
        if constexpr (kVals)
          pair_w[q - m0] = a.vals[lv_vbase[lo] + j];
        else
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
        if constexpr (kMultapse) {
          // a run of equal targets (one source's multapses onto a target,
          // adjacent in its list) added by its first thread, in order
          for (int q = q0 + tid; q < q1; q += kThreads) {
            const int x = pair_x[q - m0];
            if (q > q0 && pair_x[q - 1 - m0] == x) continue;
            float v = row[x];
            int r = q;
            do {
              v += pair_w[r - m0];
              ++r;
            } while (r < q1 && pair_x[r - m0] == x);
            row[x] = v;
          }
        } else {
          for (int q = q0 + tid; q < q1; q += kThreads)
            row[pair_x[q - m0]] += pair_w[q - m0];
        }
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
  if (tid == 0 && delivered && a.count) atomicAdd(a.count, delivered);
}

// The static walk; kMultapse for a store whose lists repeat a target.
template <bool kMultapse>
__global__ void __launch_bounds__(kThreads, 2)
synapse_deliver_kernel(const Args a) {
  deliver_walk<kMultapse, false>(a);
}

// The plastic walk: each pair's weight from the update's scratch row.
__global__ void __launch_bounds__(kThreads, 2)
stdp_deliver_kernel(const Args a) {
  deliver_walk<true, true>(a);
}

// ---- the plastic form: plan and update ---------------------------------

constexpr int kPlanSlots = 4096;    // event slots a shard the plan takes
constexpr int kPlanPer = kPlanSlots / kThreads;
constexpr int kCounters = 5;        // updates, facilitation terms, clipped,
                                    // history_short, archive entries read

struct PlanEv {                     // a plastic event of a shard, in order
  int64_t lo;                       // its list's first entry
  int32_t off, tsp, tl, next;       // first pair; t_spike; t_last and
  float kp;                         //   K+ before it; the source's next
  int32_t rep;                      //   event (or -1); a repeat of it?
};

struct Stdp {
  const uint32_t* words;      // (S, S_src, C)
  const int32_t* counts;      // (S, S_src), strides count_s, count_src
  const int64_t* row_ptr;     // (S, S_src * per + 1) plastic lists
  const int32_t* targets;     // (n_plastic,)
  float* weights;             // (n_plastic,) updated in place
  float* kplus;               // (S, S_src * per)
  int32_t* t_last;            // (S, S_src * per), -1: none yet
  const int32_t* a_step;      // (S, per, H) post-spike archive
  const float* a_kminus;      // (S, per, H)
  const int32_t* a_count;     // (S, per)
  const float* tab_plus;      // (tab_len,) e^{-k dt / tau_plus}
  const float* tab_minus;     // (tab_len,) e^{-k dt / tau_minus}
  long long* counters;        // (S, kCounters)
  PlanEv* plan;               // (S, n_slots)
  int32_t* ev_off;            // (S, n_slots + 1)
  int32_t* n_ev;              // (S,)
  int32_t* pv_off;            // (S, n_slots)
  float* vals;                // (S, vals_stride)
  const int32_t* t_at;
  int64_t t, count_s, count_src, vals_stride;
  int n_shards, n_src, capacity, per, ring_len, delay, history, tab_len;
  float lam, lam_alpha;
  double mu;
};

__device__ __forceinline__ int clamp_ix(int64_t k, int n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : static_cast<int>(k));
}

__global__ void __launch_bounds__(kThreads)
stdp_plan_kernel(const Stdp a) {
  __shared__ int32_t ce_g[kPlanSlots];       // source of a plastic event
  __shared__ int32_t ce_tsp[kPlanSlots];     //   and its t_spike, in order
  __shared__ int32_t warp_n[kThreads / 32], warp_f[kThreads / 32];
  __shared__ int32_t n_live;
  const int s = blockIdx.x, tid = threadIdx.x;
  const int C = a.capacity, n_slots = a.n_src * C;
  const int64_t n_ids = static_cast<int64_t>(a.n_src) * a.per;
  const int64_t t = a.t_at ? static_cast<int64_t>(*a.t_at) : a.t;
  const uint32_t* words = a.words + static_cast<int64_t>(s) * n_slots;
  const int32_t* counts = a.counts + s * a.count_s;
  const int64_t* row_ptr = a.row_ptr + s * (n_ids + 1);
  PlanEv* plan = a.plan + static_cast<int64_t>(s) * n_slots;
  int32_t* ev_off = a.ev_off + static_cast<int64_t>(s) * (n_slots + 1);
  // a thread's kPlanPer consecutive slots: pairs and plastic events
  int64_t lo[kPlanPer];
  int32_t g_of[kPlanPer], tsp[kPlanPer], n_of[kPlanPer];
  int my_n = 0, my_f = 0;
#pragma unroll
  for (int j = 0; j < kPlanPer; ++j) {
    const int p = tid * kPlanPer + j;
    int n = 0;
    lo[j] = 0;
    g_of[j] = -1;
    tsp[j] = 0;
    if (p < n_slots) {
      const int src = p / C;
      if (p - src * C < counts[src * a.count_src]) {
        const uint32_t w = words[p];
        const int slack = slack_of(w, t);
        const int addr = static_cast<int>((w >> kTsBits) & kAddrMask);
        if (addr < a.per && slack >= 0) {
          const int64_t g = static_cast<int64_t>(src) * a.per + addr;
          lo[j] = row_ptr[g];
          n = static_cast<int>(row_ptr[g + 1] - lo[j]);
          if (n > 0) {
            g_of[j] = static_cast<int32_t>(g);
            tsp[j] = static_cast<int32_t>(t + slack - a.delay);
          }
        }
      }
    }
    n_of[j] = n;
    my_n += n;
    my_f += n > 0;
  }
  // exclusive scans of pairs and of plastic events over the slots' order
  const int lane = tid & 31, warp = tid >> 5;
  int inc_n = my_n, inc_f = my_f;
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
  int base_n = inc_n - my_n, base_f = inc_f - my_f, tot_n = 0, tot_f = 0;
  for (int k = 0; k < kThreads / 32; ++k) {
    if (k < warp) {
      base_n += warp_n[k];
      base_f += warp_f[k];
    }
    tot_n += warp_n[k];
    tot_f += warp_f[k];
  }
#pragma unroll
  for (int j = 0; j < kPlanPer; ++j) {
    const int p = tid * kPlanPer + j;
    if (p >= n_slots) break;
    const int n = n_of[j];
    a.pv_off[static_cast<int64_t>(s) * n_slots + p] = base_n;
    if (n > 0) {
      PlanEv ev;
      ev.lo = lo[j];
      ev.off = base_n;
      ev.tsp = tsp[j];
      ev.tl = -1;
      ev.next = -1;
      ev.kp = 0.0f;
      ev.rep = 0;
      plan[base_f] = ev;
      ev_off[base_f] = base_n;
      ce_g[base_f] = g_of[j];
      ce_tsp[base_f] = tsp[j];
      ++base_f;
    }
    base_n += n;
  }
  if (tid == 0) {
    ev_off[tot_f] = tot_n;
    a.n_ev[s] = tot_f;
    n_live = tot_f;
  }
  __syncthreads();
  // a source's events chained in order; its first event's thread carries
  // K+ and t_last through them and writes the pair back
  const int n_e = n_live;
  float* kplus = a.kplus + static_cast<int64_t>(s) * n_ids;
  int32_t* t_last = a.t_last + static_cast<int64_t>(s) * n_ids;
  for (int c = tid; c < n_e; c += kThreads) {
    const int32_t g = ce_g[c];
    bool first = true;
    for (int b = 0; b < c && first; ++b) first = ce_g[b] != g;
    if (!first) {
      plan[c].rep = 1;
      continue;
    }
    float kp = kplus[g];
    int32_t tl = t_last[g];
    int m = c;
    while (m >= 0) {
      int nx = -1;
      for (int b = m + 1; b < n_e; ++b)
        if (ce_g[b] == g) {
          nx = b;
          break;
        }
      plan[m].kp = kp;
      plan[m].tl = tl;
      plan[m].next = nx;
      const int32_t ts = ce_tsp[m];
      kp = __fadd_rn(__fmul_rn(kp, a.tab_plus[clamp_ix(
                                       static_cast<int64_t>(ts) - tl,
                                       a.tab_len)]),
                     1.0f);
      tl = ts;
      m = nx;
    }
    kplus[g] = kp;
    t_last[g] = tl;
  }
}

// The rule for one synapse (target archive at `base`, `n` spikes so far)
// and one event -> its weight after it; counts into c.
__device__ __forceinline__ float stdp_rule(const Stdp& a, float w, int32_t ts,
                                           float kp, int32_t tl, int64_t base,
                                           int n, long long* c) {
  const int H = a.history;
  const int32_t t2 = ts - a.delay;
  const int32_t t1 = tl < 0 ? t2 : tl - a.delay;
  const int32_t lim = min(t1, t2 - 1);
  const int oldest = max(n - H, 0);
  int i = n - 1, dep = -1;
  bool stopped = false;
  for (; i >= oldest; --i) {
    const int32_t st = a.a_step[base + i % H];
    ++c[4];
    if (dep < 0 && st < t2) dep = i;
    if (st <= lim) {
      stopped = true;
      break;
    }
  }
  if (!stopped && n > H) ++c[3];
  for (int k = i + 1; k < n; ++k) {
    const int32_t st = a.a_step[base + k % H];
    if (st > t2) break;
    if (st <= t1) continue;
    const float kt = __fmul_rn(
        kp, a.tab_plus[clamp_ix(static_cast<int64_t>(st) + a.delay - tl,
                                a.tab_len)]);
    const float pw = static_cast<float>(pow(static_cast<double>(w), a.mu));
    w = __fadd_rn(w, __fmul_rn(__fmul_rn(a.lam, pw), kt));
    ++c[1];
  }
  if (dep >= 0) {
    const int64_t at = base + dep % H;
    const float km = __fmul_rn(
        a.a_kminus[at],
        a.tab_minus[clamp_ix(static_cast<int64_t>(t2) - a.a_step[at],
                             a.tab_len)]);
    const float wn = __fsub_rn(w, __fmul_rn(__fmul_rn(a.lam_alpha, w), km));
    if (wn < 0.0f) {
      w = 0.0f;
      ++c[2];
    } else {
      w = wn;
    }
  }
  ++c[0];
  return w;
}

__global__ void __launch_bounds__(kThreads)
stdp_update_kernel(const Stdp a) {
  __shared__ long long part[kCounters][kThreads / 32];
  const int s = blockIdx.y, tid = threadIdx.x;
  const int n_slots = a.n_src * a.capacity;
  const PlanEv* plan = a.plan + static_cast<int64_t>(s) * n_slots;
  const int32_t* ev_off = a.ev_off + static_cast<int64_t>(s) * (n_slots + 1);
  const int n_e = a.n_ev[s];
  const int total = ev_off[n_e];
  float* vals = a.vals + s * a.vals_stride;
  long long c[kCounters] = {0, 0, 0, 0, 0};
  for (int q = blockIdx.x * kThreads + tid; q < total;
       q += gridDim.x * kThreads) {
    int lo = 0, hi = n_e;                   // last event with off <= q
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (ev_off[mid] <= q) lo = mid; else hi = mid;
    }
    const PlanEv ev = plan[lo];
    if (ev.rep) continue;                   // its first event's thread
    const int64_t j = ev.lo + (q - ev.off);
    const int x = a.targets[j];
    const int64_t nid = static_cast<int64_t>(s) * a.per + x;
    const int64_t base = nid * a.history;
    const int n = a.a_count[nid];
    float w = a.weights[j];
    int m = lo;
    PlanEv em = ev;
    while (true) {
      w = stdp_rule(a, w, em.tsp, em.kp, em.tl, base, n, c);
      vals[em.off + (j - ev.lo)] = w;
      if (em.next < 0) break;
      m = em.next;
      em = plan[m];
    }
    a.weights[j] = w;
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kCounters; ++k) {
    long long v = c[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0) part[k][warp] = v;
  }
  __syncthreads();
  if (tid < kCounters) {
    long long v = 0;
    for (int k = 0; k < kThreads / 32; ++k) v += part[tid][k];
    if (v)
      atomicAdd(reinterpret_cast<unsigned long long*>(
                    a.counters + s * kCounters + tid),
                static_cast<unsigned long long>(v));
  }
}

template <typename K>
cudaError_t prepare(K kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

int g_sms = 0;

cudaError_t ready() {
  if (g_sms) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = prepare(synapse_deliver_kernel<false>);
  if (err == cudaSuccess) err = prepare(synapse_deliver_kernel<true>);
  if (err == cudaSuccess) err = prepare(stdp_deliver_kernel);
  if (err == cudaSuccess) g_sms = sms;
  return err;
}

// The walk's grid and staged bytes for `per` neurons a shard.
void walk_shape(int n_shards, int per, int ring_len, int* tile, dim3* grid,
                size_t* smem) {
  // tiles no wider than kDynBytes of staged rows allows, and at least as
  // many as fill the SMs once at two blocks each
  const int widest = kDynBytes / (2 * ring_len * static_cast<int>(
                                      sizeof(float)));
  const int fill = max(2 * g_sms / n_shards, 1);
  const int tiles = min(max((per + widest - 1) / widest, fill), per);
  *tile = (per + tiles - 1) / tiles;
  *smem = static_cast<size_t>(2 * ring_len) * *tile * sizeof(float);
  *grid = dim3((per + *tile - 1) / *tile, n_shards);
}

}  // namespace

extern "C" int repro_synapse_deliver(
    const void* words, const void* counts, const void* row_ptr,
    const void* targets, const void* weights, const void* inh_src,
    void* ring_exc, void* ring_inh, void* miss, void* count, int n_shards,
    int n_src, int capacity, int per, int ring_len, int64_t t,
    const void* t_at, int64_t count_s, int64_t count_src, int multapses,
    void* stream) {
  if (n_shards == 0 || per == 0) return 0;
  if (ring_len < 1 || 2 * ring_len > kMaxRows || capacity < 1 ||
      per > static_cast<int>(kAddrMask) + 1 || t < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ready();
  if (err != cudaSuccess) return static_cast<int>(err);
  int tile;
  dim3 grid;
  size_t smem;
  walk_shape(n_shards, per, ring_len, &tile, &grid, &smem);
  Args a{};
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
  auto st = static_cast<cudaStream_t>(stream);
  if (multapses)
    synapse_deliver_kernel<true><<<grid, kThreads, smem, st>>>(a);
  else
    synapse_deliver_kernel<false><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The plastic form: plan, update and walk over the plastic lists (module
// comment).  ws: a workspace of at least repro_stdp_workspace bytes.
extern "C" int64_t repro_stdp_workspace(int n_shards, int n_slots) {
  return static_cast<int64_t>(n_shards) *
         (static_cast<int64_t>(n_slots) * (sizeof(PlanEv) + 8) + 16);
}

extern "C" int repro_stdp_deliver(
    const void* words, const void* counts, const void* row_ptr,
    const void* targets, void* weights, const void* inh_src, void* kplus,
    void* t_last, const void* a_step, const void* a_kminus,
    const void* a_count, const void* tab_plus, const void* tab_minus,
    void* counters, void* ring_exc, void* ring_inh, void* miss, void* ws,
    void* vals, int64_t vals_stride, int n_shards, int n_src, int capacity,
    int per, int ring_len, int64_t t, const void* t_at, int64_t count_s,
    int64_t count_src, int delay, int history, int tab_len, float lam,
    float lam_alpha, double mu, void* stream) {
  if (n_shards == 0 || per == 0) return 0;
  const int n_slots = n_src * capacity;
  if (ring_len < 1 || 2 * ring_len > kMaxRows || capacity < 1 ||
      per > static_cast<int>(kAddrMask) + 1 || t < 0 ||
      n_slots > kPlanSlots || history < 1 || tab_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ready();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  char* w = static_cast<char*>(ws);
  Stdp p{};
  p.plan = reinterpret_cast<PlanEv*>(w);
  w += static_cast<int64_t>(n_shards) * n_slots * sizeof(PlanEv);
  p.ev_off = reinterpret_cast<int32_t*>(w);
  w += static_cast<int64_t>(n_shards) * (n_slots + 1) * 4;
  p.pv_off = reinterpret_cast<int32_t*>(w);
  w += static_cast<int64_t>(n_shards) * n_slots * 4;
  p.n_ev = reinterpret_cast<int32_t*>(w);
  p.words = static_cast<const uint32_t*>(words);
  p.counts = static_cast<const int32_t*>(counts);
  p.row_ptr = static_cast<const int64_t*>(row_ptr);
  p.targets = static_cast<const int32_t*>(targets);
  p.weights = static_cast<float*>(weights);
  p.kplus = static_cast<float*>(kplus);
  p.t_last = static_cast<int32_t*>(t_last);
  p.a_step = static_cast<const int32_t*>(a_step);
  p.a_kminus = static_cast<const float*>(a_kminus);
  p.a_count = static_cast<const int32_t*>(a_count);
  p.tab_plus = static_cast<const float*>(tab_plus);
  p.tab_minus = static_cast<const float*>(tab_minus);
  p.counters = static_cast<long long*>(counters);
  p.vals = static_cast<float*>(vals);
  p.t_at = static_cast<const int32_t*>(t_at);
  p.t = t;
  p.count_s = count_s;
  p.count_src = count_src;
  p.vals_stride = vals_stride;
  p.n_shards = n_shards;
  p.n_src = n_src;
  p.capacity = capacity;
  p.per = per;
  p.ring_len = ring_len;
  p.delay = delay;
  p.history = history;
  p.tab_len = tab_len;
  p.lam = lam;
  p.lam_alpha = lam_alpha;
  p.mu = mu;
  stdp_plan_kernel<<<n_shards, kThreads, 0, st>>>(p);
  const dim3 ugrid(max(4 * g_sms / n_shards, 1), n_shards);
  stdp_update_kernel<<<ugrid, kThreads, 0, st>>>(p);
  int tile;
  dim3 grid;
  size_t smem;
  walk_shape(n_shards, per, ring_len, &tile, &grid, &smem);
  Args a{};
  a.words = static_cast<const uint32_t*>(words);
  a.counts = static_cast<const int32_t*>(counts);
  a.row_ptr = static_cast<const int64_t*>(row_ptr);
  a.targets = static_cast<const int32_t*>(targets);
  a.weights = nullptr;
  a.inh_src = static_cast<const uint8_t*>(inh_src);
  a.ring_exc = static_cast<float*>(ring_exc);
  a.ring_inh = static_cast<float*>(ring_inh);
  a.miss = static_cast<int32_t*>(miss);
  a.count = nullptr;
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
  a.pv_off = p.pv_off;
  a.vals = p.vals;
  a.vals_stride = vals_stride;
  stdp_deliver_kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
