// The cycle-level bucket model and the ring-buffer model for Hopper
// (sm_90a): kernel G.
//
// No TPU kernel corresponds to it.  The reference replays both models with
// lax.scan: src/repro/core/bucket.py:284 run_trace and
// src/repro/core/flow_control.py:288 run.  The plain versions are
// run_trace_plain in src/repro_torch/core/bucket.py and run_plain in
// src/repro_torch/core/flow_control.py; the wrapper is
// src/repro_torch/kernels/cycle_models.py.
//
// bucket_trace_kernel: one whole run_trace from init_state in one launch.
// Every FPGA clock accepts E events in order (map-table lookup, the lowest
// free bucket or, with none free, a steal of the most urgent bucket after
// flushing it into the drain queue, the append with its deadline update),
// then flushes the buckets that filled, in arrival order, then the most
// urgent bucket if its slack is within the margin, then starts the next
// packet on the output port if it is idle.  Each step reads the state the
// one before left: the replay is a chain of T * E accepts and T port steps.
//
// Design.  One warp, all of the state in shared memory: the map table
// (n_dest, up to 2^14 entries: dynamic shared memory), bucket -> dest,
// fill, deadline, storage (B x C), and the drain queue (Q dests, counts,
// Q x C payloads) as a ring whose head and length, like port_busy and now,
// are warp-uniform registers.  The logical queue slot i is physical
// (head + i) % Q, so a packet start moves no payload (the reference rolls
// the queue); slots at or past the length are empty in the reference and
// are written as such into the final state.  The lanes do what is wide:
// the free-bucket search (__ballot_sync + __ffs: the lowest index), the
// argmin of the urgency over the buckets (shuffles, the lowest index
// winning ties, as jnp.argmin), the C-wide copy of a bucket into the queue,
// the payload and deadline-miss count of a starting packet (ballot +
// popc), and the final state.  Scalar state is written by lane 0 and read
// after a __syncwarp.  Every lane reads the same event word (a broadcast).
//
// Bound on an H100: the chain.  Each accept and each port step needs at
// least one shared-memory round trip (~30 cycles at 1.98 GHz); the bytes
// (the trace in, T x (C + 4) words out) take far less at 3.35 TB/s.
//
// ring_run_kernel: flow_control.run with the producer's wishes as input,
// one thread: per step the producer (min(want, credits) slots written),
// the consumer (min(rate, available) read, whole batches notified into
// the tail of the delay line) and the tick (the head's credits delivered).
// The delay line is a ring in shared memory; the final state is written
// in the reference's order.  Bound: the chain of `steps` dependent steps.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kTsMask = (1 << 15) - 1;
constexpr int kValidBit = 1 << 29;
constexpr int kNone = -1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int ts_slack(int deadline, int now) {
  const int d = (deadline - now) & kTsMask;
  return d > (kTsMask >> 1) ? d - (kTsMask + 1) : d;
}

__device__ __forceinline__ int wire_cycles(int n) {
  if (n <= 0) return 0;
  const int bytes = ((n + 3) / 4) * 16 + 16;   // 4-event groups + header
  return (bytes + 15) / 16;                    // 16 B a cycle
}

struct Buckets {
  int* map;      // (n_dest)
  int* bdest;    // (B)
  int* fill;     // (B)
  int* dl;       // (B)
  int* store;    // (B, C)
  int* qdest;    // (Q) ring
  int* qcount;   // (Q) ring
  int* qev;      // (Q, C) ring
  int B, C, Q;
  int head, len;  // queue ring (warp-uniform)
};

// Urgency of bucket b: its slack, or kBig when empty.
__device__ __forceinline__ int urgency(const Buckets& s, int b, int now) {
  return s.fill[b] > 0 ? ts_slack(s.dl[b] & kTsMask, now & kTsMask) : kBig;
}

// argmin of the urgency over the buckets, the lowest index on ties; the
// same (value, index) in every lane.
__device__ int most_urgent(const Buckets& s, int now, int lane, int* value) {
  int best = 0x7fffffff, at = 0x7fffffff;
  for (int b = lane; b < s.B; b += 32) {
    const int u = urgency(s, b, now);
    if (u < best) { best = u; at = b; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(kFull, best, off);
    const int oa = __shfl_xor_sync(kFull, at, off);
    if (ob < best || (ob == best && oa < at)) { best = ob; at = oa; }
  }
  *value = best;
  return at;
}

// Hand bucket b to the drain queue; false when the queue is full and the
// bucket is not empty (an empty bucket counts as flushed).
__device__ bool trigger_flush(Buckets& s, int b, int lane) {
  const int fill = s.fill[b];
  if (fill <= 0) return true;
  if (s.len >= s.Q) return false;
  int slot = s.head + s.len;
  if (slot >= s.Q) slot -= s.Q;
  for (int j = lane; j < s.C; j += 32)
    s.qev[slot * s.C + j] = s.store[b * s.C + j];
  __syncwarp();                      // every lane has read fill[b]
  if (lane == 0) {
    s.qdest[slot] = s.bdest[b];
    s.qcount[slot] = fill;
    s.fill[b] = 0;
    s.dl[b] = kBig;
  }
  s.len += 1;
  __syncwarp();
  return true;
}

// One event: returns the bucket that just filled (or kNone); adds a stall.
__device__ int accept_event(Buckets& s, int word, int dest, int n_dest,
                            int now, int lane, int* stalled) {
  if (!((word & kValidBit) != 0 && dest >= 0)) return kNone;
  const int dest_c = min(dest, n_dest - 1);
  int tgt = s.map[dest_c];
  if (tgt == kNone) {
    int free_b = kNone;
    for (int base = 0; base < s.B; base += 32) {
      const int b = base + lane;
      const unsigned m = __ballot_sync(kFull, b < s.B && s.bdest[b] == kNone);
      if (m != 0u) { free_b = base + __ffs(m) - 1; break; }
    }
    if (free_b != kNone) {
      tgt = free_b;
    } else {
      int u;
      const int victim = most_urgent(s, now, lane, &u);
      if (!trigger_flush(s, victim, lane)) { *stalled += 1; return kNone; }
      if (lane == 0) {                               // unbind the victim
        const int old = s.bdest[victim];
        if (old >= 0) s.map[old] = kNone;
      }
      tgt = victim;
    }
    __syncwarp();                    // every lane has read map[dest_c]
    if (lane == 0) {                                 // bind
      s.map[dest_c] = tgt;
      s.bdest[tgt] = dest_c;
    }
    __syncwarp();
  }
  const int fill = s.fill[tgt];
  const int ts = word & kTsMask;
  const int cur = s.dl[tgt];
  __syncwarp();
  if (lane == 0) {
    s.store[tgt * s.C + min(fill, s.C - 1)] = word;   // clipped append
    s.fill[tgt] = fill + 1;
    if (cur == kBig || ((ts - (cur & kTsMask)) & kTsMask) > (kTsMask >> 1))
      s.dl[tgt] = ts;
  }
  __syncwarp();
  return fill + 1 >= s.C ? tgt : kNone;
}

__global__ void __launch_bounds__(32) bucket_trace_kernel(
    const int32_t* __restrict__ words, const int32_t* __restrict__ dests,
    int32_t* __restrict__ out_scalars, int32_t* __restrict__ out_events,
    int32_t* st_map, int32_t* st_bdest, int32_t* st_fill, int32_t* st_dl,
    int32_t* st_store, int32_t* st_qdest, int32_t* st_qcount,
    int32_t* st_qev, int32_t* st_qlen, int32_t* st_busy, int32_t* st_now,
    int T, int E, int n_dest, int B, int C, int Q, int margin) {
  extern __shared__ int32_t sm[];
  const int lane = threadIdx.x;
  Buckets s;
  s.map = sm;
  s.bdest = s.map + n_dest;
  s.fill = s.bdest + B;
  s.dl = s.fill + B;
  s.store = s.dl + B;
  s.qdest = s.store + B * C;
  s.qcount = s.qdest + Q;
  s.qev = s.qcount + Q;
  s.B = B;
  s.C = C;
  s.Q = Q;
  s.head = 0;
  s.len = 0;
  for (int i = lane; i < n_dest; i += 32) s.map[i] = kNone;
  for (int b = lane; b < B; b += 32) {
    s.bdest[b] = kNone;
    s.fill[b] = 0;
    s.dl[b] = kBig;
  }
  for (int i = lane; i < B * C; i += 32) s.store[i] = 0;
  for (int i = lane; i < Q; i += 32) {
    s.qdest[i] = kNone;
    s.qcount[i] = 0;
  }
  for (int i = lane; i < Q * C; i += 32) s.qev[i] = 0;
  __syncwarp();

  int busy = 0, now = 0;
  int32_t* o_dest = out_scalars;
  int32_t* o_count = out_scalars + T;
  int32_t* o_stalled = out_scalars + 2 * static_cast<int64_t>(T);
  int32_t* o_miss = out_scalars + 3 * static_cast<int64_t>(T);
  for (int t = 0; t < T; ++t) {
    const int64_t base = static_cast<int64_t>(t) * E;
    int stalled = 0, my_full = kNone;
    for (int i = 0; i < E; ++i) {
      const int fb = accept_event(s, words[base + i], dests[base + i],
                                  n_dest, now, lane, &stalled);
      if (lane == i) my_full = fb;
    }
    for (int i = 0; i < E; ++i) {                    // full buckets, in order
      const int fb = __shfl_sync(kFull, my_full, i);
      if (fb >= 0) trigger_flush(s, fb, lane);
    }
    int u;
    const int mu = most_urgent(s, now, lane, &u);
    if (u <= margin) trigger_flush(s, mu, lane);     // deadline flush

    int32_t* row = out_events + static_cast<int64_t>(t) * C;
    int sent_dest = kNone, sent_count = 0, miss = 0;
    if (busy <= 0 && s.len > 0) {                    // start the next packet
      sent_dest = s.qdest[s.head];
      sent_count = s.qcount[s.head];
      const int nowm = now & kTsMask;
      for (int j0 = 0; j0 < C; j0 += 32) {
        const int j = j0 + lane;
        bool late = false;
        if (j < C) {
          const int w = s.qev[s.head * C + j];
          row[j] = w;
          late = j < sent_count && ts_slack(w & kTsMask, nowm) < 0;
        }
        miss += __popc(__ballot_sync(kFull, late));
      }
      s.head = s.head + 1 == Q ? 0 : s.head + 1;
      s.len -= 1;
      busy = wire_cycles(sent_count);
    } else {
      for (int j = lane; j < C; j += 32) row[j] = 0;
    }
    if (lane == 0) {
      o_dest[t] = sent_dest;
      o_count[t] = sent_count;
      o_stalled[t] = stalled;
      o_miss[t] = miss;
    }
    busy = max(busy - 1, 0);
    now += 1;
    __syncwarp();
  }

  // the final state, the queue in the reference's order
  for (int i = lane; i < n_dest; i += 32) st_map[i] = s.map[i];
  for (int b = lane; b < B; b += 32) {
    st_bdest[b] = s.bdest[b];
    st_fill[b] = s.fill[b];
    st_dl[b] = s.dl[b];
  }
  for (int i = lane; i < B * C; i += 32) st_store[i] = s.store[i];
  for (int i = 0; i < Q; ++i) {
    int p = s.head + i;
    if (p >= Q) p -= Q;
    const bool live = i < s.len;
    if (lane == 0) {
      st_qdest[i] = live ? s.qdest[p] : kNone;
      st_qcount[i] = live ? s.qcount[p] : 0;
    }
    for (int j = lane; j < C; j += 32)
      st_qev[i * C + j] = live ? s.qev[p * C + j] : 0;
  }
  if (lane == 0) {
    *st_qlen = s.len;
    *st_busy = busy;
    *st_now = now;
  }
}

__global__ void ring_run_kernel(const int32_t* __restrict__ want,
                                int32_t* __restrict__ out, int steps,
                                int size, int L, int batch, int rate) {
  extern __shared__ int32_t sm[];
  int32_t* pending = sm;        // (L) ring, logical slot i at (head + i) % L
  int32_t* data = sm + L;       // (size)
  for (int i = 0; i < L; ++i) pending[i] = 0;
  for (int i = 0; i < size; ++i) data[i] = 0;
  int wr = 0, rd = 0, credits = size, unnot = 0, head = 0;
  int produced = 0, consumed = 0, stalls = 0;
  for (int t = 0; t < steps; ++t) {
    const int w = want[t];
    const int can = min(w, credits);                 // producer
    if (can > 0) data[wr % size] = 1;
    wr += can;
    credits -= can;
    const int take = min(rate, wr - rd);             // consumer
    rd += take;
    unnot += take;
    const int notify = (unnot / batch) * batch;
    unnot -= notify;
    const int tail = head == 0 ? L - 1 : head - 1;
    pending[tail] += notify;
    credits += pending[head];                        // tick
    pending[head] = 0;
    head = head + 1 == L ? 0 : head + 1;
    produced += can;
    consumed += take;
    stalls += w - can;
  }
  out[0] = wr;
  out[1] = rd;
  out[2] = credits;
  out[3] = unnot;
  out[4] = produced;
  out[5] = consumed;
  out[6] = stalls;
  for (int i = 0; i < L; ++i) {
    int p = head + i;
    if (p >= L) p -= L;
    out[7 + i] = pending[p];
  }
  for (int i = 0; i < size; ++i) out[7 + L + i] = data[i];
}

}  // namespace

extern "C" int repro_bucket_trace(
    const void* words, const void* dests, void* out_scalars, void* out_events,
    void* st_map, void* st_bdest, void* st_fill, void* st_dl, void* st_store,
    void* st_qdest, void* st_qcount, void* st_qev, void* st_qlen,
    void* st_busy, void* st_now, int T, int E, int n_dest, int B, int C,
    int Q, int margin, void* stream) {
  if (E < 0 || E > 32 || n_dest < 1 || B < 1 || C < 1 || Q < 1 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int32_t) *
      (static_cast<size_t>(n_dest) + 3 * static_cast<size_t>(B) +
       static_cast<size_t>(B) * C + 2 * static_cast<size_t>(Q) +
       static_cast<size_t>(Q) * C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bucket_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bucket_trace_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(dests),
      static_cast<int32_t*>(out_scalars), static_cast<int32_t*>(out_events),
      static_cast<int32_t*>(st_map), static_cast<int32_t*>(st_bdest),
      static_cast<int32_t*>(st_fill), static_cast<int32_t*>(st_dl),
      static_cast<int32_t*>(st_store), static_cast<int32_t*>(st_qdest),
      static_cast<int32_t*>(st_qcount), static_cast<int32_t*>(st_qev),
      static_cast<int32_t*>(st_qlen), static_cast<int32_t*>(st_busy),
      static_cast<int32_t*>(st_now), T, E, n_dest, B, C, Q, margin);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_ring_run(const void* want, void* out, int steps,
                              int size, int L, int batch, int rate,
                              void* stream) {
  if (size < 1 || L < 1 || batch < 1 || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int32_t) * (static_cast<size_t>(L) + size);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ring_run_kernel<<<1, 1, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(want), static_cast<int32_t*>(out), steps,
      size, L, batch, rate);
  return static_cast<int>(cudaGetLastError());
}
