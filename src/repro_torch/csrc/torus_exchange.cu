// The healthy torus exchange after admission, for Hopper (sm_90a): kernel H,
// the exchange epilogue, and the ring rotation it shares with every healthy
// caller of TorusTransport._rotate.
//
// No TPU kernel corresponds to it.  The reference computes the same window
// with a chain of array operations: src/repro/transport/torus.py's ring
// phases (ppermute along each torus axis), the LinkStats sums and the row
// delivery after _admit_tenants.  The plain PyTorch version is the eager
// chain of src/repro_torch/transport/torus.py: TorusTransport._rotate /
// _ring_phase and TenantTorusTransport.exchange; it runs on CPU tensors and,
// on the card, under a dead-link mask (whose ring phases flip bundles and
// run n - 1 hops), which this file does not take.
//
// The rotation (torus_rotate_kernel, entry repro_torus_rotate; and inside
// kernel H).  The eager chain replays each dimension-ordered phase on the
// (S, S, E) [src, dst, e] counts: every holder seeds a + bundle (targets
// 1 .. n/2 ahead on its axis-a ring) and a - bundle (1 .. (n-1)/2 behind),
// each ships one neighbour a hop, and the holder at the target absorbs its
// entry.  Per holder it sums the packet-model bytes (core.aggregator.
// window_cost) and the frame bytes (wire.framing.frame_bytes) of what it
// holds before each hop, counts hops, and keeps the largest occupancy after
// each absorption, over the window and per phase.  Here each holder is one
// thread that computes the same sums in closed form: before hop h of the +
// direction holder p holds the bundle of origin p - (h - 1) with its
// entries at ring distance h .. n/2 still in it, after the hop the bundle
// of origin p - h with distances h + 1 .. n/2 (the - direction mirrors
// it).  The phase-a buffer is the counts with the first a axes swapped
// between holder and row, so the entry is read from the counts by index.
// Integer sums and maxima do not depend on their order, so every field is
// the eager one bit for bit.  A healthy rotation delivers every row to its
// destination, so the delivered counts are the column sums of the counts.
//
// Kernel H (tenant_exchange_kernel, entry repro_tenant_exchange) runs after
// kernel F's tenant form (csrc/admission.cu) in the same stream and reads
// F's packed outputs as they are.  One block:
//   1. per row (s, t, d): the shipped count (fresh completions and local
//      rows ship the caller's row, resumed rows the fabric's custody copy),
//      the delivered row [d, t, s] with its count column, the new transit
//      buffer's row, the custody masks, the unparked events, queue_us and
//      park_wait_us; per credit slot the bank's tick (credits, delay line,
//      epoch);
//   2. per (shard, tenant): every LinkStats sum over the destinations; per
//      holder: the rotation of the shipped counts with one count column per
//      tenant, its fabric-level fields on tenant 0; per (dst, tenant): the
//      delivered events.
// The floats are computed in f32 in the eager chain's order: queue_us and
// park_wait_us as frame bytes times the reciprocal of the link's bytes per
// us (PyTorch divides a CUDA tensor by a host scalar that way), the dwell a
// sum over the destinations from the first to the last.
//
// Bound on an H100: neither bytes (~150 KB in and out at the serving
// cells' shapes, 0.04 us at 3.35 TB/s) nor operations.  One block walks
// short loops of dependent global loads (a shard's S destinations, a
// holder's hops); loops that do not depend on each other start on
// different warps (lane_from).  What the window waits for is the host:
// the two launches replace ~450 host-issued ATen calls a window.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// core/events.py: the Extoll packet model of core.aggregator.window_cost
constexpr int kPacketMaxEvents = 124;
constexpr int kDeserialGroup = 4;
constexpr int kEventBytes = 4;
constexpr int kPacketHeaderBytes = 16;

// kernel F's output rows (kernels/admission.py: _TENANT_I32_FIELDS,
// _BOOL_FIELDS, _LINK_FIELDS)
enum { kResumeAge, kStallHop, kParkCount, kParkHop, kParkAge, kTraversed,
       kQueue, kRerouted, kLinksDone, kHoldShared };
enum { kFreshComplete, kFreshPark, kResumedComplete };
enum { kSpent, kNotify, kParkedByLink };

// rows of H's (13, S, T) block of per-shard sums
// (kernels/torus_exchange.py: SHARD_FIELDS)
enum { sOffered, sSent, sDeferred, sDelivered, sCreditStalls, sHops,
       sForwardedBytes, sBytesOnWire, sMaxInFlight, sParked, sUnparked,
       sInFabric, sRerouted, kShardFields };

// wire.framing.WireFormat's geometry
struct Wire {
  int epf, mtu_payload, cell_bytes, header_bytes, crc_bytes, min_frame_bytes,
      gap_bytes, word_bytes;
};

struct Torus {
  int ndim, n;
  int dims[3], stride[3];
};

// (S, S, E) [src, dst, e] int32 counts with any strides
struct Counts {
  const int32_t* p;
  int64_t ss, sd, se;
  int E;
  __device__ int operator()(int src, int dst, int e) const {
    return p[src * ss + dst * sd + e * se];
  }
};

__device__ __forceinline__ int packet_bytes(int n) {
  return n > 0 ? (n + kDeserialGroup - 1) / kDeserialGroup * kDeserialGroup
                     * kEventBytes + kPacketHeaderBytes
               : 0;
}

// one count's share of window_cost(...).bytes
__device__ __forceinline__ int window_bytes(int c) {
  return c / kPacketMaxEvents * packet_bytes(kPacketMaxEvents)
         + packet_bytes(c % kPacketMaxEvents);
}

__device__ __forceinline__ int frame_wire_bytes(const Wire& w, int payload) {
  const int cells = (payload + w.cell_bytes - 1) / w.cell_bytes
                    * w.cell_bytes;
  return max(cells + w.header_bytes + w.crc_bytes, w.min_frame_bytes)
         + w.gap_bytes;
}

__device__ __forceinline__ int frame_bytes(const Wire& w, int n) {
  const int rem = n % w.epf;
  return n / w.epf * frame_wire_bytes(w, w.mtu_payload)
         + (rem > 0 ? frame_wire_bytes(w, rem * w.word_bytes) : 0);
}

__device__ __forceinline__ int coord(const Torus& t, int x, int a) {
  return x / t.stride[a] % t.dims[a];
}

// the shard j steps along p's axis-a ring
__device__ __forceinline__ int ring(const Torus& t, int p, int a, int j) {
  const int n = t.dims[a], c = coord(t, p, a);
  return p + (((c + j) % n + n) % n - c) * t.stride[a];
}

// Sums over origin o's phase-a bundle entries at ring distance f (target
// coordinate c_o + f): packet bytes, frame bytes and events, over the
// other row coordinates and the count columns.
struct Sums {
  int bytes, owire, events;
};

__device__ Sums bundle_entry(const Torus& t, const Counts& c, const Wire& w,
                             int a, int o, int f) {
  const int n = t.dims[a], st = t.stride[a];
  const int k = ((coord(t, o, a) + f) % n + n) % n;
  Sums s{0, 0, 0};
  for (int b = 0; b < t.n / n; ++b) {
    // row with axis-a coordinate k and the other coordinates b
    const int r = b % st + b / st * st * n + k * st;
    // phase a's buffer: axes below a swapped between holder and row
    int src = 0, dst = 0;
    for (int i = 0; i < t.ndim; ++i) {
      const bool done = i < a;
      src += coord(t, done ? r : o, i) * t.stride[i];
      dst += coord(t, done ? o : r, i) * t.stride[i];
    }
    for (int e = 0; e < c.E; ++e) {
      const int v = c(src, dst, e);
      s.bytes += window_bytes(v);
      s.owire += frame_bytes(w, v);
      s.events += v;
    }
  }
  return s;
}

struct HolderStats {
  int bytes, owire, in_flight;
  int in_flight_phase[3];
};

// Every phase's hops as seen by holder p (the eager _ring_phase's acc).
__device__ HolderStats rotate_holder(const Torus& t, const Counts& c,
                                     const Wire& w, int p) {
  HolderStats hs{0, 0, 0, {0, 0, 0}};
  for (int a = 0; a < t.ndim; ++a) {
    const int n = t.dims[a];
    for (int dir = 0; dir < 2; ++dir) {
      // +: distances 1 .. n/2 ahead; -: 1 .. (n-1)/2 behind
      const int hops = dir == 0 ? n / 2 : (n - 1) / 2;
      const int sgn = dir == 0 ? 1 : -1;
      for (int h = 1; h <= hops; ++h) {
        const int o_send = ring(t, p, a, -sgn * (h - 1));
        for (int g = h; g <= hops; ++g) {
          const Sums s = bundle_entry(t, c, w, a, o_send, sgn * g);
          hs.bytes += s.bytes;
          hs.owire += s.owire;
        }
        const int o_recv = ring(t, p, a, -sgn * h);
        int occ = 0;
        for (int g = h + 1; g <= hops; ++g)
          occ += bundle_entry(t, c, w, a, o_recv, sgn * g).events;
        hs.in_flight = max(hs.in_flight, occ);
        hs.in_flight_phase[a] = max(hs.in_flight_phase[a], occ);
      }
    }
  }
  return hs;
}

// Loops that run side by side start on different warps: the thread that
// takes index 0 is ``offset`` threads along the block (every index is
// still taken once).
__device__ __forceinline__ int lane_from(int tid, int offset) {
  const int n = blockDim.x;
  return (tid + n - offset % n) % n;
}

__device__ __forceinline__ int total_hops(const Torus& t) {
  int h = 0;
  for (int a = 0; a < t.ndim; ++a) h += t.dims[a] / 2 + (t.dims[a] - 1) / 2;
  return h;
}

__global__ void __launch_bounds__(kThreads)
    torus_rotate_kernel(Counts c, Torus t, Wire w,
                        int32_t* __restrict__ bytes,
                        int32_t* __restrict__ owire,
                        int32_t* __restrict__ hops,
                        int32_t* __restrict__ in_flight,
                        int32_t* __restrict__ in_flight_phase,
                        int32_t* __restrict__ delivered) {
  const int hop_count = total_hops(t);
  for (int p = threadIdx.x; p < t.n; p += blockDim.x) {
    const HolderStats hs = rotate_holder(t, c, w, p);
    bytes[p] = hs.bytes;
    owire[p] = hs.owire;
    hops[p] = hop_count;
    in_flight[p] = hs.in_flight;
    for (int a = 0; a < t.ndim; ++a)
      in_flight_phase[p * t.ndim + a] = hs.in_flight_phase[a];
  }
  for (int i = lane_from(threadIdx.x, 128); i < t.n * c.E;
       i += blockDim.x) {
    const int d = i / c.E, e = i % c.E;
    int sum = 0;
    for (int s = 0; s < t.n; ++s) sum += c(s, d, e);
    delivered[i] = sum;
  }
}

struct TenantIn {
  const int32_t* counts;    // (S, T, S) [src, tenant, dst]
  const int32_t* payload;   // (S, T, S, W)
  const int32_t* pc0;       // (T, S, S) parked counts before the window
  const int32_t* ppay0;     // (S, T, S, W) transit buffer before the window
  const int32_t* credits;   // (T+1)K
  const int32_t* pending;   // ((T+1)K, L)
  const int32_t* epoch;     // ()
  const int32_t* f_i32;     // kernel F's (10, T, S, S)
  const bool* f_bool;       // (3, T, S, S)
  const int32_t* f_links;   // (3, (T+1)K)
};

struct TenantOut {
  int32_t* recv;            // (S, T, S, W + 1) [dst, tenant, src], count last
  int32_t* ppay;            // (S, T, S, W)
  int32_t* unparked;        // (S, T, S)
  int32_t* shard;           // (13, S, T)
  int32_t* hists;           // (2, S, T, H): stalled_by_hop, parked_by_hop
  int32_t* phase;           // (S, T, ndim)
  int32_t* credits;         // (T+1)K
  int32_t* pending;         // ((T+1)K, L)
  int32_t* epoch;           // ()
  float* us;                // (2, T, S, S): queue_us, park_wait_us
  float* dwell;             // (S, T)
  bool* masks;              // (2, S, T, S): sent_mask, sent_now
};

__global__ void __launch_bounds__(kThreads)
    tenant_exchange_kernel(TenantIn in, TenantOut out, Torus t, Wire w,
                           int T, int W, int H, int L, int link_credits,
                           float inv_bytes_per_us) {
  const int S = t.n, tid = threadIdx.x, nth = blockDim.x;
  const int R = S * S, R3 = T * R, TK = (T + 1) * S * 2 * t.ndim;
  __shared__ unsigned long long s_spent;
  if (tid == 0) s_spent = 0;
  __syncthreads();

  // 1. rows, words, credit slots
  const int32_t* f_pc = in.f_i32 + kParkCount * R3;
  for (int i = tid; i < R3; i += nth) {
    const int s = i / (T * S), tt = i / S % T, d = i % S;
    const int f = (tt * S + s) * S + d;            // F's [tenant, src, dst]
    const int c = in.counts[i];
    const bool fc = in.f_bool[kFreshComplete * R3 + f];
    const bool fp = in.f_bool[kFreshPark * R3 + f];
    const bool rs = in.f_bool[kResumedComplete * R3 + f];
    const bool local = s == d;
    const int pc = in.pc0[f];
    const bool ship = fc || (local && c > 0);
    out.recv[((d * T + tt) * S + s) * (W + 1) + W] =
        (ship ? c : 0) + (rs ? pc : 0);
    out.masks[i] = fc || fp || local || c == 0;
    out.masks[R3 + i] = fc || local || c == 0;
    out.unparked[i] = rs ? pc : 0;
    out.us[f] = static_cast<float>(
        frame_bytes(w, in.f_i32[kQueue * R3 + f])) * inv_bytes_per_us;
    out.us[R3 + f] = static_cast<float>(frame_bytes(
        w, in.f_i32[kResumeAge * R3 + f] * link_credits)) * inv_bytes_per_us;
  }
  for (int64_t j = tid; j < static_cast<int64_t>(R3) * W; j += nth) {
    const int i = static_cast<int>(j / W), x = static_cast<int>(j % W);
    const int s = i / (T * S), tt = i / S % T, d = i % S;
    const int f = (tt * S + s) * S + d;
    const bool fc = in.f_bool[kFreshComplete * R3 + f];
    const bool fp = in.f_bool[kFreshPark * R3 + f];
    const bool rs = in.f_bool[kResumedComplete * R3 + f];
    const bool ship = fc || (s == d && in.counts[i] > 0);
    const int fresh = in.payload[j], held = in.ppay0[j];
    out.recv[((d * T + tt) * S + s) * (W + 1) + x] =
        rs ? held : (ship ? fresh : 0);
    out.ppay[j] = fp ? fresh : held;
  }
  long long spent_sum = 0;
  for (int k = lane_from(tid, 128); k < TK; k += nth) {
    const int spent = in.f_links[kSpent * TK + k];
    const int notify = in.f_links[kNotify * TK + k];
    const int arrived = L > 0 ? in.pending[k * L] : notify;
    out.credits[k] = in.credits[k] - spent + arrived;
    for (int j = 0; j < L; ++j)
      out.pending[k * L + j] = j + 1 < L ? in.pending[k * L + j + 1] : notify;
    spent_sum += spent;
  }
  atomicAdd(&s_spent, static_cast<unsigned long long>(spent_sum));
  __syncthreads();                 // the shipped counts and the spent sum

  // 2. per-shard sums, the rotation, delivered events
  if (tid == 0)
    out.epoch[0] = in.epoch[0]
                   + (static_cast<long long>(s_spent) > 0 ? 1 : 0);
  const int32_t* f_ph = in.f_i32 + kParkHop * R3;
  for (int q = tid; q < S * T; q += nth) {
    const int s = q / T, tt = q % T;
    int offered = 0, sent = 0, parked = 0, stalls = 0, unparked = 0;
    int owire = 0, in_fabric = 0, rerouted = 0;
    int32_t* stall_h = out.hists + q * H;
    int32_t* park_h = out.hists + (S * T + q) * H;
    for (int h = 0; h < H; ++h) stall_h[h] = park_h[h] = 0;
    float dwell = 0.f;
    for (int d = 0; d < S; ++d) {
      const int i = (s * T + tt) * S + d, f = (tt * S + s) * S + d;
      const int c = in.counts[i];
      const bool fc = in.f_bool[kFreshComplete * R3 + f];
      const bool fp = in.f_bool[kFreshPark * R3 + f];
      const bool rs = in.f_bool[kResumedComplete * R3 + f];
      const int stall = in.f_i32[kStallHop * R3 + f];
      offered += c;
      sent += out.masks[R3 + i] ? c : 0;
      parked += fp ? c : 0;
      stalls += stall >= 0 ? 1 : 0;
      unparked += out.unparked[i];
      stall_h[min(max(stall, 0), H - 1)] += stall >= 0 ? c : 0;
      park_h[min(max(f_ph[f], 0), H - 1)] += f_pc[f];
      owire += frame_bytes(w, rs ? in.pc0[f] : c)
               * in.f_i32[kTraversed * R3 + f];
      const float v = (fc || rs) ? out.us[f] + out.us[R3 + f] : 0.f;
      dwell = d == 0 ? v : dwell + v;
      in_fabric += f_pc[f];
      rerouted += in.f_i32[kRerouted * R3 + f];
    }
    int32_t* sh = out.shard;
    sh[sOffered * S * T + q] = offered;
    sh[sSent * S * T + q] = sent;
    sh[sDeferred * S * T + q] = offered - sent - parked;
    sh[sCreditStalls * S * T + q] = stalls;
    sh[sBytesOnWire * S * T + q] = owire;
    sh[sParked * S * T + q] = parked;
    sh[sUnparked * S * T + q] = unparked;
    sh[sInFabric * S * T + q] = in_fabric;
    sh[sRerouted * S * T + q] = rerouted;
    out.dwell[q] = dwell;
  }
  // the shipped counts as (S, S, T) [src, dst, tenant]
  const Counts cin{out.recv + W, W + 1, static_cast<int64_t>(T) * S * (W + 1),
                   static_cast<int64_t>(S) * (W + 1), T};
  const int hop_count = total_hops(t);
  for (int p = lane_from(tid, 64); p < S; p += nth) {
    const HolderStats hs = rotate_holder(t, cin, w, p);
    for (int tt = 0; tt < T; ++tt) {
      const int q = p * T + tt;
      const bool t0 = tt == 0;
      out.shard[sHops * S * T + q] = t0 ? hop_count : 0;
      out.shard[sForwardedBytes * S * T + q] = t0 ? hs.bytes : 0;
      out.shard[sMaxInFlight * S * T + q] = t0 ? hs.in_flight : 0;
      for (int a = 0; a < t.ndim; ++a)
        out.phase[q * t.ndim + a] = t0 ? hs.in_flight_phase[a] : 0;
    }
  }
  for (int q = lane_from(tid, 128); q < S * T; q += nth) {
    const int d = q / T, tt = q % T;
    int sum = 0;
    for (int s = 0; s < S; ++s) sum += cin(s, d, tt);
    out.shard[sDelivered * S * T + q] = sum;
  }
}

Torus make_torus(int ndim, int d0, int d1, int d2) {
  Torus t{ndim, 1, {d0, d1, d2}, {1, 1, 1}};
  for (int a = 0; a < ndim; ++a) {
    t.stride[a] = t.n;
    t.n *= t.dims[a];
  }
  return t;
}

}  // namespace

extern "C" int repro_torus_rotate(
    const void* cnt, int64_t ss, int64_t sd, int64_t se, int E, int ndim,
    int d0, int d1, int d2, int epf, int mtu_payload, int cell_bytes,
    int header_bytes, int crc_bytes, int min_frame_bytes, int gap_bytes,
    int word_bytes, void* bytes, void* owire, void* hops, void* in_flight,
    void* in_flight_phase, void* delivered, void* stream) {
  if (ndim < 1 || ndim > 3 || E < 1 || epf < 1 || cell_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Torus t = make_torus(ndim, d0, d1, d2);
  const Counts c{static_cast<const int32_t*>(cnt), ss, sd, se, E};
  const Wire w{epf, mtu_payload, cell_bytes, header_bytes, crc_bytes,
               min_frame_bytes, gap_bytes, word_bytes};
  torus_rotate_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, t, w, static_cast<int32_t*>(bytes), static_cast<int32_t*>(owire),
      static_cast<int32_t*>(hops), static_cast<int32_t*>(in_flight),
      static_cast<int32_t*>(in_flight_phase),
      static_cast<int32_t*>(delivered));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_tenant_exchange(
    const void* counts, const void* payload, const void* pc0,
    const void* ppay0, const void* credits, const void* pending,
    const void* epoch, const void* f_i32, const void* f_bool,
    const void* f_links, void* recv, void* ppay, void* unparked, void* shard,
    void* hists, void* phase, void* credits_out, void* pending_out,
    void* epoch_out, void* us, void* dwell, void* masks, int T, int W, int H,
    int L, int link_credits, float inv_bytes_per_us, int ndim, int d0, int d1,
    int d2, int epf, int mtu_payload, int cell_bytes, int header_bytes,
    int crc_bytes, int min_frame_bytes, int gap_bytes, int word_bytes,
    void* stream) {
  if (ndim < 1 || ndim > 3 || T < 1 || W < 0 || H < 1 || L < 0 || epf < 1
      || cell_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Torus t = make_torus(ndim, d0, d1, d2);
  const Wire w{epf, mtu_payload, cell_bytes, header_bytes, crc_bytes,
               min_frame_bytes, gap_bytes, word_bytes};
  const TenantIn in{
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(payload),
      static_cast<const int32_t*>(pc0), static_cast<const int32_t*>(ppay0),
      static_cast<const int32_t*>(credits),
      static_cast<const int32_t*>(pending), static_cast<const int32_t*>(epoch),
      static_cast<const int32_t*>(f_i32), static_cast<const bool*>(f_bool),
      static_cast<const int32_t*>(f_links)};
  const TenantOut out{
      static_cast<int32_t*>(recv), static_cast<int32_t*>(ppay),
      static_cast<int32_t*>(unparked), static_cast<int32_t*>(shard),
      static_cast<int32_t*>(hists), static_cast<int32_t*>(phase),
      static_cast<int32_t*>(credits_out), static_cast<int32_t*>(pending_out),
      static_cast<int32_t*>(epoch_out), static_cast<float*>(us),
      static_cast<float*>(dwell), static_cast<bool*>(masks)};
  tenant_exchange_kernel<<<1, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      in, out, t, w, T, W, H, L, link_credits, inv_bytes_per_us);
  return static_cast<int>(cudaGetLastError());
}
