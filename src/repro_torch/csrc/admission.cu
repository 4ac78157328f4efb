// The credited torus's admission replay, healthy and faulted, for Hopper
// (sm_90a): kernel F.
//
// No TPU kernel corresponds to it.  The reference replays one window's
// admission with lax.scan: src/repro/transport/torus.py _admit_global
// (:387) and, under a dead-link mask, _admit_global_faulted (:528).  The
// plain PyTorch versions are admission_plain and admission_faulted_plain in
// src/repro_torch/kernels/admission.py; without a mask this kernel is the
// healthy replay (default routes, no flip, no eviction).
//
// What it computes, for one window of an n-shard torus with K = n * 2 * ndim
// directed egress links: every AdmissionOut field.  The n^2 rows (src, dst)
// are taken source-major with the sources rotated by the bank's epoch.
// Phase A resumes every parked row (from its blocked hop on the default
// route, or, evicted, from hop 0 on its detour); phase B offers every fresh
// row.  A row crosses the hops whose links still hold its count in credits
// and stops at the first short one; a row on a detour completes or stays
// put.  Each row's spends, notifies and holds change the credits the next
// row reads: the replay is a chain of up to 2 n^2 dependent steps, one for
// each row with work (a local row has no links, and an empty one spends,
// notifies and holds nothing).
//
// Design.  One thread block.  First, everything without a chain, in
// parallel over the rows: the per-axis reroute decision (a short arc
// crossing a dead link with a clean long arc flips the axis; both arcs dead
// leaves the row unroutable), the eviction set and the queue snapshot; the
// per-link running state (remaining credits, notifies, holds, the egress
// links a deferral blocked) goes into shared memory.  Then one warp walks
// the rows in order, one lane per hop (at most 32): each lane reads its
// hop's remaining credits, the first short hop is __ballot_sync + __ffs,
// and the lanes of the traversed hops update their links.  All reads of a
// row come before its writes, as in the reference.  Updates are shared
// atomicAdds: the release of an evicted row's old hold may fall on a link
// that its detour also crosses, and the reference adds both.
//
// Bound on an H100: the chain.  The bytes are a few tens of KB (tables,
// transit tables, counts in; the outputs out), nanoseconds at 3.35 TB/s;
// the chain's dependent steps each need at least one shared-memory round
// trip.
//
// The tenant form (admission_tenants_kernel, entry repro_admission_tenants)
// replays the multi-tenant fabric: reference _admit_tenants (:1322) and
// _admit_tenants_faulted (:1503), plain versions admission_tenants_plain and
// admission_tenants_faulted_plain.  T tenants share the physical links; the
// bank has (T + 1) * K slots, slot t * K + l tenant t's slice of link l and
// T * K + l link l's shared pool.  Rows (t, src, dst) go in a round robin
// over the combined (tenant, source) index rotated by the epoch.  A lane
// reads its hop's two slots; the link is short when slice + pool are below
// the count, and a traversed hop spends reserved-first (min(c, slice) from
// the slice, the rest from the pool), holds split the same way and the
// shared part of a hold is kept per row (hold_shared), so a departing row
// refunds each slot what it took.  Head-of-line blocking is per (tenant,
// egress link).  The design is the single-tenant one; it stays a separate
// kernel so that the single-tenant replay is untouched.
//
// The stall lane (both kernels, when out_stall is not null): the deferred
// events of the window per physical egress link, the flight recorder's
// per-link congestion table (reference _stall_attr, torus.py:338).  A
// deferred row's count is blamed on the first hop of its healthy route
// (combo 0), also under a mask, and a local row adds nothing; in the tenant
// form every tenant's row of a pair blames the same physical link.  Lane 0
// adds the count to a shared (K,) table with an integer atomicAdd (exact,
// so the table does not depend on the order), and the warp writes it out
// after phase B: the same launch, no pass after it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// int32 output rows (kernels/admission.py: _I32_FIELDS), bool rows
// (_BOOL_FIELDS), per-link rows (_LINK_FIELDS)
enum { kResumeAge, kStallHop, kParkCount, kParkHop, kParkAge, kTraversed,
       kQueue, kRerouted, kLinksDone };
enum { kFreshComplete, kFreshPark, kResumedComplete };
enum { kSpent, kNotify, kParkedByLink };

// per-row flags of the parallel phase
constexpr int kCombo = 7;          // bit a: axis a walks the long way
constexpr int kRoutable = 8;
constexpr int kEvicted = 16;

__device__ __forceinline__ int first_set(unsigned mask, int none) {
  return mask ? __ffs(mask) - 1 : none;
}

// one row's change to a link's running state (-1, a padded hop, is link 0,
// as the reference's clamp makes it)
__device__ __forceinline__ void update(int32_t* s_rem, int32_t* s_notify,
                                       int32_t* s_pbl, int32_t link,
                                       int d_rem, int d_notify, int d_pbl) {
  const int l = link >= 0 ? link : 0;
  if (d_rem) atomicAdd(s_rem + l, d_rem);
  if (d_notify) atomicAdd(s_notify + l, d_notify);
  if (d_pbl) atomicAdd(s_pbl + l, d_pbl);
}

__global__ void __launch_bounds__(kThreads)
admission_kernel(const int32_t* __restrict__ counts,
                 const int32_t* __restrict__ pc0,
                 const int32_t* __restrict__ ph0,
                 const int32_t* __restrict__ pa0,
                 const int32_t* __restrict__ credits,
                 const int32_t* __restrict__ pbl0,
                 const int32_t* __restrict__ epoch_p,
                 const int32_t* __restrict__ seq_alt,
                 const int32_t* __restrict__ len_alt,
                 const int32_t* __restrict__ seg,
                 const bool* __restrict__ down, int32_t* __restrict__ out,
                 bool* __restrict__ out_bool, int32_t* __restrict__ out_links,
                 int32_t* __restrict__ out_stall, int n, int ndim, int H2,
                 int Hs) {
  extern __shared__ int32_t sm[];
  const int R = n * n;
  const int K = n * 2 * ndim;
  int32_t* s_rem = sm;
  int32_t* s_notify = s_rem + K;
  int32_t* s_pbl = s_notify + K;
  int32_t* s_blocked = s_pbl + K;
  int32_t* s_flag = s_blocked + K;
  int32_t* s_trav = s_flag + R;    // phase A's per-row terms, summed by B
  int32_t* s_rer = s_trav + R;
  int32_t* s_done = s_rer + R;
  int32_t* s_stall = out_stall != nullptr ? s_done + R : nullptr;  // (K,)

  for (int l = threadIdx.x; l < K; l += kThreads) {
    s_rem[l] = credits[l];
    s_notify[l] = 0;
    s_pbl[l] = pbl0[l];
    s_blocked[l] = 0;
    if (s_stall != nullptr) s_stall[l] = 0;
  }
  // everything without a chain: reroute, eviction, queue snapshot
  for (int r = threadIdx.x; r < R; r += kThreads) {
    int combo = 0;
    bool routable = true;
    if (down != nullptr) {
      for (int a = 0; a < ndim; ++a) {
        const int32_t* s = seg + (static_cast<int64_t>(a * 2) * R + r) * Hs;
        const int32_t* l = s + static_cast<int64_t>(R) * Hs;  // long arc
        bool short_dead = false, long_dead = false;
        for (int j = 0; j < Hs; ++j) {
          short_dead |= s[j] >= 0 && down[s[j]];
          long_dead |= l[j] >= 0 && down[l[j]];
        }
        if (short_dead && !long_dead) combo |= 1 << a;
        if (short_dead && long_dead) routable = false;
      }
    }
    const int32_t* s0 = seq_alt + static_cast<int64_t>(r) * H2;
    const int32_t* se = seq_alt + (static_cast<int64_t>(combo) * R + r) * H2;
    const int c = pc0[r];
    const int h = ph0[r];
    bool ev = false;
    if (down != nullptr && c > 0) {
      bool rem_dirty = false;
      for (int j = h; j < H2; ++j) rem_dirty |= s0[j] >= 0 && down[s0[j]];
      const int held = s0[h >= 1 ? h - 1 : 0];
      ev = h == 0 || rem_dirty || (h >= 1 && down[held >= 0 ? held : 0]);
    }
    // events parked along the route the row will take, from its start hop
    const int32_t* sq = c > 0 ? s0 : se;
    const int start = c > 0 && !ev ? h : 0;
    int q = 0;
    for (int j = start; j < H2; ++j)
      if (sq[j] >= 0) q += pbl0[sq[j]];
    out[kQueue * R + r] = q;
    s_flag[r] = combo | (routable ? kRoutable : 0) | (ev ? kEvicted : 0);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const bool on = lane < H2;
  const int epoch = *epoch_p;

  for (int i = 0; i < R; ++i) {               // phase A: resume
    const int r = ((i / n + epoch) % n) * n + i % n;
    const int c = pc0[r];
    const int h = ph0[r];
    const int flag = s_flag[r];
    const int combo = flag & kCombo;
    const bool ev = flag & kEvicted;
    const bool detour = combo != 0;
    const bool active = c > 0;
    const int32_t l0 = on ? seq_alt[static_cast<int64_t>(r) * H2 + lane] : -1;
    const int L = len_alt[r];
    const int64_t r2 = static_cast<int64_t>(combo) * R + r;
    const int32_t l2 = on ? seq_alt[r2 * H2 + lane] : -1;
    const int L2 = len_alt[r2];
    // branch 1: undisturbed resume on the default route
    const bool from_h = l0 >= 0 && lane >= h;
    const int h_new = first_set(
        __ballot_sync(kFull, from_h && s_rem[l0] < c), H2);
    const bool act1 = active && !ev;
    const bool complete1 = act1 && h_new >= L;
    const int h_stop1 = max(complete1 ? L : h_new, h);
    const bool moved1 = act1 && h_stop1 > h;
    const bool trav1 = from_h && lane < h_stop1 && act1;
    const bool hold1 = on && moved1 && !complete1 && lane == h_stop1 - 1;
    // branch 2: evicted retry from hop 0 on the detour route
    const bool act2 = active && ev && (flag & kRoutable);
    const int h_block = first_set(
        __ballot_sync(kFull, l2 >= 0 && s_rem[l2] < c), H2);
    const bool complete2 = act2 && h_block >= L2;
    const bool park2 = act2 && !detour && h_block < L2 && h_block >= 1;
    const int h_stop2 = complete2 ? L2 : (park2 ? h_block : 0);
    const bool trav2 = l2 >= 0 && lane < h_stop2;
    const bool hold2 = on && park2 && lane == h_stop2 - 1;
    const int n_trav = __popc(__ballot_sync(kFull, trav1))
                       + __popc(__ballot_sync(kFull, trav2));
    if (trav1 || hold1)
      update(s_rem, s_notify, s_pbl, l0, trav1 ? -c : 0,
             trav1 && !hold1 ? c : 0, hold1 ? c : 0);
    if (trav2 || hold2)
      update(s_rem, s_notify, s_pbl, l2, trav2 ? -c : 0,
             trav2 && !hold2 ? c : 0, hold2 ? c : 0);
    if (lane == 0) {
      // leaving (or being evicted from) the old park spot releases its
      // held arrival credit into the delay line
      if ((moved1 || (active && ev)) && h >= 1) {
        const int32_t oh = seq_alt[static_cast<int64_t>(r) * H2 + h - 1];
        update(s_rem, s_notify, s_pbl, oh, 0, c, -c);
      }
      const bool complete = complete1 || complete2;
      const bool keep = active && !complete;
      const int h_keep = ev ? (park2 ? h_block : 0) : h_stop1;
      const int age = pa0[r];
      out_bool[kResumedComplete * R + r] = complete;
      out[kResumeAge * R + r] = complete ? age : 0;
      out[kParkCount * R + r] = complete ? 0 : c;
      out[kParkHop * R + r] = keep ? h_keep : 0;
      out[kParkAge * R + r] = keep ? age + 1 : 0;
      s_trav[r] = n_trav;
      s_rer[r] = complete2 && detour ? c : 0;
      s_done[r] = (complete1 ? L : 0) + (complete2 ? L2 : 0);
    }
    __syncwarp();
  }

  for (int i = 0; i < R; ++i) {               // phase B: offer
    const int r = ((i / n + epoch) % n) * n + i % n;
    const int c = counts[r];
    const int flag = s_flag[r];
    const int combo = flag & kCombo;
    const bool routable = flag & kRoutable;
    const bool detour = combo != 0;
    const int64_t r2 = static_cast<int64_t>(combo) * R + r;
    const int32_t l = on ? seq_alt[r2 * H2 + lane] : -1;
    const int L = len_alt[r2];
    const int32_t fl = __shfl_sync(kFull, l, 0);
    const int first = fl >= 0 ? fl : 0;
    const bool has_first = fl >= 0 && c > 0;
    const int h_block = first_set(
        __ballot_sync(kFull, l >= 0 && s_rem[l] < c), H2);
    const bool ok = has_first && routable && pc0[r] <= 0
                    && s_blocked[first] == 0;
    const bool admit_c = ok && h_block >= L;
    // parking mid-route only on the default route
    const bool admit_p = ok && !detour && h_block < L && h_block >= 1;
    const bool defer = has_first && !admit_c && !admit_p;
    const int h_stop = admit_c ? L : (admit_p ? h_block : 0);
    const bool trav = l >= 0 && lane < h_stop;
    const bool hold = on && admit_p && lane == h_stop - 1;
    const int n_trav = __popc(__ballot_sync(kFull, trav));
    if (trav || hold)
      update(s_rem, s_notify, s_pbl, l, trav ? -c : 0,
             trav && !hold ? c : 0, hold ? c : 0);
    if (lane == 0) {
      // an unroutable row never reaches its egress FIFO: it blocks nothing
      if (defer && routable) s_blocked[first] = 1;
      if (defer && s_stall != nullptr) {
        // blame the healthy route's first hop (the row's own first hop
        // unless it detours: no load on the chain)
        const int32_t f0 =
            detour ? seq_alt[static_cast<int64_t>(r) * H2] : fl;
        if (f0 >= 0) atomicAdd(s_stall + f0, c);
      }
      out_bool[kFreshComplete * R + r] = admit_c;
      out_bool[kFreshPark * R + r] = admit_p;
      out[kStallHop * R + r] = defer ? 0 : -1;
      if (admit_p) {                // a freshly parked row enters at age 1
        out[kParkCount * R + r] = c;
        out[kParkHop * R + r] = h_stop;
        out[kParkAge * R + r] = 1;
      }
      out[kTraversed * R + r] = s_trav[r] + n_trav;
      out[kRerouted * R + r] = s_rer[r] + (admit_c && detour ? c : 0);
      out[kLinksDone * R + r] = s_done[r] + (admit_c ? L : 0);
    }
    __syncwarp();
  }
  for (int k = lane; k < K; k += 32) {
    out_links[kSpent * K + k] = credits[k] - s_rem[k];
    out_links[kNotify * K + k] = s_notify[k];
    out_links[kParkedByLink * K + k] = s_pbl[k];
    if (s_stall != nullptr) out_stall[k] = s_stall[k];
  }
}

// tenant-form output rows (kernels/admission.py: _TENANT_I32_FIELDS; the
// bool and per-slot rows as above)
enum { kTResumeAge, kTStallHop, kTParkCount, kTParkHop, kTParkAge,
       kTTraversed, kTQueue, kTRerouted, kTLinksDone, kTHoldShared };

// one traversed hop's reserved-first spend of c units over its tenant's
// slice (slot_r) and the link's shared pool (slot_s); a held hop keeps
// what it spent instead of notifying it
__device__ __forceinline__ void spend_split(int32_t* s_rem, int32_t* s_notify,
                                            int32_t* s_pbl, int slot_r,
                                            int slot_s, int take_r,
                                            int take_s, bool hold) {
  if (take_r) {
    atomicAdd(s_rem + slot_r, -take_r);
    atomicAdd(hold ? s_pbl + slot_r : s_notify + slot_r, take_r);
  }
  if (take_s) {
    atomicAdd(s_rem + slot_s, -take_s);
    atomicAdd(hold ? s_pbl + slot_s : s_notify + slot_s, take_s);
  }
}

__global__ void __launch_bounds__(kThreads)
admission_tenants_kernel(const int32_t* __restrict__ counts,
                         const int32_t* __restrict__ pc0,
                         const int32_t* __restrict__ ph0,
                         const int32_t* __restrict__ pa0,
                         const int32_t* __restrict__ hs0,
                         const int32_t* __restrict__ credits,
                         const int32_t* __restrict__ pbl0,
                         const int32_t* __restrict__ epoch_p,
                         const int32_t* __restrict__ seq_alt,
                         const int32_t* __restrict__ len_alt,
                         const int32_t* __restrict__ seg,
                         const bool* __restrict__ down,
                         int32_t* __restrict__ out,
                         bool* __restrict__ out_bool,
                         int32_t* __restrict__ out_links,
                         int32_t* __restrict__ out_stall, int n, int T,
                         int ndim, int H2, int Hs) {
  extern __shared__ int32_t sm[];
  const int R = n * n;               // (src, dst) pairs
  const int TR = T * R;              // rows
  const int K = n * 2 * ndim;        // physical links
  const int S = (T + 1) * K;         // credit slots
  int32_t* s_rem = sm;
  int32_t* s_notify = s_rem + S;
  int32_t* s_pbl = s_notify + S;
  int32_t* s_blocked = s_pbl + S;    // T * K: per (tenant, egress link)
  int32_t* s_flag = s_blocked + T * K;
  int32_t* s_trav = s_flag + TR;     // phase A's per-row terms, summed by B
  int32_t* s_rer = s_trav + TR;
  int32_t* s_done = s_rer + TR;
  int32_t* s_stall = out_stall != nullptr ? s_done + TR : nullptr;  // (K,)

  for (int k = threadIdx.x; k < S; k += kThreads) {
    s_rem[k] = credits[k];
    s_notify[k] = 0;
    s_pbl[k] = pbl0[k];
  }
  for (int k = threadIdx.x; k < T * K; k += kThreads) s_blocked[k] = 0;
  if (s_stall != nullptr)
    for (int k = threadIdx.x; k < K; k += kThreads) s_stall[k] = 0;
  // everything without a chain: the per-pair reroute (the mask is physical,
  // shared by every tenant), the per-row eviction set and queue snapshot
  for (int r = threadIdx.x; r < TR; r += kThreads) {
    const int pair = r % R;
    int combo = 0;
    bool routable = true;
    if (down != nullptr) {
      for (int a = 0; a < ndim; ++a) {
        const int32_t* s = seg + (static_cast<int64_t>(a * 2) * R + pair) * Hs;
        const int32_t* l = s + static_cast<int64_t>(R) * Hs;  // long arc
        bool short_dead = false, long_dead = false;
        for (int j = 0; j < Hs; ++j) {
          short_dead |= s[j] >= 0 && down[s[j]];
          long_dead |= l[j] >= 0 && down[l[j]];
        }
        if (short_dead && !long_dead) combo |= 1 << a;
        if (short_dead && long_dead) routable = false;
      }
    }
    const int32_t* s0 = seq_alt + static_cast<int64_t>(pair) * H2;
    const int32_t* se = seq_alt + (static_cast<int64_t>(combo) * R + pair) * H2;
    const int c = pc0[r];
    const int h = ph0[r];
    bool ev = false;
    if (down != nullptr && c > 0) {
      bool rem_dirty = false;
      for (int j = h; j < H2; ++j) rem_dirty |= s0[j] >= 0 && down[s0[j]];
      const int held = s0[h >= 1 ? h - 1 : 0];
      ev = h == 0 || rem_dirty || (h >= 1 && down[held >= 0 ? held : 0]);
    }
    // events held on the physical links (every slot of a link) along the
    // route the row will take, from its start hop
    const int32_t* sq = c > 0 ? s0 : se;
    const int start = c > 0 && !ev ? h : 0;
    int q = 0;
    for (int j = start; j < H2; ++j)
      if (sq[j] >= 0)
        for (int u = 0; u <= T; ++u) q += pbl0[u * K + sq[j]];
    out[kTQueue * TR + r] = q;
    s_flag[r] = combo | (routable ? kRoutable : 0) | (ev ? kEvicted : 0);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const bool on = lane < H2;
  const int epoch = *epoch_p;
  const int Tn = T * n;

  for (int i = 0; i < TR; ++i) {              // phase A: resume
    const int r = ((i / n + epoch) % Tn) * n + i % n;
    const int t = r / R;
    const int pair = r % R;
    const int c = pc0[r];
    const int h = ph0[r];
    const int hs = hs0[r];
    const int flag = s_flag[r];
    const int combo = flag & kCombo;
    const bool ev = flag & kEvicted;
    const bool detour = combo != 0;
    const bool active = c > 0;
    const int32_t l0 = on ? seq_alt[static_cast<int64_t>(pair) * H2 + lane]
                          : -1;
    const int L = len_alt[pair];
    const int64_t r2 = static_cast<int64_t>(combo) * R + pair;
    const int32_t l2 = on ? seq_alt[r2 * H2 + lane] : -1;
    const int L2 = len_alt[r2];
    // each lane's hop: its tenant's slice and the link's shared pool
    const int k0 = l0 >= 0 ? l0 : 0;
    const int k2 = l2 >= 0 ? l2 : 0;
    const int rr0 = s_rem[t * K + k0], rs0 = s_rem[T * K + k0];
    const int rr2 = s_rem[t * K + k2], rs2 = s_rem[T * K + k2];
    // branch 1: undisturbed resume on the default route
    const bool from_h = l0 >= 0 && lane >= h;
    const int h_new = first_set(
        __ballot_sync(kFull, from_h && rr0 + rs0 < c), H2);
    const bool act1 = active && !ev;
    const bool complete1 = act1 && h_new >= L;
    const int h_stop1 = max(complete1 ? L : h_new, h);
    const bool moved1 = act1 && h_stop1 > h;
    const bool trav1 = from_h && lane < h_stop1 && act1;
    const bool hold1 = on && moved1 && !complete1 && lane == h_stop1 - 1;
    const int tr1 = trav1 ? min(c, rr0) : 0;
    const int ts1 = trav1 ? c - tr1 : 0;
    // branch 2: evicted retry from hop 0 on the detour route
    const bool act2 = active && ev && (flag & kRoutable);
    const int h_block = first_set(
        __ballot_sync(kFull, l2 >= 0 && rr2 + rs2 < c), H2);
    const bool complete2 = act2 && h_block >= L2;
    const bool park2 = act2 && !detour && h_block < L2 && h_block >= 1;
    const int h_stop2 = complete2 ? L2 : (park2 ? h_block : 0);
    const bool trav2 = l2 >= 0 && lane < h_stop2;
    const bool hold2 = on && park2 && lane == h_stop2 - 1;
    const int tr2 = trav2 ? min(c, rr2) : 0;
    const int ts2 = trav2 ? c - tr2 : 0;
    const int n_trav = __popc(__ballot_sync(kFull, trav1))
                       + __popc(__ballot_sync(kFull, trav2));
    const int hs_new1 = __reduce_add_sync(kFull, hold1 ? ts1 : 0);
    const int hs_new2 = __reduce_add_sync(kFull, hold2 ? ts2 : 0);
    spend_split(s_rem, s_notify, s_pbl, t * K + k0, T * K + k0, tr1, ts1,
                hold1);
    spend_split(s_rem, s_notify, s_pbl, t * K + k2, T * K + k2, tr2, ts2,
                hold2);
    if (lane == 0) {
      // leaving (or being evicted from) the old park spot refunds its hold
      // to the slots that funded it
      if ((moved1 || (active && ev)) && h >= 1) {
        const int32_t oh = seq_alt[static_cast<int64_t>(pair) * H2 + h - 1];
        const int ok = oh >= 0 ? oh : 0;
        update(s_rem, s_notify, s_pbl, t * K + ok, 0, c - hs, hs - c);
        update(s_rem, s_notify, s_pbl, T * K + ok, 0, hs, -hs);
      }
      const bool complete = complete1 || complete2;
      const bool keep = active && !complete;
      const int h_keep = ev ? (park2 ? h_block : 0) : h_stop1;
      const int hs_keep = ev ? (park2 ? hs_new2 : 0)
                             : (moved1 ? hs_new1 : hs);
      const int age = pa0[r];
      out_bool[kResumedComplete * TR + r] = complete;
      out[kTResumeAge * TR + r] = complete ? age : 0;
      out[kTParkCount * TR + r] = complete ? 0 : c;
      out[kTParkHop * TR + r] = keep ? h_keep : 0;
      out[kTParkAge * TR + r] = keep ? age + 1 : 0;
      out[kTHoldShared * TR + r] = keep ? hs_keep : 0;
      s_trav[r] = n_trav;
      s_rer[r] = complete2 && detour ? c : 0;
      s_done[r] = (complete1 ? L : 0) + (complete2 ? L2 : 0);
    }
    __syncwarp();
  }

  for (int i = 0; i < TR; ++i) {              // phase B: offer
    const int r = ((i / n + epoch) % Tn) * n + i % n;
    const int t = r / R;
    const int pair = r % R;
    const int c = counts[r];
    const int flag = s_flag[r];
    const int combo = flag & kCombo;
    const bool routable = flag & kRoutable;
    const bool detour = combo != 0;
    const int64_t r2 = static_cast<int64_t>(combo) * R + pair;
    const int32_t l = on ? seq_alt[r2 * H2 + lane] : -1;
    const int L = len_alt[r2];
    const int k = l >= 0 ? l : 0;
    const int rr = s_rem[t * K + k], rs = s_rem[T * K + k];
    const int32_t fl = __shfl_sync(kFull, l, 0);
    const int bl = t * K + (fl >= 0 ? fl : 0);
    const bool has_first = fl >= 0 && c > 0;
    const int h_block = first_set(
        __ballot_sync(kFull, l >= 0 && rr + rs < c), H2);
    const bool ok = has_first && routable && pc0[r] <= 0
                    && s_blocked[bl] == 0;
    const bool admit_c = ok && h_block >= L;
    // parking mid-route only on the default route
    const bool admit_p = ok && !detour && h_block < L && h_block >= 1;
    const bool defer = has_first && !admit_c && !admit_p;
    const int h_stop = admit_c ? L : (admit_p ? h_block : 0);
    const bool trav = l >= 0 && lane < h_stop;
    const bool hold = on && admit_p && lane == h_stop - 1;
    const int tr = trav ? min(c, rr) : 0;
    const int ts = trav ? c - tr : 0;
    const int n_trav = __popc(__ballot_sync(kFull, trav));
    const int hs_new = __reduce_add_sync(kFull, hold ? ts : 0);
    spend_split(s_rem, s_notify, s_pbl, t * K + k, T * K + k, tr, ts, hold);
    if (lane == 0) {
      // an unroutable row never reaches its egress FIFO: it blocks nothing
      if (defer && routable) s_blocked[bl] = 1;
      if (defer && s_stall != nullptr) {
        // blame the healthy route's first physical hop (the row's own
        // first hop unless it detours: no load on the chain)
        const int32_t f0 =
            detour ? seq_alt[static_cast<int64_t>(pair) * H2] : fl;
        if (f0 >= 0) atomicAdd(s_stall + f0, c);
      }
      out_bool[kFreshComplete * TR + r] = admit_c;
      out_bool[kFreshPark * TR + r] = admit_p;
      out[kTStallHop * TR + r] = defer ? 0 : -1;
      if (admit_p) {                // a freshly parked row enters at age 1
        out[kTParkCount * TR + r] = c;
        out[kTParkHop * TR + r] = h_stop;
        out[kTParkAge * TR + r] = 1;
        out[kTHoldShared * TR + r] = hs_new;
      }
      out[kTTraversed * TR + r] = s_trav[r] + n_trav;
      out[kTRerouted * TR + r] = s_rer[r] + (admit_c && detour ? c : 0);
      out[kTLinksDone * TR + r] = s_done[r] + (admit_c ? L : 0);
    }
    __syncwarp();
  }
  for (int k = lane; k < S; k += 32) {
    out_links[kSpent * S + k] = credits[k] - s_rem[k];
    out_links[kNotify * S + k] = s_notify[k];
    out_links[kParkedByLink * S + k] = s_pbl[k];
  }
  if (s_stall != nullptr)
    for (int k = lane; k < K; k += 32) out_stall[k] = s_stall[k];
}

}  // namespace

extern "C" int repro_admission(const void* counts, const void* pc0,
                               const void* ph0, const void* pa0,
                               const void* credits, const void* pbl0,
                               const void* epoch, const void* seq_alt,
                               const void* len_alt, const void* seg,
                               const void* down, void* out, void* out_bool,
                               void* out_links, void* out_stall, int n,
                               int ndim, int H2, int Hs, void* stream) {
  if (n <= 0) return 0;
  if (H2 < 1 || H2 > 32 || ndim < 1 || ndim > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = n * n;
  const int K = n * 2 * ndim;
  const size_t smem = sizeof(int32_t) * ((out_stall != nullptr ? 5 : 4)
                                             * static_cast<size_t>(K)
                                         + 4 * static_cast<size_t>(R));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admission_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  admission_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(pc0),
      static_cast<const int32_t*>(ph0), static_cast<const int32_t*>(pa0),
      static_cast<const int32_t*>(credits),
      static_cast<const int32_t*>(pbl0), static_cast<const int32_t*>(epoch),
      static_cast<const int32_t*>(seq_alt),
      static_cast<const int32_t*>(len_alt), static_cast<const int32_t*>(seg),
      static_cast<const bool*>(down), static_cast<int32_t*>(out),
      static_cast<bool*>(out_bool), static_cast<int32_t*>(out_links),
      static_cast<int32_t*>(out_stall), n, ndim, H2, Hs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_admission_tenants(
    const void* counts, const void* pc0, const void* ph0, const void* pa0,
    const void* hs0, const void* credits, const void* pbl0, const void* epoch,
    const void* seq_alt, const void* len_alt, const void* seg,
    const void* down, void* out, void* out_bool, void* out_links,
    void* out_stall, int n, int T, int ndim, int H2, int Hs, void* stream) {
  if (n <= 0 || T <= 0) return 0;
  if (H2 < 1 || H2 > 32 || ndim < 1 || ndim > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t R = static_cast<size_t>(n) * n;
  const size_t K = static_cast<size_t>(n) * 2 * ndim;
  const size_t smem = sizeof(int32_t) * (3 * (T + 1) * K + T * K + 4 * T * R
                                         + (out_stall != nullptr ? K : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admission_tenants_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  admission_tenants_kernel<<<1, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(pc0),
      static_cast<const int32_t*>(ph0), static_cast<const int32_t*>(pa0),
      static_cast<const int32_t*>(hs0), static_cast<const int32_t*>(credits),
      static_cast<const int32_t*>(pbl0), static_cast<const int32_t*>(epoch),
      static_cast<const int32_t*>(seq_alt),
      static_cast<const int32_t*>(len_alt), static_cast<const int32_t*>(seg),
      static_cast<const bool*>(down), static_cast<int32_t*>(out),
      static_cast<bool*>(out_bool), static_cast<int32_t*>(out_links),
      static_cast<int32_t*>(out_stall), n, T, ndim, H2, Hs);
  return static_cast<int>(cudaGetLastError());
}
