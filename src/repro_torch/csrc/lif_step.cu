// Exact-integration LIF over a window of dt steps, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lif_step.py:_kernel (:39),
// launched by lif_step_pallas (:61, pl.pallas_call at :78), together with
// the simulator's loop around it (src/repro/snn/simulator.py:151-170).
//
// What it computes, per neuron and per step k of the window: read the
// delay-ring slot (t0 + k) % ring_len of the excitatory and inhibitory
// rings, add the step's background drive to the excitatory input,
// optionally clear the consumed slots, then one LIF step: when not
// refractory, decay the membrane toward e_l and integrate the synaptic
// currents (and a scalar external current); decay both synaptic currents
// and add the step's input; spike where an active neuron reaches
// threshold, then reset it and start its refractory countdown, else count
// the countdown down to 0.  The step's spikes go to the raster, laid out
// (rows, n_steps, per) for state laid out (rows, per), which is the
// layout the simulator's spike compaction reads.  A single step
// (lif_step) is the same kernel with n_steps = 1, its inputs as a
// one-slot ring, no drive and no clearing.
//
// Bound on an H100 (3.35 TB/s): bytes.  Per window a neuron reads its
// state once and writes it once (16 B + 16 B) and per step reads two ring
// slots and the drive (12 B), writes two zeros (8 B) and a spike (1 B):
// 200 B at 8 steps for ~15 flops a step.  At the simulator's full width
// (15,432 neurons) that is 3.09 MB, about 0.92 us per window.
//
// Design: one thread per neuron with a grid-stride loop, the ragged tail
// masked by the loop bound; the state stays in registers over the whole
// window, so it crosses device memory once instead of once a step, and
// the window costs one launch instead of the 33 device functions of a
// loop of single steps.  Blocks of 128 threads spread the ~15k neurons
// over ~120 SMs.  Windows of up to 16 steps that fit the ring are
// unrolled at compile time (template W), and every step's ring and drive
// loads are issued before the dependent update chain; longer windows take
// a run-time loop, which also gives a slot met twice in one window the
// zeros that clearing left in it.  The update is written with __fmul_rn /
// __fadd_rn / __fsub_rn in the order of the plain PyTorch version
// (repro_torch/snn/lif.py:step), and the drive is added as
// __fadd_rn(ring, drive), so nvcc cannot contract anything into FMAs and
// the kernel agrees with the plain version bit for bit.  The propagators
// come from the wrapper, computed as the plain version computes them.
// The window's first step comes by value (t0, already reduced to the
// ring) or, for a caller that keeps its step count on the card (the
// simulator's window loop, replayed as a CUDA graph), through a device
// pointer t_at: the kernel then reduces *t_at to the ring itself, as
// Python's % does, so both forms read the same slots.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Params {
  float i_ext, pm, ps, pv;
  int ref_steps;
  float e_l, v_th, v_reset, tau_c;
};

// One dt step on a neuron's state in registers -> its spike.
__device__ __forceinline__ bool lif_update(float& v, float& ie, float& ii,
                                           int32_t& rf, float exc, float inh,
                                           float ext_term, const Params& p) {
  const bool active = rf <= 0;
  // e_l + (v - e_l) * pm + pv * (i_exc + i_inh) + tau_c * i_ext
  float v_new = __fadd_rn(p.e_l, __fmul_rn(__fsub_rn(v, p.e_l), p.pm));
  v_new = __fadd_rn(v_new, __fmul_rn(p.pv, __fadd_rn(ie, ii)));
  v_new = __fadd_rn(v_new, ext_term);
  v_new = active ? v_new : v;
  ie = __fadd_rn(__fmul_rn(ie, p.ps), exc);
  ii = __fadd_rn(__fmul_rn(ii, p.ps), inh);
  const bool spike = active && (v_new >= p.v_th);
  v = spike ? p.v_reset : v_new;
  rf = spike ? p.ref_steps : max(rf - 1, 0);
  return spike;
}

// W > 0: W steps unrolled (W <= ring_len, so t0 + k < 2 ring_len);
// W == 0: n_steps steps in a run-time loop.
template <int W>
__global__ void lif_window_kernel(
    const float* __restrict__ v_in, const float* __restrict__ ie_in,
    const float* __restrict__ ii_in, const int32_t* __restrict__ rf_in,
    float* ring_exc, float* ring_inh, const float* __restrict__ drive,
    float* __restrict__ v_out, float* __restrict__ ie_out,
    float* __restrict__ ii_out, int32_t* __restrict__ rf_out,
    bool* __restrict__ raster, int64_t n, int64_t per, int n_steps, int t0,
    const int32_t* __restrict__ t_at, int ring_len, bool clear, Params p) {
  if (t_at) {
    const int r = *t_at % ring_len;
    t0 = r < 0 ? r + ring_len : r;
  }
  const float ext_term = __fmul_rn(p.tau_c, p.i_ext);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = v_in[i];
    float ie = ie_in[i];
    float ii = ii_in[i];
    int32_t rf = rf_in[i];
    const int64_t row = i / per;
    bool* spk = raster + row * n_steps * per + (i - row * per);
    if constexpr (W > 0) {
      float exc[W], inh[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int slot = t0 + k < ring_len ? t0 + k : t0 + k - ring_len;
        exc[k] = ring_exc[slot * n + i];
        inh[k] = ring_inh[slot * n + i];
        if (drive) exc[k] = __fadd_rn(exc[k], drive[k * n + i]);
      }
      if (clear) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int slot = t0 + k < ring_len ? t0 + k : t0 + k - ring_len;
          ring_exc[slot * n + i] = 0.0f;
          ring_inh[slot * n + i] = 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < W; ++k)
        spk[k * per] = lif_update(v, ie, ii, rf, exc[k], inh[k], ext_term, p);
    } else {
      int slot = t0;
      for (int k = 0; k < n_steps; ++k) {
        float exc = ring_exc[slot * n + i];
        const float inh = ring_inh[slot * n + i];
        if (drive) exc = __fadd_rn(exc, drive[k * n + i]);
        if (clear) {
          ring_exc[slot * n + i] = 0.0f;
          ring_inh[slot * n + i] = 0.0f;
        }
        spk[k * per] = lif_update(v, ie, ii, rf, exc, inh, ext_term, p);
        if (++slot == ring_len) slot = 0;
      }
    }
    v_out[i] = v;
    ie_out[i] = ie;
    ii_out[i] = ii;
    rf_out[i] = rf;
  }
}

// The alpha form: NEST's iaf_psc_alpha (no TPU kernel; the HPC benchmark's
// neuron).  A neuron carries a current I and its derivative dI per synapse
// type; per step, in the order of the plain version
// (repro_torch/snn/lif.py:alpha_step): when not refractory, u = v - e_l
// becomes p33 u + p31 dI_e + p32 I_e + p31 dI_i + p32 I_i (left to right)
// and v = e_l + u; then I = p21 dI + p22 I (p22 = p11) and dI = p11 dI +
// psc (ring + drive) for each type; then the threshold test, the reset
// and the countdown, as the exponential form.  With an archive (the
// neurons' last H spikes for STDP, a ring of (step, K-) per neuron and
// its count) each spike is appended: K- = the newest entry's K- times
// tab[t - step] (a decay table, clamped) plus 1, or 1 for a first spike;
// the newest entry stays in registers over the window.  Bound: bytes,
// 24 + 24 B of state and 21 B a step (the exponential form's ring, drive,
// clearing and raster), the archive's few bytes a spike aside.
struct AlphaParams {
  float p11, p21, p31, p32, p33, psc;
  int ref_steps;
  float e_l, v_th, v_reset;
};

struct Archive {
  int32_t* step;            // (n, H)
  float* kminus;            // (n, H)
  int32_t* count;           // (n,)
  const float* tab;         // (tab_len,) e^{-k dt / tau_minus}
  int history, tab_len;
};

__device__ __forceinline__ bool alpha_update(float& v, float& die, float& ie,
                                             float& dii, float& ii,
                                             int32_t& rf, float exc,
                                             float inh,
                                             const AlphaParams& p) {
  const bool active = rf <= 0;
  float u = __fmul_rn(p.p33, __fsub_rn(v, p.e_l));
  u = __fadd_rn(u, __fmul_rn(p.p31, die));
  u = __fadd_rn(u, __fmul_rn(p.p32, ie));
  u = __fadd_rn(u, __fmul_rn(p.p31, dii));
  u = __fadd_rn(u, __fmul_rn(p.p32, ii));
  const float v_new = active ? __fadd_rn(p.e_l, u) : v;
  ie = __fadd_rn(__fmul_rn(p.p21, die), __fmul_rn(p.p11, ie));
  die = __fadd_rn(__fmul_rn(p.p11, die), __fmul_rn(p.psc, exc));
  ii = __fadd_rn(__fmul_rn(p.p21, dii), __fmul_rn(p.p11, ii));
  dii = __fadd_rn(__fmul_rn(p.p11, dii), __fmul_rn(p.psc, inh));
  const bool spike = active && (v_new >= p.v_th);
  v = spike ? p.v_reset : v_new;
  rf = spike ? p.ref_steps : max(rf - 1, 0);
  return spike;
}

// W > 0: W steps unrolled (W <= ring_len); W == 0: a run-time loop, which
// also gives a slot met twice in one window the zeros clearing left in it.
template <int W>
__global__ void lif_alpha_window_kernel(
    const float* __restrict__ v_in, const float* __restrict__ die_in,
    const float* __restrict__ ie_in, const float* __restrict__ dii_in,
    const float* __restrict__ ii_in, const int32_t* __restrict__ rf_in,
    float* ring_exc, float* ring_inh, const float* __restrict__ drive,
    float* __restrict__ v_out, float* __restrict__ die_out,
    float* __restrict__ ie_out, float* __restrict__ dii_out,
    float* __restrict__ ii_out, int32_t* __restrict__ rf_out,
    bool* __restrict__ raster, int64_t n, int64_t per, int n_steps,
    int64_t t_glob, const int32_t* __restrict__ t_at, int ring_len,
    bool clear, AlphaParams p, Archive ar) {
  if (t_at) t_glob = *t_at;
  int t0 = static_cast<int>(t_glob % ring_len);
  if (t0 < 0) t0 += ring_len;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = v_in[i], die = die_in[i], ie = ie_in[i], dii = dii_in[i],
          ii = ii_in[i];
    int32_t rf = rf_in[i];
    const int64_t row = i / per;
    bool* spk = raster + row * n_steps * per + (i - row * per);
    int32_t cnt = 0, last_step = 0;
    float last_km = 0.0f;
    if (ar.step) {
      cnt = ar.count[i];
      if (cnt > 0) {
        const int64_t at = i * ar.history + (cnt - 1) % ar.history;
        last_step = ar.step[at];
        last_km = ar.kminus[at];
      }
    }
    auto archive = [&](int64_t t_sp) {
      float km = 1.0f;
      if (cnt > 0) {
        int64_t gap = t_sp - last_step;
        gap = gap < 0 ? 0 : (gap >= ar.tab_len ? ar.tab_len - 1 : gap);
        km = __fadd_rn(__fmul_rn(last_km, ar.tab[gap]), 1.0f);
      }
      const int64_t at = i * ar.history + cnt % ar.history;
      ar.step[at] = static_cast<int32_t>(t_sp);
      ar.kminus[at] = km;
      last_step = static_cast<int32_t>(t_sp);
      last_km = km;
      ++cnt;
    };
    if constexpr (W > 0) {
      float exc[W], inh[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int slot = t0 + k < ring_len ? t0 + k : t0 + k - ring_len;
        exc[k] = ring_exc[slot * n + i];
        inh[k] = ring_inh[slot * n + i];
        if (drive) exc[k] = __fadd_rn(exc[k], drive[k * n + i]);
      }
      if (clear) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int slot = t0 + k < ring_len ? t0 + k : t0 + k - ring_len;
          ring_exc[slot * n + i] = 0.0f;
          ring_inh[slot * n + i] = 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const bool s = alpha_update(v, die, ie, dii, ii, rf, exc[k], inh[k],
                                    p);
        spk[k * per] = s;
        if (s && ar.step) archive(t_glob + k);
      }
    } else {
      int slot = t0;
      for (int k = 0; k < n_steps; ++k) {
        float exc = ring_exc[slot * n + i];
        const float inh = ring_inh[slot * n + i];
        if (drive) exc = __fadd_rn(exc, drive[k * n + i]);
        if (clear) {
          ring_exc[slot * n + i] = 0.0f;
          ring_inh[slot * n + i] = 0.0f;
        }
        const bool s = alpha_update(v, die, ie, dii, ii, rf, exc, inh, p);
        spk[k * per] = s;
        if (s && ar.step) archive(t_glob + k);
        if (++slot == ring_len) slot = 0;
      }
    }
    v_out[i] = v;
    die_out[i] = die;
    ie_out[i] = ie;
    dii_out[i] = dii;
    ii_out[i] = ii;
    rf_out[i] = rf;
    if (ar.step) ar.count[i] = cnt;
  }
}

}  // namespace

// ring_exc / ring_inh: (ring_len, n) f32; drive: (n_steps, n) f32 or null;
// t0 in [0, ring_len), or t_at a device int32 step (t0 then unused);
// state (n,) in, (n,) out; raster (n / per, n_steps, per) bool.
extern "C" int repro_lif_window(
    const void* v, const void* ie, const void* ii, const void* rf,
    void* ring_exc, void* ring_inh, const void* drive, void* v_out,
    void* ie_out, void* ii_out, void* rf_out, void* raster, int64_t n,
    int64_t per, int n_steps, int t0, const void* t_at, int ring_len,
    int clear, float i_ext,
    float pm, float ps, float pv, int ref_steps, float e_l, float v_th,
    float v_reset, float tau_c, void* stream) {
  if (n == 0 || n_steps == 0) return 0;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  const Params p{i_ext, pm, ps, pv, ref_steps, e_l, v_th, v_reset, tau_c};
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_LIF_ARGS                                                       \
  static_cast<const float*>(v), static_cast<const float*>(ie),               \
      static_cast<const float*>(ii), static_cast<const int32_t*>(rf),        \
      static_cast<float*>(ring_exc), static_cast<float*>(ring_inh),          \
      static_cast<const float*>(drive), static_cast<float*>(v_out),          \
      static_cast<float*>(ie_out), static_cast<float*>(ii_out),              \
      static_cast<int32_t*>(rf_out), static_cast<bool*>(raster), n, per,     \
      n_steps, t0, static_cast<const int32_t*>(t_at), ring_len, clear != 0,  \
      p
#define REPRO_LIF_CASE(W)                                                    \
  case W:                                                                    \
    lif_window_kernel<W><<<blocks, kThreads, 0, s>>>(REPRO_LIF_ARGS);        \
    break;
  switch (n_steps <= ring_len ? n_steps : 0) {
    REPRO_LIF_CASE(1) REPRO_LIF_CASE(2) REPRO_LIF_CASE(3) REPRO_LIF_CASE(4)
    REPRO_LIF_CASE(5) REPRO_LIF_CASE(6) REPRO_LIF_CASE(7) REPRO_LIF_CASE(8)
    REPRO_LIF_CASE(9) REPRO_LIF_CASE(10) REPRO_LIF_CASE(11)
    REPRO_LIF_CASE(12) REPRO_LIF_CASE(13) REPRO_LIF_CASE(14)
    REPRO_LIF_CASE(15) REPRO_LIF_CASE(16)
    default:
      lif_window_kernel<0><<<blocks, kThreads, 0, s>>>(REPRO_LIF_ARGS);
  }
#undef REPRO_LIF_CASE
#undef REPRO_LIF_ARGS
  return static_cast<int>(cudaGetLastError());
}

// The alpha form: state (v, dI_e, I_e, dI_i, I_i, refrac) (n,) in and out;
// t_glob the window's first global step, or t_at a device int32 holding
// it (t_glob then unused); the archive pointers null for none.
extern "C" int repro_lif_alpha_window(
    const void* v, const void* die, const void* ie, const void* dii,
    const void* ii, const void* rf, void* ring_exc, void* ring_inh,
    const void* drive, void* v_out, void* die_out, void* ie_out,
    void* dii_out, void* ii_out, void* rf_out, void* raster, int64_t n,
    int64_t per, int n_steps, int64_t t_glob, const void* t_at,
    int ring_len, int clear, float p11, float p21, float p31, float p32,
    float p33, float psc, int ref_steps, float e_l, float v_th,
    float v_reset, void* a_step, void* a_kminus, void* a_count,
    const void* a_tab, int history, int tab_len, void* stream) {
  if (n == 0 || n_steps == 0) return 0;
  if (ring_len < 1 || (a_step && (history < 1 || tab_len < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  const AlphaParams p{p11, p21, p31, p32, p33, psc, ref_steps, e_l, v_th,
                      v_reset};
  const Archive ar{static_cast<int32_t*>(a_step),
                   static_cast<float*>(a_kminus),
                   static_cast<int32_t*>(a_count),
                   static_cast<const float*>(a_tab), history, tab_len};
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_ALPHA_ARGS                                                     \
  static_cast<const float*>(v), static_cast<const float*>(die),              \
      static_cast<const float*>(ie), static_cast<const float*>(dii),         \
      static_cast<const float*>(ii), static_cast<const int32_t*>(rf),        \
      static_cast<float*>(ring_exc), static_cast<float*>(ring_inh),          \
      static_cast<const float*>(drive), static_cast<float*>(v_out),          \
      static_cast<float*>(die_out), static_cast<float*>(ie_out),             \
      static_cast<float*>(dii_out), static_cast<float*>(ii_out),             \
      static_cast<int32_t*>(rf_out), static_cast<bool*>(raster), n, per,     \
      n_steps, t_glob, static_cast<const int32_t*>(t_at), ring_len,          \
      clear != 0, p, ar
#define REPRO_ALPHA_CASE(W)                                                  \
  case W:                                                                    \
    lif_alpha_window_kernel<W><<<blocks, kThreads, 0, s>>>(REPRO_ALPHA_ARGS);\
    break;
  switch (n_steps <= ring_len ? n_steps : 0) {
    REPRO_ALPHA_CASE(8)           // the simulator's window
    default:
      lif_alpha_window_kernel<0><<<blocks, kThreads, 0, s>>>(
          REPRO_ALPHA_ARGS);
  }
#undef REPRO_ALPHA_CASE
#undef REPRO_ALPHA_ARGS
  return static_cast<int>(cudaGetLastError());
}
