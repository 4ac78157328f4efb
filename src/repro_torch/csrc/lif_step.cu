// Fused exact-integration LIF step, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lif_step.py:_kernel (:39),
// launched by lif_step_pallas (:61, pl.pallas_call at :78).
//
// What it computes, per neuron: when not refractory, decay the membrane
// toward e_l and integrate the synaptic currents (and a scalar external
// current); decay both synaptic currents and add this step's input;
// spike where an active neuron reaches threshold, then reset it and start
// its refractory countdown, else count the countdown down to 0.
//
// Bound on an H100 (3.35 TB/s): bytes.  A neuron reads 6 x 4 B (v, i_exc,
// i_inh, refrac, exc_in, inh_in) and writes 4 x 4 B + 1 B (the state and
// a bool spike): 41 B for about 15 flops.  At the simulator's full width
// (15,432 neurons over 4 shards) that is 0.63 MB per step, about 0.19 us.
// A launch costs more; the simulator runs 8 per window.
//
// Design: one thread per neuron with a grid-stride loop, the ragged tail
// masked by the loop bound (no padding, unlike the TPU tiles).  The update
// is written with __fmul_rn / __fadd_rn / __fsub_rn in the order of the
// plain PyTorch version (repro_torch/snn/lif.py:step), so nvcc cannot
// contract it into FMAs and the kernel agrees with the plain version bit
// for bit.  The propagators come from the wrapper, computed as the plain
// version computes them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void lif_kernel(const float* __restrict__ v,
                           const float* __restrict__ ie,
                           const float* __restrict__ ii,
                           const int32_t* __restrict__ rf,
                           const float* __restrict__ exc,
                           const float* __restrict__ inh,
                           float* __restrict__ v_out,
                           float* __restrict__ ie_out,
                           float* __restrict__ ii_out,
                           int32_t* __restrict__ rf_out,
                           bool* __restrict__ spk_out, int64_t n,
                           float i_ext, float pm, float ps, float pv,
                           int ref_steps, float e_l, float v_th,
                           float v_reset, float tau_c) {
  const float ext_term = __fmul_rn(tau_c, i_ext);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float vi = v[i];
    const float ei = ie[i];
    const float ji = ii[i];
    const int32_t ri = rf[i];
    const bool active = ri <= 0;
    // e_l + (v - e_l) * pm + pv * (i_exc + i_inh) + tau_c * i_ext
    float v_new = __fadd_rn(e_l, __fmul_rn(__fsub_rn(vi, e_l), pm));
    v_new = __fadd_rn(v_new, __fmul_rn(pv, __fadd_rn(ei, ji)));
    v_new = __fadd_rn(v_new, ext_term);
    v_new = active ? v_new : vi;
    ie_out[i] = __fadd_rn(__fmul_rn(ei, ps), exc[i]);
    ii_out[i] = __fadd_rn(__fmul_rn(ji, ps), inh[i]);
    const bool spike = active && (v_new >= v_th);
    v_out[i] = spike ? v_reset : v_new;
    rf_out[i] = spike ? ref_steps : max(ri - 1, 0);
    spk_out[i] = spike;
  }
}

}  // namespace

extern "C" int repro_lif_step(const void* v, const void* ie, const void* ii,
                              const void* rf, const void* exc,
                              const void* inh, void* v_out, void* ie_out,
                              void* ii_out, void* rf_out, void* spk_out,
                              int64_t n, float i_ext, float pm, float ps,
                              float pv, int ref_steps, float e_l,
                              float v_th, float v_reset, float tau_c,
                              void* stream) {
  if (n == 0) return 0;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  lif_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(ie),
      static_cast<const float*>(ii), static_cast<const int32_t*>(rf),
      static_cast<const float*>(exc), static_cast<const float*>(inh),
      static_cast<float*>(v_out), static_cast<float*>(ie_out),
      static_cast<float*>(ii_out), static_cast<int32_t*>(rf_out),
      static_cast<bool*>(spk_out), n, i_ext, pm, ps, pv, ref_steps, e_l,
      v_th, v_reset, tau_c);
  return static_cast<int>(cudaGetLastError());
}
