"""Fused LIF step (port of ``src/repro/kernels/lif_step.py``).

:func:`lif_step` launches the hand-written kernel ``csrc/lif_step.cu`` on
CUDA tensors and runs :func:`lif_step_plain` (``snn.lif.step``) on CPU
tensors.  The kernel covers the ragged tail itself, so there is no padding
to the TPU's 1024-neuron tiles; it takes the external current as one
scalar (the simulator's is 0).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.snn import lif
from repro_torch.snn.lif import LIFParams, LIFState

lif_step_plain = lif.step


def lif_step(state: LIFState, p: LIFParams, exc_in: torch.Tensor,
             inh_in: torch.Tensor, i_ext: float = 0.0):
    """One fused dt step over any shape of neurons -> (state, spikes bool)."""
    if not dispatch.on_cuda(*state, exc_in, inh_in):
        return lif_step_plain(state, p, exc_in, inh_in, i_ext)
    if not isinstance(i_ext, (int, float)):
        raise ValueError("lif_step: the kernel takes a scalar external "
                         "current")
    shape = state.v.shape
    for name, t, dtype in (("v", state.v, torch.float32),
                           ("i_exc", state.i_exc, torch.float32),
                           ("i_inh", state.i_inh, torch.float32),
                           ("refrac", state.refrac, torch.int32),
                           ("exc_in", exc_in, torch.float32),
                           ("inh_in", inh_in, torch.float32)):
        if t.dtype != dtype or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"lif_step: {name} must be a contiguous "
                             f"{dtype} tensor of shape {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    pm, ps, pv, ref_steps, tau_c = lif.propagators(p)
    v, i_exc, i_inh = (torch.empty_like(state.v) for _ in range(3))
    refrac = torch.empty_like(state.refrac)
    spikes = torch.empty(shape, dtype=torch.bool, device=state.v.device)
    dispatch.launch("lif_step", "repro_lif_step", state.v.data_ptr(),
                    state.i_exc.data_ptr(), state.i_inh.data_ptr(),
                    state.refrac.data_ptr(), exc_in.data_ptr(),
                    inh_in.data_ptr(), v.data_ptr(), i_exc.data_ptr(),
                    i_inh.data_ptr(), refrac.data_ptr(), spikes.data_ptr(),
                    state.v.numel(), float(i_ext), pm, ps, pv, ref_steps,
                    p.e_l, p.v_th, p.v_reset, tau_c)
    return LIFState(v, i_exc, i_inh, refrac), spikes
