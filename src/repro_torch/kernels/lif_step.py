"""LIF step and LIF window (port of ``src/repro/kernels/lif_step.py`` and of
the simulator's step loop, ``src/repro/snn/simulator.py:_simulate_steps``).

One hand-written kernel, ``csrc/lif_step.cu``, runs ``n_steps`` LIF steps
with the state held in registers.  :func:`lif_window` launches it once for
a whole flush window off the delay rings; :func:`lif_step` launches it
for one step (its inputs as a one-slot ring).  Both count their launches
as ``lif_step``.  On CPU tensors they run :func:`lif_window_plain` and
:func:`lif_step_plain` (``snn.lif.step``), whose f32 operations the kernel
repeats in the same order, so the two agree bit for bit.  The kernel
covers the ragged tail itself, so there is no padding to the TPU's
1024-neuron tiles; it takes the external current as one scalar (the
simulator's is 0).  The window's first step is a Python int or, for a
caller that keeps its step count on the card (the simulator, whose window
loop is replayed as a CUDA graph), an int32 tensor that the kernel reads
through its pointer, so the host never waits for it.

:func:`lif_alpha_window` is the same window for NEST's ``iaf_psc_alpha``
(``snn.lif.alpha_step``; the kernel's alpha form, counted as
``lif_alpha``), optionally appending each spike to the neurons' post-spike
archive for STDP.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.snn import lif
from repro_torch.snn.lif import (AlphaParams, AlphaState, LIFParams,
                                 LIFState, PostArchive)

lif_step_plain = lif.step


def _check(what: str, named, shape, dtype) -> None:
    for name, t in named:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
                not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                             f"tensor of shape {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)} contiguous="
                             f"{t.is_contiguous()}")


def _launch(state: LIFState, p: LIFParams, ring_exc, ring_inh,
            ring_len: int, t0, drive, n_steps: int, clear: bool,
            i_ext: float):
    """Launch the window kernel -> (state, raster (..., n_steps, per));
    ``t0`` the first step's ring slot, or an int32 tensor holding the
    step, which the kernel reduces to the ring."""
    t_at = t0.data_ptr() if isinstance(t0, torch.Tensor) else None
    shape = tuple(state.v.shape)
    per = shape[-1] if shape else 1
    pm, ps, pv, ref_steps, tau_c = lif.propagators(p)
    v, i_exc, i_inh = (torch.empty_like(state.v) for _ in range(3))
    refrac = torch.empty_like(state.refrac)
    raster = torch.empty(shape[:-1] + (n_steps, per), dtype=torch.bool,
                         device=state.v.device)
    dispatch.launch("lif_step", "repro_lif_window", state.v.data_ptr(),
                    state.i_exc.data_ptr(), state.i_inh.data_ptr(),
                    state.refrac.data_ptr(), ring_exc.data_ptr(),
                    ring_inh.data_ptr(),
                    None if drive is None else drive.data_ptr(),
                    v.data_ptr(), i_exc.data_ptr(), i_inh.data_ptr(),
                    refrac.data_ptr(), raster.data_ptr(), state.v.numel(),
                    per, n_steps, t0 if t_at is None else 0, t_at,
                    ring_len, int(clear), float(i_ext), pm, ps, pv,
                    ref_steps, p.e_l, p.v_th, p.v_reset, tau_c)
    return LIFState(v, i_exc, i_inh, refrac), raster


def lif_step(state: LIFState, p: LIFParams, exc_in: torch.Tensor,
             inh_in: torch.Tensor, i_ext: float = 0.0):
    """One fused dt step over any shape of neurons -> (state, spikes bool)."""
    if not dispatch.on_cuda(*state, exc_in, inh_in):
        return lif_step_plain(state, p, exc_in, inh_in, i_ext)
    if not isinstance(i_ext, (int, float)):
        raise ValueError("lif_step: the kernel takes a scalar external "
                         "current")
    shape = state.v.shape
    _check("lif_step", (("v", state.v), ("i_exc", state.i_exc),
                        ("i_inh", state.i_inh), ("exc_in", exc_in),
                        ("inh_in", inh_in)), shape, torch.float32)
    _check("lif_step", (("refrac", state.refrac),), shape, torch.int32)
    state, raster = _launch(state, p, exc_in, inh_in, 1, 0, None, 1, False,
                            i_ext)
    return state, raster.reshape(shape)


def lif_window_plain(neuron: LIFState, p: LIFParams, ring_exc: torch.Tensor,
                     ring_inh: torch.Tensor, t0, drive: torch.Tensor,
                     clear: bool = True):
    """Plain PyTorch window: ``drive.shape[0]`` steps off the delay rings
    (the consumed slots cleared in place when ``clear``) -> (neuron,
    spikes (..., n_steps, per) bool)."""
    t0 = dispatch.step_on_host(t0)
    ring_len = ring_exc.shape[0]
    spikes = []
    for k in range(drive.shape[0]):
        slot = (t0 + k) % ring_len
        neuron, spk = lif_step_plain(neuron, p, ring_exc[slot] + drive[k],
                                     ring_inh[slot])
        if clear:
            ring_exc[slot].zero_()
            ring_inh[slot].zero_()
        spikes.append(spk)
    return neuron, torch.stack(spikes, dim=-2)


def lif_window(neuron: LIFState, p: LIFParams, ring_exc: torch.Tensor,
               ring_inh: torch.Tensor, t0, drive: torch.Tensor,
               clear: bool = True):
    """A flush window of LIF steps off the delay rings in one launch.

    ``neuron``: (..., per) state; ``ring_exc`` / ``ring_inh``: (ring_len,
    ..., per) f32 scheduled currents, contiguous; ``drive``: (n_steps, ...,
    per) f32 background current added to the excitatory input of each
    step; step k reads ring slot ``(t0 + k) % ring_len`` and, when
    ``clear``, zeroes it in place.  ``t0`` is an int, or an int32 tensor
    on the neurons' device whose first element is the step (the
    simulator's ``ShardState.t``), read on the device by the kernel.
    -> (neuron, spikes (..., n_steps, per) bool).  Kernel on CUDA tensors,
    :func:`lif_window_plain` on CPU tensors; the operands are checked on
    both."""
    shape = tuple(neuron.v.shape)
    if not shape or drive.dim() != len(shape) + 1 or drive.shape[0] < 1:
        raise ValueError(f"lif_window: want (..., per) neurons and an "
                         f"(n_steps >= 1, ..., per) drive, got "
                         f"{shape} and {tuple(drive.shape)}")
    n_steps = drive.shape[0]
    ring_len = ring_exc.shape[0] if ring_exc.dim() else 0
    _check("lif_window", (("v", neuron.v), ("i_exc", neuron.i_exc),
                          ("i_inh", neuron.i_inh)), shape, torch.float32)
    _check("lif_window", (("refrac", neuron.refrac),), shape, torch.int32)
    _check("lif_window", (("ring_exc", ring_exc), ("ring_inh", ring_inh)),
           (ring_len,) + shape, torch.float32)
    _check("lif_window", (("drive", drive),), (n_steps,) + shape,
           torch.float32)
    if ring_len < 1:
        raise ValueError("lif_window: empty delay ring")
    on_step = isinstance(t0, torch.Tensor)
    if on_step and (t0.dtype != torch.int32 or t0.numel() < 1):
        raise ValueError(f"lif_window: a step tensor must be int32 with an "
                         f"element, got {t0.dtype} {tuple(t0.shape)}")
    if not dispatch.on_cuda(*neuron, ring_exc, ring_inh, drive,
                            *((t0,) if on_step else ())):
        return lif_window_plain(neuron, p, ring_exc, ring_inh, t0, drive,
                                clear)
    return _launch(neuron, p, ring_exc, ring_inh, ring_len,
                   t0 if on_step else t0 % ring_len, drive, n_steps, clear,
                   0.0)


def lif_alpha_window_plain(neuron: AlphaState, p: AlphaParams, ring_exc,
                           ring_inh, t0, drive, clear: bool = True,
                           archive: PostArchive | None = None,
                           minus_table: torch.Tensor | None = None):
    """Plain PyTorch alpha window: :func:`lif_window_plain` with
    ``snn.lif.alpha_step``, step k at the global step ``t0 + k`` (the
    archive, updated in place, records it)."""
    t0 = dispatch.step_on_host(t0)
    ring_len = ring_exc.shape[0]
    spikes = []
    for k in range(drive.shape[0]):
        slot = (t0 + k) % ring_len
        neuron, spk = lif.alpha_step(neuron, p, ring_exc[slot] + drive[k],
                                     ring_inh[slot], t0 + k, archive,
                                     minus_table)
        if clear:
            ring_exc[slot].zero_()
            ring_inh[slot].zero_()
        spikes.append(spk)
    return neuron, torch.stack(spikes, dim=-2)


def lif_alpha_window(neuron: AlphaState, p: AlphaParams, ring_exc,
                     ring_inh, t0, drive, clear: bool = True,
                     archive: PostArchive | None = None,
                     minus_table: torch.Tensor | None = None):
    """:func:`lif_window` for ``iaf_psc_alpha`` in one launch (``t0`` the
    window's first global step, an int or an int32 tensor on the card);
    with ``archive`` (``(..., per, H)`` entries, updated in place) and
    ``minus_table`` (``snn.lif.decay_table`` of tau_minus) each spike is
    appended.  Kernel on CUDA tensors, :func:`lif_alpha_window_plain` on
    CPU tensors."""
    shape = tuple(neuron.v.shape)
    if not shape or drive.dim() != len(shape) + 1 or drive.shape[0] < 1:
        raise ValueError(f"lif_alpha_window: want (..., per) neurons and "
                         f"an (n_steps >= 1, ..., per) drive, got {shape} "
                         f"and {tuple(drive.shape)}")
    n_steps = drive.shape[0]
    ring_len = ring_exc.shape[0] if ring_exc.dim() else 0
    _check("lif_alpha_window", [(f, getattr(neuron, f)) for f in
                                AlphaState._fields[:5]], shape,
           torch.float32)
    _check("lif_alpha_window", (("refrac", neuron.refrac),), shape,
           torch.int32)
    _check("lif_alpha_window", (("ring_exc", ring_exc),
                                ("ring_inh", ring_inh)),
           (ring_len,) + shape, torch.float32)
    _check("lif_alpha_window", (("drive", drive),), (n_steps,) + shape,
           torch.float32)
    if ring_len < 1:
        raise ValueError("lif_alpha_window: empty delay ring")
    on_step = isinstance(t0, torch.Tensor)
    if on_step and (t0.dtype != torch.int32 or t0.numel() < 1):
        raise ValueError(f"lif_alpha_window: a step tensor must be int32 "
                         f"with an element, got {t0.dtype} "
                         f"{tuple(t0.shape)}")
    extra = ()
    if archive is not None:
        if minus_table is None:
            raise ValueError("lif_alpha_window: an archive needs its "
                             "decay table")
        H = archive.step.shape[-1]
        _check("lif_alpha_window", (("archive.step", archive.step),),
               shape + (H,), torch.int32)
        _check("lif_alpha_window", (("archive.kminus", archive.kminus),),
               shape + (H,), torch.float32)
        _check("lif_alpha_window", (("archive.count", archive.count),),
               shape, torch.int32)
        extra = (*archive, minus_table)
    if not dispatch.on_cuda(*neuron, ring_exc, ring_inh, drive, *extra,
                            *((t0,) if on_step else ())):
        return lif_alpha_window_plain(neuron, p, ring_exc, ring_inh, t0,
                                      drive, clear, archive, minus_table)
    if not on_step and t0 < 0:
        raise ValueError("lif_alpha_window: the kernel takes t0 >= 0")
    p11, p21, p31, p32, p33, psc, ref_steps = lif.alpha_propagators(p)
    out = [torch.empty_like(x) for x in neuron]
    per = shape[-1]
    raster = torch.empty(shape[:-1] + (n_steps, per), dtype=torch.bool,
                         device=neuron.v.device)
    arch = ((archive.step.data_ptr(), archive.kminus.data_ptr(),
             archive.count.data_ptr(), minus_table.data_ptr(),
             archive.step.shape[-1], minus_table.numel())
            if archive is not None else (None, None, None, None, 0, 0))
    dispatch.launch("lif_alpha", "repro_lif_alpha_window",
                    *(x.data_ptr() for x in neuron), ring_exc.data_ptr(),
                    ring_inh.data_ptr(), drive.data_ptr(),
                    *(x.data_ptr() for x in out), raster.data_ptr(),
                    neuron.v.numel(), per, n_steps, 0 if on_step else t0,
                    t0.data_ptr() if on_step else None, ring_len,
                    int(clear), p11, p21, p31, p32, p33, psc, ref_steps,
                    p.e_l, p.v_th, p.v_reset, *arch)
    return AlphaState(*out), raster
