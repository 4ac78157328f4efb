"""The LIF window (kernel C's wrapper ``lif_window``) against the reference
on the CPU, where the wrapper runs its plain version.

The reference is ``repro.snn.lif.step`` applied ``window`` times, each step
reading the delay-ring slot ``(t0 + k) % ring_len``, adding the step's
background drive to the excitatory input and clearing the consumed slots,
as ``src/repro/snn/simulator.py:_simulate_steps`` does.  Tolerances are
those of ``tests/test_kernels.py``: v, i_exc, i_inh at rtol 2e-5 / atol
1e-4 (XLA and PyTorch may round the update in another order), refrac,
spikes and the cleared rings exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.snn import lif as r_lif
from repro_torch.kernels import dispatch
from repro_torch.kernels import lif_step as t_ls
from repro_torch.snn import lif as t_lif

P_REF, P_PORT = r_lif.LIFParams(), t_lif.LIFParams()


def _inputs(shape, ring_len, window, seed):
    """State with neurons at threshold and refractory ones, delay rings and
    a Poisson-like drive, all f32/int32 numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    p = P_REF
    v = (p.e_l + (p.v_th - p.e_l + 2.0) * rng.random(shape)).astype(
        np.float32)
    v.reshape(-1)[::7] = p.v_th                        # exactly at threshold
    i_exc = (rng.random(shape) * 500.0).astype(np.float32)
    i_inh = (-rng.random(shape) * 200.0).astype(np.float32)
    refrac = rng.integers(-1, 25, shape).astype(np.int32)
    ring_exc = (rng.random((ring_len,) + shape) * 2000.0).astype(np.float32)
    ring_inh = (-rng.random((ring_len,) + shape) * 300.0).astype(np.float32)
    drive = (rng.poisson(1.3, (window,) + shape) * 87.8).astype(np.float32)
    return (v, i_exc, i_inh, refrac), ring_exc, ring_inh, drive


def _reference(state, ring_exc, ring_inh, t0, drive, clear):
    st = r_lif.LIFState(*(jnp.asarray(x) for x in state))
    ring_exc, ring_inh = jnp.asarray(ring_exc), jnp.asarray(ring_inh)
    spikes = []
    for k in range(drive.shape[0]):
        slot = (t0 + k) % ring_exc.shape[0]
        st, spk = r_lif.step(st, P_REF, ring_exc[slot] + drive[k],
                             ring_inh[slot])
        if clear:
            ring_exc = ring_exc.at[slot].set(0.0)
            ring_inh = ring_inh.at[slot].set(0.0)
        spikes.append(spk)
    return (st, np.asarray(jnp.stack(spikes, axis=-2)), np.asarray(ring_exc),
            np.asarray(ring_inh))


@pytest.mark.parametrize("shape,ring_len,t0,window,clear", [
    ((4, 100), 32, 0, 8, True),        # the simulator's layout
    ((4, 100), 32, 28, 8, True),       # ring wrap: t0 + window > ring_len
    ((4, 100), 32, 29, 8, False),      # wrap, slots left in place
    ((3, 37), 16, 13, 5, True),        # ragged neuron count
    ((1, 1001), 24, 10, 20, True),     # longer than the kernel unrolls
    ((2, 50), 6, 3, 8, True),          # a slot met twice in one window
    ((257,), 12, 7, 3, True),          # one row of neurons
])
def test_lif_window_matches_reference(shape, ring_len, t0, window, clear):
    state, ring_exc, ring_inh, drive = _inputs(shape, ring_len, window,
                                               sum(shape) + t0)
    want, want_spk, want_re, want_ri = _reference(state, ring_exc, ring_inh,
                                                  t0, drive, clear)
    t = lambda a: torch.from_numpy(a.copy())
    re, ri = t(ring_exc), t(ring_inh)
    dispatch.reset_launches()
    got, spk = t_ls.lif_window(t_lif.LIFState(*(t(x) for x in state)),
                               P_PORT, re, ri, t0, t(drive), clear=clear)
    assert dispatch.LAUNCHES == {}             # CPU tensors: plain version
    assert spk.dtype == torch.bool
    assert tuple(spk.shape) == shape[:-1] + (window, shape[-1])
    assert (spk.numpy() == want_spk.astype(bool)).all()
    for name in ("v", "i_exc", "i_inh"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=2e-5, atol=1e-4, err_msg=name)
    assert (got.refrac.numpy() == np.asarray(want.refrac)).all()
    assert (re.numpy() == want_re).all() and (ri.numpy() == want_ri).all()
    if not clear:
        assert (re.numpy() == ring_exc).all()
    assert spk.any(), "threshold path unexercised"
    assert (got.refrac.numpy() > 0).any(), "refractory path unexercised"


def test_lif_window_raster_is_the_step_loop():
    """Row s, step k of the raster is step k's spike of shard s, and the
    state after the window is the one the single-step wrapper reaches."""
    state, ring_exc, ring_inh, drive = _inputs((3, 64), 16, 6, 5)
    t = lambda a: torch.from_numpy(a.copy())
    st = t_lif.LIFState(*(t(x) for x in state))
    got, spk = t_ls.lif_window(st, P_PORT, t(ring_exc), t(ring_inh), 12,
                               t(drive))
    for k in range(6):
        slot = (12 + k) % 16
        st, s_k = t_ls.lif_step(st, P_PORT, t(ring_exc[slot] + drive[k]),
                                t(ring_inh[slot]))
        assert torch.equal(spk[:, k], s_k), k
    for a, b in zip(got, st):
        assert torch.equal(a, b)


def _bad(case):
    state, ring_exc, ring_inh, drive = _inputs((2, 40), 8, 4, 3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = dict(neuron=t_lif.LIFState(*(t(x) for x in state)),
                ring_exc=t(ring_exc), ring_inh=t(ring_inh), drive=t(drive))
    if case == "ring dtype":
        args["ring_exc"] = args["ring_exc"].double()
    elif case == "ring shape":
        args["ring_inh"] = t(ring_inh[..., :-1])
    elif case == "ring not contiguous":
        args["ring_exc"] = t(np.swapaxes(ring_exc, 1, 2).copy()).transpose(
            1, 2)
    elif case == "drive shape":
        args["drive"] = t(drive[:, :1])
    elif case == "refrac dtype":
        args["neuron"] = args["neuron"]._replace(
            refrac=args["neuron"].refrac.float())
    elif case == "empty drive":
        args["drive"] = t(drive[:0])
    return args


@pytest.mark.parametrize("case", ["ring dtype", "ring shape",
                                  "ring not contiguous", "drive shape",
                                  "refrac dtype", "empty drive"])
def test_lif_window_rejects_bad_operands(case):
    """The wrapper checks its operands on every device: a wrong dtype,
    shape or a non-contiguous ring raises before anything runs."""
    args = _bad(case)
    assert case != "ring not contiguous" or \
        not args["ring_exc"].is_contiguous()
    with pytest.raises(ValueError):
        t_ls.lif_window(args["neuron"], P_PORT, args["ring_exc"],
                        args["ring_inh"], 0, args["drive"])
