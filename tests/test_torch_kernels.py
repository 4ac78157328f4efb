"""Port vs reference for the modules that hold kernels, on the CPU (where
each wrapper runs its plain version):

* placement: ``fused_aggregate`` / ``fused_route_aggregate`` against the
  reference's with the Pallas placement body in interpret mode, on ragged
  shapes, residue and residue meta included, bit for bit;
* LIF: the plain step against ``repro.snn.lif.step`` and the reference's
  Pallas kernel (interpret), at the tolerances of ``tests/test_kernels.py``
  (v rtol 2e-5 / atol 1e-4, i_exc rtol 1e-6, spikes and refrac exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as r_ev, routing as r_rt
from repro.kernels import fused_route_bucket as r_frb, ops as r_ops
from repro.snn import lif as r_lif
from repro_torch.kernels import dispatch
from repro_torch.kernels import fused_route_bucket as t_frb
from repro_torch.kernels import lif_step as t_lif_step
from repro_torch.snn import lif as t_lif


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def _window(n, d, seed, addr_hi=1 << 14):
    rng = np.random.default_rng(seed)
    words = np.array(r_ev.pack(jnp.asarray(rng.integers(0, addr_hi, n)),
                               jnp.asarray(rng.integers(0, 1 << 15, n)),
                               valid=jnp.asarray(rng.random(n) < 0.9)))
    dest = rng.integers(-1, d + 1, n).astype(np.int32)   # out of range too
    meta = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return words, dest, meta


def _assert_window_equal(got, want, with_meta=True):
    assert (_u32(got.buckets.data) == np.asarray(want.buckets.data)).all()
    assert (got.buckets.guids.numpy() == np.asarray(want.buckets.guids)).all()
    assert (got.buckets.counts.numpy()
            == np.asarray(want.buckets.counts)).all()
    for field in ("deferred", "dropped", "offered"):
        assert int(getattr(got, field)) == int(getattr(want, field)), field
    assert int(got.buckets.overflow) == int(want.buckets.overflow)
    assert (_u32(got.residue) == np.asarray(want.residue)).all()
    if with_meta:
        assert (got.residue_meta.numpy()
                == np.asarray(want.residue_meta)).all()


@pytest.mark.parametrize("n,d,c,r", [
    (1000, 7, 33, 128),     # the ROADMAP-named ragged case
    (257, 13, 19, 300),     # residue longer than the window
    (129, 5, 31, 0),        # no residue
    (1000, 9, 124, 64),
    (63, 7, 1, 16),
])
def test_fused_aggregate_matches_reference_pallas(n, d, c, r):
    words, dest, meta = _window(n, d, n + d * c)
    want = r_frb.fused_aggregate(
        jnp.asarray(words), jnp.asarray(dest), jnp.asarray(meta), d, c,
        residue_len=r, use_pallas=True, interpret=True,
        with_residue_meta=True)
    got = t_frb.fused_aggregate(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(dest),
        torch.from_numpy(meta), d, c, residue_len=r, with_residue_meta=True)
    _assert_window_equal(got, want)


@pytest.mark.parametrize("n,d,c,r", [(1000, 7, 33, 64), (200, 11, 13, 0)])
def test_fused_route_aggregate_matches_reference_pallas(n, d, c, r):
    """The LUT-routed variant, whose GUID gather runs inside placement;
    addresses past the table clamp to its last entry."""
    n_addr = 96
    projs = [r_rt.Projection(a, a + 1, dest_node=a % d, dest_links=[a % 3])
             for a in range(0, n_addr, 2)]       # half the addrs unrouted
    tabs = r_rt.build_tables(n_addr, projs, n_guid=64)
    words, _, _ = _window(n, d, n * c, addr_hi=n_addr + 16)
    want = r_frb.fused_route_aggregate(
        jnp.asarray(words), tabs.dest_of_addr, tabs.guid_of_addr, d, c,
        residue_len=r, use_pallas=True, interpret=True)
    got = t_frb.fused_route_aggregate(
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(np.array(tabs.dest_of_addr)),
        torch.from_numpy(np.array(tabs.guid_of_addr)), d, c,
        residue_len=r)
    _assert_window_equal(got, want, with_meta=False)


def test_fused_aggregate_batched_equals_rows():
    """A (B, n) batch (the simulator's shards) gives each row's result."""
    rows = [_window(300, 4, s) for s in range(3)]
    stack = lambda i, dt: torch.from_numpy(np.stack([r[i] for r in rows])
                                           .view(dt))
    got = t_frb.fused_aggregate(stack(0, np.int32), stack(1, np.int32),
                                stack(2, np.int32), 4, 16, residue_len=32,
                                with_residue_meta=True)
    for b, (w, d, m) in enumerate(rows):
        one = t_frb.fused_aggregate(torch.from_numpy(w.view(np.int32)),
                                    torch.from_numpy(d), torch.from_numpy(m),
                                    4, 16, residue_len=32,
                                    with_residue_meta=True)
        assert (got.buckets.data[b] == one.buckets.data).all()
        assert (got.buckets.guids[b] == one.buckets.guids).all()
        assert (got.residue[b] == one.residue).all()
        assert (got.residue_meta[b] == one.residue_meta).all()
        assert got.offered[b] == one.offered and \
            got.deferred[b] == one.deferred


def test_placement_wrapper_takes_plain_version_on_cpu():
    words, dest, meta = _window(200, 5, 9)
    skey, swords, smeta = t_frb.sort_by_destination(
        torch.from_numpy(words.view(np.int32))[None],
        torch.from_numpy(dest)[None], 5, torch.from_numpy(meta)[None])
    ops = t_frb.placement_operands(skey, swords, smeta, 5, 16, routed=False)
    dispatch.reset_launches()
    a = t_frb.placement(*ops, 16, routed=False)
    b = t_frb.placement_plain(*ops, 16, routed=False)
    assert all((x == y).all() for x, y in zip(a, b))
    assert dispatch.LAUNCHES == {}


@pytest.mark.parametrize("n", [64, 100, 1024, 3000])
def test_lif_step_matches_reference(n):
    p = r_lif.LIFParams()
    tp = t_lif.LIFParams()
    st_r = r_lif.init_state(n, p, jax.random.PRNGKey(1))
    st_t = t_lif.LIFState(*(torch.from_numpy(np.array(x)) for x in st_r))
    st_k = st_r
    rng = np.random.default_rng(n)
    total = 0
    for t in range(20):
        exc = (rng.random(n) * 2000).astype(np.float32)
        inh = (-rng.random(n) * 300).astype(np.float32)
        st_r, s_r = r_lif.step(st_r, p, jnp.asarray(exc), jnp.asarray(inh),
                               100.0)
        st_k, s_k = r_ops.lif_step(st_k, p, jnp.asarray(exc),
                                   jnp.asarray(inh), 100.0)
        st_t, s_t = t_lif_step.lif_step(st_t, tp, torch.from_numpy(exc),
                                        torch.from_numpy(inh), 100.0)
        for want_st, want_s in ((st_r, s_r), (st_k, s_k)):
            assert (s_t.numpy() == np.asarray(want_s).astype(bool)).all(), t
            np.testing.assert_allclose(st_t.v.numpy(), np.asarray(want_st.v),
                                       rtol=2e-5, atol=1e-4)
            np.testing.assert_allclose(st_t.i_exc.numpy(),
                                       np.asarray(want_st.i_exc), rtol=1e-6)
            np.testing.assert_allclose(st_t.i_inh.numpy(),
                                       np.asarray(want_st.i_inh), rtol=1e-6)
            assert (st_t.refrac.numpy() == np.asarray(want_st.refrac)).all()
        total += int(s_t.sum())
    assert total > 0, "no spikes exercised the threshold path"


@pytest.mark.parametrize("dt,tau_m", [(0.1, 10.0), (0.05, 20.0), (0.2, 5.0)])
def test_lif_propagators_match_reference(dt, tau_m):
    p = r_lif.LIFParams(dt=dt, tau_m=tau_m)
    want = r_lif.propagators(p)
    got = t_lif.propagators(t_lif.LIFParams(dt=dt, tau_m=tau_m))
    np.testing.assert_allclose(got[:3], [float(x) for x in want[:3]],
                               rtol=1e-6)
    assert got[3] == want[3]
