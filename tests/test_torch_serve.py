"""The multi-tenant spike serving engine, port vs reference on the CPU
(where kernel F's and kernel B's wrappers run their plain versions):

* the credit partitions (layout, guards, the bank) against
  ``repro.core.flow_control``;
* the tenant admission replay, healthy and under a mask, against
  ``jax.jit`` of the reference's ``_admit_tenants`` and
  ``_admit_tenants_faulted`` on every field, over 14
  threaded windows with a pure best-effort tenant (reserve 0), shared-pool
  holds, evictions and detours; a one-tenant fabric with reserve 0 decides
  every row as the single-tenant torus does;
* ``TenantTorusTransport.exchange`` and ``drain_fabric`` on (2, 2, 2) and
  (2, 4), healthy and under chaos masks: every ``TransportOut``,
  ``LinkStats`` and ``FabricState`` field, threaded;
* ``TenantLedger``, ``digests`` and ``tenant_rows``;
* the in-process engine tests of ``tests/test_serve_engine.py`` on the
  port, each against the reference engine's ``EngineReport``;
* 8-shard engine runs: the deployment of ``benchmarks/bench_serve.py`` at
  3 segments, solo and contended, and the link-death case of
  ``tests/test_serve_engine.py``;
* the guards (item 10) and that the new modules import no JAX.

Equal means: integers bit for bit, histograms and p50/p99 equal, max and
mean at rtol 1e-6.  Every 8-device reference case runs in one subprocess
(``md_helper.run_md``); its outputs become numpy before any indexing.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

sys.path.insert(0, os.path.dirname(__file__))
from md_helper import SRC, run_md  # noqa: E402
from repro.core import flow_control as r_fc  # noqa: E402
from repro.fabric import faults as r_faults  # noqa: E402
from repro.serve import loadgen as r_lg, spike_engine as r_se  # noqa: E402
from repro.serve import tenancy as r_ten  # noqa: E402
from repro.transport import base as r_base, torus as r_tt  # noqa: E402
from repro.wire import latency as r_lat  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import flow_control as t_fc  # noqa: E402
from repro_torch.fabric import faults as t_faults  # noqa: E402
from repro_torch.kernels import admission  # noqa: E402
from repro_torch.serve import loadgen as t_lg, spike_engine as t_se  # noqa: E402,E501
from repro_torch.serve import tenancy as t_ten  # noqa: E402
from repro_torch.transport import torus as t_tt  # noqa: E402

# transport-level cases: three tenants (one of them best effort), credits
# tight enough for shared-pool holds
TCASES = {}
for _name, _dims in (("t3", (2, 2, 2)), ("t2", (2, 4))):
    for _sched in ("healthy", "chaos"):
        TCASES[f"{_name}-{_sched}"] = dict(
            dims=_dims, reserve=(8, 0, 4), credits=24, W=4, n_win=8,
            sched=_sched, seed=len(TCASES), hi=12)

# benchmarks/bench_serve.py:140-155, the full deployment, cut to 3 segments
SERVE = dict(capacity=32, link_credits=64, notify_latency=2, window_us=100.0,
             seg_windows=8, nx=2, ny=2, nz=2)
SERVE_TENANTS = (("quiet", 32, 40.0), ("hot", 8, 600.0))
SERVE_SEGMENTS, SERVE_SEED = 3, 7
# tests/test_serve_engine.py:133-178: a cable dies at window 6 of 16
DEATH = dict(capacity=16, link_credits=32, notify_latency=2,
             window_us=100.0, seg_windows=4, nx=2, ny=2, nz=2)
DEATH_TENANTS = (("a", 12, 40.0), ("b", 10, 20.0))


def traffic(case, lg, faults, **kw):
    """A case's per-window counts (S, T, S), payloads (S, T, S, W) and
    masks (numpy), drawn with ``lg`` / ``faults`` of either package."""
    n, T, W = int(np.prod(case["dims"])), len(case["reserve"]), case["W"]
    rng = lg.traffic_rng(case["seed"])
    counts = np.stack([lg.draw_counts(rng, (n, T, n), case["hi"])
                       for _ in range(case["n_win"])])
    payloads = np.stack([lg.draw_payload(rng, (n, T, n, W))
                         for _ in range(case["n_win"])])
    masks = None
    if case["sched"] == "chaos":
        masks = faults.chaos(case["dims"], case["n_win"], case["seed"],
                             revive_p=0.1, **kw).link_down
        masks = masks.numpy() if isinstance(masks, torch.Tensor) else \
            np.asarray(masks)
    return counts, payloads, masks


def engine_parts(pkg_lg, pkg_se, pkg_ten, cfg_kw, tenants, seed, hot=True):
    """(tenant specs, EngineConfig, load generator) of either package."""
    specs = [pkg_ten.TenantSpec(name, reserve=r, rate_epw=rate)
             for name, r, rate in tenants]
    profiles = [pkg_lg.TenantProfile(name, rate if (hot or t == 0) else 0.0,
                                     *((3.0, 0.25) if name == "hot" else ()))
                for t, (name, _, rate) in enumerate(tenants)]
    cfg = pkg_se.EngineConfig(**cfg_kw)
    src = pkg_lg.PoissonLoadGen(seed, profiles, 8, cfg.capacity)
    return specs, cfg, src


REF_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
sys.path.insert(0, %(TESTS)r)
from repro.core import flow_control as fc
from repro.fabric import faults, link_fault
from repro.serve import loadgen as lg, spike_engine as se, tenancy as ten
from repro.transport import torus as tt
import test_torch_serve as T

out = {}
def flat(tree, prefix):
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            flat(getattr(tree, f), prefix + f + ".")
    else:
        out[prefix[:-1]] = np.asarray(tree)     # numpy before any indexing

tm = jax.tree_util.tree_map
mesh = Mesh(np.array(jax.devices()[:8]), ("w",))
spec = P("w")
for key, case in T.TCASES.items():
    t = tt.TenantTorusTransport(8, case["dims"], partition=fc.make_partition(
        case["credits"], case["reserve"]), notify_latency=2,
        max_row_events=case["hi"])
    def body(lstate, p, c):
        lstate = tm(lambda x: x[0], lstate)
        o = t.exchange(lstate, p[0], c[0], axis_name="w")
        return tm(lambda x: x[None], (o.state, o.recv_payload,
                  o.recv_counts, o.sent_mask, o.sent_now, o.stats,
                  o.unparked_now, o.queue_us, o.park_wait_us, o.links_used))
    def dbody(lstate):
        lstate = tm(lambda x: x[0], lstate)
        o = t.drain_fabric(lstate, axis_name="w")
        return tm(lambda x: x[None], (o.state, o.recv_payload,
                                      o.recv_counts, o.stats))
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                           out_specs=spec, check_rep=False))
    walk = jax.jit(shard_map(dbody, mesh=mesh, in_specs=(spec,),
                             out_specs=spec, check_rep=False))
    counts, payloads, masks = T.traffic(case, lg, faults)
    lstate = tm(lambda x: jnp.broadcast_to(x, (8,) + x.shape),
                t.init_state(case["W"]))
    for w in range(case["n_win"]):
        if masks is not None:
            lstate = lstate._replace(link_down=jnp.broadcast_to(
                jnp.asarray(masks[w]), (8,) + masks[w].shape))
        res = fn(lstate, jnp.asarray(payloads[w]), jnp.asarray(counts[w]))
        lstate = res[0]
        for name, x in zip(("state", "recv_payload", "recv_counts",
                            "sent_mask", "sent_now", "stats", "unparked_now",
                            "queue_us", "park_wait_us", "links_used"), res):
            flat(x, "t.%%s.w%%d.%%s." %% (key, w, name))
    for name, x in zip(("state", "recv_payload", "recv_counts", "stats"),
                       walk(lstate)):
        flat(x, "t.%%s.drain.%%s." %% (key, name))

def report(rep, prefix):
    for f in ("injected", "delivered", "shed", "clipped"):
        out[prefix + f] = getattr(rep, f)
    out[prefix + "ints"] = np.array([rep.windows, rep.drain_windows,
                                     int(rep.conservation_checked)])
    for d in rep.tenants:
        out[prefix + d.name + ".hist"] = d.hist
        out[prefix + d.name + ".lat"] = np.array(
            [d.p50_us, d.p99_us, d.max_us, d.mean_us, d.delivered])

for label, hot in (("solo", False), ("contended", True)):
    specs, cfg, src = T.engine_parts(lg, se, ten, T.SERVE, T.SERVE_TENANTS,
                                     T.SERVE_SEED, hot)
    report(se.SpikeEngine(mesh, "w", specs, cfg, src).run(T.SERVE_SEGMENTS),
           "serve.%%s." %% label)
specs, cfg, src = T.engine_parts(lg, se, ten, T.DEATH, T.DEATH_TENANTS, 0)
sched = link_fault((2, 2, 2), 64, 0, 0, start=6)
report(se.SpikeEngine(mesh, "w", specs, cfg, src, fault_schedule=sched).run(4),
       "death.")
np.savez(%(PATH)r, **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "serve.npz")
    out = run_md(REF_SCRIPT % dict(TESTS=os.path.dirname(
        os.path.abspath(__file__)), PATH=path), n_devices=8, timeout=900)
    assert "REF_OK" in out
    with np.load(path) as f:
        return dict(f)


def _t(a) -> torch.Tensor:
    a = np.array(a, order="C")
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _ref_state(state, width):
    f = lambda x: jnp.asarray(x.numpy())
    return r_base.FabricState(
        bank=r_fc.CreditBank(*(f(x) for x in state.bank)),
        parked_count=f(state.parked_count), parked_hop=f(state.parked_hop),
        parked_age=f(state.parked_age),
        parked_by_link=f(state.parked_by_link),
        parked_payload=jnp.zeros(state.parked_count.shape[:2] + (width,),
                                 jnp.uint32),
        parked_hold_shared=f(state.parked_hold_shared))


def _check_tree(got: dict, ref: dict, prefix: str, replicated=()):
    keys = [k[len(prefix):] for k in ref if k.startswith(prefix)]
    assert keys, prefix
    for key in keys:
        want, have = ref[prefix + key], got[key]
        if key in replicated:           # the reference's per-shard copies
            assert (want == want[:1]).all(), key
            want = want[0]
        if want.dtype == np.uint32:
            have = have.astype(np.int32).view(np.uint32)
        assert have.shape == want.shape, (prefix, key, have.shape,
                                          want.shape)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-6,
                                       err_msg=prefix + key)
        else:
            assert (have == want).all(), (prefix, key)


# ---------------------------------------------------------------------------
# Credit partitions.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("credits,reserve,n_links", [
    (64, (32, 8), 48), (24, (8, 0, 6), 32), (16, (0,), 6), (10, (10,), 4)])
def test_partitions_match_reference(credits, reserve, n_links):
    a = t_fc.make_partition(credits, reserve)
    b = r_fc.make_partition(credits, reserve)
    assert tuple(a) == tuple(b)
    assert (a.n_tenants, a.limit, a.n_slots_per_link) == (
        b.n_tenants, b.limit, b.n_slots_per_link)
    lim = t_fc.partition_limits(a, n_links, device="cpu")
    assert (lim.numpy() == np.asarray(r_fc.partition_limits(b, n_links))).all()
    bank = t_fc.init_partitioned_credits(a, n_links, 2, device="cpu")
    want = r_fc.init_partitioned_credits(b, n_links, 2)
    for x, y in zip(bank, want):
        assert x.numpy().shape == np.asarray(y).shape
        assert (x.numpy() == np.asarray(y)).all()
    assert bank.credits.data_ptr() != lim.data_ptr()
    for bad in ((), (-1, 4), (40, 30)):
        for fc in (t_fc, r_fc):
            with pytest.raises(ValueError):
                fc.make_partition(64, bad)


# ---------------------------------------------------------------------------
# The tenant admission loops.
# ---------------------------------------------------------------------------

def _evicted(t, state, down):
    """The reference's eviction set over the (T, S, S) rows (numpy)."""
    seq0 = t._link_seq_alt[0]
    pc = state.parked_count.numpy().reshape(-1)
    ph = state.parked_hop.numpy().reshape(-1)
    down = down.numpy()
    seq = seq0[np.arange(pc.size) % seq0.shape[0]]
    hop = np.arange(seq.shape[1])
    dead = (seq >= 0) & down[np.maximum(seq, 0)]
    rem = (dead & (hop >= ph[:, None])).any(-1)
    held = np.take_along_axis(seq, np.maximum(ph - 1, 0)[:, None], 1)[:, 0]
    return (pc > 0) & ((ph == 0) | rem | ((ph >= 1)
                                         & down[np.maximum(held, 0)]))


@pytest.mark.parametrize("dims", [(2, 2, 2), (2, 4)])
def test_tenant_admission_matches_reference(dims):
    """The tenant replay, healthy and under a mask, against the
    reference's replays on the states of 14 windows threaded through the
    port's transport: healthy for 4 windows, then under chaos masks
    (evictions, detours); a best-effort tenant (reserve 0) and
    shared-pool holds."""
    n = int(np.prod(dims))
    reserve = (8, 0, 4)
    T = len(reserve)
    t = t_tt.TenantTorusTransport(n, dims, partition=t_fc.make_partition(
        24, reserve), notify_latency=2, max_row_events=12)
    r = r_tt.TenantTorusTransport(n, dims, partition=r_fc.make_partition(
        24, reserve), notify_latency=2, max_row_events=12)
    healthy, faulted = jax.jit(r._admit_tenants), jax.jit(
        r._admit_tenants_faulted)
    masks = _t(np.asarray(r_faults.chaos(dims, 14, 3,
                                         revive_p=0.1).link_down))
    limits = t_fc.partition_limits(t.partition, n * t.n_links, device="cpu")
    rng = np.random.default_rng(n)
    state = t.init_state(4, device="cpu")
    seen = dict(hold_shared=0, evicted=0, rerouted=0, parked=0, best=0)
    for w in range(14):
        counts = rng.integers(0, 13, (n, T, n)).astype(np.int32)
        down = masks[w] if w >= 4 else None
        counts_all = _t(counts.transpose(1, 0, 2))
        got = t._admit_tenants(state, counts_all, down)
        want = (healthy(_ref_state(state, 4), jnp.asarray(counts_all))
                if down is None else
                faulted(_ref_state(state, 4), jnp.asarray(counts_all),
                        jnp.asarray(down.numpy())))
        assert got._fields == want._fields
        for field in got._fields:
            a, b = getattr(got, field), getattr(want, field)
            if a is None:
                assert b is None, field
                continue
            b = np.asarray(b)
            assert a.shape == b.shape and (a.numpy() == b).all(), (w, field)
        seen["hold_shared"] += int((got.hold_shared > 0).sum())
        seen["rerouted"] += int(got.rerouted.sum())
        seen["parked"] += int(got.fresh_park.sum())
        seen["best"] += int((got.fresh_complete[1] | got.fresh_park[1]).sum())
        if down is not None:
            seen["evicted"] += int(_evicted(t, state, down).sum())
        payload = _t(rng.integers(0, 1 << 30, (n, T, n, 4)).astype(np.int32))
        state = t.exchange(state._replace(link_down=down), payload,
                           _t(counts)).state
        held = state.bank.credits + state.bank.pending.sum(-1) \
            + state.parked_by_link
        assert torch.equal(held, limits), w
        if down is not None:
            dead = torch.cat([down] * (T + 1))
            assert int(state.parked_by_link[dead].abs().sum()) == 0, w
    assert all(v > 0 for v in seen.values()), seen


def test_one_tenant_with_no_reserve_is_the_single_tenant_torus():
    """A one-tenant fabric with reserve 0 (all credits shared) decides every
    row as the single-tenant torus, on threaded windows, healthy and under
    a mask; its spends and holds all land on the shared slots."""
    n, dims = 8, (2, 4)
    single = t_tt.TorusTransport(n, dims, link_credits=16, notify_latency=2,
                                 max_row_events=16, stall_attribution=True)
    tenant = t_tt.TenantTorusTransport(n, dims, partition=t_fc.make_partition(
        16, (0,)), notify_latency=2, max_row_events=16,
        stall_attribution=True)
    K = n * single.n_links
    masks = t_faults.chaos(dims, 10, 1, device="cpu").link_down
    rng = np.random.default_rng(5)
    s1, s2 = single.init_state(4, device="cpu"), tenant.init_state(
        4, device="cpu")
    for w in range(10):
        counts = _t(rng.integers(0, 17, (n, n)).astype(np.int32))
        down = masks[w] if w >= 3 else None
        a = single._admit_global(s1, counts, down)
        b = tenant._admit_tenants(s2, counts[None], down)
        for field in a._fields:
            x, y = getattr(a, field), getattr(b, field)
            if field in ("spent", "notify", "parked_by_link"):
                assert not y[:K].any(), (w, field)
                y = y[K:]
            elif field != "stalled_by_link":      # physical in both forms
                y = y[0]
            assert torch.equal(x, y), (w, field)
        # every hold is shared; a row parked at hop 0 holds nothing
        assert torch.equal(b.hold_shared[0], torch.where(
            b.park_hop[0] > 0, b.park_count[0], 0)), w
        payload = _t(rng.integers(0, 1 << 30, (n, n, 4)).astype(np.int32))
        s1 = single.exchange(s1._replace(link_down=down), payload,
                             counts).state
        s2 = tenant.exchange(s2._replace(link_down=down), payload[:, None],
                             counts[:, None]).state
        assert torch.equal(s1.parked_count, s2.parked_count[0])


# ---------------------------------------------------------------------------
# The transport: exchange and drain, threaded.
# ---------------------------------------------------------------------------

GLOBAL_STATE = ("bank.credits", "bank.pending", "bank.epoch", "parked_count",
                "parked_hop", "parked_age", "parked_by_link",
                "parked_hold_shared")


@pytest.mark.parametrize("key", list(TCASES))
def test_tenant_transport_matches_reference(ref, key):
    case = TCASES[key]
    t = t_tt.TenantTorusTransport(
        8, case["dims"], partition=t_fc.make_partition(case["credits"],
                                                       case["reserve"]),
        notify_latency=2, max_row_events=case["hi"])
    counts, payloads, masks = traffic(case, t_lg, t_faults, device="cpu")
    state = t.init_state(case["W"], device="cpu")
    seen = dict(parked=0, unparked=0, rerouted=0, hold_shared=0)
    for w in range(case["n_win"]):
        down = None if masks is None else torch.from_numpy(masks[w])
        out = t.exchange(state._replace(link_down=down), _t(payloads[w]),
                         _t(counts[w]))
        state = out.state
        p = f"t.{key}.w{w}."
        _check_tree(convert.flatten(out.stats), ref, p + "stats.")
        _check_tree(convert.flatten(out.state), ref, p + "state.",
                    replicated=GLOBAL_STATE)
        for name in ("recv_payload", "recv_counts", "sent_mask", "sent_now",
                     "unparked_now"):
            _check_tree({"": getattr(out, name).numpy()}, ref, p + name)
        for name in ("queue_us", "park_wait_us"):
            _check_tree({"": getattr(out, name).numpy()}, ref, p + name,
                        replicated=("",))
        if masks is None:
            assert out.links_used is None and p + "links_used" not in ref
        else:
            _check_tree({"": out.links_used.numpy()}, ref, p + "links_used",
                        replicated=("",))
        seen["parked"] += int(out.stats.parked_events.sum())
        seen["unparked"] += int(out.stats.unparked_events.sum())
        seen["rerouted"] += int(out.stats.rerouted.sum())
        seen["hold_shared"] += int((state.parked_hold_shared > 0).sum())
    drain = t.drain_fabric(state)
    d = f"t.{key}.drain."
    _check_tree(convert.flatten(drain.stats), ref, d + "stats.")
    _check_tree(convert.flatten(drain.state), ref, d + "state.",
                replicated=GLOBAL_STATE)
    _check_tree({"": drain.recv_counts.numpy()}, ref, d + "recv_counts")
    _check_tree({"": drain.recv_payload.numpy()}, ref, d + "recv_payload")
    limits = t_fc.partition_limits(t.partition, 8 * t.n_links, device="cpu")
    assert torch.equal(drain.state.bank.credits
                       + drain.state.bank.pending.sum(-1), limits)
    assert all(seen[k] > 0 for k in ("parked", "unparked", "hold_shared"))
    assert (seen["rerouted"] > 0) == (masks is not None)


# ---------------------------------------------------------------------------
# The ledger.
# ---------------------------------------------------------------------------

def test_ledger_digests_and_rows_match_reference():
    rng = np.random.default_rng(0)
    names = ("quiet", "hot", "best")
    specs = [(n, r, rate) for n, r, rate in zip(names, (32, 8, 0),
                                                 (40.0, 600.0, 5.0))]
    a, b = t_ten.TenantLedger(names), r_ten.TenantLedger(names)
    for _ in range(5):
        inj = rng.integers(0, 100, 3)
        clip = rng.integers(0, 5, 3)
        d = rng.integers(0, 50, (4, 8, 3))
        shed = rng.integers(0, 5, (4, 8, 3))
        hist = rng.integers(0, 9, (4, 8, 3, r_lat.N_LATENCY_BINS))
        hist[..., 2] = 0
        mx = rng.random((4, 8, 3)) * 100
        mean = rng.random((4, 8, 3)) * 10
        for led in (a, b):
            led.add_injected(inj, clip)
            led.add_windows(d, shed, hist, mx, mean)
    for f in ("injected", "clipped", "delivered", "shed", "hist"):
        assert (getattr(a, f) == getattr(b, f)).all(), f
    for x, y in zip(a.digests(), b.digests()):
        assert (x.name, x.delivered, x.p50_us, x.p99_us) == (
            y.name, y.delivered, y.p50_us, y.p99_us)
        assert (x.hist == y.hist).all()
        np.testing.assert_allclose([x.max_us, x.mean_us],
                                   [y.max_us, y.mean_us], rtol=1e-6)
    rows_a = t_ten.tenant_rows([t_ten.TenantSpec(*s) for s in specs], a, 2)
    rows_b = r_ten.tenant_rows([r_ten.TenantSpec(*s) for s in specs], b, 2)
    assert rows_a == rows_b
    for led in (a, b):
        with pytest.raises(AssertionError, match="conservation"):
            led.check_conservation()
    assert t_ten.guaranteed_epw(t_ten.TenantSpec("q", 32), 2) == 16.0
    assert tuple(t_ten.credit_partition([t_ten.TenantSpec("q", 32),
                                         t_ten.TenantSpec("h", 8)], 64)) == \
        ((32, 8), 24)
    fab = t_ten.build_fabric(8, [t_ten.TenantSpec("q", 32)], link_credits=64)
    assert fab.dims == (2, 2, 2) and fab.n_tenants == 1
    with pytest.raises(ValueError, match="nx/ny/nz"):
        t_ten.build_fabric(8, [t_ten.TenantSpec("q", 32)], link_credits=64,
                           nx=2)


# ---------------------------------------------------------------------------
# The engine, in process: tests/test_serve_engine.py on the port, each
# against the reference engine.
# ---------------------------------------------------------------------------

def make_engine(pkg="port", seed=3, rate_b=30.0, **cfg_kw):
    lg, se, ten = (t_lg, t_se, t_ten) if pkg == "port" else (r_lg, r_se,
                                                             r_ten)
    tenants = [ten.TenantSpec("a", reserve=8, rate_epw=10.0),
               ten.TenantSpec("b", reserve=4, rate_epw=rate_b)]
    kw = dict(capacity=8, link_credits=16, seg_windows=3, nx=1, ny=1, nz=1)
    kw.update(cfg_kw)
    cfg = se.EngineConfig(**kw)
    src = lg.PoissonLoadGen(seed, [lg.TenantProfile("a", 10.0),
                                   lg.TenantProfile("b", rate_b,
                                                    burst_factor=2.0,
                                                    burst_prob=0.3)],
                            1, cfg.capacity)
    if pkg == "port":
        return se.SpikeEngine(1, tenants, cfg, src, device="cpu")
    return se.SpikeEngine(Mesh(np.array(jax.devices()[:1]), ("w",)), "w",
                          tenants, cfg, src)


def same_report(a, b):
    """Port report ``a`` equal to reference report ``b``."""
    for f in ("injected", "delivered", "shed", "clipped"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), (
            f, getattr(a, f), getattr(b, f))
    assert (a.windows, a.drain_windows, a.conservation_checked) == (
        b.windows, b.drain_windows, b.conservation_checked)
    for x, y in zip(a.tenants, b.tenants):
        assert (x.name, x.delivered, x.p50_us, x.p99_us) == (
            y.name, y.delivered, y.p50_us, y.p99_us)
        assert np.array_equal(x.hist, y.hist)
        np.testing.assert_allclose([x.max_us, x.mean_us],
                                   [y.max_us, y.mean_us], rtol=1e-6)


@pytest.mark.timeout(300)
def test_engine_conserves_every_tenant():
    eng = make_engine()
    rep = eng.run(5)
    assert rep.conservation_checked
    assert np.all(rep.injected == rep.delivered + rep.shed)
    assert rep.delivered.sum() > 0
    assert rep.windows == 5 * 3
    assert eng.backlog_events() == 0
    assert eng.in_fabric_events() == 0
    same_report(rep, make_engine("ref").run(5))


@pytest.mark.timeout(300)
def test_engine_overload_is_counted_not_hidden():
    kw = dict(rate_b=500.0, capacity=32, link_credits=40)
    rep = make_engine(**kw).run(4)
    assert rep.clipped[1] > 0
    assert np.all(rep.injected == rep.delivered + rep.shed)
    assert rep.clipped[0] == 0 and rep.shed[0] == 0
    same_report(rep, make_engine("ref", **kw).run(4))


@pytest.mark.timeout(300)
def test_engine_deterministic_across_runs():
    r1 = make_engine(seed=11).run(4)
    r2 = make_engine(seed=11).run(4)
    same_report(r1, r2)
    same_report(r1, make_engine("ref", seed=11).run(4))
    r3 = make_engine(seed=12).run(4)
    assert not np.array_equal(r1.injected, r3.injected)


@pytest.mark.timeout(300)
def test_engine_continuous_start_stop():
    eng = make_engine()
    eng.start()
    time.sleep(1.0)
    rep = eng.stop()
    assert rep.conservation_checked and rep.windows > 0
    assert np.all(rep.injected == rep.delivered + rep.shed)
    with pytest.raises(RuntimeError):
        eng.stop()
    # whatever it served, the reference serves the same segments alike
    same_report(rep, make_engine("ref").run(rep.windows // 3))


@pytest.mark.timeout(300)
def test_engine_latency_attribution_counts_delivered():
    eng = make_engine()
    rep = eng.run(5)
    for t, dig in enumerate(rep.tenants):
        assert dig.hist.sum() == rep.delivered[t]
        if dig.delivered:
            assert dig.p99_us >= dig.p50_us
    # the per-window host copies add up to the report (before the drain)
    served = sum(ws.delivered.sum((0, 1)) for ws in eng.window_stats)
    assert (served <= rep.delivered).all() and len(eng.window_stats) >= 5


@pytest.mark.timeout(300)
def test_engine_rejects_mismatched_source():
    src = t_lg.PoissonLoadGen(0, [t_lg.TenantProfile("a", 1.0)], 1, 8)
    cfg = t_se.EngineConfig(capacity=8, link_credits=16, nx=1, ny=1, nz=1)
    specs = [t_ten.TenantSpec("a", 8), t_ten.TenantSpec("b", 4)]
    with pytest.raises(ValueError):
        t_se.SpikeEngine(1, specs, cfg, src, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        t_se.SpikeEngine(2, specs[:1], cfg, src, device="cpu")


# ---------------------------------------------------------------------------
# 8-shard engine runs.
# ---------------------------------------------------------------------------

def _port_report(rep, prefix, ref):
    for f in ("injected", "delivered", "shed", "clipped"):
        assert np.array_equal(getattr(rep, f), ref[prefix + f]), (prefix, f)
    assert [rep.windows, rep.drain_windows,
            int(rep.conservation_checked)] == ref[prefix + "ints"].tolist()
    for d in rep.tenants:
        assert np.array_equal(d.hist, ref[prefix + d.name + ".hist"])
        want = ref[prefix + d.name + ".lat"]
        assert [d.p50_us, d.p99_us, d.delivered] == [want[0], want[1],
                                                     want[4]]
        np.testing.assert_allclose([d.max_us, d.mean_us], want[2:4],
                                   rtol=1e-6)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("label", ["solo", "contended"])
def test_engine_serving_deployment_matches_reference(ref, label):
    specs, cfg, src = engine_parts(t_lg, t_se, t_ten, SERVE, SERVE_TENANTS,
                                   SERVE_SEED, label == "contended")
    eng = t_se.SpikeEngine(8, specs, cfg, src, device="cpu")
    rep = eng.run(SERVE_SEGMENTS)
    assert rep.conservation_checked
    assert np.all(rep.injected == rep.delivered + rep.shed)
    _port_report(rep, f"serve.{label}.", ref)
    if label == "contended":
        assert rep.shed[1] > 0 and rep.shed[0] == 0


@pytest.mark.timeout(600)
def test_engine_link_death_mid_segment_conserves(ref):
    specs, cfg, src = engine_parts(t_lg, t_se, t_ten, DEATH, DEATH_TENANTS, 0)
    sched = t_faults.link_fault((2, 2, 2), 64, 0, 0, start=6, device="cpu")
    rep = t_se.SpikeEngine(8, specs, cfg, src, fault_schedule=sched,
                           device="cpu").run(4)
    assert rep.conservation_checked and rep.windows == 16
    assert np.all(rep.injected == rep.delivered + rep.shed)
    for t, dig in enumerate(rep.tenants):
        assert dig.hist.sum() == rep.delivered[t] > 0
    _port_report(rep, "death.", ref)


# ---------------------------------------------------------------------------
# Guards.
# ---------------------------------------------------------------------------

def test_serve_guards():
    src = t_lg.PoissonLoadGen(0, [t_lg.TenantProfile("a", 1.0)], 1, 8)
    cfg = t_se.EngineConfig(capacity=8, link_credits=16, nx=1, ny=1, nz=1)
    specs = [t_ten.TenantSpec("a", 8)]
    # the flight recorder and the tracer (item 10) are ported: an engine
    # takes them, and one built without a recorder has no rows to give
    from repro_torch import obs
    eng = t_se.SpikeEngine(1, specs, cfg, src, device="cpu",
                           recorder=obs.RecorderConfig(4),
                           tracer=obs.Tracer())
    assert len(eng._carry) == 5 and eng.transport.stall_attribution
    eng = t_se.SpikeEngine(1, specs, cfg, src, device="cpu")
    with pytest.raises(RuntimeError, match="without a flight recorder"):
        eng.recorder_rows()
    reg = obs.Registry()
    t_ten.TenantLedger(["a"]).export_metrics(reg)
    assert "tenant_injected_events_total" in obs.prometheus_text(reg)
    assert t_ten.build_fabric(8, specs, link_credits=16,
                              stall_attribution=True).stall_attribution
    with pytest.raises(ValueError, match="oversubscribed"):
        t_ten.build_fabric(8, specs * 3, link_credits=16)
    with pytest.raises(ValueError, match="head-of-line"):
        t_ten.build_fabric(8, specs, link_credits=16, max_row_events=32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_se.SpikeEngine(1, specs, cfg, src)
    # the tenant replay refuses operands of another shape or type
    tr = t_ten.build_fabric(8, [t_ten.TenantSpec("a", 8),
                                t_ten.TenantSpec("b", 4)], link_credits=16)
    st = tr.init_state(4, device="cpu")
    routes = tr._dev(torch.device("cpu"))["routes"]
    counts = torch.full((2, 8, 8), 3, dtype=torch.int32)
    got = admission.admission_tenants(counts, st, routes)
    want = admission.admission_tenants_plain(counts, st, routes)
    assert all(torch.equal(x, y) for x, y in zip(got[:-1], want[:-1]))
    assert got.stalled_by_link is None
    for bad in (counts.to(torch.int64), counts[:, :4], counts.reshape(
            2, 4, 16)):
        with pytest.raises(ValueError, match="admission: counts must be"):
            admission.admission_tenants(bad, st, routes)
    with pytest.raises(ValueError, match="parked_count"):     # 1 tenant
        admission.admission_tenants(counts[:1], st, routes)
    with pytest.raises(ValueError, match="parked_hold_shared"):
        admission.admission_tenants(counts, st._replace(
            parked_hold_shared=st.parked_hold_shared[:, :4]), routes)
    with pytest.raises(ValueError, match="link_down"):
        admission.admission_tenants(counts, st, routes,
                                    torch.zeros(47, dtype=torch.bool))
    assert admission.shared_bytes(64, 48, 2) == 4 * (3 * 144 + 96 + 4 * 128)
    assert admission.shared_bytes(64, 48) == 4 * (4 * 48 + 4 * 64)
    with pytest.raises(ValueError, match="tenant transport wants"):
        tr.exchange(st, torch.zeros((8, 8, 4), dtype=torch.int32),
                    torch.zeros((8, 8), dtype=torch.int32))


def test_serve_modules_import_no_jax():
    code = ("import sys, repro_torch.serve, repro_torch.serve.spike_engine, "
            "repro_torch.serve.tenancy, repro_torch.core.flow_control, "
            "repro_torch.kernels.admission, repro_torch.transport.torus; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=SRC))
