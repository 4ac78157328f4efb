"""Fault injection, port vs reference on the CPU (where kernel F's wrapper
runs its plain version, the one admission replay):

* the schedules of ``fabric.faults`` (every constructor, ``mask_at``'s
  clamp, ``cable_links``, ``link_label``, ``transitions``, ``chaos`` for
  seeds 0-4), equal as numpy bool arrays;
* the detours of ``core.torus`` and the transport's detour tables;
* the faulted admission replay against ``jax.jit(_admit_global_faulted)``
  on every field, on states threaded through 8 windows under chaos
  masks, and the all-false mask against the healthy replay;
* transport-level windows under faults (every ``LinkStats`` and
  ``FabricState`` field, the received rows, ``links_used``) and the drain
  after them, on the single-link-down case of ``tests/test_faults.py`` and
  the chaos fuzz's configurations of ``tests/test_fabric_fuzz.py``;
* the simulator's fault matrix of ``benchmarks/bench_microcircuit.py``
  (scale 0.01, 8 shards, torus3d 2x2x2, credits 48, 12 windows) from the
  reference's initial state and replayed drive: every integer
  ``WindowStats`` field of every window, latency within rtol 1e-6;
* the guards, and that the new modules import no JAX.

The reference runs once, in one subprocess with 8 forced host devices
(``md_helper.run_md``); its outputs become numpy before any per-shard
indexing.

Run as a script, ``PYTHONPATH=src python tests/test_torch_faults.py``
runs the fault matrix for the 40 windows of ``BENCH_microcircuit.json``,
reference and port, and prints both beside the file's numbers.
"""
import itertools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from md_helper import SRC, run_md  # noqa: E402
from repro.core import flow_control as r_fc, torus as r_torus  # noqa: E402
from repro.fabric import faults as r_faults  # noqa: E402
from repro.serve import loadgen as r_lg  # noqa: E402
from repro.transport import base as r_base, torus as r_tt  # noqa: E402
from repro_torch import convert, transport as t_tp  # noqa: E402
from repro_torch.core import torus as t_torus  # noqa: E402
from repro_torch.fabric import faults as t_faults  # noqa: E402
from repro_torch.kernels import admission  # noqa: E402
from repro_torch.serve import loadgen as t_lg  # noqa: E402
from repro_torch.snn import microcircuit as mc, network  # noqa: E402
from repro_torch.snn import simulator as sim  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")

# transport-level cases: tests/test_faults.py's single cable down on a 2x2
# torus, and the chaos fuzz of tests/test_fabric_fuzz.py
TCASES = {"single": dict(backend="torus2d", opts={"nx": 2, "ny": 2},
                         dims=(2, 2), D=4, W=4, credits=8, n_win=8,
                         sched="link_fault", seed=11, hi=7)}
for _name, _dims in (("torus2d", (2, 4)), ("torus3d", (2, 2, 2))):
    for _credits in (48, 96):
        for _seed in range(5):
            TCASES[f"{_name}-c{_credits}-s{_seed}"] = dict(
                backend=_name, opts=dict(zip(("nx", "ny", "nz"), _dims)),
                dims=_dims, D=8, W=6, credits=_credits, n_win=6,
                sched="chaos", seed=_seed, hi=31)

# the simulator's fault matrix (benchmarks/bench_microcircuit.py:48-54)
SIM_SCALE, SIM_SHARDS, SIM_WINDOWS, SEED = 0.01, 8, 12, 0
SIM_CFG = dict(window=8, ring_len=32, e_max=512, capacity=48,
               transport="torus3d", torus_nx=2, torus_ny=2, torus_nz=2,
               link_credits=48, notify_latency=2)
DIMS = (2, 2, 2)
MATRIX = ("no_fault", "link_down", "link_flap", "node_down")


def schedule(faults, name, n_win, **kw):
    """The bench's schedule ``name`` from ``faults`` (either package)."""
    return {"no_fault": lambda: faults.healthy(DIMS, n_win, **kw),
            "link_down": lambda: faults.link_fault(DIMS, n_win, 0, 0,
                                                   start=2, **kw),
            "link_flap": lambda: faults.link_flap(DIMS, n_win, 0, 0,
                                                  period=2, start=2, **kw),
            "node_down": lambda: faults.node_fault(DIMS, n_win, 3, start=2,
                                                   **kw)}[name]()


def traffic(case, lg, faults, **kw):
    """A case's per-window counts, payloads and masks (numpy), drawn with
    ``lg`` / ``faults`` of either package."""
    n, W = case["D"], case["W"]
    if case["sched"] == "chaos":
        rng = lg.traffic_rng(case["seed"])
        prng = rng
        masks = faults.chaos(case["dims"], case["n_win"], case["seed"], **kw)
    else:
        rng, prng = lg.traffic_rng(case["seed"]), lg.traffic_rng(
            case["seed"], 1)
        masks = faults.link_fault(case["dims"], case["n_win"], 0, 0, start=1,
                                  **kw)
    counts, payloads = [], []
    for _ in range(case["n_win"]):
        counts.append(lg.draw_counts(rng, (n, n), case["hi"]))
        payloads.append(lg.draw_payload(prng, (n, n, W)))
    down = masks.link_down
    down = down.numpy() if isinstance(down, torch.Tensor) else np.asarray(down)
    return np.stack(counts), np.stack(payloads), down

REF_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
sys.path.insert(0, %(TESTS)r)
from repro import transport as tp
from repro.fabric import faults
from repro.serve import loadgen as lg
from repro.snn import lif, microcircuit as mc, network, simulator as sim
import test_torch_faults as T

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
fns = {}
for key, case in T.TCASES.items():
    D, W = case["D"], case["W"]
    cfg_key = (case["backend"], tuple(case["opts"].items()), case["credits"])
    if cfg_key not in fns:
        t = tp.create(case["backend"], n_shards=D,
                      link_credits=case["credits"], notify_latency=2,
                      **case["opts"])
        mesh = Mesh(np.array(jax.devices()[:D]), ("w",))
        spec = P("w")
        def body(lstate, p, c, t=t):
            lstate = tm(lambda x: x[0], lstate)
            o = t.exchange(lstate, p[0], c[0], axis_name="w")
            return tm(lambda x: x[None], (o.state, o.recv_payload,
                      o.recv_counts, o.sent_mask, o.sent_now, o.stats,
                      o.links_used))
        def dbody(lstate, t=t):
            lstate = tm(lambda x: x[0], lstate)
            o = t.drain_fabric(lstate, axis_name="w")
            return tm(lambda x: x[None], (o.state, o.recv_payload,
                                          o.recv_counts, o.stats))
        fns[cfg_key] = (t, jax.jit(shard_map(
            body, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
            check_rep=False)), jax.jit(shard_map(
            dbody, mesh=mesh, in_specs=(spec,), out_specs=spec,
            check_rep=False)))
    t, fn, walk = fns[cfg_key]
    counts, payloads, masks = T.traffic(case, lg, faults)
    lstate = tm(lambda x: jnp.broadcast_to(x, (D,) + x.shape),
                t.init_state(W))
    for w in range(case["n_win"]):
        lstate = lstate._replace(link_down=jnp.broadcast_to(
            jnp.asarray(masks[w]), (D,) + masks[w].shape))
        res = fn(lstate, jnp.asarray(payloads[w]), jnp.asarray(counts[w]))
        lstate = res[0]
        for name, x in zip(("state", "recv_payload", "recv_counts",
                            "sent_mask", "sent_now", "stats",
                            "links_used"), res):
            flat(x, "t.%%s.w%%d.%%s." %% (key, w, name))
    for name, x in zip(("state", "recv_payload", "recv_counts", "stats"),
                       walk(lstate)):
        flat(x, "t.%%s.drain.%%s." %% (key, name))

SS, NW, SEED = T.SIM_SHARDS, %(NW)d, T.SEED
spec = mc.MicrocircuitSpec(scale=T.SIM_SCALE)
part = network.build_partition(*spec.weight_matrix(), n_shards=SS)
per = part.per_shard
mesh8 = Mesh(np.array(jax.devices()[:SS]), ("wafer",))
cfg = sim.SimConfig(n_shards=SS, per_shard=per, max_fan=part.fanout.shape[1],
                    **T.SIM_CFG)
for name in T.MATRIX:
    init, run = sim.build_sharded_sim(
        mesh8, "wafer", cfg, part, spec.bg_rates(),
        fault_schedule=T.schedule(faults, name, NW))
    st0 = init(SEED)
    st1, stats = run(st0, NW)
    flat(st0, "sim.%%s.init." %% name)
    flat(stats, "sim.%%s.stats." %% name)

bg = np.pad(spec.bg_rates(), (0, part.n_neurons - len(spec.bg_rates())))
bg = bg.reshape(SS, per)

@jax.jit
def draws(key, rate):
    def step(k, _):
        k, sub = jax.random.split(k)
        return k, lif.poisson_input(sub, per, rate, 87.8, 0.1)
    return jax.lax.scan(step, key, None, length=NW * 8)[1]

drive = np.stack([np.asarray(draws(jax.random.PRNGKey(s + SEED * 1000 + 7),
                                   jnp.asarray(bg[s]))) for s in range(SS)])
out["sim.drive"] = drive.reshape(SS, NW, 8, per).transpose(1, 2, 0, 3)
np.savez(%(PATH)r, **out)
print("REF_OK")
"""


def run_reference(path: str, n_windows: int) -> dict:
    out = run_md(REF_SCRIPT % dict(TESTS=os.path.dirname(
        os.path.abspath(__file__)), NW=n_windows, PATH=path), n_devices=8,
        timeout=1200)
    assert "REF_OK" in out
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(str(tmp_path_factory.mktemp("ref") / "faults.npz"),
                         SIM_WINDOWS)


def _t(a) -> torch.Tensor:
    a = np.array(a, order="C")
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# ---------------------------------------------------------------------------
# Schedules and detours (host).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(2, 2), (2, 4), (2, 2, 2), (4, 4)])
def test_schedules_match_reference(dims):
    K = t_faults.n_fabric_links(dims)
    assert K == r_faults.n_fabric_links(dims)
    n_nodes, nl = int(np.prod(dims)), 2 * len(dims)
    def same(a, b):
        x, y = _np(a.link_down), _np(b.link_down)
        return x.dtype == y.dtype == bool and x.shape == y.shape and \
            (x == y).all()
    cpu = {"device": "cpu"}
    assert same(t_faults.healthy(dims, 5, **cpu), r_faults.healthy(dims, 5))
    assert same(t_faults.healthy(dims, 0, **cpu), r_faults.healthy(dims, 0))
    for node, direction, start, stop in ((0, 0, 0, None), (1, nl - 1, 2, 5),
                                         (n_nodes - 1, 1, 3, 99),
                                         (2 % n_nodes, 2 % nl, -1, 2)):
        assert same(t_faults.link_fault(dims, 7, node, direction,
                                        start=start, stop=stop, **cpu),
                    r_faults.link_fault(dims, 7, node, direction,
                                        start=start, stop=stop))
        for period in (1, 2, 3):
            assert same(t_faults.link_flap(dims, 9, node, direction,
                                           period=period,
                                           start=max(start, 0), **cpu),
                        r_faults.link_flap(dims, 9, node, direction,
                                           period=period,
                                           start=max(start, 0)))
        assert same(t_faults.node_fault(dims, 6, node, start=start,
                                        stop=stop, **cpu),
                    r_faults.node_fault(dims, 6, node, start=start,
                                        stop=stop))
    for seed in range(5):
        t_ch = t_faults.chaos(dims, 12, seed, **cpu)
        r_ch = r_faults.chaos(dims, 12, seed)
        assert same(t_ch, r_ch) and _np(t_ch.link_down).any()
        assert t_faults.transitions(t_ch) == r_faults.transitions(r_ch)
        for w in (-3, 0, 5, 11, 12, 99):     # mask_at clamps to the table
            want = _np(r_faults.mask_at(r_ch, jnp.int32(w)))
            assert (_np(t_faults.mask_at(t_ch, w)) == want).all()
            assert (_np(t_ch.at(torch.tensor(w))) == want).all()
    assert t_ch.n_windows == 12 and t_ch.n_links == K
    for node in range(n_nodes):
        for direction in range(nl):
            assert t_faults.cable_links(dims, node, direction) == \
                r_faults.cable_links(dims, node, direction)
            lid = t_faults.link_id(dims, node, direction)
            assert lid == r_faults.link_id(dims, node, direction)
            assert t_faults.link_label(dims, lid) == \
                r_faults.link_label(dims, lid)
    for bad in ((n_nodes, 0), (0, nl)):
        with pytest.raises(ValueError):
            t_faults.link_id(dims, *bad)


def test_loadgen_matches_reference():
    for seed, stream in ((0, ()), (7, (3,)), (11, (1, 4))):
        a, b = t_lg.traffic_rng(seed, *stream), r_lg.traffic_rng(seed,
                                                                 *stream)
        assert (t_lg.draw_counts(a, (8, 8), 31)
                == r_lg.draw_counts(b, (8, 8), 31)).all()
        assert (t_lg.draw_payload(a, (8, 8, 6))
                == r_lg.draw_payload(b, (8, 8, 6))).all()
        assert (t_lg.draw_events(a, (4, 5)) == r_lg.draw_events(b, (4, 5))
                ).all()
    profiles = [t_lg.TenantProfile("quiet", 40.0),
                t_lg.TenantProfile("bursty", 900.0, 4.0, 0.3)]
    r_prof = [r_lg.TenantProfile(*p) for p in profiles]
    t_gen = t_lg.PoissonLoadGen(5, profiles, n_shards=4, capacity=16)
    r_gen = r_lg.PoissonLoadGen(5, r_prof, n_shards=4, capacity=16)
    for w in range(6):
        for x, y in zip(t_gen.next_window(w), r_gen.next_window(w)):
            assert x.dtype == y.dtype and (x == y).all()
    with pytest.raises(ValueError):
        t_lg.PoissonLoadGen(0, [], 4, 16)


TORI = [("torus2d", {"nx": 2, "ny": 4}),
        ("torus3d", {"nx": 2, "ny": 2, "nz": 2}),
        ("torus3d", {"nx": 1, "ny": 2, "nz": 3}),
        ("torus2d", {"nx": 3, "ny": 3})]


def _pair(backend, opts, **kw):
    n = int(np.prod(list(opts.values())))
    t = t_tp.create(backend, n_shards=n, **opts, **kw)
    r = (r_tt.Torus2DTransport if backend == "torus2d"
         else r_tt.Torus3DTransport)(n, **opts, **kw)
    return n, t, r


@pytest.mark.parametrize("backend,opts", TORI)
def test_detours_and_tables_match_reference(backend, opts):
    n, t, r = _pair(backend, opts, link_credits=24, max_row_events=24)
    shape = tuple(opts.get(k, 1) for k in ("nx", "ny", "nz"))
    rt, tt = r_torus.Torus(*shape), t_torus.Torus(*shape)
    rng = np.random.default_rng(n)
    for s, d in itertools.product(range(n), range(n)):
        for a in range(3):
            for longway in (False, True):
                assert tt.axis_segment_links(s, d, a, longway) == \
                    rt.axis_segment_links(s, d, a, longway)
        for flips in itertools.product((False, True), repeat=3):
            assert tt.route_links_detour(s, d, flips) == \
                rt.route_links_detour(s, d, flips)
        assert tt.route_links_detour(s, d) == tt.route_links(s, d)
        for _ in range(4):
            down = {(int(u), int(v)) for u, v in zip(
                rng.integers(0, n, 3), rng.integers(0, 6, 3))}
            assert tt.route_links_avoiding(s, d, down) == \
                rt.route_links_avoiding(s, d, down)
    assert t.max_hops_alt == r.max_hops_alt
    for mine, theirs in ((t._link_seq_alt, r._link_seq_alt),
                         (t._route_len_alt, r._route_len_alt),
                         (t._seg_links, r._seg_links)):
        theirs = np.asarray(theirs)
        assert mine.shape == theirs.shape and (mine == theirs).all()


# ---------------------------------------------------------------------------
# The faulted admission replay.
# ---------------------------------------------------------------------------

def _ref_state(state, width):
    f = lambda x: jnp.asarray(x.numpy())
    return r_base.FabricState(
        bank=r_fc.CreditBank(*(f(x) for x in state.bank)),
        parked_count=f(state.parked_count), parked_hop=f(state.parked_hop),
        parked_age=f(state.parked_age),
        parked_by_link=f(state.parked_by_link),
        parked_payload=jnp.zeros((state.parked_count.shape[0], width),
                                 jnp.uint32),
        parked_hold_shared=f(state.parked_hold_shared))


def _evicted(t, state, down):
    """The reference's eviction set, from the port's tables (numpy)."""
    seq0 = t._link_seq_alt[0]
    pc = state.parked_count.numpy().reshape(-1)
    ph = state.parked_hop.numpy().reshape(-1)
    hop = np.arange(seq0.shape[1])
    dead = (seq0 >= 0) & down[np.maximum(seq0, 0)]
    rem = (dead & (hop >= ph[:, None])).any(-1)
    held = np.take_along_axis(seq0, np.maximum(ph - 1, 0)[:, None], 1)[:, 0]
    return (pc > 0) & ((ph == 0) | rem | ((ph >= 1)
                                         & down[np.maximum(held, 0)]))


@pytest.mark.parametrize("backend,opts", TORI)
def test_faulted_admission_matches_reference(backend, opts):
    """``_admit_global_faulted`` against the reference's on the states of
    12 windows threaded under chaos masks (tight credits: parks, resumes,
    evictions, hop-0 parks, detours, unroutable rows), both built with
    ``stall_attribution`` so that kernel F's stall lane is compared too."""
    n, t, r = _pair(backend, opts, link_credits=24, notify_latency=2,
                    max_row_events=24, stall_attribution=True)
    r_admit = jax.jit(r._admit_global_faulted)
    dims = tuple(opts.values())
    masks = _np(t_faults.chaos(dims, 12, n, revive_p=0.1,
                               device="cpu").link_down)
    state = t.init_state(4, device="cpu")
    rng = r_lg.traffic_rng(n)
    seen = dict(evicted=0, hop0=0, detoured=0, unroutable=0, parked=0)
    for w in range(12):
        counts = r_lg.draw_counts(rng, (n, n), 24)
        down = masks[w]
        got = t._admit_global_faulted(state, _t(counts), torch.from_numpy(
            down))
        want = r_admit(_ref_state(state, 4), jnp.asarray(counts),
                       jnp.asarray(down))
        for field in got._fields:
            a, b = getattr(got, field).numpy(), np.asarray(getattr(want,
                                                                   field))
            assert a.shape == b.shape and (a == b).all(), (w, field)
        seg = t._seg_links
        dirty = ((seg >= 0) & down[np.maximum(seg, 0)]).any(-1)
        seen["evicted"] += int(_evicted(t, state, down).sum())
        seen["hop0"] += int(((got.park_count > 0)
                             & (got.park_hop == 0)).sum())
        seen["detoured"] += int(got.rerouted.sum())
        seen["unroutable"] += int(((dirty[:, 0] & dirty[:, 1]).any(0)
                                   & (counts.reshape(-1) > 0)).sum())
        seen["parked"] += int(got.fresh_park.sum())
        payload = _t(rng.integers(0, 1 << 30, (n, n, 4)).astype(np.int32))
        state = t.exchange(state._replace(link_down=torch.from_numpy(down)),
                           payload, _t(counts)).state
        assert state.link_down is None
        held = state.bank.credits + state.bank.pending.sum(-1) \
            + state.parked_by_link
        assert (held == 24).all(), w
        assert (state.parked_by_link[torch.from_numpy(down)] == 0).all(), w
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("backend,opts", TORI)
def test_all_false_mask_is_the_healthy_replay(backend, opts):
    """On states a healthy run reaches, the faulted replay under an
    all-false mask equals ``_admit_global`` field for field (the stall
    lane included)."""
    n, t, _ = _pair(backend, opts, link_credits=24, notify_latency=2,
                    max_row_events=24, stall_attribution=True)
    state = t.init_state(4, device="cpu")
    rng = np.random.default_rng(n + 1)
    down = torch.zeros(n * t.n_links, dtype=torch.bool)
    for w in range(8):
        counts = _t(rng.integers(0, 25, (n, n)).astype(np.int32))
        a = t._admit_global(state, counts)
        b = t._admit_global_faulted(state, counts, down)
        for field in a._fields:
            assert torch.equal(getattr(a, field), getattr(b, field)), \
                (w, field)
        assert int(b.rerouted.abs().sum()) == 0
        state = t.exchange(state, torch.zeros((n, n, 4), dtype=torch.int32),
                           counts).state
    assert int(state.parked_count.sum()) > 0


# ---------------------------------------------------------------------------
# Transport windows and the drain under faults.
# ---------------------------------------------------------------------------

def _port_case(case):
    t = t_tp.create(case["backend"], n_shards=case["D"],
                    link_credits=case["credits"], notify_latency=2,
                    **case["opts"])
    counts, payloads, masks = traffic(case, t_lg, t_faults, device="cpu")
    state = t.init_state(case["W"], device="cpu")
    wins = []
    for w in range(case["n_win"]):
        out = t.exchange(state._replace(link_down=torch.from_numpy(masks[w])),
                         _t(payloads[w]), _t(counts[w]))
        state = out.state
        wins.append(out)
    return t, wins, t.drain_fabric(state), masks


GLOBAL_STATE = ("bank.credits", "bank.pending", "bank.epoch", "parked_count",
                "parked_hop", "parked_age", "parked_by_link",
                "parked_hold_shared")


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


@pytest.mark.parametrize("key", list(TCASES))
def test_transport_windows_under_faults_match_reference(ref, key):
    case = TCASES[key]
    t, wins, drain, masks = _port_case(case)
    rerouted = 0
    for w, out in enumerate(wins):
        p = f"t.{key}.w{w}."
        _check_tree(convert.flatten(out.stats), ref, p + "stats.")
        _check_tree(convert.flatten(out.state), ref, p + "state.",
                    replicated=GLOBAL_STATE)
        for name in ("recv_payload", "recv_counts", "sent_mask", "sent_now"):
            _check_tree({"": _np(getattr(out, name))}, ref, p + name)
        _check_tree({"": _np(out.links_used)}, ref, p + "links_used",
                    replicated=("",))
        # a dead link spends and holds nothing once its mask lands
        dead = torch.from_numpy(masks[w])
        assert int(out.state.parked_by_link[dead].abs().sum()) == 0
        rerouted += int(out.stats.rerouted.sum())
    d = f"t.{key}.drain."
    _check_tree(convert.flatten(drain.stats), ref, d + "stats.")
    _check_tree(convert.flatten(drain.state), ref, d + "state.",
                replicated=GLOBAL_STATE)
    _check_tree({"": _np(drain.recv_counts)}, ref, d + "recv_counts")
    _check_tree({"": _np(drain.recv_payload)}, ref, d + "recv_payload")
    assert int(drain.state.parked_count.abs().sum()) == 0
    assert int(drain.state.parked_by_link.abs().sum()) == 0
    assert ((drain.state.bank.credits + drain.state.bank.pending.sum(-1))
            == case["credits"]).all()
    if key == "single":
        assert rerouted > 0


def test_faults_exercise_hop0_parks_and_detours(ref):
    """The chaos cases reach the reference's rarer states: rows parked at
    hop 0 after a failed retry (and drained from there), and detours."""
    hop0 = detoured = 0
    for key in TCASES:
        for w in range(TCASES[key]["n_win"]):
            st = f"t.{key}.w{w}.state."
            hop0 += int(((ref[st + "parked_count"][0] > 0)
                         & (ref[st + "parked_hop"][0] == 0)).sum())
            detoured += int(ref[f"t.{key}.w{w}.stats.rerouted"].sum())
    assert hop0 > 0 and detoured > 0, (hop0, detoured)


# ---------------------------------------------------------------------------
# The simulator's fault matrix.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_part():
    spec = mc.MicrocircuitSpec(scale=SIM_SCALE)
    return spec, network.build_partition(*spec.weight_matrix(),
                                         n_shards=SIM_SHARDS)


def run_port_matrix(ref, spec, part, n_windows, names=MATRIX):
    """The port's fault matrix from the reference's initial states and
    drive -> {name: flattened WindowStats}; ``None`` names a run without a
    schedule."""
    cfg = sim.SimConfig(n_shards=SIM_SHARDS, per_shard=part.per_shard,
                        max_fan=part.fanout.shape[1], **SIM_CFG)
    out = {}
    for name in names:
        sched = (None if name is None else
                 schedule(t_faults, name, n_windows, device="cpu"))
        _, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                       fault_schedule=sched, device="cpu")
        state0 = convert.state_from_reference(
            ref, prefix=f"sim.{name or 'no_fault'}.init.", device="cpu")
        drive = torch.from_numpy(ref["sim.drive"])
        out[name] = convert.flatten(run(state0, n_windows, drive=drive)[1])
    return out


@pytest.fixture(scope="module")
def matrix(ref, sim_part):
    return run_port_matrix(ref, *sim_part, SIM_WINDOWS,
                           names=MATRIX + (None,))


@pytest.mark.parametrize("name", MATRIX)
def test_sim_fault_matrix_matches_reference(ref, matrix, name):
    got = matrix[name]
    prefix = f"sim.{name}.stats."
    keys = {k[len(prefix):] for k in ref if k.startswith(prefix)}
    assert keys == set(got), keys ^ set(got)
    _check_tree(got, ref, prefix)
    link = lambda k: got["link." + k]
    assert (link("offered_events") == link("sent_events")
            + link("deferred_events") + link("parked_events")).all()
    if name in ("link_down", "link_flap"):
        assert link("rerouted").sum() > 0
    assert got["spikes"].sum() > 0


def test_sim_healthy_schedule_is_the_run_without_one(matrix):
    """A stamped all-false mask changes nothing but ``hops``: a masked ring
    phase runs ``n - 1`` hops each way (the reference's rule), and the
    extra hops carry nothing."""
    a, b = matrix["no_fault"], matrix[None]
    assert set(a) == set(b)
    for key in a:
        if key != "link.hops":
            assert (a[key] == b[key]).all(), key
    ring = sum(2 * (d - 1) for d in DIMS)
    assert (a["link.hops"][:, 1:] == ring).all()
    assert (b["link.hops"][:, 1:] == sum(d - 1 for d in DIMS)).all()


# ---------------------------------------------------------------------------
# Guards.
# ---------------------------------------------------------------------------

def test_fault_guards(sim_part):
    spec, part = sim_part
    sched = t_faults.healthy(DIMS, 4, device="cpu")
    for kw in (dict(transport="alltoall"),
               dict(SIM_CFG, link_credits=0)):
        cfg = sim.SimConfig(n_shards=SIM_SHARDS, per_shard=part.per_shard,
                            max_fan=part.fanout.shape[1],
                            **{**SIM_CFG, **kw})
        with pytest.raises(ValueError, match="credit-throttled"):
            sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                  fault_schedule=sched, device="cpu")
    free = t_tp.create("torus3d", n_shards=8, nx=2, ny=2, nz=2)
    state = free.init_state(4, device="cpu")._replace(
        link_down=torch.zeros(48, dtype=torch.bool))
    with pytest.raises(ValueError, match="requires credit"):
        free.exchange(state, torch.zeros((8, 8, 4), dtype=torch.int32),
                      torch.zeros((8, 8), dtype=torch.int32))
    # detours longer than a warp's 32 lanes are refused on credited tori
    with pytest.raises(ValueError, match="at most 32"):
        t_tp.create("torus2d", n_shards=18 * 17, nx=18, ny=17,
                    link_credits=8)
    # on CPU tensors the wrapper replays the fabric as one tenant with
    # reserve 0 (K empty slice slots before the K pool slots), and refuses
    # bad operands
    tr = t_tp.create("torus2d", n_shards=8, nx=2, ny=4, link_credits=24)
    st = tr.init_state(4, device="cpu")
    routes = tr._dev(torch.device("cpu"))["routes"]
    counts = torch.full((8, 8), 5, dtype=torch.int32)
    down = torch.zeros(32, dtype=torch.bool)
    down[[0, 9]] = True
    got = admission.admission(counts, st, routes, down, stall_lane=True)
    lift = lambda x: torch.cat([torch.zeros_like(x), x])
    one = st._replace(
        bank=st.bank._replace(credits=lift(st.bank.credits)),
        parked_count=st.parked_count[None], parked_hop=st.parked_hop[None],
        parked_age=st.parked_age[None], parked_by_link=lift(
            st.parked_by_link), parked_hold_shared=st.parked_count[None])
    want = admission.admission_tenants_plain(counts[None], one, routes, down,
                                             stall_lane=True)
    for field in got._fields:
        x = getattr(want, field)
        x = (x if field == "stalled_by_link" else x[32:]
             if field in ("spent", "notify", "parked_by_link") else x[0])
        assert torch.equal(getattr(got, field), x), field
    assert int(got.fresh_park.sum()) > 0 and int(got.spent.sum()) > 0
    for bad in (counts.to(torch.int64), counts[:4], counts.reshape(4, 16)):
        with pytest.raises(ValueError, match="admission: counts"):
            admission.admission(bad, st, routes)
    with pytest.raises(ValueError, match="link_down"):
        admission.admission(counts, st, routes, down[:30])
    with pytest.raises(ValueError, match="link_down"):
        admission.admission(counts, st, routes, down.to(torch.int32))
    with pytest.raises(ValueError, match="parked_count"):
        admission.admission(counts, st._replace(
            parked_count=st.parked_count.to(torch.int16)), routes)
    assert admission.shared_bytes(64, 48) == 4 * (4 * 48 + 4 * 64)


def test_fault_modules_import_no_jax():
    code = ("import sys, repro_torch.fabric.faults, "
            "repro_torch.serve.loadgen, repro_torch.kernels.admission, "
            "repro_torch.transport.torus, repro_torch.snn.simulator; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=SRC))


# ---------------------------------------------------------------------------
# The 40-window fault matrix of BENCH_microcircuit.json (a script, not a
# test: the reference alone takes minutes).
# ---------------------------------------------------------------------------

def main() -> int:
    import tempfile
    n_win = 40
    with open(os.path.join(ROOT, "BENCH_microcircuit.json")) as f:
        bench = {r["fault"]: r for r in json.load(f)}
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_reference(os.path.join(tmp, "faults40.npz"), n_win)
    spec = mc.MicrocircuitSpec(scale=SIM_SCALE)
    part = network.build_partition(*spec.weight_matrix(),
                                   n_shards=SIM_SHARDS)
    port = run_port_matrix(ref, spec, part, n_win)
    keys = ("rerouted", "parked_events", "deferred_events")
    ok = True
    for name in MATRIX:
        r = {k: int(ref[f"sim.{name}.stats.link.{k}"].sum()) for k in keys}
        p = {k: int(port[name][f"link.{k}"].sum()) for k in keys}
        r["deadline_miss"] = int(ref[f"sim.{name}.stats.deadline_miss"].sum())
        p["deadline_miss"] = int(port[name]["deadline_miss"].sum())
        same = all((port[name][k[len(f"sim.{name}.stats."):]] == ref[k]).all()
                   for k in ref if k.startswith(f"sim.{name}.stats.")
                   and ref[k].dtype.kind != "f")
        ok &= same
        b = bench[name]
        print(f"{name}: BENCH_microcircuit.json rerouted {b['rerouted']} "
              f"parked {b['parked']} deferred {b['deferred']} deadline "
              f"misses {b['deadline_miss']}; reference at HEAD {r}; port "
              f"{p}; every integer WindowStats field port == reference: "
              f"{same}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
