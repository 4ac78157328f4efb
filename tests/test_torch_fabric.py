"""The fabric slice, port vs reference on the CPU (where every kernel
wrapper runs its plain version):

* kernel D's plain version against ``repro.kernels.ref.bucket_scatter_ref``
  on the shapes of ``tests/test_kernels.py``, and ``kernels.ops.
  bucket_scatter`` against the reference's (Pallas in interpret mode);
* ``aggregate_onehot`` / ``aggregate_sort`` / ``overflow_mask``,
  ``credit_tick``, the host ``Torus`` model and the torus admission replay
  (``_admit_global``, on states threaded through several windows), bit for
  bit;
* ``make_exchange`` on ``alltoall``, ``torus2d`` and ``torus3d`` with and
  without credits, and six threaded windows of the congestion study of
  ``benchmarks/_fabric_study.py``: every integer ``ExchangeOut`` /
  ``LinkStats`` field and the fabric state (credit banks, delay lines,
  transit tables and payloads) exactly, latency digests at rtol 1e-6 with
  the histogram exact; and the committed model outputs of
  ``BENCH_transport.json``;
* the simulator on ``torus2d`` and ``torus3d`` (1x2x2) with binding credits
  against ``build_sharded_sim`` (scale 0.003, 4 shards, 12 windows, the
  reference's own initial state and replayed background drive): every
  integer field of every window exactly.

The reference runs once, in one subprocess with 8 forced host devices
(``md_helper.run_md``), and saves its outputs as ``.npz``; outputs become
numpy before any per-shard indexing (jax 0.9 meshes refuse host indexing
of a shard-axis result)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_helper import SRC, run_md
from repro.core import aggregator as r_agg, events as r_ev
from repro.core import flow_control as r_fc, torus as r_torus
from repro.kernels import ops as r_ops, ref as r_ref
from repro.transport import base as r_base, torus as r_tt
from repro_torch import convert, transport as t_tp
from repro_torch.core import aggregator as t_agg
from repro_torch.core import flow_control as t_fc, torus as t_torus
from repro_torch.core.exchange import exchange_window, make_exchange
from repro_torch.kernels import bucket_scatter as t_bs, dispatch
from repro_torch.kernels import ops as t_ops, ref as t_ref
from repro_torch.snn import microcircuit as mc, network, simulator as sim

ROOT = os.path.join(os.path.dirname(__file__), "..")

# the exchange at BENCH_transport.json's shape
S, N, C, CREDITS, N_WIN, N_ADDR = 8, 4096, 256, 512, 6, 1024
CASES = {
    "alltoall": ("alltoall", None),
    "torus2d": ("torus2d", {"nx": 2, "ny": 4}),
    "torus2d+credits": ("torus2d", {"nx": 2, "ny": 4,
                                    "link_credits": CREDITS}),
    "torus3d": ("torus3d", {"nx": 2, "ny": 2, "nz": 2}),
    "torus3d+credits": ("torus3d", {"nx": 2, "ny": 2, "nz": 2,
                                    "link_credits": CREDITS}),
}
STUDIES = {k: CASES[k] for k in ("torus2d+credits", "torus3d+credits")}
# the simulator with binding credits (tests/test_transport.py:357)
SIM_SCALE, SIM_SHARDS, SIM_WINDOWS, SEED = 0.003, 4, 12, 0
SIMS = {"torus2d": ("torus2d", {}),
        "torus3d": ("torus3d", {"torus_nx": 1, "torus_ny": 2,
                                "torus_nz": 2}),
        # deeper congestion: rows park and resume, the residue overflows
        "torus2d-congested": ("torus2d", {"capacity": 8, "link_credits": 8,
                                          "notify_latency": 3,
                                          "residue": 64})}
SIM_CFG = dict(window=8, ring_len=32, e_max=256, capacity=32,
               link_credits=40, notify_latency=2)

REF_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro import transport as tp
from repro.core import events as ev, routing as rt
from repro.core.exchange import exchange_window, make_exchange
from repro.snn import lif, microcircuit as mc, network, simulator as sim

out = {}
def flat(tree, prefix):
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            flat(getattr(tree, f), prefix + f + ".")
    else:
        out[prefix[:-1]] = np.asarray(tree)     # numpy before any indexing

S, N, C, NWIN, n_addr = %(S)d, %(N)d, %(C)d, %(NWIN)d, %(NADDR)d
mesh = jax.make_mesh((S,), ("wafer",))
tabs = []
for s in range(S):      # benchmarks/bench_transport.py's tables
    projs = [rt.Projection(a, a + 1, dest_node=(a * 7 + s) %% S,
                           dest_links=[a %% 3]) for a in range(n_addr)]
    tabs.append(rt.build_tables(n_addr, projs, n_guid=64))
stacked = rt.RoutingTables(
    dest_of_addr=jnp.stack([t.dest_of_addr for t in tabs]),
    guid_of_addr=jnp.stack([t.guid_of_addr for t in tabs]),
    mcast_of_guid=jnp.stack([t.mcast_of_guid for t in tabs]))
words = ev.pack(
    jax.random.randint(jax.random.PRNGKey(0), (S, N), 0, n_addr),
    jax.random.randint(jax.random.PRNGKey(1), (S, N), 0, 1000))
out["words"] = np.asarray(words)
for k in ("dest_of_addr", "guid_of_addr", "mcast_of_guid"):
    out["tables." + k] = np.asarray(getattr(stacked, k))
for name, (backend, opts) in %(CASES)r.items():
    run = make_exchange(mesh, "wafer", n_shards=S, capacity=C,
                        n_addr_per_shard=n_addr, transport=backend,
                        transport_opts=opts)
    flat(run(words, stacked), "x." + name + ".")

for name, (backend, opts) in %(STUDIES)r.items():
    tb = tp.create(backend, n_shards=S, max_row_events=C, **opts)
    def body(w, d, g, m):
        tables = rt.RoutingTables(d[0], g[0], m[0])
        def win(lstate, _):
            o = exchange_window(w[0], tables, axis_name="wafer", n_shards=S,
                                capacity=C, transport=tb, link_state=lstate)
            return o.link_state, (o.link, o.latency)
        last, stats = jax.lax.scan(win, tb.init_state(2 * C), None,
                                   length=NWIN)
        return jax.tree_util.tree_map(lambda x: x[None], (stats, last))
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("wafer"),) * 4,
                          out_specs=P("wafer"), check_rep=False))
    (link, lat), last = f(words, stacked.dest_of_addr, stacked.guid_of_addr,
                          stacked.mcast_of_guid)
    flat(link, "s." + name + ".link.")
    flat(lat, "s." + name + ".latency.")
    flat(last, "s." + name + ".state.")

SS, NW, SEED = %(SIM_SHARDS)d, %(SIM_WINDOWS)d, %(SEED)d
spec = mc.MicrocircuitSpec(scale=%(SIM_SCALE)r)
part = network.build_partition(*spec.weight_matrix(), n_shards=SS)
per = part.per_shard
mesh4 = jax.make_mesh((SS,), ("wafer",), devices=jax.devices()[:SS])
for name, (transport, kw) in %(SIMS)r.items():
    cfg = sim.SimConfig(n_shards=SS, per_shard=per,
                        max_fan=part.fanout.shape[1], transport=transport,
                        **{**%(SIM_CFG)r, **kw})
    init, run = sim.build_sharded_sim(mesh4, "wafer", cfg, part,
                                      spec.bg_rates())
    st0 = init(SEED)
    st1, stats = run(st0, NW)
    flat(st0, "sim." + name + ".init.")
    flat(st1, "sim." + name + ".final.")
    flat(stats, "sim." + name + ".stats.")

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


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def _t(a) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _assert_tree_equal(got: dict, ref: dict, prefix: str, *, rtol=1e-6,
                       per_shard=()):
    """Every reference leaf under ``prefix`` against the port's flattened
    tree: integers exactly, floats at ``rtol``.  Keys in ``per_shard`` are
    the reference's replicated global state, held once by the port."""
    keys = [k[len(prefix):] for k in ref if k.startswith(prefix)]
    assert keys, prefix
    for key in keys:
        want = ref[prefix + key]
        have = got[key]
        if key in per_shard:
            assert (want == want[:1]).all(), f"{key}: not replicated"
            want = want[0]
        if want.dtype == np.uint32:
            have = have.astype(np.int32).view(np.uint32)
        assert have.shape == want.shape, (key, have.shape, want.shape)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(have, want, rtol=rtol, atol=1e-6,
                                       err_msg=key)
        else:
            assert (have == want).all(), (key, have, want)


GLOBAL_STATE = ("bank.credits", "bank.pending", "bank.epoch", "parked_count",
                "parked_hop", "parked_age", "parked_by_link",
                "parked_hold_shared")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "fabric.npz")
    out = run_md(REF_SCRIPT % dict(
        S=S, N=N, C=C, NWIN=N_WIN, NADDR=N_ADDR, CASES=CASES,
        STUDIES=STUDIES, SIM_SHARDS=SIM_SHARDS, SIM_WINDOWS=SIM_WINDOWS,
        SEED=SEED, SIM_SCALE=SIM_SCALE, SIMS=SIMS, SIM_CFG=SIM_CFG,
        PATH=path), n_devices=S)
    assert "REF_OK" in out
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def tables(ref):
    return convert.tables_from_reference(ref["tables.dest_of_addr"],
                                         ref["tables.guid_of_addr"],
                                         ref["tables.mcast_of_guid"],
                                         device="cpu")


# ---------------------------------------------------------------------------
# Kernel D and the aggregation oracles.
# ---------------------------------------------------------------------------

def _window(rng, n, d, n_guid=50):
    words = np.asarray(r_ev.pack(jnp.asarray(rng.integers(0, 1 << 14, n)),
                                 jnp.asarray(rng.integers(0, 1 << 15, n)),
                                 valid=jnp.asarray(rng.random(n) < 0.9)))
    dests = rng.integers(-1, d + 1, n).astype(np.int32)   # out of range too
    guids = rng.integers(0, n_guid, n).astype(np.int32)
    return words, dests, guids


@pytest.mark.parametrize("n,d,c", [
    (16, 3, 4), (64, 7, 5), (256, 16, 32), (1024, 64, 16),
    (128, 3, 124), (512, 8, 128), (100, 13, 7),
])
def test_bucket_scatter_plain_matches_reference_oracle(n, d, c):
    words, dests, guids = _window(np.random.default_rng(n * d + c), n, d)
    valid = np.asarray(r_ev.is_valid(jnp.asarray(words))) & (dests >= 0) \
        & (dests < d)
    dm = np.where(valid, dests, -1).astype(np.int32)
    want = r_ref.bucket_scatter_ref(jnp.asarray(words), jnp.asarray(dm),
                                    jnp.asarray(guids), d, c)
    got = t_bs.bucket_scatter_plain(_t(words), _t(dm), _t(guids), d, c)
    oracle = t_ref.bucket_scatter_ref(_t(words), _t(dm), _t(guids), d, c)
    for g, o, w in zip(got, oracle, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32
        assert (g.numpy().view(w.dtype) == w).all()
        assert (o.numpy().view(w.dtype) == w).all()
    assert int(got[2].sum()) > 0


def test_bucket_scatter_ops_matches_reference_kernel():
    """``ops.bucket_scatter`` against the reference's Pallas kernel in
    interpret mode, for a batch of 3 windows (one launch on the card)
    against the reference's per-window calls."""
    rng = np.random.default_rng(7)
    rows = [_window(rng, 100, 13) for _ in range(3)]
    stack = lambda i: _t(np.stack([r[i] for r in rows]))
    dispatch.reset_launches()
    got = t_ops.bucket_scatter(stack(0), stack(1), stack(2), 13, 7)
    assert dispatch.LAUNCHES == {}           # CPU tensors: plain version
    for b, (w, d, g) in enumerate(rows):
        want = r_ops.bucket_scatter(jnp.asarray(w), jnp.asarray(d),
                                    jnp.asarray(g), 13, 7)
        assert (_u32(got.data[b]) == np.asarray(want.data)).all()
        assert (got.guids[b].numpy() == np.asarray(want.guids)).all()
        assert (got.counts[b].numpy() == np.asarray(want.counts)).all()
        assert int(got.overflow[b]) == int(want.overflow) > 0


def test_ops_and_ref_entry_points():
    """The routed oracle against the reference's and the fused route
    kernel's plain version; the thin ``ops`` wrappers of kernels C and E
    against the wrappers they call."""
    from repro.core import routing as r_rt
    from repro_torch.kernels import fused_route_bucket as t_frb
    from repro_torch.snn import lif as t_lif
    rng = np.random.default_rng(11)
    projs = [r_rt.Projection(a, a + 1, dest_node=int(rng.integers(0, 6)),
                             dest_links=[0]) for a in range(0, 96, 2)]
    tabs = r_rt.build_tables(96, projs, n_guid=64)
    words = np.asarray(r_ev.pack(jnp.asarray(rng.integers(0, 110, 400)),
                                 jnp.asarray(rng.integers(0, 1 << 15, 400)),
                                 valid=jnp.asarray(rng.random(400) < 0.9)))
    lut_d, lut_g = np.asarray(tabs.dest_of_addr), np.asarray(tabs.guid_of_addr)
    want = r_ref.fused_route_aggregate_ref(jnp.asarray(words),
                                           jnp.asarray(lut_d),
                                           jnp.asarray(lut_g), 5, 12)
    got = t_ref.fused_route_aggregate_ref(_t(words), _t(lut_d), _t(lut_g),
                                          5, 12)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert (g.numpy().view(w.dtype) == w).all()
    fused = t_frb.fused_route_aggregate(_t(words), _t(lut_d), _t(lut_g), 5,
                                        12).buckets
    assert torch.equal(fused.data, got[0])
    assert torch.equal(fused.counts, torch.clamp(got[2], max=12))
    ins = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
           for shape in ((2, 16, 8), (2, 16), (2,), (2, 16, 4), (2, 16, 4),
                         (2, 8, 4))]
    ins[1], ins[2] = ins[1].abs(), -ins[2].abs()
    for a, b in zip(t_ops.ssd_chunk(*ins), t_ref.ssd_chunk_ref(*ins)):
        assert torch.equal(a, b)
    p = t_lif.LIFParams()
    st = t_lif.LIFState(torch.full((50,), p.v_th + 1.0), torch.zeros(50),
                        torch.zeros(50), torch.zeros(50, dtype=torch.int32))
    drive = torch.ones(50) * 100.0
    (s1, k1), (s2, k2) = (t_ops.lif_step(st, p, drive, drive),
                          t_ref.lif_step_ref(st, p, drive, drive, 0.0))
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert torch.equal(k1.to(torch.int32), k2) and int(k2.sum()) == 50


@pytest.mark.parametrize("n,d,c", [(1000, 7, 33), (900, 4, 124),
                                   (512, 16, 8)])
def test_aggregate_impls_and_overflow_mask_match_reference(n, d, c):
    words, dests, guids = _window(np.random.default_rng(n + c), n, d,
                                  n_guid=1 << 20)
    jw, jd, jg = jnp.asarray(words), jnp.asarray(dests), jnp.asarray(guids)
    tw, td, tg = _t(words), _t(dests), _t(guids)
    for impl in ("onehot", "sort", "fused", "pallas", "auto"):
        want = r_agg.aggregate(jw, jd, jg, d, c, impl=impl if impl in (
            "onehot", "sort") else "fused")
        got = t_agg.aggregate(tw, td, tg, d, c, impl=impl)
        assert (_u32(got.data) == np.asarray(want.data)).all(), impl
        for field in ("guids", "counts", "overflow"):
            assert (getattr(got, field).numpy()
                    == np.asarray(getattr(want, field))).all(), (impl, field)
    mask = t_agg.overflow_mask(tw, td, d, c)
    assert (mask.numpy() == np.asarray(r_agg.overflow_mask(jw, jd, d, c))
            ).all()
    assert int(mask.sum()) == int(np.asarray(want.overflow)) > 0


def test_aggregate_batched_equals_rows():
    rng = np.random.default_rng(3)
    rows = [_window(rng, 300, 5) for _ in range(3)]
    stack = lambda i: _t(np.stack([r[i] for r in rows]))
    for impl in ("onehot", "sort"):
        got = t_agg.aggregate(stack(0), stack(1), stack(2), 5, 16, impl=impl)
        for b, (w, d, g) in enumerate(rows):
            one = t_agg.aggregate(_t(w), _t(d), _t(g), 5, 16, impl=impl)
            for x, y in zip(got, one):
                assert torch.equal(x[b], y), impl


@pytest.mark.parametrize("latency", [0, 1, 3])
def test_credit_tick_matches_reference(latency):
    rng = np.random.default_rng(latency)
    r_bank = r_fc.init_credits(12, 40, latency)
    t_bank = t_fc.init_credits(12, 40, latency, device="cpu")
    for w in range(6):
        spent = rng.integers(0, 5, 12).astype(np.int32) * (w % 3 != 1)
        held = np.minimum(rng.integers(0, 3, 12), spent).astype(np.int32)
        notify = None if w % 2 else spent - held
        r_bank = r_fc.credit_tick(r_bank, jnp.asarray(spent),
                                  None if notify is None
                                  else jnp.asarray(notify))
        t_bank = t_fc.credit_tick(t_bank, _t(spent),
                                  None if notify is None else _t(notify))
        for a, b in zip(t_bank, r_bank):
            assert (a.numpy() == np.asarray(b)).all(), w
    assert int(t_bank.epoch) == 4


@pytest.mark.parametrize("shape", [(2, 4, 1), (2, 2, 2), (3, 4, 2),
                                   (1, 2, 2), (4, 4, 3)])
def test_host_torus_model_matches_reference(shape):
    r, t = r_torus.Torus(*shape), t_torus.Torus(*shape)
    n = r.n_nodes
    ids = np.arange(n)
    for a, b in zip(t.coords(ids), r.coords(ids)):
        assert (a == b).all()
    assert (t.hops(ids[:, None], ids[None, :])
            == r.hops(ids[:, None], ids[None, :])).all()
    for s in range(n):
        for d in range(n):
            assert t.route(s, d) == r.route(s, d)
            assert t.route_links(s, d) == r.route_links(s, d)
    traffic = np.random.default_rng(n).random((n, n)) * (
        np.random.default_rng(1).random((n, n)) < 0.6)
    assert t.link_loads(traffic) == r.link_loads(traffic)
    assert t.link_loads_scalar(traffic) == r.link_loads_scalar(traffic)
    w = r_torus.wafer_topology(n)
    assert t_torus.wafer_topology(n) == t_torus.Torus(w.nx, w.ny, w.nz)
    np.testing.assert_array_equal(t_torus.microcircuit_traffic(n, 1e6),
                                  r_torus.microcircuit_traffic(n, 1e6))


# ---------------------------------------------------------------------------
# The torus transports.
# ---------------------------------------------------------------------------

def _ref_state(state, width):
    """The port's fabric state as the reference's (numpy; one shard's
    payload buffer)."""
    f = lambda x: jnp.asarray(x.numpy())
    return r_base.FabricState(
        bank=r_fc.CreditBank(*(f(x) for x in state.bank)),
        parked_count=f(state.parked_count), parked_hop=f(state.parked_hop),
        parked_age=f(state.parked_age),
        parked_by_link=f(state.parked_by_link),
        parked_payload=jnp.zeros((state.parked_count.shape[0], width),
                                 jnp.uint32),
        parked_hold_shared=f(state.parked_hold_shared))


@pytest.mark.parametrize("backend,opts", [
    ("torus2d", {"nx": 2, "ny": 4}), ("torus3d", {"nx": 2, "ny": 2,
                                                  "nz": 2}),
    ("torus3d", {"nx": 1, "ny": 2, "nz": 3}), ("torus2d", {"nx": 3,
                                                           "ny": 3})])
def test_admission_replay_matches_reference(backend, opts):
    """``_admit_global`` against the reference's on the states of 8
    threaded windows of random traffic under tight credits (parking,
    resuming and re-parking rows, a rotating epoch), with the stall lane
    (``stall_attribution``) on both sides."""
    n = int(np.prod(list(opts.values())))
    kw = dict(link_credits=24, notify_latency=2, max_row_events=24,
              stall_attribution=True)
    t = t_tp.create(backend, n_shards=n, **opts, **kw)
    r = (r_tt.Torus2DTransport if backend == "torus2d"
         else r_tt.Torus3DTransport)(n, **opts, **kw)
    r_admit = jax.jit(r._admit_global)
    state = t.init_state(4, device="cpu")
    rng = np.random.default_rng(n)
    seen = {"park": 0, "resume": 0, "defer": 0}
    for w in range(8):
        counts = rng.integers(0, 25, (n, n)).astype(np.int32)
        got = t._admit_global(state, _t(counts))
        want = r_admit(_ref_state(state, 4), jnp.asarray(counts))
        for field in got._fields:
            a, b = getattr(got, field).numpy(), np.asarray(getattr(want,
                                                                   field))
            assert a.shape == b.shape and (a == b).all(), (w, field)
        seen["park"] += int(got.fresh_park.sum())
        seen["resume"] += int(got.resumed_complete.sum())
        seen["defer"] += int((got.stall_hop >= 0).sum())
        payload = _t(rng.integers(0, 1 << 30, (n, n, 4)).astype(np.int32))
        state = t.exchange(state, payload, _t(counts)).state
        held = state.bank.credits + state.bank.pending.sum(-1) \
            + state.parked_by_link
        assert (held == 24).all(), w
    assert all(v > 0 for v in seen.values()), seen


def _exchange_flat(out) -> dict:
    return convert.flatten(out)


@pytest.mark.parametrize("name", list(CASES))
def test_make_exchange_matches_reference(ref, tables, name):
    backend, opts = CASES[name]
    run = make_exchange(n_shards=S, capacity=C, n_addr_per_shard=N_ADDR,
                        transport=backend, transport_opts=opts)
    got = _exchange_flat(run(_t(ref["words"]), tables))
    _assert_tree_equal(got, ref, f"x.{name}.",
                       per_shard=tuple("link_state." + k
                                       for k in GLOBAL_STATE))


@pytest.mark.parametrize("impl", ["onehot", "sort", "pallas"])
def test_exchange_impls_match_reference_fused(ref, tables, impl):
    """The staged oracles (onehot, sort) and the kernel route give the
    reference's (fused) exchange, on the credited 3-D torus."""
    backend, opts = CASES["torus3d+credits"]
    run = make_exchange(n_shards=S, capacity=C, n_addr_per_shard=N_ADDR,
                        impl=impl, transport=backend, transport_opts=opts)
    got = _exchange_flat(run(_t(ref["words"]), tables))
    _assert_tree_equal(got, ref, "x.torus3d+credits.",
                       per_shard=tuple("link_state." + k
                                       for k in GLOBAL_STATE))


def test_uncredited_tori_deliver_what_alltoall_delivers(ref, tables):
    outs = {name: make_exchange(n_shards=S, capacity=C,
                                n_addr_per_shard=N_ADDR, transport=b,
                                transport_opts=o)(_t(ref["words"]), tables)
            for name, (b, o) in CASES.items() if "credits" not in name}
    a = outs.pop("alltoall")
    for name, o in outs.items():
        for field in ("recv_events", "recv_guids", "recv_counts",
                      "link_events", "sent_counts"):
            assert torch.equal(getattr(o, field), getattr(a, field)), name
        assert bool(o.sent_mask.all())
        assert int(o.link.forwarded_bytes.sum()) >= int(
            a.link.forwarded_bytes.sum())


def _study(tables, words, backend, opts):
    tb = t_tp.create(backend, n_shards=S, max_row_events=C, **opts)
    state = tb.init_state(2 * C, device="cpu")
    rows = []
    for _ in range(N_WIN):
        out = exchange_window(words, tables, n_shards=S, capacity=C,
                              transport=tb, link_state=state)
        state = out.link_state
        rows.append((out.link, out.latency))
    stack = lambda xs: type(xs[0])(*(None if f[0] is None else
                                     torch.stack(f, 1) for f in zip(*xs)))
    return (stack([r[0] for r in rows]), stack([r[1] for r in rows]), state,
            tb)


@pytest.fixture(scope="module")
def studies(ref, tables):
    return {name: _study(tables, _t(ref["words"]), *STUDIES[name])
            for name in STUDIES}


@pytest.mark.parametrize("name", list(STUDIES))
def test_threaded_windows_match_reference(ref, studies, name):
    """Six windows with the fabric state threaded: every LinkStats field
    of every window, the latency digests and the final fabric state (banks,
    delay lines, transit tables, parked payloads)."""
    link, lat, state, _ = studies[name]
    _assert_tree_equal(convert.flatten(link), ref, f"s.{name}.link.")
    _assert_tree_equal(convert.flatten(lat), ref, f"s.{name}.latency.")
    _assert_tree_equal(convert.flatten(state), ref, f"s.{name}.state.",
                       per_shard=GLOBAL_STATE)
    assert int(link.unparked_events.sum()) > 0


@pytest.mark.parametrize("name", list(STUDIES))
def test_credit_identities_hold_every_window(studies, name):
    link, _, state, tb = studies[name]
    assert (link.offered_events == link.sent_events + link.deferred_events
            + link.parked_events).all()
    assert (link.stalled_by_hop.sum(-1) == link.deferred_events).all()
    assert ((link.sent_events + link.unparked_events).sum(0)
            == link.delivered_events.sum(0)).all()
    held = state.bank.credits + state.bank.pending.sum(-1) \
        + state.parked_by_link
    assert (held == CREDITS).all()
    fab = tb.drain_fabric(state)
    assert int(fab.stats.unparked_events.sum()) == int(
        state.parked_count.sum()) == int(fab.recv_counts.sum()) > 0
    assert (fab.state.bank.credits + fab.state.bank.pending.sum(-1)
            == CREDITS).all()
    assert int(fab.state.parked_count.abs().sum()) == 0
    # an uncredited torus never parks: its drain delivers nothing
    free = t_tp.create("torus3d", n_shards=S, nx=2, ny=2, nz=2)
    empty = free.drain_fabric(free.init_state(device="cpu"), 2 * C)
    assert empty.recv_payload.shape == (S, S, 2 * C)
    assert int(empty.recv_counts.abs().sum()) == 0 and bool(
        empty.sent_mask.all())


def test_bench_transport_model_outputs(ref, tables, studies):
    """The committed credited rows of ``BENCH_transport.json`` (model
    outputs, not speeds), computed by the port from the same words."""
    with open(os.path.join(ROOT, "BENCH_transport.json")) as f:
        rows = {r["backend"]: r for r in json.load(f)}
    for name in ("torus2d+credits", "torus3d+credits"):
        backend, opts = CASES[name]
        out = make_exchange(n_shards=S, capacity=C, n_addr_per_shard=N_ADDR,
                            transport=backend, transport_opts=opts)(
            _t(ref["words"]), tables)
        want = rows[name]
        assert int(out.link.credit_stalls.sum()) == want["credit_stalls"]
        assert int(out.link.parked_events.sum()) == want["parked"]
        assert int(out.link.forwarded_bytes.sum()) == want["forwarded_bytes"]
        assert int(out.link.hops[0]) == want["hops"]
        assert out.link.stalled_by_hop.sum(0).tolist() == \
            want["stalled_by_hop"]
    link, lat, _, _ = studies["torus3d+credits"]
    want = rows["torus3d+credits*6win"]
    assert int(link.credit_stalls.sum()) == want["credit_stalls"] == 275
    assert int(link.hops[0].sum()) == want["hops"] == 18
    assert int(link.forwarded_bytes.sum()) == want["forwarded_bytes"]
    assert link.stalled_by_hop.sum((0, 1)).tolist() == want["stalled_by_hop"]
    assert int(link.parked_events.sum()) == want["parked"] == 3840
    assert int(link.unparked_events.sum()) == want["unparked"] == 2304
    assert int(link.deferred_events.sum()) == want["hop0_reentries"]
    assert round(float(link.queue_dwell_us.sum()), 3) == want["dwell_us"]
    assert round(float(lat.p99_us.max()), 3) == want["latency_p99_us"]


# ---------------------------------------------------------------------------
# The simulator on the credited tori.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def part():
    spec = mc.MicrocircuitSpec(scale=SIM_SCALE)
    return spec, network.build_partition(*spec.weight_matrix(),
                                         n_shards=SIM_SHARDS)


def _sim_cfg(p, transport, **kw):
    return sim.SimConfig(n_shards=SIM_SHARDS, per_shard=p.per_shard,
                         max_fan=p.fanout.shape[1], transport=transport,
                         **{**SIM_CFG, **kw})


@pytest.fixture(scope="module")
def sim_runs(ref, part):
    spec, p = part
    runs = {}
    for name, (transport, kw) in SIMS.items():
        _, run = sim.build_sharded_sim(_sim_cfg(p, transport, **kw), p,
                                       spec.bg_rates(), device="cpu")
        state0 = convert.state_from_reference(
            ref, prefix=f"sim.{name}.init.", device="cpu")
        state, stats = run(state0, SIM_WINDOWS,
                           drive=torch.from_numpy(ref["sim.drive"]))
        runs[name] = (convert.flatten(state), convert.flatten(stats))
    return runs


@pytest.mark.parametrize("name", list(SIMS))
def test_sim_torus_window_stats_match_reference(ref, sim_runs, name):
    _, got = sim_runs[name]
    prefix = f"sim.{name}.stats."
    keys = {k[len(prefix):] for k in ref if k.startswith(prefix)}
    assert keys == set(got), keys ^ set(got)
    _assert_tree_equal(got, ref, prefix)
    assert ref[prefix + "link.credit_stalls"].sum() > 0
    if name.endswith("congested"):
        for key in ("link.unparked_events", "deferred", "overflow",
                    "deadline_miss"):
            assert ref[prefix + key].sum() > 0, key


@pytest.mark.parametrize("name", list(SIMS))
def test_sim_torus_final_state_within_lif_tolerance(ref, sim_runs, name):
    got, _ = sim_runs[name]
    want = lambda k: ref[f"sim.{name}.final.{k}"]
    np.testing.assert_allclose(got["neuron.v"], want("neuron.v"), rtol=2e-5,
                               atol=1e-4)
    for key in ("ring_exc", "ring_inh"):
        np.testing.assert_allclose(np.swapaxes(got[key], 0, 1), want(key),
                                   rtol=1e-6, err_msg=key)
    assert (got["neuron.refrac"] == want("neuron.refrac")).all()


@pytest.mark.parametrize("name", list(SIMS))
def test_sim_torus_backpressure_chain_balances(sim_runs, name):
    """The identities of ``tests/test_transport.py``'s congested run."""
    _, s = sim_runs[name]
    g = lambda k: s["link." + k]
    assert (g("offered_events") == g("sent_events") + g("deferred_events")
            + g("parked_events")).all()
    assert ((g("sent_events") + g("unparked_events")).sum(0)
            == g("delivered_events").sum(0)).all()
    assert (g("stalled_by_hop").sum(-1) == g("deferred_events")).all()
    infab_prev = np.concatenate([np.zeros((SIM_SHARDS, 1), np.int64),
                                 g("in_fabric_events")[:, :-1]], axis=1)
    assert (g("in_fabric_events") == infab_prev + g("parked_events")
            - g("unparked_events")).all()
    assert (g("offered_events")[:, 1:] == s["events_sent"][:, :-1]).all()
    defr_prev = np.concatenate([np.zeros((SIM_SHARDS, 1), np.int64),
                                s["deferred"][:, :-1]], axis=1)
    assert (s["offered"] - defr_prev - g("deferred_events") >= 0).all()
    assert (s["offered"] == s["events_sent"] + s["deferred"]
            + s["overflow"]).all()
    assert (s["latency.hist"].sum(-1) == g("delivered_events")).all()


def test_sim_uncredited_tori_equal_alltoall(part):
    """Without credits both tori reproduce the crossbar's spike train and
    bucket traffic window for window, with no deadline miss."""
    spec, p = part
    rng = np.random.default_rng(5)
    drive = torch.from_numpy(rng.poisson(1.3, (6, 8, SIM_SHARDS,
                                               p.per_shard)).astype(
        np.float32) * np.float32(87.8))
    stats = {}
    for transport, kw in (("alltoall", {}), ("torus2d", {}),
                          ("torus3d", {"torus_nx": 1, "torus_ny": 2,
                                       "torus_nz": 2})):
        init, run = sim.build_sharded_sim(
            _sim_cfg(p, transport, capacity=512, link_credits=0, **kw), p,
            spec.bg_rates(), device="cpu")
        stats[transport] = convert.flatten(run(init(0), 6, drive=drive)[1])
    a = stats.pop("alltoall")
    assert a["spikes"].sum() > 0
    for name, s in stats.items():
        for key in ("spikes", "events_sent", "offered", "deferred",
                    "overflow", "wire_bytes", "link.offered_events",
                    "link.delivered_events"):
            assert (s[key] == a[key]).all(), (name, key)
        assert s["deadline_miss"].sum() == 0
        assert s["link.credit_stalls"].sum() == 0
        assert (s["link.hops"][:, 1:] > 0).all()


# ---------------------------------------------------------------------------
# Entry points and the paths still to port.
# ---------------------------------------------------------------------------

def test_torus_entry_points_default_to_cuda_and_raise_without_it(part):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    spec, p = part
    tr = t_tp.create("torus3d", n_shards=8, link_credits=64)
    entry_points = [
        lambda: tr.init_state(4),
        lambda: tr.route_hops(),
        lambda: sim.build_sharded_sim(_sim_cfg(p, "torus2d"), p,
                                      spec.bg_rates()),
    ]
    for i, make in enumerate(entry_points):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
            pytest.fail(f"entry point {i} ran without a CUDA device")


def test_torus_guards_and_unported_paths_raise():
    with pytest.raises(ValueError, match="head-of-line"):
        t_tp.create("torus2d", n_shards=8, link_credits=10,
                    max_row_events=32)
    with pytest.raises(ValueError, match="n_shards"):
        t_tp.create("torus3d", n_shards=8, nx=3, ny=2, nz=2)
    # per-link stall attribution (item 10) is ported: it builds
    assert t_tp.create("torus2d", n_shards=8, link_credits=64,
                       stall_attribution=True).stall_attribution
    # the multi-tenant torus (item 9) is ported: it builds, and refuses an
    # oversubscribed partition and a row no tenant could ever admit
    from repro_torch.core import flow_control as t_fc
    from repro_torch.transport import torus as t_tt
    part = t_fc.make_partition(64, (16, 8))
    tt = t_tt.TenantTorusTransport(8, (2, 4), partition=part)
    assert tt.n_tenants == 2 and tt.link_credits == 64
    assert tt.init_state(4, device="cpu").bank.credits.shape == (3 * 32,)
    with pytest.raises(ValueError, match="oversubscribed"):
        t_fc.make_partition(64, (40, 30))
    with pytest.raises(ValueError, match="head-of-line"):
        t_tt.TenantTorusTransport(8, (2, 4), partition=t_fc.make_partition(
            64, (60, 0)), max_row_events=32)
    assert t_tt.TenantTorusTransport(8, (2, 4), partition=part,
                                     stall_attribution=True).stall_attribution
    tr = t_tp.create("torus2d", n_shards=8, link_credits=64,
                     stall_attribution=True)
    state = tr.init_state(4, device="cpu")
    # fault injection (item 8) is ported: the faulted replay and the
    # detours run
    down = torch.zeros(tr.n_shards * tr.n_links, dtype=torch.bool)
    counts = torch.full((8, 8), 3, dtype=torch.int32)
    faulted = tr._admit_global_faulted(state, counts, down)
    healthy = tr._admit_global(state, counts)
    for field in healthy._fields:
        assert torch.equal(getattr(faulted, field), getattr(healthy, field))
    assert t_torus.Torus(2, 4, 1).route_links_detour(0, 5) == \
        t_torus.Torus(2, 4, 1).route_links(0, 5)
    with pytest.raises(ValueError, match="payload"):
        tr.exchange(state, torch.zeros((8, 8, 6), dtype=torch.int32),
                    torch.zeros((8, 8), dtype=torch.int32))
    from repro_torch.launch import mesh
    assert mesh.wafer_torus_shape(8) == (2, 4)
    assert mesh.wafer_torus_shape(8, ndim=3) == (2, 2, 2)
    assert mesh.wafer_wire_format("ethernet").name == "ethernet"


def test_fabric_modules_import_no_jax():
    code = ("import sys, repro_torch.core.exchange, repro_torch.core.torus, "
            "repro_torch.transport.torus, repro_torch.kernels.ops, "
            "repro_torch.kernels.ref, repro_torch.launch.mesh; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=SRC))
