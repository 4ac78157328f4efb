"""Port vs reference, bit for bit: event words, routing tables, the window
cost model, the microcircuit's network and its partition.

The same seed-made numpy inputs go through ``repro`` (JAX) and
``repro_torch``; u32 words are compared through ``np.uint32`` views."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregator as r_agg, events as r_ev, routing as r_rt
from repro.core import flow_control as r_fc
from repro.snn import microcircuit as r_mc, network as r_net
from repro_torch.core import aggregator as t_agg, events as t_ev
from repro_torch.core import flow_control as t_fc, routing as t_rt
from repro_torch.snn import microcircuit as t_mc, network as t_net


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def _words(rng, n, p_valid=0.8, addr_hi=1 << 14):
    addr = rng.integers(-5, addr_hi, n).astype(np.int32)
    ts = rng.integers(-100, 1 << 16, n).astype(np.int32)
    valid = rng.random(n) < p_valid
    return addr, ts, valid


@pytest.mark.parametrize("seed", range(4))
def test_events_bit_exact(seed):
    rng = np.random.default_rng(seed)
    addr, ts, valid = _words(rng, 500)
    ref = np.asarray(r_ev.pack(jnp.asarray(addr), jnp.asarray(ts),
                               valid=jnp.asarray(valid)))
    got = t_ev.pack(torch.from_numpy(addr), torch.from_numpy(ts),
                    valid=torch.from_numpy(valid))
    assert got.dtype == torch.int32
    assert (_u32(got) == ref).all()
    assert (_u32(t_ev.pack(torch.from_numpy(addr), torch.from_numpy(ts)))
            == np.asarray(r_ev.pack(jnp.asarray(addr), jnp.asarray(ts)))).all()
    # INVALID words (valid bit clear) are zero on both sides
    assert (ref[~valid] == 0).all()
    w_r, w_t = jnp.asarray(ref), got
    assert (t_ev.address(w_t).numpy() == np.asarray(r_ev.address(w_r))).all()
    assert (t_ev.timestamp(w_t).numpy()
            == np.asarray(r_ev.timestamp(w_r))).all()
    assert (t_ev.is_valid(w_t).numpy() == np.asarray(r_ev.is_valid(w_r))).all()
    a = rng.integers(0, 1 << 15, 500).astype(np.int32)
    b = rng.integers(0, 1 << 15, 500).astype(np.int32)
    assert (t_ev.ts_slack(torch.from_numpy(a), torch.from_numpy(b)).numpy()
            == np.asarray(r_ev.ts_slack(jnp.asarray(a), jnp.asarray(b)))).all()
    assert (t_ev.ts_before(torch.from_numpy(a), torch.from_numpy(b)).numpy()
            == np.asarray(r_ev.ts_before(jnp.asarray(a),
                                         jnp.asarray(b)))).all()


def test_packet_cost_functions_bit_exact():
    n = np.arange(0, 700, dtype=np.int32)
    for name in ("packet_bytes", "wire_cycles"):
        got = getattr(t_ev, name)(torch.from_numpy(n)).numpy()
        want = np.asarray(getattr(r_ev, name)(jnp.asarray(n)))
        assert (got == want).all(), name
    got = t_ev.wire_efficiency(torch.from_numpy(n)).numpy()
    want = np.asarray(r_ev.wire_efficiency(jnp.asarray(n)))
    assert got.dtype == want.dtype and (got == want).all()


@pytest.mark.parametrize("seed", range(3))
def test_window_cost_bit_exact(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 600, (5, 7)).astype(np.int32)
    counts[0] = 0                                   # an empty window
    got = t_agg.window_cost(torch.from_numpy(counts))   # one per row
    for row in range(counts.shape[0]):
        want = r_agg.window_cost(jnp.asarray(counts[row]))
        for field in t_agg.WindowCost._fields:
            assert getattr(got, field)[row].item() == \
                np.asarray(getattr(want, field)).item(), (row, field)
    total = int(counts.sum())
    got_u, want_u = t_agg.unaggregated_cost(total), r_agg.unaggregated_cost(
        total)
    for field in t_agg.WindowCost._fields:
        assert getattr(got_u, field).item() == \
            np.asarray(getattr(want_u, field)).item(), field


def _projections(n_addr, d):
    return [(a, a + 1, (a * 5) % d, [a % 3, 7]) for a in range(0, n_addr, 2)]


@pytest.mark.parametrize("seed", range(3))
def test_routing_tables_route_and_multicast(seed):
    """Tables, LUT routing with clamped out-of-range addresses and INVALID
    words, GUID multicast (negative and out-of-range GUIDs) and the
    multicast replay."""
    rng = np.random.default_rng(seed)
    n_addr, d = 96, 6
    projs = _projections(n_addr, d)
    ref = r_rt.build_tables(n_addr, [r_rt.Projection(*p) for p in projs],
                            n_guid=40)
    got = t_rt.build_tables(n_addr, [t_rt.Projection(*p) for p in projs],
                            n_guid=40, device="cpu")
    assert (got.dest_of_addr.numpy() == np.asarray(ref.dest_of_addr)).all()
    assert (got.guid_of_addr.numpy() == np.asarray(ref.guid_of_addr)).all()
    assert (_u32(got.mcast_of_guid) == np.asarray(ref.mcast_of_guid)).all()
    addr, ts, valid = _words(rng, 300, addr_hi=n_addr + 40)
    words = np.array(r_ev.pack(jnp.asarray(addr), jnp.asarray(ts),
                               valid=jnp.asarray(valid)))
    r_dest, r_guid, r_ok = ref.route(jnp.asarray(words))
    t_dest, t_guid, t_ok = got.route(torch.from_numpy(words.view(np.int32)))
    assert (t_dest.numpy() == np.asarray(r_dest)).all()
    assert (t_guid.numpy() == np.asarray(r_guid)).all()
    assert (t_ok.numpy() == np.asarray(r_ok)).all()
    guids = rng.integers(-3, 50, 200).astype(np.int32)
    r_m = np.asarray(ref.multicast(jnp.asarray(guids)))
    t_m = got.multicast(torch.from_numpy(guids))
    assert (_u32(t_m) == r_m).all()
    r_x = np.asarray(r_rt.expand_multicast(jnp.asarray(words[:200]),
                                           jnp.asarray(r_m), 8))
    t_x = t_rt.expand_multicast(torch.from_numpy(words[:200].view(np.int32)),
                                t_m, 8)
    assert (_u32(t_x) == r_x).all()


def test_stacked_tables_lookup_per_shard():
    """A stacked (S, n_addr) table routes (S, n) words row by row."""
    rng = np.random.default_rng(5)
    tabs = [t_rt.build_tables(32, [t_rt.Projection(a, a + 1, (a + s) % 4,
                                                   [a % 8])
                                   for a in range(32)], device="cpu")
            for s in range(3)]
    stacked = t_rt.RoutingTables(
        *(torch.stack([getattr(t, f) for t in tabs])
          for f in ("dest_of_addr", "guid_of_addr", "mcast_of_guid")))
    addr, ts, valid = _words(rng, 3 * 50, addr_hi=40)
    words = t_ev.pack(torch.from_numpy(addr), torch.from_numpy(ts),
                      valid=torch.from_numpy(valid)).reshape(3, 50)
    dest, guid, ok = stacked.route(words)
    for s in range(3):
        d1, g1, o1 = tabs[s].route(words[s])
        assert (dest[s] == d1).all() and (guid[s] == g1).all() and \
            (ok[s] == o1).all()


@pytest.mark.parametrize("scale,n_shards", [(0.003, 4), (0.004, 4),
                                            (0.004, 3)])
def test_network_partition_and_tables_match_reference(scale, n_shards):
    """The port's copies of the numpy-only network code give the same
    weights, partition (fan-out computed in one pass instead of a loop) and
    per-shard routing tables."""
    w_r, inh_r = r_mc.MicrocircuitSpec(scale=scale).weight_matrix()
    spec = t_mc.MicrocircuitSpec(scale=scale)
    w_t, inh_t = spec.weight_matrix()
    assert (w_t == w_r).all() and (inh_t == inh_r).all()
    assert (spec.bg_rates() == r_mc.MicrocircuitSpec(
        scale=scale).bg_rates()).all()
    p_r = r_net.build_partition(w_r, inh_r, n_shards)
    p_t = t_net.build_partition(w_t, inh_t, n_shards)
    for field in ("n_shards", "n_neurons", "per_shard"):
        assert getattr(p_t, field) == getattr(p_r, field)
    for field in ("fanout", "weights", "is_inh", "delays_steps"):
        a, b = getattr(p_t, field), getattr(p_r, field)
        assert a.dtype == b.dtype and (a == b).all(), field
    for s in range(n_shards):
        tr = r_net.routing_tables_for_shard(p_r, s)
        tt = t_net.routing_tables_for_shard(p_t, s, device="cpu")
        assert (tt.dest_of_addr.numpy() == np.asarray(tr.dest_of_addr)).all()
        assert (tt.guid_of_addr.numpy() == np.asarray(tr.guid_of_addr)).all()
        assert (_u32(tt.mcast_of_guid) == np.asarray(tr.mcast_of_guid)).all()


def test_credit_bank_init_matches_reference():
    for args in [(0, 0, 1), (6, 5, 2), (3, 7, 0)]:
        r = r_fc.init_credits(*args)
        t = t_fc.init_credits(*args, device="cpu")
        for field in t_fc.CreditBank._fields:
            a, b = getattr(t, field).numpy(), np.asarray(getattr(r, field))
            assert a.shape == b.shape and (a == b).all(), (args, field)


def test_convert_partition_and_stacked_tables():
    """``convert`` carries a reference partition and its stacked routing
    tables over, and back, unchanged; the stacked tables equal the port's
    own ``stack_tables`` of its per-shard tables."""
    from repro_torch import convert
    from repro_torch.snn import simulator as t_sim
    w, inh = r_mc.MicrocircuitSpec(scale=0.003).weight_matrix()
    p_r = r_net.build_partition(w, inh, 4)
    p_t = convert.partition_from_reference(p_r)
    assert (p_t.fanout == t_net.build_partition(w, inh, 4).fanout).all()
    tabs = [r_net.routing_tables_for_shard(p_r, s) for s in range(4)]
    na = max(t.dest_of_addr.shape[0] for t in tabs)
    ng = max(t.mcast_of_guid.shape[0] for t in tabs)
    pad = lambda a, n, v: np.pad(np.asarray(a), (0, n - a.shape[0]),
                                 constant_values=v)
    ref = {"dest_of_addr": np.stack([pad(t.dest_of_addr, na, -1)
                                     for t in tabs]),
           "guid_of_addr": np.stack([pad(t.guid_of_addr, na, 0)
                                     for t in tabs]),
           "mcast_of_guid": np.stack([pad(t.mcast_of_guid, ng, 0)
                                      for t in tabs])}
    got = convert.tables_from_reference(**ref, device="cpu")
    own = t_sim.stack_tables([t_net.routing_tables_for_shard(p_t, s,
                                                             device="cpu")
                              for s in range(4)], device="cpu")
    back = convert.tables_to_reference(got)
    for key, want in ref.items():
        assert (getattr(got, key) == getattr(own, key)).all(), key
        assert back[key].dtype == want.dtype and (back[key] == want).all()


PAPER_CONSTANTS = (("torus", "FPGAS_PER_WAFER", 48),
                   ("torus", "CONCENTRATORS_PER_WAFER", 8),
                   ("torus", "FPGAS_PER_CONCENTRATOR", 6),
                   ("torus", "HICANNS_PER_FPGA", 8),
                   ("torus", "LANES_PER_LINK", 12),
                   ("torus", "GBIT_PER_LANE", 8.4),
                   ("torus", "LINK_GBYTES", 12.6),
                   ("torus", "LINKS_PER_NODE", 7),
                   ("routing", "DEST_BITS", 16),
                   ("routing", "MAX_DESTS", 1 << 16))


@pytest.mark.parametrize("module,name,paper", PAPER_CONSTANTS)
def test_paper_constants_equal_reference(module, name, paper):
    """The paper's hardware constants (``tests/test_core.py``'s
    ``test_wafer_topology_paper_constants``): the port's own copies equal
    the reference's and the paper's."""
    import importlib
    ref = getattr(importlib.import_module(f"repro.core.{module}"), name)
    got = getattr(importlib.import_module(f"repro_torch.core.{module}"),
                  name)
    assert type(got) is type(ref) and got == ref, (name, got, ref)
    assert abs(got - paper) < 1e-9, (name, got)
