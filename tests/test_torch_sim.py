"""The whole slice, port vs reference: the crossbar exchange and the
windowed microcircuit simulator (scale 0.004, 4 shards, 6 windows).

The reference runs once, in one subprocess with 4 forced host devices
(``md_helper.run_md``), and saves its outputs as ``.npz``: the exchange of
a random window, ``build_sharded_sim`` under ample capacity, under bucket
pressure (the residue path) and on the ethernet wire profile, its initial
states, and the background drive replayed from its own key chain
(``PRNGKey(s + seed * 1000 + 7)``, split once per step, then
``lif.poisson_input``).  The port gets the same
initial state through ``repro_torch.convert`` and the replayed drive, runs
on the CPU, and must match every integer ``WindowStats`` / ``LinkStats``
field of every window exactly; latency digests at rtol 1e-6 (hist exact);
membrane state and ring currents at the LIF tolerances of
``tests/test_kernels.py`` (sums over events run in another order)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from md_helper import SRC, run_md
from repro_torch import convert, transport
from repro_torch.snn import microcircuit as mc, network, simulator as sim
from repro_torch.wire import codec as t_codec

SCALE, N_SHARDS, N_WINDOWS, SEED = 0.004, 4, 6, 0
# capacity, residue, wire format
CONFIGS = {"ample": (512, 64, "extoll"), "pressure": (4, 64, "extoll"),
           "ethernet": (64, 64, "ethernet")}

REF_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro import transport
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

S, SEED, NW = %(S)d, %(SEED)d, %(NW)d
spec = mc.MicrocircuitSpec(scale=%(SCALE)r)
part = network.build_partition(*spec.weight_matrix(), n_shards=S)
per = part.per_shard
mesh = jax.make_mesh((S,), ("wafer",))
for name, (cap, res, fmt) in %(CONFIGS)r.items():
    cfg = sim.SimConfig(n_shards=S, per_shard=per,
                        max_fan=part.fanout.shape[1], window=8, ring_len=32,
                        e_max=256, capacity=cap, residue=res, wire_format=fmt)
    init, run = sim.build_sharded_sim(mesh, "wafer", cfg, part,
                                      spec.bg_rates())
    st0 = init(SEED)
    st1, stats = run(st0, NW)
    flat(st0, name + ".init.")
    flat(st1, name + ".final.")
    flat(stats, name + ".stats.")

bg = np.pad(spec.bg_rates(), (0, part.n_neurons - len(spec.bg_rates())))
bg = bg.reshape(S, per)

@jax.jit
def draws(key, rate):
    def step(k, _):
        k, sub = jax.random.split(k)
        return k, lif.poisson_input(sub, per, rate, 87.8, 0.1)
    return jax.lax.scan(step, key, None, length=NW * 8)[1]

drive = np.stack([np.asarray(draws(jax.random.PRNGKey(s + SEED * 1000 + 7),
                                   jnp.asarray(bg[s]))) for s in range(S)])
out["drive"] = drive.reshape(S, NW, 8, per).transpose(1, 2, 0, 3)

rng = np.random.default_rng(0)
payload = rng.integers(0, 2**32, (S, S, 10), dtype=np.uint64).astype(
    np.uint32)
counts = rng.integers(0, 300, (S, S)).astype(np.int32)
tr = transport.create("alltoall", n_shards=S, wire_format="extoll")
def body(p, c):
    o = tr.exchange(tr.init_state(), p[0], c[0], axis_name="wafer")
    return jax.tree_util.tree_map(lambda x: x[None], (
        o.recv_payload, o.recv_counts, o.sent_mask, o.stats))
f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("wafer"), P("wafer")),
                      out_specs=P("wafer"), check_rep=False))
rp, rc, sm, stats = f(payload, counts)
out.update({"xchg.payload": payload, "xchg.counts": counts,
            "xchg.recv_payload": np.asarray(rp),
            "xchg.recv_counts": np.asarray(rc),
            "xchg.sent_mask": np.asarray(sm)})
flat(stats, "xchg.stats.")
np.savez(%(PATH)r, **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    out = run_md(REF_SCRIPT % dict(S=N_SHARDS, SEED=SEED, NW=N_WINDOWS,
                                   SCALE=SCALE, CONFIGS=CONFIGS, PATH=path),
                 n_devices=N_SHARDS)
    assert "REF_OK" in out
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def part():
    spec = mc.MicrocircuitSpec(scale=SCALE)
    return spec, network.build_partition(*spec.weight_matrix(),
                                         n_shards=N_SHARDS)


def _cfg(p, name):
    capacity, residue, wire_format = CONFIGS[name]
    return sim.SimConfig(n_shards=N_SHARDS, per_shard=p.per_shard,
                         max_fan=p.fanout.shape[1], window=8, ring_len=32,
                         e_max=256, capacity=capacity, residue=residue,
                         wire_format=wire_format)


@pytest.fixture(scope="module")
def port_runs(ref, part):
    """The port on the CPU, started from the reference's initial state and
    driven by the reference's replayed background drive."""
    spec, p = part
    runs = {}
    for name in CONFIGS:
        _, run = sim.build_sharded_sim(_cfg(p, name), p, spec.bg_rates(),
                                       device="cpu")
        state0 = convert.state_from_reference(ref, prefix=f"{name}.init.",
                                              device="cpu")
        state, stats = run(state0, N_WINDOWS,
                           drive=torch.from_numpy(ref["drive"]))
        runs[name] = (convert.flatten(state), convert.flatten(stats))
    return runs


def test_alltoall_exchange_matches_reference(ref):
    tr = transport.create("alltoall", n_shards=N_SHARDS, wire_format="extoll")
    out = tr.exchange(tr.init_state(device="cpu"),
                      torch.from_numpy(ref["xchg.payload"].view(np.int32)),
                      torch.from_numpy(ref["xchg.counts"]))
    assert (out.recv_payload.numpy().view(np.uint32)
            == ref["xchg.recv_payload"]).all()
    assert (out.recv_counts.numpy() == ref["xchg.recv_counts"]).all()
    assert (out.sent_mask.numpy() == ref["xchg.sent_mask"]).all()
    got = convert.flatten(out.stats)
    for key, want in ((k[len("xchg.stats."):], v) for k, v in ref.items()
                      if k.startswith("xchg.stats.")):
        assert got[key].shape == want.shape, key
        assert (got[key] == want).all(), key
    assert int(ref["xchg.stats.bytes_on_wire"].sum()) > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sim_window_stats_match_reference(ref, port_runs, name):
    """Every integer field of every window exactly; latency digests at
    rtol 1e-6 with the histogram exact."""
    _, got = port_runs[name]
    prefix = f"{name}.stats."
    keys = [k[len(prefix):] for k in ref if k.startswith(prefix)]
    assert set(keys) == set(got), set(keys) ^ set(got)
    for key in keys:
        want = ref[prefix + key]
        assert got[key].shape == want.shape, key
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got[key], want, rtol=1e-6,
                                       err_msg=key)
        else:
            assert (got[key] == want).all(), (key, got[key], want)
    assert ref[prefix + "spikes"].sum() > 0
    assert ref[prefix + "link.delivered_events"].sum() > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sim_final_state_within_lif_tolerance(ref, port_runs, name):
    got, _ = port_runs[name]
    want = lambda k: ref[f"{name}.final.{k}"]
    np.testing.assert_allclose(got["neuron.v"], want("neuron.v"), rtol=2e-5,
                               atol=1e-4)
    for key in ("neuron.i_exc", "neuron.i_inh"):
        np.testing.assert_allclose(got[key], want(key), rtol=1e-6,
                                   err_msg=key)
    for key in ("ring_exc", "ring_inh"):          # port rings are slot-major
        np.testing.assert_allclose(np.swapaxes(got[key], 0, 1), want(key),
                                   rtol=1e-6, err_msg=key)
    assert (got["neuron.refrac"] == want("neuron.refrac")).all()
    assert (got["t"] == want("t")).all()


def test_sim_residue_chain_balances_under_pressure(port_runs):
    """The identity of ``tests/test_pipeline.py`` per shard:
    offered = sent + deferred + dropped each window, and the new events
    sum to what was sent, dropped or left deferred."""
    _, s = port_runs["pressure"]
    off, sent, defr, drop = (s[k] for k in ("offered", "events_sent",
                                            "deferred", "overflow"))
    assert defr.sum() > 0, "residue carry-over unexercised"
    assert (off == sent + defr + drop).all()
    new = off - np.concatenate([np.zeros((N_SHARDS, 1), defr.dtype),
                                defr[:, :-1]], axis=1)
    assert (new >= 0).all()
    assert (new.sum(1) == sent.sum(1) + drop.sum(1) + defr[:, -1]).all()
    assert (s["link.offered_events"] == s["link.sent_events"]).all()
    assert (s["link.sent_events"].sum(0)
            == s["link.delivered_events"].sum(0)).all()


def test_convert_carry_round_trip(ref, part):
    """Reference carry -> port -> reference layout gives the same arrays;
    the port's pending wire payload (no reference counterpart) is encoded
    from the pending buckets on the way in and dropped on the way out."""
    spec, p = part
    flat = {f"state.{k[len('ample.init.'):]}": v for k, v in ref.items()
            if k.startswith("ample.init.")}
    cfg = _cfg(p, "ample")
    init_pending, init_link, _, _ = sim.make_pipeline_fns(cfg, device="cpu")
    pend = convert.flatten(init_pending())
    assert not pend.pop("payload").any()     # empty buckets encode to 0
    rng = np.random.default_rng(3)
    pend["data"] = rng.integers(0, 1 << 30, pend["data"].shape).astype(
        np.int32)
    pend["meta"] = rng.integers(-2**31, 2**31, pend["meta"].shape,
                                dtype=np.int64).astype(np.int32)
    flat.update({f"pending.{k}": (v.view(np.uint32) if k in ("data",
                                                             "residue")
                                  else v) for k, v in pend.items()})
    carry = convert.carry_from_reference(flat, init_link(), device="cpu")
    data, meta = torch.from_numpy(pend["data"]), torch.from_numpy(
        pend["meta"])
    assert torch.equal(carry.pending.payload,
                       torch.cat(t_codec.encode_plain(data, meta), dim=-1))
    assert all(torch.equal(a, b) for a, b in zip(
        t_codec.decode_planar(carry.pending.payload), (data, meta)))
    back = convert.carry_to_reference(carry)
    pending_keys = lambda d: {k for k in d if k.startswith("pending.")}
    assert pending_keys(back) == pending_keys(flat)   # payload dropped
    for key, value in back.items():
        assert value.dtype == flat[key].dtype, key
        assert (value == flat[key]).all(), key


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.snn.simulator, repro_torch.configs.brainscales, "
            "repro_torch.configs.mamba2_27b, repro_torch.models.model, "
            "repro_torch.kernels.ssd_chunk, repro_torch.serve.engine, "
            "repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=SRC))


def test_default_device_is_cuda_and_raises_without_it(ref, part):
    """Every entry point that makes tensors defaults to CUDA and raises
    without it; none quietly builds CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import flow_control, routing
    from repro_torch.launch import serve
    from repro_torch.models import build, hybrid, modules
    from repro_torch.snn import lif
    from repro_torch.wire import zero_latency_summary
    spec, p = part
    lm_cfg = reduced(get_config("mamba2_27b"))
    lm = build(lm_cfg)
    tr = transport.create("alltoall", n_shards=N_SHARDS)
    tabs = [network.routing_tables_for_shard(p, s, device="cpu")
            for s in range(N_SHARDS)]
    flat_tables = convert.tables_to_reference(
        sim.stack_tables(tabs, device="cpu"))
    entry_points = [
        lambda: sim.build_sharded_sim(_cfg(p, "ample"), p, spec.bg_rates()),
        lambda: sim.build_sharded_segments(_cfg(p, "ample"), p,
                                           spec.bg_rates()),
        lambda: sim.make_pipeline_fns(_cfg(p, "ample")),
        lambda: sim.stack_tables(tabs),
        lambda: convert.state_from_reference(ref, prefix="ample.init."),
        lambda: convert.tables_from_reference(**flat_tables),
        lambda: convert.carry_from_reference({}, None),
        lambda: lif.init_state((2, 3), lif.LIFParams()),
        lambda: tr.init_state(),
        lambda: tr.route_hops(),
        lambda: transport.zero_link_stats((N_SHARDS,)),
        lambda: flow_control.init_credits(4, 8, 2),
        lambda: zero_latency_summary((N_SHARDS,)),
        lambda: routing.build_tables(8, [routing.Projection(0, 4, 1, [0])]),
        lambda: network.routing_tables_for_shard(p, 0),
        lambda: modules.init_params(lm.specs(), torch.Generator()),
        lambda: lm.init(torch.Generator()),
        lambda: lm.init_caches(2, 16),
        lambda: hybrid.mamba2_init_caches(lm_cfg, 2),
        lambda: convert.params_from_reference({"w": np.zeros(2)}),
        lambda: convert.caches_from_reference((np.zeros(2), np.zeros(2))),
        lambda: serve.main(["--arch", "mamba2_27b", "--reduced"]),
    ]
    for i, make in enumerate(entry_points):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
            pytest.fail(f"entry point {i} ran without a CUDA device")


def test_unported_paths_raise(part):
    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.models import build
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    spec, p = part
    # every architecture (item 12, parts 1-4 with the dense family and
    # Mamba-2) resolves and builds, each family its own
    families = {}
    for arch in ARCHS:
        families[arch] = build(reduced(get_config(arch))).cfg.family
        assert build(get_config(arch)).cfg.name == get_config(arch).name
    assert set(families.values()) == {"dense", "moe", "vlm", "ssm",
                                      "hybrid", "audio"}
    lm_cfg = reduced(get_config("mamba2-2.7b"))
    lm = build(lm_cfg)
    # the span tracer (item 10) is ported
    from repro_torch.obs import Tracer
    tracer = Tracer()
    assert Engine(lm, ServeConfig(), tracer=tracer).tracer is tracer
    params = lm.init(torch.Generator(), device="cpu")
    # request extras are merged; one that does not cover the wave raises
    with pytest.raises(ValueError, match="no batch axis 0"):
        Engine(lm, ServeConfig()).generate_batch(params, [Request(
            0, np.arange(3, 7, dtype=np.int32), extras={"enc_frames": 0})])
    # fault injection (item 8) is ported: the faulted replay runs, and
    # under an all-false mask it is the healthy one
    tr = transport.create("torus2d", n_shards=4, link_credits=64,
                          stall_attribution=True)
    st = tr.init_state(4, device="cpu")
    counts = torch.full((4, 4), 9, dtype=torch.int32)
    faulted = tr._admit_global_faulted(st, counts, torch.zeros(
        16, dtype=torch.bool))
    for a, b in zip(faulted, tr._admit_global(st, counts)):
        assert torch.equal(a, b)
    # the multi-tenant torus (item 9) is ported: it builds, and refuses an
    # oversubscribed partition
    from repro_torch.core.flow_control import make_partition
    from repro_torch.transport.torus import TenantTorusTransport
    tt = TenantTorusTransport(4, (2, 2), partition=make_partition(64, (32,)))
    assert tt.partition.shared == 32
    with pytest.raises(ValueError, match="oversubscribed"):
        TenantTorusTransport(4, (2, 2), partition=make_partition(64, (65,)))
    # a fault schedule needs a credited torus; the crossbar refuses it
    with pytest.raises(ValueError, match="credit-throttled"):
        sim.build_sharded_sim(_cfg(p, "ample"), p, spec.bg_rates(),
                              fault_schedule=object(), device="cpu")
    # the flight recorder (item 10) is ported: the carry holds a ring
    from repro_torch.obs import RecorderConfig
    init, _, _ = sim.build_sharded_segments(
        _cfg(p, "ample"), p, spec.bg_rates(), recorder=RecorderConfig(4),
        device="cpu")
    assert init(0).ring.depth == 4
