"""Port vs reference for the MoE family, on the CPU:

* the router's integers bit for bit: top-k experts (ties to the lower
  index, as ``jax.lax.top_k``: planted exact ties), each assignment's slot
  (``_positions``), the per-expert counts, the kept mask and
  ``_capacity``;
* ``moe_layer_local`` in f32 at 2e-4 (the reference's own tolerance,
  ``tests/test_multidevice.py:135``): the output, the aux and z losses and
  the dropped fraction, with and without drops, and with an injected
  router jitter;
* the port's ``moe_layer_bucket`` (EP 8 as a leading dimension) against
  the reference's inside ``shard_map`` over 8 fake devices (one
  subprocess), at 2e-4, per rank;
* reduced deepseek-moe-16b and arctic-480b (the first dense layer's own
  stack and caches, shared experts, the parallel dense MLP): the full
  forward, prefill (every cache field) and one decode step at 5e-2
  (``tests/test_models.py:101``), with ``_stable_init`` weights;
* ``python -m repro_torch.launch.serve --arch <moe arch> --reduced
  --device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_helper import run_md
from repro.configs.base import MoEConfig as RMoEConfig
from repro.models import moe as r_moe
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.models import build, moe as t_moe
from test_torch_models import (_close, assert_port_matches_reduced,
                               reference_reduced)

MOD_TOL = 2e-4
ARCHS = ("deepseek_moe_16b", "arctic_480b")


def _moe(**kw):
    return MoEConfig(**kw), RMoEConfig(**kw)


def _weights(rng, d, E, f, router_std=0.3, dtype=np.float32):
    return {
        "router": (rng.standard_normal((d, E)) * router_std).astype(dtype),
        "w_gate": (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(dtype),
        "w_up": (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(dtype),
        "w_down": (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(dtype),
    }


def test_top_k_breaks_ties_as_lax_top_k():
    planted = np.array([[.1, .3, .3, .2, .3, .05]], np.float32)
    rows = (np.random.default_rng(0).integers(0, 4, (64, 16)) / 4) \
        .astype(np.float32)                       # ties in every row
    for probs, k in ((planted, 3), (rows, 5), (rows, 16)):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = t_moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert t_moe.top_k(torch.from_numpy(planted), 3)[1].tolist() == \
        [[1, 2, 4]]


ROUTER_CASES = {  # T, d, E, k, capacity factor, tied router columns
    "deepseek widths, bf16, planted ties": (96, 64, 64, 6, 1.25,
                                            ((5, 9), (20, 21), (40, 2))),
    "drops": (64, 32, 8, 2, 0.5, ()),
    "arctic widths, bf16, planted ties": (40, 64, 128, 2, 1.25,
                                          ((7, 100), (64, 65))),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_integers_match_reference(case):
    """bf16 operands, as ``moe_block`` gives them (the reference casts the
    router to bf16); tied router columns give exactly tied logits."""
    T, d, E, k, factor, ties = ROUTER_CASES[case]
    rng = np.random.default_rng(T + E)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, E)) * 0.02).astype(np.float32)
    for a, b in ties:       # large enough to be picked often
        w[:, a] *= 5
        w[:, b] = w[:, a]
    tb = lambda a: torch.from_numpy(a).bfloat16()
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    t_cfg, r_cfg = _moe(n_experts=E, top_k=k, capacity_factor=factor)
    gate_r, experts_r, _ = r_moe._route(jb(x), jb(w), r_cfg, None)
    gate_t, experts_t, _, _ = t_moe._route(tb(x), tb(w), t_cfg)
    C = r_moe._capacity(T, k, E, factor)
    assert t_moe._capacity(T, k, E, factor) == C
    pos_r, counts_r = r_moe._positions(experts_r.reshape(-1), E)
    pos_t, counts_t = t_moe._positions(experts_t.reshape(-1), E)
    slots = t_moe._slots(experts_t, E, C)
    np.testing.assert_array_equal(experts_t.numpy(), np.asarray(experts_r))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_r))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_r))
    np.testing.assert_array_equal(slots.keep.numpy(),
                                  np.asarray(pos_r) < C)
    _close(gate_t, gate_r, MOD_TOL)
    if ties:     # exact ties among the first k + 1 ranks: order matters
        probs, _ = t_moe.router_probs(tb(x), tb(w))
        top = torch.sort(probs, dim=-1, descending=True).values[:, :k + 1]
        assert int((top[:, 1:] == top[:, :-1]).any(1).sum()) >= 3
    if factor < 1:
        assert not slots.keep.all()


@pytest.mark.parametrize("n_tokens,top_k,n_experts,factor", [
    (1, 1, 1, 1.0), (4, 6, 64, 1.25), (2224, 6, 64, 1.25), (37, 2, 8, 0.5),
    (4, 2, 128, 1.25), (4512, 2, 128, 1.25), (100, 6, 64, 64 / 6)])
def test_capacity_matches_reference(n_tokens, top_k, n_experts, factor):
    assert t_moe._capacity(n_tokens, top_k, n_experts, factor) == \
        r_moe._capacity(n_tokens, top_k, n_experts, factor)


@pytest.mark.parametrize("factor,capacity,jitter", [
    (1.25, None, 0.0), (0.5, None, 0.0), (1.25, 64, 0.0), (1.25, None, 0.1)])
def test_moe_layer_local_matches_reference(factor, capacity, jitter):
    T, d, E, k, f = 48, 12, 8, 2, 16
    rng = np.random.default_rng(int(factor * 10) + (capacity or 0))
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = _weights(rng, d, E, f)
    t_cfg, r_cfg = _moe(n_experts=E, top_k=k, expert_ff=f,
                        capacity_factor=factor, router_jitter=jitter)
    key = jax.random.PRNGKey(7) if jitter else None
    y_r, st_r = r_moe.moe_layer_local(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in w.items()}, r_cfg,
        key=key, capacity=capacity)
    noise = None
    if jitter:      # the reference's own draw, injected
        noise = torch.tensor(np.asarray(jax.random.uniform(
            key, (T, E), minval=-jitter, maxval=jitter)))
    y_t, st_t = t_moe.moe_layer_local(
        torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in w.items()},
        t_cfg, noise=noise, capacity=capacity)
    _close(y_t, y_r, MOD_TOL)
    for name in ("aux_loss", "router_z", "dropped"):
        _close(getattr(st_t, name), getattr(st_r, name), MOD_TOL)
    if factor < 1:
        assert float(st_t.dropped) > 0


BUCKET_T, BUCKET_D, BUCKET_E, BUCKET_F, BUCKET_EP = 128, 12, 16, 16, 8
BUCKET_CASES = (None, 64)       # default capacity (drops) and ample


@pytest.fixture(scope="module")
def bucket_ref(tmp_path_factory):
    """The reference's ``moe_layer_bucket`` inside ``shard_map`` over 8
    fake devices (EP 8), both capacities, in one subprocess."""
    path = tmp_path_factory.mktemp("moe") / "bucket.npz"
    run_md(f"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs.base import MoEConfig
from repro.models import moe as M
T, d, E, f = {BUCKET_T}, {BUCKET_D}, {BUCKET_E}, {BUCKET_F}
mesh = jax.make_mesh(({BUCKET_EP},), ("model",))
moe = MoEConfig(n_experts=E, top_k=2, expert_ff=f, capacity_factor=1.25)
rng = np.random.default_rng(3)
w = {{"router": rng.standard_normal((d, E)) * 0.3,
      "w_gate": rng.standard_normal((E, d, f)) / np.sqrt(d),
      "w_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
      "w_down": rng.standard_normal((E, f, d)) / np.sqrt(f)}}
w = {{k: v.astype(np.float32) for k, v in w.items()}}
x = rng.standard_normal((T, d)).astype(np.float32)
out = dict(x=x, **w)
for cap in {BUCKET_CASES}:
    def body(xl, router, wg, wu, wd):
        y, st = M.moe_layer_bucket(
            xl, {{"router": router, "w_gate": wg, "w_up": wu,
                 "w_down": wd}}, moe, axis="model", capacity=cap)
        return y, st.aux_loss[None], st.router_z[None], st.dropped[None]
    fn = shard_map(body, mesh=mesh,
                   in_specs=(P("model", None), P(), P("model", None, None),
                             P("model", None, None), P("model", None, None)),
                   out_specs=(P("model", None), P("model"), P("model"),
                              P("model")), check_rep=False)
    res = fn(jnp.asarray(x), *(jnp.asarray(w[k]) for k in
             ("router", "w_gate", "w_up", "w_down")))
    for name, a in zip(("y", "aux_loss", "router_z", "dropped"), res):
        out[f"{{name}}_{{cap}}"] = np.asarray(a)
np.savez({str(path)!r}, **out)
""")
    return dict(np.load(path))


@pytest.mark.parametrize("capacity", BUCKET_CASES)
def test_moe_layer_bucket_matches_reference(bucket_ref, capacity):
    ref = bucket_ref
    ep, E = BUCKET_EP, BUCKET_E
    t_cfg = MoEConfig(n_experts=E, top_k=2, expert_ff=BUCKET_F,
                      capacity_factor=1.25)
    ranked = lambda a: torch.from_numpy(a).reshape(ep, E // ep, *a.shape[1:])
    params = {"router": torch.from_numpy(ref["router"]),
              **{n: ranked(ref[n]) for n in ("w_gate", "w_up", "w_down")}}
    x = torch.from_numpy(ref["x"]).reshape(ep, BUCKET_T // ep, BUCKET_D)
    y, stats = t_moe.moe_layer_bucket(x, params, t_cfg, capacity=capacity)
    _close(y.reshape(BUCKET_T, BUCKET_D), ref[f"y_{capacity}"], MOD_TOL)
    for name in ("aux_loss", "router_z", "dropped"):
        _close(getattr(stats, name), ref[f"{name}_{capacity}"], MOD_TOL)
    if capacity is None:
        assert float(stats.dropped.max()) > 0     # the capacity binds
    else:   # nothing dropped: the bucketed exchange is the local layer
        assert float(stats.dropped.max()) == 0
        flat = {n: torch.from_numpy(ref[n]) for n in
                ("router", "w_gate", "w_up", "w_down")}
        y_loc, _ = t_moe.moe_layer_local(x.reshape(BUCKET_T, BUCKET_D),
                                         flat, t_cfg, capacity=BUCKET_T)
        _close(y.reshape(BUCKET_T, BUCKET_D), y_loc, MOD_TOL)


def test_moe_layer_bucket_refuses_a_wrong_expert_split():
    t_cfg = MoEConfig(n_experts=8, top_k=2, expert_ff=4)
    w = {n: torch.zeros(3, 2, 4, 4) for n in ("w_gate", "w_up", "w_down")}
    with pytest.raises(ValueError, match="3 ranks x 2 local experts"):
        t_moe.moe_layer_bucket(torch.zeros(3, 4, 4),
                               {"router": torch.zeros(4, 8), **w}, t_cfg)


@pytest.fixture(scope="module")
def refs():
    return {arch: reference_reduced(arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_moe_matches_reference(refs, arch):
    ref = refs[arch]
    model = build(reduced(get_config(arch)))
    caches = assert_port_matches_reduced(ref, model)
    cfg = model.cfg
    # deepseek: a dense stack and its caches before the MoE stack
    assert sorted(caches) == (["blocks", "dense"] if cfg.moe.first_dense
                              else ["blocks"])
    assert ref["aux"] > 0


def test_moe_block_reports_drops():
    """``moe_block`` returns the layer's stats: at the published capacity
    factor the reduced deepseek drops assignments of a long batch; at a
    factor of E / k nothing can be dropped."""
    from repro_torch.models import transformer as t_tr
    cfg = reduced(get_config("deepseek_moe_16b"))
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    p = t_tr._layer(params["blocks"], 0)
    x = torch.randn(2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    tight = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    ample = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    assert float(t_tr.moe_block(p, x, tight)[1].dropped) > 0
    assert float(t_tr.moe_block(p, x, ample)[1].dropped) == 0


@pytest.mark.parametrize("arch", ("deepseek-moe-16b", "arctic-480b"))
def test_serve_cli_runs_reduced_moe_on_cpu(capsys, arch):
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new",
                       "3"]) == 0
    text = capsys.readouterr().out
    assert text.count("req ") == 3 and text.count("wave ") == 2
