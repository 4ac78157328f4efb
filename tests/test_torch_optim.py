"""The training path's optimizer, schedules, data pipeline and
checkpointer, port vs reference, on the CPU:

* the reference's own optimizer cases (``tests/test_train.py:28-97``) run
  through the port;
* ``learning_rate`` of all three kinds at steps 0 .. total + 5 against the
  reference at rtol 1e-6 (both compute in f32);
* ``adamw_update`` and ``adafactor_update`` for 5 steps on a tree with
  stacked ``(L, d)`` norm leaves, a stacked matrix, 1-D and 4-D leaves,
  each step fed the reference's gradients and the reference's state of the
  step before: params, moments and count at rtol 1e-6 (atol 1e-6 of the
  leaf's scale), the bf16 momentum within one bf16 ulp; weight decay on the
  stacked ``(L, d)`` leaves and not on 1-D ones;
* ``synthetic_batch`` bit for bit against the reference over several seeds
  and steps; the prefetcher's order, credits and close;
* the checkpointer: round trip, retention, ``.tmp`` directories ignored,
  NamedTuple states, a bf16 leaf restored bit for bit; and across the
  packages: the reference's checkpoint restored by the port (its bf16
  leaf included), the port's restored by the reference (f32 and int32
  leaves), the same manifest and the same file bytes.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.data import pipeline as r_pipeline
from repro.train import optimizer as r_opt
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, RingPrefetcher
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.train import optimizer as opt

RTOL = 1e-6
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the reference's optimizer cases, through the port
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_math():
    cfg = opt.OptimizerConfig(
        b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, clip_norm=1e9,
        schedule=opt.ScheduleConfig(kind="constant", peak_lr=0.1,
                                    warmup_steps=0))
    p = {"w": torch.tensor([[1.0, 2.0]])}
    g = {"w": torch.tensor([[0.5, -0.5]])}
    st = opt.adamw_init(p)
    newp, st, _ = opt.adamw_update(g, st, p, cfg)
    m = 0.1 * 0.5
    v = 0.01 * 0.25
    mh, vh = m / 0.1, v / 0.01
    want = 1.0 - 0.1 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(float(newp["w"][0, 0]), want, rtol=1e-5)


def test_adamw_converges_quadratic():
    cfg = opt.OptimizerConfig(
        weight_decay=0.0, clip_norm=10.0,
        schedule=opt.ScheduleConfig(kind="constant", peak_lr=0.05,
                                    warmup_steps=0))
    p = {"w": torch.tensor([3.0, -2.0])}
    st = opt.adamw_init(p)
    for _ in range(300):
        g = {"w": 2 * p["w"]}
        p, st, _ = opt.adamw_update(g, st, p, cfg)
    assert float(p["w"].abs().max()) < 1e-2


def test_adafactor_converges_quadratic():
    cfg = opt.OptimizerConfig(
        kind="adafactor", weight_decay=0.0, clip_norm=10.0,
        schedule=opt.ScheduleConfig(kind="constant", peak_lr=0.05,
                                    warmup_steps=0))
    p = {"w": torch.ones((4, 3)) * 2.0}
    st = opt.adafactor_init(p, cfg)
    for _ in range(300):
        g = {"w": 2 * p["w"]}
        p, st, _ = opt.adafactor_update(g, st, p, cfg)
    assert float(p["w"].abs().max()) < 5e-2


def test_adafactor_memory_is_factored():
    cfg = opt.OptimizerConfig(kind="adafactor", momentum_dtype="bfloat16")
    p = {"w": torch.zeros((128, 64))}
    st = opt.adafactor_init(p, cfg)
    assert st.vr["w"].shape == (128,)
    assert st.vc["w"].shape == (64,)
    assert st.m["w"].dtype == torch.bfloat16


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0])}        # norm 5
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], rtol=1e-5)


def test_schedules():
    wsd = opt.ScheduleConfig(kind="wsd", peak_lr=1.0, warmup_steps=10,
                             total_steps=100, decay_frac=0.2, min_ratio=0.1)
    assert float(opt.learning_rate(wsd, 0)) == 0.0
    assert abs(float(opt.learning_rate(wsd, 10)) - 1.0) < 1e-6
    assert abs(float(opt.learning_rate(wsd, 50)) - 1.0) < 1e-6   # stable
    assert float(opt.learning_rate(wsd, 99)) < 0.2               # decaying
    cos = opt.ScheduleConfig(kind="cosine", peak_lr=1.0, warmup_steps=0,
                             total_steps=100, min_ratio=0.0)
    assert abs(float(opt.learning_rate(cos, 100))) < 1e-6


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

SCHEDULES = [
    dict(kind="constant", peak_lr=3e-3, warmup_steps=7, total_steps=40),
    dict(kind="cosine", peak_lr=1e-3, warmup_steps=5, total_steps=50,
         min_ratio=0.1),
    dict(kind="cosine", peak_lr=2.0, warmup_steps=0, total_steps=30,
         min_ratio=0.0),
    dict(kind="wsd", peak_lr=1e-3, warmup_steps=4, total_steps=40,
         decay_frac=0.2, min_ratio=0.1),
    dict(kind="wsd", peak_lr=1e-3, warmup_steps=1, total_steps=8,
         decay_frac=0.1, min_ratio=0.1),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw["kind"])
def test_learning_rate_matches_reference(kw):
    steps = range(kw["total_steps"] + 6)
    want = [float(r_opt.learning_rate(r_opt.ScheduleConfig(**kw), s))
            for s in steps]
    cfg = opt.ScheduleConfig(**kw)
    got = [float(opt.learning_rate(cfg, s)) for s in steps]
    # a device tensor step (the optimizer's count) gives the same values
    got_t = [float(opt.learning_rate(cfg, torch.tensor(s, dtype=torch.int32)))
             for s in steps]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert got_t == got
    assert all(np.float32(x) == x for x in got)          # computed in f32


def _tree(rng) -> dict:
    """A parameter tree of every rank the optimizer tells apart: stacked
    norm weights (L, d), a stacked matrix, a 1-D final norm and a 4-D
    expert stack."""
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {"blocks": {"ln": 1.0 + 0.1 * f(3, 8), "w": 0.3 * f(3, 8, 5)},
            "final_norm": 1.0 + 0.1 * f(8),
            "experts": 0.2 * f(2, 4, 6, 3)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_tree_close(got[k], want[k], f"{what}/{k}")
        return
    w = np.asarray(want)
    if w.dtype == ml_dtypes.bfloat16:
        assert got.dtype == torch.bfloat16, what
        g = got.float().numpy()
        w = w.astype(np.float32)
        # one bf16 ulp at w's magnitude: 2^(exponent - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-38))) - 7)
        assert (np.abs(g - w) <= ulp).all(), what
        return
    g = got.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, what
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


OPT_CASES = [
    dict(kind="adamw"),
    dict(kind="adamw", b2=0.99, weight_decay=0.3, clip_norm=0.5),
    dict(kind="adafactor"),
    dict(kind="adafactor", momentum_dtype="bfloat16", clip_norm=0.5),
]


@pytest.mark.parametrize("kw", OPT_CASES,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_optimizer_steps_match_reference(kw):
    """Five steps, each from the reference's state of the step before, on
    the reference's gradients (scaled up on steps 2 and 4 so that the clip
    binds)."""
    sched = dict(kind="wsd", peak_lr=1e-2, warmup_steps=2, total_steps=6,
                 decay_frac=0.5, min_ratio=0.1)
    r_cfg = r_opt.OptimizerConfig(schedule=r_opt.ScheduleConfig(**sched),
                                  **kw)
    cfg = opt.OptimizerConfig(schedule=opt.ScheduleConfig(**sched), **kw)
    rng = np.random.default_rng(len(str(kw)))
    r_params = jax.tree_util.tree_map(jnp.asarray, _tree(rng))
    r_state = r_opt.init_opt(r_params, r_cfg)
    init = opt.init_opt(convert.params_from_reference(_np_tree(r_params),
                                                      device="cpu"), cfg)
    want_init = _np_tree(r_state)
    for f in type(init)._fields:
        _assert_tree_close(getattr(init, f), getattr(want_init, f), f)
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape)
                                  .astype(np.float32) * (3.0 ** (step % 2))),
            r_params)
        port = convert.train_state_from_reference(
            {"params": _np_tree(r_params), "opt": _np_tree(r_state),
             "step": np.int32(step)}, device="cpu")
        p_grads = convert.params_from_reference(_np_tree(grads),
                                                device="cpu")
        r_params, r_state, r_m = r_opt.apply_opt(grads, r_state, r_params,
                                                 r_cfg)
        params, state, m = opt.apply_opt(p_grads, port["opt"],
                                         port["params"], cfg)
        assert params is port["params"]                 # in place
        _assert_tree_close(params, _np_tree(r_params), f"params {step}")
        for f in type(state)._fields:
            _assert_tree_close(getattr(state, f),
                               getattr(_np_tree(r_state), f),
                               f"{f} {step}")
        assert int(state.count) == int(r_state.count) == step + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(r_m[k]),
                                       rtol=RTOL, err_msg=k)


def test_weight_decay_follows_the_stacked_rank():
    """Zero gradients: every leaf of rank >= 2 (the stacked (L, d) norm
    weights included) shrinks by lr * wd; the 1-D leaf stays."""
    cfg = opt.OptimizerConfig(weight_decay=0.5, schedule=opt.ScheduleConfig(
        kind="constant", peak_lr=0.1, warmup_steps=0))
    params = convert.params_from_reference(
        _tree(np.random.default_rng(0)), device="cpu")
    before = jax.tree_util.tree_map(lambda x: x.clone(), params)
    grads = jax.tree_util.tree_map(torch.zeros_like, params)
    opt.adamw_update(grads, opt.adamw_init(params), params, cfg)
    assert torch.equal(params["final_norm"], before["final_norm"])
    for p, b in ((params["blocks"]["ln"], before["blocks"]["ln"]),
                 (params["blocks"]["w"], before["blocks"]["w"]),
                 (params["experts"], before["experts"])):
        torch.testing.assert_close(p, b * (1 - 0.1 * 0.5), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (1234, 100, 16, 2), (0, 50280, 64, 3), (7, 122753, 33, 1),
    (2**31, 1024, 8, 4)])
def test_synthetic_batch_matches_reference(seed, vocab, seq, batch):
    r_dc = r_pipeline.DataConfig(vocab=vocab, seq_len=seq,
                                 global_batch=batch, seed=seed)
    dc = DataConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    for step in (0, 1, 7, 12345):
        want = r_pipeline.synthetic_batch(r_dc, step)
        got = synthetic_batch(dc, step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32 and got[k].device == CPU
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


@pytest.mark.timeout(60)
def test_prefetcher_order_credits_and_close():
    dc = DataConfig(vocab=100, seq_len=8, global_batch=2, ring_slots=2)
    pf = RingPrefetcher(dc, start_step=5)
    try:
        got = [pf.next() for _ in range(6)]
        assert [s for s, _ in got] == [5, 6, 7, 8, 9, 10]
        for s, b in got:
            assert torch.equal(b["tokens"], synthetic_batch(dc, s)["tokens"])
        st = pf.stats()
        assert st["consumed"] == 6
        assert st["in_flight"] <= 2               # credit bound respected
        assert st["produced"] >= 6
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    assert pf.ring.qsize() <= 1


# ---------------------------------------------------------------------------
# checkpointer
# ---------------------------------------------------------------------------

def _state(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    p = {"a": torch.randn(3, 4, generator=g),
         "b": {"c": torch.arange(5, dtype=torch.int32)}}
    return {"params": p,
            "opt": opt.AdamWState(
                m={"a": torch.randn(3, 4, generator=g),
                   "b": {"c": torch.zeros(5)}},
                v={"a": torch.rand(3, 4, generator=g),
                   "b": {"c": torch.ones(5)}},
                count=torch.tensor(7, dtype=torch.int32)),
            "bf": torch.randn(6, 2, generator=g).to(torch.bfloat16),
            "pair": (torch.tensor(1.5), torch.tensor([2, 3])),
            "step": torch.tensor(11, dtype=torch.int32)}


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, tuple):
        for a, b in zip(got, want, strict=True):
            _assert_same(a, b)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_checkpoint_round_trip_and_template(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(11, state)
    assert ck.latest_step() == 11
    template = jax.tree_util.tree_map(
        lambda x: torch.empty_like(x, device="meta"), state)
    got = ck.restore(template, device="cpu")
    _assert_same(got, state)
    assert isinstance(got["opt"], opt.AdamWState)
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"].view(torch.int16),
                       state["bf"].view(torch.int16))   # bit for bit


def test_checkpoint_retention_and_tmp_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s))
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]
    os.makedirs(tmp_path / "step_0000000009.tmp")       # a crashed write
    assert ck.latest_step() == 4
    _assert_same(ck.restore(_state(), device="cpu"), _state(4))
    _assert_same(ck.restore(_state(), 3, device="cpu"), _state(3))
    assert Checkpointer(str(tmp_path / "empty")).restore(
        _state(), device="cpu") is None


def test_checkpoint_restore_without_device_needs_a_card(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore(_state())


def _ref_state(rng):
    """A reference train state: f32 params and AdamW moments, int32 count
    and step, an int32 leaf, and a bf16 Adafactor momentum."""
    params = {"w": rng.standard_normal((2, 3, 4)).astype(np.float32),
              "ln": rng.standard_normal((2, 3)).astype(np.float32),
              "ids": np.arange(6, dtype=np.int32)}
    return {"params": params,
            "opt": r_opt.AdamWState(
                m=jax.tree_util.tree_map(lambda x: x * 0.5, params),
                v=jax.tree_util.tree_map(np.abs, params),
                count=np.int32(3)),
            "step": np.int32(3)}


def _manifest(path: str, step: int) -> dict:
    with open(os.path.join(path, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(3)
    state = _ref_state(rng)
    bf = rng.standard_normal((4, 5)).astype(ml_dtypes.bfloat16)
    RCheckpointer(str(tmp_path)).save(3, {**state, "mom": bf})
    template = {**convert.train_state_from_reference(state, device="cpu"),
                "mom": torch.empty((4, 5), dtype=torch.bfloat16)}
    got = Checkpointer(str(tmp_path)).restore(template, device="cpu")
    want = convert.train_state_from_reference(state, device="cpu")
    _assert_same({k: got[k] for k in want}, want)
    assert got["mom"].dtype == torch.bfloat16
    assert np.array_equal(got["mom"].view(torch.int16).numpy(),
                          bf.view(np.int16))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """f32 and int32 leaves through the reference's restore; the manifest
    and every file equal the reference's own save of the same state (the
    bf16 leaf's too)."""
    rng = np.random.default_rng(4)
    state = _ref_state(rng)
    bf = rng.standard_normal((4, 5)).astype(ml_dtypes.bfloat16)
    port_state = {**convert.train_state_from_reference(state, device="cpu"),
                  "mom": convert._t(bf, CPU)}
    Checkpointer(str(tmp_path / "port")).save(3, port_state)
    RCheckpointer(str(tmp_path / "ref")).save(3, {**state, "mom": bf})
    assert _manifest(str(tmp_path / "port"), 3) == \
        _manifest(str(tmp_path / "ref"), 3)
    for name in os.listdir(tmp_path / "ref" / "step_0000000003"):
        a = (tmp_path / "ref" / "step_0000000003" / name).read_bytes()
        b = (tmp_path / "port" / "step_0000000003" / name).read_bytes()
        assert a == b or name == "manifest.json", name
    got = RCheckpointer(str(tmp_path / "port")).restore(state)
    _, want_def = jax.tree_util.tree_flatten(state)
    assert jax.tree_util.tree_structure(got) == want_def
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(state)):
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)
