"""Port vs reference for RecurrentGemma (the RG-LRU and the hybrid
stack on ring KV caches), on the CPU:

* modules at rtol/atol 2e-4 in f32: ``rglru_scan`` with and without an
  initial state (the port's doubling scan sums in another order than
  XLA's ``associative_scan``), ``rglru_step``, and ``recurrent_block``
  as a prefill and then one step at a time against its cache;
* reduced recurrentgemma-9b (4 layers: one (rglru, rglru, attention)
  super-block and a recurrent tail; window 16), with ``_stable_init``
  weights: the full forward, prefill (every cache field) and one decode
  step at 5e-2 (``tests/test_models.py:101``), for a prompt inside the
  window and one longer than it;
* two behaviours of the reference that the port reproduces (ROADMAP
  queue 3): a cached prefill longer than the window leaves the full
  forward (the ring keeps the trailing window, but attention reads its
  slots as positions 0..T-1); and until the ring is full a decode step
  also attends to its unwritten (zero) slots;
* ``python -m repro_torch.launch.serve --arch recurrentgemma-9b --reduced
  --device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config, reduced as r_reduced
from repro.models import rglru as r_rglru
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import build, rglru as t_rglru
from test_torch_models import (TOL, _close, _np32,
                               assert_port_matches_reduced,
                               reference_reduced)

ARCH = "recurrentgemma_9b"
MOD_TOL = 2e-4
W = 24


def _gate_params(rng, w=W):
    return {"w_a": rng.standard_normal((w, w)) * 0.2,
            "w_x": rng.standard_normal((w, w)) * 0.2,
            "b_a": rng.standard_normal(w) * 0.1,
            "b_x": rng.standard_normal(w) * 0.1,
            "lam": rng.standard_normal(w) * 0.5}


def _both(tree):
    tree = {k: np.asarray(v, np.float32) for k, v in tree.items()}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


@pytest.mark.parametrize("L,with_h0", [(1, False), (37, False), (64, True),
                                       (5, True)])
def test_rglru_scan_matches_reference(L, with_h0):
    rng = np.random.default_rng(L)
    r_p, t_p = _both(_gate_params(rng))
    x = rng.standard_normal((2, L, W)).astype(np.float32)
    h0 = rng.standard_normal((2, W)).astype(np.float32) if with_h0 else None
    y_r, h_r = jax.jit(r_rglru.rglru_scan)(
        r_p, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    y_t, h_t = t_rglru.rglru_scan(t_p, torch.from_numpy(x),
                                  None if h0 is None else torch.from_numpy(h0))
    assert h_t.dtype == torch.float32 and y_t.shape == (2, L, W)
    _close(y_t, y_r, MOD_TOL)
    _close(h_t, h_r, MOD_TOL)


def test_rglru_step_matches_reference():
    rng = np.random.default_rng(3)
    r_p, t_p = _both(_gate_params(rng))
    x = rng.standard_normal((3, W)).astype(np.float32)
    h = rng.standard_normal((3, W)).astype(np.float32)
    y_r, h_r = r_rglru.rglru_step(r_p, jnp.asarray(x), jnp.asarray(h))
    y_t, h_t = t_rglru.rglru_step(t_p, torch.from_numpy(x),
                                  torch.from_numpy(h))
    _close(y_t, y_r, MOD_TOL)
    _close(h_t, h_r, MOD_TOL)


def test_recurrent_block_prefill_then_steps_matches_reference():
    r_cfg = r_reduced(r_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    d, w, k = cfg.d_model, cfg.recurrent.lru_width, cfg.recurrent.conv_width
    rng = np.random.default_rng(4)
    p = _gate_params(rng, w)
    p.update(w_in=rng.standard_normal((d, w)) / np.sqrt(d),
             w_gate=rng.standard_normal((d, w)) / np.sqrt(d),
             w_out=rng.standard_normal((w, d)) / np.sqrt(w),
             conv_w=rng.standard_normal((k, w)) * 0.3,
             conv_b=rng.standard_normal(w) * 0.1)
    r_p, t_p = _both(p)
    x = rng.standard_normal((2, 13, d)).astype(np.float32)
    r_cache = r_rglru.RGLRUCache(jnp.zeros((2, k - 1, w)), jnp.zeros((2, w)))
    t_cache = t_rglru.RGLRUCache(torch.zeros(2, k - 1, w),
                                 torch.zeros(2, w))
    block = jax.jit(r_rglru.recurrent_block, static_argnums=2)
    for lo, hi in ((0, 9), (9, 10), (10, 11), (11, 13)):
        o_r, r_cache = block(r_p, jnp.asarray(x[:, lo:hi]), r_cfg, r_cache)
        o_t, t_cache = t_rglru.recurrent_block(t_p, torch.from_numpy(
            x[:, lo:hi]), cfg, t_cache)
        _close(o_t, o_r, MOD_TOL)
        _close(t_cache.conv, r_cache.conv, MOD_TOL)
        _close(t_cache.h, r_cache.h, MOD_TOL)
    o_r, _ = block(r_p, jnp.asarray(x), r_cfg)
    o_t, t_none = t_rglru.recurrent_block(t_p, torch.from_numpy(x), cfg)
    assert t_none is None
    _close(o_t, o_r, MOD_TOL)


@pytest.fixture(scope="module")
def refs():
    """S 10 inside the window of 16, S 24 past it."""
    return {S: reference_reduced(ARCH, S=S) for S in (10, 24)}


@pytest.mark.parametrize("S", (10, 24))
def test_reduced_recurrentgemma_matches_reference(refs, S):
    model = build(reduced(get_config(ARCH)))
    caches = assert_port_matches_reduced(refs[S], model)
    assert caches.attn.k.shape[2] == model.cfg.sliding_window    # rings
    assert len(caches.tail) == model.cfg.n_layers % 3 == 1
    assert int(caches.attn.length[0]) == S


def test_cached_prefill_past_the_window_is_the_references(refs):
    """Inside the window the cached prefill is the full forward; past it
    it is not (reference caveat, ROADMAP queue 3), and the port follows
    the reference, not the full forward."""
    for S, ref in refs.items():
        gap = np.abs(ref["prefill_h"] - ref["hidden"])
        if S <= 16:
            assert gap.max() == 0.0
        else:   # the ring keeps positions 8..23, read as positions 0..15
            assert gap.max() > 2 * TOL


def test_decode_before_the_ring_fills_matches_reference(refs):
    """Prompt 10, window 16: steps 1-5 attend to unwritten ring slots (the
    reference's ``age < window`` keeps them), step 6 fills the ring and
    step 7 on it wraps; the port's logits equal the reference's at every
    step, and the first step differs from the full forward."""
    ref = refs[10]
    cfg = ref["cfg"]
    r_model = __import__("repro.models", fromlist=["build"]).build(cfg)
    r_params = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    rng = np.random.default_rng(9)
    nxt = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    model = build(reduced(get_config(ARCH)))
    params = convert.params_from_reference(ref["params"], device="cpu")
    r_c = r_model.prefill(r_params, {"tokens": jnp.asarray(ref["tokens"])},
                          r_model.init_caches(2, 0))[1]
    t_c = model.prefill(params, {"tokens": torch.from_numpy(ref["tokens"])},
                        model.init_caches(2, 0, device="cpu"))[1]
    full = np.asarray(r_model.logits(r_params, r_model.hidden(r_params, {
        "tokens": jnp.asarray(np.concatenate([ref["tokens"], nxt], 1))})[0]))
    decode = jax.jit(r_model.decode)
    for i in range(nxt.shape[1]):
        r_l, r_c = decode(r_params, r_c, jnp.asarray(nxt[:, i:i + 1]))
        t_l, t_c = model.decode(params, t_c, torch.from_numpy(
            nxt[:, i:i + 1]))
        _close(t_l, _np32(r_l), TOL)
        if i == 0:      # 5 of 16 slots unwritten: the full forward differs
            assert np.abs(np.asarray(r_l)[:, 0] - full[:, 10]).max() > TOL
    assert int(t_c.attn.length[0]) == 20


def test_serve_cli_runs_reduced_recurrentgemma_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                       "--device", "cpu", "--requests", "3", "--slots", "2",
                       "--max-new", "3"]) == 0
    text = capsys.readouterr().out
    assert text.count("req ") == 3 and text.count("wave ") == 2
