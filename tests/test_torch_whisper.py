"""Port vs reference for Whisper (the encoder-decoder), on the CPU:

* modules at rtol/atol 2e-4 in f32: ``layer_norm``, the GELU ``mlp`` with
  and without biases; ``sinusoidal_positions`` at 1e-6 (both compute it
  in float64 with numpy);
* on reduced whisper-large-v3 (2 + 2 layers, 24 frames) with
  ``_stable_init`` weights, at 5e-2 (``tests/test_models.py:101``; the
  blocks compute in bf16): ``encode``, and ``fill_cross_cache`` on the
  reference's own encoder output; the full forward, prefill (both caches,
  every field) and one decode step;
* the engine at 1 slot with each request's own (1, enc_ctx, d_model)
  ``enc_frames``, as the reference's launcher makes them: greedy tokens
  equal the reference engine's where its top-2 margin exceeds 5e-2; at 2
  slots the port raises ``ValueError`` where the reference raises
  ``TypeError`` (ROADMAP queue 3);
* ``python -m repro_torch.launch.serve --arch whisper-large-v3 --reduced
  --device cpu --slots 1``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as r_encdec, layers as r_layers
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import build, encdec as t_encdec, layers as t_layers
from repro_torch.serve.engine import Engine, Request, ServeConfig
from test_torch_models import (MAX_NEW, TOL, _close, _np32,
                               assert_greedy_matches,
                               assert_port_matches_reduced, reference_engine,
                               reference_reduced)

ARCH = "whisper_large_v3"
MOD_TOL = 2e-4
PROMPTS = (5, 9, 11)


def audio_extras(cfg, rng, B, S) -> dict:
    return {"enc_frames": rng.standard_normal(
        (B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("scale", (3.0, 1e-3))
def test_layer_norm_matches_reference(scale):
    rng = np.random.default_rng(int(scale * 10))
    x = rng.standard_normal((3, 5, 32), dtype=np.float32) * scale + 0.5
    w = rng.standard_normal(32, dtype=np.float32)
    b = rng.standard_normal(32, dtype=np.float32)
    want = r_layers.layer_norm(*map(jnp.asarray, (x, w, b)))
    got = t_layers.layer_norm(*map(torch.from_numpy, (x, w, b)))
    _close(got, want, MOD_TOL)


@pytest.mark.parametrize("biases", (True, False))
def test_mlp_matches_reference(biases):
    rng = np.random.default_rng(int(biases))
    x = rng.standard_normal((2, 7, 16), dtype=np.float32)
    w1 = rng.standard_normal((16, 40), dtype=np.float32) * 0.3
    w2 = rng.standard_normal((40, 16), dtype=np.float32) * 0.3
    b1 = rng.standard_normal(40, dtype=np.float32) if biases else None
    b2 = rng.standard_normal(16, dtype=np.float32) if biases else None
    conv = lambda f, a: None if a is None else f(a)
    want = r_layers.mlp(*(conv(jnp.asarray, a) for a in (x, w1, w2, b1, b2)))
    got = t_layers.mlp(*(conv(torch.from_numpy, a)
                         for a in (x, w1, w2, b1, b2)))
    _close(got, want, MOD_TOL)


@pytest.mark.parametrize("n,d", [(1500, 1280), (24, 64), (3, 2)])
def test_sinusoidal_positions_match_reference(n, d):
    got = t_layers.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    _close(got, r_layers.sinusoidal_positions(n, d), 1e-6)


@pytest.fixture(scope="module")
def ref():
    return reference_reduced(ARCH, audio_extras)


def test_encode_and_fill_cross_cache_match_reference(ref):
    cfg = reduced(get_config(ARCH))
    r_params = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    params = convert.params_from_reference(ref["params"], device="cpu")
    frames = ref["extras"]["enc_frames"]
    enc_r = r_encdec.encode(r_params, jnp.asarray(frames), ref["cfg"])
    enc_t = t_encdec.encode(params, torch.from_numpy(frames), cfg)
    assert enc_t.dtype == torch.bfloat16 and enc_t.shape == (2, 24, 64)
    _close(enc_t.float(), _np32(enc_r), TOL)
    r_c = r_encdec.fill_cross_cache(
        r_params, enc_r, r_encdec.whisper_init_caches(ref["cfg"], 2, 16),
        ref["cfg"])
    t_c = t_encdec.fill_cross_cache(
        params, convert._t(np.asarray(enc_r), torch.device("cpu")),
        t_encdec.whisper_init_caches(cfg, 2, 16, device="cpu"), cfg)
    for name in ("k", "v"):
        _close(getattr(t_c.cross_kv, name).float(),
               _np32(getattr(r_c.cross_kv, name)), TOL)
    np.testing.assert_array_equal(t_c.cross_kv.length.numpy(), [24, 24])
    assert t_c.self_kv.k.shape == (2, 2, 16, 4, 16)


def test_reduced_whisper_matches_reference(ref):
    model = build(reduced(get_config(ARCH)))
    caches = assert_port_matches_reduced(ref, model)
    assert isinstance(caches, t_encdec.WhisperCaches)


def _requests(cls, cfg):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                extras=audio_extras(cfg, rng, 1, n))
            for i, n in enumerate(PROMPTS)]


def test_engine_greedy_at_one_slot_matches_reference(ref):
    cfg = reduced(get_config(ARCH))
    want, margins = reference_engine(
        ref, _requests(RRequest, cfg),
        RServeConfig(slots=1, max_len=64, max_new_tokens=MAX_NEW))
    eng = Engine(build(cfg), ServeConfig(slots=1, max_len=64,
                                         max_new_tokens=MAX_NEW))
    out = eng.generate_batch(
        convert.params_from_reference(ref["params"], device="cpu"),
        _requests(Request, cfg))
    assert_greedy_matches(out, want, margins, len(PROMPTS) * 2)


def test_two_slots_refuse_one_request_frames(ref):
    """The reference's launcher gives each request (1, enc_ctx, d) frames;
    in a 2-slot wave the last request's win the merge, and the reference's
    model fails on them.  The port names the shapes."""
    cfg = reduced(get_config(ARCH))
    model = build(cfg)
    params = convert.params_from_reference(ref["params"], device="cpu")
    eng = Engine(model, ServeConfig(slots=2, max_len=64, max_new_tokens=2))
    with pytest.raises(ValueError, match=r"'enc_frames' of shape "
                       r"\(1, 24, 64\) has no batch axis 0 of the wave's 2"):
        eng.generate_batch(params, _requests(Request, cfg)[:2])
    r_eng_model = __import__("repro.models", fromlist=["build"]).build(
        ref["cfg"])
    from repro.serve.engine import Engine as REngine
    r_eng = REngine(r_eng_model, RServeConfig(slots=2, max_len=64,
                                              max_new_tokens=2))
    with pytest.raises(TypeError, match="cannot reshape"):
        r_eng.generate_batch(jax.tree_util.tree_map(jnp.asarray,
                                                    ref["params"]),
                             _requests(RRequest, cfg)[:2])


def test_serve_cli_runs_reduced_whisper_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "whisper-large-v3", "--reduced", "--device",
                       "cpu", "--requests", "3", "--slots", "1",
                       "--max-new", "3"]) == 0
    text = capsys.readouterr().out
    assert text.count("req ") == 3 and text.count("wave ") == 3
