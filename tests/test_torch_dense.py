"""Port vs reference for the dense transformer family, on the CPU:

* modules at rtol/atol 2e-4 in f32: ``apply_rope``, ``act_fn`` (silu,
  gelu, gelu_tanh: the reference's gelu is the tanh approximation),
  ``rms_norm(unit_offset=True)``, ``flash_attention`` (causal, windowed,
  softcapped, GQA, ``kv_len``, a query offset), ``cache_update`` (linear,
  ring, the long prefill ``S >= T``) and ``decode_attention`` (ring and
  windowed, linear);
* the four reduced architectures (qwen3-32b, qwen1.5-4b, gemma2-9b,
  minicpm-2b; 2 layers, d_model 64) with the reference's parameters
  carried across by ``convert.params_from_reference``: the hidden states
  and logits of the full forward, prefill (hidden and caches) and one
  decode step (logits and caches), at the reference's own model tolerance
  5e-2 (``tests/test_models.py:101``);
* ``param_count`` of all ten full configurations equal to the
  reference's, from the specs alone;
* the engine's greedy tokens on reduced gemma2 and qwen3 equal to the
  reference engine's wherever the reference's top-2 logit margin exceeds
  5e-2 (the replay of ``test_torch_models.py``);
* ``python -m repro_torch.launch.serve --arch gemma2-9b --reduced
  --device cpu``.

Reference weights come from ``_stable_init`` (``test_torch_models.py``):
the reference's initializers with keys pinned by a CRC-32 of each path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config, reduced as r_reduced
from repro.models import attention as r_attn
from repro.models import build as r_build, layers as r_layers
from repro.models.modules import param_count as r_param_count
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as t_attn
from repro_torch.models import build, layers as t_layers
from repro_torch.models.modules import param_count
from repro_torch.serve.engine import Engine, Request, ServeConfig
from test_torch_models import (_close, _replay_margins, _stable_init,
                               assert_greedy_matches)

TOL = 5e-2              # the reference's own model tolerance
MOD_TOL = 2e-4          # modules in f32
ARCHS = ("qwen3_32b", "qwen15_4b", "gemma2_9b", "minicpm_2b")
EMBED_SCALE = 0.25      # the blocks, not the tied embedding, pick tokens
PROMPTS = (5, 20, 33)   # 3 requests, 2 slots: waves (5, 20) and (33,)
MAX_NEW = 8


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def test_rope_act_and_unit_offset_norm():
    rng = _rng(0)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32) * 3
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (10000.0, 1_000_000.0):
        _close(t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                   theta),
               r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               MOD_TOL)
    for name in ("silu", "gelu", "gelu_tanh"):
        _close(t_layers.act_fn(name)(torch.from_numpy(x)),
               r_layers.act_fn(name)(jnp.asarray(x)), MOD_TOL)
    w = rng.standard_normal(16, dtype=np.float32) * 0.1
    for off in (False, True):
        _close(t_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                                 1e-6, unit_offset=off),
               r_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                 unit_offset=off), MOD_TOL)
    wg, wu = (rng.standard_normal((16, 24), dtype=np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((24, 16), dtype=np.float32) * 0.2
    _close(t_layers.glu_mlp(*map(torch.from_numpy, (x, wg, wu, wd)),
                            act="gelu_tanh"),
           r_layers.glu_mlp(*map(jnp.asarray, (x, wg, wu, wd)),
                            act="gelu_tanh"), MOD_TOL)


FLASH_CASES = [  # B, Sq, Skv, Hq, Hkv, D, kwargs
    (2, 9, 9, 4, 4, 8, dict()),
    (2, 17, 17, 4, 2, 8, dict(window=5, chunk=4)),
    (1, 12, 12, 8, 2, 16, dict(softcap=50.0, scale=0.3, chunk=5)),
    (2, 6, 20, 4, 1, 8, dict(kv_len=11, chunk=8)),
    (2, 5, 14, 4, 2, 8, dict(q_offset=9, window=6, chunk=3)),
    (1, 10, 10, 2, 2, 4, dict(causal=False, chunk=16)),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    B, Sq, Skv, Hq, Hkv, D, kw = case
    rng = _rng(Sq * Skv)
    q = rng.standard_normal((B, Sq, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32)
    r_kw = dict(kw)
    if "kv_len" in kw:
        r_kw["kv_len"] = jnp.int32(kw["kv_len"])
    want = r_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **r_kw)
    t_kw = dict(kw)
    if "kv_len" in kw:
        t_kw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32)
    got = t_attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **t_kw)
    _close(got, want, MOD_TOL)


def _cache_pair(B, T, Hkv, D, length, seed):
    rng = _rng(seed)
    k = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    r = r_attn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.int32(length))
    t = t_attn.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                       torch.tensor(length, dtype=torch.int32))
    return r, t


@pytest.mark.parametrize("ring,T,length,s", [
    (False, 16, 3, 5), (False, 16, 14, 4),     # the second clamps the start
    (True, 8, 5, 6), (True, 8, 3, 8), (True, 8, 21, 13), (True, 6, 0, 1),
])
def test_cache_update_matches_reference(ring, T, length, s):
    r, t = _cache_pair(2, T, 2, 4, length, T * 31 + length)
    rng = _rng(s)
    kn = rng.standard_normal((2, s, 2, 4), dtype=np.float32)
    vn = rng.standard_normal((2, s, 2, 4), dtype=np.float32)
    want = r_attn.cache_update(r, jnp.asarray(kn), jnp.asarray(vn),
                               ring=ring)
    got = t_attn.cache_update(t, torch.from_numpy(kn), torch.from_numpy(vn),
                              ring=ring)
    for name in ("k", "v", "length"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert torch.equal(t.k, torch.from_numpy(np.array(r.k)))   # untouched


@pytest.mark.parametrize("ring,window,T,length,chunk", [
    (False, 0, 24, 17, 8), (False, 6, 24, 17, 5), (False, 6, 24, 4, 4096),
    (True, 0, 8, 5, 3), (True, 8, 8, 30, 4096), (True, 5, 8, 30, 3),
])
def test_decode_attention_matches_reference(ring, window, T, length, chunk):
    r, t = _cache_pair(2, T, 2, 8, length, T + length + window)
    q = _rng(length).standard_normal((2, 1, 4, 8), dtype=np.float32)
    kw = dict(window=window, softcap=30.0, scale=0.25, ring=ring,
              chunk=chunk)
    want = r_attn.decode_attention(jnp.asarray(q), r, **kw)
    got = t_attn.decode_attention(torch.from_numpy(q), t, **kw)
    _close(got, want, MOD_TOL)


# ---------------------------------------------------------------------------
# The four reduced architectures against the reference
# ---------------------------------------------------------------------------

def _requests(cls, vocab):
    rng = _rng(11)
    return [cls(rid=i, prompt=rng.integers(3, vocab, n).astype(np.int32))
            for i, n in enumerate(PROMPTS)]


def _reference(arch: str, engine: bool):
    cfg = r_reduced(r_get_config(arch))
    model = r_build(cfg)
    params = _stable_init(model.specs(), jax.random.PRNGKey(0))
    params["embed"] = params["embed"] * EMBED_SCALE
    rng = _rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    np_ = lambda t: np.asarray(t.astype(jnp.float32)) \
        if t.dtype == jnp.bfloat16 else np.asarray(t)
    h, _ = model.hidden(params, {"tokens": jnp.asarray(tokens)})
    caches = model.init_caches(2, 40)
    hp, caches = model.prefill(params, {"tokens": jnp.asarray(tokens)},
                               caches)
    logits_d, dcaches = model.decode(params, caches, jnp.asarray(nxt))
    out = dict(
        params=jax.tree_util.tree_map(np.asarray, params), tokens=tokens,
        nxt=nxt, hidden=np_(h), logits=np_(model.logits(params, h)),
        prefill_h=np_(hp),
        caches=jax.tree_util.tree_map(np.asarray, caches),
        decode_logits=np_(logits_d),
        decode_caches=jax.tree_util.tree_map(np_, dcaches))
    if engine:
        scfg = RServeConfig(slots=2, max_len=64, max_new_tokens=MAX_NEW)
        eng = REngine(model, scfg)
        reqs = _requests(RRequest, cfg.vocab)
        out["out"] = eng.generate_batch(params, reqs)
        out["margins"] = _replay_margins(eng, model, params, reqs,
                                         out["out"], scfg)
    return out


@pytest.fixture(scope="module")
def refs():
    """Every reference run of the dense tests, once per module."""
    return {arch: _reference(arch, arch in ("qwen3_32b", "gemma2_9b"))
            for arch in ARCHS}


def _port(ref, arch):
    model = build(reduced(get_config(arch)))
    return model, convert.params_from_reference(ref["params"], device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_hidden_and_logits_match_reference(refs, arch):
    ref = refs[arch]
    model, params = _port(ref, arch)
    h, aux = model.hidden(params, {"tokens": torch.from_numpy(ref["tokens"])})
    assert h.dtype == torch.bfloat16 and float(aux) == 0.0
    _close(_f32(h), ref["hidden"], TOL)
    _close(model.logits(params, h), ref["logits"], TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_and_decode_match_reference(refs, arch):
    ref = refs[arch]
    model, params = _port(ref, arch)
    caches = model.init_caches(2, 40, device="cpu")
    h, caches = model.prefill(params, {"tokens": torch.from_numpy(
        ref["tokens"])}, caches)
    _close(_f32(h), ref["prefill_h"], TOL)
    want = convert.caches_from_reference(ref["caches"], device="cpu")
    for name in ("k", "v"):
        _close(_f32(getattr(caches["blocks"], name)),
               _f32(getattr(want["blocks"], name)), TOL)
    assert torch.equal(caches["blocks"].length, want["blocks"].length)
    logits, dcaches = model.decode(params, caches,
                                   torch.from_numpy(ref["nxt"]))
    _close(logits, ref["decode_logits"], TOL)
    for name in ("k", "v", "length"):
        _close(_f32(getattr(dcaches["blocks"], name)),
               getattr(ref["decode_caches"]["blocks"], name), TOL)
    # decode from the reference's own caches too
    logits2, _ = model.decode(params, want, torch.from_numpy(ref["nxt"]))
    _close(logits2, ref["decode_logits"], TOL)


def test_gemma2_windows_and_caches():
    """gemma2 alternates local (even) and global layers, so its caches are
    linear and max_len long; an all-windowed config takes ring caches of
    the window's length."""
    from repro_torch.models import transformer as t_tr
    from repro.models import transformer as r_tr
    cfg = get_config("gemma2-9b")
    np.testing.assert_array_equal(t_tr._layer_windows(cfg),
                                  r_tr._layer_windows(r_get_config(
                                      "gemma2_9b")))
    assert not t_tr.ring_caches(cfg)
    small = reduced(cfg)
    assert build(small).init_caches(2, 48, device="cpu")["blocks"].k.shape \
        == (2, 2, 48, 4, 16)
    windowed = dataclasses.replace(small, alt_local_global=False)
    assert t_tr.ring_caches(windowed)
    assert t_tr.init_caches(windowed, 2, 48, device="cpu")["blocks"].k \
        .shape == (2, 2, 16, 4, 16)
    assert abs(t_tr._res_scale(get_config("minicpm-2b"))
               - 1.4 / np.sqrt(40)) < 1e-12


def test_full_param_counts_equal_reference():
    """All ten architectures, from the specs alone (no weights)."""
    from repro_torch.configs import ARCHS as ALL_ARCHS
    counts = {}
    for arch in ALL_ARCHS:
        counts[arch] = param_count(build(get_config(arch)).specs())
        assert counts[arch] == r_param_count(
            r_build(r_get_config(arch)).specs()), arch
    assert 9.2e9 < counts["gemma2_9b"] < 9.3e9
    assert round(counts["deepseek_moe_16b"] / 1e9, 3) == 16.376
    assert round(counts["arctic_480b"] / 1e9, 2) == 476.85


@pytest.mark.parametrize("arch", ("qwen3_32b", "gemma2_9b"))
def test_engine_greedy_matches_reference(refs, arch):
    ref = refs[arch]
    model, params = _port(ref, arch)
    eng = Engine(model, ServeConfig(slots=2, max_len=64,
                                    max_new_tokens=MAX_NEW))
    out = eng.generate_batch(params, _requests(Request, 256))
    assert [(w.batch, w.prompt_len) for w in eng.waves] == [(2, 20), (1, 33)]
    assert_greedy_matches(out, ref["out"], ref["margins"], len(PROMPTS) * 2)


def test_serve_cli_runs_reduced_gemma2_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "gemma2-9b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new",
                       "3"]) == 0
    text = capsys.readouterr().out
    assert text.count("req ") == 3 and text.count("wave ") == 2
