"""Port vs reference for the Mamba-2 serving slice, on the CPU (where the
SSD-chunk wrapper runs its plain version):

* the SSD chunk: ``ssd_chunk_plain`` against the reference's Pallas kernel
  (interpret mode) and ``ssd_chunk_ref`` at rtol/atol 2e-4 (f32; the
  tolerance of ``tests/test_kernels_ssd.py``), and the port's chunked scan
  against ``repro.models.ssm.ssd_chunked`` at 2e-4;
* layers: ``causal_conv1d`` and ``rms_norm`` at 1e-6 (one f32 rounding);
* the reduced ``mamba2_27b`` (2 layers) with the reference's parameters
  carried across by ``convert.params_from_reference``: the hidden states
  of the full forward, of prefill and of one decode step, and the caches,
  at the reference's own 5e-2 (``tests/test_models.py``; the reference's
  jnp scan rounds its scores and carried state to bf16, the port's kernel
  stays in f32).  Logits are checked where that tolerance means
  something: the LM head on the reference's own hidden states to one bf16
  rounding (1e-2), and greedy serving with the same tokens wherever the
  reference's top-2 logit margin exceeds 5e-2.  (Held directly, logits
  would see the hidden's bf16 differences summed over d_model.)

The JAX reference of the model runs once per module (``ref`` fixture).
Its random weights come from the reference's own initializers with
per-leaf keys from a stable hash of the parameter path
(:func:`_stable_init`): ``init_params`` folds in Python's ``hash`` of the
path, which ``PYTHONHASHSEED`` salts per process, so every test process
used to draw another model.
"""
import contextlib
import dataclasses
import zlib
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config, reduced as r_reduced
from repro.kernels import ops as r_ops, ref as r_ref
from repro.models import build as r_build, layers as r_layers, ssm as r_ssm
from repro.models import hybrid as r_hybrid
from repro.models import modules as r_modules
from repro.models import transformer as r_transformer
from repro.models.modules import param_bytes as r_param_bytes
from repro.models.modules import param_count as r_param_count
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import dispatch
from repro_torch.kernels import ssd_chunk as t_ssd
from repro_torch.models import build, layers as t_layers, ssm as t_ssm
from repro_torch.models import hybrid as t_hybrid, transformer as t_tr
from repro_torch.models.modules import init_params, param_bytes, param_count
from repro_torch.serve.engine import Engine, Request, ServeConfig

TOL = 5e-2              # the reference's own model tolerance
MAX_NEW = 8
PROMPTS = (5, 20, 33)   # 3 requests, 2 slots: waves (5, 20) and (33,)
EMBED_SCALE = 0.25


def _chunk_inputs(bh, c, P, N, seed, bg=None):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    bg = bh if bg is None else bg
    x = rng.standard_normal((bh, c, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, c)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(bh) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((bg, c, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((bg, c, N)) * 0.3).astype(np.float32)
    S = (rng.standard_normal((bh, P, N)) * 0.1).astype(np.float32)
    return x, dt, A, B, C, S


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bh,c,P,N", [
    (4, 16, 8, 4), (8, 32, 16, 8), (2, 64, 64, 128),
    (3, 128, 64, 32), (1, 8, 4, 4),
])
def test_ssd_chunk_plain_matches_reference_kernel_and_ref(bh, c, P, N):
    ins = _chunk_inputs(bh, c, P, N, bh * c)
    y_k, s_k = r_ops.ssd_chunk(*map(jnp.asarray, ins))
    y_r, s_r = r_ref.ssd_chunk_ref(*map(jnp.asarray, ins))
    y_t, s_t = t_ssd.ssd_chunk_plain(*map(torch.from_numpy, ins))
    for want_y, want_s in ((y_k, s_k), (y_r, s_r)):
        _close(y_t, want_y, 2e-4)
        _close(s_t, want_s, 2e-4)


def test_ssd_chunk_bf16_inputs_match_reference_kernel():
    """bf16 x / B / C are upcast inside both: f32 math on the same values."""
    x, dt, A, B, C, S = _chunk_inputs(2, 32, 16, 8, 0)
    bf = lambda a: a.astype(ml_dtypes.bfloat16)
    y_k, s_k = r_ops.ssd_chunk(jnp.asarray(bf(x)), jnp.asarray(dt),
                               jnp.asarray(A), jnp.asarray(bf(B)),
                               jnp.asarray(bf(C)), jnp.asarray(S))
    tb = lambda a: convert._t(bf(a), torch.device("cpu"))
    y_t, s_t = t_ssd.ssd_chunk(tb(x), torch.from_numpy(dt),
                               torch.from_numpy(A), tb(B), tb(C),
                               torch.from_numpy(S))
    assert y_t.dtype == s_t.dtype == torch.float32
    _close(y_t, y_k, 2e-4)
    _close(s_t, s_k, 2e-4)


def test_ssd_chunk_groups_equal_repeated_rows_and_wrapper_is_plain_on_cpu():
    """B / C with one row block per group (pair g reads g // rep) equal the
    rows repeated per pair; on CPU tensors the wrapper launches nothing."""
    ins = [torch.from_numpy(a) for a in _chunk_inputs(8, 24, 8, 16, 3, bg=2)]
    x, dt, A, B, C, S = ins
    dispatch.reset_launches()
    y_g, s_g = t_ssd.ssd_chunk(x, dt, A, B, C, S)
    assert dispatch.LAUNCHES == {}
    rep = lambda t: t.repeat_interleave(4, dim=0)
    y_r, s_r = t_ssd.ssd_chunk_plain(x, dt, A, rep(B), rep(C), S)
    assert torch.equal(y_g, y_r) and torch.equal(s_g, s_r)


def test_ssd_chunk_operand_checks():
    x, dt, A, B, C, S = (torch.from_numpy(a)
                         for a in _chunk_inputs(4, 16, 8, 4, 5, bg=2))
    assert t_ssd._check(x, dt, A, B, C, S) == 2
    assert t_ssd._check(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(),
                        S) == 2
    bad = [(x.double(), dt, A, B, C, S), (x, dt.bfloat16(), A, B, C, S),
           (x.bfloat16(), dt, A, B, C, S), (x, dt, A, B[:1].expand(3, -1, -1)
                                            .contiguous(), C, S),
           (x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B, C, S),
           (x, dt, A, B, C, S[:, :, :2])]
    for args in bad:
        with pytest.raises(ValueError, match="ssd_chunk"):
            t_ssd._check(*args)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_matches_reference_scan(G):
    Bb, L, H, P, N, chunk = 2, 64, 4, 8, 16, 16
    rng = np.random.default_rng(9 + G)
    x = rng.standard_normal((Bb, L, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((Bb, L, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((Bb, L, G, N)) * 0.3).astype(np.float32)
    y_r, s_r = r_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    y_t, s_t = t_ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                                 chunk)
    _close(y_t, y_r, 2e-4)
    _close(s_t, s_r, 2e-4)


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv1d_matches_reference(with_prev):
    rng = np.random.default_rng(int(with_prev))
    x = rng.standard_normal((2, 11, 6), dtype=np.float32)
    w = rng.standard_normal((4, 6), dtype=np.float32)
    prev = rng.standard_normal((2, 3, 6), dtype=np.float32) \
        if with_prev else None
    y_r, p_r = r_layers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                      None if prev is None
                                      else jnp.asarray(prev))
    y_t, p_t = t_layers.causal_conv1d(torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      None if prev is None
                                      else torch.from_numpy(prev))
    _close(y_t, y_r, 1e-6)
    _close(p_t, p_r, 0.0)


@pytest.mark.parametrize("eps,scale", [(1e-5, 3.0), (1e-6, 1e-3)])
def test_rms_norm_matches_reference(eps, scale):
    """Inputs of ordinary size, and inputs small enough that eps counts."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 32), dtype=np.float32) * scale
    w = rng.standard_normal(32, dtype=np.float32)
    want = r_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), eps)
    got = t_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps)
    _close(got, want, 1e-6)


def test_configs_match_reference():
    for name in ("mamba2_27b", "mamba2-2.7b"):
        for shrink in (False, True):
            got, want = get_config(name), r_get_config(name)
            if shrink:
                got, want = reduced(got), r_reduced(want)
            for f in dataclasses.fields(got):
                a, b = getattr(got, f.name), getattr(want, f.name)
                if f.name == "ssm":
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                assert a == b, (name, shrink, f.name)


def test_param_specs_count_and_init():
    model, r_model = build(get_config("mamba2_27b")), \
        r_build(r_get_config("mamba2_27b"))
    assert param_count(model.specs()) == r_param_count(r_model.specs())
    assert param_bytes(model.specs(), torch.bfloat16) == \
        r_param_bytes(r_model.specs(), jnp.bfloat16)
    specs = build(reduced(get_config("mamba2_27b"))).specs()
    gen = lambda s: torch.Generator().manual_seed(s)
    a = init_params(specs, gen(3), device="cpu")
    b = init_params(specs, gen(3), device="cpu")
    c = init_params(specs, gen(4), device="cpu")
    assert torch.equal(a["blocks"]["in_proj"], b["blocks"]["in_proj"])
    assert not torch.equal(a["blocks"]["in_proj"], c["blocks"]["in_proj"])
    assert not torch.equal(a["blocks"]["in_proj"][0, :, :64],
                           a["blocks"]["out_proj"][0, :64])
    # the reference's std: 1/sqrt(fan-in) for "normal", 0.02 for "small"
    assert abs(float(a["blocks"]["in_proj"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(a["blocks"]["conv_w"].std()) - 0.02) < 0.002
    assert torch.equal(a["blocks"]["D"], torch.ones(2, 16))
    bf = init_params(specs, gen(3), param_dtype=torch.bfloat16, device="cpu")
    assert torch.equal(bf["embed"], a["embed"].bfloat16())


def test_convert_bf16_and_caches_bit_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    t = convert.params_from_reference({"w": {"x": a}}, device="cpu")["w"]["x"]
    assert t.dtype == torch.bfloat16
    assert (t.view(torch.int16).numpy() == a.view(np.int16)).all()
    conv = rng.standard_normal((2, 1, 3, 4)).astype(ml_dtypes.bfloat16)
    state = rng.standard_normal((2, 1, 4, 2, 3)).astype(np.float32)
    cache = convert.caches_from_reference(
        r_ssm.SSMCache(jnp.asarray(conv), jnp.asarray(state)), device="cpu")
    assert (cache.conv.view(torch.int16).numpy() == conv.view(np.int16)).all()
    assert (cache.state.numpy() == state).all()


# ---------------------------------------------------------------------------
# The reduced model and the engine against the reference.
# ---------------------------------------------------------------------------

def _requests(cls, vocab):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt=rng.integers(3, vocab, n).astype(np.int32))
            for i, n in enumerate(PROMPTS)]


def _left_pad(prompts):
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for j, p in enumerate(prompts):
        toks[j, S - len(p):] = p
    return toks


def _replay_margins(eng, model, params, reqs, out, scfg):
    """Top-2 logit margin of every generated token of the reference
    engine, replayed through its own jitted prefill / decode (the wave's
    extras merged as the engine merges them)."""
    margins = {}
    for w0 in range(0, len(reqs), scfg.slots):
        wave = reqs[w0:w0 + scfg.slots]
        batch = {"tokens": jnp.asarray(_left_pad([r.prompt for r in wave]))}
        for r in wave:
            batch.update({k: jnp.asarray(v)
                          for k, v in (r.extras or {}).items()})
        caches = model.init_caches(len(wave), scfg.max_len)
        h, caches = eng._prefill(params, batch, caches)
        steps = [np.asarray(model.logits(params, h[:, -1:, :])[:, -1])]
        n = max(len(out[r.rid]) for r in wave)
        for t in range(1, n):
            fed = np.array([[out[r.rid][t - 1] if t - 1 < len(out[r.rid])
                             else scfg.eos_id] for r in wave], np.int32)
            logits, caches = eng._decode(params, caches, jnp.asarray(fed))
            steps.append(np.asarray(logits[:, -1]))
        for j, r in enumerate(wave):
            top = np.sort(np.stack([s[j] for s in steps[:len(out[r.rid])]]),
                          axis=-1)
            assert (np.stack([s[j] for s in steps[:len(out[r.rid])]])
                    .argmax(-1) == out[r.rid]).all(), "replay diverged"
            margins[r.rid] = top[:, -1] - top[:, -2]
    return margins


def _stable_init(spec_tree, key):
    """``repro.models.modules.init_params`` with each leaf's key folded
    from a CRC-32 of its path instead of Python's per-process ``hash``:
    the reference's initializers, the same weights in every process."""
    def rec(tree, prefix=()):
        if r_modules.is_spec(tree):
            h = zlib.crc32("/".join(map(str, prefix)).encode()) % (2**31 - 1)
            return r_modules._initializer(tree, jax.random.fold_in(key, h),
                                          tree.dtype)
        return {k: rec(v, prefix + (k,)) for k, v in tree.items()}
    return rec(spec_tree)


def _np32(t) -> np.ndarray:
    """A reference array as numpy, bf16 as f32."""
    return np.asarray(t.astype(jnp.float32)) if t.dtype == jnp.bfloat16 \
        else np.asarray(t)


@contextlib.contextmanager
def head_inputs(module):
    """The hidden states that ``module.logits_fn`` (the LM head every
    family's decode ends in) is called with, collected into a list."""
    seen = []
    head = module.logits_fn

    def spy(params, hidden, *args, **kw):
        seen.append(hidden)
        return head(params, hidden, *args, **kw)

    with mock.patch.object(module, "logits_fn", spy):
        yield seen


def reference_reduced(arch: str, extras=None, *, S: int = 24,
                      max_len: int = 40, embed_scale: float = EMBED_SCALE,
                      cfg_edit=None) -> dict:
    """One reduced reference model's runs on 2 sequences of ``S`` random
    tokens (seed 1): its parameters (``_stable_init``, the embedding
    scaled so that the blocks, not the embedding, pick tokens) as numpy,
    the tokens, the next tokens, the extras (``extras(cfg, rng, B, S)`` ->
    dict of numpy arrays), the hidden states, aux and logits of the full
    forward, the prefill's hidden states and caches (``max_len``), and one
    decode step's hidden states, logits and caches."""
    cfg = r_reduced(r_get_config(arch))
    if cfg_edit is not None:
        cfg = cfg_edit(cfg)
    model = r_build(cfg)
    params = _stable_init(model.specs(), jax.random.PRNGKey(0))
    params["embed"] = params["embed"] * embed_scale
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    ext = extras(cfg, rng, 2, S) if extras else {}
    batch = {"tokens": jnp.asarray(tokens),
             **{k: jnp.asarray(v) for k, v in ext.items()}}
    h, aux = model.hidden(params, batch)
    caches = model.init_caches(2, max_len)
    hp, caches = model.prefill(params, batch, caches)
    with head_inputs(r_transformer) as seen:
        logits_d, dcaches = model.decode(params, caches, jnp.asarray(nxt))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return dict(params=to_np(params), tokens=tokens, nxt=nxt, extras=ext,
                hidden=_np32(h), aux=float(aux),
                logits=_np32(model.logits(params, h)), prefill_h=_np32(hp),
                caches=to_np(caches), decode_h=_np32(seen[0]),
                decode_logits=_np32(logits_d), decode_caches=to_np(dcaches),
                cfg=cfg)


def assert_caches_close(got, want, tol, path="caches"):
    """Every field of a port cache tree against the reference's (numpy
    leaves; integer fields exactly)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_caches_close(got[k], want[k], tol, f"{path}.{k}")
        return
    if isinstance(want, tuple):
        fields = getattr(want, "_fields", None) or range(len(want))
        assert len(got) == len(want), path
        for i, f in enumerate(fields):
            assert_caches_close(got[i], want[i], tol, f"{path}.{f}")
        return
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    w = np.asarray(want, np.float32) if want.dtype.kind == "V" or \
        want.dtype.name == "bfloat16" else np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype.kind in "iu":
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=path)


def port_batch(ref) -> dict:
    return {"tokens": torch.from_numpy(ref["tokens"]),
            **{k: torch.from_numpy(v) for k, v in ref["extras"].items()}}


def assert_port_matches_reduced(ref, model, tol=TOL):
    """The port on the reference's parameters and inputs: the full
    forward's hidden states and aux, the prefill's hidden states and every
    cache field, and one decode step's hidden states (the LM head's input)
    and caches (from the port's prefill caches and from the reference's
    own), at ``tol``.  Logits are the LM head on the reference's own hidden
    states, to one bf16 rounding (held on the port's hidden states, they
    would see the hidden's bf16 differences summed over d_model, as in the
    Mamba-2 tests above).  Returns the port's prefill caches."""
    params = convert.params_from_reference(ref["params"], device="cpu")
    batch = port_batch(ref)
    h, aux = model.hidden(params, batch)
    assert h.dtype == torch.bfloat16
    _close(h.float(), ref["hidden"], tol)
    _close(aux, ref["aux"], tol)
    _close(model.logits(params, torch.tensor(ref["hidden"]).bfloat16()),
           ref["logits"], 1e-2)
    caches = model.init_caches(2, 40, device="cpu")
    hp, caches = model.prefill(params, batch, caches)
    _close(hp.float(), ref["prefill_h"], tol)
    assert_caches_close(caches, ref["caches"], tol)
    _close(model.logits(params, torch.tensor(ref["decode_h"]).bfloat16()),
           ref["decode_logits"], 1e-2)
    nxt = torch.from_numpy(ref["nxt"])
    for start in (caches, convert.caches_from_reference(ref["caches"],
                                                        device="cpu")):
        with head_inputs(t_tr) as seen:
            logits, dcaches = model.decode(params, start, nxt)
        assert logits.shape == ref["decode_logits"].shape
        _close(seen[0].float(), ref["decode_h"], tol)
        assert_caches_close(dcaches, ref["decode_caches"], tol,
                            "decode caches")
    return caches


def reference_engine(ref, reqs, scfg) -> tuple[dict, dict]:
    """The reference engine's greedy tokens for ``reqs`` on the reduced
    model of ``reference_reduced``'s result, and every token's top-2 logit
    margin (replayed)."""
    model = r_build(ref["cfg"])
    params = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    eng = REngine(model, scfg)
    out = eng.generate_batch(params, reqs)
    return out, _replay_margins(eng, model, params, reqs, out, scfg)


def assert_greedy_matches(out, want, margins, min_checked, tol=TOL):
    """Port tokens equal the reference's wherever the reference's top-2
    margin exceeds ``tol``, up to the first near-tie that went the other
    way; at least ``min_checked`` tokens compared."""
    assert sorted(out) == sorted(want)
    checked = 0
    for rid, w in want.items():
        got, margin = out[rid], margins[rid]
        for t in range(min(len(got), len(w))):
            if margin[t] > tol:
                assert got[t] == w[t], (rid, t, margin[t])
                checked += 1
            elif got[t] != w[t]:
                break           # a near-tie went the other way: stop here
        else:
            assert len(got) == len(w), rid
    assert checked >= min_checked, "too few decisive tokens compared"


@pytest.fixture(scope="module")
def ref():
    """Every reference run of the model tests, once."""
    cfg = r_reduced(r_get_config("mamba2_27b"))
    model = r_build(cfg)
    params = _stable_init(model.specs(), jax.random.PRNGKey(0))
    # at the init's std of 1 the tied embedding of the last token decides
    # every greedy token; at 1/4 the blocks do
    params["embed"] = params["embed"] * EMBED_SCALE
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)) \
        .astype(np.int32)                         # 40: 3 chunks, padded
    nxt = np.array([[5], [7]], np.int32)
    h, _ = model.hidden(params, {"tokens": jnp.asarray(tokens)})
    caches = model.init_caches(2, 64)
    hp, caches = model.prefill(params, {"tokens": jnp.asarray(tokens)},
                               caches)
    dh, _, dcaches = r_hybrid.mamba2_forward(params, jnp.asarray(nxt), cfg,
                                             None, caches)
    scfg = RServeConfig(slots=2, max_len=64, max_new_tokens=MAX_NEW)
    eng = REngine(model, scfg)
    reqs = _requests(RRequest, cfg.vocab)
    out = eng.generate_batch(params, reqs)
    np_ = lambda t: np.asarray(t.astype(jnp.float32)) \
        if t.dtype == jnp.bfloat16 else np.asarray(t)
    return dict(
        params=jax.tree_util.tree_map(np.asarray, params), tokens=tokens,
        nxt=nxt, hidden=np_(h), logits=np_(model.logits(params, h)),
        prefill_h=np_(hp), conv=np_(caches.conv), state=np_(caches.state),
        decode_h=np_(dh), decode_conv=np_(dcaches.conv),
        decode_state=np_(dcaches.state), out=out,
        margins=_replay_margins(eng, model, params, reqs, out, scfg))


@pytest.fixture(scope="module")
def port(ref):
    model = build(reduced(get_config("mamba2_27b")))
    return model, convert.params_from_reference(ref["params"], device="cpu")


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()




def test_reduced_model_hidden_and_logits_match_reference(ref, port):
    model, params = port
    h, aux = model.hidden(params, {"tokens": torch.from_numpy(ref["tokens"])})
    assert h.dtype == torch.bfloat16 and float(aux) == 0.0
    _close(_f32(h), ref["hidden"], TOL)
    # the LM head alone, on the reference's hidden states
    h_ref = torch.tensor(ref["hidden"]).bfloat16()
    _close(model.logits(params, h_ref), ref["logits"], 1e-2)


def test_reduced_model_prefill_and_decode_match_reference(ref, port):
    model, params = port
    caches = model.init_caches(2, 64, device="cpu")
    h, caches = model.prefill(params, {"tokens": torch.from_numpy(
        ref["tokens"])}, caches)
    _close(_f32(h), ref["prefill_h"], TOL)
    _close(_f32(caches.conv), ref["conv"], TOL)
    _close(_f32(caches.state), ref["state"], TOL)
    nxt = torch.from_numpy(ref["nxt"])
    dh, _, dcaches = t_hybrid.mamba2_forward(params, nxt, model.cfg, caches)
    _close(_f32(dh), ref["decode_h"], TOL)
    _close(_f32(dcaches.conv), ref["decode_conv"], TOL)
    _close(_f32(dcaches.state), ref["decode_state"], TOL)
    logits, dcaches2 = model.decode(params, caches, nxt)
    assert torch.equal(logits, t_tr.logits_fn(params, dh, model.cfg))
    assert torch.equal(dcaches2.state, dcaches.state)


def test_reduced_model_decode_equals_chunked_prefill(port):
    """The reference's own consistency check, on the port: prefill S+1
    tokens == prefill S, then decode 1."""
    model, params = port
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (1, 17)))
    cA = model.init_caches(1, 64, device="cpu")
    hA, _ = model.prefill(params, {"tokens": tokens}, cA)
    cB = model.init_caches(1, 64, device="cpu")
    _, cB = model.prefill(params, {"tokens": tokens[:, :16]}, cB)
    logits_b, _ = model.decode(params, cB, tokens[:, 16:])
    _close(_f32(model.logits(params, hA[:, -1:, :])), _f32(logits_b), TOL)


def test_engine_greedy_matches_reference(ref, port):
    model, params = port
    eng = Engine(model, ServeConfig(slots=2, max_len=64,
                                    max_new_tokens=MAX_NEW))
    out = eng.generate_batch(params, _requests(Request, 256))
    assert [(w.batch, w.prompt_len) for w in eng.waves] == [(2, 20), (1, 33)]
    assert all(got.dtype == np.int32 for got in out.values())
    assert_greedy_matches(out, ref["out"], ref["margins"], len(PROMPTS) * 2)


def test_engine_samples_reproducibly_at_temperature(port):
    """temperature > 0 samples from the engine's seeded generator."""
    model, params = port
    scfg = ServeConfig(slots=2, max_len=64, max_new_tokens=6,
                       temperature=1.0)
    reqs = _requests(Request, 256)
    runs = [Engine(model, scfg, seed=s).generate_batch(params, reqs)
            for s in (5, 5, 6)]
    for rid in runs[0]:
        assert (runs[0][rid] == runs[1][rid]).all()
        assert ((runs[0][rid] >= 0) & (runs[0][rid] < 256)).all()
    assert any(len(runs[0][r]) != len(runs[2][r]) or
               (runs[0][r] != runs[2][r]).any() for r in runs[0])


def test_serve_cli_runs_reduced_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "mamba2_27b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new",
                       "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("req ") for line in lines) == 3
    assert sum(line.startswith("wave ") for line in lines) == 2
