"""Port vs reference for the vision family (Qwen2-VL), on the CPU:

* ``apply_mrope`` at rtol/atol 2e-4 in f32, at the published sections
  (16, 24, 24) with head_dim 128 and at the reduced ones, on position ids
  that differ between the three axes; with three equal axes it is
  ``apply_rope`` bit for bit (why decode, which the reference runs
  without ``positions3``, continues a prefill at the broadcast ``arange``
  exactly);
* reduced qwen2-vl-7b with ``vision_embeds`` and ``positions3``: the full
  forward, prefill (every cache field) and one decode step at 5e-2
  (``tests/test_models.py:101``), with ``_stable_init`` weights;
* the engine at 1 slot with per-request extras: greedy tokens equal the
  reference engine's where its top-2 margin exceeds 5e-2; a wave whose
  extras do not cover it raises ``ValueError`` (the reference's model
  raises ``TypeError`` there);
* ``python -m repro_torch.launch.serve --arch qwen2-vl-7b --reduced
  --device cpu``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as r_layers
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.models import build, layers as t_layers
from repro_torch.serve.engine import Engine, Request, ServeConfig
from test_torch_models import (MAX_NEW, _close, assert_greedy_matches,
                               assert_port_matches_reduced, reference_engine,
                               reference_reduced)

ARCH = "qwen2_vl_7b"
MOD_TOL = 2e-4
PROMPTS = (12, 20, 33)    # at least the reduced 8 vision tokens each


def positions3(B: int, S: int) -> np.ndarray:
    """Temporal / height / width ids that differ between the axes."""
    ar = np.arange(S)
    return np.broadcast_to(np.stack([ar, ar // 3, ar % 5])[:, None, :],
                           (3, B, S)).astype(np.int32).copy()


def vlm_extras(cfg, rng, B, S) -> dict:
    return {"positions3": positions3(B, S),
            "vision_embeds": rng.standard_normal(
                (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("sections,head_dim,theta", [
    ((16, 24, 24), 128, 1_000_000.0), ((4, 2, 2), 16, 1_000_000.0),
    ((4, 2, 2), 16, 10000.0)])
def test_mrope_matches_reference(sections, head_dim, theta):
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 7, 3, head_dim), dtype=np.float32) * 3
    pos3 = rng.integers(0, 5000, (3, 2, 7)).astype(np.int32)
    want = r_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections,
                                theta)
    got = t_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                               sections, theta)
    _close(got, want, MOD_TOL)


def test_mrope_with_equal_axes_is_rope():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 128),
                                             dtype=np.float32)).bfloat16()
    pos = torch.arange(100, 109).expand(2, 9)
    assert torch.equal(
        t_layers.apply_mrope(x, pos.expand(3, 2, 9), (16, 24, 24), 1e6),
        t_layers.apply_rope(x, pos, 1e6))


@pytest.fixture(scope="module")
def ref():
    return reference_reduced(ARCH, vlm_extras)


def test_reduced_vlm_matches_reference(ref):
    model = build(reduced(get_config(ARCH)))
    assert model.cfg.mrope_sections == (4, 2, 2)
    assert_port_matches_reduced(ref, model)


def test_vision_embeds_and_positions3_reach_the_model(ref):
    """Each extra changes the hidden states (so the parity above sees
    them), and vision embeds of another batch size overwrite only the rows
    their shape covers, as ``dynamic_update_slice`` does."""
    from repro_torch import convert
    from repro_torch.models import transformer as t_tr
    model = build(reduced(get_config(ARCH)))
    params = convert.params_from_reference(ref["params"], device="cpu")
    tokens = torch.from_numpy(ref["tokens"])
    ext = {k: torch.from_numpy(v) for k, v in ref["extras"].items()}
    h = model.hidden(params, {"tokens": tokens, **ext})[0]
    for drop in ext:
        rest = {k: v for k, v in ext.items() if k != drop}
        assert not torch.equal(h, model.hidden(params, {"tokens": tokens,
                                                        **rest})[0])
    x = t_tr.embed_tokens(params, tokens, model.cfg,
                          ext["vision_embeds"][:1])
    plain = t_tr.embed_tokens(params, tokens, model.cfg)
    assert torch.equal(x[0, :8], ext["vision_embeds"][0].bfloat16())
    assert torch.equal(x[1], plain[1]) and torch.equal(x[0, 8:], plain[0, 8:])


def _requests(cls, cfg):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                extras=vlm_extras(cfg, rng, 1, n))
            for i, n in enumerate(PROMPTS)]


def test_engine_greedy_with_extras_matches_reference(ref):
    """One slot: each wave's extras are its one request's."""
    from repro_torch import convert
    cfg = reduced(get_config(ARCH))
    want, margins = reference_engine(
        ref, _requests(RRequest, cfg),
        RServeConfig(slots=1, max_len=64, max_new_tokens=MAX_NEW))
    eng = Engine(build(cfg), ServeConfig(slots=1, max_len=64,
                                         max_new_tokens=MAX_NEW))
    out = eng.generate_batch(
        convert.params_from_reference(ref["params"], device="cpu"),
        _requests(Request, cfg))
    assert [(w.batch, w.prompt_len) for w in eng.waves] == \
        [(1, n) for n in PROMPTS]
    assert_greedy_matches(out, want, margins, len(PROMPTS) * 2)


def test_engine_refuses_extras_that_do_not_cover_the_wave():
    cfg = reduced(get_config(ARCH))
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(model, ServeConfig(slots=2, max_len=64, max_new_tokens=2))
    with pytest.raises(ValueError, match=r"'positions3' of shape \(3, 1, 12\)"
                       r" has no batch axis 1 of the wave's 2 requests"):
        eng.generate_batch(params, _requests(Request, cfg)[:2])
    # extras that cover the wave (the same value in each request, as the
    # reference's merge expects) are served
    rng = np.random.default_rng(2)
    wide = vlm_extras(cfg, rng, 2, 12)
    reqs = [Request(i, rng.integers(3, cfg.vocab, 12).astype(np.int32),
                    extras=wide) for i in range(2)]
    assert sorted(eng.generate_batch(params, reqs)) == [0, 1]


def test_serve_cli_runs_reduced_vlm_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen2-vl-7b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--slots", "2",
                       "--max-new", "3"]) == 0
    text = capsys.readouterr().out
    assert text.count("req ") == 3 and text.count("wave ") == 2
