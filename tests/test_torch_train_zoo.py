"""One train step of every reduced architecture, port vs reference, on the
CPU (the counterpart of ``tests/test_models.py::test_train_step_smoke``,
which trains every family in the reference):

* the loss's metrics (loss, nll, aux, z) at rtol 1e-2 and every gradient
  leaf at the model tolerance 5e-2 (``tests/test_models.py:101``): the RMS
  of the difference within 5e-2 of the reference leaf's RMS (held element
  by element, gradients see the blocks' bf16 noise at their smallest
  entries);
* MoE expert leaves (``router``, ``w_gate``, ``w_up``, ``w_down``) expert
  by expert, the same rule for each, except the experts of one routing
  flip: a token whose top-k margin lies inside the bf16 noise goes to
  another expert in the port than in the reference, which moves the
  gradients of those two experts and of no other (at most 2 experts per
  layer, the same in every expert leaf);
* then ``train_step``: finite loss and grad_norm, step 1, parameters
  moved.

Parameters are the reference's own initializers with ``_stable_init``'s
per-leaf keys; the batch is ``synthetic_batch``'s (2 x 32 tokens,
next-token labels: with ``labels = tokens`` as in the reference's smoke
test a tied embedding almost solves the task at init and the gradients
are near 0), with ``test_torch_vlm.py`` and ``test_torch_whisper.py``'s
extras.  The reference's gradients come from one ``jax.jit`` of
``value_and_grad`` per architecture, in one module fixture.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config, reduced as r_reduced
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import synthetic_batch as r_synthetic_batch
from repro.models import build as r_build
from repro.models.transformer import Runtime
from repro.train import step as r_step
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.models import build
from repro_torch.train import optimizer as opt, step as t_step
from test_torch_models import TOL, _stable_init
from test_torch_vlm import vlm_extras
from test_torch_whisper import audio_extras

METRIC_RTOL = 1e-2
MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")
MAX_FLIPPED = 2          # experts one routing flip may move, per layer
B, S = 2, 32


def batch_of(cfg) -> dict:
    """synthetic_batch's tokens and labels, and the family's extras, as
    numpy."""
    b = r_synthetic_batch(RDataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B), 0)
    out = {k: np.asarray(v) for k, v in b.items()}
    rng = np.random.default_rng(2)
    if cfg.family == "vlm":
        out.update(vlm_extras(cfg, rng, B, S))
    if cfg.family == "audio":
        out.update(audio_extras(cfg, rng, B, S))
    return out


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def assert_grad_close(got: np.ndarray, want: np.ndarray, what: str,
                      tol: float = TOL) -> None:
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = rms(got - want)
    assert err <= tol * rms(want) + 1e-30, (what, err, rms(want))


def flipped_experts(got: np.ndarray, want: np.ndarray,
                    tol: float = TOL) -> set:
    """(layer, expert) pairs of an expert leaf (L, E, ...) or the router
    (L, d, E) whose gradient misses ``tol``."""
    if got.ndim == 3 and got.shape[-1] != want.shape[1]:     # router
        got, want = np.moveaxis(got, -1, 1), np.moveaxis(want, -1, 1)
    bad = set()
    for layer in range(want.shape[0]):
        for e in range(want.shape[1]):
            g, w = got[layer, e], want[layer, e]
            if rms(g - w) > tol * rms(w) + 1e-30:
                bad.add((layer, e))
    return bad


def assert_grads_match(got: dict, want: dict, path: str = "") -> None:
    """Every gradient leaf at ``TOL``; MoE expert leaves expert by expert,
    one routing flip (at most ``MAX_FLIPPED`` experts of a layer, the same
    in every expert leaf) allowed."""
    assert sorted(got) == sorted(want), path
    flips = {}
    for k in want:
        if isinstance(want[k], dict):
            assert_grads_match(got[k], want[k], f"{path}/{k}")
            continue
        g = got[k].float().numpy()
        w = np.asarray(want[k], np.float32)
        if k in MOE_LEAVES and "router" in want:
            flips[k] = flipped_experts(g, w)
        else:
            assert_grad_close(g, w, f"{path}/{k}")
    if flips:
        union = set().union(*flips.values())
        per_layer = {}
        for layer, e in union:
            per_layer.setdefault(layer, set()).add(e)
        assert all(len(v) <= MAX_FLIPPED for v in per_layer.values()), \
            (path, flips)
        for k in ("w_gate", "w_up", "w_down"):
            assert flips[k] == flips["w_gate"], (path, flips)


@pytest.fixture(scope="module")
def ref():
    """Every architecture's reference loss metrics and gradients."""
    out = {}
    for arch in ARCHS:
        cfg = r_reduced(r_get_config(arch))
        model = r_build(cfg)
        params = _stable_init(model.specs(), jax.random.PRNGKey(0))
        batch = batch_of(cfg)
        loss_fn = r_step.make_loss_fn(model, r_step.TrainConfig(),
                                      Runtime())
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, batch)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        out[arch] = dict(params=to_np(params), batch=batch,
                         metrics={k: float(v) for k, v in metrics.items()},
                         grads=to_np(grads))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(ref, arch):
    r = ref[arch]
    model = build(reduced(get_config(arch)))
    tcfg = t_step.TrainConfig()
    params = convert.params_from_reference(r["params"], device="cpu")
    batch = {k: torch.tensor(v) for k, v in r["batch"].items()}
    grads, metrics = t_step.make_compute_grads(model, tcfg)(params, batch)
    for k, want in r["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want,
                                   rtol=METRIC_RTOL, atol=1e-6, err_msg=k)
    assert_grads_match(grads, r["grads"])
    # the whole step: the optimizer on top (in place; compare with a copy)
    state = {"params": params, "opt": opt.init_opt(params, tcfg.optimizer),
             "step": torch.zeros((), dtype=torch.int32)}
    before = [t.clone() for t in opt.tree_leaves(params)]
    state, m = t_step.make_train_step(model, tcfg)(state, batch)
    assert np.isfinite(float(m["loss"])) and \
        np.isfinite(float(m["grad_norm"]))
    assert int(state["step"]) == 1
    after = opt.tree_leaves(state["params"])
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
