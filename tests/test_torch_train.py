"""The training path, port vs reference, on the CPU:

* ``chunked_xent``: the mean NLL and z-loss, and their gradients with
  respect to the hidden states and the head, against the reference at
  rtol/atol 2e-4 in f32 (untied head, tied head with ``logit_scale``, tied
  with the softcap), and the label mask (-1 entries count nothing);
* ``ssd_chunked`` under autograd (every chunk through kernel E's
  ``autograd.Function``; on the CPU its forward is the plain version) in
  f32: the gradients of x, dt, A, B and C against ``jax.grad`` of the
  reference's scan at 2e-4, and bit for bit equal to autograd of the
  plain per-chunk loop;
* reduced minicpm-2b, held in the two parts that one AdamW step needs
  (a first step moves a parameter by the sign of its gradient, so
  parameters after a step are never compared at the model tolerance):
  the gradients against the reference's at 5e-2 of each leaf's RMS
  (``test_torch_train_zoo.py``'s rule), and the optimizer applied to the
  reference's own gradients and state at rtol 1e-6;
* gradient accumulation (``microbatch`` 2) against the whole batch at the
  reference test's tolerances (loss rtol 1e-3; parameters after the step
  rtol 3e-2, atol 3e-4); per-layer remat on and off: gradients and metrics
  bit for bit;
* the reference's trainer test ported (the loss falls over 20 steps, a
  crash injected at 25, the restart resumes at 20 and ends at 40), the
  checkpoint equal to the state it saved bit for bit, and the resumed run
  bit for bit equal to an uninterrupted one; a port trainer resumed from
  the reference trainer's checkpoint;
* ``python -m repro_torch.launch.train``: a reduced run on the CPU whose
  checkpoint the reference's ``Checkpointer`` restores (f32 and int32
  leaves), ``--mesh`` / ``--fake-devices``' errors, and the default
  device's error without a card.
"""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.configs import get_config as r_get_config, reduced as r_reduced
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import synthetic_batch as r_synthetic_batch
from repro.models import build as r_build, ssm as r_ssm
from repro.models.transformer import Runtime
from repro.train import optimizer as r_opt, step as r_step
from repro.train.trainer import Trainer as RTrainer
from repro.train.trainer import TrainerConfig as RTrainerConfig
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import ssd_chunk as t_ssd
from repro_torch.launch import train as train_cli
from repro_torch.models import build, ssm as t_ssm
from repro_torch.train import optimizer as opt, step as t_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_models import _stable_init
from test_torch_train_zoo import assert_grads_match

MOD_TOL = 2e-4
OPT_RTOL = 1e-6
ARCH = "minicpm_2b"


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _leaves(tree) -> list:
    return opt.tree_leaves(tree)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

XENT_CASES = [("qwen3_32b", 2, 16, 4), ("minicpm_2b", 1, 24, 8),
              ("gemma2_9b", 3, 8, 4), ("qwen3_32b", 2, 12, None)]


@pytest.mark.parametrize("arch,b,s,chunk", XENT_CASES)
def test_chunked_xent_and_grads_match_reference(arch, b, s, chunk):
    r_cfg, cfg = r_reduced(r_get_config(arch)), reduced(get_config(arch))
    rng = np.random.default_rng(s)
    hidden = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, ::3] = -1                                      # masked
    name = "embed" if cfg.tie_embeddings else "lm_head"
    shape = (cfg.vocab, cfg.d_model) if cfg.tie_embeddings \
        else (cfg.d_model, cfg.vocab)
    head = (rng.standard_normal(shape) * 0.3).astype(np.float32)

    def r_loss(h, w):
        nll, zsq = r_step.chunked_xent({name: w}, h, jnp.asarray(labels),
                                       r_cfg, Runtime(), chunk=chunk)
        return nll + 0.1 * zsq, (nll, zsq)

    (_, (nll_r, z_r)), (gh_r, gw_r) = jax.value_and_grad(
        r_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                              jnp.asarray(head))
    h = torch.tensor(hidden, requires_grad=True)
    w = torch.tensor(head, requires_grad=True)
    nll, zsq = t_step.chunked_xent({name: w}, h, torch.tensor(labels), cfg,
                                   chunk=chunk)
    (nll + 0.1 * zsq).backward()
    _close(nll.detach(), nll_r, MOD_TOL)
    _close(zsq.detach(), z_r, MOD_TOL)
    _close(h.grad, gh_r, MOD_TOL)
    _close(w.grad, gw_r, MOD_TOL)


def test_chunked_xent_label_mask():
    """Only unmasked tokens count: the mean over them equals the loss of
    the unmasked tokens alone; an all-masked batch is finite (0)."""
    cfg = reduced(get_config("qwen3_32b"))
    g = torch.Generator().manual_seed(0)
    h = torch.randn(1, 8, cfg.d_model, generator=g)
    params = {"lm_head": torch.randn(cfg.d_model, cfg.vocab, generator=g)
              * 0.1}
    labels = torch.full((1, 8), -1, dtype=torch.int32)
    labels[0, 0], labels[0, 5] = 3, 7
    nll, _ = t_step.chunked_xent(params, h, labels, cfg, chunk=4)
    logits = h[0, [0, 5]] @ params["lm_head"]
    want = (torch.logsumexp(logits, -1) - logits[[0, 1], [3, 7]]).mean()
    torch.testing.assert_close(nll, want, rtol=1e-6, atol=1e-6)
    nll0, z0 = t_step.chunked_xent(params, h, torch.full((1, 8), -1), cfg,
                                   chunk=4)
    assert float(nll0) == 0.0 and float(z0) == 0.0
    with pytest.raises(ValueError, match="multiple of chunk"):
        t_step.chunked_xent(params, h, labels, cfg, chunk=3)


# ---------------------------------------------------------------------------
# kernel E under autograd
# ---------------------------------------------------------------------------

def _ssd_inputs(G, seed=11):
    Bb, L, H, P, N = 2, 48, 4, 8, 16
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, L, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((Bb, L, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((Bb, L, G, N)) * 0.3).astype(np.float32)
    wy = rng.standard_normal((Bb, L, H, P)).astype(np.float32)
    ws = rng.standard_normal((Bb, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm), wy, ws


def _port_ssd_grads(ins, wy, ws, chunk):
    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    y, s = t_ssm.ssd_chunked(*leaves, chunk)
    ((y * torch.tensor(wy)).sum() + (s * torch.tensor(ws)).sum()).backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_gradients_match_reference(G):
    ins, wy, ws = _ssd_inputs(G)
    chunk = 16

    def r_loss(*a):
        y, s = r_ssm.ssd_chunked(*a, chunk)
        return (y * wy).sum() + (s * ws).sum()

    want = jax.grad(r_loss, argnums=tuple(range(5)))(
        *map(jnp.asarray, ins))
    got = _port_ssd_grads(ins, wy, ws, chunk)
    for name, g, w in zip("x dt A B C".split(), got, want):
        assert g.dtype == torch.float32, name
        _close(g, w, MOD_TOL)
    # autograd of the plain per-chunk loop: the same gradients, bit for bit
    with mock.patch.object(t_ssm, "ssd_chunk_grad", t_ssd.ssd_chunk_plain):
        plain = _port_ssd_grads(ins, wy, ws, chunk)
    for name, g, p in zip("x dt A B C".split(), got, plain):
        assert torch.equal(g, p), name


def test_ssd_chunk_grad_is_the_plain_vjp_in_each_dtype():
    """One chunk: outputs carry the Function's grad_fn; each input's
    gradient comes back in its own dtype (bf16 x, B, C) and equals the
    plain version's vjp; an input without grad gets none."""
    rng = np.random.default_rng(5)
    bh, c, P, N = 4, 16, 8, 8
    x = torch.tensor(rng.standard_normal((bh, c, P)), dtype=torch.bfloat16)
    dt = torch.tensor(np.log1p(np.exp(rng.standard_normal((bh, c)))),
                      dtype=torch.float32)
    A = torch.tensor(-np.exp(rng.standard_normal(bh) * 0.3),
                     dtype=torch.float32)
    B = torch.tensor(rng.standard_normal((2, c, N)) * 0.3,
                     dtype=torch.bfloat16)
    C = torch.tensor(rng.standard_normal((2, c, N)) * 0.3,
                     dtype=torch.bfloat16)
    s0 = torch.tensor(rng.standard_normal((bh, P, N)) * 0.1,
                      dtype=torch.float32)
    ins = [x, dt, A, B, C, s0]
    a = [t.clone().requires_grad_(i != 1) for i, t in enumerate(ins)]
    y, s = t_ssd.ssd_chunk_grad(*a)
    assert type(y.grad_fn).__name__ == "_SSDChunkBackward"
    (y.sum() + 2 * s.sum()).backward()
    b = [t.clone().requires_grad_(i != 1) for i, t in enumerate(ins)]
    y2, s2 = t_ssd.ssd_chunk_plain(*b)
    (y2.sum() + 2 * s2.sum()).backward()
    assert torch.equal(y, y2.detach()) and torch.equal(s, s2.detach())
    assert a[1].grad is None
    for i in (0, 2, 3, 4, 5):
        assert a[i].grad.dtype == ins[i].dtype, i
        assert torch.equal(a[i].grad, b[i].grad), i


# ---------------------------------------------------------------------------
# reduced minicpm-2b: gradients, then the optimizer on the same gradients
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=32, step=0) -> dict:
    b = r_synthetic_batch(RDataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B), step)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's gradients of reduced minicpm-2b and one AdamW step
    on them (WSD, lr 1e-3, warmup 1: the launcher's schedule)."""
    cfg = r_reduced(r_get_config(ARCH))
    model = r_build(cfg)
    tcfg = r_step.TrainConfig(optimizer=r_opt.OptimizerConfig(
        schedule=r_opt.ScheduleConfig(kind="wsd", peak_lr=1e-3,
                                      warmup_steps=1, total_steps=8)))
    params = _stable_init(model.specs(), jax.random.PRNGKey(0))
    batch = _batch(cfg)
    loss_fn = r_step.make_loss_fn(model, tcfg, Runtime())
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, batch)
    state = r_opt.init_opt(params, tcfg.optimizer)
    new_p, new_s, om = jax.jit(
        lambda g, s, p: r_opt.apply_opt(g, s, p, tcfg.optimizer))(
            grads, state, params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(params=to_np(params), batch=batch, grads=to_np(grads),
                metrics={k: float(v) for k, v in metrics.items()},
                new_params=to_np(new_p), new_opt=to_np(new_s),
                om={k: float(v) for k, v in om.items()},
                opt_state=to_np(state))


def _tcfg(**kw):
    return t_step.TrainConfig(optimizer=opt.OptimizerConfig(
        schedule=opt.ScheduleConfig(kind="wsd", peak_lr=1e-3,
                                    warmup_steps=1, total_steps=8)), **kw)


def test_reduced_minicpm_gradients_match_reference(ref):
    model = build(reduced(get_config(ARCH)))
    params = convert.params_from_reference(ref["params"], device="cpu")
    batch = {k: torch.tensor(v) for k, v in ref["batch"].items()}
    grads, metrics = t_step.make_compute_grads(model, _tcfg())(params,
                                                               batch)
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-2,
                                   atol=1e-6, err_msg=k)
    assert_grads_match(grads, ref["grads"])


def test_optimizer_on_reference_gradients_matches_reference(ref):
    """The port's AdamW on the reference's gradients and initial state of
    reduced minicpm-2b: every parameter (the stacked norm weights decayed,
    the 1-D final norm not) and moment at rtol 1e-6."""
    state = convert.train_state_from_reference(
        {"params": ref["params"], "opt": ref["opt_state"],
         "step": np.int32(0)}, device="cpu")
    grads = convert.params_from_reference(ref["grads"], device="cpu")
    params, st, om = opt.apply_opt(grads, state["opt"], state["params"],
                                   _tcfg().optimizer)
    for got, want in zip(_leaves(params), _leaves(ref["new_params"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=OPT_RTOL,
                                   atol=OPT_RTOL * np.abs(want).max())
    for f in ("m", "v"):
        for got, want in zip(_leaves(getattr(st, f)),
                             _leaves(getattr(ref["new_opt"], f))):
            np.testing.assert_allclose(got.numpy(), want, rtol=OPT_RTOL,
                                       atol=OPT_RTOL * np.abs(want).max())
    assert int(st.count) == 1
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(om[k]), ref["om"][k],
                                   rtol=OPT_RTOL)


def test_microbatch_equivalence():
    """Gradient accumulation over 2 microbatches == the whole batch, at the
    reference test's tolerances."""
    model = build(reduced(get_config(ARCH)))
    batch = {k: torch.tensor(v) for k, v in
             _batch(model.cfg, B=4).items()}
    out = []
    for mb in (0, 2):
        tcfg = t_step.TrainConfig(microbatch=mb)
        state = t_step.init_train_state(model, torch.Generator()
                                        .manual_seed(0), tcfg, "cpu")
        out.append(t_step.make_train_step(model, tcfg)(state, batch))
    (s1, m1), (s2, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-3)
    for x, y in zip(_leaves(s1["params"]), _leaves(s2["params"])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=3e-2,
                                   atol=3e-4)


@pytest.mark.parametrize("arch", ["minicpm_2b", "mamba2_27b",
                                  "recurrentgemma_9b", "deepseek_moe_16b",
                                  "whisper_large_v3"])
def test_remat_changes_no_value(arch):
    """Per-layer remat (recompute in the backward) against none: every
    gradient and metric bit for bit."""
    model = build(reduced(get_config(arch)))
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    cfg = model.cfg
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    if cfg.family == "audio":
        batch["enc_frames"] = torch.randn(
            2, cfg.enc_ctx, cfg.d_model,
            generator=torch.Generator().manual_seed(2))
    g_on, m_on = t_step.make_compute_grads(model, _tcfg(remat=True))(
        params, batch)
    g_off, m_off = t_step.make_compute_grads(model, _tcfg(remat=False))(
        params, batch)
    for k in m_on:
        assert torch.equal(m_on[k], m_off[k]), k
    for a, b in zip(_leaves(g_on), _leaves(g_off)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _trainer_cfgs():
    model = build(reduced(get_config(ARCH)))
    tcfg = t_step.TrainConfig(optimizer=opt.OptimizerConfig(
        schedule=opt.ScheduleConfig(kind="wsd", peak_lr=3e-3,
                                    warmup_steps=5, total_steps=40)))
    dcfg = DataConfig(vocab=model.cfg.vocab, seq_len=32, global_batch=4)
    return model, tcfg, dcfg


def _same_state(a, b) -> bool:
    """Two train states hold the same leaves, dtypes and bits."""
    fa, fb = _flatten(a), _flatten(b)
    return sorted(fa) == sorted(fb) and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


@pytest.mark.timeout(300)
def test_trainer_loss_decreases_and_resumes(tmp_path):
    model, tcfg, dcfg = _trainer_cfgs()
    d = str(tmp_path / "run")
    tr = Trainer(model, tcfg, dcfg, TrainerConfig(
        steps=20, ckpt_dir=d, ckpt_every=10, log_every=5), device="cpu")
    state, hist = tr.run(seed=0)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert [h["step"] for h in hist] == [1, 5, 10, 15, 20]
    for h in hist:
        assert set(h) >= {"loss", "nll", "aux", "z", "lr", "grad_norm",
                          "step", "dt", "produced", "consumed",
                          "producer_stalls", "in_flight"}
    template = t_step.abstract_train_state(model, tcfg)
    assert _same_state(tr.ckpt.restore(template, 20, device="cpu"), state)
    # crash at step 25, after the checkpoint at 20
    tr2 = Trainer(model, tcfg, dcfg, TrainerConfig(
        steps=40, ckpt_dir=d, ckpt_every=10, log_every=5, fail_at_step=25),
        device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        tr2.run(seed=0)
    assert tr2.ckpt.latest_step() == 20
    # the restart resumes from 20 and completes
    tr3 = Trainer(model, tcfg, dcfg, TrainerConfig(
        steps=40, ckpt_dir=d, ckpt_every=10, log_every=5), device="cpu")
    state3, hist3 = tr3.run(seed=0)
    assert int(state3["step"]) == 40 and hist3[0]["step"] == 21
    # == an uninterrupted run of 40 steps, bit for bit
    straight = Trainer(model, tcfg, dcfg, TrainerConfig(
        steps=40, ckpt_dir=str(tmp_path / "straight"), ckpt_every=100,
        log_every=5), device="cpu")
    state_s, hist_s = straight.run(seed=0)
    assert _same_state(state3, state_s)
    for k in ("loss", "nll", "aux", "z", "lr", "grad_norm", "step"):
        assert hist_s[-1][k] == hist3[-1][k], k


@pytest.mark.timeout(300)
def test_port_trainer_resumes_from_reference_checkpoint(tmp_path):
    """The reference trainer checkpoints step 10; the port resumes there,
    its first step's loss equal to the reference's own resumed step at
    rtol 1e-2 (bf16 blocks) and its state restored bit for bit."""
    d = str(tmp_path)
    r_cfg = r_reduced(r_get_config(ARCH))
    r_tcfg = r_step.TrainConfig(optimizer=r_opt.OptimizerConfig(
        schedule=r_opt.ScheduleConfig(kind="wsd", peak_lr=3e-3,
                                      warmup_steps=5, total_steps=40)))
    r_dcfg = RDataConfig(vocab=r_cfg.vocab, seq_len=32, global_batch=4)
    RTrainer(r_build(r_cfg), r_tcfg, r_dcfg, RTrainerConfig(
        steps=10, ckpt_dir=d, ckpt_every=10, log_every=5)).run(seed=0)
    saved = RCheckpointer(d).restore(jax.eval_shape(
        lambda k: r_step.init_train_state(r_build(r_cfg), k, r_tcfg),
        jax.random.PRNGKey(0)))
    _, r_hist = RTrainer(r_build(r_cfg), r_tcfg, r_dcfg, RTrainerConfig(
        steps=11, ckpt_dir=d, ckpt_every=100, log_every=5)).run(seed=0)
    model, tcfg, dcfg = _trainer_cfgs()
    tr = Trainer(model, tcfg, dcfg, TrainerConfig(
        steps=11, ckpt_dir=d, ckpt_every=100, log_every=5), device="cpu")
    state, start = tr.init_or_restore()
    assert start == 10
    assert _same_state(state, convert.train_state_from_reference(
        saved, device="cpu"))
    _, hist = tr.run()
    assert hist[0]["step"] == r_hist[0]["step"] == 11
    for k in ("loss", "nll", "z", "lr"):
        np.testing.assert_allclose(hist[0][k], r_hist[0][k], rtol=1e-2,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.timeout(300)
def test_train_cli_on_cpu_writes_a_reference_checkpoint(tmp_path, caplog):
    d = str(tmp_path)
    assert train_cli.main(["--arch", "minicpm_2b", "--reduced", "--steps",
                           "4", "--device", "cpu", "--ckpt-dir", d,
                           "--ckpt-every", "2", "--quiet"]) == 0
    assert sorted(os.listdir(d)) == ["step_0000000002", "step_0000000004"]
    r_cfg = r_reduced(r_get_config(ARCH))
    template = r_step.abstract_train_state(r_build(r_cfg),
                                           r_step.TrainConfig())
    got = RCheckpointer(d).restore(template)
    want_leaves, want_def = jax.tree_util.tree_flatten(template)
    assert jax.tree_util.tree_structure(got) == want_def
    for a, w in zip(jax.tree_util.tree_leaves(got), want_leaves):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert a.dtype in (np.float32, np.int32)
    assert int(got["step"]) == 4 and int(got["opt"].count) == 4
    port = Checkpointer(d).restore(t_step.abstract_train_state(
        build(reduced(get_config(ARCH))), t_step.TrainConfig()),
        device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(convert.train_state_to_reference(
                        port))):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("flag", [["--mesh", "2x4", "--fake-devices", "4"],
                                  ["--mesh", "3x4", "--fake-devices", "12"]])
def test_train_cli_distributed_flags_raise(flag, tmp_path):
    """The mesh flags raise where the reference would: a forced device
    count that is not the mesh's size, a data axis (3) that does not
    divide the batch (8)."""
    with pytest.raises(ValueError, match="fake-devices|does not divide"):
        train_cli.main(["--arch", "minicpm_2b", "--reduced", "--device",
                        "cpu", "--steps", "1", "--ckpt-dir", str(tmp_path),
                        "--quiet", *flag])


def test_train_cli_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "minicpm_2b", "--reduced", "--steps", "1",
                        "--ckpt-dir", str(tmp_path), "--quiet"])


def test_ssd_chunk_grad_finite_at_the_published_chunk():
    """At the published chunk of 256 the decay's exponent above the
    diagonal passes f32's exp range; the gradients stay finite (the plain
    version masks the exponent, not its result) and the outputs equal the
    reference's chunk at 2e-4."""
    rng = np.random.default_rng(8)
    bh, c, P, N = 4, 256, 16, 16
    x = rng.standard_normal((bh, c, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, c)) + 1.0)) \
        .astype(np.float32)
    A = (-np.exp(rng.standard_normal(bh) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((bh, c, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((bh, c, N)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((bh, P, N)) * 0.1).astype(np.float32)
    assert float(-(dt * A[:, None]).sum(1).max()) > 88.0     # exp overflows
    ins = [torch.tensor(a, requires_grad=True) for a in (x, dt, A, B, C, s0)]
    y, s = t_ssd.ssd_chunk_grad(*ins)
    (y.sum() + s.sum()).backward()
    for t in ins:
        assert torch.isfinite(t.grad).all()
    from repro.kernels import ref as r_ref
    y_r, s_r = r_ref.ssd_chunk_ref(*map(jnp.asarray, (x, dt, A, B, C, s0)))
    _close(y.detach(), y_r, MOD_TOL)
    _close(s.detach(), s_r, MOD_TOL)
