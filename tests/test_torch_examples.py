"""The port's entry points (``repro_torch.examples``, ``repro_torch.tools.
trace_smoke``) against the reference's scripts, on the CPU:

* the **unchanged** ``examples/multiwafer_microcircuit.py`` runs in one
  4-device reference subprocess, ``torus3d ethernet`` and ``alltoall
  extoll``; a spy on its ``build_sharded_sim`` keeps the initial state and
  the stats, and the background drive is replayed from the reference's key
  chain (``PRNGKey(s + seed * 1000 + 7)``, as ``test_torch_sim.py``).  The
  port's ``main`` runs from that state and drive, and its printout must
  equal the reference's line for line (every integer, the mean rate, the
  latency to the printed digits), its own wall-time line aside; every
  integer ``WindowStats`` / ``LinkStats`` field must equal too;
* quickstart: the aggregation, cycle-model and routing printout equal to
  the reference's ``spike_aggregation_demo`` / ``routing_demo`` with the
  reference's ``jax.random`` draws injected; the tiny LM's 10 losses at
  1e-2 relative against the reference's jitted step on ``_stable_init``
  parameters carried across by ``repro_torch.convert``;
* ``serve_lm``: the tokens against the reference engine's under the margin
  replay of ``test_torch_models.py``;
* ``train_100m``: ``config_100m()`` field for field and its parameter
  count, and a 10-step CPU run of the entry point (the loss falls, a
  checkpoint lands in the given directory);
* the trace smoke exits 0, and a planted fault (a truncated ``trace.json``,
  a window missing from ``recorder.jsonl``) makes it exit non-zero;
* every entry point raises without ``--device cpu`` on a host without a
  card, and none imports JAX.
"""
import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_helper import SRC, run_md
from repro.configs import get_config as r_get_config, reduced as r_reduced
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import synthetic_batch as r_synthetic_batch
from repro.models import build as r_build
from repro.models.modules import param_count as r_param_count
from repro.models.transformer import Runtime as RRuntime
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeConfig as RServeConfig
from repro.train import optimizer as r_opt, step as r_step
from repro_torch import convert
from repro_torch.examples import multiwafer_microcircuit as t_mwm
from repro_torch.examples import quickstart as t_qs
from repro_torch.examples import serve_lm as t_serve
from repro_torch.examples import train_100m as t_train
from repro_torch.models import build
from repro_torch.models.modules import param_count
from repro_torch.tools import trace_smoke
from test_torch_models import (_replay_margins, _stable_init,
                               assert_greedy_matches)

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = os.path.join(ROOT, "examples")
SEED = 0
CASES = {"torus3d-ethernet": ("torus3d", "ethernet"),
         "alltoall-extoll": ("alltoall", "extoll")}
LM_RTOL = 1e-2
EMBED_SCALE = 0.25      # the blocks, not the tied embedding, pick tokens
MIN_DECISIVE = 40       # serve_lm tokens the margin replay must compare


def load_reference(name: str):
    """A reference script of ``examples/`` as a module (its ``__main__``
    block does not run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# The microcircuit example.
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import contextlib, importlib.util, io
import numpy as np, jax, jax.numpy as jnp
from repro.snn import lif, simulator as sim

out = {}
def flat(tree, prefix):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            flat(getattr(tree, f), prefix + f + ".")
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)     # numpy before any indexing

spec = importlib.util.spec_from_file_location("ref_mwm", %(PATH)r)
ex = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ex)

seen = {}
real = sim.build_sharded_sim
def spy(*args, **kw):
    init, run = real(*args, **kw)
    seen["cfg"], seen["part"] = args[2], args[3]
    def init_spy(seed=0):
        seen["seed"], seen["state"] = seed, init(seed=seed)
        return seen["state"]
    def run_spy(state, n):
        seen["n"] = n
        seen["out"] = run(state, n)
        return seen["out"]
    return init_spy, run_spy
sim.build_sharded_sim = spy

for name, (transport, fmt) in %(CASES)r.items():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ex.main(transport, fmt)
    out[name + ".stdout"] = np.array(buf.getvalue())
    flat(seen["state"], name + ".init.")
    flat(seen["out"][1], name + ".stats.")

# the background drive, replayed from the simulator's own key chain
cfg, part, seed, NW = seen["cfg"], seen["part"], seen["seed"], seen["n"]
S, per = cfg.n_shards, cfg.per_shard
rates = ex.mc.MicrocircuitSpec(scale=0.004).bg_rates()
bg = np.pad(rates, (0, part.n_neurons - len(rates))).reshape(S, per)

@jax.jit
def draws(key, rate):
    def step(k, _):
        k, sub = jax.random.split(k)
        return k, lif.poisson_input(sub, per, rate, 87.8, cfg.params.dt)
    return jax.lax.scan(step, key, None, length=NW * cfg.window)[1]

drive = np.stack([np.asarray(draws(jax.random.PRNGKey(s + seed * 1000 + 7),
                                   jnp.asarray(bg[s]))) for s in range(S)])
out["drive"] = drive.reshape(S, NW, cfg.window, per).transpose(1, 2, 0, 3)
np.savez(%(OUT)r, **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "mwm.npz")
    out = run_md(REF_SCRIPT % dict(
        PATH=os.path.join(EXAMPLES, "multiwafer_microcircuit.py"),
        CASES=CASES, OUT=path), n_devices=4)
    assert "REF_OK" in out
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def port_runs(ref):
    """The port's entry point on the CPU from the reference's initial state
    and drive: {case: (printed lines, flattened stats)}."""
    import contextlib
    import io
    net = t_mwm.build_network()
    runs = {}
    for name, (transport, fmt) in CASES.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = t_mwm.main(
                transport, fmt, net=net,
                state=convert.state_from_reference(
                    ref, prefix=f"{name}.init.", device="cpu"),
                drive=torch.from_numpy(ref["drive"]), device="cpu")
        runs[name] = (buf.getvalue().splitlines(),
                      convert.flatten(result.stats))
    return runs


@pytest.mark.parametrize("name", list(CASES))
def test_microcircuit_printout_equals_reference(ref, port_runs, name):
    """Line for line: integers, the mean rate and the latency to the
    printed digits; the port's one extra line is its wall time."""
    want = str(ref[f"{name}.stdout"]).splitlines()
    lines, _ = port_runs[name]
    walls = [line for line in lines if line.startswith("wall: ")]
    assert len(walls) == 1 and walls[0].endswith("on CPU"), walls
    got = [line for line in lines if not line.startswith("wall: ")]
    assert got == want
    assert want[-1] == "ok." and "deadline misses: 0" in "\n".join(want)
    assert int(ref[f"{name}.stats.spikes"].sum()) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_microcircuit_window_stats_equal_reference(ref, port_runs, name):
    """Every integer WindowStats / LinkStats field of every window; the
    latency digests at rtol 1e-6 (``test_torch_sim.py``)."""
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
            assert (got[key] == want).all(), key


def test_microcircuit_sizes_and_network():
    """The reference's buffers at its scale, the full width's from
    ``WIDE_FROM``; the partition as the reference builds it."""
    net = t_mwm.build_network()
    cfg = t_mwm.sim_config(net, "torus3d", "ethernet")
    assert (cfg.e_max, cfg.capacity, cfg.residue) == (512, 512, 256)
    assert (cfg.transport, cfg.wire_format, cfg.link_credits) == (
        "torus3d", "ethernet", 0)
    assert (cfg.window, cfg.ring_len, cfg.n_shards) == (8, 32, 4)
    wide = t_mwm.Network(dataclasses.replace(net.spec, scale=0.2),
                         net.n_synapses, net.part)
    assert t_mwm.sim_config(wide).capacity == 1024
    with pytest.raises(ValueError, match="transport"):
        t_mwm.main("torus4d", net=net, device="cpu")


# ---------------------------------------------------------------------------
# Quickstart.
# ---------------------------------------------------------------------------

def test_quickstart_fabric_demos_equal_reference(capsys):
    """Aggregation, the cycle model and the routing demo print what the
    reference's print, on the reference's own draws."""
    r_qs = load_reference("quickstart")
    r_qs.spike_aggregation_demo()
    r_qs.routing_demo()
    want = capsys.readouterr().out
    key = jax.random.PRNGKey(0)
    addr = np.asarray(jax.random.randint(key, (256,), 0, 64))
    deadline = np.asarray(jax.random.randint(jax.random.fold_in(key, 1),
                                             (256,), 50, 200))
    buckets, (state, out) = t_qs.spike_aggregation_demo(addr, deadline,
                                                        device="cpu")
    t_qs.routing_demo(device="cpu")
    assert capsys.readouterr().out == want
    assert int(out.sent_count.sum()) > 0 and int(buckets.counts.sum()) == 256


def test_quickstart_default_draws_and_main(capsys):
    """The port's own draws come from ``default_rng(0)``; ``main`` runs the
    four demos and ends ``done.``."""
    rng = np.random.default_rng(0)
    addr, deadline = t_qs.draw_window()
    assert (addr == rng.integers(0, 64, 256)).all()
    assert (deadline == rng.integers(50, 200, 256)).all()
    t_qs.main(device="cpu")
    text = capsys.readouterr().out
    assert text.endswith("done.\n") and text.count("  step ") == 4


def test_quickstart_tiny_lm_losses_match_reference(capsys):
    cfg = r_reduced(r_get_config("qwen3_32b"))
    model = r_build(cfg)
    params = _stable_init(model.specs(), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = r_step.TrainConfig(optimizer=r_opt.OptimizerConfig(
        schedule=r_opt.ScheduleConfig(kind="cosine", peak_lr=2e-3,
                                      warmup_steps=3, total_steps=30)))
    state = {"params": params, "opt": r_opt.init_opt(params, tcfg.optimizer),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(r_step.make_train_step(model, tcfg, RRuntime()))
    dcfg = RDataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    want = []
    for i in range(t_qs.LM_STEPS):
        state, metrics = step(state, r_synthetic_batch(dcfg, i))
        want.append(float(metrics["loss"]))
    got = t_qs.tiny_lm_demo(convert.params_from_reference(np_params,
                                                          device="cpu"),
                            device="cpu")
    np.testing.assert_allclose(got, want, rtol=LM_RTOL)
    assert want[-1] < want[0]
    assert capsys.readouterr().out.count("  step ") == 4


# ---------------------------------------------------------------------------
# serve_lm.
# ---------------------------------------------------------------------------

def test_serve_lm_tokens_match_reference(capsys):
    """The example's 10 requests through 4 slots: the reference engine's
    tokens on ``_stable_init`` weights, replayed for their top-2 margins,
    against the port's entry point on the same weights."""
    cfg = r_reduced(r_get_config("gemma2_9b"), layers=4)
    model = r_build(cfg)
    params = _stable_init(model.specs(), jax.random.PRNGKey(0))
    params["embed"] = params["embed"] * EMBED_SCALE
    scfg = RServeConfig(**t_serve.SERVE)
    # the reference example's own draws (examples/serve_lm.py)
    rng = np.random.default_rng(0)
    reqs = [RRequest(rid=i, prompt=rng.integers(
        3, cfg.vocab, size=rng.integers(4, 12)).astype(np.int32))
        for i in range(10)]
    assert all((a.prompt == b.prompt).all() for a, b in
               zip(reqs, t_serve.requests(cfg.vocab)))
    eng = REngine(model, scfg)
    want = eng.generate_batch(params, reqs)
    margins = _replay_margins(eng, model, params, reqs, want, scfg)
    got = t_serve.main(convert.params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"),
        device="cpu")
    assert_greedy_matches(got, want, margins, MIN_DECISIVE)
    text = capsys.readouterr().out
    assert text.count("  req ") == 10 and "tok/s on CPU)" in text
    assert "4L d64" in text


# ---------------------------------------------------------------------------
# train_100m.
# ---------------------------------------------------------------------------

def test_config_100m_equals_reference():
    want = load_reference("train_100m").config_100m()
    got = t_train.config_100m()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    n = param_count(build(got).specs())
    assert n == r_param_count(r_build(want).specs())
    assert 50e6 < n < 150e6


def test_train_100m_runs_on_cpu(tmp_path, capsys):
    """10 steps of the entry point on the CPU: two logged steps, the loss
    falls, the step-10 checkpoint lands in ``--ckpt-dir``."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    history = t_train.main(["--steps", "10", "--batch", "1", "--seq", "8",
                            "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in history] == [1, 10]
    assert history[-1]["loss"] < history[0]["loss"]
    assert Checkpointer(str(tmp_path)).latest_step() == 10
    text = capsys.readouterr().out
    assert "on CPU" in text and "checkpoints in" in text
    # the port's default directory is its own: the format is shared
    assert "repro_torch" in os.path.basename(t_train.DEFAULT_CKPT_DIR)


# ---------------------------------------------------------------------------
# The trace smoke.
# ---------------------------------------------------------------------------

def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_trace_smoke_passes_on_cpu(tmp_path, capsys):
    docs = os.path.join(ROOT, "docs", "observability_trace.json")
    before = _sha(docs)
    artifact = tmp_path / "trace_copy.json"
    assert trace_smoke.main(["--device", "cpu", "--out-dir",
                             str(tmp_path / "run"), "--artifact",
                             str(artifact)]) == 0
    assert "trace-smoke OK on CPU" in capsys.readouterr().out
    assert json.loads(artifact.read_text())["traceEvents"]
    assert _sha(docs) == before


def _truncate_trace(run_dir: str) -> None:
    path = os.path.join(run_dir, "trace.json")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text[: len(text) // 2])


def _drop_traced_window(run_dir: str) -> None:
    """Remove from recorder.jsonl the rows of a window the trace marks."""
    with open(os.path.join(run_dir, "trace.json")) as f:
        marked = {int(ev["args"]["window"]) for ev in
                  json.load(f)["traceEvents"] if ev.get("name") == "window"}
    path = os.path.join(run_dir, "recorder.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    gone = min(marked)
    with open(path, "w") as f:
        for row in rows:
            if int(row["window"]) != gone:
                f.write(json.dumps(row) + "\n")


@pytest.mark.parametrize("plant,reason", [
    (_truncate_trace, "trace.json unreadable"),
    (_drop_traced_window, "correlation: trace windows")])
def test_trace_smoke_fails_on_a_planted_fault(tmp_path, monkeypatch, plant,
                                              reason):
    real = trace_smoke.obs_report.write_engine_run

    def write_then_break(*args, **kw):
        run_dir = real(*args, **kw)
        plant(run_dir)
        return run_dir

    monkeypatch.setattr(trace_smoke.obs_report, "write_engine_run",
                        write_then_break)
    with pytest.raises(SystemExit) as exc:
        trace_smoke.main(["--device", "cpu", "--out-dir",
                          str(tmp_path / "run")])
    assert exc.value.code not in (0, None)
    assert "trace-smoke FAIL" in str(exc.value.code)
    assert reason in str(exc.value.code)


# ---------------------------------------------------------------------------
# The device policy and the imports.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda tmp: t_mwm.cli([]),
    lambda tmp: t_mwm.cli(["torus3d", "ethernet"]),
    lambda tmp: t_qs.cli([]),
    lambda tmp: t_serve.cli([]),
    lambda tmp: t_train.main(["--steps", "1", "--ckpt-dir", str(tmp)]),
    lambda tmp: trace_smoke.main(["--out-dir", str(tmp)])],
    ids=["microcircuit", "microcircuit-torus3d", "quickstart", "serve_lm",
         "train_100m", "trace_smoke"])
def test_entry_points_need_a_card_by_default(call, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(tmp_path)
    assert not any(tmp_path.iterdir())


def test_entry_points_import_no_jax():
    code = ("import sys, repro_torch.examples.multiwafer_microcircuit, "
            "repro_torch.examples.quickstart, repro_torch.examples.serve_lm, "
            "repro_torch.examples.train_100m, repro_torch.tools.trace_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=SRC))
