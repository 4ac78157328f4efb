"""Port vs reference for the distributed slice, on the CPU.

The reference's mesh paths run once per module in one subprocess with 8
forced host devices (``md_helper.run_md``), on meshes built with Auto
axis types (jax 0.9.0's ``jax.make_mesh`` builds Explicit axes, under
which the reference's ``with_sharding_constraint`` raises); its outputs
are saved as ``.npz``.  The port lays each mesh axis out as a leading
tensor dimension (``launch.mesh.Mesh``, virtual).

* split-KV decode (``distributed.collectives``) against the reference's
  ``split_kv_decode_attention`` in ``shard_map`` over 4 shards (B 2, T 64,
  Hq 8, Hkv 2, D 16): cache_len 50, then 10 (shards 1-3 hold no valid
  slot), with a window and with a softcap and query scale, at 2e-4;
* ``_moe_bucket_sharded`` against the reference's on a 1x4 mesh (and a
  2x2 one) for the reduced deepseek-moe-16b's MoE layer in f32: the
  tokens sequence-split (``seq_axis="model"``) and replicated
  (``seq_axis=None``), at 2e-4, the stats equal; on 2x2 the reference's
  ``out_specs=P()`` returns data rank 0's stats, which the port returns;
* ``flash_attention(gqa="group")`` against the reference's, forward and
  the gradients of q, k and v, at 2e-4;
* ``compressed_psum`` on 4 distinct parties: the int8 payloads, scales
  and the int32 sum bit for bit, the mean and the residuals at 1e-6
  relative; the tree-level all-reduce of replicated parties within the
  reference test's bounds; against a numpy formula;
* ``pipelined_all_to_all`` bit for bit;
* the reduced dense (qwen3, gemma2 with 2 KV heads) and MoE (deepseek)
  models under the reference's mesh runtimes (context-parallel forward on
  1x4, split-KV decode on 1x4) against the port's at the model tolerance
  5e-2;
* port-only: ``shard_batch`` divisibility, an elastic restore bit for bit,
  ``launch/train.py --mesh 2x4`` losses equal to the mesh-free run's.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from md_helper import run_md  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import compression as Q  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_test_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-4                  # the reference's collective tests
MODEL_TOL = 5e-2            # the reference's model tolerance
SPLIT_CASES = {             # cache_len, window, softcap, scale
    "len50": (50, 0, 0.0, None),
    "len10_empty_shards": (10, 0, 0.0, None),
    "len50_window20": (50, 20, 0.0, None),
    "len50_softcap": (50, 0, 30.0, 0.125),
}
MOE_CASES = {               # mesh (data, model), seq_axis
    "1x4_seq": ((1, 4), "model"),
    "1x4_replicated": ((1, 4), None),
    "2x2_seq": ((2, 2), "model"),
}
GQA_CASES = {               # window, softcap, chunk
    "causal": (0, 0.0, 8),
    "window_softcap": (6, 20.0, 5),
}
MODEL_ARCHS = ("qwen3_32b", "gemma2_9b", "deepseek_moe_16b")
MAX_FLIPPED_TOKENS = 2      # one routing flip: its token and the one whose
                            # capacity slot it takes or frees

REF_SCRIPT = r"""
import sys, dataclasses, zlib
sys.path.insert(0, %(tests)r)
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import AxisType, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_config, reduced
from repro.distributed import collectives as C
from repro.distributed import compression as Q
from repro.models import attention as A, build, transformer as T
from test_torch_models import _stable_init

def mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

out = {}
rng = np.random.default_rng(0)
f32 = lambda *s: rng.standard_normal(s).astype(np.float32)

# split-KV decode over 4 shards
m4 = mesh((4,), ("model",))
q, k, v = f32(2, 1, 8, 16), f32(2, 64, 2, 16), f32(2, 64, 2, 16)
out.update(skv_q=q, skv_k=k, skv_v=v)
for name, (clen, win, cap, scale) in %(split)r.items():
    fn = shard_map(
        partial(C.split_kv_decode_attention, axis_name="model", scale=scale,
                window=win, softcap=cap),
        mesh=m4, in_specs=(P(), P(None, "model", None, None),
                           P(None, "model", None, None), P()),
        out_specs=P(), check_rep=False)
    out["skv_" + name] = np.asarray(fn(q, k, v, jnp.asarray(clen)))

# the sharded MoE dispatch, reduced deepseek, f32
cfg = reduced(get_config("deepseek_moe_16b"))
d, E, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.expert_ff
mp = {"router": f32(d, E) * 0.3, "w_gate": f32(E, d, f) / np.sqrt(d),
      "w_up": f32(E, d, f) / np.sqrt(d), "w_down": f32(E, f, d) / np.sqrt(f)}
B, S = 2, 8
x = f32(B * S, d)
out.update(moe_x=x, **{"moe_" + k: v for k, v in mp.items()})
for name, (shape, seq) in %(moe)r.items():
    m = mesh(shape, ("data", "model"))
    rt = T.Runtime(mesh=m, batch_axes=("data",), moe_impl="bucket",
                   seq_axis=seq)
    y, st = T._moe_bucket_sharded(jnp.asarray(x), mp, cfg, rt, B, S)
    out["moe_y_" + name] = np.asarray(y)
    out["moe_st_" + name] = np.asarray([float(st.aux_loss),
                                        float(st.router_z),
                                        float(st.dropped)])

# flash attention, group GQA, forward and gradients
qa, ka, va, ga = f32(2, 12, 8, 16), f32(2, 12, 2, 16), f32(2, 12, 2, 16), \
    f32(2, 12, 8, 16)
out.update(gqa_q=qa, gqa_k=ka, gqa_v=va, gqa_g=ga)
for name, (win, cap, chunk) in %(gqa)r.items():
    f = lambda q, k, v: A.flash_attention(q, k, v, window=win, softcap=cap,
                                          chunk=chunk, gqa="group")
    o, vjp = jax.vjp(f, qa, ka, va)
    out["gqa_o_" + name] = np.asarray(o)
    for n, gr in zip("qkv", vjp(jnp.asarray(ga))):
        out[f"gqa_d{n}_" + name] = np.asarray(gr)

# int8 error-feedback all-reduce: 4 distinct parties
mp4 = mesh((4,), ("pod",))
g4 = f32(4, 64, 32)
e4 = f32(4, 64, 32) * 0.01
out.update(cmp_g=g4, cmp_e=e4)
qs, ss, es = zip(*(Q.quantize(jnp.asarray(g4[i]), jnp.asarray(e4[i]))
                   for i in range(4)))
out["cmp_q"] = np.stack([np.asarray(t) for t in qs])
out["cmp_scale"] = np.asarray([np.asarray(t) for t in ss])
fn = shard_map(lambda g, e: Q.compressed_psum(g[0], e[0], ("pod",)),
               mesh=mp4, in_specs=(P("pod"), P("pod")),
               out_specs=(P(), P("pod")), check_rep=False)
mean, new_err = fn(jnp.asarray(g4), jnp.asarray(e4))
out["cmp_mean"] = np.asarray(mean)
out["cmp_new_err"] = np.asarray(new_err).reshape(4, 64, 32)
qsum = shard_map(lambda q: jax.lax.psum(q[0].astype(jnp.int32), "pod"),
                 mesh=mp4, in_specs=P("pod"), out_specs=P(),
                 check_rep=False)(jnp.asarray(out["cmp_q"]))
out["cmp_qsum"] = np.asarray(qsum)
ar = Q.make_compressed_allreduce(mp4, ("pod",))
gr = {"w": jnp.asarray(g4[0]), "b": jnp.asarray(g4[1, 0])}
got, e2 = jax.jit(ar)(gr, Q.init_error_feedback(gr))
for key in gr:
    out["cmpr_" + key] = np.asarray(got[key])
    out["cmpr_err_" + key] = np.asarray(e2[key])

# the chunked all-to-all over 4 shards
xa = rng.integers(-2**31, 2**31, (16, 8, 3), dtype=np.int64).astype(np.int32)
fn = shard_map(partial(C.pipelined_all_to_all, axis_name="model", n_chunks=4),
               mesh=m4, in_specs=P("model"), out_specs=P("model"),
               check_rep=False)
out.update(a2a_x=xa, a2a_y=np.asarray(fn(jnp.asarray(xa))))

# the reduced models under the mesh runtimes
m14 = mesh((1, 4), ("data", "model"))
def flat(tree, prefix):
    if isinstance(tree, dict):
        for key, val in tree.items():
            flat(val, prefix + "/" + key)
    else:
        out[prefix] = np.asarray(tree.astype(jnp.float32)) \
            if tree.dtype == jnp.bfloat16 else np.asarray(tree)
for arch in %(archs)r:
    cfg = reduced(get_config(arch))
    if cfg.n_kv_heads == cfg.n_heads:
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    model = build(cfg)
    params = _stable_init(model.specs(), jax.random.PRNGKey(0))
    params["embed"] = params["embed"] * 0.25
    flat(params, "model_" + arch)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    out[f"model_{arch}_tokens"], out[f"model_{arch}_nxt"] = toks, nxt
    cp = T.Runtime(mesh=m14, batch_axes=("data",), seq_axis="model",
                   moe_impl="bucket")
    h, aux = jax.jit(lambda p, t: model.hidden(p, {"tokens": t}, cp))(
        params, toks)
    out[f"model_{arch}_hidden_cp"] = np.asarray(h.astype(jnp.float32))
    out[f"model_{arch}_aux_cp"] = np.asarray(aux)
    caches = model.init_caches(2, 40)
    _, caches = model.prefill(params, {"tokens": jnp.asarray(toks)}, caches)
    skv = T.Runtime(mesh=m14, batch_axes=("data",), split_kv_axis="model")
    logits, _ = jax.jit(lambda p, c, t: model.decode(p, c, t, skv))(
        params, caches, nxt)
    out[f"model_{arch}_logits_skv"] = np.asarray(logits)
np.savez(%(path)r, **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist") / "ref.npz")
    out = run_md(REF_SCRIPT % dict(
        tests=os.path.dirname(os.path.abspath(__file__)), split=SPLIT_CASES,
        moe=MOE_CASES, gqa=GQA_CASES, archs=MODEL_ARCHS, path=path),
        n_devices=8, timeout=900)
    assert "REF_OK" in out
    return dict(np.load(path))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_kv_decode_matches_reference(ref, case):
    """The cache split into 4 shards of 16 slots as a leading dimension;
    at cache_len 10 shards 1-3 hold no valid slot, and only the combine's
    exp(m - m_max) = 0 (finite NEG_INF) removes them."""
    clen, win, cap, scale = SPLIT_CASES[case]
    k = _t(ref["skv_k"]).unflatten(1, (4, 16)).movedim(1, 0)
    v = _t(ref["skv_v"]).unflatten(1, (4, 16)).movedim(1, 0)
    got = C.split_kv_decode_attention(
        _t(ref["skv_q"]), k, v, torch.tensor(clen), scale=scale,
        window=win, softcap=cap)
    assert got.shape == (2, 1, 8, 16) and torch.isfinite(got).all()
    _close(got, ref["skv_" + case])


def test_split_kv_decode_equals_unsplit_decode_attention():
    """Split-KV over 4 shards == ``decode_attention`` over the whole
    cache (linear, windowed and not), at 2e-4."""
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((2, 1, 8, 16)).astype(np.float32))
    k = _t(rng.standard_normal((2, 64, 2, 16)).astype(np.float32))
    v = _t(rng.standard_normal((2, 64, 2, 16)).astype(np.float32))
    for clen, win in ((50, 0), (10, 0), (64, 24)):
        cache = A.KVCache(k, v, torch.tensor(clen, dtype=torch.int32))
        want = A.decode_attention(q, cache, window=win)
        got = C.split_kv_decode_attention(
            q, k.unflatten(1, (4, 16)).movedim(1, 0),
            v.unflatten(1, (4, 16)).movedim(1, 0), cache.length, window=win)
        _close(got, want)


def test_pipelined_all_to_all_bit_for_bit(ref):
    x = _t(ref["a2a_x"]).view(4, 4, 8, 3)
    got = C.pipelined_all_to_all(x, 4)
    assert torch.equal(got.reshape(16, 8, 3), _t(ref["a2a_y"]))
    assert torch.equal(got, x.transpose(0, 1))
    with pytest.raises(ValueError, match="multiple"):
        C.pipelined_all_to_all(x, 3)


@pytest.mark.parametrize("case", GQA_CASES)
def test_flash_attention_group_gqa_matches_reference(ref, case):
    """``gqa="group"`` (Q viewed as (Hkv, G), K/V never expanded) against
    the reference's, forward and the gradients of q, k and v, and equal
    to the expand route's."""
    win, cap, chunk = GQA_CASES[case]
    q, k, v = (_t(ref["gqa_" + n]).requires_grad_() for n in "qkv")
    o = A.flash_attention(q, k, v, window=win, softcap=cap, chunk=chunk,
                          gqa="group")
    grads = torch.autograd.grad(o, (q, k, v), _t(ref["gqa_g"]))
    _close(o.detach(), ref["gqa_o_" + case])
    for n, g in zip("qkv", grads):
        _close(g, ref[f"gqa_d{n}_" + case])
    expand = A.flash_attention(q, k, v, window=win, softcap=cap, chunk=chunk)
    _close(o.detach(), expand.detach())


# ---------------------------------------------------------------------------
# the sharded MoE dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_bucket_sharded_matches_reference(ref, case):
    shape, seq = MOE_CASES[case]
    cfg = reduced(get_config("deepseek_moe_16b"))
    rt = T.Runtime(mesh=Mesh(shape, ("data", "model")), batch_axes=("data",),
                   moe_impl="bucket", seq_axis=seq)
    mp = {k: _t(ref["moe_" + k]) for k in ("router", "w_gate", "w_up",
                                           "w_down")}
    y, st = T._moe_bucket_sharded(_t(ref["moe_x"]), mp, cfg, rt, 2, 8)
    _close(y, ref["moe_y_" + case])
    _close(torch.stack(list(st)), ref["moe_st_" + case], 1e-6)


def test_moe_bucket_sharded_replicated_tokens_count_all_in_capacity():
    """With seq_axis None every EP rank routes all of its data slice's
    tokens (the capacity counts them all); split over the sequence each
    rank buckets a quarter, so a tight capacity drops more."""
    cfg = reduced(get_config("deepseek_moe_16b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
    rng = np.random.default_rng(2)
    d, E, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.expert_ff
    mp = {"router": _t(rng.standard_normal((d, E)).astype(np.float32)),
          **{k: _t(rng.standard_normal(s).astype(np.float32) * 0.1)
             for k, s in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                          ("w_down", (E, f, d)))}}
    x = _t(rng.standard_normal((4 * 16, d)).astype(np.float32))
    mesh = Mesh((1, 4), ("data", "model"))
    rep = T._moe_bucket_sharded(x, mp, cfg, T.Runtime(
        mesh=mesh, moe_impl="bucket"), 4, 16)
    from repro_torch.models import moe as M
    local = M.moe_layer_local(x, mp, cfg.moe)
    _close(rep[0], local[0])            # one rank's routing of all tokens
    _close(torch.stack(list(rep[1])), torch.stack(list(local[1])), 1e-6)
    assert float(local[1].dropped) > 0
    with pytest.raises(ValueError, match="sequence"):
        T._moe_bucket_sharded(x[:48], mp, cfg, T.Runtime(
            mesh=mesh, moe_impl="bucket", seq_axis="model"), 8, 6)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_compressed_psum_matches_reference(ref):
    g, e = _t(ref["cmp_g"]), _t(ref["cmp_e"])
    q, scale, _ = Q.quantize(g, e)
    assert torch.equal(q, _t(ref["cmp_q"]))
    assert torch.equal(scale, _t(ref["cmp_scale"]))
    q_sum = q.to(torch.int32).sum(dim=0, dtype=torch.int32)
    assert torch.equal(q_sum, _t(ref["cmp_qsum"]))
    mean, new_err = Q.compressed_psum(g, e)
    _close(mean, ref["cmp_mean"], 1e-6)
    _close(new_err, ref["cmp_new_err"], 1e-6)
    # the numpy formula: int32 sum x mean scale / n, residual g + e - deq
    g32 = ref["cmp_g"] + ref["cmp_e"]
    s = np.abs(g32).reshape(4, -1).max(1) / np.float32(127.0) \
        + np.float32(1e-12)
    qn = np.clip(np.round(g32 / s[:, None, None]), -127, 127)
    np.testing.assert_array_equal(qn.astype(np.int8), q.numpy())
    want = qn.sum(0) * (s.sum() / 4) / 4
    _close(mean, want, 1e-6)
    _close(new_err, g32 - qn * s[:, None, None], 1e-6)


def test_compressed_allreduce_tree_matches_reference(ref):
    """Replicated parties (the reference's ``P()`` inputs): the mean
    within the reference test's bounds of the input, the residual within
    scale / 127; equal to the reference's."""
    ar = Q.make_compressed_allreduce(Mesh((4,), ("pod",)), ("pod",))
    g = {"w": _t(ref["cmp_g"][0]), "b": _t(ref["cmp_g"][1, 0])}
    got, err = ar(g, Q.init_error_feedback(g))
    for key in g:
        scale = float(g[key].abs().max())
        assert float((got[key] - g[key]).abs().max()) <= \
            scale / 127.0 * 1.5 + 1e-6
        assert float(err[key].abs().max()) <= scale / 127.0 + 1e-6
        _close(got[key], ref["cmpr_" + key], 1e-6)
        _close(err[key], ref["cmpr_err_" + key], 1e-6)


# ---------------------------------------------------------------------------
# the reduced models under the mesh runtimes
# ---------------------------------------------------------------------------

def _reduced_model(ref, arch):
    cfg = reduced(get_config(arch))
    if cfg.n_kv_heads == cfg.n_heads:
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    prefix = f"model_{arch}/"
    tree: dict = {}
    for key, val in ref.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = val
    return build(cfg), convert.params_from_reference(tree, device="cpu")


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_reduced_model_context_parallel_forward_matches_reference(ref,
                                                                  arch):
    """The forward under ``Runtime(mesh 1x4, seq_axis="model",
    moe_impl="bucket")``: the group-GQA attention (G = 2) and, for
    deepseek, the sequence-split bucket dispatch; equal to the port's
    mesh-free forward for the dense models."""
    model, params = _reduced_model(ref, arch)
    toks = _t(ref[f"model_{arch}_tokens"]).long()
    rt = T.Runtime(mesh=make_test_mesh(1, 4), batch_axes=("data",),
                   seq_axis="model", moe_impl="bucket")
    h, aux = model.hidden(params, {"tokens": toks}, rt)
    want = ref[f"model_{arch}_hidden_cp"]
    if model.cfg.moe:
        # a token whose top-k margin lies inside the bf16 noise may route
        # elsewhere: that token (and one whose slot it shifts) is excused
        err = np.abs(h.float().numpy() - want) - MODEL_TOL * np.abs(want)
        bad = (err > MODEL_TOL).any(-1)
        print(f"{arch}: {int(bad.sum())} token rows past {MODEL_TOL}")
        assert bad.sum() <= MAX_FLIPPED_TOKENS
        _close(h.float().numpy()[~bad], want[~bad], MODEL_TOL)
    else:
        _close(h.float(), want, MODEL_TOL)
    _close(aux, ref[f"model_{arch}_aux_cp"], MODEL_TOL)
    if not model.cfg.moe:
        plain, _ = model.hidden(params, {"tokens": toks})
        _close(h.float(), plain.float(), MODEL_TOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_reduced_model_split_kv_decode_matches_reference(ref, arch):
    """One decode step under ``Runtime(mesh 1x4, split_kv_axis="model")``
    after a 24-token prefill into 40-slot caches (4 shards of 10: shard
    3 holds no valid slot)."""
    model, params = _reduced_model(ref, arch)
    toks = _t(ref[f"model_{arch}_tokens"]).long()
    caches = model.init_caches(2, 40, device="cpu")
    _, caches = model.prefill(params, {"tokens": toks}, caches)
    rt = T.Runtime(mesh=make_test_mesh(1, 4), split_kv_axis="model")
    nxt = _t(ref[f"model_{arch}_nxt"]).long()
    logits, _ = model.decode(params, caches, nxt, rt)
    plain, _ = model.decode(params, caches, nxt)
    want = ref[f"model_{arch}_logits_skv"]
    rms = float(np.sqrt((want ** 2).mean()))
    _close(logits / rms, want / rms, MODEL_TOL)
    _close(logits / rms, plain / rms, MODEL_TOL)
    with pytest.raises(ValueError, match="cache length"):
        model.decode(params, model.init_caches(2, 42, device="cpu"), nxt, rt)


# ---------------------------------------------------------------------------
# port-only: placement, restore, the train CLI
# ---------------------------------------------------------------------------

def test_shard_batch_divisibility():
    from repro_torch.data.pipeline import shard_batch
    mesh = make_test_mesh(2, 4)
    batch = {"tokens": torch.arange(24).view(4, 6),
             "labels": torch.arange(24).view(4, 6) + 1}
    got = shard_batch(batch, mesh, device="cpu")
    assert all(torch.equal(got[k], batch[k]) for k in batch)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"tokens": torch.zeros(3, 6)}, mesh, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(batch, make_test_mesh(2, 4, pods=3),
                    batch_axes=("pod", "data"), device="cpu")


def test_elastic_restore_bit_for_bit(tmp_path):
    """A train state saved, then restored in the layouts of a 2x4 and a
    1x8 mesh: the same bits; a layout its mesh does not divide raises."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.train import step as step_lib
    cfg = reduced(get_config("qwen3_32b"))
    model = build(cfg)
    tcfg = step_lib.TrainConfig()
    state = step_lib.init_train_state(
        model, torch.Generator().manual_seed(0), tcfg, "cpu")
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state)
    template = step_lib.abstract_train_state(model, tcfg)
    for mesh in (make_test_mesh(2, 4), make_test_mesh(1, 8)):
        psh = shd.param_shardings(model.specs(), mesh)
        sh = {"params": psh,
              "opt": type(state["opt"])(psh, psh, shd.Sharding(mesh, ())),
              "step": shd.Sharding(mesh, ())}
        got = ck.restore(template, device="cpu", shardings=sh)
        for a, b in zip(shd.tree_leaves(got), shd.tree_leaves(state)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    bad = shd.tree_map(lambda _: shd.Sharding(Mesh((7,), ("model",)),
                                              ("model",)), sh)
    with pytest.raises(ValueError, match="does not divide"):
        ck.restore(template, device="cpu", shardings=bad)


def test_train_cli_mesh_losses_equal_mesh_free(tmp_path):
    """``--mesh 1x4 --moe-impl bucket`` trains reduced deepseek through the
    sharded bucket dispatch under autograd.  The launcher's runtime has no
    ``seq_axis``, so every EP rank holds all of the batch's tokens and
    routes and keeps them as the local dispatch does: the first loss (a
    forward) equals the mesh-free run's bit for bit, and every loss is
    within 1e-3 of it, relative (the bf16 backward sums the replicated
    ranks' router gradients in another order, and Adam's first steps
    amplify that: 1.7e-4 read; an exchange without its transpose moves the
    losses by 5.3e-4 to 2.8e-3).  A dense model reads no mesh axis (the
    batch is only checked to divide, then placed): ``--mesh 2x4`` gives
    the mesh-free losses.  The CLI checks ``--fake-devices``."""
    from repro_torch.launch import train as cli
    hist = {}
    for arch, spec, fake, impl in (("deepseek_moe_16b", None, 0, "local"),
                                   ("deepseek_moe_16b", "1x4", 4, "bucket"),
                                   ("qwen3_32b", None, 0, "local"),
                                   ("qwen3_32b", "2x4", 8, "local")):
        tr = cli.build_trainer(reduced(get_config(arch)), steps=4, batch=4,
                               seq=32, lr=1e-3,
                               ckpt_dir=str(tmp_path / f"{arch}_{spec}"),
                               ckpt_every=100,
                               mesh=cli.parse_mesh(spec, fake),
                               moe_impl=impl, device="cpu")
        hist[arch, spec] = [h["loss"] for h in tr.run(seed=0)[1]]
    free, sharded = hist["deepseek_moe_16b", None], hist["deepseek_moe_16b",
                                                         "1x4"]
    assert len(free) == 4 and sharded[0] == free[0]
    np.testing.assert_allclose(sharded, free, rtol=1e-3, atol=0)
    assert hist["qwen3_32b", None] == hist["qwen3_32b", "2x4"]
    cfg = reduced(get_config("qwen3_32b"))
    with pytest.raises(ValueError, match="fake-devices"):
        cli.parse_mesh("2x4", 4)
    with pytest.raises(ValueError, match="does not divide"):
        cli.build_trainer(cfg, steps=1, batch=3, seq=32,
                          ckpt_dir=str(tmp_path / "odd"), ckpt_every=100,
                          mesh=cli.parse_mesh("2x4"), device="cpu").run()
    assert cli.main(["--arch", "qwen3_32b", "--reduced", "--steps", "2",
                     "--batch", "2", "--seq", "16", "--mesh", "2x1",
                     "--fake-devices", "2", "--ckpt-dir",
                     str(tmp_path / "cli"), "--device", "cpu",
                     "--quiet"]) == 0
