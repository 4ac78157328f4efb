"""Production-mesh dry run (port of ``src/repro/launch/dryrun.py``).

For every (architecture x input shape) cell and both production meshes
(one pod of 16 x 16 and two of 2 x 16 x 16 = 512 devices, virtual:
``launch.mesh``), this driver

  1. builds the step (the train step, prefill or a decode step) at the
     full published widths, its state and inputs as ``meta`` tensors, so
     nothing is allocated;
  2. lays the state out with the sharding rules
     (``distributed.sharding``) and counts each device's share of it
     (``per_chip_state_bytes``, the reference's ``bytes_per_device``),
     against the H100's 80 GB (``fits_hbm``);
  3. runs the step once on ``meta`` under
     ``torch.utils.flop_counter.FlopCounterMode`` and takes the larger of
     the count over the devices and the analytic MODEL_FLOPS
     (``launch.roofline``); the memory term is the state bytes, the
     reference's own floor, read once a step.

No time in the report is measured: the roofline terms are the FLOPs and
bytes over the H100 SXM's datasheet rates.  What the reference takes
from XLA has no torch counterpart and is left out: the compile (the proof
that the sharded program builds), ``memory_analysis()`` (temporaries) and
the collective bytes parsed from the compiled HLO (``coll_bytes`` and
``t_collective`` are None).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--out r.json]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import Mesh, batch_axes, make_production_mesh
from repro_torch.models.model import build
from repro_torch.models.transformer import Runtime
from repro_torch.obs import log as obs_log
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

# ---------------------------------------------------------------------------
# per-arch training policy (what a job config would set)
# ---------------------------------------------------------------------------

def train_policy(cfg: ModelConfig):
    """(TrainConfig, parameter dtype): arctic-480b's f32 Adam moments do
    not fit one pod -> Adafactor, bf16 parameters and momentum."""
    if cfg.name == "arctic-480b":
        ocfg = opt_lib.OptimizerConfig(kind="adafactor",
                                       momentum_dtype="bfloat16")
        return step_lib.TrainConfig(optimizer=ocfg), torch.bfloat16
    return step_lib.TrainConfig(), torch.float32


def make_runtime(mesh: Mesh, *, train: bool, moe_impl: str = "local",
                 seq_axis=None, split_kv: bool = False) -> Runtime:
    """The reference's cell runtime.  ``remat`` is left to the train
    step, which sets it from ``TrainConfig.remat``."""
    return Runtime(
        mesh=mesh,
        batch_axes=batch_axes(mesh),
        moe_impl=moe_impl,
        seq_axis=("model" if train else None) if seq_axis is None
        else seq_axis,
        split_kv_axis="model" if split_kv else None,
        attn_chunk=1024,
        logits_chunk=512,
    )


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors; never allocated)
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract model inputs for one cell (tokens / labels + the modality
    stubs)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        batch = {"tokens": _meta((B, 1), torch.int32)}
    else:
        batch = {"tokens": _meta((B, S), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["positions3"] = _meta((3, B, S), torch.int32)
        batch["vision_embeds"] = _meta((B, cfg.vision_tokens, cfg.d_model),
                                       torch.bfloat16)
    if cfg.family == "audio" and shape.kind != "decode":
        batch["enc_frames"] = _meta((B, cfg.enc_ctx, cfg.d_model),
                                    torch.bfloat16)
    return batch


_BATCH_AXES_MAP = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "positions3": (None, "batch", "seq"),
    "vision_embeds": ("batch", None, "embed"),
    "enc_frames": ("batch", None, None),
}


def batch_shardings(batch: dict, mesh: Mesh) -> dict:
    return {k: shd.array_sharding(_BATCH_AXES_MAP[k][:v.dim()], v.shape,
                                  mesh)
            for k, v in batch.items()}


def cache_shardings(caches_abs, mesh: Mesh):
    """Logical axes of the cache arrays by rank: stacked (L, B, T, H, D)
    KV caches shard batch and sequence / heads; 4-d and 3-d states their
    last dim as ``mlp``; scalars replicate."""
    def one(v):
        nd = v.dim()
        if nd == 0:
            return shd.Sharding(mesh, ())
        axes = [None] * nd
        axes[0] = "layers"
        if nd >= 2:
            axes[1] = "batch"
        if nd == 5:
            axes[2], axes[3], axes[4] = "seq", "kv_heads", "head_dim"
        elif nd == 4:
            axes[2], axes[3] = None, "mlp"
        elif nd == 3:
            axes[2] = "mlp"
        return shd.array_sharding(tuple(axes), v.shape, mesh)

    return shd.tree_map(one, caches_abs)


def _meta_caches(model, shape: ShapeConfig):
    return model.init_caches(shape.global_batch, shape.seq_len,
                             device="meta")


# ---------------------------------------------------------------------------
# cell builders: (fn, abstract args, shardings, model)
# ---------------------------------------------------------------------------

def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                     moe_impl: str = "local", seq_axis=None):
    model = build(cfg)
    tcfg, pdtype = train_policy(cfg)
    rt = make_runtime(mesh, train=True, moe_impl=moe_impl, seq_axis=seq_axis)
    pspecs = shd.param_shardings(model.specs(), mesh)
    train_step = step_lib.make_train_step(model, tcfg, rt)
    state_abs = step_lib.abstract_train_state(model, tcfg, pdtype)
    # moments / master share the parameter tree's shardings leaf for leaf
    state_sh = {
        "params": shd.like_tree(pspecs, state_abs["params"]),
        "opt": _opt_shardings(state_abs["opt"], pspecs, mesh),
        "step": shd.Sharding(mesh, ()),
    }
    batch = input_specs(cfg, shape)
    return (train_step, (state_abs, batch),
            (state_sh, batch_shardings(batch, mesh)), model)


def _opt_shardings(opt_abs, pspecs, mesh: Mesh):
    """Moments mirror the parameters; factored statistics and the step
    count replicate."""
    rep = shd.Sharding(mesh, ())

    def walk(abs_node, spec_node):
        if isinstance(abs_node, dict):
            return {k: walk(abs_node[k], spec_node[k]) for k in abs_node}
        if (isinstance(spec_node, shd.Sharding)
                and abs_node.dim() == len(spec_node.spec)):
            return spec_node
        return rep

    reps = {}
    for f in opt_abs._fields:            # AdamWState / AdafactorState
        sub = getattr(opt_abs, f)
        if f in ("m", "v") and isinstance(sub, dict):
            reps[f] = walk(sub, pspecs)
        elif isinstance(sub, dict):
            reps[f] = shd.tree_map(lambda _: rep, sub)
        else:
            reps[f] = rep
    return type(opt_abs)(**reps)


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                       moe_impl: str = "local", rules=None):
    model = build(cfg)
    # prefill is long-sequence: the sequence-parallel residual and (MoE)
    # the sequence-split bucket dispatch apply as in training
    rt = make_runtime(mesh, train=False, moe_impl=moe_impl,
                      seq_axis="model")
    pspecs = shd.param_shardings(model.specs(), mesh, rules)
    params_abs = model.abstract(torch.bfloat16)
    caches_abs = _meta_caches(model, shape)
    batch = input_specs(cfg, shape)
    fn = lambda p, b, c: model.prefill(p, b, c, rt)
    return (fn, (params_abs, batch, caches_abs),
            (pspecs, batch_shardings(batch, mesh),
             cache_shardings(caches_abs, mesh)), model)


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                      moe_impl: str = "local", rules=None,
                      split_kv: bool = False):
    model = build(cfg)
    rt = make_runtime(mesh, train=False, moe_impl=moe_impl,
                      split_kv=split_kv)
    pspecs = shd.param_shardings(model.specs(), mesh, rules)
    params_abs = model.abstract(torch.bfloat16)
    caches_abs = _meta_caches(model, shape)
    tokens = _meta((shape.global_batch, 1), torch.int32)
    tsh = shd.array_sharding(("batch", None), tokens.shape, mesh)
    fn = lambda p, c, t: model.decode(p, c, t, rt)
    return (fn, (params_abs, caches_abs, tokens),
            (pspecs, cache_shardings(caches_abs, mesh), tsh), model)


# ---------------------------------------------------------------------------

def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("skip: pure full-attention arch at 524288-token KV -- "
                "quadratic-attention cell excluded, as in the reference")
    return None


def count_flops(fn, args) -> int:
    """FLOPs of ``fn(*args)`` on ``meta`` tensors (matmuls and
    attention-like products, as ``FlopCounterMode`` counts them)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             moe_impl: str = "local", seq_axis=None, verbose: bool = True,
             serve_rules: bool = False, split_kv: bool = False,
             shape: ShapeConfig | None = None,
             mesh: Mesh | None = None, cfg: ModelConfig | None = None):
    """One cell's report (a dict; ``status`` ok or skipped).
    ``serve_rules``: prefill and decode cells lay their parameters out by
    ``SERVE_RULES`` (resident weights, ``embed`` unsplit), recorded as the
    report's ``rules``.  ``shape``, ``mesh`` and ``cfg`` override the
    named shape, the production mesh and the architecture's config (e.g. a
    cut depth)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    report = {"arch": arch, "shape": shape.name, "mesh": str(mesh),
              "moe_impl": moe_impl,
              "rules": "serve" if serve_rules else "default"}
    skip = cell_skip_reason(cfg, shape)
    if skip:
        report["status"] = "skipped"
        report["reason"] = skip
        return report

    chips = mesh.size
    t0 = time.perf_counter()
    rules = shd.SERVE_RULES if serve_rules else None
    # the bucket dispatch applies to token-heavy shapes; decode payloads
    # are tiny
    if shape.kind == "decode" and moe_impl == "bucket":
        moe_impl = "local"
    if shape.kind == "train":
        fn, args, shardings, model = build_train_cell(
            cfg, shape, mesh, moe_impl, seq_axis)
    elif shape.kind == "prefill":
        fn, args, shardings, model = build_prefill_cell(
            cfg, shape, mesh, moe_impl, rules)
    else:
        fn, args, shardings, model = build_decode_cell(
            cfg, shape, mesh, moe_impl, rules, split_kv)
    # the layout must divide, as the reference's in_shardings must
    shd.check_layout(args, shardings)
    args_bytes = shd.bytes_per_device(args, shardings)
    counted = count_flops(fn, args)
    mf_chip = rf.model_flops_estimate(cfg, shape) / chips
    terms = rf.RooflineTerms(
        flops=max(counted / chips, mf_chip),
        hbm_bytes=float(args_bytes),     # one pass over the resident state
        coll_bytes=None, model_flops=mf_chip, chips=chips)
    report.update(
        status="ok",
        build_s=round(time.perf_counter() - t0, 1),
        chips=chips,
        per_chip_state_bytes=int(args_bytes),
        fits_hbm=bool(args_bytes < rf.HBM_BYTES),
        flops_counted=float(counted) / chips,
        roofline=terms.to_dict(),
    )
    if verbose:
        obs_log.get_logger(__name__).info(
            "[%s] %s x %s: OK (%ss, %.2f GB/chip state, counted/analytic "
            "FLOPs %.3f, bottleneck=%s, frac=%.3f)", report["mesh"], arch,
            shape.name, report["build_s"], args_bytes / 1e9,
            counted / chips / mf_chip if mf_chip else math.nan,
            terms.bottleneck, terms.roofline_fraction)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--moe-impl", default="local")
    ap.add_argument("--serve-rules", action="store_true",
                    help="resident-weight inference sharding (prefill and "
                         "decode cells)")
    ap.add_argument("--split-kv", action="store_true",
                    help="flash-decoding over the sequence-split cache")
    ap.add_argument("--out", default=None)
    obs_log.add_log_args(ap)
    args = ap.parse_args(argv)
    obs_log.setup_logging("INFO", quiet=args.quiet, verbose=args.verbose)

    if args.all:
        cells = [(a, s) for a in list_configs() for s in SHAPES]
    else:
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    reports = []
    for mp in meshes:
        for a, s in cells:
            try:
                reports.append(run_cell(a, s, multi_pod=mp,
                                        moe_impl=args.moe_impl,
                                        serve_rules=args.serve_rules,
                                        split_kv=args.split_kv))
            except Exception as e:                       # noqa: BLE001
                traceback.print_exc()
                reports.append({"arch": a, "shape": s,
                                "mesh": "2x16x16" if mp else "16x16",
                                "status": "error", "error": repr(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
    ok = sum(r["status"] == "ok" for r in reports)
    sk = sum(r["status"] == "skipped" for r in reports)
    err = sum(r["status"] == "error" for r in reports)
    obs_log.get_logger(__name__).info(
        "dry-run: %d ok, %d skipped, %d errors / %d cells",
        ok, sk, err, len(reports))
    return 1 if err else 0


if __name__ == "__main__":
    raise SystemExit(main())
