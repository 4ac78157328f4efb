"""The port's dry run (``launch.dryrun``, ``launch.roofline``,
``launch.report``) against the reference, on the CPU.

* The reference's own dry-run test cell (``tests/test_multidevice.py::
  test_small_mesh_dryrun_cell``: qwen3-32b cut to 2 layers, ``train_small``
  8 x 512 tokens, mesh 2x4), which is red under jax 0.9.0 because its
  compile meets Explicit mesh axes: the reference builds it on an Auto
  2x4 mesh in one subprocess (8 forced host devices) and computes
  ``shd.bytes_per_device`` of its own abstract arguments and shardings,
  without compiling; the port builds the same cell on ``meta`` tensors and
  its per-device state bytes equal the reference's.  Its counted FLOPs
  are > 0; the ratio to the analytic count is printed.  The same
  subprocess builds a decode cell of that model (8 x 512) under
  ``SERVE_RULES`` and the default rules; the port's ``--serve-rules``
  cell gives the reference's bytes under each.
* Full-size cells on ``meta``: gemma2-9b decode_32k with split-KV on
  16x16, mamba2-2.7b long_500k (kernel E's plain version, counted on
  ``meta``), the skipped quadratic long_500k cell.
* ``roofline_table`` / ``dryrun_table`` give the reference's strings on
  the reference's report dicts, and ``—`` where the port's own reports
  have no compile or collectives.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from md_helper import run_md  # noqa: E402

from repro.launch import report as r_report  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402

SMALL = ShapeConfig("train_small", 512, 8, "train")
SMALL_DECODE = ShapeConfig("decode_small", 512, 8, "decode")

REF_SCRIPT = r"""
import dataclasses
import jax
jax.devices()            # fix 8 devices before dryrun's import sets 512
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.distributed import sharding as shd
from repro.launch import dryrun as dr
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=2)
shape = ShapeConfig("train_small", 512, 8, "train")
fn, args, shardings, model = dr.build_train_cell(cfg, shape, mesh)
print("BYTES train", shd.bytes_per_device(args, shardings))
shape = ShapeConfig("decode_small", 512, 8, "decode")
for name, rules in (("default", None), ("serve", shd.SERVE_RULES)):
    fn, args, shardings, model = dr.build_decode_cell(cfg, shape, mesh,
                                                      rules=rules)
    print("BYTES decode_" + name, shd.bytes_per_device(args, shardings))
"""


@pytest.fixture(scope="module")
def ref_bytes():
    out = run_md(REF_SCRIPT, n_devices=8, timeout=600)
    return {line.split()[1]: int(line.split()[2])
            for line in out.splitlines() if line.startswith("BYTES")}


def test_small_mesh_dryrun_cell_matches_reference(ref_bytes):
    cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=2)
    r = dr.run_cell("qwen3_32b", SMALL.name, multi_pod=False, shape=SMALL,
                    mesh=make_test_mesh(2, 4), cfg=cfg, verbose=False)
    assert r["status"] == "ok" and r["chips"] == 8 and r["mesh"] == "2x4"
    assert r["per_chip_state_bytes"] == ref_bytes["train"]
    assert r["rules"] == "default"
    t = r["roofline"]
    assert r["flops_counted"] > 0
    assert t["flops"] == max(r["flops_counted"], t["model_flops"])
    assert t["coll_bytes"] is None and t["t_collective"] is None
    assert t["hbm_bytes"] == ref_bytes["train"] and r["fits_hbm"]
    print(f"counted / analytic FLOPs per device: "
          f"{r['flops_counted'] / t['model_flops']:.3f}")


def test_serve_rules_decode_cell_matches_reference(ref_bytes):
    """``--serve-rules`` lays a decode cell's parameters out by
    ``SERVE_RULES`` (``embed`` unsplit): the port's bytes per device equal
    the reference's under both rule sets, and the two differ."""
    cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=2)
    got = {}
    for name in ("default", "serve"):
        r = dr.run_cell("qwen3_32b", SMALL_DECODE.name, multi_pod=False,
                        shape=SMALL_DECODE, mesh=make_test_mesh(2, 4),
                        cfg=cfg, serve_rules=name == "serve",
                        verbose=False)
        assert r["status"] == "ok" and r["rules"] == name
        got[name] = r["per_chip_state_bytes"]
        assert got[name] == ref_bytes["decode_" + name]
    assert got["serve"] > got["default"]


def test_full_size_cells_on_meta():
    """Nothing allocated at full width: split-KV decode (gemma2's global
    layers make its caches linear), the SSM's long context through kernel
    E's plain version on ``meta``, the quadratic cell skipped."""
    r = dr.run_cell("gemma2_9b", "decode_32k", multi_pod=False,
                    split_kv=True, verbose=False)
    assert r["status"] == "ok" and r["fits_hbm"] and r["chips"] == 256
    assert r["roofline"]["bottleneck"] == "memory"
    r = dr.run_cell("mamba2_27b", "long_500k", multi_pod=True,
                    verbose=False)
    assert r["status"] == "ok" and r["chips"] == 512
    assert r["flops_counted"] > 0
    r = dr.run_cell("qwen3_32b", "long_500k", multi_pod=False)
    assert r["status"] == "skipped" and "quadratic" in r["reason"]


def _ref_reports():
    roof = {"flops": 2.5e13, "hbm_bytes": 4.1e10, "coll_bytes": 3.3e9,
            "model_flops": 2.0e13, "chips": 256, "t_compute": 0.1269,
            "t_memory": 0.05006, "t_collective": 0.066,
            "bottleneck": "compute", "useful_ratio": 0.8,
            "roofline_fraction": 0.6302}
    coll = {"bytes_by_kind": {"all-gather": 3.38e11, "all-reduce": 2.86e11,
                              "reduce-scatter": 0.0, "all-to-all": 4.1e10,
                              "collective-permute": 1.2e8}}
    ok = dict(arch="qwen3_32b", shape="train_4k", mesh="16x16",
              status="ok", compile_s=81.3, chips=256,
              per_chip_state_bytes=12_345_678_901, fits_hbm=True,
              collectives=coll, roofline=roof)
    tiny = dict(ok, shape="decode_32k", fits_hbm=False,
                roofline=dict(roof, t_compute=4.2e-5, t_memory=0.0031,
                              t_collective=2.5, bottleneck="collective"))
    return [ok, tiny,
            dict(arch="qwen3_32b", shape="long_500k", mesh="16x16",
                 status="skipped", reason="skip"),
            dict(arch="arctic_480b", shape="train_4k", mesh="2x16x16",
                 status="error", error="boom")]


def test_tables_give_reference_strings():
    reports = _ref_reports()
    assert report.roofline_table(reports) == r_report.roofline_table(reports)
    assert report.dryrun_table(reports) == r_report.dryrun_table(reports)
    for x in (3.0, 0.0123, 4.2e-5):
        assert report.fmt_s(x) == r_report.fmt_s(x)


def test_tables_on_port_reports(tmp_path):
    cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=2)
    r = dr.run_cell("qwen3_32b", SMALL.name, multi_pod=False, shape=SMALL,
                    mesh=make_test_mesh(2, 4), cfg=cfg, verbose=False)
    rows = report.roofline_table([r]).splitlines()
    assert len(rows) == 3 and "| — |" in rows[2] and "compute" in rows[2]
    rows = report.dryrun_table([r]).splitlines()
    assert rows[2].startswith("| qwen3_32b | train_small | 2x4 | — |")
    import json
    from repro_torch.launch import experiments_md
    for name in ("dryrun_single_pod.json", "dryrun_multi_pod.json"):
        (tmp_path / name).write_text(json.dumps([r]))
    assert experiments_md.main(["--reports", str(tmp_path)]) == 0
    assert dr.main(["--arch", "gemma2_9b", "--shape", "long_500k",
                    "--out", str(tmp_path / "one.json"), "--quiet"]) == 0
    assert json.loads((tmp_path / "one.json").read_text())[0]["status"] \
        == "skipped"
    assert np.isfinite(r["roofline"]["roofline_fraction"])
