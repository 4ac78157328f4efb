"""The port's sharding rules against the reference's, host-side (no
subprocess, no devices).

* For every ParamSpec leaf of all ten architectures at full size, under
  both rule sets (``DEFAULT_RULES`` and ``SERVE_RULES``) and on the meshes
  16x16, 2x16x16, 2x4, 1x8 and 3x5 (nothing divides 3 or 5 evenly in
  most widths), ``axes_to_pspec`` equals the reference's, the
  reference's ``PartitionSpec`` read as a tuple.  The reference's mesh is
  its ``FakeMesh`` duck type (axis names and a device array of the
  shape), as in ``tests/test_sharding.py``.
* ``bytes_per_device`` of the full-size parameters on each mesh equals
  the reference's on its ``ShapeDtypeStruct`` tree and sharding tree
  (duck-typed ``NamedSharding``: a spec and a mesh).
* ``param_count`` and ``model_flops_estimate`` equal the reference's for
  every architecture and every shape of ``SHAPES``.
"""
import types

import jax
import numpy as np
import pytest

from repro.configs import SHAPES as R_SHAPES, get_config as r_get_config
from repro.distributed import sharding as r_shd
from repro.launch import roofline as r_roofline
from repro.models import build as r_build
from repro.models import modules as r_modules
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import roofline
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import build
from repro_torch.models.modules import (abstract_params, param_count,
                                        tree_paths)

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x8": ((1, 8), ("data", "model")),
    "3x5": ((3, 5), ("data", "model")),
}
RULES = {"default": (shd.DEFAULT_RULES, r_shd.DEFAULT_RULES),
         "serve": (shd.SERVE_RULES, r_shd.SERVE_RULES)}


class FakeMesh:
    """The reference's duck-typed mesh: axis names and devices.shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def _norm(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _leaves(tree):
    return dict(tree_paths(tree))


@pytest.mark.parametrize("arch", list_configs())
def test_axes_to_pspec_equals_reference_on_every_leaf(arch):
    port = _leaves(build(get_config(arch)).specs())
    ref = {path: spec for path, spec in r_modules.tree_paths(
        r_build(r_get_config(arch)).specs())}
    assert port.keys() == ref.keys()
    n = 0
    for shape, names in MESHES.values():
        mesh, fake = Mesh(shape, names), FakeMesh(shape, names)
        for rules, r_rules in RULES.values():
            for path, spec in port.items():
                want = _norm(r_shd.spec_to_pspec(ref[path], fake, r_rules))
                got = shd.spec_to_pspec(spec, mesh, rules)
                assert got == want, (arch, shape, path, got, want)
                n += 1
    assert n == len(port) * len(MESHES) * len(RULES)


def test_rule_tables_and_fallback_order_equal_reference():
    assert shd.DEFAULT_RULES == r_shd.DEFAULT_RULES
    assert shd.SERVE_RULES == r_shd.SERVE_RULES
    assert list(shd.FALLBACKS.items()) == list(r_shd.FALLBACKS.items())
    mesh, fake = Mesh((16, 16), ("data", "model")), \
        FakeMesh((16, 16), ("data", "model"))
    # the reference test's cases: the kv projection stays replicated on
    # the model axis (no head_dim fallback); a cache's seq takes it
    for axes, shape in (
            (("layers", "embed", "kv_heads", "head_dim"), (64, 5120, 8, 128)),
            (("layers", "batch", "seq", "kv_heads", "head_dim"),
             (42, 128, 32768, 8, 256)),
            (("batch", None), (1, 1)),
            (("layers", "expert", "embed", "mlp"), (28, 64, 2048, 1408))):
        assert shd.axes_to_pspec(axes, shape, mesh) == \
            _norm(r_shd.axes_to_pspec(axes, shape, fake))
    assert shd.axes_to_pspec(("batch", "seq"), (256, 4096), Mesh(
        (2, 16, 16), ("pod", "data", "model")))[0] == ("pod", "data")


@pytest.mark.parametrize("mesh_name", MESHES)
def test_bytes_per_device_equals_reference(mesh_name):
    shape, names = MESHES[mesh_name]
    mesh, fake = Mesh(shape, names), FakeMesh(shape, names)
    for arch in list_configs():
        specs = build(get_config(arch)).specs()
        r_specs = r_build(r_get_config(arch)).specs()
        for rules, r_rules in RULES.values():
            got = shd.bytes_per_device(abstract_params(specs),
                                       shd.param_shardings(specs, mesh,
                                                           rules))
            r_sh = r_modules.tree_map_specs(
                lambda s: types.SimpleNamespace(
                    spec=r_shd.spec_to_pspec(s, fake, r_rules), mesh=fake),
                r_specs)
            want = r_shd.bytes_per_device(r_modules.abstract_params(r_specs),
                                          r_sh)
            assert got == want, (arch, mesh_name)


def test_param_count_and_model_flops_equal_reference():
    assert set(SHAPES) == set(R_SHAPES)
    for arch in list_configs():
        cfg, r_cfg = get_config(arch), r_get_config(arch)
        assert param_count(build(cfg).specs()) == \
            r_modules.param_count(r_build(r_cfg).specs())
        for name, shape in SHAPES.items():
            assert shape == type(shape)(**vars(R_SHAPES[name]))
            assert roofline.model_flops_estimate(cfg, shape) == \
                r_roofline.model_flops_estimate(r_cfg, R_SHAPES[name]), \
                (arch, name)


def test_mesh_helpers():
    from repro_torch.launch import mesh as m
    assert m.make_production_mesh().sizes == {"data": 16, "model": 16}
    pods = make_production_mesh(multi_pod=True)
    assert pods.size == 512 and m.batch_axes(pods) == ("pod", "data")
    assert m.make_test_mesh(2, 4, pods=3).shape == (3, 2, 4)
    assert m.make_wafer_mesh(8).axis_names == ("wafer",)
    assert pods.axis_size(("pod", "data")) == 32
    assert pods.axis_size(None) == 1 and pods.axis_size("absent") == 1
    with pytest.raises(ValueError):
        Mesh((2, 4), ("data",))
    sh = shd.array_sharding(("batch", "seq"), (8, 16), m.make_test_mesh())
    # seq picks up the unused model axis through the fallback
    assert sh.spec == ("data", "model") and sh.shards() == 8
    assert jax.tree_util.tree_leaves({"b": 1, "a": 2}) == \
        shd.tree_leaves({"b": 1, "a": 2})
