"""The port's sharding policy (``repro_torch.launch.sharding``) against the
reference's ``repro.launch.sharding``, leaf for leaf.

For all ten archs at full width, on duck meshes of ``{data: 16, model:
16}`` (the reference's TPU mesh), ``{data: 32, model: 8}`` and ``{pod: 2,
data: 32, model: 8}`` (the port's H100 meshes): every parameter spec, every
decode-cache spec, the batch specs and the activation rules of every shape
must equal the reference's exactly, less the reference's leading group dim
on stacked leaves.  Parameters are matched through ``interop``'s names (the
port's ``w_gate_up`` against both the reference's ``w_gate`` and ``w_up``;
its bare router against ``router/kernel``).  The reference's shapes come
from ``jax.eval_shape``, the port's from an ``LM`` on the ``meta`` device.
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import pytest
import torch

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.launch import sharding as ref_sh
from repro.models import model as ref_model
from repro_torch import interop
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import SHAPES, list_archs
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import sharding as sh
from repro_torch.models.model import LM, layer_kinds

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "32x8": ((32, 8), ("data", "model")),
    "2x32x8": ((2, 32, 8), ("pod", "data", "model")),
}
ARCHS = list_archs()


def _meshes(name):
    shape, axes = MESHES[name]
    ref = SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)
    return ref, port_mesh.abstract_mesh(shape, axes)


def _t(spec):
    return tuple(spec)


def _ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {tuple(p.key for p in path): leaf for path, leaf in flat}


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        cfg = ref_config(arch)
        params = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                                jax.random.PRNGKey(0))
        out[arch] = (params, LM(port_config(arch), device="meta"))
    return out


def _ref_paths(cfg, name):
    """The reference paths a port parameter corresponds to, and whether
    they are stacked (a leading group dim)."""
    parts = name.split(".")
    slot = interop._stacked_slot(cfg, parts)
    if slot is None:
        return [tuple(parts)], False
    prefix, _, _, rest = slot
    if rest == ("moe", "w_gate_up"):
        return [prefix + ("moe", "w_gate"), prefix + ("moe", "w_up")], True
    if rest == ("moe", "router"):
        return [prefix + ("moe", "router", "kernel")], True
    return [prefix + rest], True


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh_name, models):
    ref_mesh, mesh = _meshes(mesh_name)
    params_ref, lm = models[arch]
    cfg = ref_config(arch)
    ref = _ref_flat(ref_sh.param_pspecs(cfg, params_ref, ref_mesh))
    port = sh.param_pspecs(port_config(arch), dict(lm.named_parameters()),
                           mesh)
    assert len(port) == sum(1 for _ in lm.parameters())
    seen = set()
    for name, spec in port.items():
        paths, stacked = _ref_paths(cfg, name)
        for path in paths:
            want = _t(ref[path])
            if stacked:
                assert want[0] is None, (name, want)
                want = want[1:]
            assert spec == want, (name, spec, want)
            seen.add(path)
    assert seen == set(ref), set(ref) - seen


def _ref_cache_path(kind, name):
    if kind == "rglru":
        return ("rnn", name)
    if name in ("k", "v"):
        return ("kv", name)
    return (name,)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_and_activation_specs_equal_reference(arch, mesh_name,
                                                          models):
    ref_mesh, mesh = _meshes(mesh_name)
    cfg, pcfg = ref_config(arch), port_config(arch)
    lm = models[arch][1]
    period = len(cfg.layer_pattern)
    for shape_name in cfg.runnable_shapes():
        shape, pshape = REF_SHAPES[shape_name], SHAPES[shape_name]
        assert {k: _t(v) for k, v in ref_sh.batch_pspecs(
            cfg, ref_mesh, shape).items()} == sh.batch_pspecs(
                pcfg, mesh, pshape)
        assert {k: _t(v) for k, v in ref_sh.activation_rules(
            cfg, ref_mesh, shape).items()} == sh.activation_rules(
                pcfg, mesh, pshape)
        if shape.kind != "decode":
            continue
        cache_ref = jax.eval_shape(lambda: ref_model.init_cache(
            cfg, shape.global_batch, shape.seq_len))
        ref = ref_sh.cache_pspecs(cfg, ref_mesh, shape, cache_ref)
        cache = lm.init_cache(shape.global_batch, shape.seq_len)
        port = sh.cache_pspecs(pcfg, mesh, pshape, cache)
        kinds = layer_kinds(pcfg)
        for i, layer in enumerate(port):
            group = _ref_flat(ref[f"p{i % period}"])
            assert len(group) == len(layer)
            for name, spec in layer.items():
                want = _t(group[_ref_cache_path(kinds[i], name)])
                assert want[0] is None
                assert spec == want[1:], (arch, shape_name, i, name)


def test_opt_state_specs():
    specs = {"a": ("data", "model"), "b": (None,)}
    assert sh.opt_state_pspecs(specs) == {"mu": specs, "nu": specs,
                                          "count": ()}


def test_validate_spec_drops_indivisible():
    mesh = port_mesh.abstract_mesh((16, 16), ("data", "model"))
    assert sh.validate_spec(("model", "data"), (51865, 512), mesh) == \
        (None, "data")
    assert sh.validate_spec(("model", None), (256000, 64), mesh) == \
        ("model", None)
    assert sh.validate_spec((("data", "model"),), (500, 4), mesh) == \
        (None, None)
    assert sh.validate_spec((("data", "model"),), (512, 4), mesh) == \
        (("data", "model"), None)


def test_dp_axes_for_batch_greedy():
    mesh = port_mesh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.dp_axes_for_batch(mesh, 256) == (("pod", "data"), ())
    assert sh.dp_axes_for_batch(mesh, 1) == ((), ("pod", "data"))
    assert sh.dp_axes_for_batch(mesh, 16) == (("pod",), ("data",))


def test_production_meshes():
    one, two = port_mesh.make_production_mesh(), \
        port_mesh.make_production_mesh(multi_pod=True)
    assert one.axis_names == ("data", "model") and one.size == 256
    assert two.shape == {"pod": 2, "data": 32, "model": 8}
    assert two.size == 512


def test_host_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the mesh is built")
    with pytest.raises(RuntimeError):
        port_mesh.make_host_mesh(1, 1)
