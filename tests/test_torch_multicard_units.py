"""The multi-card runtime's pieces that need no world: the mesh layout
(``launch/mesh.py``), the backend rule, the refusals of ``core/comm.py``,
the elastic restore's blocks (``checkpoint/checkpointer.py``) and
``MoE.shard``'s checks.  The spawned worlds are in
``tests/test_torch_multicard_{moe,pipeline,optim,shard}.py``."""
from __future__ import annotations

import pytest
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, block_slices
from repro_torch.core import comm
from repro_torch.launch import mesh as M
from repro_torch.models.moe import MoE


def test_coords_are_row_major():
    assert [M.mesh_coords(r, (2, 3)) for r in range(6)] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert M.mesh_coords(5, (2, 2, 2)) == (1, 0, 1)


@pytest.mark.parametrize("shape,axis,groups", [
    ((2, 2), 0, [[0, 2], [1, 3]]),
    ((2, 2), 1, [[0, 1], [2, 3]]),
    ((2, 3), 0, [[0, 3], [1, 4], [2, 5]]),
    ((2, 3), 1, [[0, 1, 2], [3, 4, 5]]),
    ((4,), 0, [[0, 1, 2, 3]]),
    ((1, 2), 0, [[0], [1]]),
])
def test_axis_groups_hold_the_ranks_that_differ_in_one_axis(shape, axis,
                                                            groups):
    assert M.axis_groups(shape, axis) == groups


def test_backend_rule():
    assert M.choose_backend(torch.device("cpu"), 4, 0) == "gloo"
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        M.choose_backend(torch.device("meta"), 1, 0)


def test_make_process_mesh_refuses_bad_shapes_and_backends(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="no torch.distributed world"):
        M.make_process_mesh((1,), ("x",), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        M.make_process_mesh((2, 2), ("data",), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        M.make_process_mesh((2, 2), ("x", "x"), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        M.make_process_mesh((1,), ("x",), device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="NCCL runs CUDA ranks only"):
        M.make_process_mesh((1,), ("x",), device="cpu", backend="nccl")


def _fake_mesh(shape: dict, coords: dict) -> M.ProcessMesh:
    """A mesh's layout without a world (no process groups)."""
    return M.ProcessMesh(axis_names=tuple(shape), shape=shape,
                         coords=coords, rank=0, device=torch.device("cpu"),
                         backend="gloo", groups={}, group_ranks={}, log=None)


def test_comm_needs_a_mesh_and_a_known_axis():
    with pytest.raises(RuntimeError, match="no process mesh"):
        comm.psum(torch.ones(2), "x")
    mesh = _fake_mesh({"x": 2}, {"x": 0})
    with pytest.raises(ValueError, match="not 'y'"):
        comm.axis_index("y", mesh=mesh)
    with mesh:
        assert comm.current_mesh() is mesh
        assert comm.axis_size("x") == 2 and comm.axis_index("x") == 0
    with pytest.raises(RuntimeError, match="no process mesh"):
        comm.current_mesh()


def test_comm_refuses_what_has_no_transpose():
    mesh = _fake_mesh({"x": 2}, {"x": 0})
    t = torch.ones(2, requires_grad=True)
    with pytest.raises(ValueError, match="pmax has no gradient"):
        comm.pmax(t, "x", mesh=mesh)
    with pytest.raises(ValueError, match="broadcast has no gradient"):
        comm.broadcast(t, "x", mesh=mesh)


@pytest.mark.parametrize("perm", [[(0, 1), (0, 2)], [(0, 2), (1, 2)],
                                  [(0, 4)], [(-1, 0)]])
def test_check_perm_refuses_what_is_not_a_permutation(perm):
    with pytest.raises(ValueError, match="not a permutation"):
        comm.check_perm(perm, 4)


def test_check_perm_takes_partial_and_cyclic_permutations():
    comm.check_perm([(0, 1), (1, 2)], 4)
    comm.check_perm([(i, (i + 1) % 4) for i in range(4)], 4)
    comm.check_perm([], 4)


@pytest.mark.parametrize("spec,coords,want", [
    (("data", "model"), {"data": 1, "model": 0}, (slice(4, 8),
                                                  slice(0, 4))),
    ((("data", "model"),), {"data": 1, "model": 0}, (slice(4, 6),
                                                     slice(0, 8))),
    ((("model", "data"),), {"data": 1, "model": 0}, (slice(2, 4),
                                                     slice(0, 8))),
    ((None, "model"), {"data": 0, "model": 1}, (slice(0, 8), slice(4, 8))),
    ((), {"data": 1, "model": 1}, (slice(0, 8), slice(0, 8))),
])
def test_block_slices_follow_named_sharding(spec, coords, want):
    mesh = _fake_mesh({"data": 2, "model": 2}, coords)
    assert block_slices(spec, (8, 8), mesh) == want


def test_block_slices_refuse_uneven_and_long_specs():
    mesh = _fake_mesh({"data": 2, "model": 2}, {"data": 0, "model": 0})
    with pytest.raises(ValueError, match="does not split"):
        block_slices(("data",), (5, 4), mesh)
    with pytest.raises(ValueError, match="more entries"):
        block_slices(("data", None, None), (4, 4), mesh)


def test_elastic_restore_needs_mesh_and_specs(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.arange(4.0)})
    with pytest.raises(ValueError, match="both mesh= and specs="):
        ck.restore(1, specs={"w": ("x",)})


def test_moe_shard_checks_the_mesh():
    layer = MoE(64, 128, 6, 2, 1.25, dtype=torch.float32,
                device=torch.device("cpu"), generator=None)
    with pytest.raises(ValueError, match="do not split over a model axis"):
        layer.shard(_fake_mesh({"model": 4}, {"model": 0}))
    with pytest.raises(ValueError, match="does not split over a data"):
        layer.shard(_fake_mesh({"data": 3, "model": 2},
                               {"data": 0, "model": 0}))
    layer.shard(_fake_mesh({"data": 2, "model": 3},
                           {"data": 1, "model": 2}))
    assert (layer.e0, layer.e_loc) == (4, 2)
    assert tuple(layer.w_gate_up.shape) == (2, 32, 256)
    assert tuple(layer.w_down.shape) == (2, 128, 32)
