"""The ranks of the port's multi-card tests (``tests/test_torch_multicard*.py``).

Each function here runs in every rank of a world that
``repro_torch.launch.spawn.run_world`` spawns on the CPU (gloo); it builds
its ``ProcessMesh``, runs every case of its test module inside that one
world, and returns numpy results for the test to hold against the
reference's ``shard_map`` results.  The module imports torch and the port
only, never jax or the reference, so that a rank starts quickly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import moe as port_moe
from repro_torch.models.sharding_ctx import ShardingCtx


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


# --------------------------------------------------------------------- #
# The expert-parallel MoE on (data=2, model=2).
# --------------------------------------------------------------------- #

def moe_layer(params: dict, k: int, cf: float) -> port_moe.MoE:
    """A trainable fp32 ``MoE`` holding the reference's numpy weights
    (``w_gate`` / ``w_up`` side by side in ``w_gate_up``)."""
    E, d, f = params["w_gate"].shape
    layer = port_moe.MoE(d, f, E, k, cf, dtype=torch.float32,
                         device=torch.device("cpu"), generator=None,
                         trainable=True)
    with torch.no_grad():
        layer.router.copy_(torch.from_numpy(params["router"]))
        layer.w_gate_up.copy_(torch.from_numpy(np.concatenate(
            [params["w_gate"], params["w_up"]], axis=2)))
        layer.w_down.copy_(torch.from_numpy(params["w_down"]))
    return layer


#: Planted faults of the expert-parallel path: the partial sums left
#: unsummed (each rank keeps its own block of its partial), and the
#: experts' offset moved by one shard.
MOE_FAULTS = ("no psum_scatter", "wrong e0")


def _moe_case(mesh, params, x_full, k, cf, fault=None) -> dict:
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    layer = moe_layer(params, k, cf).shard(mesh)
    if fault == "wrong e0":
        layer.e0 = (layer.e0 + layer.e_loc) % layer.num_experts
    B = x_full.shape[0] // dp
    di = mesh.axis_index("data")
    x = torch.from_numpy(x_full[di * B:(di + 1) * B]).requires_grad_()
    ctx = ShardingCtx({}, mesh)
    real = comm.psum_scatter
    if fault == "no psum_scatter":
        def fake(t, axis, *, scatter_dimension, tiled, mesh):
            size = t.shape[scatter_dimension] // mesh.axis_size(axis)
            return t.narrow(scatter_dimension, mesh.axis_index(axis) * size,
                            size)
        comm.psum_scatter = fake
    try:
        out = layer(x, ctx=ctx)
    finally:
        comm.psum_scatter = real
    scattered = out.shape[1] != x.shape[1]
    # Each rank's share of sum(out ** 2): a block of the sequence, or the
    # whole output replicated over "model" (counted once).
    loss = (out ** 2).sum() * (1.0 if scattered else 1.0 / tp)
    loss.backward()
    f = layer.w_down.shape[1]
    g = layer.w_gate_up.grad
    return {"out": _np(out), "scattered": scattered,
            "g_gate": _np(g[..., :f]), "g_up": _np(g[..., f:]),
            "g_down": _np(layer.w_down.grad), "g_router": _np(layer.router.grad),
            "g_x": _np(x.grad), "e0": layer.e0, "e_loc": layer.e_loc,
            "log": dict(mesh.log.bytes)}


def moe_rank(rank: int, world: int, params: dict, cases: list) -> dict:
    """Every MoE case (``(name, x, k, cf)``) and every planted fault on
    the first case, on a ``(data=2, model=2)`` gloo mesh."""
    mesh = make_process_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": dict(mesh.coords)}
    for name, x, k, cf in cases:
        mesh.reset_log()
        out[name] = _moe_case(mesh, params, x, k, cf)
    name, x, k, cf = cases[0]
    for fault in MOE_FAULTS:
        out[fault] = _moe_case(mesh, params, x, k, cf, fault)
    return out


# --------------------------------------------------------------------- #
# The GPipe pipeline on (stage=4).
# --------------------------------------------------------------------- #

def tanh_block(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference test's stage: ``tanh(h @ w)`` for each of its
    layers in turn."""
    for w in params:
        x = torch.tanh(x @ w)
    return x


def _pipeline_case(mesh, ws, x, reversed_perm=False) -> dict:
    from repro_torch.train import pipeline
    S = mesh.shape["stage"]
    sid = mesh.axis_index("stage")
    stages = pipeline.split_stages(torch.from_numpy(ws), S)
    mine = stages[sid].clone().requires_grad_()
    real = pipeline.stage_perm
    if reversed_perm:
        pipeline.stage_perm = lambda n: [(d, s) for s, d in real(n)]
    try:
        out = pipeline.pipeline_apply(tanh_block, mine, torch.from_numpy(x),
                                      mesh=mesh)
    finally:
        pipeline.stage_perm = real
    # Every stage holds the outputs: each counts 1 / S of the loss.
    ((out ** 2).sum() / S).backward()
    return {"out": _np(out), "grad": _np(mine.grad),
            "log": dict(mesh.log.bytes)}


def pipeline_rank(rank: int, world: int, ws: np.ndarray,
                  x: np.ndarray) -> dict:
    """The pipeline on a ``(stage=4)`` gloo mesh, then with the hops'
    permutation reversed (a planted fault)."""
    mesh = make_process_mesh((4,), ("stage",), device="cpu")
    good = _pipeline_case(mesh, ws, x)
    mesh.reset_log()
    return {"stage": mesh.axis_index("stage"), "good": good,
            "reversed perm": _pipeline_case(mesh, ws, x, True)}


# --------------------------------------------------------------------- #
# compressed_psum, the collectives, elastic restore on 4 ranks.
# --------------------------------------------------------------------- #

def _comm_ops(mesh, x: torch.Tensor) -> dict:
    """Every ``core.comm`` op over the ``"x"`` axis of a 1-D mesh, in the
    forms the reference's programs use (the reference subprocess runs the
    same list through ``jax.lax``)."""
    n = mesh.shape["x"]
    out = {"axis_index": np.asarray(comm.axis_index("x", mesh=mesh)),
           "psum": _np(comm.psum(x, "x", mesh=mesh)),
           "pmax": _np(comm.pmax(x, "x", mesh=mesh)),
           "all_gather_0": _np(comm.all_gather(x, "x", dim=0, mesh=mesh)),
           "all_gather_1": _np(comm.all_gather(x, "x", dim=1, mesh=mesh)),
           "all_gather_1_tiled": _np(comm.all_gather(x, "x", dim=1,
                                                     tiled=True, mesh=mesh)),
           "psum_scatter_0_tiled": _np(comm.psum_scatter(
               x, "x", scatter_dimension=0, tiled=True, mesh=mesh)),
           "psum_scatter_1": _np(comm.psum_scatter(
               x[:, :n], "x", scatter_dimension=1, mesh=mesh)),
           "ppermute_shift": _np(comm.ppermute(
               x, "x", [(i, i + 1) for i in range(n - 1)], mesh=mesh)),
           "ppermute_ring": _np(comm.ppermute(
               x, "x", [(i, (i + 1) % n) for i in range(n)], mesh=mesh))}
    return out


def _comm_grads(mesh, x: np.ndarray) -> dict:
    """Each differentiable op's input gradient under the loss ``sum(y *
    w)``, ``w`` a fixed weight of ``y``'s shape per rank."""
    n = mesh.shape["x"]
    me = mesh.axis_index("x")
    ops = {"psum": lambda t: comm.psum(t, "x", mesh=mesh),
           "all_gather_1_tiled": lambda t: comm.all_gather(
               t, "x", dim=1, tiled=True, mesh=mesh),
           "psum_scatter_0_tiled": lambda t: comm.psum_scatter(
               t, "x", scatter_dimension=0, tiled=True, mesh=mesh),
           "ppermute_shift": lambda t: comm.ppermute(
               t, "x", [(i, i + 1) for i in range(n - 1)], mesh=mesh),
           "pvary": lambda t: comm.pvary(t, "x", mesh=mesh)}
    out = {}
    for name, op in ops.items():
        t = torch.from_numpy(x).requires_grad_()
        y = op(t)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
        (y * (w + me)).sum().backward()
        out[name] = _np(t.grad)
    return out


def _ring_log(mesh, x: torch.Tensor) -> dict:
    """One of each op on a fresh log: the bytes it counted by kind."""
    n = mesh.shape["x"]
    log = mesh.reset_log()
    comm.psum(x, "x", mesh=mesh)
    comm.all_gather(x, "x", dim=0, tiled=True, mesh=mesh)
    comm.psum_scatter(x, "x", scatter_dimension=0, tiled=True, mesh=mesh)
    comm.ppermute(x, "x", [(i, i + 1) for i in range(n - 1)], mesh=mesh)
    comm.broadcast(x, "x", 0, mesh=mesh)
    return dict(log.bytes)


def _regression(mesh, X, y, w_true, compress: bool, steps: int = 400,
                lr: float = 0.05) -> float:
    """The reference's compressed data-parallel regression: each rank
    holds its rows; the gradient is summed exactly or averaged through
    ``compressed_psum``."""
    from repro_torch.optim.compression import compressed_psum
    n = mesh.shape["x"]
    me = mesh.axis_index("x")
    rows = X.shape[0] // n
    Xl = torch.from_numpy(X[me * rows:(me + 1) * rows])
    yl = torch.from_numpy(y[me * rows:(me + 1) * rows])
    w = torch.zeros(X.shape[1])
    residual = torch.zeros(X.shape[1])
    for _ in range(steps):
        g_local = 2.0 * Xl.T @ (Xl @ w - yl) / X.shape[0]
        if compress:
            g, residual = compressed_psum(g_local, residual, "x", mesh=mesh)
        else:
            g = comm.psum(g_local, "x", mesh=mesh)
        w = w - lr * g
    return float(torch.linalg.norm(w - torch.from_numpy(w_true)))


def optim_rank(rank: int, world: int, grads: np.ndarray,
               residuals: np.ndarray, X: np.ndarray, y: np.ndarray,
               w_true: np.ndarray, ckpt_dir: str, ops_x: np.ndarray) -> dict:
    """``compressed_psum`` per rank, the regression, every comm op and
    its gradient, the ring volumes, all on a ``(x=4)`` gloo mesh; then
    the elastic restore on ``(data=2, model=2)``."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.optim.compression import compress_grad, compressed_psum
    mesh = make_process_mesh((4,), ("x",), device="cpu")
    me = mesh.axis_index("x")
    g = torch.from_numpy(grads[me])
    r = torch.from_numpy(residuals[me])
    q, scale, _ = compress_grad(g, r)
    mean, new_res = compressed_psum(g, r, "x", mesh=mesh)
    out = {"index": me, "q": q.numpy(), "scale": float(scale),
           "mean": _np(mean), "residual": _np(new_res),
           "err_exact": _regression(mesh, X, y, w_true, False),
           "err_comp": _regression(mesh, X, y, w_true, True),
           "ops": _comm_ops(mesh, torch.from_numpy(ops_x[me])),
           "grads": _comm_grads(mesh, ops_x[me]),
           "ring": _ring_log(mesh, torch.from_numpy(ops_x[me]))}
    grid = make_process_mesh((2, 2), ("data", "model"), device="cpu")
    specs = {"params": {"w": ("data", "model"), "b": (("data", "model"),),
                        "h": (None, "model")}}
    tree = Checkpointer(ckpt_dir).restore(1, mesh=grid, specs=specs)
    out["coords"] = dict(grid.coords)
    out["restored"] = {k: _np(v) for k, v in tree["params"].items()}
    return out


# --------------------------------------------------------------------- #
# The sharded SpMM tier on (shard=4).
# --------------------------------------------------------------------- #

#: Planted faults of the sharded tier: a collective replaced by one that
#: skips its communication.
SHARD_FAULTS = {
    "reduce_scatter without the sum": (
        "psum_scatter",
        lambda t, axis, *, scatter_dimension, tiled, mesh: t.narrow(
            0, mesh.axis_index(axis) * (t.shape[0] // mesh.axis_size(axis)),
            t.shape[0] // mesh.axis_size(axis))),
    "all_gather of the own slice only": (
        "all_gather",
        lambda t, axis, *, dim, tiled, mesh: torch.cat(
            [t] * mesh.axis_size(axis), dim)),
    "band partials not summed": (
        "psum", lambda t, axis, *, mesh: t),
}


def plan_record(p) -> dict:
    """A ShardedPlan's decision record as plain values (the fields
    ``tests/test_torch_shard.py::_record`` compares)."""
    evals = []
    for e in p.strategy_evals:
        roof = None
        if e.roofline is not None:
            r = e.roofline
            roof = {"strategy": r.strategy, "devices": r.devices,
                    **{f: float(getattr(r, f)) for f in (
                        "shard_ai", "critical_flops", "total_flops",
                        "compute_s", "collective_s", "collective_bytes")}}
        evals.append({"strategy": e.strategy, "partition": e.partition,
                      "eligible": bool(e.eligible),
                      "skip_reason": e.skip_reason, "roofline": roof})
    return {"chosen": p.chosen, "precision": p.precision,
            "num_shards": int(p.num_shards), "b_strategy": p.b_strategy,
            "partition": p.partition,
            "shard_bounds": [int(x) for x in p.shard_bounds],
            "shard_nnz": [int(x) for x in p.shard_nnz],
            "shard_precision": p.stats()["shard_precision"],
            "evals": evals}


def _shard_plan(case, mats, mesh, d: int):
    from repro_torch import interop
    from repro_torch import sparse as port_sparse
    from repro_torch.core import hardware as port_hw
    from repro_torch.sparse.dispatch import Dispatcher
    backend, hw, name, fmt_name, bs, prec = case
    n, rows, cols, vals, pattern = mats[name]
    disp = Dispatcher({"host-cpu": port_hw.HOST_CPU, "h100": port_hw.H100}[hw],
                      backend=backend, device="cpu", calibration=False,
                      tree=False)
    m = interop.coo_from_numpy(n, rows, cols, vals, pattern)
    return port_sparse.plan(
        m, port_sparse.BSpec(d=d), mesh=mesh, strategy=fmt_name,
        b_strategy=bs, dispatcher=disp,
        precision=None if prec == "-" else prec)


def _shard_run(plan, b: np.ndarray) -> dict:
    block = plan.execute(torch.from_numpy(b))
    return {"c": _np(plan.gather_c(block)), "block": _np(block),
            "c_rows": plan.c_rows}


def shard_rank(rank: int, world: int, cases: list, mats: dict,
               b: np.ndarray, fault_cases: dict) -> dict:
    """Every case on a ``(shard=4)`` gloo mesh: the plan's record and the
    gathered C; then each planted fault on its cases."""
    mesh = make_process_mesh((4,), ("shard",), device="cpu")
    out = {"index": mesh.axis_index("shard"), "cases": {}, "faults": {}}
    for case in cases:
        key = "-".join(map(str, case))
        try:
            plan = _shard_plan(case, mats, mesh, b.shape[1])
        except ValueError as e:
            out["cases"][key] = {"error": str(e)}
            continue
        mesh.reset_log()
        out["cases"][key] = {"record": plan_record(plan),
                             **_shard_run(plan, b),
                             "log": dict(mesh.log.bytes)}
    for fault, fcases in fault_cases.items():
        name, fake = SHARD_FAULTS[fault]
        for case in fcases:
            plan = _shard_plan(case, mats, mesh, b.shape[1])
            real = getattr(comm, name)
            setattr(comm, name, fake)
            try:
                block = plan.execute(torch.from_numpy(b))
            finally:
                setattr(comm, name, real)
            out["faults"][(fault, "-".join(map(str, case)))] = \
                _np(plan.gather_c(block))
    return out
