"""``core.comm``, ``compressed_psum`` and the elastic restore of the port
against the reference, on four ranks.

The port runs one gloo world of four CPU ranks (the ranks are
``tests/_multicard_ranks.py::optim_rank``): a ``(x=4)`` mesh for the
collectives and ``compressed_psum``, then a ``(data=2, model=2)`` mesh for
the restore.  The reference runs once, in a subprocess with four host
devices: each ``jax.lax`` collective on the same per-device inputs inside
``shard_map``, the gradient of each differentiable one under the loss
``sum_i sum(y_i * (w + i))`` (``w`` a fixed ramp, ``i`` the device), and
``compressed_psum`` on each device's gradient and residual.

Bounds: the collectives move data, so their outputs and gradients are
exact up to the order of a sum of four fp32 terms (``4 * eps`` of the
summed magnitudes).  ``compressed_psum``: ``q`` and the scales equal the
reference's, except that where ``(g + residual) / scale`` lies within
``TIE`` of a half-integer the two rounding paths may differ by one
quantum (each such element is counted and must be such a tie); the new
residual equals the reference's eager one and is within one rounding of
``q * scale`` of its jitted one (XLA fuses the product into the
difference), and the mean is the reference's formula bit for bit.  The
reference's compressed
data-parallel regression (``tests/test_distributed.py``), on four ranks:
``err_comp < 0.1`` and ``|err_comp - err_exact| < 0.1``.  The restore: a
checkpoint the reference's ``Checkpointer`` wrote, restored on the 2 x 2
mesh by specs, gives each rank exactly its block of every leaf.  The
counted bytes of each op equal ``core.collectives``' ring volumes.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest

from _multicard_ranks import optim_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.optim import compression as ref_compression
from repro_torch.core.collectives import CollectiveLog
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.spawn import run_world

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 4
EPS32 = float(np.finfo(np.float32).eps)
TIE = 1e-5
OP_NAMES = ("axis_index", "psum", "pmax", "all_gather_0", "all_gather_1",
            "all_gather_1_tiled", "psum_scatter_0_tiled", "psum_scatter_1",
            "ppermute_shift", "ppermute_ring")
GRAD_NAMES = ("psum", "all_gather_1_tiled", "psum_scatter_0_tiled",
              "ppermute_shift", "pvary")


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    X = rng.normal(size=(64, 16)).astype(f32)
    w_true = rng.normal(size=(16,)).astype(f32)
    g = rng.standard_normal((N, 5, 37)).astype(f32)
    g[1] *= 40.0                                  # per-rank scales differ
    return {"grads": g,
            "residuals": (1e-2 * rng.standard_normal((N, 5, 37))).astype(f32),
            "X": X, "y": (X @ w_true).astype(f32), "w_true": w_true,
            "ops_x": rng.standard_normal((N, 8, 6)).astype(f32)}


_REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.optim.compression import compressed_psum

d = np.load(sys.argv[1])
n = 4
mesh = jax.make_mesh((n,), ("x",), axis_types=(AxisType.Auto,))
shift = [(i, i + 1) for i in range(n - 1)]
ring = [(i, (i + 1) % n) for i in range(n)]
ops = {
    "axis_index": lambda x: jax.lax.axis_index("x"),
    "psum": lambda x: jax.lax.psum(x, "x"),
    "pmax": lambda x: jax.lax.pmax(x, "x"),
    "all_gather_0": lambda x: jax.lax.all_gather(x, "x", axis=0),
    "all_gather_1": lambda x: jax.lax.all_gather(x, "x", axis=1),
    "all_gather_1_tiled": lambda x: jax.lax.all_gather(x, "x", axis=1,
                                                       tiled=True),
    "psum_scatter_0_tiled": lambda x: jax.lax.psum_scatter(
        x, "x", scatter_dimension=0, tiled=True),
    "psum_scatter_1": lambda x: jax.lax.psum_scatter(
        x[:, :n], "x", scatter_dimension=1),
    "ppermute_shift": lambda x: jax.lax.ppermute(x, "x", shift),
    "ppermute_ring": lambda x: jax.lax.ppermute(x, "x", ring),
}
xs = jnp.asarray(d["ops_x"])
out = {}
for name, op in ops.items():
    f = jax.shard_map(lambda x: op(x[0])[None], mesh=mesh, in_specs=P("x"),
                      out_specs=P("x"), check_vma=False)
    out["op/" + name] = np.asarray(jax.jit(f)(xs))

def weighted(op, spec):
    def body(x):
        y = op(x[0] if spec == P("x") else x)
        w = jnp.arange(y.size, dtype=jnp.float32).reshape(y.shape)
        return jnp.sum(y * (w + jax.lax.axis_index("x")))[None]
    f = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=P("x"),
                      check_vma=False)
    return lambda x: jnp.sum(f(x))

for name in ("psum", "all_gather_1_tiled", "psum_scatter_0_tiled",
             "ppermute_shift"):
    out["grad/" + name] = np.asarray(jax.jit(jax.grad(
        weighted(ops[name], P("x"))))(xs))
# A replicated operand: shard_map's transpose sums its gradient.
out["grad/pvary"] = np.asarray(jax.jit(jax.grad(
    weighted(lambda x: x, P())))(xs[0]))

cp = jax.shard_map(
    lambda g, r: tuple(a[None] for a in compressed_psum(g[0], r[0], "x")),
    mesh=mesh, in_specs=(P("x"), P("x")), out_specs=(P("x"), P("x")),
    check_vma=False)
mean, res = jax.jit(cp)(jnp.asarray(d["grads"]), jnp.asarray(d["residuals"]))
out["cp/mean"], out["cp/residual"] = np.asarray(mean), np.asarray(res)
np.savez(sys.argv[2], **out)
print("REF-COMM-OK", len(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_comm")
    np.savez(tmp / "in.npz", **_inputs())
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "HOME": str(tmp),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                        str(tmp / "in.npz"), str(tmp / "out.npz")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=str(ROOT))
    assert "REF-COMM-OK" in r.stdout, r.stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}, time.perf_counter() - t0


def _tree():
    return {"params": {
        "w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
        "b": jnp.arange(16, dtype=jnp.float32),
        "h": jnp.arange(24, dtype=jnp.bfloat16).reshape(4, 6),
        "scalar": jnp.asarray(3.5, jnp.float32)}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    RefCheckpointer(str(ckpt)).save(1, _tree())
    i = _inputs()
    t0 = time.perf_counter()
    res = run_world(optim_rank, N, i["grads"], i["residuals"], i["X"],
                    i["y"], i["w_true"], str(ckpt), i["ops_x"], threads=1,
                    timeout=300)
    return sorted(res, key=lambda r: r["index"]), time.perf_counter() - t0


def test_reference_and_world_stay_inside_their_limits(reference, ranks):
    assert reference[1] < 120.0 and ranks[1] < 120.0


def _sum_bound(x: np.ndarray) -> float:
    return 4 * EPS32 * N * float(np.abs(x).max())


@pytest.mark.parametrize("name", OP_NAMES)
def test_collective_equals_jax_lax(name, reference, ranks):
    ref = reference[0]["op/" + name]
    for r in ranks[0]:
        got = r["ops"][name]
        want = ref[r["index"]]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert np.abs(got - want).max(initial=0.0) <= _sum_bound(want), name


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_collective_gradient_equals_jax_transpose(name, reference, ranks):
    ref = reference[0]["grad/" + name]
    for r in ranks[0]:
        got = r["grads"][name]
        want = ref if name == "pvary" else ref[r["index"]]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert np.abs(got - want).max() <= _sum_bound(want), name


def test_compressed_psum_equals_reference_up_to_ties(reference, ranks):
    """``q`` and the scale against the reference's ``compress_grad`` per
    rank; the new residual equal to its eager one and within one fp32
    rounding of ``q * scale`` of its jitted ``shard_map`` one (XLA
    contracts the product and the difference into one fused multiply-add);
    the mean within one rounding of the jitted reference's."""
    inputs = _inputs()
    ref = reference[0]
    ties = 0
    for r in ranks[0]:
        i = r["index"]
        q, scale, res = ref_compression.compress_grad(
            jnp.asarray(inputs["grads"][i]),
            jnp.asarray(inputs["residuals"][i]))
        q, scale = np.asarray(q), float(scale)
        assert r["scale"] == scale
        diff = r["q"].astype(np.int32) - q.astype(np.int32)
        if diff.any():
            corrected = (inputs["grads"][i].astype(np.float64)
                         + inputs["residuals"][i]) / scale
            frac = np.abs(np.abs(corrected - np.trunc(corrected)) - 0.5)
            assert np.all(np.abs(diff) <= 1)
            assert np.all(frac[diff != 0] < TIE), "a non-tie rounded apart"
            ties += int((diff != 0).sum())
            continue
        np.testing.assert_array_equal(r["residual"], np.asarray(res))
        step = EPS32 * np.abs(q.astype(np.float32) * np.float32(scale))
        assert np.all(np.abs(r["residual"] - ref["cp/residual"][i]) <= step)
    # Ties are rare: a quotient within TIE of a half-integer.
    assert ties < 0.01 * inputs["grads"].size, ties
    for r in ranks[0]:
        np.testing.assert_array_equal(r["mean"], ranks[0][0]["mean"])
    if ties == 0:
        want = ref["cp/mean"][0]
        assert np.all(np.abs(ranks[0][0]["mean"] - want) <=
                      2 * EPS32 * np.abs(want))


def test_compressed_psum_tracks_the_exact_mean(ranks):
    """Each rank's ``q * scale + residual`` is its ``g + residual_prev``;
    the mean is ``sum_i q_i * max_i scale_i / n`` (the reference's
    formula, bit for bit), so against the exact mean of ``g + residual``
    it errs by at most ``sum_i (|q_i| |s_max - s_i| + s_i / 2) / n`` per
    element: half a quantum when the ranks' scales agree."""
    inputs = _inputs()
    rs = ranks[0]
    n = len(rs)
    s_max = np.float32(max(r["scale"] for r in rs))
    q_sum = sum(r["q"].astype(np.int32) for r in rs)
    mean = rs[0]["mean"]
    np.testing.assert_array_equal(
        mean, q_sum.astype(np.float32) * s_max / np.float32(n))
    exact = sum(inputs["grads"][r["index"]].astype(np.float64)
                + inputs["residuals"][r["index"]] for r in rs) / n
    bound = sum(np.abs(r["q"].astype(np.float64)) * (s_max - r["scale"])
                + r["scale"] / 2 for r in rs) / n
    assert np.all(np.abs(mean - exact) <= bound * (1 + 1e-6))
    for r in rs:
        i = r["index"]
        back = r["q"].astype(np.float32) * np.float32(r["scale"]) + \
            r["residual"]
        want = inputs["grads"][i] + inputs["residuals"][i]
        assert np.abs(back - want).max() <= 2 * EPS32 * np.abs(want).max()


def test_compressed_data_parallel_converges(ranks):
    for r in ranks[0]:
        assert r["err_comp"] < 0.1, r["err_comp"]
        assert abs(r["err_comp"] - r["err_exact"]) < 0.1
        assert r["err_comp"] == ranks[0][0]["err_comp"]


def test_elastic_restore_gives_each_rank_its_block(ranks):
    tree = {k: np.asarray(v, np.float32) for k, v in _tree()["params"].items()}
    for r in ranks[0]:
        di, mi = r["coords"]["data"], r["coords"]["model"]
        got = r["restored"]
        np.testing.assert_array_equal(
            got["w"], tree["w"][di * 4:(di + 1) * 4, mi * 4:(mi + 1) * 4])
        blk = di * 2 + mi
        np.testing.assert_array_equal(got["b"], tree["b"][blk * 4:
                                                          (blk + 1) * 4])
        np.testing.assert_array_equal(got["h"].astype(np.float32),
                                      tree["h"][:, mi * 3:(mi + 1) * 3])
        assert got["scalar"].shape == () and float(got["scalar"]) == 3.5


def test_counted_bytes_equal_ring_volumes(ranks):
    x_bytes = 8 * 6 * 4
    want = CollectiveLog(abstract_mesh((N,), ("x",)))
    want.add("all-reduce", ("x",), x_bytes, 1, "psum")
    want.add("all-gather", ("x",), N * x_bytes, 1, "all_gather")
    want.add("reduce-scatter", ("x",), x_bytes, 1, "psum_scatter")
    for r in ranks[0]:
        expect = dict(want.bytes)
        if r["index"] < N - 1:
            expect["collective-permute"] = x_bytes
        if r["index"] == 0:
            expect["broadcast"] = x_bytes
        assert r["ring"] == pytest.approx(expect), r["index"]
