"""The expert-parallel MoE FFN of the port against the reference's
``shard_map`` path, on four ranks.

The port runs one gloo world of four CPU ranks, ``(data=2, model=2)``
(``launch.spawn.run_world``; the ranks are ``tests/_multicard_ranks.py``),
with the reference test's layer (``tests/test_moe.py``: d 16, d_ff 32,
8 experts, top 2) drawn from a numpy seed.  The reference runs once, in a
subprocess with four host devices, on the same weights and tokens: its
``moe_ffn(..., ctx=ShardingCtx({}, mesh))`` on a 2 x 2 mesh, and, as the
gradient the sharded layer should have, the sum over the two data shards
of its unsharded ``moe_ffn`` on each shard's tokens (the capacity is
local to a shard).

Cases: ``capacity_factor`` 8.0 (no drops) and 1.25 (drops at the local
capacity), both at S = 16 (the output is ``psum_scatter``-ed along the
sequence), and 1.25 at S = 1 (``psum``).  Each compares the output and the
gradients of ``w_gate``, ``w_up``, ``w_down``, the router and the tokens.

Bounds (fp32 throughout): every compared leaf within ``RTOL`` of its
largest |value| (two fp32 computations of the same sums in another
order; the worst measured ratio is printed by the assertion).  A routing
near-tie could flip an expert between the packages, so every token's
top-k margin (k-th minus (k+1)-th probability, in float64) must exceed
``MARGIN``.  Two planted faults must break the output bound: the partial
sums left unsummed, and the experts' offset moved by one shard.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from _multicard_ranks import MOE_FAULTS, moe_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro_torch.core.collectives import CollectiveLog
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.spawn import run_world

ROOT = pathlib.Path(__file__).resolve().parent.parent
D, FF, E, K, B, S = 16, 32, 8, 2, 4, 16
RTOL = 1e-5
MARGIN = 1e-4
#: (case name, capacity factor, sequence length).
CASES = (("cf8", 8.0, S), ("cf1.25", 1.25, S), ("cf1.25-s1", 1.25, 1))


def _params() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {"router": (rng.standard_normal((D, E)) / np.sqrt(D)).astype(f32),
            "w_gate": (rng.standard_normal((E, D, FF)) / np.sqrt(D)
                       ).astype(f32),
            "w_up": (rng.standard_normal((E, D, FF)) / np.sqrt(D)).astype(f32),
            "w_down": (rng.standard_normal((E, FF, D)) / np.sqrt(FF)
                       ).astype(f32)}


def _tokens(seq: int) -> np.ndarray:
    return np.random.default_rng(1).standard_normal(
        (B, seq, D)).astype(np.float32)


_REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.models import moe
from repro.models.sharding_ctx import ShardingCtx

d = dict(np.load(sys.argv[1]))
params = {"router": {"kernel": jnp.asarray(d.pop("router"))},
          **{k: jnp.asarray(d.pop(k)) for k in ("w_gate", "w_up", "w_down")}}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ctx = ShardingCtx({}, mesh)
out = {}
for name in sorted(k[2:] for k in d if k.startswith("x_")):
    x = jnp.asarray(d["x_" + name])
    cf = float(d["cf_" + name])

    def sharded(p, x):
        y = moe.moe_ffn(p, x, k=2, num_experts=8, capacity_factor=cf,
                        ctx=ctx)
        return jnp.sum(y ** 2), y

    def per_shard(p, x):
        ys = [moe.moe_ffn(p, x[i * 2:(i + 1) * 2], k=2, num_experts=8,
                          capacity_factor=cf) for i in range(2)]
        y = jnp.concatenate(ys)
        return jnp.sum(y ** 2), y

    for tag, fn in (("sharded", sharded), ("local", per_shard)):
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            fn, argnums=(0, 1), has_aux=True))(params, x)
        out[f"{tag}/{name}/out"] = np.asarray(y)
        out[f"{tag}/{name}/g_router"] = np.asarray(gp["router"]["kernel"])
        for k in ("w_gate", "w_up", "w_down"):
            out[f"{tag}/{name}/g_{k[2:]}"] = np.asarray(gp[k])
        out[f"{tag}/{name}/g_x"] = np.asarray(gx)
np.savez(sys.argv[2], **out)
print("REF-MOE-OK", len(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_moe")
    inputs = dict(_params())
    for name, cf, seq in CASES:
        inputs["x_" + name] = _tokens(seq)
        inputs["cf_" + name] = np.float64(cf)
    np.savez(tmp / "in.npz", **inputs)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "HOME": str(tmp),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                        str(tmp / "in.npz"), str(tmp / "out.npz")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=str(ROOT))
    assert "REF-MOE-OK" in r.stdout, r.stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}, time.perf_counter() - t0


@pytest.fixture(scope="module")
def ranks():
    cases = [(name, _tokens(seq), K, cf) for name, cf, seq in CASES]
    t0 = time.perf_counter()
    res = run_world(moe_rank, 4, _params(), cases, threads=1, timeout=300)
    return res, time.perf_counter() - t0


def _assemble(ranks_out, case: str, key: str) -> np.ndarray:
    """The whole array from the ranks' blocks of ``key``."""
    res = ranks_out
    first = res[0][case]
    if key == "out":
        blocks = {(r["coords"]["data"], r["coords"]["model"]): r[case]["out"]
                  for r in res}
        if first["scattered"]:
            return np.concatenate([np.concatenate(
                [blocks[(di, mi)] for mi in range(2)], 1) for di in range(2)])
        return np.concatenate([blocks[(di, 0)] for di in range(2)])
    if key in ("g_gate", "g_up", "g_down"):
        full = np.zeros((E, D, FF) if key != "g_down" else (E, FF, D),
                        np.float32)
        for r in res:
            c, e0, el = r["coords"], r[case]["e0"], r[case]["e_loc"]
            lo = c["data"] * (D // 2)
            if key == "g_down":
                full[e0:e0 + el, :, lo:lo + D // 2] = r[case][key]
            else:
                full[e0:e0 + el, lo:lo + D // 2] = r[case][key]
        return full
    if key == "g_x":
        by_data = {r["coords"]["data"]: r[case]["g_x"] for r in res}
        return np.concatenate([by_data[0], by_data[1]])
    return first[key]


def _within(got, ref, what) -> None:
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert err <= RTOL * scale, (f"{what}: max |port - ref| {err:.3e} > "
                                 f"{RTOL} x {scale:.3e}")


def test_reference_and_world_stay_inside_their_limits(reference, ranks):
    assert reference[1] < 120.0 and ranks[1] < 120.0


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_routing_has_no_near_ties(case):
    seq = dict((c[0], c[2]) for c in CASES)[case]
    x = _tokens(seq).reshape(-1, D).astype(np.float64)
    logits = x @ _params()["router"].astype(np.float64)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    top = np.sort(p, axis=1)[:, ::-1]
    assert float((top[:, K - 1] - top[:, K]).min()) > MARGIN


@pytest.mark.parametrize("key", ["out", "g_gate", "g_up", "g_down",
                                 "g_router", "g_x"])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_expert_parallel_equals_reference_shard_map(case, key, reference,
                                                    ranks):
    ref, _ = reference
    got = _assemble(ranks[0], case, key)
    _within(got, ref[f"sharded/{case}/{key}"], f"{case} {key}")


@pytest.mark.parametrize("key", ["out", "g_gate", "g_up", "g_down",
                                 "g_router", "g_x"])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_expert_parallel_equals_per_shard_layer(case, key, reference,
                                                ranks):
    """Against the unsharded layer on each data shard's tokens: the
    function the sharded layer computes, capacity local."""
    ref, _ = reference
    got = _assemble(ranks[0], case, key)
    _within(got, ref[f"local/{case}/{key}"], f"{case} {key}")


def test_capacity_binds_at_1_25():
    """The 1.25 cases drop slots: their local capacity is below the
    largest expert load."""
    from repro_torch.models.moe import capacity
    x = _tokens(S)[:B // 2].reshape(-1, D)
    ids = np.argsort(-(x @ _params()["router"]), axis=1)[:, :K]
    load = np.bincount(ids.ravel(), minlength=E).max()
    assert capacity(x.shape[0], K, E, 1.25) < load <= \
        capacity(x.shape[0], K, E, 8.0)


@pytest.mark.parametrize("fault", MOE_FAULTS)
def test_planted_fault_is_rejected(fault, reference, ranks):
    ref, _ = reference
    res = ranks[0]
    got = _assemble([{**r, "cf8": r[fault]} for r in res], "cf8", "out")
    with pytest.raises(AssertionError):
        _within(got, ref["sharded/cf8/out"], fault)


def test_collective_bytes_equal_ring_volumes(ranks):
    """Each rank's counted bytes per kind: the FSDP gathers of the two
    weights (forward) and their gradients' reduce-scatter (backward), the
    output's reduce-scatter over "model" and its gradient's gather, and
    the router's and tokens' gradient sums."""
    res, _ = ranks
    mesh = abstract_mesh((2, 2), ("data", "model"))
    f32 = 4
    want = CollectiveLog(mesh)
    w_bytes = E // 2 * (D * 2 * FF + FF * D) * f32    # gathered whole
    out_bytes = B // 2 * S * D * f32
    for kind in ("all-gather", "reduce-scatter"):
        want.add(kind, ("data",), E // 2 * D * 2 * FF * f32, 1, "w_gate_up")
        want.add(kind, ("data",), E // 2 * FF * D * f32, 1, "w_down")
        want.add(kind, ("model",), out_bytes, 1, "output")
    want.add("all-reduce", ("model",), out_bytes, 1, "tokens' gradient")
    for axis in ("data", "model"):
        want.add("all-reduce", (axis,), D * E * f32, 1, "router gradient")
    assert w_bytes > 0
    for r in res:
        assert r["cf8"]["log"] == pytest.approx(dict(want.bytes)), r["coords"]
