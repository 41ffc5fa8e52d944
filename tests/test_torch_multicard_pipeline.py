"""The port's GPipe pipeline (``train/pipeline.py``) against the
reference's ``pipeline_apply``, on four ranks.

The reference test's case (``tests/test_pipeline.py``): S = 4 stages,
L = 8 layers of ``tanh(h @ w)``, D = 16, 6 microbatches of 4 rows, the
weights and the stream drawn from a numpy seed.  The port runs one gloo
world of four CPU ranks on a ``(stage=4)`` mesh (the ranks are
``tests/_multicard_ranks.py``); the reference runs once, in a subprocess
with four host devices, its ``pipeline_apply`` and ``jax.grad`` of
``sum(out ** 2)`` through it, and its sequential stack.

Bounds: the reference test's own, outputs within ``rtol = atol = 2e-5``
and stage gradients within ``1e-4``, against the reference's pipeline and
against its sequential stack.  A planted fault, the hops' permutation
reversed (stage ``i + 1`` to ``i``), must break the output bound.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from _multicard_ranks import pipeline_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro_torch.launch.spawn import run_world
from repro_torch.train.pipeline import split_stages, stage_perm

ROOT = pathlib.Path(__file__).resolve().parent.parent
S, L, D, N_MICRO, MB = 4, 8, 16, 6, 4
OUT_TOL, GRAD_TOL = 2e-5, 1e-4


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return ws, x


_REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.train.pipeline import pipeline_apply, split_stages

d = np.load(sys.argv[1])
Ws, x = jnp.asarray(d["ws"]), jnp.asarray(d["x"])
S, L = 4, Ws.shape[0]
mesh = jax.make_mesh((S,), ("stage",), axis_types=(AxisType.Auto,))

def block_fn(params, h):
    def body(h, w):
        return jnp.tanh(h @ w), None
    out, _ = jax.lax.scan(body, h, params)
    return out

def loss(sp):
    y = pipeline_apply(block_fn, sp, x, mesh=mesh)
    return jnp.sum(y ** 2), y

(_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
    split_stages(Ws, S))

def seq(w):
    def one(h):
        for i in range(L):
            h = jnp.tanh(h @ w[i])
        return h
    y = jax.vmap(one)(x)
    return jnp.sum(y ** 2), y

(_, y_seq), g_seq = jax.jit(jax.value_and_grad(seq, has_aux=True))(Ws)
np.savez(sys.argv[2], out=np.asarray(y), grad=np.asarray(g),
         out_seq=np.asarray(y_seq),
         grad_seq=np.asarray(split_stages(g_seq, S)))
print("REF-PIPELINE-OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_pipeline")
    ws, x = _inputs()
    np.savez(tmp / "in.npz", ws=ws, x=x)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "HOME": str(tmp),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                        str(tmp / "in.npz"), str(tmp / "out.npz")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=str(ROOT))
    assert "REF-PIPELINE-OK" in r.stdout, r.stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}, time.perf_counter() - t0


@pytest.fixture(scope="module")
def ranks():
    ws, x = _inputs()
    t0 = time.perf_counter()
    res = run_world(pipeline_rank, 4, ws, x, threads=1, timeout=300)
    return sorted(res, key=lambda r: r["stage"]), time.perf_counter() - t0


def test_reference_and_world_stay_inside_their_limits(reference, ranks):
    assert reference[1] < 120.0 and ranks[1] < 120.0


@pytest.mark.parametrize("against", ["out", "out_seq"])
def test_every_stage_holds_the_reference_outputs(against, reference, ranks):
    ref = reference[0][against]
    for r in ranks[0]:
        np.testing.assert_allclose(r["good"]["out"], ref, rtol=OUT_TOL,
                                   atol=OUT_TOL, err_msg=f"stage {r['stage']}")


@pytest.mark.parametrize("against", ["grad", "grad_seq"])
@pytest.mark.parametrize("stage", range(S))
def test_stage_gradients_equal_reference(stage, against, reference, ranks):
    np.testing.assert_allclose(ranks[0][stage]["good"]["grad"],
                               reference[0][against][stage], rtol=GRAD_TOL,
                               atol=GRAD_TOL)


def test_reversed_perm_is_rejected(reference, ranks):
    ref = reference[0]["out"]
    for r in ranks[0]:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(r["reversed perm"]["out"], ref,
                                       rtol=OUT_TOL, atol=OUT_TOL)


def test_hops_and_final_sum_are_counted(ranks):
    """Forward: ``T = n_micro + S - 1`` hops of an ``[mb, D]`` fp32 buffer
    from every stage but the last, and the outputs' all-reduce; backward:
    the same hops from every stage but the first, and the all-reduce
    again."""
    T = N_MICRO + S - 1
    hop = MB * D * 4
    outs = N_MICRO * MB * D * 4
    for r in ranks[0]:
        sends = T * ((r["stage"] < S - 1) + (r["stage"] > 0))
        log = r["good"]["log"]
        assert log["collective-permute"] == sends * hop
        assert log["all-reduce"] == 2 * 2 * (S - 1) / S * outs


def test_split_stages_and_perm():
    import torch
    ws, _ = _inputs()
    st = split_stages(torch.from_numpy(ws), S)
    assert st.shape == (S, L // S, D, D)
    assert np.array_equal(st[1, 0].numpy(), ws[L // S])
    tree = split_stages({"a": torch.zeros(L, 3)}, S)
    assert tree["a"].shape == (S, L // S, 3)
    with pytest.raises(ValueError, match="do not split"):
        split_stages(torch.zeros(6, 2), S)
    assert stage_perm(S) == [(0, 1), (1, 2), (2, 3)]
