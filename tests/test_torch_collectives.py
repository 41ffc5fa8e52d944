"""Collectives from the sharding policy (``repro_torch.core.collectives``)
and per-device counts on a 2 x 2 mesh.

* Hand-derived per-kind bytes for reduced llama3.2-1b (2 layers, d = 64)
  on ``{data: 2, model: 2}``: FSDP gathers, gradient reduce-scatters,
  sequence-parallel gathers and scatters, the vocab-split embedding and
  loss.
* Against the reference's HLO: one subprocess (``JAX_PLATFORMS=cpu``,
  four host devices) lowers the reference's ``make_train_step`` and
  ``make_serve_step`` for reduced llama3.2-1b and olmoe-1b-7b on
  ``jax.make_mesh((2, 2), ("data", "model"))`` and returns
  ``analyze_hlo``'s per-device FLOPs and collective bytes.
  - Per-device FLOPs: equal for the dense model; for the MoE, at least the
    reference's and at most its expert padding ratio, ``C_pad(T) / (dp *
    C(T / dp))`` (the port pads the global capacity, the reference's
    shards bucket their local tokens).
  - Total collective bytes: port / reference within 5 % of the ratio
    measured on the CPU for each case (``BANDS``; ``PERF.md`` gives both
    sides per kind).  The ratios are not 1: XLA all-reduces activation
    gradients whole where the policy's sequence parallelism
    reduce-scatters them (ring volumes here, operand bytes there), and
    adds all-to-alls for the grouped-query heads.
  - Planted faults fall outside the band: the gradients' reduce-scatter
    dropped, or each FSDP gather counted once per step rather than per
    use.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import collectives as COLL
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MS
from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

MESH = MS.abstract_mesh((2, 2), ("data", "model"))
B, S, CACHE = 4, 16, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: port / reference total collective bytes, measured on the CPU (jax
#: 0.9.0's CPU partitioner, these shapes): 444,032 / 715,840, 77,952 /
#: 78,464, 1,103,488 / 1,293,384 and 241,792 / 242,304 bytes per device;
#: each case is held within 5 %.
BANDS = {"llama3.2-1b/train": 0.6203, "llama3.2-1b/decode": 0.9935,
         "olmoe-1b-7b/train": 0.8532, "olmoe-1b-7b/decode": 0.9979}
BAND = 0.05


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setattr(M, "COMPUTE_DTYPE", torch.float32)


def _shape(kind):
    if kind == "decode":
        return ShapeConfig("d", CACHE, B, "decode")
    return ShapeConfig("t", S, B, "train")


def port_side(arch, kind):
    """The port's per-device FLOPs and collective log."""
    cfg = get_config(arch).reduced()
    shape = _shape(kind)
    count = DR.count_step(cfg, shape, MESH)
    model, _ = DR.abstract_state(cfg, shape, kind)
    params = dict(model.named_parameters())
    log = COLL.step_collectives(
        cfg, shape, MESH,
        params={n: (tuple(p.shape), p.element_size())
                for n, p in params.items()},
        specs=SH.param_pspecs(cfg, params, MESH),
        constraints=count.constraints, kinds=M.layer_kinds(cfg),
        compute_itemsize=4)
    return count.flops_per_device, log


def test_hand_derived_bytes(fp32):
    _, log = port_side("llama3.2-1b", "train")
    got, launches = log.summary()
    f4 = 4
    # FSDP: (n-1)/n of each data-split weight's model shard, 3 uses.
    # Per layer: wq [64,64], wk/wv [64,32], wo [64,64], wi_gate/wi_up
    # [64,128], wo [128,64]; all split (data, model) or (model, data).
    per_layer = (64 * 64 + 2 * 64 * 32 + 64 * 64 + 2 * 64 * 128
                 + 128 * 64) // 2
    fsdp = 2 * 3 * 0.5 * per_layer * f4
    # Sequence parallelism: B/2 rows x S x d, 2 sublayers x 2 layers, AG
    # and RS each x 3 passes; the embedding RS and its gradient AG, the
    # head input's AG and its gradient RS.
    tok = B // 2 * S * 64 * f4
    sp = 0.5 * tok * 3 * 2 * 2
    assert got["all-gather"] == pytest.approx(fsdp + sp + 0.5 * tok * 2)
    grads = 0.5 * 2 * per_layer * f4
    assert got["reduce-scatter"] == pytest.approx(grads + sp +
                                                  0.5 * tok * 2)
    # all-reduce (twice (n-1)/n = 1): the gradients of the weights that
    # data does not split, over data (the embedding table [256, 64], split
    # over model only; two norm scales per layer and the final norm), and
    # the loss's max, sum and gold logit.
    table = 256 * 64 // 2 * f4
    norms = (2 * 2 + 1) * 64 * f4
    loss = 3 * (B // 2 * S * 4)
    assert got["all-reduce"] == pytest.approx(table + norms + loss)
    assert got["total"] == pytest.approx(sum(got[k] for k in COLL.KINDS))
    assert launches["all-gather"] == 2 * 3 * 7 + 3 * 2 * 2 + 2
    rows = log.top_contributors(k=100)
    assert [v for v, _ in rows] == sorted((v for v, _ in rows),
                                          reverse=True)
    assert sum(v for v, _ in rows) == pytest.approx(got["total"])
    assert rows[0] == (pytest.approx(fsdp),
                       "all-gather over data: FSDP weight gather")


@pytest.fixture(scope="module")
def reference():
    code = r'''
import json, jax, jax.numpy as jnp
from repro.configs.base import get_config, ShapeConfig
from repro.models import model as M
from repro.train import train_step as TS
from repro.optim import adamw
from repro.core import hlo_flops as HF
M.COMPUTE_DTYPE = jnp.float32
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
B, S, CACHE = %d, %d, %d
i32 = jnp.int32
for arch in ("llama3.2-1b", "olmoe-1b-7b"):
    cfg = get_config(arch).reduced()
    params = jax.eval_shape(lambda k: M.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    with mesh:
        opt = adamw.AdamWConfig()
        fn, _ = TS.make_train_step(cfg, ShapeConfig("t", S, B, "train"),
                                   mesh, opt_cfg=opt)
        st = jax.eval_shape(lambda p: adamw.init_state(p, opt), params)
        toks = jax.ShapeDtypeStruct((B, S), i32)
        txt = fn.lower(params, st, {"tokens": toks, "labels": toks},
                       jax.ShapeDtypeStruct((), i32)).compile().as_text()
        a = HF.analyze_hlo(txt)
        out[arch + "/train"] = [a["flops"], a["collective_bytes"]]
        fn, _ = TS.make_serve_step(cfg, ShapeConfig("d", CACHE, B,
                                                    "decode"), mesh)
        cache = jax.eval_shape(lambda: M.init_cache(cfg, B, CACHE))
        txt = fn.lower(params, cache, jax.ShapeDtypeStruct((B,), i32),
                       jax.ShapeDtypeStruct((), i32)).compile().as_text()
        a = HF.analyze_hlo(txt)
        out[arch + "/decode"] = [a["flops"], a["collective_bytes"]]
print("RESULT " + json.dumps(out))
''' % (B, S, CACHE)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="src",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    line = [ln for ln in run.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _padding_ratio(cfg, tokens: int) -> float:
    dp = MESH.shape["data"]
    k, e, cf = (cfg.num_experts_per_token, cfg.num_experts,
                cfg.moe_capacity_factor)
    local = MOE.capacity(tokens // dp, k, e, cf)
    return MOE.padded_capacity(MOE.capacity(tokens, k, e, cf)) / (dp * local)


@pytest.mark.parametrize("case", sorted(BANDS))
def test_against_reference_hlo(case, reference, fp32):
    arch, kind = case.split("/")
    ref_flops, ref_coll = reference[case]
    flops, log = port_side(arch, kind)
    cfg = get_config(arch).reduced()
    if cfg.num_experts:
        tokens = B * (S if kind == "train" else 1)
        assert 1.0 <= flops / ref_flops <= _padding_ratio(cfg, tokens)
    else:
        assert flops == ref_flops
    ratio = log.summary()[0]["total"] / ref_coll["total"]
    assert abs(ratio / BANDS[case] - 1) <= BAND, (case, ratio)


def _with_fault(fault):
    orig = COLL.CollectiveLog.add

    def add(self, kind, axes, size, times, what):
        if fault == "no gradient reduce-scatter" and \
                kind == "reduce-scatter" and what == "gradient":
            return
        if fault == "FSDP gather once" and what == "FSDP weight gather":
            times = 1
        orig(self, kind, axes, size, times, what)
    return add


@pytest.mark.parametrize("fault", ["no gradient reduce-scatter",
                                   "FSDP gather once"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
def test_planted_faults_leave_the_band(arch, fault, reference, fp32,
                                       monkeypatch):
    case = arch + "/train"
    monkeypatch.setattr(COLL.CollectiveLog, "add", _with_fault(fault))
    _, log = port_side(arch, "train")
    ratio = log.summary()[0]["total"] / reference[case][1]["total"]
    assert abs(ratio / BANDS[case] - 1) > BAND, (case, fault, ratio)
