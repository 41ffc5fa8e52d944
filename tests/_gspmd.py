"""Shared cases, reference runs and checks of the partitioned-step tests
(``tests/test_torch_gspmd_{train,train_moe,prefill,trainer}.py``).

The port runs its partitioned steps in one world of four gloo CPU ranks
per test module (``tests/_gspmd_ranks.py``).  The reference runs the same
cases once per module, in one subprocess with four host devices
(``--xla_force_host_platform_device_count=4``): its ``make_train_step``
/ ``make_prefill_step`` with a mesh of ``axis_types=(AxisType.Auto,) *
n`` (jax 0.9's default ``Explicit`` axes cannot differentiate through the
MoE's ``shard_map``), on the same weights (``_torch_train_helpers.
_weights``) and batches (numpy from a seed), at fp32 in both packages.
It writes every step's metrics and whole parameter / ``mu`` / ``nu``
arrays to an npz, and each leaf's spec and the index of every mesh
position's shard to a json file.  The subprocess starts before the world
and runs beside it.

A rank's block is held against the reference's shard on the device at
the rank's mesh coordinates: its index must equal the port's block (and
the specs must be the same), and its values must pass
``_torch_train_helpers``' bounds.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

from _gspmd_ranks import LR, SCHEDULE, flat
from _torch_train_helpers import _weights
from repro.configs.base import get_config as ref_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, S = 4, 32

_REF_HEAD = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.base import ShapeConfig, get_config
from repro.models import model as M
from repro.optim import adamw
from repro.train import train_step as TS

M.COMPUTE_DTYPE = jnp.float32
cases = json.load(open(sys.argv[1]))
data = np.load(sys.argv[2])


def nest(prefix):
    tree = {}
    for k in data.files:
        if k.startswith(prefix):
            node = tree
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(data[k])
    return tree


def flat(tree, prefix=""):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(p.key) for p in path)] = leaf
    return out


def spec_of(spec, ndim):
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(list(e) if isinstance(e, tuple) else e)
    return out


def where(arr, mesh):
    idx = arr.sharding.devices_indices_map(arr.shape)
    out = {}
    for pos in np.ndindex(mesh.devices.shape):
        sl = idx[mesh.devices[pos]]
        out[",".join(map(str, pos))] = [
            [s.start or 0, arr.shape[i] if s.stop is None else s.stop]
            for i, s in enumerate(sl)]
    return {"spec": spec_of(arr.sharding.spec, arr.ndim), "index": out}
"""

_REF_SCRIPT = _REF_HEAD + r"""
LR, SCHEDULE = json.loads(sys.argv[5])
out, info = {}, {}
for case in cases:
    name = case["name"]
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              **case.get("overrides", {}))
    axes = tuple(case["axes"])
    mesh = jax.make_mesh(tuple(case["shape"]), axes,
                         axis_types=(AxisType.Auto,) * len(axes))
    M.set_fused_projections(bool(case.get("fused")))
    tree = nest(name + "/w/")
    kind = case["kind"]
    shape = ShapeConfig("t", case["seq"], case["batch"], kind)
    if kind == "prefill":
        fn, sh = TS.make_prefill_step(cfg, shape, mesh)
        params = jax.device_put(tree, sh["params"])
        logits = fn(params, {k: jnp.asarray(data[f"{name}/{k}"])
                             for k in sh["batch"]})
        out[name + "/logits"] = np.asarray(logits)
        info[name] = {"logits": where(logits, mesh)}
        continue
    if kind == "prime":
        # whisper's cross cache: the encoder and prime_cross_cache on the
        # whole arrays, the cache's specs and each device's shard index.
        from repro.launch import sharding as SH
        dshape = ShapeConfig("d", case["cache_len"], case["batch"], "decode")
        enc = jax.jit(lambda p, f: M._run_encoder(cfg, p, f, TS.NO_SHARDING,
                                                   remat=False))(
            tree, jnp.asarray(data[name + "/frames"]))
        cache = jax.jit(lambda p, e: M.prime_cross_cache(
            cfg, p, M.init_cache(cfg, case["batch"], case["cache_len"]),
            e))(tree, enc)
        cspecs = SH.cache_pspecs(cfg, mesh, dshape, cache)
        cache = jax.device_put(cache, SH.named(mesh, cspecs))
        out[name + "/enc_out"] = np.asarray(enc)
        info[name] = {}
        for k in ("cross_k", "cross_v"):
            out[f"{name}/{k}"] = np.asarray(cache["p0"][k])
            info[name][k] = where(cache["p0"][k], mesh)
        continue
    fn, sh = TS.make_train_step(cfg, shape, mesh,
                                opt_cfg=adamw.AdamWConfig(lr=LR),
                                grad_accum=case.get("grad_accum", 1),
                                chunked_loss=bool(case.get("chunked")),
                                schedule_kwargs=SCHEDULE)
    params = jax.device_put(tree, sh["params"])
    opt = jax.device_put(adamw.init_state(params, adamw.AdamWConfig(lr=LR)),
                         sh["opt"])
    metrics = []
    for s in range(case["steps"]):
        batch = {k: data[f"{name}/b{s}/{k}"] for k in sh["batch"]}
        batch = jax.device_put(batch, {k: sh["batch"][k] for k in batch})
        params, opt, m = fn(params, opt, batch, jnp.int32(s + 1))
        metrics.append({k: float(v) for k, v in m.items()})
        for tag, tree_ in (("params", params), ("mu", opt["mu"]),
                           ("nu", opt["nu"])):
            for k, v in flat(tree_).items():
                out[f"{name}/s{s}/{tag}/{k}"] = np.asarray(v)
    info[name] = {"metrics": metrics,
                  "params": {k: where(v, mesh)
                             for k, v in flat(params).items()},
                  "mu": {k: where(v, mesh)
                         for k, v in flat(opt["mu"]).items()}}
np.savez(sys.argv[3], **out)
json.dump(info, open(sys.argv[4], "w"))
print("REF-GSPMD-OK", len(out))
"""


#: The serve step's reference run: per case, each step's logits, the
#: final cache, the specs and every device's shard index of the logits,
#: the cache and the parameters; a case whose step raises ``ValueError``
#: records the message instead.  whisper's cross K/V are taken from the
#: inputs (``{name}/cross_k``, ``{name}/cross_v``), not left zero.
_SERVE_SCRIPT = _REF_HEAD + r"""
out, info = {}, {}
for case in cases:
    name = case["name"]
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              **case.get("overrides", {}))
    axes = tuple(case["axes"])
    mesh = jax.make_mesh(tuple(case["shape"]), axes,
                         axis_types=(AxisType.Auto,) * len(axes))
    shape = ShapeConfig("d", case["cache_len"], case["batch"], "decode")
    try:
        fn, sh = TS.make_serve_step(cfg, shape, mesh)
        params = jax.device_put(nest(name + "/w/"), sh["params"])
        cache = M.init_cache(cfg, case["batch"], case["cache_len"])
        if cfg.family == "encdec":
            cache["p0"]["cross_k"] = jnp.asarray(data[name + "/cross_k"])
            cache["p0"]["cross_v"] = jnp.asarray(data[name + "/cross_v"])
        cache = jax.device_put(cache, sh["cache"])
        tokens = data[name + "/tokens"]
        for t in range(case["steps"]):
            logits, cache = fn(params, cache, jnp.asarray(tokens[t]),
                               jnp.int32(t))
            out[f"{name}/logits{t}"] = np.asarray(logits)
    except ValueError as e:
        info[name] = {"error": str(e)}
        continue
    for k, v in flat(cache).items():
        out[f"{name}/cache/{k}"] = np.asarray(v)
    info[name] = {"logits": where(logits, mesh),
                  "cache": {k: where(v, mesh) for k, v in flat(cache).items()},
                  "params": {k: where(v, mesh)
                             for k, v in flat(params).items()}}
np.savez(sys.argv[3], **out)
json.dump(info, open(sys.argv[4], "w"))
print("REF-GSPMD-OK", len(out))
"""


def case(name: str, arch: str, shape, axes=("data", "model"), *,
         kind: str = "train", steps: int = 3, batch: int = B,
         **extra) -> dict:
    """One case: an arch's reduced config (``overrides``) on a mesh, at
    ``batch`` (default :data:`B`) x :data:`S`."""
    return {"name": name, "arch": arch, "shape": list(shape),
            "axes": list(axes), "kind": kind, "steps": steps,
            "batch": batch, "seq": S, **extra}


def ref_cfg(c: dict):
    import dataclasses
    return dataclasses.replace(ref_config(c["arch"]).reduced(),
                               **c.get("overrides", {}))


def batch(cfg, seed: int, rows: int = B, seq: int = S) -> dict:
    """Tokens and labels from ``seed``, and the modality stubs of
    ``cfg``'s family (:func:`modality_stubs`)."""
    seqs = np.random.default_rng(seed).integers(
        2, cfg.vocab_size - 1, size=(rows, seq + 1)).astype(np.int32)
    return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:],
            **modality_stubs(cfg, seed, rows, seq)}


#: qwen2-vl's patch embeddings per row in the partitioned-step tests: more
#: than a quarter of the sequence (the pipeline's count), so that at S = 32
#: on ``model=4`` (blocks of 8 rows) they cross a block boundary.
N_MM = 12


def modality_stubs(cfg, seed: int, rows: int, seq: int) -> dict:
    """whisper's frames ``[rows, encoder_seq, d]``; qwen2-vl's
    ``mm_embeds [rows, N_MM, d]`` and M-RoPE positions ``[3, rows, seq]``
    (temporal ``arange``; height and width on an ``N_MM``-patch grid, as
    ``data.pipeline`` lays them out); N(0, 1) from ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    out = {}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(rows, cfg.encoder_seq,
                                         cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        n_mm = min(N_MM, seq)
        out["mm_embeds"] = rng.normal(size=(rows, n_mm,
                                            cfg.d_model)).astype(np.float32)
        t = np.tile(np.arange(seq, dtype=np.int32), (rows, 1))
        h, w = t.copy(), t.copy()
        grid = int(np.sqrt(n_mm))
        h[:, :n_mm] = np.arange(n_mm) // grid
        w[:, :n_mm] = np.arange(n_mm) % grid
        out["positions_3d"] = np.stack([t, h, w])
    return out


def inputs(cases: list) -> tuple:
    """Per case: the weights (flat, the reference's layout; fused where the
    case says so) and the batches (the prefill's without labels; the
    cross cache's frames)."""
    from repro.models import model as ref_model
    weights, batches = {}, {}
    for c in cases:
        cfg = ref_cfg(c)
        ref_model.set_fused_projections(bool(c.get("fused")))
        try:
            weights[c["name"]] = flat(_weights(cfg))
        finally:
            ref_model.set_fused_projections(False)
        if c["kind"] == "train":
            batches[c["name"]] = [batch(cfg, s, c["batch"], c["seq"])
                                  for s in range(c["steps"])]
        elif c["kind"] == "decode":
            batches[c["name"]] = serve_inputs(cfg, c)
        elif c["kind"] == "prime":
            batches[c["name"]] = {"frames": batch(cfg, 0, c["batch"],
                                                  c["seq"])["frames"]}
        else:
            whole = batch(cfg, 0, c["batch"], c["seq"])
            del whole["labels"]
            batches[c["name"]] = whole
    return weights, batches


#: The serve cases' cache length and steps: 24 steps from an empty
#: 32-slot cache fill its blocks in order, so a block with no valid slot
#: is met.
CACHE_LEN, SERVE_STEPS = 32, 24


def serve_case(name: str, arch: str, shape, axes=("data", "model"), *,
               batch: int = B, **extra) -> dict:
    """One serve case: :data:`SERVE_STEPS` decode steps of an arch's
    reduced config (``overrides``) on a mesh, from an empty
    :data:`CACHE_LEN`-slot cache."""
    return case(name, arch, shape, axes, kind="decode", steps=SERVE_STEPS,
                batch=batch, cache_len=CACHE_LEN, **extra)


def serve_inputs(cfg, c: dict) -> dict:
    """A serve case's inputs from a seed: each step's tokens ``[steps,
    B]``, and for ``encdec`` the cross K/V ``[layers, B, encoder_seq, Hkv,
    D]`` drawn from N(0, 1) (zeros would leave the cross-attention
    unchecked)."""
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(2, cfg.vocab_size - 1,
                                  size=(c["steps"], c["batch"]))
           .astype(np.int32)}
    if cfg.family == "encdec":
        shape = (cfg.num_layers, c["batch"], cfg.encoder_seq,
                 cfg.num_kv_heads, cfg.head_dim)
        out["cross_k"] = rng.normal(size=shape).astype(np.float32)
        out["cross_v"] = rng.normal(size=shape).astype(np.float32)
    return out


def start_reference(cases: list, weights: dict, batches: dict,
                    tmp: pathlib.Path,
                    script: str = _REF_SCRIPT) -> subprocess.Popen:
    """Start the reference's subprocess on four host devices: ``script``
    on the cases, their weights and their batches (the train steps'
    batches, or the prefill's, the cross cache's or the serve step's
    inputs by key)."""
    arrays = {}
    for c in cases:
        name = c["name"]
        for k, v in weights[name].items():
            arrays[f"{name}/w/{k}"] = v
        if c["kind"] == "train":
            for s, b in enumerate(batches[name]):
                for k, v in b.items():
                    arrays[f"{name}/b{s}/{k}"] = v
        else:
            for k, v in batches[name].items():
                arrays[f"{name}/{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    (tmp / "cases.json").write_text(json.dumps(cases))
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "HOME": str(tmp),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    return subprocess.Popen(
        [sys.executable, "-c", script, str(tmp / "cases.json"),
         str(tmp / "in.npz"), str(tmp / "out.npz"), str(tmp / "info.json"),
         json.dumps([LR, SCHEDULE])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))


def finish_reference(proc: subprocess.Popen, tmp: pathlib.Path) -> tuple:
    """Wait for the reference; ``(arrays, info)``."""
    try:
        stdout, stderr = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "REF-GSPMD-OK" in stdout, stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads((tmp / "info.json").read_text())


def run_module(cases: list, rank_fn, tmp: pathlib.Path) -> dict:
    """A test module's run: the reference's subprocess and the port's
    world side by side, with the cases by name."""
    from repro_torch.launch.spawn import run_world
    weights, batches = inputs(cases)
    t0 = time.perf_counter()
    script = _SERVE_SCRIPT if cases[0]["kind"] == "decode" else _REF_SCRIPT
    proc = start_reference(cases, weights, batches, tmp, script)
    try:
        ranks = run_world(rank_fn, 4, cases, weights, batches, threads=1,
                          timeout=300)
    except BaseException:
        proc.kill()
        raise
    world_s = time.perf_counter() - t0
    arrays, info = finish_reference(proc, tmp)
    return {"ranks": ranks, "ref": arrays, "info": info,
            "world_s": world_s, "seconds": time.perf_counter() - t0,
            "cases": {c["name"]: c for c in cases}, "weights": weights}


def position(c: dict, coords: dict) -> str:
    """A rank's mesh position, as the reference's index keys write it."""
    return ",".join(str(coords[a]) for a in c["axes"])


def port_spec(spec: tuple, ndim: int) -> list:
    """A port spec as the reference's json writes one, with the leading
    group dim of a stacked leaf."""
    entries = [list(e) if isinstance(e, tuple) else e for e in spec]
    return [None] * (ndim - len(entries)) + entries


def ref_shard(arr: np.ndarray, index: list) -> np.ndarray:
    return arr[tuple(slice(a, b) for a, b in index)]


#: Reference leaf (less the ``layers/p0/`` group prefix) -> the port
#: parameter name's suffix it comes from.
_LEAF_OF = {"moe/w_gate": "moe.w_gate_up", "moe/w_up": "moe.w_gate_up",
            "moe/router/kernel": "moe.router"}


def port_name(leaf: str) -> str:
    """The port's parameter name of a reference leaf (of a stacked one,
    its first group's layer: kind ``j`` of the pattern is layer ``j``, an
    encoder leaf is encoder layer 0)."""
    m = re.match(r"layers/p(\d+)/(.*)", leaf)
    if m:
        rest = m.group(2)
        return f"layers.{m.group(1)}." + _LEAF_OF.get(
            rest, rest.replace("/", "."))
    if leaf.startswith("encoder/layers/"):
        return "encoder.layers.0." + \
            leaf[len("encoder/layers/"):].replace("/", ".")
    return leaf.replace("/", ".")


# --------------------------------------------------------------------- #
# Checks.
# --------------------------------------------------------------------- #

def _fake_mesh(c: dict, coords: dict):
    from repro_torch.launch.mesh import ProcessMesh
    import torch
    return ProcessMesh(axis_names=tuple(c["axes"]),
                       shape=dict(zip(c["axes"], c["shape"])),
                       coords=dict(coords), rank=0,
                       device=torch.device("cpu"), backend="gloo",
                       groups={}, group_ranks={}, log=None)


def _as_spec(entries: list) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def check_specs(runs: dict, name: str) -> None:
    """Every parameter's spec equals the reference's leaf's (with the
    leading group dim of a stacked leaf)."""
    info = runs["info"][name]["params"]
    specs = runs["ranks"][0][name]["specs"]
    for leaf, where in info.items():
        got = port_spec(specs[port_name(leaf)], len(where["spec"]))
        assert got == where["spec"], (leaf, got, where["spec"])


def check_blocks_placed(runs: dict, name: str) -> None:
    """Each rank's block of every leaf is the reference's shard on the
    device at its mesh position: the same index (the port's
    ``block_slices`` of the spec on the rank's coordinates) and shape."""
    from repro_torch.launch.sharding import block_slices
    c = runs["cases"][name]
    info = runs["info"][name]["params"]
    for r in runs["ranks"]:
        pos = position(c, r[name]["coords"])
        mesh = _fake_mesh(c, r[name]["coords"])
        blocks = r[name]["params"][-1]
        for leaf, where in info.items():
            index = where["index"][pos]
            whole = tuple(runs["ref"][f"{name}/s0/params/{leaf}"].shape)
            mine = block_slices(_as_spec(where["spec"]), whole, mesh)
            assert [[s.start, s.stop] for s in mine] == index, (leaf, pos)
            assert blocks[leaf].shape == tuple(b - a for a, b in index), \
                (leaf, pos, blocks[leaf].shape)


def check_metrics_all_ranks(runs: dict, name: str) -> None:
    """Loss, ``grad_norm`` and ``lr_scale`` within ``_check_metrics``'
    bounds of the reference's at every step, the same on every rank."""
    from _torch_train_helpers import _check_metrics
    want = runs["info"][name]["metrics"]
    first = runs["ranks"][0][name]["metrics"]
    _check_metrics(want, first)
    for r in runs["ranks"][1:]:
        assert r[name]["metrics"] == first


def _shards(runs: dict, name: str, r: dict, tag: str, s: int) -> dict:
    c = runs["cases"][name]
    pos = position(c, r[name]["coords"])
    info = runs["info"][name]["params"]
    return {leaf: ref_shard(runs["ref"][f"{name}/s{s}/{tag}/{leaf}"],
                            info[leaf]["index"][pos]) for leaf in info}


def _replicas(c: dict, spec: list) -> int:
    """Ranks that hold the same block of a leaf of ``spec``."""
    sizes = dict(zip(c["axes"], c["shape"]))
    world = int(np.prod(c["shape"]))
    split = 1
    for entry in spec:
        for a in (entry if isinstance(entry, list) else [entry]):
            if a is not None:
                split *= sizes[a]
    return world // split


def check_params_per_step(runs: dict, name: str) -> None:
    """After each step, every element of each rank's parameter blocks
    passes the element rule of ``_torch_train_helpers`` (on the port's
    gradients of that block so far) against the reference's shard, and
    at most ``MAX_UNRESOLVED`` of the model's elements go uncompared: the
    share over the whole model, each block counted once however many
    ranks hold it (a rank's blocks alone over-weight the leaves that are
    split least, such as a sparse embedding table)."""
    from _torch_train_helpers import MAX_UNRESOLVED, _check_elements
    c = runs["cases"][name]
    info = runs["info"][name]["params"]
    lr = [m["lr_scale"] for m in runs["info"][name]["metrics"]]
    for s in range(c["steps"]):
        total = unresolved = 0.0
        for r in runs["ranks"]:
            res = r[name]
            counts = _check_elements(_shards(runs, name, r, "params", s),
                                     res["params"][s], res["grads"][:s + 1],
                                     lr[:s + 1])
            for leaf, (n, u) in counts.items():
                w = 1.0 / _replicas(c, info[leaf]["spec"])
                total += n * w
                unresolved += u * w
        share = unresolved / total
        assert share <= MAX_UNRESOLVED, \
            f"step {s + 1}: unresolved share {share:.3f}"


def check_opt_state(runs: dict, name: str) -> None:
    """After step ``k``, each rank's ``mu`` / ``nu`` blocks against the
    reference's shards, within what the gradients' agreement allows: each
    gradient within ``GRAD_RTOL * G`` (``G`` the largest |gradient| of the
    whole leaf over the steps so far, the port's, all ranks) and the clip
    scale within ``GRAD_RTOL`` relative (``grad_norm``'s bound), so ``|mu
    - mu_ref| <= 2 * GRAD_RTOL * (1 - b1**k) * G`` and ``|nu - nu_ref| <=
    4 * GRAD_RTOL * (1 - b2**k) * G**2`` (nu is a sum of squares), with
    ``8 * eps32`` of the value for their own roundings."""
    from _torch_train_helpers import EPS32, GRAD_RTOL
    b1, b2 = 0.9, 0.95
    c = runs["cases"][name]
    for s in range(c["steps"]):
        k = s + 1
        scale = {leaf: max(float(np.abs(r[name]["grads"][t][leaf]).max())
                           for r in runs["ranks"] for t in range(k))
                 for leaf in runs["ranks"][0][name]["mu"][s]}
        for tag, rel, power in (("mu", 2 * (1 - b1 ** k), 1),
                                ("nu", 4 * (1 - b2 ** k), 2)):
            for r in runs["ranks"]:
                want = _shards(runs, name, r, tag, s)
                for leaf, got in r[name][tag][s].items():
                    bound = GRAD_RTOL * rel * scale[leaf] ** power
                    excess = np.abs(got - want[leaf]) - bound - \
                        8 * EPS32 * np.abs(want[leaf])
                    assert excess.max() <= 0, \
                        (f"{name} step {k} {tag} {leaf}: exceeds the bound "
                         f"by {excess.max():.3e}")
