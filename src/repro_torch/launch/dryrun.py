"""Dry run: count every (arch x shape x mesh) cell on ``meta`` tensors.

    python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
        --multi-pod
    python -m repro_torch.launch.dryrun --all        # 33 cells x 2 meshes

The counterpart of the reference's ``repro.launch.dryrun``.  The reference
lowers and compiles each step for 256 or 512 virtual TPU devices and reads
the compiled HLO; the port has no compiler and no partitioner, so per cell
this:

  1. takes the H100 production mesh (``launch.mesh.make_production_mesh``:
     32 x 8, or 2 x 32 x 8);
  2. builds the model on the ``meta`` device (no storage) and runs the
     train, prefill or serve step under ``core.step_cost.StepCounter``,
     which counts every op the port runs and divides it per device by the
     mesh axes that split it under the policy (``launch.sharding``); the
     count is loop-aware: no layers and one group of the layer pattern
     (and two and three micro-batches) are counted and extrapolated to the
     full depth and ``grad_accum`` (``core.step_cost.extrapolate``);
  3. derives the per-device collectives from the policy
     (``core.collectives``);
  4. writes a JSON record with the reference's keys for the roofline
     analyzer (``core.analyzer``), with ``count_seconds`` in place of
     ``compile_seconds``, a ``fits`` flag against the H100's 80 GB, and no
     ``cost_raw`` (XLA's loops-once cost analysis has no counterpart).

``--all`` counts every cell in one process (``meta`` tensors hold no
memory, so no cell needs isolating); records already written are skipped,
so the sweep resumes.  Records go to ``experiments/dryrun_torch/``, never
to the reference's ``experiments/dryrun/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig, all_cells, \
    get_config
from repro_torch.core import collectives as COLL
from repro_torch.core.hardware import H100
from repro_torch.core.step_cost import StepCount, StepCounter, \
    extrapolate
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention as ATT
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.sharding_ctx import ShardingCtx
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.train import train_step as TS

DEFAULT_OUT = "experiments/dryrun_torch"

# The reference's per-arch training config, kept so that cells compare:
# grad_accum trades step latency for activation memory; the qwen3 MoE
# cell keeps AdamW moments in bf16.
GRAD_ACCUM_DEFAULTS = {
    ("qwen2-72b", "train_4k"): 8,
    ("qwen3-moe-235b-a22b", "train_4k"): 8,
    ("gemma3-12b", "train_4k"): 4,
    ("falcon-mamba-7b", "train_4k"): 2,
    ("recurrentgemma-9b", "train_4k"): 8,
}
OPT_DTYPE_DEFAULTS = {
    "qwen3-moe-235b-a22b": "bfloat16",
}


def input_specs(cfg, shape: ShapeConfig, batch: Optional[int] = None,
                device="meta") -> Dict[str, torch.Tensor]:
    """Stand-ins (zeros on ``device``; no storage on ``meta``) for every
    model input of ``shape``, at ``batch`` rows (default the shape's)."""
    b, s = batch or shape.global_batch, shape.seq_len

    def ids(*dims):
        return torch.zeros(dims, dtype=torch.int64, device=device)

    if shape.kind == "decode":
        return {"tokens": ids(b)}
    specs = {"tokens": ids(b, s)}
    if shape.kind == "train":
        specs["labels"] = ids(b, s)
    if cfg.family == "encdec":
        specs["frames"] = torch.zeros(b, cfg.encoder_seq, cfg.d_model,
                                      device=device)
    if cfg.family == "vlm":
        n_mm = min(s // 4, 1024)
        specs["mm_embeds"] = torch.zeros(b, n_mm, cfg.d_model, device=device)
        specs["positions_3d"] = ids(3, b, s)
    return specs


def abstract_state(cfg, shape: ShapeConfig, kind: str, device="meta",
                   opt_cfg: Optional[adamw.AdamWConfig] = None,
                   batch: Optional[int] = None):
    """``(model, state)`` on ``device``: for ``train`` an ``LM`` of fp32
    masters and its AdamW state, for ``decode`` the serving ``LM`` and its
    ``seq_len`` cache, for ``prefill`` the serving ``LM`` and None."""
    model = M.LM(cfg, device=device, masters=kind == "train")
    if kind == "train":
        return model, adamw.init_state(dict(model.named_parameters()),
                                       opt_cfg or adamw.AdamWConfig())
    if kind == "decode":
        return model, model.init_cache(batch or shape.global_batch,
                                       shape.seq_len)
    return model, None


def sparse_components(cfg, shape: ShapeConfig):
    """Paper-model metadata attached to the record."""
    out = []
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    if cfg.num_experts:
        out.append(MOE.sparse_component_spec(cfg, shape, tokens))
    if "local" in cfg.layer_pattern:
        w = min(cfg.window_size, shape.seq_len)
        out.append({
            "name": f"local_attention/{cfg.name}",
            "regime": "diagonal",
            "n": shape.seq_len,
            "nnz": shape.seq_len * w,
            "d": cfg.num_heads * cfg.head_dim,
            "sizeof_val": 2,
        })
    return out


def _seed(counter: StepCounter, tensors: Dict, specs: Dict, keep) -> None:
    """Tag each tensor with the axes of its spec that ``keep`` keeps."""
    for name, t in tensors.items():
        counter.tag(t, keep(specs[name]))


def count_step(cfg, shape: ShapeConfig, mesh=None, *, grad_accum: int = 1,
               chunked_loss: bool = False, device="meta",
               batch: Optional[int] = None, model=None,
               state=None) -> StepCount:
    """Count one step of ``cfg`` at ``shape`` (``batch`` rows; for a
    train step, ``grad_accum`` micro-batches of them) on ``device``.

    ``mesh`` (None: one device) gives the per-device shares.  A ``model``
    and ``state`` (as :func:`abstract_state` makes them) may be passed to
    count a step of an existing model; the step updates it."""
    kind = shape.kind
    b = batch or shape.global_batch
    opt_cfg = adamw.AdamWConfig(
        state_dtype=OPT_DTYPE_DEFAULTS.get(cfg.name, "float32"))
    if model is None:
        model, state = abstract_state(cfg, shape, kind, device, opt_cfg, b)
    rules = SH.activation_rules(cfg, mesh, shape) if mesh is not None \
        else {}
    counter = StepCounter(mesh, rules)
    ctx = ShardingCtx(rules, mesh, observer=counter.observe)
    params = dict(model.named_parameters())
    pspecs = SH.param_pspecs(cfg, params, mesh) if mesh is not None \
        else {n: () for n in params}
    inputs = input_specs(cfg, shape, b, model.device)
    hooks = []
    if mesh is not None:
        _seed(counter, params, pspecs, SH.model_axes_of)
        dp = SH.dp_axes_for_batch(mesh, shape.global_batch)[0]
        for name, t in inputs.items():
            counter.tag(t, dp)
        if kind == "decode":
            for layer, specs in zip(state, SH.cache_pspecs(cfg, mesh, shape,
                                                           state)):
                _seed(counter, layer, specs, SH.spec_axes)
        # The reference's MoE gathers its tokens over "model" into a
        # shard_map: the router and bucketing run replicated over it.
        hooks = [m.register_forward_pre_hook(
            lambda _, args: counter.tag(
                args[0], counter.axes(args[0]) - {"model"}))
            for m in model.modules() if isinstance(m, MOE.MoE)]
    try:
        _run_step(cfg, shape, model, state, inputs, counter, ctx, params,
                  pspecs, mesh, grad_accum, chunked_loss, opt_cfg)
    finally:
        for h in hooks:
            h.remove()
    return counter.count


def _run_step(cfg, shape, model, state, inputs, counter, ctx, params, pspecs,
              mesh, grad_accum, chunked_loss, opt_cfg) -> None:
    with counter:
        if shape.kind == "train":
            grads_fn = TS.make_grads(cfg, remat=True, grad_accum=grad_accum,
                                     chunked_loss=chunked_loss, ctx=ctx)
            _, grads = grads_fn(model, inputs)
            if mesh is not None:
                # The update runs on each weight's shards.
                for tree in (params, grads, state["mu"], state["nu"]):
                    _seed(counter, tree, pspecs, SH.spec_axes)
                counter.replicate_scalars = True
            adamw.apply_updates(params, grads, state, opt_cfg,
                                cosine_with_warmup(1))
        elif shape.kind == "prefill":
            TS.make_prefill_step(cfg, shape)[0](model, inputs, ctx=ctx)
        else:
            TS.make_serve_step(cfg, shape)[0](model, state, inputs["tokens"],
                                              shape.seq_len - 1, ctx=ctx)


def with_groups(cfg, groups: int):
    """``cfg`` cut to ``groups`` repetitions of its layer pattern."""
    return dataclasses.replace(
        cfg, num_layers=groups * len(cfg.layer_pattern))


def loop_aware_count(cfg, shape: ShapeConfig, mesh=None, *,
                     grad_accum: int = 1,
                     chunked_loss: bool = False) -> StepCount:
    """The count of the full step from models of no layers (one group for
    an encoder-decoder, whose encoder feeds only the decoder layers) and
    of one group more (and, for ``grad_accum`` > 1, of two and three
    micro-batches), extrapolated to the config's depth and ``grad_accum``
    (``core.step_cost.extrapolate``).

    The live-memory peak is not affine in the depth: it is the larger
    model's peak plus, for a train step, the residual stream that each
    further layer's checkpoint keeps (the ``"tokens_bse"`` constraint's
    bytes per layer)."""
    g0 = 1 if cfg.family == "encdec" else 0
    period = len(cfg.layer_pattern)
    groups = cfg.num_layers // period - g0
    micro = shape.global_batch // grad_accum
    peak = []

    def over_groups(a: int) -> StepCount:
        c0, c1 = (count_step(with_groups(cfg, g), shape, mesh, grad_accum=a,
                             batch=micro * a, chunked_loss=chunked_loss)
                  for g in (g0, g0 + 1))
        peak.append(c1)
        return extrapolate(c0, c1, groups)

    if shape.kind != "train" or grad_accum == 1:
        out = over_groups(1)
    else:
        out = extrapolate(over_groups(2), over_groups(3), grad_accum - 2)
    top = peak[0]
    out.peak_live = top.peak_live
    out.peak_live_per_device = top.peak_live_per_device
    if shape.kind == "train":
        more = (groups - 1) * period
        for (kind, dims, dtype, axes) in top.constraints:
            if kind == "tokens_bse":
                size = math.prod(dims) * torch.empty(
                    (), dtype=getattr(torch, dtype)).element_size()
                out.peak_live += more * size
                out.peak_live_per_device += more * size / (
                    SH.axes_size(mesh, axes) if mesh is not None else 1)
                break
    return out


def memory_record(cfg, shape: ShapeConfig, mesh, model, state, count,
                  hw=H100) -> Dict:
    """Per-device memory, with the reference's keys: arguments exact from
    the specs (weights; for training fp32 masters, gradients and AdamW
    moments; for decode the cache), outputs, and temporaries from the
    counter's live-tensor peak (less the gradients, counted as arguments);
    ``fits`` against ``hw.hbm_bytes``."""
    params = dict(model.named_parameters())
    pspecs = SH.param_pspecs(cfg, params, mesh)

    def dev_bytes(t, spec) -> float:
        return t.numel() * t.element_size() / SH.axes_size(
            mesh, SH.spec_axes(spec))

    weights = sum(dev_bytes(p, pspecs[n]) for n, p in params.items())
    args, alias, out = weights, 0.0, 0.0
    dp = SH.dp_axes_for_batch(mesh, shape.global_batch)[0]
    vocab_rows = shape.global_batch / SH.axes_size(mesh, dp) * \
        cfg.padded_vocab * 4 / mesh.shape["model"]
    temp = count.peak_live_per_device
    if shape.kind == "train":
        grads = sum(p.numel() * 4 / SH.axes_size(mesh, SH.spec_axes(
            pspecs[n])) for n, p in params.items())
        moments = sum(dev_bytes(state[k][n], pspecs[n]) for k in ("mu", "nu")
                      for n in params)
        args += grads + moments
        out = alias = weights + moments
        temp = max(0.0, temp - grads)
    elif shape.kind == "prefill":
        out = vocab_rows * shape.seq_len
    else:
        cache = sum(dev_bytes(t, s) for layer, specs in zip(
            state, SH.cache_pspecs(cfg, mesh, shape, state))
            for t, s in zip(layer.values(), specs.values()))
        args += cache
        out, alias = vocab_rows + cache, cache
    mem = {"argument_size_in_bytes": args, "output_size_in_bytes": out,
           "temp_size_in_bytes": temp, "generated_code_size_in_bytes": 0.0,
           "alias_size_in_bytes": alias}
    mem["total_hbm_bytes"] = args + out + temp - alias
    mem["fits"] = mem["total_hbm_bytes"] <= hw.hbm_bytes
    return mem


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             grad_accum: int = 0, verbose: bool = True,
             causal_impl: str = "masked",
             chunked_loss: bool = False) -> dict:
    """Count one (arch, shape, mesh) cell and return its dry-run record.

    Allocates nothing: the models live on the ``meta`` device.
    """
    ATT.set_causal_impl(causal_impl)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if grad_accum <= 0:
        grad_accum = GRAD_ACCUM_DEFAULTS.get((arch, shape_name), 1)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
    t0 = time.time()
    try:
        count = loop_aware_count(cfg, shape, mesh, grad_accum=grad_accum,
                                 chunked_loss=chunked_loss)
    finally:
        ATT.set_causal_impl("masked")
    opt_cfg = adamw.AdamWConfig(
        state_dtype=OPT_DTYPE_DEFAULTS.get(arch, "float32"))
    model, state = abstract_state(cfg, shape, shape.kind, "meta", opt_cfg)
    params = dict(model.named_parameters())
    specs = SH.param_pspecs(cfg, params, mesh)
    coll = COLL.step_collectives(
        cfg, shape, mesh,
        params={n: (tuple(p.shape), p.element_size())
                for n, p in params.items()},
        specs=specs, constraints=count.constraints, kinds=M.layer_kinds(cfg),
        compute_itemsize=torch.tensor([], dtype=model.dtype).element_size(),
        grad_accum=grad_accum)
    coll_bytes, coll_counts = coll.summary()
    mem = memory_record(cfg, shape, mesh, model, state, count)
    cost = {"flops_per_device": count.flops_per_device,
            "bytes_per_device": count.bytes_per_device,
            "flops": count.flops, "bytes": count.bytes}
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": mesh.size,
        "step_kind": shape.kind,
        "grad_accum": grad_accum,
        "causal_impl": causal_impl,
        "chunked_loss": chunked_loss,
        "cost": cost,
        "memory": mem,
        "collectives": coll_bytes,
        "collective_counts": coll_counts,
        "model_flops": cfg.model_flops(shape),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.param_count(active=True),
        "sparse_components": sparse_components(cfg, shape),
        "count_seconds": time.time() - t0,
        "fits": mem["fits"],
    }
    if verbose:
        print(f"--- {arch} / {shape_name} / {mesh_name} ---")
        print("flops/device=%.4g bytes/device=%.4g (whole step: flops=%.4g)"
              % (cost["flops_per_device"], cost["bytes_per_device"],
                 count.flops))
        print("memory/device: %.3g GB, fits: %s"
              % (mem["total_hbm_bytes"] / 1e9, mem["fits"]))
        print("collective bytes/device:", {k: f"{v:.3g}"
                                           for k, v in coll_bytes.items()})
        print(f"counted in {record['count_seconds']:.1f}s")
    return record


def record_path(out_dir, arch, shape_name, multi_pod):
    """Path the dry-run record for one cell is written to / read from."""
    tag = "pod2" if multi_pod else "pod1"
    return os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json")


def write_record(rec: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def summary_table(records) -> str:
    """A markdown table of analysed records (``core.analyzer``), one row
    per (arch, shape) with each mesh's three terms in ms and its dominant
    term, the useful-compute ratio and whether it fits."""
    cells: Dict[tuple, Dict[str, dict]] = {}
    for rec in records:
        cells.setdefault((rec["arch"], rec["shape"]), {})[rec["mesh"]] = rec
    meshes = sorted({m for c in cells.values() for m in c}, key=len)
    rows = ["| arch | shape | " + " | ".join(
        f"{m}: compute / memory / collective ms, dominant" for m in meshes)
        + " | MODEL/HLO | fits |",
        "|---|---|" + "---|" * len(meshes) + "---|---|"]
    for (arch, shape), by_mesh in sorted(cells.items()):
        terms, fits = [], []
        for m in meshes:
            if m not in by_mesh:
                terms.append("not counted")
                fits.append("-")
                continue
            r = by_mesh[m]["roofline"]
            terms.append(f"{r['compute_s'] * 1e3:.4g} / "
                         f"{r['memory_s'] * 1e3:.4g} / "
                         f"{r['collective_s'] * 1e3:.4g}, {r['dominant']}")
            fits.append("yes" if by_mesh[m]["fits"] else "no")
        ratio = next(iter(by_mesh.values()))["roofline"][
            "useful_compute_ratio"]
        rows.append(f"| {arch} | {shape} | " + " | ".join(terms) +
                    f" | {ratio:.2f} | " + "/".join(fits) + " |")
    return "\n".join(rows)


def main(argv=None):
    """Count one dry-run cell (or ``--all``) and write the JSON records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=0)
    ap.add_argument("--causal-impl", default="masked",
                    choices=("masked", "triangle"))
    ap.add_argument("--chunked-loss", action="store_true")
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the analysed table of the records in "
                         "--out-dir (H100 SXM, bf16 tensor cores)")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    torch.set_num_threads(1)

    if args.table:
        from repro_torch.core.analyzer import analyze_record
        records = []
        for name in sorted(os.listdir(args.out_dir)):
            if name.endswith(".json"):
                with open(os.path.join(args.out_dir, name)) as f:
                    records.append(analyze_record(json.load(f)))
        print(summary_table(records))
        print(f"{len(records)} records; counted in "
              f"{sum(r['count_seconds'] for r in records):.1f}s")
        return

    if args.all:
        failures, t0 = [], time.time()
        for arch, shape_name in all_cells():
            for multi_pod in (False, True):
                path = record_path(args.out_dir, arch, shape_name, multi_pod)
                if os.path.exists(path) and not args.force:
                    print("skip (exists):", path)
                    continue
                try:
                    rec = run_cell(arch, shape_name, multi_pod,
                                   causal_impl=args.causal_impl,
                                   chunked_loss=args.chunked_loss)
                except Exception:
                    traceback.print_exc()
                    failures.append((arch, shape_name, multi_pod))
                    continue
                write_record(rec, path)
        print(f"--all took {time.time() - t0:.1f}s")
        if failures:
            print("FAILED cells:", failures)
            sys.exit(1)
        print("all cells OK")
        return

    if not (args.arch and args.shape):
        ap.error("--arch/--shape or --all required")
    rec = run_cell(args.arch, args.shape, args.multi_pod,
                   grad_accum=args.grad_accum, causal_impl=args.causal_impl,
                   chunked_loss=args.chunked_loss)
    path = record_path(args.out_dir, args.arch, args.shape, args.multi_pod)
    write_record(rec, path)
    print("wrote", path)


if __name__ == "__main__":
    main()
