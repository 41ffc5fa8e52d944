"""Run one benchmark cell of the PyTorch and CUDA port once, on the card.

    python3 bench/run.py --workload scalefree.stream-d64 --seed 7 \
        --seconds 15 --trace 0

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix. The run makes the operator and the
right-hand sides on the card from ``--seed``, plans them through
``repro_torch.sparse.plan``, warms the cell's width up, serves the traffic
for ``--seconds``, checks a seeded sample of the window's answers against
the plain reference (``bench/reference.py``) and prints, as the last line
of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and ``checks``, the numbers
compared beside their limits (also the last lines of standard error).

It exits non-zero, printing no result, without a CUDA device, with fewer
devices than the cell asks for, outside a checkout that holds the port
(``src/repro_torch``), or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: Top-level module names that may not be loaded in a run.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})

#: Requests sent under the profiler before its window opens.
TRACE_WARMUP = 16


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def cache_dirs(root: pathlib.Path) -> dict:
    """The fixed directories, inside the checkout, that hold every cache."""
    base = root / "build" / "bench"
    return {"REPRO_CALIBRATION_DIR": base / "calibration",
            "TORCH_EXTENSIONS_DIR": base / "torch_extensions",
            "TRITON_CACHE_DIR": base / "triton"}


def sub_seed(seed: int, stream: int) -> int:
    """An independent generator seed for one of the run's streams."""
    return (int(seed) * 4 + stream) % 2**63


@contextlib.contextmanager
def timed_methods(obj, names, out: dict):
    """Time each call of the methods ``names`` of ``obj`` into ``out``."""
    for name in names:
        fn = getattr(obj, name)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            t = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                out[_name] = out.get(_name, 0.0) + time.perf_counter() - t
        setattr(obj, name, wrapper)
    try:
        yield out
    finally:
        for name in names:
            delattr(obj, name)


def nvidia_smi() -> str:
    """The card's name, power limit, draw, clocks and temperature."""
    query = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "clocks.mem,temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"
    return out.stdout.strip() or out.stderr.strip()


def _launches() -> int:
    from repro_torch import kernels
    return sum(kernels.launch_counts().values())


def make_operator(root, cell, seed: int, device):
    """The cell's operator as row-sorted COO tensors on ``device``: the
    pattern from the configuration's ``structure_seed``, the values from
    the run's seed."""
    import torch
    from bench import coo, spec
    cfg = cell.config
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["structure_seed"]))
    module = spec.load_module(root, "gen", cfg["generator"])
    rows, cols = module.generate(int(cfg["n"]), cfg["params"], gen)
    gen.manual_seed(sub_seed(seed, 0))
    vals = coo.values(rows.numel(), float(cfg["values"]["low"]),
                      float(cfg["values"]["high"]), gen)
    return rows, cols, vals


def traced_segment(plan, pool, traffic, driver, port_names):
    """Serve ``trace_requests`` more requests under ``torch.profiler`` and
    reduce the trace over them."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from bench import devtrace
    acts = [ProfilerActivity.CPU]
    if plan.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        driver.serve(plan, pool, traffic, count=TRACE_WARMUP)
        with record_function(devtrace.WINDOW):
            before = _launches()
            served = driver.serve(plan, pool, traffic,
                                  count=int(traffic["trace_requests"]),
                                  annotate=True)
            launches = _launches() - before
    return devtrace.read(prof, requests=served.requests,
                         port_names=port_names, port_launches=launches)


def run_cell(root: pathlib.Path, cell, *, seed: int, seconds: float,
             trace: bool, device, t0: float, precision=None,
             log=print) -> dict:
    """Run ``cell`` once and return its result line as a dict.

    Args:
        root: the checkout (its ``BENCHMARK.json`` and ``bench/`` files).
        cell: the :class:`bench.spec.Cell` to run.
        seed: the run's seed; inputs and the checked sample follow it.
        seconds: the measured window.
        trace: also serve a profiled segment and report per-layer metrics.
        device: the ``torch.device`` to run on.
        t0: ``time.perf_counter()`` at the start of the process.
        precision: a storage precision to force on the plan (the lower
            precision control; None for every benchmark run).
        log: where the context lines go.
    """
    import torch
    from bench import devtrace, reference, roofline, spec
    from bench.record import Reservoir, RunRecord
    from repro_torch import sparse
    from repro_torch.core.patterns import COOMatrix
    from repro_torch.sparse import dispatch

    cfg, traffic = cell.config, cell.traffic
    n, d = int(cfg["n"]), int(traffic["d"])
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build()
    rows, cols, vals = make_operator(root, cell, seed, device)
    nnz = int(rows.numel())
    m = COOMatrix(n=n, rows=rows.cpu().numpy(), cols=cols.cpu().numpy(),
                  vals=vals.cpu().double().numpy(), pattern=cfg["pattern"],
                  meta={"achieved_nnz": nnz, "achieved_avg_degree": nnz / n})
    disp = dispatch.default_dispatcher(device)
    timers: dict = {}
    with timed_methods(disp, ("plan", "prepare"), timers):
        plan = sparse.plan(m, sparse.BSpec(d=d, reuse=int(traffic["reuse"]),
                                           precision=precision),
                           strategy="auto", device=device)
    driver = spec.load_module(root, "drivers", traffic["driver"])
    gen_b = torch.Generator(device=device)
    gen_b.manual_seed(sub_seed(seed, 1))
    pool = driver.make_pool(n, traffic, gen_b)
    driver.serve(plan, pool, traffic, count=int(traffic["warmup"]))
    plan.reset_stats()
    chosen, prec = plan.chosen, plan.precision
    gc.collect()

    sample = Reservoir(int(traffic["sample"]), sub_seed(seed, 2))
    served = driver.serve(plan, pool, traffic,
                          until=time.perf_counter() + seconds, sample=sample)
    reading = None
    if trace:
        csrc = pathlib.Path(sys.modules["repro_torch"].__file__).parent \
            / "csrc"
        reading = traced_segment(plan, pool, traffic, driver,
                                 devtrace.port_kernel_names(csrc))
    if device.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(device))
        kind = torch.cuda.get_device_name(device)
        log(f"device: {kind} x {torch.cuda.device_count()} visible, "
            f"{cell.chips} used")
        log(f"nvidia-smi (name, power.limit, power.draw, clocks.sm, "
            f"clocks.max.sm, clocks.mem, temp): {nvidia_smi()}")
    else:
        peak, kind = 0, "cpu"
    bound = roofline.request_bound_s(n, nnz, d)
    log(f"plan: {chosen} at {prec} (regime {plan.dispatch.regime}); "
        f"n {n}, nnz {nnz}, d {d}")
    log(f"bound per request: {bound * 1e3:.6f} ms "
        f"({roofline.bound_side(n, nnz, d)}; 3.35 TB/s, 67 TFLOP/s fp32, "
        f"H100 SXM published peaks)")
    log(f"window: {served.requests} requests in {served.window_s:.6f} s; "
        f"plan {timers.get('plan', 0.0):.3f} s, pack "
        f"{timers.get('prepare', 0.0):.3f} s")
    if reading is not None:
        log(f"trace: {reading.requests} requests, "
            f"{reading.port_launches / max(reading.requests, 1):g} "
            f"launches of the program's kernels per request")

    record = RunRecord(
        cell=cell.name, n=n, nnz=nnz, d=d, bound_s=bound,
        flops=roofline.request_flops(nnz, d),
        setup_s=served.t_first - t0, served=served,
        plan_s=timers.get("plan"), pack_s=timers.get("prepare"),
        trace=reading)

    # The program's state goes before the reference runs.
    answers = sample.items
    del plan, m, sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    err = 0.0 if answers else float("inf")
    for _, b_index, c in answers:
        err = max(err, reference.max_rel_err(rows, cols, vals,
                                              pool[b_index], c))
    limit = float(cfg["check"]["max_rel_err"])

    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module(root, "metrics", entry["name"]).read(record)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": peak}
    result = {"correct": bool(err <= limit), "attempted": served.requests,
              "failed": 0, "metrics": metrics, "device": device_info}
    if reading is not None:
        device_info["busy_s"] = reading.busy_s
        device_info["window_s"] = reading.window_s
        result["breakdown"] = {"device_ops": reading.device_ops,
                               "idle_gaps": reading.idle_gaps}
    result["checks"] = {"max_rel_err": {"value": err, "limit": limit}}
    return result


def main(argv=None) -> int:
    """Parse the command line, run the cell and print its result line."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"bench: no src/repro_torch under {ROOT}: run from a checkout "
              f"of the port", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for key, path in cache_dirs(ROOT).items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    import torch
    from bench import spec
    cell = spec.load_cell(ROOT, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 3
    result = run_cell(ROOT, cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda"),
                      t0=T_START, log=lambda s: print(s, flush=True))
    loaded = forbidden_modules()
    if loaded:
        print(f"bench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
