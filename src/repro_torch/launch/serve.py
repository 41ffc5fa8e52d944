"""Serving launcher: batched LM decode, and the streamed-SpMM server.

LM serving (``--arch``): build the model at random from a fixed seed on
the device, prefill the prompts by stepping (one ``decode_step`` per
prompt token) and decode greedily; the MoE expert FFN runs on the
grouped-matmul kernel.  It prints tokens/s and the per-step decode
median and max (host clock, each step ending in
``torch.cuda.synchronize()``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --reduced --device cpu

Streamed SpMM serving: one sparse operator, many right-hand sides.
Hold one sparse operator for the whole process, plan once through
``repro_torch.sparse.plan`` with the expected request count as the reuse
horizon, and serve every request's right-hand side through the bound
kernel:

    PYTHONPATH=src python -m repro_torch.launch.serve --spmm-stream \
        --spmm-structure moe-block --spmm-n 4096 --spmm-d 64 \
        --spmm-steps 64 [--device cuda]

The server runs on the card by default and stops with an error naming
``--device cpu`` when there is none.  ``--spmm-strategy`` forces a format
instead of the roofline's pick.  Each request's B is drawn on the host and
copied to the device before its timer starts; a request's latency is the
launch plus ``torch.cuda.synchronize()``.

``--spmm-shards N`` serves the same stream through the sharded tier
(``repro_torch.sparse.shard``): the plan partitions the operator across N
devices (``-1``: every visible card, one shard each; on the CPU, N shards
of the one CPU device) and the printed summary adds the B-distribution
strategy audit.

``--engine`` serves the operator through the continuous-batching engine
(``repro_torch.sparse.engine``): ``--engine-streams`` open-loop clients
with mixed widths (d and d // 2) submit into the bounded queue, the worker
thread coalesces them into shared ``execute_wide`` calls with pinned
staging on a side stream, and the report gives per-request p50/p99 and
goodput beside a synchronous per-request replay of the same requests:

    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --spmm-structure moe-block --spmm-n 4096 --spmm-d 64 \
        --engine-streams 4 --engine-requests 64 --engine-rate 2000

``--calibrate`` runs the compute-ceiling sweep
(``repro_torch.core.calibrate``) on the device at start-up and persists
it, so the serving plan predicts from measured ``(peak_fraction,
d_half)`` ceilings (``ceiling_source="calibrated"``):

    PYTHONPATH=src python -m repro_torch.launch.serve --spmm-stream \
        --calibrate [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.calibrate import (CARD_SCALE, Calibration,
                                        CalibrationStore, calibrate)
from repro_torch.core.device import DeviceLike, resolve_device, synchronize
from repro_torch.core.patterns import serving_suite
from repro_torch.kernels import launch_counts
from repro_torch.launch.mesh import ShardMesh, make_shard_mesh
from repro_torch.sparse.dispatch import (STRATEGIES, Dispatcher,
                                         default_dispatcher)


@dataclasses.dataclass
class Generation:
    """What :func:`generate` returns."""

    tokens: np.ndarray        # [B, gen] int32, the greedy tokens
    step_ms: List[float]      # host ms of each step, prefill steps first


def generate(model, prompts: np.ndarray, gen: int) -> Generation:
    """Greedy decode ``gen`` tokens after prefilling ``prompts`` ``[B, S]``.

    Prefill steps through the prompt one token at a time (``S - 1``
    ``decode_step`` calls), then each of the ``gen`` steps feeds the last
    token and takes the argmax over the real vocabulary.  Each step is
    timed on the host clock up to ``torch.cuda.synchronize()``.
    """
    B, S = prompts.shape
    dev = model.device
    cache = model.init_cache(B, S + gen)
    toks = torch.from_numpy(np.asarray(prompts, dtype=np.int64)).to(dev)
    vocab = model.cfg.vocab_size
    step_ms, out = [], []
    with torch.inference_mode():
        for t in range(S - 1 + gen):
            t0 = time.perf_counter()
            if t < S - 1:
                model.decode_step(cache, toks[:, t], t)
            else:
                tok = toks[:, -1] if t == S - 1 else out[-1]
                logits = model.decode_step(cache, tok, t)
                out.append(torch.argmax(logits[:, :vocab], dim=-1))
            synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
    tokens = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
    return Generation(tokens, step_ms)


def lm_prompts(vocab_size: int, batch: int, prompt_len: int) -> np.ndarray:
    """The reference's prompts: ``[batch, prompt_len]`` int32 tokens in
    ``[2, vocab_size - 1)`` from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return rng.integers(2, vocab_size - 1,
                        size=(batch, prompt_len)).astype(np.int32)


def serve_lm(args, *, model=None) -> dict:
    """Build ``--arch`` (seed 0) on ``--device``, or take ``model`` (its
    config then replaces ``--arch`` and ``--reduced``), and generate
    ``--gen`` tokens for ``--batch`` prompts of ``--prompt-len``.

    On the card every MoE layer's expert FFN launches the grouped-matmul
    kernel: the launches must equal two per MoE layer per step, or this
    raises ``RuntimeError``.  On the CPU the plain version runs and
    launches nothing.

    Returns:
        A record: ``model``, ``prompts``, ``generation``, ``build_s``,
        ``seconds``, ``tok_s``, ``launches`` and ``planned_launches``.
    """
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if model is None else model.cfg
    if args.reduced and model is None:
        cfg = cfg.reduced()
    t0 = time.perf_counter()
    if model is None:
        model = init_params(cfg, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
        synchronize(dev)
    build_s = time.perf_counter() - t0
    prompts = lm_prompts(cfg.vocab_size, args.batch, args.prompt_len)
    steps = args.prompt_len - 1 + args.gen
    before = launch_counts()["grouped_matmul"]
    t0 = time.perf_counter()
    out = generate(model, prompts, args.gen)
    dt = time.perf_counter() - t0
    launches = launch_counts()["grouped_matmul"] - before
    planned = model.grouped_launches_per_step() * steps \
        if dev.type == "cuda" else 0
    ms = np.asarray(out.step_ms)
    print(f"{cfg.name} on {dev}: built in {build_s:.1f}s; generated "
          f"{out.tokens.shape} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s); {steps} decode "
          f"steps, median {np.median(ms):.2f} ms, max {ms.max():.2f} ms; "
          f"grouped_matmul launches {launches} (planned {planned})")
    print("sample:", out.tokens[0][:10])
    if launches != planned:
        raise RuntimeError(f"{cfg.name}: grouped_matmul launched {launches} "
                           f"times, planned {planned}")
    return {"model": model, "prompts": prompts, "generation": out,
            "build_s": build_s, "seconds": dt,
            "tok_s": args.batch * args.gen / dt, "launches": launches,
            "planned_launches": planned}


#: CLI choices derive from the shared registry so they can't drift from it.
STREAM_STRUCTURES = tuple(serving_suite(64))


def build_stream_matrix(structure: str, n: int):
    """Build the served sparse operator for one of the paper structures
    (``repro_torch.core.patterns.serving_suite``)."""
    suite = serving_suite(n)
    if structure not in suite:
        raise ValueError(f"unknown structure {structure!r}; choose from "
                         f"{STREAM_STRUCTURES}")
    return suite[structure]()


def run_startup_calibration(device: DeviceLike = None,
                            scale: Optional[int] = None) -> Calibration:
    """Calibrate the per-format compute ceilings of the serving device.

    Runs the :func:`~repro_torch.core.calibrate.calibrate` sweep against
    the backend and hardware spec the default dispatcher of ``device``
    resolves to, at its ``bcsr_block``, persists the result to the default
    :class:`~repro_torch.core.calibrate.CalibrationStore`, and refreshes
    that dispatcher, so every later plan (the ``--spmm-stream`` plan
    included) predicts from measured ceilings.

    Args:
        device: the serving device; None means the card.
        scale: log2 n of the sweep's matrices; None means
            :data:`~repro_torch.core.calibrate.CARD_SCALE` on the card and
            the sweep's default on the CPU.

    Returns:
        The fitted calibration.
    """
    disp = default_dispatcher(device)
    backend = disp._resolve_backend()
    hw = disp._resolve_hardware(backend)
    if scale is None and disp.device.type == "cuda":
        scale = CARD_SCALE
    sweep = {} if scale is None else {"scale": scale}
    t0 = time.perf_counter()
    store = CalibrationStore()
    cal = calibrate(hw, backend=backend, device=disp.device,
                    bcsr_block=disp.bcsr_block, store=store, **sweep)
    disp.refresh_calibration()
    print(f"startup calibration ({backend} kernels on {hw.name}, "
          f"{disp.device}) took {time.perf_counter() - t0:.1f}s -> "
          f"{store.path_for(hw, backend)}")
    print(cal.summary())
    return cal


def serving_mesh(shards: int, device: torch.device) -> ShardMesh:
    """The mesh ``--spmm-shards`` asks for on ``device``'s type.

    On the card: ``shards`` distinct cards (``-1``: every visible one).
    On the CPU, which is one device: ``shards`` shards of it (``-1``: one),
    as the reference's CPU runs use virtual host devices.
    """
    if device.type == "cpu":
        return ShardMesh([device] * max(shards, 1))
    return make_shard_mesh(None if shards < 0 else shards, device=device)


def serve_spmm_stream(args, *, dispatcher: Optional[Dispatcher] = None,
                      matrix=None) -> dict:
    """Serve ``--spmm-steps`` right-hand sides through one persistent plan.

    Args:
        args: parsed CLI arguments (``spmm_structure``, ``spmm_n``,
            ``spmm_d``, ``spmm_steps``, ``device``; optional
            ``spmm_strategy``, ``spmm_compare`` and ``spmm_shards``).
        dispatcher: plan on this dispatcher instead of a fresh one for
            ``args.device``.
        matrix: serve this operator instead of building it from
            ``args.spmm_structure`` and ``args.spmm_n``.

    Returns:
        The run's record: ``plan`` (the StreamPlan), ``matrix``,
        ``startup_ms``, ``latency_us`` (per request), ``p50_us``,
        ``p99_us``, ``gflops`` (useful FLOP/s at the median latency) and
        ``last`` (the last request's ``(b, c)``).
    """
    from repro_torch import sparse
    device = resolve_device(getattr(args, "device", None))
    strategy = getattr(args, "spmm_strategy", None) or "auto"
    m = matrix if matrix is not None else build_stream_matrix(
        args.spmm_structure, args.spmm_n)
    disp = dispatcher or Dispatcher(device=device)
    rng = np.random.default_rng(1)

    def next_batch():
        b = torch.from_numpy(
            rng.normal(size=(m.n, args.spmm_d)).astype(np.float32))
        b = b.to(disp.device)
        synchronize(disp.device)
        return b

    shards = getattr(args, "spmm_shards", 0)
    mesh = serving_mesh(shards, disp.device) if shards else None
    t0 = time.perf_counter()
    plan = sparse.plan(m, sparse.BSpec(d=args.spmm_d, reuse=args.spmm_steps),
                       strategy=strategy, dispatcher=disp, mesh=mesh)
    plan.execute(next_batch())                    # bind + first launch
    synchronize(disp.device)
    startup_s = time.perf_counter() - t0
    plan.reset_stats()     # the warm-up is startup, not a served request

    lat = []
    b = c = None
    for _ in range(args.spmm_steps):
        b = next_batch()
        t1 = time.perf_counter()
        c = plan.execute(b)
        synchronize(disp.device)
        lat.append(time.perf_counter() - t1)
    lat_us = np.asarray(lat) * 1e6
    flops = 2.0 * m.nnz * args.spmm_d
    gflops = flops / np.median(lat_us) / 1e3

    # A ShardedPlan's summary adds the B-strategy audit under the format
    # decision table.
    print(plan.summary() if mesh is not None else plan.dispatch.summary())
    single = disp.plan(m, args.spmm_d, reuse=1)
    note = ("same as single-shot" if single.chosen == plan.chosen else
            f"single-shot would pick {single.chosen}")
    print(f"serving {getattr(args, 'spmm_structure', m.pattern)} "
          f"[{m.n}x{m.n}, nnz={m.nnz}] d={args.spmm_d} on {disp.device}: "
          f"planned for reuse={args.spmm_steps} -> {plan.chosen} @ "
          f"{plan.precision} ({note})")
    print(f"startup (classify+plan+convert+pack+first launch): "
          f"{startup_s * 1e3:.1f} ms")
    print(f"steady-state: p50={np.percentile(lat_us, 50):.0f}us "
          f"p99={np.percentile(lat_us, 99):.0f}us "
          f"-> {gflops:.2f} GFLOP/s")

    if getattr(args, "spmm_compare", False):
        # Replay the same stream through a fresh dispatcher per request.
        rng = np.random.default_rng(1)
        Dispatcher(device=disp.device, backend=plan.dispatch.backend).spmm(
            m, next_batch(), reuse=1)
        synchronize(disp.device)
        percall_s = 0.0
        for _ in range(args.spmm_steps):
            bb = next_batch()
            t2 = time.perf_counter()
            Dispatcher(device=disp.device,
                       backend=plan.dispatch.backend).spmm(m, bb, reuse=1)
            synchronize(disp.device)
            percall_s += time.perf_counter() - t2
        streamed_s = float(np.sum(lat))
        print(f"per-call dispatch (fresh dispatcher per request, no "
              f"caches) of the same stream: {percall_s * 1e3:.1f} ms vs "
              f"streamed {streamed_s * 1e3:.1f} ms "
              f"({percall_s / max(streamed_s, 1e-12):.1f}x)")
    print(f"stats: {plan.stats()}")
    return {"plan": plan, "matrix": m, "startup_ms": startup_s * 1e3,
            "latency_us": lat_us, "p50_us": float(np.percentile(lat_us, 50)),
            "p99_us": float(np.percentile(lat_us, 99)), "gflops": gflops,
            "last": (b, c)}


def serve_spmm_engine(args, *, dispatcher: Optional[Dispatcher] = None,
                      matrix=None, engine_cls=None) -> dict:
    """Serve an open-loop arrival process through the serving engine.

    ``--engine-streams`` clients each submit ``--engine-requests //
    --engine-streams`` right-hand sides with exponential gaps at
    ``--engine-rate`` requests/s (open loop: arrivals don't wait for
    completions, so the queue coalesces and applies backpressure).  Even
    streams send width d, odd ones d // 2.  Every operand is drawn on the
    host before the clock starts (pinned when serving on the card), and
    every result comes back to the host.  After the engine drains, the
    same requests are replayed one by one through ``plan.execute_wide``
    with the same transfers (H2D, launch, D2H into pinned memory, one
    synchronize per request): the sync baseline.

    Args:
        args: parsed CLI arguments (``spmm_structure``, ``spmm_n``,
            ``spmm_d``, ``device``, ``engine_*``; optional
            ``spmm_strategy``).
        dispatcher: plan on this dispatcher instead of a fresh one for
            ``args.device`` (its conversion and layout caches are reused).
        matrix: serve this operator instead of building it.
        engine_cls: the engine class to serve with (default
            ``repro_torch.sparse.ServingEngine``; another implementation
            with its interface can be timed on the same arrivals).

    Returns:
        The run's record: ``plan``, ``engine``, ``stats`` (the engine's),
        ``served`` (``(ticket, b)`` per admitted request),
        ``engine_launches`` (``kernel name -> launches`` from the engine's
        start to its stop, its warm-up and the sync baseline excluded),
        ``startup_ms``, ``warmed``, ``sync_latency_us``, ``sync_p50_us``,
        ``sync_p99_us`` and ``sync_goodput_rps``.
    """
    from repro_torch import kernels, sparse
    device = resolve_device(getattr(args, "device", None))
    strategy = getattr(args, "spmm_strategy", None) or "auto"
    m = matrix if matrix is not None else build_stream_matrix(
        args.spmm_structure, args.spmm_n)
    disp = dispatcher or Dispatcher(device=device)
    dev = disp.device
    on_card = dev.type == "cuda"
    streams = max(args.engine_streams, 1)
    per_stream = max(args.engine_requests // streams, 1)
    rate = max(args.engine_rate, 1e-9)      # requests/s per stream
    half = max(args.spmm_d // 2, 1)

    def width(stream: int) -> int:
        return args.spmm_d if stream % 2 == 0 else half

    def draw(w: int) -> torch.Tensor:
        b = torch.from_numpy(rng.standard_normal((m.n, w), dtype=np.float32))
        return b.pin_memory() if on_card else b

    # Pre-draw every operand so generation stays out of both timings.
    rng = np.random.default_rng(1)
    reqs = [[draw(width(s)) for _ in range(per_stream)]
            for s in range(streams)]
    gaps = [[rng.exponential(1.0 / rate) for _ in range(per_stream)]
            for _ in range(streams)]
    total = streams * per_stream

    t0 = time.perf_counter()
    plan = sparse.plan(m, sparse.BSpec(d=args.spmm_d, reuse=total),
                       strategy=strategy, dispatcher=disp)
    plan.execute(reqs[0][0].to(dev))                # bind + first launch
    synchronize(dev)
    plan.reset_stats()
    engine = (engine_cls or sparse.ServingEngine)(
        max_queue=args.engine_queue, policy=args.engine_policy)
    engine.register("spmm", plan)
    worst_case_cols = sum(b.shape[1] for stream in reqs for b in stream)
    warmed = engine.warmup("spmm", max_cols=worst_case_cols)
    startup_s = time.perf_counter() - t0
    launched = kernels.launch_counts()
    engine.start()

    def client(stream: int, served: list) -> None:
        for gap, b in zip(gaps[stream], reqs[stream]):
            time.sleep(gap)
            try:
                served.append((engine.submit("spmm", b), b))
            except sparse.ShedError:
                pass                        # counted in engine.stats()

    per_client: list = [[] for _ in range(streams)]
    threads = [threading.Thread(target=client, args=(s, per_client[s]))
               for s in range(streams)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    served = [pair for lst in per_client for pair in lst]
    for ticket, _ in served:
        ticket.result(timeout=120.0)
    engine.stop(timeout=120.0)
    launched = {k: v - launched[k]
                for k, v in kernels.launch_counts().items()}
    stats = engine.stats()

    # The sync baseline, warmed at each request width as the engine was.
    for w in sorted({b.shape[1] for stream in reqs for b in stream}):
        plan.execute_wide(torch.zeros((m.n, w), device=dev))
    synchronize(dev)
    plan.reset_stats()
    sync_lat = []
    t_sync0 = time.perf_counter()
    for stream in reqs:
        for b in stream:
            t1 = time.perf_counter()
            c = plan.execute_wide(b.to(dev, non_blocking=True))
            host = torch.empty(c.shape, dtype=c.dtype, pin_memory=on_card)
            host.copy_(c, non_blocking=True)
            synchronize(dev)
            sync_lat.append(time.perf_counter() - t1)
    sync_span = time.perf_counter() - t_sync0
    sync_us = np.asarray(sync_lat) * 1e6
    sync_goodput = len(sync_lat) / max(sync_span, 1e-12)

    print(plan.dispatch.summary())
    print(f"engine serving {getattr(args, 'spmm_structure', m.pattern)} "
          f"[{m.n}x{m.n}, nnz={m.nnz}] on {dev}: {streams} streams x "
          f"{per_stream} requests, widths d={args.spmm_d}/{half}, "
          f"open-loop rate {rate:.0f} req/s/stream, "
          f"queue={args.engine_queue} policy={args.engine_policy}, "
          f"budget {engine.budget_for('spmm')} columns")
    print(f"startup (classify+plan+pack+first launch, {warmed} launch "
          f"widths warmed): {startup_s * 1e3:.1f} ms")
    print(engine.summary())
    if engine.transfer_log:
        split = {k: np.median([getattr(r, k) for r in engine.transfer_log])
                 for k in ("h2d_ms", "kernel_ms", "d2h_ms")}
        print("per batch on the card (median, CUDA events): " + ", ".join(
            f"{k[:-3]} {v:.4f} ms" for k, v in split.items()))
    print(f"sync per-request replay of the same {len(sync_lat)} requests: "
          f"p50={np.percentile(sync_us, 50):.0f}us "
          f"p99={np.percentile(sync_us, 99):.0f}us "
          f"goodput={sync_goodput:.1f} req/s")
    if stats["goodput_rps"] > 0:
        print(f"engine vs sync goodput: {stats['goodput_rps']:.1f} vs "
              f"{sync_goodput:.1f} req/s "
              f"({stats['goodput_rps'] / max(sync_goodput, 1e-12):.2f}x)")
    return {"plan": plan, "engine": engine, "stats": stats,
            "served": served, "engine_launches": launched,
            "startup_ms": startup_s * 1e3,
            "warmed": warmed, "sync_latency_us": sync_us,
            "sync_p50_us": float(np.percentile(sync_us, 50)),
            "sync_p99_us": float(np.percentile(sync_us, 99)),
            "sync_goodput_rps": sync_goodput}


def parser() -> argparse.ArgumentParser:
    """The server's command line."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve LM decode, or SpMM through a persistent plan, "
                    "on the GPU.")
    ap.add_argument("--arch", help="serve this model's greedy decode")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--spmm-stream", action="store_true",
                    help="serve SpMM through a persistent sparse.plan")
    ap.add_argument("--spmm-structure", choices=STREAM_STRUCTURES,
                    default="moe-block")
    ap.add_argument("--spmm-n", type=int, default=4096)
    ap.add_argument("--spmm-d", type=int, default=64)
    ap.add_argument("--spmm-steps", type=int, default=64,
                    help="requests to serve = the plan's reuse horizon")
    ap.add_argument("--spmm-strategy", choices=STRATEGIES, default="auto",
                    help="force a format instead of the roofline's pick")
    ap.add_argument("--spmm-compare", action="store_true",
                    help="also time per-call dispatch of the same stream")
    ap.add_argument("--spmm-shards", type=int, default=0,
                    help="serve through the sharded tier on this many "
                         "devices (-1 = every visible card; on the CPU, "
                         "this many shards of the one CPU device)")
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(repro_torch.sparse.engine): open-loop concurrent "
                         "clients, bounded queue, coalesced execute_wide "
                         "batches, p50/p99 + goodput report vs a sync "
                         "per-request baseline")
    ap.add_argument("--engine-streams", type=int, default=4,
                    help="concurrent synthetic client streams")
    ap.add_argument("--engine-requests", type=int, default=64,
                    help="total requests across all streams")
    ap.add_argument("--engine-rate", type=float, default=2000.0,
                    help="open-loop arrival rate per stream (requests/s)")
    ap.add_argument("--engine-queue", type=int, default=256,
                    help="bounded admission-queue depth")
    ap.add_argument("--engine-policy", choices=("wait", "shed"),
                    default="wait",
                    help="backpressure when the queue is full: block the "
                         "submitter ('wait') or reject ('shed')")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: cuda; cpu runs the "
                         "plain PyTorch versions)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit the compute ceilings on the device at "
                         "start-up; the serving plan then predicts from "
                         "measured (peak_fraction, d_half) instead of "
                         "defaults")
    return ap


def main(argv=None) -> None:
    """Parse arguments and run the engine, the streamed-SpMM server or the
    LM server."""
    ap = parser()
    args = ap.parse_args(argv)
    if not (args.spmm_stream or args.engine or args.arch):
        ap.error("--arch is required unless --spmm-stream or --engine is "
                 "set")
    if args.calibrate:
        run_startup_calibration(args.device)
    if args.engine:
        serve_spmm_engine(args)
    elif args.spmm_stream:
        serve_spmm_stream(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
