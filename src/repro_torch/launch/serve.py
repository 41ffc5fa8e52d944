"""Streamed-SpMM server: one sparse operator, many right-hand sides.

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

``--calibrate`` runs the compute-ceiling sweep
(``repro_torch.core.calibrate``) on the device at start-up and persists
it, so the serving plan predicts from measured ``(peak_fraction,
d_half)`` ceilings (``ceiling_source="calibrated"``):

    PYTHONPATH=src python -m repro_torch.launch.serve --spmm-stream \
        --calibrate [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.calibrate import (CARD_SCALE, Calibration,
                                        CalibrationStore, calibrate)
from repro_torch.core.device import DeviceLike, resolve_device, synchronize
from repro_torch.core.patterns import serving_suite
from repro_torch.sparse.dispatch import (STRATEGIES, Dispatcher,
                                         default_dispatcher)

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


def serve_spmm_stream(args, *, dispatcher: Optional[Dispatcher] = None,
                      matrix=None) -> dict:
    """Serve ``--spmm-steps`` right-hand sides through one persistent plan.

    Args:
        args: parsed CLI arguments (``spmm_structure``, ``spmm_n``,
            ``spmm_d``, ``spmm_steps``, ``device``; optional
            ``spmm_strategy`` and ``spmm_compare``).
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

    t0 = time.perf_counter()
    plan = sparse.plan(m, sparse.BSpec(d=args.spmm_d, reuse=args.spmm_steps),
                       strategy=strategy, dispatcher=disp)
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

    print(plan.dispatch.summary())
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


def parser() -> argparse.ArgumentParser:
    """The server's command line."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve SpMM through a persistent plan on the GPU.")
    ap.add_argument("--spmm-stream", action="store_true",
                    help="serve SpMM through a persistent sparse.plan (the "
                         "only mode of the port so far)")
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
    """Parse arguments and run the streamed-SpMM server."""
    ap = parser()
    args = ap.parse_args(argv)
    if not args.spmm_stream:
        ap.error("the port serves --spmm-stream only; LM decode and the "
                 "serving engine are not ported yet")
    if args.calibrate:
        run_startup_calibration(args.device)
    serve_spmm_stream(args)


if __name__ == "__main__":
    main()
