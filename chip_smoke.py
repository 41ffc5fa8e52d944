#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run, n = 2**20, d = 64
    python3 chip_smoke.py --quick    # the same phases at n = 2**14 and
                                     # small MoE widths

Phases, in order; the first failure stops the run with a nonzero exit.
The run reads and writes calibrations only in a fresh temporary
``$REPRO_CALIBRATION_DIR``, removed at the end.

1. **build**: compile the six CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once) and print ``ptxas``'s report per
   kernel function: registers, shared memory, spills.
2. **calibrate**: ``repro_torch.launch.serve``'s ``--calibrate`` sweep
   (``run_startup_calibration``) with the ``cuda`` kernels at n = 2**18
   (``CARD_SCALE``; 2**14 under ``--quick``), BCSR block 64, f32i32,
   d = 4, 16, 64, 256, host clock plus synchronise per call.  Counters are
   zeroed first; each of the five SpMM kernels must launch, and the saved
   file must load back at the registry's version.  One line per format:
   peak_fraction, d_half, sustained and measured GF/s.
3. **serving** (the SpMM path): ``repro_torch.launch.serve``'s
   ``serve_spmm_stream`` on each ``serving_suite`` structure (moe-block,
   banded, scale-free, uniform) at n = 2**20, d = 64, 8 requests each,
   plus scale-free forced onto the binned and the row-split kernels
   (``--spmm-strategy binned`` / ``rowsplit``), the scale-free regime's
   own kernels.  These six runs plan under the default ceilings
   (``calibration=False``), so the kernel phase measures the layouts they
   pack.  Every kernel's launch counter is zeroed before the phase
   and read after it; each run's chosen kernel must have launched.  A run
   on the BCSR kernel must have launched only the variant that
   ``bcsr_variant`` names for its shape, and ``moe-block``'s must be a fast
   one (``tile64_f32`` at fp32, ``wgmma_bf16`` at bf16).  The last
   request's C is held against the port's ``"torch"`` backend on the
   card.  Then each auto structure is planned under the calibrated
   ceilings (classify and plan only): the default and the calibrated
   choice with their predicted GFLOP/s; where the choice differs, the
   structure is served again under the calibrated plan (8 requests, same
   n, d and seed) and checked the same way.
4. **moe** (the MoE path): ``repro_torch.launch.moe_block`` at
   qwen3-moe-235b-a22b's expert widths (4096 tokens, top-8 of 128
   experts, d_model 4096 -> moe_d_ff 1536, bm = bk = bn = 128), at bf16
   (the config's dtype) and at fp32: route, block, run the
   ``("grouped", "cuda")`` spec, and hold every routed row against its
   expert's dense product.  Counters are zeroed before the phase and read
   after it.  After both paths, every kernel must have launched on one.
5. **kernels**: each SpMM kernel against its plain PyTorch version on the
   card, on the layout the serving phase packed for it (f32i32) and at
   every other precision its spec declares (bf16i32 at full n, bf16i16 at
   n = 32760, where the slab fits int16 indices); kernel, plain-version
   and ``torch.sparse.mm`` times, the last with A as CSR in B's dtype
   (CUDA events, warm, median); the CSR
   kernel also on the layout that ``scale-free`` auto packed, the row-tile
   kernels with their work list's size (pieces, the largest piece's real
   entries, split tiles); the banded kernel with the diagonals it walks
   (slots read per nonzero, and the host time to derive them from the
   band), and also at block edges t = 1, 2, 4; the row-split kernels
   with their fold (carry rows, carries, carry-buffer bytes, empty rows),
   a check that a call allocates less than the ``[C * W, d]`` window
   partials the first version wrote, and a check that two calls give C
   equal bit for bit; the BCSR kernel with the variant each precision
   launched (checked against ``bcsr_variant``), a check that two calls
   give C equal bit for bit, and ``torch.sparse.mm`` with A as BSR (the
   layout's t x t blocks, B's dtype) as a second library time,
   ``library_bsr_ms`` (None, with the error logged, where this torch has
   no such product).  The grouped matmul
   against its plain version on the MoE phase's operands, with
   ``torch._grouped_mm`` (bf16, where this torch has it) or a per-expert
   ``torch.matmul`` loop as the library time; the check must reject two
   planted faults (a dropped k-slice, +0.1 on one row).
6. **harvest**: ``repro_torch.launch.harvest_dispatch`` on the vendored
   corpus with the ``cuda`` kernels, d = 32 and 128, 3 repeats, the tree
   in a temporary store root of its own; its agreement and never-worse
   results are printed, not enforced (at n <= 256 a call is the launch
   path).  CSVs go to ``chiprun_out/harvest``.

Each phase prints its seconds.

Tolerance: each side of an SpMM comparison is allowed ``4 * eps * (|A| @
|B|) + 5e-4 + 5e-4 * |C|`` (eps of the value dtype), the bound of
``tests/test_differential.py``; a comparison of two computed sides is
allowed the sum of both.  The grouped matmul forms its products exactly
in fp32, so each side is allowed ``4 * eps_f32 * (|x| @ |w|) + 5e-4``
plus one rounding to the output dtype (``moe_block.grouped_tolerance``),
on the routed rows; the padding rows must be 0.

``bound_ms`` counts what the inputs need: A in the smaller of two forms
(CSR at the layout's widths, i.e. nnz * (value + column index) bytes plus
(n + 1) int32 row pointers, or the packed layout's own bytes, which is
smaller for a blocked layout), B read once and C written once, against
2 * nnz * d operations; ``bound_layout_ms`` puts the bytes of the layout
the kernel reads (padding included) in place of A's: the packed arrays,
for the banded kernel its diagonals (not the band, which only the plain
version reads).  The grouped matmul's TFLOP/s count 2 * K * N per padded
row and per routed row; its tile traffic is what its tiling copies into
shared memory (each output tile's x rows and w columns), over kernel ms.

The last lines are the ``{"kernels": [...]}`` record, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": ...}``.
Without a GPU, or without the port beside it, the script exits nonzero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: Published H100 SXM peaks (vendor data sheet, dense): HBM bytes/s and
#: FLOP/s by operand type (fp32 on CUDA cores, bf16 on tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

ATOL = RTOL = 5e-4
D = 64
STEPS = 8
#: n for the bf16i16 rows: int16 slab-local indices need n <= 32767.
N_INT16 = 32760
#: log2 n of the calibration sweep under ``--quick`` (the full run sweeps
#: at ``repro_torch.core.calibrate.CARD_SCALE``).
CAL_SCALE_QUICK = 14

#: The serving phase: (structure, forced strategy or "auto").
SERVE_RUNS = (("moe-block", "auto"), ("banded", "auto"),
              ("scale-free", "auto"), ("uniform", "auto"),
              ("scale-free", "binned"), ("scale-free", "rowsplit"))

#: The MoE phase: qwen3-moe-235b-a22b's expert FFN (src/repro/configs/
#: qwen3_moe_235b_a22b.py), and a small shape for ``--quick``.
MOE_FULL = {"tokens": 4096, "experts": 128, "top_k": 8, "d_model": 4096,
            "d_ff": 1536}
MOE_QUICK = {"tokens": 512, "experts": 16, "top_k": 2, "d_model": 256,
             "d_ff": 256}
MOE_DTYPES = ("bfloat16", "float32")

#: Kernel name -> (its CUDA source, the TPU kernel it replaces, the
#: serving run whose layout the kernel phase measures, its formats).
KERNELS = {
    "csr_spmm": ("src/repro_torch/csrc/csr_spmm.cu",
                 "src/repro/kernels/csr_spmm.py:172", ("uniform", "auto"),
                 ("csr", "ell", "ell_coo")),
    "binned_spmm": ("src/repro_torch/csrc/binned_spmm.cu",
                    "src/repro/kernels/binned_spmm.py:142",
                    ("scale-free", "binned"), ("binned",)),
    "rowsplit_spmm": ("src/repro_torch/csrc/rowsplit_spmm.cu",
                      "src/repro/kernels/binned_spmm.py:297",
                      ("scale-free", "rowsplit"), ("rowsplit",)),
    "bcsr_spmm": ("src/repro_torch/csrc/bcsr_spmm.cu",
                  "src/repro/kernels/bcsr_spmm.py:49", ("moe-block", "auto"),
                  ("bcsr",)),
    "banded_spmm": ("src/repro_torch/csrc/banded_spmm.cu",
                    "src/repro/kernels/banded_spmm.py:36", ("banded", "auto"),
                    ("dia",)),
}

#: The MoE path's kernel: (its CUDA source, the TPU kernel it replaces).
GROUPED = ("src/repro_torch/csrc/grouped_matmul.cu",
           "src/repro/kernels/grouped_matmul.py:40")

#: Further serving runs whose layout a kernel is also timed on.
EXTRA_RUNS = {"csr_spmm": (("scale-free", "auto"),)}

#: Numbers of an SpMM kernel's row that the record carries.
RECORD_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "bound_layout_ms", "stored_per_nnz",
               "read_per_nnz", "diagonals", "derive_host_ms", "pieces",
               "largest_piece_nnz", "split_tiles", "real_slots",
               "carry_rows", "carries", "carry_bytes", "empty_rows",
               "call_alloc_bytes", "partials_bytes", "variant",
               "library_bsr_ms")

#: Every kernel, in the order of the record.
KERNEL_NAMES = (*KERNELS, "grouped_matmul")


class SmokeFailure(RuntimeError):
    """A phase found the port wrong."""


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text: str) -> list:
    """``ptxas -v``'s lines per kernel function: the function, registers
    and shared memory, stack and spills, and any performance warning."""
    keep = ("Compiling entry function", "registers", "spill",
            "Performance", "setmaxnreg", "wgmma")
    return [line.strip() for line in text.splitlines()
            if any(k in line for k in keep)]


def abs_product(m, b):
    """``|A| @ |B|`` in fp32 on B's device, from the row-major COO."""
    import torch
    from repro_torch.sparse.spmm import segment_sum
    dev = b.device
    out = torch.zeros(m.n, b.shape[1], dtype=torch.float32, device=dev)
    return segment_sum(
        out, b.abs().to(torch.float32), torch.from_numpy(m.cols).to(dev),
        torch.from_numpy(abs(m.vals).astype("float32")).to(dev),
        torch.from_numpy(m.rows).to(dev))


def check_close(what: str, got, ref, absprod, eps: float) -> tuple:
    """Hold ``got`` against ``ref``; both computed, so the bound is the sum
    of both sides' bounds.  Returns ``(max_abs_err, worst_margin)``."""
    import torch
    if tuple(got.shape) != tuple(ref.shape):
        raise SmokeFailure(f"{what}: shape {tuple(got.shape)} vs "
                           f"{tuple(ref.shape)}")
    g, r = got.to(torch.float32), ref.to(torch.float32)
    if not bool(torch.isfinite(g).all()):
        raise SmokeFailure(f"{what}: non-finite values")
    err = (g - r).abs()
    bound = 2 * (4 * eps * absprod + ATOL) + RTOL * (g.abs() + r.abs())
    worst = float((err - bound).max())
    max_err = float(err.max())
    if worst > 0:
        raise SmokeFailure(f"{what}: max |err| {max_err:.3e} exceeds the "
                           f"bound by {worst:.3e}")
    return max_err, worst


def layout_bytes(layout) -> int:
    """Bytes of a layout's packed tensor fields, padding included."""
    import dataclasses
    import torch
    return sum(v.numel() * v.element_size()
               for f in dataclasses.fields(layout)
               if f.name not in LAYOUT_SKIP
               for v in [getattr(layout, f.name)]
               if isinstance(v, torch.Tensor))


def work_list_size(layout) -> dict:
    """Size of a row-tile layout's work list: pieces, the largest piece's
    real entries, split tiles (CSR)."""
    import torch
    if not hasattr(layout, "piece_ptr"):
        return {}
    ends = torch.cumsum(layout.chunk_len.long(), 0)
    ends = torch.cat([ends.new_zeros(1), ends])
    ptr = layout.piece_ptr.long()
    per_piece = ends[ptr[1:]] - ends[ptr[:-1]]
    out = {"pieces": layout.num_pieces,
           "largest_piece_nnz": int(per_piece.max()),
           "real_slots": int(ends[-1]), "slots": layout.vals.numel()}
    if hasattr(layout, "split_tiles"):
        out["split_tiles"] = int(layout.split_tiles.numel())
    return out


def torch_csr(m, dev, dtype=None):
    """A as a ``torch.sparse`` CSR tensor (fp32 unless ``dtype``): the
    library yardstick."""
    import numpy as np
    import torch
    crow = torch.from_numpy(m.row_ptr().astype(np.int64)).to(dev)
    col = torch.from_numpy(m.cols.astype(np.int64)).to(dev)
    val = torch.from_numpy(m.vals.astype(np.float32)).to(dev, dtype)
    return torch.sparse_csr_tensor(crow, col, val, size=(m.n, m.n))


def serve_run(structure: str, strategy: str, m, disp, n: int, steps: int,
              dev, tag: str = "") -> dict:
    """Serve one run through ``serve_spmm_stream`` on ``disp``; the chosen
    format's kernel must launch, and the last request's C must match the
    port's ``"torch"`` backend on the card."""
    from repro_torch import kernels
    from repro_torch.core.precision import as_precision
    from repro_torch.kernels import bcsr_spmm as bcsr_module
    from repro_torch.kernels import registry
    from repro_torch.launch import serve

    what = f"{structure}/{strategy}{tag}"
    args = serve.parser().parse_args(
        ["--spmm-stream", "--spmm-structure", structure,
         "--spmm-n", str(n), "--spmm-d", str(D),
         "--spmm-steps", str(steps), "--spmm-strategy", strategy,
         "--device", str(dev)])
    before = kernels.launch_counts()
    variants_before = dict(bcsr_module.LAUNCHES_BY_VARIANT)
    log(f"[serve] === {structure} (strategy {strategy}{tag}) ===")
    rec = serve.serve_spmm_stream(args, dispatcher=disp, matrix=m)
    after = kernels.launch_counts()
    plan = rec["plan"]
    kernel = next(k for k, v in KERNELS.items() if plan.chosen in v[3])
    delta = after[kernel] - before[kernel]
    log(f"[serve] {what}: chosen {plan.chosen} @ {plan.precision} -> "
        f"kernel {kernel}, launches +{delta}; startup "
        f"{rec['startup_ms']:.1f} ms, p50 {rec['p50_us']:.1f} us, p99 "
        f"{rec['p99_us']:.1f} us, {rec['gflops']:.2f} GFLOP/s")
    if delta <= 0:
        raise SmokeFailure(f"{what}: kernel {kernel} of the chosen format "
                           f"{plan.chosen} never launched")
    prec = as_precision(plan.precision)
    if kernel == "bcsr_spmm":
        bcsr_fast_path(structure, plan.layout.t, prec.value_torch, delta,
                       variants_before)
    # Hold the last request's C against the torch backend on the card.
    b, c = rec["last"]
    ctx = registry.KernelContext(
        bcsr_block=disp.bcsr_block, plan_d=D, precision=prec,
        convert=lambda mm, f, _p=prec: disp.convert(mm, f, precision=_p),
        device=dev)
    ref = registry.get(plan.chosen, "torch").bind(m, ctx)(b)
    err, _ = check_close(f"{what} C vs torch backend", c, ref,
                         abs_product(m, b), prec.eps)
    log(f"[serve] {what}: C {tuple(c.shape)} finite, max |C - torch| = "
        f"{err:.3e} within bound")
    del ref
    empty_cache(dev)
    return dict(rec, kernel=kernel, launches=delta)


def serve_phase(n: int, steps: int, dev) -> dict:
    """The main path: serve every run under the default ceilings, then plan
    the auto structures under the calibrated ones and serve again each
    whose choice changed; hold every C against the torch backend."""
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.sparse.dispatch import Dispatcher

    matrices, dispatchers, runs = {}, {}, {}
    kernels.reset_launch_counts()
    for structure, strategy in SERVE_RUNS:
        if structure not in matrices:
            t0 = time.perf_counter()
            matrices[structure] = serve.build_stream_matrix(structure, n)
            # The default ceilings: the kernel phase measures the layouts
            # these runs pack, whatever the calibration would pick.
            dispatchers[structure] = Dispatcher(device=dev,
                                                calibration=False, tree=False)
            log(f"[serve] built {structure} n={n} "
                f"nnz={matrices[structure].nnz} in "
                f"{time.perf_counter() - t0:.1f}s")
        runs[(structure, strategy)] = serve_run(
            structure, strategy, matrices[structure],
            dispatchers[structure], n, steps, dev)
    choices = calibrated_choices(matrices, runs, n, steps, dev)
    counts = kernels.launch_counts()
    log(f"[serve] launches on the serving path: {counts}")
    return {"runs": runs, "counts": counts, "matrices": matrices,
            "dispatchers": dispatchers, "choices": choices}


def _predictions(plan) -> str:
    return ", ".join(
        f"{c.format} {c.predicted_gflops:.1f}" for c in plan.candidates
        if c.eligible and c.precision == "f32i32")


def calibrated_choices(matrices: dict, runs: dict, n: int, steps: int,
                       dev) -> dict:
    """Plan each auto structure under the calibrated ceilings (classify and
    plan only) beside its default plan; where the choice differs, serve it
    again under the calibrated plan."""
    from repro_torch.sparse.dispatch import Dispatcher

    out = {}
    for structure, strategy in SERVE_RUNS:
        if strategy != "auto":
            continue
        m = matrices[structure]
        served = runs[(structure, "auto")]
        default = served["plan"].dispatch
        disp = Dispatcher(device=dev, tree=False)
        plan = disp.plan(m, D, reuse=steps)
        chosen = plan.candidate(plan.chosen, plan.precision)
        if chosen.ceiling_source != "calibrated":
            raise SmokeFailure(f"{structure}: the calibrated plan's "
                               f"{plan.chosen} reads "
                               f"{chosen.ceiling_source} ceilings")
        pred_default = default.candidate(
            default.chosen, default.precision).predicted_gflops
        log(f"[serve] calibrated {structure}: default ceilings choose "
            f"{default.chosen} @ {default.precision} (predicted "
            f"{pred_default:.2f} GFLOP/s, served {served['gflops']:.2f}); "
            f"calibrated ceilings choose {plan.chosen} @ {plan.precision} "
            f"(predicted {chosen.predicted_gflops:.2f} GFLOP/s)")
        log(f"[serve] calibrated {structure}: predicted GFLOP/s by format, "
            f"default: {_predictions(default)}; calibrated: "
            f"{_predictions(plan)}")
        rec = {"default": default.chosen, "calibrated": plan.chosen,
               "predicted_default": pred_default,
               "predicted_calibrated": chosen.predicted_gflops,
               "served_default_gflops": served["gflops"]}
        if (plan.chosen, plan.precision) != (default.chosen,
                                             default.precision):
            run = serve_run(structure, "auto", m, disp, n, steps, dev,
                            tag=", calibrated ceilings")
            if run["plan"].chosen != plan.chosen:
                raise SmokeFailure(f"{structure}: served {run['plan'].chosen}"
                                   f" under the calibrated plan "
                                   f"{plan.chosen}")
            runs[(structure, "calibrated")] = run
            rec.update(served_calibrated_gflops=run["gflops"],
                       p50_us=run["p50_us"], p99_us=run["p99_us"])
        out[structure] = rec
    return out


def bcsr_fast_path(structure: str, t: int, dtype, launches: int,
                   before: dict) -> None:
    """A serving run's BCSR launches must all have taken the variant
    ``bcsr_variant`` names for (t, d, dtype); ``moe-block``'s a fast one."""
    from repro_torch.kernels import bcsr_spmm as bcsr_module
    want = bcsr_module.bcsr_variant(t, D, dtype)
    moved = {k: v - before[k]
             for k, v in bcsr_module.LAUNCHES_BY_VARIANT.items()
             if v != before[k]}
    log(f"[serve] {structure}: bcsr_spmm launches by variant {moved} "
        f"(t={t}, d={D}, {dtype})")
    if moved != {want: launches}:
        raise SmokeFailure(f"{structure}: bcsr_spmm launched {moved}, not "
                           f"{launches} x {want}")
    if structure == "moe-block" and want == "generic":
        raise SmokeFailure(f"moe-block: bcsr_spmm took the generic kernel "
                           f"at t={t}, {dtype}")


def moe_phase(quick: bool, dev) -> dict:
    """The MoE path at each dtype: route, block, grouped matmul, checked
    row by row against the experts' dense products."""
    from repro_torch import kernels
    from repro_torch.launch import moe_block

    widths = MOE_QUICK if quick else MOE_FULL
    runs = {}
    kernels.reset_launch_counts()
    for dtype in MOE_DTYPES:
        argv = [f"--{k.replace('_', '-')}={v}" for k, v in widths.items()]
        argv += ["--bm=128", "--bk=128", "--bn=128", f"--dtype={dtype}",
                 "--seed=0", f"--device={dev}"]
        log(f"[moe] === {dtype}: {' '.join(argv)} ===")
        before = kernels.launch_counts()["grouped_matmul"]
        rec = moe_block.main(argv)
        delta = kernels.launch_counts()["grouped_matmul"] - before
        log(f"[moe] {dtype}: {rec['routed'].x.shape[0]} block-aligned rows, "
            f"max |out - x @ w[expert]| {rec['max_abs_err']:.3e} within "
            f"bound, grouped_matmul launches +{delta}, route "
            f"{rec['route_ms']:.1f} ms, first matmul {rec['matmul_ms']:.1f} "
            f"ms")
        if delta <= 0:
            raise SmokeFailure(f"moe {dtype}: grouped_matmul never launched")
        runs[dtype] = {"w": rec["w"], "routed": rec["routed"]}
        del rec
        empty_cache(dev)
    counts = kernels.launch_counts()
    log(f"[moe] launches on the MoE path: {counts}")
    return {"runs": runs, "counts": counts, "widths": widths}


def empty_cache(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


#: Layout fields left out of ``layout_bytes``: the plain versions' owner
#: ids and band, and the work list and carry lists derived from the
#: packed arrays.
LAYOUT_SKIP = {"tile_ids", "chunk_visits", "block_rows", "chunk_len",
               "piece_ptr", "piece_owner", "piece_split", "split_tiles",
               "band", "last_slot", "shared", "carry_rows", "carry_chunks",
               "empty_rows"}


def diagonal_walk_size(layout, m) -> dict:
    """The banded kernel's walk: diagonals, slots read per nonzero (k * n /
    nnz), and the host time to derive them from the band (checked equal to
    the layout's)."""
    import torch
    if not hasattr(layout, "diags"):
        return {}
    from repro_torch.kernels.banded_spmm import band_diagonals
    from repro_torch.sparse.formats import host_values
    band = host_values(layout.band)
    t0 = time.perf_counter()
    offsets, diags = band_diagonals(band, layout.w, layout.t)
    derive_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(torch.from_numpy(offsets), layout.offsets) and
            (diags == host_values(layout.diags)).all()):
        raise SmokeFailure("band_diagonals of the band differ from the "
                           "layout's diagonals")
    return {"diagonals": int(offsets.shape[0]),
            "read_per_nnz": layout.diags.numel() / max(m.nnz, 1),
            "derive_host_ms": derive_ms}


def carry_fold_size(layout, wrapper, b) -> dict:
    """The row-split fold: carry rows, the carries they sum, the carry
    buffer's bytes and the rows with no entry.  A call must allocate less
    than the ``[C * W, d]`` fp32 window partials of the first version, and
    two calls must give C equal bit for bit."""
    import torch
    if not hasattr(layout, "carry_rows"):
        return {}
    dev, d = b.device, b.shape[1]
    span = layout.carry_chunks.long()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    first = wrapper(layout, b)
    torch.cuda.synchronize(dev)
    alloc = torch.cuda.max_memory_allocated(dev) - base
    partials = layout.num_chunks * layout.window * d * 4
    if alloc >= partials:
        raise SmokeFailure(f"rowsplit_spmm allocated {alloc} bytes, no less "
                           f"than the {partials} of [C * W, d] partials")
    second = wrapper(layout, b)
    bits = torch.int32 if first.dtype == torch.float32 else torch.int16
    if not torch.equal(first.view(bits), second.view(bits)):
        raise SmokeFailure(f"rowsplit_spmm ({b.dtype}): two calls differ")
    del first, second
    return {"carry_rows": int(span.shape[0]),
            "carries": int((span[:, 1] - span[:, 0] + 1).sum()),
            "carry_bytes": layout.num_chunks * 2 * d * 4,
            "empty_rows": int(layout.empty_rows.numel()),
            "call_alloc_bytes": alloc, "partials_bytes": partials}


def bcsr_variant_run(layout, wrapper, b) -> dict:
    """The BCSR kernel's variant: a call must launch the one
    ``bcsr_variant`` names, and two calls must give C equal bit for bit."""
    import torch
    if not hasattr(layout, "block_ptr"):
        return {}
    from repro_torch.kernels import bcsr_spmm as bcsr_module
    want = bcsr_module.bcsr_variant(layout.t, b.shape[1], b.dtype)
    before = dict(bcsr_module.LAUNCHES_BY_VARIANT)
    first = wrapper(layout, b)
    second = wrapper(layout, b)
    moved = {k: v - before[k]
             for k, v in bcsr_module.LAUNCHES_BY_VARIANT.items()
             if v != before[k]}
    if moved != {want: 2}:
        raise SmokeFailure(f"bcsr_spmm ({b.dtype}): two calls launched "
                           f"{moved}, not 2 x {want}")
    bits = torch.int32 if first.dtype == torch.float32 else torch.int16
    if not torch.equal(first.view(bits), second.view(bits)):
        raise SmokeFailure(f"bcsr_spmm ({b.dtype}): two calls differ")
    del first, second
    return {"variant": want}


def bsr_library_row(layout, b, runs: int) -> dict:
    """``torch.sparse.mm`` with A as BSR of the layout's t x t blocks in
    B's dtype, or None (the error logged) where this torch has no such
    product.  The BSR tensor is built from the layout's own block arrays:
    ``to_sparse_bsr((t, t))`` of the CSR tensor gives the same blocks, but
    its conversion time grows faster than n and does not finish at
    n = 2**20 within a run's time limit."""
    import torch
    from repro_torch.core.device import median_ms
    if not hasattr(layout, "block_ptr"):
        return {}
    try:
        a = torch.sparse_bsr_tensor(layout.block_ptr.long(),
                                    layout.block_cols.long(), layout.blocks,
                                    size=(layout.n, layout.n))
        ms = median_ms(lambda: torch.sparse.mm(a, b), runs)
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
        log(f"[kernel] torch.sparse.mm with A as BSR at {b.dtype}: "
            f"{type(e).__name__}: {e}")
        ms = None
    empty_cache(b.device)
    return {"library_bsr_ms": ms}


def kernel_row(name, layout, m, b, index_bytes: int, runs: int,
               plain_runs: int) -> dict:
    """One kernel against its plain version on one layout, with times; the
    library time is ``torch.sparse.mm`` on A as CSR in B's dtype (None
    where this torch has no such product)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.device import median_ms
    mod = kernels.KERNEL_MODULES[name]
    wrapper = getattr(mod, name)
    plain = getattr(mod, f"{name}_plain")
    out = wrapper(layout, b)
    ref = plain(layout, b)
    eps = float(torch.finfo(b.dtype).eps)
    err, margin = check_close(f"{name} vs plain ({b.dtype})", out, ref,
                              abs_product(m, b), eps)
    del out, ref
    fold = carry_fold_size(layout, wrapper, b)
    variant = bcsr_variant_run(layout, wrapper, b)
    ms = median_ms(lambda: wrapper(layout, b), runs)
    plain_ms = median_ms(lambda: plain(layout, b), plain_runs)
    a = torch_csr(m, b.device, b.dtype)
    try:
        lib_ms = median_ms(lambda: torch.sparse.mm(a, b), runs)
    except (RuntimeError, NotImplementedError) as e:
        log(f"[kernel] torch.sparse.mm at {b.dtype}: {e}")
        lib_ms = None
    del a
    bsr = bsr_library_row(layout, b, runs)
    bc_bytes = 2 * b.numel() * b.element_size()
    # What the inputs need: A in the smaller of CSR at the layout's widths
    # and the packed layout (a blocked layout stores each value once and
    # one set of coordinates per block), B once, C once.
    a_bytes = layout_bytes(layout)
    csr_bytes = m.nnz * (b.element_size() + index_bytes) + 4 * (m.n + 1)
    nbytes = min(csr_bytes, a_bytes) + bc_bytes
    layout_nbytes = a_bytes + bc_bytes
    # Stored value slots (padding included) per true nonzero.
    stored = next(getattr(layout, f).numel() for f in ("vals", "blocks",
                                                       "band")
                  if hasattr(layout, f))
    flops = 2.0 * m.nnz * b.shape[1]
    t_ops = flops / PEAK_FLOPS[str(b.dtype).split(".")[-1]] * 1e3

    def bound(n_bytes: int) -> tuple:
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")
    bound_ms, bound_by = bound(nbytes)
    empty_cache(b.device)
    return {"max_abs_err": err, "margin": margin, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_layout_ms": bound(layout_nbytes)[0],
            "library_ms": lib_ms, "bytes": nbytes,
            "layout_bytes": layout_nbytes, "flops": flops,
            "stored_per_nnz": stored / max(m.nnz, 1),
            **work_list_size(layout), **diagonal_walk_size(layout, m),
            **fold, **variant, **bsr}


def log_row(name: str, structure: str, row: dict) -> None:
    work = "" if "pieces" not in row else (
        f"; work list {row['pieces']} pieces, largest "
        f"{row['largest_piece_nnz']} real entries, "
        f"{row.get('split_tiles', 'n/a')} split tiles, "
        f"{row['real_slots']} of {row['slots']} slots real")
    if "diagonals" in row:
        work += (f"; walks {row['diagonals']} diagonals, read per nonzero "
                 f"{row['read_per_nnz']:.2f}, derived on the host in "
                 f"{row['derive_host_ms']:.1f} ms")
    if "variant" in row:
        work += (f"; variant {row['variant']} (two calls equal bit for "
                 f"bit), torch.sparse.mm with A as BSR "
                 f"{row['library_bsr_ms']} ms")
    if "carry_rows" in row:
        work += (f"; fold: {row['carry_rows']} carry rows summing "
                 f"{row['carries']} carries, carry buffer "
                 f"{row['carry_bytes'] / 1e6:.1f} MB, {row['empty_rows']} "
                 f"empty rows, a call allocates "
                 f"{row['call_alloc_bytes'] / 1e6:.1f} MB (partials would "
                 f"be {row['partials_bytes'] / 1e6:.1f} MB), two calls "
                 f"equal bit for bit")
    log(f"[kernel] {name} {row['precision']} n={row['n']} ({structure}, "
        f"layout {row['format']}): max|err| {row['max_abs_err']:.3e} (worst "
        f"err - bound {row['margin']:.3e} <= 0), kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, torch.sparse.mm "
        f"{row['library_ms']} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), layout bound {row['bound_layout_ms']:.4f} "
        f"ms; stored values per nonzero {row['stored_per_nnz']:.2f}{work}")


def kernel_phase(served: dict, quick: bool, dev) -> list:
    """Each kernel vs its plain version at every declared precision."""
    import numpy as np
    import torch
    from repro_torch.core.precision import as_precision
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.sparse import stream
    from repro_torch.sparse.dispatch import Dispatcher

    runs, plain_runs = (3, 2) if quick else (10, 3)
    rng = np.random.default_rng(7)
    records = []
    for name, (source, replaces, run_key, formats) in KERNELS.items():
        # The designated serving run, else the first that chose a format
        # of this kernel.
        keys = [run_key] + [k for k in SERVE_RUNS if k != run_key]
        run_key = next(k for k in keys
                       if served["runs"][k]["plan"].chosen in formats)
        structure, _ = run_key
        run = served["runs"][run_key]
        m = served["matrices"][structure]
        disp = served["dispatchers"][structure]
        fmt_name = run["plan"].chosen
        spec = registry.get(fmt_name, "cuda")
        rows = []
        for token in spec.supported_precisions:
            if token == run["plan"].precision:
                mm, layout = m, run["plan"].layout
            else:
                small = token == "bf16i16"
                mm = serve.build_stream_matrix(structure, N_INT16) \
                    if small else m
                dd = Dispatcher(device=dev, calibration=False, tree=False) \
                    if small else disp
                layout = stream.plan(mm, stream.BSpec(d=D, reuse=STEPS),
                                     strategy=fmt_name, precision=token,
                                     dispatcher=dd).layout
            dtype = torch.bfloat16 if token.startswith("bf16") \
                else torch.float32
            b = torch.from_numpy(rng.normal(size=(mm.n, D))
                                 .astype(np.float32)).to(dev, dtype)
            row = kernel_row(name, layout, mm, b,
                             as_precision(token).sizeof_idx, runs,
                             plain_runs)
            row.update(precision=token, n=mm.n, format=fmt_name)
            log_row(name, structure, row)
            rows.append(row)
            del b
        others = []
        for extra in EXTRA_RUNS.get(name, ()):
            erun = served["runs"][extra]
            if extra == run_key or erun["plan"].chosen not in formats:
                continue
            mm = served["matrices"][extra[0]]
            b = torch.from_numpy(rng.normal(size=(mm.n, D))
                                 .astype(np.float32)).to(dev)
            row = kernel_row(name, erun["plan"].layout, mm, b,
                             as_precision(erun["plan"].precision).sizeof_idx,
                             runs, plain_runs)
            row.update(precision=erun["plan"].precision, n=mm.n,
                       format=erun["plan"].chosen, structure=extra[0])
            log_row(name, extra[0], row)
            others.append(row)
            del b
        main = rows[0]
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": served["counts"][name],
            **{k: main[k] for k in RECORD_KEYS if k in main},
            "precision": main["precision"], "n": main["n"], "d": D,
            "structure": structure, "format": main["format"],
            "other_precisions": [
                {k: r[k] for k in ("precision", "n", *RECORD_KEYS)
                 if k in r}
                for r in rows[1:]],
            "other_layouts": [
                {k: r[k] for k in ("structure", "format", "precision", "n",
                                   *RECORD_KEYS) if k in r}
                for r in others]})
    # The banded kernel at the smallest block edges (n = t * odd).
    from repro_torch.kernels.banded_spmm import banded_spmm, banded_spmm_plain
    for nn in (1001, 1002, 1004):
        mm = serve.build_stream_matrix("banded", nn)
        layout = stream.plan(mm, D, strategy="dia",
                             dispatcher=Dispatcher(
                                 device=dev, calibration=False,
                                 tree=False)).layout
        b = torch.from_numpy(rng.normal(size=(nn, D)).astype(np.float32)
                             ).to(dev)
        err, _ = check_close(f"banded_spmm t={layout.t}",
                             banded_spmm(layout, b),
                             banded_spmm_plain(layout, b),
                             abs_product(mm, b), 2.0 ** -23)
        log(f"[kernel] banded_spmm t={layout.t} n={nn}: max|err| "
            f"{err:.3e} within bound")
    return records


def grouped_excess(got, ref, absprod, rows) -> tuple:
    """``got`` against ``ref``, two grouped-matmul outputs, on the routed
    ``rows`` within ``moe_block.grouped_tolerance``.  Returns ``(max |err|,
    worst err - bound, worst err / bound, padding rows zero on both
    sides)``; a non-finite ``got`` counts as an infinite excess."""
    import torch
    from repro_torch.launch.moe_block import grouped_tolerance
    g, r = got[rows].to(torch.float32), ref[rows].to(torch.float32)
    err = (g - r).abs()
    if not bool(torch.isfinite(g).all()):
        err = torch.full_like(err, float("inf"))
    bound = grouped_tolerance(absprod[rows], got.dtype, g, r)
    padding = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    padding[rows] = False
    zero = not (bool(got[padding].any()) or bool(ref[padding].any()))
    return (float(err.max()), float((err - bound).max()),
            float((err / bound).max()), zero)


def grouped_row(w, routed, runs: int, plain_runs: int) -> dict:
    """The grouped matmul against its plain version on one MoE operand,
    with times; the library time is one ``torch._grouped_mm`` call (bf16,
    where this torch has it) or else a per-expert ``torch.matmul`` loop.

    The check must also reject two planted faults: the kernel run with the
    first 32-wide k-slice of x dropped, and +0.1 on one routed row."""
    import torch
    from repro_torch.core.device import median_ms
    from repro_torch.kernels.grouped_matmul import (
        TILE_N, grouped_matmul, grouped_matmul_plain, tile_rows)
    x, gids = routed.x, routed.group_ids
    bm = x.shape[0] // gids.shape[0]
    T, K = x.shape
    E, _, N = w.shape
    rows = routed.rows.reshape(-1)
    what = f"grouped_matmul vs plain ({x.dtype})"
    out = grouped_matmul(x, w, gids, bm=bm)
    ref = grouped_matmul_plain(x, w, gids, bm=bm)
    if tuple(out.shape) != tuple(ref.shape):
        raise SmokeFailure(f"{what}: shape {tuple(out.shape)} vs "
                           f"{tuple(ref.shape)}")
    absprod = grouped_matmul_plain(x.abs().float(), w.abs().float(), gids,
                                   bm=bm)
    err, margin, ratio, zero = grouped_excess(out, ref, absprod, rows)
    if margin > 0:
        raise SmokeFailure(f"{what}: max |err| {err:.3e} exceeds the bound "
                           f"by {margin:.3e}")
    if not zero:
        raise SmokeFailure(f"{what}: a padding row is not zero")
    x_cut = x.clone()
    x_cut[:, :32] = 0
    faults = {"first 32-wide k-slice dropped":
              grouped_matmul(x_cut, w, gids, bm=bm)}
    del x_cut
    faults["+0.1 on one routed row"] = out.clone()
    faults["+0.1 on one routed row"][rows[0]] += 0.1
    for fault, bad in faults.items():
        bad_err, bad_margin, bad_ratio, _ = grouped_excess(bad, ref, absprod,
                                                           rows)
        if bad_margin <= 0:
            raise SmokeFailure(f"{what}: the check let a planted fault "
                               f"through ({fault}: max |err| {bad_err:.3e})")
        log(f"[kernel] grouped_matmul {x.dtype}: planted fault ({fault}) "
            f"rejected, max |err| {bad_err:.3e}, worst err / bound "
            f"{bad_ratio:.1f}")
    del out, ref, absprod, faults
    ms = median_ms(lambda: grouped_matmul(x, w, gids, bm=bm), runs)
    plain_ms = median_ms(lambda: grouped_matmul_plain(x, w, gids, bm=bm),
                         plain_runs)
    # Rows per expert in the sorted buffer: the groups' end offsets.
    ends = torch.cumsum(torch.bincount(gids.long(), minlength=E) * bm,
                        0).to(torch.int32)
    if x.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        library = "torch._grouped_mm"
        lib_ms = median_ms(lambda: torch._grouped_mm(x, w, offs=ends), runs)
    else:
        library = "per-expert torch.matmul loop"
        bounds = [0] + ends.tolist()

        def loop():
            for e in range(E):
                lo, hi = bounds[e], bounds[e + 1]
                torch.matmul(x[lo:hi], w[e])
        lib_ms = median_ms(loop, runs)
    peak = PEAK_FLOPS[str(x.dtype).split(".")[-1]]

    def bound(n_rows: int) -> tuple:
        """(ms, by) for n_rows rows of x read, w read once, out written."""
        nbytes = (n_rows * (K + N) + w.numel()) * x.element_size() + \
            gids.numel() * gids.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * n_rows * K * N / peak * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")
    bound_ms, bound_by = bound(T)
    routed_ms, routed_by = bound(rows.numel())
    flops = 2.0 * T * K * N
    # What the kernel's tiling copies into shared memory (from L2 or HBM):
    # every (row tile, column tile) reads its x rows and its w columns.
    tm = tile_rows(bm)
    tile_bytes = (T // tm) * (N // TILE_N) * K * (tm + TILE_N) * \
        x.element_size()
    empty_cache(x.device)
    return {"max_abs_err": err, "margin": margin, "err_over_bound": ratio,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_routed_ms": routed_ms,
            "bound_routed_by": routed_by, "library_ms": lib_ms,
            "library": library, "flops": flops, "rows": T,
            "routed_rows": rows.numel(), "tflops": flops / ms / 1e9,
            "tflops_routed": 2.0 * rows.numel() * K * N / ms / 1e9,
            "tile_traffic_gb": tile_bytes / 1e9,
            "tile_traffic_tb_s": tile_bytes / ms / 1e9}


def grouped_record(moe: dict, quick: bool) -> dict:
    """The grouped matmul's record: the config dtype (bf16) first."""
    runs, plain_runs = (3, 2) if quick else (10, 3)
    rows = []
    for dtype in MOE_DTYPES:
        run = moe["runs"][dtype]
        row = grouped_row(run["w"], run["routed"], runs, plain_runs)
        row.update(precision=dtype)
        log(f"[kernel] grouped_matmul {dtype} T={row['rows']} "
            f"({row['routed_rows']} routed): max|err| "
            f"{row['max_abs_err']:.3e} on the routed rows (worst err - "
            f"bound {row['margin']:.3e} <= 0, worst err / bound "
            f"{row['err_over_bound']:.3f}), kernel {row['ms']:.4f} ms "
            f"({row['tflops']:.1f} TFLOP/s over the padded rows, "
            f"{row['tflops_routed']:.1f} over the routed rows), plain "
            f"{row['plain_ms']:.4f} ms, {row['library']} "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) over the padded rows, "
            f"{row['bound_routed_ms']:.4f} ms ({row['bound_routed_by']}) "
            f"over the routed rows; its tiles copy "
            f"{row['tile_traffic_gb']:.2f} GB into shared memory, "
            f"{row['tile_traffic_tb_s']:.2f} TB/s")
        rows.append(row)
    main = rows[0]
    return {
        "name": "grouped_matmul", "route": "cuda", "source": GROUPED[0],
        "replaces": GROUPED[1],
        "launches": moe["counts"]["grouped_matmul"],
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "library",
                                "bound_routed_ms", "precision", "rows",
                                "routed_rows", "tflops", "tflops_routed",
                                "tile_traffic_gb", "tile_traffic_tb_s")},
        "widths": moe["widths"],
        "other_precisions": [
            {k: r[k] for k in ("precision", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "bound_routed_ms",
                               "library_ms", "library", "rows",
                               "routed_rows", "tflops", "tflops_routed",
                               "tile_traffic_gb", "tile_traffic_tb_s")}
            for r in rows[1:]]}


def calibrate_phase(scale: Optional[int], dev) -> dict:
    """``serve --calibrate``'s sweep on the card: every SpMM kernel must
    launch, and the saved file must load back at this registry version."""
    from repro_torch import kernels
    from repro_torch.core.calibrate import CalibrationStore
    from repro_torch.core.hardware import h100_from_device
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.sparse.dispatch import FORMATS

    kernels.reset_launch_counts()
    cal = serve.run_startup_calibration(dev, scale=scale)
    counts = kernels.launch_counts()
    log(f"[calibrate] launches in the sweep: {counts}")
    missing = [k for k in KERNELS if counts[k] <= 0]
    if missing:
        raise SmokeFailure(f"the calibration sweep never launched {missing}")
    if [e.format for e in cal.entries] != list(FORMATS):
        raise SmokeFailure(f"the sweep fitted "
                           f"{[e.format for e in cal.entries]}, not "
                           f"{list(FORMATS)}")
    for e in cal.entries:
        measured = ", ".join(f"d={d} {g:.2f}"
                             for d, g in sorted(e.measured.items()))
        log(f"[calibrate] {e.format:8s} {e.precision}: peak_fraction "
            f"{e.peak_fraction:.6f}, d_half {e.d_half:.2f}, sustained "
            f"{e.sustained_gflops:.2f} GF/s (useful_fraction "
            f"{e.useful_fraction:.3f}); measured GF/s {measured}")
    loaded = CalibrationStore().load(h100_from_device(dev), "cuda")
    if loaded is None or \
            loaded.registry_version != registry.REGISTRY_VERSION:
        raise SmokeFailure(f"the saved calibration does not load back at "
                           f"registry v{registry.REGISTRY_VERSION}: "
                           f"{loaded}")
    log(f"[calibrate] saved {CalibrationStore().root}: backend "
        f"{loaded.backend}, registry v{loaded.registry_version}")
    return {"cal": cal, "counts": counts}


def harvest_phase(dev) -> dict:
    """The port's harvest on the vendored corpus with the CUDA kernels; the
    tree goes to a store root of its own.  Agreement and never-worse are
    reported, not enforced: at n <= 256 a call is the launch path."""
    import shutil
    import tempfile
    from repro_torch import kernels
    from repro_torch.data import corpus
    from repro_torch.data.dtree import DispatchTreeStore
    from repro_torch.launch import harvest_dispatch

    args = harvest_dispatch.parser().parse_args(
        ["--corpus-root", str(corpus.SAMPLES_DIR), "--backend", "cuda",
         "--device", str(dev), "--d", "32", "128", "--repeats", "3",
         "--out-dir", str(ROOT / "chiprun_out" / "harvest")])
    root = tempfile.mkdtemp(prefix="chip-smoke-tree-")
    try:
        kernels.reset_launch_counts()
        rec = harvest_dispatch.harvest(args, store=DispatchTreeStore(root))
        counts = kernels.launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    worse = [f"{r['matrix']} d={r['d']}" for r in rec["audit"]
             if not r["never_worse"]]
    log(f"[harvest] {len(rec['rows'])} cells timed on "
        f"{len({r['matrix'] for r in rec['rows']})} matrices, launches "
        f"{counts}; tree {rec['tree'].fingerprint()}; agreement "
        f"{rec['agreement']:.4f} over {len(rec['audit'])} pairs; "
        f"never-worse {'PASS' if rec['claim_ok'] else 'FAIL'} "
        f"(failing pairs: {worse or 'none'})")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="n = 2**14 instead of 2**20 (a short check)")
    args = ap.parse_args(argv)
    n = 2 ** 14 if args.quick else 2 ** 20

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port is not beside this script "
              f"({SRC / 'repro_torch'} missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The whole run reads and writes calibrations here and nowhere else:
    # a file left in the default root must never steer it.
    cal_root = tempfile.mkdtemp(prefix="chip-smoke-cal-")
    os.environ["REPRO_CALIBRATION_DIR"] = cal_root
    try:
        return run(args.quick, n)
    finally:
        shutil.rmtree(cal_root, ignore_errors=True)


def run(quick: bool, n: int) -> int:
    """Every phase in order; a failure raises."""
    import torch
    t_start = time.perf_counter()
    seconds = {}
    smi = nvidia_smi()
    log(f"[gpu] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build(verbose=True)
    seconds["build"] = time.perf_counter() - t0
    log(f"[build] {len(build.KERNELS)} kernels built in "
        f"{seconds['build']:.1f}s into {build.build_dir()}")
    for name, text in build.LAST_LOG.items():
        for line in ptxas_report(text):
            log(f"[build] {name}: {line}")
    log(f"kernels: {' '.join(KERNEL_NAMES)}")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    calibrated = calibrate_phase(CAL_SCALE_QUICK if quick else None, dev)
    seconds["calibrate"] = time.perf_counter() - t0
    log(f"[calibrate] phase took {seconds['calibrate']:.1f}s")
    t0 = time.perf_counter()
    served = serve_phase(n, STEPS, dev)
    seconds["serve"] = time.perf_counter() - t0
    log(f"[serve] phase took {seconds['serve']:.1f}s")
    t0 = time.perf_counter()
    moe = moe_phase(quick, dev)
    seconds["moe"] = time.perf_counter() - t0
    log(f"[moe] phase took {seconds['moe']:.1f}s")
    missing = [k for k in KERNEL_NAMES
               if served["counts"][k] + moe["counts"][k] <= 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on a path: {missing}")
    t0 = time.perf_counter()
    records = kernel_phase(served, quick, dev)
    records.append(grouped_record(moe, quick))
    for rec in records:
        rec["calibrate_launches"] = calibrated["counts"][rec["name"]]
    seconds["kernel"] = time.perf_counter() - t0
    log(f"[kernel] phase took {seconds['kernel']:.1f}s")
    t0 = time.perf_counter()
    harvest_phase(dev)
    seconds["harvest"] = time.perf_counter() - t0
    log(f"[harvest] phase took {seconds['harvest']:.1f}s")
    log(f"[time] seconds by phase: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}; total "
        f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
