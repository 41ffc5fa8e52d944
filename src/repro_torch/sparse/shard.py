"""Sharded SpMM execution tier: mesh-partitioned plans, run from one process.

Once the sparse operand is partitioned across devices, the binding
resource per shard can flip between memory bandwidth, the format's compute
ceiling and the collectives.  This module is that regime's dispatch layer:

    mesh = make_shard_mesh()                     # repro_torch.launch.mesh
    plan = sparse.plan(m, BSpec(d=64), mesh=mesh)   # -> ShardedPlan
    c = plan.execute(b)                          # per-shard replay
    print(plan.summary())                        # format + B-strategy audit

Partitioning follows structure, as format choice does:

  * CSR / ELL / BCSR take **contiguous row-block shards** balanced by nnz
    (``repro_torch.sparse.formats.nnz_balanced_splits``; BCSR cuts align
    to the block edge t).  The reduce-scatter strategy partitions by
    **columns** instead: each shard owns a slice of B and produces a
    full-height partial C, summed into row blocks.
  * DIA takes **diagonal-band shards**: contiguous runs of diagonals
    balanced by per-diagonal nnz; every band shard produces a full-height
    partial C.

The B-distribution strategy (``replicate``, ``all_gather`` or
``reduce_scatter``) is scored like a format candidate: the critical
shard's sparsity-aware roofline time plus the strategy's collective cost
(``repro_torch.core.roofline.collective_time``).  The scoring is the
reference's, on the host, number for number.

On a :class:`~repro_torch.launch.mesh.ShardMesh`, execution is one
process over the mesh's devices.  Each shard holds its own
``torch``-backend layout on its device (the reference's per-shard ``jax``
kernels; no shard is padded to the largest), and the collectives are
explicit tensor operations: ``replicate`` copies B to each shard's
device, ``all_gather`` concatenates the row slices of B on each device,
``reduce_scatter`` sums the full-height partials into each owner's row
block in shard order.  C is assembled on the plan's device in row order.
A mesh may repeat a device (``ShardMesh(["cuda:0"] * 4)``).

On a :class:`~repro_torch.launch.mesh.ProcessMesh` with a ``"shard"``
axis, shard ``i`` lives on the rank of index ``i``, every rank plans the
same (the scoring is deterministic) and keeps only its own shard, packed
for its kernel (the CSR row-tile kernel for the CSR family and ELL, the
BCSR kernel, the banded kernel, on the rank's device), and the
collectives are ``core.comm``'s, as the reference's ``shard_map``
closures run them: ``replicate`` broadcasts B from shard 0,
``all_gather`` gathers B's row slices, ``reduce_scatter`` runs
``psum_scatter`` on the full-height partials (fp32), and the DIA bands
are summed by ``psum`` (``replicate``) or ``psum_scatter``.  A kernel
whose operand must be square sees the shard as an ``[n, n]`` matrix (a
row block's rows first, a column block's B slice padded to ``n`` rows)
and the rows past the shard's are dropped.  ``execute`` returns this
rank's block of C (rows ``c_rows``; all of C for a DIA ``replicate``)
and :meth:`ShardedPlan.gather_c` assembles the whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sparsity_models as sm
from repro_torch.core.patterns import COOMatrix
from repro_torch.core.precision import Precision, as_precision
from repro_torch.core.roofline import ShardRoofline, collective_time
from repro_torch.launch.mesh import SHARD_AXIS, ProcessMesh, ShardMesh
from repro_torch.sparse import formats as fmt
from repro_torch.sparse import stream as _stream

#: The B-distribution strategies the sharded dispatcher scores.
B_STRATEGIES: Tuple[str, ...] = ("replicate", "all_gather", "reduce_scatter")

__all__ = ["B_STRATEGIES", "SHARD_AXIS", "ShardStrategyEval", "ShardedPlan"]


@dataclasses.dataclass(frozen=True)
class ShardStrategyEval:
    """One B-distribution strategy's audit record inside a ShardedPlan:
    its prediction, or the reason it was skipped."""

    strategy: str                     # one of B_STRATEGIES
    partition: str                    # "row-block" | "column-block" | "diagonal-band"
    eligible: bool
    skip_reason: Optional[str]        # None when eligible
    roofline: Optional[ShardRoofline]  # per-shard AI + collective cost

    @property
    def predicted_gflops(self) -> Optional[float]:
        """Whole-matrix useful GFLOP/s the cost model predicts."""
        if self.roofline is None:
            return None
        return self.roofline.predicted_flops_per_s / 1e9


def _pick_strategy(evals, requested: str) -> str:
    """Resolve the winning strategy ("auto" = best predicted GFLOP/s)."""
    if requested != "auto":
        ev = next(e for e in evals if e.strategy == requested)
        if not ev.eligible:
            raise ValueError(
                f"b_strategy {requested!r} is ineligible for this plan: "
                f"{ev.skip_reason}")
        return requested
    viable = [e for e in evals if e.eligible and e.roofline is not None]
    return max(viable, key=lambda e: e.roofline.predicted_flops_per_s
               ).strategy


#: One shard's replay: its device, its layout (None: the shard holds no
#: nonzero) and the rows of its output kept (None: all of them).
_Shard = Tuple[torch.device, Optional[object], Optional[int]]


class ShardedPlan(_stream.StreamPlan):
    """A StreamPlan whose replay runs shard by shard over a device mesh.

    Construction extends the single-device pipeline: partition the chosen
    format's operand per structure, score the three B-distribution
    strategies with the communication-aware roofline, and pack one layout
    per shard for the winner.  The inherited ``execute`` /
    ``execute_many`` / ``execute_wide`` then replay the shards.

    Attributes:
        mesh: the :class:`~repro_torch.launch.mesh.ShardMesh`.
        num_shards: mesh size D.
        b_strategy: the chosen B-distribution strategy.
        partition: the chosen strategy's partitioning scheme.
        strategy_evals: per-strategy audit records.
        shard_bounds: the partition's cut points (rows, columns or
            diagonals).
        shard_nnz: nonzeros per shard under the chosen partition.
        shard_layouts: each shard's ``torch``-backend layout on its device
            (None for a shard that holds no nonzero); on a process mesh,
            this rank's shard packed for its kernel.
        c_rows: on a process mesh, the rows of C this rank's ``execute``
            returns.
        c_bounds: on a process mesh, the row bounds of every rank's block
            of C (None where every rank holds all of C).
    """

    def __init__(self, dispatcher, m: COOMatrix, spec, mesh, *,
                 strategy: str = "auto", b_strategy: str = "auto"):
        """Plan, score strategies, and pack the shards.

        Args:
            dispatcher: the :class:`~repro_torch.sparse.dispatch.Dispatcher`
                owning caches, device and hardware model; C is assembled
                on its device, where operands must live.
            m: square sparse pattern, ``[n, n]``.
            spec: the stream description (``BSpec``).
            mesh: a :class:`~repro_torch.launch.mesh.ShardMesh`.
            strategy: ``"auto"`` or a forced *format* name.
            b_strategy: ``"auto"`` or a forced B-distribution strategy
                from ``B_STRATEGIES``.

        Raises:
            ValueError: on an unknown or ineligible ``b_strategy``.
        """
        if b_strategy not in ("auto",) + B_STRATEGIES:
            raise ValueError(f"unknown b_strategy {b_strategy!r}; choose "
                             f"from {('auto',) + B_STRATEGIES}")
        if isinstance(mesh, ProcessMesh):
            if SHARD_AXIS not in mesh.shape:
                raise ValueError(f"a process mesh for the sharded tier "
                                 f"needs a {SHARD_AXIS!r} axis, not "
                                 f"{mesh.axis_names}")
            self.mesh = mesh
            self.num_shards = mesh.shape[SHARD_AXIS]
        else:
            self.mesh = ShardMesh(mesh.devices)
            self.num_shards = self.mesh.size
        self.c_rows: Optional[Tuple[int, int]] = None
        self.c_bounds: Optional[List[int]] = None
        self._b_strategy_req = b_strategy
        super().__init__(dispatcher, m, spec, strategy=strategy)

    def _exec_precision(self) -> Precision:
        """The precision the per-shard kernels pack and run at: the plan's
        values, int32 indices (the ``torch`` containers keep int32
        indices), so a ``bf16i16`` plan runs its shards at ``bf16i32``."""
        prec = as_precision(self.dispatch.precision)
        if prec.index_dtype != "int32":
            prec = Precision(prec.value_dtype, "int32")
        return prec

    # ------------------------------------------------------------- #
    # Planning: strategy scoring
    # ------------------------------------------------------------- #

    def _bind(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Score the B-strategies and pack the winner's shards."""
        disp, m, plan = self._dispatcher, self._m, self.dispatch
        fmt_name, d, n, nnz = plan.chosen, plan.d, m.n, max(m.nnz, 1)
        D = self.num_shards
        hw = disp._resolve_hardware(plan.backend)
        prec = self._exec_precision()
        sv = prec.sizeof_val
        cand = plan.candidate(fmt_name)
        ceiling = disp._ceiling(fmt_name, hw, plan.backend,
                                plan.precision).attainable(
            hw.peak_flops, cand.useful_fraction or 1.0, d)
        flops = sm.flops_spmm(nnz, d)
        S = float(n * d * sv)                 # one full B or C buffer

        if fmt_name == "dia":
            dia = disp.convert(m, "dia", precision=prec)
            diag_nnz = torch.count_nonzero(dia.data, dim=1).cpu().numpy()
            band_bounds = fmt.nnz_balanced_splits(diag_nnz, D)
            full_tb = sm.TrafficBreakdown(
                flops=flops, bytes_a=dia.num_offsets * n * sv,
                bytes_b=S, bytes_c=S, model="diagonal")
            partitions = {
                "replicate": ("diagonal-band", band_bounds, diag_nnz),
                "reduce_scatter": ("diagonal-band", band_bounds, diag_nnz),
            }
            comm = {"replicate": (S + 2 * (D - 1) / D * S, 2),
                    "reduce_scatter": (S + 2 * (D - 1) / D * S, 3)}
            skip = {"all_gather": (
                "diagonal-band shards read essentially every row of B; "
                "all-gathering a row shard reconstructs the replicate "
                "broadcast with extra latency")}
        else:
            align = disp.bcsr_block if fmt_name == "bcsr" else 1
            row_nnz = np.bincount(m.rows, minlength=n)
            col_nnz = np.bincount(m.cols, minlength=n)
            row_bounds = fmt.nnz_balanced_splits(row_nnz, D, align=align)
            col_bounds = fmt.nnz_balanced_splits(col_nnz, D, align=align)
            bytes_c = S
            total_bytes = flops / cand.ai if cand.ai else bytes_c
            full_tb = sm.TrafficBreakdown(
                flops=flops, bytes_a=max(total_bytes - bytes_c, 0.0),
                bytes_b=0.0, bytes_c=bytes_c, model=plan.regime)
            partitions = {
                "replicate": ("row-block", row_bounds, row_nnz),
                "all_gather": ("row-block", row_bounds, row_nnz),
                "reduce_scatter": ("column-block", col_bounds, col_nnz),
            }
            comm = {"replicate": (S + (D - 1) / D * S, 2),
                    "all_gather": (2 * (D - 1) / D * S, 2),
                    "reduce_scatter": (S / D + 2 * (D - 1) / D * S, 3)}
            skip = {}

        evals = []
        for name in B_STRATEGIES:
            if name in skip:
                evals.append(ShardStrategyEval(
                    strategy=name, partition="-", eligible=False,
                    skip_reason=skip[name], roofline=None))
                continue
            part, bounds, weights = partitions[name]
            shard_nnz = np.add.reduceat(
                weights, bounds[:-1])[:D] if weights.size else np.zeros(D)
            # Guard reduceat's empty-slice quirk (repeated bounds repeat
            # the next value instead of 0).
            shard_nnz = np.where(np.diff(bounds) > 0, shard_nnz, 0)
            worst = ai_crit = fl_crit = 0.0
            for i in range(D):
                frac = shard_nnz[i] / nnz
                if frac <= 0:
                    continue
                rows_frac = ((bounds[i + 1] - bounds[i]) / n
                             if part == "row-block" else 1.0)
                tb_i = sm.shard_traffic(
                    full_tb, nnz_fraction=frac, rows_fraction=rows_frac,
                    bytes_b=S if part == "diagonal-band" else None)
                pred_i = min(hw.hbm_bandwidth * tb_i.ai, ceiling)
                t_i = tb_i.flops / pred_i if pred_i > 0 else 0.0
                if t_i >= worst:
                    worst, ai_crit, fl_crit = t_i, tb_i.ai, tb_i.flops
            bytes_wire, n_coll = comm[name]
            roof = ShardRoofline(
                strategy=name, devices=D, shard_ai=ai_crit,
                critical_flops=fl_crit, total_flops=flops,
                compute_s=worst,
                collective_s=collective_time(bytes_wire, hw, D,
                                             collectives=n_coll),
                collective_bytes=bytes_wire if D > 1 else 0.0)
            evals.append(ShardStrategyEval(
                strategy=name, partition=part, eligible=True,
                skip_reason=None, roofline=roof))

        self.strategy_evals = tuple(evals)
        self.b_strategy = _pick_strategy(evals, self._b_strategy_req)
        chosen_ev = next(e for e in evals if e.strategy == self.b_strategy)
        self.partition = chosen_ev.partition
        part, bounds, weights = (partitions[self.b_strategy]
                                 if self.b_strategy in partitions else
                                 partitions["replicate"])
        self.shard_bounds = np.asarray(bounds)
        counts = np.add.reduceat(weights, bounds[:-1])[:D] \
            if weights.size else np.zeros(D, dtype=np.int64)
        self.shard_nnz = np.where(np.diff(bounds) > 0, counts, 0)
        return self._build_executor(fmt_name, bounds)

    # ------------------------------------------------------------- #
    # Execution: per-shard layouts and explicit collectives
    # ------------------------------------------------------------- #

    def _kernel_ctx(self):
        """KernelContext for the per-shard ``torch``-backend runs."""
        from repro_torch.kernels import registry
        disp, plan = self._dispatcher, self.dispatch
        return registry.KernelContext(
            hardware=disp._resolve_hardware(plan.backend),
            bcsr_block=disp.bcsr_block,
            max_dia_offsets=disp.max_dia_offsets,
            plan_d=plan.d, precision=self._exec_precision())

    def _build_executor(self, fmt_name: str, bounds: np.ndarray):
        """Pack per-shard layouts and return the strategy's executor.

        Every shard runs the *torch*-backend KernelSpec (the reference's
        ``jax`` backend) on its own layout, whichever backend the
        single-device plan resolved; per-shard hand-written kernels are a
        follow-up, as the reference's per-shard Pallas packings are.
        """
        if fmt_name in ("binned", "rowsplit", "ell_coo"):
            # CSR-equivalent gather layouts (the scale-free tier): their
            # host-side orderings are whole-matrix properties that do not
            # survive row/column slicing, so the shards reuse the CSR
            # packing and the CSR implementation.
            fmt_name = "csr"
        if isinstance(self.mesh, ProcessMesh):
            return self._bind_ranked(fmt_name, bounds)
        if fmt_name == "dia":
            return self._bind_dia(bounds)
        if self.b_strategy == "reduce_scatter":
            return self._bind_cols(fmt_name, bounds)
        return self._bind_rows(fmt_name, bounds)

    def _out_dtype(self, b: torch.Tensor) -> torch.dtype:
        """The dtype every shard's output comes back in for operand ``b``
        (the torch specs cast a reduced plan's B to its value dtype)."""
        prec = self._exec_precision()
        return prec.value_torch if prec.reduced else b.dtype

    def _run_shards(self, shards: List[_Shard],
                    operand: Callable[[int, torch.device], torch.Tensor]
                    ) -> List[Optional[torch.Tensor]]:
        """Each shard's output (None for a shard without a layout), with
        ``operand(i, device)`` giving shard ``i``'s B on its device."""
        from repro_torch.kernels import registry
        spec = registry.get(self._shard_format, "torch")
        ctx = self._kernel_ctx()
        outs = []
        for i, (dev, layout, keep) in enumerate(shards):
            if layout is None:
                outs.append(None)
                continue
            out = spec.run(layout, operand(i, dev), ctx)
            outs.append(out if keep is None else out[:keep])
        return outs

    @staticmethod
    def _row_shard(a, fmt_name: str, r0: int, r1: int, n: int):
        """Rows ``[r0, r1)`` of layout ``a`` as a shard's layout, rows
        localized, columns global; and the rows of its output kept (None:
        all)."""
        if fmt_name == "csr":
            ptr = a.indptr[r0:r1 + 1]
            lo, hi = (int(x) for x in ptr[[0, -1]].cpu())
            return fmt.CSRMatrix(
                data=a.data[lo:hi], indices=a.indices[lo:hi],
                indptr=ptr - lo, row_ids=a.row_ids[lo:hi] - r0,
                n=r1 - r0), None
        if fmt_name == "ell":
            return fmt.ELLMatrix(data=a.data[r0:r1],
                                 indices=a.indices[r0:r1], n=r1 - r0), None
        # bcsr: n stays global: the implementation tiles B by n // t and B
        # is the full [n, d] operand.  Localized block rows land the
        # shard's output in rows [0, r1 - r0).
        t = a.t
        ptr = a.block_ptr[r0 // t:r1 // t + 1]
        lo, hi = (int(x) for x in ptr[[0, -1]].cpu())
        return fmt.BCSRMatrix(
            blocks=a.blocks[lo:hi], block_rows=a.block_rows[lo:hi]
            - r0 // t, block_cols=a.block_cols[lo:hi],
            block_ptr=ptr - lo, n=n, t=t, nnz=a.nnz), r1 - r0

    @staticmethod
    def _col_shard(a, fmt_name: str, c0: int, c1: int, n: int):
        """The nonzeros of columns ``[c0, c1)`` of CSR or BCSR layout ``a``
        as a full-height shard layout, columns localized; None when it
        holds none."""
        if fmt_name == "csr":
            sel = (a.indices >= c0) & (a.indices < c1)
            rows = a.row_ids[sel]
            counts = torch.bincount(rows.long(), minlength=n)
            indptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
            local = fmt.CSRMatrix(
                data=a.data[sel], indices=a.indices[sel] - c0,
                indptr=indptr.to(torch.int32), row_ids=rows, n=n)
            return local if local.nnz > 0 else None
        t = a.t
        s0, s1 = c0 // t, c1 // t
        sel = (a.block_cols >= s0) & (a.block_cols < s1)
        brows = a.block_rows[sel]
        counts = torch.bincount(brows.long(), minlength=n // t)
        ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        local = fmt.BCSRMatrix(
            blocks=a.blocks[sel], block_rows=brows,
            block_cols=a.block_cols[sel] - s0,
            block_ptr=ptr.to(torch.int32), n=n, t=t, nnz=a.nnz)
        return local if local.num_blocks > 0 else None

    def _bind_rows(self, fmt_name: str, bounds: np.ndarray):
        """Row-block execution: replicate-B or all-gather-B."""
        disp, m = self._dispatcher, self._m
        devs, D, n = self.mesh.devices, self.num_shards, self._m.n
        prec = self._exec_precision()
        a = disp.convert(m, fmt_name, precision=prec)
        shards: List[_Shard] = []
        for i in range(D):
            local, keep = self._row_shard(a, fmt_name, int(bounds[i]),
                                          int(bounds[i + 1]), n)
            shards.append((devs[i], local.to(devs[i]), keep))
        self._shard_format = fmt_name
        self.shard_layouts = tuple(s[1] for s in shards)
        Rb = -(-n // D)

        if self.b_strategy == "replicate":
            def run(b):
                outs = self._run_shards(shards, lambda i, dev: b.to(dev))
                return torch.cat([o.to(b.device) for o in outs])
        else:                                   # all_gather
            def run(b):
                # Shard j holds rows [j * Rb, (j + 1) * Rb) of B; each
                # shard gathers every slice onto its own device.
                held = [b[j * Rb:(j + 1) * Rb].to(devs[j]) for j in range(D)]
                outs = self._run_shards(
                    shards, lambda i, dev: torch.cat([h.to(dev)
                                                      for h in held]))
                return torch.cat([o.to(b.device) for o in outs])
        return run

    def _bind_cols(self, fmt_name: str, bounds: np.ndarray):
        """Column-block execution: reduce-scatter-output.

        Each shard owns the nonzeros whose *columns* fall in its slice,
        consumes only those rows of B, and produces a full-height partial
        C; the partials are then summed into each owner's row block.
        """
        disp, m = self._dispatcher, self._m
        devs, D, n = self.mesh.devices, self.num_shards, self._m.n
        prec = self._exec_precision()
        vdt = prec.value_torch
        shards: List[_Shard] = []
        if fmt_name == "ell":
            for i in range(D):
                c0, c1 = int(bounds[i]), int(bounds[i + 1])
                sel = (m.cols >= c0) & (m.cols < c1)
                if not sel.any():
                    shards.append((devs[i], None, None))
                    continue
                lm = COOMatrix(n=n, rows=m.rows[sel],
                               cols=(m.cols[sel] - c0).astype(np.int32),
                               vals=m.vals[sel], pattern=m.pattern)
                shards.append((devs[i], fmt.coo_to_ell(lm, dtype=vdt,
                                                       device=devs[i]),
                               None))
        else:                                   # csr, bcsr
            a = disp.convert(m, fmt_name, precision=prec)
            for i in range(D):
                local = self._col_shard(a, fmt_name, int(bounds[i]),
                                        int(bounds[i + 1]), n)
                shards.append((devs[i], None if local is None else
                               local.to(devs[i]), None))
        self._shard_format = fmt_name
        self.shard_layouts = tuple(s[1] for s in shards)
        lo_hi = [(int(bounds[i]), int(bounds[i + 1])) for i in range(D)]

        def operand(i, dev, b):
            c0, c1 = lo_hi[i]
            part = b[c0:c1].to(dev)
            if fmt_name != "bcsr":
                return part
            # The implementation tiles B by n // t, so the local slice is
            # padded to full height; the zero tail multiplies nothing.
            full = part.new_zeros((n, b.shape[1]))
            full[:c1 - c0] = part
            return full

        def run(b):
            partials = self._run_shards(shards,
                                        lambda i, dev: operand(i, dev, b))
            return self._reduce_scatter(partials, b)
        return run

    def _bind_dia(self, bounds: np.ndarray):
        """Diagonal-band execution: each shard runs its run of diagonals
        and yields a full-height partial C, summed on the plan's device
        (``replicate``) or into each owner's row block
        (``reduce_scatter``)."""
        disp, m = self._dispatcher, self._m
        devs, D = self.mesh.devices, self.num_shards
        dia = disp.convert(m, "dia", precision=self._exec_precision())
        shards: List[_Shard] = []
        for i in range(D):
            k0, k1 = int(bounds[i]), int(bounds[i + 1])
            local = fmt.DIAMatrix(data=dia.data[k0:k1],
                                  offsets=dia.offsets[k0:k1], n=dia.n)
            shards.append((devs[i], local.to(devs[i]) if k1 > k0 else None,
                           None))
        self._shard_format = "dia"
        self.shard_layouts = tuple(s[1] for s in shards)

        if self.b_strategy == "replicate":
            def run(b):
                partials = self._run_shards(shards,
                                            lambda i, dev: b.to(dev))
                acc = torch.zeros((self.n, b.shape[1]), dtype=torch.float32,
                                  device=b.device)
                for p in partials:
                    if p is not None:
                        acc += p.to(b.device, torch.float32)
                return acc.to(self._out_dtype(b))
        else:                                   # reduce_scatter
            def run(b):
                partials = self._run_shards(shards,
                                            lambda i, dev: b.to(dev))
                return self._reduce_scatter(partials, b)
        return run

    # ------------------------------------------------------------- #
    # Execution on a process mesh: one shard per rank, on its kernel.
    # ------------------------------------------------------------- #

    def _kernel_operand(self, fmt_name: str, local, dev):
        """``(layout, wrapper)``: shard layout ``local`` packed for its
        kernel on ``dev``, as the ``cuda`` specs pack a whole matrix (a
        CSR shard as row tiles over ``n`` rows, a BCSR shard with its
        empty block rows padded and its quadrant mask, a shard of
        diagonals as the banded kernel's layout, its DIA storage as it
        is)."""
        from repro_torch.kernels import (banded_spmm, bcsr_spmm, csr_spmm,
                                         pad_empty_block_rows)
        n = self.n
        if fmt_name == "dia":
            return banded_spmm.dia_layout(
                fmt.to_device(local.data, dev), local.offsets), \
                banded_spmm.banded_spmm
        if fmt_name == "bcsr":
            return bcsr_spmm.with_quadrants(pad_empty_block_rows(
                local.to(dev))), bcsr_spmm.bcsr_spmm
        ctx = self._kernel_ctx()
        indptr = local.indptr.cpu().numpy().astype(np.int64)
        indptr = np.concatenate(
            [indptr, np.full(n - local.n, indptr[-1])])
        bt = ctx.resolve_b_tile(n)
        arrays = csr_spmm.csr_to_row_tiles(
            indptr, local.indices.cpu().numpy(),
            fmt.host_values(local.data), n=n, row_tile=ctx.row_tile,
            chunk=ctx.chunk, b_tile=bt, index_dtype=np.int32)
        return csr_spmm.row_tile_layout(*arrays, n=n, b_tile=bt,
                                        row_tile=ctx.row_tile,
                                        device=dev), csr_spmm.csr_spmm

    def _bind_ranked(self, fmt_name: str, bounds: np.ndarray):
        """This rank's shard and the strategy's collectives (``core.comm``
        on the mesh's ``"shard"`` axis)."""
        from repro_torch.core import comm
        disp, m, mesh = self._dispatcher, self._m, self.mesh
        D, n, dev = self.num_shards, self._m.n, mesh.device
        me = mesh.axis_index(SHARD_AXIS)
        prec = self._exec_precision()
        lo, hi = int(bounds[me]), int(bounds[me + 1])
        if fmt_name == "ell":
            fmt_name = "csr"        # the CSR kernel carries ELL, as in cuda
        a = disp.convert(m, fmt_name, precision=prec)
        keep = None
        if fmt_name == "dia":
            local = fmt.DIAMatrix(data=a.data[lo:hi],
                                  offsets=a.offsets[lo:hi], n=a.n) \
                if hi > lo else None
        elif self.b_strategy == "reduce_scatter":
            local = self._col_shard(a, fmt_name, lo, hi, n)
        else:
            local, _ = self._row_shard(a, fmt_name, lo, hi, n)
            keep = hi - lo
        layout, kernel = (None, None) if local is None else \
            self._kernel_operand(fmt_name, local, dev)
        self._shard_format = fmt_name
        self.shard_layouts = (layout,)
        Rb = -(-n // D)
        replicated = fmt_name == "dia" and self.b_strategy == "replicate"
        if self.b_strategy == "reduce_scatter":
            self.c_bounds = [min(j * Rb, n) for j in range(D + 1)]
        elif replicated:
            self.c_bounds = None
        else:
            self.c_bounds = [int(x) for x in bounds]
        self.c_rows = (0, n) if replicated else \
            (self.c_bounds[me], self.c_bounds[me + 1])

        def partial(b_op: torch.Tensor) -> torch.Tensor:
            b_op = b_op.to(prec.value_torch) if prec.reduced else b_op
            if layout is None:
                return b_op.new_zeros((n if keep is None else keep,
                                       b_op.shape[1]))
            out = kernel(layout, b_op.contiguous())
            return out if keep is None else out[:keep]

        def run(b: torch.Tensor) -> torch.Tensor:
            out_dtype = self._out_dtype(b)
            if self.b_strategy == "reduce_scatter" and fmt_name != "dia":
                # This rank's rows of B, padded to the kernel's n rows.
                b_op = b.new_zeros((n, b.shape[1]))
                b_op[:hi - lo] = b[lo:hi]
            elif self.b_strategy == "all_gather":
                piece = b.new_zeros((Rb, b.shape[1]))
                rows = b[me * Rb:(me + 1) * Rb]
                piece[:rows.shape[0]] = rows
                b_op = comm.all_gather(piece, SHARD_AXIS, dim=0, tiled=True,
                                       mesh=mesh)[:n]
            else:
                b_op = comm.broadcast(b, SHARD_AXIS, 0, mesh=mesh)
            part = partial(b_op)
            if self.b_strategy != "reduce_scatter" and not replicated:
                return part.to(out_dtype)
            part = part.to(torch.float32)
            if replicated:
                return comm.psum(part, SHARD_AXIS, mesh=mesh).to(out_dtype)
            part = torch.cat([part, part.new_zeros((D * Rb - n,
                                                    part.shape[1]))])
            block = comm.psum_scatter(part, SHARD_AXIS, scatter_dimension=0,
                                      tiled=True, mesh=mesh)
            return block[:self.c_rows[1] - self.c_rows[0]].to(out_dtype)
        return run

    def gather_c(self, c_block: torch.Tensor) -> torch.Tensor:
        """The whole C on every rank from each rank's :meth:`execute`
        block (process meshes; an all-gather over ``"shard"``)."""
        from repro_torch.core import comm
        if not isinstance(self.mesh, ProcessMesh):
            raise ValueError("gather_c assembles a process mesh's blocks")
        if self.c_bounds is None:
            return c_block
        sizes = np.diff(self.c_bounds)
        R = int(max(sizes.max(), 1))
        pad = c_block.new_zeros((R, c_block.shape[1]))
        pad[:c_block.shape[0]] = c_block
        full = comm.all_gather(pad, SHARD_AXIS, dim=0, tiled=False,
                               mesh=self.mesh)
        return torch.cat([full[j, :sizes[j]] for j in range(len(sizes))])

    def _reduce_scatter(self, partials: List[Optional[torch.Tensor]],
                        b: torch.Tensor) -> torch.Tensor:
        """Sum full-height partial C's into each owner's row block.

        Shard ``j`` owns rows ``[j * R, (j + 1) * R)`` with ``R =
        ceil(n / D)``; it sums every partial's rows there in fp32, in shard
        order, and casts once.  The blocks come back to ``b``'s device in
        row order.
        """
        n, d = self.n, b.shape[1]
        R = -(-n // self.num_shards)
        blocks = []
        for j, dev in enumerate(self.mesh.devices):
            lo, hi = min(j * R, n), min((j + 1) * R, n)
            acc = torch.zeros((hi - lo, d), dtype=torch.float32, device=dev)
            for p in partials:
                if p is not None:
                    acc += p[lo:hi].to(dev, torch.float32)
            blocks.append(acc.to(self._out_dtype(b)).to(b.device))
        return torch.cat(blocks)

    # ------------------------------------------------------------- #
    # Introspection
    # ------------------------------------------------------------- #

    def summary(self) -> str:
        """The format decision table plus the B-strategy audit."""
        single = self.dispatch.candidate(self.chosen).predicted_gflops
        nz = self.shard_nnz[self.shard_nnz > 0]
        imbalance = float(nz.max() / nz.mean()) if nz.size else 1.0
        lines = [self.dispatch.summary(),
                 f"ShardedPlan(devices={self.num_shards}, "
                 f"partition={self.partition}, "
                 f"nnz_imbalance={imbalance:.2f}) -> {self.b_strategy}"]
        for ev in self.strategy_evals:
            mark = "*" if ev.strategy == self.b_strategy else " "
            if ev.roofline is not None:
                r = ev.roofline
                perf = (f"comm={r.collective_bytes / 1e6:7.2f}MB"
                        f"  t_comp={r.compute_s * 1e6:9.1f}us"
                        f"  t_coll={r.collective_s * 1e6:9.1f}us"
                        f"  pred={r.predicted_flops_per_s / 1e9:7.2f} GF/s"
                        f" [{r.dominant}-bound]")
            else:
                perf = "(not modeled)"
            tail = "" if ev.eligible else f"  SKIP: {ev.skip_reason}"
            lines.append(f" {mark} {ev.strategy:14s} {perf}{tail}")
        best = next(e for e in self.strategy_evals
                    if e.strategy == self.b_strategy)
        if single and best.predicted_gflops is not None:
            lines.append(f"   model speedup vs single device: "
                         f"{best.predicted_gflops / single:.2f}x")
        return "\n".join(lines)

    def stats(self) -> dict:
        """StreamPlan stats extended with the sharded decision record."""
        out = super().stats()
        out.update({
            "devices": self.num_shards,
            "b_strategy": self.b_strategy,
            "partition": self.partition,
            # Shards run the torch backend (int32 indices), so a bf16i16
            # plan executes its shards at bf16i32.
            "shard_precision": self._exec_precision().token,
            "shard_nnz": [int(x) for x in self.shard_nnz],
        })
        return out

    def exec_hints(self) -> dict:
        """Engine staging metadata for sharded replay.

        The per-shard ``torch`` runs enqueue on the card and return, so
        dispatch is asynchronous there; the operand is re-laid-out per
        strategy (copied, gathered or sliced), so the staged buffer is
        never donated.  The ``torch`` spec that runs inside each shard is
        the one consulted, whichever backend the single-device plan
        resolved.
        """
        from repro_torch.kernels import registry
        spec = registry.get(self.dispatch.chosen, "torch")
        return {"async_dispatch": spec.async_dispatch, "donate_b": False,
                "devices": self.num_shards}

    def coalesce_block_d(self, total_cols: int) -> int:
        """Coalesced replay width for the engine: always the planned d,
        as in the reference (whose sharded program compiles per width)."""
        return self.spec.d

    def replan(self, observed_reuse: int) -> "ShardedPlan":
        """Re-plan at an observed horizon, keeping the mesh (see
        ``StreamPlan.replan``)."""
        if observed_reuse < 1:
            raise ValueError(
                f"observed_reuse must be >= 1, got {observed_reuse}")
        spec = dataclasses.replace(self.spec, reuse=observed_reuse)
        return ShardedPlan(self._dispatcher, self._m, spec, self.mesh,
                           strategy=self._strategy,
                           b_strategy=self._b_strategy_req)
