"""Structure-aware SpMM dispatch: the paper's thesis as runtime architecture.

No single roofline model predicts SpMM across sparsity structures, so the
storage format (and kernel) is chosen per matrix structure:

    disp = Dispatcher()                      # the card (device="cuda")
    plan = disp.plan(m, d)                   # inspectable decision record
    c = disp.spmm(m, b)                      # classify -> model -> convert -> run

For each candidate format the dispatcher

  1. applies the *applicability policy* (SpChar-style structural gates),
     recording a skip reason when a format is rejected;
  2. evaluates the candidate's sparsity-aware arithmetic intensity on the
     active HardwareSpec: B traffic from the detected structural regime
     (the paper's Section III models), A traffic from the format's storage;
  3. caps the bandwidth roofline ``beta * AI`` with a format compute
     ceiling ``peak * efficiency * useful_fraction``;
  4. amortizes the one-time format conversion over an expected reuse
     count.

The decision logic is the reference package's, unchanged.  What differs:
backends are ``"torch"`` and ``"cuda"``; ``backend="auto"`` resolves to
``"cuda"`` on a CUDA device and ``"torch"`` otherwise; and the dispatcher
runs on the card unless constructed with ``device="cpu"``.

Conversion-cost caveat: conversion time is modeled as streaming the built
format at ``beta`` (read + write); the host-side converters are not that
fast, so treat amortized numbers as a lower bound on the break-even reuse.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.calibrate import CalibrationStore
from repro_torch.core.classify import StructureReport, block_stats, classify
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.hardware import HOST_CPU, HardwareSpec, h100_from_device
from repro_torch.core.precision import (DEFAULT_PRECISION, INT16_MAX_EXTENT,
                                        PRECISIONS, Precision, as_precision)
from repro_torch.core.roofline import ComputeCeiling
from repro_torch.core import sparsity_models as sm
from repro_torch.core import trace
from repro_torch.core.patterns import COOMatrix
from repro_torch.data.dtree import (DecisionTree, DispatchTreeStore,
                                    features_from_report)
from repro_torch.sparse import formats as fmt

FORMATS: Tuple[str, ...] = ("csr", "ell", "bcsr", "dia",
                            "binned", "rowsplit", "ell_coo")
STRATEGIES: Tuple[str, ...] = ("auto",) + FORMATS

#: Per-format compute ceiling: ``(peak_fraction, d_half)``.  Each
#: implementation sustains ``peak * peak_fraction * d / (d + d_half)`` on
#: its *issued* FLOPs.  These are the reference package's fallback
#: constants (``ceiling_source="default"``); a persisted calibration for
#: the active device and backend replaces them, and
#: ``Dispatcher(efficiency=...)`` overrides both.
DEFAULT_EFFICIENCY: Dict[str, Tuple[float, float]] = {
    "csr": (0.030, 112.0),
    "ell": (0.040, 8.0),
    "bcsr": (0.600, 28.0),
    "dia": (0.057, 3.0),
    "binned": (0.022, 112.0),
    "rowsplit": (0.027, 104.0),
    "ell_coo": (0.036, 40.0),
}


@dataclasses.dataclass(frozen=True)
class CandidateEval:
    """One (format, precision) audit record inside a DispatchPlan."""

    format: str
    eligible: bool
    skip_reason: Optional[str]        # None when eligible
    ai: Optional[float]               # sparsity-aware arithmetic intensity
    useful_fraction: Optional[float]  # useful FLOPs / issued FLOPs
    predicted_gflops: Optional[float]     # steady-state (no conversion)
    amortized_gflops: Optional[float]     # incl. conversion / reuse
    conversion_bytes: Optional[float]
    params: dict = dataclasses.field(default_factory=dict)
    #: Compute-ceiling provenance: "default" | "calibrated" | "override".
    ceiling_source: str = "default"
    #: Storage precision token this row was modeled at: "f32i32" |
    #: "bf16i32" | "bf16i16".
    precision: str = "f32i32"


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """The dispatcher's full, inspectable decision for one (matrix, d)."""

    chosen: str                       # winning format
    strategy: str                     # "auto" or the forced format
    regime: str                       # detected sparsity regime
    d: int
    reuse: int                        # conversion amortization horizon
    backend: str                      # "torch" | "cuda"
    hardware: str                     # HardwareSpec.name used for prediction
    candidates: Tuple[CandidateEval, ...]
    #: Winning storage precision (token).
    precision: str = "f32i32"
    #: The relative error budget the accuracy gate ran with.
    tolerance: float = 0.0
    #: Staleness warning from the CalibrationStore, or None.
    calibration_note: Optional[str] = None
    #: ``"analytic"`` (the roofline ranking) or ``"tree"`` (the fitted
    #: dispatch tree broke a near-tie).
    decision_source: str = "analytic"
    #: The tree's split trail when ``decision_source == "tree"``.
    decision_path: Tuple[str, ...] = ()

    @property
    def skips(self) -> Dict[str, str]:
        """format -> reason, for every policy-rejected candidate (keyed off
        the fp32 rows, which the precision gate never rejects)."""
        return {c.format: c.skip_reason for c in self.candidates
                if not c.eligible and c.precision == "f32i32"}

    @property
    def precision_skips(self) -> Dict[Tuple[str, str], str]:
        """(format, precision) -> reason for precision-gated rows."""
        return {(c.format, c.precision): c.skip_reason
                for c in self.candidates
                if not c.eligible and c.precision != "f32i32"
                and c.format not in self.skips}

    @property
    def ceiling_sources(self) -> Dict[str, str]:
        """format -> compute-ceiling provenance (default/calibrated/override)."""
        return {c.format: c.ceiling_source for c in self.candidates}

    def candidate(self, name: str,
                  precision: Optional[str] = None) -> CandidateEval:
        """Return the :class:`CandidateEval` for format ``name``.

        Args:
            name: one of ``FORMATS``.
            precision: a precision token to pick that exact row; ``None``
                returns the chosen row when ``name`` won, else the best
                eligible row, else the fp32 baseline.

        Raises:
            KeyError: if the pair was not evaluated in this plan.
        """
        if precision is not None:
            token = as_precision(precision).token
            for c in self.candidates:
                if c.format == name and c.precision == token:
                    return c
            raise KeyError((name, token))
        if name == self.chosen:
            return self.candidate(name, self.precision)
        rows = [c for c in self.candidates if c.format == name]
        if not rows:
            raise KeyError(name)
        eligible = [c for c in rows if c.eligible]
        if eligible:
            return max(eligible, key=lambda c: c.amortized_gflops or 0.0)
        return next(c for c in rows if c.precision == "f32i32")

    def summary(self) -> str:
        """Render the decision as a human-readable multi-line table."""
        lines = [f"DispatchPlan(regime={self.regime}, d={self.d}, "
                 f"backend={self.backend}, hw={self.hardware}, "
                 f"reuse={self.reuse}, tol={self.tolerance:.1e}, "
                 f"decision={self.decision_source})"
                 f" -> {self.chosen} @ {self.precision}"]
        for c in self.candidates:
            mark = "*" if (c.format == self.chosen
                           and c.precision == self.precision) else " "
            if c.predicted_gflops is not None:
                perf = (f"AI={c.ai:6.3f}  pred={c.predicted_gflops:7.2f}"
                        f"  amort={c.amortized_gflops:7.2f} GF/s"
                        f" [{c.ceiling_source}]")
            else:
                perf = "(not modeled)"
            tail = "" if c.eligible else f"  SKIP: {c.skip_reason}"
            lines.append(f" {mark} {c.format:8s} {c.precision:7s} "
                         f"{perf}{tail}")
        if self.decision_path:
            lines.append(" ~ tree: " + " -> ".join(self.decision_path))
        if self.calibration_note:
            lines.append(f" ! {self.calibration_note}")
        return "\n".join(lines)


def _degree_stats(m: COOMatrix) -> Tuple[float, int]:
    deg = np.bincount(m.rows, minlength=m.n)
    return float(deg.mean()), int(deg.max())


def _num_diagonals(m: COOMatrix) -> int:
    return int(fmt.diagonal_offsets(m).shape[0])


def _num_nonempty_rows(m: COOMatrix) -> int:
    return int(np.count_nonzero(np.bincount(m.rows, minlength=m.n)))


def _evict_cb(dispatcher_ref: "weakref.ref", key: int) -> None:
    """Finalizer body: must not hold the Dispatcher alive (weakref only)."""
    disp = dispatcher_ref()
    if disp is not None:
        disp._evict(key)


class Dispatcher:
    """Plans, caches, and executes structure-aware SpMM on one device.

    One instance owns two caches keyed by matrix identity (entries are
    evicted when the COOMatrix is garbage collected):

      * plan cache:        (matrix, d, strategy, knobs) -> DispatchPlan
      * conversion cache:  (matrix, format, t)          -> format container
    """

    def __init__(self, hardware: Optional[HardwareSpec] = None, *,
                 backend: str = "auto", device: DeviceLike = None,
                 reuse: int = 32,
                 bcsr_block: int = 64, max_dia_offsets: int = 64,
                 bcsr_max_inflation: float = 64.0,
                 efficiency: Optional[Dict[str, Tuple[float, float]]] = None,
                 calibration=None,
                 tree=None, tree_margin: float = 0.10,
                 sizeof_val: int = 4, sizeof_idx: int = 4,
                 tolerance: float = 0.0):
        """Configure a dispatcher.

        Args:
            hardware: the roofline's device description; None resolves to
                the H100 spec of the CUDA device, or ``HOST_CPU`` on the
                CPU.
            backend: ``"auto"`` (``"cuda"`` on a CUDA device, ``"torch"``
                otherwise), ``"torch"`` or ``"cuda"``.
            device: where layouts live and kernels run; None means the
                card (``"cuda"``), and raises when there is none — pass
                ``device="cpu"`` to run on the CPU.
            reuse, bcsr_block, max_dia_offsets, bcsr_max_inflation,
            efficiency, calibration, tree, tree_margin, sizeof_val,
            sizeof_idx, tolerance: as in the reference dispatcher.
        """
        if backend not in ("auto", "torch", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        if not 0.0 <= tree_margin < 1.0:
            raise ValueError(f"tree_margin must be in [0, 1), "
                             f"got {tree_margin}")
        if tolerance < 0.0:
            raise ValueError(f"tolerance must be >= 0, got {tolerance}")
        self.device = resolve_device(device)
        self.backend = backend
        self.hardware = hardware
        self.reuse = reuse
        self.bcsr_block = bcsr_block
        self.max_dia_offsets = max_dia_offsets
        self.bcsr_max_inflation = bcsr_max_inflation
        self.efficiency = dict(DEFAULT_EFFICIENCY, **(efficiency or {}))
        self._overridden = frozenset(efficiency or ())
        #: ``None`` = the default CalibrationStore (resolved lazily); a
        #: ``CalibrationStore`` to use explicitly; ``False`` disables it.
        self.calibration = calibration
        #: ``None`` = the persisted dispatch tree (resolved lazily); a
        #: ``DecisionTree`` to use explicitly; ``False`` disables it.
        self.tree = tree
        self.tree_margin = tree_margin
        self._cal_cache: Dict[tuple, Dict[str, Tuple[float, float]]] = {}
        self._note_cache: Dict[tuple, Optional[str]] = {}
        self._tree_cache: Dict[str, Optional[DecisionTree]] = {}
        self.sizeof_val = sizeof_val
        self.sizeof_idx = sizeof_idx
        self.tolerance = tolerance
        self._plans: Dict[tuple, DispatchPlan] = {}
        self._converted: Dict[tuple, object] = {}
        self._reports: Dict[int, StructureReport] = {}
        self._stats: Dict[tuple, object] = {}
        self._tracked: set = set()
        self._hw: Optional[HardwareSpec] = None

    # ----------------------------------------------------------------- #
    # Cache plumbing
    # ----------------------------------------------------------------- #

    def _track(self, m: COOMatrix) -> int:
        key = id(m)
        if key not in self._tracked:
            self._tracked.add(key)
            weakref.finalize(m, _evict_cb, weakref.ref(self), key)
        return key

    def _evict(self, key: int) -> None:
        self._tracked.discard(key)
        self._reports.pop(key, None)
        for cache in (self._plans, self._converted, self._stats):
            for k in [k for k in cache if k[0] == key]:
                cache.pop(k, None)

    def _report(self, m: COOMatrix) -> StructureReport:
        key = self._track(m)
        if key not in self._reports:
            with trace.span("spmm.plan.classify"):
                self._reports[key] = classify(m)
        return self._reports[key]

    def _stat(self, m: COOMatrix, name: str, fn):
        """Memoise one structural statistic of ``m`` (a pure function of
        the matrix, evaluated once however many rows need it)."""
        key = (self._track(m), name)
        if key not in self._stats:
            with trace.span("spmm.plan.stat", stat=str(name)):
                self._stats[key] = fn()
        return self._stats[key]

    def convert(self, m: COOMatrix, format: str, precision=None):
        """Convert (and cache) m into ``format``'s container on the device.

        ``precision`` sets the packed *value* dtype and is part of the
        cache key; containers keep int32 indices.
        """
        prec = as_precision(precision)
        key = (self._track(m), format, self.bcsr_block, prec.value_dtype)
        if key in self._converted:
            return self._converted[key]
        dtype, dev = prec.value_torch, self.device
        with trace.span("spmm.pack.convert", format=format):
            if format == "csr":
                out = fmt.coo_to_csr(m, dtype=dtype, device=dev)
            elif format == "ell":
                out = fmt.coo_to_ell(m, dtype=dtype, device=dev)
            elif format == "bcsr":
                out = fmt.coo_to_bcsr(m, self.bcsr_block, dtype=dtype,
                                      device=dev)
            elif format == "dia":
                out = fmt.coo_to_dia(m, dtype=dtype,
                                     max_offsets=self.max_dia_offsets,
                                     device=dev)
            elif format == "binned":
                out = fmt.coo_to_binned(m, dtype=dtype, device=dev)
            elif format == "rowsplit":
                out = fmt.coo_to_rowsplit(m, dtype=dtype, chunk=128,
                                          device=dev)
            elif format == "ell_coo":
                out = fmt.coo_to_ell_coo(m, dtype=dtype, device=dev)
            else:
                raise ValueError(f"unknown format {format!r}")
        self._converted[key] = out
        return out

    # ----------------------------------------------------------------- #
    # Modeling
    # ----------------------------------------------------------------- #

    def _calibrated(self, hw: HardwareSpec, backend: str,
                    precision: str = "f32i32"
                    ) -> Dict[str, Tuple[float, float]]:
        """The persisted calibration for ``(hw, backend)`` ({} if absent)."""
        if self.calibration is False:
            return {}
        key = (hw.fingerprint(), backend, precision)
        if key not in self._cal_cache:
            store = self.calibration or CalibrationStore()
            cal = store.load(hw, backend)
            self._cal_cache[key] = \
                cal.efficiency(precision=precision) if cal else {}
        return self._cal_cache[key]

    def _staleness(self, hw: HardwareSpec, backend: str) -> Optional[str]:
        """The CalibrationStore's staleness note for ``(hw, backend)``."""
        if self.calibration is False:
            return None
        key = (hw.fingerprint(), backend)
        if key not in self._note_cache:
            store = self.calibration or CalibrationStore()
            self._note_cache[key] = store.staleness_note(hw, backend)
        return self._note_cache[key]

    def refresh_calibration(self) -> None:
        """Drop cached calibration/tree lookups and plans."""
        self._cal_cache.clear()
        self._note_cache.clear()
        self._tree_cache.clear()
        self._plans.clear()

    def _tree(self, backend: str) -> Optional[DecisionTree]:
        """Resolve the dispatch tree for ``backend`` (None = no tree)."""
        if self.tree is False:
            return None
        if isinstance(self.tree, DecisionTree):
            return self.tree
        if backend not in self._tree_cache:
            self._tree_cache[backend] = DispatchTreeStore().load(backend)
        return self._tree_cache[backend]

    def _ceiling(self, format: str, hw: HardwareSpec, backend: str,
                 precision: str = "f32i32") -> ComputeCeiling:
        """Resolve the compute ceiling with provenance: override >
        calibrated > default."""
        if format in self._overridden:
            return ComputeCeiling(*self.efficiency[format],
                                  source="override")
        calibrated = self._calibrated(hw, backend, precision)
        if format in calibrated:
            return ComputeCeiling(*calibrated[format], source="calibrated")
        return ComputeCeiling(*self.efficiency[format], source="default")

    def _resolve_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        return "cuda" if self.device.type == "cuda" else "torch"

    def _resolve_hardware(self, backend: str) -> HardwareSpec:
        if self.hardware is not None:
            return self.hardware
        if self._hw is None:
            self._hw = (h100_from_device(self.device)
                        if self.device.type == "cuda" else HOST_CPU)
        return self._hw

    def _policy(self, m: COOMatrix, report: StructureReport,
                format: str) -> Tuple[bool, Optional[str], dict]:
        """Applicability gate + the structural params the model needs."""
        with trace.span("spmm.plan.policy", format=format):
            avg_deg, max_deg = self._stat(m, "degrees",
                                          lambda: _degree_stats(m))
            if format == "csr":
                return True, None, {}
            if format == "ell":
                k = max(max_deg, 1)
                params = {"k": k}
                if max_deg > max(64, 16 * max(avg_deg, 1)):
                    return False, (
                        f"ELL padding explodes: max_deg {max_deg} >> avg "
                        f"{avg_deg:.1f} (vendor kernels fall back to CSR here)"
                    ), params
                return True, None, params
            if format == "bcsr":
                t = self.bcsr_block
                if m.n % t != 0:
                    return False, (f"matrix dim {m.n} not divisible by BCSR "
                                   f"block {t}"), {}
                if report.stats.get("block_t") == t:
                    bstats = {k[len("block_"):]: v for k, v in
                              report.stats.items() if k.startswith("block_")}
                else:
                    bstats = self._stat(m, ("block_stats", t),
                                        lambda: block_stats(m, t))
                inflation = (t * t) / max(bstats["D"], 1e-9)
                params = {"t": t, "N": bstats["N"], "D": bstats["D"],
                          "z": bstats["z_emp"], "inflation": inflation}
                if inflation > self.bcsr_max_inflation:
                    return False, (
                        f"dense-block inflation {inflation:.0f}x exceeds "
                        f"{self.bcsr_max_inflation:.0f}x (ai_blocked_tpu "
                        f"predicts mxu_util {1 / inflation:.3f})"), params
                return True, None, params
            if format == "dia":
                k = self._stat(m, "diagonals", lambda: _num_diagonals(m))
                params = {"num_offsets": k}
                if k > self.max_dia_offsets:
                    return False, (
                        f"{k} distinct diagonals exceed "
                        f"{self.max_dia_offsets}; DIA only suits banded "
                        f"matrices"), params
                return True, None, params
            if format in ("binned", "rowsplit"):
                return True, None, {}
            if format == "ell_coo":
                deg = np.bincount(m.rows, minlength=m.n)
                k_cut = fmt.ell_coo_cutoff(deg)
                tail = int(np.clip(deg - k_cut, 0, None).sum())
                return True, None, {"k_cut": k_cut, "tail_nnz": tail}
            raise ValueError(f"unknown format {format!r}")

    def _model(self, m: COOMatrix, report: StructureReport, format: str,
               params: dict, d: int, hw: HardwareSpec, reuse: int,
               backend: str, prec: Precision = DEFAULT_PRECISION
               ) -> Tuple[float, float, float, float, float, str]:
        """(ai, useful_fraction, predicted, amortized, conv_bytes, source).

        The B-traffic term comes from the detected regime's model, the
        A-traffic term from the format's storage; every byte term is sized
        by ``prec``'s element widths.
        """
        sv, si = prec.sizeof_val, prec.sizeof_idx
        n, nnz = m.n, m.nnz
        flops = sm.flops_spmm(nnz, d)
        regime_tb = report.traffic(d, sizeof_val=sv, sizeof_idx=si)
        bytes_b = regime_tb.bytes_b
        bytes_c = n * d * sv

        if format == "csr":
            bytes_a = nnz * (sv + si) + (n + 1) * si
            useful = 1.0
            conv = nnz * (sv + 2 * si) + (n + 1) * si
        elif format == "ell":
            k = params["k"]
            bytes_a = n * k * (sv + si)
            useful = nnz / float(n * k)
            conv = n * k * (sv + si)
        elif format == "bcsr":
            t, N = params["t"], max(params["N"], 1)
            bytes_a = N * t * t * sv + 2 * N * si
            useful = sm.mxu_utilization(nnz, t, N)
            bytes_b = 0.25 * N * params["z"] * d * sv
            conv = N * t * t * sv + 3 * N * si
        elif format == "dia":
            k = max(params["num_offsets"], 1)
            bytes_a = k * n * sv
            useful = nnz / float(k * n)
            bytes_b = n * d * sv
            conv = k * n * sv
        elif format == "binned":
            # Lazy import: the kernel registry imports this package's
            # format containers.
            from repro_torch.kernels import registry as kreg
            slab = kreg.choose_b_tile(
                n, hw.vmem_bytes, bd=min(512, kreg.pallas_block_d(d)),
                sizeof_val=sv) or n
            touched, visits = self._stat(
                m, ("binned", slab),
                lambda: kreg.binned_layout_stats(m, slab_rows=slab))
            tb = sm.ai_binned(n, nnz, d, slab_rows=slab,
                              slabs_touched=touched, num_visits=visits,
                              sizeof_val=sv, sizeof_idx=si)
            bytes_a, bytes_b, bytes_c = tb.bytes_a, tb.bytes_b, tb.bytes_c
            useful = 1.0
            conv = 2.0 * (nnz * (sv + 2 * si) + (touched + 1) * si)
            params.update(slab_rows=slab, slabs_touched=touched,
                          num_visits=visits)
        elif format == "rowsplit":
            from repro_torch.kernels import registry as kreg
            n_nonempty = self._stat(m, "nonempty_rows",
                                    lambda: _num_nonempty_rows(m))
            window = kreg.rowsplit_window_model(n_nonempty, nnz)
            tb = sm.ai_rowsplit(n, nnz, d, window=window,
                                bytes_b=regime_tb.bytes_b,
                                sizeof_val=sv, sizeof_idx=si)
            bytes_a, bytes_b, bytes_c = tb.bytes_a, tb.bytes_b, tb.bytes_c
            useful = 1.0
            conv = nnz * (sv + 2 * si)
            params.update(window=window)
        elif format == "ell_coo":
            k_cut, tail = params["k_cut"], params["tail_nnz"]
            issued = max(n * k_cut + tail, 1)
            tb = sm.ai_ell_coo(
                n, nnz, d, k_cut=k_cut, tail_nnz=tail,
                bytes_b=regime_tb.bytes_b * issued / max(nnz, 1),
                sizeof_val=sv, sizeof_idx=si)
            bytes_a, bytes_b, bytes_c = tb.bytes_a, tb.bytes_b, tb.bytes_c
            useful = nnz / float(issued)
            conv = n * k_cut * (sv + si) + tail * (sv + 2 * si)
        else:
            raise ValueError(f"unknown format {format!r}")

        ai = flops / (bytes_a + bytes_b + bytes_c)
        bandwidth_roof = hw.hbm_bandwidth * ai
        ceiling = self._ceiling(format, hw, backend, prec.token)
        compute_roof = ceiling.attainable(hw.peak_flops, useful, d)
        predicted = min(bandwidth_roof, compute_roof)
        if flops <= 0 or predicted <= 0:   # empty matrix: nothing to do
            return ai, useful, 0.0, 0.0, conv, ceiling.source
        t_spmm = flops / predicted
        t_conv = 2.0 * conv / hw.hbm_bandwidth          # read COO + write
        amortized = flops / (t_spmm + t_conv / max(reuse, 1))
        return (ai, useful, predicted / 1e9, amortized / 1e9, conv,
                ceiling.source)

    def _index_extent(self, m: COOMatrix, format: str, d: int,
                      hw: HardwareSpec, prec: Precision) -> int:
        """The largest extent a packed index of this layout addresses:
        the B row slab for the row-tiled layouts, n for rowsplit."""
        if format == "rowsplit":
            return m.n
        from repro_torch.kernels import registry as kreg
        bt = kreg.choose_b_tile(
            m.n, hw.vmem_bytes, bd=min(512, kreg.pallas_block_d(d)),
            sizeof_val=prec.sizeof_val)
        return m.n if bt is None else bt

    def _precision_gate(self, m: COOMatrix, format: str, prec: Precision,
                        d: int, hw: HardwareSpec, tolerance: float,
                        forced: bool) -> Tuple[bool, Optional[str]]:
        """Accuracy/legality gate for one (format, precision) row: int16
        extent legality is never waived; the bf16 tolerance gate is waived
        by a forced precision."""
        if prec.index_dtype == "int16":
            extent = self._index_extent(m, format, d, hw, prec)
            if not fmt.int16_extent_ok(extent):
                return False, (
                    f"int16 indices cannot address extent {extent} "
                    f"(> {INT16_MAX_EXTENT}; the packers reserve a "
                    f"sentinel slot equal to the extent)")
        if prec.reduced and not forced and tolerance < prec.eps:
            return False, (
                f"bf16 values round at eps={prec.eps:.1e} > tolerance "
                f"{tolerance:.1e}; pass tolerance= or force precision= "
                f"to opt in")
        return True, None

    def _candidate(self, m, report, f, prec, params, eligible, reason,
                   d, hw, reuse, backend, tolerance, forced_tok
                   ) -> CandidateEval:
        """Gate and model one (format, precision) row."""
        with trace.span("spmm.plan.candidate", format=f,
                        precision=prec.token):
            p_ok, p_reason = self._precision_gate(
                m, f, prec, d, hw, tolerance,
                forced=prec.token == forced_tok)
            source = "default"
            row_params = dict(params)
            try:
                ai, useful, pred, amort, conv, source = self._model(
                    m, report, f, row_params, d, hw, reuse, backend, prec)
            except (KeyError, ValueError):
                ai = useful = pred = amort = conv = None
        return CandidateEval(
            format=f, eligible=eligible and p_ok,
            skip_reason=reason if not eligible else p_reason,
            ai=ai, useful_fraction=useful, predicted_gflops=pred,
            amortized_gflops=amort, conversion_bytes=conv,
            params=row_params, ceiling_source=source,
            precision=prec.token)

    # ----------------------------------------------------------------- #
    # Public API
    # ----------------------------------------------------------------- #

    def plan(self, m: COOMatrix, d: int, *, strategy: str = "auto",
             reuse: Optional[int] = None, precision=None,
             tolerance: Optional[float] = None) -> DispatchPlan:
        """Plan (and cache) the (format, kernel) choice for ``(m, d)``.

        Args:
            m: square sparse pattern, ``[n, n]``.
            d: dense operand width (``B`` is ``[n, d]``).
            strategy: ``"auto"`` or a format name from ``FORMATS``.
            reuse: conversion amortization horizon (default: the
                dispatcher's ``reuse``).
            precision: force one precision token / ``Precision``; ``None``
                enumerates every precision each kernel supports.
            tolerance: relative error budget of the accuracy gate.

        Returns:
            The cached :class:`DispatchPlan` with per-candidate predictions.

        Raises:
            ValueError: on an unknown strategy, ``d < 1``, a forced format
                the policy rejects for this matrix, or a forced precision
                no eligible kernel can run here.
        """
        with trace.span("spmm.plan", d=d, strategy=strategy) as root:
            if strategy not in STRATEGIES:
                raise ValueError(f"unknown strategy {strategy!r}; choose from "
                                 f"{STRATEGIES}")
            if d < 1:
                raise ValueError(f"dense width d must be >= 1, got {d}")
            reuse = self.reuse if reuse is None else reuse
            tolerance = (self.tolerance if tolerance is None
                         else float(tolerance))
            forced_tok = None if precision is None \
                else as_precision(precision).token
            backend = self._resolve_backend()
            hw = self._resolve_hardware(backend)
            tree = self._tree(backend) if strategy == "auto" else None
            tree_token = tree.fingerprint() if tree is not None else "none"
            key = (self._track(m), d, strategy, reuse, backend, hw.name,
                   tree_token, self.tree_margin, forced_tok, tolerance)
            root.attrs["cached"] = key in self._plans
            if root.attrs["cached"]:
                return self._plans[key]

            from repro_torch.kernels import registry as kreg
            report = self._report(m)
            cands = []
            for f in FORMATS:
                eligible, reason, params = self._policy(m, report, f)
                spec_tokens = kreg.get(f, backend).supported_precisions
                for prec in PRECISIONS:
                    if prec.token not in spec_tokens:
                        continue
                    cands.append(self._candidate(
                        m, report, f, prec, params, eligible, reason, d, hw,
                        reuse, backend, tolerance, forced_tok))

            pool = cands if forced_tok is None else \
                [c for c in cands if c.precision == forced_tok]
            decision_source, decision_path = "analytic", ()
            if strategy == "auto":
                viable = [c for c in pool
                          if c.eligible and c.amortized_gflops is not None]
                if not viable:
                    if forced_tok is not None:
                        raise ValueError(
                            f"no eligible kernel on backend {backend!r} can "
                            f"run precision {forced_tok!r} for this matrix")
                    viable = [c for c in cands
                              if c.format == "csr" and c.precision == "f32i32"]
                ranked = sorted(viable,
                                key=lambda c: c.amortized_gflops or 0.0,
                                reverse=True)
                best_by_fmt: Dict[str, CandidateEval] = {}
                for c in ranked:
                    best_by_fmt.setdefault(c.format, c)
                franked = list(best_by_fmt.values())
                chosen_c = franked[0]
                if tree is not None and len(franked) >= 2:
                    top = franked[0].amortized_gflops or 0.0
                    gap = (top - (franked[1].amortized_gflops or 0.0)) \
                        / max(top, 1e-12)
                    if gap <= self.tree_margin:
                        x = features_from_report(report, d)
                        pick = tree.predict(x)
                        near = {c.format for c in franked
                                if top - (c.amortized_gflops or 0.0)
                                <= self.tree_margin * top}
                        if pick in near:
                            chosen_c = best_by_fmt[pick]
                            decision_source = "tree"
                            decision_path = tree.decision_path(x)
            else:
                rows = [c for c in pool if c.format == strategy]
                if not rows:
                    raise ValueError(
                        f"kernel ({strategy!r}, {backend!r}) does not "
                        f"support precision {forced_tok!r}")
                eligible_rows = [c for c in rows if c.eligible]
                if not eligible_rows:
                    raise ValueError(
                        f"strategy {strategy!r} is policy-ineligible for "
                        f"this matrix: {rows[0].skip_reason}")
                chosen_c = max(eligible_rows,
                               key=lambda c: c.amortized_gflops or 0.0)
            plan = DispatchPlan(
                chosen=chosen_c.format, strategy=strategy,
                regime=report.regime, d=d, reuse=reuse, backend=backend,
                hardware=hw.name,
                candidates=tuple(cands), precision=chosen_c.precision,
                tolerance=tolerance,
                calibration_note=self._staleness(hw, backend),
                decision_source=decision_source, decision_path=decision_path)
            self._plans[key] = plan
            return plan

    def spmm(self, m: COOMatrix, b: torch.Tensor, *,
             strategy: str = "auto",
             reuse: Optional[int] = None, precision=None,
             tolerance: Optional[float] = None) -> torch.Tensor:
        """Compute ``C = A @ B`` through the planned (format, kernel) pair.

        Args:
            m: square sparse pattern, ``[n, n]``.
            b: dense right-hand side, ``[n, d]``, on the dispatcher's
                device.
            strategy, reuse, precision, tolerance: see :meth:`plan`.

        Returns:
            ``C`` as a dense ``[n, d]`` tensor (in the plan's value dtype).

        Raises:
            ValueError: on a shape- or device-incompatible ``b``, or a
                forced format / precision the policy rejects.
        """
        if b.ndim != 2 or b.shape[0] != m.n:
            raise ValueError(
                f"operand shape {tuple(b.shape)} incompatible with "
                f"[{m.n}, {m.n}] sparse matrix; expected [{m.n}, d]")
        check_device(b, self.device)
        plan = self.plan(m, int(b.shape[1]), strategy=strategy, reuse=reuse,
                         precision=precision, tolerance=tolerance)
        return self.executor(m, plan)(b)

    def executor(self, m: COOMatrix, plan: DispatchPlan
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Bind ``plan`` to ``m``: the execute phase, split from planning.

        Format conversion and the kernel's layout packing happen here,
        once, on the dispatcher's device; the returned closure holds the
        prepared layout, so replaying it does no lookups and no
        conversion.

        Args:
            m: the matrix the plan was made for.
            plan: a :class:`DispatchPlan` from :meth:`plan`.

        Returns:
            ``run(b) -> c`` executing the chosen kernel on ``[n, d]``
            operands on the dispatcher's device.
        """
        spec, layout, ctx = self.prepare(m, plan)
        return lambda b: spec.run(layout, b, ctx)

    def prepare(self, m: COOMatrix, plan: DispatchPlan):
        """The chosen kernel spec, its prepared (cached) layout for ``m``,
        and the launch context: what :meth:`executor` binds.

        Returns:
            ``(spec, layout, ctx)``.
        """
        with trace.span("spmm.pack", format=plan.chosen,
                        precision=plan.precision):
            from repro_torch.kernels import registry
            spec = registry.get(plan.chosen, plan.backend)
            prec = as_precision(plan.precision)

            def _convert(mm, format, _prec=prec):
                return self.convert(mm, format, precision=_prec)

            ctx = registry.KernelContext(
                hardware=self._resolve_hardware(plan.backend),
                bcsr_block=self.bcsr_block,
                max_dia_offsets=self.max_dia_offsets,
                plan_d=plan.d, precision=prec, convert=_convert,
                device=self.device)
            ck = (self._track(m), "layout", *spec.layout_cache_key,
                  self.bcsr_block, registry.pallas_block_d(plan.d),
                  prec.token)
            if ck not in self._converted:
                with trace.span("spmm.pack.layout"):
                    self._converted[ck] = spec.prepare(m, ctx)
            return spec, self._converted[ck], ctx


def check_device(b: torch.Tensor, device: torch.device) -> None:
    """Refuse an operand on another device than the plan's."""
    if b.device.type != device.type or (
            device.index is not None and b.device.index != device.index):
        raise ValueError(f"operand is on {b.device}, the plan runs on "
                         f"{device}; move it with .to({str(device)!r})")


#: Dispatchers behind :func:`default_dispatcher`, one per device.
_DEFAULTS: Dict[str, Dispatcher] = {}


def default_dispatcher(device: DeviceLike = None) -> Dispatcher:
    """The shared :class:`Dispatcher` for ``device`` (default: the card).

    Created on first use, so importing this module needs no GPU.

    Raises:
        RuntimeError: when ``device`` is None or CUDA and no GPU is present.
    """
    dev = resolve_device(device)
    key = str(dev)
    if key not in _DEFAULTS:
        _DEFAULTS[key] = Dispatcher(device=dev)
    return _DEFAULTS[key]


def plan_spmm(m: COOMatrix, d: int, *, strategy: str = "auto",
              reuse: Optional[int] = None, precision=None,
              tolerance: Optional[float] = None,
              device: DeviceLike = None) -> DispatchPlan:
    """Plan the (format, kernel) choice for ``(m, d)`` on the default
    dispatcher of ``device`` (see :meth:`Dispatcher.plan`)."""
    return default_dispatcher(device).plan(
        m, d, strategy=strategy, reuse=reuse, precision=precision,
        tolerance=tolerance)


def spmm(m: COOMatrix, b: torch.Tensor, *, strategy: str = "auto",
         reuse: Optional[int] = None, precision=None,
         tolerance: Optional[float] = None) -> torch.Tensor:
    """Structure-aware SpMM ``C = A @ B`` on the default dispatcher of
    ``b``'s device (see :meth:`Dispatcher.spmm`)."""
    return default_dispatcher(b.device).spmm(
        m, b, strategy=strategy, reuse=reuse, precision=precision,
        tolerance=tolerance)
