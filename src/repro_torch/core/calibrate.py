"""Per-format compute ceilings: the sweep that fits them, and their store.

The dispatcher caps every bandwidth roofline with a format compute
ceiling ``peak * peak_fraction * useful * d / (d + d_half)``.  The
``(peak_fraction, d_half)`` pairs in
``repro_torch.sparse.dispatch.DEFAULT_EFFICIENCY`` were fitted on a CPU
host; ceilings are properties of a (device, implementation) pair and are
learned where the code runs:

    from repro_torch.core.calibrate import CalibrationStore, calibrate
    cal = calibrate(hw, backend="cuda", device="cuda",
                    scale=CARD_SCALE, bcsr_block=64)
    CalibrationStore().save(cal)
    # Dispatchers pick it up; CandidateEval.ceiling_source flips from
    # "default" to "calibrated".

``calibrate`` runs, per registered kernel, a structure-matched SpMM at
several dense widths through the dispatcher's executor, and fits
``g(d) = G * d / (d + d_half)`` to the measured useful GFLOP/s via the
linearization ``1/g = 1/G + (d_half/G) * (1/d)`` (least squares on
``1/d``), so ``peak_fraction = G / (peak * useful_fraction)``.  Each
timing is the host clock around one call plus, on the card,
``torch.cuda.synchronize``: what a served request pays
(``repro_torch.launch.serve``).  ``python -m repro_torch.launch.serve
--spmm-stream --calibrate`` runs the sweep at start-up.

Files live under ``$REPRO_CALIBRATION_DIR`` (or
``~/.cache/repro/calibrations``) as ``<HardwareSpec.name>-<backend>.json``.
The port's backends are ``"torch"`` and ``"cuda"``, so its files never
collide with the reference's ``"jax"`` / ``"pallas"`` ones.  A file is
stamped with the spec's fingerprint and the port's kernel
``REGISTRY_VERSION``; a stale file is ignored.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device, synchronize
from repro_torch.core.hardware import HardwareSpec

#: Dense widths for the fit: spread in 1/d so both the asymptote and the
#: half-saturation width are constrained.
DEFAULT_D_VALUES: Tuple[int, ...] = (4, 16, 64, 256)

#: Clamps keeping a noisy fit inside physically meaningful territory.
PEAK_FRACTION_RANGE: Tuple[float, float] = (1e-5, 1.0)
D_HALF_RANGE: Tuple[float, float] = (0.0, 4096.0)

#: log2 n of the sweep on the card.  At the reference's n = 2**9 a call
#: is the launch path, not the kernel.  At the serving n = 2**20 each of
#: the 28 (format, d) cells packs its layout anew (the layout cache key
#: holds ``pallas_block_d(d)``), several seconds of host numpy each.  At
#: 2**18, B is 64 MiB at d = 64 and 256 MiB at d = 256, past the H100's
#: 50 MB L2, and stays in it at d = 4 and 16.
CARD_SCALE = 18

#: The command that refits a stale calibration.
REFIT = "python -m repro_torch.launch.serve --spmm-stream --calibrate"


def fit_ceiling(d_values: Sequence[int],
                gflops: Sequence[float]) -> Tuple[float, float]:
    """Fit ``g(d) = G * d / (d + d_half)`` to measured throughputs.

    Args:
        d_values: dense widths of the sweep (>= 2 distinct values).
        gflops: measured useful GFLOP/s at each width.

    Returns:
        ``(G, d_half)`` — the saturated throughput (same unit as the
        input) and the half-saturation width.  Degenerate sweeps (flat,
        noisy-decreasing, or non-positive) fall back to
        ``(max(gflops), 0.0)``.

    Raises:
        ValueError: on fewer than 2 points or mismatched lengths.
    """
    d = np.asarray(list(d_values), dtype=np.float64)
    g = np.asarray(list(gflops), dtype=np.float64)
    if d.shape != g.shape or d.size < 2:
        raise ValueError(f"need matched sweeps of >= 2 points, got "
                         f"{d.size} vs {g.size}")
    if np.any(g <= 0) or np.unique(d).size < 2:
        return float(max(g.max(), 1e-9)), 0.0
    slope, intercept = np.polyfit(1.0 / d, 1.0 / g, 1)
    if intercept <= 0 or slope < 0:
        # Throughput not saturating (or decreasing with d): the model's
        # asymptote is unconstrained; report the best measurement flat.
        return float(g.max()), 0.0
    return float(1.0 / intercept), float(slope / intercept)


@dataclasses.dataclass(frozen=True)
class FormatCalibration:
    """Fitted ceiling for one (format, backend, precision) on one device."""

    format: str
    backend: str
    peak_fraction: float
    d_half: float
    sustained_gflops: float           # fitted asymptote, useful GFLOP/s
    useful_fraction: float            # of the calibration matrix
    measured: Dict[int, float]        # d -> measured useful GFLOP/s
    precision: str = "f32i32"


@dataclasses.dataclass(frozen=True)
class Calibration:
    """A full calibration run: per-format ceilings + provenance."""

    hardware: str                     # HardwareSpec.name
    fingerprint: str                  # HardwareSpec.fingerprint()
    backend: str
    entries: Tuple[FormatCalibration, ...]
    #: ``repro_torch.kernels.registry.REGISTRY_VERSION`` at fit time.
    registry_version: int = 0

    def efficiency(self, precision: str = "f32i32"
                   ) -> Dict[str, Tuple[float, float]]:
        """The ``format -> (peak_fraction, d_half)`` ceiling table.

        A format's entry for the requested precision token wins; formats
        calibrated only at fp32 fall back to that fit.
        """
        out = {e.format: (e.peak_fraction, e.d_half)
               for e in self.entries if e.precision == "f32i32"}
        if precision != "f32i32":
            out.update({e.format: (e.peak_fraction, e.d_half)
                        for e in self.entries if e.precision == precision})
        return out

    def summary(self) -> str:
        """Render the fitted ceilings as a human-readable table."""
        lines = [f"Calibration({self.hardware}, fp={self.fingerprint}, "
                 f"backend={self.backend})"]
        for e in self.entries:
            lines.append(
                f"  {e.format:8s} {e.precision:7s} "
                f"peak_fraction={e.peak_fraction:.4f} "
                f"d_half={e.d_half:6.1f}  "
                f"(sustained {e.sustained_gflops:.2f} GF/s useful, "
                f"useful_fraction {e.useful_fraction:.3f})")
        return "\n".join(lines)


def _default_root() -> pathlib.Path:
    return pathlib.Path(os.environ.get("REPRO_CALIBRATION_DIR") or (
        pathlib.Path.home() / ".cache" / "repro" / "calibrations"))


class CalibrationStore:
    """Persistence for :class:`Calibration` results, one file per
    (device, backend); ``load`` refuses a stale or foreign file."""

    def __init__(self, root: Optional[os.PathLike] = None):
        """Open (without touching the filesystem) the store at ``root``."""
        self.root = pathlib.Path(root) if root is not None \
            else _default_root()

    def path_for(self, hw: HardwareSpec,
                 backend: str = "torch") -> pathlib.Path:
        """The JSON path holding ``hw``'s calibration for ``backend``."""
        return self.root / f"{hw.name}-{backend}.json"

    def save(self, cal: Calibration) -> pathlib.Path:
        """Write ``cal`` (creating the store directory) and return the path."""
        self.root.mkdir(parents=True, exist_ok=True)
        path = self.root / f"{cal.hardware}-{cal.backend}.json"
        payload = dataclasses.asdict(cal)
        payload["saved_unix"] = time.time()
        path.write_text(json.dumps(payload, indent=2), encoding="utf-8")
        return path

    def _payload(self, hw: HardwareSpec, backend: str):
        path = self.path_for(hw, backend)
        if not path.is_file():
            return path, None
        try:
            return path, json.loads(path.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError):
            return path, "unreadable"

    def load(self, hw: HardwareSpec,
             backend: str = "torch") -> Optional[Calibration]:
        """Read the calibration for ``(hw, backend)``; None when absent,
        unreadable, fitted for another fingerprint, or another backend."""
        _, payload = self._payload(hw, backend)
        if not isinstance(payload, dict):
            return None
        if payload.get("fingerprint") != hw.fingerprint():
            return None
        if payload.get("backend") != backend:
            return None
        entries = tuple(
            FormatCalibration(
                format=e["format"], backend=e["backend"],
                peak_fraction=float(e["peak_fraction"]),
                d_half=float(e["d_half"]),
                sustained_gflops=float(e["sustained_gflops"]),
                useful_fraction=float(e["useful_fraction"]),
                measured={int(k): float(v)
                          for k, v in e["measured"].items()},
                precision=e.get("precision", "f32i32"))
            for e in payload.get("entries", ()))
        return Calibration(hardware=payload["hardware"],
                           fingerprint=payload["fingerprint"],
                           backend=payload["backend"], entries=entries,
                           registry_version=int(
                               payload.get("registry_version", 0)))

    def staleness_note(self, hw: HardwareSpec,
                       backend: str = "torch") -> Optional[str]:
        """One-line staleness warning for ``(hw, backend)``, or ``None``.

        A missing file is not stale (defaults are then intended); an
        unreadable file, a fingerprint mismatch, or a calibration fitted
        against an older kernel registry each earn a note.
        """
        path, payload = self._payload(hw, backend)
        if payload is None:
            return None
        if not isinstance(payload, dict):
            return (f"calibration file {path.name} is unreadable; using "
                    f"default ceilings (re-run {REFIT})")
        if payload.get("fingerprint") != hw.fingerprint():
            return (f"calibration {path.name} was fitted for fingerprint "
                    f"{payload.get('fingerprint')}, active spec is "
                    f"{hw.fingerprint()}; using default ceilings (re-run "
                    f"{REFIT})")
        from repro_torch.kernels import registry
        stored = int(payload.get("registry_version", 0))
        if stored < registry.REGISTRY_VERSION:
            return (f"calibration {path.name} predates kernel registry "
                    f"v{registry.REGISTRY_VERSION} (fitted at "
                    f"v{stored}); ceilings may describe retired kernels "
                    f"(re-run {REFIT})")
        return None


def _calibration_matrices(scale: int, bcsr_block: int) -> Dict[str, object]:
    """One structure-matched COOMatrix generator thunk per format.

    Each format gets the structure it exists for, sized to clear the
    dispatch policy gates (BCSR divisibility + dense blocks, DIA band
    width, ELL balanced degrees).
    """
    from repro_torch.core import patterns
    n = 2 ** scale
    t = bcsr_block
    return {
        "csr": lambda: patterns.erdos_renyi(n, 8, seed=11),
        "ell": lambda: patterns.erdos_renyi(n, 8, seed=12),
        "bcsr": lambda: patterns.blocked(
            n, t=t, num_blocks=max(2 * (n // t), 1),
            nnz_per_block=int(t * t * 0.8), seed=13),
        "dia": lambda: patterns.banded(n, 3, fill=1.0, seed=14),
        # The scale-free tier calibrates on the structure it targets:
        # skewed degree distributions with hub rows/columns.
        "binned": lambda: patterns.scale_free(n, 8, alpha=2.05, seed=15),
        "rowsplit": lambda: patterns.scale_free(n, 8, alpha=2.2, seed=16),
        "ell_coo": lambda: patterns.scale_free(n, 8, seed=17),
    }


def _best_of(fn, repeats: int, device) -> float:
    """Best of ``repeats`` host-clock timings of ``fn()``, in seconds,
    after one warm call.

    On the card each timing ends in ``torch.cuda.synchronize(device)``:
    the host clock around launch plus synchronise is what a served request
    pays (``repro_torch.launch.serve``), so the fitted ceiling describes
    that path rather than the kernel alone, as CUDA events would.
    """
    fn()
    synchronize(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def calibrate(hw: HardwareSpec, *, backend: str = "torch",
              device: DeviceLike = None,
              formats: Optional[Sequence[str]] = None,
              d_values: Sequence[int] = DEFAULT_D_VALUES,
              scale: int = 9, repeats: int = 3, bcsr_block: int = 32,
              precisions: Sequence[str] = ("f32i32",),
              store: Optional[CalibrationStore] = None) -> Calibration:
    """Measure and fit the per-format compute ceilings on this device.

    For each format, runs the registered kernel (through the dispatcher's
    executor, so the measured path is the served path) on a
    structure-matched matrix across ``d_values``, fits
    ``(peak_fraction, d_half)`` (see :func:`fit_ceiling`), and optionally
    persists the result.

    Args:
        hw: the hardware spec the ceilings are expressed against
            (``peak_fraction`` is relative to ``hw.peak_flops``).
        backend: ``"torch"`` (the plain PyTorch versions) or ``"cuda"``
            (the hand-written kernels) — which registered kernels to
            calibrate.
        device: where the sweep runs; None means the card, and raises
            when there is none.
        formats: formats to sweep; defaults to every format registered
            under ``backend`` that is also a dispatch format.
        d_values: dense widths of the sweep.
        scale: matrix dimension exponent (n = 2**scale); on the card use
            :data:`CARD_SCALE`.
        repeats: min-of-N timing repeats per cell.
        bcsr_block: BCSR block edge for the blocked calibration matrix
            and the sweep's dispatcher; on the card use the serving
            dispatcher's (64), whose kernel variant serving launches.
        precisions: precision tokens to fit per format (each a separate
            :class:`FormatCalibration` entry); combos a kernel spec does
            not support, or that this matrix cannot legally pack (int16
            extent), are skipped.  Default fits fp32 only.
        store: when given, ``store.save`` the result before returning.

    Returns:
        The fitted :class:`Calibration`.

    Raises:
        ValueError: when a requested format has no calibration matrix.
        RuntimeError: when ``device`` is the card and none is present.
    """
    from repro_torch.kernels import registry
    from repro_torch.sparse.dispatch import FORMATS, Dispatcher

    dev = resolve_device(device)
    if formats is None:
        formats = [f for f in FORMATS if f in registry.formats_for(backend)]
    gens = _calibration_matrices(scale, bcsr_block)
    unknown = sorted(set(formats) - set(gens))
    if unknown:
        raise ValueError(f"no calibration matrix for formats {unknown}")

    # Ceilings must not influence the measurement: strategies are forced,
    # and the dispatcher is isolated from any existing calibration file.
    disp = Dispatcher(hardware=hw, backend=backend, device=dev,
                      bcsr_block=bcsr_block, calibration=False)
    entries = []
    for fmt in formats:
        spec = registry.get(fmt, backend)
        for prec in precisions:
            if prec not in spec.supported_precisions:
                continue
            m = gens[fmt]()
            rng = np.random.default_rng(7)
            measured: Dict[int, float] = {}
            useful_fraction = 1.0
            try:
                for d in d_values:
                    b = torch.from_numpy(
                        rng.normal(size=(m.n, d)).astype(np.float32)).to(dev)
                    plan = disp.plan(m, d, strategy=fmt, precision=prec)
                    useful_fraction = plan.candidate(fmt).useful_fraction
                    run = disp.executor(m, plan)
                    dt = _best_of(lambda run=run, b=b: run(b), repeats, dev)
                    measured[int(d)] = 2.0 * m.nnz * d / dt / 1e9
            except ValueError:
                # e.g. int16 extent illegal for this matrix: skip the
                # combo, the fp32 fit still answers for the format.
                continue
            g_inf, d_half = fit_ceiling(list(measured),
                                        list(measured.values()))
            lo, hi = PEAK_FRACTION_RANGE
            peak_fraction = float(np.clip(
                g_inf * 1e9 / (hw.peak_flops * max(useful_fraction, 1e-9)),
                lo, hi))
            d_half = float(np.clip(d_half, *D_HALF_RANGE))
            entries.append(FormatCalibration(
                format=fmt, backend=backend, peak_fraction=peak_fraction,
                d_half=d_half, sustained_gflops=g_inf,
                useful_fraction=useful_fraction, measured=measured,
                precision=prec))
    cal = Calibration(hardware=hw.name, fingerprint=hw.fingerprint(),
                      backend=backend, entries=tuple(entries),
                      registry_version=registry.REGISTRY_VERSION)
    if store is not None:
        store.save(cal)
    return cal
