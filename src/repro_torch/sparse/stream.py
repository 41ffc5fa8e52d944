"""Batched/streamed SpMM: plan once, execute across many right-hand sides.

The serving-path API on top of the dispatcher's plan/execute split:

    spec = BSpec(d=64, reuse=256)        # 256 RHS batches expected
    plan = sparse.plan(m, spec)          # classify + model + convert ONCE
    c0 = plan.execute(b0)                # zero-dispatch replay
    cs = plan.execute_many(bs)           # a stream of [n, d] batches
    cw = plan.execute_wide(b_wide)       # one [n, D] B, column-sharded

The expected reuse count feeds the plan's conversion-cost model, and
``execute`` replays the bound kernel closure with no classification, no
cache lookups and no policy checks.  Plans run on the card unless
``device="cpu"`` is passed; operands must live on the plan's device.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.device import DeviceLike
from repro_torch.core.patterns import COOMatrix
from repro_torch.sparse import dispatch as _dispatch

_LOG = logging.getLogger(__name__)

#: ``execute_many`` warns when realized reuse exceeds the planned horizon
#: by more than this factor.
REUSE_DRIFT_FACTOR = 2.0


@dataclasses.dataclass(frozen=True)
class BSpec:
    """Static description of the dense right-hand-side stream.

    Attributes:
        d: width of each right-hand side (every ``B`` is ``[n, d]``).
        reuse: expected number of executions the plan will serve (the
            conversion amortization horizon).
        dtype: element dtype of the stream (informational; kernels follow
            the dtype of each ``B`` actually passed).
        precision: optional storage precision to force on the plan.
        tolerance: accuracy budget handed to the precision gate.
    """

    d: int
    reuse: int = 32
    dtype: Any = torch.float32
    precision: Any = None
    tolerance: Optional[float] = None

    def __post_init__(self):
        """Validate widths and horizons at construction time."""
        if self.d < 1:
            raise ValueError(f"BSpec.d must be >= 1, got {self.d}")
        if self.reuse < 1:
            raise ValueError(f"BSpec.reuse must be >= 1, got {self.reuse}")


def as_b_spec(spec: Union[int, BSpec, torch.Tensor],
              *, reuse: Optional[int] = None) -> BSpec:
    """Coerce a width, an example batch, or a BSpec into a ``BSpec``.

    Args:
        spec: an ``int`` width ``d``, an example ``[n, d]`` tensor or
            array, or an existing :class:`BSpec`.
        reuse: optional override for the expected execution count.
    """
    if isinstance(spec, BSpec):
        return spec if reuse is None else dataclasses.replace(
            spec, reuse=reuse)
    if isinstance(spec, (int, np.integer)):
        return BSpec(d=int(spec), reuse=32 if reuse is None else reuse)
    shape = getattr(spec, "shape", None)
    if shape is not None and len(shape) == 2:
        dtype = spec.dtype if isinstance(spec, torch.Tensor) \
            else torch.float32
        return BSpec(d=int(shape[1]), reuse=32 if reuse is None else reuse,
                     dtype=dtype)
    raise TypeError(
        f"b_spec must be an int width, a BSpec, or an example [n, d] "
        f"array; got {type(spec).__name__}")


class StreamPlan:
    """A persistent, replayable SpMM plan for one matrix and a RHS stream.

    Construction runs the whole one-time pipeline (classification,
    roofline evaluation at the stream's reuse horizon, conversion and
    layout packing on the device), so every ``execute`` is a bare launch.
    ``layout`` is the packed operand the chosen kernel replays on.
    """

    def __init__(self, dispatcher: _dispatch.Dispatcher, m: COOMatrix,
                 spec: BSpec, *, strategy: str = "auto"):
        """Plan and bind; see :func:`plan` for the usual entry point.

        Args:
            dispatcher: the :class:`~repro_torch.sparse.dispatch.Dispatcher`
                that owns caches, device and hardware model.
            m: square sparse pattern, ``[n, n]``.
            spec: the stream description (width + expected reuse).
            strategy: ``"auto"`` or a forced format name.
        """
        self._m = m
        self._dispatcher = dispatcher
        self._strategy = strategy
        self.spec = spec
        self.dispatch = dispatcher.plan(m, spec.d, strategy=strategy,
                                        reuse=spec.reuse,
                                        precision=spec.precision,
                                        tolerance=spec.tolerance)
        self._run = self._bind()
        self.executed = 0
        self._reuse_warned = False

    def _bind(self):
        """Resolve the executor this plan replays.

        Subclasses override this hook to bind another execution tier over
        the same DispatchPlan: :class:`~repro_torch.sparse.shard.ShardedPlan`
        returns its sharded executor here instead of the single-device
        kernel.
        """
        spec, self.layout, ctx = self._dispatcher.prepare(self._m,
                                                          self.dispatch)
        return lambda b: spec.run(self.layout, b, ctx)

    @property
    def n(self) -> int:
        """Matrix dimension; every RHS must have ``n`` rows."""
        return self._m.n

    @property
    def device(self) -> torch.device:
        """The device the plan's layout lives on and its kernels run on."""
        return self._dispatcher.device

    @property
    def chosen(self) -> str:
        """The format the amortized roofline model selected."""
        return self.dispatch.chosen

    @property
    def precision(self) -> str:
        """The storage-precision token the plan executes at."""
        return self.dispatch.precision

    def _check(self, b: torch.Tensor, *, width: Optional[int] = None) -> None:
        """Reject shape- or device-mismatched operands."""
        if b.ndim != 2 or b.shape[0] != self.n:
            raise ValueError(
                f"operand shape {tuple(b.shape)} incompatible with plan for "
                f"[{self.n}, {self.n}] matrix; expected [{self.n}, d]")
        if width is not None and b.shape[1] != width:
            raise ValueError(
                f"operand width {b.shape[1]} != planned width {width}; "
                f"use execute_wide for other widths")
        _dispatch.check_device(b, self.device)

    def execute(self, b: torch.Tensor) -> torch.Tensor:
        """Run ``C = A @ B`` for one planned-width batch.

        Args:
            b: dense right-hand side, ``[n, spec.d]``, on the plan's device.

        Returns:
            ``C`` as a dense ``[n, spec.d]`` tensor.
        """
        self._check(b, width=self.spec.d)
        out = self._run(b)
        self.executed += 1
        self._audit_reuse()
        return out

    def execute_async(self, b: torch.Tensor) -> torch.Tensor:
        """Enqueue one planned-width batch with no sync point.

        Identical to :meth:`execute`: on the card the launch is queued on
        the current CUDA stream and the returned tensor is not yet
        computed (``KernelSpec.async_dispatch``), so the host is free to
        stage the next operand meanwhile, the overlap the serving engine
        (``repro_torch.sparse.engine``) builds on.  Wait with an event or
        ``torch.cuda.synchronize``.

        Args:
            b: dense right-hand side, ``[n, spec.d]``, on the plan's device.

        Returns:
            ``C`` as an in-flight ``[n, spec.d]`` tensor.
        """
        return self.execute(b)

    def execute_many_async(self, bs: Union[torch.Tensor,
                                           Sequence[torch.Tensor],
                                           Iterable[torch.Tensor]]) -> list:
        """Enqueue a whole stream with no sync point and no stacking.

        Args:
            bs: a stacked ``[k, n, d]`` tensor or an iterable of ``k``
                tensors of shape ``[n, d]``.

        Returns:
            List of ``k`` in-flight ``[n, d]`` tensors.
        """
        if isinstance(bs, torch.Tensor) and bs.ndim == 3:
            bs = list(bs.unbind(0))
        outs = []
        for b in bs:
            self._check(b, width=self.spec.d)
            outs.append(self._run(b))
            self.executed += 1
        self._audit_reuse()
        return outs

    def execute_many(self, bs: Union[torch.Tensor, Sequence[torch.Tensor],
                                     Iterable[torch.Tensor]]) -> torch.Tensor:
        """Replay the bound kernel across a stream of right-hand sides.

        Args:
            bs: a stacked ``[k, n, d]`` tensor or an iterable of ``k``
                tensors of shape ``[n, d]``.

        Returns:
            The stacked results, ``[k, n, d]``; an empty stream returns a
            ``[0, n, d]`` tensor of ``spec.dtype``.
        """
        outs = self.execute_many_async(bs)
        if not outs:
            return torch.zeros((0, self.n, self.spec.d),
                               dtype=self.spec.dtype, device=self.device)
        return torch.stack(outs)

    def _audit_reuse(self) -> None:
        """Warn (once) when the realized reuse drifts >2x past the plan."""
        if self._reuse_warned:
            return
        if self.executed > REUSE_DRIFT_FACTOR * self.spec.reuse:
            self._reuse_warned = True
            _LOG.warning(
                "StreamPlan reuse horizon off by >%.0fx: planned %d, "
                "executed %d (utilization %.1fx); the conversion "
                "amortization that picked %r assumed the shorter stream — "
                "consider plan.replan(observed_reuse=%d)",
                REUSE_DRIFT_FACTOR, self.spec.reuse, self.executed,
                self.executed / self.spec.reuse, self.chosen, self.executed)

    def replan(self, observed_reuse: int) -> "StreamPlan":
        """Re-plan at an observed reuse horizon; returns a new StreamPlan
        (this plan stays valid)."""
        if observed_reuse < 1:
            raise ValueError(
                f"observed_reuse must be >= 1, got {observed_reuse}")
        spec = dataclasses.replace(self.spec, reuse=observed_reuse)
        return StreamPlan(self._dispatcher, self._m, spec,
                          strategy=self._strategy)

    def maybe_replan(self) -> Optional["StreamPlan"]:
        """A fresh plan at the observed horizon once the reuse audit
        fired; ``None`` while the planned horizon still holds."""
        if not self._reuse_warned:
            return None
        return self.replan(max(self.executed, 1))

    def exec_hints(self) -> dict:
        """Execution metadata of the bound kernel spec
        (``async_dispatch``, ``donate_b``)."""
        from repro_torch.kernels import registry
        spec = registry.get(self.dispatch.chosen, self.dispatch.backend)
        return {"async_dispatch": spec.async_dispatch,
                "donate_b": spec.donate_b}

    def coalesce_block_d(self, total_cols: int) -> int:
        """Widest per-launch column block a coalesced batch may replay at.

        ``torch``-backend plans adapt to any width, so a coalesced batch
        runs as one launch, its width quantized to a power-of-two multiple
        of ``spec.d``.  ``cuda`` layouts were packed for the planned width
        (the slab was sized for ``plan_d = spec.d``), so they replay in
        planned-width blocks.
        """
        if self.dispatch.backend == "torch":
            d = max(self.spec.d, 1)
            blocks = -(-max(int(total_cols), 1) // d)
            size = 1
            while size < blocks:
                size *= 2
            return size * d
        return self.spec.d

    def execute_wide(self, b: torch.Tensor,
                     *, block_d: Optional[int] = None) -> torch.Tensor:
        """Column-shard one wide ``[n, D]`` B through the plan in blocks of
        ``block_d`` columns (default ``spec.d``) and concatenate."""
        self._check(b)
        block_d = self.spec.d if block_d is None else int(block_d)
        if block_d < 1:
            raise ValueError(f"block_d must be >= 1, got {block_d}")
        total = b.shape[1]
        if total == 0:
            return torch.zeros((self.n, 0), dtype=b.dtype, device=b.device)
        outs = []
        for lo in range(0, total, block_d):
            outs.append(self._run(b[:, lo:lo + block_d].contiguous()))
            self.executed += 1
        self._audit_reuse()
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def reset_stats(self) -> None:
        """Zero the execution counter (e.g. after warm-up calls)."""
        self.executed = 0

    def stats(self) -> dict:
        """Amortization audit: planned horizon vs realized executions."""
        return {
            "chosen": self.dispatch.chosen,
            "regime": self.dispatch.regime,
            "backend": self.dispatch.backend,
            "precision": self.dispatch.precision,
            "planned_reuse": self.spec.reuse,
            "executed": self.executed,
            "reuse_utilization": self.executed / self.spec.reuse,
            "replan_suggested": self._reuse_warned,
        }


def plan(m: COOMatrix, b_spec: Union[int, BSpec, torch.Tensor], *,
         strategy: str = "auto", reuse: Optional[int] = None,
         precision=None, tolerance: Optional[float] = None,
         mesh=None, b_strategy: str = "auto",
         dispatcher: Optional[_dispatch.Dispatcher] = None,
         device: DeviceLike = None) -> StreamPlan:
    """Plan once for a stream of right-hand sides; the serving entry point.

    Args:
        m: square sparse pattern (``repro_torch.core.patterns.COOMatrix``).
        b_spec: an ``int`` width, a :class:`BSpec`, or an example batch.
        strategy: ``"auto"`` or a format name to force.
        reuse: shorthand override for ``BSpec.reuse``.
        precision: shorthand override for ``BSpec.precision``.
        tolerance: shorthand override for ``BSpec.tolerance``.
        mesh: optional :class:`~repro_torch.launch.mesh.ShardMesh`; when
            given, returns a :class:`~repro_torch.sparse.shard.ShardedPlan`
            that partitions the matrix across the mesh's devices.
        b_strategy: sharded-tier B-distribution strategy (``"auto"`` or
            one of ``repro_torch.sparse.shard.B_STRATEGIES``); needs
            ``mesh``.
        dispatcher: dispatcher to plan on; defaults to the shared one of
            ``device``.
        device: where the plan runs when no dispatcher is given; None
            means the card, and raises without a GPU — pass
            ``device="cpu"`` to run on the CPU.

    Returns:
        A bound :class:`StreamPlan` (a ``ShardedPlan`` when ``mesh`` is
        given).
    """
    spec = as_b_spec(b_spec, reuse=reuse)
    if precision is not None or tolerance is not None:
        spec = dataclasses.replace(
            spec,
            precision=spec.precision if precision is None else precision,
            tolerance=spec.tolerance if tolerance is None else tolerance)
    disp = dispatcher or _dispatch.default_dispatcher(device)
    if mesh is not None:
        from repro_torch.sparse.shard import ShardedPlan
        return ShardedPlan(disp, m, spec, mesh, strategy=strategy,
                           b_strategy=b_strategy)
    if b_strategy != "auto":
        raise ValueError("b_strategy requires a mesh (sharded tier)")
    return StreamPlan(disp, m, spec, strategy=strategy)
