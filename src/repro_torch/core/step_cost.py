"""Count a step's FLOPs, bytes and live memory from the ops the port runs.

The counterpart of the reference's ``repro.core.hlo_flops`` (``analyze_hlo``,
``top_contributors``) and of ``repro.core.hlo_analysis``'s
``cost_summary`` / ``memory_summary``.  The port has no HLO: a
:class:`StepCounter` is a ``TorchDispatchMode`` that sees every aten op a
step runs, on any device (``meta`` tensors for the dry run, CUDA tensors on
the card), and counts with the reference's rules:

* **FLOPs**: dot products only (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``convolution``: 2 x the output elements x the contracted extent, which
  must exceed 1), as ``hlo_flops`` counts ``dot`` instructions;
* **bytes**: the input plus output bytes of every op that is not a view or
  a metadata op (allocations such as ``empty`` move nothing);
* **the grouped matmul** (``kernels.grouped_matmul``) as one op, whatever
  it runs on: ``2 T K N`` FLOPs and ``x`` + all of ``w`` + ``out`` bytes
  (the kernel reads every expert);
* **live memory**: the peak of the bytes held by tensors the counted ops
  made and that are still referenced.

**Per device.**  Given a mesh, every tensor carries the set of mesh axes
that split it: parameters the axes of their spec that stay split once
FSDP has gathered them (the tensor-parallel ``"model"`` axis), the batch
its data axes, a cache its spec's axes, and each ``ctx.constrain`` point
the axes of its rule (``launch.sharding.activation_rules``, validated
against the shape).  An op's output takes the union of its inputs' axes,
and the op's FLOPs and bytes are divided by the product of those axes'
sizes.  An op that only replicated tensors feed (the router on the
gathered tokens, for example) is not divided by the axes it is replicated
over.

**Loop-aware.**  :func:`extrapolate` combines counts of a model built with
no layers and with one group of its layer pattern (and two or three
micro-batches) into the count of the full depth (and ``grad_accum``), as
``hlo_flops`` multiplies loop bodies by their trip counts; on a model that
can be counted whole, the two agree exactly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import sharding as SH

aten = torch.ops.aten

#: Ops that move no data: allocations, aliases and metadata.
_NO_BYTES = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.detach.default,
    aten.alias.default, aten.lift_fresh.default,
    aten._local_scalar_dense.default, aten.sym_size.int,
    aten.sym_stride.int, aten.sym_numel.default,
    aten.sym_storage_offset.default, aten.is_same_size.default,
    aten.set_.source_Tensor,
}


def _dims(t) -> Tuple[int, ...]:
    return tuple(int(s) for s in t.shape)


def dot_flops(func, args, out) -> float:
    """FLOPs of one dot-product op (0 for any other op).

    A product that contracts a single element (``K = 1``) is an outer
    product, an elementwise multiplication: XLA rewrites such a ``dot``
    into one, so ``hlo_flops`` does not count it, and neither does this."""
    if func in (aten.mm.default, aten.addmm.default):
        a, b = (args[0], args[1]) if func is aten.mm.default \
            else (args[1], args[2])
        (m, k), n = _dims(a), _dims(b)[1]
        return 2.0 * m * n * k if k > 1 else 0.0
    if func in (aten.bmm.default, aten.baddbmm.default):
        a, b = (args[0], args[1]) if func is aten.bmm.default \
            else (args[1], args[2])
        bt, m, k = _dims(a)
        return 2.0 * bt * m * _dims(b)[2] * k if k > 1 else 0.0
    if func is aten.convolution.default:
        w = args[1]
        groups = int(args[8])
        kernel = math.prod(_dims(w)[2:])
        cin = _dims(args[0])[1]
        return 2.0 * out.numel() * (cin // groups) * kernel
    return 0.0


def _tensors(obj, out: List[torch.Tensor]) -> None:
    """Append the tensors in ``obj`` (nested lists and tuples) to ``out``."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)


def nbytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's elements."""
    return t.numel() * t.element_size()


@dataclasses.dataclass
class StepCount:
    """What one counted run gave; all fields add and scale linearly.

    Attributes:
        flops / bytes: the whole step's.
        flops_per_device / bytes_per_device: each op divided by the mesh
            axes that split it (equal to the totals without a mesh).
        peak_live / peak_live_per_device: the peak of live tensor bytes
            made by counted ops.
        rows: ``{(op, input shapes): [flops, bytes, calls]}``.
        constraints: ``{(kind, shape, dtype, axes): calls}`` of the
            ``ctx.constrain`` points the step passed.
    """

    flops: float = 0.0
    bytes: float = 0.0
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    peak_live: float = 0.0
    peak_live_per_device: float = 0.0
    rows: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0.0, 0.0, 0.0]))
    constraints: Dict[tuple, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))

    _SCALARS = ("flops", "bytes", "flops_per_device", "bytes_per_device",
                "peak_live", "peak_live_per_device")

    def top_contributors(self, kind: str = "flops",
                         k: int = 12) -> List[Tuple[float, str]]:
        """The ``k`` largest ops by ``"flops"`` or ``"bytes"``:
        ``[(total, description), ...]``, largest first."""
        col = {"flops": 0, "bytes": 1}[kind]
        rows = [(v[col], f"{getattr(op, '__name__', op)} "
                 f"{' '.join(str(list(d)) for d in dims)} x{v[2]:g}")
                for (op, dims), v in self.rows.items() if v[col] > 0]
        rows.sort(key=lambda r: -r[0])
        return rows[:k]


def combine(terms: Iterable[Tuple[float, StepCount]]) -> StepCount:
    """``sum(coef * count)``, field by field (rows and constraints by
    key; a row or constraint that sums to zero is dropped)."""
    out = StepCount()
    for coef, c in terms:
        for f in StepCount._SCALARS:
            setattr(out, f, getattr(out, f) + coef * getattr(c, f))
        for key, v in c.rows.items():
            row = out.rows[key]
            for i in range(3):
                row[i] += coef * v[i]
        for key, v in c.constraints.items():
            out.constraints[key] += coef * v
    out.rows = defaultdict(lambda: [0.0, 0.0, 0.0], {
        k: v for k, v in out.rows.items() if any(abs(x) > 1e-9 for x in v)})
    out.constraints = defaultdict(float, {
        k: v for k, v in out.constraints.items() if abs(v) > 1e-9})
    return out


def extrapolate(at0: StepCount, at1: StepCount, n: float) -> StepCount:
    """The count at ``n`` repetitions from the counts at zero and one, for
    a quantity affine in the repetitions: ``at0 + n * (at1 - at0)``."""
    return combine([(1.0 - n, at0), (n, at1)])


class StepCounter(TorchDispatchMode):
    """Counts the ops run inside ``with StepCounter(...) as c:``.

    Args:
        mesh: the mesh the per-device shares divide by (None: one device).
        rules: the activation rules ``ctx.constrain`` points take
            (``launch.sharding.activation_rules``); :meth:`observe` is the
            context's observer.
    """

    def __init__(self, mesh=None, rules: Optional[Dict] = None):
        super().__init__()
        self.mesh = mesh
        self.rules = rules or {}
        self.count = StepCount()
        self._axes: Dict[int, Tuple[weakref.ref, frozenset]] = {}
        self._opaque = 0
        self._live = 0.0
        self._live_dev = 0.0
        self._live_rec: Dict[int, List[float]] = {}
        self._sizes: Dict[frozenset, int] = {}
        #: While set, a 0-d output (a full reduction, such as the update's
        #: clip norm) is all-reduced and so replicated; otherwise it keeps
        #: its inputs' axes, so the loss's cotangent, and the backward
        #: ops it feeds, are split as the loss's operands are.
        self.replicate_scalars = False

    # -- axes -------------------------------------------------------------
    def tag(self, t: torch.Tensor, axes: Iterable[str]) -> None:
        """Record that the mesh axes ``axes`` split ``t`` (a live tensor
        the counted ops made is re-split in the live-memory total)."""
        key = id(t)
        axes = frozenset(axes)
        self._axes[key] = (weakref.ref(t, lambda _, k=key:
                                       self._axes.pop(k, None)), axes)
        rec = self._live_rec.get(key)
        if rec is not None:
            dev = rec[0] / self.split(axes)
            self._live_dev += dev - rec[1]
            rec[1] = dev

    def axes(self, t: torch.Tensor) -> frozenset:
        """The axes that split ``t`` (none if it was never tagged)."""
        entry = self._axes.get(id(t))
        if entry is None or entry[0]() is not t:
            return frozenset()
        return entry[1]

    def split(self, axes: frozenset) -> int:
        """Devices the axes split a tensor over."""
        n = self._sizes.get(axes)
        if n is None:
            n = SH.axes_size(self.mesh, axes) if self.mesh is not None else 1
            self._sizes[axes] = n
        return n

    def observe(self, x: torch.Tensor, kind: str) -> None:
        """``ShardingCtx`` observer: tag ``x`` with its rule's axes and
        record the constraint."""
        rule = self.rules.get(kind)
        if kind == "moe_gecd" and rule is not None and x.dim() == 3:
            # The port's [E, G * C, d] buffer: the groups' split moves
            # onto the rows.
            rule = (rule[1], rule[0], rule[3])
        if rule is not None and self.mesh is not None:
            spec = SH.validate_spec(rule, _dims(x), self.mesh)
            axes = frozenset(SH.spec_axes(spec))
            self.tag(x, axes)
            if x.requires_grad:
                # A constraint's cotangent is split as its value is.
                x.register_hook(lambda g, a=axes: self.tag(g, a))
        else:
            axes = self.axes(x)
        self.count.constraints[(kind, _dims(x), str(x.dtype).split(".")[-1],
                                tuple(sorted(axes)))] += 1

    # -- counting ---------------------------------------------------------
    @contextlib.contextmanager
    def opaque(self):
        """Ops issued inside are not counted (the grouped product counts
        itself through :meth:`grouped`)."""
        self._opaque += 1
        try:
            yield
        finally:
            self._opaque -= 1

    def grouped(self, x: torch.Tensor, w: torch.Tensor,
                out: torch.Tensor) -> None:
        """Count one grouped product: ``2 T K N`` FLOPs, ``x`` + ``w`` +
        ``out`` bytes."""
        T, K = _dims(x)
        N = _dims(w)[2]
        ax = self.axes(x) | self.axes(w)
        self.tag(out, ax)
        self._made([out], set())
        flops = 2.0 * T * K * N
        byts = float(nbytes(x) + nbytes(w) + nbytes(out))
        dev_bytes = nbytes(x) / self.split(self.axes(x)) + \
            nbytes(w) / self.split(self.axes(w)) + nbytes(out) / \
            self.split(ax)
        self._add(("grouped_matmul", (_dims(x), _dims(w))), flops, byts,
                  flops / self.split(ax), dev_bytes)

    def _add(self, key: tuple, flops: float, byts: float, flops_dev: float,
             bytes_dev: float) -> None:
        c = self.count
        c.flops += flops
        c.bytes += byts
        c.flops_per_device += flops_dev
        c.bytes_per_device += bytes_dev
        row = c.rows[key]
        row[0] += flops
        row[1] += byts
        row[2] += 1

    def _made(self, outs: Sequence[torch.Tensor], ins: set) -> None:
        """Track the live bytes of newly made output tensors."""
        for o in outs:
            if id(o) in ins or o._base is not None:
                continue
            rec = [float(nbytes(o)), 0.0]
            rec[1] = rec[0] / self.split(self.axes(o))
            self._live += rec[0]
            self._live_dev += rec[1]
            self._live_rec[id(o)] = rec
            weakref.finalize(o, self._free, id(o), rec)
        self._peak()

    def _peak(self) -> None:
        c = self.count
        c.peak_live = max(c.peak_live, self._live)
        c.peak_live_per_device = max(c.peak_live_per_device, self._live_dev)

    def _free(self, key: int, rec: List[float]) -> None:
        self._live -= rec[0]
        self._live_dev -= rec[1]
        if self._live_rec.get(key) is rec:
            del self._live_rec[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._opaque:
            return out
        ins: List[torch.Tensor] = []
        _tensors(args, ins)
        if kwargs:
            _tensors(tuple(kwargs.values()), ins)
        outs: List[torch.Tensor] = []
        _tensors(out, outs)
        in_axes = [self.axes(t) for t in ins]
        ax = frozenset().union(*in_axes)
        for o in outs:
            self.tag(o, frozenset() if self.replicate_scalars and
                     not o.dim() else ax)
        if func.is_view or func in _NO_BYTES:
            return out
        self._made(outs, {id(t) for t in ins})
        in_bytes = [nbytes(t) for t in ins]
        out_bytes = sum(nbytes(o) for o in outs)
        flops = dot_flops(func, args, out)
        bytes_dev = out_bytes / self.split(ax) + sum(
            b / self.split(a) for b, a in zip(in_bytes, in_axes))
        key = (func, tuple(tuple(t.shape) for t in ins[:3]))
        self._add(key, flops, float(sum(in_bytes) + out_bytes),
                  flops / self.split(ax), bytes_dev)
        return out

    def __enter__(self):
        from repro_torch.kernels import grouped_matmul as G
        if G.OBSERVER is not None:
            raise RuntimeError("a StepCounter is already counting")
        G.OBSERVER = self
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import grouped_matmul as G
        G.OBSERVER = None
        return super().__exit__(*exc)
