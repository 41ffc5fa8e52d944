"""Collectives on the named axes of a process mesh, with gradients.

The port's counterparts of the ``jax.lax`` collectives that the
reference's ``shard_map`` programs call, over
``launch.mesh.ProcessMesh``'s per-axis process groups:

* ``psum(x, axis)``: ``all_reduce`` (sum); backward ``psum``;
* ``pmax(x, axis)``: ``all_reduce`` (max); no backward (refused);
* ``all_gather(x, axis, dim=, tiled=)``: ``all_gather_into_tensor``;
  backward ``psum_scatter``;
* ``psum_scatter(x, axis, scatter_dimension=, tiled=)``:
  ``reduce_scatter_tensor``; backward ``all_gather``;
* ``ppermute(x, axis, perm)``: ``batch_isend_irecv``; backward
  ``ppermute`` by the inverse ``perm``;
* ``pvary(x, axis)``: the identity; backward ``psum``;
* ``broadcast(x, axis, src)``: ``broadcast``; no backward (refused).

Each op is a ``torch.autograd.Function`` whose backward is its transpose.
The gradients follow one convention: the objective is the sum of every
rank's local objective, so a value replicated over an axis must enter it
once (scaled by ``1 / axis_size`` on each replica, or counted on one).
:func:`pvary` is the transpose that ``shard_map`` applies to an operand
replicated over an axis (the tokens over ``"model"``, a replicated
router): its gradient is summed over the axis.

``axis`` is a mesh axis name or a tuple of them (the reduction then runs
over each axis in turn).  Each op runs on ``mesh`` or, by default, on the
mesh of the innermost ``with mesh:`` block.

Counting: every op adds the bytes this rank puts on the wire to
``mesh.log`` (``core.collectives.CollectiveLog``), at the ring volumes the
dry run charges: an all-gather or reduce-scatter of an ``S``-byte whole
over ``n`` ranks moves ``(n - 1) / n * S`` per rank, an all-reduce twice
that; a permute or a broadcast is charged the bytes a sending rank sends
(``add_sent``).  Backward collectives are counted like forward ones.

Host staging: a gloo mesh of CUDA ranks (several ranks sharing one card)
copies each payload to the host, runs the gloo collective there, and
copies the result back to the card.  That is a property of the mesh the
caller built (``ProcessMesh.stages_through_host``), not a fallback, and
the bytes copied each way are counted in ``mesh.log.staged``.  NCCL meshes
and CPU meshes run on the tensors where they are.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axis = Union[str, Tuple[str, ...]]

# The single-tensor collectives under their current names (older torch
# has only the ``*_tensor`` ones).
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

_STACK: List[object] = []


def push_mesh(mesh) -> None:
    """Make ``mesh`` the default of the ops (``with mesh:`` does this)."""
    _STACK.append(mesh)


def pop_mesh(mesh) -> None:
    """Undo :func:`push_mesh` for ``mesh``."""
    if not _STACK or _STACK[-1] is not mesh:
        raise RuntimeError("process meshes must be left in the order they "
                           "were entered")
    _STACK.pop()


def current_mesh(mesh=None):
    """``mesh``, or the innermost entered one.

    Raises:
        RuntimeError: no mesh given and none entered.
    """
    if mesh is not None:
        return mesh
    if not _STACK:
        raise RuntimeError("no process mesh: pass mesh= or run inside "
                           "`with mesh:`")
    return _STACK[-1]


def _axes(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_index(axis: str, *, mesh=None) -> int:
    """This rank's index on ``axis`` (``jax.lax.axis_index``)."""
    return current_mesh(mesh).axis_index(axis)


def axis_size(axis: Axis, *, mesh=None) -> int:
    """The number of ranks over ``axis`` (``jax.lax.psum(1, axis)``)."""
    m = current_mesh(mesh)
    n = 1
    for a in _axes(axis):
        n *= m.axis_size(a)
    return n


# --------------------------------------------------------------------- #
# The raw collectives (no autograd), with staging and counting.
# --------------------------------------------------------------------- #

def _stage(mesh, x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` where the backend runs: on the host for a staging mesh."""
    if mesh.stages_through_host and x.is_cuda:
        mesh.log.staged[kind] += _nbytes(x)
        return x.cpu()
    if mesh.backend == "nccl" and not x.is_cuda:
        raise ValueError(f"an NCCL mesh runs CUDA tensors, not {x.device}")
    return x


def _unstage(mesh, y: torch.Tensor, like: torch.Tensor,
             kind: str) -> torch.Tensor:
    if y.device != like.device:
        mesh.log.staged[kind] += _nbytes(y)
        return y.to(like.device)
    return y


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _copy(mesh, x: torch.Tensor, kind: str) -> torch.Tensor:
    """A contiguous copy of ``x`` where the backend runs (an in-place
    collective must not write into the caller's tensor)."""
    y = _stage(mesh, x, kind)
    return (y.clone() if y is x else y).contiguous()


def _all_reduce(mesh, x: torch.Tensor, axes: Tuple[str, ...], op,
                what: str) -> torch.Tensor:
    y = _copy(mesh, x, "all-reduce")
    for a in axes:
        mesh.log.add("all-reduce", (a,), _nbytes(x), 1, what)
        dist.all_reduce(y, op=op, group=mesh.groups[a])
    return _unstage(mesh, y, x, "all-reduce")


def _gather(mesh, x: torch.Tensor, axis: str, dim: int,
            tiled: bool) -> torch.Tensor:
    n = mesh.axis_size(axis)
    xs = _stage(mesh, x, "all-gather").reshape(-1).contiguous()
    out = xs.new_empty(n * xs.numel())
    mesh.log.add("all-gather", (axis,), n * _nbytes(x), 1, "all_gather")
    _ALL_GATHER(out, xs, group=mesh.groups[axis])
    out = _unstage(mesh, out, x, "all-gather").view((n,) + tuple(x.shape))
    if tiled:
        return torch.cat(out.unbind(0), dim=dim)
    return out.movedim(0, dim)


def _scatter(mesh, x: torch.Tensor, axis: str, dim: int,
             tiled: bool) -> torch.Tensor:
    n = mesh.axis_size(axis)
    size = x.shape[dim]
    if (tiled and size % n) or (not tiled and size != n):
        raise ValueError(f"psum_scatter over {axis!r} ({n} ranks): "
                         f"dimension {dim} has {size} elements")
    xs = _stage(mesh, x, "reduce-scatter")
    chunks = xs.movedim(dim, 0)
    if tiled:
        chunks = chunks.reshape((n, size // n) + tuple(chunks.shape[1:]))
    block = tuple(chunks.shape[1:])
    chunks = chunks.contiguous().reshape(-1)
    out = chunks.new_empty(chunks.numel() // n)
    mesh.log.add("reduce-scatter", (axis,), _nbytes(x), 1, "psum_scatter")
    _REDUCE_SCATTER(out, chunks, group=mesh.groups[axis])
    out = _unstage(mesh, out, x, "reduce-scatter").view(block)
    return out.movedim(0, dim) if tiled else out


def check_perm(perm: Sequence[Tuple[int, int]], n: int) -> None:
    """A permutation of ``(source, destination)`` axis indices: each in
    ``[0, n)``, no source and no destination twice.

    Raises:
        ValueError: otherwise.
    """
    srcs = [int(s) for s, _ in perm]
    dsts = [int(d) for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {list(perm)} is not a permutation of "
                         f"an axis of {n}")


def _permute(mesh, x: torch.Tensor, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    n = mesh.axis_size(axis)
    check_perm(perm, n)
    me = mesh.axis_index(axis)
    ranks = mesh.group_ranks[axis]
    group = mesh.groups[axis]
    xs = _stage(mesh, x, "collective-permute").contiguous()
    out = torch.zeros_like(xs)
    ops = []
    # Every rank posts its sends and receives in the order of ``perm``,
    # so the matching pairs line up on every rank.
    for s, d in perm:
        if s == me:
            ops.append(dist.P2POp(dist.isend, xs, ranks[d], group))
        if d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
    if any(s == me for s, _ in perm):
        mesh.log.add_sent("collective-permute", _nbytes(x), "ppermute")
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _unstage(mesh, out, x, "collective-permute")


# --------------------------------------------------------------------- #
# The differentiable ops.
# --------------------------------------------------------------------- #

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(mesh, x, axes, dist.ReduceOp.SUM, "psum")

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, ctx.mesh, ctx.axes), None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tiled):
        ctx.args = (mesh, axis, dim, tiled)
        return _gather(mesh, x, axis, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return (_PsumScatter.apply(g, *ctx.args), None, None, None, None)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tiled):
        ctx.args = (mesh, axis, dim, tiled)
        return _scatter(mesh, x, axis, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return (_AllGather.apply(g, *ctx.args), None, None, None, None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.inverse = tuple((d, s) for s, d in perm)
        return _permute(mesh, x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return (_Ppermute.apply(g, ctx.mesh, ctx.axis, ctx.inverse), None,
                None, None)


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.ndim if x.ndim else 0


def psum(x: torch.Tensor, axis: Axis, *, mesh=None) -> torch.Tensor:
    """Sum over the ranks of ``axis`` (``jax.lax.psum``); the backward
    sums the cotangents the same way."""
    return _Psum.apply(x, current_mesh(mesh), _axes(axis))


def pvary(x: torch.Tensor, axis: Axis, *, mesh=None) -> torch.Tensor:
    """``x`` itself, marked as used on every rank of ``axis``: its
    gradient is the sum of the ranks' (``jax.lax.pvary``, the transpose
    ``shard_map`` applies to a replicated operand)."""
    return _Pvary.apply(x, current_mesh(mesh), _axes(axis))


def pmax(x: torch.Tensor, axis: Axis, *, mesh=None) -> torch.Tensor:
    """Elementwise maximum over the ranks of ``axis`` (``jax.lax.pmax``).

    Raises:
        ValueError: for a tensor that requires a gradient (``pmax`` has no
            transpose here).
    """
    if x.requires_grad:
        raise ValueError("pmax has no gradient; detach its operand")
    return _all_reduce(current_mesh(mesh), x, _axes(axis),
                       dist.ReduceOp.MAX, "pmax")


def all_gather(x: torch.Tensor, axis: str, *, dim: int = 0,
               tiled: bool = False, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, in axis order
    (``jax.lax.all_gather``): stacked as a new dimension ``dim``, or, with
    ``tiled``, concatenated along ``dim``.  The backward is
    :func:`psum_scatter`."""
    m = current_mesh(mesh)
    d = dim % (x.ndim + (0 if tiled else 1))
    return _AllGather.apply(x, m, axis, d, tiled)


def psum_scatter(x: torch.Tensor, axis: str, *, scatter_dimension: int = 0,
                 tiled: bool = False, mesh=None) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, of which rank ``i`` keeps block
    ``i`` of ``scatter_dimension`` (``jax.lax.psum_scatter``): without
    ``tiled`` that dimension has one entry per rank and is removed; with
    ``tiled`` it is cut into equal blocks.  The backward is
    :func:`all_gather`."""
    m = current_mesh(mesh)
    return _PsumScatter.apply(x, m, axis, _dim(x, scatter_dimension), tiled)


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[Tuple[int, int]], *, mesh=None) -> torch.Tensor:
    """Send ``x`` from axis index ``s`` to ``d`` for each ``(s, d)`` of
    ``perm`` (``jax.lax.ppermute``); a rank no pair sends to gets zeros.
    The sends and receives go out in one ``batch_isend_irecv``.  The
    backward permutes the cotangents by the inverse ``perm``.

    Raises:
        ValueError: ``perm`` is not a permutation of the axis's indices.
    """
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _Ppermute.apply(x, current_mesh(mesh), axis, perm)


def broadcast(x: torch.Tensor, axis: str, src: int = 0, *,
              mesh=None) -> torch.Tensor:
    """Axis index ``src``'s ``x`` on every rank of ``axis`` (the other
    ranks' ``x`` give only the shape and dtype); no gradient.

    Raises:
        ValueError: for a tensor that requires a gradient.
    """
    if x.requires_grad:
        raise ValueError("broadcast has no gradient; detach its operand")
    m = current_mesh(mesh)
    y = _copy(m, x, "broadcast")
    if m.axis_index(axis) == src:
        m.log.add_sent("broadcast", _nbytes(x), "broadcast")
    dist.broadcast(y, m.group_ranks[axis][src], group=m.groups[axis])
    return _unstage(m, y, x, "broadcast")


def barrier(*, mesh=None) -> None:
    """Wait for every rank of the mesh (not counted)."""
    m = current_mesh(mesh)
    for a in m.axis_names:
        dist.barrier(group=m.groups[a])


__all__ = ["Axis", "all_gather", "axis_index", "axis_size", "barrier",
           "broadcast", "check_perm", "current_mesh", "pmax", "pop_mesh",
           "ppermute", "psum", "psum_scatter", "push_mesh", "pvary"]
