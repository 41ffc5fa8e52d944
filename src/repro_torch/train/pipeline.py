"""Pipeline parallelism (GPipe) over a ``"stage"`` axis of a process mesh.

The reference's ``repro.train.pipeline``: a stack of layer blocks is split
into S contiguous stages, stage ``s`` lives on the ranks of index ``s`` of
the ``stage`` axis, and microbatches stream through with ``ppermute``
hops between neighbours (``core.comm``).

Schedule: classic GPipe, ``T = n_micro + S - 1`` ticks; at tick ``t``
stage ``s`` runs microbatch ``t - s`` (bubble fraction ``(S - 1) / T``).
The last stage commits microbatch ``t - S + 1`` at tick ``t``, and a final
``psum`` over the stage axis gives every stage the outputs.  The backward
pipeline comes from autograd through the ``ppermute`` and ``psum``
functions, whose backwards are the inverse hops and the sum, as the
reference's comes from differentiating its ``lax.scan``; the activations of
every tick are held for it.

Every rank must run the backward of every hop, in the same order, or the
hops would not pair up across ranks; so every tick's value stays on the
path to the output on every rank, as the reference's ``jnp.where`` keeps
it.  One difference of execution, not of result: the reference's SPMD
program runs ``block_fn`` at every tick on every stage, the bubble ticks
on clipped or zero inputs whose results are never committed.  Here a
stage skips ``block_fn`` on a tick where it holds no microbatch and
passes on its input times zero, so a bubble is idle time and its
gradient, as in the reference, is zero.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from repro_torch.core import comm


def stage_perm(num_stages: int) -> List[Tuple[int, int]]:
    """The hops of one tick: stage ``i`` to stage ``i + 1``."""
    return [(i, i + 1) for i in range(num_stages - 1)]


def pipeline_apply(block_fn: Callable, stage_params, x_micro: torch.Tensor,
                   *, mesh, stage_axis: str = "stage") -> torch.Tensor:
    """Run microbatches through the pipeline's stages.

    Args:
        block_fn: ``(params_for_stage, x [mb, d]) -> [mb, d]``; it may
            close over modules (``params_for_stage`` is then whatever the
            caller passes, e.g. None).
        stage_params: this rank's stage's parameters (the reference passes
            the stacked ``[S, ...]`` tree and ``shard_map`` hands each
            stage its slice; here each rank holds its slice).
        x_micro: ``[n_micro, mb, d]`` microbatch stream, the same on
            every rank.
        mesh: a ``ProcessMesh`` with ``stage_axis``.

    Returns:
        ``[n_micro, mb, d]`` outputs of the last stage, on every stage.
    """
    S = comm.axis_size(stage_axis, mesh=mesh)
    sid = comm.axis_index(stage_axis, mesh=mesh)
    n_micro, mb, d = x_micro.shape
    T = n_micro + S - 1
    perm = stage_perm(S)
    # A leaf that asks for a gradient, so that the first hop is recorded
    # on every rank like the others.
    buf = x_micro.new_zeros((mb, d)).requires_grad_()
    outputs = [None] * n_micro
    for t in range(T):
        incoming = comm.ppermute(buf, stage_axis, perm, mesh=mesh)
        m = t - sid
        if sid == 0:
            x_in = x_micro[min(t, n_micro - 1)] + 0 * incoming
        else:
            x_in = incoming
        if 0 <= m < n_micro:
            buf = block_fn(stage_params, x_in)
            if sid == S - 1:
                outputs[m] = buf
        else:
            buf = 0 * x_in
    zero = x_micro.new_zeros((mb, d))
    stacked = torch.stack([o if o is not None else zero for o in outputs])
    # Only the last stage holds real outputs; the sum gives them to all.
    # The last tick's value joins with weight zero, so that its hop's
    # backward runs on every rank.
    return comm.psum(stacked + 0 * buf.sum(), stage_axis, mesh=mesh)


def split_stages(stacked_params, num_stages: int):
    """Reshape a ``[L, ...]`` layer-stacked tree (a tensor or a nested dict
    of them) to ``[S, L / S, ...]``."""
    def re(a):
        L = a.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers do not split into {num_stages} "
                             f"stages")
        return a.reshape((num_stages, L // num_stages) + tuple(a.shape[1:]))
    if isinstance(stacked_params, dict):
        return {k: split_stages(v, num_stages)
                for k, v in stacked_params.items()}
    return re(stacked_params)
