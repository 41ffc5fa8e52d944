"""AdamW with decoupled weight decay and global-norm clipping (the
reference's ``repro.optim.adamw``, not ``torch.optim.AdamW``, whose decay,
clipping and state dtype differ).

Parameters, gradients and the state's ``mu`` / ``nu`` are nested dicts of
tensors with the same keys (a model's ``named_parameters()`` as a dict is
one level deep).  The math is the reference's, in fp32:

    g   = grad * min(1, clip / max(|grads|_2, 1e-9))
    mu  = b1 * mu + (1 - b1) * g,   nu = b2 * nu + (1 - b2) * g * g
    p  -= lr * lr_scale * (mu / c1 / (sqrt(nu / c2) + eps) + wd * p)

with ``c1 = 1 - b1 ** count``, ``c2 = 1 - b2 ** count`` after ``count``
is incremented, and weight decay on every leaf (norm scales, embedding and
router too).  ``mu`` and ``nu`` are stored in ``state_dtype``.  In a
partitioned step (``specs`` and a ``ProcessMesh``) each rank updates its
blocks with the same math; only the norm is global: each leaf's sum of
squares is summed over the axes its spec splits it on, and a replicated
leaf counts once.  Unlike the reference, which returns new trees,
:func:`apply_updates` writes the parameters and the state in place, leaf
by leaf, with in-place and fused elementwise ops (``addcmul_``, ``add_``
with ``alpha``) that may round once where the reference rounds twice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Union

import torch

from repro_torch.core.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"    # "bfloat16" => low-memory variant


def init_state(params: Dict, cfg: AdamWConfig) -> Dict:
    """Zero ``mu`` and ``nu`` in ``state_dtype`` beside each parameter, and
    ``count`` = 0 (int32, on the parameters' device)."""
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = next(p for _, p in leaves(params)).device
    return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads: Union[Dict, List[torch.Tensor]],
                specs: Optional[Dict] = None, mesh=None) -> torch.Tensor:
    """``sqrt(sum of every leaf's sum of squares)`` in fp32 (0-d).

    With ``specs`` (a dict of the leaves' specs, ``launch.sharding``) and
    ``mesh`` (a ``ProcessMesh``), ``grads`` (a dict) are this rank's
    blocks: the leaves' sums of squares are added up by the axes their
    specs split them on (those of size > 1), each group's total ``psum``-ed
    over its axes, in the same order on every rank; a replicated leaf,
    the same on every rank, counts once."""
    if specs is None:
        gs = [g for _, g in leaves(grads)] if isinstance(grads, dict) \
            else grads
        return torch.sqrt(functools.reduce(
            torch.add, (g.float().square().sum() for g in gs)))
    from repro_torch.core import comm
    from repro_torch.launch.sharding import spec_axes
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for key, g in leaves(grads):
        axes = tuple(a for a in spec_axes(specs[key]) if mesh.shape[a] > 1)
        groups.setdefault(axes, []).append(g.float().square().sum())
    total = None
    for axes in sorted(groups):
        part = functools.reduce(torch.add, groups[axes])
        if axes:
            part = comm.psum(part, axes, mesh=mesh)
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Dict, grads: Dict, state: Dict, cfg: AdamWConfig,
                  lr_scale: Union[float, torch.Tensor] = 1.0, *,
                  specs: Optional[Dict] = None, mesh=None
                  ) -> Dict[str, torch.Tensor]:
    """One AdamW step, in place on ``params`` and ``state`` (``grads`` are
    read only).  Returns ``{"grad_norm"}``, a 0-d fp32 tensor, computed on
    the device without a host sync.  With ``specs`` and ``mesh`` the
    leaves are this rank's blocks and the norm is global
    (:func:`global_norm`)."""
    ps = list(leaves(params))
    gs = dict(leaves(grads))
    mus, nus = dict(leaves(state["mu"])), dict(leaves(state["nu"]))
    if set(gs) != {k for k, _ in ps}:
        raise ValueError("apply_updates: grads and params hold other keys")
    gnorm = global_norm([gs[k] for k, _ in ps]) if specs is None else \
        global_norm({k: gs[k] for k, _ in ps}, specs, mesh)
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) /
                        torch.clamp(gnorm, min=1e-9), max=1.0)
    state["count"].add_(1)
    count = state["count"].float()
    c1 = 1.0 - torch.full_like(count, cfg.b1) ** count
    c2 = 1.0 - torch.full_like(count, cfg.b2) ** count
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=count.device)
    for key, p in ps:
        g = gs[key].float() * scale
        mu, nu = mus[key], nus[key]
        mu32 = mu if mu.dtype == torch.float32 else mu.float()
        nu32 = nu if nu.dtype == torch.float32 else nu.float()
        mu32.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu32.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        step = (mu32 / c1).div_((nu32 / c2).sqrt_().add_(cfg.eps))
        p32 = p if p.dtype == torch.float32 else p.float()
        step.add_(p32, alpha=cfg.weight_decay)
        p32.addcmul_(step, lr, value=-1.0)
        for own, wide in ((p, p32), (mu, mu32), (nu, nu32)):
            if wide is not own:
                own.copy_(wide)
    return {"grad_norm": gnorm}
