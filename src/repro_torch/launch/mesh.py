"""Device meshes for the sharded SpMM tier (``repro_torch.sparse.shard``),
the abstract meshes of the dry run (:class:`AbstractMesh`,
:func:`make_production_mesh`, :func:`make_host_mesh`: named axes and
sizes, no devices; ``launch.sharding`` and ``launch.dryrun`` read them),
and the process mesh of the multi-card runtime (:class:`ProcessMesh`,
:func:`make_process_mesh`: one process per rank over ``torch.distributed``,
the collectives of ``core.comm`` on its named axes).

A :class:`ShardMesh` is a 1-D tuple of ``torch.device`` s along the axis
``"shard"``; a :class:`~repro_torch.sparse.shard.ShardedPlan` puts shard
``i`` on ``mesh.devices[i]`` and runs every shard from one process.

    mesh = make_shard_mesh()                 # every visible card
    mesh = ShardMesh(["cuda:0"] * 4)         # four shards on one card
    mesh = ShardMesh(["cpu"] * 4)            # four shards on the CPU

A mesh built by hand may repeat a device: that is how one card or the CPU
carries several shards, as the reference's virtual host devices
(``--xla_force_host_platform_device_count``) do.  Building a mesh touches
no device state.

A :class:`ProcessMesh` is what the reference's ``jax.make_mesh`` is to its
``shard_map`` programs: every process of a ``torch.distributed`` world is
one rank, laid out row-major over the named axes, with one process group
per axis (the ranks that differ only in that axis):

    mesh = make_process_mesh((2, 2), ("data", "model"), device="cpu")
    with mesh:                      # core.comm's ops default to it
        y = comm.psum(x, "model")

Ranks come from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) or from
:func:`repro_torch.launch.spawn.run_world`, which spawns a world on one
host.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core.device import DeviceLike, resolve_device

#: The mesh axis the sharded tier executes over.
SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True, init=False)
class ShardMesh:
    """A 1-D mesh of devices along :data:`SHARD_AXIS`.

    Attributes:
        devices: shard ``i``'s device, in shard order; may repeat.
        axis_name: always :data:`SHARD_AXIS`.
    """

    devices: Tuple[torch.device, ...]
    axis_name: str

    def __init__(self, devices: Iterable[DeviceLike]):
        """Args:
            devices: one device (``torch.device`` or a string such as
                ``"cuda:1"``) per shard; at least one.

        Raises:
            ValueError: on an empty device list.
        """
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a ShardMesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_name", SHARD_AXIS)

    @property
    def size(self) -> int:
        """Number of shards D."""
        return len(self.devices)


def make_shard_mesh(num_shards: Optional[int] = None,
                    device: DeviceLike = None) -> ShardMesh:
    """A mesh over distinct visible devices of one type.

    Args:
        num_shards: devices to use; defaults to every visible one.
        device: the device type to take (``"cuda"`` by default, the card;
            ``"cpu"`` is one device).

    Returns:
        A :class:`ShardMesh` over the first ``num_shards`` devices.

    Raises:
        RuntimeError: when the card is asked for and there is none.
        ValueError: when more shards are requested than devices exist (on
            one card or the CPU, build ``ShardMesh([dev] * N)`` instead).
    """
    kind = resolve_device(device).type
    if kind == "cuda":
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        visible = [torch.device(kind)]
    if num_shards is None:
        num_shards = len(visible)
    if num_shards > len(visible):
        raise ValueError(
            f"requested {num_shards} shards but only {len(visible)} "
            f"{kind} devices are visible (a mesh that repeats a device, "
            f"ShardMesh([{kind!r}] * {num_shards}), puts several shards "
            f"on one)")
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return ShardMesh(visible[:num_shards])


# ---------------------------------------------------------------------------
# Abstract meshes for the dry run.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A named device mesh that touches no device: ``axis_names`` in
    order and ``shape`` (axis name -> size), as a ``jax.sharding.Mesh``
    reports them.  The sharding policy (``launch.sharding``) and the dry
    run read it; nothing executes on it."""

    axis_names: Tuple[str, ...]
    shape: dict

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


def abstract_mesh(shape: Tuple[int, ...],
                  axis_names: Tuple[str, ...]) -> AbstractMesh:
    """An :class:`AbstractMesh` of ``shape`` over ``axis_names``."""
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes "
                         f"{axis_names}")
    return AbstractMesh(tuple(axis_names), dict(zip(axis_names, shape)))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The H100 production mesh: ``(data=32, model=8)``, 256 cards, or
    ``(pod=2, data=32, model=8)``, 512 cards.

    The model (tensor-parallel) axis is 8 so that it stays inside one
    8-card NVLink node, where every card reaches every other at 450 GB/s
    each way; data parallelism (FSDP) and the pods span nodes.  The
    reference's 16 x 16 mesh was a TPU torus, where both axes ride the
    same interconnect.
    """
    if multi_pod:
        return abstract_mesh((2, 32, 8), ("pod", "data", "model"))
    return abstract_mesh((32, 8), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1) -> AbstractMesh:
    """A ``(data, model)`` mesh clamped to the cards that are visible (1
    on a one-card machine).

    Raises:
        RuntimeError: when no card is visible.
    """
    resolve_device("cuda")
    n = torch.cuda.device_count()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return abstract_mesh((data, model), ("data", "model"))


# ---------------------------------------------------------------------------
# Process meshes: one rank per process over torch.distributed.
# ---------------------------------------------------------------------------

#: The backends a process mesh may run on.
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(eq=False)
class ProcessMesh:
    """This rank's view of a mesh of processes.

    Ranks are laid out row-major over ``axis_names`` (the last axis
    fastest), as ``jax.make_mesh`` lays out devices, so a rank's
    coordinate on an axis is its index in that axis's group.

    Attributes:
        axis_names: the axes, in order.
        shape: axis name -> size (as ``jax.sharding.Mesh.shape``).
        coords: axis name -> this rank's index on it.
        rank: this process's rank in the world.
        device: where this rank computes (``cuda:i`` or the CPU).
        backend: ``"nccl"`` or ``"gloo"``, the backend of every axis group.
        groups: axis name -> the process group of this rank's ranks along
            that axis.
        group_ranks: axis name -> the world ranks of that group, in axis
            index order.
        log: the collectives this rank has made on the mesh
            (``core.collectives.CollectiveLog``; ``core.comm`` adds to it).
    """

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int
    device: torch.device
    backend: str
    groups: dict
    group_ranks: Dict[str, Tuple[int, ...]]
    log: object

    @property
    def size(self) -> int:
        """Ranks in the mesh."""
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    @property
    def stages_through_host(self) -> bool:
        """Whether collectives copy CUDA payloads through the host: a gloo
        mesh of CUDA ranks (several ranks on one card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def axis_index(self, axis: str) -> int:
        """This rank's index on ``axis``."""
        return self.coords[self._axis(axis)]

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``."""
        return self.shape[self._axis(axis)]

    def _axis(self, axis: str) -> str:
        if axis not in self.shape:
            raise ValueError(f"the mesh has axes {self.axis_names}, not "
                             f"{axis!r}")
        return axis

    def reset_log(self):
        """Start a fresh :attr:`log`; returns it."""
        from repro_torch.core.collectives import CollectiveLog
        self.log = CollectiveLog(self)
        return self.log

    def __enter__(self) -> "ProcessMesh":
        from repro_torch.core import comm
        comm.push_mesh(self)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.core import comm
        comm.pop_mesh(self)


def mesh_coords(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The row-major coordinate of ``rank`` on a mesh of ``shape``."""
    out = []
    for size in reversed(shape):
        out.append(rank % size)
        rank //= size
    return tuple(reversed(out))


def axis_groups(shape: Tuple[int, ...], axis: int) -> list:
    """The world ranks of every group along ``axis`` (the ranks that differ
    only in that coordinate), each in axis-index order; the groups in the
    order of their smallest rank."""
    world = 1
    for s in shape:
        world *= s
    groups: Dict[tuple, list] = {}
    for r in range(world):
        c = mesh_coords(r, shape)
        groups.setdefault(c[:axis] + c[axis + 1:], []).append(r)
    return [groups[k] for k in sorted(groups, key=lambda k: groups[k][0])]


def choose_backend(device: torch.device, world: int,
                   local_rank: int) -> str:
    """The backend for ranks on ``device``: gloo on the CPU; NCCL when each
    rank has a card of its own (rank ``i`` of a host on ``cuda:i``).

    Raises:
        ValueError: for CUDA ranks that share a card (NCCL refuses two
            ranks on one device): the caller must ask for gloo, whose
            collectives stage CUDA payloads through the host.
    """
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"a process mesh runs on CUDA or the CPU, not "
                         f"{device}")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if world <= torch.cuda.device_count() and index == local_rank:
        return "nccl"
    raise ValueError(
        f"rank {local_rank} of {world} is on {device}: the ranks share "
        f"cards, which NCCL refuses; pass backend=\"gloo\" (its "
        f"collectives stage CUDA payloads through the host)")


def make_process_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                      *, device: DeviceLike,
                      backend: Optional[str] = None) -> ProcessMesh:
    """This rank's :class:`ProcessMesh` over the ``torch.distributed``
    world, which it joins first if it has not yet (``init_method="env://"``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, as
    ``torchrun`` and ``launch.spawn.run_world`` set them).

    Every rank of the world must call it with the same arguments, in the
    same order as its other meshes: each axis group is made collectively.
    One collective per axis group runs at the end, so a backend that
    cannot start (NCCL on ranks that share a card) fails here.

    Args:
        shape, axis_names: the mesh; the product of ``shape`` is the
            world size.
        device: this rank's device (``"cuda:i"`` or ``"cpu"``; the card
            when None).
        backend: ``"nccl"`` or ``"gloo"``; None picks
            :func:`choose_backend`'s.  A failure to start raises: the mesh
            never swaps backends.

    Raises:
        ValueError: on a shape that does not match the axes or the world,
            an unknown backend, or CUDA ranks sharing a card without an
            explicit backend.
        RuntimeError: outside a world (no ``RANK`` / ``WORLD_SIZE``).
    """
    import torch.distributed as dist
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != \
            len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes "
                         f"{axis_names}")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL runs CUDA ranks only")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    else:
        raise RuntimeError("no torch.distributed world: run under torchrun "
                           "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or "
                           "launch.spawn.run_world")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend is None:
        backend = choose_backend(dev, world, local_rank)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"a {shape} mesh has {size} ranks, the world "
                         f"{world}")
    coords = mesh_coords(rank, shape)
    groups, group_ranks = {}, {}
    for i, axis in enumerate(axis_names):
        enum = axis_groups(shape, i)
        mine, _ = dist.new_subgroups_by_enumeration(enum, backend=backend)
        groups[axis] = mine
        group_ranks[axis] = tuple(next(g for g in enum if rank in g))
    mesh = ProcessMesh(axis_names=axis_names,
                       shape=dict(zip(axis_names, shape)),
                       coords=dict(zip(axis_names, coords)), rank=rank,
                       device=dev, backend=backend, groups=groups,
                       group_ranks=group_ranks, log=None)
    mesh.reset_log()
    for axis in axis_names:          # start every communicator now
        probe = torch.ones(1, device="cpu" if mesh.stages_through_host
                           else dev)
        dist.all_reduce(probe, group=groups[axis])
        if int(probe.item()) != mesh.shape[axis]:
            raise RuntimeError(f"the {axis!r} group summed {probe.item()} "
                               f"ranks, expected {mesh.shape[axis]}")
    return mesh
