"""Device meshes for the sharded SpMM tier (``repro_torch.sparse.shard``).

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
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

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
