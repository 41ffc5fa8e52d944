"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]

#: What brings work that spans several cards (a mesh, a cross-device
#: reduction, pipeline stages); the port raises ``NotImplementedError``
#: naming it.
MULTI_CARD = "the multi-card item (ROADMAP.md Queue A, \"Multi-card item\")"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means the card (``"cuda"``).  A CUDA device that is not
    present raises; only an explicit ``device="cpu"`` runs on the CPU.

    Raises:
        RuntimeError: when a CUDA device is requested (or defaulted to)
            and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device=\"cpu\" to run the plain PyTorch path "
            "on the CPU")
    return dev


def device_of(device: Optional[torch.device]) -> torch.device:
    """``device`` itself, or the CPU when it is ``None`` (internal use)."""
    return torch.device("cpu") if device is None else torch.device(device)


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn: Callable[[], object], runs: int) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` (in ms) after one
    warm call; ``fn`` runs on the current CUDA stream."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]
