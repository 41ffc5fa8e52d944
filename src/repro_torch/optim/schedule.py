"""Learning-rate schedules (pure functions of the step counter)."""
from __future__ import annotations

import math
from typing import Union

import torch


def cosine_with_warmup(step, *, warmup_steps: int = 500,
                       total_steps: int = 100_000,
                       min_ratio: float = 0.1) -> Union[float, torch.Tensor]:
    """Linear warmup, then cosine decay to ``min_ratio``: a scale in [0, 1]
    multiplied into the base lr (step 0 gives 0).

    Computed in fp32 as the reference does.  A tensor ``step`` gives a 0-d
    fp32 tensor on its device (no host sync); a Python number gives a
    float.
    """
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = s / max(warmup_steps, 1)
    progress = torch.clamp((s - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(
        math.pi * progress))
    out = torch.where(s < warmup_steps, warm, cos)
    return out if isinstance(step, torch.Tensor) else float(out)
