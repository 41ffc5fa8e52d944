"""gemma3-12b's prefill_32k cell of the dry run at full size, on both
production meshes (the checks of ``tests/test_torch_dryrun_cells.py``,
whose other cells count faster: this one runs 64 x 32 attention tiles per
global layer on ``meta`` tensors)."""
from __future__ import annotations

import pytest

from _torch_train_helpers import one_torch_thread  # noqa: F401
from test_torch_dryrun_cells import check_cell


@pytest.mark.parametrize("multi_pod", [False, True])
def test_gemma3_prefill_cell(multi_pod):
    check_cell("gemma3-12b", "prefill_32k", multi_pod)
