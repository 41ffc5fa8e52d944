"""The port's partitioned train step against the reference's
``make_train_step(cfg, shape, mesh)`` on four host devices, for reduced
qwen2-vl-7b (``tests/_gspmd.py`` runs both): ``mm_proj`` column-parallel,
its output gathered before each rank takes its rows of the first
``N_MM`` (12 patch embeddings per row, which cross a block boundary on
``model=4``), and M-RoPE on the rank's columns of ``positions_3d``.

Cases, each three fp32 steps (1, 2, 3 of the schedule) at batch 4 x 32,
on the batches' ``mm_embeds`` and ``positions_3d``: ``(data=2,
model=2)``, ``(1, 4)`` (2 kv heads over 4 ranks), ``(4, 1)``,
``(pod=2, 1, 2)``, and 2 heads on ``(1, 4)`` (the context-parallel
fallback: each block of the queries takes its columns of the positions).
Also: ``grad_accum`` > 1 on a batch with ``positions_3d`` is refused by
both packages (the micro-batches split every entry along its first axis,
and the positions are ``[3, B, S]``).

Each rank's blocks are held against the reference's shards on the device
at the same mesh position: the specs and indices exactly, the loss,
``grad_norm`` and ``lr_scale`` by ``_check_metrics``, the parameters after
each step by the element rule, ``mu`` and ``nu`` within what the
gradients' agreement allows (``tests/_gspmd.py``).
"""
from __future__ import annotations

import pytest

from _gspmd import (case, check_blocks_placed, check_metrics_all_ranks,
                    check_opt_state, check_params_per_step, check_specs,
                    run_module)
from _gspmd_ranks import train_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401

ARCH = "qwen2-vl-7b"
CASES = [
    case("vlm-2x2", ARCH, (2, 2)),
    case("vlm-1x4", ARCH, (1, 4)),
    case("vlm-4x1", ARCH, (4, 1)),
    case("vlm-pod", ARCH, (2, 1, 2), ("pod", "data", "model")),
    case("vlm-heads2-1x4", ARCH, (1, 4), overrides={"num_heads": 2}),
]
NAMES = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_module(CASES, train_rank, tmp_path_factory.mktemp("gspmd"))


def test_reference_and_world_stay_inside_their_limits(runs):
    assert runs["world_s"] < 180.0 and runs["seconds"] < 240.0


@pytest.mark.parametrize("name", NAMES)
def test_specs_equal_the_reference(runs, name):
    check_specs(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_blocks_are_the_reference_shards(runs, name):
    check_blocks_placed(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_metrics_match_on_every_rank(runs, name):
    check_metrics_all_ranks(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_blocks_match_after_each_step(runs, name):
    check_params_per_step(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_optimiser_blocks_match_after_each_step(runs, name):
    check_opt_state(runs, name)


def test_grad_accum_with_mrope_positions_is_refused_by_both():
    import jax.numpy as jnp
    import numpy as np
    import torch

    from _gspmd import batch
    from _torch_train_helpers import _weights
    from repro.configs.base import ShapeConfig as RefShape
    from repro.configs.base import get_config as ref_config
    from repro.optim import adamw as ref_adamw
    from repro.train import train_step as ref_ts
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    rcfg = ref_config(ARCH).reduced()
    b = batch(rcfg, 0)
    assert b["positions_3d"].shape == (3, 4, 32)
    params = _weights(rcfg)
    fn, _ = ref_ts.make_train_step(rcfg, RefShape("t", 32, 4, "train"),
                                   grad_accum=2)
    with pytest.raises(TypeError, match="reshape"):
        fn(params, ref_adamw.init_state(params, ref_adamw.AdamWConfig()),
           {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(1))
    cfg = get_config(ARCH).reduced()
    model = interop.params_from_numpy(cfg, params, masters=True)
    step = TS.make_train_step(cfg, ShapeConfig("t", 32, 4, "train"),
                              grad_accum=2)
    opt = adamw.init_state(dict(model.named_parameters()),
                           adamw.AdamWConfig())
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    with pytest.raises(ValueError, match="positions_3d"):
        step(model, opt, tensors, 1)
    # Without the positions (1-D RoPE) the micro-batches split as usual.
    del tensors["positions_3d"]
    assert np.isfinite(float(step(model, opt, tensors, 1)["loss"]))
