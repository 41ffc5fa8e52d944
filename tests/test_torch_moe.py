"""The port's MoE block path against the reference, on the CPU.

``repro_torch.launch.moe_block`` routes tokens with the reference's router
math (``repro.models.moe._router``: fp32 logits, softmax, top-k,
renormalise), lays the routed rows out by the rule of
``examples/moe_block_sparse.py`` (stable sort by expert, each expert padded
to whole ``bm`` blocks, an expert with no tokens keeps one block), and runs
the ``("grouped", "cuda")`` spec, which takes the kernel's plain version on
the CPU.  The same numpy inputs go through the reference's router and its
``("grouped", "pallas")`` spec (Pallas interpret mode).

Tolerance: both sides form the products exactly in fp32, sum in fp32 and
round once, so each is allowed ``4 * eps_f32 * (|x| @ |w|) + 5e-4`` and
the two may differ by one ulp of the output
(``moe_block.grouped_tolerance``).
"""
from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as ref_registry
from repro.models.moe import _router as ref_router

from repro_torch import kernels
from repro_torch.kernels import registry as port_registry
from repro_torch.launch import moe_block


def _inputs(T, K, E, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, K)).astype(np.float32),
            rng.normal(size=(E, K, N)).astype(np.float32),
            rng.normal(size=(K, E)).astype(np.float32))


def _example_blocks(x, experts, num_experts, bm):
    """The example's blocking rule, generalised to k slots per token:
    (token, slot) rows, stable-sorted by expert, padded per expert."""
    T, k = experts.shape
    flat = experts.reshape(-1)
    order = np.argsort(flat, kind="stable")
    blocks, gids, rows = [], [], np.empty(T * k, np.int64)
    start = 0
    for e in range(num_experts):
        seg = order[flat[order] == e]
        n_blocks = max(1, -(-len(seg) // bm))
        padded = np.zeros((n_blocks * bm, x.shape[1]), x.dtype)
        padded[:len(seg)] = x[seg // k]
        rows[seg] = start + np.arange(len(seg))
        blocks.append(padded)
        gids.extend([e] * n_blocks)
        start += n_blocks * bm
    return (np.concatenate(blocks), np.asarray(gids, np.int32),
            rows.reshape(T, k))


@pytest.mark.parametrize("k", [1, 2, 8])
def test_router_matches_reference(k):
    x, _, router = _inputs(64, 32, 16, 8, seed=k)
    ref_w, ref_ids = ref_router({"kernel": jnp.asarray(router)},
                                jnp.asarray(x), k)
    w, ids = moe_block.route(torch.from_numpy(x), torch.from_numpy(router),
                             k)
    assert ids.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("bm", [32, 128])
@pytest.mark.parametrize("k", [1, 2])
def test_blocking_follows_the_example_rule(k, bm):
    E = 8
    x, _, router = _inputs(300, 16, E, 8, seed=10 * k + bm)
    routed = moe_block.route_and_block(
        torch.from_numpy(x), torch.from_numpy(router), num_experts=E, k=k,
        bm=bm)
    _, ref_ids = ref_router({"kernel": jnp.asarray(router)},
                            jnp.asarray(x), k)
    xb, gids, rows = _example_blocks(x, np.asarray(ref_ids), E, bm)
    np.testing.assert_array_equal(routed.x.numpy(), xb)
    np.testing.assert_array_equal(routed.group_ids.numpy(), gids)
    np.testing.assert_array_equal(routed.rows.numpy(), rows)
    np.testing.assert_array_equal(routed.experts.numpy(), np.asarray(ref_ids))
    assert routed.group_ids.dtype == torch.int32
    assert routed.x.shape[0] == bm * routed.group_ids.shape[0]


def test_an_expert_with_no_tokens_keeps_one_block():
    x, _, router = _inputs(40, 16, 4, 8, seed=3)
    x = np.abs(x) + 0.1
    router[:, 2] = 10.0                            # expert 2 wins every token
    routed = moe_block.route_and_block(
        torch.from_numpy(x), torch.from_numpy(router), num_experts=4, k=1,
        bm=16)
    assert routed.group_ids.tolist() == [0, 1, 2, 2, 2, 3]
    assert set(routed.experts.reshape(-1).tolist()) == {2}
    xb = routed.x.numpy()
    assert not xb[:32].any() and not xb[80:].any()   # empty experts
    np.testing.assert_array_equal(xb[32:72], x)      # stable token order
    assert not xb[72:80].any()                       # block padding


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,bm", [(1, 128), (2, 64)])
def test_moe_path_through_grouped_spec_matches_jax_spec(k, bm, dtype):
    E, T, K, N = 8, 256, 128, 128
    x, w, router = _inputs(T, K, E, N, seed=k)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    routed = moe_block.route_and_block(xt, torch.from_numpy(router),
                                       num_experts=E, k=k, bm=bm)
    operand = (wt, routed.group_ids, bm, 64, 128)
    spec = port_registry.get("grouped", "cuda")
    ctx = port_registry.KernelContext(device=torch.device("cpu"))
    before = kernels.launch_counts()
    out = spec.bind(operand, ctx)(routed.x)
    assert kernels.launch_counts() == before
    assert out.dtype == tdt and out.shape == (routed.x.shape[0], N)

    # The reference spec on the reference's own routing of the same x.
    _, ref_ids = ref_router({"kernel": jnp.asarray(router)},
                            jnp.asarray(xt.float().numpy()).astype(jdt), k)
    xb, gids, rows = _example_blocks(xt.float().numpy(), np.asarray(ref_ids),
                                     E, bm)
    ref_spec = ref_registry.get("grouped", "pallas")
    ref_out = np.asarray(ref_spec.bind(
        (jnp.asarray(w).astype(jdt), jnp.asarray(gids), bm, 64, 128),
        ref_registry.KernelContext())(jnp.asarray(xb).astype(jdt)),
        np.float32)
    np.testing.assert_array_equal(routed.group_ids.numpy(), gids)
    np.testing.assert_array_equal(routed.rows.numpy(), rows)

    aw = np.abs(wt.float().numpy().astype(np.float64))
    ax = np.abs(xb.astype(np.float64))
    absprod = torch.from_numpy(np.concatenate(
        [ax[i * bm:(i + 1) * bm] @ aw[g] for i, g in enumerate(gids)]))
    got, ref = out.double(), torch.tensor(ref_out, dtype=torch.float64)
    bound = moe_block.grouped_tolerance(absprod, tdt, got, ref)
    assert bool(((got - ref).abs() <= bound).all()), \
        float(((got - ref).abs() - bound).max())
    assert moe_block.expert_error(xt, wt, routed, out) >= 0.0
    # The same bound rejects the output of a kernel that drops a k-slice.
    cut = routed.x.clone()
    cut[:, :32] = 0
    bad = spec.bind(operand, ctx)(cut).double()
    assert not bool(((bad - ref).abs() <= bound).all())
    # The port's estimate is the reference's under the same hardware.
    port_roof = spec.estimate(operand, N, port_registry.KernelContext())
    ref_roof = ref_spec.estimate(
        (np.asarray(w), gids, bm, 64, 128), N,
        ref_registry.KernelContext(hardware=ref_registry.HOST_CPU))
    assert port_roof.ai == ref_roof.ai
    assert port_roof.attainable_flops_per_s == \
        ref_roof.attainable_flops_per_s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_check_catches_a_wrong_row(dtype):
    # w scaled by 1/sqrt(K), as the model's weights: |x| @ |w| is ~15 here
    # while |out| is ~1, so a bound scaled by eps_bf16 * |x| @ |w| would let
    # both faults below through.
    K = 512
    x, w, router = _inputs(64, K, 4, 32, seed=5)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    wt = (torch.from_numpy(w) * K ** -0.5).to(tdt)
    routed = moe_block.route_and_block(xt, torch.from_numpy(router),
                                       num_experts=4, k=2, bm=32)
    run = port_registry.get("grouped", "cuda").bind(
        (wt, routed.group_ids, 32, 32, 32), port_registry.KernelContext())
    out = run(routed.x)
    assert moe_block.expert_error(xt, wt, routed, out) < (
        1e-4 if dtype == "float32" else 0.05)
    bad = out.clone()
    bad[int(routed.rows[7, 1])] += 0.1
    with pytest.raises(ValueError, match="breaks the bound"):
        moe_block.expert_error(xt, wt, routed, bad)
    cut = routed.x.clone()
    cut[:, :32] = 0                                 # a dropped k-slice
    with pytest.raises(ValueError, match="breaks the bound"):
        moe_block.expert_error(xt, wt, routed, run(cut))
    padding_rows = sorted(set(range(out.shape[0]))
                          - set(routed.rows.reshape(-1).tolist()))
    pad = out.clone()
    pad[padding_rows[0]] = 1.0
    with pytest.raises(ValueError, match="padding row"):
        moe_block.expert_error(xt, wt, routed, pad)


def test_main_runs_the_example_defaults_on_cpu(capsys):
    rec = moe_block.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "grouped matmul OK" in out and "nvidia-h100-sxm" in out
    assert rec["routed"].x.shape[0] % 128 == 0
    assert rec["routed"].group_ids.shape[0] == rec["routed"].x.shape[0] // 128
    assert rec["out"].shape == (rec["routed"].x.shape[0], 128)
    assert rec["roofline"].mxu_utilization == 1.0
    args = moe_block.parser().parse_args([])
    assert (args.experts, args.d_model, args.d_ff, args.tokens, args.top_k,
            args.bm, args.device) == (8, 64, 128, 1024, 1, 128, "cuda")


def test_main_needs_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        moe_block.main([])


def test_inputs_come_from_the_seed():
    args = types.SimpleNamespace(tokens=8, d_model=16, experts=2, d_ff=8,
                                 dtype="bfloat16", seed=4)
    a = moe_block.make_inputs(args, torch.device("cpu"))
    b = moe_block.make_inputs(args, torch.device("cpu"))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert a[0].dtype == a[1].dtype == torch.bfloat16
    assert a[2].dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,K,N,ok", [
    (64, 192, 384, True), (128, 4096, 1536, True), (256, 64, 128, True),
    (32, 128, 128, False), (128, 96, 128, False), (128, 128, 192, False)])
def test_cuda_operand_check_states_the_tiles(dtype, bm, K, N, ok):
    """The CUDA kernels tile by bm % 64, K % 64 and N % 128; the check is
    plain Python, so it runs here on CPU tensors."""
    from repro_torch.kernels import grouped_matmul as gm
    x = torch.zeros(2 * bm, K, dtype=dtype)
    w = torch.zeros(2, K, N, dtype=dtype)
    gids = torch.zeros(2, dtype=torch.int32)
    if ok:
        gm._check_cuda_operands(x, w, gids, bm)
    else:
        with pytest.raises(ValueError, match="bm % 64, K % 64 and N % 128"):
            gm._check_cuda_operands(x, w, gids, bm)
    assert gm.tile_rows(bm) == (128 if bm % 128 == 0 else 64)
