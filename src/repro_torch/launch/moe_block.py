"""MoE expert FFN as a block-diagonal SpMM: route, block, grouped matmul.

Route a token batch with a top-k router, sort the routed (token, slot)
rows by expert into blocks of ``bm`` rows, run the ``("grouped", "cuda")``
kernel spec, check every routed row against its expert's dense product,
and print the roofline placement on the H100:

    PYTHONPATH=src python -m repro_torch.launch.moe_block --device cpu
    PYTHONPATH=src python -m repro_torch.launch.moe_block \\
        --tokens 4096 --experts 128 --top-k 8 --d-model 4096 --d-ff 1536 \\
        --bk 128 --dtype bfloat16          # qwen3-moe-235b-a22b widths

The defaults are a small demo (8 experts, 64 -> 128, 1024 tokens, top-1,
bm = 128).  It runs on the card unless ``--device cpu`` is given; the
inputs are drawn from ``--seed`` by a ``torch.Generator`` on that device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.hardware import H100

ATOL = RTOL = 5e-4
#: eps of fp32, the grouped matmul's accumulator type: products of fp32 or
#: bf16 operands are exact in fp32 and summed there.
EPS_F32 = float(torch.finfo(torch.float32).eps)


@dataclasses.dataclass(frozen=True)
class RoutedBlocks:
    """The routed token rows, sorted by expert and padded to whole blocks.

    Expert ``e``'s rows are contiguous, in (token, slot) order, and padded
    with zero rows up to a multiple of ``bm``; an expert with no tokens
    still owns one all-zero block.  Experts appear in ascending order.
    """

    x: torch.Tensor          # [R, K] block-aligned rows, R % bm == 0
    group_ids: torch.Tensor  # [R // bm] int32 expert of each row block
    rows: torch.Tensor       # [T, k] int64 row of x per (token, slot)
    experts: torch.Tensor    # [T, k] int32 expert per (token, slot)


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k routing in fp32: softmax of ``x @ router``, the ``k`` largest
    probabilities renormalised to sum to 1.

    Returns ``(weights [T, k] float32, experts [T, k] int32)``.
    """
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return weights, ids.to(torch.int32)


def route_and_block(x: torch.Tensor, router: torch.Tensor, *,
                    num_experts: int, k: int, bm: int) -> RoutedBlocks:
    """Route ``x [T, K]`` to ``k`` experts each and lay the routed rows out
    for the grouped matmul.

    Each routed (token, slot) pair is one row; rows are stable-sorted by
    expert, and every expert's rows are padded up to a multiple of ``bm``.
    """
    T, K = x.shape
    _, experts = route(x, router, k)
    flat = experts.reshape(-1).long()                        # [T*k]
    counts = torch.bincount(flat, minlength=num_experts)
    blocks = torch.clamp((counts + bm - 1) // bm, min=1)
    first_row = (torch.cumsum(blocks, 0) - blocks) * bm      # per expert
    first_pair = torch.cumsum(counts, 0) - counts            # in sorted order
    order = torch.sort(flat, stable=True).indices
    ranks = torch.arange(flat.numel(), device=x.device) - \
        first_pair[flat[order]]
    rows = torch.empty_like(flat)
    rows[order] = first_row[flat[order]] + ranks
    total = int(blocks.sum()) * bm
    buf = torch.zeros(total, K, dtype=x.dtype, device=x.device)
    buf[rows] = x.repeat_interleave(k, dim=0)
    group_ids = torch.repeat_interleave(
        torch.arange(num_experts, dtype=torch.int32, device=x.device), blocks)
    return RoutedBlocks(x=buf, group_ids=group_ids, rows=rows.reshape(T, k),
                        experts=experts)


def make_inputs(args, device: torch.device):
    """``(x [T, K], w [E, K, N], router [K, E])`` drawn from ``args.seed``:
    x and w in ``args.dtype``, w scaled by ``1/sqrt(K)``, router in fp32."""
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x = torch.randn(args.tokens, args.d_model, generator=gen, device=device,
                    dtype=dtype)
    w = torch.randn(args.experts, args.d_model, args.d_ff, generator=gen,
                    device=device, dtype=dtype).mul_(args.d_model ** -0.5)
    router = torch.randn(args.d_model, args.experts, generator=gen,
                         device=device)
    return x, w, router


def grouped_tolerance(absprod: torch.Tensor, dtype: torch.dtype,
                      got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Allowed ``|got - ref|`` between two computed grouped-matmul outputs
    in ``dtype``, elementwise.

    Each side sums exact fp32 products in fp32 (``4 * eps_f32 * (|x| @
    |w|) + ATOL``) and rounds once to ``dtype``.  Two such roundings differ
    by at most one ulp of the output, which ``eps(dtype) * (|got| + |ref|)``
    covers (``RTOL`` where that is larger).
    """
    rel = max(RTOL, float(torch.finfo(dtype).eps))
    return 2 * (4 * EPS_F32 * absprod + ATOL) + rel * (got.abs() + ref.abs())


def expert_error(x: torch.Tensor, w: torch.Tensor, routed: RoutedBlocks,
                 out: torch.Tensor) -> float:
    """Hold every routed row of ``out`` against ``x[token] @ w[expert]``
    in fp32, and every padding row against 0.

    Bound: ``8 * eps_f32 * (|x| @ |w|) + ATOL + max(RTOL, eps / 2) *
    |expect|``, eps of the operand dtype.  The kernel and the check each
    sum exact fp32 products in fp32; the kernel then rounds once to the
    operand dtype, by at most half an ulp.  Returns the largest
    ``|out - expect|``.

    Raises:
        ValueError: when a row breaks the bound.
    """
    rel = max(RTOL, float(torch.finfo(x.dtype).eps) / 2)
    k = routed.rows.shape[1]
    tokens = torch.arange(x.shape[0], device=x.device).repeat_interleave(k)
    rows = routed.rows.reshape(-1)
    experts = routed.experts.reshape(-1).long()
    worst = 0.0
    for e in torch.unique(experts).tolist():
        sel = experts == e
        xs, we = x[tokens[sel]].float(), w[e].float()
        expect = xs @ we
        bound = 8 * EPS_F32 * (xs.abs() @ we.abs()) + ATOL + \
            rel * expect.abs()
        err = (out[rows[sel]].float() - expect).abs()
        if bool((err > bound).any()) or not bool(torch.isfinite(err).all()):
            raise ValueError(f"expert {e}: |out - x @ w| up to "
                             f"{float(err.max()):.3e} breaks the bound")
        worst = max(worst, float(err.max()))
    padding = torch.ones(out.shape[0], dtype=torch.bool, device=out.device)
    padding[rows] = False
    if bool(out[padding].any()):
        raise ValueError("a padding row of the grouped output is not zero")
    return worst


def run(args) -> dict:
    """Route, block and run the grouped matmul spec once; check the rows.

    Returns a record: ``x``, ``w``, ``routed``, ``out``, ``roofline`` (the
    spec's placement on the H100), ``max_abs_err`` (against the experts'
    dense products), ``route_ms`` and ``matmul_ms`` (host clock with a
    device synchronise; the first call includes the kernel's load).
    """
    from repro_torch.kernels import registry
    device = resolve_device(args.device)
    x, w, router = make_inputs(args, device)
    synchronize(device)
    t0 = time.perf_counter()
    routed = route_and_block(x, router, num_experts=args.experts,
                             k=args.top_k, bm=args.bm)
    synchronize(device)
    t1 = time.perf_counter()
    operand = (w, routed.group_ids, args.bm, args.bk, args.bn)
    spec = registry.get("grouped", "cuda")
    ctx = registry.KernelContext(hardware=H100, device=device)
    out = spec.bind(operand, ctx)(routed.x)
    synchronize(device)
    t2 = time.perf_counter()
    roof = spec.estimate(operand, args.d_ff, ctx)
    err = expert_error(x, w, routed, out)
    rows = routed.x.shape[0]
    print(f"{args.tokens} tokens x top-{args.top_k} routed to "
          f"{args.experts} experts on {device}: buffer {rows} rows "
          f"({rows - args.tokens * args.top_k} block padding), "
          f"{args.d_model} -> {args.d_ff} in {args.dtype}")
    print(f"grouped matmul OK: max |out - x @ w[expert]| = {err:.3e}; "
          f"route {1e3 * (t1 - t0):.1f} ms, matmul {1e3 * (t2 - t1):.1f} ms")
    print(f"roofline on {ctx.hardware.name}: AI={roof.ai:.1f} FLOP/B, "
          f"utilization={roof.mxu_utilization:.2f}, attainable "
          f"{roof.attainable_flops_per_s / 1e12:.1f} TFLOP/s")
    return {"x": x, "w": w, "routed": routed, "out": out, "roofline": roof,
            "max_abs_err": err, "route_ms": 1e3 * (t1 - t0),
            "matmul_ms": 1e3 * (t2 - t1)}


def parser() -> argparse.ArgumentParser:
    """The command line (defaults: the small demo)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.moe_block",
        description="Route tokens to experts and run the expert FFN as a "
                    "grouped matmul on the GPU.")
    ap.add_argument("--tokens", type=int, default=1024)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--top-k", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=64, help="K")
    ap.add_argument("--d-ff", type=int, default=128, help="N")
    ap.add_argument("--bm", type=int, default=128,
                    help="rows per block (each expert pads to a multiple)")
    ap.add_argument("--bk", type=int, default=64)
    ap.add_argument("--bn", type=int, default=128)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: cuda; cpu runs the "
                         "plain PyTorch version)")
    return ap


def main(argv=None) -> dict:
    """Parse arguments and run once."""
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
