"""Run one cell of a ``stencil27`` configuration as ``bench/run.py`` does,
and hold each sampled answer also against the plain 27-point stencil
reference at the full grid (``bench/stencil27_reference.py``, float64, in
slabs of z-planes), beside the generic COO reference that decides
``correct``.

    python3 bench/stencil27_check.py --workload hpcg.stream-d64 \
        --seed 7 --seconds 30 --trace 0

From the root of a checkout, on the card. Prints ``bench/run.py``'s lines,
then ``stencil27_check: ...`` with each sampled answer's largest
``|C - C_ref| / (|A| @ |B|)``, and exits 1 when one passes the
configuration's ``check.max_rel_err`` (``run.py``'s own exit code
otherwise).
"""
from __future__ import annotations

import contextlib
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: z-planes of the grid one reference slab computes.
SLAB = 8


def coefficients(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 grid: tuple) -> torch.Tensor:
    """The stencil's float64 ``coef[27, nz, ny, nx]`` from its row-sorted
    COO on an ``(nx, ny, nz)`` grid (0 where a neighbour lies outside)."""
    from bench import stencil27_reference as ref
    nx, ny, nz = grid
    n = nx * ny * nz
    dev = rows.device
    slot = torch.full((2 * n + 1,), -1, dtype=torch.long, device=dev)
    slot[torch.tensor(ref.offsets(nx, ny), device=dev) + n] = torch.arange(
        27, device=dev)
    s = slot[cols.long() - rows.long() + n]
    if int(s.min()) < 0:
        raise ValueError("an entry lies off the 27-point stencil")
    coef = torch.zeros(27, n, dtype=torch.float64, device=dev)
    coef[s, rows.long()] = vals.double()
    return coef.view(27, nz, ny, nx)


def stencil_rel_err(coef: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    slab: int = SLAB) -> float:
    """Largest ``|C - C_ref| / (|A| @ |B|)`` of ``c`` against the stencil
    reference, ``slab`` z-planes at a time."""
    from bench import stencil27_reference as ref
    _, nz, ny, nx = coef.shape
    worst = 0.0
    for z0 in range(0, nz, slab):
        z1 = min(nz, z0 + slab)
        want = ref.apply(coef, b, (z0, z1))
        mag = ref.apply(coef.abs(), b.abs(), (z0, z1))
        diff = (c[z0 * ny * nx:z1 * ny * nx].double() - want).abs_()
        err = torch.where(mag > 0, diff / mag.clamp_min(1e-300),
                          torch.where(diff > 0, float("inf"), 0.0))
        worst = max(worst, float(err.max()))
    return worst


@contextlib.contextmanager
def stencil_checked(grid: tuple, errs: list):
    """Within it, each call of ``bench.reference.max_rel_err`` also holds
    its answer against the stencil reference on ``grid`` and appends that
    error to ``errs``."""
    from bench import reference
    plain = reference.max_rel_err
    coef = {}

    def checked(rows, cols, vals, b, c):
        if "coef" not in coef:
            coef["coef"] = coefficients(rows, cols, vals, grid)
        errs.append(stencil_rel_err(coef["coef"], b, c))
        return plain(rows, cols, vals, b, c)
    reference.max_rel_err = checked
    try:
        yield errs
    finally:
        reference.max_rel_err = plain


def main(argv=None) -> int:
    import argparse
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import run, spec
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload", required=True)
    args, _ = p.parse_known_args(argv)
    cfg = spec.load_cell(ROOT, args.workload).config
    if cfg["generator"] != "stencil27":
        print(f"stencil27_check: {args.workload} is not a stencil27 cell",
              file=sys.stderr)
        return 2
    grid = tuple(int(cfg["params"][k]) for k in ("nx", "ny", "nz"))
    limit = float(cfg["check"]["max_rel_err"])
    with stencil_checked(grid, []) as errs:
        rc = run.main(argv)
    print(f"stencil27_check: {len(errs)} answers against the stencil "
          f"reference on {grid}, max rel err each {errs}, worst "
          f"{max(errs, default=None)} (limit {limit})", flush=True)
    if rc == 0 and (not errs or max(errs) > limit):
        return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
