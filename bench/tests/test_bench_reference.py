"""The plain reference against a dense product, and the comparison."""
import math

import pytest
import torch

from bench import reference


def _coo(n, density, seed):
    g = torch.Generator().manual_seed(seed)
    dense = (torch.rand(n, n, generator=g) < density).float() \
        * torch.empty(n, n).uniform_(0.5, 1.5, generator=g)
    dense[3] = 0.0                       # an empty row
    rows, cols = dense.nonzero(as_tuple=True)
    return (rows.int(), cols.int(), dense[rows, cols].float(), dense)


@pytest.mark.parametrize("d", [1, 4, 64])
def test_reference_matches_dense(d, one_thread):
    rows, cols, vals, dense = _coo(300, 0.05, d)
    b = torch.randn(300, d, generator=torch.Generator().manual_seed(1))
    ptr = reference.row_ptr(rows, 300).numpy()
    # Small blocks, so the rows are cut into many.
    blocks = reference.row_blocks(ptr, d, elements=64 * d)
    assert len(blocks) > 10 and blocks[0][0] == 0 and blocks[-1][1] == 300
    ref = torch.cat([reference.reference_block(rows, cols, vals, b, ptr,
                                               r0, r1)[0]
                     for r0, r1 in blocks])
    torch.testing.assert_close(ref, dense.double() @ b.double(),
                               rtol=1e-12, atol=1e-12)
    exact = (dense.double() @ b.double())
    assert reference.max_rel_err(rows, cols, vals, b, exact) < 1e-15
    f32 = dense @ b
    assert reference.max_rel_err(rows, cols, vals, b, f32) < 1e-5


def test_comparison_catches_faults(one_thread):
    rows, cols, vals, dense = _coo(200, 0.05, 7)
    b = torch.randn(200, 8, generator=torch.Generator().manual_seed(2))
    c = dense @ b
    bad = c.clone()
    bad[3, 0] = 1e-3                     # a value in the empty row
    assert math.isinf(reference.max_rel_err(rows, cols, vals, b, bad))
    bad = c.clone()
    bad[10, 2] = float("nan")
    assert math.isinf(reference.max_rel_err(rows, cols, vals, b, bad))
    assert math.isinf(reference.max_rel_err(rows, cols, vals, b, c[:, :4]))
    half = (dense.bfloat16() @ b.bfloat16()).float()
    assert reference.max_rel_err(rows, cols, vals, b, half) > 1e-3
