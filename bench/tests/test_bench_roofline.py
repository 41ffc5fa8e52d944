"""The fixed roofline count against numbers worked by hand."""
import pytest

from bench import roofline


def test_scale_free_request():
    n, nnz, d = 2**20, 13_846_358, 64
    # A: 8 B x nnz + 4 B x (n + 1); B and C: 4 B x n x d each.
    a = 8 * 13_846_358 + 4 * 1_048_577
    bc = 2 * 4 * 1_048_576 * 64
    assert a == 110_770_864 + 4_194_308 and bc == 536_870_912
    assert roofline.request_bytes(n, nnz, d) == a + bc == 651_836_084
    assert roofline.request_flops(nnz, d) == 1_772_333_824
    assert roofline.request_bound_s(n, nnz, d) == pytest.approx(
        651_836_084 / 3.35e12)
    assert roofline.bound_side(n, nnz, d) == "bytes"
    assert roofline.request_bound_s(n, nnz, d) * 1e3 == pytest.approx(
        0.194578, abs=1e-6)


def test_fem_request_d4():
    n, nnz, d = 2**20, 16_659_812, 4
    assert roofline.request_bytes(n, nnz, d) == (
        8 * 16_659_812 + 4 * 1_048_577 + 8 * 1_048_576 * 4)
    assert roofline.request_bytes(n, nnz, d) \
        == 133_278_496 + 4_194_308 + 33_554_432 == 171_027_236
    assert roofline.request_bound_s(n, nnz, d) * 1e3 == pytest.approx(
        0.0510529, abs=1e-7)


def test_operations_bound_when_dense_enough():
    # 2 nnz d / 67e12 > bytes / 3.35e12 needs about d > 40 per byte of A.
    n, nnz, d = 1024, 1024 * 1024, 1024
    assert roofline.bound_side(n, nnz, d) == "operations"
    assert roofline.request_bound_s(n, nnz, d) == pytest.approx(
        2 * nnz * d / 67e12)
