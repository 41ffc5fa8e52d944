"""The generators: a seed gives the same operator, and nnz and degree land
where the configuration's parameters put them."""
import pytest
import torch

from bench import run, spec
from conftest import ROOT, small_config


def _operator(config: str, seed: int, n: int):
    cell = spec.Cell(name="t", chips=1, config=small_config(config, n),
                     traffic={}, end_to_end=(), per_layer=())
    return run.make_operator(ROOT, cell, seed, torch.device("cpu"))


@pytest.mark.parametrize("config", ["scalefree-small", "fem-small"])
def test_same_seed_same_operator(config, one_thread):
    a = _operator(config, 2**31 + 7, 4096)
    b = _operator(config, 2**31 + 7, 4096)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = _operator(config, 5, 4096)
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    assert not torch.equal(a[2], c[2])


@pytest.mark.parametrize("config, n, low, high", [
    # 16 requested; floor() of the rescaled degrees and the hub columns'
    # duplicates leave ~12.7-13.3 (13.2 at n = 2**20 on the card).
    ("scalefree-small", 2**14, 12.0, 14.0),
    # n / 16 blocks, ~7.5 % of them duplicates; Poisson(320) entries in
    # 1024 slots keep ~272 distinct: ~15.9 per row.
    ("fem-small", 2**14, 15.3, 16.5),
])
def test_nnz_and_degree(config, n, low, high, one_thread):
    rows, cols, vals = _operator(config, 3, n)
    nnz = rows.numel()
    assert low <= nnz / n <= high
    key = rows.long() * n + cols.long()
    assert torch.all(key[1:] > key[:-1]), "sorted row-major, no duplicates"
    assert int(rows.min()) >= 0 and int(rows.max()) < n
    assert 0.5 <= float(vals.min()) and float(vals.max()) < 1.5
    assert rows.dtype == cols.dtype == torch.int32
    assert vals.dtype == torch.float32


def test_scale_free_hubs(one_thread):
    """The hub columns take about the paper's Eq. 5 share of the edges."""
    from bench.gen.scale_free import hub_edge_fraction
    n = 2**14
    rows, cols, _ = _operator("scalefree-small", 3, n)
    n_hub = max(1, int(n * 0.001))
    hub = (cols.long() % (n // n_hub) == 0).float().mean().item()
    want = hub_edge_fraction(2.2, 0.001)
    assert want == pytest.approx(0.001 ** (0.2 / 1.2))
    # Duplicate hub edges collapse, so the kept share is below the drawn.
    assert 0.2 * want < hub < want
