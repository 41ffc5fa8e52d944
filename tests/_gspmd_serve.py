"""Checks of the serve-step tests (``tests/test_torch_gspmd_serve*.py``):
each rank's blocks of the logits, the decode cache and the parameters
against the reference's partitioned serve step's shards
(``tests/_gspmd.py``'s ``_SERVE_SCRIPT``), by spec, index and value.

Values are held within ``RTOL32`` (the one-process decode tests' fp32
bound, ``tests/test_torch_lm.py``): a logit against its row's largest
|logit| in the reference's whole logits, a cache element against its
leaf's largest |value|.  Parameter blocks are the reference's shards of
the same weights exactly.
"""
from __future__ import annotations

import numpy as np

from _gspmd import _as_spec, _fake_mesh, _LEAF_OF, position, ref_shard

RTOL32 = 1e-4


def _spec(entries) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in entries]


def _slices(spec, shape, c: dict, coords: dict) -> list:
    from repro_torch.launch.sharding import block_slices
    mine = block_slices(_as_spec(spec), tuple(shape), _fake_mesh(c, coords))
    return [[s.start, s.stop] for s in mine]


def check_logits(runs: dict, name: str) -> None:
    """Spec, index and every step's values of each rank's logits block."""
    c = runs["cases"][name]
    info = runs["info"][name]["logits"]
    shape = runs["ref"][f"{name}/logits0"].shape
    worst = 0.0
    for r in runs["ranks"]:
        res = r[name]
        assert _spec(res["specs"]["logits"]) == info["spec"], \
            (res["specs"]["logits"], info["spec"])
        at = info["index"][position(c, res["coords"])]
        assert _slices(info["spec"], shape, c, res["coords"]) == at
        for t, got in enumerate(res["logits"]):
            whole = runs["ref"][f"{name}/logits{t}"]
            want = ref_shard(whole, at)
            assert got.shape == want.shape and np.isfinite(got).all()
            scale = np.abs(ref_shard(whole, at[:1] + [[0, shape[1]]])).max(
                axis=-1, keepdims=True)
            worst = max(worst, float((np.abs(got - want) / scale).max()))
    assert worst <= RTOL32, f"{name}: worst error / row scale {worst:.3e}"


def _layers_of(c: dict, leaf: str, cfg) -> list:
    """The port's layers whose cache the reference's stacked ``leaf``
    (``p{j}/...``) holds."""
    j = int(leaf.split("/")[0][1:])
    return list(range(j, cfg.num_layers, len(cfg.layer_pattern)))


def _cfg(runs, name):
    from _gspmd_ranks import case_config
    return case_config(runs["cases"][name])


def check_cache_specs(runs: dict, name: str) -> None:
    """Each layer's cache spec equals the reference's leaf's (with the
    leading group dim), and so does its block index on every rank."""
    c = runs["cases"][name]
    cfg = _cfg(runs, name)
    for leaf, where in runs["info"][name]["cache"].items():
        key = leaf.split("/")[-1]
        whole = runs["ref"][f"{name}/cache/{leaf}"].shape
        for r in runs["ranks"]:
            res = r[name]
            for n in _layers_of(c, leaf, cfg):
                spec = res["specs"]["cache"][n][key]
                got = [None] + _spec(spec)
                got += [None] * (len(whole) - len(got))
                assert got == where["spec"], (leaf, n, got, where["spec"])
                at = where["index"][position(c, res["coords"])]
                assert [[0, whole[0]]] + _slices(spec, whole[1:], c,
                                                 res["coords"]) == at, \
                    (leaf, n, at)


def _leaf_close(got, want, scale, what) -> None:
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= RTOL32 * scale, f"{what}: {err:.3e} > {RTOL32} * {scale:.3e}"


def check_cache_blocks(runs: dict, name: str) -> None:
    """Each rank's final cache blocks against the reference's shards."""
    c = runs["cases"][name]
    info = runs["info"][name]["cache"]
    for leaf, where in info.items():
        whole = runs["ref"][f"{name}/cache/{leaf}"]
        scale = max(float(np.abs(whole).max()), 1e-30)
        for r in runs["ranks"]:
            at = where["index"][position(c, r[name]["coords"])]
            _leaf_close(r[name]["cache"][leaf], ref_shard(whole, at), scale,
                        f"{name} {leaf} at {r[name]['coords']}")


def check_whole_cache(runs: dict, name: str) -> None:
    """``interop.cache_to_numpy`` assembles the whole final cache on every
    rank, equal to the reference's within the bound."""
    for leaf in runs["info"][name]["cache"]:
        whole = runs["ref"][f"{name}/cache/{leaf}"]
        scale = max(float(np.abs(whole).max()), 1e-30)
        for r in runs["ranks"]:
            _leaf_close(r[name]["whole_cache"][leaf], whole, scale,
                        f"{name} whole {leaf}")


def _port_param(leaf: str) -> str:
    """The port's name of the first layer a reference parameter leaf
    stacks (or of an unstacked leaf)."""
    parts = leaf.split("/")
    if parts[0] == "layers":
        prefix, rest = f"layers.{parts[1][1:]}.", "/".join(parts[2:])
    elif parts[:2] == ["encoder", "layers"]:
        prefix, rest = "encoder.layers.0.", "/".join(parts[2:])
    else:
        return leaf.replace("/", ".")
    return prefix + _LEAF_OF.get(rest, rest.replace("/", "."))


def check_param_blocks(runs: dict, name: str) -> None:
    """Every parameter's spec equals the reference's, and each rank's
    block is the reference's shard at its position, exactly."""
    c = runs["cases"][name]
    weights = runs["weights"][name]
    for leaf, where in runs["info"][name]["params"].items():
        for r in runs["ranks"]:
            res = r[name]
            spec = res["specs"]["params"][_port_param(leaf)]
            got = _spec(spec)
            got = [None] * (len(where["spec"]) - len(got)) + got
            assert got == where["spec"], (leaf, got, where["spec"])
            at = where["index"][position(c, res["coords"])]
            want = ref_shard(weights[leaf], at)
            assert np.array_equal(res["params"][leaf], want), (leaf, at)
