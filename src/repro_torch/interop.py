"""Bridges from the reference package's state, as plain numpy, to the port.

Every function takes numpy arrays (or anything ``np.asarray`` accepts),
never objects of the reference package, so the port stays free of it:

    m = coo_from_numpy(ref.n, ref.rows, ref.cols, ref.vals, ref.pattern,
                       ref.meta)
    layout = layout_from_numpy("csr", {"n": ..., "b_tile": ...,
                                       "row_tile": 8, "arrays": (...)},
                               device="cpu")

A bf16 array may arrive as numpy ``bfloat16`` (the reference's dtype) or
as its ``uint16`` bits; either becomes a bfloat16 tensor bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.device import device_of
from repro_torch.core.patterns import COOMatrix


def coo_from_numpy(n: int, rows, cols, vals, pattern: str = "custom",
                   meta=None) -> COOMatrix:
    """The port's :class:`COOMatrix` from the reference's fields."""
    return COOMatrix(n=int(n), rows=np.asarray(rows, dtype=np.int32),
                     cols=np.asarray(cols, dtype=np.int32),
                     vals=np.asarray(vals, dtype=np.float64),
                     pattern=str(pattern), meta=dict(meta or {}))


def layout_from_numpy(format: str, arrays, device=None):
    """Turn a reference-packed layout into the port's layout.

    Args:
        format: the registry format the layout was packed for: ``"csr"``,
            ``"ell"`` or ``"ell_coo"`` (all the row-tiled CSR packing),
            ``"binned"``, ``"rowsplit"``, ``"bcsr"`` or ``"dia"``.
        arrays: the reference's packed layout with numpy arrays, as a
            mapping:

            * row-tiled / binned: ``n``, ``b_tile``, ``row_tile`` and
              ``arrays``, the packer's output tuple;
            * ``rowsplit``: ``n`` and ``arrays``, the packer's
              ``(row_map, cols, slots, vals)``;
            * ``bcsr``: ``blocks``, ``block_rows``, ``block_cols``,
              ``block_ptr``, ``n``, ``t``, ``nnz`` (the padded matrix);
            * ``dia``: ``band``, ``w``, ``t`` (the port keeps only the
              diagonals it derives from them).
        device: where the layout goes (None: the CPU).

    Returns:
        The layout the port's ``cuda`` spec of ``format`` runs on.
    """
    from repro_torch.kernels.banded_spmm import band_layout
    from repro_torch.kernels.binned_spmm import slab_bin_layout
    from repro_torch.kernels.csr_spmm import row_tile_layout
    from repro_torch.kernels.rowsplit_spmm import rowsplit_layout
    from repro_torch.sparse.formats import BCSRMatrix, tensor_from_host
    dev = device_of(device)
    if format in ("csr", "ell", "ell_coo", "binned"):
        packed = [np.asarray(a) for a in arrays["arrays"]]
        make = slab_bin_layout if format == "binned" else row_tile_layout
        return make(*packed, n=int(arrays["n"]),
                    b_tile=arrays["b_tile"],
                    row_tile=int(arrays["row_tile"]), device=dev)
    if format == "rowsplit":
        return rowsplit_layout(*[np.asarray(a) for a in arrays["arrays"]],
                               n=int(arrays["n"]), device=dev)
    if format == "bcsr":
        return BCSRMatrix(
            blocks=tensor_from_host(np.asarray(arrays["blocks"]), dev),
            block_rows=tensor_from_host(
                np.asarray(arrays["block_rows"]), dev),
            block_cols=tensor_from_host(
                np.asarray(arrays["block_cols"]), dev),
            block_ptr=tensor_from_host(
                np.asarray(arrays["block_ptr"]), dev),
            n=int(arrays["n"]), t=int(arrays["t"]),
            nnz=int(arrays["nnz"]))
    if format == "dia":
        return band_layout(np.asarray(arrays["band"]), int(arrays["w"]),
                           int(arrays["t"]), dev)
    raise ValueError(f"no port layout for format {format!r}")


def _leaves(tree, prefix=()):
    """``(path, array)`` for every leaf of a nested mapping."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _split_stacked(cfg, path):
    """For a reference leaf stacked over layers, the port's name of entry
    ``i`` as ``name(i)``; None for an unstacked leaf.

    ``layers / p{j} / ...`` stacks group ``g`` of the pattern's ``j``-th
    kind (port layer ``g * period + j``); ``encoder / layers / ...`` stacks
    the encoder's layers."""
    if path[0] == "layers":
        j, period = int(path[1][1:]), len(cfg.layer_pattern)
        rest = path[2:]
        return lambda g: ".".join(("layers", str(g * period + j)) + rest)
    if path[:2] == ("encoder", "layers"):
        return lambda i: ".".join(("encoder", "layers", str(i)) + path[2:])
    return None


def _stacked_slot(cfg, parts):
    """The inverse of :func:`_split_stacked` for a port name split on dots:
    ``(reference path prefix, entry index, entries, the rest)``, or None
    for an unstacked parameter."""
    if parts[0] == "layers":
        n, period = int(parts[1]), len(cfg.layer_pattern)
        return (("layers", f"p{n % period}"), n // period,
                cfg.num_layers // period, tuple(parts[2:]))
    if parts[:2] == ["encoder", "layers"]:
        return (("encoder", "layers"), int(parts[2]), cfg.encoder_layers,
                tuple(parts[3:]))
    return None


def params_from_numpy(cfg, tree, device=None, dtype=None, masters=False, *,
                      mesh=None, specs=None):
    """The port's :class:`~repro_torch.models.model.LM` holding the
    reference's ``init_params`` weights.

    Args:
        cfg: the model's ``ModelConfig`` (the port's copy).
        tree: the reference's parameter pytree as nested dicts of numpy
            (fp32 master) arrays: each kind ``j`` of the layer pattern
            stacked over its groups under ``layers["p{j}"]`` (group ``g``
            is layer ``g * period + j``), whisper's encoder layers stacked
            under ``encoder["layers"]``.
        device: where the model goes (None: the CPU).
        dtype: the compute dtype (None: ``models.model.COMPUTE_DTYPE``).
        masters: keep every weight as a trainable fp32 master (training).

    Without ``masters``, each matrix, bias, expert weight and the
    embedding table are cast once to the compute dtype, which is what the
    reference's per-use cast gives; norm scales and biases and the router
    stay fp32.  ``w_gate`` and ``w_up`` go side by side into
    ``w_gate_up``.

    With ``mesh`` (a ``launch.mesh.ProcessMesh``) the model keeps this
    rank's blocks (``LM.shard(mesh, specs)``; ``specs`` default to the
    policy's), for every family: the reference's parameters carry across
    to a partitioned step.
    """
    import torch
    from repro_torch.models.model import LM
    model = LM(cfg, device="meta", dtype=dtype, masters=masters)
    dev = device_of(device)
    state = {}
    for path, value in _leaves(tree):
        arr = np.asarray(value, dtype=np.float32)
        name = _split_stacked(cfg, path)
        if name is None:
            state[".".join(path)] = arr
            continue
        for i in range(arr.shape[0]):
            state[name(i)] = arr[i]
    for i in range(cfg.num_layers):
        gate = state.pop(f"layers.{i}.moe.w_gate", None)
        if gate is not None:
            state[f"layers.{i}.moe.w_gate_up"] = np.concatenate(
                [gate, state.pop(f"layers.{i}.moe.w_up")], axis=2)
            state[f"layers.{i}.moe.router"] = \
                state.pop(f"layers.{i}.moe.router.kernel")
    own = dict(model.named_parameters())
    tensors = {name: torch.from_numpy(np.array(arr)).to(dev, own[name].dtype)
               for name, arr in state.items()}
    model.load_state_dict(tensors, strict=True, assign=True)
    return model if mesh is None else model.shard(mesh, specs)


def tree_to_numpy(cfg, named) -> dict:
    """The reference's pytree layout of per-parameter tensors keyed by the
    port's parameter names: the inverse of :func:`params_from_numpy`'s
    mapping, for the weights, their gradients or AdamW's ``mu`` / ``nu``.

    Args:
        cfg: the model's ``ModelConfig``.
        named: ``{name: tensor}`` as ``dict(model.named_parameters())``.

    Returns:
        Nested dicts of fp32 numpy arrays (bf16 leaves are widened): the
        layers stacked per kind of the pattern under ``layers["p{j}"]`` and
        the encoder's under ``encoder["layers"]``, ``w_gate_up`` split back
        into ``w_gate`` / ``w_up`` and the router under
        ``router["kernel"]``.
    """
    import torch
    flat = {}
    for name, t in named.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        parts = name.split(".")
        slot = _stacked_slot(cfg, parts)
        if slot is None:
            flat[tuple(parts)] = arr
            continue
        prefix, i, count, path = slot
        if path == ("moe", "w_gate_up"):
            f = arr.shape[2] // 2
            pieces = {("moe", "w_gate"): arr[..., :f],
                      ("moe", "w_up"): arr[..., f:]}
        elif path == ("moe", "router"):
            pieces = {("moe", "router", "kernel"): arr}
        else:
            pieces = {path: arr}
        for sub, a in pieces.items():
            flat.setdefault(prefix + sub, [None] * count)[i] = a
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(value) if isinstance(value, list) \
            else value
    return tree


def params_to_numpy(model) -> dict:
    """The reference's parameter pytree of a port
    :class:`~repro_torch.models.model.LM` (see :func:`tree_to_numpy`).
    A model sharded on a mesh (``LM.shard``) has its whole leaves
    assembled from every rank's blocks (``launch.sharding.assemble``):
    every rank of the mesh must call this, and each gets the whole
    tree."""
    named = dict(model.named_parameters())
    if model.mesh is not None:
        from repro_torch.launch.sharding import assemble
        named = {n: assemble(p.detach(), model.param_specs[n], model.mesh)
                 for n, p in named.items()}
    return tree_to_numpy(model.cfg, named)


def _cache_leaves(node: dict) -> dict:
    """A reference layer cache's leaves by the port's names: an attention
    layer's ``kv`` (``k``, ``v``) and whisper's ``cross_k`` / ``cross_v``,
    an ``ssm`` layer's ``conv`` / ``h``, an ``rglru`` layer's under
    ``rnn``."""
    out = {}
    for key, value in node.items():
        if isinstance(value, dict):
            out.update(value)
        else:
            out[key] = value
    return out


def cache_from_numpy(cfg, tree, device=None, dtype=None, *, mesh=None,
                     specs=None):
    """The port's decode cache (``LM.init_cache``'s list of per-layer
    dicts) holding the reference's ``init_cache`` tree.

    Args:
        cfg: the model's ``ModelConfig``.
        tree: the reference's cache as nested dicts of numpy arrays: each
            kind ``j`` of the layer pattern under ``"p{j}"``, its leaves
            stacked over the groups (group ``g`` is layer ``g * period +
            j``): ``{"kv": {"k", "v"}}`` (and whisper's ``cross_k`` /
            ``cross_v``) for attention, ``{"conv", "h"}`` for ``ssm``,
            ``{"rnn": {"conv", "h"}}`` for ``rglru``.
        device: where the cache goes (None: the CPU).
        dtype: the compute dtype of every leaf but ``h`` (fp32; None:
            ``models.model.COMPUTE_DTYPE``).
        mesh, specs: with a ``launch.mesh.ProcessMesh``, this rank's block
            of every leaf, as ``specs`` cut them (default
            ``launch.sharding.cache_pspecs`` at the tree's batch).
    """
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    dev = device_of(device)
    dt = dtype or M.COMPUTE_DTYPE
    period = len(cfg.layer_pattern)
    cache = []
    for n in range(cfg.num_layers):
        g, j = divmod(n, period)
        leaves = _cache_leaves(tree[f"p{j}"])
        cache.append({
            name: torch.from_numpy(np.array(np.asarray(arr[g],
                                                       dtype=np.float32)))
            .to(dev, torch.float32 if name == "h" else dt)
            for name, arr in leaves.items()})
    if mesh is None:
        return cache
    if specs is None:
        batch = cache[0][next(iter(cache[0]))].shape[0]
        specs = SH.cache_pspecs(cfg, mesh, ShapeConfig(
            "decode", 0, batch, "decode"), cache)
    return SH.cache_blocks(cache, specs, mesh)


def cache_tree(cfg, cache) -> dict:
    """The reference's cache tree (see :func:`cache_from_numpy`) of a port
    decode cache, whole or a rank's blocks, as fp32 numpy arrays (bf16
    leaves widened): each kind's layers stacked over the groups."""
    import torch
    from repro_torch.models.model import ATTENTION_KINDS
    period = len(cfg.layer_pattern)
    tree: dict = {}
    for j, kind in enumerate(cfg.layer_pattern):
        layers = cache[j::period]
        stacked = {n: np.stack([layer[n].detach().to("cpu", torch.float32)
                                .numpy() for layer in layers])
                   for n in layers[0]}
        if kind in ATTENTION_KINDS:
            node = {"kv": {"k": stacked.pop("k"), "v": stacked.pop("v")}}
            node.update(stacked)
        elif kind == "rglru":
            node = {"rnn": stacked}
        else:
            node = stacked
        tree[f"p{j}"] = node
    return tree


def cache_to_numpy(model, cache, specs=None) -> dict:
    """:func:`cache_tree` of the whole cache of ``model``.  For a model
    sharded on a mesh, ``cache`` holds this rank's blocks and ``specs``
    (``make_serve_step``'s ``specs["cache"]``) name them: the whole leaves
    are assembled first (``launch.sharding.assemble``; every rank of the
    mesh must call this, and each gets the whole tree).

    Raises:
        ValueError: a sharded model's cache without its specs.
    """
    if model.mesh is not None:
        if specs is None:
            raise ValueError("a sharded model's cache needs its specs")
        from repro_torch.launch.sharding import assemble
        cache = [{n: assemble(t, spec[n], model.mesh)
                  for n, t in layer.items()}
                 for layer, spec in zip(cache, specs)]
    return cache_tree(model.cfg, cache)
