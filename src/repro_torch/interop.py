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
            * ``dia``: ``band``, ``w``, ``t``.
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


def params_from_numpy(cfg, tree, device=None, dtype=None):
    """The port's :class:`~repro_torch.models.model.LM` holding the
    reference's ``init_params`` weights.

    Args:
        cfg: the model's ``ModelConfig`` (the port's copy).
        tree: the reference's parameter pytree as nested dicts of numpy
            (fp32 master) arrays, its layers stacked on a leading axis
            under ``layers["p0"]``.
        device: where the model goes (None: the CPU).
        dtype: the compute dtype (None: ``models.model.COMPUTE_DTYPE``).

    Each matrix, bias, expert weight and the embedding table are cast
    once to the compute dtype, which is what the reference's per-use cast
    gives; norm scales and the router stay fp32.  ``w_gate`` and ``w_up``
    go side by side into ``w_gate_up``.
    """
    import torch
    from repro_torch.models.model import LM
    model = LM(cfg, device="meta", dtype=dtype)
    dev = device_of(device)
    state = {}
    for path, value in _leaves(tree):
        arr = np.asarray(value, dtype=np.float32)
        if path[0] != "layers":
            state[".".join(path)] = arr
            continue
        # layers / p0 / <module path>: split the stacked leading axis.
        for i in range(arr.shape[0]):
            state[".".join(("layers", str(i)) + path[2:])] = arr[i]
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
    return model
