"""Bridges from the reference package's state, as plain numpy, to the port.

Both functions take numpy arrays (or anything ``np.asarray`` accepts),
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
    from repro_torch.kernels.banded_spmm import BandLayout
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
        return BandLayout(
            band=tensor_from_host(np.asarray(arrays["band"]), dev),
            w=int(arrays["w"]), t=int(arrays["t"]))
    raise ValueError(f"no port layout for format {format!r}")
