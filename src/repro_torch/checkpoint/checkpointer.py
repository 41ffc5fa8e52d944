"""Fault-tolerant checkpointing: atomic, manifest-verified, the reference's
on-disk layout.

Layout (one directory per step), the same files the reference writes:
    <root>/step_000000042/
        manifest.json         {key: {file, shape, dtype}} + step + time
        arrays/<flat.key>.npy one file per leaf (full array)
        COMMITTED             sentinel written last (atomicity marker)

* Atomicity: arrays go to ``<dir>.tmp``, the directory is renamed and the
  ``COMMITTED`` sentinel written; ``latest_step`` sees only committed
  steps, so a crash mid-save leaves the previous checkpoint in charge.
* Retention: the newest ``keep`` committed checkpoints stay.
* Leaves are tensors (moved to the host one at a time) or numpy arrays.
  bfloat16 has no numpy dtype without ``ml_dtypes``: a bf16 leaf is saved
  as its 2-byte patterns under the header ``np.save`` writes for the
  reference's bf16 arrays (``'descr': '<V2'``), byte for byte, and the
  manifest says ``"bfloat16"``; :meth:`Checkpointer.restore` reads it back
  through the manifest's dtype.  Checkpoints therefore restore across the
  two packages.
* Elasticity: leaves are stored whole, so a restart may use another mesh.
  ``restore(mesh=, specs=)`` gives each rank of a ``launch.mesh.
  ProcessMesh`` its own block of each leaf, as a spec (the policy's
  format, ``launch.sharding``) splits it, reading only that block from
  the file: the counterpart of the reference's ``restore(shardings=)``.
  ``save(mesh=, specs=)`` is its inverse: every rank passes its blocks,
  each leaf is assembled whole (``launch.sharding.assemble``) and rank 0
  writes the same files a one-process save writes; every rank waits at a
  barrier before rank 0 commits and again after.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.tree import leaves, unflatten
from repro_torch.launch.sharding import assemble, block_slices

#: The ``.npy`` dtype descriptor of a bf16 leaf: a raw 2-byte record,
#: as ``np.save`` writes ``ml_dtypes.bfloat16``.
BF16_DESCR = "<V2"


def save_leaf(path: str, leaf) -> tuple:
    """Write one leaf (a tensor or an array) as ``.npy``; returns its
    ``(shape, manifest dtype)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": BF16_DESCR, "fortran_order": False,
                        "shape": tuple(t.shape)})
                t.contiguous().view(torch.int16).numpy().tofile(f)
            return list(t.shape), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def from_host(arr: np.ndarray, dtype: str,
              device: Optional[torch.device]) -> torch.Tensor:
    """A tensor of the manifest's ``dtype`` from a loaded array."""
    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(arr)
    return t if device is None else t.to(device)


class Checkpointer:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def save(self, step: int, tree: Dict, *, mesh=None,
             specs: Optional[Dict] = None) -> str:
        """Write a committed checkpoint for ``step``; returns its path.
        Leaves go to the host one at a time.

        With ``mesh`` (a ``ProcessMesh``) and ``specs`` (nested or
        ``/``-keyed flat, as :meth:`restore` takes them), every rank of
        the mesh calls this with its blocks of ``tree``: each leaf that
        has a spec is assembled whole over the mesh, rank 0 writes it,
        and every rank returns once rank 0 has committed.

        Raises:
            ValueError: one of ``mesh`` and ``specs`` without the other.
        """
        from repro_torch.core import comm
        if (mesh is None) != (specs is None):
            raise ValueError("a save over a mesh needs both mesh= and "
                             "specs=")
        flat_specs = dict(leaves(specs)) if specs else {}
        writer = mesh is None or mesh.rank == 0
        final = self._dir(step)
        tmp = final + ".tmp"
        arrays_dir = os.path.join(tmp, "arrays")
        if writer:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(arrays_dir)
        manifest = {"step": step, "time": time.time(), "arrays": {}}
        for key, val in leaves(tree):
            if flat_specs.get(key) is not None:
                val = assemble(val, flat_specs[key], mesh)
            if not writer:
                continue
            fname = key.replace("/", ".") + ".npy"
            shape, dtype = save_leaf(os.path.join(arrays_dir, fname), val)
            manifest["arrays"][key] = {"file": fname, "shape": shape,
                                       "dtype": dtype}
        if mesh is not None:
            comm.barrier(mesh=mesh)
        if writer:
            self._commit(tmp, final, step, manifest)
        if mesh is not None:
            comm.barrier(mesh=mesh)
        return final

    def _commit(self, tmp: str, final: str, step: int,
                manifest: Dict) -> None:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # Sentinel last: a rename is atomic on POSIX, the sentinel guards
        # against non-atomic network filesystems.
        with open(os.path.join(final, "COMMITTED"), "w") as f:
            f.write(str(step))
        self._gc()

    def committed_steps(self):
        steps = []
        for name in os.listdir(self.root):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.root, name, "COMMITTED")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *,
                device: Optional[torch.device] = None,
                like: Optional[Dict] = None, mesh=None,
                specs: Optional[Dict] = None) -> Dict:
        """Load a checkpoint as a nested dict of tensors.

        Args:
            step: the step (None: the newest committed one).
            device: where each leaf goes as it is read (None: the CPU),
                so the host holds one leaf at a time.
            like: a nested dict whose leaves the checkpoint must hold.
            mesh: a ``ProcessMesh``; with ``specs``, each leaf that has a
                spec comes back as this rank's block (:func:`block_slices`),
                read from the file alone; the others whole.
            specs: a nested (or ``/``-keyed flat) dict of specs.

        Raises:
            FileNotFoundError: no committed checkpoint.
            ValueError: a leaf of ``like`` is missing.
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint in "
                                        f"{self.root}")
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if like is not None:
            missing = {k for k, _ in leaves(like)} - set(manifest["arrays"])
            if missing:
                raise ValueError(f"checkpoint step {step} missing leaves: "
                                 f"{sorted(missing)[:5]}...")
        if (mesh is None) != (specs is None):
            raise ValueError("an elastic restore needs both mesh= and "
                             "specs=")
        flat_specs = dict(leaves(specs)) if specs else {}
        flat = {}
        for key, meta in manifest["arrays"].items():
            path = os.path.join(d, "arrays", meta["file"])
            if key in flat_specs and flat_specs[key] is not None:
                whole = np.load(path, mmap_mode="r")
                arr = np.array(
                    whole[block_slices(flat_specs[key], whole.shape, mesh)])
                del whole
            else:
                arr = np.load(path)
            flat[key] = from_host(arr, meta["dtype"], device)
            del arr
        return unflatten(flat)

    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
