"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so \
        csrc/<name>.cu

The file name carries a hash of the sources (the ``.cu`` and every
``.cuh`` header), so an edited kernel is rebuilt and a current one is
reused.  Libraries go to ``build/repro_torch_kernels/`` in the checkout.
:func:`build` starts one
``nvcc`` per source at once, so a cold build takes as long as the slowest
file.  Nothing here runs at import time: the CPU tests import every module
and never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"

#: The kernels of this package, by library name (``csrc/<name>.cu``).
KERNELS = ("csr_spmm", "binned_spmm", "rowsplit_spmm", "bcsr_spmm",
           "banded_spmm", "grouped_matmul")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    """Where the compiled libraries live (created on first build)."""
    return CSRC.parents[2] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME``, ``PATH``, the default)."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((pathlib.Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 pathlib.Path("/usr/local/cuda/bin/nvcc")):
        if cand and pathlib.Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> pathlib.Path:
    """The shared library ``name`` builds to for the current sources."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel library {name!r}; have {KERNELS}")
    return build_dir() / f"{name}-{_digest(name)}.so"


def build(names: Optional[Iterable[str]] = None, *,
          verbose: bool = False) -> Dict[str, pathlib.Path]:
    """Compile the libraries that are missing, all ``nvcc`` runs at once.

    Args:
        names: library names (default: every kernel in :data:`KERNELS`).
        verbose: add ``-Xptxas -v`` and return the compiler's report in
            :data:`LAST_LOG` (registers, shared memory, spills).

    Returns:
        ``name -> path`` of every requested library.

    Raises:
        RuntimeError: when a compile fails; carries the compiler output.
    """
    names = tuple(KERNELS if names is None else names)
    out = {name: library_path(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.is_file()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        LAST_LOG[name] = log
        if proc.returncode != 0:
            failures.append(f"--- {name} (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


#: Compiler output of the latest :func:`build`, by library name.
LAST_LOG: Dict[str, str] = {}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


def use_sources(csrc) -> None:
    """Build and load the kernels from the sources in ``csrc`` from now on
    (libraries go to the ``build/`` of the checkout that holds them).
    Lets one process time two versions of a kernel on one card."""
    global CSRC
    CSRC = pathlib.Path(csrc).resolve()
    _LIBS.clear()


def check(err: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error code (not ``cudaSuccess``)."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ``ctypes`` pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as a pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
