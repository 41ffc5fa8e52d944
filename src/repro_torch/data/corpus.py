"""DLMC/SuiteSparse-style real-matrix corpus layer (port).

The synthetic generators in ``repro_torch.core.patterns`` stand in for
the paper's matrices; this module loads real ones:

  loaders     ``load_smtx`` (the DLMC ``.smtx`` CSR-text format used by
              pytorch's ``benchmarks/sparse/dlmc`` suite) and
              ``load_mtx`` (Matrix Market coordinate format, the
              SuiteSparse interchange format); both return the port's
              ``COOMatrix``, square-padded when the source is
              rectangular.
  writers     ``write_smtx`` and ``write_mtx``, their inverses.
  corpus      ``corpus_entries()`` enumerates the active corpus: an
              explicit root, else the directory named by
              ``$REPRO_CORPUS_DIR``, else the small sample set shipped
              inside the package (``corpus_samples/``, all four paper
              groups), so tests never touch the network.
  download    ``download`` always raises :class:`CorpusDownloadDisabled`:
              the port never opens a socket.  Put downloaded files in a
              directory and point ``$REPRO_CORPUS_DIR`` at it.

File naming carries the paper group: ``<group>__<name>.smtx|.mtx`` with
``group`` one of :data:`GROUPS`.  ``repro_torch.core.patterns.
fit_generator`` turns a corpus matrix's measured statistics back into a
synthetic generator.  Everything here is host numpy.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.patterns import COOMatrix

#: The paper's four structure groups; corpus filenames are
#: ``<group>__<name>.<ext>``.
GROUPS: Tuple[str, ...] = ("random", "diagonal", "blocked", "scale_free")

#: The vendored sample set shipped with the package (hermetic corpus).
SAMPLES_DIR = pathlib.Path(__file__).resolve().parent / "corpus_samples"

#: Loader dispatch by suffix.
_SUFFIXES = (".smtx", ".mtx")


class CorpusDownloadDisabled(RuntimeError):
    """Raised by :func:`download`: the port fetches nothing."""


def _finalize_loaded(n: int, rows: np.ndarray, cols: np.ndarray,
                     vals: np.ndarray, pattern: str,
                     meta: dict) -> COOMatrix:
    """Sort row-major, deduplicate (first value wins), keep real values."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if np.any((rows < 0) | (rows >= n) | (cols < 0) | (cols >= n)):
        raise ValueError(f"{meta.get('source', 'corpus matrix')}: index "
                         f"out of range for n={n}")
    lin = rows * n + cols
    order = np.argsort(lin, kind="stable")
    lin, vals = lin[order], vals[order]
    keep = np.concatenate([[True], np.diff(lin) > 0])
    lin, vals = lin[keep], vals[keep]
    return COOMatrix(n=n, rows=(lin // n).astype(np.int32),
                     cols=(lin % n).astype(np.int32), vals=vals,
                     pattern=pattern, meta=meta)


def _synth_vals(nnz: int, seed: int = 0) -> np.ndarray:
    """Deterministic values for pattern-only sources (no stored values)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, size=nnz)


def load_smtx(path: os.PathLike, pattern: str = "corpus") -> COOMatrix:
    """Load a DLMC ``.smtx`` file (CSR text: shape line, ptr line, col line).

    The format (pytorch ``benchmarks/sparse/dlmc``): line 1 is
    ``nrows, ncols, nnz`` (comma separated), line 2 the ``nrows + 1``
    row pointers, line 3 the ``nnz`` column indices.  DLMC stores
    patterns only, so values are synthesized deterministically.
    Rectangular sources are square-padded to ``n = max(nrows, ncols)``
    (the repo's SpMM stack is square); the true shape is kept in
    ``meta``.

    Args:
        path: the ``.smtx`` file.
        pattern: the ``COOMatrix.pattern`` tag to attach.

    Returns:
        The matrix as a sorted, deduplicated ``COOMatrix``.

    Raises:
        ValueError: on a malformed header, pointer, or index section.
    """
    path = pathlib.Path(path)
    text = path.read_text(encoding="utf-8").strip().splitlines()
    if len(text) < 2:
        raise ValueError(f"{path.name}: expected 3 lines (shape, row "
                         f"pointers, column indices), got {len(text)}")
    try:
        nrows, ncols, nnz = (int(tok) for tok in text[0].replace(
            ",", " ").split())
    except ValueError:
        raise ValueError(f"{path.name}: malformed shape line "
                         f"{text[0]!r}") from None
    ptr = np.array(text[1].split(), dtype=np.int64)
    cols = (np.array(text[2].split(), dtype=np.int64)
            if len(text) > 2 and text[2].strip() else
            np.zeros(0, dtype=np.int64))
    if ptr.shape[0] != nrows + 1 or ptr[0] != 0 or ptr[-1] != nnz:
        raise ValueError(f"{path.name}: row-pointer line inconsistent "
                         f"with shape header ({ptr.shape[0]} ptrs, "
                         f"expected {nrows + 1}; ptr[-1]="
                         f"{ptr[-1] if ptr.size else 'none'} vs nnz={nnz})")
    if cols.shape[0] != nnz:
        raise ValueError(f"{path.name}: {cols.shape[0]} column indices, "
                         f"header says nnz={nnz}")
    rows = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(ptr))
    n = max(nrows, ncols)
    meta = {"source": path.name, "format": "smtx",
            "nrows": nrows, "ncols": ncols}
    return _finalize_loaded(n, rows, cols, _synth_vals(nnz), pattern, meta)


def load_mtx(path: os.PathLike, pattern: str = "corpus") -> COOMatrix:
    """Load a Matrix Market coordinate file (SuiteSparse interchange).

    Supports ``real`` / ``integer`` / ``pattern`` fields and the
    ``general`` / ``symmetric`` symmetries (symmetric entries are
    mirrored; the diagonal is not duplicated).  Indices are 1-based per
    the spec.  Rectangular sources are square-padded to
    ``n = max(nrows, ncols)``.

    Args:
        path: the ``.mtx`` file.
        pattern: the ``COOMatrix.pattern`` tag to attach.

    Returns:
        The matrix as a sorted, deduplicated ``COOMatrix``.

    Raises:
        ValueError: on a malformed banner, an unsupported field or
            symmetry, or an entry-count mismatch.
    """
    path = pathlib.Path(path)
    with open(path, encoding="utf-8") as f:
        banner = f.readline().strip().lower().split()
        if (len(banner) < 5 or banner[0] != "%%matrixmarket"
                or banner[2] != "coordinate"):
            raise ValueError(f"{path.name}: unsupported MatrixMarket "
                             f"banner {' '.join(banner)!r} (only "
                             f"'matrix coordinate' is supported)")
        field, symmetry = banner[3], banner[4]
        if field not in ("real", "integer", "pattern"):
            raise ValueError(f"{path.name}: unsupported field {field!r}")
        if symmetry not in ("general", "symmetric"):
            raise ValueError(f"{path.name}: unsupported symmetry "
                             f"{symmetry!r}")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        try:
            nrows, ncols, nnz = (int(tok) for tok in line.split())
        except ValueError:
            raise ValueError(f"{path.name}: malformed size line "
                             f"{line!r}") from None
        body = np.array(f.read().split(), dtype=np.float64)
    per = 2 if field == "pattern" else 3
    if body.shape[0] != per * nnz:
        raise ValueError(f"{path.name}: {body.shape[0] // per} entries, "
                         f"size line says {nnz}")
    body = body.reshape(nnz, per)
    rows = body[:, 0].astype(np.int64) - 1
    cols = body[:, 1].astype(np.int64) - 1
    vals = body[:, 2] if per == 3 else _synth_vals(nnz)
    if symmetry == "symmetric":
        off = rows != cols
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))
        vals = np.concatenate([vals, vals[off]])
    n = max(nrows, ncols)
    meta = {"source": path.name, "format": "mtx",
            "nrows": nrows, "ncols": ncols, "symmetry": symmetry}
    return _finalize_loaded(n, rows, cols, vals, pattern, meta)


def load_matrix(path: os.PathLike, pattern: str = "corpus") -> COOMatrix:
    """Load ``path`` by suffix (``.smtx`` or ``.mtx``)."""
    path = pathlib.Path(path)
    if path.suffix == ".smtx":
        return load_smtx(path, pattern)
    if path.suffix == ".mtx":
        return load_mtx(path, pattern)
    raise ValueError(f"unknown corpus suffix {path.suffix!r} for "
                     f"{path.name}; expected one of {_SUFFIXES}")


def write_smtx(m: COOMatrix, path: os.PathLike) -> pathlib.Path:
    """Write ``m`` as a DLMC ``.smtx`` pattern file (values dropped)."""
    path = pathlib.Path(path)
    ptr = m.row_ptr()
    lines = [f"{m.n}, {m.n}, {m.nnz}",
             " ".join(str(int(p)) for p in ptr),
             " ".join(str(int(c)) for c in m.cols)]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return path


def write_mtx(m: COOMatrix, path: os.PathLike, *,
              values: bool = True) -> pathlib.Path:
    """Write ``m`` as a Matrix Market coordinate file (1-based, general)."""
    path = pathlib.Path(path)
    field = "real" if values else "pattern"
    # The comment line is the reference writer's own, so that both
    # packages write the same bytes for one matrix.
    out = [f"%%MatrixMarket matrix coordinate {field} general",
           f"% written by repro.data.corpus ({m.pattern})",
           f"{m.n} {m.n} {m.nnz}"]
    if values:
        out += [f"{r + 1} {c + 1} {v:.6g}"
                for r, c, v in zip(m.rows, m.cols, m.vals)]
    else:
        out += [f"{r + 1} {c + 1}" for r, c in zip(m.rows, m.cols)]
    path.write_text("\n".join(out) + "\n", encoding="utf-8")
    return path


@dataclasses.dataclass(frozen=True)
class CorpusEntry:
    """One corpus matrix: its paper group and where it loads from."""

    name: str          # file stem after the group prefix
    group: str         # one of GROUPS
    path: pathlib.Path

    def load(self) -> COOMatrix:
        """Load the matrix; ``pattern`` is tagged with the group."""
        m = load_matrix(self.path, pattern=self.group)
        return dataclasses.replace(m, meta={**m.meta, "group": self.group,
                                            "corpus_name": self.name})


def _scan(root: pathlib.Path) -> Tuple[CorpusEntry, ...]:
    entries = []
    for path in sorted(root.glob("*")):
        if path.suffix not in _SUFFIXES or "__" not in path.stem:
            continue
        group, name = path.stem.split("__", 1)
        if group not in GROUPS:
            raise ValueError(f"corpus file {path.name}: group {group!r} "
                             f"not in {GROUPS}")
        entries.append(CorpusEntry(name=name, group=group, path=path))
    return tuple(entries)


def vendored_entries() -> Tuple[CorpusEntry, ...]:
    """The sample set shipped inside the package (no network, ever)."""
    return _scan(SAMPLES_DIR)


def corpus_entries(
        root: Optional[os.PathLike] = None) -> Tuple[CorpusEntry, ...]:
    """Enumerate the active corpus.

    Resolution order: an explicit ``root`` argument, then the directory
    named by ``$REPRO_CORPUS_DIR`` (the opt-in hook for a real
    downloaded DLMC/SuiteSparse tree), then the vendored sample set.
    Files must follow the ``<group>__<name>.smtx|.mtx`` convention;
    anything else in the directory is ignored.

    Args:
        root: optional corpus directory override.

    Returns:
        The discovered :class:`CorpusEntry` tuple (possibly empty for an
        empty override directory — never empty for the vendored set).
    """
    root = root or os.environ.get("REPRO_CORPUS_DIR")
    if root:
        return _scan(pathlib.Path(root))
    return vendored_entries()


def download(url: str, dest: os.PathLike, *,
             allow: Optional[bool] = None,
             timeout: float = 60.0) -> pathlib.Path:
    """Refuse to fetch ``url``: the port's corpus layer is hermetic.

    The reference's opt-in downloader is not ported; ``allow`` and
    ``timeout`` keep its signature and enable nothing.  Copy the files
    into a directory by other means and point ``$REPRO_CORPUS_DIR`` (or
    ``corpus_entries(root)``) at it.

    Raises:
        CorpusDownloadDisabled: always.
    """
    raise CorpusDownloadDisabled(
        f"refusing to download {url} to {dest}: the corpus layer is "
        f"hermetic (vendored samples, or files already under "
        f"REPRO_CORPUS_DIR)")


def load_corpus(root: Optional[os.PathLike] = None,
                groups: Optional[Sequence[str]] = None):
    """Load the active corpus as ``{name: COOMatrix}`` (group-filtered)."""
    out = {}
    for e in corpus_entries(root):
        if groups and e.group not in groups:
            continue
        out[e.name] = e.load()
    return out
