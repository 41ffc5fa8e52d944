"""The port's corpus layer and generators against the reference's.

Every vendored file loads to the same arrays through both loaders, both
writers produce the same bytes, the port's copy of the samples is the
reference's byte for byte, ``corpus_entries`` resolves in the same order,
and ``fit_generator`` / ``paper_suite`` give byte-equal matrices.  The
port's ``download`` always refuses.
"""
from __future__ import annotations

import pathlib
import socket

import pytest

from repro.core import patterns as ref_patterns
from repro.core.classify import classify as ref_classify
from repro.data import corpus as ref_corpus

from repro_torch import interop
from repro_torch.core import patterns as port_patterns
from repro_torch.core.classify import classify as port_classify
from repro_torch.data import corpus as port_corpus

ENTRIES = ref_corpus.vendored_entries()
IDS = [f"{e.group}__{e.name}" for e in ENTRIES]


def _bridge(m):
    return interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                  m.meta)


def _same_matrix(p, r, what=""):
    assert (p.n, p.nnz, p.pattern, p.meta) == (r.n, r.nnz, r.pattern,
                                               r.meta), what
    for field in ("rows", "cols", "vals"):
        a, b = getattr(p, field), getattr(r, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
            (what, field)


@pytest.fixture
def no_network(monkeypatch):
    """Make any socket creation an immediate test failure."""
    def _blocked(*a, **k):
        raise AssertionError("network access attempted in hermetic test")
    monkeypatch.setattr(socket, "socket", _blocked)


def test_samples_are_the_references_byte_for_byte():
    ref_files = sorted(p.name for p in ref_corpus.SAMPLES_DIR.iterdir()
                       if p.suffix in (".smtx", ".mtx"))
    port_files = sorted(p.name for p in port_corpus.SAMPLES_DIR.iterdir()
                        if p.suffix in (".smtx", ".mtx"))
    assert port_files == ref_files and len(ref_files) == 8
    for name in ref_files:
        assert (port_corpus.SAMPLES_DIR / name).read_bytes() == \
            (ref_corpus.SAMPLES_DIR / name).read_bytes(), name


def test_vendored_entries_mirror_the_reference():
    port = port_corpus.vendored_entries()
    assert [(e.name, e.group, e.path.name) for e in port] == \
        [(e.name, e.group, e.path.name) for e in ENTRIES]
    assert {e.group for e in port} == set(port_corpus.GROUPS)
    assert port_corpus.GROUPS == ref_corpus.GROUPS


@pytest.mark.parametrize("entry", ENTRIES, ids=IDS)
def test_vendored_file_loads_equal(entry, no_network):
    port_entry = port_corpus.CorpusEntry(entry.name, entry.group,
                                         port_corpus.SAMPLES_DIR /
                                         entry.path.name)
    _same_matrix(port_entry.load(), entry.load(), entry.name)
    # The suffix loaders directly, with the default pattern tag.
    loader = {".smtx": "load_smtx", ".mtx": "load_mtx"}[entry.path.suffix]
    _same_matrix(getattr(port_corpus, loader)(entry.path),
                 getattr(ref_corpus, loader)(entry.path), entry.name)
    _same_matrix(port_corpus.load_matrix(entry.path, pattern="x"),
                 ref_corpus.load_matrix(entry.path, pattern="x"))


WRITE_CASES = {
    "er": lambda: ref_patterns.erdos_renyi(128, 6, seed=3),
    "banded": lambda: ref_patterns.banded(96, 3, fill=0.8, seed=4),
    "blocked": lambda: ref_patterns.blocked(128, t=16, num_blocks=12,
                                            nnz_per_block=40, seed=6),
    "scale_free": lambda: ref_patterns.scale_free(128, 6, alpha=2.1,
                                                  seed=8),
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_writers_write_equal_bytes(case, tmp_path):
    m = WRITE_CASES[case]()
    pm = _bridge(m)
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    for fn, kw, suffix in (("write_smtx", {}, ".smtx"),
                           ("write_mtx", {}, ".mtx"),
                           ("write_mtx", {"values": False}, ".mtx")):
        p = getattr(port_corpus, fn)(pm, tmp_path / "p" / f"a{suffix}",
                                     **kw)
        r = getattr(ref_corpus, fn)(m, tmp_path / "r" / f"a{suffix}", **kw)
        assert p.read_bytes() == r.read_bytes(), (fn, kw)
        # And the port reads back what it wrote, as the reference does.
        _same_matrix(port_corpus.load_matrix(p), ref_corpus.load_matrix(r))


@pytest.mark.parametrize("text", [
    "1, 1\n0 0\n\n",                         # short shape line
    "2, 2, 1\n0 1\n0\n",                     # ptr line too short
    "2, 2, 2\n0 1 2\n0\n",                   # too few column indices
    "2, 2, 1\n0 1 1\n5\n",                   # column out of range
])
def test_loaders_reject_the_same_malformed_smtx(text, tmp_path):
    path = tmp_path / "random__bad.smtx"
    path.write_text(text)
    with pytest.raises(ValueError):
        ref_corpus.load_smtx(path)
    with pytest.raises(ValueError):
        port_corpus.load_smtx(path)


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
    "%%MatrixMarket matrix coordinate complex general\n2 2 1\n1 1 1 0\n",
    "%%MatrixMarket matrix coordinate real hermitian\n2 2 1\n1 1 1\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1\n",
])
def test_loaders_reject_the_same_malformed_mtx(text, tmp_path):
    path = tmp_path / "random__bad.mtx"
    path.write_text(text)
    with pytest.raises(ValueError):
        ref_corpus.load_mtx(path)
    with pytest.raises(ValueError):
        port_corpus.load_mtx(path)


def test_symmetric_mtx_mirrors_like_the_reference(tmp_path):
    path = tmp_path / "diagonal__sym.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                    "% a comment\n4 4 4\n1 1 2.0\n2 1 -1.0\n3 2 0.5\n"
                    "4 4 3\n")
    _same_matrix(port_corpus.load_mtx(path), ref_corpus.load_mtx(path))


def _names(entries):
    return [(e.name, e.group, pathlib.Path(e.path).name) for e in entries]


def test_corpus_entries_resolve_in_the_references_order(tmp_path,
                                                       monkeypatch):
    env_dir, arg_dir = tmp_path / "env", tmp_path / "arg"
    env_dir.mkdir()
    arg_dir.mkdir()
    m = ref_patterns.erdos_renyi(32, 2, seed=0)
    ref_corpus.write_smtx(m, env_dir / "random__from_env.smtx")
    ref_corpus.write_mtx(m, arg_dir / "blocked__from_arg.mtx")
    (arg_dir / "notes.txt").write_text("ignored")
    (arg_dir / "nogroup.smtx").write_text("ignored")
    monkeypatch.setenv("REPRO_CORPUS_DIR", str(env_dir))
    for root in (None, arg_dir, tmp_path / "missing"):
        got = _names(port_corpus.corpus_entries(root))
        assert got == _names(ref_corpus.corpus_entries(root)), root
    assert _names(port_corpus.corpus_entries()) == \
        [("from_env", "random", "random__from_env.smtx")]
    assert _names(port_corpus.corpus_entries(arg_dir)) == \
        [("from_arg", "blocked", "blocked__from_arg.mtx")]
    monkeypatch.delenv("REPRO_CORPUS_DIR")
    assert [e.name for e in port_corpus.corpus_entries()] == \
        [e.name for e in ENTRIES]
    (env_dir / "bogus__x.smtx").write_text("1, 1, 0\n0 0\n\n")
    with pytest.raises(ValueError, match="bogus"):
        port_corpus.corpus_entries(env_dir)


@pytest.mark.parametrize("groups", [None, ["diagonal"],
                                    ["blocked", "scale_free"]])
def test_load_corpus_equals_reference(groups, no_network):
    port = port_corpus.load_corpus(groups=groups)
    ref = ref_corpus.load_corpus(groups=groups)
    assert list(port) == list(ref) and port
    for name in ref:
        _same_matrix(port[name], ref[name], name)


@pytest.mark.parametrize("allow", [None, False, True])
def test_download_always_refuses(allow, tmp_path, no_network,
                                 monkeypatch):
    monkeypatch.setenv("REPRO_CORPUS_ALLOW_DOWNLOAD", "1")
    dest = tmp_path / "m.mtx"
    with pytest.raises(port_corpus.CorpusDownloadDisabled):
        port_corpus.download("https://example.com/m.mtx", dest, allow=allow)
    dest.write_text("cached")
    with pytest.raises(port_corpus.CorpusDownloadDisabled):
        port_corpus.download("https://example.com/m.mtx", dest, allow=allow)
    assert dest.read_text() == "cached"


FIT_SOURCES = {
    "random": lambda: ref_patterns.erdos_renyi(256, 8, seed=1),
    "diagonal": lambda: ref_patterns.banded(256, 2, fill=1.0, seed=4),
    "blocked": lambda: ref_patterns.blocked(256, t=32, num_blocks=16,
                                            nnz_per_block=256, seed=6),
    "scale_free": lambda: ref_patterns.scale_free(256, 8, alpha=2.1,
                                                  seed=8),
    **{f"corpus:{e.name}": e.load for e in ENTRIES},
}


@pytest.mark.parametrize("n", [None, 512])
@pytest.mark.parametrize("source", sorted(FIT_SOURCES))
def test_fit_generator_equals_reference(source, n):
    m = FIT_SOURCES[source]()
    ref_report = ref_classify(m)
    port_report = port_classify(_bridge(m))
    assert port_report.regime == ref_report.regime
    _same_matrix(port_patterns.fit_generator(port_report, n=n, seed=2),
                 ref_patterns.fit_generator(ref_report, n=n, seed=2),
                 source)


@pytest.mark.parametrize("name", sorted(ref_patterns.paper_suite(8)))
def test_paper_suite_equals_reference(name):
    port = port_patterns.paper_suite(8)
    ref = ref_patterns.paper_suite(8)
    assert list(port) == list(ref)
    _same_matrix(port[name](), ref[name](), name)


def test_paper_suite_default_scale_names_equal_reference():
    assert list(port_patterns.paper_suite()) == \
        list(ref_patterns.paper_suite())
