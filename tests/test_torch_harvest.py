"""The port's dispatch-tree harvest against the reference's, on the CPU.

Two vendored matrices at d = 4 go through the port's
``repro_torch.launch.harvest_dispatch`` (``backend="torch"``,
``device="cpu"``) and through the reference's ``tools/harvest_dispatch.py``
(``backend="jax"``).  Timings differ between the two, so what is held
equal is what does not depend on them: the sweep's rows (which formats
are eligible, at which n, nnz and d), each sample's features, the tree the
reference fits on the port's samples, and the analytic choices of the
audit.  The tree goes to a temporary store root, never to the default
one, which every test in the worker shares.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import shutil

import numpy as np
import pytest

from repro.core.classify import classify as ref_classify
from repro.data import corpus as ref_corpus
from repro.data.dtree import DecisionTree as RefDecisionTree
from repro.data.dtree import features_from_report as ref_features
from repro.sparse.dispatch import Dispatcher as RefDispatcher

from repro_torch import interop
from repro_torch.data.dtree import FEATURES, DecisionTree, DispatchTreeStore
from repro_torch.kernels import registry as port_registry
from repro_torch.launch import harvest_dispatch as port_harvest

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: Two vendored matrices of different regimes.
PICK = ("blocked__fem_256_t32.smtx", "scale_free__hub_256_21.smtx")


def _ref_harvest():
    spec = importlib.util.spec_from_file_location(
        "ref_harvest_dispatch", ROOT / "tools" / "harvest_dispatch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    for name in PICK:
        shutil.copy(ref_corpus.SAMPLES_DIR / name, root / name)
    return root


@pytest.fixture(scope="module")
def harvested(corpus_dir, tmp_path_factory):
    """One port harvest: d = 4, one repeat, the tree to a temp root."""
    out = tmp_path_factory.mktemp("harvest-out")
    store = DispatchTreeStore(tmp_path_factory.mktemp("harvest-store"))
    args = port_harvest.parser().parse_args(
        ["--corpus-root", str(corpus_dir), "--d", "4", "--repeats", "1",
         "--device", "cpu", "--backend", "torch", "--out-dir", str(out)])
    return port_harvest.harvest(args, store=store), out, store


def _shape(rows):
    return [{k: r[k] for k in ("matrix", "group", "impl", "d", "n", "nnz")}
            for r in rows]


def test_sweep_rows_equal_reference(harvested, corpus_dir):
    rec, out, _ = harvested
    ref = _ref_harvest()
    entries = ref_corpus.corpus_entries(corpus_dir)
    ref_rows, ref_samples = ref.sweep(entries, [4], 1, "jax")
    assert _shape(rec["rows"]) == _shape(ref_rows)
    assert rec["backend"] == "torch"
    assert all(g > 0 for s in rec["samples"] for g in s["measured"].values())
    assert [(s["matrix"], s["d"]) for s in rec["samples"]] == \
        [(s["matrix"], s["d"]) for s in ref_samples]
    for p, r in zip(rec["samples"], ref_samples):
        np.testing.assert_array_equal(p["features"], r["features"])
        assert set(p["measured"]) == set(r["measured"])
        assert p["label"] == max(p["measured"], key=p["measured"].get)
    csv_lines = (out / port_harvest.HARVEST_CSV).read_text().splitlines()
    assert csv_lines[0] == "matrix,group,impl,d,n,nnz,gflops"
    assert len(csv_lines) == 1 + len(rec["rows"])


def test_features_equal_reference(corpus_dir):
    from repro_torch.core.classify import classify
    from repro_torch.data.dtree import features_from_report
    for e in ref_corpus.corpus_entries(corpus_dir):
        m = e.load()
        pm = interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                    m.meta)
        for d in (4, 32, 128):
            np.testing.assert_array_equal(
                features_from_report(classify(pm), d),
                ref_features(ref_classify(m), d))


def test_fitted_tree_equals_the_references_on_the_same_samples(harvested):
    rec, out, _ = harvested
    x = np.stack([s["features"] for s in rec["samples"]])
    y = [s["label"] for s in rec["samples"]]
    ref_tree = RefDecisionTree(max_depth=4, min_leaf=2).fit(x, y)
    assert rec["tree"].to_json() == ref_tree.to_json()
    assert rec["tree"].fingerprint() == ref_tree.fingerprint()
    payload = json.loads((out / port_harvest.TREE_JSON).read_text())
    assert payload["backend"] == "torch"
    assert DecisionTree.from_json(payload["tree"]).to_json() == \
        rec["tree"].to_json()
    assert payload["meta"]["matrices"] == sorted(
        {s["matrix"] for s in rec["samples"]})


def test_audit_rows_hold_the_analytic_choice(harvested, corpus_dir):
    rec, out, _ = harvested
    ref = RefDispatcher(backend="jax", calibration=False, tree=False)
    by_name = {e.name: e for e in ref_corpus.corpus_entries(corpus_dir)}
    assert [(r["matrix"], r["d"]) for r in rec["audit"]] == \
        [(s["matrix"], s["d"]) for s in rec["samples"]]
    agree = 0
    for row, s in zip(rec["audit"], rec["samples"]):
        assert row["impl"] == "tree_vs_analytic"
        assert row["analytic"] == \
            ref.plan(by_name[row["matrix"]].load(), row["d"]).chosen
        assert row["agreement"] == int(row["analytic"] == row["tree"])
        assert row["never_worse"] == int(
            s["measured"].get(row["tree"], 0.0)
            >= 0.95 * s["measured"].get(row["analytic"], 0.0))
        assert row["decision_source"] in ("analytic", "tree")
        agree += row["agreement"]
    assert rec["agreement"] == agree / len(rec["audit"])
    assert rec["claim_ok"] == all(r["never_worse"] for r in rec["audit"])
    assert (out / port_harvest.AGREEMENT_CSV).is_file()


def test_tree_saved_to_the_given_root_only(harvested):
    rec, _, store = harvested
    assert rec["tree_path"] == store.path_for("torch")
    loaded = store.load("torch")
    assert loaded is not None
    assert loaded.fingerprint() == rec["tree"].fingerprint()
    payload = json.loads(store.path_for("torch").read_text())
    assert payload["registry_version"] == port_registry.REGISTRY_VERSION
    assert store.load("cuda") is None
    # The default root (shared by the worker) holds no port tree.
    assert DispatchTreeStore().load("torch") is None


def test_default_out_dir_is_ignored_by_git():
    assert port_harvest.parser().parse_args([]).out_dir == \
        "chiprun_out/harvest"
    assert "chiprun_out/" in (ROOT / ".gitignore").read_text().splitlines()


def test_main_exit_codes(corpus_dir, tmp_path):
    common = ["--corpus-root", str(corpus_dir), "--d", "4", "--repeats",
              "1", "--device", "cpu", "--backend", "torch", "--no-store",
              "--out-dir", str(tmp_path / "out")]
    assert port_harvest.main(common) == 0
    # An impossible claim fails, and only --enforce turns that into 1.
    strict = common + ["--claim-factor", "1e9"]
    assert port_harvest.main(strict) == 0
    assert port_harvest.main(strict + ["--enforce"]) == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    assert port_harvest.main(["--corpus-root", str(empty), "--device",
                              "cpu", "--no-store"]) == 1
    assert DispatchTreeStore().load("torch") is None


def test_backend_follows_the_device(corpus_dir, tmp_path, capsys):
    args = port_harvest.parser().parse_args(
        ["--corpus-root", str(corpus_dir), "--d", "4", "--repeats", "1",
         "--device", "cpu", "--no-store", "--out-dir", str(tmp_path)])
    assert args.backend is None
    rec = port_harvest.harvest(args)
    assert rec["backend"] == "torch" and rec["tree_path"] is None
    assert "(torch backend on cpu)" in capsys.readouterr().out


def test_tree_store_defaults_to_the_port_backend(tmp_path):
    store = DispatchTreeStore(tmp_path)
    tree = DecisionTree(max_depth=1, min_leaf=1).fit(
        np.zeros((2, len(FEATURES))), ["csr", "csr"])
    path = store.save(tree)
    assert path == tmp_path / "dispatch_tree-torch.json"
    assert store.load() is not None
    assert store.load("jax") is None


def test_tree_store_refuses_a_payload_without_backend(tmp_path):
    store = DispatchTreeStore(tmp_path)
    tree = DecisionTree(max_depth=1, min_leaf=1).fit(
        np.zeros((2, len(FEATURES))), ["csr", "csr"])
    path = store.save(tree, "cuda")
    payload = json.loads(path.read_text())
    del payload["backend"]
    path.write_text(json.dumps(payload))
    assert store.load("cuda") is None
    assert store.load("jax") is None
