"""The harness: found by name, driven by data, and its last line."""
import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from bench import run, spec
from conftest import ROOT, SMALL

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}


def _run(root, cell, *, trace=False, seed=11, seconds=0.3, **kw):
    return run.run_cell(root, spec.load_cell(root, cell), seed=seed,
                        seconds=seconds, trace=trace,
                        device=torch.device("cpu"), t0=time.perf_counter(),
                        log=lambda s: None, **kw)


def test_benchmark_json_names_what_exists():
    bench = spec.load_benchmark(ROOT)
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", ()):
            assert w in {c["name"] for c in bench["workloads"]}
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        assert len(w["why"]) <= 200
        assert (ROOT / "bench" / "gen"
                / f"{cell.config['generator']}.py").is_file()
        assert (ROOT / "bench" / "drivers"
                / f"{cell.traffic['driver']}.py").is_file()
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["reduced"])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_result_line(small_root, cell, trace, one_thread):
    res = _run(small_root, cell, trace=trace)
    keys = list(res)
    assert set(keys) - {"breakdown"} == RESULT_KEYS
    assert keys[-1] == "checks"
    assert ("breakdown" in res) == trace
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    c = spec.load_cell(small_root, cell)
    want = c.per_layer if trace else c.end_to_end
    # On the CPU the trace sees no device: the device metrics are absent.
    absent = {m["name"] for m in want
              if m["name"].startswith("kernel_roofline")} if trace else set()
    assert set(res["metrics"]) == {m["name"] for m in want} - absent
    for m in want:
        if m["name"] in res["metrics"]:
            assert res["metrics"][m["name"]]["unit"] == m["unit"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    check = res["checks"]["max_rel_err"]
    assert check["value"] <= check["limit"]
    json.dumps(res)


def test_new_files_are_found_without_edits(small_root, one_thread):
    """A new config, traffic mix, metric and cell: new files and entries."""
    before = {p: p.read_bytes() for p in (small_root / "bench").rglob("*")
              if p.is_file()}
    cfg = json.loads((small_root / "bench" / "configs"
                      / "scalefree-small.json").read_text())
    cfg["name"] = "scalefree-tiny"
    cfg["n"] = 2048
    (small_root / "bench" / "configs" / "scalefree-tiny.json").write_text(
        json.dumps(cfg))
    mix = json.loads((small_root / "bench" / "traffic"
                      / "stream-d64.json").read_text())
    mix.update(name="stream-d16", d=16, in_flight=2)
    (small_root / "bench" / "traffic" / "stream-d16.json").write_text(
        json.dumps(mix))
    (small_root / "bench" / "metrics" / "requests.new.py").write_text(
        'def read(rec):\n    return float(rec.served.requests)\n')
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "scalefree-tiny", "source": "test",
                             "file": "bench/configs/scalefree-tiny.json",
                             "reduced": ["n"], "why": "test"})
    bench["workloads"].append({"name": "tiny.stream-d16",
                               "config": "scalefree-tiny",
                               "traffic": "stream-d16", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "requests.new", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "request path", "moves": "gflops",
                               "workloads": ["tiny.stream-d16"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _run(small_root, "tiny.stream-d16", trace=True)
    assert res["correct"]
    assert res["metrics"]["requests.new"]["value"] == res["attempted"]
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"


def test_cli_refuses_without_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result line."""
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "scalefree.stream-d64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)}, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA device" in out.stderr


def test_cli_refuses_outside_a_checkout(tmp_path):
    """Only BENCHMARK.json and bench/: a non-zero exit and no result."""
    from conftest import copy_checkout
    root = copy_checkout(tmp_path)
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "scalefree.stream-d64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert not {"repro_torch_fake", "jaxtyping_fake"} \
        & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert "flax" in run.forbidden_modules()


def test_stream_pools_leave_the_l2():
    """The fixed count reads B from HBM: a streamed mix cycles through B
    tensors that hold at least four times the L2 at the configurations'
    n."""
    from bench import roofline
    bench = spec.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        n, t = int(cell.config["n"]), cell.traffic
        if t["in_flight"] > 1:
            pool_bytes = 4 * n * int(t["d"]) * int(t["pool"])
            assert pool_bytes >= 4 * roofline.L2_BYTES


def test_cache_dirs_are_fixed_and_inside():
    dirs = run.cache_dirs(ROOT)
    assert dirs == run.cache_dirs(ROOT)
    for path in dirs.values():
        assert pathlib.Path(path).is_relative_to(ROOT)
