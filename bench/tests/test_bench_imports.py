"""A fresh interpreter loads the harness and every bench module and finds
no JAX and no JAX package; the reference loads nothing of the port."""
import subprocess
import sys

from conftest import ROOT

SCRIPT = r"""
import importlib, pathlib, sys
root = pathlib.Path({root!r})
sys.path[:0] = [str(root), str(root / "src")]
{body}
"""

ALL = r"""
from bench import spec, run, reference, roofline, devtrace, record, coo
import bench.drivers.closed_loop
for folder in ("gen", "drivers", "metrics"):
    for path in sorted((root / "bench" / folder).glob("*.py")):
        spec.load_module(root, folder, path.stem)
import repro_torch.sparse, repro_torch.kernels
top = {{name.split(".")[0] for name in sys.modules}}
bad = sorted(top & {{"jax", "jaxlib", "flax", "repro"}})
assert not bad, bad
assert "repro_torch" in top
print("ok")
"""

REFERENCE = r"""
import importlib.util
spec = importlib.util.spec_from_file_location(
    "plain_reference", root / "bench" / "reference.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
top = {{name.split(".")[0] for name in sys.modules}}
bad = sorted(top & {{"jax", "jaxlib", "flax", "repro", "repro_torch",
                     "bench"}})
assert not bad, bad
print("ok")
"""


def _fresh(body: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(ROOT),
                                             body=body.format())],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_harness_loads_no_jax():
    assert _fresh(ALL).strip().endswith("ok")


def test_reference_loads_nothing_of_the_port():
    assert _fresh(REFERENCE).strip().endswith("ok")
