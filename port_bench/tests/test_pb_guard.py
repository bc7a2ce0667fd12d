"""No JAX in a run, by whole top-level name, and a reference that
imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from conftest import BENCH, ROOT
from core import guard


def test_forbidden_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "point_slam_tpu", "point_slam_tpu.ops.knn",
             "point_slam_tpu_torch", "point_slam_tpu_torch.slam", "jaxtyping",
             "flaxen", "numpy"]
    assert guard.forbidden(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "point_slam_tpu", "point_slam_tpu.ops.knn"]


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return {guard.top_level(n) for n in out}


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tops = _imports(path)
        assert not tops & {"point_slam_tpu_torch", "point_slam_tpu", "jax",
                           "jaxlib", "flax", "core"}, path


def test_no_harness_file_imports_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"),
                          recursive=True):
        assert not _imports(path) & guard.FORBIDDEN, path


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]; {code}; "
         "from core import guard; "
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, check=True, cwd=ROOT)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded_after("import reference.render, reference.step")
    assert not tops & {"point_slam_tpu_torch", "point_slam_tpu", "jax",
                       "jaxlib", "flax"}


def test_the_program_and_harness_load_no_jax():
    tops = _loaded_after(
        "import importlib.util as u; "
        "s = u.spec_from_file_location('pb', 'port_bench/run.py'); "
        "m = u.module_from_spec(s); s.loader.exec_module(m); "
        "import point_slam_tpu_torch.slam, point_slam_tpu_torch.renderer")
    assert "point_slam_tpu_torch" in tops
    assert not tops & guard.FORBIDDEN
