"""Nothing the benchmark loads is JAX or the JAX package, and the plain
references import nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

HGBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HGBENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "hashgan_tpu"}


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(HGBENCH, "**", "*.py"),
                          recursive=True):
        assert not _imported_tops(path) & FORBIDDEN, path


def test_the_references_import_nothing_of_the_program():
    """A reference imports plain libraries and other references only."""
    for path in glob.glob(os.path.join(HGBENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                top = name.split(".", 1)[0]
                assert top not in FORBIDDEN | {"hashgan_tpu_torch"}, path
                if top == "hgbench":
                    assert name.startswith("hgbench.reference"), (path, name)


def test_every_module_the_harness_loads_is_clear_of_jax():
    """Import the harness, every driver, metric reader and reference, and
    the program modules the drivers reach, in a fresh process; then
    compare each top-level name in sys.modules, whole, with the forbidden
    ones (``hashgan_tpu_torch`` begins with ``hashgan_tpu`` and is fine)."""
    code = f"""
import glob, os, sys
sys.path.insert(0, {ROOT!r})
from hgbench import core, run, serving, stats, tracing, inputs, record
from hgbench.reference import retrieval, pc_wgan, alexnet_hash
bench = core.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    core.load_reader(m["name"])
for path in glob.glob(os.path.join({HGBENCH!r}, "drivers", "*.py")):
    core.load_driver(os.path.basename(path)[:-3])
import hashgan_tpu_torch.index.engine, hashgan_tpu_torch.train.loop
print(",".join(run.forbidden_modules()))
print("hashgan_tpu_torch" in sys.modules)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    found, loaded = out.stdout.splitlines()[-2:]
    assert found == ""
    assert loaded == "True"


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, ROOT)
    from hgbench.run import forbidden_modules

    assert forbidden_modules({"hashgan_tpu_torch.ops": 1, "jaxtyping": 1,
                              "numpy": 1}) == []
    assert forbidden_modules({"jax.numpy": 1, "hashgan_tpu.ops": 1}) == [
        "hashgan_tpu", "jax"]
